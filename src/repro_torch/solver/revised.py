"""Bounded-variable revised simplex with warm starts.

Solves   min  c @ x
         s.t. A @ x == b          (m equality rows only)
              lb <= x <= ub       (ub may be +inf; lb must be finite)

Design (DESIGN.md §13/§17):

* **Implicit bounds.**  Upper bounds never become rows.  Every nonbasic
  variable rests at one of its bounds (``AT_LB``/``AT_UB``); a simplex step
  either pivots or merely *flips* a variable between its bounds.  The basis
  is therefore always m x m — for the Eq.-14 policy LP that is 2M x 2M
  instead of the dense oracle's O(M^2) x O(M^2) tableau.
* **Two basis engines.**  Small instances (``m < _LU_MIN_ROWS``) keep the
  historical dense product-form inverse: ``Binv`` maintained by elementary
  eta updates (O(m^2) per pivot), refactorized from scratch every
  ``refactor_every`` pivots.  This path is bit-identical to the original
  dense solver — the engine-parity and grid-point-pin suites depend on that.
  Large instances switch to a **sparse-LU + eta-file** factorization
  (Bartels–Golub style): ``scipy.sparse.linalg.splu`` on the basis matrix
  plus a bounded list of eta transforms, so FTRAN/BTRAN cost O(lu + k·m)
  instead of O(m^2), and a pivot costs O(m) (append one eta) instead of the
  O(m^2) dense rank-1 update.  Periodic refactorization bounds both the eta
  file and numerical drift.
* **Sparse pricing.**  Eq.-14 columns carry at most two nonzeros (the
  worker's Eq.-10 row and its Eq.-13 row), so reduced costs over all n
  columns are O(nnz) through a CSC store — not the O(m·n) dense matvec
  that dominated wall time at M >= 128.  ``A_eq`` may be passed as a
  ``scipy.sparse`` matrix to skip the dense instance entirely.
* **Pricing rules.**  ``pricing="dantzig"`` (most-negative reduced cost,
  the historical rule), ``"partial"`` (rotating candidate window — prices
  a slice of columns per iteration, cutting per-iteration cost on wide
  instances), ``"devex"`` (Devex reference weights — available for LPs
  where pivot count, not pricing cost, dominates), or ``"auto"`` (dantzig
  below the LU threshold for bit-stability, partial above it — on Eq.-14
  the ratio-test ties make every rule take essentially the same pivot
  path, so the cheapest per-iteration rule wins the wall clock).  All
  rules share the Bland fallback:
  after a stall the iteration reverts to full pricing with Bland's rule,
  which guarantees termination regardless of the steady-state rule.
* **Warm starts.**  ``solve_lp_revised(..., warm=basis)`` accepts the
  ``BasisState`` returned by a previous solve.  The basis is refactorized
  against the *current* A (nonsingularity checked), nonbasic statuses are
  re-forced dual feasible against the *current* costs, and a
  bounded-variable **dual simplex** drives out any primal infeasibility
  introduced by changed ``b`` (the t_bar grid) or changed bound floors
  (the rho grid).  A warm basis is a hint, never a correctness input: any
  validation failure falls back to a cold start.

Cold starts run the textbook artificial-variable phase 1 (signed unit
columns, so the initial basis is a diagonal) followed by primal phase 2.
"""

from __future__ import annotations

import numpy as np

try:  # scipy ships in the target env; gate anyway per repo policy
    import scipy.sparse as _sp
    import scipy.sparse.linalg as _sla
except ImportError:  # pragma: no cover - exercised only without scipy
    _sp = None
    _sla = None

from repro_torch.solver.result import BasisState, LPResult

_EPS = 1e-9      # reduced-cost / pivot-eligibility tolerance
_FEAS = 1e-8     # primal feasibility tolerance on basic variables
_PIV_MIN = 1e-10  # smallest acceptable eta pivot before forcing refactor

# Rows at which "auto" switches from the dense product-form inverse to the
# sparse-LU engine (and from Dantzig to partial pricing).  Every bit-exactness
# pin in the test suite runs at m <= 64 (M <= 32); the switch lives well
# above that so the historical path keeps producing identical bits.
_LU_MIN_ROWS = 96

AT_LB, AT_UB, BASIC = 0, 1, 2

PRICING_RULES = ("auto", "dantzig", "partial", "devex")


def _is_sparse(A) -> bool:
    return _sp is not None and _sp.issparse(A)


def instance_key(A) -> tuple:
    """Cheap fingerprint used to match a BasisState to an instance shape.

    Only the (m, n) prefix gates warm-start acceptance (see ``try_warm``);
    the sums are a debugging aid, O(n) so they stay off the hot path.
    Sparse and dense builds of the same instance produce the same key
    (adding explicit zeros is exact in IEEE float).
    """
    m, n = A.shape
    if _is_sparse(A):
        r = A.tocsr()
        return (m, n, float(r[0].sum()), float(r[m - 1].sum()))
    return (m, n, float(A[0].sum()), float(A[-1].sum()))


class _EtaLU:
    """Sparse-LU basis factorization plus an eta file.

    ``B = B0 E1 ... Ek`` where B0 is the last refactorized basis and each
    eta Ei is the identity with column r_i replaced by w_i (= B_{i-1}^-1
    a_entering).  FTRAN applies B0's LU solve then the etas in order;
    BTRAN applies the transposed etas in reverse then B0's transpose
    solve.  Each eta application is O(m); the caller bounds the file
    length via periodic refactorization.
    """

    __slots__ = ("lu", "etas", "ill_conditioned")

    def __init__(self, B_csc):
        """Factorize the basis matrix; raise RuntimeError when singular."""
        try:
            self.lu = _sla.splu(B_csc)
        except RuntimeError as e:  # exactly singular
            raise RuntimeError(f"revised simplex: singular basis ({e})")
        du = np.abs(self.lu.U.diagonal())
        if not np.isfinite(du).all() or du.min() <= 0.0:
            raise RuntimeError("revised simplex: singular basis (LU)")
        # Warm-start guard analog of the dense |Binv|.max() check.
        self.ill_conditioned = bool(du.max() / du.min() > 1e13)
        self.etas: list = []

    def push(self, r: int, w: np.ndarray) -> None:
        """Append one eta transform (pivot row r, ftran'd entering column w)."""
        self.etas.append((r, w, w[r]))

    def ftran(self, v: np.ndarray) -> np.ndarray:
        """Apply B^-1 v through the LU factors plus the eta file."""
        x = self.lu.solve(v)
        for r, w, wr in self.etas:
            t = x[r] / wr
            x -= w * t
            x[r] = t
        return x

    def btran(self, v: np.ndarray) -> np.ndarray:
        """Apply v B^-1 (transpose solve) through the eta file then the LU."""
        y = np.array(v, dtype=np.float64, copy=True)
        for r, w, wr in reversed(self.etas):
            # (E^-T y)_r = y_r - ((w - e_r) . y) / w_r; other entries fixed.
            y[r] -= (w @ y - y[r]) / wr
        return self.lu.solve(y, trans="T")


class _Simplex:
    """One solve on one instance.  Not reusable across instances."""

    def __init__(self, c, A, b, lb, ub, max_iter=20000, refactor_every=64,
                 pricing="auto", engine="auto"):
        """Set up bound-status arrays and pick the pricing rule + engine."""
        self.m, self.n = A.shape
        m, n = self.m, self.n
        sparse_in = _is_sparse(A)
        if engine == "auto":
            engine = (
                "lu" if _sp is not None and (sparse_in or m >= _LU_MIN_ROWS)
                else "dense"
            )
        if engine == "lu" and _sp is None:  # pragma: no cover - no scipy
            engine = "dense"
        if pricing == "auto":
            pricing = "partial" if engine == "lu" else "dantzig"
        if pricing not in ("dantzig", "partial", "devex"):
            raise ValueError(f"unknown pricing rule {pricing!r}")
        self.engine = engine
        self.pricing = pricing
        # Column stores.  ``self.A`` is the dense matrix (None when the
        # caller handed us a sparse instance); ``self.A_sp`` is the CSC
        # store the LU engine prices through (None on the dense engine —
        # whose arithmetic must stay bit-identical to the legacy solver).
        if engine == "dense":
            self.A = A.toarray() if sparse_in else A
            self.A_sp = None
        else:
            self.A_sp = A.tocsc() if sparse_in else _sp.csc_matrix(A)
            self.A = None if sparse_in else A
        self._ikey = instance_key(A)
        self.b = b
        self.art_sign = np.ones(m)
        self.cost = np.concatenate([c, np.zeros(m)])
        self.lbw = np.concatenate([lb, np.zeros(m)])
        self.ubw = np.concatenate([ub, np.zeros(m)])
        self.vstat = np.full(n + m, AT_LB, dtype=np.int8)
        # Nonbasic variables with no finite lower bound rest at their upper
        # bound; both-infinite (free) variables are unsupported, matching
        # the dense oracle (whose lb-shift also requires finite lb).
        no_lb = ~np.isfinite(self.lbw[:n])
        if np.any(no_lb & ~np.isfinite(self.ubw[:n])):
            raise ValueError("free variables (lb and ub infinite) unsupported")
        self.vstat[:n][no_lb] = AT_UB
        self.basis = np.arange(n, n + m)
        self.Binv = np.eye(m) if engine == "dense" else None
        self._lu: _EtaLU | None = None
        self.xB = np.zeros(m)
        self.xN = np.zeros(n + m)  # nonbasic bound values; basic entries 0
        self._rebuild_xN()
        self.pivots = 0
        self.max_iter = max_iter
        self.refactor_every = refactor_every
        # Partial pricing: rotating window over the working columns.
        self._pp_w = max(64, (n + m + 7) // 8)
        self._pp_ptr = 0
        self._gamma = None  # Devex reference weights (primal() resets)

    # -- columns / factorization -------------------------------------------
    def _col(self, j):
        if j < self.n:
            if self.A is not None:
                return self.A[:, j]
            s, e = self.A_sp.indptr[j], self.A_sp.indptr[j + 1]
            a = np.zeros(self.m)
            a[self.A_sp.indices[s:e]] = self.A_sp.data[s:e]
            return a
        e = np.zeros(self.m)
        e[j - self.n] = self.art_sign[j - self.n]
        return e

    def _cols(self, idx):
        """Dense (m, len(idx)) matrix of working columns."""
        idx = np.asarray(idx)
        out = np.zeros((self.m, len(idx)))
        struct = idx < self.n
        if self.A is not None:
            out[:, struct] = self.A[:, idx[struct]]
        else:
            out[:, struct] = self.A_sp[:, idx[struct]].toarray()
        art = np.flatnonzero(~struct)
        rows = idx[art] - self.n
        out[rows, art] = self.art_sign[rows]
        return out

    def _Ax(self, x):
        """A @ x over the structural columns."""
        if self.A_sp is not None:
            return self.A_sp @ x
        return self.A @ x

    def _ATy(self, y):
        """Compute y @ A over the structural columns (row vector times A)."""
        if self.A_sp is not None:
            return self.A_sp.T @ y
        return y @ self.A

    def _basis_csc(self):
        """Sparse basis matrix in basis order (LU engine refactorization)."""
        idx = self.basis
        struct = idx < self.n
        ns = int(struct.sum())
        nart = self.m - ns
        order = np.empty(self.m, dtype=np.int64)
        order[struct] = np.arange(ns)
        order[~struct] = ns + np.arange(nart)
        parts = []
        if ns:
            parts.append(self.A_sp[:, idx[struct]])
        if nart:
            rows = idx[~struct] - self.n
            parts.append(_sp.csc_matrix(
                (self.art_sign[rows], (rows, np.arange(nart))),
                shape=(self.m, nart),
            ))
        B = parts[0] if len(parts) == 1 else _sp.hstack(parts, format="csc")
        return B.tocsc()[:, order]

    def _refactor(self):
        if self.engine == "lu":
            self._lu = _EtaLU(self._basis_csc())
            return
        B = self._cols(self.basis)
        try:
            Binv = np.linalg.inv(B)
        except np.linalg.LinAlgError as e:
            raise RuntimeError(f"revised simplex: singular basis ({e})")
        if not np.isfinite(Binv).all():
            raise RuntimeError("revised simplex: non-finite basis inverse")
        self.Binv = Binv

    def _ftran(self, v):
        """B^-1 @ v through the active engine."""
        if self.engine == "dense":
            return self.Binv @ v
        return self._lu.ftran(v)

    def _btran(self, v):
        """Compute v @ B^-1 through the active engine."""
        if self.engine == "dense":
            return v @ self.Binv
        return self._lu.btran(v)

    def _row(self, r):
        """Row r of B^-1 (the dual-simplex / drive-out pivot row)."""
        if self.engine == "dense":
            return self.Binv[r]
        e = np.zeros(self.m)
        e[r] = 1.0
        return self._lu.btran(e)

    def _rebuild_xN(self):
        """Recompute the nonbasic-value vector from scratch (status change)."""
        x = np.where(self.vstat == AT_UB, self.ubw, self.lbw)
        x[self.vstat == BASIC] = 0.0
        self.xN = x

    def _compute_xB(self):
        """Recompute basic values from self.xN (start of a run / refactor).

        Between refactorizations xB is maintained incrementally by the
        pivot/flip updates in primal()/dual().
        """
        rhs = self.b - self._Ax(self.xN[: self.n])
        art = self.xN[self.n:]
        if art.any():  # artificial nonbasic values are 0 outside phase 1
            rhs = rhs - self.art_sign * art
        self.xB = self._ftran(rhs)

    def _x_full(self):
        x = self.xN.copy()
        x[self.basis] = self.xB
        return x

    def _reduced_costs(self, cost):
        y = self._btran(cost[self.basis])
        d = np.empty(self.n + self.m)
        d[: self.n] = cost[: self.n] - self._ATy(y)
        d[self.n:] = cost[self.n:] - y * self.art_sign
        return d

    def _do_pivot(self, r, j, leave_to, w, xj_new=None):
        """Swap j into basis row r; leaving variable rests at ``leave_to``.

        ``xj_new`` is the entering variable's value (caller-computed from
        the ratio/dual step); the incremental xB must already reflect the
        step for all *other* basics — this only fixes up row r and xN.
        """
        leaving = self.basis[r]
        self.vstat[leaving] = leave_to
        self.vstat[j] = BASIC
        self.basis[r] = j
        self.xN[leaving] = self.ubw[leaving] if leave_to == AT_UB else self.lbw[leaving]
        if xj_new is None:
            xj_new = self.xN[j]  # degenerate drive-out: enters at its bound
        self.xN[j] = 0.0
        self.pivots += 1
        if self.pivots % self.refactor_every == 0 or abs(w[r]) < _PIV_MIN:
            self._refactor()
            self._compute_xB()  # reset incremental drift at each refactor
        else:
            if self.engine == "dense":
                prow = self.Binv[r] / w[r]
                self.Binv -= np.outer(w, prow)
                self.Binv[r] = prow
            else:
                self._lu.push(r, w)
            self.xB[r] = xj_new

    # -- pricing ------------------------------------------------------------
    def _price_window(self, idx, y, cost):
        """Reduced costs for the working columns ``idx`` given duals y."""
        out = np.empty(len(idx))
        struct = idx < self.n
        js = idx[struct]
        if self.A_sp is not None:
            out[struct] = self.A_sp[:, js].T @ y
        else:
            out[struct] = y @ self.A[:, js]
        rows = idx[~struct] - self.n
        out[~struct] = y[rows] * self.art_sign[rows]
        return cost[idx] - out

    def _price_partial(self, cost, movable):
        """Rotating-window partial pricing.

        Prices one window of columns per call, starting just past the last
        entering column; falls through to the next window when the current
        one has no eligible candidate.  A full rotation with no candidate
        anywhere is a Dantzig-complete optimality certificate (every
        window shares the same duals y).
        """
        y = self._btran(cost[self.basis])
        nt = self.n + self.m
        W = min(self._pp_w, nt)
        ptr = self._pp_ptr
        for _ in range(-(-nt // W) + 1):
            idx = np.arange(ptr, ptr + W) % nt
            d = self._price_window(idx, y, cost)
            st = self.vstat[idx]
            elig = movable[idx] & (
                ((st == AT_LB) & (d < -_EPS)) | ((st == AT_UB) & (d > _EPS))
            )
            hit = np.flatnonzero(elig)
            if hit.size:
                k = int(hit[np.argmax(np.abs(d[hit]))])
                j = int(idx[k])
                self._pp_ptr = (j + 1) % nt
                return j
            ptr = (ptr + W) % nt
        self._pp_ptr = ptr
        return None

    def _devex_update(self, r, j, w):
        """Devex reference-weight update for pivot (row r, entering j).

        Uses the pre-pivot factorization: alpha_row = (B^-1 A)_r over all
        working columns — one BTRAN plus one sparse A-transpose product,
        O(m + nnz) on the LU engine.
        """
        rv = self._row(r)
        arow = np.empty(self.n + self.m)
        arow[: self.n] = self._ATy(rv)
        arow[self.n:] = rv * self.art_sign
        arj = arow[j]
        if abs(arj) < _PIV_MIN:
            return
        g = self._gamma
        gq = float(g[j])
        np.maximum(g, (arow / arj) ** 2 * gq, out=g)
        g[self.basis[r]] = max(gq / (arj * arj), 1.0)

    # -- primal simplex -----------------------------------------------------
    def primal(self, cost) -> str:
        """Bounded-variable primal simplex from the current (feasible) basis.

        Returns "optimal" or "unbounded"; raises RuntimeError at the
        iteration cap.
        """
        bland = False
        stall = 0
        best_obj = np.inf
        movable = (self.ubw - self.lbw) > _EPS  # fixed vars can never enter
        self._compute_xB()
        if self.pricing == "devex":
            self._gamma = np.ones(self.n + self.m)
        for _ in range(self.max_iter):
            obj = float(cost[self.basis] @ self.xB + cost @ self.xN)
            if obj < best_obj - 1e-12:
                best_obj = obj
                stall = 0
                bland = False
            else:
                stall += 1
                if stall > 2 * self.m + 16:
                    bland = True  # Bland's rule: guaranteed termination
            if bland or self.pricing != "partial":
                d = self._reduced_costs(cost)
                elig = movable & (
                    ((self.vstat == AT_LB) & (d < -_EPS))
                    | ((self.vstat == AT_UB) & (d > _EPS))
                )
                cand = np.flatnonzero(elig)
                if cand.size == 0:
                    return "optimal"
                if bland:
                    j = int(cand[0])
                elif self.pricing == "devex":
                    j = int(cand[np.argmax(d[cand] ** 2 / self._gamma[cand])])
                else:
                    j = int(cand[np.argmax(np.abs(d[cand]))])
            else:
                j = self._price_partial(cost, movable)
                if j is None:
                    return "optimal"
            s = 1.0 if self.vstat[j] == AT_LB else -1.0  # x_j moves by s*t
            w = self._ftran(self._col(j))
            dxB = -s * w
            lbB = self.lbw[self.basis]
            ubB = self.ubw[self.basis]
            inc = dxB > _EPS
            dec = dxB < -_EPS
            with np.errstate(divide="ignore", invalid="ignore"):
                t_up = np.where(inc, (ubB - self.xB) / dxB, np.inf)
                t_lo = np.where(dec, (lbB - self.xB) / dxB, np.inf)
            t_up = np.where(np.isnan(t_up), np.inf, np.maximum(t_up, 0.0))
            t_lo = np.where(np.isnan(t_lo), np.inf, np.maximum(t_lo, 0.0))
            t_row = np.minimum(t_up, t_lo)
            rmin = float(t_row.min()) if t_row.size else np.inf
            t_flip = self.ubw[j] - self.lbw[j]
            if not np.isfinite(min(rmin, t_flip)):
                return "unbounded"
            if t_flip < rmin - 1e-12:
                # Bound flip: no basis change, the variable crosses to its
                # other bound (this is the move the dense oracle needs an
                # entire slack row to express).
                self.xB += dxB * t_flip
                self.vstat[j] = AT_UB if self.vstat[j] == AT_LB else AT_LB
                self.xN[j] = (
                    self.ubw[j] if self.vstat[j] == AT_UB else self.lbw[j]
                )
                continue
            rows = np.flatnonzero(t_row <= rmin + _EPS)
            if bland:
                r = int(rows[np.argmin(self.basis[rows])])
            else:
                r = int(rows[np.argmax(np.abs(dxB[rows]))])
            leave_to = AT_UB if t_up[r] <= t_lo[r] else AT_LB
            if self.pricing == "devex" and not bland:
                self._devex_update(r, j, w)
            xj_new = self.xN[j] + s * rmin
            self.xB += dxB * rmin
            self._do_pivot(r, j, leave_to, w, xj_new=xj_new)
        raise RuntimeError("revised simplex: iteration limit reached")

    # -- dual simplex -------------------------------------------------------
    def dual(self, cost) -> str:
        """Bounded-variable dual simplex from a dual-feasible basis.

        Drives primal bound violations of basic variables to zero while
        keeping reduced costs sign-feasible.  Returns "optimal" (primal
        feasible reached) or "infeasible" (dual unbounded); raises
        RuntimeError at the iteration cap.
        """
        stall = 0
        best_viol = np.inf
        movable = (self.ubw - self.lbw) > _EPS
        self._compute_xB()
        for _ in range(self.max_iter):
            lbB = self.lbw[self.basis]
            ubB = self.ubw[self.basis]
            viol_lo = lbB - self.xB
            viol_up = self.xB - ubB
            v = np.maximum(viol_lo, viol_up)
            vmax = float(v.max()) if v.size else 0.0
            if vmax <= _FEAS:
                return "optimal"
            if vmax < best_viol - 1e-12:
                best_viol = vmax
                stall = 0
            else:
                stall += 1
            bland = stall > 2 * self.m + 16
            if bland:
                bad = np.flatnonzero(v > _FEAS)
                r = int(bad[np.argmin(self.basis[bad])])
            else:
                r = int(np.argmax(v))
            below = viol_lo[r] > viol_up[r]
            rv = self._row(r)
            rho = np.empty(self.n + self.m)
            rho[: self.n] = self._ATy(rv)
            rho[self.n:] = rv * self.art_sign
            a = -rho if below else rho
            d = self._reduced_costs(cost)
            nb_lo = movable & (self.vstat == AT_LB) & (a > _EPS)
            nb_up = movable & (self.vstat == AT_UB) & (a < -_EPS)
            cand = np.flatnonzero(nb_lo | nb_up)
            if cand.size == 0:
                return "infeasible"  # dual unbounded
            ratios = d[cand] / a[cand]
            ratios = np.maximum(ratios, 0.0)  # clip tiny dual-degenerate noise
            rmin = ratios.min()
            ties = cand[np.flatnonzero(ratios <= rmin + _EPS)]
            if bland:
                j = int(ties[0])
            else:
                j = int(ties[np.argmax(np.abs(a[ties]))])
            w = self._ftran(self._col(j))
            bound_r = lbB[r] if below else ubB[r]
            delta = (self.xB[r] - bound_r) / w[r]
            xj_new = self.xN[j] + delta
            self.xB -= w * delta
            leave_to = AT_LB if below else AT_UB
            self._do_pivot(r, j, leave_to, w, xj_new=xj_new)
        raise RuntimeError("revised simplex: iteration limit reached")

    # -- phase 1 ------------------------------------------------------------
    def phase1(self) -> str:
        """Artificial-variable phase 1 from the all-artificial basis."""
        self._rebuild_xN()
        r0 = self.b - self._Ax(self.xN[: self.n])
        self.art_sign = np.where(r0 >= 0.0, 1.0, -1.0)
        self.basis = np.arange(self.n, self.n + self.m)
        self.vstat[self.basis] = BASIC
        self.xN[self.basis] = 0.0
        if self.engine == "dense":
            self.Binv = np.diag(self.art_sign)  # diag(s)^-1 == diag(s)
        else:
            self._refactor()
        self.ubw[self.n:] = np.inf  # artificials live during phase 1
        cost1 = np.zeros(self.n + self.m)
        cost1[self.n:] = 1.0
        self.primal(cost1)  # cannot be unbounded (objective >= 0)
        self._compute_xB()
        art_basic = self.basis >= self.n
        obj = float(self.xB[art_basic].sum()) if art_basic.any() else 0.0
        if obj > 1e-7:
            return "infeasible"
        # Drive remaining (degenerate, value-0) artificials out wherever a
        # structural column has a nonzero in their row; rows with no such
        # column are redundant and keep a pinned artificial at 0.
        for r in np.flatnonzero(self.basis >= self.n):
            row = self._ATy(self._row(r))
            free = (self.vstat[: self.n] != BASIC) & (np.abs(row) > 1e-7)
            jc = np.flatnonzero(free)
            if jc.size:
                j = int(jc[0])
                w = self._ftran(self._col(j))
                self._do_pivot(r, j, AT_LB, w)
        self.ubw[self.n:] = 0.0  # pin artificials for phase 2
        return "feasible"

    # -- warm start ---------------------------------------------------------
    def try_warm(self, warm: BasisState) -> str | None:
        """Install a prior basis and re-solve from it.

        Returns "optimal"/"unbounded" when the warm path concluded, None
        when the basis failed validation (caller falls back to cold start).
        Only the *shape* part of the key is checked: the fingerprint is a
        hint, and a same-shaped basis from different data (e.g. a Monitor
        refresh with new EMA times) is exactly the reuse we want — the
        refactorization, dual-feasibility forcing, and final primal polish
        below make any nonsingular basis a correct starting point.
        """
        if warm is None or tuple(warm.key[:2]) != (self.m, self.n):
            return None
        basis = np.asarray(warm.basis, dtype=np.int64)
        if (
            basis.shape != (self.m,)
            or basis.min(initial=0) < 0
            or basis.max(initial=0) >= self.n
            or np.unique(basis).size != self.m
        ):
            return None
        vstat = np.asarray(warm.vstat, dtype=np.int8).copy()
        if vstat.shape != (self.n,):
            return None
        vstat[basis] = BASIC
        # Nonbasic statuses must point at finite bounds.
        at_ub = vstat == AT_UB
        bad_ub = at_ub & ~np.isfinite(self.ubw[: self.n])
        vstat[bad_ub] = AT_LB
        at_lb = vstat == AT_LB
        if np.any(at_lb & ~np.isfinite(self.lbw[: self.n])):
            return None
        saved = (self.basis, self.vstat.copy(), self.Binv, self._lu)
        self.basis = basis
        self.vstat = np.concatenate(
            [vstat, np.full(self.m, AT_LB, dtype=np.int8)]
        )
        try:
            self._refactor()
            # Guard against a nearly-singular inherited basis.
            if self.engine == "dense":
                if np.abs(self.Binv).max() > 1e12:
                    raise RuntimeError("ill-conditioned warm basis")
            elif self._lu.ill_conditioned:
                raise RuntimeError("ill-conditioned warm basis")
            # Re-force dual feasibility against the *current* costs: a
            # nonbasic variable whose reduced cost has the wrong sign flips
            # to its other (finite) bound; if that bound is infinite the
            # warm basis is not dual-feasibilizable — cold start instead.
            d = self._reduced_costs(self.cost)[: self.n]
            nb = self.vstat[: self.n] != BASIC
            wrong_lb = nb & (self.vstat[: self.n] == AT_LB) & (d < -_EPS)
            wrong_ub = nb & (self.vstat[: self.n] == AT_UB) & (d > _EPS)
            if np.any(wrong_lb & ~np.isfinite(self.ubw[: self.n])):
                raise RuntimeError("dual infeasible warm basis (ub=inf)")
            if np.any(wrong_ub & ~np.isfinite(self.lbw[: self.n])):
                raise RuntimeError("dual infeasible warm basis (lb=-inf)")
            self.vstat[: self.n][wrong_lb] = AT_UB
            self.vstat[: self.n][wrong_ub] = AT_LB
            self._rebuild_xN()
            status = self.dual(self.cost)
            if status == "infeasible":
                # Dual unbounded == primal infeasible.  Don't trust a stale
                # basis with a verdict: restore and let the cold two-phase
                # path confirm infeasibility.
                raise RuntimeError("warm dual restart declared infeasible")
            # The dual ratio test tolerates tiny dual-degenerate noise; a
            # final primal polish certifies true optimality (it exits
            # immediately when the dual restart already converged).
            status = self.primal(self.cost)
        except (RuntimeError, ValueError, np.linalg.LinAlgError):
            # ValueError/LinAlgError: numerical breakdown on a pathological
            # inherited basis — same remedy as any other warm failure.
            self.basis, self.vstat, self.Binv, self._lu = saved
            self._rebuild_xN()
            # Don't charge the abandoned attempt's pivots to the cold solve
            # that follows (keeps LPResult.pivots meaning "pivots of the
            # path that produced the answer").
            self.pivots = 0
            return None
        return status

    def export_basis(self) -> BasisState | None:
        """Package the optimal basis as a warm-start token (None if artificial)."""
        if np.any(self.basis >= self.n):  # degenerate artificial left over
            return None
        return BasisState(
            key=self._ikey,
            basis=self.basis.copy(),
            vstat=self.vstat[: self.n].copy(),
        )


def solve_lp_revised(
    c,
    A_eq,
    b_eq,
    lb=None,
    ub=None,
    warm: BasisState | None = None,
    max_iter: int = 20000,
    pricing: str = "auto",
    engine: str = "auto",
) -> LPResult:
    """Minimize c@x s.t. A_eq@x=b_eq, lb<=x<=ub via revised simplex.

    ``warm`` is an opaque ``BasisState`` from a previous solve of a
    same-shaped instance; on acceptance the solve is a dual-simplex restart
    (typically a handful of pivots when only b or the bound floors moved).
    The returned ``LPResult.basis`` is the new token to thread forward.

    ``A_eq`` may be a ``scipy.sparse`` matrix — the LU engine prices
    through it directly, skipping the dense instance entirely (the Eq.-14
    LP at M=256 is ~2 MB sparse vs ~270 MB dense).  ``pricing`` selects
    the entering-variable rule ("auto"/"dantzig"/"partial"/"devex");
    ``engine`` the basis factorization ("auto"/"dense"/"lu").  The
    defaults preserve the historical bit-exact behavior on small
    instances and switch to sparse-LU + partial pricing above
    ``_LU_MIN_ROWS``.
    """
    c = np.asarray(c, dtype=np.float64)
    if _is_sparse(A_eq):
        A = A_eq
    else:
        A = np.asarray(A_eq, dtype=np.float64)
    b = np.asarray(b_eq, dtype=np.float64)
    n = c.shape[0]
    lb = np.zeros(n) if lb is None else np.asarray(lb, dtype=np.float64).copy()
    ub = np.full(n, np.inf) if ub is None else np.asarray(ub, dtype=np.float64).copy()
    if np.any(lb > ub + _EPS):
        return LPResult(None, np.inf, "infeasible")

    S = _Simplex(c, A, b, lb, ub, max_iter=max_iter,
                 pricing=pricing, engine=engine)
    warm_status = S.try_warm(warm) if warm is not None else None
    if warm_status == "unbounded":
        return LPResult(None, -np.inf, "unbounded",
                        pivots=S.pivots, warm_used=True)
    if warm_status == "optimal":
        x = S._x_full()[:n]
        return LPResult(
            x, float(c @ x), "optimal",
            basis=S.export_basis(), pivots=S.pivots, warm_used=True,
        )

    if S.phase1() == "infeasible":
        return LPResult(
            None, np.inf, "infeasible",
            basis=None, pivots=S.pivots, warm_used=False,
        )
    status = S.primal(S.cost)
    if status == "unbounded":
        return LPResult(None, -np.inf, "unbounded", pivots=S.pivots)
    x = S._x_full()[:n]
    return LPResult(
        x, float(c @ x), "optimal",
        basis=S.export_basis(), pivots=S.pivots, warm_used=False,
    )
