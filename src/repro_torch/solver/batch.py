"""Lockstep batched bounded-variable simplex over same-layout instances.

``solve_lp_batch`` solves S instances that share one constraint matrix A
(and hence one variable layout) but differ in the right-hand side ``b``
and/or the bounds — exactly the shape of an Eq.-14 (rho, t_bar) grid
sweep, where ``b`` carries t_bar and the lower-bound floors carry rho.

All S instances advance in lockstep: one iteration prices every active
instance with a single (S, m) x (m, n) matmul, runs every ratio test as
one stacked reduction, and applies every eta update as one batched rank-1
— "price and ratio-test in one dispatch" instead of S sequential solver
runs.  Instances converge (or fail) independently: finished ones drop out
of the active set while the rest keep iterating.

The algorithm is the same bounded-variable two-phase simplex as
``repro.solver.revised`` (implicit bounds, bound flips, Dantzig pricing
with per-instance Bland fallback, periodic batched refactorization via
``np.linalg.inv`` on the (K, m, m) basis stack).  It is a cold-start
path: no warm bases in or out — the sweep's parallelism replaces the
serial sweep's dual-simplex restarts.  Numerics follow a different
summation order than the serial solver (batched GEMMs), so results agree
with the serial path to solver tolerance, not bit-for-bit; callers that
need bit-stable policies (the engine-parity suites) use the serial path.
"""

from __future__ import annotations

import numpy as np

from repro_torch.solver.result import LPResult

_EPS = 1e-9
_FEAS = 1e-8
_PIV_MIN = 1e-10

AT_LB, AT_UB, BASIC = 0, 1, 2
# Per-instance terminal states.
RUN, OPT, INFEAS, UNB, LIMIT = 0, 1, 2, 3, 4
_STATUS = {OPT: "optimal", INFEAS: "infeasible", UNB: "unbounded",
           LIMIT: "iteration_limit"}


class _BatchSimplex:
    """One lockstep run over S same-layout instances."""

    def __init__(self, c, A, b, lb, ub, max_iter=20000, refactor_every=64):
        """Stack the S instances into lockstep arrays and init bound statuses."""
        self.S, self.m = b.shape
        self.n = c.shape[0]
        S, m, n = self.S, self.m, self.n
        self.A = A
        self.b = b
        self.cost = np.concatenate([c, np.zeros(m)])
        self.lbw = np.concatenate([lb, np.zeros((S, m))], axis=1)
        self.ubw = np.concatenate([ub, np.zeros((S, m))], axis=1)
        self.vstat = np.full((S, n + m), AT_LB, dtype=np.int8)
        no_lb = ~np.isfinite(self.lbw[:, :n])
        if np.any(no_lb & ~np.isfinite(self.ubw[:, :n])):
            raise ValueError("free variables (lb and ub infinite) unsupported")
        self.vstat[:, :n][no_lb] = AT_UB
        self.art_sign = np.ones((S, m))
        self.basis = np.tile(np.arange(n, n + m), (S, 1))
        self.Binv = np.tile(np.eye(m), (S, 1, 1))
        self.xB = np.zeros((S, m))
        self.xN = np.zeros((S, n + m))
        self.status = np.full(S, RUN, dtype=np.int8)
        self.pivots = np.zeros(S, dtype=np.int64)
        self.max_iter = max_iter
        self.refactor_every = refactor_every
        self._run = np.zeros(S, dtype=bool)  # active mask of current phase

    # -- shared helpers -----------------------------------------------------
    def _rebuild_xN(self, idx):
        x = np.where(self.vstat[idx] == AT_UB, self.ubw[idx], self.lbw[idx])
        x[self.vstat[idx] == BASIC] = 0.0
        self.xN[idx] = x

    def _compute_xB(self, idx):
        rhs = self.b[idx] - self.xN[idx, : self.n] @ self.A.T
        rhs = rhs - self.art_sign[idx] * self.xN[idx, self.n:]
        self.xB[idx] = np.einsum("kmn,kn->km", self.Binv[idx], rhs)

    def _basis_mats(self, idx):
        basisK = self.basis[idx]
        K, m, n = len(idx), self.m, self.n
        B = np.zeros((K, m, m))
        struct = basisK < n
        kk, cc = np.nonzero(struct)
        B[kk, :, cc] = self.A[:, basisK[kk, cc]].T
        ka, ca = np.nonzero(~struct)
        rows = basisK[ka, ca] - n
        B[ka, rows, ca] = self.art_sign[idx[ka], rows]
        return B

    def _refactor(self, idx):
        if idx.size == 0:
            return
        B = self._basis_mats(idx)
        try:
            Binv = np.linalg.inv(B)
        except np.linalg.LinAlgError:
            Binv = np.empty_like(B)
            for k in range(len(idx)):
                try:
                    Binv[k] = np.linalg.inv(B[k])
                except np.linalg.LinAlgError:
                    Binv[k] = np.nan
        ok = np.isfinite(Binv).all(axis=(1, 2))
        self.Binv[idx[ok]] = Binv[ok]
        dead = idx[~ok]  # numerical breakdown: give up on those instances
        self.status[dead] = LIMIT
        self._run[dead] = False

    def _work_cols(self, idx, j):
        """(K, m) dense working columns j (per instance)."""
        cols = np.zeros((len(idx), self.m))
        struct = j < self.n
        cols[struct] = self.A[:, j[struct]].T
        arti = np.flatnonzero(~struct)
        rows = j[arti] - self.n
        cols[arti, rows] = self.art_sign[idx[arti], rows]
        return cols

    def _do_pivot(self, pi, r, j, leave_to, w, xj_new):
        """Batched basis swap: instance pi[k] pivots column j[k] into row r[k]."""
        K = pi.size
        ar = np.arange(K)
        leaving = self.basis[pi, r]
        self.vstat[pi, leaving] = leave_to
        self.vstat[pi, j] = BASIC
        self.basis[pi, r] = j
        self.xN[pi, leaving] = np.where(
            leave_to == AT_UB, self.ubw[pi, leaving], self.lbw[pi, leaving]
        )
        self.xN[pi, j] = 0.0
        self.pivots[pi] += 1
        wr = w[ar, r]
        need_rf = (self.pivots[pi] % self.refactor_every == 0) | (
            np.abs(wr) < _PIV_MIN
        )
        upd = np.flatnonzero(~need_rf)
        if upd.size:
            u, ru = pi[upd], r[upd]
            prow = self.Binv[u, ru] / wr[upd][:, None]
            self.Binv[u] -= w[upd][:, :, None] * prow[:, None, :]
            self.Binv[u, ru] = prow
            self.xB[u, ru] = xj_new[upd]
        rf = np.flatnonzero(need_rf)
        if rf.size:
            self._refactor(pi[rf])
            alive = pi[rf][self._run[pi[rf]]]
            self._compute_xB(alive)

    # -- primal simplex (lockstep) ------------------------------------------
    def _primal(self, cost):
        """Advance every ``self._run`` instance to phase optimality.

        Clears ``self._run`` as instances finish; terminal failures
        (unbounded / iteration cap / breakdown) also set ``self.status``.
        """
        S = self.S
        bland = np.zeros(S, dtype=bool)
        stall = np.zeros(S, dtype=np.int64)
        best = np.full(S, np.inf)
        movable = (self.ubw - self.lbw) > _EPS
        self._compute_xB(np.flatnonzero(self._run))
        for _ in range(self.max_iter):
            idx = np.flatnonzero(self._run)
            if idx.size == 0:
                return
            costB = cost[self.basis[idx]]
            obj = np.einsum("km,km->k", costB, self.xB[idx]) + self.xN[idx] @ cost
            better = obj < best[idx] - 1e-12
            best[idx] = np.where(better, obj, best[idx])
            new_stall = np.where(better, 0, stall[idx] + 1)
            stall[idx] = new_stall
            bland[idx] = np.where(
                better, False, bland[idx] | (new_stall > 2 * self.m + 16)
            )
            # Pricing: one stacked GEMM covers every active instance.
            y = np.einsum("km,kmn->kn", costB, self.Binv[idx])
            d = np.empty((idx.size, self.n + self.m))
            d[:, : self.n] = cost[: self.n] - y @ self.A
            d[:, self.n:] = cost[self.n:] - y * self.art_sign[idx]
            st = self.vstat[idx]
            elig = movable[idx] & (
                ((st == AT_LB) & (d < -_EPS)) | ((st == AT_UB) & (d > _EPS))
            )
            has = elig.any(axis=1)
            self._run[idx[~has]] = False  # phase optimal
            if not has.any():
                continue
            idx, d, elig = idx[has], d[has], elig[has]
            j = np.argmax(np.where(elig, np.abs(d), -1.0), axis=1)
            j = np.where(bland[idx], np.argmax(elig, axis=1), j)
            K = idx.size
            ar = np.arange(K)
            sdir = np.where(self.vstat[idx, j] == AT_LB, 1.0, -1.0)
            w = np.einsum(
                "kmn,kn->km", self.Binv[idx], self._work_cols(idx, j)
            )
            dxB = -sdir[:, None] * w
            lbB = np.take_along_axis(self.lbw[idx], self.basis[idx], axis=1)
            ubB = np.take_along_axis(self.ubw[idx], self.basis[idx], axis=1)
            xB = self.xB[idx]
            inc = dxB > _EPS
            dec = dxB < -_EPS
            with np.errstate(divide="ignore", invalid="ignore"):
                t_up = np.where(inc, (ubB - xB) / dxB, np.inf)
                t_lo = np.where(dec, (lbB - xB) / dxB, np.inf)
            t_up = np.where(np.isnan(t_up), np.inf, np.maximum(t_up, 0.0))
            t_lo = np.where(np.isnan(t_lo), np.inf, np.maximum(t_lo, 0.0))
            t_row = np.minimum(t_up, t_lo)
            rmin = t_row.min(axis=1)
            t_flip = self.ubw[idx, j] - self.lbw[idx, j]
            unb = ~np.isfinite(np.minimum(rmin, t_flip))
            if unb.any():
                u = idx[unb]
                self.status[u] = UNB
                self._run[u] = False
            flip = ~unb & (t_flip < rmin - 1e-12)
            if flip.any():
                f = np.flatnonzero(flip)
                fi, jf = idx[f], j[f]
                self.xB[fi] += dxB[f] * t_flip[f, None]
                new = np.where(
                    self.vstat[fi, jf] == AT_LB, AT_UB, AT_LB
                ).astype(np.int8)
                self.vstat[fi, jf] = new
                self.xN[fi, jf] = np.where(
                    new == AT_UB, self.ubw[fi, jf], self.lbw[fi, jf]
                )
            piv = ~unb & ~flip
            if piv.any():
                p = np.flatnonzero(piv)
                pi = idx[p]
                cand = t_row[p] <= (rmin[p] + _EPS)[:, None]
                r = np.argmax(np.where(cand, np.abs(dxB[p]), -1.0), axis=1)
                rb = np.argmax(
                    np.where(cand, -self.basis[pi].astype(float), -np.inf),
                    axis=1,
                )
                r = np.where(bland[pi], rb, r)
                pr = np.arange(p.size)
                leave_to = np.where(
                    t_up[p, r] <= t_lo[p, r], AT_UB, AT_LB
                ).astype(np.int8)[pr]
                xj_new = self.xN[pi, j[p]] + sdir[p] * rmin[p]
                self.xB[pi] += dxB[p] * rmin[p][:, None]
                self._do_pivot(pi, r, j[p], leave_to, w[p], xj_new)
        left = np.flatnonzero(self._run)
        self.status[left] = LIMIT
        self._run[left] = False

    # -- two-phase driver ---------------------------------------------------
    def solve(self):
        """Run phase 1 then phase 2 to completion on every live instance."""
        S, m, n = self.S, self.m, self.n
        live = self.status == RUN
        idx = np.flatnonzero(live)
        self._rebuild_xN(idx)
        r0 = self.b[idx] - self.xN[idx, : n] @ self.A.T
        self.art_sign[idx] = np.where(r0 >= 0.0, 1.0, -1.0)
        self.basis[idx] = np.arange(n, n + m)
        self.vstat[idx, n:] = BASIC
        self.xN[idx, n:] = 0.0
        self.Binv[idx] = np.eye(m) * self.art_sign[idx][:, :, None]
        self.ubw[idx, n:] = np.inf  # artificials live during phase 1
        cost1 = np.zeros(n + m)
        cost1[n:] = 1.0
        self._run = live.copy()
        self._primal(cost1)
        idx = np.flatnonzero(self.status == RUN)
        self._compute_xB(idx)
        art_obj = np.where(self.basis[idx] >= n, self.xB[idx], 0.0).sum(axis=1)
        bad = idx[art_obj > 1e-7]
        self.status[bad] = INFEAS
        # Drive leftover degenerate artificials out per instance (rarely
        # more than a handful of rows — not worth stacking).
        for s in np.flatnonzero(self.status == RUN):
            for r in np.flatnonzero(self.basis[s] >= n):
                row = self.Binv[s, r] @ self.A
                free = (self.vstat[s, :n] != BASIC) & (np.abs(row) > 1e-7)
                jc = np.flatnonzero(free)
                if jc.size:
                    jj = int(jc[0])
                    w = self.Binv[s] @ self._work_cols(
                        np.array([s]), np.array([jj])
                    )[0]
                    self._run[s] = True  # _do_pivot may refactor; keep alive
                    self._do_pivot(
                        np.array([s]), np.array([r]), np.array([jj]),
                        np.array([AT_LB], dtype=np.int8), w[None, :],
                        np.array([self.xN[s, jj]]),
                    )
        self.ubw[:, n:] = 0.0  # pin artificials for phase 2
        self._run = self.status == RUN
        self._primal(self.cost)
        self.status[self.status == RUN] = OPT


def solve_lp_batch(
    c,
    A,
    b_stack,
    lb_stack=None,
    ub_stack=None,
    max_iter: int = 20000,
) -> list[LPResult]:
    """Solve S instances min c@x s.t. A@x=b_s, lb_s<=x<=ub_s in lockstep.

    ``c`` (n,) and ``A`` (m, n) are shared; ``b_stack`` is (S, m);
    ``lb_stack``/``ub_stack`` broadcast from (n,) to (S, n).  Returns one
    ``LPResult`` per instance (no warm-basis export — the batched path is
    cold-start by design).  A sparse ``A`` is densified: the batched
    GEMMs want contiguous storage.
    """
    c = np.asarray(c, dtype=np.float64)
    if hasattr(A, "toarray") and not isinstance(A, np.ndarray):
        A = A.toarray()
    A = np.asarray(A, dtype=np.float64)
    b = np.atleast_2d(np.asarray(b_stack, dtype=np.float64))
    S = b.shape[0]
    n = c.shape[0]
    lb = np.zeros(n) if lb_stack is None else np.asarray(lb_stack, np.float64)
    ub = (
        np.full(n, np.inf) if ub_stack is None
        else np.asarray(ub_stack, np.float64)
    )
    lb = np.broadcast_to(lb, (S, n)).copy()
    ub = np.broadcast_to(ub, (S, n)).copy()

    solver = _BatchSimplex(c, A, b, lb, ub, max_iter=max_iter)
    solver.status[(lb > ub + _EPS).any(axis=1)] = INFEAS
    solver.solve()

    out = []
    for s in range(S):
        st = _STATUS[int(solver.status[s])]
        piv = int(solver.pivots[s])
        if st != "optimal":
            fun = -np.inf if st == "unbounded" else np.inf
            out.append(LPResult(None, fun, st, pivots=piv))
            continue
        x = solver.xN[s].copy()
        x[solver.basis[s]] = solver.xB[s]
        x = x[:n]
        out.append(LPResult(x, float(c @ x), "optimal", pivots=piv))
    return out
