"""Lockstep batched bounded-variable simplex in float64 on a torch device.

``solve_lp_batch_torch`` is the device twin of
``repro_torch.solver.batch.solve_lp_batch`` and the counterpart of the JAX
package's ``solver/batch_jax.py``: S same-layout instances (shared ``c``/
``A``, per-instance ``b`` and bounds -- the Eq.-14 (rho, t_bar) grid shape)
advance in lockstep on the device.  Every iteration prices every instance
with one stacked matmul, runs every ratio test as a stacked reduction and
applies every basis update as a batched rank-1 product on the (S, m, m)
inverse stack, with **masked termination**: finished instances go on as
no-ops under a ``run`` mask and their pivot counts stop.

The pivot rules are those of ``solver.batch``, written out: Dantzig
pricing with a per-instance Bland fallback after ``2m + 16`` stalled
iterations, bound flips, ties in the ratio test broken by the largest
|pivot| (Bland: the smallest basic index), a refactorisation
(``torch.linalg.inv_ex`` on the basis matrices) every ``refactor_every``
pivots or on a pivot below ``_PIV_MIN``, chosen per instance.  Every
``argmax`` takes the first index of the maximum explicitly
(``_first_argmax``), so no library's tie convention decides a pivot.

The JAX program decides "refactor now?" on the device (``lax.cond``);
eager torch would need a read-back every iteration.  Instead the loop runs
in **windows** of up to ``_WINDOW`` iterations with no read-back inside:

- the refactor schedule is known on the host: an instance with p pivots
  reaches its next scheduled refactor no sooner than ``refactor_every -
  p % refactor_every`` iterations on (one pivot an iteration at most), so
  a window stops short of the first such iteration, which then runs alone
  with a read-back of its refactor mask;
- a tiny pivot cannot be foreseen: the window records it in a device
  flag, and a window that raised it is rolled back to a snapshot taken at
  its start and run again an iteration at a time, each with its refactor
  read-back;
- one read-back at the window's end brings the running mask, the pivot
  counts and the flag together.  Iterations after every instance has
  finished are masked no-ops, so the answer is the same as with a
  read-back every iteration.

On CUDA one iteration's ~220 kernels are captured once into a CUDA graph
and replayed, so an iteration costs one graph launch on the host rather
than ~220 kernel launches.  No padding of S: eager torch compiles
nothing.  The device's reductions sum in another order than numpy, so a
near-tie in pricing can go the other way; away from ties the pivot path
is numpy's.  Cold start only, like the numpy path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.solver.batch import (
    _EPS,
    _PIV_MIN,
    _STATUS,
    AT_LB,
    AT_UB,
    BASIC,
    INFEAS,
    LIMIT,
    OPT,
    RUN,
    UNB,
)
from repro_torch.solver.result import LPResult

F64 = torch.float64
_WINDOW = 8  # iterations between read-backs


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Per row, the first index holding the row's maximum (numpy's
    ``argmax`` rule, written out)."""
    k = x.shape[1]
    ar = torch.arange(k, device=x.device)
    top = x.max(dim=1, keepdim=True).values
    return torch.where(x == top, ar, k).min(dim=1).values.clamp_max(k - 1)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Per row, the first True index; 0 for a row with none (numpy's
    ``argmax`` of a bool row)."""
    k = mask.shape[1]
    ar = torch.arange(k, device=mask.device)
    idx = torch.where(mask, ar, k).min(dim=1).values
    return torch.where(idx == k, 0, idx)


class _TorchBatchSimplex:
    """One lockstep two-phase run over S instances, state on ``device``.

    Every tensor an iteration updates is a fixed buffer updated in place,
    so the iteration can be replayed as a CUDA graph.
    """

    _STATE = ("vstat", "basis", "xN", "xB", "Binv", "status", "pivots", "run",
              "bland", "stall", "best")

    def __init__(self, c, A, b, lb, ub, live, device, max_iter, refactor_every):
        def t(a):
            return torch.as_tensor(a, dtype=F64, device=device)

        self.S, self.m = b.shape
        self.n = c.shape[0]
        S, m, n = self.S, self.m, self.n
        self.dev = device
        self.inf = torch.tensor(float("inf"), dtype=F64, device=device)
        self.max_iter = max_iter
        self.refactor_every = refactor_every
        self.A, self.b, self.c = t(A), t(b), t(c)
        self.sidx = torch.arange(S, device=device)
        self.lbw = torch.cat([t(lb), torch.zeros((S, m), dtype=F64, device=device)], 1)
        ub0 = torch.cat([t(ub), torch.zeros((S, m), dtype=F64, device=device)], 1)
        self.ub_phase2 = ub0
        vstat = torch.full((S, n + m), AT_LB, dtype=torch.int64, device=device)
        vstat[:, :n] = torch.where(torch.isfinite(self.lbw[:, :n]), AT_LB, AT_UB)
        xN = torch.where(vstat == AT_UB, ub0, self.lbw)
        r0 = self.b - xN[:, :n] @ self.A.T
        self.art_sign = torch.where(r0 >= 0.0, 1.0, -1.0).to(F64)
        self.basis = torch.arange(n, n + m, device=device).repeat(S, 1)
        vstat[:, n:] = BASIC
        xN[:, n:] = 0.0
        self.vstat, self.xN = vstat, xN
        self.Binv = torch.eye(m, dtype=F64, device=device)[None] * self.art_sign[:, :, None]
        self.ub_phase1 = ub0.clone()
        self.ub_phase1[:, n:] = float("inf")  # artificials live in phase 1
        self.ubw = self.ub_phase1.clone()  # the current phase's bounds
        self.cost = torch.zeros(n + m, dtype=F64, device=device)
        self.movable = torch.zeros((S, n + m), dtype=torch.bool, device=device)
        live = torch.as_tensor(live, device=device)
        self.status = torch.where(live, RUN, INFEAS).to(torch.int64)
        self.pivots = torch.zeros(S, dtype=torch.int64, device=device)
        self.xB = torch.zeros((S, m), dtype=F64, device=device)
        self.run = live.clone()
        self.bland = torch.zeros(S, dtype=torch.bool, device=device)
        self.stall = torch.zeros(S, dtype=torch.int64, device=device)
        self.best = torch.full((S,), float("inf"), dtype=F64, device=device)
        self.need_rf = torch.zeros(S, dtype=torch.bool, device=device)
        self.rf_hit = torch.zeros((), dtype=torch.bool, device=device)
        self.snapshot = None
        self.graph = None
        self.use_graph = True  # False: every iteration's kernels launched eagerly
        # Iterations run (a rolled-back window's counted twice), windows
        # rolled back, and device-to-host read-backs.
        self.iterations = self.rollbacks = self.readbacks = 0

    # -- shared helpers ------------------------------------------------------
    def compute_xB(self):
        """Basic values B^-1 (b - N xN) for the whole stack."""
        n = self.n
        rhs = self.b - self.xN[:, :n] @ self.A.T - self.art_sign * self.xN[:, n:]
        return torch.bmm(self.Binv, rhs[:, :, None])[:, :, 0]

    def basis_mats(self, idx):
        """(K, m, m) basis matrices of instances ``idx``, from their columns."""
        m, n = self.m, self.n
        basis = self.basis[idx]
        struct = basis < n
        gath = self.A.T[basis.clamp(0, n - 1)]  # (K, col, row)
        rows = (basis - n).clamp(0, m - 1)
        sign = self.art_sign[idx].gather(1, rows)
        ar = torch.arange(m, device=self.dev)
        art = (ar[None, None, :] == rows[:, :, None]) * sign[:, :, None]
        return torch.where(struct[:, :, None], gath, art).transpose(1, 2)

    def work_cols(self, j):
        """(S, m) dense working column j[s] of every instance."""
        m, n = self.m, self.n
        wc_struct = self.A.T[j.clamp(0, n - 1)]
        rows = (j - n).clamp(0, m - 1)
        sign = self.art_sign[self.sidx, rows]
        ar = torch.arange(m, device=self.dev)
        wc_art = (ar[None, :] == rows[:, None]) * sign[:, None]
        return torch.where((j < n)[:, None], wc_struct, wc_art)

    def refactor(self, idx):
        """Rebuild B^-1 of instances ``idx``; a singular basis ends its
        instance as LIMIT (numerical breakdown)."""
        Binv_new, info = torch.linalg.inv_ex(self.basis_mats(idx))
        ok = (info == 0) & torch.isfinite(Binv_new).all(dim=2).all(dim=1)
        self.Binv[idx] = torch.where(ok[:, None, None], Binv_new, self.Binv[idx])
        self.status[idx] = torch.where(ok, self.status[idx], LIMIT)
        alive = ok & self.run[idx]
        self.run[idx] = alive
        xB_new = self.compute_xB()[idx]
        self.xB[idx] = torch.where(alive[:, None], xB_new, self.xB[idx])

    def apply_refactors(self):
        """Read back the last iteration's refactor mask (one sync) and
        refactor those instances."""
        self.readbacks += 1
        rf = torch.nonzero(self.need_rf.cpu()).flatten()
        if rf.numel():
            self.refactor(rf.to(self.dev))

    def masked_pivot(self, mask, r, j, leave_to, w, xj_new):
        """Apply one basis swap where ``mask`` holds: bookkeeping and a
        batched rank-1 update of the inverse stack.  Instances whose pivot
        count hits the schedule or whose pivot is tiny skip the update and
        are marked in ``need_rf`` (and ``rf_hit``) for a refactorisation."""
        sidx = self.sidx
        leaving = self.basis[sidx, r]
        self.vstat[sidx, leaving] = torch.where(mask, leave_to, self.vstat[sidx, leaving])
        self.vstat[sidx, j] = torch.where(mask, BASIC, self.vstat[sidx, j])
        self.basis[sidx, r] = torch.where(mask, j, self.basis[sidx, r])
        leave_x = torch.where(leave_to == AT_UB, self.ubw[sidx, leaving],
                              self.lbw[sidx, leaving])
        self.xN[sidx, leaving] = torch.where(mask, leave_x, self.xN[sidx, leaving])
        self.xN[sidx, j] = torch.where(mask, 0.0, self.xN[sidx, j])
        self.pivots += mask.to(torch.int64)
        wr = w[sidx, r]
        need_rf = mask & ((self.pivots % self.refactor_every == 0) | (wr.abs() < _PIV_MIN))
        self.need_rf.copy_(need_rf)
        self.rf_hit.logical_or_(need_rf.any())
        upd = mask & ~need_rf
        # Product-form rank-1 update (the divide guarded; masked out anyway).
        safe_wr = torch.where(wr.abs() > 0.0, wr, 1.0)
        prow = self.Binv[sidx, r] / safe_wr[:, None]
        self.Binv.sub_(torch.where(upd[:, None, None], w[:, :, None] * prow[:, None, :], 0.0))
        self.Binv[sidx, r] = torch.where(upd[:, None], prow, self.Binv[sidx, r])
        self.xB[sidx, r] = torch.where(upd, xj_new, self.xB[sidx, r])

    # -- primal simplex (lockstep, masked) -----------------------------------
    def step(self):
        """One lockstep iteration of every running instance, in place (no
        read-back, so a CUDA graph can hold it)."""
        m, n = self.m, self.n
        sidx = self.sidx
        run, cost, lbw, ubw = self.run, self.cost, self.lbw, self.ubw
        vstat, basis, xB, xN = self.vstat, self.basis, self.xB, self.xN
        costB = cost[basis]
        obj = (costB * xB).sum(dim=1) + xN @ cost
        better = obj < self.best - 1e-12
        self.best.copy_(torch.where(run & better, obj, self.best))
        stall_new = torch.where(better, 0, self.stall + 1)
        bland_new = torch.where(better, False, self.bland | (stall_new > 2 * m + 16))
        self.stall.copy_(torch.where(run, stall_new, self.stall))
        self.bland.copy_(torch.where(run, bland_new, self.bland))
        bland = self.bland
        # Pricing: one stacked matmul covers every instance.
        y = torch.bmm(costB[:, None, :], self.Binv)[:, 0]
        dred = torch.cat([cost[:n] - y @ self.A, cost[n:] - y * self.art_sign], dim=1)
        elig = self.movable & (((vstat == AT_LB) & (dred < -_EPS))
                               | ((vstat == AT_UB) & (dred > _EPS)))
        elig = elig & run[:, None]
        act = run & elig.any(dim=1)  # phase-optimal instances retire
        j_dz = _first_argmax(torch.where(elig, dred.abs(), -1.0))
        j = torch.where(bland, _first_true(elig), j_dz)
        at_lb = vstat[sidx, j] == AT_LB
        sdir = torch.where(at_lb, 1.0, -1.0).to(F64)
        w = torch.bmm(self.Binv, self.work_cols(j)[:, :, None])[:, :, 0]
        dxB = -sdir[:, None] * w
        lbB = lbw.gather(1, basis)
        ubB = ubw.gather(1, basis)
        inc = dxB > _EPS
        dec = dxB < -_EPS
        inf = self.inf
        t_up = torch.where(inc, (ubB - xB) / torch.where(inc, dxB, 1.0), inf)
        t_lo = torch.where(dec, (lbB - xB) / torch.where(dec, dxB, 1.0), inf)
        t_up = torch.where(torch.isnan(t_up), inf, t_up.clamp_min(0.0))
        t_lo = torch.where(torch.isnan(t_lo), inf, t_lo.clamp_min(0.0))
        t_row = torch.minimum(t_up, t_lo)
        rmin = t_row.min(dim=1).values
        t_flip = ubw[sidx, j] - lbw[sidx, j]
        unb = act & ~torch.isfinite(torch.minimum(rmin, t_flip))
        self.status.copy_(torch.where(unb, UNB, self.status))
        flip = act & ~unb & (t_flip < rmin - 1e-12)
        xB_f = torch.where(flip[:, None], xB + dxB * t_flip[:, None], xB)
        newst = torch.where(at_lb, AT_UB, AT_LB)
        vstat[sidx, j] = torch.where(flip, newst, vstat[sidx, j])
        flip_x = torch.where(newst == AT_UB, ubw[sidx, j], lbw[sidx, j])
        xN[sidx, j] = torch.where(flip, flip_x, xN[sidx, j])
        piv = act & ~unb & ~flip
        cand = t_row <= (rmin + _EPS)[:, None]
        r_dz = _first_argmax(torch.where(cand, dxB.abs(), -1.0))
        r_bl = _first_argmax(torch.where(cand, -basis.to(F64), -inf))
        r = torch.where(bland, r_bl, r_dz)
        leave_to = torch.where(t_up[sidx, r] <= t_lo[sidx, r], AT_UB, AT_LB)
        xj_new = xN[sidx, j] + sdir * rmin
        xB.copy_(torch.where(piv[:, None], xB_f + dxB * rmin[:, None], xB_f))
        run.copy_(act & ~unb)
        self.masked_pivot(piv, r, j, leave_to, w, xj_new)

    def run_steps(self, k):
        """k iterations with no read-back: on CUDA as replays of one graph
        of ``step`` (captured at the first call, after one eager
        iteration on a side stream has warmed the libraries up)."""
        self.iterations += k
        if self.dev.type != "cuda" or not self.use_graph:
            for _ in range(k):
                self.step()
            return
        if self.graph is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.step()  # recorded, not run
            k -= 1
        for _ in range(k):
            self.graph.replay()

    def flags(self):
        """One read-back: the running mask, the pivot counts and the
        window's tiny-pivot flag, as host arrays."""
        self.readbacks += 1
        packed = torch.cat([self.run.to(torch.int64), self.pivots,
                            self.rf_hit.to(torch.int64)[None]]).cpu().numpy()
        S = self.S
        return packed[:S].astype(bool), packed[S:2 * S], bool(packed[-1])

    def phase(self, cost, ubw):
        """Advance every running instance to phase optimality."""
        self.cost.copy_(cost)
        self.ubw.copy_(ubw)
        self.movable.copy_((self.ubw - self.lbw) > _EPS)
        self.xB.copy_(torch.where(self.run[:, None], self.compute_xB(), self.xB))
        self.bland.fill_(False)
        self.stall.zero_()
        self.best.fill_(float("inf"))
        R = self.refactor_every
        run, pivots, _ = self.flags()
        it = 0
        while it < self.max_iter and run.any():
            # Iterations before any running instance can reach its
            # scheduled refactor (one pivot an iteration at most).
            clear = int((R - pivots[run] % R).min()) - 1
            k = min(_WINDOW, self.max_iter - it, clear)
            if k == 0:
                self.run_steps(1)
                self.apply_refactors()
                k = 1
            else:
                if self.snapshot is None:
                    self.snapshot = {a: getattr(self, a).clone() for a in self._STATE}
                else:
                    for a in self._STATE:
                        self.snapshot[a].copy_(getattr(self, a))
                self.rf_hit.fill_(False)
                self.run_steps(k)
                if self.flags()[2]:  # a tiny pivot: redo the window with read-backs
                    self.rollbacks += 1
                    for a in self._STATE:
                        getattr(self, a).copy_(self.snapshot[a])
                    for _ in range(k):
                        self.run_steps(1)
                        self.apply_refactors()
            it += k
            run, pivots, _ = self.flags()
        self.status.copy_(torch.where(self.run, LIMIT, self.status))  # iteration cap
        self.run.fill_(False)

    def drive_out_artificials(self):
        """Pivot leftover degenerate artificials out of the basis, row by
        row, each onto the first free column with a nonzero entry."""
        m, n = self.m, self.n
        rows = torch.nonzero(((self.basis >= n) & (self.status == RUN)[:, None]).any(dim=0))
        leave = torch.full((self.S,), AT_LB, dtype=torch.int64, device=self.dev)
        for r in rows.flatten().tolist():
            isart = (self.status == RUN) & (self.basis[:, r] >= n)
            row = self.Binv[:, r, :] @ self.A
            free = (self.vstat[:, :n] != BASIC) & (row.abs() > 1e-7)
            mask = isart & free.any(dim=1)
            jj = _first_true(free)
            w = torch.bmm(self.Binv, self.work_cols(jj)[:, :, None])[:, :, 0]
            rvec = torch.full((self.S,), r, dtype=torch.int64, device=self.dev)
            self.run |= mask  # the refactor path needs liveness
            self.masked_pivot(mask, rvec, jj, leave, w, self.xN[self.sidx, jj])
            self.apply_refactors()
            self.run &= ~mask

    def solve(self):
        """Phase 1 on the artificials, then phase 2 on ``c``."""
        m, n = self.m, self.n
        cost1 = torch.cat([torch.zeros(n, dtype=F64, device=self.dev),
                           torch.ones(m, dtype=F64, device=self.dev)])
        self.phase(cost1, self.ub_phase1)
        still = self.status == RUN
        self.xB.copy_(torch.where(still[:, None], self.compute_xB(), self.xB))
        art_obj = torch.where(self.basis >= n, self.xB, 0.0).sum(dim=1)
        self.status.copy_(torch.where(still & (art_obj > 1e-7), INFEAS, self.status))
        self.drive_out_artificials()
        self.run.copy_(self.status == RUN)
        cost2 = torch.cat([self.c, torch.zeros(m, dtype=F64, device=self.dev)])
        self.phase(cost2, self.ub_phase2)  # artificials pinned at 0
        self.graph = None
        self.status.copy_(torch.where(self.status == RUN, OPT, self.status))
        x = self.xN.clone()
        x.scatter_(1, self.basis, self.xB)
        return x[:, :n], self.status, self.pivots


def make_solver(c, A, b_stack, lb_stack=None, ub_stack=None, max_iter: int = 20000,
                refactor_every: int = 64, device=None) -> _TorchBatchSimplex:
    """The lockstep run ``solve_lp_batch_torch`` makes, before it solves:
    its ``solve()`` returns the device tensors (x, status, pivots), and
    its ``iterations``, ``rollbacks`` and ``readbacks`` count the run."""
    dev = resolve_device(device)
    c = np.asarray(c, dtype=np.float64)
    if hasattr(A, "toarray") and not isinstance(A, np.ndarray):
        A = A.toarray()
    A = np.asarray(A, dtype=np.float64)
    b = np.atleast_2d(np.asarray(b_stack, dtype=np.float64))
    S = b.shape[0]
    n = c.shape[0]
    lb = np.zeros(n) if lb_stack is None else np.asarray(lb_stack, np.float64)
    ub = (np.full(n, np.inf) if ub_stack is None
          else np.asarray(ub_stack, np.float64))
    lb = np.broadcast_to(lb, (S, n)).copy()
    ub = np.broadcast_to(ub, (S, n)).copy()
    if np.any(~np.isfinite(lb) & ~np.isfinite(ub)):
        raise ValueError("free variables (lb and ub infinite) unsupported")
    live = ~(lb > ub + _EPS).any(axis=1)
    return _TorchBatchSimplex(c, A, b, lb, ub, live, dev, int(max_iter), int(refactor_every))


def solve_lp_batch_torch(
    c,
    A,
    b_stack,
    lb_stack=None,
    ub_stack=None,
    max_iter: int = 20000,
    refactor_every: int = 64,
    device=None,
) -> list[LPResult]:
    """Solve S instances min c@x s.t. A@x=b_s, lb_s<=x<=ub_s on ``device``.

    Drop-in for ``repro_torch.solver.batch.solve_lp_batch`` with the same
    call and return conventions (one ``LPResult`` per instance, cold
    start, a sparse ``A`` densified), run in float64 on ``device``: CUDA by
    default, raising without a card; ``device="cpu"`` runs it on the CPU.
    """
    sol = make_solver(c, A, b_stack, lb_stack, ub_stack, max_iter, refactor_every, device)
    x, status, pivots = sol.solve()
    x = x.cpu().numpy()
    status = status.cpu().numpy()
    pivots = pivots.cpu().numpy()
    c = np.asarray(c, dtype=np.float64)
    out = []
    for s in range(sol.S):
        st = _STATUS[int(status[s])]
        piv = int(pivots[s])
        if st != "optimal":
            fun = -np.inf if st == "unbounded" else np.inf
            out.append(LPResult(None, fun, st, pivots=piv))
            continue
        xs = x[s]
        out.append(LPResult(xs, float(c @ xs), "optimal", pivots=piv))
    return out
