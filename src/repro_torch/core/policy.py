"""Communication policy generation (paper Algorithm 3 + Appendix A).

``generate_policy_matrix`` is the Network Monitor's core computation:
a nested grid search over the mixing weight rho (outer, K points) and the
target mean iteration time t_bar (inner, R points).  Each grid point solves
the LP of Eq. (14) — minimize self-selection subject to Eqs. (10)-(13) —
and is scored by the convergence-time model T = t_bar * ln(eps)/ln(lambda2).

Solver hot path (DESIGN.md §13): every grid point is solved by the
bounded-variable revised simplex with an **optimal-basis warm start**
threaded across the whole sweep via ``WarmStartCarry`` — across the t_bar
grid only ``b`` changes and across rho steps only the Eq.-11 bound floors
change, so each re-solve is a dual-simplex restart of a handful of pivots
instead of a from-scratch two-phase solve.  The Monitor threads its carry
across policy refreshes too (steady-state re-solves start from the last
optimal basis).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

try:  # scipy ships in the target env; gate anyway per repo policy
    import scipy.sparse as _sp
except ImportError:  # pragma: no cover - exercised only without scipy
    _sp = None

from repro_torch.core import consensus, theory
from repro_torch.solver.lp import BasisState, solve_lp

# Strictness margin for the strict inequality Eq. (11): p > alpha*rho*(d+d').
_FLOOR_MARGIN = 1e-6

# At and above this M the Eq.-14 constraint matrix is built directly in CSC
# form (each column holds at most two nonzeros — the worker's Eq.-10 row and
# its Eq.-13 row), skipping the O(M^3) dense allocation entirely: ~2 MB
# sparse vs ~270 MB dense at M=256 full graph.  The solver's LU engine
# prices through CSC natively; values are identical to the dense build, so
# this is a storage choice, not a behavior change.
_SPARSE_A_MIN_M = 64


@dataclass
class WarmStartCarry:
    """Mutable warm-start state threaded across an Eq.-14 grid sweep.

    ``basis`` is the opaque ``BasisState`` of the most recent *feasible*
    solve (infeasible grid points return no reusable basis); the counters
    are diagnostics surfaced on ``PolicyResult`` and in BENCH_policy.json.
    """

    basis: BasisState | None = None
    n_solves: int = 0
    n_warm_used: int = 0
    n_pivots: int = 0
    # ``enabled=False`` keeps the counters but never feeds the basis back
    # into a solve — the cold-start baseline for BENCH_policy.json.
    enabled: bool = True


@dataclass
class PolicyResult:
    P: np.ndarray
    rho: float
    t_bar: float
    lambda2: float
    T_convergence: float
    # Diagnostics for EXPERIMENTS.md / the Monitor log.
    n_lp_solved: int = 0
    n_lp_feasible: int = 0
    grid: list = field(default_factory=list)
    # Warm-start protocol: last optimal LP basis (opaque) + sweep counters.
    # n_solves counts actual simplex runs across the whole sweep (grid
    # points skipped by the feasibility pre-check never run one), so it is
    # the denominator for a warm-start hit rate.
    basis: BasisState | None = None
    n_pivots: int = 0
    n_warm_used: int = 0
    n_solves: int = 0

    @property
    def ok(self) -> bool:
        return np.isfinite(self.T_convergence)


@dataclass
class _Eq14Instance:
    """Eq.-14 LP skeleton shared across a whole (rho, t_bar) grid sweep.

    Everything here depends only on (T, d): across the t_bar grid only
    ``b`` changes and across rho steps only the Eq.-11 bound floors, so
    the constraint matrix — the expensive part, O(M^3) dense at full
    connectivity — is built once per policy generation instead of once
    per grid point.  ``A`` is dense below ``_SPARSE_A_MIN_M`` (the
    bit-exact historical path) and CSC at scale.
    """

    M: int
    n: int
    ii: np.ndarray      # edge row indices (ascending i, ascending m per row)
    mm: np.ndarray      # edge col indices
    pos: np.ndarray     # LP variable slot of each edge
    start: np.ndarray   # LP variable slot of each diagonal p_{i,i}
    c: np.ndarray
    A: object           # ndarray or scipy.sparse CSC
    ub: np.ndarray
    dsym: np.ndarray    # d[ii, mm] + d[mm, ii] — the Eq.-11 floor weights


def _build_eq14(T: np.ndarray, d: np.ndarray) -> _Eq14Instance:
    """Build the Eq.-14 instance skeleton for connectivity ``d``.

    Variable layout matches the historical per-(i, m) Python loop exactly:
    for each worker i the diagonal p_{i,i} first, then p_{i,m} over edges
    in ascending m.  (The simplex pivot path — hence the solution bits —
    depends on variable order, so the vectorized build must preserve it.)
    """
    M = T.shape[0]
    eye = np.eye(M, dtype=bool)
    edge = (d != 0) & ~eye
    n_per_row = 1 + edge.sum(axis=1)
    start = np.concatenate(([0], np.cumsum(n_per_row)[:-1]))  # (i,i) slots
    ii, mm = np.nonzero(edge)  # row-major: ascending i, ascending m per row
    pos = start[ii] + edge.cumsum(axis=1)[ii, mm]  # edge slots
    n = int(n_per_row.sum())
    c = np.zeros(n)
    c[start] = 1.0  # objective: minimize self-selection
    ub = np.ones(n)
    dsym = d[ii, mm] + d[mm, ii]
    if M >= _SPARSE_A_MIN_M and _sp is not None:
        # Direct CSC build: diagonal columns hold one nonzero (Eq.-13 row
        # M+i), edge columns two (Eq.-10 row i with coefficient T_im, then
        # Eq.-13 row M+i) — rows ascending within each column, columns in
        # variable order, so the structure matches csc_matrix(dense).
        col_nnz = np.ones(n, dtype=np.int64)
        col_nnz[pos] = 2
        indptr = np.concatenate(([0], np.cumsum(col_nnz)))
        data = np.empty(int(indptr[-1]))
        indices = np.empty(int(indptr[-1]), dtype=np.int32)
        indices[indptr[start]] = M + np.arange(M)
        data[indptr[start]] = 1.0
        indices[indptr[pos]] = ii
        data[indptr[pos]] = T[ii, mm]
        indices[indptr[pos] + 1] = M + ii
        data[indptr[pos] + 1] = 1.0
        A = _sp.csc_matrix((data, indices, indptr), shape=(2 * M, n))
    else:
        A = np.zeros((2 * M, n))
        # Eq. (10): sum_m t_{i,m} p_{i,m} d_{i,m} = M * t_bar.
        A[ii, pos] = T[ii, mm]
        # Eq. (13): sum_m p_{i,m} = 1 (diagonal included).
        A[M + np.arange(M), start] = 1.0
        A[M + ii, pos] = 1.0
    return _Eq14Instance(M, n, ii, mm, pos, start, c, A, ub, dsym)


def _solve_policy_lp(
    T: np.ndarray,
    d: np.ndarray,
    alpha: float,
    rho: float,
    t_bar: float,
    carry: WarmStartCarry | None = None,
    inst: _Eq14Instance | None = None,
) -> np.ndarray | None:
    """LP of Eq. (14): min sum_i p_{i,i} s.t. Eqs. (10)-(13).

    Variables: p_{i,m} for every edge (d_{i,m}=1) plus every diagonal p_{i,i}
    — sparse connectivity masks shrink the variable set to live edges, which
    is where multi-cluster topologies win.  Eq. (10): per-worker expected
    iteration time == M * t_bar (equalizes p_i).  Eq. (11): p_{i,m} >=
    alpha*rho*(d_{i,m}+d_{m,i}) + margin on edges.  Eq. (13): rows sum to
    one (diagonal included).  ``carry`` (optional) supplies the warm-start
    basis for the solve and receives the updated one; ``inst`` reuses a
    prebuilt ``_Eq14Instance`` across the grid (sweeps pass it — only
    ``b`` and the floors change between grid points).
    """
    if inst is None:
        inst = _build_eq14(T, d)
    M, n = inst.M, inst.n
    lb = np.zeros(n)
    lb[inst.pos] = alpha * rho * inst.dsym + _FLOOR_MARGIN
    b = np.zeros(2 * M)
    b[:M] = M * t_bar
    b[M:] = 1.0
    warm = carry.basis if carry is not None and carry.enabled else None
    res = solve_lp(inst.c, inst.A, b, lb=lb, ub=inst.ub, warm=warm)
    if carry is not None:
        carry.n_solves += 1
        carry.n_pivots += res.pivots
        carry.n_warm_used += int(res.warm_used)
        if res.basis is not None:
            carry.basis = res.basis
    if not res.ok:
        return None
    x = np.maximum(res.x, 0.0)
    P = np.zeros((M, M))
    P[inst.ii, inst.mm] = x[inst.pos]
    P[np.arange(M), np.arange(M)] = x[inst.start]
    return P


def _t_bar_interval(
    T: np.ndarray, d: np.ndarray, alpha: float, rho: float
) -> tuple[float, float]:
    """Feasible [L, U] for t_bar (Appendix A, Eqs. 26/28).

    Broadcast over all worker rows at once — the former per-(i, m) Python
    loops made this the O(K·M²) floor of Algorithm 3 at M=64+.  The per-row
    reduction goes through ``np.cumsum`` (a sequential accumulation), so it
    is bit-identical to the historical left-to-right Python ``sum`` — the
    parity test in tests/test_policy.py pins exact equality."""
    M = T.shape[0]
    eye = np.eye(M, dtype=bool)
    terms = T * (d + d.T)
    terms[eye] = 0.0  # the loop skipped m == i
    L_rows = alpha * rho / M * np.cumsum(terms, axis=1)[:, -1]
    edge = (d != 0) & ~eye
    if not edge.any(axis=1).all():
        return (np.inf, -np.inf)  # isolated node: infeasible
    U_rows = np.where(edge, T, -np.inf).max(axis=1) / M
    return max(0.0, float(L_rows.max())), float(U_rows.min())


def _eq14_time_bounds(
    T: np.ndarray, d: np.ndarray, alpha: float, rho: float
) -> tuple[float, float]:
    """Exact feasible range of M*t_bar for the Eq.-14 LP at this rho.

    The LP couples workers only through the shared t_bar (each worker's
    variables appear in exactly its own Eq.-10 and Eq.-13 rows), so it is
    feasible iff every worker can realize sum_m T_im p_im == M*t_bar under
    its floors/caps — a per-row fractional-knapsack range: the minimum puts
    every edge at its Eq.-11 floor, the maximum greedily spends the
    remaining row budget (1 - floors, p_ii >= 0) on the slowest edges.
    Returns (max_i tmin_i, min_i tmax_i); (inf, -inf) when some row's
    floors alone overflow the row-stochastic budget.  ``inner_loop`` uses
    this to skip provably infeasible grid points without a simplex run —
    those cold, iteration-heavy phase-1 solves were most of the Algorithm-3
    wall time at M=128.
    """
    M = T.shape[0]
    eye = np.eye(M, dtype=bool)
    edge = (d != 0) & ~eye
    f = np.where(edge, alpha * rho * (d + d.T) + _FLOOR_MARGIN, 0.0)
    fsum = f.sum(axis=1)
    if np.any(fsum > 1.0 + 1e-9):
        return np.inf, -np.inf
    Te = np.where(edge, T, 0.0)
    tmin = (Te * f).sum(axis=1)
    order = np.argsort(np.where(edge, -T, np.inf), axis=1, kind="stable")
    Ts = np.take_along_axis(Te, order, axis=1)
    caps = np.take_along_axis(np.where(edge, 1.0 - f, 0.0), order, axis=1)
    taken = np.minimum(np.cumsum(caps, axis=1), (1.0 - fsum)[:, None])
    take = np.diff(taken, axis=1, prepend=0.0)
    tmax = tmin + (take * Ts).sum(axis=1)
    return float(tmin.max()), float(tmax.min())


def _rho_grid_upper(alpha: float, Tm: np.ndarray, d: np.ndarray) -> float:
    """Upper end of the outer rho grid (engineering guard, see below).

    Clamp the outer grid to the region where the inner interval [L(rho), U]
    is non-empty and the Eq.-11 floors can sum to <= 1, so no grid point is
    wasted on provably infeasible rho.  L(rho) = alpha*rho*A with A below;
    U is rho-free.  Broadcast over rows — pinned bit-exact against the
    historical per-row generator loops by tests/test_policy.py.
    """
    M = Tm.shape[0]
    U_rho = 0.5 / alpha
    dsym = d + d.T
    deg2 = dsym.sum(axis=1)
    with np.errstate(invalid="ignore"):
        A = ((Tm * dsym).sum(axis=1) / M).max()
    live = d.sum(axis=1) > 0
    if d.sum() > 0:
        U_t = ((Tm * d).max(axis=1) / M)[live].min()
    else:
        U_t = 0.0
    if A > 0:
        U_rho = min(U_rho, U_t / (A * alpha))
    if deg2.max() > 0:
        U_rho = min(U_rho, 1.0 / (alpha * deg2.max()) * (1.0 - 1e-6))
    return U_rho


def inner_loop(
    alpha: float,
    rho: float,
    R: int,
    T: np.ndarray,
    d: np.ndarray,
    eps: float = 1e-2,
    carry: WarmStartCarry | None = None,
    inst: _Eq14Instance | None = None,
) -> PolicyResult | None:
    """Algorithm 3 INNERLOOP: grid over t_bar in [L, U], LP + eig score.

    Across the grid only ``b`` changes (b[:M] = M*t_bar), so with ``carry``
    each solve after the first is a warm dual-simplex restart.  ``inst``
    (optional) reuses a prebuilt Eq.-14 skeleton — the outer loop passes
    one so the constraint matrix is built once per policy generation.
    """
    L, U = _t_bar_interval(T, d, alpha, rho)
    if not np.isfinite(U) or U <= L:
        return None
    M = T.shape[0]
    if inst is None:
        inst = _build_eq14(T, d)
    lo, hi = _eq14_time_bounds(T, d, alpha, rho)
    best: PolicyResult | None = None
    n_solved = n_feasible = 0
    grid = []
    for r in range(1, R + 1):
        t_bar = L + (U - L) * r / R
        target = M * t_bar
        tol = 1e-6 * max(1.0, abs(target))
        if target < lo - tol or target > hi + tol:
            # Provably infeasible (conservative margin: boundary points
            # still go to the LP so the verdict matches the solver's).
            # Skipped points are not counted in n_lp_solved: that counter
            # means "simplex runs", consistent with the pivot/warm counters.
            grid.append((rho, t_bar, None, np.inf))
            continue
        n_solved += 1
        try:
            P = _solve_policy_lp(T, d, alpha, rho, t_bar, carry=carry,
                                 inst=inst)
        except (RuntimeError, MemoryError):
            # Simplex iteration cap / instance too large for this grid point:
            # score it infeasible so the Monitor degrades to other grid
            # points or the uniform fallback instead of dying mid-run.
            P = None
        if P is None:
            grid.append((rho, t_bar, None, np.inf))
            continue
        n_feasible += 1
        Y = consensus.build_Y(P, alpha, rho, d)
        lam2 = theory.lambda2(Y)
        Tc = theory.convergence_time(t_bar, lam2, eps)
        grid.append((rho, t_bar, lam2, Tc))
        if best is None or Tc < best.T_convergence:
            best = PolicyResult(P, rho, t_bar, lam2, Tc)
    if best is not None:
        best.n_lp_solved = n_solved
        best.n_lp_feasible = n_feasible
        best.grid = grid
    return best


def generate_policy_matrix(
    alpha: float,
    K: int,
    R: int,
    T: np.ndarray,
    d: np.ndarray | None = None,
    eps: float = 1e-2,
    warm: BasisState | None = None,
    warm_start: bool = True,
) -> PolicyResult:
    """Algorithm 3 GENERATEPOLICYMATRIX.

    Parameters mirror the paper: learning rate alpha, outer-loop rounds K
    (grid over rho in (0, 0.5/alpha]), inner-loop rounds R (grid over t_bar),
    iteration-time matrix T.  ``d`` is the connectivity mask (default: fully
    connected on finite links — entries of T that are inf/nan are treated as
    dead links and masked out, which is how failed nodes are retired).

    ``warm`` seeds the sweep with the previous refresh's optimal basis (the
    Monitor threads this across Algorithm-1 periods); the returned
    ``PolicyResult.basis`` is the token for the next call.  A stale or
    differently-shaped token is validated and discarded by the solver, so
    callers never need to invalidate it themselves.  ``warm_start=False``
    forces every grid point to a cold solve (benchmark baseline).
    """
    T = np.asarray(T, dtype=np.float64)
    M = T.shape[0]
    if d is None:
        d = np.ones((M, M)) - np.eye(M)
    d = np.asarray(d, dtype=np.float64).copy()
    dead = ~np.isfinite(T)
    d[dead] = 0.0
    d[dead.T] = 0.0
    Tm = np.where(np.isfinite(T), T, 0.0)

    # Fault tolerance: isolated workers (all links dead) are excluded from
    # the optimization; the policy is solved on the live subgraph and
    # embedded back (dead rows/cols zero).  lambda2 then measures consensus
    # of the *live* replicas, which is what convergence means post-failure.
    np.fill_diagonal(d, 0.0)
    live = np.where(d.sum(axis=1) > 0)[0]
    if 0 < live.size < M:
        sub = generate_policy_matrix(
            alpha, K, R, Tm[np.ix_(live, live)], d[np.ix_(live, live)], eps,
            warm=warm,  # shape-checked by the solver; free if stale
            warm_start=warm_start,
        )
        P = np.zeros((M, M))
        P[np.ix_(live, live)] = sub.P
        return PolicyResult(
            P, sub.rho, sub.t_bar, sub.lambda2, sub.T_convergence,
            sub.n_lp_solved, sub.n_lp_feasible, sub.grid,
            basis=sub.basis, n_pivots=sub.n_pivots,
            n_warm_used=sub.n_warm_used, n_solves=sub.n_solves,
        )

    U_rho = _rho_grid_upper(alpha, Tm, d)
    delta = U_rho / K
    carry = WarmStartCarry(basis=warm, enabled=warm_start)
    inst = _build_eq14(Tm, d)  # one constraint matrix for the whole sweep
    best: PolicyResult | None = None
    all_grid = []
    for k in range(1, K + 1):
        rho = k * delta
        # Across rho steps only the Eq.-11 bound floors change: the carry's
        # basis stays dual-feasible and restarts in a handful of pivots.
        res = inner_loop(alpha, rho, R, Tm, d, eps, carry=carry, inst=inst)
        if res is None:
            continue
        all_grid.extend(res.grid)
        if best is None or res.T_convergence < best.T_convergence:
            best = res
    if best is None:
        # No feasible grid point (e.g. alpha*rho floor too high everywhere):
        # fall back to the uniform policy — still convergent (Thm 1), just
        # not time-optimized.  The Monitor logs this condition.
        P = uniform_policy(d)
        rho = 0.25 / alpha / max(1.0, d.sum(axis=1).max())
        Y = consensus.build_Y(P, alpha, rho, d)
        lam2 = theory.lambda2(Y)
        tbar = float(consensus.mean_iteration_times(P, Tm, d).mean())
        best = PolicyResult(P, rho, tbar, lam2, theory.convergence_time(tbar, lam2, eps))
    best.grid = all_grid
    best.basis = carry.basis
    best.n_pivots = carry.n_pivots
    best.n_warm_used = carry.n_warm_used
    best.n_solves = carry.n_solves
    return best


def generate_policy_matrix_batched(
    alpha: float,
    K: int,
    R: int,
    T: np.ndarray,
    d: np.ndarray | None = None,
    eps: float = 1e-2,
    backend: str = "numpy",
) -> PolicyResult:
    """Algorithm 3 with the whole (rho, t_bar) grid solved in one dispatch.

    Semantically ``generate_policy_matrix`` (same grid, same feasibility
    pre-filter, same scoring), but every surviving grid point becomes one
    instance of a lockstep batched simplex (``repro.solver.batch``) — all
    points price and ratio-test together in stacked GEMMs — and all
    feasible policies are scored with a single stacked ``eigvalsh``.

    ``backend`` selects the lockstep engine: ``"numpy"`` (the only one in
    this package so far) is the host path.  The JAX package's ``"jax"``
    device program has no counterpart here yet: the CUDA lockstep simplex
    (``backend="torch"``, ROADMAP A7) comes later, and any other backend
    raises ``ValueError``.

    Numerics follow a different summation order than the serial sweep, so
    the selected grid point matches the serial path up to solver tolerance
    (exactly, away from near-ties), not bit-for-bit — engine-parity
    callers keep the serial path.  Best suited to small/medium M where the
    grid, not one LP, dominates; at large M the serial warm-start sweep's
    dual restarts are cheaper than lockstep cold starts.
    """
    if backend != "numpy":
        raise ValueError(
            f"batched-sweep backend {backend!r} is not available in "
            "repro_torch: only 'numpy' is ported; the torch device backend "
            "(ROADMAP A7) comes later"
        )
    T = np.asarray(T, dtype=np.float64)
    M = T.shape[0]
    if d is None:
        d = np.ones((M, M)) - np.eye(M)
    d = np.asarray(d, dtype=np.float64).copy()
    dead = ~np.isfinite(T)
    d[dead] = 0.0
    d[dead.T] = 0.0
    Tm = np.where(np.isfinite(T), T, 0.0)
    np.fill_diagonal(d, 0.0)
    live = np.where(d.sum(axis=1) > 0)[0]
    if 0 < live.size < M:
        sub = generate_policy_matrix_batched(
            alpha, K, R, Tm[np.ix_(live, live)], d[np.ix_(live, live)], eps,
            backend=backend,
        )
        P = np.zeros((M, M))
        P[np.ix_(live, live)] = sub.P
        return PolicyResult(
            P, sub.rho, sub.t_bar, sub.lambda2, sub.T_convergence,
            sub.n_lp_solved, sub.n_lp_feasible, sub.grid,
            basis=sub.basis, n_pivots=sub.n_pivots,
            n_warm_used=sub.n_warm_used, n_solves=sub.n_solves,
        )

    U_rho = _rho_grid_upper(alpha, Tm, d)
    delta = U_rho / K
    inst = _build_eq14(Tm, d)
    cand: list[tuple[float, float]] = []
    grid: list = []
    for k in range(1, K + 1):
        rho = k * delta
        L, U = _t_bar_interval(Tm, d, alpha, rho)
        if not np.isfinite(U) or U <= L:
            continue
        lo, hi = _eq14_time_bounds(Tm, d, alpha, rho)
        for r in range(1, R + 1):
            t_bar = L + (U - L) * r / R
            target = M * t_bar
            tol = 1e-6 * max(1.0, abs(target))
            if target < lo - tol or target > hi + tol:
                grid.append((rho, t_bar, None, np.inf))
            else:
                cand.append((rho, t_bar))

    best: PolicyResult | None = None
    n_pivots = 0
    n_feasible = 0
    if cand:
        from repro_torch.solver.batch import solve_lp_batch as _batch

        S = len(cand)
        rho_s = np.array([c0 for c0, _ in cand])
        tb_s = np.array([c1 for _, c1 in cand])
        b = np.zeros((S, 2 * M))
        b[:, :M] = (M * tb_s)[:, None]
        b[:, M:] = 1.0
        lb = np.zeros((S, inst.n))
        lb[:, inst.pos] = (
            alpha * rho_s[:, None] * inst.dsym[None, :] + _FLOOR_MARGIN
        )
        results = _batch(inst.c, inst.A, b, lb_stack=lb, ub_stack=inst.ub)
        n_pivots = int(sum(r.pivots for r in results))
        Ps, feas = [], []
        for s, res in enumerate(results):
            if not res.ok:
                grid.append((rho_s[s], tb_s[s], None, np.inf))
                continue
            x = np.maximum(res.x, 0.0)
            P = np.zeros((M, M))
            P[inst.ii, inst.mm] = x[inst.pos]
            P[np.arange(M), np.arange(M)] = x[inst.start]
            Ps.append(P)
            feas.append(s)
        n_feasible = len(feas)
        if feas:
            Ys = np.stack([
                consensus.build_Y(P, alpha, rho_s[s], d)
                for P, s in zip(Ps, feas)
            ])
            ev = np.linalg.eigvalsh(Ys)  # one stacked decomposition
            lam2 = ev[:, -2] if M >= 2 else ev[:, -1]
            for P, s, l2 in zip(Ps, feas, lam2):
                Tc = theory.convergence_time(tb_s[s], float(l2), eps)
                grid.append((rho_s[s], tb_s[s], float(l2), Tc))
                if best is None or Tc < best.T_convergence:
                    best = PolicyResult(
                        P, float(rho_s[s]), float(tb_s[s]), float(l2), Tc
                    )
    if best is None:
        P = uniform_policy(d)
        rho = 0.25 / alpha / max(1.0, d.sum(axis=1).max())
        Y = consensus.build_Y(P, alpha, rho, d)
        lam2 = theory.lambda2(Y)
        tbar = float(consensus.mean_iteration_times(P, Tm, d).mean())
        best = PolicyResult(
            P, rho, tbar, lam2, theory.convergence_time(tbar, lam2, eps)
        )
    best.n_lp_solved = len(cand)
    best.n_lp_feasible = n_feasible
    best.grid = grid
    best.n_pivots = n_pivots
    best.n_solves = len(cand)
    return best


def connectivity_key(d: np.ndarray) -> bytes:
    """Fingerprint of an effective edge set (who may talk to whom).

    An optimal-basis warm start is only meaningful across solves that share
    the same variable layout — the Eq.-14 LP's variables are the live edges
    of ``d`` — so a caller threading ``PolicyResult.basis`` across refreshes
    must drop it whenever this key changes (live set shrank, links masked).
    The solver's shape validation would also reject a stale basis, but that
    is a fallback, not a contract; the Monitor invalidates explicitly.
    """
    return np.ascontiguousarray(d != 0).tobytes()


def uniform_policy(d: np.ndarray) -> np.ndarray:
    """AD-PSGD-style uniform neighbor selection (no self-loops)."""
    M = d.shape[0]
    mask = (d != 0) & ~np.eye(M, dtype=bool)
    cnt = mask.sum(axis=1)
    P = np.zeros((M, M))
    rows = cnt > 0
    P[rows] = mask[rows] / cnt[rows, None]
    return P
