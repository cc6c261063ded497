"""The float64 device simplex (``solver/batch_torch.py``) against the JAX
package's lockstep numpy simplex (``repro/solver/batch.py``), on the CPU.

The oracle is the JAX package's numpy ``solve_lp_batch`` (and its
``_BatchSimplex`` for the refactor schedule and the iteration cap), the
same oracle ``tests/test_revised.py`` holds ``batch_jax`` to.  The device
program ``repro/solver/batch_jax.py`` itself cannot be the oracle here
(ROADMAP caveat C4: its ``from jax.experimental import enable_x64``
raises ``ImportError`` under the installed jax, which is why
``tests/test_revised.py::test_solve_lp_batch_jax_lockstep_with_numpy``
fails on every run); ``repro/solver/batch.py`` imports only numpy.  The
port's own numpy ``solve_lp_batch`` is a second witness, held bit-equal to
the reference.  Both simplexes follow the same pivot rules, so on these
fixtures the pivot path is the same: equal statuses and pivot counts per
instance, objectives within 1e-9 (the two sum their matmuls in different
orders).  Through ``generate_policy_matrix_batched(backend="torch")`` the
Eq.-14 sweep picks the reference's ``backend="numpy"`` grid point on
tests/test_policy.py's heterogeneous-times fixtures.  Without a card the
torch backend raises unless ``device="cpu"`` is passed.
"""

import numpy as np
import pytest
import torch

from repro.core import policy as ref_policy
from repro.solver import batch as ref_batch
from repro.solver.batch import _EPS, INFEAS, _BatchSimplex, solve_lp_batch
from repro_torch.core import policy
from repro_torch.solver import batch as port_batch
from repro_torch.solver import batch_torch
from repro_torch.solver.batch_torch import solve_lp_batch_torch

FUN_TOL = 1e-9


def hetero_times(M, seed, slow_factor=10.0):
    """tests/test_policy.py's fixture: U(0.01, 0.05) symmetric link times
    with one slow link."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(0.01, 0.05, size=(M, M))
    T = (T + T.T) / 2
    i, m = rng.choice(M, size=2, replace=False)
    T[i, m] = T[m, i] = T[i, m] * slow_factor
    np.fill_diagonal(T, 0.0)
    return T


def rng23():
    """tests/test_revised.py:675's fixture (rng 23, n 10, m 4, S 12): ten
    feasible right-hand sides, two likely infeasible, per-instance floors."""
    rng = np.random.default_rng(23)
    n, m, S = 10, 4, 12
    A = rng.normal(size=(m, n))
    c = rng.normal(size=n)
    b = np.stack([A @ rng.uniform(0.1, 0.9, size=n) for _ in range(S - 2)]
                 + [rng.normal(size=m), rng.normal(size=m)])
    lb = np.zeros((S, n))
    lb[3] = 0.05
    return c, A, b, lb, np.ones((S, n))


def random_stack(seed, S=16):
    """Random LPs in the three shapes of tests/test_revised.py's random
    suite: boxed and feasible, unbounded above, arbitrary b."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(6, 14)), int(rng.integers(2, 6))
    A = rng.normal(size=(m, n))
    c = rng.normal(size=n)
    kind = seed % 3
    if kind == 0:
        b = np.stack([A @ rng.uniform(0.1, 0.9, size=n) for _ in range(S)])
        lb, ub = np.zeros(n), np.ones(n)
    elif kind == 1:
        b = np.stack([A @ rng.uniform(0.1, 2.0, size=n) for _ in range(S)])
        lb, ub = np.zeros(n), np.full(n, np.inf)
    else:
        lb = rng.uniform(-1, 0.5, size=n)
        ub = lb + rng.uniform(0.1, 2.0, size=n)
        b = rng.normal(size=(S, m))
    return c, A, b, lb, ub


def eq14_stack(M, seed):
    """The batched sweep's own shape: one Eq.-14 skeleton, a stack of t_bar
    right-hand sides with the rho floors as lower bounds."""
    T = hetero_times(M, seed)
    d = np.ones((M, M)) - np.eye(M)
    alpha, rho = 0.1, 0.1
    sk = ref_policy._build_eq14(T, d)
    L, U = ref_policy._t_bar_interval(T, d, alpha, rho)
    b = np.zeros((6, 2 * M))
    for s, f in enumerate(np.linspace(0.05, 0.95, 6)):
        b[s, :M] = M * (L + (U - L) * f)
        b[s, M:] = 1.0
    lb = np.zeros(sk.n)
    lb[sk.pos] = alpha * rho * sk.dsym + ref_policy._FLOOR_MARGIN
    A = sk.A.toarray() if hasattr(sk.A, "toarray") else sk.A
    return sk.c, A, b, lb, sk.ub


def _assert_same_results(ref, got):
    """The port's numpy simplex against the reference: the same code on
    the same inputs, so bit-equal."""
    assert [(g.status, g.pivots, g.fun) for g in got] == [
        (r.status, r.pivots, r.fun) for r in ref]
    for r, g in zip(ref, got):
        assert (g.x is None) == (r.x is None)
        if r.x is not None:
            np.testing.assert_array_equal(g.x, r.x)


def _assert_lockstep(ref, got):
    assert len(got) == len(ref)
    for s, (r, g) in enumerate(zip(ref, got)):
        assert g.status == r.status, s
        assert g.pivots == r.pivots, s
        if r.ok:
            assert g.fun == pytest.approx(r.fun, rel=FUN_TOL, abs=FUN_TOL)
            np.testing.assert_allclose(g.x, r.x, atol=1e-8)
        else:
            assert g.x is None and g.fun == r.fun


FIXTURES = {"rng23": rng23, **{f"random{s}": (lambda s=s: random_stack(s))
                               for s in range(6)},
            "eq14_M6": lambda: eq14_stack(6, 3), "eq14_M10": lambda: eq14_stack(10, 4)}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_device_simplex_walks_the_numpy_path(name):
    c, A, b, lb, ub = FIXTURES[name]()
    ref = solve_lp_batch(c, A, b, lb_stack=lb, ub_stack=ub)
    got = solve_lp_batch_torch(c, A, b, lb_stack=lb, ub_stack=ub, device="cpu")
    _assert_lockstep(ref, got)
    _assert_same_results(ref, port_batch.solve_lp_batch(c, A, b, lb_stack=lb, ub_stack=ub))
    if name == "rng23":
        assert {r.status for r in got} == {"optimal", "infeasible"}


def _numpy_with(c, A, b, lb, ub, simplex=_BatchSimplex, **kw):
    """The reference's ``solve_lp_batch`` with ``_BatchSimplex``'s knobs
    exposed (``simplex``: whose ``_BatchSimplex``)."""
    S, n = b.shape[0], c.shape[0]
    lb = np.broadcast_to(lb, (S, n)).copy()
    ub = np.broadcast_to(ub, (S, n)).copy()
    sol = simplex(c, A, b, lb, ub, **kw)
    sol.status[(lb > ub + _EPS).any(axis=1)] = INFEAS
    sol.solve()
    return sol.status.tolist(), sol.pivots.tolist()


@pytest.mark.parametrize("kw", [dict(refactor_every=3), dict(max_iter=4)],
                         ids=["refactor-every-3", "iteration-cap"])
def test_refactor_schedule_and_iteration_cap_follow_numpy(kw):
    """Refactorisations every 3 pivots (the product-form update replaced
    by a fresh inverse, per instance) and an iteration cap that stops
    instances mid-phase give the reference's statuses and pivot counts."""
    c, A, b, lb, ub = eq14_stack(8, 1)
    status, pivots = _numpy_with(c, A, b, lb, ub, **kw)
    assert _numpy_with(c, A, b, lb, ub, port_batch._BatchSimplex, **kw) == (status, pivots)
    got = solve_lp_batch_torch(c, A, b, lb_stack=lb, ub_stack=ub, device="cpu", **kw)
    names = {1: "optimal", 2: "infeasible", 3: "unbounded", 4: "iteration_limit"}
    assert [g.status for g in got] == [names[s] for s in status]
    assert [g.pivots for g in got] == pivots
    if "max_iter" in kw:
        assert "iteration_limit" in {g.status for g in got}


WINDOW_CASES = ["rng23", "random0", "random2", "eq14_M10"]


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_tiny_pivot_rolls_the_window_back(name, monkeypatch):
    """A tiny pivot cannot be foreseen between read-backs: the window that
    met one is rolled back to its snapshot and run again an iteration at
    a time, refactoring where the pivot was tiny.  With the tiny-pivot
    threshold raised to 0.3 in both simplexes such pivots are common; the
    statuses, pivot counts and objectives stay the reference's."""
    monkeypatch.setattr(ref_batch, "_PIV_MIN", 0.3)
    monkeypatch.setattr(batch_torch, "_PIV_MIN", 0.3)
    c, A, b, lb, ub = FIXTURES[name]()
    ref = solve_lp_batch(c, A, b, lb_stack=lb, ub_stack=ub)
    sol = batch_torch.make_solver(c, A, b, lb, ub, device="cpu")
    sol.solve()
    assert sol.rollbacks > 0
    got = solve_lp_batch_torch(c, A, b, lb_stack=lb, ub_stack=ub, device="cpu")
    _assert_lockstep(ref, got)


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_windows_answer_as_a_read_back_every_iteration(name, monkeypatch):
    """Iterations between read-backs after every instance has finished are
    masked no-ops: windows of 8 give bit for bit the answer of windows of
    1, with at most a third as many read-backs as iterations."""
    c, A, b, lb, ub = FIXTURES[name]()
    runs = {}
    for window in (1, 8):
        monkeypatch.setattr(batch_torch, "_WINDOW", window)
        sol = batch_torch.make_solver(c, A, b, lb, ub, device="cpu")
        runs[window] = [t.numpy() for t in sol.solve()], sol
    (x1, st1, pv1), _ = runs[1]
    (x8, st8, pv8), sol = runs[8]
    np.testing.assert_array_equal(st8, st1)
    np.testing.assert_array_equal(pv8, pv1)
    np.testing.assert_array_equal(x8, x1)
    assert sol.rollbacks == 0 and 3 * sol.readbacks <= sol.iterations


def test_unbounded_infeasible_box_and_bound_flip():
    cases = [
        (np.array([-1.0, 0.0]), np.array([[1.0, -1.0]]), np.array([[0.0]]), None, None),
        (np.array([1.0]), np.array([[1.0]]), np.array([[5.0]]), np.zeros(1), np.ones(1)),
        (np.array([-1.0, -2.0]), np.array([[1.0, 1.0]]), np.array([[1.0]]), None,
         np.array([0.6, 0.6])),
    ]
    for c, A, b, lb, ub in cases:
        ref = solve_lp_batch(c, A, b, lb_stack=lb, ub_stack=ub)
        got = solve_lp_batch_torch(c, A, b, lb_stack=lb, ub_stack=ub, device="cpu")
        _assert_lockstep(ref, got)
    assert [g.status for g in got] == ["optimal"]
    np.testing.assert_allclose(got[0].x, [0.4, 0.6])
    with pytest.raises(ValueError, match="free variables"):
        solve_lp_batch_torch(np.ones(1), np.ones((1, 1)), np.ones((1, 1)),
                             lb_stack=np.array([-np.inf]), device="cpu")


def test_tie_breaks_take_the_first_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [-1.0, -1.0, -1.0, -1.0],
                      [0.0, 5.0, 1.0, 5.0]], dtype=torch.float64)
    assert batch_torch._first_argmax(x).tolist() == [1, 0, 1]
    m = torch.tensor([[False, True, True], [False, False, False], [True, False, True]])
    assert batch_torch._first_true(m).tolist() == [1, 0, 0]


SWEEP_CASES = [(8, 0, False), (10, 1, False), (12, 2, True), (9, 3, True), (16, 5, False)]


@pytest.mark.parametrize("M,seed,sparse", SWEEP_CASES)
def test_torch_backend_same_grid_point_as_numpy(M, seed, sparse):
    T = hetero_times(M, seed)
    d = None
    if sparse:
        d = np.ones((M, M)) - np.eye(M)
        rng = np.random.default_rng(100 + seed)
        i, j = rng.integers(0, M, 2)
        while i == j:
            i, j = rng.integers(0, M, 2)
        d[i, j] = d[j, i] = 0.0
    pn = ref_policy.generate_policy_matrix_batched(0.9, 6, 6, T, d=d, backend="numpy")
    pt = policy.generate_policy_matrix_batched(0.9, 6, 6, T, d=d, backend="torch",
                                               device="cpu")
    pp = policy.generate_policy_matrix_batched(0.9, 6, 6, T, d=d, backend="numpy")
    assert (pp.rho, pp.t_bar, pp.n_pivots, pp.grid) == (pn.rho, pn.t_bar, pn.n_pivots,
                                                         pn.grid)
    np.testing.assert_array_equal(pp.P, pn.P)
    assert (pt.rho, pt.t_bar) == (pn.rho, pn.t_bar)
    assert pt.ok == pn.ok and pt.n_lp_solved == pn.n_lp_solved
    assert pt.n_lp_feasible == pn.n_lp_feasible and pt.n_pivots == pn.n_pivots
    assert [g[:2] for g in pt.grid] == [g[:2] for g in pn.grid]
    np.testing.assert_allclose(pt.P, pn.P, atol=1e-12)


def test_torch_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    T = hetero_times(6, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy.generate_policy_matrix_batched(0.9, 4, 4, T, backend="torch")
    c, A, b, lb, ub = rng23()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_lp_batch_torch(c, A, b, lb_stack=lb, ub_stack=ub)
    with pytest.raises(ValueError, match="backend"):
        policy.generate_policy_matrix_batched(0.9, 4, 4, T, backend="jax")
