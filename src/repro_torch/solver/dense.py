"""Dense two-phase primal tableau simplex — the differential-testing oracle.

This is the original solver the repo grew up on: a standard-form two-phase
method with Bland's rule, where every finite upper bound becomes an explicit
slack *row* (so the Eq.-14 policy LP at M workers builds an
O(M^2) x O(M^2) tableau).  The production path is the bounded-variable
revised simplex in ``repro.solver.revised``; this implementation is kept
verbatim as the ground-truth oracle for the differential tests in
tests/test_revised.py and for the `method="dense"` escape hatch in the
``repro.solver.lp`` facade — the same role the reference event loop plays
for the batched engine.

No external dependencies beyond numpy.
"""

from __future__ import annotations

import numpy as np

from repro_torch.solver.result import LPResult

_EPS = 1e-9


def _to_standard_form(c, A_eq, b_eq, lb, ub):
    """Shift lower bounds to zero and split upper bounds into slack rows.

    Variables become y = x - lb >= 0.  Finite upper bounds add rows
    y_j + s_j = ub_j - lb_j with slack s_j >= 0.
    """
    n = c.shape[0]
    m = A_eq.shape[0]
    b_shift = b_eq - A_eq @ lb
    finite_ub = np.where(np.isfinite(ub))[0]
    k = finite_ub.shape[0]
    A = np.zeros((m + k, n + k))
    A[:m, :n] = A_eq
    b = np.concatenate([b_shift, ub[finite_ub] - lb[finite_ub]])
    for r, j in enumerate(finite_ub):
        A[m + r, j] = 1.0
        A[m + r, n + r] = 1.0
    c_full = np.concatenate([c, np.zeros(k)])
    return A, b, c_full, n


def _simplex_core(T, basis, n_total, max_iter=20000):
    """Run Bland's-rule simplex on tableau T (last row = objective).

    T layout: [A | b] stacked over [c_reduced | -obj].
    Returns "optimal" or "unbounded"; T and basis are mutated in place.
    """
    m = T.shape[0] - 1
    for _ in range(max_iter):
        obj = T[-1, :n_total]
        # Bland: entering = smallest index with negative reduced cost.
        neg = np.where(obj < -_EPS)[0]
        if neg.size == 0:
            return "optimal"
        j = int(neg[0])
        col = T[:m, j]
        pos = np.where(col > _EPS)[0]
        if pos.size == 0:
            return "unbounded"
        ratios = T[pos, -1] / col[pos]
        rmin = ratios.min()
        # Bland tie-break: smallest basis index among min-ratio rows.
        cand = pos[np.where(ratios <= rmin + _EPS)[0]]
        r = int(cand[np.argmin([basis[i] for i in cand])])
        piv = T[r, j]
        T[r, :] /= piv
        for i in range(T.shape[0]):
            if i != r and abs(T[i, j]) > _EPS:
                T[i, :] -= T[i, j] * T[r, :]
        basis[r] = j
    raise RuntimeError("simplex: iteration limit reached")


def solve_lp_dense(c, A_eq, b_eq, lb=None, ub=None) -> LPResult:
    """Minimize c@x subject to A_eq@x=b_eq, lb<=x<=ub (elementwise)."""
    c = np.asarray(c, dtype=np.float64)
    A_eq = np.asarray(A_eq, dtype=np.float64)
    b_eq = np.asarray(b_eq, dtype=np.float64)
    n = c.shape[0]
    lb = np.zeros(n) if lb is None else np.asarray(lb, dtype=np.float64)
    ub = np.full(n, np.inf) if ub is None else np.asarray(ub, dtype=np.float64)
    if np.any(lb > ub + _EPS):
        return LPResult(None, np.inf, "infeasible")

    A, b, c_std, n_orig = _to_standard_form(c, A_eq, b_eq, lb, ub)
    m, n_std = A.shape
    # Make b >= 0 for phase 1.
    neg_rows = b < 0
    A[neg_rows] *= -1.0
    b[neg_rows] *= -1.0

    # ---- Phase 1: minimize sum of artificials. ----
    n_total = n_std + m
    T = np.zeros((m + 1, n_total + 1))
    T[:m, :n_std] = A
    T[:m, n_std:n_total] = np.eye(m)
    T[:m, -1] = b
    basis = list(range(n_std, n_total))
    # Phase-1 objective: sum artificials -> reduced costs.
    T[-1, :n_std] = -A.sum(axis=0)
    T[-1, -1] = -b.sum()
    status = _simplex_core(T, basis, n_total)
    if status != "optimal" or T[-1, -1] < -1e-7:
        return LPResult(None, np.inf, "infeasible")

    # Drive artificials out of the basis where possible.
    for r in range(m):
        if basis[r] >= n_std:
            row = T[r, :n_std]
            j_cand = np.where(np.abs(row) > _EPS)[0]
            if j_cand.size:
                j = int(j_cand[0])
                piv = T[r, j]
                T[r, :] /= piv
                for i in range(T.shape[0]):
                    if i != r and abs(T[i, j]) > _EPS:
                        T[i, :] -= T[i, j] * T[r, :]
                basis[r] = j
            # else: redundant row, leave degenerate artificial at 0.

    # ---- Phase 2. ----
    T2 = np.zeros((m + 1, n_std + 1))
    T2[:m, :n_std] = T[:m, :n_std]
    T2[:m, -1] = T[:m, -1]
    T2[-1, :n_std] = c_std
    # Zero reduced costs of basic variables.
    for r in range(m):
        j = basis[r]
        if j < n_std and abs(T2[-1, j]) > _EPS:
            T2[-1, :] -= T2[-1, j] * T2[r, :]
    status = _simplex_core(T2, basis, n_std)
    if status == "unbounded":
        return LPResult(None, -np.inf, "unbounded")

    y = np.zeros(n_std)
    for r in range(m):
        if basis[r] < n_std:
            y[basis[r]] = T2[r, -1]
    x = y[:n_orig] + lb
    return LPResult(x, float(c @ x), "optimal")
