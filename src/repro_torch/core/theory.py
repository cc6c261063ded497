"""Convergence theory (paper §IV + Appendices A/B).

Second-eigenvalue machinery, the deviation bound of Theorems 1/2, the
convergence-time objective k*t_bar used by Algorithm 3, and the
approximation-ratio bound of Appendix B.
"""

from __future__ import annotations

import numpy as np


def lambda2(Y: np.ndarray) -> float:
    """Second largest eigenvalue of the (symmetric) second-moment matrix."""
    ev = np.linalg.eigvalsh(Y)
    return float(ev[-2]) if ev.shape[0] >= 2 else float(ev[-1])


def lambda1(Y: np.ndarray) -> float:
    ev = np.linalg.eigvalsh(Y)
    return float(ev[-1])


def is_doubly_stochastic(Y: np.ndarray, tol: float = 1e-6) -> bool:
    return bool(
        np.all(Y >= -tol)
        and np.allclose(Y.sum(axis=0), 1.0, atol=1e-5)
        and np.allclose(Y.sum(axis=1), 1.0, atol=1e-5)
    )


def effective_lambda(Y: np.ndarray) -> float:
    """lambda = lambda2 if Y is doubly stochastic else lambda1 (paper §IV)."""
    return lambda2(Y) if is_doubly_stochastic(Y) else lambda1(Y)


def deviation_bound(lam: float, dev0: float, alpha: float, sigma: float, k: int) -> float:
    """RHS of Eq. (23)/(24): lam^k * dev0 + alpha^2 sigma^2 lam/(1-lam)."""
    if lam >= 1.0:
        return float("inf")
    return lam**k * dev0 + alpha**2 * sigma**2 * lam / (1.0 - lam)


def convergence_steps(lam: float, eps: float) -> float:
    """Smallest k with lam^k <= eps (Eq. 9)."""
    if lam <= 0.0:
        return 1.0
    if lam >= 1.0:
        return float("inf")
    return np.log(eps) / np.log(lam)


def convergence_time(t_bar: float, lam: float, eps: float) -> float:
    """T_conv = t_bar * ln(eps)/ln(lambda)  (Algorithm 3 line 21)."""
    return t_bar * convergence_steps(lam, eps)


def global_step_time(P: np.ndarray, T: np.ndarray, d: np.ndarray) -> float:
    """Expected duration of one *global* step for an arbitrary policy.

    Workers iterate concurrently; global steps arrive at combined rate
    sum_i 1/t_bar_i, so t_bar_global = 1/sum_i(1/t_bar_i).  For an
    Algorithm-3 policy (t_bar_i = M*t_bar for all i) this reduces to t_bar.
    """
    from repro_torch.core.consensus import mean_iteration_times

    tbar = mean_iteration_times(P, T, d)
    rates = np.where(tbar > 0, 1.0 / np.maximum(tbar, 1e-300), 0.0)
    s = rates.sum()
    return float(1.0 / s) if s > 0 else float("inf")


def approximation_ratio(U: float, L: float, M: int, a: float) -> float:
    """Appendix-B bound Eq. (38) for a fully-connected heterogeneous graph.

    ratio <= (U/L) * [ln(M-1) - ln(M-3)] / [ln(1-2a+a^M) - ln(1-2a+a^(M+1))]
    where a is the minimum positive entry of Y_P.  Requires M > 3, 0<a<1.
    """
    if M <= 3 or not (0.0 < a < 1.0) or L <= 0.0:
        return float("inf")
    num = np.log(M - 1.0) - np.log(M - 3.0)
    # den = ln(1-2a+a^M) - ln(1-2a+a^(M+1)); for small a the difference
    # underflows in direct form, so compute via log1p of the exact ratio.
    den = np.log1p((a**M - a ** (M + 1)) / (1.0 - 2.0 * a + a ** (M + 1)))
    if den <= 0.0:
        return float("inf")
    return float((U / L) * num / den)


def lambda2_lower_bound(M: int) -> float:
    """Eq. (34): lambda2 >= (M-3)/(M-1) on a fully-connected graph."""
    return (M - 3.0) / (M - 1.0)


def lambda2_upper_bound(a: float, M: int) -> float:
    """Eq. (35): Kirkland cycle bound given minimum positive entry a."""
    return (1.0 - 2.0 * a + a ** (M + 1)) / (1.0 - 2.0 * a + a**M)
