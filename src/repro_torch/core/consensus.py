"""Consensus SGD math (paper §III-B, §IV).

The JAX package's ``core/consensus.py``.  In numpy: the one-step random
operator ``D^k`` (Eq. 19), its second moment ``Y_P = E[(D^k)^T D^k]``
(Eq. 22), the helpers the policy generator uses, and the host-side lockstep
round draw.  In torch, on parameter trees (``tree.py``): the two-step update
and the stacked gossip round (``two_step_update`` / ``stacked_round``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

# --------------------------------------------------------------------------
# Analysis view (numpy)
# --------------------------------------------------------------------------


def gamma_matrix(P: np.ndarray, d: np.ndarray) -> np.ndarray:
    """gamma_{i,m} = (d_{i,m} + d_{m,i}) / (2 p_{i,m}), 0 where p=0 or no edge."""
    num = d + d.T
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where((P > 0) & (num > 0), num / (2.0 * np.maximum(P, 1e-300)), 0.0)
    return g


def mean_iteration_times(P: np.ndarray, T: np.ndarray, d: np.ndarray) -> np.ndarray:
    """t_bar_i = sum_m t_{i,m} p_{i,m} d_{i,m}   (Eq. 2)."""
    return (T * P * d).sum(axis=1)


def worker_activation_probs(
    P: np.ndarray, T: np.ndarray | None, d: np.ndarray
) -> np.ndarray:
    """p_i per Eq. (3); uniform 1/M when no time matrix is supplied.

    For any feasible Algorithm-3 policy the equality constraints (Eq. 10)
    force t_bar_i identical across i, hence p_i = 1/M (Lemma 1).
    """
    M = P.shape[0]
    if T is None:
        return np.full(M, 1.0 / M)
    tbar = mean_iteration_times(P, T, d)
    # Workers that never communicate (tbar == 0) get frequency 0 by convention.
    with np.errstate(divide="ignore"):
        freq = np.where(tbar > 0, 1.0 / np.maximum(tbar, 1e-300), 0.0)
    s = freq.sum()
    return freq / s if s > 0 else np.full(M, 1.0 / M)


def build_Y(
    P: np.ndarray,
    alpha: float,
    rho: float,
    d: np.ndarray,
    T: np.ndarray | None = None,
) -> np.ndarray:
    """Second-moment matrix Y_P = E[(D^k)^T D^k], entries per Eq. (22).

    Edges whose selection probability is zero contribute nothing (the
    corresponding event never happens), which is how the Monitor retires a
    dead link without touching the math.
    """
    M = P.shape[0]
    p = worker_activation_probs(P, T, d)
    g = gamma_matrix(P, d)
    ar = alpha * rho
    # p_{i,m} * gamma_{i,m} = (d_{i,m}+d_{m,i})/2 when p>0 — a constant per edge.
    pg = np.where(P > 0, P * g, 0.0)
    pg2 = np.where(P > 0, P * g * g, 0.0)
    # Vectorized over all (i, m) at once (this sits inside Algorithm 3's
    # K·R grid, so the former Python double loop was O(K·R·M²)).  gamma's
    # zero diagonal keeps rowl/rowq diagonals exactly 0, matching the
    # loop's skipped m == i entries.
    rowl = p[:, None] * pg  # rowl[i, m] = p_i pg_{i,m};  rowl.T[i, m] = p_m pg_{m,i}
    rowq = p[:, None] * pg2
    Y = ar * (rowl + rowl.T) - ar * ar * (rowq + rowq.T)
    lin_d = 2.0 * ar * rowl.sum(axis=1)
    quad_d = ar * ar * (rowq + rowq.T).sum(axis=1)
    Y[np.arange(M), np.arange(M)] = 1.0 - lin_d + quad_d
    return Y


def sample_event(
    rng: np.random.Generator, P: np.ndarray, p: np.ndarray
) -> tuple[int, int]:
    """Draw (i, m): active worker i ~ p, neighbor m ~ P[i]."""
    M = P.shape[0]
    i = int(rng.choice(M, p=p))
    row = P[i] / P[i].sum()
    m = int(rng.choice(M, p=row))
    return i, m


def D_matrix(i: int, m: int, alpha: float, rho: float, P, d) -> np.ndarray:
    """D^k = I + alpha*rho*gamma_{i,m} e_i (e_m - e_i)^T  (Eq. 19)."""
    M = P.shape[0]
    D = np.eye(M)
    if i != m and d[i, m]:
        g = (d[i, m] + d[m, i]) / (2.0 * P[i, m])
        w = alpha * rho * g
        D[i, i] -= w
        D[i, m] += w
    return D


def mixing_weight(alpha: float, rho: float, p_im: float, d_sym: float = 2.0):
    """w = alpha * rho * gamma = alpha*rho*(d_im+d_mi)/(2*p_im)."""
    return alpha * rho * d_sym / (2.0 * p_im)


# --------------------------------------------------------------------------
# Runtime view (torch, tree-level)
# --------------------------------------------------------------------------


def _weak(v, like):
    """A Python number as a 0-d tensor of ``like``'s dtype (JAX's weak
    typing: ``0.05 * bf16_array`` rounds 0.05 to bf16 first); a tensor as it
    is."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def two_step_update(params, grads, pulled, alpha, w):
    """Algorithm 2 lines 11+13-15 on a parameter tree.

    x_half = x - alpha * g          (first step: local SGD)
    x_next = (1-w) * x_half + w * x_pull   (second step: consensus mix)

    ``w`` may be a scalar or a tensor broadcastable leaf-wise (per worker
    when leaves carry a leading worker axis).  Python numbers take the leaf
    dtype, as in JAX.
    """

    def leaf(x, g, xp):
        x_half = x - _weak(alpha, x) * g
        keep = _weak(1.0 - w, x_half) if not isinstance(w, torch.Tensor) else 1.0 - w
        return keep * x_half + _weak(w, xp) * xp

    return tree_map(leaf, params, grads, pulled)


def stacked_round(params, grads, neighbors, weights, alpha):
    """Lockstep gossip round on *stacked* replicas (leading axis = worker).

    params/grads: trees whose leaves are (M, ...).
    neighbors:    (M,) ints — the neighbour drawn per worker (may equal i).
    weights:      (M,) f32 tensor — alpha*rho*gamma_{i, m_i}; 0 where m_i == i.

    Pulled values are the *pre-round* neighbour params (Eq. 16 pulls x_m^k,
    not x_m^k - alpha g_m^k).  The weights stay f32, so bf16 leaves come
    out f32, as in the JAX package.
    """

    def leaf(x, g):
        nb = torch.as_tensor(neighbors, device=x.device).long()
        pulled = torch.index_select(x, 0, nb)
        x_half = x - _weak(alpha, x) * g
        w = weights.reshape((-1,) + (1,) * (x.ndim - 1))
        return (1.0 - w) * x_half + w * pulled

    return tree_map(leaf, params, grads)


def sample_round(rng: np.random.Generator, P: np.ndarray, alpha: float, rho: float, d: np.ndarray):
    """Draw one lockstep round: per-worker neighbor + mixing weight (host side)."""
    M = P.shape[0]
    neighbors = np.empty(M, dtype=np.int32)
    weights = np.zeros(M, dtype=np.float32)
    for i in range(M):
        row = P[i] / P[i].sum()
        m = int(rng.choice(M, p=row))
        neighbors[i] = m
        if m != i and d[i, m]:
            g = (d[i, m] + d[m, i]) / (2.0 * P[i, m])
            weights[i] = alpha * rho * g
    return neighbors, weights
