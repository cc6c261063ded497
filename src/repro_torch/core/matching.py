"""Matched gossip rounds via Birkhoff-von Neumann decomposition (beyond paper).

The paper's pull is worker->neighbor point-to-point over TCP.  In SPMD the
naive equivalent (every worker gathers the full worker-axis stack and indexes
its neighbor) costs an all-gather: M x shard bytes.  If instead each round's
neighbor assignment is a *permutation* pi, the pull lowers to
``collective_permute`` — exactly one shard in, one shard out per worker,
point-to-point, overlappable with compute.

This module turns a NetMax policy P into a distribution over permutations
whose per-edge marginal frequencies approximate P:

1. Sinkhorn-project P (row-stochastic) to the nearest doubly stochastic Q on
   the same support (self-loops allowed: a fixed point = "no pull this round").
2. Birkhoff-decompose Q = sum_j theta_j Pi_j (theta_j > 0, sum = 1) using
   repeated perfect matchings on the remaining support.
3. Sample Pi_j ~ theta each round.  E[pi matrix] = Q, so the consensus
   operator's second moment is Y_Q — recomputed and reported so the
   convergence guarantee (Thm 1) still holds for the matched sampler.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def sinkhorn(P: np.ndarray, iters: int = 500, tol: float = 1e-10) -> np.ndarray:
    """Project a nonnegative matrix onto doubly stochastic via Sinkhorn-Knopp.

    Zero-support entries stay zero.  Requires total support (guaranteed when
    the diagonal is free: we add a small self-loop mass where needed).
    """
    Q = P.copy().astype(np.float64)
    # Ensure total support: give every row/col a diagonal escape hatch.
    eps = max(Q[Q > 0].min() * 1e-3, 1e-12) if (Q > 0).any() else 1e-12
    np.fill_diagonal(Q, np.maximum(np.diag(Q), eps))
    for _ in range(iters):
        Q /= Q.sum(axis=1, keepdims=True)
        Q /= Q.sum(axis=0, keepdims=True)
        r = np.abs(Q.sum(axis=1) - 1.0).max()
        if r < tol:
            break
    # One last row normalization keeps rows exact (cols off by <= tol).
    Q /= Q.sum(axis=1, keepdims=True)
    return Q


def _perfect_matching(support: np.ndarray) -> np.ndarray | None:
    """Hopcroft-Karp-lite: augmenting-path perfect matching on a 0/1 matrix.

    Returns match[i] = column matched to row i, or None if no perfect
    matching exists.
    """
    n = support.shape[0]
    match_col = np.full(n, -1, dtype=np.int64)  # col -> row

    def try_assign(i: int, seen: np.ndarray) -> bool:
        for j in range(n):
            if support[i, j] and not seen[j]:
                seen[j] = True
                if match_col[j] == -1 or try_assign(match_col[j], seen):
                    match_col[j] = i
                    return True
        return False

    for i in range(n):
        if not try_assign(i, np.zeros(n, dtype=bool)):
            return None
    match_row = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        match_row[match_col[j]] = j
    return match_row


@dataclass
class BirkhoffDecomposition:
    permutations: np.ndarray  # (k, M) int — perm[j][i] = neighbor of i
    weights: np.ndarray  # (k,) float, sums to 1
    Q: np.ndarray  # the doubly stochastic matrix decomposed
    residual: float  # mass not captured (numerical tail)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        j = int(rng.choice(len(self.weights), p=self.weights))
        return self.permutations[j]

    @property
    def n_components(self) -> int:
        return len(self.weights)


def birkhoff_decompose(
    Q: np.ndarray, max_components: int = 128, tol: float = 1e-7
) -> BirkhoffDecomposition:
    """Decompose a doubly stochastic Q into a convex sum of permutations."""
    R = Q.copy().astype(np.float64)
    M = Q.shape[0]
    perms: list[np.ndarray] = []
    weights: list[float] = []
    for _ in range(max_components):
        mass = R.max()
        if mass < tol:
            break
        support = R > tol
        match = _perfect_matching(support)
        if match is None:
            break  # numerically exhausted
        theta = float(R[np.arange(M), match].min())
        if theta < tol:
            # Mask the smallest edge and retry would loop; treat as done.
            break
        perms.append(match.copy())
        weights.append(theta)
        R[np.arange(M), match] -= theta
    if not perms:
        perms.append(np.arange(M))
        weights.append(1.0)
    w = np.asarray(weights)
    residual = float(max(0.0, 1.0 - w.sum()))
    w = w / w.sum()
    return BirkhoffDecomposition(np.asarray(perms), w, Q, residual)


def matched_sampler(P: np.ndarray, max_components: int = 128) -> BirkhoffDecomposition:
    """Policy matrix -> permutation sampler with matching edge marginals."""
    return birkhoff_decompose(sinkhorn(P), max_components=max_components)


def marginal_matrix(dec: BirkhoffDecomposition) -> np.ndarray:
    """E[permutation matrix] under the sampler (should equal dec.Q)."""
    M = dec.permutations.shape[1]
    E = np.zeros((M, M))
    for perm, w in zip(dec.permutations, dec.weights):
        E[np.arange(M), perm] += w
    return E
