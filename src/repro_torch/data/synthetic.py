"""Synthetic datasets: LM token streams + classification sets.

The LM stream is a deterministic, seekable generator (worker, step) ->
batch, so checkpoint/restart reproduces the exact data order (tested in
test_checkpoint.py).  Classification sets power the paper-reproduction
benchmarks (convergence/accuracy claims on small models).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenStream:
    """Markov-chain token stream with learnable structure (so loss actually
    decreases) — per-worker shards are disjoint by seed."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    order: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish transition structure: each token prefers ~8 successors
        k = 8
        self._succ = rng.integers(0, self.vocab_size, size=(self.vocab_size, k))

    def batch(self, worker: int, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + worker) * 1_000_003 + step
        )
        B, S = self.batch_size, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=B)
        for t in range(S):
            choice = rng.integers(0, self._succ.shape[1], size=B)
            nxt = self._succ[toks[:, t], choice]
            noise = rng.random(B) < 0.1
            nxt = np.where(noise, rng.integers(0, self.vocab_size, size=B), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def classification_dataset(
    n: int, dim: int, n_classes: int, seed: int = 0, margin: float = 1.0
):
    """Linearly-separable-ish gaussian blobs (paper-repro small models)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, dim)) * margin * 2
    y = rng.integers(0, n_classes, size=n)
    x = centers[y] + rng.normal(size=(n, dim))
    return x.astype(np.float32), y.astype(np.int32)


def train_eval_split(n_train: int, n_eval: int, dim: int, n_classes: int,
                     seed: int = 0, margin: float = 1.0):
    """Train/eval from the SAME distribution (same class centers)."""
    x, y = classification_dataset(n_train + n_eval, dim, n_classes, seed=seed, margin=margin)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def mnist_like(n: int = 8192, seed: int = 0):
    """28x28-ish synthetic digits: 10 classes, blob + structured noise."""
    x, y = classification_dataset(n, 64, 10, seed=seed, margin=1.2)
    return x, y
