"""Dataset partitioning across workers (paper §V-A/F).

uniform:     equal IID shards
size_skewed: workers get <2,1,2,1,...> segments (paper §V-F non-uniform)
non_iid:     label-skewed shards — each worker LOSES a set of labels
             (paper Table IV / Table VII cross-cloud setup)
"""

from __future__ import annotations

import numpy as np


def uniform_partition(n: int, M: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(idx, M)]


def size_skewed_partition(
    n: int, M: int, segments: list[int], seed: int = 0
) -> list[np.ndarray]:
    """Worker i receives segments[i] shares of the data (paper: batch size
    scales with segment count)."""
    assert len(segments) == M
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    total = sum(segments)
    bounds = np.cumsum([0] + [int(round(n * s / total)) for s in segments])
    bounds[-1] = n
    return [np.sort(idx[bounds[i] : bounds[i + 1]]) for i in range(M)]


def non_iid_partition(
    labels: np.ndarray, M: int, lost_labels: list[list[int]], seed: int = 0
) -> list[np.ndarray]:
    """Each worker sees all data EXCEPT its lost labels, partitioned
    disjointly among the workers that can hold each label."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    assert len(lost_labels) == M
    holders: dict[int, list[int]] = {}
    for lab in np.unique(labels):
        holders[int(lab)] = [i for i in range(M) if int(lab) not in lost_labels[i]]
    parts: list[list[int]] = [[] for _ in range(M)]
    for lab, workers in holders.items():
        idx = np.where(labels == lab)[0]
        idx = rng.permutation(idx)
        if not workers:
            continue
        for j, chunk in enumerate(np.array_split(idx, len(workers))):
            parts[workers[j]].extend(chunk.tolist())
    return [np.sort(np.asarray(p, dtype=np.int64)) for p in parts]
