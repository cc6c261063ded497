"""Sequence scans for the recurrent layers, forward only.

A transcription of ``chunked_scan`` from ``repro/models/scan_utils.py``.
The JAX version splits time into chunks so that ``jax.checkpoint`` bounds
the carries its backward pass keeps; the port serves and keeps no
activations, so the scan is one loop over time.  The reference's input
check stays (there an ``assert``, here a ``ValueError``), so both packages
accept the same sequence lengths.
"""

from __future__ import annotations

import torch


def check_chunk(S: int, chunk: int) -> None:
    """A scan longer than one chunk must cut into whole chunks."""
    if S > chunk and S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")


def chunked_scan(step_fn, init, xs, chunk: int = 64):
    """Like ``lax.scan(step_fn, init, xs)``: xs is a tuple of (S, ...)
    tensors; returns (final carry, ys stacked (S, ...))."""
    S = xs[0].shape[0]
    check_chunk(S, chunk)
    carry, ys = init, []
    for t in range(S):
        carry, y = step_fn(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)
