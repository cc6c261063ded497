"""Device dispatchers for the hand-written kernels.

Dispatch is by the tensor's device and nothing else: a CUDA tensor goes to
the hand-written kernel (``kernels/gossip_mix.py``,
``kernels/flash_attention.py``, ``kernels/rwkv_scan.py``), a CPU tensor to
its plain version
(``kernels/ref.py``), and any other device raises.  There is
no mode switch (the JAX package's ``use_pallas``) and no fallback: a kernel
that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_rows, gossip_mix_rows_tree
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def _on_cuda(x, what="gossip-mix") -> bool:
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no {what} path for device {x.device}")
    return kind == "cuda"


def attention(q, k, v, *, causal=True):
    """GQA attention. q: (B,S,H,hd); k/v: (B,Sk,Hk,hd) -> (B,S,H,hd)."""
    if _on_cuda(q, "attention"):
        return flash_attention(q, k, v, causal=causal)
    return ref.reference_attention(q, k, v, causal=causal)


def rwkv(r, k, v, w, u, *, chunk=64, state=None):
    """WKV recurrence. r/k/v/w: (B,S,H,N); u: (H,N) -> y (B,S,H,N), or
    (y, final state (B,H,N,N) f32) when an initial ``state`` is given.

    On CUDA the chunked kernel, on the CPU the sequential recurrence; both
    exact for any decay, as the JAX model's scan is (its Pallas kernel
    clamps the per-step log decay to ``>= -75 / min(16, chunk)``).  Both are
    differentiable: on CUDA through the WKV backward kernel
    (``rwkv_scan.RwkvScanFn``), on the CPU through torch's autograd of the
    recurrence."""
    if _on_cuda(r, "rwkv"):
        y, final = rwkv_scan(r, k, v, w, u, chunk=chunk, state=state)
    else:
        y, final = ref.reference_rwkv_state(r, k, v, w, u, state)
    return y if state is None else (y, final)


def mix(x, u, pulled, w):
    """out = (1-w)*(x+u) + w*pulled; w scalar (per worker)."""
    if _on_cuda(x):
        return gossip_mix(x, u, pulled, w)
    return ref.reference_gossip_mix(x, u, pulled, w)


def mix_rows(x, u, pulled, w):
    """Stacked mix with per-row weights (leading worker/cohort axis)."""
    if _on_cuda(x):
        return gossip_mix_rows(x, u, pulled, w)
    return ref.reference_gossip_mix_rows(x, u, pulled, w)


def segment_mean_rows(x, seg, num_segments):
    """Replace each row of ``x`` by the mean of the rows sharing its segment.

    ``x`` is (M, ...) stacked replicas, ``seg`` an (M,) int64 segment id per
    row.  Rows alone in their segment pass through exactly (the sum of one
    row, 0 + x, divided by 1.0), as in the JAX package, whose jnp
    ``segment_sum`` this is; it is not a Pallas kernel there, so here it is
    plain torch on any device (``index_add_`` into zeros, then a gather)."""
    shape = (num_segments,) + tuple(x.shape[1:])
    sums = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(0, seg, x)
    counts = torch.zeros(num_segments, dtype=x.dtype, device=x.device).index_add_(
        0, seg, torch.ones(x.shape[0], dtype=x.dtype, device=x.device))
    cnt = counts[seg].reshape((-1,) + (1,) * (x.ndim - 1))
    return sums[seg] / cnt


def gossip_mix_tree(x_half, pulled, weights):
    """Tree-level fused mix used by the batched simulator engine (x_half
    already includes the optimizer update, so u = 0):
    out = (1-w_i) x_half + w_i pulled, leaf by leaf, over any tree
    (``tree.py``), returned in the same structure; ``[]`` gives ``[]``.

    The JAX package's ``gossip_mix_tree``, which mixes each leaf with a
    materialised ``u = zeros_like(h)``.  Here u is absent: on CUDA the whole
    tree is one kernel launch (per dtype group of up to
    ``gossip_mix.MAX_LEAVES`` leaves) that reads no u; on the CPU the plain
    version per leaf, with x + 0.0 for x + u."""
    xs, treedef = tree_flatten(x_half)
    ps = tree_leaves(pulled)
    if len(ps) != len(xs):
        raise ValueError(f"gossip_mix_tree: {len(xs)} leaves of x_half against "
                         f"{len(ps)} of pulled")
    if not xs:
        return tree_unflatten(treedef, [])
    if _on_cuda(xs[0]):
        outs = gossip_mix_rows_tree(xs, None, ps, weights)
    else:
        outs = [ref.reference_gossip_mix_rows(h, None, p, weights) for h, p in zip(xs, ps)]
    return tree_unflatten(treedef, outs)
