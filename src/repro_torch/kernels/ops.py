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

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_rows, gossip_mix_rows_tree
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.tree import tree_map


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

    On CUDA the chunked kernel, which clamps the per-step log decay to
    ``>= -75 / min(16, chunk)``; on the CPU the sequential recurrence, which
    does not (as the JAX package's ``ops.rwkv`` with and without Pallas)."""
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


def gossip_mix_tree(x_half, pulled, weights):
    """Tree-level fused mix used by the batched simulator engine (x_half
    already includes the optimizer update, so u = 0):
    out = (1-w_i) x_half + w_i pulled, leaf by leaf.

    The JAX package's ``gossip_mix_tree``, which mixes each leaf with a
    materialised ``u = zeros_like(h)``.  Here u is absent: on CUDA the whole
    tree is one kernel launch (per dtype group of up to
    ``gossip_mix.MAX_LEAVES`` leaves) that reads no u; on the CPU the plain
    version per leaf, with x + 0.0 for x + u."""
    keys = [(i, k) for i, layer in enumerate(x_half) for k in layer]
    xs = [x_half[i][k] for i, k in keys]
    if not _on_cuda(xs[0]):
        return tree_map(lambda h, p: ref.reference_gossip_mix_rows(h, None, p, weights),
                        x_half, pulled)
    outs = iter(gossip_mix_rows_tree(xs, None, [pulled[i][k] for i, k in keys], weights))
    return [{k: next(outs) for k in layer} for layer in x_half]
