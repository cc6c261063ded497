"""GQA attention: flash attention for prefill + KV-cache decode.

A transcription of ``repro/models/attention.py``.  ``chunked_attention`` is
the one place the two packages part: the JAX package runs the online-softmax
scan in XLA (it is the reference of its Pallas flash kernel); the port sends
a CUDA tensor to that kernel's hand-written counterpart through
``kernels/ops.attention``, and runs the same scan in torch on the CPU so
that the CPU tests compare like with like.  Decode (one query token against
the cache) is a plain einsum in both, not a kernel.

Mixed dtypes follow JAX (``modules.promote``): whisper's encoder runs on f32
frames against bf16 weights, so its projections are f32, and its decoder's
cross-attention takes a bf16 query against f32 keys and values.
``chunked_attention`` casts such operands to their common dtype before the
kernel and returns q's dtype, as the reference's f32 scan does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.modules import (apply_rope, gather_input, lecun_normal, matmul,
                                       promote, row_project, split_dim, split_heads)

NEG_INF = -1e30


def _pad_q(w, D, Hk, G, Hke, Gn, hd):
    """Pad q-projection (D, Hk*G*hd) -> (D, Hke*Gn*hd) with zeros placed
    PER GROUP so original q heads keep their kv-group assignment."""
    w4 = w.reshape(D, Hk, G, hd)
    w4 = F.pad(w4, (0, 0, 0, Gn - G, 0, Hke - Hk))
    return w4.reshape(D, Hke * Gn * hd)


def _pad_o(w, Hk, G, Hke, Gn, hd, D):
    """Pad out-projection rows (H*hd, D) group-aligned with _pad_q."""
    w4 = w.reshape(Hk, G, hd, D)
    w4 = F.pad(w4, (0, 0, 0, 0, 0, Gn - G, 0, Hke - Hk))
    return w4.reshape(Hke * Gn * hd, D)


def attn_init(gen, cfg, dtype, device=None):
    """Projections sized to the EFFECTIVE (TP-padded) head counts; padded
    heads are zero in both wq and wo, so they are exactly inert."""
    H, Hk, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    He, Hke = cfg.n_heads_eff, cfg.n_kv_heads_eff
    G, Gn = H // Hk, He // Hke
    if He != Hke * Gn:
        raise ValueError("pad_heads must keep H_eff = Hk_eff * G_eff")
    device = gen.device if device is None else torch.device(device)
    wq = lecun_normal(gen, (D, H * hd), dtype, device=device)
    wk = lecun_normal(gen, (D, Hk * hd), dtype, device=device)
    wv = lecun_normal(gen, (D, Hk * hd), dtype, device=device)
    wo = lecun_normal(gen, (H * hd, D), dtype, fan_in=H * hd, device=device)
    if He != H or Hke != Hk:
        wq = _pad_q(wq, D, Hk, G, Hke, Gn, hd)
        wo = _pad_o(wo, Hk, G, Hke, Gn, hd, D)
        if Hke != Hk:
            wk = F.pad(wk.reshape(D, Hk, hd), (0, 0, 0, Hke - Hk)).reshape(D, Hke * hd)
            wv = F.pad(wv.reshape(D, Hk, hd), (0, 0, 0, Hke - Hk)).reshape(D, Hke * hd)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((He * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hke * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hke * hd,), dtype=dtype, device=device)
    return p


def qkv_project(p, x, cfg, positions=None, rope=True):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,Hk,hd), with RoPE applied."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads_eff, cfg.n_kv_heads_eff, cfg.hd
    x = gather_input(x, p["wq"])
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, H, hd)
    k = split_heads(k, Hk, hd)
    v = split_heads(v, Hk, hd)
    if rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal=True, q_chunk=512, kv_chunk=1024):
    """Online-softmax attention. q: (B,S,H,hd); k,v: (B,Sk,Hk,hd) -> (B,S,H,hd).

    On CUDA: the flash-attention kernel (``ops.attention``), which tiles
    for itself, so the chunk sizes do not apply; operands of mixed dtypes
    enter it in their common dtype and the output is q's; on ``meta`` the
    dry-run's route, likewise.  On the CPU: the JAX package's scan over KV
    chunks, transcribed (``_scan_attention``), as ``ops.attention``'s plain
    version.  DTensors go to ``ops.attention`` whole, which runs it on
    their local shards."""
    if q.device.type in ("cuda", "meta"):
        qc, kc, vc = (t.contiguous() for t in promote(q, k, v))
        return ops.attention(qc, kc, vc, causal=causal).to(q.dtype)
    if q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
    return ops.attention(q, k, v, causal=causal, plain=lambda q, k, v, causal: _scan_attention(
        q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk))


def _scan_attention(q, k, v, *, causal, q_chunk, kv_chunk):
    """``repro/models/attention.py::chunked_attention`` in torch: GQA by
    head grouping, stats carried across KV chunks for all q chunks, masked
    scores -1e30, whole-future chunks keep the previous carry, ``l``
    floored at 1e-30."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, Sk)
    if S % q_chunk or Sk % kv_chunk:
        raise ValueError(f"chunks must divide the sequence: S={S} q_chunk={q_chunk}, "
                         f"Sk={Sk} kv_chunk={kv_chunk}")
    nq, nk = S // q_chunk, Sk // kv_chunk
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))

    qg = q.reshape(B, nq, q_chunk, Hk, G, hd).float()
    ks = k.reshape(B, nk, kv_chunk, Hk, hd)
    vs = v.reshape(B, nk, kv_chunk, Hk, hd)
    q_pos = torch.arange(S).reshape(nq, q_chunk)

    acc = torch.zeros((B, nq, q_chunk, Hk, G, hd), dtype=torch.float32)
    m = torch.full((B, nq, q_chunk, Hk, G), NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, nq, q_chunk, Hk, G), dtype=torch.float32)
    for kidx in range(nk):
        kb, vb = ks[:, kidx].float(), vs[:, kidx].float()
        s = torch.einsum("bnqhgd,bkhd->bnqhgk", qg, kb) * scale
        if causal:
            k_pos = kidx * kv_chunk + torch.arange(kv_chunk)
            mask = q_pos[None, :, :, None, None, None] >= k_pos
            s = torch.where(mask, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bnqhgk,bkhd->bnqhgd", p, vb)
        if causal:
            # A chunk wholly in the future of a q chunk keeps its carry.
            fm = ((kidx * kv_chunk) > q_pos[:, -1])[None, :, None, None, None]
            acc_new = torch.where(fm[..., None], acc, acc_new)
            l_new = torch.where(fm, l, l_new)
            m_new = torch.where(fm, m, m_new)
        acc, m, l = acc_new, m_new, l_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, S, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length=None):
    """Single-token attention against the KV cache (a plain einsum, as in
    the JAX package).  q: (B, 1, H, hd); caches: (B, S, Hk, hd).  DTensors
    with q split on heads run on the local shards where they can
    (``_decode_attention_local``)."""
    if hasattr(q, "placements"):
        out = _decode_attention_local(q, k_cache, v_cache, length)
        if out is not None:
            return out
    B, _, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    qg = split_dim(q, 2, (Hk, G)).reshape(B, Hk, G, hd)
    # Scalars stay Python numbers: a tensor made from one on the card is a
    # host-to-device copy, which waits for the stream.
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) / math.sqrt(hd)
    if length is not None:
        mask = torch.arange(S, device=q.device)[None, None, None, :] < length
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _decode_attention_local(q, k_cache, v_cache, length):
    """``decode_attention`` of DTensors on the local shards, the attention
    split over the mesh dim that splits q's heads, as the prefill's
    (``kernels/ops.py``): rank c of n holds query heads [c h, (c + 1) h),
    h = H / n, and slices their KV heads from its cache, which that dim
    replicates (the cache's other splits, the batch's, must be q's), before
    the cast to f32, so it casts only those.  The output is split on heads
    as q is.  None where that does not hold: q split on heads over no mesh
    dim or several, H not divisible, a rank's heads not whole KV groups nor
    within one (12 heads on 16 ranks, 3 heads of groups of 2)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not hasattr(k_cache, "placements"):
        return None
    mesh = q.device_mesh
    dims = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    if len(dims) != 1:
        return None
    i = dims[0]
    B, _, H, hd = q.shape
    G, n = H // k_cache.shape[2], mesh.shape[i]
    h = H // n
    if H % n or (G % h and h % G):
        return None
    for j, (pq, pk) in enumerate(zip(q.placements, k_cache.placements)):
        if pk != (Replicate() if j == i else pq) or pk != v_cache.placements[j]:
            return None
    lo, nk = mesh.get_local_rank(i) * h // G, max(h // G, 1)
    out = decode_attention(q.to_local(), k_cache.to_local()[:, :, lo:lo + nk],
                           v_cache.to_local()[:, :, lo:lo + nk], length)
    return DTensor.from_local(out, mesh, q.placements, run_check=False, shape=q.shape,
                              stride=(H * hd, H * hd, hd, 1))


def attn_apply(p, x, cfg, *, causal=True, positions=None, rope=True,
               q_chunk=512, kv_chunk=1024):
    """Full attention sub-layer (projections + flash attention + out proj)."""
    q, k, v = qkv_project(p, x, cfg, positions=positions, rope=rope)
    o = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    B, S = x.shape[:2]
    return row_project(o.reshape(B, S, -1), p["wo"])


def cross_attn_apply(p, x, kv_src, cfg, q_chunk=512, kv_chunk=1024):
    """Encoder-decoder cross attention (whisper): queries from x (B,S,D),
    keys and values from the encoder output kv_src (B,Se,D); not causal, no
    RoPE."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads_eff, cfg.n_kv_heads_eff, cfg.hd
    Se = kv_src.shape[1]
    kv_src = gather_input(kv_src, p["wk"])
    q = split_heads(matmul(gather_input(x, p["wq"]), p["wq"]), H, hd)
    k = split_heads(matmul(kv_src, p["wk"]), Hk, hd)
    v = split_heads(matmul(kv_src, p["wv"]), Hk, hd)
    o = chunked_attention(q, k, v, causal=False, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return row_project(o.reshape(B, S, -1), p["wo"])


def decode_qkv(p, x, cfg, position):
    """One-token projections for the decode step. x: (B, 1, D); position a
    scalar or a (B,) tensor."""
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads_eff, cfg.n_kv_heads_eff, cfg.hd
    x = gather_input(x, p["wq"])
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, H, hd)
    k = split_heads(k, Hk, hd)
    v = split_heads(v, Hk, hd)
    if isinstance(position, torch.Tensor) and position.ndim == 1:
        pos = position[:, None]
    else:  # a fill, not a host-to-device copy (which would wait for the stream)
        pos = torch.full((B, 1), int(position), device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v
