"""Decoder-LM assembly for every decoder family: dense, MoE, ssm, hybrid, VLM.

A transcription of ``repro/models/transformer.py``.  The layout is the JAX
package's: block parameters and caches are stacked on a leading block axis,
and ``lax.scan`` over blocks becomes a Python loop over the block index.
The llama4 ``every_2`` layout stacks periods of two layers (MoE MLP, then
dense MLP); the hybrid (Jamba) stacks periods of ``attn_period`` layers
(mamba mixers, then one attention mixer; MoE MLPs at even positions).  Each
block provides:

    init(gen, cfg, dtype) -> params              (one block)
    apply(params, x, cfg) -> (x, aux)            (prefill, stateless)
    decode(params, x, cache, cfg, pos) -> (x, cache)   (one token)

The ssm family (rwkv6-7b) runs ``models/rwkv.py``'s blocks, whose prefill
goes through the WKV kernel on the card; every attention mixer's prefill
goes through the flash-attention kernel.  The VLM prepends its vision
tokens (``vis_embeds @ vis_proj``, an f32 product cast to the model dtype,
as in JAX) to the text under one causal mask.  Unlike the JAX package,
decoding updates the cache in place (attention: the new K/V written at
``pos`` by ``_dus_seq``; recurrent states copied over the old), and the
cache returned is the one passed in.  ``forward`` is also the training
forward: under autograd with ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` over the
scan body); with grad disabled (serving) nothing changes.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.modules import (
    DTYPES,
    embedding_init,
    embedding_lookup,
    gather_input,
    lecun_normal,
    make_norm,
    matmul,
    mlp,
    mlp_init,
    pick_chunk,
    row_project,
)


def _dt(cfg):
    if cfg.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"{cfg.name}: dtype {cfg.dtype!r}")
    return DTYPES[cfg.dtype]


def _stack(trees):
    """Per-block trees -> one tree stacked on a leading block axis, leaf by
    leaf.  Each leaf's per-block tensors leave ``trees`` as it is stacked,
    and one block is a view, not a copy: init then holds the blocks and at
    most one stacked leaf at once, not a second copy of every block (llama4's
    expert leaves are 10.7 GB each)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(first)}
    if len(trees) == 1:
        return first.unsqueeze(0)
    return torch.stack(trees)


def _layer(tree, i):
    """Layer ``i`` of a tree stacked on a leading layer axis (views), or of a
    list of per-layer trees (the trainer's per-worker leaves)."""
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Dense / MoE transformer block
# ---------------------------------------------------------------------------


def _mlp_init(gen, cfg, dtype, device, use_moe):
    if use_moe:
        return {"moe": moe_mod.moe_init(gen, cfg, dtype, device=device)}
    return {"mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, cfg.activation, device=device)}


def _mlp_apply(p, h, cfg):
    """The block's MLP on normed h -> (out, aux loss () f32): the MoE's, or
    a dense MLP's with aux 0."""
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], h, cfg)
    return (mlp(p["mlp"], h, cfg.activation),
            torch.zeros((), dtype=torch.float32, device=h.device))


def dense_block_init(gen, cfg: ArchConfig, dtype, use_moe: bool = False, device=None):
    device = gen.device if device is None else torch.device(device)
    norm_init, _ = make_norm(cfg.norm)
    return {
        "ln1": norm_init(cfg.d_model, dtype, device),
        "attn": attn.attn_init(gen, cfg, dtype, device=device),
        "ln2": norm_init(cfg.d_model, dtype, device),
        **_mlp_init(gen, cfg, dtype, device, use_moe),
    }


def dense_block_apply(p, x, cfg: ArchConfig, causal=True, q_chunk=512, kv_chunk=1024):
    _, norm = make_norm(cfg.norm)
    h = attn.attn_apply(
        p["attn"], norm(p["ln1"], x), cfg, causal=causal,
        q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    x = x + h
    h, aux = _mlp_apply(p, norm(p["ln2"], x), cfg)
    return x + h, aux


def dense_block_decode(p, x, cache, cfg: ArchConfig, pos):
    """x: (B,1,D); cache: {'k','v'}: (B,S,Hk,hd); write at pos (in place),
    attend <= pos."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["ln1"], x)
    q, k, v = attn.decode_qkv(p["attn"], h, cfg, pos)
    cache = {
        "k": _dus_seq(cache["k"], k, pos),
        "v": _dus_seq(cache["v"], v, pos),
    }
    o = attn.decode_attention(q, cache["k"], cache["v"], length=pos + 1)
    B = x.shape[0]
    x = x + row_project(o.reshape(B, 1, -1), p["attn"]["wo"])
    h, _ = _mlp_apply(p, norm(p["ln2"], x), cfg)
    return x + h, cache


def _dus_seq(buf, val, pos):
    """Write val (B,1,...) into buf (B,S,...) at seq index pos, in place (the
    JAX package's ``dynamic_update_slice``, including its clamp of the
    start index into [0, S - 1]); returns ``buf``."""
    start = min(max(int(pos), 0), buf.shape[1] - val.shape[1])
    buf[:, start:start + val.shape[1]] = val.to(buf.dtype)
    return buf


def dense_cache_init(cfg: ArchConfig, B: int, S: int, dtype, device):
    Hk, hd = cfg.n_kv_heads_eff, cfg.hd
    return {
        "k": torch.zeros((B, S, Hk, hd), dtype=dtype, device=device),
        "v": torch.zeros((B, S, Hk, hd), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# MoE-interleaved period (llama4's "every_2"): pos0 = MoE MLP, pos1 = dense
# MLP, both attention mixers; stacked as periods of 2 so the blocks stay
# homogeneous.
# ---------------------------------------------------------------------------


def moe_period_init(gen, cfg: ArchConfig, dtype, device=None):
    return {
        "pos0": dense_block_init(gen, cfg, dtype, use_moe=True, device=device),
        "pos1": dense_block_init(gen, cfg, dtype, use_moe=False, device=device),
    }


def moe_period_apply(p, x, cfg: ArchConfig, causal=True, q_chunk=512, kv_chunk=1024):
    x, aux0 = dense_block_apply(p["pos0"], x, cfg, causal, q_chunk, kv_chunk)
    x, aux1 = dense_block_apply(p["pos1"], x, cfg, causal, q_chunk, kv_chunk)
    return x, aux0 + aux1


def moe_period_decode(p, x, cache, cfg: ArchConfig, pos):
    x, _ = dense_block_decode(p["pos0"], x, cache["pos0"], cfg, pos)
    x, _ = dense_block_decode(p["pos1"], x, cache["pos1"], cfg, pos)
    return x, cache


def _moe_interleaved(cfg: ArchConfig) -> bool:
    return cfg.moe is not None and cfg.moe.layout == "every_2" and cfg.family != "hybrid"


# ---------------------------------------------------------------------------
# Hybrid (Jamba) period: (attn_period - 1) mamba mixers, then 1 attention
# mixer; MLPs alternate MoE (even position) / dense (odd position).
# ---------------------------------------------------------------------------


def hybrid_period_init(gen, cfg: ArchConfig, dtype, device=None):
    device = gen.device if device is None else torch.device(device)
    norm_init, _ = make_norm(cfg.norm)
    P = cfg.attn_period
    p = {}
    for j in range(P):
        sub = {"ln1": norm_init(cfg.d_model, dtype, device),
               "ln2": norm_init(cfg.d_model, dtype, device)}
        if j == P - 1:
            sub["attn"] = attn.attn_init(gen, cfg, dtype, device=device)
        else:
            sub["mamba"] = mam.mamba_init(gen, cfg, dtype, device=device)
        sub.update(_mlp_init(gen, cfg, dtype, device, cfg.moe is not None and j % 2 == 0))
        p[f"pos{j}"] = sub
    return p


def hybrid_period_apply(p, x, cfg: ArchConfig, q_chunk=512, kv_chunk=1024):
    _, norm = make_norm(cfg.norm)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(cfg.attn_period):
        sub = p[f"pos{j}"]
        h = norm(sub["ln1"], x)
        if "attn" in sub:
            h = attn.attn_apply(sub["attn"], h, cfg, causal=True,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
        else:
            h, _ = mam.mamba_apply(sub["mamba"], h, cfg)
        x = x + h
        h, aux = _mlp_apply(sub, norm(sub["ln2"], x), cfg)
        aux_total = aux_total + aux
        x = x + h
    return x, aux_total


def hybrid_period_decode(p, x, cache, cfg: ArchConfig, pos):
    """One token through a period; the attention K/V and the mamba states
    of ``cache`` (views of the stacked cache) are updated in place."""
    _, norm = make_norm(cfg.norm)
    for j in range(cfg.attn_period):
        sub, c = p[f"pos{j}"], cache[f"pos{j}"]
        h = norm(sub["ln1"], x)
        if "attn" in sub:
            q, k, v = attn.decode_qkv(sub["attn"], h, cfg, pos)
            _dus_seq(c["k"], k, pos)
            _dus_seq(c["v"], v, pos)
            o = attn.decode_attention(q, c["k"], c["v"], length=pos + 1)
            h = row_project(o.reshape(x.shape[0], 1, -1), sub["attn"]["wo"])
        else:
            h, new = mam.mamba_apply(sub["mamba"], h, cfg, state=c)
            _copy_state(c, new)
        x = x + h
        h, _ = _mlp_apply(sub, norm(sub["ln2"], x), cfg)
        x = x + h
    return x, cache


def hybrid_cache_init(cfg: ArchConfig, B: int, S: int, dtype, device):
    P = cfg.attn_period
    return {f"pos{j}": (dense_cache_init(cfg, B, S, dtype, device) if j == P - 1
                        else mam.mamba_init_state(cfg, B, dtype, device))
            for j in range(P)}


def _copy_state(cache, new):
    """Copy a recurrent layer's new state over its cache entries (views of
    the stacked cache)."""
    for key, t in new.items():
        cache[key].copy_(t)


# ---------------------------------------------------------------------------
# Whole-model init / apply
# ---------------------------------------------------------------------------


def n_blocks(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        if cfg.n_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole periods "
                             f"of {cfg.attn_period}")
        return cfg.n_layers // cfg.attn_period
    if _moe_interleaved(cfg):
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: the every_2 layout needs an even layer count, "
                             f"not {cfg.n_layers}")
        return cfg.n_layers // 2
    return cfg.n_layers


def _block_init_fn(cfg: ArchConfig):
    if cfg.family == "hybrid":
        return hybrid_period_init
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_block_init
    if _moe_interleaved(cfg):
        return moe_period_init
    use_moe = cfg.moe is not None
    return lambda gen, cfg, dtype, device=None: dense_block_init(gen, cfg, dtype, use_moe,
                                                                  device=device)


def init_params(cfg: ArchConfig, generator=None, device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device; with
    ``device="meta"`` (and no generator) shapes only."""
    dtype = _dt(cfg)
    dev = generator.device if device is None else torch.device(device)
    binit = _block_init_fn(cfg)
    blocks = _stack([binit(generator, cfg, dtype, device=dev) for _ in range(n_blocks(cfg))])
    norm_init, _ = make_norm(cfg.norm)
    p = {
        "embed": embedding_init(generator, cfg.vocab_size, cfg.d_model, dtype, device=dev),
        "blocks": blocks,
        "final_norm": norm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": lecun_normal(generator, (cfg.d_model, cfg.vocab_size), dtype,
                                          device=dev)}
    if cfg.n_vis_tokens:
        # VLM stub projection applied to precomputed patch embeddings.
        p["vis_proj"] = {"w": lecun_normal(generator, (cfg.d_model, cfg.d_model), dtype,
                                           device=dev)}
    return p


def _chunks_for(cfg: ArchConfig, S: int) -> tuple[int, int]:
    # q chunks chosen so the chunk count divides the model axis when the
    # sequence is model-sharded, and so chunks always divide S exactly.
    target_q = max(128, min(512, S // 16)) if S >= 2048 else S
    return pick_chunk(S, target_q), pick_chunk(S, 1024)


def forward(params, tokens, cfg: ArchConfig, vis_embeds=None):
    """Train/prefill forward -> final hidden states (B, S, D) and the aux
    loss summed over blocks (0 without MoE); with vision tokens S counts
    them too.  Blocks rematerialised under autograd when ``cfg.remat``."""
    x = embedding_lookup(params["embed"], tokens)
    if cfg.n_vis_tokens:
        if vis_embeds is None:
            raise ValueError(f"{cfg.name}: the vlm family's forward needs vis_embeds "
                             f"(B, {cfg.n_vis_tokens}, {cfg.d_model})")
        v = matmul(vis_embeds, params["vis_proj"]["w"])
        x = torch.cat([v.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    q_chunk, kv_chunk = _chunks_for(cfg, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        def body(blk, x):
            return rwkv_mod.rwkv_block_apply(blk, x, cfg)[0], aux
    elif cfg.family == "hybrid":
        def body(blk, x):
            return hybrid_period_apply(blk, x, cfg, q_chunk, kv_chunk)
    elif _moe_interleaved(cfg):
        def body(blk, x):
            return moe_period_apply(blk, x, cfg, True, q_chunk, kv_chunk)
    else:
        def body(blk, x):
            return dense_block_apply(blk, x, cfg, True, q_chunk, kv_chunk)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n_blocks(cfg)):
        blk = _layer(params["blocks"], i)
        if remat:
            x, a = checkpoint(body, blk, x, use_reentrant=False)
        else:
            x, a = body(blk, x)
        aux = aux + a
    _, norm = make_norm(cfg.norm)
    x = norm(params["final_norm"], x)
    return x, aux


def logits_head(params, x, cfg: ArchConfig):
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return gather_input(x, w) @ w


# -- decode -----------------------------------------------------------------


def init_cache(cfg: ArchConfig, B: int, S: int, device=None):
    """Stacked per-block decode cache (leading axis = blocks); ``device``
    defaults to CUDA."""
    dev = resolve_device(device)
    dtype = _dt(cfg)
    if cfg.family == "ssm":  # O(1) recurrent state: S is not used
        def one():
            return rwkv_mod.rwkv_init_state(cfg, B, dtype, dev)
    elif cfg.family == "hybrid":
        def one():
            return hybrid_cache_init(cfg, B, S, dtype, dev)
    elif _moe_interleaved(cfg):
        def one():
            return {"pos0": dense_cache_init(cfg, B, S, dtype, dev),
                    "pos1": dense_cache_init(cfg, B, S, dtype, dev)}
    else:
        def one():
            return dense_cache_init(cfg, B, S, dtype, dev)
    return _stack([one() for _ in range(n_blocks(cfg))])


def decode_step(params, cache, token, pos, cfg: ArchConfig):
    """One serve step: token (B,) int, pos scalar -> (logits (B,V) f32,
    cache), the cache updated in place."""
    x = embedding_lookup(params["embed"], token[:, None])  # (B,1,D)
    for i in range(n_blocks(cfg)):
        blk, c = _layer(params["blocks"], i), _layer(cache, i)
        if cfg.family == "ssm":
            x, new = rwkv_mod.rwkv_block_apply(blk, x, cfg, state=c)
            _copy_state(c, new)
        elif cfg.family == "hybrid":
            x, _ = hybrid_period_decode(blk, x, c, cfg, pos)
        elif _moe_interleaved(cfg):
            x, _ = moe_period_decode(blk, x, c, cfg, pos)
        else:
            x, _ = dense_block_decode(blk, x, c, cfg, pos)
    _, norm = make_norm(cfg.norm)
    x = norm(params["final_norm"], x)
    logits = logits_head(params, x[:, 0, :], cfg)
    return logits.float(), cache


def prefill(params, tokens, cfg: ArchConfig, vis_embeds=None):
    """Prefill: forward + the logits of the last position (B, 1, V) f32; see
    serve.engine.capture_prefill for the variant that also fills a cache."""
    x, _ = forward(params, tokens, cfg, vis_embeds=vis_embeds)
    return logits_head(params, x[:, -1:, :], cfg).float()
