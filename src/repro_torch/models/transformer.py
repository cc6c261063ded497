"""Decoder-LM assembly: the dense and ssm families.

A transcription of the dense and ssm paths of ``repro/models/transformer.py``.
The layout is the JAX package's: block parameters and caches are stacked on a
leading layer axis, and ``lax.scan`` over blocks becomes a Python loop over
the layer index.  Each block provides:

    init(gen, cfg, dtype) -> params              (single layer)
    apply(params, x, cfg) -> (x, aux)            (prefill, stateless)
    decode(params, x, cache, cfg, pos) -> (x, cache)   (one token)

The ssm family (rwkv6-7b) runs ``models/rwkv.py``'s blocks, whose prefill
goes through the WKV kernel on the card.  Unlike the JAX package, decoding
updates the cache in place (dense: the new K/V written at ``pos`` by
``_dus_seq``; ssm: each layer's new recurrent state copied over the old), and
the cache returned is the one passed in.  ``forward`` is also the training
forward: under autograd with ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` over the
scan body), so only the blocks' inputs are kept and each block's forward
runs again in the backward pass; with grad disabled (serving) nothing
changes.  The moe, hybrid and audio families, the ``every_2`` MoE interleave
and vision tokens are not ported yet (ROADMAP A8): they raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.modules import (
    DTYPES,
    embedding_init,
    embedding_lookup,
    lecun_normal,
    make_norm,
    mlp,
    mlp_init,
    pick_chunk,
)


def _dt(cfg):
    if cfg.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"{cfg.name}: dtype {cfg.dtype!r}")
    return DTYPES[cfg.dtype]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family in ("moe", "hybrid", "audio") or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP A8); "
            "the port runs the dense and ssm families"
        )
    if cfg.n_vis_tokens:
        raise NotImplementedError(
            f"{cfg.name}: vision tokens (n_vis_tokens={cfg.n_vis_tokens}) are not "
            "ported yet (ROADMAP A8)"
        )


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
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
# Dense transformer block
# ---------------------------------------------------------------------------


def dense_block_init(gen, cfg: ArchConfig, dtype, use_moe: bool = False, device=None):
    if use_moe:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP A8)")
    device = gen.device if device is None else torch.device(device)
    norm_init, _ = make_norm(cfg.norm)
    return {
        "ln1": norm_init(cfg.d_model, dtype, device),
        "attn": attn.attn_init(gen, cfg, dtype, device=device),
        "ln2": norm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, cfg.activation, device=device),
    }


def dense_block_apply(p, x, cfg: ArchConfig, causal=True, q_chunk=512, kv_chunk=1024):
    _, norm = make_norm(cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = attn.attn_apply(
        p["attn"], norm(p["ln1"], x), cfg, causal=causal,
        q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    x = x + h
    h = mlp(p["mlp"], norm(p["ln2"], x), cfg.activation)
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
    x = x + o.reshape(B, 1, -1) @ p["attn"]["wo"]
    h = norm(p["ln2"], x)
    h = mlp(p["mlp"], h, cfg.activation)
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
# Whole-model init / apply
# ---------------------------------------------------------------------------


def n_blocks(cfg: ArchConfig) -> int:
    _check_family(cfg)
    return cfg.n_layers


def init_params(cfg: ArchConfig, generator=None, device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device; with
    ``device="meta"`` (and no generator) shapes only."""
    dtype = _dt(cfg)
    nb = n_blocks(cfg)
    dev = generator.device if device is None else torch.device(device)
    binit = rwkv_mod.rwkv_block_init if cfg.family == "ssm" else dense_block_init
    blocks = _stack([binit(generator, cfg, dtype, device=dev) for _ in range(nb)])
    norm_init, _ = make_norm(cfg.norm)
    p = {
        "embed": embedding_init(generator, cfg.vocab_size, cfg.d_model, dtype, device=dev),
        "blocks": blocks,
        "final_norm": norm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": lecun_normal(generator, (cfg.d_model, cfg.vocab_size), dtype,
                                          device=dev)}
    return p


def _chunks_for(cfg: ArchConfig, S: int) -> tuple[int, int]:
    # q chunks chosen so the chunk count divides the model axis when the
    # sequence is model-sharded, and so chunks always divide S exactly.
    target_q = max(128, min(512, S // 16)) if S >= 2048 else S
    return pick_chunk(S, target_q), pick_chunk(S, 1024)


def forward(params, tokens, cfg: ArchConfig, vis_embeds=None):
    """Train/prefill forward -> final hidden states (B, S, D) and aux loss
    (0 for these families); blocks rematerialised under autograd when
    ``cfg.remat``."""
    _check_family(cfg)
    x = embedding_lookup(params["embed"], tokens)
    B, S, _ = x.shape
    q_chunk, kv_chunk = _chunks_for(cfg, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        def body(blk, x):
            return rwkv_mod.rwkv_block_apply(blk, x, cfg)[0], aux
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
    return x @ w


# -- decode -----------------------------------------------------------------


def init_cache(cfg: ArchConfig, B: int, S: int, device=None):
    """Stacked per-layer decode cache (leading axis = blocks); ``device``
    defaults to CUDA."""
    dev = resolve_device(device)
    dtype = _dt(cfg)
    if cfg.family == "ssm":  # O(1) recurrent state: S is not used
        return _stack([rwkv_mod.rwkv_init_state(cfg, B, dtype, dev)
                       for _ in range(n_blocks(cfg))])
    return _stack([dense_cache_init(cfg, B, S, dtype, dev) for _ in range(n_blocks(cfg))])


def decode_step(params, cache, token, pos, cfg: ArchConfig):
    """One serve step: token (B,) int, pos scalar -> (logits (B,V) f32,
    cache), the cache updated in place."""
    x = embedding_lookup(params["embed"], token[:, None])  # (B,1,D)
    for i in range(n_blocks(cfg)):
        blk, c = _layer(params["blocks"], i), _layer(cache, i)
        if cfg.family == "ssm":
            x, new = rwkv_mod.rwkv_block_apply(blk, x, cfg, state=c)
            for key, t in new.items():
                c[key].copy_(t)  # views of the stacked cache
            continue
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
