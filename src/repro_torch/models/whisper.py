"""Whisper-style encoder-decoder (the audio family).

A transcription of ``repro/models/whisper.py``.  The conv/mel frontend is a
stub (``models/frontends.py``): the encoder takes precomputed frame
embeddings (B, S_enc, D), f32 as the JAX input specs give.  The backbone is
real: a bidirectional encoder (sinusoid positions added, no RoPE) and a
causal decoder (learned positions, no RoPE) with cross-attention, LayerNorm
and GELU.  JAX promotes the f32 frames against bf16 weights, so the encoder
runs in f32 and the decoder's cross-attention takes f32 keys and values
(``modules.promote``); every attention prefill goes through the
flash-attention kernel on the card.  The encoder and the teacher-forced
decoder are also the training forward: under autograd with ``cfg.remat``
each block is rematerialised (``torch.utils.checkpoint``), as in
``models/transformer.py``.

Two behaviours of the reference are kept (ROADMAP C8): the decode cache's
cross-attention K/V (``xk``/``xv``) start at zero and nothing writes them,
so a serving decode cross-attends to zeros; and ``capture_prefill`` does
not serve this family (``serve/engine.py``).  Decoding updates the cache in
place, as ``models/transformer.py`` does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.modules import (
    embedding_init,
    embedding_lookup,
    layernorm,
    layernorm_init,
    lecun_normal,
    mlp,
    mlp_init,
    pick_chunk,
    sinusoidal_positions,
    split_heads,
)
from repro_torch.models.transformer import _dt, _dus_seq, _layer, _stack

#: Rows of the learned decoder position table (the JAX package's size: the
#: largest decode shape it lowers).
DEC_POSITIONS = 32768


def enc_block_init(gen, cfg, dtype, device):
    return {
        "ln1": layernorm_init(cfg.d_model, dtype, device),
        "attn": attn.attn_init(gen, cfg, dtype, device=device),
        "ln2": layernorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, "gelu", device=device),
    }


def dec_block_init(gen, cfg, dtype, device):
    return {
        "ln1": layernorm_init(cfg.d_model, dtype, device),
        "self_attn": attn.attn_init(gen, cfg, dtype, device=device),
        "ln_x": layernorm_init(cfg.d_model, dtype, device),
        "cross_attn": attn.attn_init(gen, cfg, dtype, device=device),
        "ln2": layernorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, "gelu", device=device),
    }


def init_params(cfg: ArchConfig, generator=None, device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device; with
    ``device="meta"`` (and no generator) shapes only."""
    dtype = _dt(cfg)
    dev = generator.device if device is None else torch.device(device)
    enc = _stack([enc_block_init(generator, cfg, dtype, dev) for _ in range(cfg.n_enc_layers)])
    dec = _stack([dec_block_init(generator, cfg, dtype, dev) for _ in range(cfg.n_layers)])
    return {
        "embed": embedding_init(generator, cfg.vocab_size, cfg.d_model, dtype, device=dev),
        "dec_pos": {"table": lecun_normal(generator, (DEC_POSITIONS, cfg.d_model), dtype,
                                          device=dev)},
        "enc_blocks": enc,
        "dec_blocks": dec,
        "enc_norm": layernorm_init(cfg.d_model, dtype, dev),
        "final_norm": layernorm_init(cfg.d_model, dtype, dev),
        "lm_head": {"w": lecun_normal(generator, (cfg.d_model, cfg.vocab_size), dtype,
                                      device=dev)},
    }


def encode(params, frames, cfg: ArchConfig):
    """frames: (B, S_enc, D) precomputed embeddings -> encoder output
    (B, S_enc, D) in frames' dtype (f32 for the stub's frames)."""
    S = frames.shape[1]
    x = frames + sinusoidal_positions(S, cfg.d_model, frames.device).to(frames.dtype)
    qc, kc = pick_chunk(S, 512), pick_chunk(S, 1024)

    def body(blk, x):
        h = attn.attn_apply(blk["attn"], layernorm(blk["ln1"], x), cfg, causal=False,
                            rope=False, q_chunk=qc, kv_chunk=kc)
        x = x + h
        return x + mlp(blk["mlp"], layernorm(blk["ln2"], x), "gelu")

    x = _blocks(body, params["enc_blocks"], x, cfg.n_enc_layers, cfg)
    return layernorm(params["enc_norm"], x)


def decode_train(params, tokens, enc_out, cfg: ArchConfig):
    """Teacher-forced decoder -> hidden states (B, S, D) in the model dtype."""
    B, S = tokens.shape
    x = embedding_lookup(params["embed"], tokens)
    x = x + params["dec_pos"]["table"][:S]
    qc, kc = pick_chunk(S, 512), pick_chunk(S, 1024)
    xkc = pick_chunk(enc_out.shape[1], 1024)

    def body(blk, x):
        h = attn.attn_apply(blk["self_attn"], layernorm(blk["ln1"], x), cfg, causal=True,
                            rope=False, q_chunk=qc, kv_chunk=kc)
        x = x + h
        h = attn.cross_attn_apply(blk["cross_attn"], layernorm(blk["ln_x"], x), enc_out,
                                  cfg, q_chunk=qc, kv_chunk=xkc)
        x = x + h
        return x + mlp(blk["mlp"], layernorm(blk["ln2"], x), "gelu")

    x = _blocks(body, params["dec_blocks"], x, cfg.n_layers, cfg)
    return layernorm(params["final_norm"], x)


def _blocks(body, blocks, x, n, cfg: ArchConfig):
    """x through ``body(block i, x)`` for each of the n stacked blocks; under
    autograd with ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
    (the JAX package's ``jax.checkpoint`` over the scan body), as
    ``transformer.forward``'s blocks do; with grad disabled (serving) plainly."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n):
        blk = _layer(blocks, i)
        x = checkpoint(body, blk, x, use_reentrant=False) if remat else body(blk, x)
    return x


def init_cache(cfg: ArchConfig, B: int, S: int, device=None):
    """Decoder self-attention K/V (B, S, Hk, hd) and cross-attention K/V
    (B, S_enc, Hk, hd) per layer, stacked; ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    dtype = _dt(cfg)
    Hk, hd, Se = cfg.n_kv_heads, cfg.hd, cfg.enc_seq_len

    def one():
        return {"k": torch.zeros((B, S, Hk, hd), dtype=dtype, device=dev),
                "v": torch.zeros((B, S, Hk, hd), dtype=dtype, device=dev),
                "xk": torch.zeros((B, Se, Hk, hd), dtype=dtype, device=dev),
                "xv": torch.zeros((B, Se, Hk, hd), dtype=dtype, device=dev)}

    return _stack([one() for _ in range(cfg.n_layers)])


def decode_step(params, cache, token, pos, cfg: ArchConfig):
    """One decoder token against the self cache (written at ``pos`` in
    place) and the fixed cross K/V -> (logits (B, V) f32, cache)."""
    x = embedding_lookup(params["embed"], token[:, None])
    start = min(max(int(pos), 0), params["dec_pos"]["table"].shape[0] - 1)
    x = x + params["dec_pos"]["table"][start:start + 1]
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for i in range(cfg.n_layers):
        blk, c = _layer(params["dec_blocks"], i), _layer(cache, i)
        h = layernorm(blk["ln1"], x)
        sa = blk["self_attn"]
        q = split_heads(h @ sa["wq"], H, hd)
        _dus_seq(c["k"], split_heads(h @ sa["wk"], Hk, hd), pos)
        _dus_seq(c["v"], split_heads(h @ sa["wv"], Hk, hd), pos)
        o = attn.decode_attention(q, c["k"], c["v"], length=pos + 1)
        x = x + o.reshape(B, 1, -1) @ sa["wo"]
        # cross attention against the cache's encoder K/V
        h = layernorm(blk["ln_x"], x)
        q = split_heads(h @ blk["cross_attn"]["wq"], H, hd)
        o = attn.decode_attention(q, c["xk"], c["xv"])
        x = x + o.reshape(B, 1, -1) @ blk["cross_attn"]["wo"]
        x = x + mlp(blk["mlp"], layernorm(blk["ln2"], x), "gelu")
    x = layernorm(params["final_norm"], x)
    logits = x[:, 0, :] @ params["lm_head"]["w"]
    return logits.float(), cache
