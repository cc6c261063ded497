"""Whisper-small: 12L enc + 12L dec, conv frontend STUB.

[arXiv:2212.04356; unverified].  input_specs() provides precomputed frame
embeddings; decode shapes exercise the decoder with a mechanically sized
self-attention KV cache.
"""

from repro_torch.configs.base import ArchConfig, register

CFG = register(
    ArchConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        head_dim=64,
        activation="gelu",
        norm="layernorm",
        n_enc_layers=12,
        enc_seq_len=1500,
        worker_axes=("pod", "data"),
        notes="Enc-dec; 12 heads % 16 != 0 -> seq-parallel attention fallback.",
    )
)
