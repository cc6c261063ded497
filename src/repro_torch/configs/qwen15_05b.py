"""Qwen1.5-0.5B: MHA with QKV bias.  [hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.configs.base import ArchConfig, register

CFG = register(
    ArchConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        head_dim=64,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
        worker_axes=("pod", "data"),
        microbatches=2,
    )
)
