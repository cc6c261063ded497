"""StarCoder2-3B: GQA kv=2, RoPE.  [arXiv:2402.19173; hf]."""

from repro_torch.configs.base import ArchConfig, register

CFG = register(
    ArchConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        head_dim=128,
        activation="gelu",
        norm="layernorm",
        rope_theta=999999.4,
        worker_axes=("pod", "data"),
        microbatches=4,
        notes="24 heads % 16 != 0 -> seq-parallel attention fallback.",
    )
)
