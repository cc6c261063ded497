"""TinyLlama-1.1B: llama2-arch small, GQA kv=4.  [arXiv:2401.02385; hf]."""

from repro_torch.configs.base import ArchConfig, register

CFG = register(
    ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        head_dim=64,
        rope_theta=10000.0,
        worker_axes=("pod", "data"),
        microbatches=2,
        notes="Used (reduced) by the end-to-end ~100M training example.",
    )
)
