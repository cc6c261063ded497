"""Jamba-v0.1 52B: Mamba+attention 1:7 interleave, MoE 16e top-2 every 2.

[arXiv:2403.19887; hf].  52B params -> worker_axes=("pod",) with FSDP+TP
inside the worker.  Serves long_500k (mamba state + 4 attention layers).
"""

from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig, register

CFG = register(
    ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        head_dim=128,
        moe=MoEConfig(n_experts=16, top_k=2, layout="every_2"),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        attn_period=8,
        worker_axes=("pod",),
        fsdp=True,
        microbatches=8,
        notes="1 attention layer per 8 (4 of 32); MoE on even layers.",
    )
)
