"""Phi-3.5-MoE-instruct: 42B total / 6.6B active, 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct].
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CFG = register(
    ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        head_dim=128,
        moe=MoEConfig(n_experts=16, top_k=2),
        rope_theta=10000.0,
        worker_axes=("pod",),
        fsdp=True,
        microbatches=8,
        notes="All layers MoE; EP=16 over model axis; replica too big for a 16-chip slice with fp32 optimizer state -> pod-level workers + FSDP.",
    )
)
