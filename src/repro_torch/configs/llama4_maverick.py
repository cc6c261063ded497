"""Llama-4 Maverick: 400B total / 17B active, 128 experts top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Too large to replicate
per data-row: worker_axes=("pod",) with FSDP(data) x TP(model) inside each
worker (DESIGN.md SS2 worker granularity).
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CFG = register(
    ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        head_dim=128,
        moe=MoEConfig(n_experts=128, top_k=1, layout="every_2"),
        rope_theta=500000.0,
        worker_axes=("pod",),
        fsdp=True,
        microbatches=16,
        notes="MoE interleaved every other layer (how Maverick reaches 400B total); 40 heads % 16 != 0 -> attention TP falls back to replication (hillclimbed via head padding in SSPerf).",
    )
)
