"""InternVL2-1B backbone: InternLM2-1B LM (GQA kv=2) + ViT patch stub.

[arXiv:2404.16821; hf].  The vision frontend is a STUB: input_specs()
supplies precomputed patch embeddings (n_vis_tokens x d_model).
"""

from repro_torch.configs.base import ArchConfig, register

CFG = register(
    ArchConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        head_dim=64,
        n_vis_tokens=256,
        tie_embeddings=True,
        rope_theta=1e6,
        worker_axes=("pod", "data"),
        notes="InternViT frontend stubbed; backbone LM trains under NetMax-DP.",
    )
)
