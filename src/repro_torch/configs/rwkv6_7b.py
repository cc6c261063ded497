"""RWKV-6 'Finch' 7B: attention-free, data-dependent decay.

[arXiv:2404.05892; hf].  Serves long_500k (O(1) recurrent state per token).
"""

from repro_torch.configs.base import ArchConfig, RWKVConfig, register

CFG = register(
    ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,   # d_model / rwkv head_dim
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        head_dim=64,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64),
        worker_axes=("pod", "data"),
        microbatches=4,
        notes="Attention-free: NetMax applies unchanged (protocol is model-agnostic).",
    )
)
