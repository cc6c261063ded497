"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; CUDA raises when no card is present (pass
    ``device="cpu"`` to run on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda":
        # f32 matmuls run in full f32, as the JAX reference does on the CPU
        # (the simulator's MLP, the LM in its f32 configs).
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
