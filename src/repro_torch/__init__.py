"""repro_torch — the PyTorch/CUDA port of the NetMax reproduction.

A second package beside ``repro`` (the JAX reference) with the same module
layout.  It imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``: numpy-only modules of the reference are carried over as copies.
Entry points run on CUDA unless the caller passes ``device="cpu"``; the
kernels (``kernels/``: gossip mix, flash attention, the RWKV-6 WKV scan) are
hand-written CUDA for Hopper (``sm_90a``), built on first use.
"""
