"""Per-architecture configs (one module per assigned arch) + registry.

The port's own copy of the JAX package's ``configs`` (data only), so that
``all_archs()`` gives the same names and fields without importing it.
"""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    MambaConfig,
    MoEConfig,
    RWKVConfig,
    ShapeSpec,
    all_archs,
    get_arch,
    register,
)
