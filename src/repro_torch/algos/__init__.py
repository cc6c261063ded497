"""Pluggable communication strategies, ported to torch.

Importing this package populates the registry with the paper's seven
strategies plus the beyond-paper ``netmax-topk``, the JAX package's eight:
``adpsgd``, ``adpsgd+mon``, ``allreduce``, ``netmax``, ``netmax-topk``,
``prague``, ``ps-async`` and ``ps-sync``.

    from repro_torch.algos import get_algorithm, list_algorithms
    algo = get_algorithm("netmax")
"""

from repro_torch.algos.base import (
    Algorithm,
    AlgoState,
    Timing,
    get_algorithm,
    list_algorithms,
    mean_params,
    register,
)

# Importing the strategy modules registers them.
from repro_torch.algos import collective as _collective  # noqa: F401
from repro_torch.algos import netmax as _netmax  # noqa: F401
from repro_torch.algos import netmax_topk as _netmax_topk  # noqa: F401
from repro_torch.algos import ps as _ps  # noqa: F401

__all__ = [
    "Algorithm",
    "AlgoState",
    "Timing",
    "get_algorithm",
    "list_algorithms",
    "mean_params",
    "register",
]
