"""Pluggable communication strategies, ported to torch.

Importing this package populates the registry with the async gossip
family: ``netmax``, ``adpsgd`` and ``adpsgd+mon``.  The collective, PS and
top-k strategies are ROADMAP A5.

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

# Importing the strategy module registers its strategies.
from repro_torch.algos import netmax as _netmax  # noqa: F401

__all__ = [
    "Algorithm",
    "AlgoState",
    "Timing",
    "get_algorithm",
    "list_algorithms",
    "mean_params",
    "register",
]
