"""LP solver layer: dense/revised simplex backends behind the solve_lp facade."""

from repro_torch.solver.lp import (
    BasisState,
    LPResult,
    lp_method,
    solve_lp,
    solve_lp_dense,
    solve_lp_revised,
)

__all__ = [
    "BasisState",
    "LPResult",
    "lp_method",
    "solve_lp",
    "solve_lp_dense",
    "solve_lp_revised",
]
