"""Shared result/state types for the LP solver layer.

Kept in their own leaf module so both solver backends (`repro.solver.dense`,
`repro.solver.revised`) and the `repro.solver.lp` facade can import them
without cycles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class LPResult:
    """Outcome of one LP solve: point, objective, status, warm-start extras."""

    x: np.ndarray | None
    fun: float
    status: str  # "optimal" | "infeasible" | "unbounded"
    # Revised-simplex extras (dense backend leaves the defaults):
    # ``basis`` is an opaque warm-start token (see BasisState) valid for the
    # next solve of a same-shaped instance; ``pivots`` counts simplex pivots
    # (bound flips excluded); ``warm_used`` records whether a caller-supplied
    # basis was accepted (vs silently falling back to a cold start).
    basis: "BasisState | None" = None
    pivots: int = 0
    warm_used: bool = False

    @property
    def ok(self) -> bool:
        """Whether the solve reached an optimal point."""
        return self.status == "optimal"


@dataclass
class BasisState:
    """Opaque warm-start token: an optimal basis + nonbasic bound statuses.

    ``key`` fingerprints the instance shape ((m, n) plus two cheap sums of
    A) so a stale token from a differently-shaped problem is rejected up
    front.  A token whose shape matches but whose A differs (fingerprint
    collisions are possible in principle) is still *safe*: the solver
    re-factorizes B from the current columns, re-forces dual feasibility
    against the current costs, and runs the dual simplex to optimality — a
    wrong-but-nonsingular basis only costs extra pivots, never correctness.
    """

    key: tuple
    basis: np.ndarray  # (m,) structural column indices forming B
    vstat: np.ndarray  # (n,) int8: 0 = nonbasic at lb, 1 = at ub, 2 = basic
    meta: dict = field(default_factory=dict)
