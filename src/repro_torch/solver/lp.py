"""LP solver facade.

Solves   min  c @ x
         s.t. A_eq @ x == b_eq
              lb <= x <= ub        (ub may be +inf)

Two backends live behind ``solve_lp``:

* ``"revised"`` (default) — the bounded-variable revised simplex in
  ``repro.solver.revised``: no tableau, no ub-slack rows (bounds are
  implicit in the nonbasic-at-bound statuses), an m x m basis
  factorization (dense product-form on small instances, sparse-LU + eta
  file above ``_LU_MIN_ROWS``) with periodic refactorization, selectable
  pricing (Dantzig / partial / Devex), and a warm-start protocol
  (``warm=``/``LPResult.basis``) that turns the Algorithm-3 (rho, t_bar)
  grid sweep into dual-simplex restarts.  This is what makes M=128+
  policy generation cheap (see DESIGN.md §13/§17).
* ``"dense"`` — the original two-phase tableau simplex, kept verbatim in
  ``repro.solver.dense`` as the differential-testing oracle (the role the
  reference event loop plays for the batched engine) and as an escape
  hatch.

``lp_method("dense")`` switches the process-wide default inside a ``with``
block — that is how the differential tests and the policy benchmark drive
the whole Algorithm-3 stack through the oracle.  ``lp_pricing("dantzig")``
does the same for the revised backend's pricing rule — that is how the
serve benchmark measures the Dantzig pivot baseline at M >= 128 without
threading a parameter through Algorithm 3.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from repro_torch.solver.dense import solve_lp_dense
from repro_torch.solver.result import BasisState, LPResult
from repro_torch.solver.revised import PRICING_RULES, solve_lp_revised

__all__ = [
    "BasisState",
    "LPResult",
    "lp_method",
    "lp_pricing",
    "solve_lp",
    "solve_lp_dense",
    "solve_lp_revised",
]

_DEFAULT_METHOD = "revised"
_DEFAULT_PRICING = "auto"


@contextmanager
def lp_method(name: str):
    """Temporarily switch the default ``solve_lp`` backend ("revised"/"dense")."""
    global _DEFAULT_METHOD
    if name not in ("revised", "dense"):
        raise ValueError(f"unknown LP method {name!r}")
    old, _DEFAULT_METHOD = _DEFAULT_METHOD, name
    try:
        yield
    finally:
        _DEFAULT_METHOD = old


@contextmanager
def lp_pricing(name: str):
    """Temporarily pin the revised backend's pricing rule.

    "auto" (default) prices small instances with Dantzig (bit-identical to
    the historical solver) and large ones with a partial rotating window;
    "dantzig"/"partial"/"devex" force one rule at every size — benchmarks
    use this to compare pivot counts across rules on the same instance
    stream.
    """
    global _DEFAULT_PRICING
    if name not in PRICING_RULES:
        raise ValueError(f"unknown LP pricing rule {name!r}")
    old, _DEFAULT_PRICING = _DEFAULT_PRICING, name
    try:
        yield
    finally:
        _DEFAULT_PRICING = old


def default_method() -> str:
    """Name of the backend ``solve_lp`` uses when ``method`` is not given."""
    return _DEFAULT_METHOD


def default_pricing() -> str:
    """Name of the pricing rule ``solve_lp`` uses when ``pricing`` is not given."""
    return _DEFAULT_PRICING


def solve_lp(
    c,
    A_eq,
    b_eq,
    lb=None,
    ub=None,
    warm: BasisState | None = None,
    method: str | None = None,
    pricing: str | None = None,
) -> LPResult:
    """Minimize c@x subject to A_eq@x=b_eq, lb<=x<=ub (elementwise).

    ``warm`` threads a ``BasisState`` from a prior solve into the revised
    backend (ignored by the dense oracle); the result's ``.basis`` is the
    token to pass to the next same-shaped solve.  ``A_eq`` may be a
    ``scipy.sparse`` matrix (densified for the dense oracle).
    """
    method = method or _DEFAULT_METHOD
    if method == "dense":
        if hasattr(A_eq, "toarray") and not isinstance(A_eq, np.ndarray):
            A_eq = A_eq.toarray()
        return solve_lp_dense(c, A_eq, b_eq, lb=lb, ub=ub)
    if method == "revised":
        return solve_lp_revised(
            c, A_eq, b_eq, lb=lb, ub=ub, warm=warm,
            pricing=pricing or _DEFAULT_PRICING,
        )
    raise ValueError(f"unknown LP method {method!r}")
