"""Gossip-family strategies: NetMax (paper Alg. 2/3) and AD-PSGD baselines.

  netmax      adaptive P from Alg. 3; mix weight alpha*rho*gamma_{i,m}
  adpsgd      uniform neighbor, fixed averaging weight 1/2 (Lian et al., 2018)
  adpsgd+mon  AD-PSGD retrofitted with Monitor-optimized probabilities
              (paper §V-H / Fig. 15)
"""

from __future__ import annotations

from repro_torch.algos.base import Algorithm, AlgoState, register


class GossipAlgorithm(Algorithm):
    """Shared event-driven gossip behavior: neighbor ~ P[i], pull + mix.

    The whole family is pull-only (``apply_comm`` touches replicas[i] alone),
    so it inherits ``supports_batched = True`` and runs on the vectorized
    cohort engine (train/engine.py) as well as the reference event loop.
    """

    family = "gossip"
    synchronous = False
    reports_ema = True

    def select_peer(self, state: AlgoState, i: int, rng) -> int:
        # Cached-CDF draw. ``rng.choice(M, p=row)`` recomputes the row's
        # cumsum on every event — O(M) per draw, the dominant host cost at
        # fleet scale. P is only ever rebound (never mutated in place), so
        # the per-row CDFs stay valid until ``state.policy_version``
        # changes — the counter AlgoState bumps on every rebind of P.
        # (Keying on ``id(state.P)`` is unsound: a freed policy matrix's
        # address can be reused by a later allocation, serving stale CDFs.)
        # The draw mirrors Generator.choice's internals exactly (cumsum,
        # normalize by the last entry, searchsorted(random(), 'right')),
        # consuming one uniform — bit-identical to the rng.choice path.
        pid, cdfs = state.extras.get("_peer_cdf", (None, None))
        if pid != state.policy_version:
            cdfs = {}
            state.extras["_peer_cdf"] = (state.policy_version, cdfs)
        cdf = cdfs.get(i)
        if cdf is None:
            row = state.P[i] / state.P[i].sum()
            cdf = row.cumsum()
            cdf /= cdf[-1]
            cdfs[i] = cdf
        return int(cdf.searchsorted(rng.random(), side="right"))


@register("netmax")
class NetMax(GossipAlgorithm):
    """Paper Algorithm 2: adaptive peer selection + gamma-weighted mixing."""

    def wants_monitor(self, cfg) -> bool:
        return not getattr(cfg, "uniform_policy", False)

    def on_policy(self, state, pol):
        super().on_policy(state, pol)
        state.rho = pol.rho  # NetMax also adopts the Alg.-3 consensus step

    def mix_weight(self, state, cfg, i, m):
        if not getattr(cfg, "adaptive_weight", True):
            return 0.5
        d = state.d
        gamma = (d[i, m] + d[m, i]) / (2 * state.P[i, m])
        return min(cfg.lr * state.rho_of(i) * gamma, 0.9)


@register("adpsgd")
class AdPsgd(GossipAlgorithm):
    """Lian et al. AD-PSGD: uniform neighbor, fixed 1/2 averaging."""

    def mix_weight(self, state, cfg, i, m):
        return 0.5


@register("adpsgd+mon")
class AdPsgdMonitored(AdPsgd):
    """AD-PSGD with Monitor-optimized selection probabilities (paper §V-H):
    P adapts to the network, the averaging weight stays 1/2."""

    def wants_monitor(self, cfg) -> bool:
        return not getattr(cfg, "uniform_policy", False)
