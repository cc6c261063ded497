"""The ``Algorithm`` protocol + registry, ported to torch.

One communication strategy = one ``Algorithm`` subclass owning its three
concerns:

* **peer/group selection** — host-side, numpy RNG (verbatim from the JAX
  package, so every draw is bit-identical);
* **mixing semantics** — torch tensors: how pulled parameters fold into the
  local replica, per replica (``mix``) and on stacked replicas
  (``mix_stacked_tree``, the batched engine's leaf rule);
* **timing semantics** — the per-event duration model (verbatim).

Parameter trees follow JAX's pytree rules (``tree.py``); the simulator's
MLP is a list of ``{"w", "b"}`` dicts of tensors, an LM's a nested dict.
The trainer mixes through ``mix_stacked`` and ``stacked_round`` is its
lockstep reference round.

    @register("my-algo")
    class MyAlgo(Algorithm):
        ...

    algo = get_algorithm("my-algo")
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.tree import tree_map

# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, type["Algorithm"]] = {}


def register(name: str):
    """Class decorator: ``@register("netmax")`` adds the class to the registry."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_algorithm(name: "str | Algorithm", **kwargs) -> "Algorithm":
    """Instantiate a registered algorithm by name (kwargs -> constructor).

    An Algorithm instance passes through unchanged — this is the single
    dispatch point for "name or instance" (SimConfig.algorithm etc.).
    """
    if isinstance(name, Algorithm):
        assert not kwargs, "kwargs only apply when constructing by name"
        return name
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown algorithm {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)


def list_algorithms() -> list[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------
# Shared state / timing records
# --------------------------------------------------------------------------


@dataclass
class AlgoState:
    """Host-side mutable state the event loop shares with the algorithm."""

    M: int
    d: np.ndarray  # connectivity mask (M, M), 0/1, zero diagonal
    P: np.ndarray  # communication policy matrix (rows sum to 1 on edges)
    rho: float  # consensus step size (paper Alg. 3)
    extras: dict = field(default_factory=dict)
    # Per-worker consensus step (set only by partition-aware policy
    # publishing, scenarios/driver.publish_policy): workers a home-pinned
    # Monitor could not reach keep their stale rho while reachable workers
    # adopt the fresh one.  None = everyone shares the scalar ``rho``.
    rho_vec: np.ndarray | None = None
    # Monotonic publish counter: bumped automatically on every rebind of
    # ``P``.  This is the cache key for anything derived from P (the gossip
    # peer-draw CDF cache); ``id(state.P)`` is not safe because a freed
    # policy matrix's address can be reused by a later allocation.  P is
    # never mutated in place by the engines, so "version changed iff P was
    # rebound" holds.
    policy_version: int = 0

    def __setattr__(self, name, value):
        if name == "P":
            object.__setattr__(
                self, "policy_version",
                getattr(self, "policy_version", -1) + 1,
            )
        object.__setattr__(self, name, value)

    def rho_of(self, i: int) -> float:
        """Worker ``i``'s consensus step (stale-policy aware)."""
        if self.rho_vec is None:
            return self.rho
        return float(self.rho_vec[i])


@dataclass
class Timing:
    """Duration model output for one event (async) or one round (sync).

    ``net`` carries the *raw* link time the event drew, before any strategy
    multiplier; traced runs record it per async event.  None for events
    that never drew a link time (local steps, sync rounds).
    """

    duration: float
    comm: float = 0.0
    compute: float = 0.0
    net: float | None = None


def uniform_state(cfg, M: int) -> AlgoState:
    """Fully-connected uniform policy + the conservative initial rho.

    Initial rho keeps w = alpha*rho*gamma <= 0.5 under the uniform policy
    (gamma = M-1); a Monitor's Alg.-3 rho replaces it on first refresh.
    """
    d = np.ones((M, M)) - np.eye(M)
    P = np.where(d > 0, 1.0 / (M - 1), 0.0)
    rho = getattr(cfg, "rho", None)
    if rho is None:
        rho = 0.5 / (2 * cfg.lr * max(M - 1, 1))
    return AlgoState(M=M, d=d, P=P, rho=rho)


def guard_policy_rows(P: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Keep every row a valid sampling distribution (fallback: uniform)."""
    P = P.copy()
    bad = P.sum(axis=1) <= 0
    M = P.shape[0]
    P[bad] = np.where(d[bad] > 0, 1.0 / max(M - 1, 1), 0.0)
    return P


# --------------------------------------------------------------------------
# Protocol
# --------------------------------------------------------------------------


class Algorithm(abc.ABC):
    """One pluggable communication strategy; see module docstring."""

    name: str = "?"
    # gossip  — async pairwise pulls (netmax / adpsgd family)
    # collective — synchronous (partial-)allreduce rounds
    # ps      — parameter-server star
    family: str = "gossip"
    synchronous: bool = False  # round-based barrier loop vs event-driven
    reports_ema: bool = True  # workers feed IterationTimeEMA (Alg. 2 l.19-22)

    @property
    def supports_batched(self) -> bool:
        """Whether the batched engine (train/engine.py) can execute this
        strategy, decided from capabilities as in the JAX package:
        synchronous strategies when both group-averaging forms are default
        or both overridden; asynchronous ones when ``apply_comm`` is the
        default pull+mix or they declare a non-default ``batched_variant``.
        """
        if self.synchronous:
            default_ref = type(self).reduce_groups is Algorithm.reduce_groups
            default_stacked = (
                type(self).reduce_groups_stacked
                is Algorithm.reduce_groups_stacked
            )
            return default_ref == default_stacked
        return (
            type(self).apply_comm is Algorithm.apply_comm
            or self.batched_variant != "gossip"
        )

    @property
    def batched_variant(self) -> str:
        """Which fused cohort step the batched engine builds for async
        strategies: ``"gossip"`` (gather pre-cohort peer rows, pull + mix)
        or ``"ps-serial"`` (every communicating event pushes into one
        serialized row — the PS — folded in pop order inside the dispatch;
        see ``serial_row``)."""
        return "gossip"

    def serial_row(self, state: AlgoState) -> int | None:
        """The replica row the ``"ps-serial"`` batched variant serializes
        inside a fused cohort dispatch (all communicating events read-modify-
        write it in pop order).  ``None`` for variants without one."""
        return None

    # -- lifecycle ----------------------------------------------------------
    def init_state(self, cfg, M: int) -> AlgoState:
        return uniform_state(cfg, M)

    def wants_monitor(self, cfg) -> bool:
        """Whether the simulator should run a Network Monitor for this algo."""
        return False

    def make_monitor(self, cfg, M: int, d=None):
        """Build the Monitor; cfg.monitor_period (when set) is the single
        source of truth for the schedule period T_s, and ``d`` (the
        AlgoState connectivity mask) bounds the topology Algorithm 3
        optimizes over."""
        from repro_torch.core.monitor import NetworkMonitor

        kw = dict(alpha=cfg.lr, K=cfg.policy_K, R=cfg.policy_R, d=d)
        period = getattr(cfg, "monitor_period", None)
        if period is not None:
            kw["schedule_period"] = float(period)
        home = getattr(cfg, "monitor_home_cluster", None)
        if home is not None:
            kw["home_cluster"] = int(home)
        if getattr(cfg, "monitor_failover", False):
            from repro_torch.core.monitor import MonitorFailover

            kw["failover"] = MonitorFailover(
                lease_periods=getattr(cfg, "monitor_lease_periods", 1.0),
                quorum=getattr(cfg, "monitor_quorum", None),
            )
        return NetworkMonitor(M, **kw)

    def on_policy(self, state: AlgoState, pol) -> None:
        """Fold a fresh Monitor policy into host state."""
        state.P = guard_policy_rows(pol.P, state.d)

    # -- peer/group selection (host side, numpy RNG) ------------------------
    def select_peer(self, state: AlgoState, i: int, rng) -> int | None:
        """Async families: the neighbor worker i pulls from this event."""
        raise NotImplementedError(f"{self.name} is not event-driven")

    def select_groups(self, state: AlgoState, rng) -> list[list[int]]:
        """Sync families: the reduction groups for this round."""
        raise NotImplementedError(f"{self.name} is not round-based")

    # -- mixing semantics (torch) -------------------------------------------
    def delta_transform(self, delta: torch.Tensor) -> torch.Tensor:
        """Hook on the consensus delta (x_pull - x_half) of ONE replica.

        Identity here; compression strategies (top-k, quantization) override.
        On the stacked path it is applied row by row (``torch.func.vmap``),
        so it sees unstacked leaf shapes in both paths.
        """
        return delta

    def _identity_delta(self) -> bool:
        return type(self).delta_transform is Algorithm.delta_transform

    def mix_weight(self, state: AlgoState, cfg, i: int, m: int) -> float:
        """Consensus weight w for worker i pulling from m (host side)."""
        return 0.5

    def mix(self, x_half, pulled, w):
        """Per-replica consensus mix: x_half + w * f(pulled - x_half), with
        ``w`` rounded to f32 and cast to the leaf dtype."""
        wf = torch.tensor(w, dtype=torch.float32)

        def leaf(a, b):
            return a + wf.to(a.dtype) * self.delta_transform(b - a)

        return tree_map(leaf, x_half, pulled)

    def mix_stacked_tree(self, x_half, pulled, weights):
        """Stacked consensus mix — THE leaf rule of this strategy.

        Leaves carry a leading worker/cohort axis; ``weights`` is (K,) f32.
        The batched engine's fused step uses it (or ``kernels/ops`` under
        ``SimConfig.use_mix_kernel``).
        """
        delta = (
            self.delta_transform if self._identity_delta()
            else torch.func.vmap(self.delta_transform)
        )

        def leaf(h, p):
            # Cast weights into the param dtype so bf16 replicas stay bf16.
            w = weights.reshape((-1,) + (1,) * (h.ndim - 1)).to(h.dtype)
            return h + w * delta(p - h)

        return tree_map(leaf, x_half, pulled)

    def mix_stacked(self, x_half, pulled, weights):
        """The trainer's stacked mix: ``mix_stacked_tree`` (the JAX package
        jits it; eager torch calls it as it is)."""
        return self.mix_stacked_tree(x_half, pulled, weights)

    def stacked_round(self, params, grads, neighbors, weights, alpha):
        """One lockstep gossip round on stacked replicas (the trainer's
        reference): pull the *pre-round* neighbour rows (Eq. 16), take the
        step ``x - alpha * g`` with alpha in the leaf dtype, then the same
        leaf rule as the event-driven path (``mix_stacked_tree``).

        params/grads leaves: (M, ...); neighbors (M,) ints; weights (M,) f32.
        """
        def pull(x):
            return torch.index_select(x, 0, torch.as_tensor(neighbors, device=x.device).long())

        pulled = tree_map(pull, params)
        x_half = tree_map(
            lambda x, g: x - torch.tensor(alpha, dtype=x.dtype, device=x.device) * g,
            params, grads)
        return self.mix_stacked_tree(x_half, pulled, weights)

    def transform_grads(self, grads, M: int, shard=None):
        """SPMD trainer hook: grad reduction before the optimizer step
        (identity for gossip; global/group mean for collective families).
        ``shard``: when the grads hold one rank's rows of the M workers, its
        ``dist.sharding.WorkerShard``; the reduction is then a collective."""
        return grads

    @property
    def communicates_in_trainer(self) -> bool:
        """Whether the SPMD train step performs a gossip pull + mix."""
        return self.family == "gossip"

    @property
    def supports_trainer(self) -> bool:
        """Whether the lockstep SPMD trainer can express this strategy
        (False for inherently asynchronous semantics such as ps-async)."""
        return True

    # -- event application (async families) ---------------------------------
    def would_communicate(self, state: AlgoState, i: int, m: int | None) -> bool:
        """Host-side predicate: does worker i's event with peer m cross the
        network?  Must agree with ``apply_comm``'s return value — the batched
        engine uses it to price events *before* executing a cohort."""
        return m is not None and m != i and bool(state.d[i, m])

    def apply_comm(self, state: AlgoState, cfg, replicas, i, m, x_half):
        """Fold worker i's communication into the replica list.

        Default (gossip): replicas[i] <- mix(x_half, pre-event replicas[m]).
        Returns True when a transfer actually crossed the network.
        """
        if self.would_communicate(state, i, m):
            w = self.mix_weight(state, cfg, i, m)
            replicas[i] = self.mix(x_half, replicas[m], w)
            return True
        replicas[i] = x_half
        return False

    def apply_failed(self, state: AlgoState, cfg, replicas, i, x_half):
        """A scenario-dead link timed the pull out: the local grad step
        still commits, nothing is mixed, and no peer state is touched."""
        replicas[i] = x_half

    # -- timing semantics ---------------------------------------------------
    def event_timing(
        self, state: AlgoState, cfg, link, i: int, m: int | None,
        communicated: bool, t: float,
    ) -> Timing:
        """Async duration model: overlap of compute and the (optional) pull."""
        raw = link.iteration_time(i, m, now=t) if communicated else None
        net = raw * self.wire_ratio() if communicated else 0.0
        comp = link.compute_time
        if getattr(cfg, "serial_compute", False):
            return Timing(duration=comp + net, comm=net, compute=comp, net=raw)
        return Timing(duration=max(comp, net), comm=max(0.0, net - comp),
                      compute=comp, net=raw)

    def round_timing(self, state: AlgoState, cfg, link, groups, t: float) -> Timing:
        raise NotImplementedError(f"{self.name} is not round-based")

    def wire_ratio(self) -> float:
        """Bytes-on-the-wire ratio vs a dense f32 pull (compression hook)."""
        return 1.0

    # -- round application (sync families) ----------------------------------
    def reduce_groups(self, replicas, groups):
        """Average replicas within each reduction group of >= 2 workers.

        Reference-engine form: per-replica trees, one mean per group, the
        same tree shared by the group's members (nothing updates a replica
        in place).  The batched engine executes the same semantics through
        ``reduce_groups_stacked`` — overriding this method without also
        overriding the stacked form drops the strategy back to the
        reference engine (``supports_batched``)."""
        for grp in groups:
            if len(grp) < 2:
                continue
            mean_p = mean_params([replicas[i] for i in grp])
            for i in grp:
                replicas[i] = mean_p

    def reduce_groups_stacked(self, x, gid):
        """Stacked-tree group averaging: one segment mean per leaf.

        ``x`` leaves are (M, ...) stacked replicas; ``gid`` an (M,) int64
        segment id per worker (workers sharing an id form one reduction
        group; singletons map to themselves and pass through exactly)."""
        from repro_torch.kernels import ops as kops

        M = gid.shape[0]
        return tree_map(lambda l: kops.segment_mean_rows(l, gid, M), x)

    def __repr__(self):
        return f"<Algorithm {self.name} family={self.family}>"


def mean_params(replicas):
    """Leafwise mean of per-replica trees, summed in replica order like the
    JAX package's ``sum(xs) / len(xs)``."""
    return tree_map(lambda *xs: sum(xs) / len(xs), *replicas)


def global_mean_grads(grads, shard=None):
    """Mean over the stacked worker dim, broadcast back to every row.  With a
    ``WorkerShard`` the grads are this rank's rows: their f32 sum is summed
    across the worker ranks and divided by M."""
    if shard is None:
        return tree_map(lambda g: g.mean(dim=0, keepdim=True).expand_as(g).contiguous(),
                        grads)

    def leaf(g):
        total = shard.sum(g.float().sum(dim=0, keepdim=True))
        return (total / shard.M).to(g.dtype).expand_as(g).contiguous()

    return tree_map(leaf, grads)
