"""Connectivity-keyed sharding across ``PolicyServer`` workers.

``ShardRouter`` spreads policy traffic over N independent
``PolicyServer`` instances so that all requests for one effective edge
set land on the same worker.  That placement is the whole point: warm
bases, ``_last_good`` stale entries and cache lines are keyed by
``connectivity_key`` and live inside a single server — routing by
anything else (round-robin, tenant hash) would scatter one cluster's
refreshes across workers and turn every warm hit cold.

Routing is a stable content hash: ``blake2b`` over the normalized edge
set's ``connectivity_key`` bytes, reduced mod N.  Stability matters in
two ways the tests pin down:

* **cross-process** — Python's builtin ``hash()`` is salted per process
  (PYTHONHASHSEED), so a client-side router and a server-side router
  would disagree; blake2b gives the same shard on any process, any
  platform.
* **T-independent** — the key hashes only the edge set, not the link
  times, so EMA jitter never migrates a cluster between shards (which
  would abandon its warm basis).

Invalidation fans out to *all* shards: the router cannot assume the
caller's previous edge set hashed to the same worker as its current one
(the edge set is exactly what changed), so correctness requires the
broadcast.  Per-tenant edge-set invalidation inside each server still works
for the common case where a tenant's old and new keys co-locate; the
explicit ``invalidate`` broadcast covers the rest.

``stats()`` aggregates counters across shards and keeps the per-shard
snapshots for operators (docs/serving.md).
"""

from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core.policy import PolicyResult, connectivity_key
from repro_torch.serve.policy import PolicyServer, normalize_instance


def shard_index(ck: bytes, n_shards: int) -> int:
    """Map a ``connectivity_key`` to a shard by stable content hash.

    ``blake2b`` (8-byte digest) mod ``n_shards`` — deterministic across
    processes and platforms, unlike the salted builtin ``hash()``.
    """
    h = hashlib.blake2b(ck, digest_size=8).digest()
    return int.from_bytes(h, "big") % n_shards


class ShardRouter:
    """Route policy requests across N ``PolicyServer`` shards.

    Implements the same request surface as ``PolicyServer`` (``request``,
    ``request_meta``, ``request_many``, ``invalidate``, ``stats``) so the
    RPC front-end and the admission controller can sit in front of either
    a single server or a sharded pool without caring which.
    """

    def __init__(self, servers):
        """Wrap an ordered, non-empty list of ``PolicyServer`` workers."""
        servers = list(servers)
        if not servers:
            raise ValueError("ShardRouter needs at least one PolicyServer")
        for s in servers:
            if not isinstance(s, PolicyServer):
                raise TypeError(f"not a PolicyServer: {s!r}")
        self.servers = servers

    @classmethod
    def build(cls, n_shards: int, *args, **kwargs) -> "ShardRouter":
        """Build a router over ``n_shards`` identically-configured workers.

        Positional/keyword arguments are forwarded verbatim to each
        ``PolicyServer``.
        """
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        return cls([PolicyServer(*args, **kwargs) for _ in range(n_shards)])

    @property
    def n_shards(self) -> int:
        """Number of workers behind this router."""
        return len(self.servers)

    def shard_of(self, T, d=None) -> int:
        """Shard index a request for ``(T, d)`` routes to.

        Normalizes exactly like the target server's cache keying, so the
        routed-to worker and the hashed edge set always agree.
        """
        _, dn = normalize_instance(T, d)
        return shard_index(connectivity_key(dn), len(self.servers))

    # -- request surface (mirrors PolicyServer) ------------------------------
    def request(self, T, d=None, tenant=None) -> PolicyResult:
        """Serve one request on the owning shard (blocking, total)."""
        return self.servers[self.shard_of(T, d)].request(T, d=d, tenant=tenant)

    def request_meta(self, T, d=None, tenant=None):
        """Serve one request and return ``(result, meta)``.

        The owning shard's index is added to the server's meta dict under
        ``"shard"``.
        """
        i = self.shard_of(T, d)
        res, meta = self.servers[i].request_meta(T, d=d, tenant=tenant)
        meta["shard"] = i
        return res, meta

    def request_many(self, requests) -> list[PolicyResult]:
        """Micro-batch requests, grouped per owning shard.

        Each group goes through that shard's ``request_many`` (keeping
        its same-key coalescing); results return in request order.
        """
        groups: dict[int, list[int]] = {}
        for pos, req in enumerate(requests):
            T, d = req[0], req[1]
            groups.setdefault(self.shard_of(T, d), []).append(pos)
        out: list = [None] * len(requests)
        for i, positions in groups.items():
            sub = [requests[p] for p in positions]
            for p, res in zip(positions, self.servers[i].request_many(sub)):
                out[p] = res
        return out

    def invalidate(self, d) -> None:
        """Fan an edge-set invalidation out to every shard.

        The caller's previous edge set need not hash to the same worker
        as its current one, so only a broadcast keeps every shard's warm
        basis / stale entry / cache lines coherent.
        """
        for s in self.servers:
            s.invalidate(d)

    def cache_len(self) -> int:
        """Total cached policies across shards."""
        return sum(s.cache_len() for s in self.servers)

    def stats(self) -> dict:
        """Aggregate counters across shards (plus per-shard snapshots)."""
        shards = [s.stats.snapshot() for s in self.servers]
        agg: dict = {"n_shards": len(shards), "per_shard": shards}
        for k, v in shards[0].items():
            if k.startswith("n_"):
                agg[k] = sum(snap[k] for snap in shards)
        n_req = agg.get("n_requests", 0)
        served = agg.get("n_hits", 0) + agg.get("n_coalesced", 0)
        agg["hit_rate"] = served / n_req if n_req else 0.0
        lat = np.concatenate(
            [np.asarray(s.stats.latencies_ms, dtype=float)
             for s in self.servers]
        ) if any(s.stats.latencies_ms for s in self.servers) else np.array([])
        agg["p50_ms"] = float(np.percentile(lat, 50)) if lat.size else 0.0
        agg["p99_ms"] = float(np.percentile(lat, 99)) if lat.size else 0.0
        return agg
