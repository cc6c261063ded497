"""Serving runtimes of the port.

* ``repro_torch.serve.engine`` -- KV-cache LM engine with batched prefill
  (the flash-attention kernel) and token-by-token decode (import the
  submodule directly).
* ``repro_torch.serve.policy`` -- ``PolicyServer``, the caching/micro-batching
  front-end over Algorithm 3 policy generation, with the degraded-mode
  ladder (deadline, retry, stale answer, circuit breaker, uniform fallback).
* ``repro_torch.serve.shard`` -- ``ShardRouter``, connectivity-keyed routing
  across N ``PolicyServer`` workers.
* ``repro_torch.serve.admission`` -- ``AdmissionController``, bounded-queue
  EDF admission with deadline-aware shedding.
* ``repro_torch.serve.rpc`` -- ``PolicyService``/``PolicyClient``, the
  length-prefixed JSON-over-socket front-end (schema ``repro.serve/v1``,
  the JAX package's wire format: a client of either package talks to a
  service of the other).

Everything except ``engine`` is numpy-only and re-exported here.
"""

from repro_torch.serve.admission import AdmissionController, AdmissionStats
from repro_torch.serve.policy import PolicyServer, ServeStats
from repro_torch.serve.rpc import PolicyClient, PolicyService, RpcError
from repro_torch.serve.shard import ShardRouter

__all__ = [
    "AdmissionController",
    "AdmissionStats",
    "PolicyClient",
    "PolicyServer",
    "PolicyService",
    "RpcError",
    "ServeStats",
    "ShardRouter",
]
