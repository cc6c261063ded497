"""Policy-serving front-end: cache + micro-batch over Algorithm 3.

``PolicyServer`` turns ``generate_policy_matrix`` from a per-caller
computation into a served endpoint: many tenants (simulated clusters,
what-if probes, Monitor replicas) request policies concurrently; the
server answers most of them from cache and spends solver time only on
genuinely new link-states.

Three mechanisms (DESIGN.md §17):

* **Quantized-key caching.**  A request's key is (M, connectivity key,
  quantized T, alpha, K, R, eps).  Link-state T is snapped to a relative
  grid before keying *and solving* — two tenants whose EMAs differ by
  less than the quantum share one cache line and one solve, and the
  cache stays coherent (a hit returns exactly what a solve of the same
  key would).  Quantization error is bounded by ``quant`` (default 5%),
  well inside the EMA noise the Monitor already tolerates.
* **Warm-basis reuse + edge-set invalidation.**  Per connectivity key the
  server threads the last optimal basis into the next solve (the
  Monitor's own steady-state trick, core/monitor.py).  The Monitor's
  invalidation rule is mirrored verbatim: when a tenant's edge set
  changes, that tenant's old connectivity key drops its cache lines and
  its warm basis — a shrunken live set must never warm-start or serve a
  stale-layout result.
* **Micro-batching / coalescing.**  ``request_many`` deduplicates
  compatible instances (same key) into one solve; concurrent
  ``request`` calls for the same key coalesce on an in-flight event so
  the solver runs once while every waiter blocks, not once per thread.
  ``sweep="batched"`` routes each miss through the lockstep stacked
  sweep (``generate_policy_matrix_batched``) — useful at small/medium M
  where grid parallelism beats warm restarts.

Latency accounting: every request records wall time; ``stats()`` reports
p50/p99 and the hit rate — the serve benchmark gates the hit rate (a
ratio, hardware-portable) and reports the latencies ungated.

**Degraded-mode serving (DESIGN.md §18).**  A solver failure must never
become a caller-visible exception — a worker that cannot fetch a policy
keeps training on *something*, so the server walks a degradation ladder
on every miss whose solve goes wrong:

1. **Bounded retry with backoff** — up to ``max_retries`` re-attempts,
   exponential backoff charged against the request's ``deadline_ms``
   (backoff and chaos-injected latency are charged *virtually*, not
   slept, so tests are deterministic and fast; wall time still counts).
   A blown deadline stops retrying immediately.
2. **Stale-while-revalidate** — the last good result for the same
   connectivity key (``_last_good``) is served in place of the failed
   solve.  Edge-set invalidation drops it (a stale result for a changed
   layout must never be served), and degraded results are never cached
   and never become ``_last_good`` themselves.
3. **Uniform fallback** — with no stale result to serve, the
   AD-PSGD-style ``uniform_policy`` ships with a safe rho (the
   ``generate_policy_matrix`` infeasible-sweep fallback, core/policy.py)
   and ``T_convergence = inf`` — so ``PolicyResult.ok`` is False, which
   is how callers (and tests) recognize a degraded answer.

A **circuit breaker** guards the solver: ``breaker_threshold``
consecutive failed solves open it, after which misses short-circuit
straight to the ladder's stale/uniform steps without burning a solver
attempt; every ``breaker_probe_every``-th short-circuited miss probes
the solver once (no retries), and a successful probe closes the breaker.
Fault injection for all of this is ``scenarios.chaos.ChaosInjector``
passed as ``chaos=``; every rung is surfaced in ``ServeStats``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.policy import (
    PolicyResult,
    connectivity_key,
    generate_policy_matrix,
    generate_policy_matrix_batched,
    uniform_policy,
)


def normalize_instance(T, d):
    """Mirror generate_policy_matrix's dead-link masking.

    Returns ``(T, d)`` float64 copies describing exactly the instance a
    solve would see: T entries off the live edge set (diagonal, dead
    links, d=0 pairs) are zeroed so irrelevant jitter (or an inf marker)
    cannot fragment the cache, and infinite-T links are dropped from
    ``d``.  Shared by ``PolicyServer`` (cache keying) and ``ShardRouter``
    (routing must hash the same effective edge set the target shard will
    key on).
    """
    T = np.asarray(T, dtype=np.float64).copy()
    M = T.shape[0]
    if d is None:
        d = np.ones((M, M)) - np.eye(M)
    d = np.asarray(d, dtype=np.float64).copy()
    dead = ~np.isfinite(T)
    d[dead] = 0.0
    d[dead.T] = 0.0
    np.fill_diagonal(d, 0.0)
    T[d == 0.0] = 0.0
    return T, d


@dataclass
class ServeStats:
    """Counters + latency reservoir for one PolicyServer.

    Thread-safe on its own lock: counters are mutated via ``bump`` and
    latencies via ``note_latency`` from any thread, with or without the
    server's cache lock held — the final latency append of a request
    deliberately happens *after* the server releases its lock, so the
    stats object must not rely on it.
    """

    n_requests: int = 0
    n_hits: int = 0
    n_coalesced: int = 0
    n_solves: int = 0
    n_invalidations: int = 0
    n_evictions: int = 0
    # Degraded-mode ladder (module docstring): every rung is counted.
    n_solve_errors: int = 0
    n_retries: int = 0
    n_deadline_misses: int = 0
    n_stale_served: int = 0
    n_uniform_fallbacks: int = 0
    n_breaker_trips: int = 0
    n_breaker_probes: int = 0
    n_breaker_recoveries: int = 0
    latencies_ms: list = field(default_factory=list)
    _lock: threading.Lock = field(
        init=False, repr=False, compare=False, default_factory=threading.Lock
    )

    def bump(self, name: str, k: int = 1) -> None:
        """Atomically add ``k`` to counter ``name``."""
        with self._lock:
            setattr(self, name, getattr(self, name) + k)

    def note_latency(self, ms: float) -> None:
        """Record one request latency sample in milliseconds."""
        with self._lock:
            self.latencies_ms.append(ms)

    @property
    def hit_rate(self) -> float:
        """Fraction of requests served without running a solver."""
        served = self.n_hits + self.n_coalesced
        return served / self.n_requests if self.n_requests else 0.0

    @property
    def n_degraded(self) -> int:
        """Requests answered from the ladder instead of a fresh solve."""
        return self.n_stale_served + self.n_uniform_fallbacks

    def latency_ms(self, q: float) -> float:
        """Latency percentile ``q`` (0-100) in ms over recorded samples."""
        with self._lock:
            lat = np.asarray(self.latencies_ms)
        if lat.size == 0:
            return 0.0
        return float(np.percentile(lat, q))

    def snapshot(self) -> dict:
        """Export all counters plus derived rates as a plain dict."""
        return {
            "n_requests": self.n_requests,
            "n_hits": self.n_hits,
            "n_coalesced": self.n_coalesced,
            "n_solves": self.n_solves,
            "n_invalidations": self.n_invalidations,
            "n_evictions": self.n_evictions,
            "n_solve_errors": self.n_solve_errors,
            "n_retries": self.n_retries,
            "n_deadline_misses": self.n_deadline_misses,
            "n_stale_served": self.n_stale_served,
            "n_uniform_fallbacks": self.n_uniform_fallbacks,
            "n_breaker_trips": self.n_breaker_trips,
            "n_breaker_probes": self.n_breaker_probes,
            "n_breaker_recoveries": self.n_breaker_recoveries,
            "hit_rate": self.hit_rate,
            "p50_ms": self.latency_ms(50),
            "p99_ms": self.latency_ms(99),
        }


class PolicyServer:
    """Concurrent, caching policy endpoint over Algorithm 3.

    Thread-safe: cache/bookkeeping mutations hold one lock; solves run
    outside it (concurrent distinct keys solve in parallel, concurrent
    identical keys coalesce).  ``alpha``/``K``/``R``/``eps`` fix the
    Algorithm-3 configuration for every request this server answers.
    """

    def __init__(
        self,
        alpha: float,
        K: int = 5,
        R: int = 6,
        eps: float = 1e-2,
        quant: float = 0.05,
        cache_size: int = 256,
        sweep: str = "serial",
        deadline_ms: float | None = None,
        max_retries: int = 2,
        backoff_ms: float = 1.0,
        breaker_threshold: int = 3,
        breaker_probe_every: int = 8,
        chaos=None,
    ):
        """Validate and pin the Algorithm-3 + degradation-ladder configuration."""
        if sweep not in ("serial", "batched"):
            raise ValueError(f"unknown sweep mode {sweep!r}")
        if deadline_ms is not None and not deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if max_retries < 0 or backoff_ms < 0:
            raise ValueError("max_retries and backoff_ms must be >= 0")
        if breaker_threshold < 1 or breaker_probe_every < 1:
            raise ValueError(
                "breaker_threshold and breaker_probe_every must be >= 1"
            )
        self.alpha = float(alpha)
        self.K = int(K)
        self.R = int(R)
        self.eps = float(eps)
        self.quant = float(quant)
        self.cache_size = int(cache_size)
        self.sweep = sweep
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.max_retries = int(max_retries)
        self.backoff_ms = float(backoff_ms)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_probe_every = int(breaker_probe_every)
        self.chaos = chaos  # scenarios.chaos.ChaosInjector (solver channels)
        self.stats = ServeStats()
        self._lock = threading.Lock()
        self._cache: OrderedDict = OrderedDict()  # key -> PolicyResult
        self._warm: dict = {}          # conn_key -> BasisState
        self._tenant_conn: dict = {}   # tenant -> conn_key (edge-set rule)
        self._inflight: dict = {}      # key -> threading.Event
        self._last_good: dict = {}     # conn_key -> last fresh PolicyResult
        self._inval_epoch: dict = {}   # conn_key -> invalidation counter
        self._consec_failures = 0
        self._breaker_open = False
        self._probe_tick = 0

    @property
    def breaker_open(self) -> bool:
        """Whether the circuit breaker is currently tripped open."""
        with self._lock:
            return self._breaker_open

    # -- request path -------------------------------------------------------
    def _normalize(self, T, d):
        """Delegate to module-level ``normalize_instance``.

        Shared with the shard router, which must hash the same effective
        edge set.
        """
        return normalize_instance(T, d)

    def _quantize(self, T):
        """Snap finite link times to a relative grid of step ``quant``.

        The quantum is ``quant`` times the matrix's magnitude bucketed to
        a power of two — bucketing keeps the quantum itself stable under
        small EMA jitter (a raw ``max(T)``-proportional quantum would
        shift with every perturbation and defeat the cache).  quant=0
        disables snapping (every distinct T is its own key).
        """
        if self.quant <= 0.0:
            return T
        finite = np.isfinite(T)
        scale = float(T[finite].max()) if finite.any() else 1.0
        if scale <= 0.0:
            return T
        q = self.quant * float(2.0 ** np.ceil(np.log2(scale)))
        return np.where(finite, np.round(T / q) * q, T)

    def _key(self, Tq, d, ck) -> tuple:
        return (
            Tq.shape[0], ck, Tq.tobytes(),
            self.alpha, self.K, self.R, self.eps,
        )

    def _note_tenant(self, tenant, ck):
        """Apply the Monitor's edge-set rule for ``tenant``.

        A tenant whose edge set changed invalidates its previous
        connectivity key's cache lines and warm basis.
        """
        if tenant is None:
            return
        prev = self._tenant_conn.get(tenant)
        if prev is not None and prev != ck:
            self._invalidate_locked(prev)
        self._tenant_conn[tenant] = ck

    def _invalidate_locked(self, ck) -> None:
        self._warm.pop(ck, None)
        # Stale-while-revalidate must respect the same rule: a last-good
        # result for a changed edge set has the wrong layout — drop it
        # (the ladder then falls through to the uniform policy).
        self._last_good.pop(ck, None)
        # Epoch bump: a solve that started before this invalidation must
        # not insert its (stale-layout) result when it finishes.
        self._inval_epoch[ck] = self._inval_epoch.get(ck, 0) + 1
        stale = [k for k in self._cache if k[1] == ck]
        for k in stale:
            del self._cache[k]
        self.stats.bump("n_invalidations")

    def invalidate(self, d) -> None:
        """Explicitly drop cache + warm basis for connectivity ``d``."""
        with self._lock:
            self._invalidate_locked(connectivity_key(np.asarray(d)))

    def _solve(self, Tq, d, ck) -> PolicyResult:
        if self.sweep == "batched":
            return generate_policy_matrix_batched(
                self.alpha, self.K, self.R, Tq, d=d, eps=self.eps
            )
        with self._lock:
            warm = self._warm.get(ck)
        res = generate_policy_matrix(
            self.alpha, self.K, self.R, Tq, d=d, eps=self.eps, warm=warm
        )
        return res

    # -- degradation ladder (module docstring) -------------------------------
    def _solve_guarded(self, Tq, d, ck, t0: float, max_retries: int):
        """Bounded-retry solve under the deadline.

        Returns the fresh ``PolicyResult`` or None when the retry budget
        or the deadline is exhausted.  Backoff and chaos-injected latency
        are charged *virtually* against the deadline (never slept), so
        the ladder is deterministic under test; real wall time counts too.
        """
        charged_ms = 0.0

        def over_deadline() -> bool:
            """Whether wall time plus virtually-charged ms exceeds the deadline."""
            if self.deadline_ms is None:
                return False
            spent = (time.perf_counter() - t0) * 1e3 + charged_ms
            return spent > self.deadline_ms

        for attempt in range(max_retries + 1):
            if self.chaos is not None:
                charged_ms += self.chaos.injected_delay_ms()
            try:
                if self.chaos is not None:
                    self.chaos.maybe_fail_solver()
                res = self._solve(Tq, d, ck)
            except Exception:
                self.stats.bump("n_solve_errors")
                res = None
            if res is not None:
                # A late success is still served (the fresh result is in
                # hand; stale would be strictly worse) — but the miss is
                # counted: the deadline's job is bounding the retry tail.
                if over_deadline():
                    self.stats.bump("n_deadline_misses")
                return res
            if over_deadline():
                self.stats.bump("n_deadline_misses")
                return None
            if attempt < max_retries:
                self.stats.bump("n_retries")
                charged_ms += self.backoff_ms * (2.0 ** attempt)
        return None

    def _degraded(self, d, ck):
        """Walk stale-while-revalidate, then the uniform fallback.

        Degraded results are never cached and never raise — the caller
        always gets a usable policy.  Returns ``(result, rung)`` with
        rung ``"stale"`` or ``"uniform"``.
        """
        with self._lock:
            stale = self._last_good.get(ck)
        if stale is not None:
            self.stats.bump("n_stale_served")
            return stale, "stale"
        self.stats.bump("n_uniform_fallbacks")
        P = uniform_policy(d)
        rho = 0.25 / self.alpha / max(1.0, d.sum(axis=1).max())
        # T_convergence=inf => PolicyResult.ok is False: the degraded
        # marker callers and tests key off.
        return PolicyResult(P, rho, 0.0, 1.0, float("inf")), "uniform"

    def _breaker_gate(self) -> str:
        """Decide how the breaker treats this request.

        'closed' = solve normally, 'probe' = one no-retry attempt,
        'short' = short-circuit straight to the degraded ladder.
        """
        with self._lock:
            if not self._breaker_open:
                return "closed"
            self._probe_tick += 1
            if self._probe_tick >= self.breaker_probe_every:
                self._probe_tick = 0
                probe = True
            else:
                probe = False
        if probe:
            self.stats.bump("n_breaker_probes")
            return "probe"
        return "short"

    def _note_solve_outcome(self, success: bool) -> None:
        tripped = recovered = False
        with self._lock:
            if success:
                self._consec_failures = 0
                if self._breaker_open:
                    self._breaker_open = False
                    recovered = True
            else:
                self._consec_failures += 1
                if (not self._breaker_open
                        and self._consec_failures >= self.breaker_threshold):
                    self._breaker_open = True
                    self._probe_tick = 0
                    tripped = True
        if tripped:
            self.stats.bump("n_breaker_trips")
        if recovered:
            self.stats.bump("n_breaker_recoveries")

    def _serve_miss(self, Tq, d, ck, t0, cache_key=None, epoch=None):
        """Serve one cache miss: breaker -> guarded solve -> ladder.

        ``cache_key``/``epoch`` are set only for the in-flight owner: the
        fresh result is inserted unless the key's invalidation epoch moved
        while the solve ran (a concurrent ``invalidate`` must win — its
        caller's edge set changed, so the just-solved layout is stale).
        Coalesced waiters falling through a degraded owner pass None and
        never populate the cache.  Degraded results are never cached.
        Returns ``(result, rung)`` with rung ``"fresh"``, ``"stale"`` or
        ``"uniform"``.
        """
        gate = self._breaker_gate()
        if gate == "short":
            return self._degraded(d, ck)
        retries = 0 if gate == "probe" else self.max_retries
        res = self._solve_guarded(Tq, d, ck, t0, retries)
        self._note_solve_outcome(res is not None)
        if res is None:
            return self._degraded(d, ck)
        self.stats.bump("n_solves")
        with self._lock:
            fresh = self._inval_epoch.get(ck, 0) == epoch
            if cache_key is not None and fresh:
                if res.basis is not None:
                    self._warm[ck] = res.basis
                self._last_good[ck] = res
                self._cache[cache_key] = res
                self._cache.move_to_end(cache_key)
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
                    self.stats.bump("n_evictions")
        return res, "fresh"

    def request(self, T, d=None, tenant=None) -> PolicyResult:
        """Serve one policy request (blocking; thread-safe; total).

        ``tenant`` (optional, hashable) enables the edge-set-change
        invalidation rule; anonymous requests only read/populate the
        cache.  *Total*: solver failures (real or chaos-injected) never
        escape — the degradation ladder answers instead (module
        docstring), and ``ServeStats`` records which rung did.
        """
        return self.request_meta(T, d=d, tenant=tenant)[0]

    def request_meta(self, T, d=None, tenant=None):
        """Serve one request and report how it was answered.

        Returns ``(result, meta)`` where ``meta`` is a dict with ``rung``
        — one of ``"hit"``, ``"coalesced"``, ``"fresh"``, ``"stale"``,
        ``"uniform"`` — and ``ms`` (wall latency).  Rungs hit/coalesced/
        fresh are bit-equal to a direct solve of the same (quantized)
        instance; stale/uniform are degraded answers.  The RPC front-end
        (``repro_torch.serve.rpc``) forwards ``meta`` to clients that ask.
        """
        t0 = time.perf_counter()
        T, d = self._normalize(T, d)
        Tq = self._quantize(T)
        ck = connectivity_key(d)
        key = self._key(Tq, d, ck)
        wait_ev = None
        with self._lock:
            self.stats.bump("n_requests")
            self._note_tenant(tenant, ck)
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self.stats.bump("n_hits")
                ms = (time.perf_counter() - t0) * 1e3
                self.stats.note_latency(ms)
                return hit, {"rung": "hit", "ms": ms}
            wait_ev = self._inflight.get(key)
            if wait_ev is None:
                self._inflight[key] = threading.Event()
                epoch = self._inval_epoch.get(ck, 0)
        if wait_ev is not None:
            # Another thread is already solving this exact key: coalesce.
            wait_ev.wait()
            self.stats.bump("n_coalesced")
            with self._lock:
                res = self._cache.get(key)
            rung = "coalesced"
            if res is None:
                # The owner degraded (or an invalidation raced its insert):
                # walk the guarded ladder ourselves — never the raw solver.
                res, rung = self._serve_miss(Tq, d, ck, time.perf_counter())
            ms = (time.perf_counter() - t0) * 1e3
            self.stats.note_latency(ms)
            return res, {"rung": rung, "ms": ms}
        try:
            res, rung = self._serve_miss(
                Tq, d, ck, t0, cache_key=key, epoch=epoch
            )
        finally:
            with self._lock:
                ev = self._inflight.pop(key, None)
            if ev is not None:
                ev.set()
        ms = (time.perf_counter() - t0) * 1e3
        self.stats.note_latency(ms)
        return res, {"rung": rung, "ms": ms}

    def request_many(self, requests) -> list[PolicyResult]:
        """Micro-batch a list of (T, d) or (T, d, tenant) requests.

        Compatible instances — identical (M, connectivity, quantized T,
        config) — collapse into one solve; the duplicates are counted as
        coalesced.  Returns results in request order.
        """
        prepared = []
        for req in requests:
            T, d = req[0], req[1]
            tenant = req[2] if len(req) > 2 else None
            T, d = self._normalize(T, d)
            Tq = self._quantize(T)
            ck = connectivity_key(d)
            prepared.append((self._key(Tq, d, ck), Tq, d, ck, tenant))
        first_of: dict = {}
        out: list = [None] * len(prepared)
        for i, (key, Tq, d, ck, tenant) in enumerate(prepared):
            if key in first_of:
                self.stats.bump("n_requests")
                self.stats.bump("n_coalesced")
                with self._lock:
                    self._note_tenant(tenant, ck)
                out[i] = first_of[key]
                continue
            res = self.request(Tq, d, tenant=tenant)
            first_of[key] = res
            out[i] = res
        return out

    def cache_len(self) -> int:
        """Number of policy results currently cached."""
        with self._lock:
            return len(self._cache)
