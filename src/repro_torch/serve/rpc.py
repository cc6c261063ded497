"""Cross-process policy serving: JSON-over-socket RPC (repro.serve/v1).

The wire protocol is deliberately minimal — the same shape as the trace
schema (``repro.trace/v1``): every frame is a 4-byte big-endian unsigned
length followed by that many bytes of UTF-8 JSON.  Requests carry
``{"schema": "repro.serve/v1", "op": ..., "id": ...}`` plus op-specific
fields; responses echo ``id`` and set envelope-``ok`` (RPC success —
distinct from ``PolicyResult.ok``, which marks a non-degraded policy and
rides inside ``result``).  Ops:

* ``policy`` — ``T`` (nested lists), optional ``d``/``tenant``/
  ``want_meta``, optional ``priority``/``deadline_ms`` (honored when the
  service fronts an ``AdmissionController``).  Response ``result`` holds
  P/rho/t_bar/lambda2/T_convergence; ``meta`` (when asked) holds the
  serving rung.  Python's ``json`` writes floats by ``repr`` and accepts
  ``Infinity``, so policies round-trip bit-exactly — the E2E test pins
  RPC answers bit-equal to in-process answers.
* ``invalidate`` — edge-set ``d``; fans out through the backend (all
  shards when the backend is a ``ShardRouter``).
* ``stats`` — backend stats snapshot (plus admission counters when
  present).
* ``ping`` — liveness probe.

``PolicyService`` is a threaded server (one accept loop, one handler
thread per connection) over any backend with the ``PolicyServer``
request surface: a bare ``PolicyServer``, a ``ShardRouter``, or an
``AdmissionController`` wrapping either.  Faulty clients cannot hurt it:
malformed JSON, a bogus schema tag, an oversized length prefix, or a
mid-request disconnect are answered (where possible) with an error frame
and cost only that one connection.

``PolicyClient`` is the retrying counterpart: on connection loss it
reconnects with bounded backoff and re-sends the request.  Retrying a
``policy`` op is safe — serving is read-only-plus-cache, so a duplicate
solve is wasted work, never wrong state; ``invalidate`` is idempotent.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np

from repro_torch.core.policy import PolicyResult

SCHEMA = "repro.serve/v1"
MAX_FRAME = 64 * 1024 * 1024  # 64 MiB: an M=1024 policy is ~20 MB of JSON
_LEN = struct.Struct(">I")


class RpcError(RuntimeError):
    """Server-reported failure for one RPC (connection stays usable)."""


class FrameError(RuntimeError):
    """Unrecoverable wire corruption (oversized/short frame): close."""


def _send_frame(sock: socket.socket, obj: dict) -> None:
    """Serialize ``obj`` and write one length-prefixed frame."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME:
        raise FrameError(f"frame of {len(payload)} bytes exceeds {MAX_FRAME}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` on EOF."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> dict:
    """Read one frame; raise ``FrameError`` on oversized/garbled input."""
    (length,) = _LEN.unpack(_recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise FrameError(f"declared frame of {length} bytes exceeds cap")
    payload = _recv_exact(sock, length)
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"malformed frame: {e}") from None
    if not isinstance(obj, dict):
        raise FrameError("frame payload must be a JSON object")
    return obj


def _result_to_wire(res: PolicyResult) -> dict:
    """Encode a ``PolicyResult`` (floats round-trip exactly via repr)."""
    return {
        "P": np.asarray(res.P).tolist(),
        "rho": float(res.rho),
        "t_bar": float(res.t_bar),
        "lambda2": float(res.lambda2),
        "T_convergence": float(res.T_convergence),
    }


def _result_from_wire(doc: dict) -> PolicyResult:
    """Decode the ``policy`` response body back into a ``PolicyResult``."""
    return PolicyResult(
        np.asarray(doc["P"], dtype=np.float64),
        float(doc["rho"]),
        float(doc["t_bar"]),
        float(doc["lambda2"]),
        float(doc["T_convergence"]),
    )


class PolicyService:
    """Threaded RPC front-end over a policy-serving backend.

    ``backend`` needs the ``PolicyServer`` request surface; when it is an
    ``AdmissionController`` (detected by its ``submit`` method), per-
    request ``priority``/``deadline_ms`` are forwarded into admission.
    ``start()`` binds and returns (serving happens on daemon threads);
    ``stop()`` closes the listener and all live connections.  Use
    ``address`` to reach it (port 0 picks a free port).
    """

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0):
        """Record the backend and bind address (nothing starts yet)."""
        self.backend = backend
        self._host, self._port = host, int(port)
        self._listener: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._stopping = False
        self.n_bad_frames = 0
        self.n_disconnects = 0

    @property
    def address(self) -> tuple[str, int]:
        """(host, port) actually bound (valid after ``start``)."""
        if self._listener is None:
            raise RuntimeError("service not started")
        return self._listener.getsockname()[:2]

    def start(self) -> "PolicyService":
        """Bind, listen and spawn the accept loop; returns self."""
        srv = socket.create_server(
            (self._host, self._port), reuse_port=False
        )
        srv.listen(64)
        self._listener = srv
        self._stopping = False
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        return self

    def stop(self) -> None:
        """Close the listener and every live connection.

        The listener is ``shutdown()`` before ``close()``: a thread
        blocked inside ``accept(2)`` holds the kernel file description
        open past ``close()``, so without the shutdown the dead service
        could accept (and answer!) one more connection — and pin the
        port against a restart.
        """
        self._stopping = True
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self):
        """Context-manager entry: start serving."""
        return self.start()

    def __exit__(self, *exc):
        """Context-manager exit: stop serving."""
        self.stop()

    # -- server internals ----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            if self._stopping:  # raced stop(): never serve from a dead
                try:            # service
                    conn.close()
                except OSError:
                    pass
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                try:
                    req = _recv_frame(conn)
                except FrameError as e:
                    # Framing is corrupt; answer if the socket still
                    # writes, then drop the connection (only safe move:
                    # the byte stream can no longer be trusted).
                    self.n_bad_frames += 1
                    try:
                        _send_frame(conn, {
                            "schema": SCHEMA, "id": None,
                            "ok": False, "error": str(e),
                        })
                    except OSError:
                        pass
                    return
                resp = self._handle(req)
                _send_frame(conn, resp)
        except (ConnectionError, OSError):
            self.n_disconnects += 1  # client went away: their problem
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, req: dict) -> dict:
        rid = req.get("id")
        head = {"schema": SCHEMA, "id": rid}
        if req.get("schema") != SCHEMA:
            return {**head, "ok": False,
                    "error": f"unknown schema {req.get('schema')!r}"}
        op = req.get("op")
        try:
            if op == "ping":
                return {**head, "ok": True}
            if op == "policy":
                return {**head, "ok": True, **self._op_policy(req)}
            if op == "invalidate":
                self.backend.invalidate(np.asarray(req["d"], dtype=float))
                return {**head, "ok": True}
            if op == "stats":
                return {**head, "ok": True, "stats": self._op_stats()}
            return {**head, "ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:  # total: one bad request != dead server
            return {**head, "ok": False, "error": f"{type(e).__name__}: {e}"}

    def _op_policy(self, req: dict) -> dict:
        T = np.asarray(req["T"], dtype=np.float64)
        d = req.get("d")
        if d is not None:
            d = np.asarray(d, dtype=np.float64)
        tenant = req.get("tenant")
        if hasattr(self.backend, "submit"):  # AdmissionController
            res, meta = self.backend.submit(
                T, d=d, tenant=tenant,
                priority=req.get("priority"),
                deadline_ms=req.get("deadline_ms"),
            )
        else:
            res, meta = self.backend.request_meta(T, d=d, tenant=tenant)
        out = {"result": _result_to_wire(res)}
        if req.get("want_meta"):
            out["meta"] = meta
        return out

    def _op_stats(self) -> dict:
        backend = self.backend
        out: dict = {}
        if hasattr(backend, "submit"):  # AdmissionController in front
            out["admission"] = backend.stats.snapshot()
            backend = backend.backend
        if hasattr(backend, "servers"):  # ShardRouter
            out["serving"] = backend.stats()
        else:
            out["serving"] = backend.stats.snapshot()
        return out


class PolicyClient:
    """Reconnecting RPC client for ``PolicyService``.

    One client holds one connection and is locked per call (share across
    threads freely, or build one per thread for parallelism — they are
    cheap).  On connection failure each op is retried up to ``retries``
    times with exponential backoff, reconnecting first; server-reported
    errors raise ``RpcError`` without a retry (the request itself is
    bad, or the server chose to refuse it — resending cannot help).
    """

    def __init__(
        self,
        address: tuple,
        retries: int = 3,
        backoff_s: float = 0.05,
        timeout_s: float = 60.0,
    ):
        """Record the target address; the first op connects lazily."""
        if retries < 0 or backoff_s < 0:
            raise ValueError("retries and backoff_s must be >= 0")
        self.address = (address[0], int(address[1]))
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.timeout_s = float(timeout_s)
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._id = 0
        self.n_reconnects = 0

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address, timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _call(self, body: dict) -> dict:
        with self._lock:
            self._id += 1
            body = {"schema": SCHEMA, "id": self._id, **body}
            last_err: Exception | None = None
            for attempt in range(self.retries + 1):
                sent = False
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                        if attempt:
                            self.n_reconnects += 1
                    _send_frame(self._sock, body)
                    sent = True
                    resp = _recv_frame(self._sock)
                    break
                except (ConnectionError, OSError, FrameError) as e:
                    if isinstance(e, FrameError) and not sent:
                        raise  # oversized request — resending cannot help
                    last_err = e
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    if attempt < self.retries:
                        time.sleep(self.backoff_s * (2.0 ** attempt))
            else:
                raise ConnectionError(
                    f"rpc to {self.address} failed after "
                    f"{self.retries + 1} attempts: {last_err}"
                )
        if not resp.get("ok"):
            raise RpcError(resp.get("error", "unknown server error"))
        return resp

    # -- ops -----------------------------------------------------------------
    def request(self, T, d=None, tenant=None, want_meta=False,
                priority=None, deadline_ms=None):
        """Fetch a policy; returns ``PolicyResult`` (or with meta dict).

        ``priority``/``deadline_ms`` only take effect when the service
        fronts an ``AdmissionController``; other backends ignore them.
        With ``want_meta=True`` returns ``(result, meta)`` where ``meta``
        carries the serving rung (and shard/queueing info when present).
        """
        body: dict = {"op": "policy", "T": np.asarray(T).tolist()}
        if d is not None:
            body["d"] = np.asarray(d).tolist()
        if tenant is not None:
            body["tenant"] = tenant
        if want_meta:
            body["want_meta"] = True
        if priority is not None:
            body["priority"] = priority
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        resp = self._call(body)
        res = _result_from_wire(resp["result"])
        if want_meta:
            return res, resp.get("meta", {})
        return res

    def invalidate(self, d) -> None:
        """Drop cache/warm state for edge set ``d`` on every shard."""
        self._call({"op": "invalidate", "d": np.asarray(d).tolist()})

    def stats(self) -> dict:
        """Fetch the service's aggregated stats snapshot."""
        return self._call({"op": "stats"})["stats"]

    def ping(self) -> bool:
        """Round-trip a liveness probe (True, or raises)."""
        self._call({"op": "ping"})
        return True

    def close(self) -> None:
        """Close the underlying connection (next op reconnects)."""
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def __enter__(self):
        """Context-manager entry."""
        return self

    def __exit__(self, *exc):
        """Context-manager exit: close the connection."""
        self.close()
