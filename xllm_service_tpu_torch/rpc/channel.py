"""Synchronous control-plane channel to one engine instance (port of
``xllm_service_tpu/rpc/channel.py`` on ``http.client``).

The engine speaks HTTP; the channel keeps a bounded pool of kept-alive
HTTP/1.1 connections per destination (TCP keepalive and no Nagle on each
socket, as the reference's session adapter sets them) and retries with
jittered exponential backoff (``rpc_retries``/``rpc_timeout_s``/
``rpc_backoff_*``). Non-idempotent generation forwards are never retried
here: an ambiguous failure may have started generation, so replay belongs
to the scheduler's failover layer, which rebinds incarnations so a
duplicate stream is dropped. Every attempt first consults the fault plane
(``common/faults.py``, points ``rpc.post``/``rpc.get``).
"""

from __future__ import annotations

import http.client
import json
import select
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Optional
from urllib.parse import urlsplit

from ..common import tracing
from ..common.faults import FAULTS, FaultInjected
from ..common.metrics import RPC_RETRIES_TOTAL
from ..common.types import InstanceMetaInfo
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..utils import get_logger, jittered_backoff
from . import wire
from .breaker import CircuitBreaker

logger = get_logger(__name__)

DEFAULT_TIMEOUT_S = 5.0
DEFAULT_RETRIES = 3
DEFAULT_BACKOFF_BASE_S = 0.05
DEFAULT_BACKOFF_MAX_S = 1.0


def _breaker_ok(status_code: int) -> bool:
    """Is an HTTP answer health evidence for the circuit breaker?

    Any 2xx/3xx/4xx answer is (the instance's serving loop is alive), and
    so are the deliberate overload and lifecycle rejections: 429 (shed),
    503 (draining / accept queue full), 504 (deadline refused). Counting
    those as sickness would eject a busy instance during the burst the
    overload plane exists to absorb. Only unexplained server errors join
    transport failures as breaker evidence."""
    return status_code < 500 or status_code in (503, 504)


class ChannelError(OSError):
    """A transport failure of a channel call (connect, send or read)."""


_SOCKET_OPTIONS = [(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1),
                   (socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)]
if hasattr(socket, "TCP_KEEPIDLE"):
    _SOCKET_OPTIONS += [
        (socket.IPPROTO_TCP, socket.TCP_KEEPIDLE, 30),
        (socket.IPPROTO_TCP, socket.TCP_KEEPINTVL, 10),
        (socket.IPPROTO_TCP, socket.TCP_KEEPCNT, 3),
    ]


class _Connection(http.client.HTTPConnection):
    def connect(self) -> None:
        super().connect()
        for opt in _SOCKET_OPTIONS:
            self.sock.setsockopt(*opt)


def _dropped(conn: http.client.HTTPConnection) -> bool:
    """Did the peer close an idle pooled connection (readable at rest means
    EOF or an unsolicited byte: either way unusable)?"""
    sock = conn.sock
    if sock is None:
        return True
    try:
        return bool(select.select([sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


class Response:
    """What a session call returns: status, body bytes and decoders."""

    __slots__ = ("status_code", "content", "headers")

    def __init__(self, status_code: int, content: bytes, headers) -> None:
        self.status_code = status_code
        self.content = content
        self.headers = headers

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return json.loads(self.content)


class KeepaliveSession:
    """A bounded pool of kept-alive connections: at most
    ``pool_connections`` destinations (least recently used dropped first),
    each with at most ``pool_maxsize`` idle connections. A pooled
    connection the peer has closed is discarded before reuse; a request is
    never sent twice."""

    def __init__(self, pool_connections: int = 4, pool_maxsize: int = 4):
        self._max_hosts = max(1, pool_connections)
        self._max_per_host = max(1, pool_maxsize)
        self._lock = make_lock("rpc.keepalive_pool", order=839)  # lock-order: 839
        # "host:port" -> [idle connections], LRU order.
        self._pools: OrderedDict[str, list] = OrderedDict()
        self.connections_created = 0

    def _take(self, dest: str, timeout: float) -> http.client.HTTPConnection:
        dropped: list = []
        conn = None
        with self._lock:
            pool = self._pools.get(dest)
            if pool is None:
                pool = self._pools[dest] = []
                while len(self._pools) > self._max_hosts:
                    dropped += self._pools.popitem(last=False)[1]
            self._pools.move_to_end(dest)
            while pool:
                c = pool.pop()
                if _dropped(c):
                    dropped.append(c)
                    continue
                conn = c
                break
        for c in dropped:
            c.close()
        if conn is None:
            host, _, port = dest.rpartition(":")
            conn = _Connection(host, int(port), timeout=timeout)
            with self._lock:
                self.connections_created += 1
        else:
            conn.timeout = timeout
            conn.sock.settimeout(timeout)
        return conn

    def _give(self, dest: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            pool = self._pools.get(dest)
            if pool is not None and len(pool) < self._max_per_host:
                pool.append(conn)
                return
        conn.close()

    def request(self, method: str, url: str, data: Optional[bytes] = None,
                json_body: Any = None, headers: Optional[dict] = None,
                timeout: float = DEFAULT_TIMEOUT_S) -> Response:
        u = urlsplit(url)
        dest = f"{u.hostname}:{u.port or 80}"
        path = u.path + (f"?{u.query}" if u.query else "")
        hdrs = dict(headers or {})
        if json_body is not None:
            data = json.dumps(json_body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        conn = self._take(dest, timeout)
        try:
            conn.request(method, path or "/", body=data, headers=hdrs)
            resp = conn.getresponse()
            body = resp.read()
        except (http.client.HTTPException, OSError) as e:
            conn.close()
            raise ChannelError(f"{method} {url}: {e!r}") from e
        if resp.will_close:
            conn.close()
        else:
            self._give(dest, conn)
        return Response(resp.status, body, resp.headers)

    def post(self, url: str, data: Optional[bytes] = None, json: Any = None,
             headers: Optional[dict] = None,
             timeout: float = DEFAULT_TIMEOUT_S) -> Response:
        return self.request("POST", url, data=data, json_body=json,
                            headers=headers, timeout=timeout)

    def get(self, url: str, headers: Optional[dict] = None,
            timeout: float = DEFAULT_TIMEOUT_S) -> Response:
        return self.request("GET", url, headers=headers, timeout=timeout)

    def stats(self) -> dict:
        """``hosts``: destinations with a pool now; ``connections_created``:
        connects ever made (an engine's connection-count evidence)."""
        with self._lock:
            return {"hosts": len(self._pools),
                    "connections_created": self.connections_created}

    def close(self) -> None:
        with self._lock:
            pools, self._pools = self._pools, OrderedDict()
        for idle in pools.values():
            for c in idle:
                c.close()


def make_keepalive_session(pool_connections: int = 4,
                           pool_maxsize: int = 4) -> KeepaliveSession:
    """A shared, bounded keep-alive session: one connection pool for every
    hop a process makes to the same destinations, instead of a connect per
    call."""
    return KeepaliveSession(pool_connections, pool_maxsize)


@_ownership.verify_state
class EngineChannel:
    def __init__(self, name: str, base_url: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 retries: int = DEFAULT_RETRIES,
                 backoff_base_s: float = DEFAULT_BACKOFF_BASE_S,
                 backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
                 breaker: Optional[CircuitBreaker] = None):
        # `name` is the engine's HTTP address (reference: InstanceMetaInfo.name
        # doubles as the HTTP endpoint, `xllm_rpc_service.proto:31-46`).
        self.name = name
        self.base_url = base_url or (
            name if name.startswith("http") else f"http://{name}")
        self.timeout_s = timeout_s
        self.retries = max(1, retries)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        # Negotiated dispatch-wire format for `forward` (InstanceMgr sets
        # this from the instance's advertised wire_formats at
        # registration; 415 responses demote it back to JSON).
        self.wire_format = wire.WIRE_JSON
        # Per-instance circuit breaker (rpc/breaker.py): OPEN fails every
        # call fast; the reconcile thread mirrors the state into routing
        # (BREAKER_OPEN) and drives the half-open recovery probe.
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker(name)
        self._session = KeepaliveSession()

    @classmethod
    def from_options(cls, name: str, options: Any) -> "EngineChannel":
        """Build with the `rpc_*` / `circuit_breaker_*` knobs from a
        ServiceOptions."""
        return cls(name,
                   timeout_s=options.rpc_timeout_s,
                   retries=options.rpc_retries,
                   backoff_base_s=options.rpc_backoff_base_s,
                   backoff_max_s=options.rpc_backoff_max_s,
                   breaker=CircuitBreaker(
                       name,
                       window_s=options.circuit_breaker_window_s,
                       min_samples=options.circuit_breaker_min_samples,
                       failure_ratio=options.circuit_breaker_failure_ratio,
                       open_cooldown_s=(
                           options.circuit_breaker_open_cooldown_s),
                       enabled=options.circuit_breaker_enabled))

    def _sleep_backoff(self, prior_attempts: int) -> None:
        time.sleep(jittered_backoff(self.backoff_base_s,
                                    self.backoff_max_s, prior_attempts))

    def _post(self, path: str, payload: dict[str, Any],
              timeout_s: Optional[float] = None,
              retries: Optional[int] = None,
              fmt: str = wire.WIRE_JSON) -> tuple[bool, Any]:
        attempts = self.retries if retries is None else max(1, retries)
        err: Any = None
        if not self.breaker.allow():
            return False, "circuit breaker open"
        data, ctype = wire.encode_dispatch(payload, fmt)
        # Trace propagation: the calling thread's active span rides the
        # wire as headers ({} almost always — one thread-local read).
        headers = dict(tracing.current_headers())
        headers["Content-Type"] = ctype
        for attempt in range(attempts):
            if attempt:
                RPC_RETRIES_TOTAL.labels(instance=self.name).inc()
                self._sleep_backoff(attempt - 1)
            try:
                FAULTS.check("rpc.post", instance=self.name, path=path)
                r = self._session.post(self.base_url + path, data=data,
                                       headers=headers,
                                       timeout=timeout_s or self.timeout_s)
                if r.status_code == 200:
                    try:
                        self.breaker.record(True)
                        return True, r.json()
                    except ValueError:  # a non-JSON 200 body is a success payload,
                        return True, r.text   # else it'd retry as failure
                self.breaker.record(_breaker_ok(r.status_code))
                err = f"HTTP {r.status_code}: {r.text[:200]}"
            except FaultInjected as e:
                self.breaker.record(False)
                err = str(e)
            except ChannelError as e:
                self.breaker.record(False)
                err = str(e)
        return False, err

    def _get(self, path: str, timeout_s: Optional[float] = None,
             retries: Optional[int] = None) -> tuple[bool, Any]:
        attempts = self.retries if retries is None else max(1, retries)
        err: Any = None
        if not self.breaker.allow():
            return False, "circuit breaker open"
        headers = tracing.current_headers() or None
        for attempt in range(attempts):
            if attempt:
                RPC_RETRIES_TOTAL.labels(instance=self.name).inc()
                self._sleep_backoff(attempt - 1)
            try:
                FAULTS.check("rpc.get", instance=self.name, path=path)
                r = self._session.get(self.base_url + path, headers=headers,
                                      timeout=timeout_s or self.timeout_s)
                if r.status_code == 200:
                    try:
                        self.breaker.record(True)
                        return True, r.json()
                    except ValueError:  # same contract as _post: a non-JSON
                        return True, r.text   # 200 body is a success payload
                self.breaker.record(_breaker_ok(r.status_code))
                err = f"HTTP {r.status_code}"
            except FaultInjected as e:
                self.breaker.record(False)
                err = str(e)
            except ChannelError as e:
                self.breaker.record(False)
                err = str(e)
        return False, err

    def warm_up(self, timeout_s: float = 2.0) -> bool:
        """Prime the connection pool (TCP + keepalive handshake) so the
        FIRST real call on this channel doesn't pay connection setup.
        Best-effort: registration proceeds either way."""
        ok, _ = self._get("/health", timeout_s=timeout_s, retries=1)
        return ok

    # ---- control plane -----------------------------------------------------
    def health(self, timeout_s: float = 1.0) -> bool:
        """Reference probes HTTP GET /health (`instance_mgr.cpp:500-539`).
        Single attempt: InstanceMgr owns the probe-retry policy
        (`health_probe_attempts`)."""
        ok, _ = self._get("/health", timeout_s=timeout_s, retries=1)
        return ok

    def link(self, peer: InstanceMetaInfo) -> bool:
        """Introduce a PD peer for KV-transfer setup (reference
        `DisaggPDService.LinkInstance`, `instance_mgr.cpp:1087-1113`)."""
        ok, err = self._post("/rpc/link", {"peer": json.loads(peer.to_json())})
        if not ok:
            logger.warning("link %s -> %s failed: %s", self.name, peer.name, err)
        return ok

    def unlink(self, peer_name: str) -> bool:
        ok, _ = self._post("/rpc/unlink", {"peer_name": peer_name})
        return ok

    def flip_role(self, new_type: str) -> bool:
        """Dynamic PD-role switch (reference flips types via engine contract,
        `instance_mgr.cpp:1023-1063`; TPU engine swaps compiled programs)."""
        ok, _ = self._post("/rpc/flip_role", {"type": new_type})
        return ok

    def drain(self) -> bool:
        """Graceful retirement (autoscaler scale-in / operator drain —
        no reference counterpart, its instances die abruptly): the
        engine advertises `draining` in its registration, finishes
        in-flight work and self-stops. Best effort; the master marks the
        instance DRAINING either way."""
        ok, _ = self._post("/rpc/drain", {})
        return ok

    def cancel(self, service_request_id: str) -> bool:
        """Propagate client disconnect / service-side cancellation to the
        engine (reference cancels via the engine contract on disconnect,
        `scheduler.cpp:507-521`)."""
        ok, _ = self._post("/rpc/cancel",
                           {"service_request_id": service_request_id})
        return ok

    def models(self) -> list[dict[str, Any]]:
        ok, body = self._get("/v1/models")
        if ok and isinstance(body, dict):
            return body.get("data", [])
        return []

    # ---- data plane (sync fallback; the frontend normally forwards async) --
    def forward(self, path: str, payload: dict[str, Any]) -> tuple[bool, Any]:
        """Single-shot by design: a generation forward is NOT idempotent.
        An ambiguous failure (reset after send) may already be generating;
        blind retry would double-submit. The failover layer owns replay —
        it rebinds incarnations first so any duplicate stream is dropped.

        Rides the negotiated dispatch wire (msgpack for current engines).
        A 415 demotes the channel to JSON and re-sends once — a 415
        rejection cannot have started generation, so this is the one safe
        retry on this wire."""
        ok, resp = self._post(path, payload, retries=1,
                              fmt=self.wire_format)
        if not ok and self.wire_format != wire.WIRE_JSON \
                and isinstance(resp, str) and resp.startswith("HTTP 415"):
            logger.warning("engine %s rejected msgpack dispatch; demoting "
                           "channel to JSON wire", self.name)
            with _ownership.escape("415 wire demotion: one-way monotonic "
                                   "fallback to JSON; GIL-atomic string "
                                   "swap on the negotiation slot"):
                self.wire_format = wire.WIRE_JSON
            ok, resp = self._post(path, payload, retries=1)
        return ok, resp

    def forward_status(self, path: str,
                       payload: dict[str, Any]) -> tuple[int, Any]:
        """Single-shot POST preserving the engine's status code + body (for
        proxied endpoints where 4xx/5xx must pass through to the client
        instead of collapsing into a retry/False)."""
        if not self.breaker.allow():
            return 503, {"error": "circuit breaker open"}
        try:
            FAULTS.check("rpc.post", instance=self.name, path=path)
            r = self._session.post(self.base_url + path, json=payload,
                                   headers=tracing.current_headers() or None,
                                   timeout=self.timeout_s)
        except (ChannelError, FaultInjected) as e:
            self.breaker.record(False)
            return 502, {"error": str(e)}
        self.breaker.record(_breaker_ok(r.status_code))
        try:
            return r.status_code, r.json()
        except ValueError:
            return r.status_code, {"error": r.text[:300]}

    def close(self) -> None:
        self._session.close()
