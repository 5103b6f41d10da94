"""Engine instance agent: the process that owns one port engine and speaks
the orchestration wire contract (port of ``xllm_service_tpu/engine/
agent.py``, its single-engine MIX path on the JSON wire).

It registers in coordination under ``XLLM:INSTANCE:<TYPE>:<name>`` with a
TTL lease and an incarnation id, heartbeats every 3 s to the elected master
(``XLLM:SERVICE:MASTER``) with KvCacheEvents and load/latency metrics,
accepts enriched completions and chat dispatches, streams batched
Generations to the dispatching service's RPC endpoint, serves ``/health``
probes, and honours cancel, drain, link/unlink and role flips. The
reference master serves it unchanged: it advertises
``wire_formats=["json"]``, so the master dispatches JSON to it, and its
heartbeats and Generations are JSON, which the master decodes.

Written on the standard library: ``http.server`` for the routes (HTTP/1.1,
kept-alive connections, a ``Content-Length`` on every reply) and
``http.client`` for its own posts. A route or flag of the reference that
the port lacks is refused with an error that names its ROADMAP item; the
agent never answers as if it had done work it did not do.

Run: ``python -m xllm_service_tpu_torch.engine.agent --coordination-addr
host:port --model-config llama3_8b`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import queue
import socket
import statistics
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional, Union

import torch

from ..common.net import pick_free_port
from ..common.request import RequestOutput, SamplingParams, Usage
from ..common.types import (
    InstanceMetaInfo,
    InstanceType,
    KvCacheEvent,
    TpuTopology,
    now_ms,
)
from ..coordination import CoordinationClient, connect
from ..rpc import MASTER_KEY, instance_key
from ..rpc import wire
from ..tokenizer.factory import TokenizerFactory
from .config import EngineConfig
from .engine import EngineRequest, InferenceEngine

logger = logging.getLogger(__name__)

# Reference routes this agent does not serve, each with its ROADMAP item
# (queue 1). A request to one gets 501 and this reason.
_NOT_PORTED = {
    "/rpc/kv_transfer": "PD KV transfer is not ported (ROADMAP queue 1 "
                        "item 10)",
    "/rpc/kv_stream_pull": "PD KV transfer is not ported (ROADMAP queue 1 "
                           "item 10)",
    "/rpc/encode": "the vision encoder (EPD) is not ported (ROADMAP queue 1 "
                   "item 13)",
    "/metrics": "/metrics is not ported (ROADMAP queue 1 item 3)",
    "/admin/trace": "engine-side tracing is not ported (ROADMAP queue 1 "
                    "item 3)",
    "/admin/trace/recent": "engine-side tracing is not ported (ROADMAP "
                           "queue 1 item 3)",
    "/admin/flightrecorder/recent": "the flight recorder is not ported "
                                    "(ROADMAP queue 1 item 3)",
    "/admin/profile": "the profiler routes are not ported (ROADMAP queue 1 "
                      "item 3)",
}


@dataclass
class AgentConfig:
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral
    coordination_addr: str = ""
    instance_type: InstanceType = InstanceType.MIX
    model_id: str = "tiny-llama"
    heartbeat_interval_s: float = 3.0
    lease_ttl_s: float = 3.0
    generation_flush_ms: float = 5.0   # batching window for Generations
    # Coordination-plane static stability: "on" keeps heartbeats flowing to
    # the last master that resolved while the plane is unreachable, so the
    # master's degraded-mode liveness fallback sees this engine alive;
    # "off": no resolvable master, no beats.
    degraded_mode: str = "on"


class _ChoiceAggregator:
    """Merges n engine sequences into one OpenAI request: re-indexes each
    choice's outputs and defers `finished`/usage until the last choice
    completes."""

    def __init__(self, n: int, push: Callable[[RequestOutput], None]):
        self._remaining = n
        self._push = push
        self._prompt_tokens = 0
        self._generated = 0
        self._lock = threading.Lock()

    def callback_for(self, index: int) -> Callable[[RequestOutput], None]:
        def cb(out: RequestOutput) -> None:
            for seq_out in out.outputs:
                seq_out.index = index
            if out.finished:
                with self._lock:
                    self._remaining -= 1
                    last = self._remaining == 0
                    if out.usage is not None:
                        self._prompt_tokens = out.usage.num_prompt_tokens
                        self._generated += out.usage.num_generated_tokens
                    if last:
                        out.usage = Usage(
                            num_prompt_tokens=self._prompt_tokens,
                            num_generated_tokens=self._generated)
                    else:
                        out.finished = False
                        out.usage = None
            self._push(out)
        return cb


class _Connections:
    """Kept-alive HTTP/1.1 connections, one per destination ("host:port"),
    used by one thread. A post that finds its reused connection closed by
    the peer (an idle keep-alive timeout) is sent once more on a fresh one;
    the receivers are idempotent (Generations dedupe on ``delta_seq``,
    heartbeats apply absolute state)."""

    _STALE = (http.client.RemoteDisconnected, BrokenPipeError,
              ConnectionResetError, ConnectionAbortedError)

    def __init__(self, timeout_s: float):
        self._timeout_s = timeout_s
        self._conns: dict[str, http.client.HTTPConnection] = {}

    def post(self, dest: str, path: str, body: bytes,
             ctype: str) -> tuple[int, bytes]:
        while True:
            conn = self._conns.get(dest)
            reused = conn is not None
            if conn is None:
                host, _, port = dest.rpartition(":")
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=self._timeout_s)
                self._conns[dest] = conn
            try:
                conn.request("POST", path, body=body,
                             headers={"Content-Type": ctype})
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as e:
                self.drop(dest)
                if reused and isinstance(e, self._STALE):
                    continue
                raise
            if resp.will_close:
                self.drop(dest)
            return resp.status, data

    def drop(self, dest: str) -> None:
        conn = self._conns.pop(dest, None)
        if conn is not None:
            conn.close()

    def close(self) -> None:
        for dest in list(self._conns):
            self.drop(dest)


_NOTHING = object()   # queue-timeout marker distinct from the stop sentinel


class GenerationStreamer:
    """Batches RequestOutput deltas per destination service and POSTs
    `{"gens": [...]}` as JSON to its ``/rpc/generations`` on a kept-alive
    connection (the reference's direct per-destination wire). ``engine``
    is anything with a ``cancel(service_request_id)``.

    Delivery semantics: each delta carries a per-request monotonic
    `delta_seq` (the service dedupes on it, so retries are safe even when
    the original POST was processed but its response lost). A failed dest
    keeps its gens queued and is retried after a backoff without blocking
    flushes to healthy dests; only after `FLUSH_RETRIES` consecutive
    failures are that dest's requests cancelled. Requests the service
    reports not alive are cancelled."""

    FLUSH_RETRIES = 2
    RETRY_BACKOFF_S = 0.25

    def __init__(self, engine: Any, flush_ms: float):
        self._engine = engine
        self._q: "queue.Queue[Optional[tuple[str, dict]]]" = queue.Queue()
        self._flush_s = flush_ms / 1000.0
        self._seq_lock = threading.Lock()
        self._seqs: dict[str, int] = {}
        # Sender identity stamped on every delta (set by the agent).
        self.instance_name = ""
        self.incarnation = ""
        self.direct_sends = 0
        self._conns = _Connections(timeout_s=10.0)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gen-streamer")
        self._thread.start()

    def push(self, dest_addr: str, output: RequestOutput) -> None:
        sid = output.service_request_id
        # seq assignment AND enqueue under one lock: the service's dedup
        # relies on queue order == seq order per request.
        with self._seq_lock:
            seq = self._seqs.get(sid, 0) + 1
            if output.finished:
                self._seqs.pop(sid, None)
            else:
                self._seqs[sid] = seq
            output.delta_seq = seq
            output.instance = self.instance_name
            output.incarnation = self.incarnation
            self._q.put((dest_addr, output.to_dict()))

    def _loop(self) -> None:
        # Per-dest unsent gens (order preserved) + failure bookkeeping.
        pending: dict[str, list[dict]] = {}
        attempts: dict[str, int] = {}
        next_try: dict[str, float] = {}
        stopping = False
        while True:
            now = time.monotonic()
            if stopping and not pending:
                self._conns.close()
                return
            if pending:
                wait = max(0.0, min(next_try.get(d, now)
                                    for d in pending) - now)
            else:
                wait = None   # idle: block until the next delta
            try:
                item = self._q.get(timeout=wait)
            except queue.Empty:
                item = _NOTHING
            if item is None:
                stopping = True
            elif item is not _NOTHING:
                # Batch for one flush interval, preserving per-dest order.
                pending.setdefault(item[0], []).append(item[1])
                deadline = time.monotonic() + self._flush_s
                while True:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if nxt is None:
                        stopping = True
                        break
                    pending.setdefault(nxt[0], []).append(nxt[1])

            now = time.monotonic()
            ready = [d for d in list(pending)
                     if stopping or next_try.get(d, 0.0) <= now]
            for dest in ready:
                self.direct_sends += 1
                if self._send(dest, pending[dest]):
                    del pending[dest]
                    attempts.pop(dest, None)
                    next_try.pop(dest, None)
                    continue
                n = attempts.get(dest, 0) + 1
                if stopping or n > self.FLUSH_RETRIES:
                    # Repeatedly unreachable: cancel these requests so the
                    # engine doesn't burn the card on a dead stream.
                    for g in pending.pop(dest):
                        self._engine.cancel(g.get("service_request_id", ""))
                    attempts.pop(dest, None)
                    next_try.pop(dest, None)
                else:
                    attempts[dest] = n
                    next_try[dest] = now + self.RETRY_BACKOFF_S * n

    def _send(self, dest: str, gens: list[dict]) -> bool:
        body, ctype = wire.encode_dispatch({"gens": gens})
        try:
            status, data = self._conns.post(dest, "/rpc/generations", body,
                                            ctype)
            # An error page must route through retry/cancel, not count as
            # delivery.
            if status != 200:
                raise ValueError(f"HTTP {status}: {data[:200]!r}")
            alive = json.loads(data).get("alive", {})
        except (http.client.HTTPException, OSError, ValueError) as e:
            logger.warning("generations push to %s failed: %s", dest, e)
            return False
        for sid, ok in alive.items():
            if not ok:
                self._engine.cancel(sid)
        return True

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=15)


class _Handler(BaseHTTPRequestHandler):
    """One kept-alive HTTP/1.1 connection to the agent; every reply is
    JSON with a Content-Length (the master's clients keep connections)."""

    protocol_version = "HTTP/1.1"
    # A reply goes out as two writes (headers, then body). On a kept-alive
    # connection Nagle holds the body until the client ACKs the headers,
    # which a client waiting for the body delays by the delayed-ACK timer
    # (about 40 ms on Linux) on every request after the first.
    disable_nagle_algorithm = True
    agent: "EngineAgent"

    def setup(self) -> None:
        super().setup()
        self.agent._note_conn(self.connection, True)

    def finish(self) -> None:
        try:
            super().finish()
        finally:
            self.agent._note_conn(self.connection, False)

    def do_GET(self) -> None:
        self._serve("GET")

    def do_POST(self) -> None:
        self._serve("POST")

    def _serve(self, method: str) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        path = self.path.split("?", 1)[0]
        try:
            status, obj = self.agent._route(
                method, path, body, self.headers.get("Content-Type", ""))
        except Exception as e:  # noqa: BLE001 — surfaced as a 500
            logger.exception("%s %s failed", method, path)
            status, obj = 500, {"error": str(e)}
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", wire.JSON_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)


class _Server(ThreadingHTTPServer):
    request_queue_size = 128


class _BadRequest(ValueError):
    """A request body the agent cannot parse (HTTP 400)."""


Reply = tuple[int, dict]


class EngineAgent:
    def __init__(self, engine_cfg: EngineConfig, agent_cfg: AgentConfig,
                 coord: Optional[CoordinationClient] = None,
                 params: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = agent_cfg
        tokenizer = TokenizerFactory.create_tokenizer()
        # The engine first: without a card (and no device named) it raises
        # before anything else is opened.
        self.engine = InferenceEngine(engine_cfg, device=device,
                                      tokenizer=tokenizer, params=params)
        self.coord = coord or connect(agent_cfg.coordination_addr)
        self.port = agent_cfg.port or pick_free_port(agent_cfg.host)
        self.name = f"{agent_cfg.host}:{self.port}"
        self.incarnation_id = uuid.uuid4().hex[:12]
        self.instance_type = agent_cfg.instance_type
        # Last master address that resolved: the degraded-mode target
        # while the plane is unreachable.
        self._last_master = ""
        self._hb_conns = _Connections(timeout_s=3.0)
        # Pass the agent itself: cancel() is the engine's.
        self.streamer = GenerationStreamer(self,
                                           agent_cfg.generation_flush_ms)
        # Stamp sender identity on every delta: after a transparent
        # failover the service drops deltas from incarnations the request
        # is no longer bound to.
        self.streamer.instance_name = self.name
        self.streamer.incarnation = self.incarnation_id
        # Agent-observed TTFT per request (ms, accept -> first delta).
        self.ttft_spans: deque = deque(maxlen=512)
        self.linked_peers: dict[str, InstanceMetaInfo] = {}
        self._draining = False
        # Registration and role flips under one lock: a heartbeat's
        # re-registration must not re-create the key a flip just removed.
        self._reg_lock = threading.Lock()
        self._stop_lock = threading.Lock()
        self._stopped = False
        self._wake = threading.Event()
        self._server: Optional[_Server] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._routes: dict[tuple[str, str], Callable[[bytes, str], Reply]] = {
            ("GET", "/health"): self._h_health,
            ("GET", "/v1/models"): self._h_models,
            ("GET", "/stats"): self._h_stats,
            ("POST", "/v1/completions"): self._h_completion,
            ("POST", "/v1/chat/completions"): self._h_chat,
            ("POST", "/v1/embeddings"): self._h_embeddings,
            ("POST", "/rpc/link"): self._h_link,
            ("POST", "/rpc/unlink"): self._h_unlink,
            ("POST", "/rpc/cancel"): self._h_cancel,
            ("POST", "/rpc/flip_role"): self._h_flip,
            ("POST", "/rpc/drain"): self._h_drain,
        }

    def cancel(self, service_request_id: str) -> None:
        self.engine.cancel(service_request_id)

    # ------------------------------------------------------------ metadata
    # Conservative cold-start tables (used until the engine has measured
    # enough of its own traffic to fit real ones).
    DEFAULT_TTFT_TABLE = [[128, 30.0], [512, 80.0], [2048, 250.0],
                          [4096, 520.0]]
    DEFAULT_TPOT_TABLE = [[1, 128, 6.0], [4, 2048, 9.0],
                          [8, 8192, 14.0], [16, 32768, 25.0]]

    def profiling_tables(self) -> tuple[list, list]:
        """SLO profiling tables from live engine telemetry. Samples are
        bucketed (median per bucket, robust to stragglers); until >= 3
        distinct buckets exist the conservative defaults are advertised so
        the predictor always has something to fit."""
        ttft: dict[int, list[float]] = {}
        tpot: dict[int, list[tuple[int, float]]] = {}
        for plen, ms in list(self.engine.ttft_samples):
            bucket = 1 << max(5, (plen - 1).bit_length())
            ttft.setdefault(bucket, []).append(ms)
        for batch, toks, ms in list(self.engine.tpot_samples):
            tpot.setdefault(batch, []).append((toks, ms))
        ttft_table = [[b, statistics.median(v)]
                      for b, v in sorted(ttft.items())]
        tpot_table = [
            [b, statistics.median(t for t, _ in v),
             statistics.median(m for _, m in v)]
            for b, v in sorted(tpot.items())]
        if len(ttft_table) < 3:
            ttft_table = self.DEFAULT_TTFT_TABLE
        if len(tpot_table) < 3:
            tpot_table = self.DEFAULT_TPOT_TABLE
        return ttft_table, tpot_table

    def _mesh_shape(self) -> list[int]:
        mesh = self.engine.mesh
        return list(mesh.sizes) if mesh is not None else [1]

    def _mesh_axes(self) -> list[str]:
        mesh = self.engine.mesh
        return list(mesh.axis_names) if mesh is not None else ["data"]

    def meta(self) -> InstanceMetaInfo:
        ecfg = self.engine.cfg
        mcfg = ecfg.model
        ttft_table, tpot_table = self.profiling_tables()
        return InstanceMetaInfo(
            name=self.name, rpc_address=self.name, type=self.instance_type,
            dp_size=1,
            topology=TpuTopology(
                # The reference's default slice; placement flags are not
                # ported. Describes THIS engine's mesh (mesh-less = one
                # device).
                slice_id="slice-0",
                mesh_shape=self._mesh_shape(),
                axis_names=self._mesh_axes(),
                host_addrs=[self.name]),
            kv_page_size=ecfg.page_size,
            kv_dtype=str(mcfg.dtype).removeprefix("torch."),
            num_layers=mcfg.num_layers, num_kv_heads=mcfg.num_kv_heads,
            head_dim=mcfg.head_dim,
            max_context_len=ecfg.max_seq_len,
            incarnation_id=self.incarnation_id,
            register_ts_ms=int(time.time() * 1000),
            models=[self.cfg.model_id],
            wire_formats=[wire.WIRE_JSON],
            ttft_profiling_data=ttft_table,
            tpot_profiling_data=tpot_table,
        )

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EngineAgent":
        self.engine.start()
        handler = type("_AgentHandler", (_Handler,), {"agent": self})
        self._server = _Server((self.cfg.host, self.port), handler)
        t = threading.Thread(target=self._server.serve_forever,
                             kwargs={"poll_interval": 0.1}, daemon=True,
                             name=f"agent-http-{self.port}")
        t.start()
        self._threads.append(t)
        self.register()
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True,
                              name="agent-heartbeat")
        hb.start()
        self._threads.append(hb)
        logger.info("engine agent %s (%s, model=%s) up on %s",
                    self.name, self.instance_type.value, self.cfg.model_id,
                    self.engine.device)
        return self

    def register(self) -> None:
        with self._reg_lock:
            meta = self.meta()
            meta.draining = self._draining
            self.coord.set(instance_key(self.instance_type.value, self.name),
                           meta.to_json(), ttl_s=self.cfg.lease_ttl_s)

    def drain(self, timeout_s: float = 60.0) -> None:
        """Graceful shutdown: advertise draining (the scheduler stops
        routing here on the next registration refresh), let in-flight
        requests finish, then stop."""
        logger.info("agent %s draining (timeout %.0fs)", self.name,
                    timeout_s)
        self._draining = True
        self.register()
        # Grace window: requests the master routed just before the
        # draining flag landed may still be in HTTP flight.
        time.sleep(min(timeout_s / 4,
                       max(1.0, self.cfg.heartbeat_interval_s)))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            stats = self.aggregate_stats()
            if stats["running"] == 0 and stats["waiting"] == 0:
                break
            time.sleep(0.2)
        self.stop()

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._wake.set()
        self.coord.rm(instance_key(self.instance_type.value, self.name))
        self.streamer.stop()
        self.engine.stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:     # kept-alive client connections
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._hb_conns.close()
        self.coord.close()

    def _note_conn(self, conn: Any, open_: bool) -> None:
        with self._conns_lock:
            (self._conns.add if open_ else self._conns.discard)(conn)

    # ----------------------------------------------------------- heartbeats
    def _heartbeat_loop(self) -> None:
        """The reference's master funnel: re-register (lease refresh),
        resolve the elected master, beat to it."""
        while not self._wake.wait(self.cfg.heartbeat_interval_s):
            try:
                self.register()
                target = self.coord.get(MASTER_KEY) or ""
                if target:
                    self._last_master = target
                elif self.cfg.degraded_mode != "off":
                    # Static stability: an unreachable plane resolves no
                    # master; keep beating at the last one that did.
                    target = self._last_master
                if not target:
                    continue
                stats = self.aggregate_stats()
                ev = self.engine.drain_kv_events()
                ttft, tbt = self.engine.drain_recent_latency()
                payload = {
                    "name": self.name,
                    "incarnation_id": self.incarnation_id,
                    "load_metrics": {
                        "waiting_requests_num": stats["waiting"],
                        "running_requests_num": stats["running"],
                        "hbm_cache_usage_perc": stats["kv_usage_perc"],
                    },
                    "latency_metrics": {
                        "recent_max_ttft": ttft,
                        "recent_max_tbt": tbt,
                    },
                }
                self._post_heartbeat(target, payload, ev)
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("heartbeat failed")

    def _post_heartbeat(self, target: str, payload: dict,
                        ev: KvCacheEvent) -> bool:
        """One heartbeat on the JSON wire (KV-event keys as hex)."""
        payload = dict(payload, kv_cache_event=ev.to_dict())
        body, ctype = wire.encode_dispatch(payload)
        try:
            status, _ = self._hb_conns.post(target, "/rpc/heartbeat", body,
                                            ctype)
        except (http.client.HTTPException, OSError) as e:
            logger.warning("heartbeat to %s failed: %s", target, e)
            return False
        return status == 200

    # ------------------------------------------------------------ handlers
    def aggregate_stats(self) -> dict[str, Any]:
        s = self.engine.stats()
        return {
            "waiting": s["waiting"],
            "running": s["running"],
            "kv_usage_perc": s["kv_usage_perc"],
            "cached_blocks": s["cached_blocks"],
            "total_generated": s["total_generated"],
            "dp_size": 1,
            "sarathi_rides": self.engine.sarathi_rides,
            "preemption_count": self.engine.preemption_count,
        }

    def _route(self, method: str, path: str, body: bytes,
               ctype: str) -> Reply:
        fn = self._routes.get((method, path))
        if fn is not None:
            try:
                return fn(body, ctype)
            except _BadRequest as e:
                return 400, {"error": str(e)}
        if path in _NOT_PORTED:
            return 501, {"error": _NOT_PORTED[path]}
        return 404, {"error": f"no route {method} {path}"}

    @staticmethod
    def _json(body: bytes) -> dict:
        try:
            obj = json.loads(body or b"{}")
        except ValueError:
            raise _BadRequest("invalid JSON") from None
        if not isinstance(obj, dict):
            raise _BadRequest("body must be an object")
        return obj

    def _h_health(self, body: bytes, ctype: str) -> Reply:
        return 200, {"status": "ok"}

    def _h_models(self, body: bytes, ctype: str) -> Reply:
        return 200, {"object": "list", "data": [
            {"id": self.cfg.model_id, "object": "model"}]}

    def _h_stats(self, body: bytes, ctype: str) -> Reply:
        return 200, {
            **self.aggregate_stats(),
            "telemetry": {"mode": "master",
                          "direct_sends": self.streamer.direct_sends},
            "kv_tier": self._tier_stats(),
            "ttft_spans": self._span_summary(),
        }

    def _tier_stats(self) -> dict[str, Any]:
        """Tier-store telemetry ({} = tiering off)."""
        store = self.engine.tier_store
        return dict(store.stats()) if store is not None else {}

    def _span_summary(self) -> dict[str, float]:
        """p50s of the TTFT span samples (agent accept -> first delta; the
        engine's queue wait; its prefill), so an external bench can split
        client TTFT across processes."""
        def p50(xs):
            xs = sorted(xs)
            return round(xs[len(xs) // 2], 1) if xs else 0.0

        eng = list(self.engine.span_samples)
        return {"n": len(self.ttft_spans),
                "agent_accept_to_first_delta_ms": p50(self.ttft_spans),
                "engine_queue_ms": p50(s["queue_ms"] for s in eng),
                "engine_prefill_ms": p50(s["prefill_ms"] for s in eng)}

    def _h_link(self, body: bytes, ctype: str) -> Reply:
        peer = InstanceMetaInfo.from_json(
            json.dumps(self._json(body).get("peer", {})))
        # KV-layout compatibility gate.
        mine = self.meta()
        for f in ("kv_page_size", "num_layers", "num_kv_heads", "head_dim"):
            if getattr(peer, f) and getattr(peer, f) != getattr(mine, f):
                return 409, {"ok": False,
                             "error": f"kv layout mismatch on {f}"}
        self.linked_peers[peer.name] = peer
        return 200, {"ok": True}

    def _h_unlink(self, body: bytes, ctype: str) -> Reply:
        self.linked_peers.pop(self._json(body).get("peer_name", ""), None)
        return 200, {"ok": True}

    def _h_cancel(self, body: bytes, ctype: str) -> Reply:
        self.cancel(self._json(body).get("service_request_id", ""))
        return 200, {"ok": True}

    def _h_drain(self, body: bytes, ctype: str) -> Reply:
        """Master-initiated graceful retirement: the drain sequence runs
        on a background thread; the RPC acks immediately."""
        if not self._draining:
            threading.Thread(target=self.drain, name="agent-drain",
                             daemon=True).start()
        return 200, {"ok": True, "draining": True}

    def _h_flip(self, body: bytes, ctype: str) -> Reply:
        """Dynamic PD-role switch: the engine keeps its weights and KV
        pool; the registration moves to the new role's key."""
        new_type = InstanceType.parse(self._json(body).get("type"))
        with self._reg_lock:
            self.coord.rm(instance_key(self.instance_type.value, self.name))
            self.instance_type = new_type
        self.register()
        return 200, {"ok": True}

    def _h_embeddings(self, body: bytes, ctype: str) -> Reply:
        """OpenAI embeddings over the engine's embed forward."""
        req = self._json(body)
        inputs = req.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not inputs:
            return 400, {"error": "input must be a string or list of "
                                  "strings"}
        if self.engine.family.embed_forward is None:
            return 501, {"error": f"model family "
                                  f"{self.engine.cfg.model_family} has no "
                                  "embedding forward"}
        max_len = self.engine.cfg.max_seq_len
        tok = self.engine.tokenizer
        token_lists = [tok.encode(str(t))[:max_len] or [0] for t in inputs]
        vecs = self.engine.embed(token_lists)
        n_tokens = sum(len(t) for t in token_lists)
        return 200, {
            "object": "list",
            "model": req.get("model", self.cfg.model_id),
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in v]}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }

    def _h_completion(self, body: bytes, ctype: str) -> Reply:
        return self._accept(body, ctype, chat=False)

    def _h_chat(self, body: bytes, ctype: str) -> Reply:
        return self._accept(body, ctype, chat=True)

    def _accept(self, data: bytes, ctype: str, chat: bool) -> Reply:
        t_recv = time.monotonic()
        try:
            body = wire.decode_body(ctype, data)
        except wire.UnsupportedMediaType as e:
            return 415, {"error": str(e)}
        except ValueError:
            return 400, {"error": "invalid request body"}
        if not isinstance(body, dict):
            return 400, {"error": "body must be an object"}
        sid = body.get("service_request_id") or f"local-{uuid.uuid4().hex[:8]}"
        source = body.get("source_service_addr", "")
        token_ids = list(body.get("token_ids") or ())
        # End-to-end deadline: the enriched payload carries the ABSOLUTE
        # deadline; work that expired while queued upstream is refused.
        deadline_ms = int(body.get("deadline_ms") or 0)
        if deadline_ms and now_ms() > deadline_ms:
            return 504, {"error": "deadline exceeded"}
        if chat and any(
                isinstance(part, dict)
                and str(part.get("type", "")).startswith("image")
                for m in body.get("messages") or ()
                if isinstance(m, dict) and isinstance(m.get("content"), list)
                for part in m["content"]):
            return 501, {"error": "image inputs need the vision encoder, "
                                  "which is not ported (ROADMAP queue 1 "
                                  "item 13)"}
        if not token_ids:
            # Standalone mode (no orchestrator enrichment): tokenize here.
            prompt = body.get("prompt", "")
            if chat and not prompt:
                msgs = body.get("messages") or []
                prompt = "\n".join(str(m.get("content", "")) for m in msgs)
            token_ids = self.engine.tokenizer.encode(str(prompt))
        sampling = self._sampling_from_body(body)

        if not source:
            return 400, {"error": "source_service_addr required (engine "
                                  "streams results to the service RPC "
                                  "endpoint)"}
        decode_name = (body.get("routing") or {}).get("decode_name", "")
        if self.instance_type == InstanceType.PREFILL and decode_name \
                and decode_name != self.name:
            return 501, {"error": "the prefill-to-decode handoff needs PD "
                                  "KV transfer, which is not ported "
                                  "(ROADMAP queue 1 item 10)"}

        dest = source
        first_delta = [True]

        def on_output(out: RequestOutput) -> None:
            if deadline_ms and not out.finished and now_ms() > deadline_ms:
                # Mid-decode expiry: stop the request through the cancel
                # path; the delta in hand still ships.
                self.cancel(out.service_request_id)
            if first_delta[0]:
                first_delta[0] = False
                self.ttft_spans.append((time.monotonic() - t_recv) * 1000)
            self.streamer.push(dest, out)

        # n > 1: fan out into n engine sequences sharing the prompt (the
        # prefix cache dedupes their prefill); choice k's outputs are
        # re-indexed, and `finished` is withheld until every choice is done.
        n = max(1, sampling.n)
        offline = bool(body.get("offline", False))
        priority = int(body.get("priority") or 0)
        request_id = body.get("request_id", sid)
        if n == 1:
            self.engine.submit(EngineRequest(
                service_request_id=sid, request_id=request_id,
                token_ids=token_ids, sampling=sampling, on_output=on_output,
                offline=offline, priority=priority))
            return 200, {"ok": True, "service_request_id": sid}

        agg = _ChoiceAggregator(n, lambda out: self.streamer.push(dest, out))
        for k in range(n):
            sub_sampling = sampling
            if sampling.seed is not None:
                sub_sampling = SamplingParams.from_dict(sampling.to_dict())
                sub_sampling.seed = sampling.seed + k
            self.engine.submit(EngineRequest(
                service_request_id=sid, request_id=request_id,
                token_ids=list(token_ids), sampling=sub_sampling,
                on_output=agg.callback_for(k),
                offline=offline, priority=priority))
        return 200, {"ok": True, "service_request_id": sid}

    @staticmethod
    def _sampling_from_body(body: dict[str, Any]) -> SamplingParams:
        sp = SamplingParams()
        def num(key, default, cast):
            v = body.get(key)
            return cast(v) if v is not None else default
        sp.max_tokens = num("max_tokens", num("max_completion_tokens", 16, int), int)
        sp.n = num("n", 1, int)
        sp.temperature = num("temperature", 1.0, float)
        sp.top_p = num("top_p", 1.0, float)
        sp.top_k = num("top_k", -1, int)
        sp.frequency_penalty = num("frequency_penalty", 0.0, float)
        sp.presence_penalty = num("presence_penalty", 0.0, float)
        sp.repetition_penalty = num("repetition_penalty", 1.0, float)
        stop = body.get("stop")
        sp.stop = [stop] if isinstance(stop, str) else \
            [str(s) for s in stop] if isinstance(stop, list) else []
        sp.stop_token_ids = list(body.get("stop_token_ids", ()))
        if body.get("seed") is not None:
            sp.seed = int(body["seed"])
        lp = body.get("logprobs")
        if isinstance(lp, bool):
            sp.logprobs = lp
            sp.top_logprobs = int(body.get("top_logprobs") or 0)
        elif isinstance(lp, int):
            sp.logprobs = lp > 0
            sp.top_logprobs = lp
        sp.ignore_eos = bool(body.get("ignore_eos", False))
        lb = body.get("logit_bias")
        if isinstance(lb, dict):
            try:
                sp.logit_bias = {int(k): float(v) for k, v in lb.items()}
            except (TypeError, ValueError):
                pass
        return sp


# Reference flags this agent does not take: flag -> (the value that means
# "off", the ROADMAP item that ports it). Any other value is an error.
_REFUSED_FLAGS: dict[str, tuple[Any, str]] = {
    "--tp": (0, "tensor parallelism, queue 1 item 11"),
    "--device-offset": (0, "multi-device placement, queue 1 item 11"),
    "--dp-size": (1, "dp_size > 1, queue 1 item 3"),
    "--quant": ("", "weight-only int8, queue 1 item 7"),
    "--checkpoint-path": ("", "checkpoint loading, queue 1 item 8"),
    "--tokenizer-path": ("", "checkpoint loading, queue 1 item 8"),
    "--speculate-k": (0, "speculative decoding, queue 1 item 6"),
    "--telemetry-mode": ("master", "the mux and owner telemetry modes, "
                                   "queue 1 item 3"),
    "--slice-id": ("slice-0", "topology placement with PD, queue 1 "
                              "item 10"),
    "--topo-host": ("", "topology placement with PD, queue 1 item 10"),
    "--topo-chip": (-1, "topology placement with PD, queue 1 item 10"),
    "--ici-bytes-per-s": (0.0, "PD KV transfer budgets, queue 1 item 10"),
    "--dcn-bytes-per-s": (0.0, "PD KV transfer budgets, queue 1 item 10"),
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="xllm-service engine agent on the PyTorch/CUDA port")
    p.add_argument("--coordination-addr", default="127.0.0.1:12379",
                   help="coordination server host:port ('' = in-process)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--type", default="MIX",
                   choices=[t.value for t in InstanceType])
    p.add_argument("--model-id", default="bench-1b")
    p.add_argument("--model-config", default="bench_1b",
                   choices=["tiny", "bench_1b", "llama3_8b"],
                   help="config factory in models.base (random weights "
                        "from the engine's seed)")
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--decode-horizon", type=int, default=0,
                   help="tokens per host fetch (0 = config default)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked-prefill tokens per engine iteration "
                        "(0 = whole-suffix installs); with a chunk set, "
                        "mid chunks ride decode steps (Sarathi mixed "
                        "steps) unless XLLM_SARATHI=0")
    p.add_argument("--generation-flush-ms", type=float, default=5.0,
                   help="batching window for Generations delta pushes")
    p.add_argument("--kv-tier-dram-mb", type=int, default=0,
                   help="host-RAM tier for evicted prefix KV blocks, MiB "
                        "(0 disables tiering)")
    p.add_argument("--kv-tier-ssd-mb", type=int, default=0,
                   help="disk spill tier behind the DRAM arena, MiB "
                        "(requires --kv-tier-dram-mb > 0)")
    p.add_argument("--kv-tier-ssd-path", default="",
                   help="spill file path ('' = a temp file owned by the "
                        "store)")
    p.add_argument("--degraded-mode", default="on", choices=["on", "off"],
                   help="on = keep heartbeats flowing to the last-known-"
                        "good master while the coordination plane is "
                        "unreachable; off = no resolvable master, no beats")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a "
                        "card). 'cpu' runs on the CPU")
    for flag, (default, item) in _REFUSED_FLAGS.items():
        p.add_argument(flag, type=type(default), default=default,
                       help=f"not ported ({item})")
    return p


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The engine configuration of parsed command-line ``args``."""
    from ..models import base as model_base

    mcfg = {"tiny": model_base.tiny_config,
            "bench_1b": model_base.bench_1b_config,
            "llama3_8b": model_base.llama3_8b_config}[args.model_config]()
    ecfg = EngineConfig(
        model_family=mcfg.name, model=mcfg,
        num_pages=args.num_pages, page_size=args.page_size,
        max_batch_size=args.max_batch_size,
        max_seq_len=min(args.max_seq_len, mcfg.max_context_len))
    if args.kv_tier_dram_mb > 0:
        ecfg.kv_tier_dram_bytes = args.kv_tier_dram_mb << 20
        ecfg.kv_tier_ssd_bytes = args.kv_tier_ssd_mb << 20
        ecfg.kv_tier_ssd_path = args.kv_tier_ssd_path
    if args.decode_horizon > 0:
        ecfg.decode_horizon = args.decode_horizon
    if args.prefill_chunk > 0:
        ecfg.prefill_chunk_tokens = args.prefill_chunk
    return ecfg


def main(argv: Optional[list[str]] = None) -> None:
    p = _parser()
    args = p.parse_args(argv)
    for flag, (default, item) in _REFUSED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) != default:
            p.error(f"{flag} is not ported yet (ROADMAP {item})")
    agent = EngineAgent(
        engine_config(args),
        AgentConfig(host=args.host, port=args.port,
                    coordination_addr=args.coordination_addr,
                    instance_type=InstanceType.parse(args.type),
                    model_id=args.model_id,
                    generation_flush_ms=args.generation_flush_ms,
                    degraded_mode=args.degraded_mode),
        device=args.device)
    agent.start()
    import signal as _signal

    def _sigterm(_sig, _frm):
        # Planned restarts drain: stop taking traffic, finish streams.
        agent.drain(timeout_s=60.0)
        raise SystemExit(0)

    _signal.signal(_signal.SIGTERM, _sigterm)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        agent.stop()


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    main()
