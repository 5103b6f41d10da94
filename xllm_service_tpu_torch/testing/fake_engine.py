"""In-process fake engine implementing the full engine contract (port of
``xllm_service_tpu/testing/fake_engine.py`` on the standard library: it
serves on ``http_service/web.py`` and posts on the kept-alive session of
``rpc/channel.py``; locks are plain ``threading.Lock``s).

It is the hermetic fixture for scheduler/failover/e2e tests, the default
engine of the autoscaler's local actuator
(``python -m xllm_service_tpu_torch.testing.fake_engine``, the flags of
the reference's ``examples/run_fake_engine.py``), AND an implementation
of the engine side of the wire contract:

- registers itself in coordination under `XLLM:INSTANCE:<TYPE>:<name>` with
  a TTL lease (+incarnation id),
- heartbeats to the master's RPC endpoint (load metrics + KV-cache events),
- serves the engine HTTP surface: enriched /v1/completions +
  /v1/chat/completions (fire-and-forget accept), /health, /rpc/link,
  /rpc/unlink, /rpc/cancel, /rpc/flip_role, /rpc/drain (self-stops once
  its streams finish),
- streams canned Generations back to `source_service_addr` in configurable
  chunks with configurable delays, each stamped with this engine's
  instance/incarnation (the service's stale-incarnation guard keys on it),
- resumes a failed-over request from `resume_generated_token_ids`: the
  canned reply continues from the token after the replayed prefix, so a
  chaos drill can assert the client-visible sequence is byte-identical.

Failure drills: `pause()` (stop heartbeats + lease), `kill()` (drop
everything, refuse health), `set_unhealthy()`; plus scripted faults from
the deterministic plane (`common/faults.py`):

- ``engine.token`` action ``crash`` — hard-kill before emitting the Nth
  delta (crash-on-Nth-token, `after=N`),
- ``engine.heartbeat`` action ``silence`` — stop heartbeats AND let the
  lease lapse (process-hang simulation),
- ``engine.accept`` action ``error``/``drop`` — reject or swallow an
  incoming generation request.
"""

from __future__ import annotations

import argparse
import asyncio
import queue
import signal
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

from ..common.faults import FAULTS
from ..common.hashing import prefix_block_hash_hexes
from ..common import topology as topo
from ..common.tracing import (TRACER, TraceContext, admin_trace,
                              admin_trace_recent)
from ..common.types import (InstanceMetaInfo, InstanceType, KvCacheEvent,
                            TpuTopology, now_ms)
from ..coordination.base import CoordinationClient
from ..devtools.locks import make_lock
from ..http_service import web
from ..multimaster.ownership import TelemetryOwnerResolver
from ..overload.deadline import deadline_expired
from ..profiling import admin_profile
from ..rpc import instance_key
from ..rpc import wire
from ..rpc.channel import (ChannelError, KeepaliveSession,
                           make_keepalive_session)
from ..utils import get_logger, pick_free_port

logger = get_logger(__name__)


@dataclass
class FakeEngineConfig:
    instance_type: InstanceType = InstanceType.MIX
    models: list[str] = field(default_factory=lambda: ["fake-model"])
    reply_text: str = "Hello from the fake engine!"
    chunk_size: int = 4          # characters per Generations delta
    delay_s: float = 0.0         # inter-delta delay
    heartbeat_interval_s: float = 0.5
    lease_ttl_s: float = 1.0
    block_size: int = 128
    emit_kv_events: bool = True
    host: str = "127.0.0.1"
    # Advertised port (0 = pick a free one). The autoscaler's local
    # actuator passes an explicit port so the instance NAME (host:port)
    # is known to the launcher before the process registers.
    port: int = 0
    # Deterministic capacity model for overload/scaling drills and
    # benches (replaces the old blocking-accept hack): accepts land in a
    # bounded queue and a dispatcher thread starts one generation per
    # 1/service_rate_rps seconds — the engine serves EXACTLY that rate
    # under backlog, so adding instances genuinely adds fleet
    # throughput and overload drills are reproducible. 0 = unlimited
    # (generations start immediately, the hermetic-test default).
    service_rate_rps: float = 0.0
    # Accept-queue bound (only with a service rate); a full queue 503s
    # the accept — the dispatch-failure path upstream. 0 = unbounded.
    accept_queue_limit: int = 0
    # Simulated prefill latency: sleep before the FIRST delta of each
    # generation (delay_s paces the deltas after it). Gives overload
    # benches a realistic TTFT floor so queueing delay can be measured
    # as a ratio against it.
    first_delta_delay_s: float = 0.0
    # Telemetry wiring (wire-contract mirror of
    # AgentConfig.telemetry_mode): "owner" routes heartbeats to the
    # rendezvous telemetry owner (deltas stay direct — the hermetic-test
    # default, identical delta wire to before); "mux" multiplexes
    # heartbeats AND deltas as tagged frames on one keepalive session to
    # the owner (the bench's O(engines) connection mode); "master" keeps
    # the legacy elected-master heartbeat funnel.
    telemetry_mode: str = "owner"
    # Coordination-plane static stability (mirror of
    # AgentConfig.degraded_mode): "on" keeps heartbeats flowing to the
    # last-known-good telemetry owner / elected master while the
    # coordination plane is unreachable (owner resolution comes back
    # empty); "off" restores the legacy collapse — no owner, no beats —
    # which is the outage bench's control leg.
    degraded_mode: str = "on"
    # Topology placement coordinate (mirror of AgentConfig.slice_id/
    # topo_host/topo_chip; common/topology.py). A non-empty topo_host
    # marks this instance PLACED; empty keeps the legacy synthetic
    # per-host coordinate, so existing tests/benches see zero change.
    slice_id: str = "fake-slice"
    topo_host: str = ""
    topo_chip: int = -1
    # Modeled PD KV-handoff: when > 0 and a dispatch routes decode to a
    # DIFFERENT instance, the prefill side sleeps
    # transfer_cost(bytes_per_token * prompt_tokens, link) before the
    # first delta — the link class derived from the two instances'
    # registered coordinates, the budgets below standing in for the real
    # agent's BandwidthAccountant pacing. This is what makes the topo
    # bench handoff-bandwidth-bound without real KV payloads.
    kv_handoff_bytes_per_token: int = 0
    ici_bytes_per_s: float = 0.0
    dcn_bytes_per_s: float = 0.0


class FakeEngine:
    #: Max deltas coalesced into one Generations POST (mirrors the real
    #: agent's flush-window batching).
    _PUSH_BATCH = 8

    def __init__(self, coord: CoordinationClient,
                 config: Optional[FakeEngineConfig] = None):
        self.coord = coord
        self.cfg = config or FakeEngineConfig()
        self.port = self.cfg.port or pick_free_port(self.cfg.host)
        self.name = f"{self.cfg.host}:{self.port}"
        self.incarnation_id = uuid.uuid4().hex[:12]
        self.instance_type = self.cfg.instance_type
        self.links: list[str] = []
        self.unlinks: list[str] = []
        self.cancelled: set[str] = set()
        self.accepted_requests: list[dict[str, Any]] = []
        # Raw dispatch wire as received: (content_type, body bytes) per
        # accepted request — the msgpack-failover chaos drill asserts the
        # replayed binary payload is byte-equivalent to first dispatch.
        self.accepted_wire: list[tuple[str, bytes]] = []
        # Trace-propagation headers (x-xllm-*) seen on accepted requests —
        # lets tests assert the RPC channel stamps them on the wire.
        self.accepted_trace_headers: list[dict[str, str]] = []
        self.healthy = True
        self._alive = True
        self._paused = False
        # Accept/stop log for overload drills: (reason, sid) rows —
        # reason in {"deadline", "cancel", "stopped", "overload"} — so
        # tests can assert WHY token production stopped (e.g. a
        # mid-decode deadline expiry stops the engine within one pump
        # interval) without scraping logs.
        self.stop_log: list[tuple[str, str]] = []
        self.rejected_overload = 0
        # Deterministic capacity model (service_rate_rps > 0): accepts
        # queue here; the dispatcher thread starts one generation per
        # 1/rate seconds.
        self._svc_queue: Optional[queue.Queue] = None
        self._svc_thread: Optional[threading.Thread] = None
        if self.cfg.service_rate_rps > 0:
            self._svc_queue = queue.Queue(
                maxsize=max(0, self.cfg.accept_queue_limit))
        # Graceful drain (wire-contract mirror of EngineAgent.drain):
        # draining engines advertise the flag, reject new accepts, and
        # self-stop once the active generation count hits zero.
        self.draining = False
        self._active_lock = make_lock("fake_engine.active", order=66)  # lock-order: 66
        self._active_gens = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._runner: Optional[web.AppRunner] = None
        self._thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stored_hashes: list[str] = []
        self._pending_kv_stored: list[str] = []
        self._kv_lock = make_lock("fake_engine.kv_events", order=64)  # lock-order: 64
        # Heartbeat wire: msgpack w/ raw KV keys; demoted on legacy
        # master, re-probed when the master address changes.
        self._hb_wire = wire.WIRE_MSGPACK
        self._hb_master = ""
        # ONE shared, bounded keepalive session for every telemetry hop
        # (heartbeats + Generations pushes): a fresh TCP connect per
        # delta would charge connection setup to the master+wire span in
        # every bench, and per-master pools would make fan-out
        # O(engines × masters). The session's pool is thread-safe.
        self._push_session = make_keepalive_session(pool_connections=4,
                                                    pool_maxsize=8)
        # Rendezvous owner resolution for the sharded telemetry plane
        # (mirrors the real agent).
        self.telemetry_owner = TelemetryOwnerResolver(
            coord, self.name,
            hold_last_owner=self.cfg.degraded_mode != "off")
        self._telemetry_mode = self.cfg.telemetry_mode
        # Last master address that resolved ("master" funnel mode): the
        # degraded-mode fallback target while the plane is unreachable.
        self._last_master = ""
        self.mux_sends = 0
        self.direct_sends = 0
        # Modeled PD KV-handoff bookkeeping (topo bench evidence): per
        # completed handoff (link, modeled_seconds). Appended from
        # generation threads, read by /admin/topology — deque appends
        # are atomic and the reader copies.
        self.handoff_log: deque[tuple[str, float]] = deque(maxlen=4096)
        # Peer-name -> effective Coord, resolved once from coordination
        # (bench fleets are static; a missing peer is retried on the
        # next handoff, not cached).
        self._peer_coords: dict[str, topo.Coord] = {}

    # ------------------------------------------------------------ lifecycle
    def start(self, register: bool = True) -> "FakeEngine":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"fake-engine-{self.port}")
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("fake engine failed to start")
        if register:
            self.register()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True,
                                           name=f"fake-hb-{self.port}")
        self._hb_thread.start()
        if self._svc_queue is not None:
            self._svc_thread = threading.Thread(
                target=self._service_loop, daemon=True,
                name=f"fake-svc-{self.port}")
            self._svc_thread.start()
        return self

    def meta(self) -> InstanceMetaInfo:
        return InstanceMetaInfo(
            name=self.name, rpc_address=self.name, type=self.instance_type,
            draining=self.draining,
            dp_size=1,
            topology=TpuTopology(slice_id=self.cfg.slice_id,
                                 host=self.cfg.topo_host,
                                 chip=self.cfg.topo_chip,
                                 mesh_shape=[1],
                                 axis_names=["data"],
                                 host_addrs=[self.name]),
            incarnation_id=self.incarnation_id,
            register_ts_ms=int(time.time() * 1000),
            models=list(self.cfg.models),
            ttft_profiling_data=[[128, 10.0], [512, 30.0], [2048, 100.0]],
            tpot_profiling_data=[[1, 100, 5.0], [8, 1000, 10.0],
                                 [32, 8000, 20.0]],
            # Wire-contract reference impl: accepts the binary dispatch
            # wire, like the real agent.
            wire_formats=[wire.WIRE_MSGPACK, wire.WIRE_JSON],
        )

    def register(self) -> None:
        self.coord.set(instance_key(self.instance_type.value, self.name),
                       self.meta().to_json(), ttl_s=self.cfg.lease_ttl_s)

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        app = web.Application()
        app.router.add_post("/v1/completions", self._h_completion)
        app.router.add_post("/v1/chat/completions", self._h_chat)
        app.router.add_get("/v1/models", self._h_models)
        app.router.add_get("/health", self._h_health)
        # Minimal engine /metrics (wire-contract reference: the fleet
        # scrape — /metrics/fleet on any frontend — collects every
        # engine's exposition and re-labels it by instance/role).
        app.router.add_get("/metrics", self._h_metrics)
        app.router.add_post("/rpc/link", self._h_link)
        app.router.add_post("/rpc/unlink", self._h_unlink)
        app.router.add_post("/rpc/cancel", self._h_cancel)
        app.router.add_post("/rpc/flip_role", self._h_flip)
        app.router.add_post("/rpc/drain", self._h_drain)
        # Same per-process trace surface the real agent serves — useful
        # when the fake engine runs out-of-process (``main`` below).
        app.router.add_get("/admin/topology", self._h_topology)
        app.router.add_get("/admin/trace", self._h_trace)
        app.router.add_get("/admin/trace/recent", self._h_trace_recent)
        app.router.add_get("/admin/profile", self._h_profile)

        async def _start():
            self._runner = web.AppRunner(app)
            await self._runner.setup()
            site = web.TCPSite(self._runner, self.cfg.host, self.port)
            await site.start()

        self._loop.run_until_complete(_start())
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.run_until_complete(self._runner.cleanup())
            self._loop.close()

    # ------------------------------------------------------- failure drills
    def pause(self) -> None:
        """Stop heartbeats + let the lease lapse (process-hang simulation)."""
        self._paused = True
        self.coord.release(instance_key(self.instance_type.value, self.name))

    def resume(self) -> None:
        self._paused = False
        self.register()

    def set_unhealthy(self) -> None:
        self.healthy = False

    def kill(self) -> None:
        """Hard death: lease lapses, health probe fails, no heartbeats."""
        self._alive = False
        self._paused = True
        self.healthy = False
        self.coord.release(instance_key(self.instance_type.value, self.name))
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)

    def stop(self) -> None:
        self._alive = False
        self._paused = True
        self.coord.rm(instance_key(self.instance_type.value, self.name))
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._push_session.close()

    # ---------------------------------------------------------- heartbeats
    def _heartbeat_loop(self) -> None:
        while self._alive:
            time.sleep(self.cfg.heartbeat_interval_s)
            if self._paused or not self._alive:
                continue
            rule = FAULTS.fire("engine.heartbeat", instance=self.name)
            if rule is not None and rule.action in ("silence", "drop"):
                # Full silence (process-hang model): no heartbeat AND the
                # lease stops being refreshed, so the master's three-state
                # detector walks DELETE → probe → LEASE_LOST/SUSPECT.
                self.coord.release(
                    instance_key(self.instance_type.value, self.name))
                continue
            self.register()  # refresh registration (lease keepalive path)
            # Sharded telemetry: beats route to the OWNING
            # master under the rendezvous shard map; "master" mode keeps
            # the legacy elected-master funnel.
            if self._telemetry_mode == "master":
                target = self.coord.get("XLLM:SERVICE:MASTER") or ""
                if target:
                    self._last_master = target
                elif self.cfg.degraded_mode != "off":
                    # Static stability: an unreachable plane resolves no
                    # master — keep beating at the last one that did
                    # (the owner path holds inside the resolver).
                    target = self._last_master
            else:
                target = self.telemetry_owner()
            if not target:
                continue
            with self._kv_lock:
                stored = self._pending_kv_stored
                self._pending_kv_stored = []
            # Wire-contract reference: heartbeats ride msgpack with raw
            # 16-byte KV-event keys (mirror of EngineAgent._heartbeat_loop,
            # including the legacy-master JSON demotion).
            ev = KvCacheEvent(stored=stored)
            payload = {
                "name": self.name,
                "incarnation_id": self.incarnation_id,
                "load_metrics": {
                    # Capacity-model backlog (0 without a service rate):
                    # the planner's pressure heuristic and scale-in
                    # victim picks read the waiting depth.
                    "waiting_requests_num":
                        self._svc_queue.qsize()
                        if self._svc_queue is not None else 0,
                    # Live streams, not the accept log: drain-completion
                    # checks and scale-in victim picks read this.
                    "running_requests_num": self._active_gens,
                    "hbm_cache_usage_perc": 0.1,
                },
                "latency_metrics": {"recent_max_ttft": 12.0,
                                    "recent_max_tbt": 4.0},
            }
            if not self._post_heartbeat(target, payload, ev):
                # Owner died mid-heartbeat-stream: exclude it and hand
                # THIS beat to the rendezvous successor now — the
                # takeover drill asserts no SUSPECT transit, which a
                # full-interval gap could trip.
                self.telemetry_owner.note_failure(target)
                successor = self.telemetry_owner() \
                    if self._telemetry_mode != "master" else ""
                if successor and successor != target:
                    self._post_heartbeat(successor, payload, ev)

    def _post_heartbeat(self, target: str, payload: dict, ev) -> bool:
        """One heartbeat delivery (mux = tagged telemetry frame on the
        shared session; otherwise the legacy wire with msgpack->JSON
        demotion per master)."""
        try:
            if target != self._hb_master:
                self._hb_master = target
                self._hb_wire = wire.WIRE_MSGPACK
            if self._telemetry_mode == "mux":
                payload = dict(payload)
                payload["kv_cache_event"] = ev.to_wire_dict()
                body, ctype = wire.encode_telemetry(
                    [{"t": wire.TELEMETRY_HB, "d": payload}])
                r = self._push_session.post(
                    f"http://{target}/rpc/telemetry", data=body,
                    headers={"Content-Type": ctype}, timeout=2)
                if r.status_code not in (404, 405):
                    if r.status_code == 200:
                        self._adopt_owner_hint(r, target)
                        return True
                    return False
                # Legacy (pre-sharding) master: only the ELECTED master
                # uploads load metrics there, so fall back to the full
                # reference funnel, not just per-endpoint wires.
                self._telemetry_mode = "master"
            fmt = self._hb_wire
            payload = dict(payload)
            payload["kv_cache_event"] = (
                ev.to_wire_dict() if fmt == wire.WIRE_MSGPACK
                else ev.to_dict())
            body, ctype = wire.encode_dispatch(payload, fmt)
            r = self._push_session.post(f"http://{target}/rpc/heartbeat",
                                        data=body,
                                        headers={"Content-Type": ctype},
                                        timeout=2)
            if r.status_code in (400, 415) \
                    and fmt == wire.WIRE_MSGPACK:
                self._hb_wire = wire.WIRE_JSON
                payload["kv_cache_event"] = ev.to_dict()
                body, ctype = wire.encode_dispatch(payload,
                                                   wire.WIRE_JSON)
                r = self._push_session.post(
                    f"http://{target}/rpc/heartbeat", data=body,
                    headers={"Content-Type": ctype}, timeout=2)
            if r.status_code == 200:
                self._adopt_owner_hint(r, target)
                return True
            return False
        except ChannelError:
            return False

    def _adopt_owner_hint(self, r, target: str) -> None:
        """Adopt the receiving master's `owner` hint (its shard-map view
        is fresher than our mirrored membership on a race) so the NEXT
        beat re-routes without waiting a resolver cache window out."""
        if self._telemetry_mode == "master":
            return
        try:
            owner = (r.json() or {}).get("owner", "")
        except ValueError:
            return
        if owner and owner != target:
            self.telemetry_owner.pin(owner)

    # ------------------------------------------------------------ handlers
    async def _h_health(self, req: web.Request) -> web.Response:
        if not self.healthy:
            return web.Response(status=503, text="unhealthy")
        return web.json_response({"status": "ok"})

    async def _h_models(self, req: web.Request) -> web.Response:
        return web.json_response({"object": "list", "data": [
            {"id": m, "object": "model"} for m in self.cfg.models]})

    async def _h_trace(self, req: web.Request) -> web.Response:
        return web.reply(*admin_trace(req.query))

    async def _h_trace_recent(self, req: web.Request) -> web.Response:
        return web.reply(*admin_trace_recent(req.query))

    async def _h_profile(self, req: web.Request) -> web.Response:
        return web.reply(*admin_profile(req.query))

    async def _h_metrics(self, req: web.Request) -> web.Response:
        conn = self._push_session.stats()
        lines = [
            "# TYPE engine_running_requests gauge",
            f"engine_running_requests {len(self.accepted_requests)}",
            "# TYPE engine_cached_prefix_blocks gauge",
            f"engine_cached_prefix_blocks {len(self._stored_hashes)}",
            # Multiplexed-session fan-out evidence: distinct master pools + TCP connects this engine ever made
            # on its one telemetry session, plus the mux/direct split.
            "# TYPE engine_telemetry_session_hosts gauge",
            f"engine_telemetry_session_hosts {conn['hosts']}",
            "# TYPE engine_telemetry_connections_created counter",
            f"engine_telemetry_connections_created "
            f"{conn['connections_created']}",
            "# TYPE engine_telemetry_mux_sends_total counter",
            f"engine_telemetry_mux_sends_total {self.mux_sends}",
            "# TYPE engine_telemetry_direct_sends_total counter",
            f"engine_telemetry_direct_sends_total {self.direct_sends}",
        ]
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain")

    async def _h_link(self, req: web.Request) -> web.Response:
        body = await req.json()
        self.links.append(body.get("peer", {}).get("name", ""))
        return web.json_response({"ok": True})

    async def _h_unlink(self, req: web.Request) -> web.Response:
        body = await req.json()
        self.unlinks.append(body.get("peer_name", ""))
        return web.json_response({"ok": True})

    async def _h_cancel(self, req: web.Request) -> web.Response:
        body = await req.json()
        self.cancelled.add(body.get("service_request_id", ""))
        return web.json_response({"ok": True})

    async def _h_flip(self, req: web.Request) -> web.Response:
        body = await req.json()
        self.instance_type = InstanceType.parse(body.get("type"))
        return web.json_response({"ok": True})

    async def _h_drain(self, req: web.Request) -> web.Response:
        """Graceful retirement (mirror of EngineAgent.drain, on the
        wire-contract reference impl): advertise `draining` on the next
        registration refresh, reject new accepts, and self-stop once the
        in-flight generations finish — the master's lease-lapse handler
        then deregisters the instance as cleanly drained."""
        if not self.draining:
            self.draining = True
            # register() is a blocking coordination write — it runs on
            # the drain thread, never this event loop.
            threading.Thread(target=self._drain_then_stop,
                             name=f"fake-drain-{self.port}",
                             daemon=True).start()
        return web.json_response({"ok": True, "draining": True})

    def _drain_then_stop(self, timeout_s: float = 60.0) -> None:
        self.register()   # advertise draining now, not at the next beat
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._active_lock:
                idle = self._active_gens == 0
            if idle:
                break
            time.sleep(0.05)
        self.stop()


    async def _h_completion(self, req: web.Request) -> web.Response:
        return await self._accept(req, chat=False)

    async def _h_chat(self, req: web.Request) -> web.Response:
        return await self._accept(req, chat=True)

    async def _accept(self, req: web.Request, chat: bool) -> web.Response:
        raw = await req.read()
        try:
            body = wire.decode_body(req.content_type, raw)
        except ValueError:
            return web.json_response({"error": "invalid request body"},
                                     status=400)
        if self.draining:
            # A draining engine takes no new work; a request that raced
            # the drain (routed from a pre-drain snapshot) fails over to
            # a surviving instance via the 503 dispatch-failure path.
            return web.json_response({"error": "draining"}, status=503)
        self.accepted_wire.append((req.content_type or "", raw))
        self.accepted_trace_headers.append(
            {k.lower(): v for k, v in req.headers.items()
             if k.lower().startswith("x-xllm-")})
        # Header fallback: a control-plane forward (EngineChannel) carries
        # the sender's active span as x-xllm-* headers; the enriched body
        # key wins when both are present.
        if "trace_context" not in body:
            hctx = TraceContext.from_headers(req.headers)
            if hctx is not None:
                body["trace_context"] = hctx.to_dict()
        # A delay rule here deliberately stalls the engine's loop (accepts
        # serialize behind it): a test double's model of a stuck engine.
        rule = FAULTS.fire("engine.accept", instance=self.name,  # xlint: allow-async-blocking(test double: a delay rule on engine.accept deliberately models a stalled engine loop, serialized accepts included)
                           sid=body.get("service_request_id", ""))
        if rule is not None and rule.action == "error":
            return web.Response(status=503, text="fault injected")
        self.accepted_requests.append(body)
        sid = body.get("service_request_id", "")
        # A (re)dispatch supersedes any earlier cancellation of the same
        # request (failover replays may land after a best-effort cancel).
        self.cancelled.discard(sid)
        source = body.get("source_service_addr", "")
        token_ids = body.get("token_ids", [])
        if rule is not None and rule.action == "drop":
            # Accept then swallow: the request hangs until the service
            # times it out or fails it over.
            return web.json_response({"ok": True})
        if self.cfg.emit_kv_events and token_ids:
            with self._kv_lock:
                self._pending_kv_stored.extend(
                    prefix_block_hash_hexes(token_ids, self.cfg.block_size))
        # Already past its deadline on arrival (queued upstream too
        # long): ack with 504 instead of burning service slots — the
        # master's dispatch-failure path surfaces it as non-retryable.
        if deadline_expired(int(body.get("deadline_ms") or 0)):
            self.stop_log.append(("deadline", sid))
            return web.json_response({"error": "deadline exceeded"},
                                     status=504)
        if self._svc_queue is not None:
            # Deterministic capacity model: enqueue for the dispatcher
            # (one generation starts per 1/service_rate_rps s); a full
            # queue is the engine saying "overloaded" — a fast 503 the
            # upstream admission/failover layers handle.
            try:
                self._svc_queue.put_nowait((sid, source, body))
            except queue.Full:
                self.rejected_overload += 1
                self.stop_log.append(("overload", sid))
                return web.json_response(
                    {"error": "engine accept queue full"}, status=503)
            return web.json_response({"ok": True, "queued": True})
        # Fire-and-forget: accept now, stream Generations from a thread.
        threading.Thread(target=self._generate, daemon=True,
                         args=(sid, source, body)).start()
        return web.json_response({"ok": True})

    def _service_loop(self) -> None:
        """Dispatcher for the capacity model: starts at most one
        accepted generation per 1/service_rate_rps seconds (token-bucket
        pacing — an idle engine dispatches immediately with NO added
        latency; under backlog dispatches are spaced exactly one
        interval apart, so the engine serves EXACTLY its configured
        rate, fleet capacity is additive, and overload drills
        reproduce)."""
        interval = 1.0 / self.cfg.service_rate_rps
        next_at = 0.0
        while self._alive:
            try:
                sid, source, body = self._svc_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            now = time.monotonic()
            if next_at > now:
                time.sleep(next_at - now)
                now = time.monotonic()
            threading.Thread(target=self._generate, daemon=True,
                             args=(sid, source, body)).start()
            next_at = max(next_at, now) + interval

    def _push_gens_mux(self, session: KeepaliveSession, owner: str,
                       dest: str, gens: list) -> Optional[bool]:
        """One tagged-frame push via the owning master (every delta
        batch here belongs to one request/dest pair — the fake engine
        flushes per generation thread). True/False = the dest's alive
        verdict for this request; None = owner unreachable or relay
        failed (caller excludes the owner and falls back direct)."""
        sid = gens[0].get("service_request_id", "") if gens else ""
        body, ctype = wire.encode_telemetry(
            [{"t": wire.TELEMETRY_GENS, "dest": dest,
              "d": {"gens": gens}}])
        try:
            r = session.post(f"http://{owner}/rpc/telemetry", data=body,
                             headers={"Content-Type": ctype}, timeout=5)
            if r.status_code in (404, 405):
                self._telemetry_mode = "owner"   # legacy master
                return None
            if r.status_code >= 400:
                raise ChannelError(f"HTTP {r.status_code}")
            payload = r.json()
        except (ChannelError, ValueError) as e:
            logger.warning("fake engine: mux gens push via %s failed: %s",
                           owner, e)
            return None
        self.mux_sends += 1
        dest_ok = payload.get("dest_ok") or {}
        if not dest_ok.get(dest, False):
            return None   # relay to the dest failed; retry direct
        return bool((payload.get("alive") or {}).get(sid, True))

    # ----------------------------------------------------------- generation
    def _generate(self, sid: str, source: str, body: dict[str, Any]) -> None:
        # Active-generation accounting gates the drain self-stop: a
        # draining engine only exits once every stream it accepted has
        # finished (or been cancelled).
        with self._active_lock:
            self._active_gens += 1
        try:
            self._generate_stream(sid, source, body)
        finally:
            with self._active_lock:
                self._active_gens -= 1

    # ------------------------------------------------- modeled KV handoff
    def own_coord(self) -> topo.Coord:
        return topo.effective_coord(
            TpuTopology(slice_id=self.cfg.slice_id, host=self.cfg.topo_host,
                        chip=self.cfg.topo_chip), self.name)

    _PEER_TYPE_ORDER = (InstanceType.DECODE, InstanceType.MIX,
                        InstanceType.DEFAULT, InstanceType.PREFILL,
                        InstanceType.ENCODE)

    def _resolve_coord(self, name: str) -> Optional[topo.Coord]:
        """Effective coordinate of a peer, from its coordination
        registration (cached — bench fleets are static; unresolvable
        peers are retried on the next handoff, not negatively cached)."""
        c = self._peer_coords.get(name)
        if c is not None:
            return c
        for t in self._PEER_TYPE_ORDER:
            try:
                raw = self.coord.get(instance_key(t.value, name))
            except Exception:  # noqa: BLE001  # xlint: allow-broad-except(plane outage = no coordinate; the handoff just goes unmodeled)
                return None
            if raw:
                try:
                    meta = InstanceMetaInfo.from_json(raw)
                except (ValueError, TypeError):
                    continue
                c = topo.effective_coord(meta.topology, name)
                self._peer_coords[name] = c
                return c
        return None

    def _modeled_handoff(self, body: dict[str, Any],
                         prompt_tokens: int) -> tuple[str, float]:
        """(link, modeled seconds) for this dispatch's prefill→decode KV
        handoff; ("", 0.0) when unmodeled (no bytes-per-token knob, no
        split PD pair, or peer coordinate unresolvable)."""
        bpt = self.cfg.kv_handoff_bytes_per_token
        decode_name = (body.get("routing") or {}).get("decode_name") or ""
        if bpt <= 0 or not decode_name or decode_name == self.name:
            return "", 0.0
        peer = self._resolve_coord(decode_name)
        if peer is None:
            return "", 0.0
        link = topo.link_class(self.own_coord(), peer)
        nbytes = bpt * max(1, prompt_tokens)
        return link, topo.transfer_cost(nbytes, link,
                                        self.cfg.ici_bytes_per_s,
                                        self.cfg.dcn_bytes_per_s)

    async def _h_topology(self, req: web.Request) -> web.Response:
        """Topo bench evidence: own coordinate + the modeled-handoff log
        (link class and modeled wire ms per completed handoff)."""
        mine = self.own_coord()
        rows = list(self.handoff_log)
        counts: dict[str, int] = {}
        for link, _s in rows:
            counts[link] = counts.get(link, 0) + 1
        return web.json_response({
            "name": self.name,
            "coord": {"slice_id": mine.slice_id, "host": mine.host,
                      "chip": mine.chip, "placed": mine.placed},
            "handoff_counts": counts,
            "handoffs": [{"link": link, "ms": s * 1000.0}
                         for link, s in rows],
        })

    def _generate_stream(self, sid: str, source: str,
                         body: dict[str, Any]) -> None:
        session = self._push_session
        text = self.cfg.reply_text
        max_tokens = int(body.get("max_tokens", 1 << 30))
        chunks = [text[i:i + self.cfg.chunk_size]
                  for i in range(0, len(text), self.cfg.chunk_size)]
        chunks = chunks[:max_tokens] or [""]
        n = len(chunks)
        # Failover resume: `resume_generated_token_ids` is the prefix the
        # client already received (the service appended it to token_ids);
        # continue the canned reply from the next token. Token ids stay
        # position-stable across the resume so a chaos drill can assert
        # the assembled sequence is byte-identical to a no-fault run.
        resume = list(body.get("resume_generated_token_ids") or ())
        start = min(len(resume), n)
        prompt_tokens = len(body.get("token_ids", [])) - len(resume)
        total_tokens = n
        seq = 0
        if start >= n:
            # Everything was already delivered before the failover: emit
            # just the terminal delta.
            chunks = chunks + [""]
            n += 1
        # Trace propagation: parent this engine's stage spans under the
        # carried context (the frontend root, or the scheduler's failover
        # span on a replayed dispatch). The MIX fake engine serves both
        # stages in one process, so the PD KV-handoff hop is modeled as a
        # zero-work span to keep traces shaped like the real pipeline.
        ctx = TraceContext.from_dict(body.get("trace_context"))
        # require_ctx: direct engine hits (no carried context) must not
        # root orphan single-span traces.
        span_kw: dict[str, Any] = dict(
            ctx=ctx, require_ctx=True, request_id=sid, instance=self.name,
            incarnation=self.incarnation_id)
        with TRACER.span("engine.prefill", prompt_tokens=prompt_tokens,
                         resumed_tokens=len(resume), **span_kw):
            pass
        # Modeled PD KV handoff (topo bench): when the dispatch routed
        # decode to a different instance, charge the link-classed wire
        # time for the prompt's KV payload before the first delta —
        # prefill→decode handoff gates TTFT exactly like the real
        # stream pull does.
        handoff_link, handoff_s = self._modeled_handoff(body, prompt_tokens)
        with TRACER.span("kv_transfer.offer", simulated=True,
                         link=handoff_link or "none",
                         modeled_ms=handoff_s * 1000.0, **span_kw):
            pass
        # Deltas are BATCHED per push like the real agent's streamer
        # (GenerationStreamer flush window): the first delta flushes
        # immediately (TTFT-critical), later ones coalesce up to
        # _PUSH_BATCH per POST. Fault semantics are preserved — tokens
        # emitted before a crash point are flushed BEFORE the kill, so
        # crash-after-N drills still deliver exactly N tokens.
        pending: list[dict[str, Any]] = []

        def flush() -> Optional[bool]:
            """POST pending deltas; True = delivered & request alive,
            False = service said stop, None = push failed. Mux mode
            rides the owner-routed telemetry session (one connection
            regardless of which master dispatched this request); owner
            failure falls back to the direct wire for THIS flush after
            excluding the dead owner."""
            if not pending:
                return True
            gens = list(pending)
            pending.clear()
            if self._telemetry_mode == "mux":
                owner = self.telemetry_owner()
                if owner:
                    verdict = self._push_gens_mux(session, owner, source,
                                                  gens)
                    if verdict is not None:
                        return verdict
                    self.telemetry_owner.note_failure(owner)
            data, ctype = wire.encode_dispatch(
                {"gens": gens}, wire.WIRE_MSGPACK)
            self.direct_sends += 1
            try:
                r = session.post(f"http://{source}/rpc/generations",
                                 data=data,
                                 headers={"Content-Type": ctype},
                                 timeout=5)
                return bool(r.json().get("alive", {}).get(sid, True))
            except (ChannelError, ValueError) as e:
                logger.warning("fake engine: generations push failed: %s", e)
                return None

        deadline_ms = int(body.get("deadline_ms") or 0)
        if self.cfg.first_delta_delay_s:
            time.sleep(self.cfg.first_delta_delay_s)   # simulated prefill
        if handoff_s > 0:
            time.sleep(handoff_s)                      # modeled KV handoff
            self.handoff_log.append((handoff_link, handoff_s))
        with TRACER.span("engine.decode", **span_kw) as dsp:
            for i in range(start, n):
                chunk = chunks[i]
                if sid in self.cancelled or not self._alive:
                    self.stop_log.append(("cancel", sid))
                    dsp.end("CANCELLED")
                    return
                if deadline_ms and now_ms() > deadline_ms:
                    # Deadline enforcement at the engine (overload
                    # plane): stop producing tokens within ONE pump
                    # interval of expiry — the service side 504s the
                    # client and cancels; this side just stops burning
                    # decode capacity. Tokens already pending are
                    # flushed (they were produced inside the budget).
                    flush()
                    self.stop_log.append(("deadline", sid))
                    dsp.end("DEADLINE")
                    return
                rule = FAULTS.fire("engine.token", instance=self.name,
                                   sid=sid, n=i)
                if rule is not None and rule.action == "crash":
                    logger.info("fault: engine %s crashing before token %d "
                                "of %s", self.name, i, sid)
                    flush()   # tokens before the crash point were emitted
                    dsp.end("CRASHED")
                    self.kill()
                    return
                if rule is not None and rule.action == "delay":
                    alive = flush()
                    if alive is False:
                        dsp.end("STOPPED")
                        return
                    if alive is None:
                        dsp.end("PUSH_FAILED")
                        return
                    time.sleep(rule.delay_s)
                last = i == n - 1
                seq += 1
                gen: dict[str, Any] = {
                    "request_id": body.get("request_id", sid),
                    "service_request_id": sid,
                    "status": {"code": 0, "message": ""},
                    "outputs": [{"index": 0, "text": chunk,
                                 "token_ids": [i] if i < total_tokens else [],
                                 "finish_reason": "stop" if last else "",
                                 "logprobs": []}],
                    "finished": last,
                    "delta_seq": seq,
                    "instance": self.name,
                    "incarnation": self.incarnation_id,
                }
                if last:
                    gen["usage"] = {"num_prompt_tokens": prompt_tokens,
                                    "num_generated_tokens": total_tokens}
                pending.append(gen)
                # First delta (TTFT) and terminal delta flush immediately;
                # a configured inter-delta delay means per-delta pushes
                # (timing-sensitive drills); otherwise coalesce.
                if last or i == start or self.cfg.delay_s \
                        or len(pending) >= self._PUSH_BATCH:
                    alive = flush()
                    if alive is False:
                        self.stop_log.append(("stopped", sid))
                        dsp.end("STOPPED")
                        return  # service told us to stop
                    if alive is None:
                        dsp.end("PUSH_FAILED")
                        return
                if self.cfg.delay_s and not last:
                    time.sleep(self.cfg.delay_s)
            dsp.set(generated_tokens=total_tokens - start)


def main() -> None:
    p = argparse.ArgumentParser(
        description="a fake engine registered with a coordination server")
    p.add_argument("--coordination-addr", default="127.0.0.1:12379")
    p.add_argument("--type", default="MIX",
                   choices=[t.value for t in InstanceType])
    p.add_argument("--reply", default="Hello from the fake engine!")
    p.add_argument("--model", default="fake-model")
    p.add_argument("--chunk-size", type=int, default=4,
                   help="characters per Generations delta")
    p.add_argument("--delay", type=float, default=0.0,
                   help="inter-delta delay in seconds (0 = instant; the "
                        "hot-path bench uses 0 so client TTFT isolates "
                        "the master+wire span)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="advertised port (0 = pick free; the autoscaler's "
                        "local actuator passes one so the instance name is "
                        "known at launch)")
    p.add_argument("--service-rate", type=float, default=0.0,
                   help="deterministic capacity model: serve at most "
                        "this many generations per second (0 = "
                        "unlimited); the overload/autoscaling benches' "
                        "per-engine capacity knob")
    p.add_argument("--accept-queue", type=int, default=0,
                   help="bounded accept queue in front of the service "
                        "rate (0 = unbounded); a full queue 503s")
    p.add_argument("--first-delta-delay", type=float, default=0.0,
                   help="simulated prefill latency: sleep before the "
                        "first delta of each generation")
    p.add_argument("--accept-delay", type=float, default=0.0,
                   help="DEPRECATED alias: mapped to "
                        "--service-rate 1/delay (the old blocking-"
                        "accept hack is gone)")
    p.add_argument("--heartbeat-interval", type=float, default=0.5)
    p.add_argument("--lease-ttl", type=float, default=1.0)
    p.add_argument("--telemetry-mode", default="owner",
                   choices=["owner", "mux", "master"],
                   help="owner = heartbeats to the rendezvous telemetry "
                        "owner (deltas direct); mux = heartbeats AND "
                        "deltas multiplexed on one keepalive session to "
                        "the owner; master = legacy elected-master "
                        "heartbeat funnel (the ingest-sharding bench "
                        "baseline)")
    p.add_argument("--degraded-mode", default="on", choices=["on", "off"],
                   help="on = keep heartbeats flowing to the last-known-"
                        "good master while the coordination plane is "
                        "unreachable (static stability); off = legacy "
                        "behavior (no resolvable target, no beats — the "
                        "outage bench's control leg)")
    p.add_argument("--slice-id", default="fake-slice",
                   help="TPU slice/pod coordinate; same-slice PD handoffs "
                        "are ICI-classed, cross-slice DCN "
                        "(docs/topology.md)")
    p.add_argument("--topo-host", default="",
                   help="physical host coordinate; non-empty marks this "
                        "instance PLACED for topology-aware routing "
                        "('' = legacy flat behavior)")
    p.add_argument("--topo-chip", type=int, default=-1,
                   help="chip index within --topo-host (-1 = unpinned)")
    p.add_argument("--kv-handoff-bytes-per-token", type=int, default=0,
                   help="modeled PD KV payload per prompt token: split-"
                        "pair dispatches sleep the link-classed wire "
                        "time before the first delta (0 = no modeled "
                        "handoff — the topo bench's load-bearing knob)")
    p.add_argument("--ici-bytes-per-s", type=float, default=0.0,
                   help="modeled ICI bandwidth for the handoff sleep "
                        "(0 = class default)")
    p.add_argument("--dcn-bytes-per-s", type=float, default=0.0,
                   help="modeled DCN bandwidth for the handoff sleep "
                        "(0 = class default)")
    args = p.parse_args()

    rate = max(0.0, args.service_rate)
    if not rate and args.accept_delay > 0:
        rate = 1.0 / args.accept_delay
    from ..coordination import connect

    coord = connect(args.coordination_addr)
    engine = FakeEngine(coord, FakeEngineConfig(
        instance_type=InstanceType.parse(args.type),
        models=[args.model], reply_text=args.reply,
        chunk_size=max(1, args.chunk_size), delay_s=max(0.0, args.delay),
        host=args.host, port=max(0, args.port),
        service_rate_rps=rate,
        accept_queue_limit=max(0, args.accept_queue),
        first_delta_delay_s=max(0.0, args.first_delta_delay),
        heartbeat_interval_s=max(0.05, args.heartbeat_interval),
        lease_ttl_s=max(0.2, args.lease_ttl),
        telemetry_mode=args.telemetry_mode,
        degraded_mode=args.degraded_mode,
        slice_id=args.slice_id,
        topo_host=args.topo_host,
        topo_chip=args.topo_chip,
        kv_handoff_bytes_per_token=max(0, args.kv_handoff_bytes_per_token),
        ici_bytes_per_s=max(0.0, args.ici_bytes_per_s),
        dcn_bytes_per_s=max(0.0, args.dcn_bytes_per_s))
    ).start()
    print(f"fake engine {engine.name} ({args.type}) registered; Ctrl-C to stop",
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    engine.stop()
    coord.close()


if __name__ == "__main__":
    main()
