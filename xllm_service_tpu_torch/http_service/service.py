"""OpenAI-compatible HTTP frontend + engine-facing RPC endpoints (port of
``xllm_service_tpu/http_service/service.py`` on the standard library's
``asyncio``: ``http_service/web.py`` serves both applications, and engine
dispatches run on a thread pool over the keep-alive session of
``rpc/channel.py``).

Several active masters serve one fleet: a request this frontend accepts
but another owns is relayed to its owner's ``/rpc/handoff`` on the
asyncio client of ``http_service/client.py`` (``multimaster/handoff.py``),
a relay's client abort reaches ``/rpc/handoff_abort``, and a replica's
PD-role flip hints reach the elected master's ``/rpc/flip_hint``.

The admin and fleet surface is the reference's: ``/admin/config`` (GET
and POST), ``/admin/planner``, ``/admin/autoscaler`` (the controller's
decision log), ``/admin/coordination``, ``/admin/overload``,
``/admin/hotpath``, ``/admin/faults`` (GET and POST), ``/admin/slo``,
``/admin/flightrecorder/recent``, and ``/admin/trace``,
``/admin/trace/recent``, ``/admin/profile`` and ``/metrics/fleet``, whose
``?scope=fleet`` (always, for ``/metrics/fleet``) fans out on the same
asyncio client to every agent and peer frontend and merges. The RPC app
serves the local scope of ``/metrics``, the trace routes and the profile,
and never honours ``scope=fleet``: a peer's fan-out ends at one hop.

Parity: reference `http_service/service.cpp` (SURVEY.md §2.2, §3.2) and
`rpc_service/service.cpp` (§2.3, §3.3):

HTTP app (client-facing, reference routes in `master.cpp:71-76`):
- POST /v1/completions, /v1/chat/completions — parse body → Request with
  service id `method-threadid-shortuuid` → `Scheduler::schedule` → forward
  the **enriched** body (service_request_id, source_service_addr, token_ids,
  routing) to the chosen prefill instance fire-and-forget
  (`service.cpp:222-260,407-415,485-493`) → stream SSE back as Generations
  arrive.
- GET /v1/models — proxied/aggregated from instance metadata
  (`service.cpp:317-357`).
- POST /v1/embeddings — "not support" (`service.cpp:500-517`).
- GET /metrics — Prometheus text (reference leaves this TODO-empty,
  `service.cpp:526-532`; we implement it).
- GET /hello, GET /health.

RPC app (engine-facing, reference `XllmRpcService`):
- POST /rpc/heartbeat → `Scheduler::handle_instance_heartbeat`.
- POST /rpc/generations → batched deltas → `Scheduler::handle_generation`
  (`rpc_service/service.cpp:149-215`).
- GET /rpc/hello, /rpc/instance_info, /rpc/static_prefill_list,
  /rpc/static_decode_list (P/D peer discovery for engines).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from ..common import hashing
from ..common import native as _native
from ..common.faults import FAULTS
from ..common.flightrecorder import RECORDER, admin_flightrecorder_recent
from ..common.hotpath import CPU_ATTR, HOTPATH
from ..common.metrics import (
    ADMISSION_PENDING_REQUESTS,
    AUTOSCALER_LAST_DECISION_AGE_SECONDS,
    BROWNOUT_ACTIVE,
    FLEET_SIZE,
    HANDOFF_JOURNAL_REPLAYS_TOTAL,
    HANDOFF_SERVED_TOTAL,
    KVCACHE_FRAME_LOG_SEQ,
    LOADINFO_AGE_SECONDS,
    LOADINFO_MAX_AGE_SECONDS,
    LOADINFO_STALE_INSTANCES,
    REGISTRY,
    REQUESTS_CANCELLED_TOTAL,
    RETRY_BUDGET_TOKENS,
    ROUTING_SNAPSHOT_AGE_SECONDS,
    SERVER_REQUEST_IN_TOTAL,
    TELEMETRY_GENS_RELAYED_TOTAL,
    relabel_prometheus_text,
)
from ..common.request import Request, RequestOutput, SamplingParams
from ..common.slo import SLO_MONITOR
from ..common.tracing import (
    TRACER,
    TraceContext,
    admin_trace,
    admin_trace_recent,
    merge_fleet_spans,
    span_tree,
)
from ..common.types import InstanceType
from ..multimaster.handoff import DeltaJournal, HandoffRelay
from ..overload import (
    ADMISSION,
    BROWNOUT,
    RETRY_BUDGET,
    deadline_expired,
    parse_deadline_ms,
    parse_priority,
)
from ..overload.deadline import ABS_DEADLINE_HEADER, remaining_ms
from ..profiling import (
    PROFILER,
    admin_profile,
    aggregate_critical_paths,
    critical_path,
    parse_folded,
    summarize_stacks,
)
from ..rpc import wire
from ..rpc.channel import ChannelError, make_keepalive_session
from ..scheduler.scheduler import Scheduler
from ..utils import generate_service_request_id, get_logger, short_uuid
from . import web
from .client import ClientError, ClientSession, ClientTimeout
from .connection import AioConnection
from .request_tracer import RequestTracer

logger = get_logger(__name__)

# Preserialized SSE frame pieces: the emit loop is per-delta hot, so the
# constant bytes are built once, and delta JSON uses compact separators
# (identical parse, fewer bytes, faster dumps).
_DATA_PREFIX = b"data: "
_FRAME_SEP = b"\n\n"
_DONE_FRAME = b"data: [DONE]\n\n"
_COMPACT = (",", ":")


def _num(body: dict[str, Any], key: str, default, cast):
    """OpenAI clients serialize unset optionals as explicit null; treat null
    as default instead of crashing in int()/float()."""
    v = body.get(key)
    return cast(v) if v is not None else default


def _parse_sampling(body: dict[str, Any]) -> SamplingParams:
    sp = SamplingParams()
    sp.max_tokens = _num(body, "max_tokens",
                         _num(body, "max_completion_tokens", 16, int), int)
    sp.temperature = _num(body, "temperature", 1.0, float)
    sp.top_p = _num(body, "top_p", 1.0, float)
    sp.top_k = _num(body, "top_k", -1, int)
    sp.n = _num(body, "n", 1, int)
    sp.frequency_penalty = _num(body, "frequency_penalty", 0.0, float)
    sp.presence_penalty = _num(body, "presence_penalty", 0.0, float)
    sp.repetition_penalty = _num(body, "repetition_penalty", 1.0, float)
    stop = body.get("stop")
    if isinstance(stop, str):
        sp.stop = [stop]
    elif isinstance(stop, list):
        sp.stop = [str(s) for s in stop]
    sp.stop_token_ids = list(body.get("stop_token_ids", ()))
    if body.get("seed") is not None:
        sp.seed = int(body["seed"])
    lp = body.get("logprobs")
    if isinstance(lp, bool):
        sp.logprobs = lp
        sp.top_logprobs = int(body.get("top_logprobs", 0) or 0)
    elif isinstance(lp, int):  # completions-style int logprobs
        sp.logprobs = lp > 0
        sp.top_logprobs = lp
    sp.ignore_eos = bool(body.get("ignore_eos", False))
    sp.echo = bool(body.get("echo", False))
    return sp


def _cast_bool(v: Any) -> bool:
    """Admin-config boolean caster: JSON true/false or the string forms —
    bool("false") is True, which would silently invert an operator's
    intent."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in ("true", "false", "1", "0"):
        return v.lower() in ("true", "1")
    raise ValueError(f"not a boolean: {v!r}")


def _error_response(code: int, message: str, etype: str = "invalid_request_error") -> web.Response:
    return web.json_response(
        {"error": {"message": message, "type": etype, "code": code}},
        status=code)


async def _local_trace(request: web.Request) -> web.Response:
    return web.reply(*admin_trace(request.query))


async def _local_trace_recent(request: web.Request) -> web.Response:
    return web.reply(*admin_trace_recent(request.query))


async def _local_profile(request: web.Request) -> web.Response:
    return web.reply(*admin_profile(request.query))


async def _flightrecorder_recent(request: web.Request) -> web.Response:
    return web.reply(*admin_flightrecorder_recent(request.query))


class XllmHttpService:
    """Both applications (client HTTP and engine RPC) + the dispatch client."""

    def __init__(self, scheduler: Scheduler, tracer: Optional[RequestTracer] = None):
        self.scheduler = scheduler
        self.opts = scheduler._opts
        self.tracer = tracer or RequestTracer(self.opts.trace_dir,
                                              self.opts.enable_request_trace)
        # Span tracing: ring buffer per options; finished spans mirrored
        # into the RequestTracer JSONL when request tracing is on.
        TRACER.configure(
            enabled=self.opts.enable_tracing,
            capacity=self.opts.trace_span_capacity,
            mirror=self._mirror_span if self.tracer.enabled else None,
            sample_rate=self.opts.trace_sample_rate)
        # SLO burn-rate monitor (it feeds the brownout) and the anomaly
        # flight recorder the scheduler records failovers and deadline
        # cancels into.
        SLO_MONITOR.configure(
            ttft_ms=self.opts.slo_ttft_ms, tpot_ms=self.opts.slo_tpot_ms,
            budget=self.opts.slo_error_budget,
            fast_s=self.opts.slo_fast_window_s,
            slow_s=self.opts.slo_slow_window_s,
            alert=self.opts.slo_burn_alert)
        RECORDER.configure(capacity=self.opts.flightrecorder_capacity,
                           directory=self.opts.flightrecorder_dir)
        # The recorder's context provider captures this frontend's
        # control-plane view into every anomaly bundle.
        RECORDER.add_context_provider("service", self._anomaly_context)
        # Which libhotcore components this process serves natively: a
        # bundle from a degraded master says so. Loading the core here
        # (built at first use) keeps that cost off the first request.
        _native.available()
        hashing.native_available()
        RECORDER.add_context_provider("native", _native.status)
        # Continuous profiler (profiling/sampler.py): always-on sampling
        # at profile_hz (0 disables), refcounted — an in-process engine
        # agent shares the same process-global sampler.
        PROFILER.configure(hz=self.opts.profile_hz,
                           window_s=self.opts.profile_window_s,
                           max_stacks=self.opts.profile_max_stacks,
                           max_depth=self.opts.profile_max_depth)
        PROFILER.start()
        # Overload-hardening plane (overload/, docs/robustness.md):
        # admission gate, brownout state, global retry budget. Ticked by
        # the scheduler's sync loop; enforced on the request paths here.
        ADMISSION.configure(
            per_instance_limit=self.opts.admission_max_inflight_per_instance,
            batch_watermark=self.opts.admission_batch_watermark,
            retry_after_s=self.opts.admission_retry_after_s)
        BROWNOUT.configure(
            enabled=self.opts.brownout_enabled,
            batch_max_tokens=self.opts.brownout_batch_max_tokens,
            recover_ticks=self.opts.brownout_recover_ticks,
            trace_sample_rate=self.opts.brownout_trace_sample_rate,
            restore_rate_fn=lambda: self.opts.trace_sample_rate)
        RETRY_BUDGET.configure(ratio=self.opts.retry_budget_ratio,
                               cap=self.opts.retry_budget_cap)
        # Engine dispatches and master->master gens relays: blocking
        # POSTs over one kept-alive session, each on a pool thread so
        # nothing blocks the event loop (the reference's aiohttp client,
        # total timeout 30 s).
        self._session = make_keepalive_session(pool_connections=64,
                                               pool_maxsize=16)
        self._post_executor = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="dispatch")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # The event loop keeps only weak refs to tasks; hold forward tasks
        # here so they can't be garbage-collected mid-flight.
        self._forward_tasks: set[asyncio.Task] = set()
        # Multi-master: owner-forward path for the minority of requests
        # this frontend accepts but does not own (multimaster/handoff.py),
        # plus the owner-side delta journal a relay reconnect replays
        # from (exact dedup — no pipeline re-run under sampling).
        self._journal = DeltaJournal(
            grace_s=self.opts.handoff_journal_grace_s)
        self._relay = HandoffRelay(
            scheduler.ownership,
            max_attempts=self.opts.handoff_max_attempts,
            stall_timeout_s=self.opts.handoff_stall_timeout_s,
            same_owner_retry=self._journal.enabled)
        # The relay's and the fleet fan-outs' HTTP client, on the event
        # loop (a relayed stream holds its connection for the whole
        # generation).
        self._client = ClientSession()
        # /metrics/fleet TTL cache: (monotonic deadline, rendered text).
        self._fleet_metrics_cache: Optional[tuple[float, str]] = None
        # Fleet fan-out concurrency bound (asyncio primitives bind their
        # loop lazily on first await, so construction here is safe).
        self._fleet_sem = asyncio.Semaphore(  # lock-order: 830
            max(1, self.opts.fleet_scrape_concurrency))

    # ------------------------------------------------------------- HTTP app
    def build_http_app(self) -> web.Application:
        app = web.Application(middlewares=[self._readiness_middleware])
        app.router.add_post("/v1/completions", self.handle_completions)
        app.router.add_post("/v1/chat/completions", self.handle_chat)
        app.router.add_post("/v1/messages", self.handle_messages)
        app.router.add_post("/v1/embeddings", self.handle_embeddings)
        app.router.add_get("/v1/models", self.handle_models)
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_get("/hello", self.handle_hello)
        app.router.add_get("/health", self.handle_hello)
        app.router.add_get("/admin/config", self.handle_get_config)
        app.router.add_post("/admin/config", self.handle_set_config)
        app.router.add_get("/admin/planner", self.handle_planner)
        app.router.add_get("/admin/autoscaler", self.handle_autoscaler)
        app.router.add_get("/admin/coordination", self.handle_coordination)
        app.router.add_get("/admin/overload", self.handle_overload)
        app.router.add_get("/admin/hotpath", self.handle_hotpath)
        app.router.add_get("/admin/faults", self.handle_get_faults)
        app.router.add_post("/admin/faults", self.handle_set_faults)
        # Span-trace query surface. Default scope serves this process's
        # SpanStore; `?scope=fleet` fans out to every live engine agent
        # and peer frontend and merges the per-process span rings into
        # ONE tree.
        app.router.add_get("/admin/trace", self.handle_admin_trace)
        app.router.add_get("/admin/trace/recent",
                           self.handle_admin_trace_recent)
        # Fleet observability plane: merged fleet metrics, the SLO
        # burn-rate report, and the anomaly flight recorder.
        app.router.add_get("/metrics/fleet", self.handle_metrics_fleet)
        app.router.add_get("/admin/slo", self.handle_slo)
        app.router.add_get("/admin/flightrecorder/recent",
                           _flightrecorder_recent)
        # Continuous-profiling plane: this process's folded stacks, or
        # `?scope=fleet` for the merged per-role view across every live
        # engine agent and peer frontend.
        app.router.add_get("/admin/profile", self.handle_admin_profile)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    def build_rpc_app(self) -> web.Application:
        app = web.Application()
        app.router.add_post("/rpc/heartbeat", self.handle_heartbeat)
        app.router.add_post("/rpc/generations", self.handle_generations)
        # Multiplexed engine telemetry session: ONE keepalive
        # connection per engine carries tagged hb/gens frames to the
        # engine's owning master; foreign-dest gens relay master->master.
        app.router.add_post("/rpc/telemetry", self.handle_telemetry)
        # Multi-master plane: owner-side ingest of relayed requests, and
        # the replica→master write-lease proxy for PD-role flip hints.
        app.router.add_post("/rpc/handoff", self.handle_handoff)
        app.router.add_post("/rpc/handoff_abort", self.handle_handoff_abort)
        app.router.add_post("/rpc/flip_hint", self.handle_flip_hint)
        app.router.add_get("/rpc/hello", self.handle_hello)
        app.router.add_get("/rpc/instance_info", self.handle_instance_info)
        app.router.add_get("/rpc/static_prefill_list", self.handle_prefill_list)
        app.router.add_get("/rpc/static_decode_list", self.handle_decode_list)
        app.router.add_get("/health", self.handle_hello)
        # Fleet fan-out targets reach peer frontends by their RPC address
        # (the only address the XLLM:SERVICE:* records carry), so the
        # LOCAL-scope observability surface is served here too. scope=
        # fleet is deliberately not honored on this app — a peer's fan-out
        # must terminate at one hop, never cascade.
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_get("/admin/trace", _local_trace)
        app.router.add_get("/admin/trace/recent", _local_trace_recent)
        app.router.add_get("/admin/profile", _local_profile)
        return app

    async def _on_startup(self, app: web.Application) -> None:
        self._loop = asyncio.get_running_loop()

    async def _on_cleanup(self, app: web.Application) -> None:
        self._post_executor.shutdown(wait=False)
        self._session.close()
        self.tracer.close()
        RECORDER.close()
        PROFILER.stop()
        RECORDER.remove_context_provider("service", self._anomaly_context)
        RECORDER.remove_context_provider("native", _native.status)

    def _anomaly_context(self) -> dict[str, Any]:
        """Flight-recorder context provider: this frontend's control-plane
        state at anomaly time (lock-free reads only)."""
        mgr = self.scheduler.instance_mgr
        return {
            "self_addr": self.scheduler.self_addr,
            "is_master": self.scheduler.is_master,
            "snapshot_age_s": mgr.snapshot_age_s(),
            "loadinfo_ages_s": mgr.load_info_ages_s(),
            "stale_load": sorted(mgr.stale_load_names()),
            "frame_log_seq": self.scheduler.kvcache_mgr.frame_log_seq(),
            "ownership": self.scheduler.ownership.stats(),
            "inflight_requests": self.scheduler.num_inflight_requests(),
        }

    def _mirror_span(self, span: dict[str, Any]) -> None:
        self.tracer.log(span.get("request_id", ""),
                        {"type": "span", "span": span})

    @web.middleware
    async def _readiness_middleware(self, request: web.Request, handler):
        # Readiness gate (reference stops the whole HTTP server while no
        # instance group is viable, `master.cpp:101-135`; we keep the socket
        # and reject API traffic with 503 — same client-observable contract).
        if request.path.startswith("/v1/") and \
                not self.scheduler.has_available_instances():
            return _error_response(503, "no available instances",
                                   "service_unavailable")
        return await handler(request)

    # ----------------------------------------------------------- completions
    async def handle_completions(self, request: web.Request) -> web.StreamResponse:
        return await self._handle_generate(request, kind="completion")

    async def handle_chat(self, request: web.Request) -> web.StreamResponse:
        return await self._handle_generate(request, kind="chat")

    async def handle_messages(self, http_req: web.Request,
                              sid: Optional[str] = None,
                              deadline_override: int = 0
                              ) -> web.StreamResponse:
        """Anthropic-style Messages API (`/v1/messages`): the reference
        family acknowledges this surface only as an engine proto
        (`anthropic.proto` in `proto/CMakeLists.txt:18-37`) with no
        service route; here it is a first-class endpoint mapped onto the
        chat pipeline with Anthropic request/response/stream framing."""
        if sid is None:
            # Relayed handoffs already counted at their accepting
            # frontend; HANDOFF_SERVED_TOTAL tracks the owner-side serve.
            SERVER_REQUEST_IN_TOTAL.labels(kind="anthropic").inc()
        raw = await http_req.read()
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _error_response(400, "invalid JSON body")
        if not isinstance(body, dict):
            return _error_response(400, "request body must be a JSON object")
        # Overload plane (same order as _handle_generate): deadline +
        # priority first, admission after the relay decision.
        priority = parse_priority(body, http_req.headers)
        deadline_ms = deadline_override or parse_deadline_ms(
            body, http_req.headers, self.opts.default_request_deadline_ms)
        if deadline_expired(deadline_ms):
            REQUESTS_CANCELLED_TOTAL.labels(reason="deadline").inc()
            return _error_response(504, "request deadline already expired",
                                   "timeout")
        handoff = sid is not None
        if not handoff:
            sid, owner, owner_key = self._assign_ownership("messages", body)
            if owner != self.scheduler.self_addr:
                RETRY_BUDGET.note_request()
                return await self._relay_to_owner(
                    http_req, raw, "messages", sid, owner, owner_key,
                    bool(body.get("stream", False)),
                    deadline_ms=deadline_ms, priority=priority)
        if not isinstance(body.get("max_tokens"), int) \
                or body["max_tokens"] < 1:
            return _error_response(400, "max_tokens is required")
        msgs = body.get("messages")
        if not isinstance(msgs, list) or not msgs:
            return _error_response(400, "messages must be a non-empty list")
        shed = self._admission_check(priority)
        if shed is not None:
            return shed
        RETRY_BUDGET.note_request()
        # Same slot-ownership discipline as _handle_generate: the finally
        # releases on every path that never registers the request.
        slot = {"held": True}
        try:
            return await self._admitted_messages(
                http_req, sid, body, msgs, priority, deadline_ms,
                handoff, slot)
        finally:
            if slot["held"]:
                ADMISSION.release()

    async def _admitted_messages(self, http_req: web.Request, sid: str,
                                 body: dict[str, Any], msgs: list,
                                 priority: str, deadline_ms: int,
                                 handoff: bool,
                                 slot: dict) -> web.StreamResponse:
        try:
            sp = _parse_sampling(body)
        except (TypeError, ValueError, AttributeError) as e:
            return _error_response(400, f"invalid request field: {e}")
        stops = body.get("stop_sequences")
        if isinstance(stops, list):
            sp.stop = [str(s) for s in stops]
        sp.max_tokens = BROWNOUT.clamp_max_tokens(priority, sp.max_tokens)
        body["max_tokens"] = sp.max_tokens
        req = Request(
            service_request_id=sid,
            request_id="msg_" + short_uuid(),
            model=body.get("model", self.opts.model_id or ""),
            stream=bool(body.get("stream", False)),
            priority_class=priority,
            deadline_ms=deadline_ms,
            sampling=sp,
        )
        # Anthropic carries the system prompt out-of-band; normalize
        # content blocks to the chat-template message shape.
        norm: list[dict[str, Any]] = []
        system = body.get("system")
        if isinstance(system, str) and system:
            norm.append({"role": "system", "content": system})
        for m in msgs:
            if not isinstance(m, dict):
                return _error_response(400, "invalid message entry")
            content = m.get("content")
            if isinstance(content, list):
                content = "".join(p.get("text", "") for p in content
                                  if isinstance(p, dict)
                                  and p.get("type") == "text")
            norm.append({"role": m.get("role", "user"),
                         "content": str(content or "")})
        req.messages = norm
        if self.tracer.enabled:
            req.trace_callback = self.tracer.log
            self.tracer.log(req.service_request_id, {"request": body})
        self._start_root_span(
            req, "anthropic",
            ctx=TraceContext.from_headers(http_req.headers) if handoff
            else None)

        t0 = time.perf_counter()
        status = await asyncio.get_running_loop().run_in_executor(
            self.scheduler.schedule_executor, self.scheduler.schedule, req)
        HOTPATH.record("schedule", (time.perf_counter() - t0) * 1000)
        if not status.ok():
            if req.span:
                req.span.end(f"ERROR: {status.code.name}")
            return _error_response(
                503 if status.code.name == "UNAVAILABLE" else 400,
                status.message, "service_unavailable"
                if status.code.name == "UNAVAILABLE" else "invalid_request_error")

        conn = AioConnection(asyncio.get_running_loop(), req.stream)
        enriched: dict[str, Any] = {
            "model": req.model,
            "service_request_id": req.service_request_id,
            "source_service_addr": self.scheduler.self_addr,
            "token_ids": req.token_ids,
            "max_tokens": body["max_tokens"],
            "temperature": body.get("temperature", 1.0),
            "stream": req.stream,
            "messages": norm,
            "stop": sp.stop,
            "routing": {"prefill_name": req.routing.prefill_name,
                        "decode_name": req.routing.decode_name,
                        "encode_name": req.routing.encode_name},
        }
        if req.deadline_ms:
            enriched["deadline_ms"] = req.deadline_ms
        if body.get("top_p") is not None:
            enriched["top_p"] = body["top_p"]
        if body.get("top_k") is not None:
            enriched["top_k"] = body["top_k"]
        if req.trace is not None:
            enriched["trace_context"] = req.trace.to_dict()
        req.admitted = True
        slot["held"] = False
        self.scheduler.record_new_request(
            req, conn, "anthropic",
            forward_path="/v1/chat/completions", forward_payload=enriched)
        task = asyncio.create_task(self._forward_to_instance(
            req, conn, "/v1/chat/completions", enriched))
        self._forward_tasks.add(task)
        task.add_done_callback(self._forward_tasks.discard)
        return await self._respond(http_req, req, conn, emit_done=False)

    def _start_root_span(self, req: Request, kind: str,
                         ctx: Optional[TraceContext] = None) -> None:
        """Root the request's trace in the frontend (no-op when tracing is
        off): every downstream hop parents its spans under this context.
        With `ctx` (a relayed handoff: the accepting frontend rooted the
        trace and sent it as x-xllm-* headers) this span parents under
        the relay instead, so /admin/trace assembles ONE tree across the
        accepting frontend, every owner incarnation, and the engines."""
        root = TRACER.start_span("frontend.request", ctx=ctx,
                                 request_id=req.service_request_id,
                                 kind=kind, model=req.model,
                                 stream=req.stream)
        if root:
            req.span = root
            req.trace = root.context()

    # ------------------------------------------------- multi-master ownership
    def _assign_ownership(self, kind: str,
                          body: dict[str, Any]) -> tuple[str, str, str]:
        """(service_request_id, owner_addr, ownership_key) for a new
        accept. A client-pinned string `ownership_key` in the body gives
        session affinity — every request carrying the same key is owned
        by the same master (and fails over to the same successor);
        otherwise the generated id is mined so that, in the common case,
        this frontend owns what it accepts and no forward hop is paid."""
        ownership = self.scheduler.ownership
        okey = body.get("ownership_key")
        if isinstance(okey, str) and okey:
            return (generate_service_request_id(kind),
                    ownership.owner_of(okey), okey)
        sid, owner = ownership.mine(kind)
        return sid, owner, sid

    async def _relay_to_owner(self, http_req: web.Request, raw: bytes,
                              kind: str, sid: str, owner: str,
                              owner_key: str, stream: bool,
                              deadline_ms: int = 0,
                              priority: str = "") -> web.StreamResponse:
        return await self._relay.relay(
            http_req, self._client, raw, kind, sid, owner, owner_key,
            stream, self.opts.request_timeout_s,
            deadline_ms=deadline_ms, priority=priority)

    def _admission_check(self, priority: str) -> Optional[web.Response]:
        """Overload-admission gate (overload/admission.py): None =
        admitted (the caller must set `req.admitted` so exit accounting
        releases the slot), else the fast 429. Runs on the event loop —
        one leaf-lock hold over integer math, no RPC, no tokenize."""
        admit, reason, retry_after = ADMISSION.try_admit(
            priority,
            live=len(self.scheduler.instance_mgr
                     .routing_snapshot().schedulable),
            burn_hot=BROWNOUT.active())
        if admit:
            return None
        REQUESTS_CANCELLED_TOTAL.labels(reason="shed").inc()
        return web.json_response(
            {"error": {"message": f"overloaded: {reason}",
                       "type": "overloaded_error", "code": 429}},
            status=429,
            headers={"Retry-After": str(max(1, int(retry_after)))})

    async def _handle_generate(self, http_req: web.Request, kind: str,
                               sid: Optional[str] = None,
                               deadline_override: int = 0
                               ) -> web.StreamResponse:
        if sid is None:
            # Relayed handoffs already counted at their accepting
            # frontend; HANDOFF_SERVED_TOTAL tracks the owner-side serve.
            SERVER_REQUEST_IN_TOTAL.labels(kind=kind).inc()
        raw = await http_req.read()
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _error_response(400, "invalid JSON body")
        if not isinstance(body, dict):
            return _error_response(400, "request body must be a JSON object")

        # Overload plane: resolve the end-to-end deadline and the
        # priority class BEFORE any expensive work. A relayed handoff
        # carries the ABSOLUTE deadline the accepting frontend computed
        # (re-parsing the body's relative budget here would extend the
        # deadline by the relay hop it is meant to bound).
        priority = parse_priority(body, http_req.headers)
        deadline_ms = deadline_override or parse_deadline_ms(
            body, http_req.headers, self.opts.default_request_deadline_ms)
        if deadline_expired(deadline_ms):
            # Admission rejects already-expired work: serving it burns
            # fleet capacity on an answer nobody is waiting for.
            REQUESTS_CANCELLED_TOTAL.labels(reason="deadline").inc()
            return _error_response(504, "request deadline already expired",
                                   "timeout")

        # Multi-master ownership: `sid` set means this request was relayed
        # here by its accepting frontend — serve it locally under the
        # relay-supplied id (never re-relay). Otherwise resolve ownership
        # and forward the raw body to the owner when it isn't us.
        handoff = sid is not None
        if not handoff:
            sid, owner, owner_key = self._assign_ownership(kind, body)
            if owner != self.scheduler.self_addr:
                # Relay-path deposit: the relay's re-ownership recovery
                # spends from THIS process's retry bucket.
                RETRY_BUDGET.note_request()
                return await self._relay_to_owner(
                    http_req, raw, kind, sid, owner, owner_key,
                    bool(body.get("stream", False)),
                    deadline_ms=deadline_ms, priority=priority)

        # Admission control + priority shedding: the bounded gate in
        # front of the schedule executor — a fast 429 beats a slow 200
        # that blows everyone's SLO. Runs at the serving frontend (the
        # owner, for relayed requests): the watermark protects THIS
        # process's executor and the fleet behind it.
        shed = self._admission_check(priority)
        if shed is not None:
            return shed
        RETRY_BUDGET.note_request()
        # Slot ownership: held HERE from try_admit until the request is
        # registered (record_new_request — from then on the scheduler's
        # winning-exit accounting releases it via `req.admitted`). The
        # finally releases on EVERY other path — validation errors,
        # schedule failure, a raising parser, handler-task cancellation
        # — or a shed slot would leak forever.
        slot = {"held": True}
        try:
            return await self._admitted_generate(
                http_req, kind, sid, body, priority, deadline_ms,
                handoff, slot)
        finally:
            if slot["held"]:
                ADMISSION.release()

    async def _admitted_generate(self, http_req: web.Request, kind: str,
                                 sid: str, body: dict[str, Any],
                                 priority: str, deadline_ms: int,
                                 handoff: bool,
                                 slot: dict) -> web.StreamResponse:
        try:
            req = Request(
                service_request_id=sid,
                request_id=("chatcmpl-" if kind == "chat" else "cmpl-") + short_uuid(),
                model=body.get("model", self.opts.model_id or ""),
                stream=bool(body.get("stream", False)),
                include_usage=bool((body.get("stream_options") or {})
                                   .get("include_usage", False)),
                offline=bool(body.get("offline", False)),
                priority=int(body.get("priority") or 0),
                priority_class=priority,
                deadline_ms=deadline_ms,
                sampling=_parse_sampling(body),
            )
        except (TypeError, ValueError, AttributeError) as e:
            # Mistyped client fields (e.g. "max_tokens": null) are client
            # errors, not 500s.
            return _error_response(400, f"invalid request field: {e}")
        # Brownout: clamp batch-priority generation length while the SLO
        # burn is hot — bulk work finishes sooner and returns decode
        # capacity to interactive traffic. The body is clamped too: the
        # enriched engine payload is built from it.
        clamped = BROWNOUT.clamp_max_tokens(priority,
                                            req.sampling.max_tokens)
        if clamped != req.sampling.max_tokens:
            req.sampling.max_tokens = clamped
            body["max_tokens"] = clamped
            body.pop("max_completion_tokens", None)
        if kind == "chat":
            msgs = body.get("messages")
            if not isinstance(msgs, list) or not msgs:
                return _error_response(400, "messages must be a non-empty list")
            req.messages = msgs
            req.tools = body.get("tools") or []
            req.chat_template_kwargs = body.get("chat_template_kwargs") or {}
            req.has_images = any(
                isinstance(m.get("content"), list) and any(
                    isinstance(part, dict)
                    and str(part.get("type", "")).startswith("image")
                    for part in m["content"])
                for m in msgs if isinstance(m, dict))
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                if prompt and isinstance(prompt[0], int):
                    req.token_ids = [int(t) for t in prompt]
                else:
                    prompt = "".join(str(p) for p in prompt)
            if isinstance(prompt, str):
                req.prompt = prompt
            if not req.prompt and not req.token_ids:
                return _error_response(400, "prompt must not be empty")
        if self.tracer.enabled:
            req.trace_callback = self.tracer.log
            self.tracer.log(req.service_request_id, {"request": body})
        self._start_root_span(
            req, kind,
            ctx=TraceContext.from_headers(http_req.headers) if handoff
            else None)

        # Schedule (tokenize + route) off the event loop — CPU-bound, on
        # the dedicated bounded pool so admission never queues behind
        # generations ingest or failover backoff sleeps.
        t0 = time.perf_counter()
        status = await asyncio.get_running_loop().run_in_executor(
            self.scheduler.schedule_executor, self.scheduler.schedule, req)
        HOTPATH.record("schedule", (time.perf_counter() - t0) * 1000)
        if not status.ok():
            if req.span:
                req.span.end(f"ERROR: {status.code.name}")
            # A failed schedule is never registered, so exit accounting
            # will not release its admission slot — the caller's finally
            # does.
            return _error_response(
                503 if status.code.name == "UNAVAILABLE" else 400,
                status.message, "service_unavailable"
                if status.code.name == "UNAVAILABLE" else "invalid_request_error")

        conn = AioConnection(asyncio.get_running_loop(), req.stream)

        # Enrich + forward to the prefill instance, fire-and-forget
        # (reference `service.cpp:222-260,485-493`). The enriched payload
        # is also retained with the request registration so the failover
        # layer can replay it on a surviving instance; the wire bytes are
        # preserialized HERE, once, in the instance's negotiated format
        # (msgpack for current engines — token_ids is a multi-thousand-int
        # list; JSON-encoding it per request was a measured hot-path cost).
        t1 = time.perf_counter()
        enriched = dict(body)
        enriched["service_request_id"] = req.service_request_id
        enriched["source_service_addr"] = self.scheduler.self_addr
        enriched["token_ids"] = req.token_ids
        enriched["routing"] = {"prefill_name": req.routing.prefill_name,
                               "decode_name": req.routing.decode_name,
                               "encode_name": req.routing.encode_name}
        if req.deadline_ms:
            # Absolute deadline on the engine wire: the engine compares
            # against its own clock, so queueing/transit time is
            # naturally subtracted from the remaining budget.
            enriched["deadline_ms"] = req.deadline_ms
        if req.trace is not None:
            enriched["trace_context"] = req.trace.to_dict()
        path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
        wire_body, wire_ctype = wire.encode_dispatch(
            enriched, self.scheduler.dispatch_wire(req.routing.prefill_name))
        HOTPATH.record("enrich", (time.perf_counter() - t1) * 1000)
        # Admission-slot ownership transfers to the scheduler with the
        # registration: its exactly-once exit accounting releases.
        req.admitted = True
        slot["held"] = False
        self.scheduler.record_new_request(req, conn, kind,
                                          forward_path=path,
                                          forward_payload=enriched)
        task = asyncio.create_task(
            self._forward_to_instance(req, conn, path, enriched,
                                      wire_body, wire_ctype))
        self._forward_tasks.add(task)
        task.add_done_callback(self._forward_tasks.discard)

        # Owner-side delta journal for relayed streams: every emitted SSE
        # data frame is teed into it so a relay reconnect (transport blip,
        # accepting-frontend restart) replays the exact frames instead of
        # re-running the generation.
        journal = self._journal.start(sid) \
            if handoff and req.stream else None
        return await self._respond(http_req, req, conn, journal=journal)

    def _post(self, url: str, body: bytes, ctype: str,
              timeout: float = 30.0):
        return self._session.post(url, data=body,
                                  headers={"Content-Type": ctype},
                                  timeout=timeout)

    async def _forward_to_instance(self, req: Request, conn: AioConnection,
                                   path: str, payload: dict[str, Any],
                                   body: Optional[bytes] = None,
                                   ctype: str = wire.JSON_CONTENT_TYPE) -> None:
        url = f"http://{req.routing.prefill_name}{path}"
        if body is None:
            body, ctype = wire.encode_dispatch(payload)
        retryable, code = True, 503
        loop = asyncio.get_running_loop()
        try:
            t0 = time.perf_counter()
            resp = await loop.run_in_executor(self._post_executor,
                                              self._post, url, body, ctype)
            if resp.status_code == 415 \
                    and ctype == wire.MSGPACK_CONTENT_TYPE:
                # Legacy engine behind a stale registration: negotiate
                # down to JSON for this instance and re-send. A 415
                # rejection cannot have started generation, so the
                # re-send is safe on this non-idempotent wire.
                self.scheduler.instance_mgr.demote_wire(
                    req.routing.prefill_name)
                body, ctype = wire.encode_dispatch(payload)
                resp = await loop.run_in_executor(
                    self._post_executor, self._post, url, body, ctype)
            if resp.status_code != 200:
                # 4xx = the engine deliberately rejected the request
                # (client error): another instance would reject it the
                # same way — surface it as-is, don't failover.
                if 400 <= resp.status_code < 500:
                    retryable, code = False, resp.status_code
                raise RuntimeError(f"engine returned {resp.status_code}: "
                                   f"{resp.text[:200]}")
            HOTPATH.record("forward", (time.perf_counter() - t0) * 1000)
            self.scheduler.mark_dispatch_complete(req)
        except Exception as e:  # noqa: BLE001 — surface any forward failure
            logger.warning("forward of %s to %s failed: %s",
                           req.service_request_id, url, e)
            # Failover-or-surface. Off the event loop: the failover layer
            # sleeps on backoff and issues blocking engine RPCs.
            await loop.run_in_executor(
                None, self.scheduler.handle_dispatch_failure, req,
                f"failed to reach prefill instance: {e}", retryable, code)

    async def _respond(self, http_req: web.Request, req: Request,
                       conn: AioConnection,
                       emit_done: bool = True,
                       journal=None) -> web.StreamResponse:
        timeout = self.opts.request_timeout_s
        if req.deadline_ms:
            # The client-side wait honors the per-request deadline (plus
            # a small grace for in-flight deltas) so a stalled stream
            # surfaces its 504 at deadline, not at the blunt GC bound.
            timeout = max(0.05, min(
                timeout, remaining_ms(req.deadline_ms) / 1000.0 + 0.25))
        if req.stream:
            resp = web.StreamResponse()
            resp.headers["Content-Type"] = "text/event-stream"
            resp.headers["Cache-Control"] = "no-cache"
            resp.headers["Connection"] = "keep-alive"
            # The internal service id (the key /admin/trace and the
            # flight recorder index by) — deltas only carry the
            # OpenAI-style cmpl- id, so without this header a client
            # cannot correlate its own request with the trace plane.
            resp.headers["X-Request-Id"] = req.service_request_id
            await resp.prepare(http_req)
            # Coalesced emit: one blocking queue get, then drain whatever
            # else is already queued and flush ALL frames in one write()
            # — an engine delta batch (several tokens per Generations
            # POST) costs one event-loop write instead of one per chunk.
            # With a `journal` (owner side of a relayed stream) every
            # data frame is teed into it, and a broken downstream
            # connection DETACHES instead of cancelling: deltas keep
            # absorbing into the journal for the reconnect grace window
            # so a relay retry replays the exact stream.
            dumps = json.dumps  # xlint: allow-hot-json(SSE frames are client-protocol JSON, not the negotiated dispatch wire)
            buf = bytearray()
            done = False
            detached = False
            detach_deadline = 0.0
            try:
                while not done:
                    get_timeout = timeout
                    if detached:
                        # A reconnect (journal get) or an actively-
                        # streaming replay (per-poll touch) extends the
                        # grace: cancelling a generation whose frames a
                        # reattached relay is mid-replay would truncate
                        # the stream.
                        extended = max(
                            detach_deadline,
                            journal.touched + self._journal.grace_s)
                        remaining = extended - time.monotonic()
                        if remaining <= 0:
                            # Nobody (re)attached inside the grace
                            # window: normal disconnect semantics from
                            # here. Finish the journal so a late replay
                            # drains what exists and exits instead of
                            # polling to the request-timeout bound.
                            DeltaJournal.finish(journal)
                            conn.mark_disconnected()
                            break
                        get_timeout = min(timeout, remaining)
                    try:
                        tag, item = await asyncio.wait_for(conn.queue.get(),
                                                           get_timeout)
                    except asyncio.TimeoutError:
                        if detached:
                            continue   # re-check the grace window
                        raise
                    # The drain below is pure CPU (no awaits): frame
                    # assembly + JSON serialization per delta, attributed
                    # to the "stream" loop so XLLM_NATIVE=1 and =0 are
                    # compared where the bytes are built. The port's
                    # libhotcore (common/native.py, csrc/hotcore.c)
                    # assembles each data/event frame in one C call; on
                    # MISS (an input it cannot render bit-exactly) the
                    # Python encoder below builds the same bytes. Error
                    # frames are rare and ensure_ascii, so they always
                    # take the Python encoder.
                    with CPU_ATTR.measure("stream"):
                        while True:
                            frame = b""
                            if AioConnection.is_finish(tag):
                                if emit_done:  # OpenAI framing
                                    frame = _DONE_FRAME
                                done = True
                            elif tag == "error":
                                code, msg = item
                                frame = _DATA_PREFIX + dumps(
                                    {"error": {"message": msg,
                                               "code": code}},
                                    separators=_COMPACT).encode() \
                                    + _FRAME_SEP
                                done = True
                            elif tag == "event":
                                name, obj = item
                                frame = _native.sse_event_frame(name, obj)
                                if frame is _native.MISS:
                                    frame = (f"event: {name}\n".encode()
                                             + _DATA_PREFIX
                                             + dumps(obj, ensure_ascii=False,
                                                     separators=_COMPACT
                                                     ).encode()
                                             + _FRAME_SEP)
                            else:
                                frame = _native.sse_data_frame(item)
                                if frame is _native.MISS:
                                    frame = _DATA_PREFIX + dumps(
                                        item, ensure_ascii=False,
                                        separators=_COMPACT).encode() \
                                        + _FRAME_SEP
                            if frame:
                                buf += frame
                                if journal is not None:
                                    DeltaJournal.record(journal, frame)
                            if done:
                                break
                            try:
                                tag, item = conn.queue.get_nowait()
                            except asyncio.QueueEmpty:
                                break
                    if buf:
                        if not detached:
                            try:
                                await resp.write(bytes(buf))
                            except (ConnectionResetError, OSError):
                                if journal is None:
                                    raise
                                detached = True
                                detach_deadline = time.monotonic() + \
                                    self._journal.grace_s
                                logger.info(
                                    "relay connection of %s broke after "
                                    "%d journaled frames; absorbing "
                                    "deltas for reconnect (%.1fs grace)",
                                    req.service_request_id,
                                    len(journal.frames),
                                    self._journal.grace_s)
                        buf.clear()
                if done and journal is not None:
                    DeltaJournal.finish(journal)
            except asyncio.TimeoutError:
                if await self._deadline_cancel(req):
                    # Surface the 504 in-band: frames may already be out.
                    with contextlib.suppress(ConnectionResetError, OSError):
                        await resp.write(
                            b'data: {"error": {"message": "deadline '
                            b'exceeded", "code": 504}}\n\n')
                else:
                    conn.mark_disconnected()
            except (ConnectionResetError, OSError):
                conn.mark_disconnected()
            except asyncio.CancelledError:
                conn.mark_disconnected()
                raise
            if not detached:
                with contextlib.suppress(ConnectionResetError):
                    await resp.write_eof()
            return resp
        # Non-stream.
        try:
            while True:
                tag, item = await asyncio.wait_for(conn.queue.get(), timeout)
                if AioConnection.is_finish(tag):
                    continue  # finish after single payload: loop exits below
                if tag == "error":
                    code, msg = item
                    return _error_response(code, msg, "server_error")
                return web.json_response(
                    item, headers={"X-Request-Id": req.service_request_id})
        except asyncio.TimeoutError:
            if await self._deadline_cancel(req):
                return _error_response(504, "deadline exceeded", "timeout")
            conn.mark_disconnected()
            return _error_response(504, "request timed out", "timeout")
        except asyncio.CancelledError:
            conn.mark_disconnected()
            raise

    async def _deadline_cancel(self, req: Request) -> bool:
        """A response wait timed out: if the request's own deadline has
        expired, cancel it for real (exit accounting + engine-side stop
        — blocking RPCs, so off the event loop). False = not a deadline
        case; the caller falls back to disconnect semantics."""
        if not deadline_expired(req.deadline_ms):
            return False
        await asyncio.get_running_loop().run_in_executor(
            None, self.scheduler.cancel_request, req.service_request_id,
            504, "deadline exceeded", "deadline")
        return True

    # -------------------------------------------------------- other routes
    async def handle_models(self, request: web.Request) -> web.Response:
        """Aggregate model list from instance metadata (reference proxies an
        instance's Models RPC, `service.cpp:317-357`)."""
        models: dict[str, dict[str, Any]] = {}
        for meta in self.scheduler.instance_mgr.list_instances():
            for m in meta.models or ([self.opts.model_id] if self.opts.model_id else []):
                if m:
                    models.setdefault(m, {
                        "id": m, "object": "model", "created": 0,
                        "owned_by": "xllm-service-tpu"})
        return web.json_response({"object": "list",
                                  "data": list(models.values())})

    async def handle_embeddings(self, request: web.Request) -> web.Response:
        """Synchronous proxy to an engine's embedding forward. (The
        reference returns "not support" here, `service.cpp:500-517` — we
        exceed it; engines whose model family lacks an embed forward still
        501.)"""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON")
        routing = self.scheduler.instance_mgr.get_next_instance_pair()
        if not routing.valid():
            return _error_response(503, "no available instances",
                                   "service_unavailable")
        ch = self.scheduler.get_channel(routing.prefill_name)
        if ch is None:
            return _error_response(503, "instance channel unavailable",
                                   "service_unavailable")
        forward = getattr(ch, "forward_status", None)
        if forward is None:   # test doubles without the richer API
            ok, resp = await asyncio.get_running_loop().run_in_executor(
                None, ch.forward, "/v1/embeddings", body)
            if not ok:
                return _error_response(502, f"engine error: {resp}")
            return web.json_response(resp)
        status, resp = await asyncio.get_running_loop().run_in_executor(
            None, forward, "/v1/embeddings", body)
        if status != 200:
            # Pass the engine's own status through (501 unsupported
            # family, 400 bad input, ...) instead of masking as 502.
            msg = resp.get("error") if isinstance(resp, dict) else resp
            return _error_response(status if 400 <= status < 600 else 502,
                                   str(msg))
        return web.json_response(resp)

    def _refresh_local_gauges(self) -> None:
        """Scrape-time refresh of the control-plane freshness gauges +
        the SLO burn rates (cheap lock-free reads; no background
        thread)."""
        mgr = self.scheduler.instance_mgr
        ROUTING_SNAPSHOT_AGE_SECONDS.set(mgr.snapshot_age_s())
        ages = mgr.load_info_ages_s()
        # A never-updated instance (age sentinel -1) IS the stalest case
        # — routing has zero telemetry for it; it must win the gauge,
        # not be hidden by a fresher peer's finite age.
        LOADINFO_MAX_AGE_SECONDS.set(
            -1.0 if any(a < 0 for a in ages.values())
            else max(ages.values(), default=0.0))
        for name, age in ages.items():
            # Per-instance snapshot age : the exact
            # staleness SLO/CAR scoring discounts by. Series ride the
            # live load-info view; deregistration evicts them.
            LOADINFO_AGE_SECONDS.labels(instance=name).set(age)
        LOADINFO_STALE_INSTANCES.set(len(mgr.stale_load_names()))
        KVCACHE_FRAME_LOG_SEQ.set(
            self.scheduler.kvcache_mgr.frame_log_seq())
        # Autoscaler surface: fleet census by role + decision freshness
        # (a stuck control loop shows up as a growing age).
        snap = mgr.routing_snapshot()
        FLEET_SIZE.labels(role="prefill").set(len(snap.prefill))
        FLEET_SIZE.labels(role="decode").set(len(snap.decode))
        FLEET_SIZE.labels(role="encode").set(len(snap.encode))
        FLEET_SIZE.labels(role="draining").set(len(mgr.draining_names()))
        AUTOSCALER_LAST_DECISION_AGE_SECONDS.set(
            self.scheduler.autoscaler.last_decision_age_s())
        # Overload plane: gate depth, brownout state, retry-budget level.
        ADMISSION_PENDING_REQUESTS.set(ADMISSION.pending())
        BROWNOUT_ACTIVE.set(1.0 if BROWNOUT.active() else 0.0)
        tokens = RETRY_BUDGET.tokens()
        RETRY_BUDGET_TOKENS.set(tokens if tokens != float("inf") else -1.0)
        SLO_MONITOR.export_gauges()
        # Hot-loop CPU attribution as counters.
        CPU_ATTR.export_counters()
        # Which libhotcore components serve this process (1) and which
        # run the pure-Python path (0): fleet scrapes spot degraded peers.
        _native.export_gauges()

    async def handle_metrics(self, request: web.Request) -> web.Response:
        self._refresh_local_gauges()
        return web.Response(text=REGISTRY.render_prometheus(),
                            content_type="text/plain")

    async def handle_hello(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok",
                                  "master": self.scheduler.is_master})

    # ----------------------------------------------- fleet observability
    def _fleet_targets(self) -> list[tuple[str, str]]:
        """(addr, role) fan-out targets: every known engine agent (from
        the RCU routing snapshot — SUSPECT/draining included, their view
        may hold the evidence) and every peer frontend (ownership member
        set)."""
        targets = [(name, "engine") for name in
                   self.scheduler.instance_mgr.routing_snapshot().entries]
        self_addr = self.scheduler.self_addr
        targets += [(addr, "frontend")
                    for addr in self.scheduler.ownership.members()
                    if addr != self_addr]
        return targets

    async def _fanout_get(self, path: str, params: dict[str, str],
                          as_json: bool = True
                          ) -> list[tuple[str, str, str, Any]]:
        """Concurrent bounded GET against every fleet target. Returns
        ``(addr, role, status, payload)`` rows where status is ``ok``,
        ``http <code>``, ``timeout`` or ``error`` — a dead peer degrades
        the view, never the endpoint."""
        timeout = ClientTimeout(
            total=max(0.1, self.opts.fleet_peer_timeout_s))

        async def one(addr: str, role: str):
            async with self._fleet_sem:
                try:
                    async with self._client.get(
                            f"http://{addr}{path}", params=params,
                            timeout=timeout) as r:
                        payload = (await r.json()
                                   if as_json else await r.text())
                        status = "ok" if r.status == 200 \
                            else f"http {r.status}"
                        return addr, role, status, payload
                except asyncio.TimeoutError:
                    return addr, role, "timeout", None
                except (ClientError, OSError, ValueError) as e:
                    return addr, role, f"error: {type(e).__name__}", None

        return list(await asyncio.gather(
            *(one(a, r) for a, r in self._fleet_targets())))

    async def handle_admin_trace(self, request: web.Request) -> web.Response:
        if request.query.get("scope") != "fleet":
            return await _local_trace(request)
        request_id = request.query.get("request_id", "")
        trace_id = request.query.get("trace_id", "")
        if not request_id and not trace_id:
            return _error_response(400, "pass request_id= or trace_id=")
        status, local = TRACER.query_trace(request_id=request_id,
                                           trace_id=trace_id)
        span_lists: list[list[dict[str, Any]]] = []
        if status == 200:
            span_lists.append(local["spans"])
            trace_id = trace_id or local["trace_id"]
        # Peers resolve request_id against their own stores, so the
        # fan-out works even when this frontend recorded nothing (e.g. a
        # trace rooted by a peer that relayed elsewhere).
        params = {"trace_id": trace_id} if trace_id \
            else {"request_id": request_id}
        peers: dict[str, dict[str, str]] = {}
        for addr, role, pstatus, payload in await self._fanout_get(
                "/admin/trace", params):
            if pstatus == "ok" and isinstance(payload, dict):
                span_lists.append(payload.get("spans") or [])
                trace_id = trace_id or payload.get("trace_id", "")
            elif pstatus == "http 404":
                pstatus = "no_spans"   # a peer this trace never touched
            peers[addr] = {"role": role, "status": pstatus}
        spans = merge_fleet_spans(span_lists)
        if not spans:
            return web.json_response(
                {"error": "no spans recorded anywhere in the fleet",
                 "scope": "fleet", "peers": peers}, status=404)
        payload = {
            "scope": "fleet",
            "trace_id": trace_id,
            "request_id": request_id or next(
                (s["request_id"] for s in spans if s.get("request_id")), ""),
            "num_spans": len(spans),
            "peers": peers,
            "spans": spans,
            "tree": span_tree(spans),
        }
        # TTFT critical path over the MERGED tree: on a relayed request
        # the root span lives on the accepting frontend and the prefill
        # span on an engine — only the fleet view can decompose it.
        cp = critical_path(spans)
        if cp is not None:
            payload["critical_path"] = cp
        return web.json_response(payload)

    async def handle_admin_trace_recent(self,
                                        request: web.Request) -> web.Response:
        if request.query.get("scope") != "fleet":
            return await _local_trace_recent(request)
        try:
            limit = int(request.query.get("limit", 20))
        except ValueError:
            return _error_response(400, "limit must be an integer")
        sort = request.query.get("sort", "recent")
        local = TRACER.query_recent(limit=limit, sort=sort)
        rows: dict[str, dict[str, Any]] = {
            r["trace_id"]: r for r in local["traces"]}
        peers: dict[str, dict[str, str]] = {}
        for addr, role, pstatus, payload in await self._fanout_get(
                "/admin/trace/recent",
                {"limit": str(limit), "sort": sort}):
            if pstatus == "ok" and isinstance(payload, dict):
                for r in payload.get("traces") or ():
                    cur = rows.get(r.get("trace_id", ""))
                    # Keep the row closest to the root (a frontend's view
                    # names the root point; an engine's view doesn't).
                    if cur is None or (not cur.get("root_point")
                                       and r.get("root_point")):
                        rows[r["trace_id"]] = r
            peers[addr] = {"role": role, "status": pstatus}
        key = "duration_ms" if sort == "slowest" else "start_ms"
        merged = sorted(rows.values(), key=lambda r: r.get(key, 0.0),
                        reverse=True)[:max(0, limit)]
        return web.json_response({"scope": "fleet", "sort": sort,
                                  "peers": peers, "traces": merged})

    async def handle_admin_profile(self,
                                   request: web.Request) -> web.Response:
        """Continuous-profiling view (profiling/sampler.py). Default
        scope serves this process's folded stacks / top-N summary;
        ``?scope=fleet`` fans out to every live engine agent and peer
        frontend, merges the folded counts exactly (role prefixes keep
        per-role attribution across processes) and marks each peer's
        contribution — a dead peer degrades the view, never the
        endpoint."""
        if request.query.get("scope") != "fleet":
            return await _local_profile(request)
        try:
            top = int(request.query.get("top", 30))
        except ValueError:
            return _error_response(400, "top must be an integer")
        counts = parse_folded(PROFILER.folded())
        peers: dict[str, dict[str, str]] = {}
        for addr, role, pstatus, payload in await self._fanout_get(
                "/admin/profile", {"format": "folded"}, as_json=False):
            if pstatus == "ok" and isinstance(payload, str):
                for stack, n in parse_folded(payload).items():
                    counts[stack] = counts.get(stack, 0) + n
            peers[addr] = {"role": role, "status": pstatus}
        if request.query.get("format") == "folded":
            lines = [f"{';'.join(stack)} {n}"
                     for stack, n in sorted(counts.items())]
            return web.Response(text="\n".join(lines) + "\n",
                                content_type="text/plain")
        merged = summarize_stacks(counts, top_n=top)
        merged.update({"scope": "fleet", "peers": peers})
        return web.json_response(merged)

    async def handle_metrics_fleet(self,
                                   request: web.Request) -> web.Response:
        """Merged fleet Prometheus exposition: local series + every peer
        frontend's + every engine agent's /metrics, each sample re-labeled
        with ``instance``/``role``, behind a short TTL cache. A dead
        target contributes only ``fleet_scrape_up 0`` — partial, never an
        error."""
        now = time.monotonic()
        cached = self._fleet_metrics_cache
        if cached is not None and now < cached[0]:
            return web.Response(text=cached[1], content_type="text/plain")
        self._refresh_local_gauges()
        self_addr = self.scheduler.self_addr
        parts = [relabel_prometheus_text(REGISTRY.render_prometheus(),
                                         self_addr, "frontend")]
        up_lines = ["# TYPE fleet_scrape_up gauge",
                    f'fleet_scrape_up{{instance="{self_addr}",'
                    f'role="frontend"}} 1']
        for addr, role, pstatus, payload in await self._fanout_get(
                "/metrics", {}, as_json=False):
            up = 1 if pstatus == "ok" and isinstance(payload, str) else 0
            up_lines.append(f'fleet_scrape_up{{instance="{addr}",'
                            f'role="{role}"}} {up}')
            if up:
                # Foreign comments dropped: duplicate # TYPE lines across
                # sources would make the merged exposition invalid.
                parts.append(relabel_prometheus_text(
                    payload, addr, role, strip_comments=True))
        text = "".join(parts) + "\n".join(up_lines) + "\n"
        self._fleet_metrics_cache = (
            now + max(0.0, self.opts.metrics_fleet_cache_ttl_s), text)
        return web.Response(text=text, content_type="text/plain")

    async def handle_slo(self, request: web.Request) -> web.Response:
        """Scored SLO report: per-objective multi-window burn rates
        (common/slo.py) — the machine-readable signal the autoscaling /
        SLO-policy loop consumes."""
        report = SLO_MONITOR.export_gauges()
        report["targets"] = {
            "slo_ttft_ms": self.opts.slo_ttft_ms,
            "slo_tpot_ms": self.opts.slo_tpot_ms,
            "slo_error_budget": self.opts.slo_error_budget,
        }
        return web.json_response(report)

    # ----------------------------------------------------------- admin routes
    # Live-reloadable knobs (reference exposes target_ttft/target_tpot as
    # brpc-reloadable flags with validation, `global_gflags.cpp:122-132`).
    _RELOADABLE = {"target_ttft_ms": float, "target_tpot_ms": float,
                   "max_waiting_requests": int, "request_timeout_s": float,
                   "enable_request_trace": _cast_bool,
                   "enable_tracing": _cast_bool,
                   "trace_sample_rate": float}

    async def handle_get_config(self, request: web.Request) -> web.Response:
        return web.json_response({
            f.name: getattr(self.opts, f.name)
            for f in dataclasses.fields(self.opts)
            if isinstance(getattr(self.opts, f.name), (int, float, str, bool))
        })

    async def handle_planner(self, request: web.Request) -> web.Response:
        """Latest fleet-planning decision (scale hints + requested flips;
        reference Planner component, docs/en/overview.md:56-60)."""
        d = self.scheduler.planner.last_decision
        if d is None:
            return web.json_response({"decision": None})
        return web.json_response({"decision": dataclasses.asdict(d)})

    async def handle_autoscaler(self, request: web.Request) -> web.Response:
        """The autoscaler controller's decision log + state
        (docs/autoscaling.md): every tick's inputs, actions and the
        reasons they were (or were not) taken — PlanDecision.reasons,
        but acted on."""
        return web.json_response(self.scheduler.autoscaler.report())

    async def handle_coordination(self, request: web.Request) -> web.Response:
        """Coordination-plane health (docs/robustness.md degraded mode):
        CONNECTED/DEGRADED/RECOVERING state, probe-failure streak,
        outage accounting, frozen census events, the held-action log,
        and the client's reconnect counter — one page answering "is the
        fleet serving through a coordination outage right now, and what
        is being held back"."""
        return web.json_response(self.scheduler.coordination_health.report())

    async def handle_overload(self, request: web.Request) -> web.Response:
        """Overload-hardening plane state (docs/robustness.md): the
        admission gate (watermarks, pending, shed counts/rate), the
        brownout controller (state + transition log with reasons), the
        global retry budget, and every instance channel's circuit
        breaker — one page answering "what is being degraded, shed or
        fenced off right now, and why"."""
        snap = self.scheduler.instance_mgr.routing_snapshot()
        breakers = {}
        for name, ch in snap.channels.items():
            br = getattr(ch, "breaker", None)
            if br is not None:
                breakers[name] = br.snapshot()
        return web.json_response({
            "deadline": {
                "default_request_deadline_ms":
                    self.opts.default_request_deadline_ms,
                "request_timeout_s": self.opts.request_timeout_s,
            },
            "admission": ADMISSION.report(),
            "brownout": BROWNOUT.report(),
            "retry_budget": RETRY_BUDGET.report(),
            "breakers": breakers,
        })

    async def handle_hotpath(self, request: web.Request) -> web.Response:
        """Per-stage master hot-path latency table (always-on recorder,
        common/hotpath.py): schedule / enrich / forward / first_delta
        percentiles over the recent sample window, plus the multi-master
        plane's view — ownership/mining stats and the load-info
        telemetry ages staleness-aware scoring discounts by."""
        mgr = self.scheduler.instance_mgr
        return web.json_response({
            "stages": HOTPATH.summary(),
            # Per-category CPU attribution (ingest = heartbeat/telemetry,
            # route = schedule, stream = delta ingest): the bench's
            # ingest-share evidence for the sharded telemetry plane.
            "cpu": CPU_ATTR.summary(),
            # Where recent requests' TTFT went, stage by stage: the
            # critical-path aggregate over this process's span ring
            # (per-request decomposition: /admin/trace?request_id=...).
            "critical_path": aggregate_critical_paths(
                critical_path(spans)
                for spans in TRACER.store.recent_trace_spans(50)),
            "ownership": self.scheduler.ownership.stats(),
            # Telemetry-ingest shard map + frame-log progress + the
            # per-instance load-info snapshot ages (observable, not
            # inferred).
            "telemetry": mgr.stats(),
            "handoff_journal": self._journal.stats(),
            "snapshot_age_s": mgr.snapshot_age_s(),
            "frame_log_seq": self.scheduler.kvcache_mgr.frame_log_seq(),
            "loadinfo": {
                "ages_s": mgr.load_info_ages_s(),
                "stale": sorted(mgr.stale_load_names()),
                "stale_after_s": self.opts.loadinfo_stale_after_s,
            },
        })

    async def handle_get_faults(self, request: web.Request) -> web.Response:
        """Inspect the deterministic fault-injection plane (rules + hit/fire
        counters)."""
        return web.json_response({
            "seed": FAULTS.seed,
            "rules": [r.to_dict() for r in FAULTS.rules()]})

    async def handle_set_faults(self, request: web.Request) -> web.Response:
        """Configure the fault plane: `{"rules": [...], "seed": N}` replaces
        the rule set (seeded → deterministic), `{"clear": true}` disarms."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON")
        if not isinstance(body, dict):
            return _error_response(400, "request body must be a JSON object")
        if body.get("clear"):
            FAULTS.clear()
        if body.get("rules") is not None:
            try:
                FAULTS.configure(body["rules"], seed=body.get("seed"))
            except (TypeError, ValueError) as e:
                return _error_response(400, f"bad fault rule: {e}")
        return web.json_response({
            "ok": True, "seed": FAULTS.seed,
            "rules": [r.to_dict() for r in FAULTS.rules()]})

    async def handle_set_config(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON")
        applied = {}
        for key, value in (body or {}).items():
            caster = self._RELOADABLE.get(key)
            if caster is None:
                return _error_response(
                    400, f"{key} is not live-reloadable "
                         f"(reloadable: {sorted(self._RELOADABLE)})")
            try:
                cast_value = caster(value)
            except (TypeError, ValueError):
                return _error_response(400, f"bad value for {key}")
            if key.startswith("target_") and cast_value <= 0:
                return _error_response(400, f"{key} must be positive")
            setattr(self.opts, key, cast_value)
            applied[key] = cast_value
        if "enable_tracing" in applied:
            # Live span-tracing toggle (e.g. shed the overhead under a
            # traffic spike without a restart).
            TRACER.configure(enabled=self.opts.enable_tracing)
        if "trace_sample_rate" in applied:
            # Live sampling knob: dial down under a traffic spike without
            # losing anomalies (tail-based keep still promotes them).
            TRACER.configure(sample_rate=self.opts.trace_sample_rate)
        return web.json_response({"ok": True, "applied": applied})

    # ----------------------------------------------------------- RPC routes
    async def handle_handoff(self, request: web.Request) -> web.StreamResponse:
        """Owner-side ingest of a request relayed by another frontend
        (multimaster/handoff.py): run the FULL local pipeline — schedule,
        dispatch, failover bookkeeping, trace assembly — under the
        relay-supplied service id. Never re-relays: the accepting
        frontend resolved ownership, and re-resolving here on a
        membership race could loop. The response (SSE frames or one JSON
        document) streams back to the relay, which copies it to the
        client — dropping the already-delivered frame prefix on a
        re-owned replay."""
        sid = request.query.get("sid", "")
        kind = request.query.get("kind", "completion")
        if not sid:
            return _error_response(400, "missing sid")
        try:
            attempt = int(request.query.get("attempt", 0))
            skip = int(request.query.get("skip", 0))
        except (TypeError, ValueError):
            attempt, skip = 0, 0
        if attempt > 0:
            # Relay reconnect: if THIS owner journaled the stream (the
            # relay retries the same owner first), replay the exact
            # recorded frames after `skip` — no pipeline re-run, so the
            # continuation is identical even under temperature>0
            # sampling. No journal (we are the rendezvous successor of a
            # dead owner) → fall through to the legacy full re-run with
            # relay-side frame dropping.
            entry = self._journal.get(sid)
            if entry is not None:
                HANDOFF_JOURNAL_REPLAYS_TOTAL.inc()
                return await self._replay_from_journal(request, sid, skip,
                                                       entry)
        HANDOFF_SERVED_TOTAL.inc()
        # The relay forwards the ABSOLUTE deadline it computed at accept
        # (x-xllm-deadline-ms) so the owner enforces the original
        # budget, not a fresh one restarted at the relay hop.
        try:
            deadline_ms = int(request.headers.get(ABS_DEADLINE_HEADER, 0))
        except (TypeError, ValueError):
            deadline_ms = 0
        if kind == "messages":
            return await self.handle_messages(request, sid=sid,
                                              deadline_override=deadline_ms)
        if kind not in ("chat", "completion"):
            return _error_response(400, f"unknown handoff kind {kind}")
        return await self._handle_generate(request, kind, sid=sid,
                                           deadline_override=deadline_ms)

    async def _replay_from_journal(self, http_req: web.Request, sid: str,
                                   skip: int, entry) -> web.StreamResponse:
        """Serve a relay reconnect from the delta journal: stream the
        recorded frames after ``skip``, then follow the LIVE journal
        growth (the original generation keeps appending while detached)
        until the stream finishes. Pure frame copy — the engine sees
        nothing."""
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "text/event-stream"
        resp.headers["Cache-Control"] = "no-cache"
        await resp.prepare(http_req)
        i = max(0, skip)
        deadline = time.monotonic() + self.opts.request_timeout_s
        try:
            while True:
                # Keep the journal (and the detached generation's grace
                # window) alive while this replay is attached: the
                # detached _respond loop extends its deadline off
                # `touched`, so an active replay is never cancelled
                # under it mid-stream.
                entry.touched = time.monotonic()
                frames = entry.frames
                while i < len(frames):
                    await resp.write(frames[i])
                    i += 1
                if entry.finished and i >= len(entry.frames):
                    break
                if time.monotonic() > deadline:
                    break
                await asyncio.sleep(0.02)
            await resp.write_eof()
        except (ConnectionResetError, OSError):
            pass   # the relay broke again; its next attempt re-enters here
        return resp

    async def handle_handoff_abort(self, request: web.Request) -> web.Response:
        """Relay-signalled CLIENT abort of a relayed stream: the journal
        grace exists for transport blips, but a gone client must cancel
        NOW (engine capacity, exit accounting) — the relay distinguishes
        the two, this endpoint enacts it. Idempotent; unknown sids ack."""
        sid = request.query.get("sid", "")
        if not sid:
            return _error_response(400, "missing sid")
        entry = self._journal.get(sid)
        if entry is not None:
            DeltaJournal.finish(entry)
        cancelled = await asyncio.get_running_loop().run_in_executor(
            None, self.scheduler.cancel_request, sid, 499,
            "client disconnected at relay", "disconnect")
        return web.json_response({"ok": True, "cancelled": cancelled})

    async def handle_flip_hint(self, request: web.Request) -> web.Response:
        """Replica→master write-lease proxy for PD-role flips: a
        non-elected frontend's SLO policy saw a role imbalance, but the
        coordination writes a flip performs are master-only (frame-log +
        instance-key invariants). The hint lands in this master's pending
        set; its reconcile thread executes. If mastership just moved, the
        local drain re-proxies to the current master — convergent."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON")
        if not isinstance(body, dict) or not body.get("name"):
            return _error_response(400, "missing instance name")
        try:
            new_type = InstanceType.parse(body.get("type"))
        except ValueError:
            return _error_response(400, f"bad type {body.get('type')!r}")
        self.scheduler.instance_mgr.request_flip(str(body["name"]), new_type)
        return web.json_response({"ok": True,
                                  "master": self.scheduler.is_master})

    async def handle_heartbeat(self, request: web.Request) -> web.Response:
        """Per-instance heartbeat (load/latency metrics + KV-cache event
        delta). Wire is msgpack by default — KV-event block keys ride as
        raw 16 bytes instead of hex JSON strings — with the JSON path kept
        for legacy agents (agents demote themselves when a legacy master
        rejects their binary heartbeat; see EngineAgent._heartbeat_loop).
        """
        body = await request.read()
        try:
            payload = wire.decode_body(request.content_type, body)
        except ValueError:
            return _error_response(400, "invalid payload")
        if not isinstance(payload, dict):
            return _error_response(400, "invalid payload")
        known = await asyncio.get_running_loop().run_in_executor(
            None, self.scheduler.handle_instance_heartbeat, payload)
        resp: dict[str, Any] = {"ok": True, "known": known}
        owner = self.scheduler.instance_mgr.telemetry_owner_addr(
            payload.get("name", ""))
        if owner:
            # Sharded ingest: tell the engine who owns its telemetry so
            # a beat that landed here on a membership race re-routes.
            resp["owner"] = owner
        return web.json_response(resp)

    def _ingest_gens_batch(self, gens: list) -> dict[str, bool]:
        """Shared Generations-delta ingest (direct POSTs and multiplexed
        telemetry frames): parse + dispatch the whole batch in one go,
        measured into the `stream` CPU-attribution bucket."""
        with CPU_ATTR.measure("stream"):
            results: dict[str, bool] = {}
            for gen in gens:
                out = RequestOutput.from_dict(gen)
                results[out.service_request_id] = \
                    self.scheduler.handle_generation(out)
            return results

    async def handle_telemetry(self, request: web.Request) -> web.Response:
        """Multiplexed engine telemetry session: tagged
        msgpack frames on ONE keepalive connection per engine, routed to
        the engine's owning master. "hb" frames ingest like
        /rpc/heartbeat; "gens" frames carry a `dest` service address —
        ingested here when dest is us, relayed master->master otherwise
        (the fan-out the engine no longer pays: per-engine connections
        stay O(1) while masters scale). Responses carry per-dest
        delivery verdicts so the engine's per-dest retry/cancel
        machinery keeps working unchanged."""
        body = await request.read()
        try:
            payload = wire.decode_body(request.content_type, body)
        except ValueError:
            return _error_response(400, "invalid payload")
        frames = payload.get("frames") if isinstance(payload, dict) else None
        if not isinstance(frames, list):
            return _error_response(400, "invalid payload: frames required")
        loop = asyncio.get_running_loop()
        self_addr = self.scheduler.self_addr
        alive: dict[str, bool] = {}
        dest_ok: dict[str, bool] = {}
        out: dict[str, Any] = {"ok": True}
        relays: list = []
        for fr in frames:
            if not isinstance(fr, dict):
                continue
            tag = fr.get("t")
            if tag == wire.TELEMETRY_HB:
                hb = fr.get("d") or {}
                out["known"] = await loop.run_in_executor(
                    None, self.scheduler.handle_instance_heartbeat, hb)
                owner = self.scheduler.instance_mgr.telemetry_owner_addr(
                    hb.get("name", ""))
                if not owner and \
                        not self.scheduler.instance_mgr.sharded():
                    # A mux beat landed on a master-mode (funnel)
                    # service: in that fleet only the ELECTED master
                    # uploads load metrics from locally-ingested beats,
                    # so hint the engine there — otherwise its beats
                    # strand telemetry on whichever replica the
                    # rendezvous map picked (mixed-config hazard).
                    owner = await loop.run_in_executor(
                        None, self.scheduler.elected_master_addr)
                if owner:
                    out["owner"] = owner
            elif tag == wire.TELEMETRY_GENS:
                dest = fr.get("dest") or self_addr
                gens = (fr.get("d") or {}).get("gens", [])
                if dest == self_addr:
                    if len(gens) <= 32:
                        results = self._ingest_gens_batch(gens)
                    else:
                        results = await loop.run_in_executor(
                            None, self._ingest_gens_batch, gens)
                    alive.update(results)
                    dest_ok[dest] = True
                else:
                    relays.append(self._relay_gens(dest, gens))
        for dest, ok, dest_alive in await asyncio.gather(*relays):
            dest_ok[dest] = ok
            alive.update(dest_alive)
        out["alive"] = alive
        out["dest_ok"] = dest_ok
        return web.json_response(out)

    async def _relay_gens(self, dest: str,
                          gens: list) -> tuple[str, bool, dict]:
        """Master->master relay of a foreign-dest generation batch over
        the kept-alive session; a failed relay reports dest_ok=False so
        the ENGINE keeps those frames queued and retries — the relay
        itself never re-sends (delta dedup belongs to the per-request seq
        numbers)."""
        TELEMETRY_GENS_RELAYED_TOTAL.labels(dest=dest).inc()
        data, ctype = wire.encode_dispatch({"gens": gens},
                                           wire.WIRE_MSGPACK)
        try:
            r = await asyncio.get_running_loop().run_in_executor(
                self._post_executor, self._post,
                f"http://{dest}/rpc/generations", data, ctype, 10.0)
            if r.status_code != 200:
                return dest, False, {}
            payload = r.json()
            return dest, True, dict(payload.get("alive") or {})
        except (ChannelError, ValueError, AttributeError):
            return dest, False, {}

    async def handle_generations(self, request: web.Request) -> web.Response:
        """Batched generation deltas (reference `Generations` RPC,
        `rpc_service/service.cpp:149-215`). Response tells the engine which
        requests are dead so it can stop generating them.

        This is the service plane's hottest ingest loop: the whole batch is
        parsed and dispatched in ONE executor hop (an await per delta would
        serialize the event loop against the worker pool), and the wire
        format may be msgpack (binary, the engine agent's default — the
        reference uses batched protobuf here for the same reason) or JSON.
        """
        body = await request.read()
        try:
            payload = wire.decode_body(request.content_type, body)
        except ValueError:
            return _error_response(400, "invalid payload")
        if not isinstance(payload, dict):
            return _error_response(400, "invalid payload")

        gens = list(payload.get("gens", ()))
        if len(gens) <= 32:
            # Small batch: ingest inline. handle_generation is dict work
            # under a short lock hold (formatting/SSE rides the output
            # lanes, not this handler) — an executor hop per batch costs
            # a thread wake on the first-token path for no protection.
            results = self._ingest_gens_batch(gens)
        else:
            # Big batch (engine catch-up after a stall): keep the loop
            # responsive, take the one executor hop.
            results = await asyncio.get_running_loop().run_in_executor(
                None, self._ingest_gens_batch, gens)
        return web.json_response({"ok": True, "alive": results})

    async def handle_instance_info(self, request: web.Request) -> web.Response:
        name = request.query.get("name", "")
        meta = self.scheduler.instance_mgr.get_instance_meta(name)
        if meta is None:
            return _error_response(404, f"unknown instance {name}")
        return web.json_response(json.loads(meta.to_json()))

    async def handle_prefill_list(self, request: web.Request) -> web.Response:
        metas = self.scheduler.instance_mgr.list_instances(InstanceType.PREFILL)
        return web.json_response({"instances": [m.name for m in metas]})

    async def handle_decode_list(self, request: web.Request) -> web.Response:
        metas = self.scheduler.instance_mgr.list_instances(InstanceType.DECODE)
        return web.json_response({"instances": [m.name for m in metas]})
