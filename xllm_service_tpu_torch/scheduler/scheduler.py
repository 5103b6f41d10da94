"""Central orchestrator (port of ``xllm_service_tpu/scheduler/scheduler.py``:
any number of active masters, one of them elected; RR, CAR or SLO_AWARE
routing; the planner, and the closed-loop autoscaler that enacts its
flips when enabled).

Parity: reference `scheduler/scheduler.{h,cpp}` (733 LoC, SURVEY.md §2.4,
§3.2-3.5):

- ctor: tokenizer + chat template, coordination client, self-registration
  under `XLLM:SERVICE:<addr>` with a TTL lease, master election by
  create-if-absent on `XLLM:SERVICE:MASTER`, InstanceMgr + GlobalKVCacheMgr +
  LB policy construction, master 3s upload loop, replica watch-takeover.
- `schedule()`: chat-template apply → tokenize → `select_instances_pair` →
  bind incarnations → SLO accounting.
- `record_new_request()`: request registry keyed by service_request_id with
  per-request output-ordering lane pinning; output callbacks built from
  ResponseHandler (streaming parse state per request).
- `handle_generation()`: registry lookup, client-disconnect cancellation,
  TTFT/ITL metrics, callback dispatch on the pinned lane.
- `clear_requests_on_failed_instance()`: the reference cancel-and-surfaces
  every request bound to a dead (instance, incarnation, role)
  (`scheduler.cpp:443-482`). We go further: **transparent failover** —
  in-flight requests are re-dispatched to a surviving pair, decode resumed
  by extending the prompt with the tokens already streamed, under a
  per-request retry budget with exponential backoff. Replay is idempotent:
  the request is re-bound to the new incarnations first, and deltas from
  incarnations it is no longer bound to are dropped in
  `handle_generation()`. Cancel-and-surface remains the fallback
  (`failover_max_retries=0`, no replay payload, or budget exhausted).
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from ..autoscaler import AutoscalerController, create_actuator
from ..chat_template import JinjaChatTemplate
from ..common import tracing
from ..common.call_data import ClientConnection
from ..common.config import ServiceOptions
from ..common.hotpath import CPU_ATTR, HOTPATH
from ..common.metrics import (
    FAILOVER_ATTEMPTS_TOTAL,
    FAILOVER_SUCCESS_TOTAL,
    ITL_MS,
    REQUESTS_CANCELLED_TOTAL,
    TTFT_MS,
)
from ..common.flightrecorder import RECORDER
from ..common.ordered_executor import OrderedExecutor
from ..common.slo import SLO_MONITOR
from ..common.request import (
    Request,
    RequestOutput,
    SequenceOutput,
    Status,
    StatusCode,
    Usage,
)
from ..common.tracing import TRACER
from ..common.types import (
    InstanceType,
    KvCacheEvent,
    LatencyMetrics,
    LoadMetrics,
    RequestAction,
    now_ms,
)
from ..coordination import CoordinationClient, connect
from ..coordination.base import KeyEvent, WatchEventType
from ..coordination.health import CoordinationHealthMonitor, HeldAction
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..overload import ADMISSION, BROWNOUT, RETRY_BUDGET
from ..overload.deadline import deadline_expired
from ..rpc import MASTER_KEY, SERVICE_KEY_PREFIX
from ..scheduler.global_kvcache_mgr import GlobalKVCacheMgr
from ..scheduler.instance_mgr import InstanceMgr
from ..multimaster.ownership import OwnershipRouter
from ..scheduler.planner import PLANNER_KEY, Planner
from ..scheduler.policies import create_policy
from ..scheduler.policies.slo_aware import SloAwarePolicy
from ..scheduler.response_handler import ChatStreamState, ResponseHandler
from ..tokenizer import TokenizerFactory
from ..utils import get_logger, jittered_backoff

logger = get_logger(__name__)


class _RequestState:
    __slots__ = ("request", "conn", "lane", "kind", "stream_state",
                 "accum", "first_token_ms", "last_token_ms", "finished",
                 "exited", "last_delta_seq", "forward_path",
                 "forward_payload", "replay_token_ids", "failover_attempts",
                 "failing", "in_failover", "dispatch_done_pc")

    def __init__(self, request: Request, conn: ClientConnection, lane: int,
                 kind: str, stream_state: Optional[ChatStreamState],
                 forward_path: Optional[str] = None,
                 forward_payload: Optional[dict[str, Any]] = None):
        self.request = request
        self.conn = conn
        self.lane = lane
        self.kind = kind                  # "chat" | "completion"
        self.stream_state = stream_state  # only for streaming chat
        self.accum: dict[int, SequenceOutput] = {}   # non-stream aggregation
        self.first_token_ms: Optional[int] = None
        self.last_token_ms: Optional[int] = None
        self.finished = False
        # Exit accounting ran (exactly-once guard across the normal-finish,
        # disconnect, GC-timeout and instance-failure paths).
        self.exited = False
        # Highest engine delta_seq processed — dedup for retried deliveries.
        self.last_delta_seq = 0
        # Replay material for transparent failover: the enriched engine
        # payload the HTTP layer originally forwarded (None = this request
        # cannot be replayed → cancel-and-surface), plus every index-0
        # token id already delivered to the client (decode resumes by
        # extending the prompt with exactly these).
        self.forward_path = forward_path
        self.forward_payload = forward_payload
        self.replay_token_ids: list[int] = []
        self.failover_attempts = 0
        # True while the request is between instances (its old instance
        # failed, re-dispatch pending): in-flight deltas from the old
        # binding are void and must be dropped.
        self.failing = False
        # Serialization guard: the dispatch-failure executor thread and
        # the instance-death failover thread can both reach this request;
        # only one may run the failover loop (the other would double-burn
        # the retry budget and double-dispatch).
        self.in_failover = False
        # perf_counter at engine-accept of the initial dispatch; the
        # first-token path turns it into the hot-path "first_delta" stage
        # sample (engine accept -> first Generations delta ingested).
        self.dispatch_done_pc: Optional[float] = None


@_ownership.verify_state
class Scheduler:
    def __init__(self, options: ServiceOptions,
                 coord: Optional[CoordinationClient] = None,
                 start_threads: bool = True):
        self._opts = options
        self._coord = coord or connect(
            options.coordination_addr, options.coordination_namespace,
            options.coordination_username, options.coordination_password,
            reconnect_max_backoff_s=options.coordination_reconnect_jitter_s)
        self.self_addr = f"{options.host}:{options.rpc_port}"

        # NLP components (reference `scheduler.cpp:35-58`).
        self.tokenizer = TokenizerFactory.create_tokenizer(options.tokenizer_path)
        template = TokenizerFactory.load_chat_template(options.tokenizer_path)
        self.chat_template = JinjaChatTemplate(template)

        # Self-registration + master election (reference
        # `scheduler.cpp:72-76,170-184`). A master that loses the election
        # starts as an ACTIVE replica frontend: it takes the key over on
        # its DELETE (`_on_master_event`).
        self._coord.set(SERVICE_KEY_PREFIX + self.self_addr,
                        json.dumps({"rpc_address": self.self_addr}),
                        ttl_s=options.lease_ttl_s)
        self.is_master = self._coord.create_if_absent(
            MASTER_KEY, self.self_addr, ttl_s=options.lease_ttl_s)

        # Coordination-plane static stability: classify the plane
        # CONNECTED -> DEGRADED -> RECOVERING from client-side evidence
        # on the sync cadence. While degraded: census frozen (InstanceMgr
        # consults it), mastership sticky, ownership-changing actions
        # held; on recovery `_recover_from_outage` re-asserts and
        # replays-or-discards.
        self.coordination_health = CoordinationHealthMonitor(
            self._coord, options, entity=self.self_addr,
            on_recovered=self._recover_from_outage)

        # Multi-master service plane: every replica is an ACTIVE frontend;
        # per-request ownership is decided by rendezvous hashing over the
        # live service records this router mirrors (multimaster/).
        self.ownership = OwnershipRouter(
            self._coord, self.self_addr,
            enabled=options.multimaster_ownership,
            mine_ids=options.multimaster_mine_owned_ids)

        self.instance_mgr = InstanceMgr(self._coord, options,
                                        is_master=self.is_master,
                                        start_threads=start_threads,
                                        ownership=self.ownership,
                                        health=self.coordination_health)
        # Pooled session for the owner->elected-master KV-event relay
        # (sharded telemetry: the index stays write-leased; see
        # handle_instance_heartbeat).
        from ..rpc.channel import make_keepalive_session
        self._kv_relay_session = make_keepalive_session(
            pool_connections=2, pool_maxsize=2)
        self.kvcache_mgr = GlobalKVCacheMgr(self._coord, options.block_size,
                                            is_master=self.is_master,
                                            options=options)
        self.instance_mgr.on_instance_failure = self._on_instance_failure
        self.lb_policy = create_policy(options.load_balance_policy,
                                       self.instance_mgr, self.kvcache_mgr,
                                       options)
        self.planner = Planner(self.instance_mgr, options)
        # Closed-loop autoscaler (autoscaler/): master-gated controller
        # turning SLO burn rates + planner pressure into fleet actions
        # through a pluggable actuator. Constructed always (the admin
        # surface reports state either way); it self-gates on
        # `autoscaler_enabled` and the election. With the controller
        # enabled, planner and SLO-policy PD flips route through it —
        # ONE actuation path; disabled (default) keeps the hint-only
        # behavior.
        self.autoscaler = AutoscalerController(
            options, self.instance_mgr,
            create_actuator(options, self._coord),
            planner=self.planner,
            is_master_fn=lambda: self.is_master,
            degraded_fn=self.coordination_health.degraded)
        if options.autoscaler_enabled:
            self.planner.flip_sink = self.autoscaler.propose_flip
            if isinstance(self.lb_policy, SloAwarePolicy):
                self.lb_policy.flip_sink = self.autoscaler.propose_flip
        self.response_handler = ResponseHandler(
            options.model_id, options.tool_call_parser,
            options.reasoning_parser)

        # Request registry + ordered output lanes (reference
        # `scheduler.h:127-133`). RLock: exit paths run accounting while
        # holding it so a concurrent first-token delta can't interleave a
        # FINISH_PREFILL after a CANCEL (which would leak decode load).
        self._requests: dict[str, _RequestState] = {}
        self._req_lock = make_lock("scheduler.requests", order=10, reentrant=True)  # lock-order: 10
        self._output_executor = OrderedExecutor(options.num_output_threads)
        # Dedicated bounded pool for schedule() (template/tokenize/route/
        # bind): on the default event-loop executor a schedule queues
        # behind generations-ingest batches and heartbeat handling, and a
        # failover sleeping on backoff could starve admission entirely.
        self.schedule_executor = ThreadPoolExecutor(
            max_workers=max(1, options.num_schedule_threads),
            thread_name_prefix="schedule")

        self._stopped = threading.Event()
        self._master_watch_id: Optional[int] = None
        if not self.is_master:
            self._master_watch_id = self._coord.add_watch(
                MASTER_KEY, self._on_master_event)
        self._sync_thread: Optional[threading.Thread] = None
        if start_threads:
            self._sync_thread = threading.Thread(
                target=self._sync_loop, name="scheduler-sync", daemon=True)
            self._sync_thread.start()

    def update_self_addr(self, addr: str) -> None:
        """Re-register after the serving port is actually bound (ephemeral
        ports are only known post-bind). Engines resolve the master address
        from coordination, so the records must carry the real port."""
        if addr == self.self_addr:
            return
        old = self.self_addr
        with _ownership.escape("post-bind re-registration: rebinds the "
                               "init-only self_addr once, before traffic"):
            self.self_addr = addr
        self._coord.rm(SERVICE_KEY_PREFIX + old)
        self._coord.set(SERVICE_KEY_PREFIX + addr,
                        json.dumps({"rpc_address": addr}),
                        ttl_s=self._opts.lease_ttl_s)
        self.coordination_health.update_entity(addr)
        self.ownership.update_self_addr(addr)
        if self.is_master:
            # Overwrite in place — we hold the lease. A rm+create would fire
            # a DELETE watch event and race replica takeover (split brain).
            self._coord.set(MASTER_KEY, addr, ttl_s=self._opts.lease_ttl_s)

    # --------------------------------------------------------------- master
    def _on_master_event(self, events: list[KeyEvent], _prefix: str) -> None:
        """Replica takeover on master-key expiry (reference
        `scheduler.cpp:200-217`)."""
        for ev in events:
            if ev.key == MASTER_KEY and ev.type == WatchEventType.DELETE:
                if self.coordination_health.degraded():
                    # Census freeze, mastership edition: during/right
                    # after an outage this DELETE is (or may be) the
                    # client's watch-resync synthesizing "every lease
                    # lapsed" — NOT evidence the master died. Contending
                    # now would flip mastership on every blip and storm
                    # the recovering plane. `_recover_from_outage`
                    # re-checks the key once our own jitter slot passes
                    # and takes over then if it is genuinely vacant.
                    self.coordination_health.note_frozen(
                        "master_delete", ev.key)
                    continue
                self._try_takeover()

    def _try_takeover(self) -> bool:
        """Contend for the master key; promote on win."""
        if self._coord.create_if_absent(MASTER_KEY, self.self_addr,
                                        ttl_s=self._opts.lease_ttl_s):
            logger.info("service %s promoted to master", self.self_addr)
            self.is_master = True
            self.instance_mgr.set_as_master()
            self.kvcache_mgr.set_as_master()
            if self._master_watch_id is not None:
                self._coord.remove_watch(self._master_watch_id)
                self._master_watch_id = None
            return True
        return False

    def _sync_loop(self) -> None:
        """Master 3s upload loop (reference `scheduler.cpp:160-168`) + stale
        request GC."""
        while not self._stopped.wait(self._opts.sync_interval_s):
            self.sync_once()

    def elected_master_addr(self) -> str:
        """The elected master's service address ("" when unknown):
        self when we hold the lease, a coordination read otherwise.
        Blocking — callers off the event loop only."""
        if self.is_master:
            return self.self_addr
        try:
            return self._coord.get(MASTER_KEY) or ""
        except Exception:  # noqa: BLE001  # xlint: allow-broad-except(hint-only: a coordination blip degrades to no owner hint, the engine keeps its current target)
            return ""

    def sync_once(self) -> None:
        # Probe the coordination plane first: everything below keys off
        # whether THIS tick sees it degraded (a recovery callback fires
        # inside tick(), so a recovered tick already runs un-frozen).
        self.coordination_health.tick()
        plane_degraded = self.coordination_health.degraded()
        if self.is_master:
            # Verify we still hold the election key: after a coordination
            # outage a replica may have legitimately won while our lease
            # was lapsed (the client will NOT re-assert a create_only key
            # someone else holds) — demote instead of split-braining.
            # This check deliberately runs even while degraded — the
            # fencing rule: an *unreachable* plane (get -> None) never
            # demotes (sticky mastership), but a plane that ANSWERS and
            # names someone else always does, immediately.
            owner = self._coord.get(MASTER_KEY)
            if owner is not None and owner != self.self_addr:
                logger.warning("lost mastership to %s; demoting", owner)
                self.is_master = False
                self.instance_mgr.set_as_replica()
                self.kvcache_mgr.set_as_replica()
                # Fencing, part two: anything queued while we thought we
                # were still the owner must never execute under the new
                # master — discard, never replay.
                self.coordination_health.discard_held(
                    f"demoted: observed {owner} holding the write lease")
                if self._master_watch_id is None:
                    self._master_watch_id = self._coord.add_watch(
                        MASTER_KEY, self._on_master_event)
        # Sharded telemetry plane: EVERY active frontend publishes the
        # coalesced load/lease frame for its own shard — frame keys are
        # single-writer (keyed by owner address), so this is the one
        # coordination write that deliberately bypasses the election
        # gate. No-op outside sharded mode. (While degraded it holds
        # internally and keeps accumulating dirty shards — the frame
        # resync material.)
        try:
            self.instance_mgr.publish_telemetry_frames()
        except Exception:  # noqa: BLE001 — telemetry must not kill sync
            logger.exception("telemetry frame publish failed")
        decision = None
        if self.is_master and plane_degraded:
            # Sticky mastership: keep serving/routing from last-known-good
            # snapshots, but suspend every coordination-publishing action
            # into the held log (coalesced per kind, so a long outage
            # stays one entry each).
            h = self.coordination_health
            h.hold("kvframe_publish", self.self_addr,
                   reason="plane degraded: KV-frame publish suspended")
            h.hold("loadmetrics_upload", self.self_addr,
                   reason="plane degraded: load-metrics upload suspended")
            h.hold("planner_publish", self.self_addr,
                   reason="plane degraded: planner decision publish "
                          "suspended")
            if self._opts.autoscaler_enabled:
                h.hold("autoscaler_tick", self.self_addr,
                       reason="plane degraded: autoscaler enactment "
                              "suspended")
        elif self.is_master:
            self.kvcache_mgr.upload_kvcache()
            self.instance_mgr.upload_load_metrics()
            # Fleet-level planning (scale hints + PD-ratio correction;
            # reference Planner component, docs/en/overview.md:56-60).
            try:
                decision = self.planner.plan_once()
                self._coord.set(PLANNER_KEY, decision.to_json())
            except Exception:  # noqa: BLE001 — planning must not kill sync
                logger.exception("planner pass failed")
        # Closed-loop autoscaler tick. Self-gating: disabled or
        # non-elected controllers gather nothing and act on nothing (a
        # demoted master's straggler tick enacts zero actions — the
        # write-lease discipline the multimaster drills assert).
        try:
            self.autoscaler.tick(decision)
            self.autoscaler.reap_departed()
        except Exception:  # noqa: BLE001 — scaling must not kill sync
            logger.exception("autoscaler tick failed")
        # Brownout evaluation (overload plane): every frontend degrades
        # its OWN traffic off its own burn monitor — no election gate.
        try:
            BROWNOUT.tick()
        except Exception:  # noqa: BLE001 — degradation must not kill sync
            logger.exception("brownout tick failed")
        self._gc_stale_requests()

    def _recover_from_outage(self) -> None:
        """Post-outage re-assertion (sync thread; fired by the health
        monitor once RECOVERING has waited out this entity's jitter slot
        — the fleet-wide spread is what keeps recovery storm-free).
        Order matters: re-register, reconcile mastership against what
        coordination NOW says (fencing), replay-or-discard the held
        actions, then queue a full frame-log resync."""
        try:
            self._coord.set(SERVICE_KEY_PREFIX + self.self_addr,
                            json.dumps({"rpc_address": self.self_addr}),
                            ttl_s=self._opts.lease_ttl_s)
        except Exception:  # noqa: BLE001  # xlint: allow-broad-except(re-registration is retried by the client keepalive; a throw here must not abort held-action replay)
            logger.exception("post-outage re-registration failed")
        owner = self._coord.get(MASTER_KEY)
        if self.is_master:
            if owner is None:
                # Our lease lapsed during the outage and nobody won yet:
                # re-contend for our own seat.
                if not self._coord.create_if_absent(
                        MASTER_KEY, self.self_addr,
                        ttl_s=self._opts.lease_ttl_s):
                    owner = self._coord.get(MASTER_KEY)
            if owner is not None and owner != self.self_addr:
                logger.warning("post-outage: %s won mastership; demoting",
                               owner)
                self.is_master = False
                self.instance_mgr.set_as_replica()
                self.kvcache_mgr.set_as_replica()
                self.coordination_health.discard_held(
                    f"demoted: {owner} won the election during the outage")
                if self._master_watch_id is None:
                    self._master_watch_id = self._coord.add_watch(
                        MASTER_KEY, self._on_master_event)
        elif owner is None:
            # The takeover we held while frozen (`_on_master_event`): the
            # key is genuinely vacant now that the plane answers — the
            # old master either died or has not re-asserted within its
            # own jitter slot. Jitter spreads this contention too.
            self._try_takeover()
        try:
            for action in self.coordination_health.drain_held():
                outcome = self._replay_held_action(action)
                RECORDER.record("held_action_replay",
                                detail={**action.to_dict(),
                                        "outcome": outcome})
                logger.info("held action %s(%s) x%d -> %s",
                            action.kind, action.key, action.count, outcome)
        finally:
            self.coordination_health.replay_done()
        self.instance_mgr.resync_after_outage()

    def _replay_held_action(self, action: HeldAction) -> str:
        """Decide one held action's fate after recovery. Returns the
        flight-recorded outcome string."""
        if action.kind in ("evict", "drain_deregister"):
            # Shard-owner verdicts, not election-gated ones: in sharded
            # ingest the telemetry owner (master OR replica) runs the
            # silence pipeline, so its held evictions replay here too —
            # replay_held_eviction re-checks ownership and liveness
            # against the recovered plane before acting.
            return self.instance_mgr.replay_held_eviction(
                action.key, action.reason or "post-outage replay")
        if not self.is_master:
            # Fencing backstop: by the time replay runs, anything queued
            # under a mastership we no longer hold is dead.
            return "discarded: no longer master"
        # Publish/enact kinds (kvframe_publish, loadmetrics_upload,
        # planner_publish, autoscaler_tick, loadframe_publish, flip):
        # these re-derive from live state every sync tick — replaying the
        # stale frame would publish the past over the present.
        return "superseded: next sync tick republishes from live state"

    def _gc_stale_requests(self) -> None:
        """Deadline sweep: per-request deadlines (overload plane) are the
        primary bound; the blunt `request_timeout_s` silence GC remains
        the backstop for requests without one."""
        horizon = now_ms() - int(self._opts.request_timeout_s * 1000)
        now = now_ms()
        with self._req_lock:
            stale = [st for st in self._requests.values()
                     if st.request.latest_generate_time_ms < horizon
                     or deadline_expired(st.request.deadline_ms, now)]
        for st in stale:
            expired = deadline_expired(st.request.deadline_ms, now)
            msg = "deadline exceeded" if expired else "request timed out"
            if not self._cancel_request_state(st, 504, msg,
                                              reason="deadline"):
                continue   # a concurrent path finished it first
            logger.warning("request %s %s; cancelling",
                           st.request.service_request_id, msg)

    # -------------------------------------------------------- cancellation
    def _cancel_request_state(self, st: _RequestState, code: int,
                              message: str, reason: str) -> bool:
        """Service-side cancellation of one in-flight request: winning-
        exit accounting, engine-side stop (the existing
        `_cancel_on_engines` path — engines ack and stop decoding), the
        client error, and the `requests_cancelled_total{reason}` count.
        Deadline cancellations also capture a flight-recorder bundle
        (an expired request IS an anomaly worth a post-mortem)."""
        if not self._remove_request(st, error=(code, message)):
            return False
        REQUESTS_CANCELLED_TOTAL.labels(reason=reason).inc()
        if reason == "deadline":
            r = st.request
            trace_id = r.span.trace_id if r.span else \
                (r.trace.trace_id if r.trace else "")
            TRACER.keep_trace(trace_id)
            RECORDER.record(
                "deadline", request_id=r.service_request_id,
                trace_id=trace_id,
                detail={"message": message,
                        "deadline_ms": r.deadline_ms,
                        "overdue_ms": now_ms() - r.deadline_ms
                        if r.deadline_ms else None,
                        "generated_tokens": r.num_generated_tokens,
                        "prefill": r.routing.prefill_name,
                        "decode": r.routing.decode_name})
        self._cancel_on_engines(st.request)
        self._output_executor.submit_to_lane(
            st.lane, lambda: st.conn.finish_with_error(code, message))
        return True

    def cancel_request(self, service_request_id: str, code: int = 504,
                       message: str = "deadline exceeded",
                       reason: str = "deadline") -> bool:
        """Public cancellation entry (deadline enforcement from the HTTP
        layer's response wait, operator tooling). Blocking — issues
        engine RPCs; call off the event loop."""
        with self._req_lock:
            st = self._requests.get(service_request_id)
        if st is None:
            return False
        return self._cancel_request_state(st, code, message, reason)

    # ------------------------------------------------------------- schedule
    def schedule(self, request: Request) -> Status:
        """Reference `scheduler.cpp:107-153`."""
        own_root = False
        if request.span is None:
            # Direct-scheduler callers (tests, embedded use) get a root
            # span here; the HTTP frontend normally created it already.
            root = TRACER.start_span("frontend.request",
                                     request_id=request.service_request_id,
                                     origin="scheduler")
            if root:
                request.span = root
                request.trace = root.context()
                own_root = True
        with TRACER.span("scheduler.schedule", ctx=request.trace,
                         request_id=request.service_request_id,
                         policy=self._opts.load_balance_policy) as sp:
            status = self._schedule(request)
            if status.ok():
                sp.set(prefill=request.routing.prefill_name,
                       decode=request.routing.decode_name,
                       prompt_tokens=request.metrics.prompt_tokens)
            else:
                sp.set(error=status.message)
        if not status.ok() and own_root:
            # A failed schedule is never registered, so exit accounting
            # will not end the root we created — end it here or the trace
            # loses its frontend.request root. (The HTTP frontend does the
            # same for roots it owns.)
            request.span.end(f"ERROR: {status.code.name}")
        return status

    def _schedule(self, request: Request) -> Status:
        # Per-stage sub-spans under the scheduler.schedule span (the
        # thread-active context): attribution for the master hot-path
        # budget. All four are no-ops when tracing is off.
        with CPU_ATTR.measure("route"):
            return self._schedule_inner(request)

    def _schedule_inner(self, request: Request) -> Status:
        ctx = tracing.current_context()
        sid = request.service_request_id
        if request.messages and not request.prompt:
            with TRACER.span("scheduler.template", ctx=ctx, request_id=sid):
                try:
                    request.prompt = self.chat_template.apply(
                        request.messages, request.tools,
                        request.chat_template_kwargs)
                except Exception as e:  # noqa: BLE001  # xlint: allow-broad-except(template errors surface to the client as INVALID_ARGUMENT)
                    return Status(StatusCode.INVALID_ARGUMENT,
                                  f"chat template error: {e}")
        if not request.token_ids and request.prompt:
            with TRACER.span("scheduler.tokenize", ctx=ctx,
                             request_id=sid) as sp:
                request.token_ids = self.tokenizer.encode(request.prompt)
                if self._opts.load_balance_policy == "CAR":
                    # Warm the memoized block hashes here so the cost is
                    # attributed to the tokenize stage, paid exactly once;
                    # the CAR match, failover re-selects and replays all
                    # reuse the cached chain.
                    request.prefix_hashes(self._opts.block_size)
                sp.set(prompt_tokens=len(request.token_ids))
        elif request.sampling.echo and not request.prompt \
                and request.token_ids:
            # Completions `echo` with an array-of-token-ids prompt: OpenAI
            # echoes the detokenized prompt text.
            request.prompt = self.tokenizer.decode(request.token_ids)
        request.metrics.prompt_tokens = len(request.token_ids)

        # Route + bind, RCU-validated: routing reads a lock-free snapshot,
        # so the selected pair may be superseded (evicted/replaced) before
        # the bind — bind re-checks against the CURRENT snapshot and a
        # failed bind re-selects (bounded; each retry reads a fresher
        # snapshot, so livelock requires perpetual fleet churn).
        for _ in range(3):
            with TRACER.span("scheduler.route", ctx=ctx,
                             request_id=sid) as sp:
                routing = self.lb_policy.select_instances_pair(request)
                sp.set(prefill=routing.prefill_name,
                       decode=routing.decode_name)
            if not routing.valid():
                return Status(StatusCode.UNAVAILABLE,
                              "no available instances")
            if request.has_images:
                # EPD: pin the vision-encode stage to a dedicated ENCODE
                # instance when the fleet has one (BASELINE config 5).
                routing.encode_name = \
                    self.instance_mgr.get_next_encode_instance()
            request.routing = routing
            with TRACER.span("scheduler.bind", ctx=ctx,
                             request_id=sid) as sp:
                bound = self.instance_mgr \
                    .bind_request_instance_incarnations(request)
                sp.set(ok=bound)
            if bound:
                break
        else:
            return Status(StatusCode.UNAVAILABLE,
                          "no available instances (fleet churning)")
        request.metrics.schedule_time_ms = now_ms()
        self.instance_mgr.update_request_metrics(request, RequestAction.SCHEDULE)
        return Status(StatusCode.OK)

    # ------------------------------------------------------ request registry
    def record_new_request(self, request: Request, conn: ClientConnection,
                           kind: str, forward_path: Optional[str] = None,
                           forward_payload: Optional[dict[str, Any]] = None,
                           ) -> None:
        """Register the in-flight request and build its output path
        (reference `record_new_request` overloads, `scheduler.cpp:279-414`).
        `forward_path`/`forward_payload` are the engine-facing dispatch the
        HTTP layer is about to send — kept for failover replay."""
        lane = self._output_executor.lane_for(request.service_request_id)
        stream_state = None
        if kind == "chat" and request.stream:
            stream_state = self.response_handler.create_chat_stream_state(request)
        elif kind == "anthropic" and request.stream:
            from .response_handler import AnthropicStreamState
            stream_state = AnthropicStreamState()
        st = _RequestState(request, conn, lane, kind, stream_state,
                           forward_path=forward_path,
                           forward_payload=forward_payload)
        with self._req_lock:
            self._requests[request.service_request_id] = st

    def mark_dispatch_complete(self, request: Request) -> None:
        """Engine accepted the initial dispatch: stamp the perf_counter the
        first-token path diffs into the hot-path `first_delta` stage."""
        with self._req_lock:
            st = self._requests.get(request.service_request_id)
            if st is not None and st.dispatch_done_pc is None:
                st.dispatch_done_pc = time.perf_counter()

    def dispatch_wire(self, name: str) -> str:
        """Negotiated dispatch-wire format for an instance (lock-free)."""
        return self.instance_mgr.dispatch_wire(name)

    def has_request(self, service_request_id: str) -> bool:
        with self._req_lock:
            return service_request_id in self._requests

    def num_inflight_requests(self) -> int:
        with self._req_lock:
            return len(self._requests)

    # ------------------------------------------------------------- heartbeat
    def handle_instance_heartbeat(self, payload: dict[str, Any]) -> bool:
        """Reference `scheduler.cpp:186-198` + RPC `Heartbeat`. Measured
        into the `ingest` CPU-attribution bucket — the share the sharded
        telemetry plane exists to spread across masters.

        KV-event routing under sharded ingest: load/lease telemetry is
        owner-ingested (this frontend), but the KV-cache INDEX stays
        WRITE-LEASED — one frame-log writer, the elected master. A
        non-elected telemetry owner therefore
        forwards the heartbeat's kv_cache_event to the elected master
        instead of applying it locally (a local apply would fork the
        replica index from the frame log it also mirrors); a lost
        forward costs cache-hit routing accuracy for one delta, never
        correctness."""
        with CPU_ATTR.measure("ingest"):
            name = payload.get("name", "")
            incarnation = payload.get("incarnation_id", "")
            load = LoadMetrics.from_dict(payload.get("load_metrics", {})) \
                if payload.get("load_metrics") else None
            latency = LatencyMetrics.from_dict(payload.get("latency_metrics", {})) \
                if payload.get("latency_metrics") else None
            known = self.instance_mgr.record_instance_heartbeat(
                name, incarnation, load, latency)
            kv = payload.get("kv_cache_event")
            if known and kv:
                if self.is_master:
                    self.kvcache_mgr.record_updated_kvcaches(
                        name, KvCacheEvent.from_dict(kv))
                else:
                    self._forward_kv_event(name, incarnation, kv)
            return known

    def _forward_kv_event(self, name: str, incarnation: str,
                          kv: dict[str, Any]) -> None:
        """Relay a heartbeat's KV-cache event to the elected master
        (runs on the heartbeat executor thread — blocking POST is fine).
        Empty events are dropped here: most beats carry no delta, and
        the common case must not pay a master round-trip."""
        if not any(kv.get(k) for k in ("stored", "removed", "offloaded")):
            return
        master = self._coord.get(MASTER_KEY)
        if not master or master == self.self_addr:
            return
        from ..rpc import wire as _wire

        body, ctype = _wire.encode_dispatch(
            {"name": name, "incarnation_id": incarnation,
             "kv_cache_event": kv}, _wire.WIRE_MSGPACK)
        try:
            self._kv_relay_session.post(
                f"http://{master}/rpc/heartbeat", data=body,
                headers={"Content-Type": ctype}, timeout=3)
        except Exception as e:  # noqa: BLE001  # xlint: allow-broad-except(a lost KV delta degrades cache-hit routing for one beat; the next heartbeat's absolute tier moves re-converge)
            logger.warning("kv-event relay to master %s failed: %s",
                           master, e)

    # ----------------------------------------------------------- generation
    def handle_generation(self, output: RequestOutput) -> bool:
        """One Generations delta from an engine (reference
        `scheduler.cpp:484-559`). Returns False if the request is unknown
        (signals the engine to stop generating).

        Lookup, dedup, disconnect check and token accounting run under
        `_req_lock` so they are atomic w.r.t. the exit paths (GC timeout,
        instance failure) that pop the request and reverse its accounting.
        """
        disconnected = False
        expired = False
        with self._req_lock:
            st = self._requests.get(output.service_request_id)
            if st is None or st.finished:
                return False
            req = st.request
            # Idempotent-replay guard: after a failover the request is
            # bound to new incarnations; a delta still in flight from an
            # old binding must not reach the client twice. Unstamped
            # deltas (legacy engines, unit tests) skip the check.
            if output.incarnation and output.incarnation not in (
                    req.prefill_incarnation, req.decode_incarnation):
                return False
            if st.failing:
                # Between instances (failure detected, re-dispatch
                # pending): the old stream is void; tell it to stop.
                return False
            # Mid-stream deadline expiry (overload plane): stop the
            # engine NOW — the False return below is the stop signal the
            # engine acts on, independent of the cancel RPC.
            if deadline_expired(req.deadline_ms) and not output.finished:
                expired = True
            req.touch()
            if output.delta_seq is not None:
                if output.delta_seq <= st.last_delta_seq:
                    # Duplicate delivery: the agent retried a POST whose
                    # original was processed but whose response was lost.
                    # Already handled — ack, don't re-deliver.
                    return True
                st.last_delta_seq = output.delta_seq
            # Client-disconnect cancellation (reference
            # `scheduler.cpp:507-521`).
            if expired:
                pass    # cancel path runs below, outside the lock
            elif st.conn.is_disconnected():
                self._remove_request(st)
                disconnected = True
            else:
                self._update_token_metrics(st, output)
                if output.status.ok():
                    # Track the delivered index-0 token ids: failover
                    # resumes decode by replaying exactly this prefix.
                    for seq in output.outputs:
                        if seq.index == 0 and seq.token_ids:
                            st.replay_token_ids.extend(seq.token_ids)
                if output.finished:
                    st.finished = True
        if expired:
            if self._cancel_request_state(st, 504, "deadline exceeded",
                                          reason="deadline"):
                logger.info("request %s deadline expired mid-stream; "
                            "cancelling", req.service_request_id)
            return False
        if disconnected:
            logger.info("client of %s disconnected; cancelling",
                        req.service_request_id)
            REQUESTS_CANCELLED_TOTAL.labels(reason="disconnect").inc()
            self._cancel_on_engines(req)
            return False
        self._output_executor.submit_to_lane(
            st.lane, lambda: self._deliver(st, output))
        return True

    def _update_token_metrics(self, st: _RequestState,
                              output: RequestOutput) -> None:
        """TTFT vs ITL histograms + SLO accounting (reference
        `scheduler.cpp:561-587`)."""
        req = st.request
        n_new = sum(len(s.token_ids) or (1 if s.text else 0)
                    for s in output.outputs)
        now = now_ms()
        policy = self._opts.load_balance_policy
        if st.first_token_ms is None and n_new:
            st.first_token_ms = now
            if st.dispatch_done_pc is not None:
                HOTPATH.record(
                    "first_delta",
                    (time.perf_counter() - st.dispatch_done_pc) * 1000)
                st.dispatch_done_pc = None
            if not req.metrics.prefill_finish_time_ms:
                # Observe TTFT once per request: after a failover the
                # prefill stage re-runs (accounting below must re-fire)
                # but the client's TTFT already happened.
                TTFT_MS.labels(instance=req.routing.prefill_name or "none",
                               policy=policy).observe(
                    now - req.created_time_ms)
                SLO_MONITOR.record_ttft(
                    now - req.created_time_ms,
                    trace_id=req.span.trace_id if req.span else "")
            req.prefill_stage_finished = True
            req.metrics.prefill_finish_time_ms = now
            self.instance_mgr.update_request_metrics(
                req, RequestAction.FINISH_PREFILL, n_new=n_new)
        elif n_new:
            if st.last_token_ms is not None:
                ITL_MS.labels(
                    instance=(req.routing.decode_name
                              or req.routing.prefill_name or "none"),
                    policy=policy).observe(now - st.last_token_ms)
                SLO_MONITOR.record_tpot(
                    now - st.last_token_ms,
                    trace_id=req.span.trace_id if req.span else "")
            self.instance_mgr.update_request_metrics(
                req, RequestAction.DECODE_STEP, n_new=n_new)
        if n_new:
            st.last_token_ms = now
            req.num_generated_tokens += n_new

    def _deliver(self, st: _RequestState, output: RequestOutput) -> None:
        """Runs on the request's pinned lane (ordering guarantee)."""
        req = st.request
        if req.trace_callback is not None:
            req.trace_callback(req.service_request_id, output.to_dict())
        if not output.status.ok():
            code = 503 if output.status.code == StatusCode.UNAVAILABLE \
                else 500
            msg = output.status.message or output.status.code.name
            st.conn.finish_with_error(code, msg)
            # Stamp the engine error onto the root span (and through it
            # the flight recorder's anomaly hook) — an engine-surfaced
            # failure is as much an anomaly as a dispatch failure.
            self._remove_request(st, output, error=(code, msg))
            return
        ok = True
        if req.stream:
            if st.kind == "chat":
                ok = self.response_handler.send_chat_delta(
                    st.conn, st.stream_state, req, output)
            elif st.kind == "anthropic":
                ok = self.response_handler.send_anthropic_delta(
                    st.conn, st.stream_state, req, output)
            else:
                ok = self.response_handler.send_completion_delta(
                    st.conn, req, output)
        else:
            self._accumulate(st, output)
            if output.finished:
                final = self._final_output(st, output)
                if st.kind == "chat":
                    ok = self.response_handler.send_chat_result(
                        st.conn, req, final)
                elif st.kind == "anthropic":
                    ok = self.response_handler.send_anthropic_result(
                        st.conn, req, final)
                else:
                    ok = self.response_handler.send_completion_result(
                        st.conn, req, final)
        if output.finished:
            self._remove_request(st, output)
        elif not ok:
            # Downstream write failed: client gone.
            st.finished = True
            if self._remove_request(st, output):
                REQUESTS_CANCELLED_TOTAL.labels(reason="disconnect").inc()
            self._cancel_on_engines(req)

    def _accumulate(self, st: _RequestState, output: RequestOutput) -> None:
        for seq in output.outputs:
            acc = st.accum.get(seq.index)
            if acc is None:
                acc = SequenceOutput(index=seq.index)
                st.accum[seq.index] = acc
            acc.text += seq.text
            acc.token_ids.extend(seq.token_ids)
            acc.logprobs.extend(seq.logprobs)
            if seq.finish_reason:
                acc.finish_reason = seq.finish_reason

    def _final_output(self, st: _RequestState,
                      last: RequestOutput) -> RequestOutput:
        outputs = [st.accum[i] for i in sorted(st.accum)]
        usage = last.usage or Usage(
            num_prompt_tokens=st.request.metrics.prompt_tokens,
            num_generated_tokens=st.request.num_generated_tokens)
        return RequestOutput(
            request_id=last.request_id,
            service_request_id=last.service_request_id,
            outputs=outputs, usage=usage, finished=True,
            finished_on_prefill=last.finished_on_prefill)

    def _remove_request(self, st: _RequestState,
                        output: Optional[RequestOutput] = None,
                        error: Optional[tuple[int, str]] = None) -> bool:
        """Reference `finish_request` (`scheduler.cpp:416-441`). Idempotent:
        returns True only for the call that actually performed the exit
        (callers gate their error/cancel side effects on it). `error`
        stamps (code, message) onto the root span — inside the winning
        exit's lock hold, so a failure path that loses the race against a
        normal completion cannot relabel an already-recorded span."""
        with self._req_lock:
            self._requests.pop(st.request.service_request_id, None)
            if st.exited:
                return False
            st.exited = True
            st.finished = True
            st.request.metrics.finish_time_ms = now_ms()
            if error is not None and st.request.span:
                st.request.span.set(error=error[1], error_code=error[0])
                st.request.span.status = f"ERROR: {error[0]}"
            self._account_request_exit(st.request)
            if st.request.admitted:
                # Release the admission-gate slot exactly once (this IS
                # the winning exit; leaf lock nests under _req_lock).
                st.request.admitted = False
                ADMISSION.release()
        self._trace_spans(st)
        self._finish_request_observability(st, error)
        return True

    def _trace_spans(self, st: _RequestState) -> None:
        """Close out the request's real root span (common/tracing.py) with
        the per-stage latency breakdown and mirror the summary to the
        request-trace JSONL (the reference's raw I/O JSONL gains timing the
        SLO predictor can be audited against, now keyed by trace_id)."""
        r = st.request
        if r.span is None and r.trace_callback is None:
            return   # no trace consumer: skip building the summary
        m = r.metrics
        summary = {
            "type": "spans",
            "created_ms": r.created_time_ms,
            "schedule_delay_ms": (m.schedule_time_ms - r.created_time_ms)
            if m.schedule_time_ms else None,
            "ttft_ms": (m.prefill_finish_time_ms - r.created_time_ms)
            if m.prefill_finish_time_ms else None,
            "decode_ms": (m.finish_time_ms - m.prefill_finish_time_ms)
            if m.prefill_finish_time_ms else None,
            "total_ms": m.finish_time_ms - r.created_time_ms,
            "estimated_ttft_ms": m.estimated_ttft_ms,
            "prompt_tokens": m.prompt_tokens,
            "generated_tokens": r.num_generated_tokens,
            "prefill_instance": r.routing.prefill_name,
            "decode_instance": r.routing.decode_name,
            "failover_attempts": st.failover_attempts,
        }
        if r.span:
            summary["trace_id"] = r.span.trace_id
            r.span.set(**{k: v for k, v in summary.items() if k != "type"})
            r.span.end()
        if r.trace_callback is None:
            return
        try:
            r.trace_callback(r.service_request_id, summary)
        except Exception:  # noqa: BLE001 — tracing must never break exit
            logger.exception("span trace emit failed")

    def _finish_request_observability(self, st: _RequestState,
                                      error: Optional[tuple[int, str]]
                                      ) -> None:
        """Exit-time observability, on the winning exit path only and
        outside `_remove_request`'s own lock hold (leaf locks only;
        bundle capture is deque+file appends, never a scheduler lock):

        - feed the request outcome to the SLO error-rate objective,
        - tail-sampling verdict: an anomalous exit (error, failover, TTFT
          SLO breach) KEEPS the trace — sampled-out anomalies promote
          out of the pending buffer; a clean exit drops it,
        - capture a flight-recorder bundle for errors and SLO breaches
          (failovers are captured at failover time, where the dead
          instance is still known).
        """
        r = st.request
        m = r.metrics
        trace_id = r.span.trace_id if r.span else \
            (r.trace.trace_id if r.trace else "")
        SLO_MONITOR.record_request(ok=error is None, trace_id=trace_id)
        ttft_ms = (m.prefill_finish_time_ms - r.created_time_ms) \
            if m.prefill_finish_time_ms else None
        slo_breach = ttft_ms is not None and SLO_MONITOR.ttft_breached(
            ttft_ms)
        if error is None and st.failover_attempts == 0 and not slo_breach:
            TRACER.drop_trace(trace_id)
            return
        TRACER.keep_trace(trace_id)
        if error is not None:
            RECORDER.record(
                "error", request_id=r.service_request_id,
                trace_id=trace_id,
                detail={"code": error[0], "message": error[1],
                        "ttft_ms": ttft_ms,
                        "failover_attempts": st.failover_attempts,
                        "prefill": r.routing.prefill_name,
                        "decode": r.routing.decode_name})
        elif slo_breach:
            RECORDER.record(
                "slo_breach", request_id=r.service_request_id,
                trace_id=trace_id,
                detail={"ttft_ms": ttft_ms,
                        "slo_ttft_ms": SLO_MONITOR.ttft_target_ms,
                        "failover_attempts": st.failover_attempts,
                        "prefill": r.routing.prefill_name,
                        "decode": r.routing.decode_name})

    def _account_request_exit(self, req: Request) -> None:
        """Reverse this request's load-accounting increments on any exit
        path. After the first token (FINISH_PREFILL already credited the
        decode side) the reversal is FINISH_DECODE; before it, CANCEL
        reverses only SCHEDULE — emitting FINISH_PREFILL for a request that
        never produced a token would leak decode load forever."""
        self.instance_mgr.update_request_metrics(
            req,
            RequestAction.FINISH_DECODE if req.prefill_stage_finished
            else RequestAction.CANCEL)

    def _cancel_on_engines(self, req: Request) -> None:
        for name in {req.routing.prefill_name, req.routing.decode_name}:
            if not name:
                continue
            ch = self.instance_mgr.get_channel(name)
            if ch is not None:
                try:
                    ch.cancel(req.service_request_id)
                except Exception:
                    logger.exception("cancel RPC to %s failed", name)

    # --------------------------------------------------------- failure path
    def _on_instance_failure(self, name: str, incarnation: str,
                             itype: InstanceType) -> None:
        self.kvcache_mgr.remove_instance(name)
        self.clear_requests_on_failed_instance(name, incarnation, itype)

    def clear_requests_on_failed_instance(self, name: str, incarnation: str,
                                          itype: InstanceType) -> None:
        """Requests bound to a dead (instance, incarnation, role): the
        reference cancel-and-surfaces them all (`scheduler.cpp:443-482`);
        here they are transparently re-dispatched when a replay payload
        exists and the retry budget allows, and surfaced as 503 only
        otherwise."""
        victims: list[_RequestState] = []
        with self._req_lock:
            for sid, st in list(self._requests.items()):
                r = st.request
                hit = (
                    (r.routing.prefill_name == name
                     and (not incarnation or r.prefill_incarnation == incarnation)
                     and not r.prefill_stage_finished)
                    or (r.routing.decode_name == name
                        and (not incarnation or r.decode_incarnation == incarnation))
                    or (r.routing.decode_name == "" and
                        r.routing.prefill_name == name
                        and (not incarnation or r.prefill_incarnation == incarnation))
                )
                if hit and not st.finished and not st.exited:
                    # Void the old stream immediately: deltas already in
                    # flight from the dead binding must not interleave
                    # with the replayed one.
                    st.failing = True
                    victims.append(st)
        if not victims:
            return
        failover: list[_RequestState] = []
        for st in victims:
            if (self._opts.failover_max_retries > 0 and st.forward_path
                    and not st.conn.is_disconnected()):
                failover.append(st)
            else:
                self._surface_failure(
                    st, f"instance {name} failed; request cancelled")
        if failover:
            logger.info("failing over %d request(s) from dead instance %s",
                        len(failover), name)
            threading.Thread(
                target=self._failover_batch, args=(failover, name),
                name="request-failover", daemon=True).start()

    def _failover_batch(self, victims: list[_RequestState],
                        dead_name: str) -> None:
        if len(victims) == 1:
            self._failover_one(victims[0], dead_name)
            return
        # Fan out: each victim's backoff must not delay the others'
        # recovery (a dead instance can carry hundreds of streams).
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, len(victims)),
                                thread_name_prefix="failover") as pool:
            for st in victims:
                pool.submit(self._failover_one, st, dead_name)

    def _failover_one(self, st: _RequestState, dead_name: str) -> None:
        try:
            self._failover_request(st, dead_name)
        except Exception:  # noqa: BLE001 — one bad replay must not
            logger.exception(                  # strand the rest
                "failover of %s failed unexpectedly",
                st.request.service_request_id)
            self._surface_failure(st, "failover error")

    def _failover_request(self, st: _RequestState,
                          dead_name: str = "") -> None:
        """Re-dispatch one in-flight request after its instance died:
        re-run prefill on a surviving pair with the prompt extended by the
        tokens already streamed, under the per-request retry budget with
        exponential backoff. Runs off the event loop / watch threads."""
        req = st.request
        opts = self._opts
        with self._req_lock:
            if st.in_failover:
                return   # another thread already owns this replay
            st.in_failover = True
        try:
            self._failover_loop(st, req, opts, dead_name)
        finally:
            with self._req_lock:
                st.in_failover = False

    def _failover_loop(self, st: _RequestState, req: Request,
                       opts: ServiceOptions, dead_name: str) -> None:
        # Stop the old binding's surviving peer (the dead instance's
        # channel is already gone): any stream it still drives is void,
        # and in-flight deltas are dropped while st.failing holds.
        self._cancel_on_engines(req)
        while True:
            with self._req_lock:
                if st.exited or st.finished:
                    return
                if st.failover_attempts >= opts.failover_max_retries:
                    break
                st.failover_attempts += 1
                attempt = st.failover_attempts
            if deadline_expired(req.deadline_ms):
                # A replay that cannot finish inside the request's
                # deadline is pure amplification — cancel instead.
                self._cancel_request_state(
                    st, 504, "deadline exceeded during failover",
                    reason="deadline")
                return
            if not RETRY_BUDGET.try_spend():
                # Global retry budget (overload plane): during a partial
                # outage the per-request budget still multiplies across
                # thousands of victims — the shared bucket caps the
                # fleet-wide replay volume. Surface instead of retrying.
                self._surface_failure(
                    st, "instance failed; global retry budget exhausted")
                return
            FAILOVER_ATTEMPTS_TOTAL.labels(
                instance=dead_name or "dispatch-failure").inc()
            if st.conn.is_disconnected():
                if self._remove_request(st):
                    logger.info("client of %s gone during failover",
                                req.service_request_id)
                return
            if attempt > 1:
                time.sleep(jittered_backoff(opts.failover_backoff_base_s,
                                            opts.failover_backoff_max_s,
                                            attempt - 2))
            routing = self.lb_policy.select_instances_pair(req)
            if not routing.valid() or (
                    dead_name and dead_name in (routing.prefill_name,
                                                routing.decode_name)):
                continue   # no usable capacity yet; burn one budgeted try
            with self._req_lock:
                if st.exited or st.finished:
                    return
                # Move the load accounting: reverse the old pair's credits
                # (before resetting progress — the FINISH_DECODE reversal
                # keys off prefill_stage_finished/num_generated_tokens),
                # then re-run SCHEDULE against the new pair.
                self._account_request_exit(req)
                req.routing = routing
                # RCU window: the selected survivor may vanish between
                # select and bind — bind re-validates against the current
                # snapshot. Progress reset + SCHEDULE credit run either
                # way (the next attempt's _account_request_exit reverses
                # exactly this credit via CANCEL); a failed bind just
                # skips the dispatch and burns this budgeted try.
                bound = self.instance_mgr \
                    .bind_request_instance_incarnations(req)
                req.prefill_stage_finished = False
                req.num_generated_tokens = 0
                st.first_token_ms = None
                st.last_delta_seq = 0   # the new stream numbers from 1
                resume = list(st.replay_token_ids)
                req.touch()
                self.instance_mgr.update_request_metrics(
                    req, RequestAction.SCHEDULE)
                st.failing = not bound
            if not bound:
                continue
            payload = dict(st.forward_payload or {})
            payload["service_request_id"] = req.service_request_id
            # Resume-by-prompt-extension: the engine prefills the original
            # prompt plus every token already streamed and generates only
            # the remainder (so the client-visible sequence is identical).
            payload["token_ids"] = list(req.token_ids) + resume
            payload["resume_generated_token_ids"] = resume
            payload["routing"] = {"prefill_name": routing.prefill_name,
                                  "decode_name": routing.decode_name,
                                  "encode_name": routing.encode_name}
            payload["failover_attempt"] = attempt
            # The re-dispatch rides under a failover span (same trace_id as
            # the original incarnation): the replayed engine's spans parent
            # here, so /admin/trace shows both incarnations in one tree.
            with TRACER.span("scheduler.failover", ctx=req.trace,
                             request_id=req.service_request_id,
                             attempt=attempt, dead_instance=dead_name,
                             target=routing.prefill_name,
                             resumed_tokens=len(resume)) as fo:
                fo_ctx = fo.context()
                if fo_ctx is not None:
                    payload["trace_context"] = fo_ctx.to_dict()
                ch = self.instance_mgr.get_channel(routing.prefill_name)
                if ch is None:
                    ok, err = False, "no channel"
                else:
                    # Single-shot POST: replay is owned here, and the
                    # request was just re-bound, so a duplicate stream from
                    # an ambiguous failure is dropped by the incarnation
                    # guard.
                    ok, err = ch.forward(st.forward_path, payload)
                fo.set(ok=ok)
            if ok:
                FAILOVER_SUCCESS_TOTAL.labels(
                    instance=routing.prefill_name).inc()
                logger.info(
                    "request %s failed over to %s (attempt %d, resuming "
                    "after %d tokens)", req.service_request_id,
                    routing.prefill_name, attempt, len(resume))
                # Anomaly capture at failover time (the dead instance and
                # resume state are still in hand); also forces the
                # tail-sampling keep so a sampled-out trace's spans —
                # including the dead incarnation's — promote to the ring.
                trace_id = req.trace.trace_id if req.trace else ""
                TRACER.keep_trace(trace_id)
                RECORDER.record(
                    "failover", request_id=req.service_request_id,
                    trace_id=trace_id,
                    detail={"dead_instance": dead_name,
                            "target": routing.prefill_name,
                            "attempt": attempt,
                            "resumed_tokens": len(resume)})
                return
            logger.warning("failover dispatch of %s to %s failed: %s",
                           req.service_request_id, routing.prefill_name, err)
            with self._req_lock:
                if st.exited:
                    return
                st.failing = True
                # The SCHEDULE credit against the failed target is NOT
                # reversed here: every exit from this loop (next-attempt
                # rebind, _surface_failure, disconnect) reverses exactly
                # one outstanding credit via _account_request_exit, so the
                # invariant is one credit held at all times.
            # Ambiguous failure may have started generating: best-effort
            # cancel before trying the next instance.
            self._cancel_on_engines(req)
        self._surface_failure(
            st, f"instance failed; retry budget exhausted "
                f"after {st.failover_attempts} attempt(s)")

    def handle_dispatch_failure(self, req: Request, message: str = "",
                                retryable: bool = True,
                                code: int = 503) -> None:
        """The initial (or replayed) engine forward failed. With failover
        enabled this re-dispatches under the same budget as instance death;
        a non-retryable failure (the engine rejected the request as a
        client error — `code` carries its status through) or disabled
        failover surfaces the error (reference handle_first_send_request
        failure path)."""
        with self._req_lock:
            st = self._requests.get(req.service_request_id)
            if st is None or st.exited or st.finished:
                return
            st.failing = True
        if retryable and self._opts.failover_max_retries > 0 \
                and st.forward_path:
            self._failover_request(st)
            return
        self._surface_failure(
            st, message or "failed to reach prefill instance", code=code)

    def _surface_failure(self, st: _RequestState, message: str,
                         code: int = 503) -> None:
        """Cancel-and-surface terminal path (reference
        `scheduler.cpp:443-482`): exit accounting + client error."""
        if not self._remove_request(st, error=(code, message)):
            return
        REQUESTS_CANCELLED_TOTAL.labels(reason="failover").inc()
        self._cancel_on_engines(st.request)
        self._output_executor.submit_to_lane(
            st.lane, lambda: st.conn.finish_with_error(code, message))
        logger.info("cancelled request %s: %s",
                    st.request.service_request_id, message)

    # ------------------------------------------------------------ readiness
    def has_available_instances(self) -> bool:
        return self.instance_mgr.has_available_instances()

    def get_channel(self, name: str):
        return self.instance_mgr.get_channel(name)

    def stop(self) -> None:
        self._stopped.set()
        self.ownership.stop()
        self.autoscaler.stop()
        self.instance_mgr.stop()
        self.kvcache_mgr.stop()
        self._output_executor.shutdown()
        self.schedule_executor.shutdown(wait=False)
        # A stopping scheduler abandons its in-flight requests — but the
        # admission gate is process-global, so their slots must be
        # handed back or a killed master permanently shrinks the
        # surviving masters' gate.
        # st.exited makes this exactly-once against racing late exits.
        with self._req_lock:
            for st in self._requests.values():
                if not st.exited and st.request.admitted:
                    st.exited = True
                    st.finished = True
                    st.request.admitted = False
                    ADMISSION.release()
            self._requests.clear()
        self._coord.release(SERVICE_KEY_PREFIX + self.self_addr)
        if self.is_master:
            self._coord.release(MASTER_KEY)
        self._coord.close()
