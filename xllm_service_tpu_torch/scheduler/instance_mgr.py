"""Instance fleet state machine.

Parity: reference `scheduler/managers/instance_mgr.{h,cpp}` (1,678 LoC — the
reference's largest component; SURVEY.md §2.5, §3.4). Responsibilities:

- Coordination watches on per-type instance prefixes; boot-time load.
- Registration: channel creation, TimePredictor fit from profiled tables,
  P↔D peer linking with rollback on partial failure, round-robin index
  insert with O(1) swap-remove.
- Incarnation tracking: stale-heartbeat rejection, instance-replacement
  detection (same name, new incarnation).
- Three-state failure detection: DELETE event → health probe → LEASE_LOST
  (grace, still schedulable) or SUSPECT (excluded); 1s reconcile thread
  promotes silent LEASE_LOST → SUSPECT and evicts old SUSPECTs
  (deregister: unlink peers, cancel bound in-flight requests, drop state).
- Scheduling reads: RR pair selection with SUSPECT skip + DEFAULT/MIX
  fallback, load snapshots for CAR, SLO-aware pair selection with dynamic
  PD-role flipping.
- Master replicas: master uploads load metrics to coordination; non-masters
  mirror via watch.
- Sharded telemetry ingest (``telemetry_ingest_mode="shard"``, the
  default): heartbeat/load ingest AND failure detection for an
  instance run only on its OWNING master under the rendezvous telemetry
  map (`multimaster/ownership.py telemetry_owner`); each owner publishes
  one coalesced load/lease frame per sync tick
  (``XLLM:LOADFRAME:<owner>``, single-writer by construction) that every
  other frontend mirrors into its lock-free load-info view — the elected
  master's heartbeat funnel spreads 1/N
  across the active plane. Owner death hands a shard to the rendezvous
  successor implicitly (the member set shrinks); the successor grants a
  takeover heartbeat grace so the handoff never transits SUSPECT.
  ``telemetry_ingest_mode="master"`` keeps the reference-shaped funnel
  (elected master ingests everything, LOADMETRICS mirror) — the bench
  baseline and mixed-version escape hatch.

Lock discipline (reference documents a two-lock order,
`instance_mgr.h:156-162`): `_cluster_lock` guards fleet membership;
`_metrics_lock` guards load/latency/request accounting. Never take
`_cluster_lock` while holding `_metrics_lock`; RPCs are issued outside locks.

Scheduling reads are LOCK-FREE (RCU): every membership/state writer
rebuilds an immutable :class:`RoutingSnapshot` under `_cluster_lock` and
publishes it with one atomic reference assignment; `get_next_instance_pair`
/ `select_instance_pair_on_slo` / `bind_request_instance_incarnations` /
`has_available_instances` / `get_channel` read the current snapshot without
taking any instance_mgr lock — a heartbeat or eviction storm can no longer
stall the request hot path on `_cluster_lock`. A reader that routed from a
just-superseded snapshot is caught at bind time: the bind re-reads the
CURRENT snapshot and fails if its target is gone or re-incarnated, and the
scheduler re-selects.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..common.config import ServiceOptions
from ..common.metrics import (
    CIRCUIT_BREAKER_OPEN,
    HEARTBEATS_INGESTED_TOTAL,
    INSTANCE_EVICTIONS_TOTAL,
    INSTANCE_INFLIGHT_REQUESTS,
    INSTANCE_QUEUE_DEPTH,
    ITL_MS,
    LOADFRAMES_APPLIED_TOTAL,
    LOADFRAMES_PUBLISHED_TOTAL,
    LOADINFO_AGE_SECONDS,
    RPC_RETRIES_TOTAL,
    TTFT_MS,
    evict_series,
)
from ..devtools import lifecycle as _lifecycle
from ..common.time_predictor import TimePredictor
from ..common import topology as topo
from ..common.types import (
    InstanceLoadInfo,
    InstanceMetaInfo,
    InstanceRuntimeState,
    InstanceType,
    LatencyMetrics,
    LoadMetrics,
    RequestAction,
    Routing,
    now_ms,
)
from ..common.request import Request
from ..coordination.base import CoordinationClient, KeyEvent, WatchEventType
from ..devtools import ownership as _ownership
from ..devtools import rcu
from ..devtools.locks import make_lock
from ..rpc import (
    INSTANCE_KEY_PREFIX,
    LOADFRAME_KEY_PREFIX,
    LOADMETRICS_KEY_PREFIX,
    MASTER_KEY,
    instance_key,
    parse_instance_key,
)
from ..rpc.channel import ChannelError, EngineChannel, make_keepalive_session
from ..rpc.wire import (
    WIRE_JSON,
    decode_load_frame,
    encode_load_frame,
    negotiate,
)
from ..utils import get_logger

logger = get_logger(__name__)

# Roles that serve prefill-side / decode-side traffic.
_PREFILL_TYPES = (InstanceType.PREFILL, InstanceType.MIX, InstanceType.DEFAULT)
_DECODE_TYPES = (InstanceType.DECODE, InstanceType.MIX)


@dataclass
class _RequestLoad:
    """Per-instance in-flight accounting for the SLO predictor
    (reference `request_metrics_`, `instance_mgr.h:173-195`)."""

    num_prefill_requests: int = 0
    num_prefill_tokens: int = 0
    num_decode_requests: int = 0
    num_decode_tokens: int = 0


@dataclass
class _Entry:
    meta: InstanceMetaInfo
    state: InstanceRuntimeState = InstanceRuntimeState.ACTIVE
    channel: Optional[EngineChannel] = None
    predictor: TimePredictor = field(default_factory=TimePredictor)
    last_heartbeat_ms: int = field(default_factory=now_ms)
    state_since_ms: int = field(default_factory=now_ms)

    def schedulable(self) -> bool:
        # SUSPECT instances are excluded from scheduling; LEASE_LOST are in a
        # grace window and still schedulable (reference
        # `is_instance_schedulable`, `instance_mgr.cpp:63-66`). DRAINING
        # instances (graceful shutdown: finish in-flight, take no new
        # traffic) are excluded while still alive — either
        # master-initiated (entry state, the autoscaler's scale-in path)
        # or self-advertised (meta flag, an agent-side drain).
        # BREAKER_OPEN (sick-but-leased: the channel's circuit breaker
        # tripped) is excluded like SUSPECT until the half-open probe
        # recovers it.
        return self.state not in (InstanceRuntimeState.SUSPECT,
                                  InstanceRuntimeState.DRAINING,
                                  InstanceRuntimeState.BREAKER_OPEN) \
            and not self.meta.draining


class RoutingSnapshot:
    """Immutable view of the fleet for the scheduling hot path (RCU).

    Built by writers under `_cluster_lock`, published with one atomic
    reference assignment, read lock-free. Role membership is captured at
    build time over schedulable() instances only, so an evicted/SUSPECT/
    draining instance disappears from routing the moment its eviction
    publishes — readers never consult mutable entry state. `entries` keeps
    references to the (shared) `_Entry` objects for the SLO policy's
    predictor reads; those are coefficient-reference reads, safe without
    the lock."""

    __slots__ = ("prefill", "decode", "encode", "schedulable", "entries",
                 "incarnations", "channels", "wire", "has_available",
                 "built_ms", "coords", "decode_by_slice", "topo_active")

    def __init__(self, instances: dict[str, _Entry]):
        # Build timestamp: the fleet-observability gauge
        # routing_snapshot_age_seconds reports now - built_ms (a frontend
        # whose snapshot stopped republishing is routing blind).
        self.built_ms = now_ms()
        prefill: list[str] = []
        decode: list[str] = []
        encode: list[str] = []
        self.entries: dict[str, _Entry] = dict(instances)
        self.incarnations = {n: e.meta.incarnation_id
                             for n, e in instances.items()}
        self.channels = {n: e.channel for n, e in instances.items()}
        self.wire = {n: negotiate(e.meta.wire_formats)
                     for n, e in instances.items()}
        has_default = has_prefill = has_decode = False
        for name, e in instances.items():
            if not e.schedulable():
                continue
            t = e.meta.type
            if t in _PREFILL_TYPES:
                prefill.append(name)
            if t in _DECODE_TYPES:
                decode.append(name)
            if t == InstanceType.ENCODE:
                encode.append(name)
            if t in (InstanceType.DEFAULT, InstanceType.MIX):
                has_default = True
            elif t == InstanceType.PREFILL:
                has_prefill = True
            elif t == InstanceType.DECODE:
                has_decode = True
        self.prefill = tuple(prefill)
        self.decode = tuple(decode)
        self.encode = tuple(encode)
        self.schedulable = frozenset(prefill).union(decode, encode)
        # Readiness (reference `instance_mgr.cpp:1430-1472`): a schedulable
        # DEFAULT/MIX serves both roles; otherwise both a PREFILL and a
        # DECODE must exist — a prefill-only fleet must NOT report ready.
        self.has_available = has_default or (has_prefill and has_decode)
        # Topology plane (common/topology.py, docs/topology.md): every
        # instance's effective coordinate (synthetic per-host slice when
        # the registration carried no host), decode membership grouped by
        # slice for locality-first pairing, and the plane's armed bit —
        # ONLY when the schedulable PD fleet spans >= 2 distinct
        # effective slices do consumers pay link costs; a flat fleet
        # collapses into one synthetic slice and routing is bit-for-bit
        # the legacy behavior.
        self.coords = {n: topo.effective_coord(e.meta.topology, n)
                       for n, e in instances.items()}
        by_slice: dict[str, list[str]] = {}
        for name in decode:
            by_slice.setdefault(self.coords[name].slice_id, []).append(name)
        self.decode_by_slice = {s: tuple(v) for s, v in by_slice.items()}
        pd = set(prefill).union(decode)
        self.topo_active = topo.fleet_topo_active(
            [self.coords[n] for n in pd])


@_ownership.verify_state
class InstanceMgr:
    def __init__(self, coord: CoordinationClient, options: ServiceOptions,
                 is_master: bool = True,
                 channel_factory: Callable[[str, str], EngineChannel] | None = None,
                 start_threads: bool = True,
                 ownership=None, health=None):
        self._coord = coord
        self._opts = options
        self._is_master = is_master
        # Coordination-plane health monitor (scheduler-owned; None in
        # direct-construction tests = never degraded). While it reports
        # degraded the census is FROZEN: lease-lapse verdicts, missed-
        # lease sweeps and ownership-changing actions are suppressed or
        # held — liveness falls back to direct heartbeat silence.
        self._health = health
        # Telemetry-shard map source (multimaster OwnershipRouter). None
        # (direct-construction tests, single-process embedding) degrades
        # to the legacy funnel: owns_telemetry() is uniformly True and
        # no frames are published or mirrored.
        self._ownership = ownership
        self._channel_factory = channel_factory or (
            lambda name, rpc_addr: EngineChannel.from_options(name, options))
        # L1: fleet membership (writers). Scheduling reads go through the
        # published RoutingSnapshot, not this lock.
        self._cluster_lock = make_lock("instance_mgr.cluster", order=20, reentrant=True)  # lock-order: 20
        self._instances: dict[str, _Entry] = {}
        self._snapshot = rcu.publish(RoutingSnapshot({}), "routing.snapshot")
        # RR cursors: shared monotonic counters (next() on itertools.count
        # is atomic under the GIL) — no lock, stable fairness across
        # snapshot republishes.
        self._rr_prefill = itertools.count()
        self._rr_decode = itertools.count()
        self._rr_encode = itertools.count()
        # Pending async role flips + graceful drains (performed by the
        # reconcile thread — the engine RPCs and coordination writes they
        # issue never run on a request path).
        self._flip_lock = make_lock("instance_mgr.flip", order=22)  # lock-order: 22
        self._pending_flips: dict[str, InstanceType] = {}
        self._pending_drains: set[str] = set()
        # L2: metrics.
        self._metrics_lock = make_lock("instance_mgr.metrics", order=24)  # lock-order: 24
        self._load_metrics: dict[str, LoadMetrics] = {}
        self._latency_metrics: dict[str, LatencyMetrics] = {}
        # Link-class census of scheduled PD pairs (topology plane
        # evidence): link_class -> count, incremented per SCHEDULE.
        # "mix" = the pair collapsed onto one instance (no handoff).
        # Surfaced by stats() -> /admin/hotpath so the topo bench can
        # read the same-slice pair share straight off the master.
        self._pair_links: dict[str, int] = {}
        # Telemetry freshness per instance: when load/latency was last
        # refreshed (heartbeat ingest here on the master; LOADMETRICS
        # mirror on replicas). Feeds InstanceLoadInfo.updated_ms so
        # staleness-aware scoring can discount entries a multi-master
        # frontend is routing on from an old mirror.
        self._load_updated_ms: dict[str, int] = {}
        self._request_loads: dict[str, _RequestLoad] = {}
        # Published request-load view (RCU, like _load_infos): immutable
        # (np_req, np_tok, nd_req, nd_tok) tuples per instance, rebuilt
        # copy-on-write by update_request_metrics under `_metrics_lock`
        # and read LOCK-FREE by the SLO policy's predictive scoring —
        # the selection no longer re-scans `_request_loads` under the
        # manager lock on every schedule/planner tick.
        self._request_load_view: dict[str, tuple] = rcu.publish(
            {}, "routing.request_loads")
        self._updated_load_names: set[str] = set()
        self._removed_load_names: set[str] = set()
        # Published load-info view (RCU, like the routing snapshot):
        # rebuilt under `_metrics_lock` by every load/latency/membership
        # writer, read lock-free by CAR / planner / admin. Treat as
        # immutable.
        self._load_infos: dict[str, InstanceLoadInfo] = rcu.publish(
            {}, "routing.load_infos")
        # Sharded telemetry-ingest plane. `_owned_names` is the
        # reconcile thread's view of this master's telemetry shard (the
        # set difference against the fresh rendezvous answer is the
        # ownership-takeover detector — newly-owned instances get a
        # heartbeat grace so a shard handoff never transits SUSPECT).
        # `_shard_dirty`/`_shard_gone` are the OWNER-GATED frame inputs:
        # every write is dominated by an owns_telemetry() check (a
        # non-owner never writes a heartbeat field).
        self._owned_names: set[str] = set()
        self._shard_dirty: set[str] = set()
        self._shard_gone: dict[str, tuple[str, int]] = {}
        # Post-outage missed-DELETE sweep window (ms deadline): lease
        # DELETEs synthesized while the census was frozen were dropped,
        # so for a bounded window after recovery the silence sweep also
        # runs in funnel mode (sharded mode sweeps unconditionally).
        self._post_outage_sweep_until_ms = 0
        self._published_owned: set[str] = set()
        self._shard_seq = 0
        self._frames_published = 0
        self._frames_applied = 0
        self._foreign_heartbeats = 0
        # Hook for request cancellation on instance death (reference keeps a
        # Scheduler back-pointer, `instance_mgr.h:196-198`).
        self.on_instance_failure: Optional[Callable[[str, str, InstanceType], None]] = None
        # Heartbeat KV-event sink (wired to GlobalKVCacheMgr by Scheduler).
        self.on_kvcache_event = None

        self._watch_ids: list[int] = []
        self._stopped = threading.Event()
        self._watch_ids.append(
            coord.add_watch(INSTANCE_KEY_PREFIX, self._on_instance_event))
        self._frame_watch_id: Optional[int] = None
        if self.sharded():
            # Every ACTIVE frontend (elected or not) mirrors peer owners'
            # coalesced load/lease frames. Held OUTSIDE `_watch_ids`:
            # set_as_master prunes `_watch_ids[1:]` on promotion, and the
            # frame mirror must survive every election flip.
            self._frame_watch_id = coord.add_watch(
                LOADFRAME_KEY_PREFIX, self._on_load_frame_event)
        elif not is_master:
            self._watch_ids.append(
                coord.add_watch(LOADMETRICS_KEY_PREFIX, self._on_loadmetrics_event))
            self._on_loadmetrics_event(
                [KeyEvent(WatchEventType.PUT, k, v) for k, v in
                 coord.get_prefix(LOADMETRICS_KEY_PREFIX).items()], "")
        self._load_existing()
        if self._frame_watch_id is not None:
            # Bootstrap frame apply AFTER the boot-time fleet load: frames
            # reference instances by name and skip unknowns.
            self._on_load_frame_event(
                [KeyEvent(WatchEventType.PUT, k, v) for k, v in
                 coord.get_prefix(LOADFRAME_KEY_PREFIX).items()], "")
        self._reconciler: Optional[threading.Thread] = None
        if start_threads:
            self._reconciler = threading.Thread(
                target=self._reconcile_loop, name="instance-reconcile", daemon=True)
            self._reconciler.start()

    # ------------------------------------------------------------- snapshot
    def _publish_snapshot(self) -> None:
        """Rebuild + atomically publish the routing snapshot. Called by
        every membership/state writer; `_cluster_lock` is reentrant, so
        writers already holding it republish in place. The load-info view
        derives from the snapshot (membership/type/schedulable), so it is
        republished in the same step (nested `_metrics_lock` is fine:
        lock order 20 → 24, and no path nests them the other way)."""
        with self._cluster_lock:
            self._snapshot = rcu.publish(RoutingSnapshot(self._instances),
                                         "routing.snapshot")
            with self._metrics_lock:
                self._rebuild_load_infos_locked()

    def _rebuild_load_infos_locked(self) -> None:
        """Rebuild + publish the lock-free load-info view (callers hold
        `_metrics_lock`; membership comes from the current routing
        snapshot). Full rebuild — membership writers only; per-heartbeat
        updates go through :meth:`_update_load_info_locked` (copy-on-write
        of ONE entry, so a large fleet's heartbeat stream doesn't rebuild
        O(fleet) objects per beat)."""
        snap = self._snapshot
        self._load_infos = rcu.publish({
            name: self._make_load_info_locked(name, entry, snap)
            for name, entry in snap.entries.items()}, "routing.load_infos")

    def _make_load_info_locked(self, name: str, entry: _Entry,
                               snap: RoutingSnapshot) -> InstanceLoadInfo:
        coord = snap.coords.get(name) \
            or topo.effective_coord(entry.meta.topology, name)
        return InstanceLoadInfo(
            name=name, type=entry.meta.type,
            load=self._load_metrics.get(name, LoadMetrics()),
            latency=self._latency_metrics.get(name, LatencyMetrics()),
            schedulable=name in snap.schedulable,
            updated_ms=self._load_updated_ms.get(name, 0),
            slice_id=coord.slice_id, host=coord.host)

    def _update_load_info_locked(self, name: str) -> None:
        """Copy-on-write republish of one instance's load-info entry
        (callers hold `_metrics_lock`). Unknown names (metrics for an
        instance the snapshot dropped) are ignored — the membership
        writer's full rebuild is authoritative."""
        snap = self._snapshot
        entry = snap.entries.get(name)
        if entry is None:
            if name in self._load_infos:
                nxt = dict(self._load_infos)
                nxt.pop(name, None)
                self._load_infos = rcu.publish(nxt, "routing.load_infos")
            return
        nxt = dict(self._load_infos)
        nxt[name] = self._make_load_info_locked(name, entry, snap)
        self._load_infos = rcu.publish(nxt, "routing.load_infos")

    def _publish_request_load_locked(self, *names: str) -> None:
        """Copy-on-write republish of the lock-free request-load view for
        the given instances (callers hold `_metrics_lock`). Entries are
        immutable (np_req, np_tok, nd_req, nd_tok) tuples."""
        nxt = dict(self._request_load_view)
        for name in names:
            rl = self._request_loads.get(name)
            if rl is None:
                nxt.pop(name, None)
            else:
                nxt[name] = (rl.num_prefill_requests, rl.num_prefill_tokens,
                             rl.num_decode_requests, rl.num_decode_tokens)
        self._request_load_view = rcu.publish(nxt, "routing.request_loads")

    def get_request_loads(self) -> dict[str, tuple]:
        """Per-instance in-flight accounting for the SLO policy's
        predictive scoring: name -> (num_prefill_requests,
        num_prefill_tokens, num_decode_requests, num_decode_tokens).
        LOCK-FREE: returns the published view — treat as immutable."""
        return self._request_load_view

    def inflight_requests(self, name: str) -> int:
        """This frontend's in-flight request count against an instance
        (lock-free; the drain-completion check — note a multi-master
        peer's requests are not visible here, which is why drains also
        wait for the ENGINE-reported load to go idle)."""
        rl = self._request_load_view.get(name)
        return (rl[0] + rl[2]) if rl else 0

    def routing_snapshot(self) -> RoutingSnapshot:
        """The current immutable routing view (lock-free read)."""
        return self._snapshot

    def draining_names(self) -> list[str]:
        """Instances on their way out — master-marked DRAINING or
        self-advertised draining (lock-free read off the snapshot's
        entry refs; state is a single reference read)."""
        snap = self._snapshot
        return [n for n, e in snap.entries.items()
                if e.state == InstanceRuntimeState.DRAINING
                or e.meta.draining]

    def snapshot_age_s(self, now: Optional[int] = None) -> float:
        """Age of the published routing snapshot in seconds (lock-free;
        fleet-observability gauge + /admin/hotpath)."""
        return round(((now or now_ms()) - self._snapshot.built_ms)
                     / 1000.0, 3)

    def dispatch_wire(self, name: str) -> str:
        """Negotiated dispatch-wire format for an instance (lock-free)."""
        return self._snapshot.wire.get(name, WIRE_JSON)

    def demote_wire(self, name: str) -> None:
        """Fall back to JSON dispatch for an instance that rejected
        msgpack with a 415 (legacy build behind a stale registration).
        Updates BOTH negotiation sites — the snapshot (async frontend
        dispatch) and the channel flag (sync failover dispatch) — so a
        demotion learned on one path isn't re-discovered at 415 cost on
        the other."""
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return
            if entry.channel is not None:
                with _ownership.escape("415 wire demotion: monotonic "
                                       "JSON fallback on the negotiation "
                                       "slot (GIL-atomic string swap)"):
                    entry.channel.wire_format = WIRE_JSON
            if WIRE_JSON == negotiate(entry.meta.wire_formats):
                return
            entry.meta.wire_formats = [WIRE_JSON]
            self._publish_snapshot()
        logger.warning("instance %s rejected msgpack dispatch; demoted to "
                       "JSON wire", name)

    # ------------------------------------------- sharded telemetry ingest
    def sharded(self) -> bool:
        """Is the sharded telemetry-ingest plane active? Requires the
        shard mode AND a live ownership router (direct-construction
        tests and embedded single-process use degrade to the legacy
        funnel)."""
        return (self._opts.telemetry_ingest_mode == "shard"
                and self._ownership is not None
                and self._ownership.enabled)

    def _frozen(self) -> bool:
        """True while the coordination plane is degraded and the census
        is frozen (see ctor `health`). Lock-free: the monitor guards its
        own state."""
        return self._health is not None and self._health.degraded()

    def owns_telemetry(self, name: str) -> bool:
        """Does THIS master own heartbeat/load ingest and failure
        detection for the instance? Uniformly True outside sharded mode
        (legacy funnel: whoever receives a heartbeat ingests it, every
        frontend runs its own detection). Lock-free: one memo lookup on
        the router's per-membership-epoch verdict cache (a rendezvous
        walk only on the first ask per epoch). Under XLLM_STATE_DEBUG the
        answer is noted per-thread — the runtime half of the `owner:`
        state discipline on the sharded heartbeat fields."""
        ok = (not self.sharded()) or self._ownership.owns_instance(name)
        _ownership.note_owner_guard("owns_telemetry", ok)
        return ok

    def telemetry_owner_addr(self, name: str) -> str:
        """The owning master's rpc address for an instance's telemetry
        ("" outside sharded mode)."""
        if not self.sharded():
            return ""
        return self._ownership.instance_owner(name)

    def publish_telemetry_frames(self) -> None:
        """Publish this master's coalesced load/lease frame (sync-tick
        cadence, EVERY active frontend — not just the elected master).
        The frame carries the FULL owned shard so a mirror converges
        from the latest frame alone; the key is this master's address,
        single-writer by construction. Skipped when nothing owned
        changed since the last publish (mirrors age their entries
        locally, so an unchanged shard needs no re-publish)."""
        if not self.sharded():
            return
        if self._frozen():
            # Degraded plane: don't publish frames built from a frozen
            # view — and do NOT drain the dirty/tombstone sets, they
            # keep accumulating as the frame-log resync material that
            # `resync_after_outage` flushes once the plane answers.
            self._health.hold(
                "loadframe_publish", self._ownership.self_addr,
                reason="plane degraded: frame publish suspended")
            return
        now = now_ms()
        rows: dict[str, dict] = {}
        gone: dict[str, str] = {}
        snap = self._snapshot
        with self._metrics_lock:
            dirty = bool(self._shard_dirty) or bool(self._shard_gone)
            horizon = now - 30_000
            with _ownership.escape("frame build drains this owner's own "
                                   "dirty set and prunes expired "
                                   "tombstones whole — owner-neutral "
                                   "bookkeeping, no per-instance verdict"):
                self._shard_dirty.clear()
                # Tombstones republish for a window (a mirror that missed
                # one frame catches the next), then age out.
                for n, (reason, ms) in list(self._shard_gone.items()):
                    if ms < horizon:
                        del self._shard_gone[n]
                    else:
                        gone[n] = reason
            owned = [n for n in snap.entries if self.owns_telemetry(n)]
            if not dirty and set(owned) == self._published_owned:
                return
            self._published_owned = set(owned)
            for n in owned:
                entry = snap.entries[n]
                rows[n] = {
                    "l": self._load_metrics.get(n, LoadMetrics()).to_dict(),
                    "y": self._latency_metrics.get(
                        n, LatencyMetrics()).to_dict(),
                    "hb": entry.last_heartbeat_ms,
                    "up": self._load_updated_ms.get(n, 0),
                    "st": entry.state.value,
                }
            self._shard_seq += 1
            seq = self._shard_seq
            self._frames_published += 1
        self._coord.set(
            LOADFRAME_KEY_PREFIX + self._ownership.self_addr,
            encode_load_frame(rows, gone, seq, now))
        LOADFRAMES_PUBLISHED_TOTAL.inc()

    def _on_load_frame_event(self, events: list[KeyEvent],
                             _prefix: str) -> None:
        """Mirror peer owners' coalesced frames into the local fleet
        view: load/latency/heartbeat/lease state for every instance THIS
        master does not own (local ingest is authoritative for owned
        ones), plus tombstone-driven deregistration. Heartbeat and
        telemetry ages are re-based onto the local clock from the frame's
        build timestamp, so staleness scoring needs no cross-host clock
        agreement."""
        if not self.sharded():
            return
        self_addr = self._ownership.self_addr
        for ev in events:
            if ev.type != WatchEventType.PUT:
                continue   # frame-key GC; latest-frame-per-owner model
            owner = ev.key[len(LOADFRAME_KEY_PREFIX):]
            if owner == self_addr:
                continue   # our own publication echoing back
            try:
                frame = decode_load_frame(ev.value)
            except ValueError as e:
                logger.warning("bad load frame from %s: %s", owner, e)
                continue
            self._apply_load_frame(owner, frame)

    def _apply_load_frame(self, owner: str, frame: dict) -> None:
        now = now_ms()
        frame_ms = int(frame.get("ms") or now)
        rows = frame.get("i", {})
        with self._cluster_lock:
            for name, row in rows.items():
                if self.owns_telemetry(name):
                    continue   # local ingest is authoritative
                entry = self._instances.get(name)
                if entry is None:
                    continue
                hb = int(row.get("hb") or 0)
                if hb:
                    # Re-base the owner's heartbeat age onto our clock;
                    # never move the local clock backwards (a direct
                    # foreign-routed beat may be fresher than the frame).
                    rebased = now - max(0, frame_ms - hb)
                    if rebased > entry.last_heartbeat_ms:
                        entry.last_heartbeat_ms = rebased
                st = row.get("st")
                if st and entry.state not in (
                        InstanceRuntimeState.DRAINING,
                        InstanceRuntimeState.BREAKER_OPEN):
                    # Apply the owner's SUSPECT/LEASE_LOST/ACTIVE verdict.
                    # DRAINING and BREAKER_OPEN stay local: draining is
                    # the write-lease holder's decision surfaced via
                    # meta, breaker state is THIS channel's evidence.
                    try:
                        new_state = InstanceRuntimeState(st)
                    except ValueError:
                        new_state = None
                    if new_state in (InstanceRuntimeState.ACTIVE,
                                     InstanceRuntimeState.LEASE_LOST,
                                     InstanceRuntimeState.SUSPECT):
                        self._set_state(entry, new_state)
        with self._metrics_lock:
            for name, row in rows.items():
                if self.owns_telemetry(name):
                    continue
                if name not in self._snapshot.entries:
                    continue
                self._load_metrics[name] = LoadMetrics.from_dict(
                    row.get("l") or {})
                self._latency_metrics[name] = LatencyMetrics.from_dict(
                    row.get("y") or {})
                up = int(row.get("up") or 0)
                rebased_up = now - max(0, frame_ms - up) if up else 0
                if rebased_up > self._load_updated_ms.get(name, 0):
                    self._load_updated_ms[name] = rebased_up
                self._update_load_info_locked(name)
            self._frames_applied += 1
        LOADFRAMES_APPLIED_TOTAL.inc()
        gone = frame.get("g") or {}
        if isinstance(gone, list):   # tolerate a reason-less tombstone list
            gone = {n: "owner eviction" for n in gone}
        for name, reason in gone.items():
            if self.owns_telemetry(name):
                continue
            if self._ownership.instance_owner(name) != owner:
                # Stale tombstone from a FORMER owner (membership moved
                # the shard since it was recorded): only the instance's
                # current rendezvous owner may verdict it — the current
                # owner's frames carry the live row.
                continue
            with self._cluster_lock:
                known = name in self._instances
            if known:
                logger.info("mirroring owner %s's eviction of %s (%s)",
                            owner, name, reason)
                self.deregister_instance(name, reason=reason)

    # ------------------------------------------------------------------ boot
    def _load_existing(self) -> None:
        """Boot-time fleet load WITH link fan-out (reference
        `instance_mgr.cpp:150-182`): when the master starts after engines
        registered (or restarts under a live fleet), every pre-existing
        P↔D pair still gets linked — each instance links to the peers
        already loaded before it, which covers all pairs; engine-side link
        is idempotent."""
        for key, val in self._coord.get_prefix(INSTANCE_KEY_PREFIX).items():
            try:
                meta = InstanceMetaInfo.from_json(val)
            except (json.JSONDecodeError, TypeError) as e:
                logger.warning("bad instance meta at %s: %s", key, e)
                continue
            if not self.register_instance(meta):
                logger.warning("boot-time registration of %s failed (link "
                               "fan-out); its lease will re-register it",
                               meta.name)

    # ------------------------------------------------------- watch callbacks
    def _on_instance_event(self, events: list[KeyEvent], _prefix: str) -> None:
        for ev in events:
            type_str, name = parse_instance_key(ev.key)
            if ev.type == WatchEventType.PUT:
                try:
                    meta = InstanceMetaInfo.from_json(ev.value)
                except (json.JSONDecodeError, TypeError) as e:
                    logger.warning("bad instance meta for %s: %s", name, e)
                    continue
                self._handle_instance_put(meta)
            else:
                self._handle_instance_delete(name)

    def _handle_instance_put(self, meta: InstanceMetaInfo) -> None:
        with self._cluster_lock:
            cur = self._instances.get(meta.name)
        if cur is None:
            self.register_instance(meta)
            return
        if cur.meta.incarnation_id == meta.incarnation_id:
            # Refresh registration → back to ACTIVE (reference
            # `instance_mgr.cpp:575-586,783-799`). Agents fit their SLO
            # profiling tables from live telemetry and refresh them with
            # each re-registration — refit the predictor when they change.
            with self._cluster_lock:
                refit = (meta.ttft_profiling_data !=
                         cur.meta.ttft_profiling_data or
                         meta.tpot_profiling_data !=
                         cur.meta.tpot_profiling_data)
                cur.meta = meta
                if cur.channel is not None:
                    # Keep the sync-dispatch flag coherent with the
                    # refreshed advertisement (one negotiation truth).
                    with _ownership.escape("registration refresh under "
                                           "_cluster_lock re-negotiates "
                                           "the wire slot (GIL-atomic "
                                           "string swap)"):
                        cur.channel.wire_format = \
                            negotiate(meta.wire_formats)
                if refit:
                    if meta.ttft_profiling_data:
                        cur.predictor.fit_ttft(meta.ttft_profiling_data)
                    if meta.tpot_profiling_data:
                        cur.predictor.fit_tpot(meta.tpot_profiling_data)
                if cur.state not in (InstanceRuntimeState.DRAINING,
                                     InstanceRuntimeState.BREAKER_OPEN):
                    # A draining instance keeps re-registering while its
                    # in-flight work finishes (lease keepalive) — the
                    # refresh must not resurrect it into the schedulable
                    # set mid-drain. Likewise a breaker-open instance:
                    # its lease renewing IS the sick-but-leased failure
                    # mode; only the half-open probe restores it.
                    self._set_state(cur, InstanceRuntimeState.ACTIVE)
                # Meta replacement can change schedulability (draining
                # flag) or the wire format even when the state didn't
                # flip — republish unconditionally.
                self._publish_snapshot()
            return
        # New incarnation: instance replacement (reference
        # `instance_mgr.cpp:588-601`).
        logger.info("instance %s replaced (incarnation %s -> %s)",
                    meta.name, cur.meta.incarnation_id, meta.incarnation_id)
        self.deregister_instance(meta.name, reason="replaced")
        self.register_instance(meta)

    def _handle_instance_delete(self, name: str) -> None:
        """Lease lapse: probe health, then LEASE_LOST (grace) or SUSPECT
        (reference `instance_mgr.cpp:500-539,604-661`).

        DRAINING special case: a draining instance that stops refreshing
        its lease AND fails the probe has completed its planned shutdown
        (agents self-stop once their in-flight work finishes) — it
        deregisters gracefully, no SUSPECT window, no eviction alarm. If
        it still had bound requests (killed mid-drain), the deregister's
        failure callback routes them through the NORMAL failover path.

        Sharded telemetry ingest: only the OWNING master probes and
        verdicts — non-owners leave the entry as-is and converge on the
        owner's lease state via its load frames (O(1) probes per lapse
        instead of O(masters); the owner's verdict is the one built from
        the heartbeat stream it actually receives)."""
        if not self.owns_telemetry(name):
            return
        if self._frozen():
            # Census freeze: during a coordination outage EVERY lease
            # lapses (including the watch-resync's synthesized DELETEs
            # after a server restart) — a lapse is evidence about the
            # plane, not the instance. Liveness falls back to direct
            # heartbeat silence (`reconcile_once` under the degraded
            # threshold); a chatty instance never transits SUSPECT here.
            self._health.note_frozen("lease_lapse", name)
            return
        with self._cluster_lock:
            entry = self._instances.get(name)
            channel = entry.channel if entry else None
        if entry is None:
            return
        ok = False
        if channel is not None:
            for _ in range(self._opts.health_probe_attempts):
                if channel.health(timeout_s=self._opts.health_probe_timeout_s):
                    ok = True
                    break
                time.sleep(0.01 if self._stopped.is_set() else
                           min(self._opts.health_probe_timeout_s, 1.0))
        drained = False
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return
            if entry.state == InstanceRuntimeState.DRAINING:
                if ok:
                    return   # lease blip while draining: stay DRAINING
                drained = True
            else:
                self._set_state(entry, InstanceRuntimeState.LEASE_LOST if ok
                                else InstanceRuntimeState.SUSPECT)
        if drained:
            self.deregister_instance(name, reason="drained")
            return
        logger.info("instance %s lease lost; probe %s -> %s", name,
                    "ok" if ok else "failed", entry.state.value)

    def _on_loadmetrics_event(self, events: list[KeyEvent], _prefix: str) -> None:
        """Non-master replicas mirror load metrics from coordination
        (reference `instance_mgr.cpp:665-706`)."""
        with self._metrics_lock:
            for ev in events:
                name = ev.key[len(LOADMETRICS_KEY_PREFIX):]
                if ev.type == WatchEventType.PUT:
                    try:
                        d = json.loads(ev.value)
                    except json.JSONDecodeError:
                        continue
                    self._load_metrics[name] = LoadMetrics.from_dict(
                        d.get("load", {}))
                    self._latency_metrics[name] = LatencyMetrics.from_dict(
                        d.get("latency", {}))
                    self._load_updated_ms[name] = now_ms()
                else:
                    self._load_metrics.pop(name, None)
                    self._latency_metrics.pop(name, None)
                    self._load_updated_ms.pop(name, None)
                self._update_load_info_locked(name)

    # --------------------------------------------------------- registration
    def register_instance(self, meta: InstanceMetaInfo,
                          link_peers: bool = True) -> bool:
        """Reference `instance_mgr.cpp:1155-1210,1289-1396`."""
        channel = self._channel_factory(meta.name, meta.rpc_address)
        # Negotiate the dispatch wire from the advertised formats, and
        # prime the connection pool (TCP keepalive handshake) so the first
        # real call doesn't pay connection setup. Warm-up runs on a
        # background thread: registration executes on the coordination
        # watch thread, and an unreachable instance's connect timeout must
        # not stall eviction/heartbeat event processing behind it. Both
        # tolerate test doubles without the richer channel API.
        with _ownership.escape("pre-publication: the channel is not yet "
                               "visible to any other thread"):
            channel.wire_format = negotiate(meta.wire_formats)
        warm = getattr(channel, "warm_up", None)
        if warm is not None:
            threading.Thread(target=warm, daemon=True,
                             name=f"chan-warmup-{meta.name}").start()
        entry = _Entry(meta=meta, channel=channel)
        if meta.ttft_profiling_data:
            entry.predictor.fit_ttft(meta.ttft_profiling_data)
        if meta.tpot_profiling_data:
            entry.predictor.fit_tpot(meta.tpot_profiling_data)

        # Link fan-out OUTSIDE locks (reference async-outside-lock pattern,
        # `instance_mgr.cpp:1189-1202`): new P links to all D, new D to all P,
        # MIX to all peers; rollback on partial failure (1324-1336).
        if link_peers and meta.type in (InstanceType.PREFILL,
                                        InstanceType.DECODE, InstanceType.MIX):
            peers = self._link_targets(meta)
            linked: list[_Entry] = []
            failed = False
            for peer in peers:
                if peer.channel is not None and not peer.channel.link(meta):
                    failed = True
                    break
                if channel.link(peer.meta):
                    linked.append(peer)
                else:
                    failed = True
                    break
            if failed:
                for peer in linked:
                    if peer.channel is not None:
                        peer.channel.unlink(meta.name)
                    channel.unlink(peer.meta.name)
                logger.warning("registration of %s rolled back: link failure",
                               meta.name)
                channel.close()
                return False

        with self._cluster_lock:
            old = self._instances.get(meta.name)
            if old is not None and old.channel is not None and old.channel is not channel:
                old.channel.close()
            self._instances[meta.name] = entry
            self._publish_snapshot()
        # A legitimate re-registration (rolling restart, same name) may
        # re-create series evicted with the previous incarnation — clear
        # the leak verifier's tombstones so those are not misreported as
        # the stale-writer resurrection bug.
        _lifecycle.note_series_revived(meta.name)
        with self._metrics_lock:
            self._load_metrics.setdefault(meta.name, LoadMetrics())
            self._request_loads.setdefault(meta.name, _RequestLoad())
            self._publish_request_load_locked(meta.name)
            if self.owns_telemetry(meta.name):
                # A (re-)registration supersedes any pending eviction
                # tombstone: without this the tombstone keeps
                # republishing for its 30s window and every mirror
                # deregisters the LIVE re-registered instance on each
                # frame tick — a fleet-wide routing flap under rolling
                # restarts. Mark the shard dirty so the
                # next frame carries the resurrection row immediately.
                self._shard_gone.pop(meta.name, None)
                self._shard_dirty.add(meta.name)
        logger.info("registered instance %s type=%s incarnation=%s",
                    meta.name, meta.type.value, meta.incarnation_id)
        return True

    def _link_targets(self, meta: InstanceMetaInfo) -> list[_Entry]:
        with self._cluster_lock:
            if meta.type == InstanceType.PREFILL:
                types = (InstanceType.DECODE, InstanceType.MIX)
            elif meta.type == InstanceType.DECODE:
                types = (InstanceType.PREFILL, InstanceType.MIX)
            else:  # MIX links to all PD peers
                types = (InstanceType.PREFILL, InstanceType.DECODE,
                         InstanceType.MIX)
            return [e for e in self._instances.values()
                    if e.meta.type in types and e.meta.name != meta.name]

    def deregister_instance(self, name: str, reason: str = "") -> None:
        """Unlink peers → drop indices → cancel bound requests → drop state
        (reference `instance_mgr.cpp:1212-1265`)."""
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return
            peers = self._link_targets(entry.meta)
            incarnation = entry.meta.incarnation_id
            itype = entry.meta.type
        for peer in peers:
            if peer.channel is not None:
                peer.channel.unlink(name)
        with self._cluster_lock:
            entry = self._instances.pop(name, None)
            if entry is None:
                return
            # Publish BEFORE closing the channel: a hot-path reader holding
            # the superseded snapshot may still grab the channel reference,
            # and a closed session surfaces as a dispatch failure (handled
            # by failover), not a crash.
            self._publish_snapshot()
            if entry.channel is not None:
                entry.channel.close()
        with self._metrics_lock:
            self._load_metrics.pop(name, None)
            self._latency_metrics.pop(name, None)
            self._load_updated_ms.pop(name, None)
            self._request_loads.pop(name, None)
            self._publish_request_load_locked(name)
            self._removed_load_names.add(name)
            self._updated_load_names.discard(name)
            if self.owns_telemetry(name):
                # Owner-gated tombstone: the
                # eviction rides this master's next load frame so every
                # mirror deregisters too, with the original reason (a
                # mirrored graceful drain must not page anyone either).
                self._shard_gone[name] = (reason or "owner eviction",
                                          now_ms())
                self._shard_dirty.discard(name)
            # Drop the dead instance's gauge series so /metrics stops
            # exporting stale labels. Inside _metrics_lock: the gauge
            # writers gate on _load_metrics membership under the same
            # lock, so a racing write can't resurrect a removed series.
            evict_series(INSTANCE_QUEUE_DEPTH, instance=name)
            for phase in ("prefill", "decode"):
                evict_series(INSTANCE_INFLIGHT_REQUESTS, instance=name,
                             phase=phase)
        # High-cardinality per-instance latency/retry series go too (a
        # histogram is 17 lines per child; fleet churn with ephemeral
        # ports would grow /metrics without bound). FAILOVER_* and
        # eviction counters are kept: they are the failure history, and
        # grow one small child per eviction event, not per instance
        # lifetime of traffic.
        policy = self._opts.load_balance_policy
        evict_series(TTFT_MS, instance=name, policy=policy)
        evict_series(ITL_MS, instance=name, policy=policy)
        evict_series(RPC_RETRIES_TOTAL, instance=name)
        evict_series(CIRCUIT_BREAKER_OPEN, instance=name)
        evict_series(LOADINFO_AGE_SECONDS, instance=name)
        if reason not in ("replaced", "drained"):
            # Planned churn — a rolling-restart re-registration or a
            # completed graceful drain (autoscaler scale-in) — is not an
            # eviction; don't page anyone. A drain that blew its deadline
            # ("drain deadline") still counts: something held requests.
            INSTANCE_EVICTIONS_TOTAL.labels(instance=name).inc()
        logger.info("deregistered instance %s (%s)", name, reason)
        if self.on_instance_failure is not None:
            self.on_instance_failure(name, incarnation, itype)

    # ----------------------------------------------------------- heartbeats
    def record_instance_heartbeat(self, name: str, incarnation_id: str,
                                  load: Optional[LoadMetrics] = None,
                                  latency: Optional[LatencyMetrics] = None) -> bool:
        """Incarnation-checked heartbeat ingest; SUSPECT → LEASE_LOST
        recovery (reference `instance_mgr.cpp:451-478`)."""
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return False
            if incarnation_id and entry.meta.incarnation_id and \
                    incarnation_id != entry.meta.incarnation_id:
                return False  # stale heartbeat from a dead incarnation
            entry.last_heartbeat_ms = now_ms()
            if entry.state == InstanceRuntimeState.SUSPECT:
                self._set_state(entry, InstanceRuntimeState.LEASE_LOST)
        owned_beat: Optional[bool] = None
        if load is not None or latency is not None:
            with self._metrics_lock:
                if load is not None:
                    # Gauge write gated on membership BEFORE the store:
                    # a heartbeat that raced a deregister (instance check
                    # passed, then the instance was dropped) must not
                    # resurrect the removed gauge series.
                    if name in self._load_metrics:
                        INSTANCE_QUEUE_DEPTH.labels(instance=name).set(
                            load.waiting_requests_num)
                    self._load_metrics[name] = load
                if latency is not None:
                    self._latency_metrics[name] = latency
                self._load_updated_ms[name] = now_ms()
                self._updated_load_names.add(name)
                if self.owns_telemetry(name):
                    # Owner-gated frame input:
                    # only the telemetry owner coalesces this beat into
                    # its published load frame. A foreign-routed beat
                    # (membership race, legacy engine) still updated the
                    # LOCAL view above — fresh data beats none — but the
                    # owner's frame is the one mirrors converge on.
                    self._shard_dirty.add(name)
                    owned_beat = True
                else:
                    self._foreign_heartbeats += 1
                    owned_beat = False
                self._update_load_info_locked(name)
        # Reuse the in-lock verdict: a second owns_telemetry() here would
        # repeat the shard lookup on the exact hot path this plane exists
        # to thin. Bare beats (no metrics — the kv-relay
        # path) re-ask, but the answer now comes from the router's
        # per-membership-epoch verdict memo, not a fresh rendezvous walk.
        if owned_beat is None:
            owned_beat = self.owns_telemetry(name)
        HEARTBEATS_INGESTED_TOTAL.labels(
            shard="owned" if owned_beat else "foreign").inc()
        return True

    def _set_state(self, entry: _Entry, state: InstanceRuntimeState) -> None:
        """State transition + snapshot republish (all call sites hold
        `_cluster_lock`; the publish re-enter is reentrant)."""
        if entry.state != state:
            entry.state = state
            entry.state_since_ms = now_ms()
            self._publish_snapshot()

    # ------------------------------------------------------------ reconcile
    def _reconcile_loop(self) -> None:
        while not self._stopped.wait(self._opts.reconcile_interval_s):
            self.reconcile_once()

    def reconcile_once(self) -> None:
        """One pass of the 1s reconcile thread (reference
        `instance_mgr.cpp:719-781`): LEASE_LOST with heartbeat silence →
        SUSPECT; SUSPECT older than eviction window → deregister;
        DRAINING instances deregister gracefully once idle (or at the
        drain deadline, stragglers riding the normal failover path);
        circuit-breaker state mirrored into routing (BREAKER_OPEN) with
        the half-open recovery probe driven from here."""
        now = now_ms()
        to_evict: list[str] = []
        to_drain_check: list[tuple[str, int]] = []
        to_probe: list[tuple[str, EngineChannel]] = []
        to_lease_check: list[tuple[str, str]] = []
        to_failover: list[tuple[str, str, InstanceType]] = []
        shard = self.sharded()
        frozen = self._frozen()
        # Degraded liveness fallback: with lease evidence frozen, ACTIVE
        # instances are judged on direct heartbeat silence over the
        # (outage-immune) telemetry sessions — under the LONGER degraded
        # threshold, so a chatty instance never dies and a genuinely
        # silent one still does.
        degraded_silence_ms = max(
            self._opts.degraded_heartbeat_silence_s,
            self._opts.heartbeat_silence_to_suspect_s) * 1000
        with self._cluster_lock:
            if shard:
                owned_now = {n for n in self._instances
                             if self._ownership.owns_instance(n)}
                for name in owned_now - self._owned_names:
                    # Ownership takeover (a member died or joined and the
                    # rendezvous map moved this instance to us): grant a
                    # fresh heartbeat grace. The engine re-routes its
                    # beats within one interval; judging it on silence
                    # accrued while SOMEBODY ELSE owned its ingest would
                    # SUSPECT a healthy instance — the exact spurious
                    # transition the owner-death chaos drill forbids.
                    entry = self._instances[name]
                    entry.last_heartbeat_ms = max(entry.last_heartbeat_ms,
                                                  now)
                self._owned_names = owned_now
            for name, entry in self._instances.items():
                # Sharded ingest: silence verdicts and eviction timers
                # run only on the telemetry owner — non-owners converge
                # on the owner's lease state via its load frames and
                # tombstones. Local concerns (drain completion, circuit-
                # breaker mirroring of THIS frontend's channel evidence)
                # run everywhere.
                owner = not shard or name in self._owned_names
                if frozen and owner \
                        and entry.state == InstanceRuntimeState.ACTIVE \
                        and now - entry.last_heartbeat_ms \
                        > degraded_silence_ms:
                    # Every lease is lapsed during a total outage, so
                    # silent here IS silent-and-lease-lapsed: exclude
                    # from routing now; the eviction itself is held and
                    # replayed (or discarded, if the beats resume) after
                    # recovery.
                    self._set_state(entry, InstanceRuntimeState.SUSPECT)
                    logger.warning(
                        "instance %s: ACTIVE -> SUSPECT on degraded-mode "
                        "heartbeat silence (%dms, plane down)", name,
                        now - entry.last_heartbeat_ms)
                    # Bound in-flight requests fail over NOW: request
                    # re-dispatch is data-plane and request-scoped, not
                    # an ownership-changing action — only the census
                    # eviction waits for recovery. Without this, streams
                    # bound to an engine that died mid-outage would hang
                    # until the plane returns.
                    to_failover.append((name, entry.meta.incarnation_id,
                                        entry.meta.type))
                elif owner and entry.state == InstanceRuntimeState.ACTIVE \
                        and not frozen \
                        and (shard
                             or now < self._post_outage_sweep_until_ms) \
                        and now - entry.last_heartbeat_ms > (
                            self._opts.heartbeat_silence_to_suspect_s
                            + self._opts.lease_ttl_s) * 1000:
                    # Missed-DELETE sweep: the lease-lapse event may have
                    # fired while ANOTHER master owned this instance (and
                    # died before verdicting) — or was synthesized and
                    # dropped under the census freeze during an outage
                    # (the post-outage window extends the sweep to the
                    # funnel mode, whose DELETE events are otherwise
                    # reliable). An owned, silent, still-ACTIVE entry is
                    # checked against coordination outside the lock; an
                    # absent key re-runs the normal lapse pipeline
                    # (probe -> LEASE_LOST/SUSPECT).
                    to_lease_check.append((name, entry.meta.type.value))
                if owner and entry.state in (
                        InstanceRuntimeState.LEASE_LOST,
                        InstanceRuntimeState.BREAKER_OPEN):
                    # Heartbeat-silence promotion applies to BREAKER_OPEN
                    # too: a breaker-open instance that also goes SILENT
                    # is dead, not busy — without this it would sit
                    # outside the SUSPECT/evict path forever (no eviction
                    # timer by design, no further lease-delete event, and
                    # every half-open probe just re-opens the breaker),
                    # stranding its bound requests away from failover.
                    silence = now - entry.last_heartbeat_ms
                    threshold_ms = degraded_silence_ms if frozen else \
                        self._opts.heartbeat_silence_to_suspect_s * 1000
                    if silence > threshold_ms:
                        was = entry.state.value
                        self._set_state(entry, InstanceRuntimeState.SUSPECT)
                        logger.info("instance %s: %s -> SUSPECT "
                                    "(heartbeat silence %dms)", name, was,
                                    silence)
                if entry.state == InstanceRuntimeState.SUSPECT:
                    age = now - entry.state_since_ms
                    if owner and age > \
                            self._opts.detect_disconnected_instance_interval_s * 1000:
                        if frozen:
                            # Eviction is an ownership-changing action
                            # (coordination rm + tombstone): held until
                            # recovery, where it replays only if the
                            # instance is STILL suspect-and-silent.
                            self._health.hold(
                                "evict", name,
                                reason="plane degraded: suspect eviction "
                                       "held")
                        elif self._health is None \
                                or not self._health.evict_pending(name):
                            # A held eviction is the recovery replay's
                            # to decide: the census unfreezes before the
                            # replay runs, and evicting here first would
                            # turn the replay into "already gone".
                            to_evict.append(name)
                elif entry.state == InstanceRuntimeState.DRAINING:
                    to_drain_check.append((name, now - entry.state_since_ms))
                elif entry.state in (InstanceRuntimeState.ACTIVE,
                                     InstanceRuntimeState.LEASE_LOST) \
                        and entry.channel is not None \
                        and getattr(entry.channel, "breaker", None) is not None \
                        and entry.channel.breaker.state() == "open":
                    # Sick-but-leased: the channel's rolling window
                    # tripped. Exclude from routing like SUSPECT — but
                    # no eviction timer; recovery is probe-driven.
                    self._set_state(entry,
                                    InstanceRuntimeState.BREAKER_OPEN)
                    CIRCUIT_BREAKER_OPEN.labels(instance=name).set(1)
                    logger.warning("instance %s: circuit breaker OPEN; "
                                   "excluded from routing", name)
                elif entry.state == InstanceRuntimeState.BREAKER_OPEN \
                        and entry.channel is not None:
                    to_probe.append((name, entry.channel))
        for name, channel in to_probe:
            breaker = getattr(channel, "breaker", None)
            if breaker is None:
                continue   # test double without the breaker API
            # Half-open probe OUTSIDE the lock: the breaker itself gates
            # (fast no-op while the open cooldown holds, one probe at a
            # time after it). A successful probe closes the breaker; the
            # instance returns to routing on the same pass.
            channel.health(timeout_s=self._opts.health_probe_timeout_s)
            if breaker.state() == "closed":
                restored = False
                with self._cluster_lock:
                    entry = self._instances.get(name)
                    if entry is not None and \
                            entry.state == InstanceRuntimeState.BREAKER_OPEN:
                        self._set_state(entry, InstanceRuntimeState.ACTIVE)
                        restored = True
                if restored:
                    # Gauge write gated on the entry still existing: a
                    # concurrent deregister already evicted the series —
                    # an unconditional set(0) would resurrect it.
                    CIRCUIT_BREAKER_OPEN.labels(instance=name).set(0)
                    logger.info("instance %s: circuit breaker closed "
                                "(half-open probe ok); restored to "
                                "routing", name)
        for name, type_str in to_lease_check:
            # Outside the lock: one coordination read per silent-but-
            # ACTIVE owned instance (rare — only when a lapse verdict was
            # missed during an ownership handoff).
            if self._coord.get(instance_key(type_str, name)) is None:
                logger.info("owned instance %s silent with no lease; "
                            "running missed lapse detection", name)
                self._handle_instance_delete(name)
        for name, incarnation, itype in to_failover:
            # Outside the lock, same callback deregister_instance fires:
            # the scheduler voids the dead binding's streams and replays
            # them onto survivors from the (frozen) routing snapshot.
            if self.on_instance_failure is not None:
                self.on_instance_failure(name, incarnation, itype)
        for name in to_evict:
            self.deregister_instance(name, reason="suspect eviction")
        for name, age_ms in to_drain_check:
            if frozen:
                # Drain completion/deadline deregisters write to
                # coordination — held; the drain clock keeps running and
                # the verdict replays after recovery.
                self._health.hold(
                    "drain_deregister", name,
                    reason="plane degraded: drain deregistration held")
            elif age_ms > self._opts.autoscaler_drain_deadline_s * 1000:
                # Deadline: something is holding requests open — cut it
                # loose; bound requests ride the normal failover path.
                logger.warning("instance %s blew the drain deadline "
                               "(%.0fs); deregistering", name, age_ms / 1000)
                self.deregister_instance(name, reason="drain deadline")
            elif age_ms > self._opts.autoscaler_drain_grace_s * 1000 \
                    and self.inflight_requests(name) == 0 \
                    and self._engine_reported_idle(name):
                # Idle on BOTH books — this frontend's in-flight
                # accounting AND the engine's own reported load (which
                # covers multi-master peers' requests too).
                self.deregister_instance(name, reason="drained")
        # SLO role flips + drains requested off-path run here, never on
        # the client's critical path.
        self.drain_pending_flips()

    def resync_after_outage(self) -> None:
        """Post-outage frame-log resync + census re-arm (sync thread,
        called from the scheduler's recovery callback): every owned
        instance is marked dirty so the next publish carries the FULL
        shard (mirrors reconverge from a single frame), and the
        missed-DELETE sweep window opens so lease lapses whose DELETE
        events were dropped under the freeze are re-detected from
        silence."""
        now = now_ms()
        window_ms = int((self._opts.degraded_heartbeat_silence_s
                         + self._opts.heartbeat_silence_to_suspect_s
                         + 2 * self._opts.lease_ttl_s) * 1000)
        with self._cluster_lock:
            names = list(self._instances)
            self._post_outage_sweep_until_ms = now + max(window_ms, 1000)
        if self.sharded():
            with self._metrics_lock:
                for n in names:
                    if self.owns_telemetry(n):
                        self._shard_dirty.add(n)

    def replay_held_eviction(self, name: str, reason: str) -> str:
        """Replay one held eviction verdict after recovery: evict only
        if the instance is STILL suspect-and-silent now that the plane
        answers — an instance whose beats resumed during the outage is
        spared (the hold recorded a moment, not a sentence). Returns the
        outcome string the scheduler flight-records."""
        if self.sharded() and not self._ownership.owns_instance(name):
            # Shard map moved while the plane was down: the verdict now
            # belongs to another frontend, whose own silence pipeline
            # re-derives it from live beats.
            return "discarded: telemetry ownership moved during the outage"
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return "discarded: already gone"
            silence_ms = now_ms() - entry.last_heartbeat_ms
            state = entry.state
        if state == InstanceRuntimeState.DRAINING:
            # The drain books (in-flight counts, engine-reported load)
            # are live again: the normal reconcile pass re-evaluates
            # grace/deadline with current data.
            return "superseded: reconcile re-evaluates the drain"
        if state != InstanceRuntimeState.SUSPECT:
            return "discarded: instance recovered"
        if silence_ms <= self._opts.heartbeat_silence_to_suspect_s * 1000:
            return "discarded: heartbeats resumed"
        self.deregister_instance(name, reason=reason)
        return "replayed: evicted"

    def _engine_reported_idle(self, name: str) -> bool:
        """True when the instance's last heartbeat reported zero waiting
        and running requests (lock-free read of the published load-info
        view)."""
        info = self._load_infos.get(name)
        if info is None:
            return True
        return (info.load.waiting_requests_num == 0
                and info.load.running_requests_num == 0)

    # ------------------------------------------------------ scheduling reads
    # All lock-free: one read of the published snapshot reference.
    def get_next_instance_pair(self) -> Routing:
        """RR over the snapshot's schedulable role lists; DEFAULT/MIX-only
        fallback when no decode fleet exists (reference
        `instance_mgr.cpp:203-254`)."""
        snap = self._snapshot
        if not snap.prefill:
            return Routing()
        prefill = snap.prefill[next(self._rr_prefill) % len(snap.prefill)]
        if not snap.decode:
            return Routing(prefill_name=prefill)
        pool = snap.decode
        if snap.topo_active and self._opts.topology_tradeoff > 0:
            # Topology plane armed: RR over the decodes sharing the
            # chosen prefill's slice (ICI/local handoff) — the full
            # fleet only when that slice has no decode. RR carries no
            # load signal, so there is no skew to trade off against;
            # locality simply wins. Flat fleets (one effective slice)
            # never take this branch.
            local = snap.decode_by_slice.get(snap.coords[prefill].slice_id)
            if local:
                pool = local
        decode = pool[next(self._rr_decode) % len(pool)]
        if decode == prefill:
            # A MIX instance picked for both roles serves both stages.
            return Routing(prefill_name=prefill)
        return Routing(prefill_name=prefill, decode_name=decode)

    def get_next_encode_instance(self) -> str:
        """RR over ENCODE-role instances (EPD three-stage routing; the
        reference only claims EPD — README.md:47 — the mechanism is ours)."""
        snap = self._snapshot
        if not snap.encode:
            return ""
        return snap.encode[next(self._rr_encode) % len(snap.encode)]

    def get_load_infos(self) -> dict[str, InstanceLoadInfo]:
        """Per-instance view for CAR scoring (reference `get_load_metrics`,
        `instance_mgr.cpp:287-359`). LOCK-FREE: returns the published
        view (rebuilt by load/latency/membership writers) — callers must
        treat it as immutable. Each entry carries ``updated_ms``
        (telemetry freshness) so staleness-aware scoring can discount
        entries mirrored from an old master upload."""
        return self._load_infos

    def stale_load_names(self, now: Optional[int] = None) -> set[str]:
        """Instances whose telemetry is older than
        ``loadinfo_stale_after_s`` — RELATIVE staleness: when every entry
        is equally stale (bootstrap, idle fleet, no heartbeats yet) the
        set is empty, because a uniform discount carries no routing
        signal and would only distort absolute SLO thresholds.
        Lock-free: one read of the published load-info view."""
        infos = self._load_infos
        if not infos:
            return set()
        now = now or now_ms()
        horizon = now - int(self._opts.loadinfo_stale_after_s * 1000)
        stale = {n for n, i in infos.items() if i.updated_ms < horizon}
        if len(stale) == len(infos):
            return set()
        return stale

    def load_info_ages_s(self, now: Optional[int] = None) -> dict[str, float]:
        """Per-instance telemetry age in seconds (-1 = never updated) for
        the admin surface and the planner's staleness report."""
        now = now or now_ms()
        return {n: round((now - i.updated_ms) / 1000.0, 3)
                if i.updated_ms else -1.0
                for n, i in self._load_infos.items()}

    def bind_request_instance_incarnations(self, req: Request) -> bool:
        """Reference `instance_mgr.cpp:408-449`: record the incarnations the
        request is bound to, for stale-output suppression and targeted
        cancellation.

        RCU validation step: incarnations come from the CURRENT snapshot,
        which may be newer than the one routing selected from. Returns
        False when the routed pair is no longer schedulable there (evicted
        / replaced / drained between select and bind) — the caller must
        re-select instead of dispatching into a dead binding."""
        snap = self._snapshot
        req.prefill_incarnation = \
            snap.incarnations.get(req.routing.prefill_name, "")
        req.decode_incarnation = \
            snap.incarnations.get(req.routing.decode_name, "")
        if req.routing.prefill_name not in snap.schedulable:
            return False
        return (not req.routing.decode_name
                or req.routing.decode_name in snap.schedulable)

    def get_channel(self, name: str) -> Optional[EngineChannel]:
        return self._snapshot.channels.get(name)

    def get_instance_meta(self, name: str) -> Optional[InstanceMetaInfo]:
        with self._cluster_lock:
            entry = self._instances.get(name)
            return entry.meta if entry else None

    def get_instance_state(self, name: str) -> Optional[InstanceRuntimeState]:
        with self._cluster_lock:
            entry = self._instances.get(name)
            return entry.state if entry else None

    def list_instances(self, itype: Optional[InstanceType] = None) -> list[InstanceMetaInfo]:
        with self._cluster_lock:
            return [e.meta for e in self._instances.values()
                    if itype is None or e.meta.type == itype]

    def has_available_instances(self) -> bool:
        """Readiness gate (reference `instance_mgr.cpp:1430-1472`),
        precomputed at snapshot build — the per-request readiness
        middleware reads one bool instead of walking the fleet under
        `_cluster_lock`."""
        return self._snapshot.has_available

    # ------------------------------------------------- SLO core + role flips
    def update_request_metrics(self, req: Request, action: RequestAction,
                               n_new: int = 1) -> None:
        """Per-action token/request accounting (reference
        `instance_mgr.cpp:825-903`). `n_new` = generated tokens carried by
        this delta; credits must sum to exactly `ntok +
        num_generated_tokens` so the FINISH_DECODE/CANCEL reversal zeroes
        out instead of drifting (clamped drift still skews SLO routing)."""
        pname, dname = req.routing.prefill_name, req.routing.decode_name or req.routing.prefill_name
        ntok = len(req.token_ids) or req.metrics.prompt_tokens
        with self._metrics_lock:
            pl = self._request_loads.setdefault(pname, _RequestLoad())
            dl = self._request_loads.setdefault(dname, _RequestLoad())
            if action == RequestAction.SCHEDULE:
                pl.num_prefill_requests += 1
                pl.num_prefill_tokens += ntok
                # Pair-link census (lock: _metrics_lock): which link
                # class this request's KV handoff will ride. Coordinates
                # come from the current snapshot — racing a republish
                # can misclassify ONE count, never corrupt state.
                if not req.routing.decode_name \
                        or req.routing.decode_name == pname:
                    link = "mix"
                else:
                    snap = self._snapshot
                    ca, cb = snap.coords.get(pname), snap.coords.get(dname)
                    link = topo.link_class(ca, cb) \
                        if ca is not None and cb is not None else "unknown"
                self._pair_links[link] = self._pair_links.get(link, 0) + 1
            elif action == RequestAction.FINISH_PREFILL:
                pl.num_prefill_requests = max(0, pl.num_prefill_requests - 1)
                pl.num_prefill_tokens = max(0, pl.num_prefill_tokens - ntok)
                dl.num_decode_requests += 1
                dl.num_decode_tokens += ntok + n_new
            elif action == RequestAction.DECODE_STEP:
                dl.num_decode_tokens += n_new
            elif action == RequestAction.FINISH_DECODE:
                dl.num_decode_requests = max(0, dl.num_decode_requests - 1)
                dl.num_decode_tokens = max(
                    0, dl.num_decode_tokens - ntok - req.num_generated_tokens)
            elif action == RequestAction.CANCEL:
                # Pre-first-token exit: only the SCHEDULE increments exist.
                pl.num_prefill_requests = max(0, pl.num_prefill_requests - 1)
                pl.num_prefill_tokens = max(0, pl.num_prefill_tokens - ntok)
            # Gauge writes stay under _metrics_lock (leaf metric locks nest
            # below it) so concurrent exits can't publish stale snapshots
            # out of order. A DECODE_STEP changes neither request count —
            # skip the churn. Gate on _load_metrics membership: exit
            # accounting for a just-deregistered instance must not
            # resurrect the gauge series deregister_instance removed.
            if action != RequestAction.DECODE_STEP:
                if pname in self._load_metrics:
                    INSTANCE_INFLIGHT_REQUESTS.labels(
                        instance=pname, phase="prefill").set(
                        pl.num_prefill_requests)
                if dname in self._load_metrics:
                    INSTANCE_INFLIGHT_REQUESTS.labels(
                        instance=dname, phase="decode").set(
                        dl.num_decode_requests)
            # Republish the lock-free request-load view (COW of the two
            # touched entries) so SLO scoring reads current in-flight
            # token counts without taking `_metrics_lock`.
            self._publish_request_load_locked(pname, dname)

    def select_instance_pair_on_slo(self, req: Request) -> Routing:
        """SLO-aware pair selection with dynamic PD flipping (reference
        `instance_mgr.cpp:905-1063`). The selection kernel lives in
        policies/slo_aware.py and is LOCK-FREE: routing snapshot +
        published request-load view, staleness-aware — no
        `_metrics_lock` fleet re-scan on the schedule path."""
        from .policies.slo_aware import select_pair_on_slo

        return select_pair_on_slo(self, self._opts, req)

    def request_flip(self, name: str, new_type: InstanceType) -> None:
        """Enqueue a role flip to be performed by the reconcile thread
        (engine RPC + coordination writes stay off the request path)."""
        with self._flip_lock:
            self._pending_flips[name] = new_type

    def request_drain(self, name: str) -> None:
        """Enqueue a graceful drain (autoscaler scale-in / operator
        retirement): the reconcile thread tells the engine to drain
        (it advertises `draining` and self-stops once idle) and marks
        the entry DRAINING so routing excludes it immediately. Enqueued
        only by the elected master's controller (write-lease
        discipline)."""
        with self._flip_lock:
            self._pending_drains.add(name)

    def drain_pending_flips(self) -> None:
        if self._frozen():
            # Flips move coordination records and drains retire fleet
            # members — both ownership-changing. Leave the queues intact
            # (they are idempotent sets); note the suppression once per
            # pass so the recovery bundle shows how long they waited.
            with self._flip_lock:
                pending = len(self._pending_flips) + len(self._pending_drains)
            if pending:
                self._health.hold(
                    "flip", "pending",
                    reason="plane degraded: pending flips/drains "
                           "suspended", pending=pending)
            return
        with self._flip_lock:
            pending = dict(self._pending_flips)
            self._pending_flips.clear()
            drains = sorted(self._pending_drains)
            self._pending_drains.clear()
        if drains and not self._is_master:
            # Write-lease discipline: a drain enqueued by the elected
            # master's controller must NOT be enacted by a frontend that
            # was demoted before its reconcile pass ran — the new master
            # owns retirement decisions now (and may pick a different
            # victim). Dropped, not proxied: unlike flips, a drain hint
            # is not idempotent fleet-wide.
            logger.info("dropping %d pending drain(s) after demotion: %s",
                        len(drains), drains)
            drains = []
        for name in drains:
            try:
                self._drain_instance(name)
            except Exception:  # noqa: BLE001 — keep the reconcile loop up
                logger.exception("drain of %s failed", name)
        if pending and not self._is_master:
            # Write-lease discipline (multi-master): PD-role flips mutate
            # coordination (instance-key move) and must stay funneled
            # through the ELECTED master, or concurrent frontends would
            # flip the same engine back and forth. Non-elected frontends
            # forward the hint to the master's /rpc/flip_hint; its
            # reconcile thread executes (and if mastership just moved,
            # the receiver re-proxies — convergent).
            self._proxy_flip_hints(pending)
            return
        for name, new_type in pending.items():
            try:
                self.flip_instance_role(name, new_type)
            except Exception:  # noqa: BLE001 — keep the reconcile loop up
                logger.exception("async role flip of %s failed", name)

    def _proxy_flip_hints(self, pending: dict[str, InstanceType]) -> None:
        """Best-effort replica→master flip-hint forward (runs on the
        reconcile thread, never a request path). A lost hint is re-raised
        by the next SLO/planner pass that still sees the imbalance."""
        master_addr = self._coord.get(MASTER_KEY)
        if not master_addr:
            return
        session = make_keepalive_session(1, 1)
        try:
            for name, new_type in pending.items():
                try:
                    session.post(f"http://{master_addr}/rpc/flip_hint",
                                 json={"name": name,
                                       "type": new_type.value},
                                 timeout=2)
                except ChannelError as e:
                    logger.warning("flip hint for %s -> %s lost (master "
                                   "%s unreachable: %s)", name,
                                   new_type.value, master_addr, e)
        finally:
            session.close()

    def flip_instance_role(self, name: str, new_type: InstanceType) -> bool:
        """Dynamic PD-role switch: tell the engine to swap programs, then
        update indices + coordination record (reference
        `flip_prefill_to_decode/flip_decode_to_prefill`,
        `instance_mgr.cpp:1023-1063`)."""
        if self._frozen():
            # Defense in depth (drain_pending_flips already gates): a
            # flip moves the instance's coordination record — held.
            self._health.hold(
                "flip", name,
                reason="plane degraded: role flip suspended",
                target=new_type.value)
            return False
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return False
            channel = entry.channel
            old_type = entry.meta.type
        if old_type == new_type:
            return True
        if channel is not None and not channel.flip_role(new_type.value):
            logger.warning("role flip %s -> %s rejected by engine %s",
                           old_type.value, new_type.value, name)
            return False
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return False
            entry.meta.type = new_type
            self._publish_snapshot()
            meta_json = entry.meta.to_json()
            meta = entry.meta
            chan = entry.channel
        # Link fan-out for the NEW role (outside locks): a flipped P->D
        # must be linked to every prefill (and vice versa) or their KV
        # handoffs get rejected by the linked-peer gate on the decode
        # side. Best effort — a failed pair falls back at handoff time.
        for peer in self._link_targets(meta):
            try:
                if peer.channel is not None:
                    peer.channel.link(meta)
                if chan is not None:
                    chan.link(peer.meta)
            except Exception:
                logger.exception("post-flip link of %s <-> %s failed",
                                 name, peer.meta.name)
        # Move the coordination record so replicas converge.
        self._coord.rm(instance_key(old_type.value, name))
        self._coord.set(instance_key(new_type.value, name), meta_json)
        logger.info("flipped instance %s: %s -> %s", name, old_type.value,
                    new_type.value)
        return True

    def _drain_instance(self, name: str) -> bool:
        """Begin a graceful drain (runs on the reconcile thread): notify
        the engine (best effort — it advertises `draining` on its next
        registration refresh and self-stops once idle), then mark the
        entry DRAINING and republish the snapshot so this frontend stops
        routing to it NOW. Completion is detected by reconcile_once /
        the lease-lapse handler; a mid-drain death falls back to the
        normal SUSPECT/failover path."""
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return False
            if entry.state == InstanceRuntimeState.DRAINING:
                return True
            channel = entry.channel
        # Engine RPC outside locks (same shape as flip_instance_role).
        drain_rpc = getattr(channel, "drain", None)
        if drain_rpc is not None:
            try:
                if not drain_rpc():
                    logger.warning("drain RPC to %s failed; draining "
                                   "master-side anyway", name)
            except Exception:  # noqa: BLE001 — drain must proceed locally
                logger.exception("drain RPC to %s raised", name)
        with self._cluster_lock:
            entry = self._instances.get(name)
            if entry is None:
                return False
            self._set_state(entry, InstanceRuntimeState.DRAINING)
        logger.info("instance %s draining (graceful retirement)", name)
        return True

    # ----------------------------------------------------- master sync loop
    def upload_load_metrics(self) -> None:
        """Master: push updated load metrics to coordination; replicas mirror
        (reference `instance_mgr.cpp:372-391`). Legacy-funnel mode only:
        under sharded ingest the per-owner load frames replace the
        per-instance LOADMETRICS keys entirely (each owner publishes its
        shard; there is no single uploader to funnel through)."""
        if self.sharded():
            with self._metrics_lock:
                # The dirty sets feed ONLY this uploader; keep them from
                # growing unboundedly while frames carry the data.
                self._updated_load_names.clear()
                self._removed_load_names.clear()
            return
        if not self._is_master:
            # Write-lease discipline (multi-master): LOADMETRICS records
            # are master-published; a demoted master's straggler tick
            # must not overwrite the new master's fresher uploads.
            return
        with self._metrics_lock:
            updated = {n: json.dumps({
                "load": self._load_metrics.get(n, LoadMetrics()).to_dict(),
                "latency": self._latency_metrics.get(n, LatencyMetrics()).to_dict(),
            }) for n in self._updated_load_names if n in self._load_metrics}
            removed = list(self._removed_load_names)
            self._updated_load_names.clear()
            self._removed_load_names.clear()
        if updated:
            self._coord.bulk_set({LOADMETRICS_KEY_PREFIX + n: v
                                  for n, v in updated.items()})
        if removed:
            self._coord.bulk_rm([LOADMETRICS_KEY_PREFIX + n for n in removed])

    def set_as_master(self) -> None:
        """Replica promotion: drop the mirror watch, start uploading
        (reference `instance_mgr.cpp:393-396`)."""
        if self._is_master:
            return
        self._is_master = True
        for wid in list(self._watch_ids[1:]):
            self._coord.remove_watch(wid)
        self._watch_ids = self._watch_ids[:1]

    def set_as_replica(self) -> None:
        """Demotion (a master that lost its coordination lease to a new
        winner): stop uploading, mirror load metrics again. Sharded
        ingest needs neither step: frame publication and mirroring are
        election-independent (every frontend already does both for its
        own shard)."""
        if not self._is_master:
            return
        self._is_master = False
        if self.sharded():
            return
        self._watch_ids.append(self._coord.add_watch(
            LOADMETRICS_KEY_PREFIX, self._on_loadmetrics_event))
        self._on_loadmetrics_event(
            [KeyEvent(WatchEventType.PUT, k, v) for k, v in
             self._coord.get_prefix(LOADMETRICS_KEY_PREFIX).items()], "")

    def stats(self) -> dict:
        """Telemetry-plane observability : the
        shard map as this master sees it, frame-log progress, and the
        per-instance load-info snapshot ages staleness-aware scoring
        discounts by — surfaced via /admin/hotpath and mirrored into
        /metrics by the scrape-time gauge refresh. Lock-free reads
        plus GIL-atomic counter loads."""
        sharded = self.sharded()
        snap = self._snapshot
        owned = sorted(n for n in snap.entries
                       if self.owns_telemetry(n)) if sharded else []
        return {
            "mode": "shard" if sharded else "master",
            "fleet": len(snap.entries),
            "owned_instances": owned,
            "owned": len(owned) if sharded else len(snap.entries),
            "frame_seq": self._shard_seq,
            "frames_published": self._frames_published,
            "frames_applied": self._frames_applied,
            "foreign_heartbeats": self._foreign_heartbeats,
            "load_info_ages_s": self.load_info_ages_s(),
            # Topology plane: armed bit, per-instance effective
            # coordinates, and the scheduled-pair link census (the topo
            # bench's same-slice share evidence).
            "topology": {
                "active": snap.topo_active,
                "tradeoff": self._opts.topology_tradeoff,
                "coords": {n: {"slice_id": c.slice_id, "host": c.host,
                               "chip": c.chip, "placed": c.placed}
                           for n, c in snap.coords.items()},
                "pair_links": self.pair_link_counts(),
            },
        }

    def pair_link_counts(self) -> dict[str, int]:
        """Copy of the scheduled-pair link census (link class -> count)."""
        with self._metrics_lock:
            return dict(self._pair_links)

    def stop(self) -> None:
        self._stopped.set()
        for wid in self._watch_ids:
            self._coord.remove_watch(wid)
        self._watch_ids.clear()
        if self._frame_watch_id is not None:
            self._coord.remove_watch(self._frame_watch_id)
            self._frame_watch_id = None
            # Retire this owner's frame key: peers converge on live
            # owners' frames only (a kill skips this, like any lease —
            # stale frames are inert: mirrors apply frames on PUT events
            # and age rebasing keeps bootstrap reads honest).
            self._coord.rm(LOADFRAME_KEY_PREFIX + self._ownership.self_addr)
        with self._cluster_lock:
            for entry in self._instances.values():
                if entry.channel is not None:
                    entry.channel.close()
