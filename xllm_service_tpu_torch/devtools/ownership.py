"""Shared-state ownership model: discipline registry + runtime verifier.

Lock discipline (``devtools/locks.py``) and RCU publication discipline
(``devtools/rcu.py``) only govern state somebody remembered to
register. The bug class that keeps recurring (unguarded O(fleet)
rebuilds, in-place mutation of shared containers, writes from the wrong
thread, context-provider lifetime leaks) lives in the *unregistered middle*: the mutable attributes on
Scheduler, InstanceMgr, GlobalKVCacheMgr, TieredKVStore, OwnershipRouter,
SloMonitor, … touched from the HTTP loop, the schedule executor, the sync
thread, the failover pool and agent heartbeats all at once. This module
closes it, in the spirit of Eraser-style lockset analysis and
ThreadSanitizer's happens-before checking, adapted to a
declared-discipline codebase:

**Registry** (:data:`STATE_DISCIPLINES`): ``"Class.attr"`` → a declared
discipline, seeded by an auto-inventory pass (``python -m
xllm_service_tpu_torch.devtools.ownership --inventory``) over the
concurrency-relevant classes and then hand-curated:

========================  ====================================================
discipline                contract
========================  ====================================================
``lock:<attr>``           every write (rebind, item store, in-place mutator)
                          happens while the declared lock attribute of the
                          same class is held; ``<attr>`` is cross-checked
                          against the lock registry (``# lock-order``
                          declarations)
``rcu``                   the attribute is an RCU publication — must also be
                          registered in ``rcu.py``'s ``RCU_PUBLICATIONS``
                          (bidirectional); writes are governed by the
                          ``rcu-publish`` rule and the declared writer lock
``confined:<role>``       rebound only from the declared thread role's entry
                          functions (:data:`THREAD_ROLES`); at runtime, only
                          from threads whose name matches the role (the main
                          thread is exempt — single-threaded test drivers
                          stand in for every role)
``owner:<guard>``         sharded-plane state owned by whichever PROCESS the
                          rendezvous map elects: every write must
                          be dominated by a successful ``self.<guard>(...)``
                          check (statically: lexically inside an
                          ``if self.<guard>(...)`` body; at runtime: the
                          writing thread's most recent ``<guard>`` call —
                          noted via :func:`note_owner_guard` — returned
                          True). A non-owner writing a sharded heartbeat
                          field is a build failure AND a recorded violation
``init-only``             assigned at construction (and lifecycle teardown),
                          never rebound afterwards; the value may be
                          internally synchronized elsewhere
``immutable``             like ``init-only``, and the value itself is never
                          mutated in place — reads need no synchronization
                          at all
========================  ====================================================

Three xlint rules enforce the registry statically (``state-decl``,
``state-write``, ``state-read`` — see devtools/xlint). Methods named in
:data:`LIFECYCLE_METHODS` are declaration scope, like ``__init__``:
teardown runs after the worker threads are joined.

**Runtime** (``XLLM_STATE_DEBUG=1``): classes decorated with
:func:`verify_state` get an instrumented ``__setattr__`` that records
(thread role, locks held — read from ``locks.py``'s per-thread
acquisition stacks) for every write to a registered attribute and
cross-checks the declared discipline; ``lock:`` container values are
wrapped in raise-nothing guarded views (mutators re-check the
discipline before delegating; confinement governs rebinds only) and
``immutable`` values are deep-frozen with the RCU freezer
(``rcu.freeze``). Violations are
recorded, never raised — production code paths behave identically —
and the pytest plugin ``xllm_service_tpu_torch.testing.debug_guard``
fails any test that recorded one, so the full chaos /
multimaster-kill / tier-drill suites double as an
attribute-race detector. Arming state debug arms the instrumented locks
too (the lock-held check needs their per-thread stacks).

**Escape hatch**: :func:`escape` — ``with ownership.escape(reason):`` —
is the unified hatch: xlint's three state rules skip writes lexically
inside it, and the runtime verifier skips writes made while a thread is
inside one. The reason string is mandatory, exactly like
``rcu.thaw(..., reason)`` and the ``# xlint: allow-*(reason)`` comments
(which the state rules also accept).
"""

from __future__ import annotations

import os
import threading
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

from . import locks as _locks

#: Declared per-attribute state disciplines. Key = "Class.attr" (class
#: matched by NAME, like RCU_FROZEN_TYPES: the owning modules import this
#: module, not the other way around). Value = discipline spec (table in
#: the module docstring). xlint's ``state-decl`` rule is bidirectional
#: over this registry: every post-__init__ attribute assignment in a
#: registered class must be declared here, and every entry must resolve
#: to a live class + assigned attribute (stale entries are violations).
STATE_DISCIPLINES: dict[str, str] = {
    # ----------------------------------------------------------- Scheduler
    # The in-flight request table: every exit path (normal finish, GC
    # timeout, disconnect, instance failure, failover) races the token
    # ingest on it.
    "Scheduler._requests": "lock:_req_lock",
    # Mastership flips run on the coordination watch thread (master-key
    # DELETE) and the sync thread (demotion check) — never a request path.
    "Scheduler.is_master": "confined:mastership",
    "Scheduler._master_watch_id": "confined:mastership",
    # Post-bind re-registration rebinds once, before traffic (the write
    # site carries an ownership.escape with that reason).
    "Scheduler.self_addr": "init-only",
    "Scheduler._opts": "init-only",
    "Scheduler._coord": "init-only",
    # Coordination-plane health monitor (degraded-mode serving): the
    # object is constructed once; all its mutable state lives behind its
    # own leaf lock (see CoordinationHealthMonitor below).
    "Scheduler.coordination_health": "init-only",
    # --------------------------------------------------------- InstanceMgr
    "InstanceMgr._snapshot": "rcu",
    "InstanceMgr._load_infos": "rcu",
    "InstanceMgr._request_load_view": "rcu",
    "InstanceMgr._instances": "lock:_cluster_lock",
    "InstanceMgr._pending_flips": "lock:_flip_lock",
    "InstanceMgr._pending_drains": "lock:_flip_lock",
    "InstanceMgr._load_metrics": "lock:_metrics_lock",
    "InstanceMgr._latency_metrics": "lock:_metrics_lock",
    "InstanceMgr._load_updated_ms": "lock:_metrics_lock",
    "InstanceMgr._request_loads": "lock:_metrics_lock",
    "InstanceMgr._pair_links": "lock:_metrics_lock",
    "InstanceMgr._updated_load_names": "lock:_metrics_lock",
    "InstanceMgr._removed_load_names": "lock:_metrics_lock",
    "InstanceMgr._is_master": "confined:mastership",
    "InstanceMgr._watch_ids": "confined:mastership",
    "InstanceMgr._opts": "init-only",
    "InstanceMgr._coord": "init-only",
    "InstanceMgr._health": "init-only",
    # Post-outage missed-DELETE sweep deadline: armed by the recovery
    # callback, consumed by the reconcile pass — both under the cluster
    # lock.
    "InstanceMgr._post_outage_sweep_until_ms": "lock:_cluster_lock",
    # Sharded telemetry-ingest plane. The frame inputs are
    # OWNER-GATED: only the master that owns an instance's telemetry
    # under the rendezvous shard map may coalesce its beats into the
    # published load frame or tombstone its eviction — a non-owner write
    # here would fork the fleet's converged view.
    "InstanceMgr._shard_dirty": "owner:owns_telemetry",
    "InstanceMgr._shard_gone": "owner:owns_telemetry",
    "InstanceMgr._owned_names": "lock:_cluster_lock",
    "InstanceMgr._published_owned": "lock:_metrics_lock",
    "InstanceMgr._shard_seq": "lock:_metrics_lock",
    "InstanceMgr._frames_published": "lock:_metrics_lock",
    "InstanceMgr._frames_applied": "lock:_metrics_lock",
    "InstanceMgr._foreign_heartbeats": "lock:_metrics_lock",
    "InstanceMgr._frame_watch_id": "init-only",
    "InstanceMgr._ownership": "init-only",
    "InstanceMgr._rr_prefill": "init-only",
    "InstanceMgr._rr_decode": "init-only",
    "InstanceMgr._rr_encode": "init-only",
    # ---------------------------------------------------- GlobalKVCacheMgr
    "GlobalKVCacheMgr._snapshot": "rcu",
    "GlobalKVCacheMgr._by_instance": "lock:_lock",
    "GlobalKVCacheMgr._dirty": "lock:_lock",
    "GlobalKVCacheMgr._removed": "lock:_lock",
    "GlobalKVCacheMgr._frame_seq": "lock:_lock",
    "GlobalKVCacheMgr._frames_since_full": "lock:_lock",
    "GlobalKVCacheMgr._bootstrap_buffer": "lock:_lock",
    "GlobalKVCacheMgr._is_master": "confined:mastership",
    "GlobalKVCacheMgr._watch_id": "confined:mastership",
    "GlobalKVCacheMgr._block_size": "immutable",
    "GlobalKVCacheMgr._weights": "immutable",
    "GlobalKVCacheMgr._compact_every": "immutable",
    # ------------------------------------------------------- TieredKVStore
    "TieredKVStore._dram": "lock:_lock",
    "TieredKVStore._ssd": "lock:_lock",
    "TieredKVStore._sums": "lock:_lock",
    "TieredKVStore._pending": "lock:_lock",
    "TieredKVStore._superseded": "lock:_lock",
    "TieredKVStore._free_dram": "lock:_lock",
    "TieredKVStore._free_ssd": "lock:_lock",
    "TieredKVStore._offloaded": "lock:_lock",
    "TieredKVStore._removed": "lock:_lock",
    "TieredKVStore.offload_total": "lock:_lock",
    "TieredKVStore.offload_dropped": "lock:_lock",
    "TieredKVStore.onload_total": "lock:_lock",
    "TieredKVStore.demote_total": "lock:_lock",
    "TieredKVStore.corrupt_total": "lock:_lock",
    "TieredKVStore.bytes_offloaded": "lock:_lock",
    "TieredKVStore.bytes_onloaded": "lock:_lock",
    "TieredKVStore.block_shape": "immutable",
    "TieredKVStore.block_nbytes": "immutable",
    "TieredKVStore.dram_capacity_blocks": "immutable",
    "TieredKVStore.ssd_capacity_blocks": "immutable",
    # ----------------------------------------------------- OwnershipRouter
    "OwnershipRouter._members": "rcu",
    "OwnershipRouter._addrs": "lock:_lock",
    # Rebound once by the post-bind re-registration (escaped write site,
    # same as Scheduler.self_addr); read lock-free on every owner_of.
    "OwnershipRouter.self_addr": "init-only",
    # Mining stat counters: GIL-atomic int adds on the accept path; the
    # write sites carry ownership.escape(reason) — losing a rare
    # increment is acceptable, taking a lock per accept is not.
    "OwnershipRouter.mined": "lock:_lock",
    "OwnershipRouter.mine_misses": "lock:_lock",
    # Telemetry-shard verdict memo: nominally lock-guarded
    # like the mining counters, but the beat-path write sites carry
    # ownership.escape(reason) — the memo is keyed by IDENTITY of the
    # RCU-published member tuple and every racer computes the same
    # deterministic owner, so a lost fill is a re-computation, not a
    # wrong answer; taking a lock per heartbeat is the cost the memo
    # exists to remove.
    "OwnershipRouter._own_cache": "lock:_lock",
    # ---------------------------------------------------------- SloMonitor
    "SloMonitor._objectives": "lock:_lock",
    "SloMonitor.ttft_target_ms": "lock:_lock",
    "SloMonitor.tpot_target_ms": "lock:_lock",
    "SloMonitor.alert": "lock:_lock",
    # ------------------------------------------------------ FlightRecorder
    # The context-provider table: registered at owner startup (HTTP
    # service / engine agent threads), iterated by record() on request
    # exit threads — the provider leak/race surface.
    "FlightRecorder._context": "lock:_lock",
    "FlightRecorder._ring": "lock:_lock",
    "FlightRecorder._file": "lock:_file_lock",
    "FlightRecorder._path": "lock:_file_lock",
    # ------------------------------------------------------------- Planner
    "Planner.last_decision": "confined:sync-thread",
    # ------------------------------------------------- AutoscalerController
    # The decision loop's private state: kernel state swapped by tick
    # (sync thread) and the spawn-backoff update (enactment), flip
    # proposals arriving from schedule-path threads, the retiring set,
    # and the bounded decision log — all behind one leaf lock.
    "AutoscalerController._state": "lock:_lock",
    "AutoscalerController._flip_proposals": "lock:_lock",
    "AutoscalerController._retiring": "lock:_lock",
    "AutoscalerController._log": "lock:_lock",
    "AutoscalerController._last_decision_ms": "lock:_lock",
    "AutoscalerController._ticks": "lock:_lock",
    # Topology plane (docs/topology.md): per-slice capacity census and
    # the recently-lost-slice map that targets replacement spawns.
    "AutoscalerController._slice_census": "lock:_lock",
    "AutoscalerController._lost_slices": "lock:_lock",
    "AutoscalerController._opts": "init-only",
    "AutoscalerController._mgr": "init-only",
    "AutoscalerController._actuator": "init-only",
    "AutoscalerController._planner": "init-only",
    "AutoscalerController._is_master_fn": "init-only",
    "AutoscalerController._degraded_fn": "init-only",
    "AutoscalerController._slo": "init-only",
    "AutoscalerController._cfg": "init-only",
    "AutoscalerController._enabled": "init-only",
    # ------------------------------------------------------ FleetActuators
    "HintActuator._seq": "lock:_lock",
    "HintActuator._last_publish": "lock:_lock",
    "HintActuator._coord": "init-only",
    "LocalProcessActuator._procs": "lock:_lock",
    "LocalProcessActuator._spawned_at": "lock:_lock",
    "LocalProcessActuator.launched_total": "lock:_lock",
    "LocalProcessActuator.spawn_failures_total": "lock:_lock",
    "LocalProcessActuator._opts": "init-only",
    "LocalProcessActuator._spawn_cmd": "init-only",
    "LocalProcessActuator._max_procs": "init-only",
    # ------------------------------------------------- AdmissionController
    # The overload-admission gate (overload/admission.py): pending
    # count + shed buckets written from every request-accept thread and
    # the scheduler's exit paths; config rebinds from configure().
    "AdmissionController._per_instance_limit": "lock:_lock",
    "AdmissionController._batch_watermark": "lock:_lock",
    "AdmissionController._retry_after_s": "lock:_lock",
    "AdmissionController._pending": "lock:_lock",
    "AdmissionController._admitted_total": "lock:_lock",
    "AdmissionController._shed_total": "lock:_lock",
    "AdmissionController._shed_window": "lock:_lock",
    # -------------------------------------------------- BrownoutController
    # Degradation state (overload/brownout.py): flipped by the sync
    # thread's tick, read lock-free by the request paths (active() is
    # one GIL-atomic bool load).
    "BrownoutController._enabled": "lock:_lock",
    "BrownoutController._batch_max_tokens": "lock:_lock",
    "BrownoutController._recover_ticks": "lock:_lock",
    "BrownoutController._trace_sample_rate": "lock:_lock",
    "BrownoutController._restore_rate_fn": "lock:_lock",
    "BrownoutController._active": "lock:_lock",
    "BrownoutController._since_s": "lock:_lock",
    "BrownoutController._recover_streak": "lock:_lock",
    "BrownoutController._entered_total": "lock:_lock",
    "BrownoutController._log": "lock:_lock",
    # ------------------------------------- CoordinationHealthMonitor
    # Degraded-mode plane classifier (coordination/health.py): state
    # machine stepped by the sync thread's tick, queried (degraded()) and
    # fed (hold()/note_frozen()) from the reconcile and watch-dispatch
    # threads — all behind one leaf lock (order 26). The held-action log
    # shares that lock. `_entity` follows the post-bind re-registration
    # (escaped write site, same as Scheduler.self_addr).
    "CoordinationHealthMonitor._state": "lock:_lock",
    "CoordinationHealthMonitor._consec_failures": "lock:_lock",
    "CoordinationHealthMonitor._outage_started_mono": "lock:_lock",
    "CoordinationHealthMonitor._outage_started_unix": "lock:_lock",
    "CoordinationHealthMonitor._recover_at_mono": "lock:_lock",
    "CoordinationHealthMonitor._last_tick_mono": "lock:_lock",
    "CoordinationHealthMonitor._outages_total": "lock:_lock",
    "CoordinationHealthMonitor._frozen_events": "lock:_lock",
    "CoordinationHealthMonitor._entity": "init-only",
    "CoordinationHealthMonitor._coord": "init-only",
    "CoordinationHealthMonitor._enabled": "init-only",
    "CoordinationHealthMonitor._after_ticks": "init-only",
    "CoordinationHealthMonitor._jitter_window_s": "init-only",
    "CoordinationHealthMonitor.held": "init-only",
    "CoordinationHealthMonitor.on_degraded": "init-only",
    "CoordinationHealthMonitor.on_recovered": "init-only",
    "HeldActionLog._items": "lock:_lock",
    "HeldActionLog._order": "lock:_lock",
    "HeldActionLog._dropped": "lock:_lock",
    "HeldActionLog._replaying": "lock:_lock",
    "HeldActionLog._capacity": "init-only",
    # --------------------------------------------------------- RetryBudget
    # Global retry token bucket (overload/retry_budget.py): deposits
    # from accept threads, withdrawals from failover/relay threads.
    "RetryBudget._ratio": "lock:_lock",
    "RetryBudget._cap": "lock:_lock",
    "RetryBudget._tokens": "lock:_lock",
    "RetryBudget._spent_total": "lock:_lock",
    "RetryBudget._denied_total": "lock:_lock",
    # ------------------------------------------------------ CircuitBreaker
    # Per-channel breaker (rpc/breaker.py): outcome recording from every
    # channel-calling thread; state transitions under the same leaf lock.
    "CircuitBreaker._events": "lock:_lock",
    "CircuitBreaker._state": "lock:_lock",
    "CircuitBreaker._opened_at": "lock:_lock",
    "CircuitBreaker._probe_inflight": "lock:_lock",
    "CircuitBreaker._open_total": "lock:_lock",
    # ------------------------------------------------------- EngineChannel
    # The negotiated dispatch-wire slot: set at registration, demoted
    # (one-way, to JSON) on an HTTP 415 — every write site carries an
    # ownership.escape documenting the GIL-atomic benign-race contract.
    "EngineChannel.wire_format": "init-only",
    # ----------------------------------------------------- InferenceEngine
    # Decode-loop telemetry counters: written only by the engine pump
    # (tests drive step() from the main thread, which is role-exempt).
    "InferenceEngine.total_generated": "confined:engine-pump",
    # Decaying latency maxima: pump writes race the heartbeat drain —
    # both go through the telemetry leaf lock (the bare read-then-reset
    # window race was this registry's first runtime catch).
    "InferenceEngine.recent_max_ttft_ms": "lock:_telemetry_lock",
    "InferenceEngine.recent_max_tbt_ms": "lock:_telemetry_lock",
    "InferenceEngine.preemption_count": "confined:engine-pump",
    "InferenceEngine.sarathi_rides": "confined:engine-pump",
    # ---------------------------------------------------------- EngineAgent
    # The port's agent (engine/agent.py) serves its HTTP routes from a
    # thread per connection; each of these is guarded by a leaf lock of
    # its own. Registration: the role and its epoch change together under
    # _reg_lock, and the coordination calls run outside it.
    "EngineAgent.instance_type": "lock:_reg_lock",
    "EngineAgent._reg_epoch": "lock:_reg_lock",
    "EngineAgent._streams": "lock:_streams_lock",
    "EngineAgent._handoffs_seen": "lock:_seen_lock",
    "EngineAgent.encode_count": "lock:_encode_lock",
    "EngineAgent.kv_device_sent": "lock:_kv_count_lock",
    "EngineAgent.kv_host_sent": "lock:_kv_count_lock",
    "EngineAgent.kv_stream_sent": "lock:_kv_count_lock",
    "EngineAgent.kv_device_received": "lock:_kv_count_lock",
    "EngineAgent.kv_host_received": "lock:_kv_count_lock",
    "EngineAgent.kv_stream_received": "lock:_kv_count_lock",
    "EngineAgent._stopped": "lock:_stop_lock",
    "EngineAgent._conns": "lock:_conns_lock",
    # ---------------------------------------------------- SamplingProfiler
    # Continuous profiler (profiling/sampler.py): refcounted lifecycle +
    # window aggregates behind one leaf lock (order 824); the sampler
    # thread merges each tick under it, /admin/profile reads under it.
    "SamplingProfiler._refs": "lock:_lock",
    "SamplingProfiler._thread": "lock:_lock",
    "SamplingProfiler._stop_evt": "lock:_lock",
    "SamplingProfiler._hz": "lock:_lock",
    "SamplingProfiler._window_s": "lock:_lock",
    "SamplingProfiler._max_stacks": "lock:_lock",
    "SamplingProfiler._max_depth": "lock:_lock",
    "SamplingProfiler._agg": "lock:_lock",
    "SamplingProfiler._ticks": "lock:_lock",
    "SamplingProfiler._window_started": "lock:_lock",
    "SamplingProfiler._prev": "lock:_lock",
    "SamplingProfiler._prev_ticks": "lock:_lock",
    "SamplingProfiler._prev_window_s": "lock:_lock",
    # Sampler-thread heartbeat: rebound only by the sampler loop itself.
    "SamplingProfiler._last_tick_mono": "confined:profiler",
    # Per-code-object label memo: only the sampler thread mutates it, and
    # GIL-atomic dict get/set makes concurrent snapshot reads benign.
    "SamplingProfiler._label_cache": "init-only",
    "SamplingProfiler._roles": "init-only",
}

#: Fully-audited classes: xlint's ``state-decl`` rule requires EVERY
#: attribute these classes assign outside __init__/lifecycle scope to
#: carry a discipline above (the completeness ratchet). Classes that
#: appear in STATE_DISCIPLINES but not here (InferenceEngine: only its
#: decode-loop telemetry counters are registered so far) get their
#: declared attributes enforced without the completeness requirement.
STATE_CLASSES: tuple = (
    "Scheduler",
    "InstanceMgr",
    "GlobalKVCacheMgr",
    "TieredKVStore",
    "OwnershipRouter",
    "SloMonitor",
    "FlightRecorder",
    "Planner",
    "AutoscalerController",
    "HintActuator",
    "LocalProcessActuator",
    "AdmissionController",
    "BrownoutController",
    "CoordinationHealthMonitor",
    "HeldActionLog",
    "RetryBudget",
    "CircuitBreaker",
    "SamplingProfiler",
)

#: Thread roles for ``confined:<role>`` disciplines. ``threads`` are
#: name prefixes matched against ``threading.current_thread().name`` at
#: runtime (the main thread is always exempt); ``entries`` are the
#: "Class.method" functions the static ``state-write`` rule accepts as
#: the role's write scope (a helper whose every resolvable call site
#: sits inside the scope inherits it — same transitive-summary idea as
#: the lock-order graph). Bidirectional: a role no confined declaration
#: references is a stale registry entry.
THREAD_ROLES: dict[str, dict] = {
    "mastership": {
        "threads": ("scheduler-sync", "coord-dispatch", "coord-reader"),
        "entries": (
            "Scheduler._on_master_event",
            "Scheduler.sync_once",
            # Post-outage recovery runs on the sync thread but is
            # reached via the health monitor's on_recovered callback, so
            # the static call-site resolution needs the explicit entry
            # (same for the takeover helper it shares with the watch).
            "Scheduler._recover_from_outage",
            "Scheduler._try_takeover",
            "InstanceMgr.set_as_master",
            "InstanceMgr.set_as_replica",
            "GlobalKVCacheMgr.set_as_master",
            "GlobalKVCacheMgr.set_as_replica",
        ),
    },
    "sync-thread": {
        "threads": ("scheduler-sync",),
        "entries": (
            "Scheduler._sync_loop",
            "Scheduler.sync_once",
            "Planner.plan_once",
            "Planner._finish",
        ),
    },
    "engine-pump": {
        # multihost primaries drive step() from the tick thread instead
        # of the single-process engine loop — both ARE the pump.
        "threads": ("engine-loop", "multihost-tick"),
        "entries": (
            "InferenceEngine._loop",
            "InferenceEngine.step",
            # The port's decode drain and token emission: only step()
            # reaches them on a serving engine; benchmarks/decode_profile
            # drives _drain_one_decode from its main thread, which stands
            # in for the pump (and the runtime check exempts).
            "InferenceEngine._decode",
            "InferenceEngine._emit_tokens",
        ),
    },
    "profiler": {
        # Continuous-profiling sampler (profiling/sampler.py): one
        # daemon thread per process, walking sys._current_frames().
        "threads": ("profiler-sampler",),
        "entries": (
            "SamplingProfiler._loop",
        ),
    },
}

#: Teardown methods that count as declaration scope (like ``__init__``):
#: they run after worker threads are joined/cancelled, so unguarded
#: rebinds there are lifecycle bookkeeping, not races.
LIFECYCLE_METHODS = ("stop", "close", "shutdown")

_DEBUG = os.environ.get("XLLM_STATE_DEBUG", "") not in ("", "0")


def debug_enabled() -> bool:
    return _DEBUG


# --------------------------------------------------------------- violations
@dataclass
class StateViolation:
    kind: str            # "state-lock" | "state-confined" | "state-reassign"
    message: str
    thread: str
    stack: list[str] = field(default_factory=list)

    def __str__(self) -> str:
        return f"[{self.kind}] {self.message} (thread {self.thread})"


# Detector bookkeeping; never held across project locks.
_sviol_lock = threading.Lock()   # lock-order: 904
_violations: list[StateViolation] = []


def violations() -> list[StateViolation]:
    with _sviol_lock:
        return list(_violations)


def reset_violations() -> None:
    with _sviol_lock:
        _violations.clear()


def _record(kind: str, message: str) -> None:
    v = StateViolation(kind=kind, message=message,
                       thread=threading.current_thread().name,
                       stack=traceback.format_stack(limit=16)[:-2])
    with _sviol_lock:
        _violations.append(v)
    # Imported lazily through locks' logger machinery would be circular;
    # keep it simple — the debug-guard plugin surfaces the message.


# ------------------------------------------------------------- escape hatch
_tls = threading.local()


class _Escape:
    """``with ownership.escape(reason):`` — the unified static + runtime
    hatch. Static: xlint's state rules skip writes lexically inside the
    with-block (and flag an empty reason). Runtime: writes made while
    the thread is inside one are exempt from discipline checks."""

    __slots__ = ()

    def __enter__(self):
        _tls.escape = getattr(_tls, "escape", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.escape = max(0, getattr(_tls, "escape", 1) - 1)


_ESCAPE = _Escape()


def escape(reason: str) -> _Escape:
    """Declare a write site exempt from its attribute's discipline.
    ``reason`` is mandatory (the runtime mirror of an
    ``# xlint: allow-state-*(reason)`` comment)."""
    if not reason or not isinstance(reason, str):
        raise ValueError("ownership.escape requires a non-empty reason "
                         "string")
    return _ESCAPE


def _escaped() -> bool:
    return getattr(_tls, "escape", 0) > 0


# ----------------------------------------------------- owner-gated guards
def note_owner_guard(guard: str, ok: bool) -> None:
    """Record the calling thread's most recent ``<guard>()`` verdict —
    the runtime half of the ``owner:<guard>`` discipline. Called by the
    guard method itself (e.g. ``InstanceMgr.owns_telemetry``) on every
    invocation; a subsequent write to an owner-gated attribute from this
    thread is checked against this verdict. One thread-local dict store
    — cheap enough to run outside debug mode, so arming the verifier
    mid-run needs no warm-up."""
    guards = getattr(_tls, "owner_guards", None)
    if guards is None:
        guards = _tls.owner_guards = {}
    guards[guard] = ok


def _owner_guard_ok(guard: str) -> bool:
    return getattr(_tls, "owner_guards", {}).get(guard, False)


# --------------------------------------------------------- discipline model
def _parse(spec: str) -> tuple[str, str]:
    """('lock', attr) | ('confined', role) | ('rcu'|'init-only'|
    'immutable', '')."""
    kind, _, arg = spec.partition(":")
    return kind, arg


def _rcu_writer_lock(cls_name: str, attr: str) -> Optional[str]:
    from . import rcu

    spec = rcu.RCU_PUBLICATIONS.get(f"{cls_name}.{attr}")
    if not spec:
        return None
    _, _, lock = spec.partition("@")
    return lock.strip() or None


def _thread_confined_ok(role: str) -> bool:
    t = threading.current_thread()
    if t is threading.main_thread():
        # Single-threaded test drivers stand in for every role; a main-
        # thread write cannot race a role thread it is standing in for.
        return True
    prefixes = THREAD_ROLES.get(role, {}).get("threads", ())
    return any(t.name.startswith(p) for p in prefixes)


def _lock_held(obj: Any, lock_attr: str) -> Optional[bool]:
    """True/False when verifiable; None when the lock attribute is not an
    instrumented lock (plain threading lock, or not created yet)."""
    lk = obj.__dict__.get(lock_attr)
    if isinstance(lk, _locks.InstrumentedLock):
        return _locks.thread_holds(lk)
    return None


#: Construction-scope method names: writes from these frames are exempt
#: from the confined/init-only/immutable rebind checks at runtime, the
#: exact scope the static state-write rule exempts.
_DECL_SCOPE = ("__init__", "setup", "__post_init__", *LIFECYCLE_METHODS)


def _check_write(obj: Any, cls_name: str, name: str, spec: str,
                 first: bool, meth: str = "") -> None:
    # First assignment = construction scope (init writes predate any
    # lock hold; __init__ itself is single-threaded by contract).
    kind, arg = _parse(spec)
    if kind == "lock":
        if not first and _lock_held(obj, arg) is False:
            _record("state-lock",
                    f"{cls_name}.{name} (lock:{arg}) written without "
                    f"holding {arg} (held: {_locks.held_locks()})")
    elif kind == "rcu":
        wlock = _rcu_writer_lock(cls_name, name)
        if not first and wlock is not None \
                and _lock_held(obj, wlock) is False:
            _record("state-lock",
                    f"{cls_name}.{name} (rcu) swapped without the "
                    f"declared writer lock {wlock} "
                    f"(held: {_locks.held_locks()})")
    elif kind == "confined":
        if not first and meth not in _DECL_SCOPE \
                and not _thread_confined_ok(arg):
            _record("state-confined",
                    f"{cls_name}.{name} (confined:{arg}) written from "
                    f"thread {threading.current_thread().name!r}, which "
                    f"is not in role {arg!r} "
                    f"({THREAD_ROLES.get(arg, {}).get('threads', ())})")
    elif kind == "owner":
        if not first and meth not in _DECL_SCOPE \
                and not _owner_guard_ok(arg):
            _record("state-owner",
                    f"{cls_name}.{name} (owner:{arg}) written without a "
                    f"passing {arg}() check on this thread — only the "
                    f"rendezvous owner may write sharded telemetry state")
    elif kind in ("init-only", "immutable"):
        if not first and meth not in _DECL_SCOPE:
            _record("state-reassign",
                    f"{cls_name}.{name} ({kind}) rebound after "
                    f"construction")


# ----------------------------------------------------------- guarded views
class _GuardedBase:
    """Mixin state for guarded container views (one per lock:/confined:
    container value under XLLM_STATE_DEBUG=1). Mutators re-check the
    attribute's discipline, record on violation, then delegate —
    behavior is otherwise identical to the plain container."""

    __slots__ = ()

    def _chk(self) -> None:
        if not _DEBUG:
            return   # view outlived set_debug(False): go inert
        owner = self._xllm_owner()
        if owner is None or _escaped():
            return
        _check_write(owner, self._xllm_cls, self._xllm_attr,
                     self._xllm_spec, first=False)


def _guard_method(mname: str):
    def guarded(self, *a, **k):
        self._chk()
        return getattr(self._xllm_base, mname)(self, *a, **k)

    guarded.__name__ = mname
    return guarded


_MUTATORS = {
    dict: ("__setitem__", "__delitem__", "pop", "popitem", "clear",
           "update", "setdefault", "__ior__"),
    list: ("__setitem__", "__delitem__", "append", "extend", "insert",
           "remove", "sort", "reverse", "clear", "pop", "__iadd__",
           "__imul__"),
    set: ("add", "discard", "remove", "pop", "clear", "update",
          "difference_update", "intersection_update",
          "symmetric_difference_update", "__ior__", "__iand__",
          "__isub__", "__ixor__"),
}

_guarded_types: dict[type, type] = {}


def _guarded_type(base: type) -> type:
    sub = _guarded_types.get(base)
    if sub is None:
        ns: dict[str, Any] = {
            "__slots__": ("_xllm_owner", "_xllm_cls", "_xllm_attr",
                          "_xllm_spec"),
            "_xllm_base": base,
            # rcu.freeze treats guarded views as their base container
            # (the deep-freeze must still bite on a drained/published
            # guarded list — the in-place delta bug class).
            "_xllm_guarded_kind": base.__name__,
        }
        for m in _MUTATORS[base]:
            ns[m] = _guard_method(m)
        sub = type(f"Guarded{base.__name__.capitalize()}",
                   (_GuardedBase, base), ns)
        _guarded_types[base] = sub
    return sub


def _guard_container(value: Any, obj: Any, cls_name: str, attr: str,
                     spec: str) -> Any:
    base = type(value)
    if base not in _MUTATORS:
        return value
    sub = _guarded_type(base)
    out = sub(value)
    out._xllm_owner = weakref.ref(obj)
    out._xllm_cls = cls_name
    out._xllm_attr = attr
    out._xllm_spec = spec
    return out


# ----------------------------------------------------------- class hookup
#: Classes decorated with @verify_state: registered-name -> [class, ...]
#: (instrumented/restored together by set_debug).
_DECORATED: dict[str, list[type]] = {}
_original_setattr: dict[type, Any] = {}

#: Per-class discipline index derived from STATE_DISCIPLINES.
_class_specs: dict[str, dict[str, str]] = {}
for _key, _spec in STATE_DISCIPLINES.items():
    _cls, _, _attr = _key.partition(".")
    _class_specs.setdefault(_cls, {})[_attr] = _spec


def _instrument(cls: type) -> None:
    if cls in _original_setattr:
        return
    cls_name = cls.__name__
    specs = _class_specs.get(cls_name, {})
    orig = cls.__setattr__
    _original_setattr[cls] = orig

    def checking_setattr(self, name, value, *, _specs=specs,
                         _cls=cls_name, _orig=orig):
        spec = _specs.get(name)
        if spec is None or _escaped():
            return _orig(self, name, value)
        import sys

        first = name not in self.__dict__
        # The writing frame's method name: the runtime mirror of the
        # static rule's construction/lifecycle scope exemption (a
        # reaper-thread stop() rebinding a confined watch id is
        # teardown bookkeeping, not a race). Debug-mode-only cost.
        _check_write(self, _cls, name, spec, first,
                     sys._getframe(1).f_code.co_name)
        kind, _ = _parse(spec)
        if kind in ("lock", "owner"):
            # Confined containers stay unwrapped: construction may run on
            # an arbitrary thread (e2e masters build on "master-loop") and
            # confinement only governs rebinds, not in-place bookkeeping.
            # Owner-gated containers ARE wrapped: every in-place mutation
            # re-checks the thread's last guard verdict.
            value = _guard_container(value, self, _cls, name, spec)
        elif kind == "immutable":
            from . import rcu

            value = rcu.freeze(value)
        return _orig(self, name, value)

    cls.__setattr__ = checking_setattr


def _restore(cls: type) -> None:
    orig = _original_setattr.pop(cls, None)
    if orig is not None:
        cls.__setattr__ = orig


def verify_state(cls: type) -> type:
    """Class decorator opting a class into the runtime verifier. Identity
    (zero overhead) unless ``XLLM_STATE_DEBUG=1`` / :func:`set_debug` —
    instrumentation is installed and removed dynamically on the class
    object, so instances created after arming are checked."""
    _DECORATED.setdefault(cls.__name__, []).append(cls)
    if _DEBUG:
        _instrument(cls)
    return cls


def set_debug(on: bool) -> None:
    """Test hook: toggles the verifier for ALL decorated classes.
    Arming also arms the instrumented locks (the lock-held check reads
    their per-thread acquisition stacks); locks created before arming
    stay plain and their disciplines go unverified (same contract as
    ``locks.set_debug``)."""
    global _DEBUG
    _DEBUG = on
    if on:
        _locks.set_debug(True)
        for classes in _DECORATED.values():
            for cls in classes:
                _instrument(cls)
    else:
        for classes in _DECORATED.values():
            for cls in classes:
                _restore(cls)


if _DEBUG:
    # XLLM_STATE_DEBUG=1 implies instrumented locks: the per-thread
    # acquisition stacks are what the lock-held cross-check reads.
    _locks.set_debug(True)


# ------------------------------------------------------------ inventory CLI
def _inventory(roots: list[str]) -> int:
    """The seeding pass: list self-attribute assignments outside
    __init__/lifecycle scope in the registered (or --all) classes, with
    their current registry status. This is how STATE_DISCIPLINES was
    seeded; re-run it after adding threads or attributes."""
    import ast
    from pathlib import Path

    decl = {"__init__", "setup", "__post_init__", *LIFECYCLE_METHODS}
    rows: list[tuple[str, str, str, str]] = []
    for root in roots:
        for p in sorted(Path(root).rglob("*.py")):
            if "xlint_fixtures" in p.parts:
                continue
            try:
                tree = ast.parse(p.read_text())
            except (OSError, SyntaxError):
                continue
            for node in tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                for fn in node.body:
                    if not isinstance(fn, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)) \
                            or fn.name in decl:
                        continue
                    for sub in ast.walk(fn):
                        tgts: list[ast.AST] = []
                        if isinstance(sub, ast.Assign):
                            tgts = sub.targets
                        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
                            tgts = [sub.target]
                        for t in tgts:
                            if isinstance(t, ast.Attribute) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self":
                                key = f"{node.name}.{t.attr}"
                                status = STATE_DISCIPLINES.get(
                                    key, "<unregistered>")
                                rows.append((key, status, fn.name,
                                             f"{p}:{sub.lineno}"))
    seen = set()
    for key, status, meth, where in rows:
        if (key, meth) in seen:
            continue
        seen.add((key, meth))
        print(f"{key:45s} {status:28s} {meth}() {where}")
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--inventory":
        roots = argv[1:] or [os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))]
        return _inventory(roots)
    print("usage: python -m xllm_service_tpu_torch.devtools.ownership "
          "--inventory [roots...]")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
