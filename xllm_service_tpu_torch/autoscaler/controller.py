"""Autoscaler controller: the master-gated decision loop (port of
``xllm_service_tpu/autoscaler/controller.py``; its lock is a plain
``threading.Lock``).

Structure (docs/autoscaling.md):

- :func:`decide` — the PURE decision kernel: ``(KernelInputs,
  KernelState, AutoscalerConfig) -> (actions, KernelState', reasons)``.
  No clocks, no locks, no I/O — every guard (hysteresis, per-action
  cooldowns, min/max clamps, stale-telemetry hold) is a branch over the
  immutable inputs, unit-testable as a table.
- :class:`AutoscalerController` — gathers live telemetry (SLO burn
  rates, planner pressure, routing-snapshot fleet counts, load-info
  ages — all lock-free reads), runs the kernel under its own leaf lock,
  and ENACTS outside the lock: SCALE_OUT through the actuator,
  SCALE_IN as a graceful drain (`InstanceMgr.request_drain` — routing
  excludes the victim immediately, in-flight requests finish, the
  engine self-stops), FLIP through `InstanceMgr.request_flip` (the
  reconcile thread executes). Every tick appends a decision record —
  inputs, actions, reasons, enactment results — to a bounded log served
  at ``GET /admin/autoscaler``.

Write-lease discipline (multi-master): only the ELECTED master's
controller acts. ``tick`` re-checks mastership at entry, so a demoted
master's straggler tick gathers nothing, enacts nothing and logs
nothing — the same self-gating contract as frame publishing and
LOADMETRICS uploads (docs/multi_master.md).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..common.config import ServiceOptions
from ..common.metrics import (
    AUTOSCALER_ACTIONS_TOTAL,
    AUTOSCALER_LAST_DECISION_AGE_SECONDS,
    FLEET_SIZE,
)
from ..common import topology as _topo
from ..common.slo import SLO_MONITOR
from ..common.tracing import TRACER
from ..common.types import InstanceType, now_ms
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..utils import get_logger, jittered_backoff

logger = get_logger(__name__)

#: Action kinds (stable API: metric label values + log records).
ACTION_SCALE_OUT = "scale_out"
ACTION_SCALE_IN = "scale_in"
ACTION_FLIP = "flip"
ACTION_DRAIN = "drain"
ACTION_HOLD = "hold"

@dataclass(frozen=True)
class AutoscalerConfig:
    """Kernel-visible knobs (an immutable projection of ServiceOptions —
    the kernel never sees the live options object)."""

    min_instances: int = 1
    max_instances: int = 8
    breach_ticks: int = 2
    idle_ticks: int = 5
    scale_out_step: float = 0.5
    scale_out_cooldown_s: float = 20.0
    scale_in_cooldown_s: float = 45.0
    flip_cooldown_s: float = 10.0
    stale_hold_s: float = 15.0
    # Pressure thresholds shared with the planner's scale-hint heuristic.
    scale_out_pressure: float = 1.5
    scale_in_pressure: float = 0.1
    kv_pressure: float = 0.92

    @classmethod
    def from_options(cls, opts: ServiceOptions) -> "AutoscalerConfig":
        min_i = max(1, opts.autoscaler_min_instances)
        return cls(
            min_instances=min_i,
            # A misconfigured min above max must not let the replacement
            # path launch past the max: max wins by absorbing min.
            max_instances=max(min_i, opts.autoscaler_max_instances),
            breach_ticks=max(1, opts.autoscaler_breach_ticks),
            idle_ticks=max(1, opts.autoscaler_idle_ticks),
            scale_out_step=max(0.0, opts.autoscaler_scale_out_step),
            scale_out_cooldown_s=max(0.0, opts.autoscaler_scale_out_cooldown_s),
            scale_in_cooldown_s=max(0.0, opts.autoscaler_scale_in_cooldown_s),
            flip_cooldown_s=max(0.0, opts.autoscaler_flip_cooldown_s),
            stale_hold_s=max(0.0, opts.autoscaler_stale_hold_s),
        )


@dataclass(frozen=True)
class KernelInputs:
    """One tick's immutable telemetry view.

    ``live`` counts schedulable, non-retiring instances (the controller
    subtracts victims it has already asked to drain — routing may not
    have excluded them yet); ``draining`` counts instances on their way
    out (master-requested retirements plus self-advertised drains).
    ``max_load_age_s`` is the stalest load-info entry (-1 = an instance
    never reported); ``scale_in_candidate`` is the pre-picked victim
    ("" = no instance can be retired without breaking role
    availability)."""

    now_s: float = 0.0
    breaching: tuple = ()          # objective names with BOTH windows hot
    worst_fast_burn: float = 0.0
    worst_slow_burn: float = 0.0
    pressure: float = 0.0
    kv_pressure: float = 0.0
    live: int = 0
    draining: int = 0
    # Suspect instances are in the failure-detection grace: they either
    # recover (LEASE_LOST blip) or are evicted within the detection
    # window — counting them toward capacity until eviction keeps a
    # network blip from triggering a hysteresis-free replacement whose
    # recovery would inflate the desired fleet.
    suspect: int = 0
    # Launches in flight (actuator-reported): spawned but not yet
    # registered. Counted toward capacity so a slow-to-register launch
    # is not re-launched every tick (the respawn-storm guard).
    pending_launches: int = 0
    # Admission-gate shed rate (sheds/s over the overload plane's
    # window): shedding is UNSERVED DEMAND — the burn monitor goes
    # quiet exactly when shedding works (admitted requests meet their
    # SLO), so without this input the controller would read a shedding
    # fleet as healthy and never add the capacity that would stop the
    # shedding. Any sustained shed rate is a breach signal.
    shed_rate: float = 0.0
    max_load_age_s: float = 0.0
    scale_in_candidate: str = ""
    flip_proposals: tuple = ()     # ((instance, target_type_str), ...)


@dataclass(frozen=True)
class KernelState:
    """Carried across ticks; replaced wholesale by each decision (pure
    kernel: the controller swaps the reference under its lock)."""

    desired: int = 0
    breach_streak: int = 0
    idle_streak: int = 0
    last_scale_out_s: float = 0.0
    last_scale_in_s: float = 0.0
    last_flip_s: float = 0.0
    # Actuator spawn-failure backoff: no SCALE_OUT before retry_at_s.
    retry_at_s: float = 0.0
    retry_count: int = 0


@dataclass(frozen=True)
class Action:
    kind: str
    count: int = 0
    instance: str = ""
    target_type: str = ""
    reason: str = ""

    def to_dict(self) -> dict[str, Any]:
        d = {"kind": self.kind, "reason": self.reason}
        if self.count:
            d["count"] = self.count
        if self.instance:
            d["instance"] = self.instance
        if self.target_type:
            d["target_type"] = self.target_type
        return d


def decide(inp: KernelInputs, st: KernelState,
           cfg: AutoscalerConfig) -> tuple[list[Action], KernelState,
                                           list[str]]:
    """The pure decision kernel. Precedence: stale-telemetry HOLD →
    replace lost capacity → breach-driven SCALE_OUT → idle SCALE_IN;
    FLIP proposals are enacted independently under their own cooldown.
    Never emits more than one scale action per tick (rate limiting by
    construction)."""
    reasons: list[str] = []
    actions: list[Action] = []
    total = inp.live + inp.draining + inp.suspect + inp.pending_launches
    desired = st.desired

    # Desired-fleet sync: externally-joined capacity raises the target
    # (an operator adding engines is a statement of intent) — but the
    # TARGET never crosses the configured bounds: an over-joined fleet
    # is tolerated while alive yet never re-grown by the replacement
    # path ("fleet bounds the controller never crosses").
    if inp.live > desired:
        desired = min(inp.live, cfg.max_instances)
        reasons.append(f"desired raised to observed fleet ({desired}"
                       + (f"; clamped to max_instances "
                          f"{cfg.max_instances}"
                          if inp.live > cfg.max_instances else "") + ")")
    if desired < cfg.min_instances:
        desired = cfg.min_instances
        reasons.append(f"desired clamped up to min_instances "
                       f"({cfg.min_instances})")
    desired = min(desired, cfg.max_instances)

    # Hold-state guard: acting on dead telemetry amplifies outages — a
    # fleet that stopped reporting gets NO scale/flip decisions, and the
    # streak counters freeze (stale ticks are not evidence of breach or
    # idleness).
    if inp.live > 0 and (inp.max_load_age_s < 0
                         or inp.max_load_age_s > cfg.stale_hold_s):
        why = ("an instance never reported load telemetry"
               if inp.max_load_age_s < 0 else
               f"stalest load telemetry {inp.max_load_age_s:.1f}s > "
               f"hold threshold {cfg.stale_hold_s:.1f}s")
        reasons.append(f"HOLD: {why}")
        actions.append(Action(ACTION_HOLD, reason=why))
        return actions, dataclasses.replace(st, desired=desired), reasons

    breach = bool(inp.breaching) or inp.pressure >= cfg.scale_out_pressure \
        or inp.kv_pressure >= cfg.kv_pressure or inp.shed_rate > 0.0
    idle = (not breach and inp.pressure <= cfg.scale_in_pressure
            and inp.worst_fast_burn < 1.0 and inp.worst_slow_burn < 1.0)
    breach_streak = st.breach_streak + 1 if breach else 0
    idle_streak = st.idle_streak + 1 if idle else 0
    if breach:
        what = ", ".join(inp.breaching) or (
            f"shedding {inp.shed_rate:.1f}/s" if inp.shed_rate > 0
            else "pressure")
        reasons.append(
            f"breaching: {what}"
            f" (fast burn {inp.worst_fast_burn:.1f}, "
            f"pressure {inp.pressure:.2f}, kv {inp.kv_pressure:.2f}, "
            f"shed {inp.shed_rate:.2f}/s; "
            f"streak {breach_streak}/{cfg.breach_ticks})")

    last_out, last_in = st.last_scale_out_s, st.last_scale_in_s
    last_flip = st.last_flip_s

    missing = desired - total
    if missing > 0:
        # Lost capacity (killed instance, failed spawn): replacement
        # bypasses breach hysteresis and the scale-out cooldown — it is
        # convergence to an already-made decision, not growth — but
        # honors the actuator spawn-retry backoff so a broken launcher
        # is retried, never hammered.
        if inp.now_s < st.retry_at_s:
            reasons.append(
                f"{missing} instance(s) missing; spawn retry backed off "
                f"for {st.retry_at_s - inp.now_s:.1f}s more "
                f"(attempt {st.retry_count})")
        else:
            actions.append(Action(
                ACTION_SCALE_OUT, count=missing,
                reason=f"replacing lost capacity: live {inp.live} + "
                       f"draining {inp.draining} + suspect {inp.suspect} "
                       f"+ pending {inp.pending_launches} "
                       f"< desired {desired}"))
            last_out = inp.now_s
    elif breach and breach_streak >= cfg.breach_ticks:
        if desired >= cfg.max_instances:
            reasons.append(f"at max_instances ({cfg.max_instances}); "
                           f"cannot scale out")
        elif inp.now_s - last_out < cfg.scale_out_cooldown_s:
            reasons.append(
                f"scale-out in cooldown "
                f"({cfg.scale_out_cooldown_s - (inp.now_s - last_out):.1f}s "
                f"left)")
        elif inp.now_s < st.retry_at_s:
            reasons.append(f"scale-out backed off after spawn failure "
                           f"(attempt {st.retry_count})")
        else:
            n = min(cfg.max_instances - desired,
                    max(1, math.ceil(desired * cfg.scale_out_step)))
            desired += n
            actions.append(Action(
                ACTION_SCALE_OUT, count=n,
                reason="SLO burn over alert" if inp.breaching
                else ("admission shedding load (unserved demand)"
                      if inp.shed_rate > 0
                      else "fleet pressure over threshold")))
            last_out = inp.now_s
            breach_streak = 0
    elif idle and idle_streak >= cfg.idle_ticks:
        if desired <= cfg.min_instances or inp.live <= cfg.min_instances:
            reasons.append(f"idle but at min_instances "
                           f"({cfg.min_instances})")
        elif inp.now_s - last_in < cfg.scale_in_cooldown_s:
            reasons.append(
                f"scale-in in cooldown "
                f"({cfg.scale_in_cooldown_s - (inp.now_s - last_in):.1f}s "
                f"left)")
        elif inp.draining > 0:
            reasons.append("a drain is already in progress; one "
                           "retirement at a time")
        elif not inp.scale_in_candidate:
            reasons.append("idle, but no instance can be retired without "
                           "breaking role availability")
        else:
            desired -= 1
            actions.append(Action(
                ACTION_SCALE_IN, count=1, instance=inp.scale_in_candidate,
                reason=f"fleet idle for {idle_streak} tick(s) "
                       f"(pressure {inp.pressure:.2f}, "
                       f"burn {inp.worst_fast_burn:.2f})"))
            last_in = inp.now_s
            idle_streak = 0

    # PD-ratio flips (proposed by the planner / SLO policy): one per
    # tick under the flip cooldown — the single actuation path for role
    # changes when the controller owns the fleet.
    if inp.flip_proposals:
        if inp.now_s - last_flip < cfg.flip_cooldown_s:
            reasons.append(
                f"{len(inp.flip_proposals)} flip proposal(s) deferred "
                f"(cooldown)")
        else:
            name, ttype = inp.flip_proposals[0]
            actions.append(Action(ACTION_FLIP, instance=name,
                                  target_type=ttype,
                                  reason="PD-ratio correction proposed by "
                                         "planner/SLO policy"))
            last_flip = inp.now_s
            if len(inp.flip_proposals) > 1:
                reasons.append(f"{len(inp.flip_proposals) - 1} further "
                               f"flip proposal(s) deferred to later ticks")

    nxt = KernelState(
        desired=desired, breach_streak=breach_streak,
        idle_streak=idle_streak, last_scale_out_s=last_out,
        last_scale_in_s=last_in, last_flip_s=last_flip,
        retry_at_s=st.retry_at_s, retry_count=st.retry_count)
    return actions, nxt, reasons


@_ownership.verify_state
class AutoscalerController:
    """The closed control loop. One instance per frontend; ticks ride the
    scheduler's sync cadence; only the elected master's ticks act."""

    #: A recorded capacity loss on a slice targets replacement spawns
    #: for at most this long — after that, placement falls back to
    #: "any slice" (the loss is presumed absorbed or permanent).
    LOST_SLICE_TTL_S = 120.0

    def __init__(self, options: ServiceOptions, instance_mgr,
                 actuator, planner=None,
                 is_master_fn: Optional[Callable[[], bool]] = None,
                 slo_monitor=None,
                 degraded_fn: Optional[Callable[[], bool]] = None):
        self._opts = options
        self._mgr = instance_mgr
        self._actuator = actuator
        self._planner = planner
        self._is_master_fn = is_master_fn or (lambda: True)
        # Coordination-plane health gate: while the plane is degraded the
        # controller suspends entirely (scale/drain/flip all mutate fleet
        # ownership — exactly the actions held during an outage).
        self._degraded_fn = degraded_fn or (lambda: False)
        self._slo = slo_monitor if slo_monitor is not None else SLO_MONITOR
        self._cfg = AutoscalerConfig.from_options(options)
        self._enabled = bool(options.autoscaler_enabled)
        # Controller-private state: kernel state, the decision log, flip
        # proposals awaiting a tick, and retiring victims (drain
        # requested; awaiting departure so the actuator can reap).
        self._lock = make_lock("autoscaler.controller", order=16)  # lock-order: 16
        self._state = KernelState()
        self._log: deque = deque(
            maxlen=max(8, options.autoscaler_decision_log_capacity))
        self._flip_proposals: dict[str, InstanceType] = {}
        self._retiring: dict[str, float] = {}     # name -> retire ts (s)
        # Topology plane (docs/topology.md): schedulable count per
        # effective slice (previous tick) and slices that recently LOST
        # capacity (slice_id -> loss ts). Replacement scale-outs target
        # the most recent loss so new capacity lands on the slice the
        # failure emptied. Both maps stay empty on flat fleets.
        self._slice_census: dict[str, int] = {}
        self._lost_slices: dict[str, float] = {}
        self._last_decision_ms = 0
        self._ticks = 0

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def actuator(self):
        return self._actuator

    # ------------------------------------------------------------ proposals
    def propose_flip(self, name: str, new_type: InstanceType) -> None:
        """Flip-proposal sink for the planner / SLO policy (the
        single-actuation-path satellite): proposals are deduped and
        enacted by the next tick under the flip cooldown. Callable from
        any thread; cheap (one dict store under a leaf lock)."""
        with self._lock:
            self._flip_proposals[name] = InstanceType.parse(new_type)

    # ----------------------------------------------------------- tick cycle
    def tick(self, plan=None) -> Optional[dict[str, Any]]:
        """One decision cycle (called from the scheduler's sync loop).
        Returns the decision record, or None when the controller is
        disabled or this frontend does not hold the write lease — a
        demoted master's straggler tick gathers nothing, enacts nothing,
        logs nothing."""
        if not self._enabled:
            return None
        if not self._is_master_fn():
            return None
        if self._degraded_fn():
            # Coordination outage: the fleet census is frozen and
            # last-known-good — scaling decisions off it would churn a
            # healthy fleet. The scheduler records the suppression in
            # the held-action log; enactment resumes with live state
            # after recovery.
            return None
        now_s = time.monotonic()
        inputs = self._gather(now_s, plan)
        with self._lock:
            actions, nxt, reasons = decide(inputs, self._state, self._cfg)
            self._state = nxt
            # Consume ONLY enacted proposals: cooldown-deferred ones stay
            # queued for a later tick (the log says "deferred", so they
            # must actually survive), and a proposal that raced in since
            # the gather is untouched.
            for a in actions:
                if a.kind == ACTION_FLIP:
                    self._flip_proposals.pop(a.instance, None)
            tick_no = self._ticks
        enacted = self._enact(actions, now_s)
        record = {
            "ts_ms": now_ms(),
            "tick": tick_no,
            "inputs": {
                "breaching": list(inputs.breaching),
                "worst_fast_burn": round(inputs.worst_fast_burn, 3),
                "worst_slow_burn": round(inputs.worst_slow_burn, 3),
                "pressure": round(inputs.pressure, 3),
                "kv_pressure": round(inputs.kv_pressure, 3),
                "live": inputs.live,
                "draining": inputs.draining,
                "suspect": inputs.suspect,
                "pending_launches": inputs.pending_launches,
                "shed_rate": round(inputs.shed_rate, 3),
                "desired": nxt.desired,
                "max_load_age_s": inputs.max_load_age_s,
            },
            "actions": [a.to_dict() for a in actions],
            "enacted": enacted,
            "reasons": reasons,
        }
        with self._lock:
            self._ticks += 1
            self._log.append(record)
            self._last_decision_ms = now_ms()
        AUTOSCALER_LAST_DECISION_AGE_SECONDS.set(0.0)
        return record

    def _gather(self, now_s: float, plan) -> KernelInputs:
        """Build the tick's immutable telemetry view — lock-free reads
        only (routing snapshot, published load infos, SLO report)."""
        snap = self._mgr.routing_snapshot()
        report = self._slo.report()
        objectives = report.get("objectives", {})
        worst_fast = max((o["fast"]["burn_rate"]
                          for o in objectives.values()), default=0.0)
        worst_slow = max((o["slow"]["burn_rate"]
                          for o in objectives.values()), default=0.0)

        with self._lock:
            retiring = dict(self._retiring)
            # Prune proposals whose target left the fleet (evicted /
            # drained while queued behind the flip cooldown).
            for n in [n for n in self._flip_proposals
                      if n not in snap.entries]:
                self._flip_proposals.pop(n, None)
            proposals = tuple((n, t.value)
                              for n, t in self._flip_proposals.items())

        # Fleet census off the snapshot: schedulable = routable now;
        # draining = on the way out (master-requested retirements whose
        # snapshot exclusion may lag one reconcile tick count as
        # draining, not live).
        live_names = [n for n in snap.schedulable if n not in retiring]
        drain_set = set(self._mgr.draining_names()) \
            | {n for n in retiring if n in snap.entries}
        draining = len(drain_set)
        from ..common.types import InstanceRuntimeState

        suspect = sum(1 for n, e in snap.entries.items()
                      if e.state == InstanceRuntimeState.SUSPECT
                      and n not in drain_set)
        try:
            pending = int(self._actuator.pending(set(snap.entries)))
        except Exception:  # noqa: BLE001 — census must not kill the tick
            logger.exception("actuator pending() failed")
            pending = 0
        FLEET_SIZE.labels(role="prefill").set(len(snap.prefill))
        FLEET_SIZE.labels(role="decode").set(len(snap.decode))
        FLEET_SIZE.labels(role="encode").set(len(snap.encode))
        FLEET_SIZE.labels(role="draining").set(draining)

        # Per-slice capacity census (docs/topology.md): a slice whose
        # schedulable count DROPS is recorded as having lost capacity;
        # replacement scale-outs target the most recent loss. Armed when
        # the fleet spans >= 2 effective slices counting SUSPECT/dying
        # entries (the schedulable-only topo_active bit flips false on
        # the very tick an entire slice dies — the exact transition this
        # census exists to record), or when the previous census did (the
        # entries may already be evicted). A flat fleet never arms, never
        # records a loss, and its spawn commands stay byte-identical to
        # the legacy path. Only operator-PLACED coordinates count —
        # synthetic per-host fallbacks would make any multi-host unplaced
        # fleet look multi-slice and stamp synthetic slice ids into spawn
        # commands. Intentional shrink (scale-in) also lowers `desired`,
        # so the loss mark is only ever consulted when a genuine
        # replacement fires.
        coords = {n: c for n, c in getattr(snap, "coords", {}).items()
                  if getattr(c, "placed", False)}
        armed = _topo.fleet_topo_active(list(coords.values()))
        census: dict[str, int] = {}
        for n in live_names:
            c = coords.get(n)
            if c is not None:
                census[c.slice_id] = census.get(c.slice_id, 0) + 1
        with self._lock:
            if armed or len(self._slice_census) >= 2:
                for s, prev in self._slice_census.items():
                    if census.get(s, 0) < prev:
                        self._lost_slices[s] = now_s
                self._slice_census = census
            else:
                self._slice_census = {}
            for s, ts in list(self._lost_slices.items()):
                if now_s - ts > self.LOST_SLICE_TTL_S:
                    self._lost_slices.pop(s, None)

        ages = self._mgr.load_info_ages_s()
        max_age = -1.0 if any(a < 0 for a in ages.values()) \
            else max(ages.values(), default=0.0)

        pressure = kv = 0.0
        if plan is not None:
            # Planner pressures (computed this same sync pass). The
            # planner's prefill/decode pressures feed flips; the scalar
            # fleet pressure feeds scale decisions.
            kv = plan.kv_pressure
            pressure = self._plan_pressure(plan)

        # Overload-plane coupling: the admission gate's shed rate is
        # unserved demand the burn monitor can no longer see (shed
        # requests never produce TTFT samples) — it must drive
        # scale-out, and it decays to ~0 as the capacity arrives.
        from ..overload import ADMISSION

        return KernelInputs(
            now_s=now_s,
            breaching=tuple(report.get("breaching", ())),
            worst_fast_burn=worst_fast,
            worst_slow_burn=worst_slow,
            pressure=pressure,
            kv_pressure=kv,
            live=len(live_names),
            draining=draining,
            suspect=suspect,
            pending_launches=pending,
            shed_rate=ADMISSION.shed_rate(),
            max_load_age_s=max_age,
            scale_in_candidate=self._pick_scale_in_victim(
                snap, live_names),
            flip_proposals=proposals,
        )

    @staticmethod
    def _plan_pressure(plan) -> float:
        """Scalar fleet pressure from the planner decision: the planner
        publishes a scale hint; the controller re-derives the pressure
        ratio it was based on (waiting / capacity) from the decision's
        components so the kernel thresholds stay in one unit."""
        return max(plan.prefill_pressure, plan.decode_pressure) \
            if (plan.prefill_pressure or plan.decode_pressure) \
            else (1.5 if plan.scale_hint > 0 and plan.reasons else 0.0)

    def _pick_scale_in_victim(self, snap, live_names: list[str]) -> str:
        """Least-loaded instance whose retirement keeps the fleet
        routable (never the last prefill-capable or decode-capable
        instance). Load = this frontend's in-flight accounting plus the
        engine-reported queue depth."""
        if len(live_names) <= 1:
            return ""
        loads = self._mgr.get_request_loads()
        infos = self._mgr.get_load_infos()

        def load_of(name: str) -> tuple:
            rl = loads.get(name, (0, 0, 0, 0))
            info = infos.get(name)
            waiting = info.load.waiting_requests_num if info else 0
            running = info.load.running_requests_num if info else 0
            return (rl[0] + rl[2] + waiting + running, rl[1] + rl[3], name)

        for _, _, name in sorted(load_of(n) for n in live_names):
            rest = [snap.entries[n].meta.type for n in live_names
                    if n != name and n in snap.entries]
            has_default = any(t in (InstanceType.DEFAULT, InstanceType.MIX)
                              for t in rest)
            has_p = any(t == InstanceType.PREFILL for t in rest)
            has_d = any(t == InstanceType.DECODE for t in rest)
            if has_default or (has_p and has_d):
                return name
        return ""

    # ------------------------------------------------------------ enactment
    def _enact(self, actions: list[Action],
               now_s: float) -> list[dict[str, Any]]:
        """Apply the kernel's actions through the actuator / instance
        manager. Runs OUTSIDE the controller lock (spawning processes and
        enqueueing drains must not serialize against propose_flip on the
        schedule path). Failures are recorded and retried with backoff —
        never raised, the loop must not wedge."""
        results: list[dict[str, Any]] = []
        if not actions:
            return results
        with TRACER.span("autoscaler.tick",
                         actions=",".join(a.kind for a in actions)):
            for a in actions:
                AUTOSCALER_ACTIONS_TOTAL.labels(action=a.kind).inc()
                try:
                    results.append(self._enact_one(a, now_s))
                except Exception as e:  # noqa: BLE001 — loop must survive
                    logger.exception("autoscaler action %s failed", a.kind)
                    results.append({"kind": a.kind, "ok": False,
                                    "error": str(e)})
        return results

    def _enact_one(self, a: Action, now_s: float) -> dict[str, Any]:
        if a.kind == ACTION_HOLD:
            return {"kind": a.kind, "ok": True}
        if a.kind == ACTION_SCALE_OUT:
            # Target the slice that most recently lost capacity ("" on
            # flat fleets / no recorded loss): the actuator lands the
            # replacement where the failure happened, so the restored
            # fleet re-converges to same-slice PD pairs instead of
            # permanently paying DCN for a capacity hole.
            with self._lock:
                target_slice = max(self._lost_slices,
                                   key=self._lost_slices.get, default="") \
                    if self._lost_slices else ""
            launched = self._actuator.scale_out(a.count, a.reason,
                                                slice_id=target_slice)
            if target_slice and launched >= a.count:
                with self._lock:
                    self._lost_slices.pop(target_slice, None)
            if launched < a.count:
                with self._lock:
                    st = self._state
                    delay = jittered_backoff(
                        self._opts.autoscaler_spawn_retry_base_s,
                        self._opts.autoscaler_spawn_retry_max_s,
                        st.retry_count)
                    self._state = dataclasses.replace(
                        st, retry_at_s=now_s + delay,
                        retry_count=st.retry_count + 1)
                logger.warning(
                    "autoscaler: actuator launched %d/%d instance(s); "
                    "retrying in %.1fs", launched, a.count, delay)
            else:
                with self._lock:
                    self._state = dataclasses.replace(
                        self._state, retry_at_s=0.0, retry_count=0)
            out = {"kind": a.kind, "ok": launched >= a.count,
                   "requested": a.count, "launched": launched}
            if target_slice:
                out["target_slice"] = target_slice
            return out
        if a.kind == ACTION_SCALE_IN:
            self._mgr.request_drain(a.instance)
            AUTOSCALER_ACTIONS_TOTAL.labels(action=ACTION_DRAIN).inc()
            with self._lock:
                self._retiring[a.instance] = now_s
            self._actuator.scale_in(a.instance, a.reason)
            return {"kind": a.kind, "ok": True, "instance": a.instance,
                    "via": ACTION_DRAIN}
        if a.kind == ACTION_FLIP:
            self._mgr.request_flip(a.instance,
                                   InstanceType.parse(a.target_type))
            return {"kind": a.kind, "ok": True, "instance": a.instance,
                    "target_type": a.target_type}
        return {"kind": a.kind, "ok": False, "error": "unknown action"}

    def reap_departed(self) -> None:
        """Housekeeping (each sync pass, master or not): victims that
        finished draining and left the fleet are handed to the actuator
        for final teardown (the local actuator SIGTERMs the process it
        launched; the hint actuator publishes the completion)."""
        snap = self._mgr.routing_snapshot()
        with self._lock:
            departed = [n for n in self._retiring if n not in snap.entries]
            for n in departed:
                self._retiring.pop(n, None)
        for n in departed:
            try:
                self._actuator.reap(n)
            except Exception:  # noqa: BLE001 — housekeeping must not wedge
                logger.exception("actuator reap of %s failed", n)

    # ----------------------------------------------------------- inspection
    def last_decision_age_s(self) -> float:
        """Seconds since the last completed tick (-1 = never/disabled);
        refreshed into the gauge at scrape time by the /metrics
        handler."""
        with self._lock:
            last = self._last_decision_ms
        if not last:
            return -1.0
        return round((now_ms() - last) / 1000.0, 3)

    def report(self) -> dict[str, Any]:
        """The /admin/autoscaler payload: config, kernel state, the
        retiring set, and the decision log (newest first) — every action
        with the reasons it was (or was not) taken, like
        PlanDecision.reasons but acted on."""
        with self._lock:
            st = self._state
            log = list(self._log)
            retiring = dict(self._retiring)
            ticks = self._ticks
            lost_slices = sorted(self._lost_slices)
            slice_census = dict(self._slice_census)
        return {
            "enabled": self._enabled,
            "master": bool(self._is_master_fn()),
            "actuator": getattr(self._actuator, "name", "none"),
            "ticks": ticks,
            "last_decision_age_s": self.last_decision_age_s(),
            "state": dataclasses.asdict(st),
            "retiring": sorted(retiring),
            "slice_census": slice_census,
            "lost_slices": lost_slices,
            "config": dataclasses.asdict(self._cfg),
            "decisions": list(reversed(log)),
        }

    def stop(self) -> None:
        if self._actuator is not None:
            self._actuator.stop()
