"""Coordination-plane health monitor: degraded-mode (static-stability)
serving through a total coordination outage.

The reference hangs all fleet liveness off etcd leases, so an etcd
outage lapses every instance lease and demotes the elected master — the
data plane collapses even though every engine is healthy. This monitor
is the decoupling: it classifies the plane CONNECTED -> DEGRADED ->
RECOVERING from **client-side evidence only** (consecutive failed
liveness pings across scheduler sync ticks — never lease loss, which
would conflate an outage with a lost election), and while the plane is
down the fleet keeps doing what it was doing:

- **census freeze** — lease-lapse verdicts and missed-lease sweeps stop
  producing SUSPECT/evict (`InstanceMgr` consults :meth:`degraded`);
  instance liveness falls back to direct heartbeat silence over the
  multiplexed telemetry sessions (`degraded_heartbeat_silence_s`): a
  silent-AND-lease-lapsed instance still dies, a chatty one never does;
- **sticky mastership under a fencing rule** — the elected master keeps
  serving and routing from last-known-good RCU snapshots but suspends
  ownership-*changing* actions (evictions, drains, flips, autoscaler
  enactment, LOADFRAME/KV-frame publishing) into the bounded
  :class:`HeldActionLog`. The stickiness applies ONLY while the plane is
  unreachable: a master that *observes* someone else holding the write
  lease still demotes immediately, and held actions are discarded — they
  never execute after demotion;
- **storm-free recovery** — on reconnect the monitor holds RECOVERING
  for a deterministic per-entity jitter (:func:`entity_jitter`, so a
  fleet's re-assertions spread over `coordination_reconnect_jitter_s`
  instead of thundering the just-recovered plane), then fires
  ``on_recovered``: the scheduler re-asserts its registration,
  reconciles incarnations against what coordination now says, resyncs
  the frame log, and replays-or-discards each held action with the
  reason flight-recorded.

Thread contract: :meth:`tick` runs on the scheduler-sync thread only;
:meth:`degraded`/:meth:`hold`/:meth:`note_frozen` are called from the
reconcile and watch-dispatch threads — all state lives behind one leaf
lock (order 26), and transition callbacks fire OUTSIDE it (they call
back into subsystems with lower-ordered locks).
"""

from __future__ import annotations

import threading

import time
from dataclasses import dataclass, field
from hashlib import blake2b
from typing import Any, Callable, Optional

from ..common.flightrecorder import RECORDER
from ..common.metrics import (COORDINATION_CONNECTED,
                              COORDINATION_DEGRADED_SECONDS_TOTAL,
                              COORDINATION_FROZEN_EVENTS_TOTAL,
                              COORDINATION_HELD_ACTIONS)
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..utils import get_logger

logger = get_logger(__name__)

#: Plane states. DEGRADED and RECOVERING both keep the census frozen and
#: the holds engaged — RECOVERING only adds "the plane answers again,
#: wait out the per-entity jitter before re-asserting".
CONNECTED = "CONNECTED"
DEGRADED = "DEGRADED"
RECOVERING = "RECOVERING"


def entity_jitter(entity: str, window_s: float) -> float:
    """Deterministic per-entity delay in ``[0, window_s)``: every entity
    (master addr, agent instance name) computes its own slot from a hash
    of its identity, so post-outage re-assertions spread over the window
    without any coordination — which is the point: there is none."""
    if window_s <= 0.0:
        return 0.0
    h = int.from_bytes(blake2b(entity.encode(), digest_size=4).digest(),
                       "big")
    return (h / float(0xFFFFFFFF)) * window_s


@dataclass
class HeldAction:
    """One suspended ownership-changing action. Coalesced by
    ``(kind, key)`` — a 30 s outage must not grow the log by one entry
    per sync tick for the same suppressed publish."""

    kind: str
    key: str
    reason: str
    detail: dict[str, Any] = field(default_factory=dict)
    first_held_ms: int = 0
    count: int = 1

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "key": self.key, "reason": self.reason,
                "detail": dict(self.detail), "count": self.count,
                "first_held_ms": self.first_held_ms}


@_ownership.verify_state
class HeldActionLog:
    """Bounded, coalescing log of suspended actions, behind its own
    leaf lock (fed from the sync, reconcile, and watch-dispatch
    threads; drained by recovery on the sync thread)."""

    def __init__(self, capacity: int) -> None:
        self._lock = make_lock("coordination.heldlog", order=27)  # lock-order: 27
        self._capacity = max(1, int(capacity))
        self._items: dict[tuple[str, str], HeldAction] = {}
        self._order: list[tuple[str, str]] = []
        self._dropped = 0
        # (kind, key) of the actions drained for a replay that has not
        # finished: the census unfreezes before the recovery callback
        # runs, and the normal path must not act on them meanwhile.
        self._replaying: set[tuple[str, str]] = set()

    def hold(self, kind: str, key: str, reason: str = "",
             **detail: Any) -> HeldAction:
        with self._lock:
            slot = (kind, key)
            cur = self._items.get(slot)
            if cur is not None:
                cur.count += 1
                if detail:
                    cur.detail.update(detail)
                return cur
            action = HeldAction(kind=kind, key=key, reason=reason,
                                detail=dict(detail),
                                first_held_ms=int(time.time() * 1000))
            self._items[slot] = action
            self._order.append(slot)
            while len(self._order) > self._capacity:
                oldest = self._order.pop(0)
                self._items.pop(oldest, None)
                self._dropped += 1
            COORDINATION_HELD_ACTIONS.set(len(self._order))
            return action

    def drain(self, for_replay: bool = False) -> list[HeldAction]:
        """Empty the log; ``for_replay`` keeps the drained actions
        :meth:`pending` until :meth:`replay_done`."""
        with self._lock:
            out = [self._items[slot] for slot in self._order]
            if for_replay:
                self._replaying = set(self._order)
            self._items = {}
            self._order = []
            COORDINATION_HELD_ACTIONS.set(0)
            return out

    def replay_done(self) -> None:
        with self._lock:
            self._replaying = set()

    def pending(self, kind: str, key: str) -> bool:
        """Is this action held, or drained for a replay not yet done?"""
        with self._lock:
            return (kind, key) in self._items or \
                (kind, key) in self._replaying

    def depth(self) -> int:
        with self._lock:
            return len(self._order)

    def report(self) -> dict[str, Any]:
        with self._lock:
            return {"depth": len(self._order), "dropped": self._dropped,
                    "actions": [self._items[s].to_dict()
                                for s in self._order]}


@_ownership.verify_state
class CoordinationHealthMonitor:
    """CONNECTED -> DEGRADED -> RECOVERING classifier + held-action log.

    One instance per frontend, owned by the scheduler; ``entity`` is the
    frontend's rpc address (the per-entity jitter identity)."""

    def __init__(self, coord, options, entity: str = "",
                 on_degraded: Optional[Callable[[], None]] = None,
                 on_recovered: Optional[Callable[[], None]] = None) -> None:
        self._coord = coord
        self._entity = entity
        self._enabled = getattr(options, "coordination_degraded_mode",
                                "on") != "off"
        self._after_ticks = max(1, int(getattr(
            options, "coordination_degraded_after_ticks", 2)))
        self._jitter_window_s = float(getattr(
            options, "coordination_reconnect_jitter_s", 5.0))
        self._lock = make_lock("coordination.health", order=26)  # lock-order: 26
        self.held = HeldActionLog(
            int(getattr(options, "coordination_held_log_capacity", 256)))
        self._state = CONNECTED
        self._consec_failures = 0
        self._outage_started_mono = 0.0
        self._outage_started_unix = 0.0
        self._recover_at_mono = 0.0
        self._last_tick_mono = 0.0
        self._outages_total = 0
        self._frozen_events: dict[str, int] = {}
        # Transition hooks (construction-time; fired on the sync thread,
        # outside _lock — they call back into subsystems whose locks
        # order below this one).
        self.on_degraded = on_degraded
        self.on_recovered = on_recovered
        COORDINATION_CONNECTED.set(1)

    # ------------------------------------------------------------- queries
    def state(self) -> str:
        with self._lock:
            return self._state

    def degraded(self) -> bool:
        """True while the census freeze and action holds apply
        (DEGRADED *or* RECOVERING — holds release only once recovery
        has actually re-asserted)."""
        with self._lock:
            return self._state != CONNECTED

    def update_entity(self, entity: str) -> None:
        """Follow the scheduler's post-bind re-registration."""
        with self._lock:
            with _ownership.escape("post-bind re-registration: rebinds "
                                   "the init-only entity id once, before "
                                   "traffic"):
                self._entity = entity

    # ---------------------------------------------------------- transitions
    def tick(self) -> str:
        """One probe + state-machine step, on the scheduler-sync cadence.
        Returns the (possibly new) state; fires transition callbacks
        outside the lock."""
        ok = self._probe()
        now = time.monotonic()
        fire_degraded = fire_recovered = False
        outage_s = 0.0
        frozen_snapshot: dict[str, int] = {}
        with self._lock:
            prev = self._state
            if self._state != CONNECTED and self._last_tick_mono:
                COORDINATION_DEGRADED_SECONDS_TOTAL.inc(
                    max(0.0, now - self._last_tick_mono))
            self._last_tick_mono = now
            if ok:
                self._consec_failures = 0
                if self._state == DEGRADED:
                    # The plane answers again: hold RECOVERING for this
                    # entity's deterministic jitter slot so the fleet's
                    # re-assertions spread over the window.
                    self._state = RECOVERING
                    self._recover_at_mono = now + entity_jitter(
                        self._entity, self._jitter_window_s)
                elif self._state == RECOVERING \
                        and now >= self._recover_at_mono:
                    self._state = CONNECTED
                    fire_recovered = True
                    outage_s = now - self._outage_started_mono
                    frozen_snapshot = dict(self._frozen_events)
            else:
                self._consec_failures += 1
                if self._state == CONNECTED and self._enabled \
                        and self._consec_failures >= self._after_ticks:
                    self._state = DEGRADED
                    self._outage_started_mono = now
                    self._outage_started_unix = time.time()
                    self._outages_total += 1
                    fire_degraded = True
                elif self._state == RECOVERING:
                    # Reconnect didn't stick — back to DEGRADED, same
                    # outage (keep the original start for accounting).
                    self._state = DEGRADED
            state = self._state
        COORDINATION_CONNECTED.set(1 if ok else 0)
        if fire_degraded:
            logger.warning(
                "coordination plane DEGRADED after %d failed probes: "
                "census frozen, mastership sticky, ownership-changing "
                "actions held", self._after_ticks)
            RECORDER.record("coordination_degraded",
                            detail={"entity": self._entity,
                                    "failed_probes": self._after_ticks})
            if self.on_degraded is not None:
                self.on_degraded()
        if fire_recovered:
            logger.info(
                "coordination plane RECOVERED after %.1fs: replaying or "
                "discarding %d held actions", outage_s, self.held.depth())
            RECORDER.record("coordination_recovered",
                            detail={"entity": self._entity,
                                    "outage_seconds": round(outage_s, 3),
                                    "held_depth": self.held.depth(),
                                    "frozen_events": frozen_snapshot})
            if self.on_recovered is not None:
                self.on_recovered()
        if prev != state and not (fire_degraded or fire_recovered):
            logger.info("coordination plane %s -> %s", prev, state)
        return state

    def _probe(self) -> bool:
        # A client mid-reconnect short-circuits (connected=False) before
        # the ping round-trip; backends without connectivity loss report
        # connected implicitly.
        if not getattr(self._coord, "connected", True):
            return False
        try:
            return bool(self._coord.ping())
        except Exception:  # noqa: BLE001  # xlint: allow-broad-except(a probe that THROWS is exactly the evidence this monitor exists to classify)
            return False

    # ------------------------------------------------------ freeze / holds
    def hold(self, kind: str, key: str, reason: str = "",
             **detail: Any) -> None:
        """Suspend one ownership-changing action into the bounded log."""
        self.held.hold(kind, key, reason, **detail)

    def note_frozen(self, kind: str, key: str = "") -> None:
        """Count a census event ignored under the freeze (observability:
        the recovery bundle and /admin/coordination surface these)."""
        COORDINATION_FROZEN_EVENTS_TOTAL.labels(kind=kind).inc()
        with self._lock:
            self._frozen_events[kind] = self._frozen_events.get(kind, 0) + 1

    def drain_held(self) -> list[HeldAction]:
        """The held actions, for the recovery replay; each stays
        :meth:`evict_pending` until :meth:`replay_done`."""
        return self.held.drain(for_replay=True)

    def replay_done(self) -> None:
        self.held.replay_done()

    def evict_pending(self, name: str) -> bool:
        """Is the instance's eviction held or being replayed? Its verdict
        then belongs to the replay (which evicts only a still suspect and
        silent instance), not to the normal path."""
        return self.held.pending("evict", name)

    def discard_held(self, reason: str) -> int:
        """Drop every held action WITHOUT replaying (demotion fencing:
        a master that lost the lease must never enact what it queued
        while it thought it was still the owner). Reasons are
        flight-recorded per action."""
        dropped = self.held.drain()
        for action in dropped:
            RECORDER.record("held_action_discarded",
                            detail={"kind": action.kind, "key": action.key,
                                    "held_reason": action.reason,
                                    "discard_reason": reason,
                                    "count": action.count})
        if dropped:
            logger.warning("discarded %d held actions: %s",
                           len(dropped), reason)
        return len(dropped)

    # ------------------------------------------------------------ reporting
    def report(self) -> dict[str, Any]:
        with self._lock:
            state = self._state
            out: dict[str, Any] = {
                "state": state,
                "enabled": self._enabled,
                "entity": self._entity,
                "consecutive_failures": self._consec_failures,
                "degraded_after_ticks": self._after_ticks,
                "reconnect_jitter_s": self._jitter_window_s,
                "outages_total": self._outages_total,
                "frozen_events": dict(self._frozen_events),
            }
            if state != CONNECTED:
                out["outage_started_unix"] = self._outage_started_unix
                out["outage_seconds"] = round(
                    time.monotonic() - self._outage_started_mono, 3)
            if state == RECOVERING:
                out["recover_in_s"] = round(
                    max(0.0, self._recover_at_mono - time.monotonic()), 3)
        out["held"] = self.held.report()
        out["reconnects_total"] = getattr(self._coord,
                                          "reconnects_total", 0)
        return out
