"""Per-instance circuit breaker for the engine control-plane channel.

One sick-but-leased engine — accepting TCP, failing or timing out every
RPC — is worse than a dead one: a dead engine's lease lapses and the
three-state failure detector evicts it, but a sick one keeps renewing
its lease while every cancel/link/drain/forward against it burns a full
timeout × retries, and every request routed to it burns failover budget.
The breaker is the standard three-state answer (Nygard, *Release It!*;
the same shape as Envoy outlier detection), attached to each
:class:`..rpc.channel.EngineChannel`:

- **CLOSED** — normal. Outcomes are recorded into a rolling window;
  when at least ``min_samples`` outcomes in ``window_s`` are
  ``failure_ratio`` bad, the breaker OPENs.
- **OPEN** — every call fails fast (no network). The routing layer
  (InstanceMgr's reconcile thread) mirrors this as the
  ``BREAKER_OPEN`` runtime state, so the RCU routing snapshot excludes
  the instance exactly like SUSPECT.
- **HALF_OPEN** — after ``open_cooldown_s`` ONE probe is allowed
  through (the reconcile thread's health probe). Success closes the
  breaker and restores the instance to routing; failure re-opens it for
  another cooldown.

Failures are TRANSPORT failures (timeouts, resets, refusals) and
unexplained server errors (500/502) — any other HTTP answer, including
the overload plane's own deliberate 429/503/504 rejections, is evidence
of health, not sickness (see ``channel._breaker_ok``: counting
deliberate overload answers as failures would eject busy-but-healthy
instances mid-burst, a positive-feedback capacity collapse). Recording
happens per attempt (inside the channel's retry loop), so a flapping
instance accumulates evidence at attempt rate, not call rate.
"""

from __future__ import annotations

import threading

import time
from collections import deque
from typing import Any, Optional

from ..devtools import lifecycle as _lifecycle
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"


@_ownership.verify_state
class CircuitBreaker:
    """Rolling-window breaker; all transitions under one leaf lock."""

    def __init__(self, name: str = "", window_s: float = 30.0,
                 min_samples: int = 5, failure_ratio: float = 0.5,
                 open_cooldown_s: float = 5.0, enabled: bool = True):
        self.name = name
        self.window_s = max(0.1, window_s)
        self.min_samples = max(1, min_samples)
        self.failure_ratio = min(1.0, max(0.0, failure_ratio))
        self.open_cooldown_s = max(0.0, open_cooldown_s)
        self.enabled = enabled
        self._lock = make_lock("rpc.breaker", order=836)  # lock-order: 836
        self._events: deque = deque()     # (monotonic_ts, ok)
        self._state = STATE_CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self._open_total = 0

    # ---------------------------------------------------------------- reads
    def state(self) -> str:
        with self._lock:
            return self._state

    def is_open(self, now: Optional[float] = None) -> bool:
        """True while calls would be refused (OPEN before cooldown).
        HALF_OPEN reports False: a probe may pass."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            return self._state == STATE_OPEN and \
                now - self._opened_at < self.open_cooldown_s

    # ------------------------------------------------------------ decisions
    def allow(self, now: Optional[float] = None) -> bool:
        """May a call proceed now? OPEN fails fast until the cooldown
        elapses, then transitions to HALF_OPEN and admits exactly ONE
        probe at a time (further calls fail fast until the probe's
        outcome is recorded)."""
        if not self.enabled:
            return True
        now = now if now is not None else time.monotonic()
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN:
                if now - self._opened_at < self.open_cooldown_s:
                    return False
                self._state = STATE_HALF_OPEN
                self._probe_inflight = True
                _lifecycle.note_acquire("breaker-probe", key=self.name)
                return True
            # HALF_OPEN: one probe in flight at a time.
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            _lifecycle.note_acquire("breaker-probe", key=self.name)
            return True

    def record(self, ok: bool, now: Optional[float] = None) -> None:
        """One attempt outcome. In HALF_OPEN the outcome resolves the
        probe: success closes (window reset — the sick history must not
        immediately re-trip), failure re-opens for another cooldown."""
        if not self.enabled:
            return
        now = now if now is not None else time.monotonic()
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                if self._probe_inflight:
                    _lifecycle.note_release("breaker-probe", key=self.name)
                self._probe_inflight = False
                if ok:
                    self._state = STATE_CLOSED
                    self._events.clear()
                else:
                    self._state = STATE_OPEN
                    self._opened_at = now
                    self._open_total += 1
                return
            self._events.append((now, ok))
            horizon = now - self.window_s
            while self._events and self._events[0][0] < horizon:
                self._events.popleft()
            if self._state != STATE_CLOSED:
                return
            n = len(self._events)
            if n < self.min_samples:
                return
            bad = sum(1 for _, o in self._events if not o)
            if bad / n >= self.failure_ratio:
                self._state = STATE_OPEN
                self._opened_at = now
                self._open_total += 1

    # ------------------------------------------------------------ reporting
    def snapshot(self, now: Optional[float] = None) -> dict[str, Any]:
        now = now if now is not None else time.monotonic()
        with self._lock:
            n = len(self._events)
            bad = sum(1 for _, o in self._events if not o)
            return {
                "state": self._state,
                "enabled": self.enabled,
                "window_samples": n,
                "window_failures": bad,
                "open_total": self._open_total,
                "open_age_s": round(now - self._opened_at, 3)
                if self._state != STATE_CLOSED else 0.0,
            }
