"""Brownout mode: degrade before refusing.

Between "serving everything at full quality" and "shedding load" there
is a cheaper middle gear: serve everything, but serve less of the
optional parts. The brownout controller watches the SLO burn-rate
monitor (common/slo.py) on the scheduler's sync cadence and flips a
process-wide degradation state when ANY objective breaches on BOTH
windows (the same multi-window rule that gates paging and autoscaling):

- **batch-priority ``max_tokens`` is clamped** to
  ``brownout_batch_max_tokens`` — bulk work finishes sooner and returns
  decode capacity to interactive traffic without refusing anyone;
- **optional work is shed**: trace head-sampling drops to
  ``brownout_trace_sample_rate`` (tail-based keep still promotes
  anomalies, so debuggability degrades, not disappears).

Brownout LIFTS with hysteresis: ``brownout_recover_ticks`` consecutive
non-breaching sync passes (a single good tick inside a burst must not
flap the state). Every transition is logged with the burn numbers that
caused it, captured as a flight-recorder anomaly bundle, and kept in a
bounded transition log behind ``GET /admin/overload``.

Each frontend runs its own controller off its own burn monitor — like
admission, brownout protects the local process; no coordination writes,
no write-lease gating.
"""

from __future__ import annotations

import threading

import time
from collections import deque
from typing import Any, Callable, Optional

from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..utils import get_logger
from .deadline import PRIORITY_BATCH

logger = get_logger(__name__)


@_ownership.verify_state
class BrownoutController:
    """Process-global degradation state. ``active()`` /
    ``clamp_max_tokens()`` are the hot-path reads: one attribute load
    (GIL-atomic bool), no lock."""

    def __init__(self) -> None:
        self._lock = make_lock("overload.brownout", order=834)  # lock-order: 834
        self._enabled = True
        self._batch_max_tokens = 32
        self._recover_ticks = 2
        self._trace_sample_rate = 0.0
        self._restore_rate_fn: Optional[Callable[[], float]] = None
        self._active = False
        self._since_s = 0.0
        self._recover_streak = 0
        self._entered_total = 0
        self._log: deque = deque(maxlen=32)

    def configure(self, enabled: bool = True, batch_max_tokens: int = 32,
                  recover_ticks: int = 2, trace_sample_rate: float = 0.0,
                  restore_rate_fn: Optional[Callable[[], float]] = None
                  ) -> None:
        """`restore_rate_fn` returns the sampling rate to restore on
        lift (a callable, not a value: /admin/config may have changed
        the configured rate while brownout held it down)."""
        with self._lock:
            self._enabled = bool(enabled)
            self._batch_max_tokens = max(1, int(batch_max_tokens))
            self._recover_ticks = max(1, int(recover_ticks))
            self._trace_sample_rate = min(1.0, max(0.0, trace_sample_rate))
            self._restore_rate_fn = restore_rate_fn

    def reset(self) -> None:
        """Test hook: back to NORMAL without side effects."""
        with self._lock:
            self._active = False
            self._recover_streak = 0
            self._entered_total = 0
            self._log.clear()

    # ------------------------------------------------------------- hot path
    def active(self) -> bool:
        return self._active

    def clamp_max_tokens(self, priority: str, max_tokens: int) -> int:
        """Brownout cap for batch-priority work (identity for
        interactive traffic and outside brownout)."""
        if self._active and priority == PRIORITY_BATCH:
            return min(max_tokens, self._batch_max_tokens)
        return max_tokens

    # ------------------------------------------------------------ sync tick
    def tick(self, report: Optional[dict[str, Any]] = None,
             now: Optional[float] = None) -> bool:
        """One evaluation pass (scheduler sync cadence). `report` is an
        SLO_MONITOR report (fetched here when not supplied — callers on
        the sync thread pass the one they already computed). Returns the
        post-tick active state."""
        if not self._enabled:
            return False
        if report is None:
            from ..common.slo import SLO_MONITOR

            report = SLO_MONITOR.report()
        breaching = sorted(report.get("breaching", ()))
        worst = report.get("worst_fast_burn_rate", 0.0)
        now = now if now is not None else time.monotonic()
        transition: Optional[dict[str, Any]] = None
        with self._lock:
            if breaching and not self._active:
                self._active = True
                self._since_s = now
                self._recover_streak = 0
                self._entered_total += 1
                transition = self._log_locked(
                    "enter", breaching, worst,
                    f"objectives {','.join(breaching)} breaching on both "
                    f"burn windows (worst fast burn {worst:.1f}); clamping "
                    f"batch max_tokens to {self._batch_max_tokens}, trace "
                    f"sampling to {self._trace_sample_rate}")
            elif self._active and not breaching:
                self._recover_streak += 1
                if self._recover_streak >= self._recover_ticks:
                    self._active = False
                    transition = self._log_locked(
                        "exit", breaching, worst,
                        f"burn recovered for {self._recover_streak} "
                        f"consecutive tick(s); restoring full service")
                    self._recover_streak = 0
            elif self._active:
                self._recover_streak = 0
        if transition is not None:
            self._apply_transition(transition)
        return self._active

    def _log_locked(self, kind: str, breaching: list, worst: float,
                    reason: str) -> dict[str, Any]:
        rec = {"ts_s": round(time.time(), 3), "kind": kind,
               "breaching": list(breaching),
               "worst_fast_burn": round(worst, 3), "reason": reason}
        self._log.append(rec)
        return rec

    def _apply_transition(self, rec: dict[str, Any]) -> None:
        """Side effects OUTSIDE the lock: tracer reconfig + flight
        recorder capture + logging (all leaf-locked elsewhere)."""
        from ..common.flightrecorder import RECORDER
        from ..common.tracing import TRACER

        entering = rec["kind"] == "enter"
        if entering:
            logger.warning("BROWNOUT entered: %s", rec["reason"])
            TRACER.configure(sample_rate=self._trace_sample_rate)
        else:
            logger.info("brownout lifted: %s", rec["reason"])
            restore = self._restore_rate_fn
            TRACER.configure(
                sample_rate=restore() if restore is not None else 1.0)
        RECORDER.record("brownout", detail=dict(rec))

    # ------------------------------------------------------------ reporting
    def report(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": self._enabled,
                "active": self._active,
                "batch_max_tokens": self._batch_max_tokens,
                "recover_ticks": self._recover_ticks,
                "brownout_trace_sample_rate": self._trace_sample_rate,
                "recover_streak": self._recover_streak,
                "entered_total": self._entered_total,
                "transitions": list(self._log),
            }


#: Process-global brownout state; the HTTP service configures it, the
#: scheduler's sync loop ticks it.
BROWNOUT = BrownoutController()
