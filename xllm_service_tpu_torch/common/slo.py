"""SLO burn-rate monitor: multi-window error-budget tracking over live
telemetry.

The ROADMAP's closed-loop autoscaling item ("SLO policy on live
telemetry") needs a machine-readable answer to "are we meeting our
objectives, and how fast are we spending the budget?" — not a raw
latency histogram. This module implements the Google-SRE multi-window
multi-burn-rate construction:

- An **objective** turns each observation into good/bad: a TTFT or TPOT
  sample is *bad* when it exceeds its target (``slo_ttft_ms`` /
  ``slo_tpot_ms``); a request is *bad* when it surfaces an error. The
  **error budget** (``slo_error_budget``) is the allowed bad fraction.
- The **burn rate** over a window is ``bad_fraction / budget`` — 1.0
  means spending exactly the sustainable pace, 14.4 means the monthly
  budget would be gone in ~2 days.
- Two rolling windows (**fast** ~5 min, **slow** ~1 h) are tracked per
  objective; an objective is *breaching* when BOTH are at or above
  ``slo_burn_alert`` — the fast window gives detection latency, the slow
  window keeps a transient spike from paging anyone.

Observations aggregate into per-second buckets (bounded memory at any
QPS); reads walk only the buckets inside the window. The scored report
is served at ``GET /admin/slo`` and exported as the
``slo_burn_rate{objective,window}`` gauges, which is exactly the input
surface ``scheduler/planner.py`` and ``policies/slo_aware.py`` grow into
next.
"""

from __future__ import annotations

import threading

import time
from collections import deque
from typing import Any, Optional

from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock

#: Objective keys (stable API: gauge label values and report keys).
OBJECTIVES = ("ttft", "tpot", "error_rate")


class WindowCounts:
    """Rolling good/bad counts bucketed per second (one deque of
    ``[sec, good, bad]`` triples; writers append/merge at the tail,
    readers prune the head lazily — bounded at any rate with or without
    a reader). Shared helper: the SLO objectives' windows here and the
    admission gate's shed-rate window (overload/admission.py) both ride
    it. NOT internally locked — the owner serializes access."""

    def __init__(self, window_s: float):
        self.window_s = max(1.0, float(window_s))
        self._buckets: deque[list] = deque()

    def record(self, bad: bool, now: Optional[float] = None) -> None:
        sec = int(now if now is not None else time.time())
        if self._buckets and self._buckets[-1][0] == sec:
            b = self._buckets[-1]
        else:
            b = [sec, 0, 0]
            self._buckets.append(b)
            # Prune on the write path too: a process that records but is
            # never scraped must still hold only one window of buckets
            # (reads prune as well — this keeps the 'bounded memory at
            # any QPS' claim true without any reader).
            self._prune(sec)
        b[2 if bad else 1] += 1

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    def counts(self, now: Optional[float] = None) -> tuple[int, int]:
        """(good, bad) over the window."""
        now = now if now is not None else time.time()
        self._prune(now)
        good = bad = 0
        for _, g, b in self._buckets:
            good += g
            bad += b
        return good, bad


class _Objective:
    def __init__(self, name: str, fast_s: float, slow_s: float,
                 budget: float, target: Optional[float] = None):
        self.name = name
        self.target = target          # ms threshold; None = outcome-based
        self.budget = max(1e-6, float(budget))
        self.fast = WindowCounts(fast_s)
        self.slow = WindowCounts(slow_s)
        # Trace exemplars: the worst observation per second bucket
        # ([sec, value, trace_id], pruned to the slow horizon) — a burn
        # spike in /admin/slo links straight to a federated trace and
        # its critical-path breakdown instead of a bare number.
        self.exemplars: deque[list] = deque()

    def record(self, bad: bool, now: Optional[float] = None,
               value: Optional[float] = None, trace_id: str = "") -> None:
        self.fast.record(bad, now)
        self.slow.record(bad, now)
        if not trace_id or value is None:
            return
        sec = int(now if now is not None else time.time())
        if self.exemplars and self.exemplars[-1][0] == sec:
            b = self.exemplars[-1]
            if value > b[1]:
                b[1], b[2] = value, trace_id
        else:
            self.exemplars.append([sec, value, trace_id])
            horizon = sec - self.slow.window_s
            while self.exemplars and self.exemplars[0][0] < horizon:
                self.exemplars.popleft()

    def worst_exemplar(self, w: WindowCounts,
                       now: Optional[float] = None) -> Optional[dict]:
        now = now if now is not None else time.time()
        horizon = now - w.window_s
        best = None
        for sec, value, tid in self.exemplars:
            if sec >= horizon and (best is None or value > best[1]):
                best = (sec, value, tid)
        if best is None:
            return None
        return {"trace_id": best[2], "value": round(best[1], 3),
                "age_s": round(now - best[0], 1)}

    def window_report(self, w: WindowCounts,
                      now: Optional[float] = None) -> dict[str, Any]:
        good, bad = w.counts(now)
        n = good + bad
        frac = (bad / n) if n else 0.0
        return {"window_s": w.window_s, "n": n, "bad": bad,
                "bad_fraction": round(frac, 6),
                "burn_rate": round(frac / self.budget, 3),
                "exemplar": self.worst_exemplar(w, now)}

    def report(self, alert: float,
               now: Optional[float] = None) -> dict[str, Any]:
        fast = self.window_report(self.fast, now)
        slow = self.window_report(self.slow, now)
        return {
            "objective": self.name,
            "target_ms": self.target,
            "error_budget": self.budget,
            "fast": fast,
            "slow": slow,
            # Multi-window rule: both windows must burn hot — the fast
            # one for detection latency, the slow one so a blip that
            # already ended doesn't keep alerting.
            "breaching": (fast["burn_rate"] >= alert
                          and slow["burn_rate"] >= alert),
        }


@_ownership.verify_state
class SloMonitor:
    """Process-global burn-rate tracker over the three serving
    objectives. Writers (the scheduler's token/exit paths) hold one leaf
    lock for a deque append; the report walks bounded bucket lists."""

    def __init__(self) -> None:
        self._lock = make_lock("slo.monitor", order=816)  # lock-order: 816
        self.alert = 14.4
        self._configure_locked(1000.0, 50.0, 0.01, 300.0, 3600.0)

    def _configure_locked(self, ttft_ms: float, tpot_ms: float,
                          budget: float, fast_s: float,
                          slow_s: float) -> None:
        self.ttft_target_ms = float(ttft_ms)
        self.tpot_target_ms = float(tpot_ms)
        self._objectives = {
            "ttft": _Objective("ttft", fast_s, slow_s, budget, ttft_ms),
            "tpot": _Objective("tpot", fast_s, slow_s, budget, tpot_ms),
            "error_rate": _Objective("error_rate", fast_s, slow_s, budget),
        }

    def configure(self, ttft_ms: float, tpot_ms: float, budget: float,
                  fast_s: float, slow_s: float,
                  alert: Optional[float] = None) -> None:
        """(Re)configure objectives — resets the windows."""
        with self._lock:
            if alert is not None:
                self.alert = float(alert)
            self._configure_locked(ttft_ms, tpot_ms, budget, fast_s, slow_s)

    # ----------------------------------------------------------- recording
    def record_ttft(self, ms: float, now: Optional[float] = None,
                    trace_id: str = "") -> None:
        with self._lock:
            self._objectives["ttft"].record(
                ms > self.ttft_target_ms, now, value=ms, trace_id=trace_id)

    def record_tpot(self, ms: float, now: Optional[float] = None,
                    trace_id: str = "") -> None:
        with self._lock:
            self._objectives["tpot"].record(
                ms > self.tpot_target_ms, now, value=ms, trace_id=trace_id)

    def record_request(self, ok: bool, now: Optional[float] = None,
                       trace_id: str = "") -> None:
        with self._lock:
            self._objectives["error_rate"].record(
                not ok, now, value=None if ok else 1.0,
                trace_id="" if ok else trace_id)

    def ttft_breached(self, ms: float) -> bool:
        """Per-request breach check (flight recorder / tail-sampling keep
        decision) — no budget math, just the target."""
        return ms > self.ttft_target_ms

    # ------------------------------------------------------------- reading
    def report(self, now: Optional[float] = None) -> dict[str, Any]:
        with self._lock:
            objectives = {name: obj.report(self.alert, now)
                          for name, obj in self._objectives.items()}
        worst = max((o["fast"]["burn_rate"] for o in objectives.values()),
                    default=0.0)
        return {
            "alert_burn_rate": self.alert,
            "objectives": objectives,
            "worst_fast_burn_rate": worst,
            "breaching": sorted(name for name, o in objectives.items()
                                if o["breaching"]),
        }

    def export_gauges(self, now: Optional[float] = None) -> dict[str, Any]:
        """Refresh the ``slo_burn_rate{objective,window}`` gauges from the
        current windows and return the report (callers: the /metrics and
        /admin/slo handlers — scrape-time refresh, no background
        thread)."""
        from .metrics import SLO_BURN_RATE

        report = self.report(now)
        for name, obj in report["objectives"].items():
            for window in ("fast", "slow"):
                SLO_BURN_RATE.labels(objective=name, window=window).set(
                    obj[window]["burn_rate"])
        return report


#: Process-global monitor; the HTTP service configures it from options.
SLO_MONITOR = SloMonitor()
