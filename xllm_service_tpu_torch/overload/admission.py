"""Admission control + priority shedding: the bounded gate in front of
the schedule executor.

Without this gate, a burst beyond fleet capacity queues unboundedly —
first in the schedule executor, then in the engines — until TTFT
collapses for every request. The gate bounds the in-flight set at
a per-priority watermark derived from the live fleet size, so a request
that cannot be served within its SLO is refused in microseconds with a
``429`` + ``Retry-After`` instead of being served in seconds:

- the ADMISSION LIMIT is ``admission_max_inflight_per_instance ×
  live_instances`` (live from the lock-free RCU routing snapshot — the
  limit tracks scale-out/in automatically);
- **batch** priority is admitted only below ``admission_batch_watermark
  × limit``, and not at all while the SLO burn is hot (brownout state)
  — interactive traffic keeps the full limit;
- **interactive** priority is shed only when the limit itself is hit.

The decision is a pure function (:func:`decide_admission`) over an
immutable input row — unit-testable as a table, like the autoscaler
kernel. The controller adds the mutable half: the in-flight count
(acquired at admission, released by the scheduler's exactly-once exit
path), per-second shed buckets (the shed RATE feeds the autoscaler
kernel so shedding and scale-out cooperate rather than mask each
other), and the counters behind ``GET /admin/overload``.
"""

from __future__ import annotations

import threading

import time
from dataclasses import dataclass
from typing import Any, Optional

from ..common.slo import WindowCounts
from ..devtools import lifecycle as _lifecycle
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from .deadline import PRIORITY_BATCH

#: Sliding window for the shed-rate signal the autoscaler consumes.
_SHED_WINDOW_S = 10.0


@dataclass(frozen=True)
class AdmissionInputs:
    """One admission decision's immutable view."""

    pending: int = 0               # in-flight admitted requests
    live: int = 0                  # schedulable instances (RCU snapshot)
    per_instance_limit: int = 0    # 0 = admission control disabled
    batch_watermark: float = 0.5
    burn_hot: bool = False         # SLO burn breaching (brownout state)
    priority: str = "interactive"


def decide_admission(inp: AdmissionInputs) -> tuple[bool, str]:
    """(admit, reason). Pure — no clocks, no locks."""
    if inp.per_instance_limit <= 0:
        return True, "admission control disabled"
    limit = inp.per_instance_limit * max(1, inp.live)
    if inp.pending >= limit:
        return False, (f"admission queue full ({inp.pending}/{limit} "
                       f"over {max(1, inp.live)} live instance(s))")
    if inp.priority == PRIORITY_BATCH:
        cap = 0 if inp.burn_hot else int(limit * inp.batch_watermark)
        if inp.pending >= cap:
            return False, (
                "batch shed: SLO burn hot — batch admission closed"
                if inp.burn_hot else
                f"batch shed: over batch watermark ({inp.pending}/{cap} "
                f"of limit {limit})")
    return True, "admitted"


@_ownership.verify_state
class AdmissionController:
    """Process-global admission gate. ``try_admit`` runs on the request
    hot path: one leaf-lock hold around integer math and a deque
    append — no RPC, no fleet walk (``live`` comes in from the caller's
    snapshot read)."""

    def __init__(self) -> None:
        self._lock = make_lock("overload.admission", order=832)  # lock-order: 832
        self._per_instance_limit = 0
        self._batch_watermark = 0.5
        self._retry_after_s = 1.0
        self._pending = 0
        self._admitted_total = 0
        self._shed_total: dict[str, int] = {}
        # Rolling shed window (the shared per-second bucket helper from
        # common/slo.py; mutated only under self._lock).
        self._shed_window = WindowCounts(_SHED_WINDOW_S)

    def configure(self, per_instance_limit: int = 0,
                  batch_watermark: float = 0.5,
                  retry_after_s: float = 1.0) -> None:
        with self._lock:
            self._per_instance_limit = max(0, int(per_instance_limit))
            self._batch_watermark = min(1.0, max(0.0, batch_watermark))
            self._retry_after_s = max(0.0, retry_after_s)

    def reset(self) -> None:
        """Test hook: zero the counters and the in-flight count."""
        with self._lock:
            self._pending = 0
            self._admitted_total = 0
            self._shed_total = {}
            self._shed_window = WindowCounts(_SHED_WINDOW_S)
        _lifecycle.note_reset("admission-slot")

    @property
    def enabled(self) -> bool:
        return self._per_instance_limit > 0

    # ------------------------------------------------------------- hot path
    def try_admit(self, priority: str, live: int,
                  burn_hot: bool) -> tuple[bool, str, float]:
        """(admit, reason, retry_after_s). Admission increments the
        in-flight count; the caller MUST pair every admit with exactly
        one :meth:`release` (the scheduler's exit accounting)."""
        with self._lock:
            inp = AdmissionInputs(
                pending=self._pending, live=live,
                per_instance_limit=self._per_instance_limit,
                batch_watermark=self._batch_watermark,
                burn_hot=burn_hot, priority=priority)
            admit, reason = decide_admission(inp)
            if admit:
                self._pending += 1
                self._admitted_total += 1
                _lifecycle.note_acquire("admission-slot")
            else:
                self._shed_total[priority] = \
                    self._shed_total.get(priority, 0) + 1
                self._shed_window.record(bad=True)
            return admit, reason, self._retry_after_s

    def release(self) -> None:
        """One admitted request exited (any path — finish, error,
        cancel). Clamped at zero: direct-scheduler callers that never
        admitted must not be able to underflow the gate."""
        with self._lock:
            self._pending = max(0, self._pending - 1)
            _lifecycle.note_release("admission-slot")

    # -------------------------------------------------------------- signals
    def shed_rate(self, now: Optional[float] = None) -> float:
        """Sheds per second over the recent window — the autoscaler
        kernel's coupling signal (shedding is unserved demand: it must
        drive scale-out, not mask the need for it)."""
        now = now if now is not None else time.time()
        with self._lock:
            _, shed = self._shed_window.counts(now)
        return shed / _SHED_WINDOW_S

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def report(self) -> dict[str, Any]:
        # The shed rate re-takes the (non-reentrant) leaf lock — compute
        # it before the locked field snapshot.
        rate = self.shed_rate()
        with self._lock:
            return {
                "enabled": self._per_instance_limit > 0,
                "per_instance_limit": self._per_instance_limit,
                "batch_watermark": self._batch_watermark,
                "retry_after_s": self._retry_after_s,
                "pending": self._pending,
                "admitted_total": self._admitted_total,
                "shed_total": dict(self._shed_total),
                "shed_rate_per_s": rate,
            }


#: Process-global gate; the HTTP service configures it from options.
ADMISSION = AdmissionController()
