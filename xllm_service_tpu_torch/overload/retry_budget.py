"""Global retry budget: one token bucket capping retry amplification.

During a partial outage every retry layer is locally rational — the
failover loop replays dead instances' requests, the multimaster relay
re-owns streams off dead frontends — but their PRODUCT is not: N layers
of "try 3 times" turn one unit of offered load into 3^N units of fleet
load exactly when the fleet can least afford it (the classic retry-storm
amplification; Google SRE "Handling Overload"). The budget makes the
total retry volume proportional to the total request volume:

- every accepted request DEPOSITS ``retry_budget_ratio`` tokens
  (capped at ``retry_budget_cap`` — the burst allowance);
- every failover re-dispatch attempt and every relay re-ownership
  recovery WITHDRAWS one token first, and fails the request fast when
  the bucket is empty.

So steady-state retries are bounded at ~ratio × request rate, a healthy
fleet keeps a full burst allowance, and a mass failure degrades into
bounded, budgeted recovery instead of a self-sustaining storm. Channel-
level transport retries (rpc/channel.py) stay outside the budget: they
are already bounded per call and back off with jitter; the budget
governs the layers that multiply them.

``retry_budget_cap <= 0`` disables the budget (every spend allowed).
"""

from __future__ import annotations

import threading

from typing import Any

from ..devtools import lifecycle as _lifecycle
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock


@_ownership.verify_state
class RetryBudget:
    """Process-global token bucket. Both paths are a leaf-lock hold
    around float math."""

    def __init__(self) -> None:
        self._lock = make_lock("overload.retry_budget", order=838)  # lock-order: 838
        self._ratio = 0.1
        self._cap = 50.0
        self._tokens = 50.0
        self._spent_total = 0
        self._denied_total = 0

    def configure(self, ratio: float = 0.1, cap: float = 50.0) -> None:
        """Re-arm with a full bucket and fresh counters (a healthy boot
        starts with its whole burst allowance)."""
        with self._lock:
            self._ratio = max(0.0, ratio)
            self._cap = max(0.0, cap)
            self._tokens = self._cap
            self._spent_total = 0
            self._denied_total = 0

    def reset(self) -> None:
        """Test hook: refill and zero the counters."""
        with self._lock:
            self._tokens = self._cap
            self._spent_total = 0
            self._denied_total = 0
        _lifecycle.note_reset("retry-budget")

    @property
    def enabled(self) -> bool:
        return self._cap > 0

    def note_request(self) -> None:
        """One accepted request: deposit the per-request retry
        allowance."""
        with self._lock:
            if self._cap > 0:
                self._tokens = min(self._cap, self._tokens + self._ratio)
                _lifecycle.note_release("retry-budget")

    def try_spend(self, n: float = 1.0) -> bool:
        """Withdraw `n` tokens for a retry; False = budget exhausted,
        the caller must fail fast instead of retrying."""
        with self._lock:
            if self._cap <= 0:
                return True
            if self._tokens >= n:
                self._tokens -= n
                self._spent_total += 1
                _lifecycle.note_acquire("retry-budget")
                return True
            self._denied_total += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens if self._cap > 0 else float("inf")

    def report(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": self._cap > 0,
                "ratio": self._ratio,
                "cap": self._cap,
                "tokens": round(self._tokens, 3),
                "spent_total": self._spent_total,
                "denied_total": self._denied_total,
            }


#: Process-global budget shared by failover + relay recovery.
RETRY_BUDGET = RetryBudget()
