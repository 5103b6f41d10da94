"""Per-request deadline + priority parsing (pure helpers, no state).

A deadline enters the system as a RELATIVE budget — the body's OpenAI-
client-style ``timeout`` (seconds) or the ``x-request-deadline-ms``
header (milliseconds), falling back to
``ServiceOptions.default_request_deadline_ms`` — and is immediately
converted to an ABSOLUTE wall-clock ms value (``Request.deadline_ms``).
Absolute is what propagates: the enriched engine payload carries
``deadline_ms`` and the multimaster relay forwards it as the
``x-xllm-deadline-ms`` header, so every downstream hop naturally
"subtracts elapsed budget" by comparing against its own clock instead
of re-starting the budget from its own arrival time (which would extend
the deadline by the relay/queueing delay it was meant to bound).

Priority classes are two-valued by design (interactive | batch): the
admission gate's per-priority watermarks only need "sheddable first"
vs "shed last", and two classes keep the watermark math and the metric
cardinality trivial. ``offline`` requests default to batch.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from ..common.types import now_ms

#: Client-supplied relative deadline budget in milliseconds.
DEADLINE_HEADER = "x-request-deadline-ms"
#: Relay-hop ABSOLUTE deadline (epoch ms) — internal, set by the
#: multimaster handoff relay so the owner enforces the original budget.
ABS_DEADLINE_HEADER = "x-xllm-deadline-ms"
#: Client-supplied priority class.
PRIORITY_HEADER = "x-request-priority"

PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"


def parse_deadline_ms(body: Mapping[str, Any],
                      headers: Mapping[str, str],
                      default_ms: float,
                      now: Optional[int] = None) -> int:
    """Absolute deadline (epoch ms; 0 = none) for a new accept. Header
    wins over body ``timeout`` wins over the configured default; a
    malformed value falls through to the next source rather than
    failing the request (a deadline is a bound, not an argument)."""
    now = now if now is not None else now_ms()
    raw = headers.get(DEADLINE_HEADER)
    if raw is not None:
        try:
            budget = float(raw)
            if budget > 0:
                return now + int(budget)
        except (TypeError, ValueError):
            pass
    timeout = body.get("timeout")
    if timeout is not None and not isinstance(timeout, bool):
        try:
            budget_s = float(timeout)
            if budget_s > 0:
                return now + int(budget_s * 1000)
        except (TypeError, ValueError):
            pass
    if default_ms and default_ms > 0:
        return now + int(default_ms)
    return 0


def parse_priority(body: Mapping[str, Any],
                   headers: Mapping[str, str]) -> str:
    """interactive | batch. Header wins over the body's
    ``priority_class``; unknown values clamp to interactive (a typo'd
    priority must not silently demote someone to sheddable); requests
    marked ``offline`` default to batch."""
    raw = headers.get(PRIORITY_HEADER) or body.get("priority_class") or ""
    if isinstance(raw, str) and raw.lower() == PRIORITY_BATCH:
        return PRIORITY_BATCH
    if not raw and body.get("offline"):
        return PRIORITY_BATCH
    return PRIORITY_INTERACTIVE


def remaining_ms(deadline_ms: int, now: Optional[int] = None) -> float:
    """Budget left (ms); +inf when no deadline is set."""
    if not deadline_ms:
        return float("inf")
    return float(deadline_ms - (now if now is not None else now_ms()))


def deadline_expired(deadline_ms: int, now: Optional[int] = None) -> bool:
    return bool(deadline_ms) and \
        (now if now is not None else now_ms()) > deadline_ms
