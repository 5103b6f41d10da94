"""Overload-hardening plane (docs/robustness.md).

The serving stack's graceful-degradation layer, built from four
cooperating mechanisms — each independently togglable, all reported at
``GET /admin/overload``:

- **End-to-end deadlines** (:mod:`.deadline`): a per-request deadline
  (body ``timeout`` seconds / ``x-request-deadline-ms`` header /
  ``ServiceOptions.default_request_deadline_ms``) is carried as an
  ABSOLUTE wall-clock ms value through the enriched engine payload and
  the multimaster handoff wire, and enforced at every hop — admission
  rejects already-expired work, the scheduler cancels mid-stream
  expiries, and engines stop decoding past-deadline requests.
- **Admission control + priority shedding** (:mod:`.admission`): a
  bounded admission gate in front of the schedule executor with
  per-priority (``x-request-priority``: interactive/batch) watermarks
  derived from the RCU routing snapshot's live fleet size and the SLO
  burn state; rejected requests get a fast 429 with ``Retry-After``
  instead of queueing, and the shed rate feeds the autoscaler kernel so
  shedding and scale-out cooperate.
- **Brownout mode** (:mod:`.brownout`): when both SLO burn windows
  breach, degrade before refusing — batch-priority ``max_tokens`` is
  clamped and optional work (trace head-sampling) is shed, lifting as
  burn recovers; every transition is logged with reasons and captured
  by the flight recorder.
- **Global retry budget** (:mod:`.retry_budget`): one token bucket
  shared by the failover and multimaster-relay retry paths caps retry
  amplification during partial outages (per-instance circuit breakers
  live in :mod:`..rpc.breaker`).

All four state holders are process-global singletons configured by the
HTTP service from :class:`..common.config.ServiceOptions` — the same
pattern as ``SLO_MONITOR`` / ``RECORDER``.
"""

from .admission import ADMISSION, AdmissionController, decide_admission
from .brownout import BROWNOUT, BrownoutController
from .deadline import (
    ABS_DEADLINE_HEADER,
    DEADLINE_HEADER,
    PRIORITY_BATCH,
    PRIORITY_HEADER,
    PRIORITY_INTERACTIVE,
    deadline_expired,
    parse_deadline_ms,
    parse_priority,
    remaining_ms,
)
from .retry_budget import RETRY_BUDGET, RetryBudget

__all__ = [
    "ADMISSION",
    "AdmissionController",
    "decide_admission",
    "BROWNOUT",
    "BrownoutController",
    "RETRY_BUDGET",
    "RetryBudget",
    "DEADLINE_HEADER",
    "ABS_DEADLINE_HEADER",
    "PRIORITY_HEADER",
    "PRIORITY_INTERACTIVE",
    "PRIORITY_BATCH",
    "parse_deadline_ms",
    "parse_priority",
    "remaining_ms",
    "deadline_expired",
]
