"""Paired-effect lifecycle discipline: registry + opt-in leak verifier.

The service's whole job is lifecycle bookkeeping — admission/release,
instance register/evict, lease grant/lapse — and the single most
recurrent bug class is an *unbalanced pair*: the admission-slot leak
(any raising path between ``try_admit`` and ``record_new_request``
leaks a slot forever), the context-provider leak (providers never
deregistered on cleanup), and the gauge resurrection (a
post-deregister ``set(0)`` revived an evicted ``circuit_breaker_open``
series). This module is the machine check,
following the ``locks``/``rcu``/``ownership`` pattern exactly:

**Registry** (statically cross-checked by xlint's pair rules):

- :data:`EFFECT_PAIRS` — every acquire→release effect pair in the tree,
  ``"name": "Acq.meth -> Rel.meth @ scope[; opt]*"``. The scope declares
  HOW the release is guaranteed, which is what the static rules check:

  - ``finally`` — the acquiring function (or every one of its callers,
    for an acquire wrapped in a helper) must hold a ``try/finally`` that
    reaches the release, unless ownership is transferred to the declared
    ``transfer=`` method (whose ``sink=`` method then owns the release).
    ``pair-release`` enforces this; ``pair-once`` flags a path that
    releases twice or releases after the transfer.
  - ``owner`` — the release lives in the owning object's teardown; only
    registry staleness is checked statically, the runtime half checks
    the balance.
  - ``gc`` — released by TTL/background gc; statically staleness-only.
  - ``budget`` — a token bucket (withdraw/deposit), intentionally
    non-zero-summing; balance counters only, no violation checks.
  - ``evict`` — a labeled metric series: created by ``.labels(...)``,
    released ONLY through the blessed ``helper=`` function in
    ``common/metrics.py``. ``pair-evict`` flags direct ``.remove()``
    call sites and the lexical write-after-evict resurrection shape.

  ``strict`` marks pairs whose balance must be ZERO at test teardown
  (the debug-guard plugin enforces it); ``idempotent`` marks pairs whose
  instrumented release only fires when something was actually removed
  (pop-style), so a zero-balance release is not a double-release.

**Runtime** (``XLLM_LEAK_DEBUG=1``): the wrapped acquire/release sites
call :func:`note_acquire`/:func:`note_release`; per-(pair, key) balances
carry the acquisition call stacks (same bookkeeping shape as
``locks.thread_holds``), a release with zero balance on a non-idempotent
pair records a double-release, and :func:`note_series_created` against a
tombstone left by the blessed evict helper records a resurrected metric
series. Violations are recorded, never raised — the pytest plugin
``xllm_service_tpu_torch.testing.debug_guard`` fails any test that
recorded one (or left a nonzero strict balance)
while debug mode is on, so the chaos / multimaster / overload drills
double as a resource-leak detector.

**Escape hatch**: :func:`escape` suppresses leak bookkeeping for a
calling-thread region and requires a reason string, exactly like
``ownership.escape`` / ``rcu.thaw``.
"""

from __future__ import annotations

import os
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional

from ..utils import get_logger

logger = get_logger(__name__)

#: Acquire→release effect pairs. Key = pair name (the identifier used in
#: ``note_acquire``/``note_release`` calls and violation messages);
#: value = ``"AcqClass.meth -> RelClass.meth @ scope[; option]*"``.
#: xlint's pair rules parse this registry (via :func:`parse_spec`) and
#: cross-check every entry against the tree in both directions.
EFFECT_PAIRS: dict[str, str] = {
    # The admission leak class: one admission-gate slot per admitted request.
    # Ownership transfers to the scheduler at record_new_request; the
    # idempotent winning exit in _remove_request releases it.
    "admission-slot":
        "AdmissionController.try_admit -> AdmissionController.release"
        " @ finally; transfer=Scheduler.record_new_request;"
        " sink=Scheduler._remove_request; strict",
    # Token bucket: deposits are fractional per request, withdrawals
    # whole — intentionally non-zero-summing.
    "retry-budget":
        "RetryBudget.try_spend -> RetryBudget.note_request @ budget",
    # HALF_OPEN probe admit resolves in record() (ok or not).
    "breaker-probe":
        "CircuitBreaker.allow -> CircuitBreaker.record @ owner",
    # Labeled series: created on first .labels(...), released only via
    # the blessed metrics.evict_series helper (the resurrection class).
    "metric-series":
        "_Metric.labels -> _Metric.remove @ evict; helper=evict_series;"
        " idempotent",
    # The provider leak class: anomaly-context providers must deregister.
    "flight-context":
        "FlightRecorder.add_context_provider ->"
        " FlightRecorder.remove_context_provider @ owner; strict;"
        " idempotent",
    # Tail-sampling side buffer: pending traces promote or drop/gc.
    "span-pending":
        "SpanStore.add_pending -> SpanStore.promote @ gc; idempotent",
    # Streamed KV offers: consumed by the puller or TTL-gc'd.
    "stream-offer":
        "StreamOfferTable.offer -> StreamOfferTable.release @ gc;"
        " idempotent",
    # Exact-replay journal entries: finished by the owner, TTL-gc'd.
    "journal-session":
        "DeltaJournal.start -> DeltaJournal.finish @ gc; idempotent",
    # Leased coordination keys: keepalive stops, lease lapses naturally.
    "coord-lease":
        "CoordinationClient.set -> CoordinationClient.release @ gc;"
        " idempotent",
    # Offload-executor inflight slots (bounded transfer pump).
    "tier-inflight":
        "TieredKVStore.offload -> TieredKVStore._offload_worker @ owner",
    # Continuous-profiling sampler thread: refcounted start/stop; the
    # last stop must join the thread and drop the flight-recorder
    # context provider (idempotent: start with profile_hz=0 spawns
    # nothing, so its stop releases nothing).
    "profiler-thread":
        "SamplingProfiler.start -> SamplingProfiler.stop @ owner;"
        " strict; idempotent",
}

_SCOPES = ("finally", "owner", "gc", "budget", "evict")
_FLAGS = ("strict", "idempotent")
_OPTS = ("transfer", "sink", "helper")


@dataclass(frozen=True)
class PairSpec:
    name: str
    acquire: tuple          # (cls, meth)
    release: tuple          # (cls, meth)
    scope: str
    transfer: Optional[tuple] = None
    sink: Optional[tuple] = None
    helper: Optional[str] = None
    strict: bool = False
    idempotent: bool = False


def _dotted(text: str) -> Optional[tuple]:
    parts = text.strip().split(".")
    if len(parts) != 2 or not all(p.isidentifier() for p in parts):
        return None
    return (parts[0], parts[1])


def parse_spec(name: str, text: Any) -> tuple[Optional[PairSpec], list[str]]:
    """Parse one EFFECT_PAIRS value. Returns ``(spec, errors)`` — the
    single grammar shared by the runtime half and xlint's pair rules
    (which parse the registry out of the AST, fixture stand-ins
    included)."""
    errors: list[str] = []
    if not isinstance(text, str):
        return None, [f"pair '{name}': spec must be a string literal"]
    head, _, opt_text = text.partition(";")
    methods, at, scope = head.partition("@")
    if not at:
        return None, [f"pair '{name}': missing '@ scope'"]
    scope = scope.strip()
    if scope not in _SCOPES:
        return None, [f"pair '{name}': unknown scope '{scope}' "
                      f"(expected one of {', '.join(_SCOPES)})"]
    acq_text, arrow, rel_text = methods.partition("->")
    acq = _dotted(acq_text) if arrow else None
    rel = _dotted(rel_text) if arrow else None
    if acq is None or rel is None:
        return None, [f"pair '{name}': expected 'Cls.meth -> Cls.meth', "
                      f"got '{methods.strip()}'"]
    opts: dict[str, Any] = {}
    for raw in opt_text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        key, eq, val = raw.partition("=")
        key = key.strip()
        if key in _FLAGS and not eq:
            opts[key] = True
        elif key in ("transfer", "sink") and eq:
            ref = _dotted(val)
            if ref is None:
                errors.append(f"pair '{name}': bad {key}= target '{val}'")
            else:
                opts[key] = ref
        elif key == "helper" and eq and val.strip().isidentifier():
            opts["helper"] = val.strip()
        else:
            errors.append(f"pair '{name}': unknown option '{raw}'")
    if errors:
        return None, errors
    return PairSpec(name=name, acquire=acq, release=rel, scope=scope,
                    **opts), []


_parsed: Optional[dict[str, PairSpec]] = None


def pair_specs() -> dict[str, PairSpec]:
    """Parsed EFFECT_PAIRS (malformed entries dropped; the registry in
    this file is additionally linted, so a malformed entry is a CI
    failure, not a silent skip)."""
    global _parsed
    if _parsed is None:
        out = {}
        for name, text in EFFECT_PAIRS.items():
            spec, errs = parse_spec(name, text)
            if spec is not None:
                out[name] = spec
            else:  # pragma: no cover - registry is linted
                logger.error("malformed EFFECT_PAIRS entry: %s", errs)
        _parsed = out
    return _parsed


# ------------------------------------------------------------------ runtime
_DEBUG = os.environ.get("XLLM_LEAK_DEBUG", "") not in ("", "0")


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    """Test hook: arms/disarms the leak verifier for subsequent
    note_* calls."""
    global _DEBUG
    _DEBUG = on


@dataclass
class LeakViolation:
    kind: str            # "double-release" | "leak" | "resurrected-series"
    pair: str
    message: str
    thread: str
    stack: list[str] = field(default_factory=list)

    def __str__(self) -> str:
        return f"[{self.kind}:{self.pair}] {self.message} " \
               f"(thread {self.thread})"


# Detector bookkeeping; leaf locks, never held across project locks.
_lviol_lock = threading.Lock()   # lock-order: 905
_violations: list[LeakViolation] = []
# Balances + tombstones share one leaf lock (only touched under debug).
_lbal_lock = threading.Lock()   # lock-order: 906
# (pair, key) -> outstanding acquisition stacks (len == balance).
_balances: dict[tuple, list[list[str]]] = {}
# Evicted labeled-series tombstones: (metric_name, label_key_tuple).
_tombstones: set[tuple] = set()


def violations() -> list[LeakViolation]:
    with _lviol_lock:
        return list(_violations)


def reset_violations() -> None:
    with _lviol_lock:
        _violations.clear()


def _record(kind: str, pair: str, message: str) -> None:
    v = LeakViolation(kind=kind, pair=pair, message=message,
                      thread=threading.current_thread().name,
                      stack=traceback.format_stack(limit=12)[:-2])
    with _lviol_lock:
        _violations.append(v)
    logger.error("lifecycle violation: %s", v)


_tls = threading.local()


class _Escape:
    """Context manager marking a calling-thread region exempt from leak
    bookkeeping (per-thread depth counter, like ``ownership.escape``)."""

    def __enter__(self) -> "_Escape":
        _tls.escape = getattr(_tls, "escape", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _tls.escape = getattr(_tls, "escape", 1) - 1


_ESCAPE = _Escape()


def escape(reason: str) -> _Escape:
    """Declare a region exempt from pair bookkeeping. ``reason`` is
    mandatory (the runtime mirror of an ``# xlint: allow-pair-*(reason)``
    comment; xlint flags an empty reason)."""
    if not reason or not isinstance(reason, str):
        raise ValueError("lifecycle.escape requires a non-empty reason "
                         "string")
    return _ESCAPE


def _escaped() -> bool:
    return getattr(_tls, "escape", 0) > 0


def note_acquire(pair: str, key: Any = None) -> None:
    """Record one acquisition of `pair` (optionally keyed — e.g. a
    provider name or offer uuid). Call sites gate nothing: with debug
    off this is one global check."""
    if not _DEBUG or _escaped():
        return
    stack = traceback.format_stack(limit=10)[:-1]
    with _lbal_lock:
        _balances.setdefault((pair, key), []).append(stack)


def note_release(pair: str, key: Any = None) -> None:
    """Record one release of `pair`. A release with zero balance on a
    non-idempotent pair is a double-release (the bug class where two
    exit paths both decrement)."""
    if not _DEBUG or _escaped():
        return
    with _lbal_lock:
        stacks = _balances.get((pair, key))
        if stacks:
            stacks.pop()
            return
    spec = pair_specs().get(pair)
    if spec is not None and (spec.idempotent or spec.scope == "budget"):
        return   # pop-style release or token bucket: zero balance is fine
    _record("double-release", pair,
            f"release with zero balance (key={key!r})")


def note_reset(pair: str) -> None:
    """A blessed bulk-reset of the pair's underlying counter (e.g.
    ``AdmissionController.reset()``): drop its balances so the verifier
    tracks the code's own notion of outstanding effects."""
    if not _DEBUG:
        return
    with _lbal_lock:
        for k in [k for k in _balances if k[0] == pair]:
            del _balances[k]


def balances() -> dict[tuple, int]:
    """Snapshot of nonzero (pair, key) balances — diagnostic helper."""
    with _lbal_lock:
        return {k: len(v) for k, v in _balances.items() if v}


def reset_balances() -> None:
    with _lbal_lock:
        _balances.clear()
        _tombstones.clear()


def strict_imbalances() -> list[LeakViolation]:
    """Leak verdicts for strict pairs: any nonzero balance, reported with
    the oldest outstanding acquisition stack. The conftest guard calls
    this at test teardown."""
    specs = pair_specs()
    out: list[LeakViolation] = []
    with _lbal_lock:
        snap = {k: list(v) for k, v in _balances.items() if v}
    for (pair, key), stacks in sorted(snap.items(), key=lambda kv: str(kv)):
        spec = specs.get(pair)
        if spec is None or not spec.strict:
            continue
        out.append(LeakViolation(
            kind="leak", pair=pair,
            message=f"{len(stacks)} unreleased acquisition(s) "
                    f"(key={key!r}); oldest acquired at:\n"
                    + "".join(stacks[0][-4:]),
            thread="<teardown>"))
    return out


# ------------------------------------------- labeled metric series half
def note_series_evicted(metric_name: str, key: tuple) -> None:
    """Called by the blessed ``metrics.evict_series`` helper: tombstone
    the evicted child so a later re-creation is caught as a
    resurrection."""
    if not _DEBUG or _escaped():
        return
    with _lbal_lock:
        _tombstones.add((metric_name, key))


def note_series_created(metric_name: str, key: tuple) -> None:
    """Called by ``_Metric.labels()`` when it creates a NEW child: a
    creation against a tombstone is the gauge-resurrection bug
    (a stale writer reviving an evicted series). One report per
    tombstone."""
    if not _DEBUG or _escaped():
        return
    with _lbal_lock:
        if (metric_name, key) not in _tombstones:
            return
        _tombstones.discard((metric_name, key))
    _record("resurrected-series", "metric-series",
            f"evicted series {metric_name}{key!r} re-created by a write")


def note_series_revived(label_value: str) -> None:
    """Called by legitimate re-registration paths (an instance with the
    same name re-registers after eviction): clear tombstones carrying
    this label value so the entity's fresh series are not misreported
    as resurrections."""
    if not _DEBUG:
        return
    with _lbal_lock:
        for t in [t for t in _tombstones if label_value in t[1]]:
            _tombstones.discard(t)
