"""End-to-end request tracing on the engine's side (copy of
``xllm_service_tpu/common/tracing.py``): hop-propagated spans with a live
query surface.

A trace context (``trace_id``, ``span_id``) comes from the master in the
enriched dispatch (``trace_context``) or in the ``x-xllm-trace-id`` /
``x-xllm-parent-span-id`` headers, and every engine-side stage records a
:class:`Span` under it into a bounded in-memory ring (:class:`SpanStore`):
``engine.prefill`` (accept to first token), ``engine.decode`` (first token
to finish) and the PD transfer's ``kv_transfer.offer`` and
``kv_transfer.pull``. The agent serves the store at ``/admin/trace`` and
``/admin/trace/recent`` (:func:`query_trace`, :func:`query_recent`); the
master's ``?scope=fleet`` view fans out to them and merges.

:func:`add_event` stamps an event onto the calling thread's active span
(entered with ``with TRACER.span(...)``); the fault plane calls it on
every rule that fires. A span that is only started and ended (the stage
spans, ended on whichever thread delivers the first token or the finish)
never touches a thread's active stack.

With tracing disabled a span call is one attribute read and the shared
no-op span; enabled, a span costs one append into the ring under a leaf
lock.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass
from hashlib import blake2b
from typing import Any, Callable, Optional

from ..devtools import lifecycle as _lifecycle
from ..devtools.locks import make_lock
from ..utils import get_logger

logger = get_logger(__name__)

#: Registry of every span point compiled into the request path. xlint's
#: span-point rule enforces the bidirectional contract: every
#: ``TRACER.span("name")``/``TRACER.start_span("name")`` call site must name
#: a point registered here, and every registered point must have at least
#: one live call site (no dead span points).
SPAN_POINTS: dict[str, str] = {
    "frontend.request": "http_service/service.py root span per API request "
                        "(fallback-created in scheduler.schedule for "
                        "direct-scheduler callers)",
    "scheduler.schedule": "scheduler dispatch: template + tokenize + route "
                          "+ incarnation bind",
    "scheduler.template": "chat-template apply sub-stage of schedule",
    "scheduler.tokenize": "prompt tokenization sub-stage of schedule",
    "scheduler.route": "LB-policy pair selection sub-stage of schedule "
                       "(lock-free routing-snapshot read)",
    "scheduler.bind": "incarnation bind + RCU re-validation sub-stage of "
                      "schedule",
    "scheduler.failover": "one transparent-failover re-dispatch attempt; "
                          "children are the replayed engine spans",
    "engine.prefill": "engine-side prefill stage (accept -> first delta)",
    "engine.decode": "engine-side decode stage (first delta -> finish)",
    "kv_transfer.offer": "prefill-side KV offer/handoff to the decode peer",
    "kv_transfer.pull": "decode-side device KV pull",
    "autoscaler.tick": "one autoscaler enactment pass (only ticks that "
                       "act record a span; attrs carry the action kinds)",
}

#: Wire header names (RPC channel hop).
TRACE_ID_HEADER = "x-xllm-trace-id"
PARENT_SPAN_HEADER = "x-xllm-parent-span-id"


def _now_ms() -> float:
    return time.time() * 1000.0


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """What a downstream hop needs to parent its spans: `span_id` is the
    sender's span, the receiver's `parent_span_id`."""

    trace_id: str
    span_id: str

    def to_dict(self) -> dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d: Any) -> Optional["TraceContext"]:
        """Tolerant parse of the `trace_context` wire key (None or a
        malformed value: no parenting)."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not tid or not sid:
            return None
        return cls(trace_id=str(tid), span_id=str(sid))

    def to_headers(self) -> dict[str, str]:
        return {TRACE_ID_HEADER: self.trace_id,
                PARENT_SPAN_HEADER: self.span_id}

    @classmethod
    def from_headers(cls, headers: Any) -> Optional["TraceContext"]:
        try:
            tid = headers.get(TRACE_ID_HEADER)
            sid = headers.get(PARENT_SPAN_HEADER)
        except AttributeError:
            return None
        if not tid or not sid:
            return None
        return cls(trace_id=str(tid), span_id=str(sid))


# Thread-local stack of entered spans (innermost last).
_tls = threading.local()


def _active_stack() -> list["Span"]:
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    return stack


def current_span() -> Optional["Span"]:
    stack = _active_stack()
    return stack[-1] if stack else None


def current_context() -> Optional[TraceContext]:
    sp = current_span()
    return sp.context() if sp is not None else None


def current_headers() -> dict[str, str]:
    """Propagation headers of the calling thread's active span ({} when
    none; the master's engine channel stamps them on every call)."""
    ctx = current_context()
    return ctx.to_headers() if ctx is not None else {}


def add_event(name: str, **attrs: Any) -> None:
    """Stamp an event onto the calling thread's active span (no-op without
    one)."""
    sp = current_span()
    if sp is not None:
        sp.event(name, **attrs)


class Span:
    """One timed hop of a request. Entering it (``with``) makes it the
    thread's active span; exit ends it. `end()` records the span at its
    first call and is a no-op after."""

    __slots__ = ("point", "trace_id", "span_id", "parent_span_id",
                 "request_id", "instance", "start_ms", "end_ms", "status",
                 "attrs", "events", "_tracer")

    def __init__(self, tracer: "Tracer", point: str,
                 ctx: Optional[TraceContext], request_id: str,
                 instance: str, attrs: dict[str, Any]):
        self._tracer = tracer
        self.point = point
        self.trace_id = ctx.trace_id if ctx else _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_span_id = ctx.span_id if ctx else ""
        self.request_id = request_id
        self.instance = instance
        self.start_ms = _now_ms()
        self.end_ms: Optional[float] = None
        self.status = "OK"
        self.attrs = attrs
        self.events: list[dict[str, Any]] = []

    def context(self) -> TraceContext:
        """Context for children of this span."""
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        ev: dict[str, Any] = {"ts_ms": _now_ms(), "name": name}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def end(self, status: Optional[str] = None) -> None:
        if self.end_ms is not None:
            return
        if status is not None:
            self.status = status
        self.end_ms = _now_ms()
        self._tracer._record(self)

    def duration_ms(self) -> float:
        return (self.end_ms if self.end_ms is not None
                else _now_ms()) - self.start_ms

    def to_dict(self) -> dict[str, Any]:
        return {
            "point": self.point,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "request_id": self.request_id,
            "instance": self.instance,
            "start_ms": self.start_ms,
            "end_ms": self.end_ms,
            "duration_ms": round(self.duration_ms(), 3),
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }

    def __enter__(self) -> "Span":
        _active_stack().append(self)
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        stack = _active_stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self.end("ERROR: " + repr(exc) if exc is not None else None)


class _NoopSpan:
    """The shared do-nothing span of disabled tracing and of requests that
    carry no context."""

    __slots__ = ()

    def context(self) -> None:
        return None

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self, status: Optional[str] = None) -> None:
        pass

    def duration_ms(self) -> float:
        return 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class SpanStore:
    """Bounded ring of finished spans, indexed by trace_id and request_id.
    Eviction is FIFO over spans; a trace leaves the index with its last
    span.

    Tail sampling: spans of sampled-out traces park in a bounded side
    buffer (whole traces, FIFO evicted) instead of the ring. `promote()`
    moves a parked trace into the ring (the request ended anomalously);
    `drop()` discards it. Parked spans stay queryable by trace_id."""

    def __init__(self, capacity: int = 2048):
        self.capacity = max(1, int(capacity))
        self._lock = make_lock("tracing.span_store", order=820)  # lock-order: 820
        self._ring: deque[Span] = deque()
        self._by_trace: dict[str, list[Span]] = {}
        # request_id -> trace_id, insertion-ordered for bounded eviction.
        self._req_index: OrderedDict[str, str] = OrderedDict()
        self._pending: OrderedDict[str, list[Span]] = OrderedDict()
        self._pending_traces_cap = max(16, self.capacity // 4)

    def _index_request(self, span: Span) -> None:
        if span.request_id:
            self._req_index[span.request_id] = span.trace_id
            self._req_index.move_to_end(span.request_id)
            while len(self._req_index) > 4 * self.capacity:
                self._req_index.popitem(last=False)

    def add(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            self._by_trace.setdefault(span.trace_id, []).append(span)
            self._index_request(span)
            while len(self._ring) > self.capacity:
                old = self._ring.popleft()
                spans = self._by_trace.get(old.trace_id)
                if spans is not None:
                    try:
                        spans.remove(old)
                    except ValueError:
                        pass
                    if not spans:
                        self._by_trace.pop(old.trace_id, None)

    def add_pending(self, span: Span) -> None:
        """Park a sampled-out trace's span until its tail verdict."""
        with self._lock:
            spans = self._pending.get(span.trace_id)
            if spans is None:
                spans = self._pending[span.trace_id] = []
                _lifecycle.note_acquire("span-pending", key=span.trace_id)
                while len(self._pending) > self._pending_traces_cap:
                    old_tid, _ = self._pending.popitem(last=False)
                    _lifecycle.note_release("span-pending", key=old_tid)
            spans.append(span)
            self._index_request(span)

    def promote(self, trace_id: str) -> None:
        """Tail-based keep: move a parked trace into the ring."""
        with self._lock:
            spans = self._pending.pop(trace_id, None)
            if spans is not None:
                _lifecycle.note_release("span-pending", key=trace_id)
        for s in spans or ():
            self.add(s)

    def drop(self, trace_id: str) -> None:
        """Tail-based drop: the request ended cleanly."""
        with self._lock:
            if self._pending.pop(trace_id, None) is not None:
                _lifecycle.note_release("span-pending", key=trace_id)

    def has_pending(self) -> bool:
        return bool(self._pending)

    def trace(self, trace_id: str) -> list[dict[str, Any]]:
        with self._lock:
            spans = list(self._by_trace.get(trace_id, ()))
            spans += self._pending.get(trace_id, ())
        return [s.to_dict() for s in sorted(spans, key=lambda s: s.start_ms)]

    def trace_id_for_request(self, request_id: str) -> Optional[str]:
        with self._lock:
            return self._req_index.get(request_id)

    def summaries(self, limit: int = 20,
                  sort: str = "recent") -> list[dict[str, Any]]:
        """Per-trace one-liners, latest start first ("recent") or longest
        first ("slowest")."""
        with self._lock:
            traces = {tid: list(spans)
                      for tid, spans in self._by_trace.items()}
        rows = []
        for tid, spans in traces.items():
            start = min(s.start_ms for s in spans)
            end = max(s.end_ms if s.end_ms is not None else s.start_ms
                      for s in spans)
            root = next((s for s in spans if not s.parent_span_id), None)
            rid = next((s.request_id for s in spans if s.request_id), "")
            rows.append({
                "trace_id": tid,
                "request_id": rid,
                "root_point": root.point if root else "",
                "start_ms": start,
                "duration_ms": round(end - start, 3),
                "num_spans": len(spans),
                "status": (root.status if root else "OK"),
            })
        key = "duration_ms" if sort == "slowest" else "start_ms"
        rows.sort(key=lambda r: r[key], reverse=True)
        return rows[:max(0, int(limit))]

    def recent_trace_spans(self, limit: int = 50) -> list[list[dict]]:
        """Span dicts of the most recently started traces (newest last) —
        the /admin/hotpath critical-path aggregation input."""
        with self._lock:
            traces = [(min(s.start_ms for s in spans), list(spans))
                      for spans in self._by_trace.values() if spans]
        traces.sort(key=lambda t: t[0])
        return [[s.to_dict() for s in spans]
                for _, spans in traces[-max(1, int(limit)):]]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_trace.clear()
            self._req_index.clear()
            self._pending.clear()
        _lifecycle.note_reset("span-pending")


def span_tree(spans: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Flat span dicts as a parent/children forest, children by start
    time. A span whose parent is not among them is a root."""
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: list[dict[str, Any]] = []
    for s in sorted(by_id.values(), key=lambda s: s["start_ms"]):
        parent = by_id.get(s["parent_span_id"])
        if parent is not None and parent is not s:
            parent["children"].append(s)
        else:
            roots.append(s)
    return roots


class Tracer:
    """The process's tracer. `enabled=False` turns every span call into a
    no-op.

    `sample_rate` < 1.0 samples at the head with a tail-based keep: the
    verdict is a hash of the trace_id (every process of the fleet keeps
    the same traces), sampled-out spans park in the store's side buffer,
    and `keep_trace()` (a failover, an error, a fallback) promotes them;
    `drop_trace()` discards a clean exit."""

    def __init__(self, capacity: int = 2048):
        self.enabled = True
        self.sample_rate = 1.0
        self.store = SpanStore(capacity)
        # Called with each recorded span's dict (the master's request
        # tracer mirrors spans into its JSONL file).
        self._mirror: Optional[Callable[[dict[str, Any]], None]] = None
        # Traces kept by a tail decision: their later spans go straight to
        # the ring. Bounded ordered set.
        self._kept: OrderedDict[str, None] = OrderedDict()

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  mirror: Any = "__unset__",
                  sample_rate: Optional[float] = None) -> None:
        if enabled is not None:
            self.enabled = enabled
        if capacity is not None and capacity != self.store.capacity:
            self.store = SpanStore(capacity)
        if mirror != "__unset__":
            self._mirror = mirror
        if sample_rate is not None:
            self.sample_rate = min(1.0, max(0.0, float(sample_rate)))

    def is_sampled(self, trace_id: str) -> bool:
        """Deterministic head-sampling verdict of a trace."""
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        h = int.from_bytes(blake2b(trace_id.encode(),
                                   digest_size=8).digest(), "big")
        return (h % 1_000_000) < rate * 1_000_000

    def keep_trace(self, trace_id: str) -> None:
        """Tail-based keep: promote the trace's parked spans and record
        its later ones."""
        if not trace_id:
            return
        if self.sample_rate >= 1.0 and not self.store.has_pending():
            # Everything records directly; a non-empty side buffer means
            # the rate was raised live, and its traces still need a verdict.
            return
        self._kept[trace_id] = None
        while len(self._kept) > 1024:
            self._kept.popitem(last=False)
        self.store.promote(trace_id)

    def drop_trace(self, trace_id: str) -> None:
        """Tail-based drop: clean exit of a sampled-out trace."""
        if not trace_id:
            return
        if self.sample_rate >= 1.0 and not self.store.has_pending():
            return
        if trace_id not in self._kept:
            self.store.drop(trace_id)

    def start_span(self, point: str, ctx: Optional[TraceContext] = None,
                   request_id: str = "", instance: str = "",
                   require_ctx: bool = False, **attrs: Any):
        """A new span (recorded at `end()`). Without `ctx` it roots a new
        trace, unless `require_ctx` is set: then the no-op span (a request
        that carried no context gets no orphan trace)."""
        if not self.enabled or (require_ctx and ctx is None):
            return NOOP_SPAN
        return Span(self, point, ctx, request_id, instance, attrs)

    # The name call sites use for a span entered with ``with``.
    span = start_span

    def _record(self, span: Span) -> None:
        if not self.enabled:
            return
        if self.sample_rate >= 1.0 or span.trace_id in self._kept \
                or self.is_sampled(span.trace_id):
            self.store.add(span)
        else:
            self.store.add_pending(span)
        mirror = self._mirror
        if mirror is not None:
            try:
                mirror(span.to_dict())
            except Exception:  # noqa: BLE001 — tracing never breaks a request
                logger.exception("span mirror failed")

    def query_trace(self, request_id: str = "",
                    trace_id: str = "") -> tuple[int, dict[str, Any]]:
        """The ``/admin/trace`` answer: (HTTP status, payload)."""
        tid = trace_id
        if not tid and request_id:
            tid = self.store.trace_id_for_request(request_id) or ""
        if not tid:
            return 404, {"error": "unknown request_id (pass request_id= or "
                                  "trace_id=)"}
        spans = self.store.trace(tid)
        if not spans:
            return 404, {"error": f"no spans recorded for trace {tid}"}
        from ..profiling.critical_path import critical_path

        payload = {"trace_id": tid,
                   "request_id": request_id
                   or next((s["request_id"] for s in spans
                            if s["request_id"]), ""),
                   "num_spans": len(spans),
                   "spans": spans,
                   "tree": span_tree(spans)}
        cp = critical_path(spans)
        if cp is not None:
            payload["critical_path"] = cp
        return 200, payload

    def query_recent(self, limit: int = 20,
                     sort: str = "recent") -> dict[str, Any]:
        if sort not in ("recent", "slowest"):
            sort = "recent"
        return {"sort": sort, "traces": self.store.summaries(limit, sort)}


#: The process's tracer: enabled, with a modest ring.
TRACER = Tracer()


def merge_fleet_spans(span_lists: list[list[dict[str, Any]]]
                      ) -> list[dict[str, Any]]:
    """Per-process span dicts of one trace as one list ordered by start,
    deduplicated by span_id."""
    seen: dict[str, dict[str, Any]] = {}
    for spans in span_lists:
        for s in spans:
            sid = s.get("span_id", "")
            if sid and sid not in seen:
                seen[sid] = s
    return sorted(seen.values(), key=lambda s: s.get("start_ms", 0.0))


def admin_trace(query: dict[str, str],
                tracer: Optional[Tracer] = None) -> tuple[int, dict]:
    """``GET /admin/trace?request_id=...|trace_id=...``: (status,
    payload)."""
    return (tracer or TRACER).query_trace(
        request_id=query.get("request_id", ""),
        trace_id=query.get("trace_id", ""))


def admin_trace_recent(query: dict[str, str],
                       tracer: Optional[Tracer] = None) -> tuple[int, dict]:
    """``GET /admin/trace/recent[?sort=slowest&limit=N]``: (status,
    payload)."""
    try:
        limit = int(query.get("limit", 20))
    except ValueError:
        return 400, {"error": "limit must be an integer"}
    return 200, (tracer or TRACER).query_recent(
        limit=limit, sort=query.get("sort", "recent"))
