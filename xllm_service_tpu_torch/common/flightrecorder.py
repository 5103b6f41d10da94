"""Anomaly flight recorder (copy of
``xllm_service_tpu/common/flightrecorder.py``): bounded post-mortem bundles
for requests that went wrong.

At anomaly time (on the engine: a streamed KV handoff that fell back to
the inline path) a bundle snapshots the request's span tree from the
process's ``SpanStore`` (parked tail-sampled spans included) and whatever
context the process registered (the agent registers ``engine``: its load,
tier and transfer counters; the profiler registers ``profile``) into a
bounded ring served at ``GET /admin/flightrecorder/recent``, and, with a
directory configured, appended to ``flightrecorder.jsonl``. The
reference's bundles also carry the master's hot-path stage percentiles,
which an engine process does not record.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

#: Anomaly kinds (the ring's records and the JSONL use these values).
KINDS = ("slo_breach", "failover", "error", "kv_stream_fallback",
         "handoff_recovery")


class FlightRecorder:
    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(1, capacity))
        self._path: Optional[str] = None
        self._file = None
        self._file_lock = threading.Lock()
        # name -> zero-argument callable returning a JSON-able snapshot,
        # captured into every bundle; a provider's error is recorded in
        # place of its value.
        self._context: dict[str, Callable[[], Any]] = {}

    def configure(self, capacity: Optional[int] = None,
                  directory: Any = "__unset__") -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(1, capacity))
        if directory != "__unset__":
            with self._file_lock:
                if self._file is not None:
                    self._file.close()
                    self._file = None
                self._path = (os.path.join(directory, "flightrecorder.jsonl")
                              if directory else None)

    def add_context_provider(self, name: str,
                             fn: Callable[[], Any]) -> None:
        with self._lock:
            self._context[name] = fn

    def remove_context_provider(self, name: str,
                                fn: Optional[Callable[[], Any]] = None
                                ) -> None:
        """Deregister a provider. With `fn`, only while the slot still
        holds that callable (a newer owner of the name keeps its own)."""
        with self._lock:
            if fn is None or self._context.get(name) == fn:
                self._context.pop(name, None)

    def record(self, kind: str, request_id: str = "", trace_id: str = "",
               detail: Optional[dict[str, Any]] = None) -> dict[str, Any]:
        """Capture one anomaly bundle. Never raises: a failed capture logs
        and records what it got."""
        from .tracing import TRACER, span_tree

        bundle: dict[str, Any] = {
            "ts_ms": time.time() * 1000.0,
            "kind": kind,
            "request_id": request_id,
            "trace_id": trace_id,
            "detail": dict(detail or {}),
        }
        try:
            if not trace_id and request_id:
                trace_id = TRACER.store.trace_id_for_request(
                    request_id) or ""
                bundle["trace_id"] = trace_id
            if trace_id:
                spans = TRACER.store.trace(trace_id)
                bundle["num_spans"] = len(spans)
                bundle["trace"] = span_tree(spans)
            with self._lock:
                providers = list(self._context.items())
            for name, fn in providers:
                try:
                    bundle[name] = fn()
                except Exception as e:  # noqa: BLE001 — keep the bundle
                    bundle[name] = {"error": str(e)}
        except Exception:  # noqa: BLE001 — capture is best effort
            logger.exception("flight-recorder capture failed (%s)", kind)
        with self._lock:
            self._ring.append(bundle)
        self._dump(bundle)
        return bundle

    def _dump(self, bundle: dict[str, Any]) -> None:
        if self._path is None:
            return
        try:
            line = json.dumps(bundle, default=str)
            with self._file_lock:
                if self._file is None:
                    os.makedirs(os.path.dirname(self._path), exist_ok=True)
                    self._file = open(self._path, "a", buffering=1)
                self._file.write(line + "\n")
        except (OSError, TypeError, ValueError):
            logger.exception("flight-recorder JSONL append failed")

    def recent(self, limit: int = 20,
               kind: str = "") -> list[dict[str, Any]]:
        """Newest first."""
        with self._lock:
            records = list(self._ring)
        if kind:
            records = [r for r in records if r.get("kind") == kind]
        return records[-max(0, int(limit)):][::-1]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        with self._file_lock:
            if self._file is not None:
                self._file.close()
                self._file = None


#: The process's recorder.
RECORDER = FlightRecorder()


def admin_flightrecorder_recent(query: dict[str, str]) -> tuple[int, dict]:
    """``GET /admin/flightrecorder/recent[?limit=N&kind=...]``: (status,
    payload), newest first."""
    try:
        limit = int(query.get("limit", 20))
    except ValueError:
        return 400, {"error": "limit must be an integer"}
    records = RECORDER.recent(limit=limit, kind=query.get("kind", ""))
    return 200, {"num_records": len(records), "records": records}
