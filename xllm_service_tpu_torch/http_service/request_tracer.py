"""Opt-in request I/O tracing.

Parity: reference `http_service/request_tracer.{h,cpp}` — appends
`{timestamp, service_request_id, data}` JSONL under a mutex, gated by
`--enable_request_trace` (`request_tracer.cpp:38-61`).

Beyond the reference (which reopens the file for every record — an
open/append/close syscall triple per log call): the handle is opened once
and kept line-buffered (each record still lands on disk at its newline, so
live `tail -f`/test reads see records immediately, but the per-record
open/close churn is gone), with an explicit `close()`/`flush()` invoked
from service cleanup. Output is `trace.jsonl` (it always was JSONL);
a directory that already holds a legacy `trace.json` keeps appending
there so old dirs stay readable with one file to look at.
"""

from __future__ import annotations

import threading

import json
import time
from pathlib import Path
from typing import Any, Optional, TextIO

from ..devtools.locks import make_lock


class RequestTracer:
    def __init__(self, trace_dir: str = "trace", enabled: bool = False):
        self._enabled = enabled
        self._lock = make_lock("request_tracer.file", order=70)  # lock-order: 70
        d = Path(trace_dir)
        legacy = d / "trace.json"
        self._path = legacy if legacy.exists() else d / "trace.jsonl"
        self._fh: Optional[TextIO] = None
        if enabled:
            self._path.parent.mkdir(parents=True, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def path(self) -> Path:
        return self._path

    def log(self, service_request_id: str, data: Any) -> None:
        if not self._enabled:
            return
        rec = {"timestamp": int(time.time() * 1000),
               "service_request_id": service_request_id,
               "data": data}
        line = json.dumps(rec, ensure_ascii=False) + "\n"
        with self._lock:
            if self._fh is None:
                # Lazy (re)open: first record, or a straggler logged on an
                # output lane after cleanup closed the handle.
                self._fh = self._path.open("a", buffering=1)
            self._fh.write(line)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
