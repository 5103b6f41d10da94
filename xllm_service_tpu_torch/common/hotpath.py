"""Always-on per-stage latency recorder for the master hot path.

The span-tracing plane (common/tracing.py) attributes individual requests
but costs a ring insert per span and can be disabled; capacity planning
needs a cheap aggregate that is ALWAYS there. This recorder is two
``perf_counter`` reads and a bounded-deque append per stage (appends on
``collections.deque`` are atomic under the GIL — no lock on the write
path), served by ``GET /admin/hotpath`` on the master and read by
serve_bench / master_hotpath_bench for their per-stage tables.

Stages (the four legs of the client-observed master+wire TTFT span):

========== ==========================================================
stage      measures
========== ==========================================================
schedule   executor hop + Scheduler.schedule (template/tokenize/route/
           bind) — sub-attributed by tracing spans when enabled
enrich     dispatch payload build + wire serialization
forward    engine dispatch POST (accept round trip)
first_delta engine accept -> first Generations delta ingested
========== ==========================================================
"""

from __future__ import annotations

from collections import deque
from typing import Any

#: Stage names in hot-path order (the admin endpoint and the bench tables
#: render in this order).
STAGES = ("schedule", "enrich", "forward", "first_delta")

_WINDOW = 2048   # per-stage sample window (bounded memory, recent view)


class HotpathRecorder:
    """Bounded per-stage sample windows with percentile summaries."""

    def __init__(self, window: int = _WINDOW):
        self._samples: dict[str, deque] = {
            s: deque(maxlen=window) for s in STAGES}

    def record(self, stage: str, ms: float) -> None:
        q = self._samples.get(stage)
        if q is not None:
            q.append(ms)

    @staticmethod
    def _pct(xs: list, p: float) -> float:
        if not xs:
            return 0.0
        xs = sorted(xs)
        k = min(len(xs) - 1, int(round((p / 100) * (len(xs) - 1))))
        return xs[k]

    def summary(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for stage in STAGES:
            xs = list(self._samples[stage])
            out[stage] = {
                "n": len(xs),
                "p50": round(self._pct(xs, 50), 3),
                "p90": round(self._pct(xs, 90), 3),
                "p99": round(self._pct(xs, 99), 3),
            }
        return out

    def clear(self) -> None:
        for q in self._samples.values():
            q.clear()


#: Process-global recorder (the master is one process; the engine agent
#: has its own ttft_spans surface).
HOTPATH = HotpathRecorder()


class CpuAttribution:
    """Per-category CPU-second accounting for the master process
    (ingest = heartbeat/telemetry-frame ingest, route = schedule
    [template/tokenize/route/bind], stream = generation-delta ingest).

    The bench divides these by the process's total /proc CPU to get the
    ingest/route/stream shares. Each
    measurement is two ``thread_time`` reads (CPU time of the CURRENT
    thread — correct on executor threads, immune to wall-clock blocking)
    and one float add; totals are plain floats mutated under the GIL —
    a torn read of a monotonically-growing total is off by at most one
    sample, which is noise at bench scale."""

    CATEGORIES = ("ingest", "route", "stream")

    def __init__(self):
        self._totals = {c: 0.0 for c in self.CATEGORIES}
        self._counts = {c: 0 for c in self.CATEGORIES}
        self._exported = {c: 0.0 for c in self.CATEGORIES}

    def measure(self, category: str):
        return _CpuSpan(self, category)

    def add(self, category: str, seconds: float) -> None:
        if category in self._totals:
            self._totals[category] += seconds
            self._counts[category] += 1

    def summary(self) -> dict[str, Any]:
        return {c: {"cpu_s": round(self._totals[c], 4),
                    "n": self._counts[c]}
                for c in self.CATEGORIES}

    def export_counters(self) -> None:
        """Publish the delta since the last export to the Prometheus
        ``hotpath_cpu_seconds_total{loop}`` counter — called from the
        master's scrape-time gauge refresh, so /metrics and
        /metrics/fleet carry the loop-level CPU series without a
        background thread."""
        from .metrics import HOTPATH_CPU_SECONDS

        for c in self.CATEGORIES:
            delta = self._totals[c] - self._exported[c]
            if delta > 0:
                HOTPATH_CPU_SECONDS.labels(loop=c).inc(delta)
                self._exported[c] += delta

    def clear(self) -> None:
        for c in self.CATEGORIES:
            self._totals[c] = 0.0
            self._counts[c] = 0
            self._exported[c] = 0.0


class _CpuSpan:
    __slots__ = ("_attr", "_cat", "_t0")

    def __init__(self, attr: CpuAttribution, category: str):
        self._attr = attr
        self._cat = category

    def __enter__(self):
        import time

        self._t0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        import time

        self._attr.add(self._cat, time.thread_time() - self._t0)


#: Process-global CPU attribution (served by /admin/hotpath; read by
#: master_hotpath_bench's ingest-share report).
CPU_ATTR = CpuAttribution()
