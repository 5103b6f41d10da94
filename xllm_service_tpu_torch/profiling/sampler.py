"""Always-on wall-clock sampling profiler with per-thread-role folding
(copy of ``xllm_service_tpu/profiling/sampler.py``).

A daemon thread (``profiler-sampler``) walks ``sys._current_frames()`` at
about 19 Hz (a rate that does not phase-lock with periodic loops) and
folds each thread's stack into a bounded aggregate per thread role. The
roles are :data:`THREAD_ROLES`, the port's own table of its threads;
other threads group under their thread-name stem. Aggregates rotate every
``window_s``: the last complete window stays queryable beside the live
one, and :meth:`SamplingProfiler.anomaly_context` puts it into every
flight-recorder bundle (the ``profile`` provider, while the sampler
runs).

Served at ``GET /admin/profile`` as a top-N JSON summary and, with
``?format=folded``, as flamegraph folded stacks (``role;frame;...;leaf
N``), which the master's ``?scope=fleet`` view merges with
:func:`parse_folded`. A tick holds the GIL for one ``_current_frames``
walk and a memoized label lookup per frame. Start and stop are
refcounted.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Optional

from ..devtools import lifecycle as _lifecycle
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..utils import get_logger

logger = get_logger(__name__)

#: The port's threads by role: role -> thread-name prefixes.
THREAD_ROLES: dict[str, tuple[str, ...]] = {
    "engine-pump": ("engine-loop",),       # InferenceEngine._loop
    "streamer": ("gen-streamer",),         # GenerationStreamer._loop
    "heartbeat": ("agent-heartbeat",),     # EngineAgent._heartbeat_loop
    "http": ("agent-http", "agent-handler"),   # accept loop, handlers
    "kv-tier": ("kv-tier",),               # TieredKVStore workers
    "kv-transfer": ("kv-pull", "kv-transfer"),  # PD pulls and handoffs
}

#: Aggregate bucket charged once a role's distinct-stack table is full —
#: memory stays bounded at any churn, and the overflow is visible rather
#: than silently dropped.
OVERFLOW_FRAME = "(overflow)"

#: Role assigned to the main thread (it matches no THREAD_ROLES prefix
#: but stands for whatever a test or a script runs there).
MAIN_ROLE = "main"

#: Role-table bound: samples from threads beyond this many distinct
#: roles aggregate under ``(otherrole)`` — role cardinality (not just
#: per-role stacks) stays bounded under adversarial thread naming.
MAX_ROLES = 64

_LABEL_CACHE_MAX = 4096


def _role_prefixes() -> list[tuple[str, str]]:
    """(thread-name prefix, role) rows of :data:`THREAD_ROLES`."""
    return [(prefix, role) for role, prefixes in THREAD_ROLES.items()
            for prefix in prefixes]


def _name_stem(name: str) -> str:
    """Fallback role for unregistered threads: the thread-name stem with
    trailing pool/worker numbering stripped (``ThreadPoolExecutor-0_3``
    -> ``ThreadPoolExecutor``). CPython's default ``Thread-N (target)``
    names collapse to the target — per-request worker threads must
    aggregate under one role, not one role per thread."""
    if name.startswith("Thread-") and name.endswith(")"):
        lp = name.find("(")
        if lp != -1 and name[lp + 1:-1]:
            return name[lp + 1:-1]
    stem = name
    while stem and stem[-1] in "0123456789-_ ":
        stem = stem[:-1]
    return stem or "other"


@_ownership.verify_state
class SamplingProfiler:
    """Refcounted process-global sampling profiler (see module doc)."""

    def __init__(self) -> None:
        self._lock = make_lock("profiling.sampler", order=824)  # lock-order: 824
        self._refs = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt: Optional[threading.Event] = None
        self._hz = 19.0
        self._window_s = 30.0
        self._max_stacks = 256
        self._max_depth = 24
        # Live window: role -> {stack tuple (root..leaf) -> count}.
        self._agg: dict[str, dict[tuple, int]] = {}
        self._ticks = 0
        self._window_started = time.monotonic()
        # Last complete window (the anomaly snapshot's preferred source).
        self._prev: dict[str, dict[tuple, int]] = {}
        self._prev_ticks = 0
        self._prev_window_s = 0.0
        # Sampler-thread heartbeat (liveness surfaced in snapshots).
        self._last_tick_mono = 0.0
        # Per-code-object label memo (sampler thread only mutates it; a
        # bounded dict keyed by the code objects themselves).
        self._label_cache: dict[Any, str] = {}
        self._roles = _role_prefixes()

    # ------------------------------------------------------------ lifecycle
    def configure(self, hz: Optional[float] = None,
                  window_s: Optional[float] = None,
                  max_stacks: Optional[int] = None,
                  max_depth: Optional[int] = None) -> None:
        """Apply options. ``hz <= 0`` disables sampling (the next start()
        spawns no thread); a running sampler keeps its spawn-time rate
        but honors the new window/bounds at the next merge."""
        with self._lock:
            if hz is not None:
                self._hz = float(hz)
            if window_s is not None:
                self._window_s = max(1.0, float(window_s))
            if max_stacks is not None:
                self._max_stacks = max(16, int(max_stacks))
            if max_depth is not None:
                self._max_depth = max(2, int(max_depth))

    def start(self) -> None:
        """Refcounted start: the first owner with a positive rate spawns
        the ``profiler-sampler`` thread and registers the flight-recorder
        ``profile`` context provider; later owners only take a ref."""
        spawned = None
        with self._lock:
            self._refs += 1
            if self._thread is None and self._hz > 0:
                evt = threading.Event()
                t = threading.Thread(
                    target=self._loop,
                    args=(evt, max(0.5, self._hz)),
                    name="profiler-sampler", daemon=True)
                self._stop_evt = evt
                self._thread = t
                self._window_started = time.monotonic()
                spawned = t
        if spawned is not None:
            _lifecycle.note_acquire("profiler-thread")
            from ..common.flightrecorder import RECORDER

            RECORDER.add_context_provider("profile", self.anomaly_context)
            spawned.start()

    def stop(self) -> None:
        """Refcounted stop: the last owner joins the sampler thread and
        deregisters the anomaly provider. Idempotent — a stop with no
        outstanding start is a no-op."""
        joined = None
        with self._lock:
            if self._refs == 0:
                return
            self._refs -= 1
            if self._refs:
                return
            joined = self._thread
            evt = self._stop_evt
            self._thread = None
            self._stop_evt = None
            if evt is not None:
                evt.set()
        if joined is not None:
            joined.join(timeout=5.0)
            from ..common.flightrecorder import RECORDER

            RECORDER.remove_context_provider("profile", self.anomaly_context)
            _lifecycle.note_release("profiler-thread")

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    # ------------------------------------------------------------- sampling
    def _loop(self, stop_evt: threading.Event, hz: float) -> None:
        interval = 1.0 / hz
        own_ident = threading.get_ident()
        while not stop_evt.wait(interval):
            self._last_tick_mono = time.monotonic()
            try:
                self._sample_once(own_ident)
            except Exception:  # noqa: BLE001 — the sampler must outlive any one bad tick
                logger.exception("profiler sample tick failed")

    def _sample_once(self, own_ident: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        ticks: list[tuple[str, tuple]] = []
        for ident, frame in sys._current_frames().items():
            if ident == own_ident:
                continue
            name = names.get(ident)
            if name is None:
                continue   # a thread born between enumerate() and here
            ticks.append((self._role_of(name), self._fold(frame)))
        self._merge(ticks, time.monotonic())

    def _merge(self, ticks: list[tuple[str, tuple]], now: float) -> None:
        """Fold one tick's (role, stack) samples into the live window,
        bounded per role at ``_max_stacks`` distinct stacks (the rest is
        charged to a visible overflow bucket), rotating the window on
        the ``_window_s`` cadence."""
        with self._lock:
            self._ticks += 1
            max_stacks = self._max_stacks
            for role, stack in ticks:
                stacks = self._agg.get(role)
                if stacks is None:
                    if len(self._agg) >= MAX_ROLES:
                        role = "(otherrole)"
                        stacks = self._agg.setdefault(role, {})
                    else:
                        stacks = {}
                        self._agg[role] = stacks
                if stack in stacks:
                    stacks[stack] += 1
                elif len(stacks) < max_stacks:
                    stacks[stack] = 1
                else:
                    key = (OVERFLOW_FRAME,)
                    stacks[key] = stacks.get(key, 0) + 1
            if now - self._window_started >= self._window_s:
                self._rotate_locked(now)

    def _role_of(self, name: str) -> str:
        if name == "MainThread":
            return MAIN_ROLE
        for prefix, role in self._roles:
            if name.startswith(prefix):
                return role
        return _name_stem(name)

    def _fold(self, frame: Any) -> tuple:
        """Leaf frame -> bounded (root..leaf) label tuple. Labels memoize
        per code object; deep stacks keep the leaf side."""
        cache = self._label_cache
        labels: list[str] = []
        depth = self._max_depth
        f = frame
        while f is not None and len(labels) < depth:
            code = f.f_code
            label = cache.get(code)
            if label is None:
                base = code.co_filename.rsplit("/", 1)[-1]
                qual = getattr(code, "co_qualname", code.co_name)
                label = f"{base}:{qual}".replace(";", ":").replace(" ", "")
                if len(cache) < _LABEL_CACHE_MAX:
                    cache[code] = label
            labels.append(label)
            f = f.f_back
        labels.reverse()
        return tuple(labels)

    def _rotate_locked(self, now: float) -> None:
        self._prev = self._agg
        self._prev_ticks = self._ticks
        self._prev_window_s = now - self._window_started
        self._agg = {}
        self._ticks = 0
        self._window_started = now

    # -------------------------------------------------------------- reading
    def _merged_locked(self) -> dict[tuple, int]:
        """(role, frame..., leaf) -> count over prev + live windows."""
        merged: dict[tuple, int] = {}
        for window in (self._prev, self._agg):
            for role, stacks in window.items():
                for stack, n in stacks.items():
                    key = (role,) + stack
                    merged[key] = merged.get(key, 0) + n
        return merged

    def snapshot(self, top_n: int = 30) -> dict[str, Any]:
        """Top-N JSON view over the last two windows (the live one plus
        the last complete one)."""
        now = time.monotonic()
        with self._lock:
            merged = self._merged_locked()
            meta = {
                "enabled": self._thread is not None,
                "hz": self._hz,
                "window_s": self._window_s,
                "ticks": self._ticks + self._prev_ticks,
                "covered_s": round(
                    self._prev_window_s + (now - self._window_started), 3),
                "last_tick_age_s": round(
                    now - self._last_tick_mono, 3)
                if self._last_tick_mono else None,
            }
        out = summarize_stacks(merged, top_n=top_n)
        out.update(meta)
        return out

    def folded(self) -> str:
        """Flamegraph folded-stack text: one ``role;frame;...;leaf N``
        line per distinct stack (flamegraph.pl / speedscope input)."""
        with self._lock:
            merged = self._merged_locked()
        lines = [f"{';'.join(stack)} {n}"
                 for stack, n in sorted(merged.items())]
        return "\n".join(lines) + ("\n" if lines else "")

    def anomaly_context(self) -> dict[str, Any]:
        """Flight-recorder context provider: a compact profile of the
        last complete window (or the live one while the first window is
        still filling) — every breach/error/failover bundle carries it."""
        with self._lock:
            if self._thread is None:
                return {"enabled": False}
            window = self._prev or self._agg
            window_s = self._prev_window_s if self._prev else \
                (time.monotonic() - self._window_started)
            ticks = self._prev_ticks if self._prev else self._ticks
            merged: dict[tuple, int] = {}
            for role, stacks in window.items():
                for stack, n in stacks.items():
                    merged[(role,) + stack] = n
        summary = summarize_stacks(merged, top_n=12)
        return {
            "enabled": True,
            "window_s": round(window_s, 3),
            "ticks": ticks,
            "role_samples": {role: r["samples"]
                             for role, r in summary["roles"].items()},
            "top_frames": summary["top_frames"],
        }

    def clear(self) -> None:
        """Bench/test hook: drop both windows (bounds and rate keep)."""
        with self._lock:
            self._agg = {}
            self._prev = {}
            self._ticks = 0
            self._prev_ticks = 0
            self._prev_window_s = 0.0
            self._window_started = time.monotonic()


# --------------------------------------------------- folded-stack helpers
def parse_folded(text: str) -> dict[tuple, int]:
    """Inverse of :meth:`SamplingProfiler.folded` — the fleet merge path
    (counts sum exactly across peers, no top-N loss)."""
    out: dict[tuple, int] = {}
    for line in text.splitlines():
        stack_text, _, count_text = line.rpartition(" ")
        if not stack_text:
            continue
        try:
            n = int(count_text)
        except ValueError:
            continue
        key = tuple(stack_text.split(";"))
        out[key] = out.get(key, 0) + n
    return out


def summarize_stacks(counts: dict[tuple, int],
                     top_n: int = 30) -> dict[str, Any]:
    """Top-N summary of ``(role, frame..., leaf) -> count`` aggregates:
    per-role sample totals, hottest leaf frames (self samples), hottest
    stacks, and the cross-role frame table the CPU_ATTR alignment drill
    reads."""
    top_n = max(1, int(top_n))
    roles: dict[str, dict[str, Any]] = {}
    per_role_frames: dict[str, dict[str, int]] = {}
    per_role_stacks: dict[str, dict[tuple, int]] = {}
    global_frames: dict[str, int] = {}
    total = 0
    for key, n in counts.items():
        if not key:
            continue
        role = key[0]
        stack = key[1:]
        leaf = stack[-1] if stack else "(unknown)"
        total += n
        per_role_frames.setdefault(role, {})
        per_role_frames[role][leaf] = per_role_frames[role].get(leaf, 0) + n
        per_role_stacks.setdefault(role, {})
        per_role_stacks[role][stack] = \
            per_role_stacks[role].get(stack, 0) + n
        global_frames[leaf] = global_frames.get(leaf, 0) + n

    def top_items(d: dict, k: int) -> list:
        return sorted(d.items(), key=lambda kv: (-kv[1], str(kv[0])))[:k]

    for role, frames in per_role_frames.items():
        samples = sum(frames.values())
        roles[role] = {
            "samples": samples,
            "top_frames": [
                {"frame": frame, "self": n,
                 "pct": round(100.0 * n / samples, 2)}
                for frame, n in top_items(frames, top_n)],
            "top_stacks": [
                {"stack": ";".join(stack), "count": n}
                for stack, n in top_items(per_role_stacks[role], top_n)],
        }
    return {
        "samples": total,
        "roles": dict(sorted(roles.items())),
        "top_frames": [
            {"frame": frame, "self": n,
             "pct": round(100.0 * n / total, 2) if total else 0.0}
            for frame, n in top_items(global_frames, top_n)],
    }


#: The process's profiler (start and stop are refcounted).
PROFILER = SamplingProfiler()


def admin_profile(query: dict[str, str]) -> tuple[int, Any]:
    """``GET /admin/profile``: (status, the JSON summary), or with
    ``?format=folded`` (200, the folded-stack text); ``?top=N`` bounds
    the summary's tables."""
    try:
        top = int(query.get("top", 30))
    except ValueError:
        return 400, {"error": "top must be an integer"}
    if query.get("format") == "folded":
        return 200, PROFILER.folded()
    return 200, PROFILER.snapshot(top_n=top)
