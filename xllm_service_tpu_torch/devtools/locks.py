"""Lock factory with an opt-in race/deadlock detector.

``make_lock(name, order=N)`` is the project-wide replacement for bare
``threading.Lock()`` / ``threading.RLock()`` in the orchestration plane
(scheduler, instance manager, coordination, rpc, engine-side managers).

Normal mode (``XLLM_LOCK_DEBUG`` unset): returns a plain
``threading.Lock``/``RLock`` — zero overhead, byte-identical behavior.

Debug mode (``XLLM_LOCK_DEBUG=1``): returns an :class:`InstrumentedLock`
that

- records a per-thread stack of currently-held instrumented locks with the
  acquisition call stack and timestamp;
- flags **lock-order inversions**: acquiring a lock whose declared order is
  <= the order of any lock the thread already holds (the declared order is
  the ``order=N`` passed here, mirrored by the ``# lock-order: N`` source
  annotation xlint checks statically);
- flags **holds across fault-injection yield points**: every
  ``FAULTS.check``/``FAULTS.fire`` call site marks a spot where the code
  performs (or models) blocking I/O; if a thread crosses one while holding
  an instrumented lock for longer than ``XLLM_LOCK_HOLD_THRESHOLD_S``
  (default 0 — any hold counts), a violation is recorded. Wired into the
  fault plane via :func:`xllm_service_tpu_torch.common.faults.set_yield_hook`,
  so the chaos drills double as a blocking-under-lock detector.

Violations are recorded (never raised) so production code paths behave
identically; the pytest plugin
``xllm_service_tpu_torch.testing.debug_guard`` fails any test that
produced one when debug mode is on.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Union

from ..utils import get_logger

logger = get_logger(__name__)

_DEBUG = os.environ.get("XLLM_LOCK_DEBUG", "") not in ("", "0")
_HOLD_THRESHOLD_S = float(os.environ.get("XLLM_LOCK_HOLD_THRESHOLD_S", "0"))


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    """Test hook: toggles instrumentation for locks created AFTER the call
    (existing locks keep whatever mode they were built with)."""
    global _DEBUG
    _DEBUG = on
    if on:
        _install_yield_hook()


@dataclass
class LockViolation:
    kind: str            # "lock-order" | "held-across-yield"
    message: str
    thread: str
    stack: list[str] = field(default_factory=list)

    def __str__(self) -> str:
        return f"[{self.kind}] {self.message} (thread {self.thread})"


# Detector bookkeeping; never held across project locks.
_vlock = threading.Lock()   # lock-order: 900
_violations: list[LockViolation] = []


def violations() -> list[LockViolation]:
    with _vlock:
        return list(_violations)


def reset_violations() -> None:
    with _vlock:
        _violations.clear()


def _record(kind: str, message: str) -> None:
    v = LockViolation(kind=kind, message=message,
                      thread=threading.current_thread().name,
                      stack=traceback.format_stack(limit=16)[:-2])
    with _vlock:
        _violations.append(v)
    logger.error("lock violation: %s", v)


_tls = threading.local()


@dataclass
class _Held:
    lock: "InstrumentedLock"
    acquired_at: float
    stack: list[str]
    depth: int = 1   # re-entrant re-acquisitions bump this, not the list


def _held_list() -> list[_Held]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def held_locks() -> list[str]:
    """Names of instrumented locks the calling thread currently holds
    (outermost first) — diagnostic helper."""
    return [h.lock.name for h in _held_list()]


def thread_holds(lock: "InstrumentedLock") -> bool:
    """Does the calling thread currently hold this instrumented lock?
    (Identity check against the per-thread acquisition stack — the
    ownership state verifier's lock-held cross-check reads this.)"""
    return any(h.lock is lock for h in _held_list())


class InstrumentedLock:
    """Context-manager lock recording acquisition order + stacks."""

    def __init__(self, name: str, order: int, reentrant: bool = False):
        self.name = name
        self.order = order
        self.reentrant = reentrant
        self._inner: Union[threading.Lock, threading.RLock] = (
            threading.RLock() if reentrant else threading.Lock())  # lock-order: 901

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)  # xlint: allow-bare-acquire(instrumentation wrapper)
        if ok:
            held = _held_list()
            mine = next((h for h in held if h.lock is self), None)
            if mine is not None:
                # Re-entrant re-acquisition: one entry, counted depth (a
                # second entry would double-report in note_yield_point).
                mine.depth += 1
            else:
                for h in held:
                    if h.lock.order >= self.order:
                        _record(
                            "lock-order",
                            f"acquired {self.name} (order {self.order}) "
                            f"while holding {h.lock.name} "
                            f"(order {h.lock.order})")
                        break
                held.append(_Held(self, time.monotonic(),
                                  traceback.format_stack(limit=12)[:-1]))
        return ok

    def release(self) -> None:
        held = _held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                if held[i].depth > 1:
                    held[i].depth -= 1
                else:
                    del held[i]
                break
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def note_yield_point(point: str) -> None:
    """Called from the fault plane at every ``FAULTS.check``/``fire`` —
    i.e. at every modeled blocking-I/O site. Flags instrumented locks the
    calling thread has held longer than the threshold."""
    for h in _held_list():
        held_for = time.monotonic() - h.acquired_at
        if held_for >= _HOLD_THRESHOLD_S:
            _record(
                "held-across-yield",
                f"lock {h.lock.name} (order {h.lock.order}) held "
                f"{held_for * 1000:.1f}ms across fault point {point!r} "
                f"(blocking call under lock?)")


_hook_installed = False


def _install_yield_hook() -> None:
    global _hook_installed
    if _hook_installed:
        return
    from ..common import faults

    faults.set_yield_hook(note_yield_point)
    _hook_installed = True


def make_lock(name: str, *, order: int, reentrant: bool = False):
    """Project lock factory. ``order`` is the global acquisition rank
    (lower = acquired first / outermost); it must match the
    ``# lock-order: N`` annotation on the declaration line, which xlint
    cross-checks and uses for the static acquisition-graph rule."""
    if not _DEBUG:
        return threading.RLock() if reentrant else threading.Lock()
    _install_yield_hook()
    return InstrumentedLock(name, order, reentrant)


if _DEBUG:
    _install_yield_hook()
