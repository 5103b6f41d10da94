"""The owner-side delta journal of relayed streams (port of the part of
``xllm_service_tpu/multimaster/handoff.py`` a lone master runs).

A master records every SSE data frame it emits for a stream relayed to it
by another frontend, keeps absorbing engine deltas for ``grace_s`` after
the relay's connection breaks instead of cancelling, and serves a
reconnect the exact recorded frames. The relay itself (``HandoffRelay``,
``/rpc/handoff``) is the several-masters path and is not ported yet: the
port's master refuses to start beside another live master.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_DATA_PREFIX = b"data: "


class _JournalEntry:
    """One relayed stream's journaled SSE data frames. ``frames`` is
    append-only (writer: the owner's SSE emit loop; readers: replay
    handlers polling length under the GIL); ``finished`` flips once,
    after the last frame."""

    __slots__ = ("frames", "finished", "created", "touched", "sid")

    def __init__(self, now: float, sid: str = ""):
        self.frames: list[bytes] = []
        self.finished = False
        self.created = now
        self.touched = now
        self.sid = sid


class DeltaJournal:
    """Owner-side seq-numbered delta journal for relayed streams
    The old recovery contract re-ran the whole
    pipeline on the replacement owner and dropped ``skip`` frames of the
    NEW stream — exact only if streams are reproducible, which
    temperature>0 sampling breaks (the relay would splice a divergent
    continuation). With the journal, the owner records every SSE data
    frame it emits for a relayed request (frame index IS the seq — the
    same count the relay's ``skip`` uses), keeps absorbing engine deltas
    for ``grace_s`` after the relay's connection breaks instead of
    cancelling, and serves a reconnect (same sid, ``skip=N``) the EXACT
    recorded frames ``N:`` — no re-run, no splice risk. The relay's
    first recovery attempt retries the SAME owner to hit this path; a
    genuinely dead owner fails that attempt fast (RST) and recovery
    falls back to the rendezvous successor with the legacy
    reproducible-stream contract."""

    def __init__(self, grace_s: float = 10.0, max_requests: int = 256,
                 ttl_s: float = 120.0):
        self.grace_s = grace_s
        self.max_requests = max_requests
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._entries: dict[str, _JournalEntry] = {}

    @property
    def enabled(self) -> bool:
        return self.grace_s > 0

    def start(self, sid: str) -> Optional[_JournalEntry]:
        """Open (or resume) the journal for a relayed stream; returns
        None when journaling is disabled or the table is full (the
        stream still serves — it just loses exact-replay recovery)."""
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            self._gc_locked(now)
            entry = self._entries.get(sid)
            if entry is None:
                if len(self._entries) >= self.max_requests:
                    return None
                entry = self._entries[sid] = _JournalEntry(now, sid)
            return entry

    def get(self, sid: str) -> Optional[_JournalEntry]:
        with self._lock:
            entry = self._entries.get(sid)
            if entry is not None:
                entry.touched = time.monotonic()
            return entry

    @staticmethod
    def record(entry: Optional[_JournalEntry], frame: bytes) -> None:
        """Tee one emitted SSE frame (only ``data:`` frames — the exact
        set the relay's delivered-frame counter increments on, so
        journal index == relay skip)."""
        if entry is not None and frame.startswith(_DATA_PREFIX):
            entry.frames.append(frame)

    @staticmethod
    def finish(entry: Optional[_JournalEntry]) -> None:
        if entry is not None:
            entry.finished = True

    def _gc_locked(self, now: float) -> None:
        dead = [sid for sid, e in self._entries.items()
                if now - e.touched > self.ttl_s]
        for sid in dead:
            # Idempotent pair: a finished entry already released; this
            # only balances entries the grace window abandoned.
            del self._entries[sid]

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "grace_s": self.grace_s}
