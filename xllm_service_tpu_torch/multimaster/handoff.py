"""Request handoff between active masters (port of
``xllm_service_tpu/multimaster/handoff.py`` on the standard library: the
relay speaks HTTP through ``http_service/client.py`` on the event loop).

The accepting frontend relays the ORIGINAL client body to the owner's
``/rpc/handoff`` endpoint and streams the owner's response (SSE frames or
one JSON document) straight back to the client — the owner runs the full
schedule/dispatch/failover pipeline; the relay never parses payloads
beyond SSE frame boundaries.

Owner-death recovery: if the owner connection dies mid-stream, the relay
recomputes ownership over the surviving members (rendezvous successor —
every relay holding requests of the dead owner lands them on the same
survivors, deterministically), re-forwards with the count of data frames
already delivered, and drops exactly that many frames from the
replacement stream before resuming the client copy. The replacement
owner re-runs the request through the normal pipeline; with the
engine-side prefix cache warm, the replay prefills from cache. Frame-skip
dedup assumes the upstream stream is reproducible for the same request
(greedy decoding; a temperature>0 engine may splice a divergent
continuation, but the stream *completes*). A transport blip against a
LIVE owner is answered from its delta journal instead: the exact frames
already generated, no re-run.

Trace correlation: the relay roots the request's trace and sends the
context as ``x-xllm-*`` headers; the owner parents its ``frontend.request``
span under it, so one trace tree spans the relay, every owner
incarnation, and the engines they dispatched to.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Optional

from ..common.flightrecorder import RECORDER
from ..common.metrics import (
    HANDOFF_FORWARDED_TOTAL,
    HANDOFF_RECOVERIES_TOTAL,
)
from ..common.tracing import TRACER
from ..devtools import lifecycle as _lifecycle
from ..devtools.locks import make_lock
from ..http_service import web
from ..http_service.client import (
    ClientError,
    ClientResponse,
    ClientSession,
    ClientTimeout,
)
from ..overload import RETRY_BUDGET
from ..overload.deadline import ABS_DEADLINE_HEADER, PRIORITY_HEADER
from ..utils import get_logger
from .ownership import OwnershipRouter

logger = get_logger(__name__)

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
    """Owner-side seq-numbered delta journal for relayed streams. The old recovery contract re-ran the whole
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
        self._lock = make_lock("multimaster.journal", order=30)  # lock-order: 30
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
                _lifecycle.note_acquire("journal-session", key=sid)
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
            if not entry.finished:
                _lifecycle.note_release("journal-session", key=entry.sid)
            entry.finished = True

    def _gc_locked(self, now: float) -> None:
        dead = [sid for sid, e in self._entries.items()
                if now - e.touched > self.ttl_s]
        for sid in dead:
            # Idempotent pair: a finished entry already released; this
            # only balances entries the grace window abandoned.
            _lifecycle.note_release("journal-session", key=sid)
            del self._entries[sid]

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "grace_s": self.grace_s}


def _passthrough_headers(r) -> dict[str, str]:
    """Owner-response headers the relay must not swallow: Retry-After
    carries the admission gate's backoff hint on a shed 429 — without
    it well-behaved clients retry immediately instead of backing off,
    and X-Request-Id carries the internal service id the trace plane
    keys by."""
    out = {}
    for h in ("Retry-After", "X-Request-Id"):
        v = r.headers.get(h)
        if v:
            out[h] = v
    return out


class HandoffRelay:
    """Relays one frontend's foreign-owned requests to their owners."""

    def __init__(self, ownership: OwnershipRouter, max_attempts: int = 3,
                 stall_timeout_s: float = 60.0,
                 same_owner_retry: bool = True):
        self._ownership = ownership
        self.max_attempts = max(1, max_attempts)
        # Read deadline per response chunk: a killed-but-not-closed owner
        # (hung event loop, SIGKILL mid-handler) leaves the TCP stream
        # open and silent — without this the relay would stall forever
        # instead of re-owning. Found by the kill-the-owner chaos drill.
        self.stall_timeout_s = stall_timeout_s
        # First stream recovery retries the SAME owner before excluding
        # it: a transport blip against a LIVE owner hits its delta
        # journal (exact frame replay, no pipeline re-run); a dead owner
        # fails the retry fast and the next attempt re-owns as before.
        self.same_owner_retry = same_owner_retry

    def _url(self, owner: str, kind: str, sid: str) -> str:
        return f"http://{owner}/rpc/handoff?kind={kind}&sid={sid}"

    async def relay(self, http_req: web.Request, client: ClientSession,
                    body: bytes, kind: str, sid: str, owner: str,
                    owner_key: str, stream: bool,
                    timeout_s: float, deadline_ms: int = 0,
                    priority: str = "") -> web.StreamResponse:
        """Forward ``body`` to ``owner`` and copy the response back to the
        client of ``http_req``. Returns the prepared client response."""
        span = TRACER.start_span("frontend.request", request_id=sid,
                                 kind=kind, stream=stream, relay=True,
                                 owner=owner)
        headers = {"Content-Type": "application/json"}
        if deadline_ms:
            # The ABSOLUTE deadline computed at accept rides the hop —
            # the owner must enforce the original budget, not restart it
            # (overload/deadline.py). The relay's own total timeout is
            # clamped to the remaining budget below.
            headers[ABS_DEADLINE_HEADER] = str(deadline_ms)
            timeout_s = max(0.05, min(
                timeout_s, deadline_ms / 1000.0 - time.time() + 0.5))
        if priority:
            headers[PRIORITY_HEADER] = priority
        if span:
            headers.update(span.context().to_headers())
        HANDOFF_FORWARDED_TOTAL.labels(owner=owner).inc()
        try:
            if stream:
                return await self._relay_stream(
                    http_req, client, body, kind, sid, owner, owner_key,
                    headers, timeout_s, span)
            return await self._relay_unary(
                http_req, client, body, kind, sid, owner, owner_key,
                headers, timeout_s, span)
        finally:
            if span:
                span.end()

    # ----------------------------------------------------------- non-stream
    async def _relay_unary(self, http_req, client, body, kind, sid, owner,
                           owner_key, headers, timeout_s,
                           span) -> web.Response:
        failed: list[str] = []
        last_err: Any = None
        for attempt in range(self.max_attempts):
            if attempt:
                if not RETRY_BUDGET.try_spend():
                    # Global retry budget (overload plane): a mass owner
                    # outage must degrade into bounded recovery, not a
                    # relay retry storm across every accepting frontend.
                    last_err = f"{last_err} (retry budget exhausted)"
                    break
                owner = self._recover(owner, failed, owner_key, sid, span)
                HANDOFF_RECOVERIES_TOTAL.labels(owner=owner).inc()
            url = self._url(owner, kind, sid) + f"&attempt={attempt}"
            try:
                # No per-read stall deadline here (unlike the stream
                # relay): a unary owner legitimately sends ZERO bytes
                # until the whole generation is done, which can far
                # exceed any silence threshold that would still catch a
                # hung owner usefully. A SIGKILLed owner closes its
                # sockets (kernel teardown) and fails fast below; the
                # rare hung-but-open owner is bounded by `total`.
                async with client.post(
                        url, data=body, headers=headers,
                        timeout=ClientTimeout(
                            total=timeout_s, sock_connect=10)) as r:
                    payload = await r.read()
                    # Any HTTP status from the owner is an answer (client
                    # errors replay identically anywhere; 5xx came from
                    # the owner's own pipeline, which already ran its
                    # failover budget) — only transport failures recover.
                    return web.Response(
                        body=payload, status=r.status,
                        content_type=(r.content_type or "application/json"),
                        headers=_passthrough_headers(r))
            except (ClientError, asyncio.TimeoutError) as e:
                last_err = e
                failed.append(owner)
                logger.warning("handoff of %s to %s failed: %s",
                               sid, owner, e)
        if span:
            span.set(error=str(last_err), error_code=503)
            span.status = "ERROR: 503"
        return web.json_response(
            {"error": {"message": f"request owner unreachable: {last_err}",
                       "type": "service_unavailable", "code": 503}},
            status=503)

    # --------------------------------------------------------------- stream
    async def _relay_stream(self, http_req, client, body, kind, sid, owner,
                            owner_key, headers, timeout_s,
                            span) -> web.StreamResponse:
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "text/event-stream"
        resp.headers["Cache-Control"] = "no-cache"
        # Same contract as the owner-served path: the internal service id
        # (what /admin/trace and the flight recorder key by) rides a
        # response header — the deltas only carry the OpenAI cmpl- id.
        resp.headers["X-Request-Id"] = sid
        prepared = False
        delivered = 0          # data frames already copied to the client
        failed: list[str] = []
        last_err: Any = None
        for attempt in range(self.max_attempts):
            if attempt:
                if not RETRY_BUDGET.try_spend():
                    last_err = f"{last_err} (retry budget exhausted)"
                    break
                if attempt == 1 and self.same_owner_retry \
                        and owner not in failed:
                    # Same-owner-first: a live owner serves the reconnect
                    # from its delta journal — the exact frames already
                    # generated, no re-run (exact dedup even under
                    # temperature>0 sampling). A dead owner RSTs this
                    # attempt immediately and the next one re-owns.
                    logger.info("retrying %s against the same owner %s "
                                "(journal reconnect, %d frames delivered)",
                                sid, owner, delivered)
                else:
                    owner = self._recover(owner, failed, owner_key, sid,
                                          span)
                    HANDOFF_RECOVERIES_TOTAL.labels(owner=owner).inc()
            url = (self._url(owner, kind, sid)
                   + f"&attempt={attempt}&skip={delivered}")
            skip = delivered
            try:
                async with client.post(
                        url, data=body, headers=headers,
                        timeout=ClientTimeout(
                            total=timeout_s, sock_connect=10,
                            sock_read=self.stall_timeout_s)) as r:
                    if r.status != 200:
                        # The owner answered (error body, non-stream): an
                        # authoritative reply, not a transport failure.
                        payload = await r.read()
                        if prepared:
                            # Frames already went out — append an SSE
                            # error frame instead of rewriting the status.
                            await resp.write(
                                _DATA_PREFIX + payload + b"\n\n")
                            await resp.write_eof()
                            return resp
                        return web.Response(
                            body=payload, status=r.status,
                            content_type=(r.content_type
                                          or "application/json"),
                            headers=_passthrough_headers(r))
                    # Client-facing writes are guarded INDIVIDUALLY: a
                    # dead client raises ClientConnectionResetError,
                    # which is an ClientError too — letting it
                    # reach the owner-failure handler below would
                    # misclassify the disconnect as owner death and
                    # re-run the whole generation on the rendezvous
                    # successor (up to max_attempts times) for a client
                    # that is gone. OSError covers it: the reset is a
                    # ConnectionResetError subclass.
                    try:
                        if not prepared:
                            await resp.prepare(http_req)
                            prepared = True
                    except OSError:
                        # CLIENT went away before prepare: abort the
                        # owner connection NOW — a graceful release
                        # would drain the stream, hiding the disconnect
                        # from the owner (whose next write is what
                        # triggers its mark_disconnected →
                        # _cancel_on_engines chain).
                        r.close()
                        await self._abort_owner(client, owner, sid)
                        return resp
                    async for frame in self._frames(r):
                        if frame.startswith(_DATA_PREFIX) and skip > 0:
                            # Replay dedup: this frame was already
                            # delivered by a previous owner incarnation.
                            skip -= 1
                            continue
                        try:
                            await resp.write(frame)
                        except OSError:
                            # CLIENT went away mid-copy: abort the owner
                            # connection so the disconnect PROPAGATES —
                            # the owner's next SSE write fails, it marks
                            # the connection dead, and the engines get
                            # cancelled. Without this the relay could
                            # keep draining the owner stream to
                            # completion, burning engine tokens for a
                            # client that is gone.
                            r.close()
                            await self._abort_owner(client, owner, sid)
                            return resp
                        if frame.startswith(_DATA_PREFIX):
                            delivered += 1
                    try:
                        await resp.write_eof()
                    except OSError:
                        pass
                    return resp
            except (ClientError, asyncio.TimeoutError) as e:
                last_err = e
                if not (self.same_owner_retry and attempt == 0):
                    # First break with same-owner retry armed: keep the
                    # owner out of `failed` so the journal-reconnect
                    # attempt targets it; a second break condemns it.
                    failed.append(owner)
                logger.warning("handoff stream of %s via %s broke after "
                               "%d frames: %s", sid, owner, delivered, e)
        # Recovery budget exhausted mid-stream: surface in-band.
        if span:
            span.set(error=str(last_err), error_code=503)
        if prepared:
            try:
                await resp.write(
                    b'data: {"error": {"message": "request owner lost mid-'
                    b'stream; recovery budget exhausted", "code": 503}}\n\n')
                await resp.write_eof()
            except (ConnectionResetError, OSError):
                pass
            return resp
        return web.json_response(
            {"error": {"message": f"request owner unreachable: {last_err}",
                       "type": "service_unavailable", "code": 503}},
            status=503)

    @staticmethod
    async def _abort_owner(client: ClientSession, owner: str,
                           sid: str) -> None:
        """Tell the owner the CLIENT is gone (not just the relay
        transport): with the delta journal armed, a bare connection
        break makes the owner absorb deltas for the reconnect grace
        window — correct for a blip, wasted engine tokens for a real
        client abort. This explicit signal finishes the journal and
        cancels the request immediately. Best effort: a legacy owner
        404s and falls back to the grace-expiry cancel."""
        try:
            async with client.post(
                    f"http://{owner}/rpc/handoff_abort?sid={sid}",
                    timeout=ClientTimeout(total=2)) as r:
                await r.read()
        except (ClientError, asyncio.TimeoutError, OSError):
            pass

    @staticmethod
    async def _frames(r: ClientResponse):
        """Yield complete SSE frames (through the blank-line terminator) so
        the skip/count logic never sees a torn frame."""
        buf = bytearray()
        async for chunk in r.iter_chunks():
            buf += chunk
            while True:
                i = buf.find(b"\n\n")
                if i < 0:
                    break
                yield bytes(buf[:i + 2])
                del buf[:i + 2]
        if buf:
            yield bytes(buf)

    def _recover(self, dead: str, failed: list[str], owner_key: str,
                 sid: str, span) -> str:
        """Deterministic re-ownership: the rendezvous successor over the
        members that have not failed this relay."""
        successor = self._ownership.owner_of(owner_key, exclude=failed)
        logger.info("re-owning %s: %s -> %s (failed: %s)",
                    sid, dead, successor, failed)
        if span:
            span.set(reowned_to=successor, attempt_failed=dead)
            # Owner death is an anomaly by definition: force the
            # tail-sampling keep so the relay-side spans survive, and
            # capture the re-ownership in the flight recorder (the
            # owner-kill chaos drill asserts on this bundle).
            TRACER.keep_trace(span.trace_id)
        RECORDER.record(
            "handoff_recovery", request_id=sid,
            trace_id=span.trace_id if span else "",
            detail={"dead_owner": dead, "successor": successor,
                    "failed_so_far": list(failed)})
        return successor
