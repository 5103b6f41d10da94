"""Telemetry ownership over the live service-replica set, the engine's
side (copy of the engine-side part of
``xllm_service_tpu/multimaster/ownership.py``).

Every master registers under ``XLLM:SERVICE:<rpc_addr>``. The master that
owns an instance's heartbeat and load ingest is the rendezvous
(highest-random-weight) winner of ``hb|<instance name>`` over those
members: any node computes the same owner from the member list alone, and
when a master dies only what it owned moves, each key to the next-highest
scoring survivor. The agent mirrors the membership through
:class:`TelemetryOwnerResolver` and sends its beats and delta pushes to
that owner.

The master's side is :class:`OwnershipRouter`: it mirrors the member set
through a watch, decides the owner of each request id (and mines ids this
master owns) and the telemetry owner of each instance.

``owner_of`` runs on the request hot path → registered in xlint's
``HOT_PATH_FUNCTIONS``.
"""

from __future__ import annotations

import threading
import time
from hashlib import blake2b
from typing import Callable, Iterable, Optional

from ..common import native as _native
from ..coordination.base import CoordinationClient, KeyEvent, WatchEventType
from ..devtools import ownership as _ownership
from ..devtools import rcu
from ..devtools.locks import make_lock
from ..rpc import MASTER_KEY, SERVICE_KEY_PREFIX
from ..utils import generate_service_request_id

#: Bounded id-mining draws. P(all misses) = (1-1/N)^tries; a miss means
#: the request pays one handoff hop.
MINE_TRIES = 32

#: Telemetry shard salt: the owner of an instance's ingest hashes
#: ``<member>|hb|<instance name>``. Masters and engines share it.
TELEMETRY_SALT = "hb"


def _rendezvous_score(member: str, key: str) -> int:
    return int.from_bytes(
        blake2b(f"{member}|{key}".encode(), digest_size=8).digest(), "big")


def rendezvous_owner(members: Iterable[str], key: str,
                     exclude: Iterable[str] = ()) -> str:
    """Highest-random-weight owner of ``key`` over ``members``, the first
    strict maximum ("" when no member survives ``exclude``)."""
    excluded = set(exclude)
    if excluded:
        members = [m for m in members if m not in excluded]
    elif not isinstance(members, (tuple, list)):
        members = list(members)
    # One native call walks the whole member set (libhotcore; identical
    # winner — blake2b-8 big-endian scores, first strict max).
    best = _native.rendezvous(members, key)
    if best is not _native.MISS:
        return best
    best, best_score = "", -1
    for m in members:
        if m in excluded:
            continue
        s = _rendezvous_score(m, key)
        if s > best_score:
            best, best_score = m, s
    return best


def telemetry_owner(members: Iterable[str], instance_name: str,
                    exclude: Iterable[str] = ()) -> str:
    """The master that owns an instance's heartbeat and load ingest under
    the telemetry shard map ("" when no member survives)."""
    return rendezvous_owner(members, f"{TELEMETRY_SALT}|{instance_name}",
                            exclude)


class TelemetryOwnerResolver:
    """The agent's telemetry owner: reads the service membership (one
    ``get_prefix`` per ``cache_s``, shared by every beat and delta flush),
    applies the rendezvous map to this instance's name and skips owners
    observed dead (:meth:`note_failure`) for ``FAILURE_TTL_S``. Without
    membership records it falls back to the elected master
    (``MASTER_KEY``); with ``hold_last_owner``, while the plane answers
    nothing at all, it keeps the last owner that resolved.

    Called from the heartbeat and streamer threads. Every update is one
    assignment of a tuple or a dict entry, and a stale cached answer
    corrects itself within one cache window."""

    FAILURE_TTL_S = 10.0

    def __init__(self, coord, instance_name: str, cache_s: float = 2.0,
                 hold_last_owner: bool = True):
        self._coord = coord
        self._name = instance_name
        self._cache_s = cache_s
        self._cached: tuple[str, float] = ("", 0.0)
        self._failed: dict[str, float] = {}
        self._hold_last_owner = hold_last_owner
        self._last_good = ""

    def __call__(self) -> str:
        now = time.monotonic()
        owner, expires = self._cached
        if owner and now < expires:
            return owner
        try:
            members = [k[len(SERVICE_KEY_PREFIX):]
                       for k in self._coord.get_prefix(SERVICE_KEY_PREFIX)
                       if k != MASTER_KEY]
        except Exception:  # noqa: BLE001  # xlint: allow-broad-except(a coordination blip degrades to the cached/master fallback; the next window re-resolves)
            members = []
        exclude = {o for o, ts in list(self._failed.items())
                   if now - ts < self.FAILURE_TTL_S}
        owner = telemetry_owner(members, self._name, exclude)
        if not owner:
            try:
                owner = self._coord.get(MASTER_KEY) or ""
            except Exception:  # noqa: BLE001  # xlint: allow-broad-except(same degradation contract as the membership read above)
                owner = ""
        if owner:
            self._last_good = owner
        elif self._hold_last_owner and self._last_good not in exclude:
            owner = self._last_good
        self._cached = (owner, now + self._cache_s)
        return owner

    def note_failure(self, owner: str) -> None:
        """The caller saw this owner fail (connect or POST): skip it and
        drop the cache, so the next call resolves the rendezvous
        successor."""
        self._failed[owner] = time.monotonic()
        self._cached = ("", 0.0)

    def pin(self, owner: str) -> None:
        """A master answered a beat with an ``owner`` hint (its view of the
        shard map, fresher than the mirrored membership in a race): adopt
        it for one cache window."""
        if owner:
            self._cached = (owner, time.monotonic() + self._cache_s)


@_ownership.verify_state
class OwnershipRouter:
    """Rendezvous-hash request→master ownership (lock-free reads)."""

    def __init__(self, coord: CoordinationClient, self_addr: str,
                 enabled: bool = True, mine_ids: bool = True,
                 start_watch: bool = True):
        self._coord = coord
        self.self_addr = self_addr
        self.enabled = enabled
        self.mine_ids = mine_ids
        # Writers (watch callbacks, self-addr updates) serialize here and
        # publish an immutable sorted tuple; readers never take the lock.
        self._lock = make_lock("multimaster.ownership", order=28)  # lock-order: 28
        self._addrs: set[str] = {self_addr}
        self._members: tuple[str, ...] = (self_addr,)
        self.mined = 0          # ids mined to self-ownership
        self.mine_misses = 0    # draws exhausted -> foreign owner accepted
        # Telemetry-shard verdict memo: (member tuple it was computed
        # against, {instance name -> owner addr}). Keyed by IDENTITY of
        # the RCU-published member tuple — _publish_locked always builds
        # a fresh tuple, so any membership change invalidates the whole
        # memo on the next read without coordination (the "membership
        # epoch" is the tuple object itself).
        self._own_cache: tuple[tuple[str, ...], dict] = (self._members, {})
        self._watch_id: Optional[int] = None
        if enabled and start_watch:
            self._watch_id = coord.add_watch(SERVICE_KEY_PREFIX,
                                             self._on_service_event)
            self._bootstrap()

    # ------------------------------------------------------------ membership
    def _bootstrap(self) -> None:
        addrs = {k[len(SERVICE_KEY_PREFIX):]
                 for k in self._coord.get_prefix(SERVICE_KEY_PREFIX)
                 if k != MASTER_KEY}
        with self._lock:
            self._addrs |= addrs
            self._publish_locked()

    def _on_service_event(self, events: list[KeyEvent], _prefix: str) -> None:
        with self._lock:
            for ev in events:
                if ev.key == MASTER_KEY:
                    continue   # election key shares the prefix
                addr = ev.key[len(SERVICE_KEY_PREFIX):]
                if ev.type == WatchEventType.PUT:
                    self._addrs.add(addr)
                elif addr != self.self_addr:
                    # Self stays a member even through a lease blip: this
                    # process is alive by construction, and dropping it
                    # would stampede every mined id into handoffs.
                    self._addrs.discard(addr)
            self._publish_locked()

    def _publish_locked(self) -> None:
        self._members = rcu.publish(tuple(sorted(self._addrs)),
                                    "ownership.members")

    def update_self_addr(self, addr: str) -> None:
        """Follow the scheduler's post-bind re-registration (ephemeral
        ports are only known after the RPC site binds)."""
        with self._lock:
            self._addrs.discard(self.self_addr)
            with _ownership.escape("post-bind re-registration: rebinds "
                                   "the init-only self_addr once, before "
                                   "traffic"):
                self.self_addr = addr
            self._addrs.add(addr)
            self._publish_locked()

    def members(self) -> tuple[str, ...]:
        """Live service-replica addresses (lock-free, immutable)."""
        return self._members

    # ------------------------------------------------------------- ownership
    _score = staticmethod(_rendezvous_score)

    def owner_of(self, key: str,
                 exclude: Iterable[str] = ()) -> str:
        """The owning master's rpc address for a request id (or explicit
        affinity key). ``exclude`` drops members the caller has observed
        dead but whose lease has not lapsed yet — the result is the
        deterministic rendezvous successor. Falls back to self when the
        plane is empty or ownership is disabled."""
        if not self.enabled:
            return self.self_addr
        members = self._members
        if exclude:
            excluded = set(exclude)
            members = tuple(m for m in members if m not in excluded)
        if not members:
            return self.self_addr
        if len(members) == 1:
            return members[0]
        best = _native.rendezvous(members, key)
        if best is not _native.MISS:
            return best
        best, best_score = members[0], -1
        for m in members:
            s = self._score(m, key)
            if s > best_score:
                best, best_score = m, s
        return best

    def is_self(self, key: str, exclude: Iterable[str] = ()) -> bool:
        return self.owner_of(key, exclude) == self.self_addr

    # ---------------------------------------------------- telemetry shard map
    #: Verdict-memo safety bound: far above any real fleet's instance
    #: count; a runaway name space (chaos drills mint random names)
    #: resets the memo instead of growing it.
    OWN_CACHE_MAX = 65536

    def instance_owner(self, instance_name: str,
                       exclude: Iterable[str] = ()) -> str:
        """The master owning an instance's heartbeat/load ingest
        (telemetry shard map; falls back to self when ownership is
        disabled or the plane is empty). Lock-free, and memoized per
        (published member tuple, instance): every heartbeat of every
        instance consults this verdict — often twice (in-lock ingest
        gate + bare-beat kv relay) — so the rendezvous walk runs once
        per instance per membership epoch, not per beat. ``exclude`` is
        the rare failover path and bypasses the memo."""
        if not self.enabled:
            return self.self_addr
        members = self._members
        if exclude:
            return telemetry_owner(members, instance_name,
                                   exclude) or self.self_addr
        cache = self._own_cache  # xlint: allow-state-read(verdict memo: GIL-atomic snapshot read; a stale pair fails the identity check below and is rebuilt)
        if cache[0] is not members or len(cache[1]) >= self.OWN_CACHE_MAX:
            cache = (members, {})
            with _ownership.escape("verdict-memo swap on the beat hot "
                                   "path: single-assignment publish of a "
                                   "fresh (members, {}) pair; racing "
                                   "readers rebuild identical entries"):
                self._own_cache = cache
        owner = cache[1].get(instance_name)
        if owner is None:
            owner = telemetry_owner(members, instance_name) or self.self_addr
            with _ownership.escape("verdict-memo fill: GIL-atomic item "
                                   "store of a deterministic value — "
                                   "every racer computes the same owner "
                                   "for the same member tuple"):
                cache[1][instance_name] = owner
        return owner

    def owns_instance(self, instance_name: str) -> bool:
        """Does THIS master own the instance's telemetry ingest?"""
        return self.instance_owner(instance_name) == self.self_addr

    def mine(self, kind: str,
             gen: Optional[Callable[[str], str]] = None) -> tuple[str, str]:
        """Generate a service request id, preferring one THIS node owns
        (bounded draws). Returns ``(sid, owner_addr)``; the caller hands
        off when ``owner_addr != self_addr`` (draws exhausted against an
        unlucky membership, or mining disabled)."""
        gen = gen or generate_service_request_id
        if not self.enabled or len(self._members) <= 1:
            return gen(kind), self.self_addr
        if not self.mine_ids:
            sid = gen(kind)
            return sid, self.owner_of(sid)
        sid = gen(kind)
        with _ownership.escape("stat counters on the accept hot path: "
                               "GIL-atomic int adds; losing a rare "
                               "increment beats a lock per accept"):
            for _ in range(MINE_TRIES):
                if self.owner_of(sid) == self.self_addr:
                    self.mined += 1
                    return sid, self.self_addr
                sid = gen(kind)
            self.mine_misses += 1
        return sid, self.owner_of(sid)

    def stats(self) -> dict:
        return {"self": self.self_addr, "members": list(self._members),
                "enabled": self.enabled, "mine_ids": self.mine_ids,
                "mined": self.mined, "mine_misses": self.mine_misses}

    def stop(self) -> None:
        if self._watch_id is not None:
            self._coord.remove_watch(self._watch_id)
            self._watch_id = None
