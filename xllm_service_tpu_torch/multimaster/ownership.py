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
"""

from __future__ import annotations

import time
from hashlib import blake2b
from typing import Iterable

from ..rpc import MASTER_KEY, SERVICE_KEY_PREFIX

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
        except Exception:  # noqa: BLE001 — a plane blip falls back below
            members = []
        exclude = {o for o, ts in list(self._failed.items())
                   if now - ts < self.FAILURE_TTL_S}
        owner = telemetry_owner(members, self._name, exclude)
        if not owner:
            try:
                owner = self._coord.get(MASTER_KEY) or ""
            except Exception:  # noqa: BLE001 — as the membership read
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
