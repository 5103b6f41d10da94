"""In-process coordination backend.

The reference has no test double for etcd (SURVEY.md §4 calls this out as a
gap to fix); this backend is the hermetic-test lever *and* a real single-host
deployment mode. Semantics mirror etcd v3 as used by the reference:
TTL-leased keys expire unless kept alive; expiry fires DELETE watch events
(which is exactly how the reference detects dead instances and dead masters,
SURVEY.md §3.4-3.5).

Multiple clients attached to one :class:`MemoryStore` model multiple
processes sharing one etcd cluster; closing a client stops its keepalives so
its leased keys lapse — simulating process death in failure-injection tests.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Optional

from .base import CoordinationClient, KeyEvent, WatchCallback, WatchEventType
from ..common.faults import FAULTS
from ..devtools import lifecycle as _lifecycle
from ..devtools.locks import make_lock


@dataclass
class _Entry:
    value: str
    expire_at: Optional[float] = None   # None = no lease


@dataclass
class _Watch:
    id: int
    prefix: str
    cb: WatchCallback


class MemoryStore:
    """The shared 'cluster'. Thread-safe; watch callbacks run on a dedicated
    dispatch thread (never under the store lock)."""

    _shared: dict[str, "MemoryStore"] = {}
    _shared_lock = make_lock("memory_store.shared", order=40)  # lock-order: 40

    @classmethod
    def shared(cls, name: str = "default") -> "MemoryStore":
        with cls._shared_lock:
            st = cls._shared.get(name)
            if st is None:
                st = cls()
                cls._shared[name] = st
            return st

    @classmethod
    def reset_shared(cls, name: str = "default") -> None:
        with cls._shared_lock:
            st = cls._shared.pop(name, None)
        if st is not None:
            st.close()

    def __init__(self, expiry_tick_s: float = 0.05):
        self._data: dict[str, _Entry] = {}
        self._watches: list[_Watch] = []
        self._next_watch_id = 1
        self._lock = make_lock("memory_store.data", order=44)  # lock-order: 44
        self._events: "queue.Queue[Optional[tuple[list[KeyEvent], str, WatchCallback]]]" = queue.Queue()
        self._closed = False
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="coord-dispatch", daemon=True)
        self._dispatcher.start()
        self._expiry_tick_s = expiry_tick_s
        self._expirer = threading.Thread(target=self._expiry_loop,
                                         name="coord-expiry", daemon=True)
        self._expirer.start()

    # ---- internals ---------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            item = self._events.get()
            if item is None:
                return
            events, prefix, cb = item
            try:
                cb(events, prefix)
            except Exception:
                import logging

                logging.getLogger(__name__).exception("watch callback failed")

    def _expiry_loop(self) -> None:
        while not self._closed:
            time.sleep(self._expiry_tick_s)
            now = time.monotonic()
            expired: list[str] = []
            with self._lock:
                for k, e in self._data.items():
                    if e.expire_at is not None and e.expire_at <= now:
                        expired.append(k)
                for k in expired:
                    del self._data[k]
                if expired:
                    self._emit_locked([KeyEvent(WatchEventType.DELETE, k, "") for k in expired])

    def _emit_locked(self, events: list[KeyEvent]) -> None:
        for w in self._watches:
            hits = [e for e in events if e.key.startswith(w.prefix)]
            if hits:
                self._events.put((hits, w.prefix, w.cb))

    # ---- ops (called by clients, keys already namespaced) ------------------
    def put(self, key: str, value: str, ttl_s: Optional[float],
            create_only: bool = False) -> bool:
        with self._lock:
            exists = key in self._data
            if create_only and exists:
                e = self._data[key]
                # A leased key that has logically expired but not yet been
                # swept still blocks creation in etcd only until expiry; treat
                # sweep-lag as expired for correctness.
                if e.expire_at is None or e.expire_at > time.monotonic():
                    return False
            expire_at = time.monotonic() + ttl_s if ttl_s else None
            self._data[key] = _Entry(value, expire_at)
            self._emit_locked([KeyEvent(WatchEventType.PUT, key, value)])
            return True

    def refresh(self, key: str, ttl_s: float) -> bool:
        with self._lock:
            e = self._data.get(key)
            if e is None or e.expire_at is None:
                return False
            e.expire_at = time.monotonic() + ttl_s
            return True

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            e = self._data.get(key)
            return e.value if e is not None else None

    def get_prefix(self, prefix: str) -> dict[str, str]:
        with self._lock:
            return {k: e.value for k, e in self._data.items() if k.startswith(prefix)}

    def rm(self, key: str) -> bool:
        with self._lock:
            if key not in self._data:
                return False
            del self._data[key]
            self._emit_locked([KeyEvent(WatchEventType.DELETE, key, "")])
            return True

    def rm_prefix(self, prefix: str, guard_key: Optional[str]) -> int:
        with self._lock:
            if guard_key is not None and guard_key not in self._data:
                return 0
            keys = [k for k in self._data if k.startswith(prefix)]
            for k in keys:
                del self._data[k]
            if keys:
                self._emit_locked([KeyEvent(WatchEventType.DELETE, k, "") for k in keys])
            return len(keys)

    def bulk_set(self, kvs: Mapping[str, str]) -> bool:
        with self._lock:
            events = []
            for k, v in kvs.items():
                self._data[k] = _Entry(v, None)
                events.append(KeyEvent(WatchEventType.PUT, k, v))
            if events:
                self._emit_locked(events)
            return True

    def bulk_rm(self, keys: Iterable[str]) -> int:
        with self._lock:
            removed = [k for k in keys if k in self._data]
            for k in removed:
                del self._data[k]
            if removed:
                self._emit_locked([KeyEvent(WatchEventType.DELETE, k, "") for k in removed])
            return len(removed)

    def bulk_apply(self, kvs: Mapping[str, str], rm_keys: Iterable[str]) -> bool:
        """Deletes + puts in ONE emission: watchers see one event batch
        (DELETEs first), so multi-key transitions apply atomically."""
        with self._lock:
            events = []
            for k in rm_keys:
                if k in self._data and k not in kvs:
                    del self._data[k]
                    events.append(KeyEvent(WatchEventType.DELETE, k, ""))
            for k, v in kvs.items():
                self._data[k] = _Entry(v, None)
                events.append(KeyEvent(WatchEventType.PUT, k, v))
            if events:
                self._emit_locked(events)
            return True

    def add_watch(self, prefix: str, cb: WatchCallback) -> int:
        with self._lock:
            wid = self._next_watch_id
            self._next_watch_id += 1
            self._watches.append(_Watch(wid, prefix, cb))
            return wid

    def remove_watch(self, watch_id: int) -> None:
        with self._lock:
            self._watches = [w for w in self._watches if w.id != watch_id]

    def close(self) -> None:
        self._closed = True
        self._events.put(None)


class InMemoryCoordination(CoordinationClient):
    """A 'process handle' on a MemoryStore: owns keepalives + watches."""

    def __init__(self, store: Optional[MemoryStore] = None, namespace: str = ""):
        self._store = store or MemoryStore()
        self._ns = namespace.strip("/")
        # key -> (ttl, last value, create_only) for keys this client keeps
        # alive, so a failed refresh can re-create the key.
        self._keepalives: dict[str, tuple[float, str, bool]] = {}
        self._ka_lock = make_lock("memory_coord.keepalives", order=42)  # lock-order: 42
        self._watch_ids: list[int] = []
        self._closed = threading.Event()
        self._ka_thread = threading.Thread(target=self._keepalive_loop,
                                           name="coord-keepalive", daemon=True)
        self._ka_thread.start()

    @classmethod
    def shared(cls, name: str = "default", namespace: str = "") -> "InMemoryCoordination":
        return cls(MemoryStore.shared(name), namespace=namespace)

    @property
    def store(self) -> MemoryStore:
        return self._store

    def _k(self, key: str) -> str:
        return f"{self._ns}/{key}" if self._ns else key

    def _strip(self, key: str) -> str:
        return key[len(self._ns) + 1:] if self._ns else key

    def _keepalive_loop(self) -> None:
        # Refresh each leased key at ~ttl/3 cadence (etcd KeepAlive behavior,
        # reference retains `etcd::KeepAlive` handles in `keep_alives_`,
        # `etcd_client.h:160`). A key whose lease ran out while this thread
        # was starved (a stall longer than the TTL) is re-created with its
        # last value and its original create-only semantics, as the TCP
        # client's keepalive re-creates a key the server lost: otherwise a
        # live master's membership key would stay gone for good.
        while not self._closed.wait(0.1):
            with self._ka_lock:
                items = list(self._keepalives.items())
            for key, entry in items:
                ttl, value, create_only = entry
                if self._store.refresh(key, ttl):
                    continue
                with self._ka_lock:
                    if self._closed.is_set() \
                            or self._keepalives.get(key) != entry:
                        continue        # released or re-set meanwhile
                    if not self._store.put(key, value, ttl,
                                           create_only=create_only) \
                            and create_only:
                        # Another holds the election key now: stop
                        # claiming it (the owner learns of its demotion
                        # from the key's value).
                        del self._keepalives[key]
                        _lifecycle.note_release("coord-lease",
                                                key=(id(self), key))

    # ---- CoordinationClient ------------------------------------------------
    def ping(self) -> bool:
        # Hermetic plane-outage simulation: a scripted `coord.outage`
        # fault fails the liveness probe, so the degraded-mode health
        # monitor can be drilled to DEGRADED/RECOVERING without a real
        # TCP coordination server to kill.
        if FAULTS.fire("coord.outage") is not None:
            return False
        return True

    def set(self, key, value, ttl_s=None, keepalive=True) -> bool:
        ok = self._store.put(self._k(key), value, ttl_s)
        if ok and ttl_s and keepalive:
            with self._ka_lock:
                if self._k(key) not in self._keepalives:
                    _lifecycle.note_acquire("coord-lease",
                                            key=(id(self), self._k(key)))
                self._keepalives[self._k(key)] = (ttl_s, value, False)
        return ok

    def create_if_absent(self, key, value, ttl_s=None, keepalive=True) -> bool:
        ok = self._store.put(self._k(key), value, ttl_s, create_only=True)
        if ok and ttl_s and keepalive:
            with self._ka_lock:
                if self._k(key) not in self._keepalives:
                    _lifecycle.note_acquire("coord-lease",
                                            key=(id(self), self._k(key)))
                self._keepalives[self._k(key)] = (ttl_s, value, True)
        return ok

    def get(self, key):
        return self._store.get(self._k(key))

    def get_prefix(self, prefix):
        raw = self._store.get_prefix(self._k(prefix))
        return {self._strip(k): v for k, v in raw.items()}

    def rm(self, key) -> bool:
        self.release(key)
        return self._store.rm(self._k(key))

    def rm_prefix(self, prefix, guard_key=None) -> int:
        return self._store.rm_prefix(
            self._k(prefix), self._k(guard_key) if guard_key else None)

    def bulk_set(self, kvs) -> bool:
        return self._store.bulk_set({self._k(k): v for k, v in kvs.items()})

    def bulk_rm(self, keys) -> int:
        return self._store.bulk_rm([self._k(k) for k in keys])

    def bulk_apply(self, kvs, rm_keys) -> bool:
        return self._store.bulk_apply({self._k(k): v for k, v in kvs.items()},
                                      [self._k(k) for k in rm_keys])

    def release(self, key) -> None:
        with self._ka_lock:
            if self._keepalives.pop(self._k(key), None) is not None:
                _lifecycle.note_release("coord-lease",
                                        key=(id(self), self._k(key)))

    def add_watch(self, prefix, cb) -> int:
        ns_prefix = self._k(prefix)

        def wrapped(events: list[KeyEvent], _raw_prefix: str) -> None:
            cb([KeyEvent(e.type, self._strip(e.key), e.value) for e in events], prefix)

        wid = self._store.add_watch(ns_prefix, wrapped)
        self._watch_ids.append(wid)
        return wid

    def remove_watch(self, watch_id) -> None:
        self._store.remove_watch(watch_id)
        if watch_id in self._watch_ids:
            self._watch_ids.remove(watch_id)

    def close(self) -> None:
        self._closed.set()
        with self._ka_lock:
            for k in self._keepalives:
                _lifecycle.note_release("coord-lease", key=(id(self), k))
            self._keepalives.clear()
        for wid in list(self._watch_ids):
            self._store.remove_watch(wid)
        self._watch_ids.clear()
