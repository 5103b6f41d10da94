"""In-process coordination backend (copy of the part of
``xllm_service_tpu/coordination/memory.py`` the port's agent uses).

TTL-leased keys expire unless kept alive, as in etcd. Several clients on
one :class:`MemoryStore` model several processes sharing one cluster;
closing a client stops its keepalives so its leased keys lapse.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from .base import CoordinationClient


@dataclass
class _Entry:
    value: str
    expire_at: Optional[float] = None   # None = no lease


class MemoryStore:
    """The shared 'cluster'. Thread-safe; a sweeper thread drops expired
    leased keys every ``expiry_tick_s``."""

    _shared: Optional["MemoryStore"] = None
    _shared_lock = threading.Lock()

    @classmethod
    def shared(cls) -> "MemoryStore":
        """The process's one store behind ``connect("")``."""
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    def __init__(self, expiry_tick_s: float = 0.05):
        self._data: dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._expiry_tick_s = expiry_tick_s
        self._expirer = threading.Thread(target=self._expiry_loop,
                                         name="coord-expiry", daemon=True)
        self._expirer.start()

    def _expiry_loop(self) -> None:
        while not self._closed:
            time.sleep(self._expiry_tick_s)
            now = time.monotonic()
            with self._lock:
                for k in [k for k, e in self._data.items()
                          if e.expire_at is not None and e.expire_at <= now]:
                    del self._data[k]

    # ---- ops (called by clients) -------------------------------------------
    def put(self, key: str, value: str, ttl_s: Optional[float]) -> bool:
        with self._lock:
            expire_at = time.monotonic() + ttl_s if ttl_s else None
            self._data[key] = _Entry(value, expire_at)
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
            return {k: e.value for k, e in self._data.items()
                    if k.startswith(prefix)}

    def rm(self, key: str) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def close(self) -> None:
        self._closed = True


class InMemoryCoordination(CoordinationClient):
    """A 'process handle' on a MemoryStore: owns its keepalives."""

    def __init__(self, store: Optional[MemoryStore] = None):
        self._store = store or MemoryStore()
        # key -> ttl for keys this client keeps alive.
        self._keepalives: dict[str, float] = {}
        self._ka_lock = threading.Lock()
        self._closed = threading.Event()
        self._ka_thread = threading.Thread(target=self._keepalive_loop,
                                           name="coord-keepalive",
                                           daemon=True)
        self._ka_thread.start()

    @classmethod
    def shared(cls) -> "InMemoryCoordination":
        return cls(MemoryStore.shared())

    @property
    def store(self) -> MemoryStore:
        return self._store

    def _keepalive_loop(self) -> None:
        # Each leased key refreshed every 0.1 s (well inside any ttl/3).
        while not self._closed.wait(0.1):
            with self._ka_lock:
                items = list(self._keepalives.items())
            for key, ttl in items:
                self._store.refresh(key, ttl)

    def set(self, key, value, ttl_s=None) -> bool:
        ok = self._store.put(key, value, ttl_s)
        if ok and ttl_s:
            with self._ka_lock:
                self._keepalives[key] = ttl_s
        return ok

    def get(self, key):
        return self._store.get(key)

    def get_prefix(self, prefix):
        return self._store.get_prefix(prefix)

    def rm(self, key) -> bool:
        self.release(key)
        return self._store.rm(key)

    def release(self, key) -> None:
        with self._ka_lock:
            self._keepalives.pop(key, None)

    def close(self) -> None:
        self._closed.set()
        with self._ka_lock:
            self._keepalives.clear()
