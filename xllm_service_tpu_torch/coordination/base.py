"""Backend-neutral coordination interface.

Capability parity with the reference's `EtcdClient`
(`scheduler/etcd_client/etcd_client.h:38`, SURVEY.md §2.7):

- `set(key, value)` plain put; `set(key, value, ttl)` = transaction
  {create-if-absent + put-with-lease} with a background keepalive retained
  until `release` (`etcd_client.cpp:105-120`).
- bulk upsert/delete (`etcd_client.cpp:122-137`).
- `get`, `get_prefix` (`etcd_client.cpp:174-219`).
- `rm`, `rm_prefix` — the reference guards bulk rm on still-being-master
  (`etcd_client.cpp:149-160`); we expose `rm_prefix(guard_key=...)`.
- `add_watch(prefix, cb)` recursive prefix watch with cancel
  (`etcd_client.cpp:221-259`).
- `create_if_absent` — master-election primitive (`scheduler.cpp:72-76`).

Values are opaque strings on every backend (memory, native C++ server,
etcd) and must survive JSON framing, so binary payloads are ASCII-wrapped
by the producer — the KV-index sync frames are base64(msgpack)
(`rpc/wire.py encode_kv_frame`); one frame key per master sync tick
replaces the per-block JSON values the index used to write.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass
from typing import Callable, Iterable, Mapping, Optional


class WatchEventType(str, enum.Enum):
    PUT = "PUT"
    DELETE = "DELETE"


@dataclass
class KeyEvent:
    type: WatchEventType
    key: str          # full key (namespace stripped)
    value: str        # "" for DELETE


# Watch callback receives the batch of events for one revision plus the
# watched prefix (reference passes (response, prefix_len); we pre-strip).
WatchCallback = Callable[[list[KeyEvent], str], None]


class CoordinationClient(abc.ABC):
    """All keys are namespaced transparently (reference
    `common/utils.cpp:105-133` etcd namespace support)."""

    @abc.abstractmethod
    def set(self, key: str, value: str, ttl_s: Optional[float] = None,
            keepalive: bool = True) -> bool:
        """Put. With ttl_s, attach a lease; with keepalive, auto-refresh the
        lease until `release(key)` or client close."""

    @abc.abstractmethod
    def create_if_absent(self, key: str, value: str,
                         ttl_s: Optional[float] = None,
                         keepalive: bool = True) -> bool:
        """Atomic create; returns False if the key exists. Election primitive."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[str]: ...

    @abc.abstractmethod
    def get_prefix(self, prefix: str) -> dict[str, str]: ...

    @abc.abstractmethod
    def rm(self, key: str) -> bool: ...

    @abc.abstractmethod
    def rm_prefix(self, prefix: str, guard_key: Optional[str] = None) -> int:
        """Delete all keys under prefix. If guard_key is given, only proceed
        while guard_key exists (reference master-guarded bulk rm,
        `etcd_client.cpp:149-160`). Returns number deleted."""

    @abc.abstractmethod
    def bulk_set(self, kvs: Mapping[str, str]) -> bool: ...

    @abc.abstractmethod
    def bulk_rm(self, keys: Iterable[str]) -> int: ...

    def bulk_apply(self, kvs: Mapping[str, str],
                   rm_keys: Iterable[str]) -> bool:
        """Deletes + puts as ONE revision: watchers receive a single
        event batch (DELETEs first, then PUTs), so a multi-key state
        transition — e.g. the KV-index compaction's prune-legacy +
        install-full-frame — is applied atomically by replicas instead
        of exposing the half-pruned intermediate state. Backends that
        can't batch fall back to this default (rm then set, two
        revisions — correct but with a transient window; the
        memory/native backends override with a true single batch)."""
        self.bulk_rm(rm_keys)
        return self.bulk_set(kvs)

    def ping(self) -> bool:
        """Liveness probe of the coordination PLANE itself (not any key):
        the client-side evidence the degraded-mode health monitor
        classifies CONNECTED -> DEGRADED from. Backends that can lose
        connectivity override; the default is always-reachable."""
        return True

    @abc.abstractmethod
    def release(self, key: str) -> None:
        """Stop keepalive for a leased key (lease then expires naturally)."""

    @abc.abstractmethod
    def add_watch(self, prefix: str, cb: WatchCallback) -> int:
        """Watch a prefix recursively; returns a watch id."""

    @abc.abstractmethod
    def remove_watch(self, watch_id: int) -> None: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    # Context-manager sugar.
    def __enter__(self) -> "CoordinationClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
