"""L3 coordination: etcd-equivalent metadata/liveness store.

Parity: reference `scheduler/etcd_client/` wrapping etcd-cpp-apiv3
(SURVEY.md §2.7). The framework defines a backend-neutral
:class:`CoordinationClient` interface with the same capability surface —
TTL leases + keepalive, create-if-absent transactions, bulk ops, typed
prefix gets, recursive prefix watches — and ships two backends:

- :mod:`.memory` — in-process store (hermetic tests, single-host deploys).
- :mod:`.client`/:mod:`.server` — a standalone coordination service over TCP
  (this repo's self-contained replacement for an external etcd cluster; an
  etcd backend can be slotted in behind the same interface where etcd is
  available).
"""

from .base import CoordinationClient, KeyEvent, WatchEventType
from .memory import InMemoryCoordination

__all__ = [
    "CoordinationClient",
    "KeyEvent",
    "WatchEventType",
    "InMemoryCoordination",
    "connect",
]


def connect(addr: str = "", namespace: str = "", username: str = "",
            password: str = "", reconnect_max_backoff_s: float = 2.0):
    """Create a coordination client: empty addr -> shared in-memory backend;
    'host:port' -> TCP client to a coordination server."""
    if not addr:
        return InMemoryCoordination.shared(namespace=namespace)
    from .client import TcpCoordinationClient

    return TcpCoordinationClient(
        addr, namespace=namespace, username=username, password=password,
        reconnect_max_backoff_s=reconnect_max_backoff_s)
