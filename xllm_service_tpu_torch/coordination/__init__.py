"""Coordination clients of the port's agent: the in-process store and a
TCP client of the reference's coordination server."""

from .base import CoordinationClient
from .memory import InMemoryCoordination

__all__ = ["CoordinationClient", "InMemoryCoordination", "connect"]


def connect(addr: str = "") -> CoordinationClient:
    """Empty addr -> the shared in-memory store; 'host:port' -> a TCP
    client of a coordination server."""
    if not addr:
        return InMemoryCoordination.shared()
    from .client import TcpCoordinationClient

    return TcpCoordinationClient(addr)
