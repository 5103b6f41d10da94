"""Backend-neutral coordination interface (copy of the part of
``xllm_service_tpu/coordination/base.py`` the port's agent uses).

Capability parity with an etcd client as the reference uses it: a put with
a TTL lease that a background keepalive refreshes until ``release``,
``get``, ``get_prefix`` (the telemetry-owner resolver reads the service
membership with it), ``rm``, and a liveness probe of the plane. Values are
opaque strings. Bulk ops, create-if-absent and watches are the master's
and are not part of the port (ROADMAP queue 1 item 3.7).
"""

from __future__ import annotations

import abc
from typing import Optional


class CoordinationClient(abc.ABC):
    @abc.abstractmethod
    def set(self, key: str, value: str,
            ttl_s: Optional[float] = None) -> bool:
        """Put. With ttl_s, attach a lease that a keepalive refreshes until
        `release(key)` or client close."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[str]: ...

    @abc.abstractmethod
    def get_prefix(self, prefix: str) -> dict[str, str]:
        """Every live key under ``prefix`` with its value."""

    @abc.abstractmethod
    def rm(self, key: str) -> bool: ...

    def ping(self) -> bool:
        """Liveness probe of the coordination plane itself (not any key).
        Backends that can lose connectivity override; the default is
        always-reachable."""
        return True

    @abc.abstractmethod
    def release(self, key: str) -> None:
        """Stop keepalive for a leased key (lease then expires naturally)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    def __enter__(self) -> "CoordinationClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
