"""Domain types the engine reports through (copy of the part of
``xllm_service_tpu/common/types.py`` the engine uses)."""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field


def now_ms() -> int:
    return int(time.time() * 1000)


class InstanceType(str, enum.Enum):
    """Role of an engine instance in the PD(+E)-disaggregated fleet."""

    DEFAULT = "DEFAULT"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    MIX = "MIX"
    ENCODE = "ENCODE"

    @classmethod
    def parse(cls, v: "InstanceType | str | None") -> "InstanceType":
        if v is None:
            return cls.DEFAULT
        if isinstance(v, InstanceType):
            return v
        return cls(str(v).upper())


@dataclass
class KvCacheEvent:
    """Delta of the instance's prefix-cache content, carried in heartbeats:
    chained block hashes (``common/hashing.py``) stored, removed or
    offloaded since the last drain."""

    stored: list = field(default_factory=list)
    removed: list = field(default_factory=list)
    offloaded: list = field(default_factory=list)

    def empty(self) -> bool:
        return not (self.stored or self.removed or self.offloaded)
