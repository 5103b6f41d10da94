"""Domain types the engine and its agent report through (copy of the part
of ``xllm_service_tpu/common/types.py`` they use: the instance role, the
registration record with its topology, and the KV-cache event with its
JSON and msgpack heartbeat forms)."""

from __future__ import annotations

import enum
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any


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
class TpuTopology:
    """Placement metadata of an instance (the reference's name; the fields
    describe any device mesh): slice and host coordinates, the engine's
    mesh shape and axis names, per-host addresses, and the device KV
    transfer endpoint ("" = host path only)."""

    slice_id: str = ""
    host: str = ""
    chip: int = -1
    mesh_shape: list[int] = field(default_factory=list)
    axis_names: list[str] = field(default_factory=list)
    host_addrs: list[str] = field(default_factory=list)
    chip_coords: list[list[int]] = field(default_factory=list)
    kv_transfer_addr: str = ""


@dataclass
class InstanceMetaInfo:
    """Engine instance registration record, stored as JSON under
    ``XLLM:INSTANCE:<TYPE>:<name>``: identity, role, topology, the KV
    layout PD peers check before linking, SLO profiling tables, the
    dispatch-wire formats the engine parses, and the lifecycle fields."""

    name: str = ""                       # identity; "host:http_port"
    rpc_address: str = ""
    type: InstanceType = InstanceType.DEFAULT
    dp_size: int = 1
    topology: TpuTopology = field(default_factory=TpuTopology)
    kv_page_size: int = 128
    kv_dtype: str = "bfloat16"
    num_layers: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    max_context_len: int = 8192
    cp_degree: int = 1
    # Rows of [prompt_len, ttft_ms] and [batch_size, total_tokens, tpot_ms].
    ttft_profiling_data: list[list[float]] = field(default_factory=list)
    tpot_profiling_data: list[list[float]] = field(default_factory=list)
    wire_formats: list[str] = field(default_factory=lambda: ["json"])
    draining: bool = False
    incarnation_id: str = ""
    register_ts_ms: int = 0
    models: list[str] = field(default_factory=list)

    def to_json(self) -> str:
        d = asdict(self)
        d["type"] = self.type.value
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str | bytes) -> "InstanceMetaInfo":
        d = json.loads(s)
        topo = d.pop("topology", None) or {}
        info = cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__
                      and k not in ("type", "topology")})
        info.type = InstanceType.parse(d.get("type"))
        info.topology = TpuTopology(**{
            k: v for k, v in topo.items()
            if k in TpuTopology.__dataclass_fields__})
        return info


@dataclass
class KvCacheEvent:
    """Delta of the instance's prefix-cache content, carried in heartbeats:
    chained block hashes (``common/hashing.py``) stored, removed or
    offloaded since the last drain. Keys are hex strings in the engine, or
    raw 16-byte keys; ``to_dict`` renders hex (the JSON heartbeat form),
    ``to_wire_dict`` raw bytes (the msgpack heartbeat form)."""

    stored: list = field(default_factory=list)
    removed: list = field(default_factory=list)
    offloaded: list = field(default_factory=list)

    def empty(self) -> bool:
        return not (self.stored or self.removed or self.offloaded)

    @staticmethod
    def _hexes(keys: list) -> list[str]:
        return [k.hex() if isinstance(k, (bytes, bytearray)) else k
                for k in keys]

    @staticmethod
    def _raws(keys: list) -> list[bytes]:
        return [bytes(k) if isinstance(k, (bytes, bytearray))
                else bytes.fromhex(k) for k in keys]

    def merge(self, other: "KvCacheEvent") -> None:
        """Union of two replicas' deltas (dp_size > 1): a block one replica
        removed but another stored stays stored; a block one replica
        offloaded but another holds on the device ships stored only (the
        index applies stored before offloaded). Within one delta, stored
        and offloaded together is the donate-then-evict sequence, and the
        offload survives."""
        hbm_only = (set(self.stored) - set(self.offloaded)) \
            | (set(other.stored) - set(other.offloaded))
        removed_here = set(other.stored)
        self.removed = [h for h in self.removed if h not in removed_here]
        stored_there = set(self.stored)
        self.stored += [h for h in other.stored if h not in stored_there]
        kept = set(self.stored)
        self.removed += [h for h in other.removed
                         if h not in kept and h not in set(self.removed)]
        offloaded = self.offloaded + [h for h in other.offloaded
                                      if h not in set(self.offloaded)]
        self.offloaded = [h for h in offloaded if h not in hbm_only]

    def to_dict(self) -> dict[str, Any]:
        """JSON-safe form: hex-string keys (the JSON heartbeat wire)."""
        return {"stored": self._hexes(self.stored),
                "removed": self._hexes(self.removed),
                "offloaded": self._hexes(self.offloaded)}

    def to_wire_dict(self) -> dict[str, Any]:
        """msgpack form: raw 16-byte keys (the binary heartbeat wire)."""
        return {"stored": self._raws(self.stored),
                "removed": self._raws(self.removed),
                "offloaded": self._raws(self.offloaded)}
