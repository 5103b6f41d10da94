"""Core domain types for the orchestration plane.

Behavioral parity with the reference's `xllm_service/common/types.h` (461 LoC;
see SURVEY.md §2.9): InstanceMetaInfo, InstanceType, InstanceRuntimeState,
Routing, LoadMetrics, LatencyMetrics, KvCacheEvent, CacheLocations,
RequestAction/RequestMetrics, OverlapScores, LoadBalanceInfos — re-designed
for TPU: the reference's RDMA endpoint fields (`device_ips`, `ports`,
`cluster_ids`, reference `xllm_rpc_service.proto:38-43`) are replaced with an
explicit :class:`TpuTopology` (slice id, mesh shape, named axes, per-host DCN
addresses) so the scheduler can place prefill/decode roles topology-aware.

All types JSON-round-trip (``to_json``/``from_json``) because — like the
reference, which persists them to etcd (`types.h:224-318`) — they are stored
in the coordination service and mirrored by replica schedulers.
"""

from __future__ import annotations

import enum
import json
import time
from dataclasses import dataclass, field, asdict
from typing import Any, Sequence


def now_ms() -> int:
    return int(time.time() * 1000)


class InstanceType(str, enum.Enum):
    """Role of an engine instance in the PD(+E)-disaggregated fleet.

    Reference: `common/types.h:75-83` {DEFAULT, PREFILL, DECODE, MIX}; we add
    ENCODE for EPD three-stage multimodal disaggregation (the reference only
    claims the feature, README.md:47 — the mechanism is ours to define).
    """

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


class InstanceRuntimeState(str, enum.Enum):
    """Liveness state machine (reference `common/types.h:85-89` has three
    states; DRAINING is ours — the reference has no graceful shutdown).

    ACTIVE -> LEASE_LOST (lease expired but health probe passed; still
    schedulable) -> SUSPECT (probe failed or heartbeat silence; excluded from
    scheduling) -> evicted. See SURVEY.md §3.4.

    DRAINING (planned retirement — autoscaler scale-in or an operator
    drain): excluded from new scheduling, in-flight requests finish, then
    the instance deregisters gracefully (no eviction alarm, no failover).
    A DRAINING instance that dies mid-drain transitions through the
    normal LEASE_LOST/SUSPECT failure path, so its remaining requests
    still fail over.

    BREAKER_OPEN (overload plane, rpc/breaker.py): the instance's
    engine channel tripped its circuit breaker — sick-but-leased, its
    lease keeps renewing while RPCs fail. Excluded from scheduling like
    SUSPECT, but NOT evicted on a timer: the reconcile thread's
    half-open probe restores it to ACTIVE when the channel recovers. A
    registration refresh must not resurrect it (same rule as DRAINING).
    """

    ACTIVE = "ACTIVE"
    LEASE_LOST = "LEASE_LOST"
    SUSPECT = "SUSPECT"
    DRAINING = "DRAINING"
    BREAKER_OPEN = "BREAKER_OPEN"


class RequestAction(str, enum.Enum):
    """SLO-accounting actions (reference `common/types.h:152-158`)."""

    SCHEDULE = "SCHEDULE"
    FINISH_PREFILL = "FINISH_PREFILL"
    DECODE_STEP = "DECODE_STEP"
    FINISH_DECODE = "FINISH_DECODE"
    # Request left before producing a token (error / disconnect / GC
    # timeout): reverse only the SCHEDULE increments. Using FINISH_PREFILL
    # here would credit the decode instance with load it never received and
    # permanently skew SLO/CAR routing.
    CANCEL = "CANCEL"


@dataclass
class TpuTopology:
    """TPU-native placement metadata, replacing the reference's RDMA NIC
    fields (`xllm_rpc_service.proto:38-43` device_ips/ports/cluster_ids).

    slice_id      — which TPU slice/pod this instance's mesh lives on; KV
                    handoff between instances on the same slice can ride ICI,
                    cross-slice handoff rides DCN.
    host          — physical host within the slice; two instances sharing a
                    non-empty host are link-class "local". A non-empty host is
                    also what marks the instance as *placed* for the topology
                    plane (common/topology.py) — slice_id alone never does,
                    so legacy default slice ids can't re-route a flat fleet.
    chip          — chip index within the host (-1 = unpinned).
    mesh_shape    — e.g. [2, 4] for a 2x4 sub-mesh.
    axis_names    — named mesh axes, e.g. ["data", "model"].
    host_addrs    — per-host DCN endpoints (host:port) for KV transfer.
    chip_coords   — optional per-chip coordinates within the slice.
    """

    slice_id: str = ""
    host: str = ""
    chip: int = -1
    mesh_shape: list[int] = field(default_factory=list)
    axis_names: list[str] = field(default_factory=list)
    host_addrs: list[str] = field(default_factory=list)
    chip_coords: list[list[int]] = field(default_factory=list)
    # JAX transfer-server endpoint for device-path KV pulls (the TPU
    # analog of the reference's RDMA device_ips/ports); "" = host path
    # only.
    kv_transfer_addr: str = ""

    def num_devices(self) -> int:
        n = 1
        for d in self.mesh_shape:
            n *= d
        return n if self.mesh_shape else 0


@dataclass
class InstanceMetaInfo:
    """Engine instance registration record.

    Reference: `xllm_rpc_service.proto:31-46` InstanceMetaInfo — name (the
    instance's HTTP address doubles as its identity), rpc_address, type,
    dp_size, kv-cache ids, profiling tables, incarnation_id, register_ts_ms.
    TPU changes: `topology` replaces cluster_ids/device_ips/ports;
    `max_context_len`/`cp_degree` advertise long-context capability
    (SURVEY.md §5.7); `kv_page_size`/`kv_dtype`/`num_layers`/`num_kv_heads`/
    `head_dim` advertise KV layout so PD peers can validate transfer
    compatibility before linking.
    """

    name: str = ""                       # identity; typically "host:http_port"
    rpc_address: str = ""
    type: InstanceType = InstanceType.DEFAULT
    dp_size: int = 1
    topology: TpuTopology = field(default_factory=TpuTopology)
    # KV layout contract for PD linking (replaces opaque k/v_cache_ids).
    kv_page_size: int = 128
    kv_dtype: str = "bfloat16"
    num_layers: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    # Long-context capability (SURVEY.md §5.7).
    max_context_len: int = 8192
    cp_degree: int = 1
    # Offline-profiled latency tables: rows of [prompt_len, ttft_ms] and
    # [batch_size, total_tokens, tpot_ms] (reference `common/types.h:207-210`),
    # fitted by TimePredictor at registration.
    ttft_profiling_data: list[list[float]] = field(default_factory=list)
    tpot_profiling_data: list[list[float]] = field(default_factory=list)
    # Dispatch-wire formats this engine accepts, preference-ordered
    # (rpc/wire.py). Current builds advertise ["msgpack", "json"]; legacy
    # metadata without the field defaults to JSON-only, so the master
    # never sends binary to an engine that can't parse it.
    wire_formats: list[str] = field(default_factory=lambda: ["json"])
    # Graceful shutdown: a draining instance stays registered (in-flight
    # streams finish) but is excluded from scheduling.
    draining: bool = False
    # Lifecycle.
    incarnation_id: str = ""
    register_ts_ms: int = 0
    models: list[str] = field(default_factory=list)

    # ---- json ----
    def to_json(self) -> str:
        d = asdict(self)
        d["type"] = self.type.value
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str | bytes) -> "InstanceMetaInfo":
        d = json.loads(s)
        topo = d.pop("topology", None) or {}
        info = cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__ and k not in ("type", "topology")})
        info.type = InstanceType.parse(d.get("type"))
        info.topology = TpuTopology(**{k: v for k, v in topo.items() if k in TpuTopology.__dataclass_fields__})
        return info


@dataclass
class LoadMetrics:
    """Per-instance load snapshot carried in heartbeats.

    Reference: `xllm_rpc_service.proto:54-58` {waiting_requests_num,
    gpu_cache_usage_perc}; renamed gpu→hbm for TPU.
    """

    waiting_requests_num: int = 0
    hbm_cache_usage_perc: float = 0.0
    running_requests_num: int = 0

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LoadMetrics":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


@dataclass
class LatencyMetrics:
    """Recent worst-case latencies from the engine (reference
    `xllm_rpc_service.proto:59-62`)."""

    recent_max_ttft: float = 0.0
    recent_max_tbt: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LatencyMetrics":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


@dataclass
class KvCacheEvent:
    """Delta of the instance's prefix-cache content, carried in heartbeats.

    Reference: `xllm_rpc_service.proto:48-53` KvCacheEvent {stored/removed/
    offload_cache blobs}. Keys are the 16-byte chained block hash
    (common/hashing.py): raw ``bytes`` on the msgpack heartbeat wire
    (half the bytes, no hex codec on either end), hex ``str`` on the
    legacy JSON wire. Each list is homogeneous; consumers normalize via
    ``hashing.as_key``. ``to_dict`` renders hex (JSON-safe),
    ``to_wire_dict`` renders raw bytes (msgpack-only).
    """

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
        """Union of two replicas' deltas (dp_size>1: the instance-level
        event is the union of its replicas'; a block removed by one replica
        but stored by another stays stored). Same best-state rule for
        tiers: a block one replica offloaded cold but another holds in HBM
        ships stored-only — the index applies stored before offloaded, so
        shipping both would demote the instance below its best tier.
        Within ONE delta stored+offloaded is the donate-then-evict
        sequence (per-replica deltas are internally ordered) and the cold
        move must survive, hence the per-side stored-minus-offloaded
        sets."""
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
        """JSON-safe form: hex-string keys (legacy heartbeat wire)."""
        return {"stored": self._hexes(self.stored),
                "removed": self._hexes(self.removed),
                "offloaded": self._hexes(self.offloaded)}

    def to_wire_dict(self) -> dict[str, Any]:
        """msgpack form: raw 16-byte keys (binary heartbeat wire)."""
        return {"stored": self._raws(self.stored),
                "removed": self._raws(self.removed),
                "offloaded": self._raws(self.offloaded)}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KvCacheEvent":
        return cls(**{k: list(v) for k, v in d.items()
                      if k in cls.__dataclass_fields__ and v is not None})


class CacheTier(str, enum.Enum):
    """KV block residence tier (reference `common/types.h:320-365`
    CacheLocations{hbm,dram,ssd}). On TPU: HBM = device memory,
    DRAM = TPU-VM host memory, SSD = local disk."""

    HBM = "hbm"
    DRAM = "dram"
    SSD = "ssd"


@dataclass
class CacheLocations:
    """Which instances hold a given KV block, per tier."""

    hbm: set[str] = field(default_factory=set)
    dram: set[str] = field(default_factory=set)
    ssd: set[str] = field(default_factory=set)

    def empty(self) -> bool:
        return not (self.hbm or self.dram or self.ssd)

    def remove_instance(self, name: str) -> None:
        self.hbm.discard(name)
        self.dram.discard(name)
        self.ssd.discard(name)

    def to_dict(self) -> dict[str, Any]:
        return {"hbm": sorted(self.hbm), "dram": sorted(self.dram), "ssd": sorted(self.ssd)}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CacheLocations":
        return cls(hbm=set(d.get("hbm", ())), dram=set(d.get("dram", ())), ssd=set(d.get("ssd", ())))

    def to_row(self) -> list[list[str]]:
        """Compact positional [hbm, dram, ssd] form for binary KV frames
        (rpc/wire.py encode_kv_frame) — no per-entry field names."""
        return [sorted(self.hbm), sorted(self.dram), sorted(self.ssd)]

    @classmethod
    def from_row(cls, row: Sequence[Any]) -> "CacheLocations":
        return cls(hbm=set(row[0]), dram=set(row[1]), ssd=set(row[2]))


@dataclass
class OverlapScores:
    """Prefix-cache match result per candidate instance
    (reference `common/types.h:376-403`)."""

    # instance name -> number of matched KV blocks (per tier-weighted score).
    scores: dict[str, float] = field(default_factory=dict)
    max_block_num: int = 0
    # Depth of the matched prefix: how many leading full blocks were found
    # in the global index before the first miss (the radix-walk depth).
    matched_blocks: int = 0


@dataclass
class Routing:
    """Chosen (prefill, decode[, encode]) instance pair for a request
    (reference `common/types.h:43-55`)."""

    prefill_name: str = ""
    decode_name: str = ""
    encode_name: str = ""

    def valid(self) -> bool:
        return bool(self.prefill_name)


@dataclass
class RequestMetrics:
    """Per-request SLO accounting (reference `common/types.h:161-178`)."""

    prompt_tokens: int = 0
    generated_tokens: int = 0
    schedule_time_ms: int = 0
    prefill_finish_time_ms: int = 0
    finish_time_ms: int = 0
    estimated_ttft_ms: float = 0.0


@dataclass
class InstanceLoadInfo:
    """Aggregated per-instance info handed to LB policies
    (reference `common/types.h:405-437` LoadBalanceInfos)."""

    name: str = ""
    type: InstanceType = InstanceType.DEFAULT
    load: LoadMetrics = field(default_factory=LoadMetrics)
    latency: LatencyMetrics = field(default_factory=LatencyMetrics)
    schedulable: bool = True
    # When this entry's telemetry was last refreshed (heartbeat on the
    # master; LOADMETRICS mirror on replicas). 0 = never. Multi-master
    # frontends score routing off mirrored telemetry, so CAR/SLO scoring
    # discounts entries older than `loadinfo_stale_after_s`.
    updated_ms: int = 0
    # Effective placement coordinate (common/topology.py effective_coord):
    # synthetic per-host slice when the registration carried no host, so
    # the planner/policies can always compare slices without re-deriving.
    slice_id: str = ""
    host: str = ""
