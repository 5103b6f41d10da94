"""The dispatch, heartbeat and telemetry wire of the engine's side (copy of
the engine-side part of ``xllm_service_tpu/rpc/wire.py``), with every
msgpack byte through ``rpc/msgpack_lite.py``.

- ``encode_dispatch(payload, fmt)``: msgpack (``WIRE_MSGPACK``) or compact
  JSON. msgpack maps keep insertion order, so the same dict always gives
  the same bytes.
- ``decode_body(content_type, data)``: the inverse, chosen by content
  type; a malformed body raises ValueError (the agent answers 400).
- ``encode_telemetry(frames)``: the tagged frames of the multiplexed
  telemetry session to the owning master's ``/rpc/telemetry``:
  ``{"t": "hb", "d": beat}`` and ``{"t": "gens", "dest": addr, "d":
  {"gens": [...]}}``; always msgpack.
- ``negotiate(wire_formats)``: the dispatch format for an instance that
  advertises ``wire_formats``.

The engine advertises ``[WIRE_MSGPACK, WIRE_JSON]``; the master then
dispatches msgpack to it.

The master's half: ``encode_kv_frame``/``decode_kv_frame`` (the KV-index
delta frames the master writes to coordination each sync tick) and
``encode_load_frame``/``decode_load_frame`` (a telemetry owner's coalesced
load frame), each base64(msgpack) since coordination values are strings.

Every msgpack and base64(msgpack) byte goes through the port's native hot
core first (``common/native.py``, component ``wire``): it returns the
same bytes as the pure path or ``MISS``, and on ``MISS`` the pure path
below runs.

``HOT_PATH_FUNCTIONS`` is the registry behind xlint's ``hot-json`` rule:
inside these functions, hand-rolled ``json.dumps``/``json=`` encoding is
a lint violation (hatch: ``# xlint: allow-hot-json(reason)``) — dispatch
bytes must come from this module so the wire stays symmetric and the
negotiation stays in one place.
"""

from __future__ import annotations

import base64
import json
from typing import Any

from ..common import native as _native
from . import msgpack_lite

#: Wire format names (the values carried in InstanceMetaInfo.wire_formats).
WIRE_MSGPACK = "msgpack"
WIRE_JSON = "json"

MSGPACK_CONTENT_TYPE = msgpack_lite.CONTENT_TYPE
JSON_CONTENT_TYPE = "application/json"

#: Frame tags of the multiplexed telemetry session.
TELEMETRY_HB = "hb"
TELEMETRY_GENS = "gens"

#: Registered hot-path dispatch call sites ("Class.method" or a bare
#: module-level function name → why it is hot). xlint's hot-json rule is
#: bidirectional over this registry: each entry must resolve to a live
#: function in the tree, and inside each, ``json.dumps(...)`` calls and
#: ``json=`` kwargs are violations unless hatched with
#: ``# xlint: allow-hot-json(reason)``.
HOT_PATH_FUNCTIONS: dict[str, str] = {
    "XllmHttpService._forward_to_instance":
        "initial engine dispatch from the HTTP frontend",
    "XllmHttpService.handle_generations":
        "token-return ingest (hottest service endpoint)",
    "XllmHttpService.handle_telemetry":
        "multiplexed engine telemetry ingest (tagged hb/gens frames + "
        "master->master gens relay)",
    "XllmHttpService._respond":
        "SSE emit loop (client-facing frames are protocol JSON)",
    "Scheduler._failover_loop":
        "failover replay dispatch",
    "EngineChannel.forward":
        "sync dispatch fallback / failover wire",
    "GenerationStreamer._send":
        "engine agent batched Generations push",
    "FakeEngine._generate":
        "fake-engine Generations push (wire-contract reference impl)",
    "EngineAgent._heartbeat_loop":
        "heartbeat push (KV-cache event deltas, raw 16-byte keys)",
    "FakeEngine._heartbeat_loop":
        "fake-engine heartbeat push (wire-contract reference impl)",
    "GlobalKVCacheMgr.upload_kvcache":
        "master→coordination KV-index sync (binary delta frames)",
    "OwnershipRouter.owner_of":
        "per-request ownership resolution (every accept + every relay)",
    "OwnershipRouter.instance_owner":
        "per-beat telemetry-shard verdict (memoized on the published "
        "member tuple; native rendezvous walk on miss)",
    "SimpleTokenizer.encode":
        "per-request prompt tokenization inside the route loop (the "
        "profiler's hottest route frame; native byte-id fast path)",
    "HandoffRelay._relay_stream":
        "owner-forward SSE relay (frames must pass through as raw bytes)",
    "XllmHttpService.handle_handoff":
        "owner-side ingest of relayed requests (full dispatch pipeline)",
    "TieredKVStore.offload":
        "per-eviction tier-offload admission (engine thread, never blocks)",
    "TieredKVStore.fetch":
        "cold-tier onload read on the engine admission path",
    "InferenceEngine._pump_tier_offloads":
        "eviction drain after every page allocation (decode loop)",
    "InferenceEngine._onload_cold_prefix":
        "cold-prefix extension walk at admission (ahead of prefill)",
    "StreamOfferTable.read_chunk":
        "per-chunk streaming-transfer serve (one memoryview slice)",
    "pull_stream":
        "chunked KV pull loop (decode-side executor thread, paced)",
    "EngineAgent._h_kv_stream_pull":
        "streaming-transfer pull endpoint (msgpack frames)",
    "SamplingProfiler._sample_once":
        "always-on ~19 Hz wall-clock stack sampler tick (overhead gate "
        "<=1%: benchmarks/bench_profile_overhead.py)",
    # RCU snapshot readers (rcu-read single-load discipline applies: one
    # load of the publication attribute per call, or two loads may
    # observe different snapshots — the copy-on-write torn-read smell).
    "GlobalKVCacheMgr.match":
        "lock-free prefix-index walk on every CAR schedule",
    "InstanceMgr.get_next_instance_pair":
        "RR pair selection off the routing snapshot",
    "InstanceMgr.select_instance_pair_on_slo":
        "SLO pair selection off the routing snapshot",
    "select_pair_on_slo":
        "lock-free SLO selection kernel (snapshot + request-load view + "
        "staleness-aware predictive scoring)",
    "SloAwarePolicy.select_instances_pair":
        "whole SLO_AWARE selection on the schedule path",
    "InstanceMgr.get_request_loads":
        "published request-load accessor for SLO predictive scoring",
    "AutoscalerController.tick":
        "autoscaler decision loop (sync cadence; lock-free telemetry "
        "gather, pure kernel, rate-limited enactment)",
    "InstanceMgr.bind_request_instance_incarnations":
        "RCU bind re-validation against the current snapshot",
    "InstanceMgr.get_channel":
        "per-dispatch channel lookup off the routing snapshot",
    "InstanceMgr.get_load_infos":
        "published load-info accessor for CAR/planner scoring",
    "CacheAwareRoutingPolicy.select_instances_pair":
        "whole CAR selection (match + load-info scoring, lock-free)",
}



def pack_dispatch(payload: dict[str, Any]) -> bytes:
    """Deterministic msgpack encoding of a dispatch payload (the bytes of
    ``msgpack.packb(payload, use_bin_type=True)``)."""
    enc = _native.packb(payload)
    if enc is not _native.MISS:
        return enc
    return msgpack_lite.packb(payload)


def unpack_dispatch(data: bytes) -> Any:
    obj = _native.unpackb(data)
    if obj is not _native.MISS:
        return obj
    return msgpack_lite.unpackb(data)


def encode_dispatch(payload: dict[str, Any],
                    fmt: str = WIRE_JSON) -> tuple[bytes, str]:
    """Serialize a payload for the wire. Returns (body bytes, content
    type)."""
    if fmt == WIRE_MSGPACK:
        return pack_dispatch(payload), MSGPACK_CONTENT_TYPE
    return (json.dumps(payload, separators=(",", ":")).encode(),
            JSON_CONTENT_TYPE)


def decode_body(content_type: str, data: bytes) -> Any:
    """Inverse of :func:`encode_dispatch`. Raises ValueError on a
    malformed body (callers answer 400)."""
    if content_type and MSGPACK_CONTENT_TYPE in content_type:
        try:
            return unpack_dispatch(data)
        except (ValueError, TypeError, OverflowError, UnicodeDecodeError) \
                as e:
            raise ValueError(f"malformed msgpack body: {e}") from None
    return json.loads(data)


def encode_telemetry(frames: "list[dict]") -> tuple[bytes, str]:
    """Tagged telemetry frames for one POST to ``/rpc/telemetry``. Always
    msgpack: a master without the route answers 404 and the engine falls
    back to the per-endpoint wires."""
    enc = _native.packb({"frames": frames})
    if enc is _native.MISS:
        enc = msgpack_lite.packb({"frames": frames})
    return enc, MSGPACK_CONTENT_TYPE


def negotiate(wire_formats: Any) -> str:
    """The dispatch format for an instance advertising `wire_formats`
    (missing, empty or legacy metadata: JSON)."""
    try:
        return WIRE_MSGPACK if WIRE_MSGPACK in (wire_formats or ()) \
            else WIRE_JSON
    except TypeError:
        return WIRE_JSON


def _b64_pack(frame: dict) -> str:
    enc = _native.pack_b64(frame)
    if enc is not _native.MISS:
        return enc
    return base64.b64encode(msgpack_lite.packb(frame)).decode("ascii")


def _b64_unpack(value: Any) -> Any:
    frame = _native.unpack_b64(value)
    if frame is _native.MISS:
        frame = msgpack_lite.unpackb(base64.b64decode(value))
    return frame


def encode_kv_frame(upserts: "dict[bytes, Any]", removals: "list[bytes]",
                    full: bool = False) -> str:
    """One sync tick's KV-index delta: ``upserts`` maps a raw block key to
    its positional [hbm, dram, ssd] instance-name row; ``full`` marks a
    compaction frame carrying the entire index."""
    frame = {"u": upserts, "r": list(removals)}
    if full:
        frame["full"] = True
    return _b64_pack(frame)


def decode_kv_frame(value: str) -> "tuple[dict[bytes, Any], list[bytes], bool]":
    """Inverse of :func:`encode_kv_frame` -> (upserts, removals, full).
    Raises ValueError on a malformed frame (callers skip it)."""
    try:
        frame = _b64_unpack(value)
        if not isinstance(frame, dict):
            raise TypeError("frame is not a map")
        upserts = frame.get("u") or {}
        removals = list(frame.get("r") or ())
        if not isinstance(upserts, dict):
            raise TypeError("frame upserts is not a map")
    except Exception as e:  # base64 and the decoder raise their own types
        raise ValueError(f"malformed kv frame: {e}") from None
    return upserts, removals, bool(frame.get("full"))


def encode_load_frame(instances: dict, gone: "dict[str, str]", seq: int,
                      now_ms: int) -> str:
    """One owner's telemetry shard: ``instances`` maps a name to {"l":
    load, "y": latency, "hb": last heartbeat ms, "up": telemetry-updated
    ms, "st": runtime state}; ``gone`` maps recently evicted instances to
    the reason; ``now_ms`` is the owner's clock at build time."""
    return _b64_pack({"i": instances, "g": dict(gone), "s": seq,
                      "ms": now_ms})


def decode_load_frame(value: str) -> dict:
    """Inverse of :func:`encode_load_frame`. Raises ValueError on a
    malformed frame (callers skip it)."""
    try:
        frame = _b64_unpack(value)
        if not isinstance(frame, dict) or not isinstance(
                frame.get("i", {}), dict):
            raise TypeError("load frame is not a map")
    except Exception as e:  # base64 and the decoder raise their own types
        raise ValueError(f"malformed load frame: {e}") from None
    frame.setdefault("i", {})
    frame.setdefault("g", {})
    return frame
