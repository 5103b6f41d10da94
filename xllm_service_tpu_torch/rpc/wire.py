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
"""

from __future__ import annotations

import base64
import json
from typing import Any

from . import msgpack_lite

#: Wire format names (the values carried in InstanceMetaInfo.wire_formats).
WIRE_MSGPACK = "msgpack"
WIRE_JSON = "json"

MSGPACK_CONTENT_TYPE = msgpack_lite.CONTENT_TYPE
JSON_CONTENT_TYPE = "application/json"

#: Frame tags of the multiplexed telemetry session.
TELEMETRY_HB = "hb"
TELEMETRY_GENS = "gens"


def pack_dispatch(payload: dict[str, Any]) -> bytes:
    """Deterministic msgpack encoding of a dispatch payload (the bytes of
    ``msgpack.packb(payload, use_bin_type=True)``)."""
    return msgpack_lite.packb(payload)


def unpack_dispatch(data: bytes) -> Any:
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
    return msgpack_lite.packb({"frames": frames}), MSGPACK_CONTENT_TYPE


def negotiate(wire_formats: Any) -> str:
    """The dispatch format for an instance advertising `wire_formats`
    (missing, empty or legacy metadata: JSON)."""
    try:
        return WIRE_MSGPACK if WIRE_MSGPACK in (wire_formats or ()) \
            else WIRE_JSON
    except TypeError:
        return WIRE_JSON


def _b64_pack(frame: dict) -> str:
    return base64.b64encode(msgpack_lite.packb(frame)).decode("ascii")


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
        frame = msgpack_lite.unpackb(base64.b64decode(value))
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
        frame = msgpack_lite.unpackb(base64.b64decode(value))
        if not isinstance(frame, dict) or not isinstance(
                frame.get("i", {}), dict):
            raise TypeError("load frame is not a map")
    except Exception as e:  # base64 and the decoder raise their own types
        raise ValueError(f"malformed load frame: {e}") from None
    frame.setdefault("i", {})
    frame.setdefault("g", {})
    return frame
