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
dispatches msgpack to it. The reference's KV-index and load frames are
the master's and are not here.
"""

from __future__ import annotations

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
