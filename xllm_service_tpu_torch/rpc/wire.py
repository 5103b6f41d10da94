"""The JSON half of the dispatch wire (copy of the part of
``xllm_service_tpu/rpc/wire.py`` the port's agent speaks).

The reference master negotiates the dispatch format per instance from the
``wire_formats`` an engine advertises; the port's agent advertises
``["json"]`` only (the msgpack package is not part of the port's
environment), so the master sends it JSON. A body marked msgpack is
refused with :class:`UnsupportedMediaType`, which the agent answers with
HTTP 415: the reply on which the master demotes an instance to JSON and
re-sends.
"""

from __future__ import annotations

import json
from typing import Any

#: Wire format names (the values carried in InstanceMetaInfo.wire_formats).
WIRE_JSON = "json"

MSGPACK_CONTENT_TYPE = "application/msgpack"
JSON_CONTENT_TYPE = "application/json"


class UnsupportedMediaType(ValueError):
    """A body in a format this engine does not parse (HTTP 415)."""


def encode_dispatch(payload: dict[str, Any]) -> tuple[bytes, str]:
    """Serialize a payload for the JSON wire. Returns (body bytes, content
    type)."""
    return (json.dumps(payload, separators=(",", ":")).encode(),
            JSON_CONTENT_TYPE)


def decode_body(content_type: str, data: bytes) -> Any:
    """Inverse of :func:`encode_dispatch`. Raises UnsupportedMediaType on
    a msgpack body and ValueError on malformed JSON (callers answer 415
    and 400)."""
    if content_type and MSGPACK_CONTENT_TYPE in content_type:
        raise UnsupportedMediaType(
            "msgpack bodies are not parsed by this engine; send JSON")
    return json.loads(data)
