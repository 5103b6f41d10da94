"""Per-request client-connection abstraction.

Parity: reference `common/call_data.h` CallData / StreamCallData — the
response writer handed to the scheduler's output callbacks: `write()` frames
one SSE `data: <json>\n\n` chunk (`call_data.h:177-197`), `finish()` sends
`data: [DONE]` (`call_data.h:199-205`), `finish_with_error` maps to an HTTP
error body, `is_disconnected` surfaces client aborts so generation can be
cancelled upstream (`call_data.h:207-216`). The HTTP layer implements this
over aiohttp streaming responses; tests use :class:`CollectingConnection`.
"""

from __future__ import annotations

import abc
import json
from typing import Any, Optional


class ClientConnection(abc.ABC):
    stream: bool = False

    @abc.abstractmethod
    def write_event(self, event: str, obj: dict[str, Any]) -> bool:
        """Named SSE event (`event: <name>` framing — the Anthropic
        Messages stream shape). Default: plain data write."""
        return self.write(obj)

    def write(self, obj: dict[str, Any]) -> bool:
        """Deliver one payload (SSE chunk when streaming). Returns False if
        the client is gone."""

    @abc.abstractmethod
    def finish(self) -> bool:
        """Complete the response ([DONE] sentinel when streaming)."""

    def write_and_finish(self, obj: dict[str, Any]) -> bool:
        ok = self.write(obj)
        return self.finish() and ok

    @abc.abstractmethod
    def finish_with_error(self, code: int, message: str) -> bool: ...

    @abc.abstractmethod
    def is_disconnected(self) -> bool: ...


def sse_frame(obj: dict[str, Any] | str) -> bytes:
    data = obj if isinstance(obj, str) else json.dumps(obj, ensure_ascii=False)
    return f"data: {data}\n\n".encode()


SSE_DONE = b"data: [DONE]\n\n"


class CollectingConnection(ClientConnection):
    """Test double: records everything written."""

    def __init__(self, stream: bool = False):
        self.stream = stream
        self.payloads: list[dict[str, Any]] = []
        self.events: list[tuple[str, dict[str, Any]]] = []
        self.finished = False
        self.error: Optional[tuple[int, str]] = None
        self.disconnected = False

    def write(self, obj: dict[str, Any]) -> bool:
        if self.disconnected:
            return False
        self.payloads.append(obj)
        return True

    def write_event(self, event: str, obj: dict[str, Any]) -> bool:
        if self.disconnected:
            return False
        self.events.append((event, obj))
        self.payloads.append(obj)
        return True

    def finish(self) -> bool:
        self.finished = True
        return not self.disconnected

    def finish_with_error(self, code: int, message: str) -> bool:
        self.error = (code, message)
        self.finished = True
        return True

    def is_disconnected(self) -> bool:
        return self.disconnected
