"""aiohttp-backed ClientConnection.

Parity: reference `StreamCallData` over brpc ProgressiveAttachment
(`common/call_data.h:87-216`): SSE headers sent early, `data: <json>\n\n`
framing, `data: [DONE]` terminator, disconnect detection surfaced to the
scheduler so engines can be cancelled.

Scheduler output lanes are plain threads; deliveries are marshaled onto the
event loop via `call_soon_threadsafe` into an asyncio queue drained by the
request handler coroutine.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

from ..common.call_data import ClientConnection

_FINISH = object()


class AioConnection(ClientConnection):
    def __init__(self, loop: asyncio.AbstractEventLoop, stream: bool):
        self.stream = stream
        self._loop = loop
        self.queue: "asyncio.Queue[Any]" = asyncio.Queue()
        self._disconnected = False
        self.error: Optional[tuple[int, str]] = None

    # ---- called from scheduler output lanes (threads) ----
    def _put(self, item: Any) -> None:
        self._loop.call_soon_threadsafe(self.queue.put_nowait, item)

    def write(self, obj: dict[str, Any]) -> bool:
        if self._disconnected:
            return False
        self._put(("data", obj))
        return True

    def write_event(self, event: str, obj: dict[str, Any]) -> bool:
        if self._disconnected:
            return False
        self._put(("event", (event, obj)))
        return True

    def finish(self) -> bool:
        self._put((_FINISH, None))
        return not self._disconnected

    def finish_with_error(self, code: int, message: str) -> bool:
        self.error = (code, message)
        self._put(("error", (code, message)))
        return True

    def is_disconnected(self) -> bool:
        return self._disconnected

    # ---- called from the handler coroutine ----
    def mark_disconnected(self) -> None:
        self._disconnected = True

    @staticmethod
    def is_finish(tag: Any) -> bool:
        return tag is _FINISH
