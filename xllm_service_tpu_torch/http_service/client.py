"""An HTTP/1.1 client on ``asyncio`` streams, beside the server of
``web.py``.

It offers the part of aiohttp's ``ClientSession`` surface the handoff
relay (``multimaster/handoff.py``) uses, on the event loop (a relay holds
its stream for the whole generation, so no thread per stream):

- ``async with session.post(url, data=..., headers=..., timeout=...) as r``
  sends one request with its headers and body on a connection of its own
  (``Connection: close``), and ``session.get(url, params=..., ...)`` a GET
  with its query (the master's fleet fan-outs);
- :class:`ClientResponse` has ``status``, ``headers``
  (case-insensitive), ``content_type`` (the MIME type without its
  parameters), :meth:`~ClientResponse.read` and
  :meth:`~ClientResponse.iter_chunks` (and :meth:`~ClientResponse.text`
  and :meth:`~ClientResponse.json` on the whole body), for bodies framed by
  ``Content-Length``, by chunked transfer or by the connection's close;
- :class:`ClientTimeout`: ``total`` bounds the request from its connect to
  the end of its body, ``sock_connect`` the connect, and ``sock_read``
  every single read — the stall timeout that tells a killed-but-open peer
  from a slow one;
- :meth:`ClientResponse.close` aborts the connection at once (a reset, not
  a drain), as aiohttp's does.

A failed connect, a reset, a malformed answer or a body cut short raise
:class:`ClientError`; an expired timeout raises ``asyncio.TimeoutError``.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional
from urllib.parse import urlencode, urlsplit

from .web import Headers

_MAX_LINE = 8190
_READ = 1 << 16


class ClientError(Exception):
    """A transport failure: refused, reset, malformed or cut short."""


@dataclass
class ClientTimeout:
    total: Optional[float] = None
    sock_connect: Optional[float] = None
    sock_read: Optional[float] = None


class ClientResponse:
    """The head of a response, and its body read on demand."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, status: int,
                 headers: Headers, deadline: Optional[float],
                 sock_read: Optional[float]) -> None:
        self.status = status
        self.headers = headers
        ctype = headers.get("Content-Type", "")
        self.content_type = ctype.split(";", 1)[0].strip().lower()
        self._reader = reader
        self._writer = writer
        self._deadline = deadline
        self._sock_read = sock_read
        self._body: Optional[bytes] = None
        te = headers.get("Transfer-Encoding", "").lower()
        self._chunked = "chunked" in te
        cl = headers.get("Content-Length")
        self._length = int(cl) if cl is not None and not self._chunked \
            else None

    async def _io(self, coro):
        """One read, bounded by the stall timeout and what is left of the
        total one; transport errors become :class:`ClientError`."""
        limits = [t for t in (self._sock_read,) if t is not None]
        if self._deadline is not None:
            limits.append(self._deadline - asyncio.get_running_loop().time())
        try:
            if limits:
                return await asyncio.wait_for(coro, max(0.0, min(limits)))
            return await coro
        except asyncio.IncompleteReadError as e:
            raise ClientError(
                f"response body cut short ({len(e.partial)} bytes of "
                f"{e.expected})") from e
        except asyncio.LimitOverrunError as e:
            raise ClientError("response line too long") from e
        except asyncio.TimeoutError:
            raise                   # an OSError too, since Python 3.11
        except OSError as e:
            raise ClientError(str(e) or type(e).__name__) from e

    async def iter_chunks(self) -> AsyncIterator[bytes]:
        """The body's pieces as they arrive: each chunk of a chunked body,
        else what each read returns."""
        if self._chunked:
            while True:
                line = await self._io(self._reader.readline())
                if not line:
                    raise ClientError("chunked body cut short")
                try:
                    size = int(line.split(b";", 1)[0].strip(), 16)
                except ValueError as e:
                    raise ClientError(
                        f"bad chunk size line {line[:40]!r}") from e
                if size == 0:
                    while (await self._io(self._reader.readline())) \
                            not in (b"\r\n", b"\n", b""):
                        pass
                    return
                data = await self._io(self._reader.readexactly(size))
                await self._io(self._reader.readexactly(2))
                yield data
        elif self._length is not None:
            left = self._length
            while left > 0:
                data = await self._io(self._reader.read(min(left, _READ)))
                if not data:
                    raise ClientError(
                        f"response body cut short ({self._length - left} "
                        f"bytes of {self._length})")
                left -= len(data)
                yield data
        else:
            while True:
                data = await self._io(self._reader.read(_READ))
                if not data:
                    return
                yield data

    async def read(self) -> bytes:
        if self._body is None:
            out = bytearray()
            async for piece in self.iter_chunks():
                out += piece
            self._body = bytes(out)
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8", "replace")

    async def json(self) -> Any:
        """The body as JSON, whatever its content type (aiohttp's
        ``json(content_type=None)``); ``ValueError`` if it is not."""
        return json.loads(await self.read())

    def close(self) -> None:
        """Abort the connection now: the peer sees a reset at its next
        write."""
        self._writer.transport.abort()

    def release(self) -> None:
        self._writer.close()


class _RequestContext:
    """``async with session.post(...) as r``: the response on entry, the
    connection closed on exit."""

    def __init__(self, coro) -> None:
        self._coro = coro
        self._resp: Optional[ClientResponse] = None

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            self._resp.release()


class ClientSession:
    """POSTs and GETs, each on a connection of its own (nothing is pooled:
    a relayed stream holds its connection for the whole generation)."""

    def post(self, url: str, data: bytes = b"",
             headers: Optional[dict] = None,
             timeout: ClientTimeout = ClientTimeout()) -> _RequestContext:
        return _RequestContext(
            self._request("POST", url, data, headers, timeout))

    def get(self, url: str, params: Optional[dict] = None,
            headers: Optional[dict] = None,
            timeout: ClientTimeout = ClientTimeout()) -> _RequestContext:
        if params:
            url += ("&" if "?" in url else "?") + urlencode(params)
        return _RequestContext(
            self._request("GET", url, b"", headers, timeout))

    async def _request(self, method: str, url: str, data: bytes,
                       headers: Optional[dict],
                       timeout: ClientTimeout) -> ClientResponse:
        u = urlsplit(url)
        if u.scheme != "http" or not u.hostname:
            raise ClientError(f"unsupported URL {url!r}")
        loop = asyncio.get_running_loop()
        deadline = (loop.time() + timeout.total
                    if timeout.total is not None else None)
        limits = [t for t in (timeout.sock_connect, timeout.total)
                  if t is not None]
        try:
            conn = asyncio.open_connection(u.hostname, u.port or 80,
                                           limit=2 ** 20)
            reader, writer = (await asyncio.wait_for(conn, min(limits))
                              if limits else await conn)
        except asyncio.TimeoutError:
            raise
        except OSError as e:
            raise ClientError(
                f"cannot connect to {u.netloc}: {e}") from e
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        head = Headers({"Host": u.netloc, "Connection": "close",
                        "Accept-Encoding": "identity"})
        for k, v in (headers or {}).items():
            head[k] = v
        body = data or b""
        head["Content-Length"] = str(len(body))
        lines = [f"{method} {target} HTTP/1.1"]
        lines += [f"{k}: {v}" for k, v in head.items()]
        try:
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                         + body)
            resp = ClientResponse(reader, writer, 0, Headers(), deadline,
                                  timeout.sock_read)
            status_line = await resp._io(reader.readline())
            parts = status_line.decode("latin-1").split(None, 2)
            if len(parts) < 2 or not parts[0].startswith("HTTP/"):
                raise ClientError(
                    f"bad status line {status_line[:80]!r}"
                    if status_line else "server closed the connection")
            hdrs = Headers()
            while True:
                h = await resp._io(reader.readline())
                if h in (b"\r\n", b"\n", b""):
                    break
                if len(h) > _MAX_LINE:
                    raise ClientError("header line too long")
                name, _, value = h.decode("latin-1").partition(":")
                hdrs[name.strip()] = value.strip()
            return ClientResponse(reader, writer, int(parts[1]), hdrs,
                                  deadline, timeout.sock_read)
        except BaseException:
            writer.transport.abort()
            raise
