"""The HTTP/1.1 server of the master, on ``asyncio`` streams.

It serves the part of aiohttp's ``web`` surface the reference frontend
uses, with the same bytes on the wire where clients and agents can see
them:

- keep-alive connections (HTTP/1.1 unless ``Connection: close``; HTTP/1.0
  only with ``Connection: keep-alive``), requests served in order;
- request bodies by ``Content-Length`` or chunked transfer, at most
  ``client_max_size`` bytes (413 above it);
- :func:`json_response` (``json.dumps`` with its default separators,
  ``application/json; charset=utf-8``) and :class:`Response` with text
  (``charset=utf-8``) or bytes; :func:`reply` for the admin helpers'
  ``(status, payload)``;
- :class:`StreamResponse`: headers on :meth:`~StreamResponse.prepare`,
  then each :meth:`~StreamResponse.write` leaves the socket as one chunk
  of chunked transfer before it returns (an SSE delta is sent when it is
  written, not when a buffer fills); a write on a connection the client
  closed raises ``ConnectionResetError``;
- 404 ``404: Not Found`` and 405 ``405: Method Not Allowed`` (with
  ``Allow``) as ``text/plain``; ``HEAD`` on a GET route (headers only);
  an exception in a handler answers 500;
- middlewares, and ``on_startup``/``on_cleanup`` hooks.

A handler is not cancelled when its client goes away (aiohttp's default):
a stream notices at its next write, a whole response is dropped.
"""

from __future__ import annotations

import asyncio
import json
import logging
from email.utils import formatdate
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Optional
from urllib.parse import parse_qsl, urlsplit

logger = logging.getLogger(__name__)

Handler = Callable[["Request"], Awaitable["StreamResponse"]]

CLIENT_MAX_SIZE = 1024 ** 2
_MAX_LINE = 8190
_MAX_HEADERS = 128
_SERVER = "Python http_service"


class Headers:
    """Case-insensitive header map that keeps the names as given."""

    def __init__(self, items: Any = ()) -> None:
        self._d: dict[str, tuple[str, str]] = {}
        pairs = items.items() if hasattr(items, "items") else items
        for k, v in pairs:
            self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        self._d[key.lower()] = (key, str(value))

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and key.lower() in self._d

    def get(self, key: str, default: Any = None) -> Any:
        v = self._d.get(key.lower())
        return v[1] if v is not None else default

    def setdefault(self, key: str, value: Any) -> str:
        if key not in self:
            self[key] = value
        return self[key]

    def items(self):
        return list(self._d.values())



class HTTPException(Exception):
    """A handler's or the server's error answer."""

    def __init__(self, status: int, text: str = "",
                 headers: Optional[dict] = None) -> None:
        super().__init__(text)
        self.status = status
        self.text = text or f"{status}: {HTTPStatus(status).phrase}"
        self.headers = headers or {}

    def response(self) -> "Response":
        return Response(status=self.status, text=self.text,
                        content_type="text/plain", headers=self.headers)


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Headers, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 client_max_size: int) -> None:
        self.method = method
        self.version = version
        self.headers = headers
        u = urlsplit(target)
        self.path = u.path or "/"
        self.query = dict(parse_qsl(u.query, keep_blank_values=True))
        self.transport = writer.transport
        self._reader = reader
        self._writer = writer
        self._max = client_max_size
        self._body: Optional[bytes] = None
        ctype = headers.get("Content-Type", "")
        self.content_type = (ctype.split(";", 1)[0].strip().lower()
                             or "application/octet-stream")

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("Connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    async def read(self) -> bytes:
        if self._body is None:
            self._body = await self._read_body()
        return self._body

    async def _read_body(self) -> bytes:
        te = self.headers.get("Transfer-Encoding", "").lower()
        if "chunked" in te:
            out = bytearray()
            while True:
                line = await self._reader.readline()
                size = int(line.split(b";", 1)[0].strip() or b"0", 16)
                if size == 0:
                    while (await self._reader.readline()) not in (b"\r\n",
                                                                  b"\n", b""):
                        pass
                    break
                if len(out) + size > self._max:
                    raise _too_large(self._max, len(out) + size)
                out += await self._reader.readexactly(size)
                await self._reader.readline()
            return bytes(out)
        n = int(self.headers.get("Content-Length", "0") or 0)
        if n > self._max:
            raise _too_large(self._max, n)
        return await self._reader.readexactly(n) if n else b""

    async def json(self) -> Any:
        return json.loads(await self.read())


def _too_large(limit: int, actual: int) -> HTTPException:
    return HTTPException(
        413, f"Maximum request body size {limit} exceeded, actual body "
             f"size {actual}")


class StreamResponse:
    """A response whose body is written in pieces after :meth:`prepare`
    (chunked transfer)."""

    def __init__(self, status: int = 200,
                 headers: Optional[dict] = None) -> None:
        self.status = status
        self.headers = Headers(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None
        self._eof = False
        self.prepared = False

    @property
    def content_type(self) -> str:
        return self.headers.get("Content-Type", "")

    def _head(self, extra: list[tuple[str, str]]) -> bytes:
        lines = [f"HTTP/1.1 {self.status} {HTTPStatus(self.status).phrase}"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        lines += [f"{k}: {v}" for k, v in extra if k not in self.headers]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    def _check(self) -> asyncio.StreamWriter:
        w = self._writer
        if w is None or w.transport.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        return w

    async def prepare(self, request: Request) -> "StreamResponse":
        if self.prepared:
            return self
        self._writer = request._writer
        self.headers.setdefault("Content-Type", "application/octet-stream")
        w = self._check()
        w.write(self._head([("Transfer-Encoding", "chunked"),
                            ("Date", formatdate(usegmt=True)),
                            ("Server", _SERVER)]))
        self.prepared = True
        await w.drain()
        return self

    async def write(self, data: bytes) -> None:
        if not data:
            return
        w = self._check()
        w.write(b"%x\r\n%b\r\n" % (len(data), data))
        await w.drain()

    async def write_eof(self) -> None:
        if self._eof:
            return
        self._eof = True
        w = self._check()
        w.write(b"0\r\n\r\n")
        await w.drain()


class Response(StreamResponse):
    """A whole response with ``Content-Length``."""

    def __init__(self, body: Optional[bytes] = None, status: int = 200,
                 text: Optional[str] = None,
                 content_type: Optional[str] = None,
                 headers: Optional[dict] = None) -> None:
        super().__init__(status, headers)
        if text is not None:
            self.body = text.encode("utf-8")
            ctype = content_type or "text/plain"
            if "charset" not in ctype:
                ctype += "; charset=utf-8"
        else:
            self.body = body or b""
            ctype = content_type or "application/octet-stream"
        if "Content-Type" not in self.headers:
            self.headers["Content-Type"] = ctype

    @property
    def text(self) -> str:
        return self.body.decode("utf-8")

    async def send(self, request: Request) -> None:
        self._writer = request._writer
        w = self._check()
        head = self._head([("Content-Length", str(len(self.body))),
                           ("Date", formatdate(usegmt=True)),
                           ("Server", _SERVER)])
        w.write(head if request.method == "HEAD" else head + self.body)
        self.prepared = True
        await w.drain()


def json_response(data: Any, status: int = 200,
                  headers: Optional[dict] = None,
                  dumps: Callable[[Any], str] = json.dumps) -> Response:
    return Response(text=dumps(data), status=status,
                    content_type="application/json", headers=headers)


def reply(status: int, payload: Any) -> Response:
    """The answer to a local admin helper's ``(status, payload)``: text (a
    folded profile) as ``text/plain``, anything else as JSON."""
    if isinstance(payload, str):
        return Response(text=payload, status=status,
                        content_type="text/plain")
    return json_response(payload, status=status)


def middleware(fn):
    """Marks a middleware ``(request, handler) -> response``, as aiohttp's
    decorator does."""
    return fn


class _Router:
    def __init__(self) -> None:
        self.routes: dict[str, dict[str, Handler]] = {}

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes.setdefault(path, {})[method] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def resolve(self, method: str, path: str) -> Handler:
        by_method = self.routes.get(path)
        if by_method is None:
            raise HTTPException(404)
        h = by_method.get(method)
        if h is None and method == "HEAD":
            h = by_method.get("GET")
        if h is None:
            raise HTTPException(
                405, headers={"Allow": ",".join(sorted(by_method))})
        return h


class Application:
    def __init__(self, middlewares: Any = (),
                 client_max_size: int = CLIENT_MAX_SIZE) -> None:
        self.router = _Router()
        self.middlewares = list(middlewares)
        self.client_max_size = client_max_size
        self.on_startup: list[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[["Application"], Awaitable[None]]] = []

    async def handle(self, request: Request) -> StreamResponse:
        async def route(req: Request) -> StreamResponse:
            return await self.router.resolve(req.method, req.path)(req)

        handler = route
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        try:
            return await handler(request)
        except HTTPException as e:
            return e.response()


def _bind(mw, inner: Handler) -> Handler:
    async def h(req: Request) -> StreamResponse:
        return await mw(req, inner)
    return h


class AppRunner:
    """Serves one application on the TCP sites added to it."""

    def __init__(self, app: Application) -> None:
        self.app = app
        self.sites: list["TCPSite"] = []
        self.connections: set[asyncio.StreamWriter] = set()
        self._tasks: set[asyncio.Task] = set()

    async def setup(self) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)

    async def cleanup(self) -> None:
        for site in list(self.sites):
            await site.stop()
        for w in list(self.connections):
            w.close()
        tasks = [t for t in self._tasks if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for hook in self.app.on_cleanup:
            await hook(self.app)

    def abort(self) -> None:
        """Close the listening sockets and reset every connection now."""
        for site in self.sites:
            if site.server is not None:
                site.server.close()
        for w in list(self.connections):
            w.transport.abort()

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        self.connections.add(writer)
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            while True:
                request = await self._read_request(reader, writer)
                if request is None:
                    return
                resp = await self._dispatch(request)
                if resp is None:
                    return
                if not request.keep_alive or writer.transport.is_closing():
                    return
                if request._body is None:
                    # The handler left the body unread: drain it so the
                    # next request starts at its request line.
                    await request.read()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:  # noqa: BLE001 — one connection, never the server
            logger.exception("http connection failed")
        finally:
            self._tasks.discard(task)
            self.connections.discard(writer)
            writer.close()

    async def _read_request(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter
                            ) -> Optional[Request]:
        line = await reader.readline()
        while line in (b"\r\n", b"\n"):
            line = await reader.readline()
        if not line:
            return None
        if len(line) > _MAX_LINE:
            await _send_error(writer, 400, "Bad status line")
            return None
        try:
            method, target, version = line.decode("latin-1").split()
        except ValueError:
            await _send_error(writer, 400, "Bad status line")
            return None
        headers = Headers()
        for _ in range(_MAX_HEADERS + 1):
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, sep, value = h.decode("latin-1").partition(":")
            if not sep:
                await _send_error(writer, 400, "Bad header line")
                return None
            headers[name.strip()] = value.strip()
        else:
            await _send_error(writer, 400, "Too many headers")
            return None
        return Request(method.upper(), target, version, headers, reader,
                       writer, self.app.client_max_size)

    async def _dispatch(self, request: Request) -> Optional[StreamResponse]:
        try:
            resp = await self.app.handle(request)
        except (ConnectionError, asyncio.IncompleteReadError):
            return None
        except Exception:  # noqa: BLE001 — a handler bug answers 500
            logger.exception("error handling %s %s", request.method,
                             request.path)
            resp = Response(
                status=500, content_type="text/plain",
                text="500 Internal Server Error\n\n"
                     "Server got itself in trouble")
        if isinstance(resp, Response) and not resp.prepared:
            await resp.send(request)
        elif not resp.prepared:
            await resp.prepare(request)
            await resp.write_eof()
        elif not resp._eof:
            try:
                await resp.write_eof()
            except ConnectionError:
                return None
        return resp


async def _send_error(writer: asyncio.StreamWriter, status: int,
                      text: str) -> None:
    r = Response(status=status, text=text, headers={"Connection": "close"})
    r._writer = writer
    writer.write(r._head([("Content-Length", str(len(r.body)))]) + r.body)
    await writer.drain()


class TCPSite:
    """One listening socket of a runner."""

    def __init__(self, runner: AppRunner, host: str, port: int) -> None:
        self.runner = runner
        self.host = host
        self.port = port
        self.server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self.server = await asyncio.start_server(
            self.runner._serve, self.host, self.port, reuse_address=True,
            limit=2 ** 20)
        self.port = self.server.sockets[0].getsockname()[1]
        self.runner.sites.append(self)

    async def stop(self) -> None:
        if self.server is not None:
            self.server.close()
        if self in self.runner.sites:
            self.runner.sites.remove(self)
