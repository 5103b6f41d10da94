"""What the service-plane bench twins share: an HTTP client on
``http.client`` and the children a bench spawns.

The reference's benches drive the master with ``requests``; the card's
machine has no ``requests``, so :class:`Session` is its counterpart on
the standard library: one kept-alive HTTP/1.1 connection per destination
(a ``requests.Session`` with its pool), ``TCP_NODELAY`` on every socket
(a kept-alive reply must not wait on Nagle), a body read whole unless the
caller streams it, and :meth:`Response.iter_lines` reading a streamed
body line by line as ``requests``' ``iter_lines`` does.

A connection goes back to its session only once its body has been read
to the end (for a chunked body, its terminal chunk): a caller that
stops reading early and closes the response closes the connection, so
the server sees the client go. An OpenAI stream ends with ``data:
[DONE]``; :meth:`Response.iter_lines` reads what follows it (the blank
line and the terminal chunk) before it yields that line, so a caller
that stops there keeps its connection.

:class:`Children` spawns the port's entry points (``python -m
xllm_service_tpu_torch.master`` and the rest), each in a session of its
own, and reaps them: SIGTERM to each process group, then SIGKILL to what
outlives ten seconds — the grandchildren too (the fake engines a master's
local actuator launched).
"""

from __future__ import annotations

import http.client
import json as _json
import os
import select
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Iterator, Optional
from urllib.parse import urlencode, urlsplit

#: The checkout: ``python -m xllm_service_tpu_torch...`` runs from here.
ROOT = Path(__file__).resolve().parents[2]


def percentile(xs, p):
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = min(len(xs) - 1, int(round((p / 100) * (len(xs) - 1))))
    return xs[k]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def proc_cpu_s(pid: int) -> float:
    """utime+stime of one process in seconds (0.0 if unreadable)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        return (int(parts[11]) + int(parts[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


# ------------------------------------------------------------------ client
class RequestException(OSError):
    """A transport failure: refused, reset, timed out or cut short."""


class _Connection(http.client.HTTPConnection):
    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def _dropped(conn: http.client.HTTPConnection) -> bool:
    """Has the peer closed an idle connection (readable at rest)?"""
    if conn.sock is None:
        return True
    try:
        return bool(select.select([conn.sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


class Response:
    """Status, headers and the body, read whole or streamed."""

    def __init__(self, session: "Session", dest: str,
                 conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse, stream: bool) -> None:
        self.status_code = resp.status
        self.headers = resp.headers
        self._session, self._dest = session, dest
        self._conn, self._resp = conn, resp
        self._content: Optional[bytes] = None
        if not stream:
            self._content = self._read()
            self.close()

    def _read(self) -> bytes:
        try:
            return self._resp.read()
        except (http.client.HTTPException, OSError) as e:
            self._drop()
            raise RequestException(f"reading the body: {e!r}") from e

    @property
    def content(self) -> bytes:
        if self._content is None:
            self._content = self._read()
            self.close()
        return self._content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return _json.loads(self.content)

    def iter_lines(self) -> Iterator[bytes]:
        """The body's lines without their line ends, as they arrive."""
        resp = self._resp
        try:
            while True:
                line = resp.readline()
                if not line:
                    self.close()
                    return
                line = line.rstrip(b"\r\n")
                if line == b"data: [DONE]":
                    resp.read()     # the stream's end: keep the connection
                    self.close()
                yield line
        except (http.client.HTTPException, OSError) as e:
            self._drop()
            raise RequestException(f"reading the stream: {e!r}") from e

    def _drop(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self) -> None:
        """Give the connection back if the body was read to its end,
        else close it."""
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if self._resp.isclosed() and not self._resp.will_close:
            self._session._give(self._dest, conn)
        else:
            conn.close()


class Session:
    """One kept-alive connection per destination, reused request after
    request; a thread drives its own session."""

    def __init__(self) -> None:
        self._idle: dict[str, http.client.HTTPConnection] = {}

    def _take(self, dest: str, timeout: float) -> http.client.HTTPConnection:
        conn = self._idle.pop(dest, None)
        if conn is not None and _dropped(conn):
            conn.close()
            conn = None
        if conn is None:
            host, _, port = dest.rpartition(":")
            conn = _Connection(host, int(port), timeout=timeout)
        else:
            conn.timeout = timeout
            conn.sock.settimeout(timeout)
        return conn

    def _give(self, dest: str, conn: http.client.HTTPConnection) -> None:
        old = self._idle.pop(dest, None)
        if old is not None:
            old.close()
        self._idle[dest] = conn

    def request(self, method: str, url: str, json: Any = None,
                data: Optional[bytes] = None,
                headers: Optional[dict] = None,
                params: Optional[dict] = None, stream: bool = False,
                timeout: float = 30.0) -> Response:
        u = urlsplit(url)
        dest = f"{u.hostname}:{u.port or 80}"
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        if params:
            path += ("&" if "?" in path else "?") + urlencode(params)
        hdrs = dict(headers or {})
        if json is not None:
            data = _json.dumps(json).encode()
            hdrs.setdefault("Content-Type", "application/json")
        conn = self._take(dest, timeout)
        try:
            conn.request(method, path, body=data, headers=hdrs)
            resp = conn.getresponse()
        except (http.client.HTTPException, OSError) as e:
            conn.close()
            raise RequestException(f"{method} {url}: {e!r}") from e
        return Response(self, dest, conn, resp, stream)

    def post(self, url: str, **kw) -> Response:
        return self.request("POST", url, **kw)

    def get(self, url: str, **kw) -> Response:
        return self.request("GET", url, **kw)

    def close(self) -> None:
        idle, self._idle = self._idle, {}
        for conn in idle.values():
            conn.close()


def post(url: str, **kw) -> Response:
    """One request on a connection of its own."""
    s = Session()
    try:
        return s.post(url, **kw)
    finally:
        s.close()


def get(url: str, **kw) -> Response:
    s = Session()
    try:
        return s.get(url, **kw)
    finally:
        s.close()


# ---------------------------------------------------------------- children
def child_env(**extra: str) -> dict:
    """The environment of a spawned entry point: the checkout importable,
    one OpenMP thread (nothing there computes), ``extra`` on top."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + path if path else "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra)
    return env


def logdir() -> Path:
    return Path(os.environ.get("XLLM_BENCH_LOGDIR", tempfile.gettempdir()))


def module_cmd(module: str, *argv: str) -> list[str]:
    return [sys.executable, "-m", module, *argv]


class Children:
    """The processes of one bench leg, each logging to
    ``<logdir>/<prefix>_<name>.log``."""

    def __init__(self, prefix: str, env: Optional[dict] = None) -> None:
        self.prefix = prefix
        self.env = env if env is not None else child_env()
        self.procs: list[tuple[str, subprocess.Popen]] = []

    def log_path(self, name: str) -> Path:
        return logdir() / f"{self.prefix}_{name}.log"

    def spawn(self, name: str, cmd: list[str], env: Optional[dict] = None,
              mode: str = "w") -> subprocess.Popen:
        with open(self.log_path(name), mode) as log:
            p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 cwd=str(ROOT), env=env or self.env,
                                 start_new_session=True)
        self.procs.append((name, p))
        return p

    def check(self) -> None:
        """Raise if a child has died."""
        for name, p in self.procs:
            if p.poll() is not None:
                raise RuntimeError(f"{name} died rc={p.returncode} — see "
                                   f"{self.log_path(name)}")

    @staticmethod
    def _signal_group(p: subprocess.Popen, sig: int) -> None:
        try:
            os.killpg(p.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    def stop(self) -> None:
        """SIGTERM every group, wait up to 10 s each, SIGKILL the rest."""
        for _, p in self.procs:
            if p.poll() is None:
                self._signal_group(p, signal.SIGTERM)
        deadline = time.monotonic() + 10
        for _, p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        for _, p in self.procs:
            # The group outlives its leader when a grandchild lingers.
            self._signal_group(p, signal.SIGKILL)
            p.wait()
