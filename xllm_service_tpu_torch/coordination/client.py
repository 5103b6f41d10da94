"""TCP client of the reference's standalone coordination server (port of
the part of ``xllm_service_tpu/coordination/client.py`` the agent uses).

Speaks the server's newline-JSON protocol (``{"op": ..., "id": ...}``
requests, responses matched by id). A reader thread demultiplexes
responses; a keepalive thread refreshes leased keys at ttl/3 and re-creates
a key whose refresh fails, so if this process dies its leases lapse on the
server, and a server restart converges back to the live registrations. On
connection loss the reader reconnects with jittered backoff and re-creates
every leased key before it declares the session good. Watches and auth are
not ported (ROADMAP queue 1 item 3.7).
"""

from __future__ import annotations

import itertools
import json
import logging
import socket
import threading
import time
from typing import Optional

from ..common.net import jittered_backoff
from .base import CoordinationClient

logger = logging.getLogger(__name__)


class CoordinationError(RuntimeError):
    pass


class TcpCoordinationClient(CoordinationClient):
    def __init__(self, addr: str, reconnect_max_backoff_s: float = 2.0):
        host, _, port = addr.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._reconnect_max_backoff_s = max(0.1, reconnect_max_backoff_s)
        # False from the moment the reader sees the connection die until
        # the session (leases included) is re-established; written only by
        # the reader thread after __init__.
        self.connected = True
        self.reconnects_total = 0
        self._ids = itertools.count(1)
        self._wlock = threading.Lock()     # serializes frames on the socket
        # rid -> (event, response, connection generation it was sent on).
        self._pending: dict[int, tuple[threading.Event, dict, int]] = {}
        self._plock = threading.Lock()
        # key -> (ttl, last value): a failed refresh re-creates the key.
        self._keepalives: dict[str, tuple[float, str]] = {}
        self._ka_lock = threading.Lock()
        self._closed = threading.Event()
        self._timeout_s = 10.0
        self._gen = 0
        self._connect()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="coord-reader", daemon=True)
        self._reader.start()
        self._ka_thread = threading.Thread(target=self._keepalive_loop,
                                           name="coord-ka", daemon=True)
        self._ka_thread.start()
        if not self._call({"op": "ping"}).get("ok"):
            self.close()
            raise CoordinationError("coordination ping failed")

    # ---- connection --------------------------------------------------------
    def _connect(self) -> None:
        sock = socket.create_connection(self._addr, timeout=self._timeout_s)
        sock.settimeout(None)
        with self._wlock:
            self._sock = sock
            self._gen += 1
        self._rfile = sock.makefile("rb")

    def _send_raw(self, req: dict) -> bool:
        data = (json.dumps(req) + "\n").encode()
        try:
            with self._wlock:
                self._sock.sendall(data)
            return True
        except OSError:
            return False

    def _complete(self, msg: dict) -> None:
        with self._plock:
            waiter = self._pending.pop(msg.get("id"), None)
        if waiter is not None:
            waiter[1].update(msg)
            waiter[0].set()

    def _read_loop(self) -> None:
        while not self._closed.is_set():
            try:
                for line in self._rfile:
                    self._complete(json.loads(line))
            except (OSError, ValueError):
                pass
            self.connected = False
            if self._closed.is_set():
                break
            # Close the dead socket so concurrent writers fail fast.
            try:
                self._sock.close()
            except OSError:
                pass
            self._fail_pending()
            if not self._reconnect_loop():
                break
        self._fail_pending()

    def _fail_pending(self) -> None:
        with self._plock:
            doomed, self._pending = self._pending, {}
        for ev, resp, _ in doomed.values():
            resp["ok"] = False
            resp["error"] = "connection closed"
            ev.set()

    def _request_on_reader(self, req: dict) -> Optional[dict]:
        """Synchronous exchange issued from the reader thread (the
        reconnect path; `_call` would wait on itself)."""
        rid = next(self._ids)
        req["id"] = rid
        if not self._send_raw(req):
            return None
        try:
            for line in self._rfile:
                msg = json.loads(line)
                if msg.get("id") == rid:
                    return msg
                self._complete(msg)
        except (OSError, ValueError):
            return None
        return None

    def _reconnect_loop(self) -> bool:
        """Re-establish the connection and re-create every leased key.
        Returns False if the client was closed while retrying."""
        attempt = 0
        while not self._closed.is_set():
            if attempt and self._closed.wait(jittered_backoff(
                    0.1, self._reconnect_max_backoff_s, attempt - 1)):
                return False
            attempt += 1
            try:
                self._connect()
                # Bounded session set-up: no read may block forever on a
                # half-open socket.
                self._sock.settimeout(min(5.0, self._timeout_s))
            except OSError:
                continue
            with self._ka_lock:
                items = list(self._keepalives.items())
            ok = all((self._request_on_reader(
                {"op": "put", "key": key, "value": value, "ttl": ttl})
                or {}).get("ok") for key, (ttl, value) in items)
            # Liveness check before declaring the session good: a connect
            # racing a dying server can land in its accept backlog.
            resp = self._request_on_reader({"op": "ping"}) if ok else None
            try:
                if not resp or not resp.get("ok"):
                    self._sock.close()
                    continue
                self._sock.settimeout(None)
            except OSError:
                continue
            logger.info("coordination reconnected to %s:%d", *self._addr)
            self.reconnects_total += 1
            self.connected = True
            return True
        return False

    def _call(self, req: dict, timeout_s: Optional[float] = None) -> dict:
        if self._closed.is_set():
            return {"ok": False, "error": "client closed"}
        if not self.connected:
            # Fail fast while the reader is mid-reconnect.
            return {"ok": False, "error": "disconnected"}
        rid = next(self._ids)
        req["id"] = rid
        ev, resp = threading.Event(), {}
        data = (json.dumps(req) + "\n").encode()
        try:
            with self._wlock:
                with self._plock:
                    self._pending[rid] = (ev, resp, self._gen)
                self._sock.sendall(data)
        except OSError as e:
            with self._plock:
                self._pending.pop(rid, None)
            return {"ok": False, "error": str(e)}
        if not ev.wait(timeout_s if timeout_s is not None
                       else self._timeout_s):
            with self._plock:
                self._pending.pop(rid, None)
            return {"ok": False, "error": "timeout"}
        return resp

    def _keepalive_loop(self) -> None:
        # Fine-grained tick; each key refreshed at ttl/3 (etcd KeepAlive).
        last_refresh: dict[str, float] = {}
        while not self._closed.wait(0.02):
            now = time.monotonic()
            with self._ka_lock:
                items = list(self._keepalives.items())
            for key, (ttl, value) in items:
                if now - last_refresh.get(key, 0.0) < ttl / 3.0:
                    continue
                last_refresh[key] = now
                ok = self._call({"op": "refresh", "key": key,
                                 "ttl": ttl}).get("ok", False)
                if not ok and self.connected and not self._closed.is_set():
                    # The key vanished (server restart, lease raced out).
                    self._call({"op": "put", "key": key, "value": value,
                                "ttl": ttl})

    # ---- CoordinationClient ------------------------------------------------
    def ping(self) -> bool:
        """A real round trip, so a half-open connection reads as down."""
        if not self.connected:
            return False
        return bool(self._call({"op": "ping"},
                               timeout_s=min(1.0, self._timeout_s))
                    .get("ok"))

    def set(self, key, value, ttl_s=None) -> bool:
        ok = self._call({"op": "put", "key": key, "value": value,
                         "ttl": ttl_s}).get("ok", False)
        if ok and ttl_s:
            with self._ka_lock:
                self._keepalives[key] = (ttl_s, value)
        return ok

    def get(self, key) -> Optional[str]:
        resp = self._call({"op": "get", "key": key})
        return resp.get("value") if resp.get("ok") else None

    def get_prefix(self, prefix) -> dict[str, str]:
        resp = self._call({"op": "get_prefix", "prefix": prefix})
        return dict(resp.get("kvs") or {}) if resp.get("ok") else {}

    def rm(self, key) -> bool:
        self.release(key)
        return self._call({"op": "rm", "key": key}).get("ok", False)

    def release(self, key) -> None:
        with self._ka_lock:
            self._keepalives.pop(key, None)

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        with self._ka_lock:
            self._keepalives.clear()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
