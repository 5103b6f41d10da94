"""Standalone coordination server.

The framework's self-contained replacement for the reference's external etcd
cluster (SURVEY.md §2.13: "etcd is hardware-neutral" — but this framework is
also deployable with zero external dependencies). One server process holds a
:class:`MemoryStore`; any number of scheduler replicas and engine agents
connect over TCP with a newline-delimited JSON protocol.

etcd-parity semantics:
- leases: a leased key expires unless refreshed; clients refresh at ttl/3.
  Because refreshes ride the client's connection, process death ⇒ refresh
  stop ⇒ expiry ⇒ DELETE watch events — the exact liveness signal the
  reference builds on etcd leases (`etcd_client.cpp:105-120`).
- watches: server pushes `{"event": "watch", ...}` frames to subscribed
  connections.
- auth: optional username/password (reference reads ETCD_USERNAME/PASSWORD,
  `scheduler.cpp:29-58`).

Run: ``python -m xllm_service_tpu.coordination.server --port 2379``.
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import threading
import time
from typing import Optional

from .base import KeyEvent
from .memory import MemoryStore
from ..devtools.locks import make_lock
from ..utils import get_logger

logger = get_logger(__name__)


class _Conn(socketserver.BaseRequestHandler):
    """One client connection: request/response + watch pushes."""

    def setup(self) -> None:
        self.wlock = make_lock("coord_server.conn_write", order=36)  # lock-order: 36
        self.watch_ids: dict[int, int] = {}   # client watch id -> store watch id
        self.authed = not self.server.auth    # type: ignore[attr-defined]
        self.rfile = self.request.makefile("rb")
        self.server.note_accept(self)         # type: ignore[attr-defined]

    def _send(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        with self.wlock:
            try:
                # xlint: allow-blocking-under-lock(single-writer frame serialization; the socket is the resource this lock guards)
                self.request.sendall(data)
            except OSError:
                pass

    def handle(self) -> None:
        store: MemoryStore = self.server.store  # type: ignore[attr-defined]
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                self._send({"ok": False, "error": "bad json"})
                continue
            rid = req.get("id")
            op = req.get("op")
            try:
                if op == "auth":
                    auth = self.server.auth  # type: ignore[attr-defined]
                    self.authed = (not auth) or (
                        (req.get("username"), req.get("password")) == auth)
                    self._send({"id": rid, "ok": self.authed})
                    continue
                if not self.authed:
                    self._send({"id": rid, "ok": False, "error": "unauthenticated"})
                    continue
                self._send({"id": rid, **self._dispatch(store, op, req)})
            except Exception as e:  # noqa: BLE001  # xlint: allow-broad-except(error is surfaced to the client as a protocol-level error frame)
                self._send({"id": rid, "ok": False, "error": str(e)})

    def _dispatch(self, store: MemoryStore, op: str, req: dict) -> dict:
        if op == "put":
            ok = store.put(req["key"], req["value"], req.get("ttl"),
                           create_only=req.get("create_only", False))
            return {"ok": ok}
        if op == "refresh":
            return {"ok": store.refresh(req["key"], req["ttl"])}
        if op == "get":
            v = store.get(req["key"])
            return {"ok": True, "value": v}
        if op == "get_prefix":
            return {"ok": True, "kvs": store.get_prefix(req["prefix"])}
        if op == "rm":
            return {"ok": store.rm(req["key"])}
        if op == "rm_prefix":
            n = store.rm_prefix(req["prefix"], req.get("guard_key"))
            return {"ok": True, "count": n}
        if op == "bulk_set":
            return {"ok": store.bulk_set(req["kvs"])}
        if op == "bulk_rm":
            return {"ok": True, "count": store.bulk_rm(req["keys"])}
        if op == "bulk_apply":
            return {"ok": store.bulk_apply(req.get("kvs", {}),
                                           req.get("rm_keys", []))}
        if op == "watch":
            cwid = req["watch_id"]
            prefix = req["prefix"]

            def push(events: list[KeyEvent], _prefix: str,
                     _cwid: int = cwid, _p: str = prefix) -> None:
                self._send({"event": "watch", "watch_id": _cwid, "prefix": _p,
                            "events": [{"type": e.type.value, "key": e.key,
                                        "value": e.value} for e in events]})

            self.watch_ids[cwid] = store.add_watch(prefix, push)
            return {"ok": True}
        if op == "unwatch":
            swid = self.watch_ids.pop(req["watch_id"], None)
            if swid is not None:
                store.remove_watch(swid)
            return {"ok": True}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op}"}

    def finish(self) -> None:
        store: MemoryStore = self.server.store  # type: ignore[attr-defined]
        for swid in self.watch_ids.values():
            store.remove_watch(swid)
        self.server.note_close(self)          # type: ignore[attr-defined]


class CoordinationServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    #: Accept-log bound: enough to audit a full fleet's post-outage
    #: reconnect storm without unbounded growth in long-lived servers.
    ACCEPT_LOG_CAPACITY = 4096

    def __init__(self, host: str = "0.0.0.0", port: int = 2379,
                 auth: Optional[tuple[str, str]] = None,
                 store: Optional[MemoryStore] = None,
                 accept_log_path: str = ""):
        self.store = store or MemoryStore()
        self.auth = auth
        # Connection bookkeeping + bounded accept log (timestamps of
        # every accepted connection): the outage bench reads the accept
        # spread after a restart to verify recovery is storm-free.
        self._conn_lock = make_lock("coord_server.conns", order=38)  # lock-order: 38
        self._conns: set = set()
        self.accept_log: list[float] = []
        self._accept_log_path = accept_log_path
        super().__init__((host, port), _Conn)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def note_accept(self, conn) -> None:
        ts = time.time()
        with self._conn_lock:
            self._conns.add(conn)
            self.accept_log.append(ts)
            if len(self.accept_log) > self.ACCEPT_LOG_CAPACITY:
                del self.accept_log[:len(self.accept_log)
                                    - self.ACCEPT_LOG_CAPACITY]
        if self._accept_log_path:
            try:
                with open(self._accept_log_path, "a") as f:
                    f.write(f"{ts:.6f}\n")
            except OSError:
                pass
        logger.debug("accepted coordination connection (%d live)",
                     len(self._conns))

    def note_close(self, conn) -> None:
        with self._conn_lock:
            self._conns.discard(conn)

    def start_background(self) -> threading.Thread:
        def _serve() -> None:
            try:
                self.serve_forever()
            except OSError:
                # kill() closes the listener out from under the poll
                # loop — that IS the simulated process death, not an
                # error worth a thread traceback.
                pass

        t = threading.Thread(target=_serve, name="coord-server",
                             daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        self.store.close()

    def kill(self) -> None:
        """Simulate abrupt process death (the chaos drills' killable
        hook): sever every live client connection mid-stream and close
        the listener WITHOUT the graceful teardown — clients see ECONNRESET
        exactly as if the process got SIGKILLed. The store is dropped
        with it (a restarted server starts empty, like a fresh
        process)."""
        # The LISTENER dies first: shutdown()'s serve_forever poll
        # window (≤0.5s) would otherwise keep accepting the just-severed
        # clients' instant reconnects into zombie handler threads — a
        # half-dead server no real SIGKILL produces.
        try:
            self.socket.close()
        except OSError:
            pass
        self.shutdown()
        # Sever every connection accepted up to the listener close
        # (snapshot AFTER shutdown so a straggler accepted during the
        # race is included).
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.request.close()
            except OSError:
                pass
        try:
            self.server_close()
        except OSError:
            pass
        self.store.close()


def main() -> None:
    p = argparse.ArgumentParser(description="xllm-service-tpu coordination server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=2379)
    p.add_argument("--username", default="")
    p.add_argument("--password", default="")
    p.add_argument("--accept-log", default="",
                   help="append an epoch timestamp per accepted "
                        "connection to this file (outage-bench reconnect "
                        "spread audit)")
    args = p.parse_args()
    auth = (args.username, args.password) if args.username else None
    srv = CoordinationServer(args.host, args.port, auth=auth,
                             accept_log_path=args.accept_log)
    logger.info("coordination server listening on %s:%d", args.host, srv.port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
