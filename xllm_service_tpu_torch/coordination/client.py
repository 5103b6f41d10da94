"""TCP client for the standalone coordination server.

Implements :class:`CoordinationClient` over the newline-JSON protocol of
:mod:`.server`. A reader thread demultiplexes responses (by request id) from
watch pushes; a keepalive thread refreshes leased keys at ttl/3 — so if this
process dies, its leases lapse on the server and watchers see DELETEs
(etcd-lease parity; reference `etcd_client.cpp:105-120`).
"""

from __future__ import annotations

import itertools
import json
import queue
import socket
import threading
from typing import Optional

from .base import CoordinationClient, KeyEvent, WatchCallback, WatchEventType
from ..common.faults import FAULTS, FaultInjected
from ..common.metrics import COORDINATION_RECONNECTS_TOTAL
from ..devtools import lifecycle as _lifecycle
from ..devtools.locks import make_lock
from ..utils import get_logger, jittered_backoff

logger = get_logger(__name__)


class CoordinationError(RuntimeError):
    pass


class TcpCoordinationClient(CoordinationClient):
    """Resilience (the reference inherits this from the etcd client):
    on connection loss the client reconnects with backoff, re-authenticates,
    re-subscribes every watch, and the keepalive loop RE-CREATES leased keys
    whose refresh fails — so a coordination-server restart (in-memory state
    lost) converges back to the live fleet's registrations."""

    def __init__(self, addr: str, namespace: str = "",
                 username: str = "", password: str = "",
                 timeout_s: float = 10.0,
                 reconnect_max_backoff_s: float = 2.0):
        host, _, port = addr.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._auth = (username, password) if username else None
        # Reconnect backoff cap; each attempt's delay is exponential AND
        # randomized (jittered_backoff) so a fleet of clients that lost
        # the same server does not retry in lockstep — the reconnect
        # storm the degraded-mode recovery path must avoid.
        self._reconnect_max_backoff_s = max(0.1, reconnect_max_backoff_s)
        # Client-side plane evidence for the degraded-mode health
        # monitor: False from the moment the reader detects connection
        # death until the full session (auth + watches + leases) is
        # re-established. Single-assignment bool (GIL-atomic), written
        # only by the reader thread after __init__.
        self.connected = True
        self.reconnects_total = 0
        self._wlock = make_lock("coord_client.write", order=30)  # lock-order: 30
        self._ns = namespace.strip("/")
        self._ids = itertools.count(1)
        # rid -> (event, response, connection generation it was sent on).
        self._pending: dict[int, tuple[threading.Event, dict, int]] = {}
        self._plock = make_lock("coord_client.pending", order=32)  # lock-order: 32
        self._watches: dict[int, tuple[str, WatchCallback]] = {}
        # wid -> keys (namespace-stripped) last known to exist under the
        # watch prefix; the reconnect resync diffs the server's current
        # state against this to synthesize the PUT/DELETE events that were
        # lost while the connection was down (list-then-watch).
        self._watch_known: dict[int, set[str]] = {}
        # key -> (ttl, last_value, create_only) so a failed refresh can
        # re-create with the ORIGINAL semantics (an election key must never
        # be re-asserted with a plain put — that would overwrite a new
        # winner and split-brain).
        self._keepalives: dict[str, tuple[float, str, bool]] = {}
        self._ka_lock = make_lock("coord_client.keepalives", order=34)  # lock-order: 34
        self._closed = threading.Event()
        self._timeout_s = timeout_s
        # Connection generation, bumped under _wlock with each (re)connect;
        # lets reconnect fail exactly the calls sent on dead connections.
        self._gen = 0
        # Watch callbacks run on a DEDICATED dispatcher thread, fed FIFO
        # from the reader (one queue + one consumer = delivery order
        # preserved, which the replica frame-log apply depends on). They
        # must NOT run on the reader thread itself: a callback that makes
        # a coordination call — the master-election takeover does exactly
        # this (`scheduler._on_master_event` -> `create_if_absent`) —
        # would wait on a response only the reader can deliver, while the
        # reader waits inside the callback. The server had already applied
        # the write, so the deadlock's timeout left the caller believing
        # the election failed while its key sat in the store unrefreshed.
        self._watch_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._connect()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="coord-reader", daemon=True)
        self._reader.start()
        self._watch_thread = threading.Thread(target=self._watch_loop,
                                              name="coord-watch", daemon=True)
        self._watch_thread.start()
        self._ka_thread = threading.Thread(target=self._keepalive_loop,
                                           name="coord-ka", daemon=True)
        self._ka_thread.start()
        if self._auth:
            resp = self._call({"op": "auth", "username": username,
                               "password": password})
            if not resp.get("ok"):
                raise CoordinationError("coordination auth failed")
        # Connectivity check (reference pings with a PUT of XLLM_PING,
        # `etcd_client.cpp:58-86`).
        if not self._call({"op": "ping"}).get("ok"):
            raise CoordinationError("coordination ping failed")

    def _connect(self) -> None:
        FAULTS.check("coord.connect", addr=f"{self._addr[0]}:{self._addr[1]}")
        sock = socket.create_connection(self._addr, timeout=self._timeout_s)
        sock.settimeout(None)
        with self._wlock:
            self._sock = sock
            self._gen += 1
        self._rfile = sock.makefile("rb")

    def _reconnect_loop(self) -> bool:
        """Re-establish the connection + session state. Returns False if
        the client was closed while retrying."""
        attempt = 0
        while not self._closed.is_set():
            try:
                self._connect()
            except (OSError, FaultInjected):
                if self._closed.wait(jittered_backoff(
                        0.1, self._reconnect_max_backoff_s, attempt)):
                    return False
                attempt += 1
                continue
            logger.info("coordination reconnected to %s:%d", *self._addr)
            # Bounded session establishment: the auth/resync/ping reads
            # below must not block forever on a half-open socket (the
            # timeout is lifted again before normal — idle-tolerant —
            # watch reads resume).
            try:
                self._sock.settimeout(min(5.0, self._timeout_s))
            except OSError:
                continue
            if self._auth:
                # Synchronous auth exchange (we ARE the reader thread here,
                # so reading the response line directly is safe). A silent
                # auth failure would leave the session half-broken.
                self._send_raw({"op": "auth", "id": next(self._ids),
                                "username": self._auth[0],
                                "password": self._auth[1]})
                try:
                    line = self._rfile.readline()
                    if not json.loads(line).get("ok"):
                        logger.error("coordination re-auth REJECTED after "
                                     "reconnect; retrying connection")
                        self._sock.close()
                        if self._closed.wait(jittered_backoff(
                                0.1, self._reconnect_max_backoff_s, attempt)):
                            return False
                        attempt += 1
                        continue
                except (OSError, ValueError):
                    continue
            # Re-subscribe watches (server lost them with the connection).
            for wid, (prefix, _cb) in list(self._watches.items()):
                self._send_raw({"op": "watch", "id": next(self._ids),
                                "watch_id": wid,
                                "prefix": self._k(prefix)})
            # Re-create leased keys immediately, honoring create_only (an
            # election key lost to a new winner must NOT be clobbered).
            with self._ka_lock:
                items = list(self._keepalives.items())
            for key, (ttl, value, create_only) in items:
                self._send_raw({"op": "put", "id": next(self._ids),
                                "key": key, "value": value, "ttl": ttl,
                                "create_only": create_only})
            # List-then-watch resync: deliver the events lost during the
            # outage, so a coordination blip can't silently freeze instance
            # discovery (a registration or eviction that happened while we
            # were down would otherwise never reach the watchers).
            self._resync_watches()
            # Liveness check before declaring the session good: a connect
            # that raced a dying server can complete the TCP handshake in
            # the kernel's accept backlog with no process behind it — the
            # resync above then no-ops per watch and we would flag
            # `connected` on a socket the next write discovers is dead.
            resp = self._request_on_reader({"op": "ping"})
            if not resp or not resp.get("ok"):
                try:
                    self._sock.close()
                except OSError:
                    pass
                # Any call that raced onto this rejected connection
                # must not ride out its full timeout.
                self._fail_pending()
                if self._closed.wait(jittered_backoff(
                        0.1, self._reconnect_max_backoff_s, attempt)):
                    return False
                attempt += 1
                continue
            try:
                self._sock.settimeout(None)
            except OSError:
                continue
            self.reconnects_total += 1
            COORDINATION_RECONNECTS_TOTAL.inc()
            self.connected = True
            return True
        return False

    def _request_on_reader(self, req: dict) -> Optional[dict]:
        """Synchronous exchange issued FROM the reader thread (reconnect
        path — `_call` would deadlock waiting on ourselves). Watch pushes
        interleaved on the wire are enqueued to the dispatcher."""
        rid = next(self._ids)
        req["id"] = rid
        if not self._send_raw(req):
            return None
        try:
            for line in self._rfile:
                msg = json.loads(line)
                if msg.get("event") == "watch":
                    self._enqueue_watch(msg)
                    continue
                if msg.get("id") == rid:
                    return msg
                # A concurrent _call (e.g. the keepalive refreshing a
                # lease on the fresh connection) interleaved its response:
                # complete its waiter instead of dropping it, or the call
                # would stall for its full timeout.
                with self._plock:
                    waiter = self._pending.pop(msg.get("id"), None)
                if waiter is not None:
                    waiter[1].update(msg)
                    waiter[0].set()
        except (OSError, ValueError):
            return None
        return None

    def _resync_watches(self) -> None:
        for wid, (prefix, cb) in list(self._watches.items()):
            resp = self._request_on_reader(
                {"op": "get_prefix", "prefix": self._k(prefix)})
            if not resp or not resp.get("ok"):
                continue
            current = {self._strip(k): v
                       for k, v in resp.get("kvs", {}).items()}
            known = self._watch_known.get(wid, set())
            events = [KeyEvent(WatchEventType.DELETE, k, "")
                      for k in sorted(known - set(current))]
            events += [KeyEvent(WatchEventType.PUT, k, current[k])
                       for k in sorted(current)]
            self._watch_known[wid] = set(current)
            if not events:
                continue
            # Through the dispatcher queue like live pushes: resync events
            # must not run callbacks on the reader thread either (same
            # election-takeover deadlock), and FIFO keeps them ordered
            # before any pushes the fresh connection delivers next.
            self._watch_q.put((cb, events, prefix))

    def _send_raw(self, req: dict) -> bool:
        data = (json.dumps(req) + "\n").encode()
        try:
            with self._wlock:
                # xlint: allow-blocking-under-lock(single-writer frame serialization; the socket is the resource this lock guards)
                self._sock.sendall(data)
            return True
        except OSError:
            return False

    # ---- plumbing ----------------------------------------------------------
    def _k(self, key: str) -> str:
        return f"{self._ns}/{key}" if self._ns else key

    def _strip(self, key: str) -> str:
        return key[len(self._ns) + 1:] if self._ns else key

    def _read_loop(self) -> None:
        while not self._closed.is_set():
            self._read_one_connection()
            self.connected = False
            if self._closed.is_set():
                break
            # Close the dead socket so concurrent writers fail fast instead
            # of buffering into a black hole for their full call timeout.
            try:
                self._sock.close()
            except OSError:
                pass
            self._fail_pending()
            if not self._reconnect_loop():
                self._fail_pending()
                return
            # Calls issued while we were reconnecting went to the dead
            # socket; fail exactly those (generation check protects calls
            # already sent on the fresh connection).
            with self._wlock:
                cur_gen = self._gen
            self._fail_pending(older_than=cur_gen)
        self._fail_pending()

    def _fail_pending(self, older_than: Optional[int] = None) -> None:
        with self._plock:
            doomed = [rid for rid, (_, _, gen) in self._pending.items()
                      if older_than is None or gen < older_than]
            for rid in doomed:
                ev, resp, _ = self._pending.pop(rid)
                resp["ok"] = False
                resp["error"] = "connection closed"
                ev.set()

    def _enqueue_watch(self, msg: dict) -> None:
        """Reader-thread half of watch delivery: decode, update the
        known-key bookkeeping (kept on the reader thread so the resync
        diff never races the dispatcher), and queue for the dispatcher."""
        wid = msg["watch_id"]
        entry = self._watches.get(wid)
        if entry is None:
            return
        prefix, cb = entry
        events = [KeyEvent(WatchEventType(e["type"]),
                           self._strip(e["key"]), e.get("value", ""))
                  for e in msg.get("events", ())]
        known = self._watch_known.setdefault(wid, set())
        for e in events:
            if e.type == WatchEventType.PUT:
                known.add(e.key)
            else:
                known.discard(e.key)
        self._watch_q.put((cb, events, prefix))

    def _watch_loop(self) -> None:
        """Dispatcher half: the ONLY thread that runs watch callbacks, so
        callbacks may freely issue coordination calls (election takeover)
        without deadlocking the reader, and per-client delivery stays
        strictly ordered."""
        while True:
            item = self._watch_q.get()
            if item is None:
                return
            cb, events, prefix = item
            try:
                cb(events, prefix)
            except Exception:
                logger.exception("watch callback failed")

    def _read_one_connection(self) -> None:
        try:
            for line in self._rfile:
                msg = json.loads(line)
                if msg.get("event") == "watch":
                    self._enqueue_watch(msg)
                    continue
                rid = msg.get("id")
                with self._plock:
                    waiter = self._pending.pop(rid, None)
                if waiter is not None:
                    waiter[1].update(msg)
                    waiter[0].set()  # (ev, resp, gen)
        except (OSError, ValueError):
            pass

    def _call(self, req: dict, timeout_s: Optional[float] = None) -> dict:
        if self._closed.is_set():
            return {"ok": False, "error": "client closed"}
        if not self.connected:
            # Fail fast while the reader is mid-reconnect: a call sent
            # on a half-established socket would ride in _pending until
            # its full timeout (nothing fails it if the reconnect
            # attempt is later rejected), stalling the caller — which
            # during an outage is the scheduler's sync tick itself.
            return {"ok": False, "error": "disconnected"}
        rule = FAULTS.fire("coord.call", op=req.get("op"))
        if rule is not None:
            if rule.action == "disconnect":
                # Sever the connection (blip simulation): this call fails
                # and the reader thread drives reconnect + watch resync.
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            elif rule.action == "delay":
                import time as _t
                _t.sleep(rule.delay_s)
            else:
                return {"ok": False, "error": "fault injected"}
        rid = next(self._ids)
        req["id"] = rid
        ev, resp = threading.Event(), {}
        data = (json.dumps(req) + "\n").encode()
        try:
            with self._wlock:
                with self._plock:
                    self._pending[rid] = (ev, resp, self._gen)
                # xlint: allow-blocking-under-lock(single-writer frame serialization; registration + send must be atomic vs reconnect)
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
        # Fine-grained tick; each key refreshed at ttl/3 cadence (etcd
        # KeepAlive behavior).
        last_refresh: dict[str, float] = {}
        import time as _time

        while not self._closed.wait(0.02):
            now = _time.monotonic()
            with self._ka_lock:
                items = list(self._keepalives.items())
            for key, (ttl, value, create_only) in items:
                if now - last_refresh.get(key, 0.0) >= ttl / 3.0:
                    last_refresh[key] = now
                    ok = self._call({"op": "refresh", "key": key,
                                     "ttl": ttl}).get("ok", False)
                    if not ok and not self._closed.is_set():
                        # Key vanished (server restart / lease raced out):
                        # re-create with the ORIGINAL create_only semantics.
                        resp = self._call({"op": "put", "key": key,
                                           "value": value, "ttl": ttl,
                                           "create_only": create_only})
                        if create_only and resp and not resp.get("ok"):
                            # Someone else now holds the election key: we
                            # are no longer the owner — stop claiming it.
                            # (Owners detect demotion via verify_ownership.)
                            with self._ka_lock:
                                if self._keepalives.pop(key, None) \
                                        is not None:
                                    _lifecycle.note_release(
                                        "coord-lease", key=(id(self), key))

    # ---- CoordinationClient ------------------------------------------------
    def ping(self) -> bool:
        """Plane liveness probe (degraded-mode monitor evidence): a real
        round-trip, so a half-open connection reads as down — unlike
        `get`, whose None conflates missing-key with unreachable."""
        if not self.connected:
            return False
        # Short dedicated timeout: the probe runs on the scheduler-sync
        # cadence, and a probe that stalls for the full call timeout
        # would stall the sync tick itself — the probe's whole job is to
        # answer "up or not" faster than that.
        return bool(self._call({"op": "ping"},
                               timeout_s=min(1.0, self._timeout_s))
                    .get("ok"))

    def set(self, key, value, ttl_s=None, keepalive=True) -> bool:
        ok = self._call({"op": "put", "key": self._k(key), "value": value,
                         "ttl": ttl_s}).get("ok", False)
        if ok and ttl_s and keepalive:
            with self._ka_lock:
                if self._k(key) not in self._keepalives:
                    _lifecycle.note_acquire("coord-lease",
                                            key=(id(self), self._k(key)))
                self._keepalives[self._k(key)] = (ttl_s, value, False)
        return ok

    def create_if_absent(self, key, value, ttl_s=None, keepalive=True) -> bool:
        ok = self._call({"op": "put", "key": self._k(key), "value": value,
                         "ttl": ttl_s, "create_only": True}).get("ok", False)
        if ok and ttl_s and keepalive:
            with self._ka_lock:
                if self._k(key) not in self._keepalives:
                    _lifecycle.note_acquire("coord-lease",
                                            key=(id(self), self._k(key)))
                self._keepalives[self._k(key)] = (ttl_s, value, True)
        return ok

    def get(self, key) -> Optional[str]:
        resp = self._call({"op": "get", "key": self._k(key)})
        return resp.get("value") if resp.get("ok") else None

    def get_prefix(self, prefix) -> dict[str, str]:
        resp = self._call({"op": "get_prefix", "prefix": self._k(prefix)})
        if not resp.get("ok"):
            return {}
        return {self._strip(k): v for k, v in resp.get("kvs", {}).items()}

    def rm(self, key) -> bool:
        self.release(key)
        return self._call({"op": "rm", "key": self._k(key)}).get("ok", False)

    def rm_prefix(self, prefix, guard_key=None) -> int:
        resp = self._call({"op": "rm_prefix", "prefix": self._k(prefix),
                           "guard_key": self._k(guard_key) if guard_key else None})
        return resp.get("count", 0)

    def bulk_set(self, kvs) -> bool:
        return self._call({"op": "bulk_set",
                           "kvs": {self._k(k): v for k, v in kvs.items()}}).get("ok", False)

    def bulk_rm(self, keys) -> int:
        return self._call({"op": "bulk_rm",
                           "keys": [self._k(k) for k in keys]}).get("count", 0)

    def bulk_apply(self, kvs, rm_keys) -> bool:
        resp = self._call({"op": "bulk_apply",
                           "kvs": {self._k(k): v for k, v in kvs.items()},
                           "rm_keys": [self._k(k) for k in rm_keys]})
        if resp.get("ok"):
            return True
        if "unknown op" in str(resp.get("error", "")):
            # Legacy coordination server: fall back to two revisions
            # (correct, with the pre-batch transient window).
            return super().bulk_apply(kvs, rm_keys)
        return False

    def release(self, key) -> None:
        with self._ka_lock:
            if self._keepalives.pop(self._k(key), None) is not None:
                _lifecycle.note_release("coord-lease",
                                        key=(id(self), self._k(key)))

    def add_watch(self, prefix, cb) -> int:
        wid = next(self._ids)
        self._watches[wid] = (prefix, cb)
        self._call({"op": "watch", "watch_id": wid, "prefix": self._k(prefix)})
        return wid

    def remove_watch(self, watch_id) -> None:
        self._watches.pop(watch_id, None)
        self._watch_known.pop(watch_id, None)
        self._call({"op": "unwatch", "watch_id": watch_id})

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        with self._ka_lock:
            for k in self._keepalives:
                _lifecycle.note_release("coord-lease", key=(id(self), k))
            self._keepalives.clear()
        self._watch_q.put(None)   # dispatcher sentinel
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
