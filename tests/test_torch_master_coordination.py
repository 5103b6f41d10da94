"""The port's coordination clients and server against the JAX package's,
both ways: the port's TCP client against the reference's server, the
reference's client against the port's server, and the port's pair alone,
each held to the reference's pair running the same script. The in-process
backends are held to each other the same way.

The script covers what the master uses: ``create_if_absent`` (the
election), watches (PUT, DELETE on a lease's expiry once its owner is
closed, and ``remove_watch``), key namespaces (a watcher sees its own
namespace's keys, stripped), username/password auth (a wrong password is
refused), ``set`` without a keepalive (the lease lapses), ``rm_prefix``
with its guard key, ``bulk_set``, ``bulk_rm`` and ``bulk_apply`` (one
event batch, DELETEs first).
"""

import threading
import time

import pytest
import torch

from xllm_service_tpu.coordination import client as ref_client
from xllm_service_tpu.coordination import memory as ref_memory
from xllm_service_tpu.coordination import server as ref_server
from xllm_service_tpu_torch.coordination import client, memory, server

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

TTL = 0.5
AUTH = ("root", "s3cret")

PORT = (client, memory, server)
REF = (ref_client, ref_memory, ref_server)


class _Events:
    """A watch callback that keeps every batch, in order."""

    def __init__(self):
        self.batches: list = []
        self._lock = threading.Lock()

    def __call__(self, events, prefix):
        with self._lock:
            self.batches.append(
                (prefix, [(e.type.value, e.key, e.value) for e in events]))

    def flat(self):
        with self._lock:
            return [ev for _, b in self.batches for ev in b]


def _settle(pred, timeout=5.0):
    assert wait_until(pred, timeout=timeout)


def _script(make_client):
    """One run of the master's coordination use; returns its transcript."""
    out = []
    a = make_client("")
    b = make_client("")
    ns1 = make_client("ns1")
    ns2 = make_client("/ns2/")
    try:
        ev, ev_ns = _Events(), _Events()
        wid = b.add_watch("XLLM:", ev)
        ns1.add_watch("XLLM:", ev_ns)
        # The election: the first create wins, a second loses.
        out.append(a.create_if_absent("XLLM:SERVICE:MASTER", "m1",
                                      ttl_s=TTL))
        out.append(b.create_if_absent("XLLM:SERVICE:MASTER", "m2",
                                      ttl_s=TTL))
        out.append(b.get("XLLM:SERVICE:MASTER"))
        out.append(a.set("XLLM:INSTANCE:MIX:i1", "meta1", ttl_s=TTL))
        out.append(a.set("XLLM:CACHE:k1", "v1"))
        out.append(sorted(b.get_prefix("XLLM:").items()))
        # Namespaces: isolated views, keys stripped for the watcher.
        out.append(ns1.set("XLLM:INSTANCE:MIX:n", "in-ns1"))
        out.append(ns2.set("XLLM:INSTANCE:MIX:n", "in-ns2"))
        out.append((ns1.get("XLLM:INSTANCE:MIX:n"),
                    ns2.get("XLLM:INSTANCE:MIX:n"),
                    a.get("XLLM:INSTANCE:MIX:n")))
        out.append(sorted(ns2.get_prefix("").items()))
        _settle(lambda: len(ev_ns.flat()) >= 1)
        out.append(ev_ns.flat())
        # Bulk ops.
        out.append(a.bulk_set({"XLLM:CACHE:k2": "v2", "XLLM:CACHE:k3": "v3",
                               "XLLM:CACHE:k4": "v4"}))
        out.append(a.bulk_rm(["XLLM:CACHE:k2", "XLLM:CACHE:missing"]))
        out.append(a.bulk_apply({"XLLM:CACHE:k5": "v5"},
                                ["XLLM:CACHE:k3"]))
        out.append(sorted(a.get_prefix("XLLM:CACHE:").items()))
        # rm_prefix only while the guard key exists.
        out.append(a.rm_prefix("XLLM:CACHE:", guard_key="XLLM:NO:GUARD"))
        out.append(a.rm_prefix("XLLM:CACHE:k4", guard_key="XLLM:SERVICE:MASTER"))
        out.append(sorted(a.get_prefix("XLLM:CACHE:").items()))
        # set without a keepalive: its lease lapses.
        out.append(a.set("XLLM:INSTANCE:MIX:once", "x", ttl_s=TTL,
                         keepalive=False))
        _settle(lambda: b.get("XLLM:INSTANCE:MIX:once") is None)
        # A kept-alive lease outlives its TTL; closing the owner lets the
        # election key and the instance lapse (DELETE events).
        time.sleep(3 * TTL)
        out.append((b.get("XLLM:SERVICE:MASTER"),
                    b.get("XLLM:INSTANCE:MIX:i1")))
        a.close()
        _settle(lambda: b.get("XLLM:SERVICE:MASTER") is None
                and b.get("XLLM:INSTANCE:MIX:i1") is None)
        out.append(b.create_if_absent("XLLM:SERVICE:MASTER", "m2",
                                      ttl_s=TTL))

        def deletes_in():
            keys = {k for t, k, _ in ev.flat() if t == "DELETE"}
            # The new winner's PUT arrives on the watch after the lapse.
            won = ("PUT", "XLLM:SERVICE:MASTER", "m2") in ev.flat()
            return won and {"XLLM:SERVICE:MASTER", "XLLM:INSTANCE:MIX:i1",
                            "XLLM:INSTANCE:MIX:once"} <= keys

        _settle(deletes_in)
        # Per-key event order (batches across keys may interleave with
        # the expiry sweep's timing; within a key they are ordered).
        per_key: dict = {}
        for t, k, v in ev.flat():
            per_key.setdefault(k, []).append((t, v))
        out.append(sorted(per_key.items()))
        applied = [b_ for p, b_ in ev.batches
                   if any(k == "XLLM:CACHE:k5" for _, k, _ in b_)]
        out.append(applied)
        b.remove_watch(wid)
        n = len(ev.flat())
        b.set("XLLM:CACHE:after", "x")
        time.sleep(0.2)
        out.append(len(ev.flat()) == n)
    finally:
        for c in (a, b, ns1, ns2):
            c.close()
    return out


@pytest.fixture
def servers():
    made = []

    def make(pkg, auth=None):
        _, mem, srv_mod = pkg
        srv = srv_mod.CoordinationServer(
            host="127.0.0.1", port=0, auth=auth,
            store=mem.MemoryStore(expiry_tick_s=0.02))
        srv.start_background()
        made.append(srv)
        return srv

    yield make
    for s in made:
        s.stop()


def _tcp(pkg, srv, auth=None):
    cli_mod = pkg[0]

    def make(ns):
        kw = dict(username=auth[0], password=auth[1]) if auth else {}
        return cli_mod.TcpCoordinationClient(
            f"127.0.0.1:{srv.port}", namespace=ns, **kw)
    return make


@pytest.mark.parametrize("client_pkg,server_pkg", [
    (PORT, REF), (REF, PORT), (PORT, PORT)],
    ids=["port-client-ref-server", "ref-client-port-server", "port-port"])
def test_tcp_pairs_match_the_reference_pair(servers, client_pkg,
                                            server_pkg):
    got = _script(_tcp(client_pkg, servers(server_pkg)))
    want = _script(_tcp(REF, servers(REF)))
    assert got == want
    assert got[0] is True and got[1] is False and got[2] == "m1"


@pytest.mark.parametrize("client_pkg,server_pkg", [
    (PORT, REF), (REF, PORT), (PORT, PORT)],
    ids=["port-client-ref-server", "ref-client-port-server", "port-port"])
def test_auth_both_ways(servers, client_pkg, server_pkg):
    srv = servers(server_pkg, auth=AUTH)
    cli_mod = client_pkg[0]
    with pytest.raises(RuntimeError):
        cli_mod.TcpCoordinationClient(f"127.0.0.1:{srv.port}",
                                      username="root", password="wrong")
    c = cli_mod.TcpCoordinationClient(f"127.0.0.1:{srv.port}",
                                      username=AUTH[0], password=AUTH[1])
    try:
        assert c.set("k", "v") and c.get("k") == "v"
        assert c.create_if_absent("e", "1") and not c.create_if_absent("e", "2")
    finally:
        c.close()


def test_in_memory_backends_match_the_reference():
    def make(pkg):
        store = pkg[1].MemoryStore(expiry_tick_s=0.02)

        def factory(ns):
            return pkg[1].InMemoryCoordination(store, namespace=ns)
        return factory, store

    (mine, s1), (ref, s2) = make(PORT), make(REF)
    try:
        assert _script(mine) == _script(ref)
    finally:
        s1.close()
        s2.close()


def test_watch_resync_after_server_restart(servers):
    """A port client watching through a reference server's death and
    restart on the same port re-subscribes and synthesizes the DELETEs of
    the keys the new store lacks, as the reference client does."""
    results = []
    for cli_pkg in (PORT, REF):
        srv = servers(REF)
        port = srv.port
        c = cli_pkg[0].TcpCoordinationClient(f"127.0.0.1:{port}",
                                             reconnect_max_backoff_s=0.2)
        ev = _Events()
        try:
            c.add_watch("XLLM:", ev)
            c.set("XLLM:INSTANCE:MIX:gone", "x")
            _settle(lambda: len(ev.flat()) == 1)
            srv.kill()
            _settle(lambda: not c.connected)
            fresh = ref_server.CoordinationServer(
                host="127.0.0.1", port=port,
                store=ref_memory.MemoryStore(expiry_tick_s=0.02))
            fresh.start_background()
            try:
                _settle(lambda: c.connected, timeout=10)
                _settle(lambda: len(ev.flat()) >= 2)
                fresh.store.put("XLLM:INSTANCE:MIX:new", "y", None)
                _settle(lambda: len(ev.flat()) >= 3)
                results.append(ev.flat())
            finally:
                fresh.stop()
        finally:
            c.close()
    assert results[0] == results[1]
    assert results[0][1] == ("DELETE", "XLLM:INSTANCE:MIX:gone", "")
