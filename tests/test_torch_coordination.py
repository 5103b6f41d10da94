"""The port's coordination clients against the reference's: its TCP client
against the reference's ``CoordinationServer`` (the newline-JSON protocol,
leases, keepalive, reconnect), and its in-process store against the
reference's on one TTL and expiry script."""

import time

import pytest

from xllm_service_tpu.coordination.memory import MemoryStore as RefStore
from xllm_service_tpu.coordination.server import CoordinationServer
from xllm_service_tpu_torch.common.net import pick_free_port
from xllm_service_tpu_torch.coordination import connect
from xllm_service_tpu_torch.coordination.client import (
    CoordinationError,
    TcpCoordinationClient,
)
from xllm_service_tpu_torch.coordination.memory import (
    InMemoryCoordination,
    MemoryStore,
)

from fakes import wait_until

TTL = 0.6
SCRIPT_TTL = 1.0   # the store script's lease: wide margins under load


@pytest.fixture
def server():
    srv = CoordinationServer(host="127.0.0.1", port=0,
                             store=RefStore(expiry_tick_s=0.02))
    srv.start_background()
    yield srv
    srv.stop()


def _client(srv, **kw):
    return TcpCoordinationClient(f"127.0.0.1:{srv.port}", **kw)


def test_set_get_rm(server):
    c = _client(server)
    try:
        assert c.ping()
        assert c.set("k", "v1") and c.get("k") == "v1"
        assert server.store.get("k") == "v1"
        assert c.get("missing") is None
        assert c.rm("k") and c.get("k") is None
        assert not c.rm("k")
    finally:
        c.close()
    assert not c.ping() and c.get("k") is None


def test_keepalive_holds_the_lease_and_close_lets_it_lapse(server):
    owner, reader = _client(server), _client(server)
    try:
        assert owner.set("lease", "alive", ttl_s=TTL)
        assert reader.set("once", "x", ttl_s=TTL)
        reader.release("once")
        time.sleep(4 * TTL)
        assert reader.get("lease") == "alive"   # refreshed at ttl/3
        assert reader.get("once") is None       # released: never refreshed
        owner.close()
        assert wait_until(lambda: reader.get("lease") is None,
                          timeout=5 * TTL)
    finally:
        owner.close()
        reader.close()


def test_release_stops_the_keepalive(server):
    c = _client(server)
    try:
        c.set("lease", "v", ttl_s=TTL)
        c.release("lease")
        assert wait_until(lambda: c.get("lease") is None, timeout=5 * TTL)
    finally:
        c.close()


def test_reconnect_recreates_leased_keys(server):
    c = _client(server, reconnect_max_backoff_s=0.2)
    port = server.port
    fresh = None
    try:
        c.set("lease", "v", ttl_s=TTL)
        c.set("plain", "p")
        server.kill()                       # the store dies with it
        assert wait_until(lambda: not c.connected, timeout=5)
        assert not c.ping() and not c.set("x", "y")
        fresh = CoordinationServer(host="127.0.0.1", port=port,
                                   store=RefStore(expiry_tick_s=0.02))
        fresh.start_background()
        assert wait_until(lambda: c.connected, timeout=10)
        assert c.reconnects_total == 1
        assert fresh.store.get("lease") == "v"   # re-created
        assert fresh.store.get("plain") is None  # not leased: lost
        time.sleep(4 * TTL)
        assert c.get("lease") == "v"             # and kept alive
    finally:
        c.close()
        if fresh is not None:
            fresh.stop()


def test_unreachable_server_raises():
    with pytest.raises(OSError):
        TcpCoordinationClient(f"127.0.0.1:{pick_free_port()}")
    assert issubclass(CoordinationError, RuntimeError)


def _script(store) -> list:
    """One TTL and expiry script, run against a store's put/refresh/get/rm."""
    T = SCRIPT_TTL
    out = [store.put("a", "1", T), store.put("b", "2", None),
           store.put("c", "3", T)]
    time.sleep(T / 2)
    out += [store.refresh("a", T), store.refresh("b", T),
            store.refresh("zz", T)]
    time.sleep(0.75 * T)            # c's lease has run out, a's has not
    out += [store.get("a"), store.get("b"), store.get("c")]
    time.sleep(0.75 * T)
    out += [store.get("a"), store.put("a", "4", T),
            store.get("a"), store.rm("b"), store.rm("b"), store.get("b")]
    return out


def test_memory_store_matches_reference():
    mine, ref = MemoryStore(expiry_tick_s=0.01), RefStore(expiry_tick_s=0.01)
    try:
        got, want = _script(mine), _script(ref)
    finally:
        mine.close()
        ref.close()
    assert got == want
    assert got == [True, True, True, True, False, False,
                   "1", "2", None, None, True, "4", True, False, None]


def test_in_memory_client_leases():
    store = MemoryStore(expiry_tick_s=0.01)
    owner = InMemoryCoordination(store)
    reader = InMemoryCoordination(store)
    try:
        assert owner.ping()
        owner.set("lease", "v", ttl_s=TTL)
        time.sleep(3 * TTL)
        assert reader.get("lease") == "v" and owner.get("lease") == "v"
        owner.close()
        assert wait_until(lambda: reader.get("lease") is None,
                          timeout=5 * TTL)
    finally:
        owner.close()
        store.close()


def test_connect_picks_the_backend(server):
    mem = connect("")
    assert isinstance(mem, InMemoryCoordination)
    assert mem.store is MemoryStore.shared()
    tcp = connect(f"127.0.0.1:{server.port}")
    try:
        assert isinstance(tcp, TcpCoordinationClient) and tcp.ping()
    finally:
        tcp.close()
        mem.close()


def _prefix_script(put, get_prefix) -> list:
    for k, v in (("XLLM:SERVICE:a:1", "x"), ("XLLM:SERVICE:MASTER", "a:1"),
                 ("XLLM:SERVICE:b:2", "y"), ("XLLM:INSTANCE:MIX:e", "z"),
                 ("XLLM:SERVICEX", "w")):
        put(k, v)
    return [get_prefix("XLLM:SERVICE:"), get_prefix("XLLM:"),
            get_prefix("nope"), get_prefix("")]


def test_get_prefix_against_the_reference_server(server):
    c = _client(server)
    try:
        got = _prefix_script(c.set, c.get_prefix)
    finally:
        c.close()
    ref = RefStore(expiry_tick_s=0.02)
    try:
        want = _prefix_script(lambda k, v: ref.put(k, v, None),
                              ref.get_prefix)
    finally:
        ref.close()
    assert got == want
    assert set(got[0]) == {"XLLM:SERVICE:a:1", "XLLM:SERVICE:MASTER",
                           "XLLM:SERVICE:b:2"}


def test_get_prefix_of_the_in_memory_store_matches_reference():
    mine, ref = MemoryStore(expiry_tick_s=0.01), RefStore(expiry_tick_s=0.01)
    client = InMemoryCoordination(mine)
    try:
        got = _prefix_script(client.set, client.get_prefix)
        want = _prefix_script(lambda k, v: ref.put(k, v, None),
                              ref.get_prefix)
        # A lapsed lease leaves the prefix view.
        client.set("XLLM:SERVICE:c:3", "q", ttl_s=0.05)
        client.release("XLLM:SERVICE:c:3")
        assert wait_until(lambda: "XLLM:SERVICE:c:3" not in
                          client.get_prefix("XLLM:SERVICE:"), timeout=5)
    finally:
        client.close()
        mine.close()
        ref.close()
    assert got == want
