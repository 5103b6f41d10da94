"""The port's telemetry ownership (``multimaster/ownership.py``) against the
reference's: ``rendezvous_owner`` and ``telemetry_owner`` on hypothesis
member sets and exclusions, and ``TelemetryOwnerResolver`` step by step
against the reference's on the same key scripts (the port's resolver on
the port's in-memory store and on the reference's, the reference's on the
reference's), under an injected clock: the cache window, ``note_failure``
and its 10 s exclusion, ``pin``, ``hold_last_owner`` and the fallback to
the elected master's key."""

import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu.coordination.memory import (
    InMemoryCoordination as RefCoord,
)
from xllm_service_tpu.coordination.memory import MemoryStore as RefStore
from xllm_service_tpu.multimaster import ownership as ref
from xllm_service_tpu_torch.coordination.memory import (
    InMemoryCoordination,
    MemoryStore,
)
from xllm_service_tpu_torch.multimaster import ownership as port
from xllm_service_tpu_torch.rpc import MASTER_KEY, SERVICE_KEY_PREFIX

ADDR = st.builds(lambda h, p: f"10.0.{h}:{p}", st.integers(0, 255),
                 st.integers(1, 65535))


@settings(max_examples=300, deadline=None)
@given(st.lists(ADDR, max_size=8), st.text(max_size=30), st.data())
def test_owners_are_the_references(members, key, data):
    exclude = data.draw(st.lists(st.sampled_from(members), max_size=4)
                        if members else st.just([]))
    assert port.rendezvous_owner(members, key, exclude) == \
        ref.rendezvous_owner(members, key, exclude)
    assert port.telemetry_owner(members, key, exclude) == \
        ref.telemetry_owner(members, key, exclude)
    assert port.telemetry_owner(iter(members), key) == \
        ref.telemetry_owner(list(members), key)
    assert port.TELEMETRY_SALT == ref.TELEMETRY_SALT


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Broken:
    """A coordination client whose every read fails (a plane blip)."""

    def get_prefix(self, prefix):
        raise ConnectionError("plane down")

    def get(self, key):
        raise ConnectionError("plane down")


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    # Both modules read time.monotonic at call time.
    monkeypatch.setattr(time, "monotonic", c)
    return c


@pytest.mark.parametrize("hold", [True, False])
@pytest.mark.parametrize("port_store", [True, False])
def test_resolver_is_the_references_step_by_step(clock, hold, port_store):
    """One script of membership changes, failures, pins and clock steps:
    the port's resolver answers as the reference's at every step."""
    ref_store = RefStore(expiry_tick_s=0.02)
    mine_store = MemoryStore(expiry_tick_s=0.02) if port_store else ref_store
    ref_coord = RefCoord(ref_store)
    mine_coord = (InMemoryCoordination(mine_store) if port_store
                  else RefCoord(ref_store))
    name = "127.0.0.1:7001"
    want = ref.TelemetryOwnerResolver(ref_coord, name, hold_last_owner=hold)
    got = port.TelemetryOwnerResolver(mine_coord, name, hold_last_owner=hold)
    writers = [ref_coord] + ([mine_coord] if port_store else [])
    members = [f"10.0.0.{i}:900{i}" for i in range(4)]

    def put(key, value="{}"):
        for c in writers:
            c.set(key, value)

    def rm(key):
        for c in writers:
            c.rm(key)

    trail = []

    def step(what):
        g, w = got(), want()
        trail.append((what, g, w))
        assert g == w, trail

    try:
        step("empty plane")
        put(MASTER_KEY, "10.9.9.9:1")
        step("master key, cached empty answer")
        clock.t += 2.5
        step("master key fallback")
        for m in members:
            put(SERVICE_KEY_PREFIX + m)
        step("members, still the cached master")
        clock.t += 2.5
        step("the rendezvous owner")
        owner = got()
        assert owner in members
        assert owner == ref.telemetry_owner(members, name)
        got.note_failure(owner)
        want.note_failure(owner)
        step("the successor after a failure")
        assert got() == ref.telemetry_owner(members, name, [owner])
        clock.t += 5
        step("still excluded at 5 s")
        clock.t += 6
        step("the owner again after the 10 s exclusion")
        got.pin("10.1.1.1:5")
        want.pin("10.1.1.1:5")
        step("a pinned hint")
        clock.t += 1.0
        step("the hint inside its window")
        clock.t += 1.5
        step("the hint expired")
        got.pin("")
        want.pin("")
        step("an empty pin is ignored")
        for m in members:
            rm(SERVICE_KEY_PREFIX + m)
        rm(MASTER_KEY)
        clock.t += 2.5
        step("an empty plane: the last good owner, or nothing")
        last = got()
        if hold:
            got.note_failure(last)
            want.note_failure(last)
            step("the last good owner failed: nothing")
        put(SERVICE_KEY_PREFIX + MASTER_KEY[len(SERVICE_KEY_PREFIX):])
        put(MASTER_KEY, "10.9.9.9:2")
        clock.t += 2.5
        step("the master key is not a member; the fallback")
    finally:
        for c in {id(c): c for c in (ref_coord, mine_coord)}.values():
            c.close()
        ref_store.close()
        if port_store:
            mine_store.close()


def test_a_failing_plane_falls_back_as_the_reference(clock):
    for hold in (True, False):
        got = port.TelemetryOwnerResolver(_Broken(), "e:1",
                                          hold_last_owner=hold)
        want = ref.TelemetryOwnerResolver(_Broken(), "e:1",
                                          hold_last_owner=hold)
        assert got() == want() == ""
        got._last_good = want._last_good = "m:1"
        clock.t += 3
        assert got() == want() == ("m:1" if hold else "")


def test_the_cache_window_is_one_read_per_window(clock):
    """Every call inside the window is served from the cache: one
    ``get_prefix`` per window, shared by beats and flushes."""
    reads = []

    class Counting(_Broken):
        def get_prefix(self, prefix):
            reads.append(prefix)
            return {SERVICE_KEY_PREFIX + "m:1": "{}"}

    r = port.TelemetryOwnerResolver(Counting(), "e:1", cache_s=2.0)
    for _ in range(50):
        assert r() == "m:1"
        clock.t += 0.01
    assert len(reads) == 1
    clock.t += 2.0
    assert r() == "m:1" and len(reads) == 2
