"""The failover and outage planes' drills on the port's master against the
JAX master, on the CPU.

Each drill is a function ``drill_x(P)`` run on masters of package ``P``
(each on its own package's coordination store or server, with the
reference's fake engines), with the reference drill's own assertions;
the two outcomes must be equal. They twin:

- ``tests/test_chaos_failover.py``: concurrent streams across an
  instance's death, an engine's 5xx on accept failed over, a burst
  through a coordination outage with a crash inside it, the per-request
  retry budget (0, and exhausted with no survivor), idempotent replay
  (a stale incarnation's delta dropped, the replay prefix tracked) and
  the msgpack dispatch replayed byte for byte;
- ``tests/test_multimaster.py::TestCoordinationOutage``: degraded mode
  holding and recovering, degraded mode off, and the total outage over
  TCP (the reference's server under the JAX masters, the port's
  ``coordination/server.py`` under the port's);
- ``tests/test_routing_snapshot.py``: the snapshot's semantics, the
  scheduling races and the churn drill under live streams. The eviction
  race keeps the invariant of the reference class's docstring (no OK
  schedule binds to a pair that was dead before the call began) but
  records a pair as dead only once its deregistration has returned, the
  same bookkeeping for both packages.

Drills that wait on time wait on the event they check, with a bound.
"""

import json
import threading
import time
import uuid

import pytest
import requests
import torch

from fakes import FakeChannel, make_meta, wait_until
from test_torch_overload_drills import (  # noqa: F401 — autouse fixture
    ENGINE_FAULTS,
    PKGS,
    SEED,
    REPLY as PLANE_REPLY,
    Fleet,
    _clean_planes,
    await_fleet,
    base,
    both,
    norm,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

REPLY = "Resilience is the art of continuing exactly where you left off."
ENGINE = dict(reply_text=REPLY, chunk_size=4, delay_s=0.05,
              heartbeat_interval_s=0.1, lease_ttl_s=0.5)
OPTS = dict(host="127.0.0.1", http_port=0, rpc_port=0,
            lease_ttl_s=0.5, reconcile_interval_s=0.05,
            heartbeat_silence_to_suspect_s=0.3,
            detect_disconnected_instance_interval_s=0.3,
            health_probe_attempts=1, health_probe_timeout_s=0.2,
            sync_interval_s=0.2, failover_backoff_base_s=0.05,
            failover_backoff_max_s=0.3, rpc_backoff_base_s=0.02,
            rpc_backoff_max_s=0.1)
OUTAGE = dict(coordination_degraded_after_ticks=2,
              coordination_reconnect_jitter_s=0.2,
              degraded_heartbeat_silence_s=0.5)


def duo(P, n=2, **kw):
    """A master with ``n`` MIX fake engines (RR puts each request on one
    MIX instance, which serves both stages)."""
    return Fleet(P, engines=[ENGINE] * n, opts=OPTS, **kw)


def loads_zero(m):
    mgr = m.scheduler.instance_mgr
    with mgr._metrics_lock:
        return all(rl.num_prefill_requests == 0
                   and rl.num_prefill_tokens == 0
                   and rl.num_decode_requests == 0
                   and rl.num_decode_tokens == 0
                   for rl in mgr._request_loads.values())


def stream(m, timeout=60):
    """(text, finish reasons) of one streamed completion; raises on an
    error frame."""
    r = requests.post(base(m) + "/v1/completions", json={
        "model": "fake-model", "prompt": "chaos", "stream": True,
        "max_tokens": 1000}, stream=True, timeout=timeout)
    assert r.status_code == 200, r.text
    text, finishes = "", []
    for line in r.iter_lines():
        if not line.startswith(b"data: "):
            continue
        data = line[6:]
        if data == b"[DONE]":
            break
        obj = json.loads(data)
        if "error" in obj:
            raise RuntimeError(f"stream error: {norm(json.dumps(obj))}")
        for c in obj.get("choices", ()):
            text += c.get("text", "")
            if c.get("finish_reason"):
                finishes.append(c["finish_reason"])
    return text, finishes


def crash_after(n):
    ENGINE_FAULTS.configure([dict(point="engine.token", action="crash",
                                  after=n, max_fires=1)], seed=SEED)


def kinds(P, kind, sid=None):
    return [r["kind"] for r in P.RECORDER.recent(limit=200, kind=kind)
            if sid is None or r["request_id"] == sid]


# ============================================= TestMidstreamCrashFailover
def drill_concurrent_inflight(P):
    """Every in-flight request completes across an instance's death."""
    fl = duo(P)
    m = fl.masters[0]
    try:
        crash_after(10)
        before = P.metrics.FAILOVER_SUCCESS_TOTAL.value()
        results, errors = {}, []

        def run(i):
            try:
                results[i], _ = stream(m)
            except BaseException as e:  # noqa: BLE001 — collected
                errors.append(e)
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert len(results) == 4
        assert all(text == REPLY for text in results.values()), results
        dead = sum(1 for e in fl.engines if not e._alive)
        assert dead == 1
        assert wait_until(lambda: loads_zero(m), timeout=5)
        return dict(texts=sorted(results.values()), dead=dead,
                    recovered=P.metrics.FAILOVER_SUCCESS_TOTAL.value()
                    - before >= 1)
    finally:
        ENGINE_FAULTS.configure((), seed=SEED)
        fl.close()


def test_concurrent_inflight_requests_all_complete():
    assert both(drill_concurrent_inflight) == dict(
        texts=[REPLY] * 4, dead=1, recovered=True)


# ============================================ TestDispatchFailureFailover
def drill_engine_5xx_on_accept(P):
    fl = duo(P)
    m = fl.masters[0]
    try:
        ENGINE_FAULTS.configure([dict(point="engine.accept", action="error",
                                      max_fires=1)], seed=SEED)
        before = P.metrics.FAILOVER_SUCCESS_TOTAL.value()
        attempts0 = P.metrics.FAILOVER_ATTEMPTS_TOTAL.value()
        text, finishes = stream(m)
        assert text == REPLY
        assert finishes == ["stop"]
        assert P.metrics.FAILOVER_SUCCESS_TOTAL.value() == before + 1
        assert all(e._alive for e in fl.engines)
        assert wait_until(lambda: loads_zero(m), timeout=5)
        accepted = [len(e.accepted_requests) for e in fl.engines]
        return dict(text=text, finishes=finishes,
                    recovered=P.metrics.FAILOVER_SUCCESS_TOTAL.value()
                    - before,
                    attempts=P.metrics.FAILOVER_ATTEMPTS_TOTAL.value()
                    - attempts0,
                    accepted=sorted(accepted), records=kinds(P, "failover")
                    [-1:])
    finally:
        ENGINE_FAULTS.configure((), seed=SEED)
        fl.close()


def test_engine_5xx_on_accept_fails_over():
    out = both(drill_engine_5xx_on_accept)
    assert out["recovered"] == 1 and out["accepted"] == [0, 1]
    assert out["records"] == ["failover"]


# ========================================= TestCoordinationOutageFailover
def drill_burst_through_outage(P):
    """A burst through a total outage, then a crash inside it: streams
    complete byte for byte, the census holds, the eviction replays."""
    fl = duo(P, **OUTAGE)
    m = fl.masters[0]
    dead = live = None
    try:
        expected, _ = stream(m)
        assert expected == REPLY
        mon = m.scheduler.coordination_health
        results, errors = {}, []

        def run(i):
            try:
                results[i], _ = stream(m)
            except BaseException as e:  # noqa: BLE001 — collected
                errors.append(e)
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        P.FAULTS.add("coord.outage", action="error")
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert all(text == REPLY for text in results.values()), results
        assert wait_until(lambda: mon.state() == "DEGRADED", timeout=5)
        sticky = m.scheduler.is_master
        assert sticky
        # The crash joins the outage: under the JAX master both rules
        # live on the one fault plane (configure replaces its rules).
        crash = [dict(point="engine.token", action="crash", after=4,
                      max_fires=1)]
        if P.FAULTS is ENGINE_FAULTS:
            crash.insert(0, dict(point="coord.outage", action="error"))
        ENGINE_FAULTS.configure(crash, seed=SEED)
        before = P.metrics.FAILOVER_SUCCESS_TOTAL.value()
        text, finishes = stream(m)
        assert text == expected and finishes == ["stop"]
        assert P.metrics.FAILOVER_SUCCESS_TOTAL.value() == before + 1
        dead = [e for e in fl.engines if not e._alive]
        live = [e for e in fl.engines if e._alive]
        assert len(dead) == 1
        mgr = m.scheduler.instance_mgr
        assert wait_until(lambda: mgr.get_instance_state(dead[0].name)
                          == P.State.SUSPECT, timeout=5)
        assert wait_until(lambda: any(
            a["kind"] == "evict" and a["key"] == dead[0].name
            for a in mon.held.report()["actions"]), timeout=5)
        live_state = mgr.get_instance_state(live[0].name).name
        assert live_state == "ACTIVE"
        during = stream(m)[0]
        assert during == expected
        P.FAULTS.clear()
        ENGINE_FAULTS.configure((), seed=SEED)
        assert wait_until(lambda: mon.state() == "CONNECTED", timeout=10)
        assert wait_until(lambda: mgr.get_instance_meta(dead[0].name)
                          is None, timeout=5)
        assert mgr.get_instance_state(live[0].name) == P.State.ACTIVE
        after = stream(m)[0]
        assert after == expected
        return dict(burst=sorted(results.values()), sticky=sticky,
                    failover=(text, finishes), live_state=live_state,
                    during=during, after=after,
                    records=sorted({k for k in kinds(P, None)
                                    if k.startswith("coordination_")
                                    or k == "held_action_replay"}))
    finally:
        P.FAULTS.clear()
        ENGINE_FAULTS.configure((), seed=SEED)
        fl.close()


def test_burst_survives_outage_and_midstream_crash():
    out = both(drill_burst_through_outage)
    assert out["burst"] == [REPLY] * 4 and out["after"] == REPLY
    assert {"coordination_degraded", "coordination_recovered",
            "held_action_replay"} <= set(out["records"])


# ======================================================= TestRetryBudget
def drill_budget_zero(P):
    """failover_max_retries=0: a prompt error, no hang, no leaked load."""
    fl = duo(P, n=1, failover_max_retries=0, request_timeout_s=60)
    m = fl.masters[0]
    try:
        crash_after(4)
        before = P.metrics.REQUESTS_CANCELLED_TOTAL.value()
        start = time.time()
        with pytest.raises(RuntimeError, match="stream error") as err:
            stream(m, timeout=30)
        assert time.time() - start < 20
        assert P.metrics.REQUESTS_CANCELLED_TOTAL.value() == before + 1
        assert wait_until(lambda: loads_zero(m), timeout=5)
        return str(err.value), P.metrics.REQUESTS_CANCELLED_TOTAL.labels(
            reason="failover").value() >= 1
    finally:
        ENGINE_FAULTS.configure((), seed=SEED)
        fl.close()


def test_budget_zero_prompt_503_no_hang():
    message, counted = both(drill_budget_zero)
    assert "503" in message and counted


def drill_budget_no_survivors(P):
    fl = duo(P, n=1, failover_max_retries=2, request_timeout_s=60)
    m = fl.masters[0]
    try:
        crash_after(4)
        start = time.time()
        with pytest.raises(RuntimeError, match="stream error") as err:
            stream(m, timeout=30)
        assert time.time() - start < 20
        assert wait_until(lambda: loads_zero(m), timeout=5)
        return str(err.value)
    finally:
        ENGINE_FAULTS.configure((), seed=SEED)
        fl.close()


def test_budget_exhausted_with_no_survivors_503():
    assert "retry budget exhausted" in both(drill_budget_no_survivors)


# ================================================== TestIdempotentReplay
class Units:
    """A package's scheduler-level types for the hermetic drills."""

    def __init__(self, which):
        if which == "ref":
            from xllm_service_tpu.common.call_data import (
                CollectingConnection,
            )
            from xllm_service_tpu.common.config import ServiceOptions
            from xllm_service_tpu.common import request, types
            from xllm_service_tpu.coordination.memory import (
                InMemoryCoordination,
                MemoryStore,
            )
            from xllm_service_tpu.rpc import wire
            from xllm_service_tpu.scheduler.instance_mgr import InstanceMgr
            from xllm_service_tpu.scheduler.scheduler import Scheduler
        else:
            from xllm_service_tpu_torch.common.call_data import (
                CollectingConnection,
            )
            from xllm_service_tpu_torch.common.config import ServiceOptions
            from xllm_service_tpu_torch.common import request, types
            from xllm_service_tpu_torch.coordination.memory import (
                InMemoryCoordination,
                MemoryStore,
            )
            from xllm_service_tpu_torch.rpc import wire
            from xllm_service_tpu_torch.scheduler.instance_mgr import (
                InstanceMgr,
            )
            from xllm_service_tpu_torch.scheduler.scheduler import Scheduler
        self.which = which
        self.Conn, self.Options = CollectingConnection, ServiceOptions
        self.request, self.types, self.wire = request, types, wire
        self.Coord, self.Store = InMemoryCoordination, MemoryStore
        self.InstanceMgr, self.Scheduler = InstanceMgr, Scheduler

    def meta(self, name, itype="MIX", **kw):
        """``fakes.make_meta`` in this package's types."""
        ref = make_meta(name, **kw)
        meta = self.types.InstanceMetaInfo.from_json(ref.to_json())
        meta.type = self.types.InstanceType(itype)
        return meta


UNITS = {w: Units(w) for w in ("ref", "port")}


@pytest.fixture(params=("ref", "port"))
def U(request):
    FakeChannel.reset()
    U = UNITS[request.param]
    store = U.Store(expiry_tick_s=0.02)
    U.store = store
    yield U
    store.close()


def _hermetic_scheduler(U, **kw):
    opts = dict(reconcile_interval_s=0.05, sync_interval_s=0.1,
                lease_ttl_s=0.2)
    opts.update(kw)
    sched = U.Scheduler(U.Options(**opts), coord=U.Coord(U.store),
                        start_threads=False)
    sched.instance_mgr._channel_factory = FakeChannel.factory
    return sched


def drill_stale_incarnation_dropped(U):
    sched = _hermetic_scheduler(U)
    R = U.request
    try:
        sched.instance_mgr.register_instance(
            U.meta("m1", incarnation_id="INC-NEW"), link_peers=False)
        req = R.Request(service_request_id="sid-1", request_id="r",
                        model="m", stream=True, prompt="hello")
        assert sched.schedule(req).ok()
        conn = U.Conn(stream=True)
        sched.record_new_request(req, conn, "completion")
        assert req.prefill_incarnation == "INC-NEW"
        stale = R.RequestOutput(
            service_request_id="sid-1", instance="m1", incarnation="INC-OLD",
            outputs=[R.SequenceOutput(index=0, text="ZOMBIE",
                                      token_ids=[9])])
        dropped = not sched.handle_generation(stale)
        assert dropped
        fresh = R.RequestOutput(
            service_request_id="sid-1", instance="m1", incarnation="INC-NEW",
            outputs=[R.SequenceOutput(index=0, text="ok", token_ids=[0])])
        assert sched.handle_generation(fresh)
        sched._output_executor.drain()
        texts = [c["choices"][0]["text"] for c in conn.payloads
                 if c.get("choices")]
        assert texts == ["ok"]
        assert sched.has_request("sid-1")
        cancels = FakeChannel.registry["m1"].cancels
        return dropped, texts, cancels
    finally:
        sched.stop()


def both_units(drill):
    """A hermetic drill on each package's scheduler: equal outcomes."""
    outs = []
    for which in ("ref", "port"):
        U = UNITS[which]
        FakeChannel.reset()
        U.store = U.Store(expiry_tick_s=0.02)
        try:
            outs.append(drill(U))
        finally:
            U.store.close()
    assert outs[1] == outs[0], outs
    return outs[1]


def test_stale_incarnation_delta_dropped():
    dropped, texts, _ = both_units(drill_stale_incarnation_dropped)
    assert dropped and texts == ["ok"]


def drill_replay_prefix(U):
    sched = _hermetic_scheduler(U)
    R = U.request
    try:
        sched.instance_mgr.register_instance(U.meta("m1"), link_peers=False)
        req = R.Request(service_request_id="sid-2", request_id="r",
                        model="m", stream=True, prompt="hello")
        assert sched.schedule(req).ok()
        sched.record_new_request(req, U.Conn(stream=True), "completion")
        for seq, toks in enumerate(([1, 2], [3], [4, 5]), start=1):
            sched.handle_generation(R.RequestOutput(
                service_request_id="sid-2", delta_seq=seq,
                outputs=[R.SequenceOutput(index=0, text="x",
                                          token_ids=list(toks))]))
        dup = sched.handle_generation(R.RequestOutput(
            service_request_id="sid-2", delta_seq=3,
            outputs=[R.SequenceOutput(index=0, text="x",
                                      token_ids=[4, 5])]))
        st = sched._requests["sid-2"]
        assert st.replay_token_ids == [1, 2, 3, 4, 5]
        return list(st.replay_token_ids), dup
    finally:
        sched.stop()


def test_replay_token_prefix_is_tracked():
    prefix, _ = both_units(drill_replay_prefix)
    assert prefix == [1, 2, 3, 4, 5]


# ================================================ TestMsgpackDispatchWire
def drill_replay_byte_equivalent(P):
    """The failover replay of the retained payload is the first dispatch
    byte for byte on the msgpack wire, minus the failover-volatile
    keys."""
    fl = duo(P)
    m = fl.masters[0]
    wire = P.wire
    try:
        ENGINE_FAULTS.configure([dict(point="engine.accept", action="error",
                                      max_fires=1)], seed=SEED)
        text, finishes = stream(m)
        assert text == REPLY and finishes == ["stop"]
        wires = [w for e in fl.engines for w in e.accepted_wire]
        assert len(wires) == 2
        assert all(ctype == wire.MSGPACK_CONTENT_TYPE for ctype, _ in wires)
        first, replay = (wire.unpack_dispatch(raw) for _, raw in wires)
        assert replay["failover_attempt"] == 1
        assert replay["resume_generated_token_ids"] == []
        assert replay["token_ids"] == first["token_ids"]
        volatile = ("routing", "trace_context", "failover_attempt",
                    "resume_generated_token_ids")
        core_first = {k: v for k, v in first.items() if k not in volatile}
        core_replay = {k: v for k, v in replay.items() if k not in volatile}
        assert wire.pack_dispatch(core_first) == \
            wire.pack_dispatch(core_replay)
        assert wait_until(lambda: loads_zero(m), timeout=5)
        scrub = ("service_request_id", "request_id", "source_service_addr",
                 "deadline_ms", "created")
        return (sorted(first), sorted(replay),
                {k: v for k, v in core_first.items() if k not in scrub})
    finally:
        ENGINE_FAULTS.configure((), seed=SEED)
        fl.close()


def test_failover_replay_byte_equivalent_on_binary_wire():
    first, replay, core = both(drill_replay_byte_equivalent)
    assert set(replay) - set(first) == {"failover_attempt",
                                        "resume_generated_token_ids"}


# ============================================== TestCoordinationOutage
def drill_monitor_degrades_holds_recovers(P):
    fl = Fleet(P, engines=({}, {}), **OUTAGE)
    m = fl.masters[0]
    chatty, doomed = fl.engines
    # The flight recorder is the process's: earlier drills' records (the
    # burst through an outage replays held actions too) are not this
    # drill's evidence.
    since_ms = time.time() * 1000.0
    try:
        assert m.scheduler.is_master
        mon = m.scheduler.coordination_health
        P.FAULTS.add("coord.outage", action="error")
        assert wait_until(lambda: mon.state() == "DEGRADED", timeout=5)
        assert m.scheduler.is_master
        assert wait_until(lambda: mon.held.depth() >= 3, timeout=5)
        depth = mon.held.depth()
        failures = mon.report()["consecutive_failures"]
        # Two more sync ticks (each a failed probe) grow counts, not the
        # log.
        assert wait_until(lambda: mon.report()["consecutive_failures"]
                          >= failures + 2, timeout=5)
        rep = mon.held.report()
        assert rep["depth"] == depth
        assert any(a["count"] >= 2 for a in rep["actions"])
        # The election-gated publishes are held on every tick; the
        # sharded frame publish only while a shard is dirty (timing).
        held_kinds = sorted(a["kind"] for a in rep["actions"]
                            if a["kind"] != "loadframe_publish")
        doomed.kill()
        mgr = m.scheduler.instance_mgr
        assert wait_until(lambda: mgr.get_instance_state(doomed.name)
                          == P.State.SUSPECT, timeout=5)
        assert wait_until(lambda: any(
            a["kind"] == "evict" and a["key"] == doomed.name
            for a in mon.held.report()["actions"]), timeout=5)
        assert mgr.get_instance_state(chatty.name) == P.State.ACTIVE
        frozen = mon.report()["frozen_events"].get("lease_lapse", 0)
        assert frozen >= 1
        P.FAULTS.clear()
        assert wait_until(lambda: mon.state() == "CONNECTED", timeout=5)
        assert m.scheduler.is_master
        assert wait_until(lambda: mgr.get_instance_meta(doomed.name)
                          is None, timeout=5)
        assert mon.held.depth() == 0

        def records(kind):
            return [r for r in P.RECORDER.recent(limit=50, kind=kind)
                    if r["ts_ms"] >= since_ms]

        def replays():
            return records("held_action_replay")
        assert wait_until(lambda: any(
            r["detail"].get("key") == doomed.name
            and r["detail"].get("outcome") == "replayed: evicted"
            for r in replays()), timeout=5)
        assert any("superseded" in r["detail"].get("outcome", "")
                   for r in replays())
        assert records("coordination_degraded")
        assert records("coordination_recovered")
        r = requests.post(base(m) + "/v1/completions", json={
            "model": "fake-model", "prompt": "multimaster",
            "max_tokens": 1000}, timeout=30)
        text = r.json()["choices"][0]["text"]
        assert text == PLANE_REPLY
        report = requests.get(base(m) + "/admin/coordination",
                              timeout=5).json()
        return dict(held_kinds=held_kinds, frozen=frozen >= 1,
                    outcomes=sorted({r["detail"]["outcome"].split(":")[0]
                                     for r in replays()}),
                    text=text, state=report["state"],
                    report=sorted(report), connected=P.metrics
                    .COORDINATION_CONNECTED.value())
    finally:
        P.FAULTS.clear()
        fl.close()


def test_monitor_degrades_holds_and_recovers():
    out = both(drill_monitor_degrades_holds_recovers)
    assert out["state"] == "CONNECTED" and out["connected"] == 1
    assert {"replayed", "superseded"} <= set(out["outcomes"])


def test_held_eviction_replays_when_recovery_is_slow():
    """The port's master alone: the census unfreezes (CONNECTED) before
    the recovery callback replays the held actions. With that callback
    slowed (its first coordination write stalls 0.5 s, as a loaded box
    stalls it), the reconcile pass (every 0.05 s) must still leave the
    dead engine's eviction to the replay: "replayed: evicted", not
    "discarded: already gone". The JAX master evicts it first."""
    P = PKGS["port"]
    fl = Fleet(P, engines=({}, {}), **OUTAGE)
    m = fl.masters[0]
    _, doomed = fl.engines
    since_ms = time.time() * 1000.0
    coord = m.scheduler._coord
    real_set = coord.set

    def slow_set(key, *a, **kw):
        if key.startswith(P.rpc.SERVICE_KEY_PREFIX):
            time.sleep(0.5)
        return real_set(key, *a, **kw)
    try:
        mon = m.scheduler.coordination_health
        P.FAULTS.add("coord.outage", action="error")
        assert wait_until(lambda: mon.state() == "DEGRADED", timeout=5)
        doomed.kill()
        assert wait_until(lambda: any(
            a["kind"] == "evict" and a["key"] == doomed.name
            for a in mon.held.report()["actions"]), timeout=5)
        coord.set = slow_set
        P.FAULTS.clear()
        assert wait_until(lambda: mon.state() == "CONNECTED", timeout=5)

        def outcomes():
            return [r["detail"].get("outcome") for r in P.RECORDER.recent(
                limit=50, kind="held_action_replay")
                if r["ts_ms"] >= since_ms
                and r["detail"].get("key") == doomed.name]
        assert wait_until(outcomes, timeout=5)
        assert outcomes() == ["replayed: evicted"]
        assert m.scheduler.instance_mgr.get_instance_meta(doomed.name) \
            is None
    finally:
        coord.set = real_set
        P.FAULTS.clear()
        fl.close()


def drill_degraded_mode_off(P):
    fl = Fleet(P, engines=(), coordination_degraded_mode="off",
               coordination_degraded_after_ticks=2)
    m = fl.masters[0]
    try:
        mon = m.scheduler.coordination_health
        P.FAULTS.add("coord.outage", action="error")
        assert wait_until(lambda: mon.report()["consecutive_failures"] >= 5,
                          timeout=5)
        assert mon.state() == "CONNECTED"
        assert not mon.degraded()
        assert mon.held.depth() == 0
        assert mon.report()["enabled"] is False
        return (mon.state(), mon.degraded(), mon.held.depth(),
                mon.report()["enabled"])
    finally:
        P.FAULTS.clear()
        fl.close()


def test_degraded_mode_off_is_legacy_behavior():
    assert both(drill_degraded_mode_off) == ("CONNECTED", False, 0, False)


def drill_total_outage_over_tcp(P):
    """The coordination server killed mid-stream, a multi-second outage
    served through, an engine killed inside it, the server restarted
    empty on the same port: monitors CONNECTED, the fleet re-registered,
    the held eviction replayed, traffic flowing."""
    srv = P.server.CoordinationServer(host="127.0.0.1", port=0)
    srv.start_background()
    port = srv.port
    addr = f"127.0.0.1:{port}"

    def tcp_master(**kw):
        m = P.Master(P.Options(**{**OPTS, "handoff_stall_timeout_s": 1.5,
                                  "coordination_addr": addr,
                                  **OUTAGE, **kw}))
        m.start()
        return m

    def tcp_engine(delay_s=0.0):
        from xllm_service_tpu.testing.fake_engine import (
            FakeEngine,
            FakeEngineConfig,
        )

        coord = P.client.TcpCoordinationClient(addr,
                                               reconnect_max_backoff_s=0.15)
        return FakeEngine(coord, FakeEngineConfig(
            reply_text=REPLY, chunk_size=4, delay_s=delay_s,
            heartbeat_interval_s=0.1, lease_ttl_s=0.5,
            telemetry_mode="mux")).start()

    m1 = m2 = chatty = doomed = srv2 = None
    stop_sampler = threading.Event()
    spurious: list = []

    def sample():
        while not stop_sampler.wait(0.01):
            for m in (m1, m2):
                st = m.scheduler.instance_mgr.get_instance_state(chatty.name)
                if st in (P.State.SUSPECT, P.State.LEASE_LOST):
                    spurious.append((m.scheduler.self_addr, st))

    def completion(m):
        r = requests.post(base(m) + "/v1/completions", json={
            "model": "fake-model", "prompt": "multimaster",
            "max_tokens": 1000}, timeout=30)
        return r.json()["choices"][0]["text"]

    try:
        m1 = tcp_master(coordination_reconnect_jitter_s=0.1)
        m2 = tcp_master(coordination_reconnect_jitter_s=0.5)
        chatty = tcp_engine(delay_s=0.12)
        doomed = tcp_engine()
        await_fleet([m1, m2], [chatty, doomed])
        assert m1.scheduler.is_master
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        r = requests.post(base(m1) + "/v1/completions", json={
            "model": "fake-model", "prompt": "multimaster",
            "max_tokens": 1000, "stream": True}, stream=True, timeout=90)
        text, finishes, frames = "", [], 0
        for line in r.iter_lines():
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            frames += 1
            if frames == 3:
                srv.kill()
            for c in json.loads(line[6:]).get("choices", ()):
                text += c.get("text", "")
                if c.get("finish_reason"):
                    finishes.append(c["finish_reason"])
        assert text == REPLY and finishes == ["stop"]
        mons = [m1.scheduler.coordination_health,
                m2.scheduler.coordination_health]
        assert wait_until(lambda: all(mon.state() == "DEGRADED"
                                      for mon in mons), timeout=5)
        assert m1.scheduler.is_master
        assert not m2.scheduler.is_master
        during = [completion(m1), completion(m2)]
        assert during == [REPLY, REPLY]
        owner_m = m1 if m1.scheduler.ownership.owns_instance(doomed.name) \
            else m2
        doomed.kill()
        assert wait_until(
            lambda: owner_m.scheduler.instance_mgr.get_instance_state(
                doomed.name) == P.State.SUSPECT, timeout=5)
        own_mon = owner_m.scheduler.coordination_health
        assert wait_until(lambda: any(
            a["kind"] == "evict" and a["key"] == doomed.name
            for a in own_mon.held.report()["actions"]), timeout=5)
        degraded_report = requests.get(base(m1) + "/admin/coordination",
                                       timeout=5).json()
        srv2 = P.server.CoordinationServer(host="127.0.0.1", port=port)
        srv2.start_background()
        assert wait_until(lambda: all(mon.state() == "CONNECTED"
                                      for mon in mons), timeout=15)
        assert m1.scheduler.is_master
        assert not m2.scheduler.is_master
        assert m1.scheduler._coord.reconnects_total >= 1
        kvs = m1.scheduler._coord.get_prefix(P.rpc.SERVICE_KEY_PREFIX)
        members = len([k for k in kvs if k != P.rpc.MASTER_KEY])
        assert members == 2
        assert wait_until(lambda: all(
            m.scheduler.instance_mgr.get_instance_meta(doomed.name) is None
            for m in (m1, m2)), timeout=10)
        assert all(m.scheduler.instance_mgr.get_instance_state(chatty.name)
                   == P.State.ACTIVE for m in (m1, m2))
        stop_sampler.set()
        sampler.join(timeout=5)
        assert not spurious, f"spurious verdicts: {spurious[:5]}"
        after = [completion(m1), completion(m2)]
        assert after == [REPLY, REPLY]
        return dict(stream=(text, finishes), during=during, after=after,
                    degraded=degraded_report["state"],
                    members=members, spurious=len(spurious))
    finally:
        stop_sampler.set()
        for e in (chatty, doomed):
            if e is not None:
                e.stop()
                e.coord.close()
        for m in (m1, m2):
            if m is not None:
                m.stop()
        for s in (srv, srv2):
            if s is not None:
                try:
                    s.stop()
                except OSError:
                    pass


def test_total_outage_static_stability_over_tcp():
    out = both(drill_total_outage_over_tcp)
    assert out["spurious"] == 0 and out["after"] == [REPLY, REPLY]


# ================================================= TestSnapshotSemantics
def _mgr(U):
    opts = U.Options(reconcile_interval_s=3600, sync_interval_s=3600)
    return U.InstanceMgr(U.Coord(U.store), opts,
                         channel_factory=FakeChannel.factory,
                         start_threads=False)


def test_suspect_and_draining_leave_routing(U):
    mgr = _mgr(U)
    try:
        mgr.register_instance(U.meta("a"), link_peers=False)
        mgr.register_instance(U.meta("b"), link_peers=False)
        assert mgr.has_available_instances()
        assert {mgr.get_next_instance_pair().prefill_name
                for _ in range(8)} == {"a", "b"}
        with mgr._cluster_lock:
            mgr._set_state(mgr._instances["a"],
                           U.types.InstanceRuntimeState.SUSPECT)
        assert {mgr.get_next_instance_pair().prefill_name
                for _ in range(8)} == {"b"}
        meta_b = mgr.get_instance_meta("b")
        meta_b.draining = True
        mgr._handle_instance_put(meta_b)
        assert not mgr.has_available_instances()
        assert not mgr.get_next_instance_pair().valid()
    finally:
        mgr.stop()


def test_bind_fails_for_instance_evicted_after_select(U):
    mgr = _mgr(U)
    try:
        mgr.register_instance(U.meta("a"), link_peers=False)
        routing = mgr.get_next_instance_pair()
        assert routing.prefill_name == "a"
        mgr.deregister_instance("a", reason="drill")
        req = U.request.Request(service_request_id="s", request_id="r",
                                model="m")
        req.routing = routing
        assert not mgr.bind_request_instance_incarnations(req)
    finally:
        mgr.stop()


def test_wire_negotiation_and_demotion(U):
    mgr = _mgr(U)
    W = U.wire
    try:
        mgr.register_instance(
            U.meta("m", wire_formats=[W.WIRE_MSGPACK, W.WIRE_JSON]),
            link_peers=False)
        mgr.register_instance(U.meta("legacy"), link_peers=False)
        assert mgr.dispatch_wire("m") == W.WIRE_MSGPACK
        assert mgr.dispatch_wire("legacy") == W.WIRE_JSON
        assert mgr.get_channel("m").wire_format == W.WIRE_MSGPACK
        mgr.demote_wire("m")
        assert mgr.dispatch_wire("m") == W.WIRE_JSON
        mgr.demote_wire("m")
        assert mgr.dispatch_wire("m") == W.WIRE_JSON
    finally:
        mgr.stop()


def test_channel_read_is_snapshot_backed(U):
    mgr = _mgr(U)
    try:
        mgr.register_instance(U.meta("a"), link_peers=False)
        assert mgr.get_channel("a") is FakeChannel.registry["a"]
        mgr.deregister_instance("a", reason="drill")
        assert mgr.get_channel("a") is None
    finally:
        mgr.stop()


# =================================================== TestSchedulingRaces
def _race_scheduler(U):
    sched = U.Scheduler(U.Options(reconcile_interval_s=3600,
                                  sync_interval_s=3600, lease_ttl_s=3600),
                        coord=U.Coord(U.store), start_threads=False)
    sched.instance_mgr._channel_factory = FakeChannel.factory
    return sched


def test_evictions_and_replacements_race_schedule(U):
    """Writers replace instances while readers schedule: no OK schedule
    binds to a (name, incarnation) that was dead before the call began.
    A pair counts as dead once its deregistration has RETURNED: from
    then on the published snapshot no longer holds it, so a schedule
    that starts later must not bind it. (Recording it before the
    deregistration returns, as the reference drill does, flags schedules
    that legitimately saw the pair still live.)"""
    sched = _race_scheduler(U)
    mgr = sched.instance_mgr
    names = [f"i{k}" for k in range(4)]
    for n in names:
        mgr.register_instance(U.meta(n), link_peers=False)
    dead_lock = threading.Lock()
    dead: set = set()
    stop = threading.Event()
    errors: list = []
    stats = {"ok": 0, "replaced": 0}

    def churner(my_names):
        while not stop.is_set():
            for n in my_names:
                meta = mgr.get_instance_meta(n)
                if meta is None:
                    continue
                mgr.deregister_instance(n, reason="replaced")
                with dead_lock:
                    dead.add((n, meta.incarnation_id))
                    stats["replaced"] += 1
                mgr.register_instance(
                    U.meta(n, incarnation_id=uuid.uuid4().hex[:8]),
                    link_peers=False)

    def reader():
        while not stop.is_set():
            with dead_lock:
                dead_before = set(dead)
            req = U.request.Request(service_request_id=uuid.uuid4().hex[:8],
                                    request_id="r", model="m", prompt="hi")
            if not sched.schedule(req).ok():
                continue
            pair = (req.routing.prefill_name, req.prefill_incarnation)
            with dead_lock:
                stats["ok"] += 1
            if not req.prefill_incarnation:
                errors.append(f"unbound OK schedule: {pair}")
            elif pair in dead_before:
                errors.append(f"routed to stale incarnation: {pair}")

    threads = [threading.Thread(target=churner, args=(names[:2],)),
               threading.Thread(target=churner, args=(names[2:],))] + \
              [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        # Run until both sides have done real work (bounded).
        assert wait_until(lambda: stats["ok"] >= 200
                          and stats["replaced"] >= 100, timeout=10)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sched.stop()
    assert not errors, errors[:5]


def test_role_flips_race_schedule(U):
    sched = _race_scheduler(U)
    mgr = sched.instance_mgr
    T = U.types.InstanceType
    for k in range(2):
        mgr.register_instance(U.meta(f"p{k}", "PREFILL"), link_peers=False)
        mgr.register_instance(U.meta(f"d{k}", "DECODE"), link_peers=False)
    stop = threading.Event()
    errors: list = []
    stats = {"ok": 0, "flips": 0}

    def flipper():
        flip = True
        while not stop.is_set():
            mgr.flip_instance_role("p1", T.DECODE if flip else T.PREFILL)
            mgr.flip_instance_role("d1", T.PREFILL if flip else T.DECODE)
            stats["flips"] += 1
            flip = not flip

    def reader():
        while not stop.is_set():
            req = U.request.Request(service_request_id=uuid.uuid4().hex[:8],
                                    request_id="r", model="m", prompt="hi")
            status = sched.schedule(req)
            if not status.ok():
                errors.append(status.message)
            elif not req.prefill_incarnation:
                errors.append("unbound OK schedule")
            else:
                stats["ok"] += 1

    threads = [threading.Thread(target=flipper)] + \
              [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        assert wait_until(lambda: stats["ok"] >= 200
                          and stats["flips"] >= 50, timeout=10)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sched.stop()
    assert not errors, errors[:5]


# ================================================ TestSnapshotChaosDrill
SNAP_REPLY = "Snapshots never route to the dead."


def drill_streams_survive_churn(P):
    P.FAULTS.configure((), seed=7)
    opts = dict(OPTS, detect_disconnected_instance_interval_s=0.5)
    opts.pop("rpc_backoff_base_s")
    opts.pop("rpc_backoff_max_s")
    fl = Fleet(P, opts=opts, engines=[dict(reply_text=SNAP_REPLY,
                                           delay_s=0.03)] * 3)
    m = fl.masters[0]
    engines = fl.engines
    stop = threading.Event()
    T = P.types.InstanceType

    def churner():
        flip = True
        while not stop.is_set():
            m.scheduler.instance_mgr.flip_instance_role(
                engines[0].name, T.PREFILL if flip else T.MIX)
            engines[1].pause()
            stop.wait(0.15)
            engines[1].resume()
            flip = not flip
            stop.wait(0.1)

    results, errors = [], []

    def run_stream():
        try:
            r = requests.post(base(m) + "/v1/completions", json={
                "model": "fake-model", "prompt": "chaos", "stream": True,
                "max_tokens": 1000}, stream=True, timeout=60)
            assert r.status_code == 200, r.text
            text = ""
            for line in r.iter_lines():
                if not line.startswith(b"data: ") or line == b"data: [DONE]":
                    continue
                obj = json.loads(line[6:])
                if "error" in obj:
                    raise RuntimeError(str(obj["error"]))
                for c in obj.get("choices", ()):
                    text += c.get("text", "")
            results.append(text)
        except Exception as e:  # noqa: BLE001 — collected
            errors.append(e)

    churn = threading.Thread(target=churner)
    churn.start()
    try:
        streams = [threading.Thread(target=run_stream) for _ in range(6)]
        for t in streams:
            t.start()
            time.sleep(0.05)
        for t in streams:
            t.join(timeout=60)
    finally:
        stop.set()
        churn.join(timeout=10)
        P.FAULTS.clear()
        fl.close()
    assert not errors, errors
    assert len(results) == 6
    assert all(t == SNAP_REPLY for t in results), results
    return sorted(results)


def test_streams_survive_fleet_churn():
    assert both(drill_streams_survive_churn) == [SNAP_REPLY] * 6

