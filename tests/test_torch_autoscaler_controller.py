"""The autoscaler's controller and actuators of the port against the JAX
package's, on the CPU: the scenarios of ``tests/test_autoscaler.py``'s
``TestController``, ``TestWriteLease``, ``TestHintActuator``,
``TestRebuiltSloPolicy`` and ``TestPlannerThroughController`` run once on
each package's instance manager (fake channels) with a recording actuator,
and their outcomes (decision records without times, actuator calls, drain
and flip effects, published hint records) must be equal; the reference
test's assertions are then held on the port's outcome.

``LocalProcessActuator`` is tested on the port's fake engine: spawn and
reap, a failed spawn reports 0, the runaway cap, a child that dies after
launch drops out of ``pending`` (later ticks see the missing capacity),
and the default command runs ``python -m
xllm_service_tpu_torch.testing.fake_engine``, which registers with a
coordination server and leaves on ``reap``.
"""

import importlib
import json
import os
import re
import shlex
import sys
import time
from pathlib import Path

import pytest
import torch

from fakes import FakeChannel, make_meta, wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

PKGS = {"ref": "xllm_service_tpu", "port": "xllm_service_tpu_torch"}
ROOT = Path(__file__).resolve().parents[1]


def mod(P, name):
    return importlib.import_module(f"{PKGS[P]}.{name}")


@pytest.fixture(autouse=True)
def _reset_channels():
    FakeChannel.reset()
    yield
    FakeChannel.reset()


def opts(P, **kw):
    base = dict(autoscaler_enabled=True, autoscaler_breach_ticks=2,
                autoscaler_idle_ticks=2, autoscaler_min_instances=1,
                autoscaler_max_instances=4,
                autoscaler_scale_out_cooldown_s=0.2,
                autoscaler_scale_in_cooldown_s=0.2,
                autoscaler_flip_cooldown_s=0.1,
                autoscaler_stale_hold_s=30.0,
                autoscaler_drain_grace_s=0.05,
                autoscaler_spawn_retry_base_s=0.05,
                autoscaler_spawn_retry_max_s=0.2)
    base.update(kw)
    return mod(P, "common.config").ServiceOptions(**base)


class Env:
    """One package's store, coordination client and the pieces a scenario
    builds from; ``close()`` stops what was started."""

    def __init__(self, P):
        self.P = P
        self.T = mod(P, "common.types")
        memory = mod(P, "coordination.memory")
        self.store = memory.MemoryStore(expiry_tick_s=0.02)
        self.coord = memory.InMemoryCoordination(self.store)
        self.mgrs = []

    def meta(self, name, itype="MIX", **kw):
        ref = make_meta(name, **kw)
        meta = self.T.InstanceMetaInfo.from_json(ref.to_json())
        meta.type = self.T.InstanceType.parse(itype)
        return meta

    def mgr(self, fleet=(("e1", "MIX"), ("e2", "MIX")), **okw):
        im = mod(self.P, "scheduler.instance_mgr")
        m = im.InstanceMgr(self.coord, opts(self.P, **okw),
                           start_threads=False,
                           channel_factory=FakeChannel.factory)
        for name, itype, *kw in fleet:
            m.register_instance(self.meta(name, itype, **(kw[0] if kw
                                                          else {})),
                                link_peers=False)
        self.mgrs.append(m)
        return m

    def beat(self, m, name, **load):
        lat = load.pop("latency", None)
        m.record_instance_heartbeat(
            name, m.get_instance_meta(name).incarnation_id,
            self.T.LoadMetrics(**load),
            self.T.LatencyMetrics(**lat) if lat else self.T.LatencyMetrics())

    def beat_all(self, m):
        for meta in m.list_instances():
            self.beat(m, meta.name)

    def monitor(self, bad_samples=0):
        mon = mod(self.P, "common.slo").SloMonitor()
        mon.configure(ttft_ms=100.0, tpot_ms=50.0, budget=0.01,
                      fast_s=60.0, slow_s=120.0, alert=14.4)
        for _ in range(bad_samples):
            mon.record_ttft(500.0)    # every sample over target: burn 100x
        return mon

    def controller(self, m, actuator=None, monitor=None, is_master=None,
                   **okw):
        A = mod(self.P, "autoscaler")
        return A.AutoscalerController(
            opts(self.P, **okw), m,
            actuator if actuator is not None else recording(self.P),
            is_master_fn=is_master or (lambda: True),
            slo_monitor=monitor or self.monitor())

    def close(self):
        for m in self.mgrs:
            m.stop()
        self.store.close()


def recording(P, scale_out_result=None):
    base = mod(P, "autoscaler.actuator").FleetActuator

    class RecordingActuator(base):
        name = "recording"

        def __init__(self):
            self.scale_outs, self.scale_ins, self.reaps = [], [], []
            self.result = scale_out_result   # None = echo count

        def scale_out(self, count, reason, slice_id=""):
            self.scale_outs.append((count, reason, slice_id))
            return count if self.result is None else self.result

        def scale_in(self, instance, reason):
            self.scale_ins.append(instance)
            return True

        def reap(self, instance):
            self.reaps.append(instance)

    return RecordingActuator()


_SECONDS = re.compile(r"\d+\.\d+s")


def norm(rec):
    """A decision record without its clock: no timestamps or ages, and the
    seconds inside reasons (cooldowns left) as ``Xs``."""
    if rec is None:
        return None
    inputs = {k: v for k, v in rec["inputs"].items() if k != "max_load_age_s"}
    return {"tick": rec["tick"], "inputs": inputs, "actions": rec["actions"],
            "enacted": rec["enacted"],
            "reasons": [_SECONDS.sub("Xs", r) for r in rec["reasons"]]}


def both(scenario):
    """The scenario on the JAX package, then on the port: equal outcomes."""
    outs = {}
    for P in ("ref", "port"):
        FakeChannel.reset()
        env = Env(P)
        try:
            outs[P] = scenario(env)
        finally:
            env.close()
    assert outs["port"] == outs["ref"], (outs["port"], outs["ref"])
    return outs["port"]


# ------------------------------------------------------------ controller
def sc_disabled(env):
    m = env.mgr()
    ctl = env.controller(m, autoscaler_enabled=False)
    return ctl.tick(), ctl.report()["ticks"]


def test_disabled_controller_never_ticks():
    assert both(sc_disabled) == (None, 0)


def sc_burn_breach(env):
    m = env.mgr()
    env.beat_all(m)
    act = recording(env.P)
    ctl = env.controller(m, actuator=act, monitor=env.monitor(30))
    recs = [norm(ctl.tick()), norm(ctl.tick())]
    return recs, act.scale_outs


def test_burn_breach_drives_scale_out():
    recs, scale_outs = both(sc_burn_breach)
    assert recs[0]["actions"] == []
    assert [a["kind"] for a in recs[1]["actions"]] == ["scale_out"]
    assert scale_outs and scale_outs[0][0] == 1
    assert recs[1]["inputs"]["breaching"] == ["ttft"]


def sc_stale(env):
    m = env.mgr()                          # no heartbeats: age -1
    act = recording(env.P)
    ctl = env.controller(m, actuator=act, monitor=env.monitor(30))
    return norm(ctl.tick()), act.scale_outs


def test_stale_telemetry_holds():
    rec, scale_outs = both(sc_stale)
    assert [a["kind"] for a in rec["actions"]] == ["hold"]
    assert scale_outs == []


def sc_idle_scale_in(env):
    m = env.mgr(fleet=[(f"e{i}", "MIX") for i in (1, 2, 3)])
    env.beat_all(m)
    env.beat(m, "e1", waiting_requests_num=5, running_requests_num=3)
    act = recording(env.P)
    ctl = env.controller(m, actuator=act)
    recs = [norm(ctl.tick()), norm(ctl.tick())]
    victim = [a for r in recs for a in r["actions"]][0]["instance"]
    m.reconcile_once()
    return (recs, act.scale_ins, m.get_instance_state(victim).name,
            victim in m.routing_snapshot().schedulable,
            FakeChannel.registry[victim].drains)


def test_idle_fleet_scale_in_drains_least_loaded():
    recs, scale_ins, state, schedulable, drains = both(sc_idle_scale_in)
    acted = [a for r in recs for a in r["actions"]]
    assert [a["kind"] for a in acted] == ["scale_in"]
    assert acted[0]["instance"] in ("e2", "e3") and scale_ins
    assert state == "DRAINING" and not schedulable and drains == 1


def sc_role_availability(env):
    m = env.mgr(fleet=[("p1", "PREFILL"), ("d1", "DECODE")])
    env.beat_all(m)
    act = recording(env.P)
    ctl = env.controller(m, actuator=act)
    recs = [norm(ctl.tick()) for _ in range(4)]
    return recs, act.scale_ins


def test_scale_in_never_breaks_role_availability():
    recs, scale_ins = both(sc_role_availability)
    assert scale_ins == []
    assert any("role availability" in r for r in recs[-1]["reasons"])


def sc_spawn_failure(env):
    m = env.mgr(fleet=[("e1", "MIX")])
    env.beat_all(m)
    act = recording(env.P, scale_out_result=0)    # every launch fails
    ctl = env.controller(m, actuator=act, monitor=env.monitor(30))
    first = [norm(ctl.tick()), norm(ctl.tick())]
    retry = ctl.report()["state"]["retry_count"]
    n_calls = len(act.scale_outs)
    backed = norm(ctl.tick())
    calls_in_backoff = len(act.scale_outs) - n_calls
    act.result = None                     # the actuator heals
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and len(act.scale_outs) == n_calls:
        ctl.tick()
        time.sleep(0.05)
    return (first, retry, backed["reasons"], calls_in_backoff,
            len(act.scale_outs) > n_calls,
            ctl.report()["state"]["retry_count"])


def test_spawn_failure_backs_off_and_recovers():
    first, retry, reasons, in_backoff, relaunched, retry_after = \
        both(sc_spawn_failure)
    assert first[1]["enacted"][0]["launched"] == 0 and retry == 1
    assert in_backoff == 0
    assert any("backed off" in r or "backoff" in r for r in reasons)
    assert relaunched and retry_after == 0


def sc_killed_replaced(env):
    m = env.mgr(fleet=[(f"e{i}", "MIX") for i in (1, 2, 3)])
    env.beat_all(m)
    act = recording(env.P)
    ctl = env.controller(m, actuator=act)
    ctl.tick()
    desired = ctl.report()["state"]["desired"]
    m.deregister_instance("e2", reason="test kill")
    env.beat_all(m)
    return desired, norm(ctl.tick()), act.scale_outs


def test_killed_capacity_gets_replaced():
    desired, rec, scale_outs = both(sc_killed_replaced)
    assert desired == 3
    assert [(a["kind"], a["count"]) for a in rec["actions"]] == \
        [("scale_out", 1)]
    assert "replacing lost capacity" in rec["actions"][0]["reason"]
    assert [c[0] for c in scale_outs] == [1]


PD3 = [("p1", "PREFILL"), ("p2", "PREFILL"), ("d1", "DECODE")]


def sc_flip_through_controller(env):
    m = env.mgr(fleet=PD3)
    env.beat_all(m)
    ctl = env.controller(m)
    ctl.propose_flip("p2", env.T.InstanceType.DECODE)
    rec = norm(ctl.tick())
    m.reconcile_once()
    return rec, m.get_instance_meta("p2").type.value, \
        FakeChannel.registry["p2"].flips


def test_flip_proposals_route_through_controller():
    rec, new_type, flips = both(sc_flip_through_controller)
    assert [a["kind"] for a in rec["actions"]] == ["flip"]
    assert new_type == "DECODE" and flips == ["DECODE"]


def sc_deferred_flip(env):
    m = env.mgr(fleet=PD3[:2] + [("p3", "PREFILL"), ("d1", "DECODE")])
    env.beat_all(m)
    ctl = env.controller(m, autoscaler_flip_cooldown_s=0.3,
                         autoscaler_idle_ticks=99)
    ctl.propose_flip("p2", env.T.InstanceType.DECODE)
    recs = [norm(ctl.tick())]
    ctl.propose_flip("p3", env.T.InstanceType.DECODE)
    recs.append(norm(ctl.tick()))         # inside the flip cooldown
    time.sleep(0.35)
    recs.append(norm(ctl.tick()))         # cooldown over: p3 still queued
    return recs


def test_deferred_flip_proposal_survives_cooldown():
    recs = both(sc_deferred_flip)
    assert [a["kind"] for a in recs[0]["actions"]] == ["flip"]
    assert recs[1]["actions"] == []
    assert any("deferred" in r for r in recs[1]["reasons"])
    assert [(a["kind"], a["instance"]) for a in recs[2]["actions"]] == \
        [("flip", "p3")]


def sc_drain_after_demotion(env):
    m = env.mgr()
    m.request_drain("e2")
    m._is_master = False                  # demotion lands before reconcile
    m.reconcile_once()
    out = [(m.get_instance_state("e2").name,
            FakeChannel.registry["e2"].drains)]
    m._is_master = True                   # re-elected: a fresh request
    m.request_drain("e2")
    m.reconcile_once()
    out.append((m.get_instance_state("e2").name,
                FakeChannel.registry["e2"].drains))
    return out


def test_drains_dropped_after_demotion():
    assert both(sc_drain_after_demotion) == [("ACTIVE", 0), ("DRAINING", 1)]


def sc_decision_log(env):
    m = env.mgr(fleet=[("e1", "MIX")])
    env.beat_all(m)
    ctl = env.controller(m, autoscaler_decision_log_capacity=8)
    for _ in range(20):
        ctl.tick()
    rep = ctl.report()
    return (len(rep["decisions"]), rep["ticks"],
            rep["last_decision_age_s"] >= 0.0,
            [norm(d) for d in rep["decisions"]],
            {k: rep[k] for k in ("enabled", "master", "actuator", "state",
                                 "retiring", "slice_census", "lost_slices",
                                 "config")})


def test_decision_log_is_bounded_and_reasoned():
    n, ticks, aged, _, _ = both(sc_decision_log)
    assert n <= 8 and ticks == 20 and aged


# ----------------------------------------------------------- write lease
def sc_non_master(env):
    m = env.mgr()
    env.beat_all(m)
    act = recording(env.P)
    ctl = env.controller(m, actuator=act, monitor=env.monitor(30),
                         is_master=lambda: False)
    ticks = [ctl.tick() for _ in range(3)]
    return (ticks, act.scale_outs, act.scale_ins, ctl.report()["ticks"],
            ctl.report()["decisions"])


def test_non_master_controller_acts_on_nothing():
    assert both(sc_non_master) == ([None] * 3, [], [], 0, [])


def sc_demoted_straggler(env):
    m = env.mgr()
    env.beat_all(m)
    mastership = {"is_master": True}
    act = recording(env.P)
    ctl = env.controller(m, actuator=act, monitor=env.monitor(30),
                         is_master=lambda: mastership["is_master"])
    ctl.tick()
    ctl.tick()
    calls, ticks = len(act.scale_outs), ctl.report()["ticks"]
    mastership["is_master"] = False
    straggler = [ctl.tick() for _ in range(3)]
    return (calls, straggler, len(act.scale_outs) - calls,
            ctl.report()["ticks"] - ticks)


def test_demoted_master_straggler_tick_acts_on_nothing():
    calls, straggler, more, more_ticks = both(sc_demoted_straggler)
    assert calls >= 1 and straggler == [None] * 3
    assert more == 0 and more_ticks == 0


def sc_scheduler_demotion(env):
    sched = mod(env.P, "scheduler.scheduler")
    rpc = mod(env.P, "rpc")
    memory = mod(env.P, "coordination.memory")
    o = opts(env.P, lease_ttl_s=1.0)
    s1 = sched.Scheduler(o, coord=memory.InMemoryCoordination(env.store),
                         start_threads=False)
    s2 = sched.Scheduler(o.with_overrides(rpc_port=8890),
                         coord=memory.InMemoryCoordination(env.store),
                         start_threads=False)
    try:
        out = [(s1.is_master, s2.is_master)]
        s1.sync_once()
        s2.sync_once()
        out.append((s1.autoscaler.report()["ticks"],
                    s2.autoscaler.report()["ticks"]))
        s1._coord.set(rpc.MASTER_KEY, s2.self_addr)
        s2.is_master = True
        s1.sync_once()
        out.append((s1.is_master, s1.autoscaler.report()["ticks"]))
        s2.sync_once()
        out.append(s2.autoscaler.report()["ticks"])
        return out
    finally:
        s1.stop()
        s2.stop()


def test_scheduler_demotion_gates_controller():
    assert both(sc_scheduler_demotion) == [(True, False), (1, 0), (False, 1),
                                           1]


# ---------------------------------------------------------- hint actuator
def hint_records(env):
    act = mod(env.P, "autoscaler.actuator")
    stream = env.coord.get_prefix(act.AUTOSCALER_ACTION_KEY_PREFIX)
    strip = lambda d: {k: v for k, v in d.items() if k != "ts_ms"}  # noqa
    return (sorted((k, strip(json.loads(v))) for k, v in stream.items()),
            strip(json.loads(env.coord.get(act.AUTOSCALER_DECISION_KEY))))


def sc_hint_publishes(env):
    act = mod(env.P, "autoscaler").HintActuator(env.coord)
    out = act.scale_out(2, "burn over alert")
    act.scale_in("e2", "idle")
    act.reap("e2")
    return out, hint_records(env)


def test_hint_actuator_publishes_action_records():
    n, (stream, latest) = both(sc_hint_publishes)
    assert n == 2 and len(stream) == 3
    assert latest["action"] == "scale_in" and latest["phase"] == "drained"


def sc_hint_not_respammed(env):
    act = mod(env.P, "autoscaler").HintActuator(env.coord)
    act.scale_out(2, "replacing lost capacity")
    act.scale_out(2, "replacing lost capacity")
    return hint_records(env)


def test_identical_unsatisfied_hint_not_respammed():
    stream, _ = both(sc_hint_not_respammed)
    assert len(stream) == 1


# ------------------------------------------------------- rebuilt SLO policy
TTFT = [[128, 20.0], [512, 60.0], [2048, 200.0]]
TPOT = [[1, 100, 5.0], [4, 1000, 10.0], [16, 8000, 30.0]]


class _PoisonLock:
    def __enter__(self):
        raise AssertionError("manager lock taken on the SLO hot path")

    def __exit__(self, *exc):
        return False

    def acquire(self, *a, **k):
        raise AssertionError("manager lock taken on the SLO hot path")

    def release(self):
        pass


def slo_fleet(env):
    return env.mgr(fleet=[("p1", "PREFILL", dict(ttft_profiling_data=TTFT)),
                          ("d1", "DECODE", dict(tpot_profiling_data=TPOT))])


def sc_slo_lock_free(env):
    m = slo_fleet(env)
    policy = mod(env.P, "scheduler.policies").create_policy(
        "SLO_AWARE", m, None, opts(env.P))
    m._metrics_lock = _PoisonLock()
    Req = mod(env.P, "common.request").Request
    r = policy.select_instances_pair(
        Req(service_request_id="s1", token_ids=list(range(256))))
    return r.prefill_name, r.decode_name


def test_slo_selection_is_lock_free():
    assert both(sc_slo_lock_free) == ("p1", "d1")


def sc_request_loads(env):
    m = slo_fleet(env)
    Req = mod(env.P, "common.request").Request
    req = Req(service_request_id="s1", token_ids=list(range(64)))
    req.routing.prefill_name, req.routing.decode_name = "p1", "d1"
    m.update_request_metrics(req, env.T.RequestAction.SCHEDULE)
    first = m.get_request_loads()["p1"]
    m.update_request_metrics(req, env.T.RequestAction.FINISH_PREFILL,
                             n_new=2)
    view = m.get_request_loads()
    return first, view["p1"], view["d1"]


def test_request_load_view_tracks_accounting():
    assert both(sc_request_loads) == ((1, 64, 0, 0), (0, 0, 0, 0),
                                      (0, 0, 1, 66))


def sc_no_flip_of_stale_prefill(env):
    awful = [[1, 100, 500.0], [4, 1000, 900.0], [16, 8000, 2000.0]]
    o = dict(loadinfo_stale_after_s=0.15, target_tpot_ms=1.0)
    m = env.mgr(fleet=[("p1", "PREFILL"), ("p2", "PREFILL"),
                       ("d1", "DECODE", dict(tpot_profiling_data=awful))],
                **o)
    for n in ("p1", "p2", "d1"):
        env.beat(m, n)
    time.sleep(0.25)
    for n in ("p1", "d1"):                # p2's telemetry goes stale
        env.beat(m, n)
    stale = m.stale_load_names()
    flips = []
    Req = mod(env.P, "common.request").Request
    mod(env.P, "scheduler.policies.slo_aware").select_pair_on_slo(
        m, opts(env.P, **o),
        Req(service_request_id="s1", token_ids=list(range(128))),
        flip_sink=lambda n, t: flips.append((n, t)))
    return stale, flips


def test_no_flip_of_stale_idle_prefill():
    assert both(sc_no_flip_of_stale_prefill) == ({"p2"}, [])


# ------------------------------------------------ planner through the sink
def sc_planner_flip(env):
    m = env.mgr(fleet=PD3)
    env.beat(m, "p1", waiting_requests_num=4, running_requests_num=2)
    env.beat(m, "p2")
    env.beat(m, "d1", running_requests_num=8,
             latency=dict(recent_max_tbt=500.0))
    planner = mod(env.P, "scheduler.planner").Planner(m, opts(env.P))
    proposals = []
    planner.flip_sink = lambda n, t: proposals.append((n, t.value))
    d = planner.plan_once()
    with m._flip_lock:
        pending = dict(m._pending_flips)
    return d.flips_requested, proposals, pending


def test_planner_flip_rides_sink():
    assert both(sc_planner_flip) == ([["p2", "DECODE"]],
                                     [("p2", "DECODE")], {})


def sc_planner_stale(env):
    o = dict(loadinfo_stale_after_s=0.15)
    m = env.mgr(fleet=PD3, **o)
    env.beat(m, "p2")
    time.sleep(0.25)
    env.beat(m, "p1", waiting_requests_num=4, running_requests_num=2)
    env.beat(m, "d1", running_requests_num=8,
             latency=dict(recent_max_tbt=500.0))
    d = mod(env.P, "scheduler.planner").Planner(m, opts(env.P, **o)) \
        .plan_once()
    return d.flips_requested, "p2" in d.stale_load_entries


def test_planner_skips_stale_flip_target():
    assert both(sc_planner_stale) == ([], True)


# ------------------------------------------------ the local process actuator
def local_actuator(cmd="", log_dir=None, **kw):
    from xllm_service_tpu_torch.autoscaler import LocalProcessActuator

    return LocalProcessActuator(
        opts("port", autoscaler_actuator="local", **kw), spawn_cmd=cmd,
        log_dir=log_dir)


SLEEPER = f"{shlex.quote(sys.executable)} -c " \
    f"{shlex.quote('import time; time.sleep(30)')}"


def test_local_actuator_spawn_and_reap(tmp_path):
    act = local_actuator(SLEEPER, log_dir=str(tmp_path))
    try:
        assert act.scale_out(1, "test") == 1
        kids = act.live_children()
        assert len(kids) == 1 and kids[0].startswith("127.0.0.1:")
        assert act.pending(set()) == 1 and act.pending(set(kids)) == 0
        act.reap(kids[0])
        assert act.live_children() == []
    finally:
        act.stop()


def test_local_actuator_failed_spawn_reports_zero(tmp_path):
    act = local_actuator("/nonexistent-binary-xyz --port {port}",
                         log_dir=str(tmp_path))
    try:
        assert act.scale_out(2, "test") == 0
        assert act.spawn_failures_total == 2
    finally:
        act.stop()


def test_local_actuator_dead_child_is_missing_capacity(tmp_path):
    """A child that dies at launch is a failed spawn when the launch's
    check sees it, and otherwise drops out of ``pending`` and the live
    children, so the next ticks count it as missing capacity."""
    cmd = f"{shlex.quote(sys.executable)} -c " \
        f"{shlex.quote('import sys; sys.exit(3)')}"
    act = local_actuator(cmd, log_dir=str(tmp_path))
    try:
        launched = act.scale_out(1, "test")
        assert launched + act.spawn_failures_total == 1
        assert wait_until(lambda: act.pending(set()) == 0
                          and act.live_children() == [], timeout=10)
    finally:
        act.stop()


def test_local_actuator_runaway_cap(tmp_path):
    act = local_actuator(SLEEPER, log_dir=str(tmp_path),
                         autoscaler_max_instances=1)
    try:
        assert act.scale_out(5, "test") == act._max_procs == 2
    finally:
        act.stop()


def test_default_command_runs_the_ports_fake_engine(tmp_path):
    from xllm_service_tpu_torch.autoscaler import create_actuator
    from xllm_service_tpu_torch.common.types import InstanceMetaInfo
    from xllm_service_tpu_torch.coordination.client import (
        TcpCoordinationClient,
    )
    from xllm_service_tpu_torch.coordination.memory import MemoryStore
    from xllm_service_tpu_torch.coordination.server import (
        CoordinationServer,
    )
    from xllm_service_tpu_torch.rpc import instance_key

    srv = CoordinationServer(host="127.0.0.1", port=0,
                             store=MemoryStore(expiry_tick_s=0.02))
    srv.start_background()
    addr = f"127.0.0.1:{srv.port}"
    os.environ["XLLM_AUTOSCALER_LOGDIR"] = str(tmp_path)
    try:
        act = create_actuator(opts("port", autoscaler_actuator="local",
                                   coordination_addr=addr), None)
    finally:
        del os.environ["XLLM_AUTOSCALER_LOGDIR"]
    coord = TcpCoordinationClient(addr)
    try:
        cmd = act._command(4242)
        assert cmd[:3] == [sys.executable, "-m",
                           "xllm_service_tpu_torch.testing.fake_engine"]
        assert cmd[3:] == ["--coordination-addr", addr, "--host",
                           "127.0.0.1", "--port", "4242"]
        assert str(ROOT) in act._env()["PYTHONPATH"].split(os.pathsep)
        assert act.scale_out(1, "test") == 1
        name = act.live_children()[0]
        key = instance_key("MIX", name)
        assert wait_until(lambda: coord.get(key) is not None, timeout=30), \
            (tmp_path / f"autoscaled_{name.split(':')[1]}.log").read_text()
        meta = InstanceMetaInfo.from_json(coord.get(key))
        assert meta.name == name and meta.models == ["fake-model"]
        act.reap(name)
        assert act.live_children() == []
        assert wait_until(lambda: coord.get(key) is None, timeout=10)
    finally:
        act.stop()
        coord.close()
        srv.stop()
