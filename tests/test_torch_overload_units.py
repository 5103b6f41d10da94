"""The overload and outage planes' pure units of the port against the JAX
package's, on the CPU.

Every case of ``tests/test_overload.py``'s ``TestDeadlineParsing``,
``TestAdmissionKernel``, ``TestCircuitBreakerStateTable``,
``TestRetryBudget``, ``TestBrownoutController`` and
``TestAutoscalerShedCoupling``, of ``tests/test_multimaster.py``'s
``TestCoordinationHealthUnit`` and of ``tests/test_chaos_failover.py``'s
``TestFaultPlaneDeterminism`` runs once through each package's functions
on the same inputs (parametrised by package) with the reference test's
own assertions. Hypothesis then draws sequences for the breaker's state
table, the admission kernel and gate, the retry budget and the held
action log, and both packages must answer each step alike.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

PACKAGES = ("ref", "port")


class Pkg:
    """The pure modules of one package ("ref" or "port")."""

    def __init__(self, which):
        if which == "ref":
            from xllm_service_tpu import autoscaler, overload
            from xllm_service_tpu.common import faults
            from xllm_service_tpu.common.flightrecorder import RECORDER
            from xllm_service_tpu.coordination import health
            from xllm_service_tpu.devtools import lifecycle
            from xllm_service_tpu.overload import admission
            from xllm_service_tpu.overload.retry_budget import RetryBudget
            from xllm_service_tpu.rpc import breaker
        else:
            from xllm_service_tpu_torch import autoscaler, overload
            from xllm_service_tpu_torch.common import faults
            from xllm_service_tpu_torch.common.flightrecorder import RECORDER
            from xllm_service_tpu_torch.coordination import health
            from xllm_service_tpu_torch.devtools import lifecycle
            from xllm_service_tpu_torch.overload import admission
            from xllm_service_tpu_torch.overload.retry_budget import (
                RetryBudget,
            )
            from xllm_service_tpu_torch.rpc import breaker
        self.which = which
        self.overload, self.admission, self.breaker = overload, admission, \
            breaker
        self.autoscaler, self.faults, self.health = autoscaler, faults, health
        self.RECORDER, self.lifecycle, self.RetryBudget = RECORDER, \
            lifecycle, RetryBudget
        self.ADMISSION = overload.ADMISSION
        self.BROWNOUT = overload.BROWNOUT
        self.RETRY_BUDGET = overload.RETRY_BUDGET


PKGS = {w: Pkg(w) for w in PACKAGES}


def _clean(P):
    P.faults.FAULTS.configure((), seed=0)
    P.ADMISSION.configure(per_instance_limit=0)
    P.ADMISSION.reset()
    P.BROWNOUT.configure(enabled=True)
    P.BROWNOUT.reset()
    P.RETRY_BUDGET.configure(ratio=0.1, cap=50.0)


@pytest.fixture(params=PACKAGES)
def P(request):
    """One package's units, its overload singletons clean before and
    after (they are process-global, as the reference's fixture says)."""
    P = PKGS[request.param]
    _clean(P)
    yield P
    P.faults.FAULTS.clear()
    _clean(P)
    P.faults.FAULTS.clear()


# ------------------------------------------------------ TestDeadlineParsing
def test_deadline_header_wins_over_body_over_default(P):
    parse = P.overload.parse_deadline_ms
    now = 1_000_000
    assert parse({"timeout": 2.0}, {"x-request-deadline-ms": "500"},
                 default_ms=9000, now=now) == now + 500
    assert parse({"timeout": 2.0}, {}, default_ms=9000, now=now) \
        == now + 2000
    assert parse({}, {}, default_ms=9000, now=now) == now + 9000
    assert parse({}, {}, default_ms=0, now=now) == 0


def test_deadline_malformed_values_fall_through(P):
    parse = P.overload.parse_deadline_ms
    now = 1_000_000
    assert parse({"timeout": "nope"}, {"x-request-deadline-ms": "bogus"},
                 default_ms=100, now=now) == now + 100
    assert parse({"timeout": -5}, {}, 0, now=now) == 0
    assert parse({"timeout": True}, {}, 0, now=now) == 0


def test_priority_parse(P):
    parse = P.overload.parse_priority
    assert parse({}, {}) == "interactive"
    assert parse({}, {"x-request-priority": "batch"}) == "batch"
    assert parse({"priority_class": "batch"}, {}) == "batch"
    assert parse({"priority_class": "BATCH"}, {}) == "batch"
    assert parse({"priority_class": "weird"}, {}) == "interactive"
    assert parse({"offline": True}, {}) == "batch"
    assert parse({"offline": True, "priority_class": "interactive"}, {}) \
        == "interactive"


# ------------------------------------------------------ TestAdmissionKernel
def _decide(P, **kw):
    return P.admission.decide_admission(P.admission.AdmissionInputs(**kw))


def test_admission_disabled_admits_everything(P):
    ok, _ = _decide(P, pending=10**6, live=0, per_instance_limit=0)
    assert ok


def test_admission_limit_scales_with_live_fleet(P):
    base = dict(per_instance_limit=4, priority="interactive")
    assert _decide(P, pending=7, live=2, **base)[0]
    ok, reason = _decide(P, pending=8, live=2, **base)
    assert not ok and "queue full" in reason
    assert _decide(P, pending=8, live=3, **base)[0]


def test_admission_batch_watermark_and_burn_hot(P):
    base = dict(per_instance_limit=10, live=1, batch_watermark=0.5)
    assert _decide(P, pending=4, priority="batch", **base)[0]
    ok, reason = _decide(P, pending=5, priority="batch", **base)
    assert not ok and "batch" in reason
    assert _decide(P, pending=9, priority="interactive", **base)[0]
    ok, reason = _decide(P, pending=0, priority="batch", burn_hot=True,
                         **base)
    assert not ok and "burn" in reason
    assert _decide(P, pending=0, priority="interactive", burn_hot=True,
                   **base)[0]


def test_admission_controller_pending_and_shed_rate(P):
    A = P.ADMISSION
    A.configure(per_instance_limit=1, batch_watermark=0.5, retry_after_s=2.0)
    ok, _, _ = A.try_admit("interactive", live=1, burn_hot=False)
    assert ok and A.pending() == 1
    ok, reason, retry_after = A.try_admit("interactive", live=1,
                                          burn_hot=False)
    assert not ok and retry_after == 2.0
    assert A.shed_rate() > 0
    A.release()
    assert A.pending() == 0
    with P.lifecycle.escape("drill: clamping of over-release is the "
                            "behavior under test"):
        A.release()
    assert A.pending() == 0
    rep = A.report()
    assert rep["admitted_total"] == 1
    assert rep["shed_total"] == {"interactive": 1}


# --------------------------------------------- TestCircuitBreakerStateTable
def _breaker(P, **kw):
    base = dict(name="t", window_s=5.0, min_samples=4, failure_ratio=0.5,
                open_cooldown_s=10.0)
    base.update(kw)
    return P.breaker.CircuitBreaker(**base)


def test_breaker_closed_until_min_samples_and_ratio(P):
    b = _breaker(P)
    for _ in range(3):
        b.record(False, now=0.0)
    assert b.state() == "closed"
    b = _breaker(P)
    b.record(False, now=0.0)
    for _ in range(3):
        b.record(True, now=0.0)
    assert b.state() == "closed"
    b.record(False, now=0.0)
    b.record(False, now=0.0)
    assert b.state() == "open"
    assert not b.allow(now=1.0)


def test_breaker_half_open_single_probe_then_close(P):
    b = _breaker(P, open_cooldown_s=1.0)
    for _ in range(4):
        b.record(False, now=0.0)
    assert b.state() == "open"
    assert not b.allow(now=0.5)
    assert b.allow(now=1.5)
    assert b.state() == "half_open"
    assert not b.allow(now=1.6)
    b.record(True, now=1.7)
    assert b.state() == "closed"
    b.record(False, now=1.8)
    assert b.state() == "closed"


def test_breaker_half_open_failure_reopens(P):
    b = _breaker(P, open_cooldown_s=1.0)
    for _ in range(4):
        b.record(False, now=0.0)
    assert b.allow(now=1.5)
    b.record(False, now=1.6)
    assert b.state() == "open"
    assert not b.allow(now=2.0)
    assert b.allow(now=2.7)


def test_breaker_stale_window_expires(P):
    b = _breaker(P, window_s=1.0)
    for _ in range(3):
        b.record(False, now=0.0)
    b.record(False, now=2.0)
    assert b.state() == "closed"


def test_breaker_disabled_is_transparent(P):
    b = _breaker(P, enabled=False)
    for _ in range(20):
        b.record(False, now=0.0)
    assert b.allow(now=0.0) and b.state() == "closed"


# --------------------------------------------------------- TestRetryBudget
def test_retry_budget_deposit_spend_deny(P):
    R = P.RETRY_BUDGET
    R.configure(ratio=0.5, cap=2.0)
    assert R.try_spend()
    assert R.try_spend()
    assert not R.try_spend()
    for _ in range(2):
        R.note_request()
    assert R.try_spend()
    assert not R.try_spend()
    rep = R.report()
    assert rep["spent_total"] == 3 and rep["denied_total"] == 2


def test_retry_budget_cap_bounds_deposits(P):
    R = P.RETRY_BUDGET
    R.configure(ratio=10.0, cap=3.0)
    for _ in range(100):
        R.note_request()
    assert R.tokens() == 3.0


def test_retry_budget_disabled(P):
    R = P.RETRY_BUDGET
    R.configure(ratio=0.1, cap=0.0)
    for _ in range(100):
        assert R.try_spend()


# -------------------------------------------------- TestBrownoutController
HOT = {"breaching": ["ttft"], "worst_fast_burn_rate": 50.0}
COOL = {"breaching": [], "worst_fast_burn_rate": 0.2}


def test_brownout_enter_clamp_exit_hysteresis(P):
    B = P.BROWNOUT
    B.configure(enabled=True, batch_max_tokens=8, recover_ticks=2,
                trace_sample_rate=0.0, restore_rate_fn=lambda: 1.0)
    assert not B.active()
    assert B.tick(report=HOT)
    assert B.active()
    assert B.clamp_max_tokens("batch", 1000) == 8
    assert B.clamp_max_tokens("interactive", 1000) == 1000
    assert B.clamp_max_tokens("batch", 4) == 4
    assert B.tick(report=COOL)
    assert B.tick(report=HOT)
    assert B.tick(report=COOL)
    assert not B.tick(report=COOL)
    assert not B.active()
    assert B.clamp_max_tokens("batch", 1000) == 1000
    rep = B.report()
    assert [t["kind"] for t in rep["transitions"]] == ["enter", "exit"]
    assert rep["entered_total"] == 1
    recs = P.RECORDER.recent(kind="brownout")
    assert len(recs) >= 2
    assert any("breaching" in r["detail"]["reason"]
               for r in recs if r["detail"]["kind"] == "enter")


def test_brownout_disabled_never_enters(P):
    B = P.BROWNOUT
    B.configure(enabled=False)
    assert not B.tick(report=HOT)
    assert not B.active()


# --------------------------------------------- TestAutoscalerShedCoupling
def _shed_cfg(P):
    return P.autoscaler.AutoscalerConfig(min_instances=1, max_instances=4,
                                         breach_ticks=2, idle_ticks=3)


def test_shed_rate_drives_scale_out(P):
    A = P.autoscaler
    st_ = A.KernelState(desired=2)
    inp = A.KernelInputs(now_s=1000.0, live=2, max_load_age_s=1.0,
                         shed_rate=2.5)
    actions, st_, reasons = A.decide(inp, st_, _shed_cfg(P))
    assert not actions
    assert any("shedding" in r for r in reasons)
    inp2 = A.KernelInputs(now_s=1003.0, live=2, max_load_age_s=1.0,
                          shed_rate=2.5)
    actions, st_, _ = A.decide(inp2, st_, _shed_cfg(P))
    assert [a.kind for a in actions] == ["scale_out"]
    assert "unserved demand" in actions[0].reason


def test_zero_shed_rate_is_not_breach(P):
    A = P.autoscaler
    st_ = A.KernelState(desired=2)
    for t in (1000.0, 1003.0, 1006.0):
        inp = A.KernelInputs(now_s=t, live=2, max_load_age_s=1.0,
                             shed_rate=0.0)
        actions, st_, _ = A.decide(inp, st_, _shed_cfg(P))
        assert not any(a.kind == "scale_out" for a in actions)


# ------------------------------------------------ TestCoordinationHealthUnit
def test_entity_jitter_deterministic_and_bounded(P):
    jitter = P.health.entity_jitter
    a = jitter("127.0.0.1:8001", 5.0)
    b = jitter("127.0.0.1:8002", 5.0)
    assert a == jitter("127.0.0.1:8001", 5.0)
    assert 0.0 <= a < 5.0 and 0.0 <= b < 5.0
    assert a != b
    assert jitter("127.0.0.1:8001", 0.0) == 0.0


def test_entity_jitter_equals_the_reference():
    """The slot an identity draws must be the reference's: a mixed fleet
    spreads its recoveries over the same window."""
    for i in range(50):
        entity = f"10.0.{i}.7:{9000 + i}"
        for window in (0.2, 5.0, 30.0):
            assert PKGS["port"].health.entity_jitter(entity, window) == \
                PKGS["ref"].health.entity_jitter(entity, window)


def test_held_log_coalesces_and_bounds(P):
    log = P.health.HeldActionLog(capacity=3)
    log.hold("evict", "engine-a", reason="r1")
    log.hold("evict", "engine-a", reason="ignored", extra=1)
    assert log.depth() == 1
    only = log.report()["actions"][0]
    assert only["count"] == 2 and only["reason"] == "r1"
    assert only["detail"] == {"extra": 1}
    for i in range(4):
        log.hold("flip", f"engine-{i}")
    rep = log.report()
    assert rep["depth"] == 3 and rep["dropped"] == 2
    drained = log.drain()
    assert len(drained) == 3 and log.depth() == 0
    assert log.report()["actions"] == []


# ------------------------------------------------ TestFaultPlaneDeterminism
def test_fault_same_seed_same_schedule(P):
    def draw(seed):
        plane = P.faults.FaultPlane(seed=seed)
        plane.configure([dict(point="rpc.post", action="error",
                              probability=0.5)])
        return [plane.fire("rpc.post") is not None for _ in range(64)]

    assert draw(1234) == draw(1234)
    assert draw(1234) != draw(4321)


def test_fault_schedule_equals_the_reference():
    """One seed draws the same schedule in both packages."""
    def draw(P, seed):
        plane = P.faults.FaultPlane(seed=seed)
        plane.configure([dict(point="rpc.*", action="error",
                              probability=0.3, after=2)])
        return [plane.fire("rpc.post") is not None for _ in range(64)]
    for seed in (0, 7, 1234):
        assert draw(PKGS["port"], seed) == draw(PKGS["ref"], seed)


def test_fault_after_and_max_fires_counting(P):
    plane = P.faults.FaultPlane(seed=0)
    rule = plane.add("engine.token", action="crash", after=2, max_fires=1)
    fires = [plane.fire("engine.token") is not None for _ in range(5)]
    assert fires == [False, False, True, False, False]
    assert rule.hits == 5 and rule.fires == 1


def test_fault_match_and_glob(P):
    plane = P.faults.FaultPlane(seed=0)
    plane.add("rpc.*", action="error", match={"instance": "a:1"})
    assert plane.fire("rpc.post", instance="b:2") is None
    assert plane.fire("rpc.get", instance="a:1") is not None


def test_fault_check_raises_and_delays(P):
    plane = P.faults.FaultPlane(seed=0)
    plane.add("kv_transfer.offer", action="error", max_fires=1)
    with pytest.raises(P.faults.FaultInjected):
        plane.check("kv_transfer.offer")
    plane.check("kv_transfer.offer")


# ------------------------------------------------------------ Hypothesis
# A breaker step: (advance the clock by dt, then record ok / record a
# failure / ask allow()).
STEP = st.tuples(st.floats(min_value=0.0, max_value=1.5, allow_nan=False),
                 st.sampled_from(["ok", "fail", "allow"]))


def _breaker_trace(P, cfg, steps):
    b = P.breaker.CircuitBreaker(name="h", **cfg)
    now, out = 0.0, []
    for dt, op in steps:
        now += dt
        if op == "allow":
            out.append(("allow", b.allow(now=now), b.state()))
        else:
            b.record(op == "ok", now=now)
            out.append((op, b.state()))
    snap = b.snapshot()
    out.append(sorted((k, v) for k, v in snap.items()
                      if not isinstance(v, float)))
    return out


@settings(max_examples=80, deadline=None)
@given(cfg=st.fixed_dictionaries(dict(
    window_s=st.sampled_from([0.5, 1.0, 5.0]),
    min_samples=st.integers(1, 6),
    failure_ratio=st.sampled_from([0.25, 0.5, 1.0]),
    open_cooldown_s=st.sampled_from([0.0, 0.3, 1.0]),
    enabled=st.booleans())),
    steps=st.lists(STEP, min_size=1, max_size=40))
def test_breaker_state_table_sequences(cfg, steps):
    assert _breaker_trace(PKGS["port"], cfg, steps) == \
        _breaker_trace(PKGS["ref"], cfg, steps)


@settings(max_examples=200, deadline=None)
@given(pending=st.integers(0, 50), live=st.integers(0, 6),
       limit=st.integers(0, 8),
       watermark=st.sampled_from([0.0, 0.25, 0.5, 1.0]),
       burn_hot=st.booleans(),
       priority=st.sampled_from(["interactive", "batch"]))
def test_admission_kernel_drawn(pending, live, limit, watermark, burn_hot,
                                priority):
    kw = dict(pending=pending, live=live, per_instance_limit=limit,
              batch_watermark=watermark, burn_hot=burn_hot,
              priority=priority)
    assert _decide(PKGS["port"], **kw) == _decide(PKGS["ref"], **kw)


GATE_OP = st.one_of(
    st.tuples(st.just("admit"), st.sampled_from(["interactive", "batch"]),
              st.integers(0, 3), st.booleans()),
    st.tuples(st.just("release")))


def _gate_trace(P, limit, watermark, ops):
    _clean(P)
    A = P.ADMISSION
    A.configure(per_instance_limit=limit, batch_watermark=watermark,
                retry_after_s=1.5)
    out = []
    try:
        with P.lifecycle.escape("drawn sequences may over-release; the "
                                "clamp is part of what is compared"):
            for op in ops:
                if op[0] == "admit":
                    out.append(A.try_admit(op[1], live=op[2],
                                           burn_hot=op[3]))
                else:
                    A.release()
                out.append(A.pending())
        rep = A.report()
        out.append((rep["enabled"], rep["admitted_total"],
                    rep["shed_total"], rep["pending"]))
    finally:
        _clean(P)
    return out


@settings(max_examples=60, deadline=None)
@given(limit=st.integers(0, 3), watermark=st.sampled_from([0.0, 0.5, 1.0]),
       ops=st.lists(GATE_OP, min_size=1, max_size=30))
def test_admission_gate_sequences(limit, watermark, ops):
    assert _gate_trace(PKGS["port"], limit, watermark, ops) == \
        _gate_trace(PKGS["ref"], limit, watermark, ops)


def _budget_trace(P, ratio, cap, ops):
    b = P.RetryBudget()
    b.configure(ratio=ratio, cap=cap)
    out = [b.try_spend() if op else b.note_request() for op in ops]
    out.append(b.tokens())
    rep = b.report()
    out.append((rep["spent_total"], rep["denied_total"]))
    return out


@settings(max_examples=60, deadline=None)
@given(ratio=st.sampled_from([0.0, 0.1, 0.5, 2.0]),
       cap=st.sampled_from([0.0, 1.0, 3.0, 50.0]),
       ops=st.lists(st.booleans(), max_size=40))
def test_retry_budget_sequences(ratio, cap, ops):
    assert _budget_trace(PKGS["port"], ratio, cap, ops) == \
        _budget_trace(PKGS["ref"], ratio, cap, ops)


HOLD = st.tuples(st.sampled_from(["evict", "flip", "kvframe_publish"]),
                 st.sampled_from(["a", "b", "c", "d"]),
                 st.sampled_from(["", "r1", "r2"]), st.booleans())


def _held_trace(P, capacity, holds):
    log = P.health.HeldActionLog(capacity=capacity)
    for kind, key, reason, extra in holds:
        if extra:
            log.hold(kind, key, reason=reason, n=len(key))
        else:
            log.hold(kind, key, reason=reason)
    rep = log.report()
    actions = [{k: v for k, v in a.items() if not k.endswith("_ms")
                and not k.endswith("_s")} for a in rep["actions"]]
    drained = [(a.kind, a.key, a.count) for a in log.drain()]
    return rep["depth"], rep["dropped"], actions, drained, log.depth()


@settings(max_examples=60, deadline=None)
@given(capacity=st.integers(1, 4), holds=st.lists(HOLD, max_size=20))
def test_held_log_sequences(capacity, holds):
    assert _held_trace(PKGS["port"], capacity, holds) == \
        _held_trace(PKGS["ref"], capacity, holds)
