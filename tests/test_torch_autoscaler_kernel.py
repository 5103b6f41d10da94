"""The autoscaler's pure decision kernel of the port against the JAX
package's, on the CPU: every case of ``tests/test_autoscaler.py``'s
``TestDecisionKernel`` runs as a sequence of ticks through both packages'
``decide``, and Hypothesis draws further sequences. Each tick's actions
(``to_dict``), next state and reasons must be equal, and the port's must
satisfy the reference test's own assertions."""

import dataclasses

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu import autoscaler as ref
from xllm_service_tpu.common.config import ServiceOptions as RefOptions
from xllm_service_tpu_torch import autoscaler as port
from xllm_service_tpu_torch.common.config import ServiceOptions

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

CFG = dict(min_instances=1, max_instances=4, breach_ticks=2, idle_ticks=3,
           scale_out_step=0.5, scale_out_cooldown_s=10.0,
           scale_in_cooldown_s=10.0, flip_cooldown_s=5.0, stale_hold_s=15.0)


def tick(now_s=1000.0, live=2, max_load_age_s=1.0, **kw):
    return dict(now_s=now_s, live=live, max_load_age_s=max_load_age_s, **kw)


# (state, [inputs, ...] ticks; the state carries from tick to tick unless
# a tick names its own with "state"), config overrides. One case per test
# of TestDecisionKernel.
CASES = {
    "quiet_fleet_no_action": (
        dict(desired=2), [tick(worst_fast_burn=0.5, pressure=0.5)], {}),
    "breach_below_hysteresis_waits": (
        dict(desired=2), [tick(breaching=("ttft",), worst_fast_burn=30.0)],
        {}),
    "breach_at_hysteresis_scales_out": (
        dict(desired=2, breach_streak=1),
        [tick(breaching=("ttft",), worst_fast_burn=30.0)], {}),
    "pressure_alone_triggers_breach": (
        dict(desired=2, breach_streak=1), [tick(pressure=2.0)], {}),
    "kv_pressure_alone_triggers_breach": (
        dict(desired=2, breach_streak=1), [tick(kv_pressure=0.95)], {}),
    "max_instances_clamp": (
        dict(desired=4, breach_streak=5),
        [tick(live=4, breaching=("ttft",))], {}),
    "scale_out_step_clamped_to_max": (
        dict(desired=3), [tick(live=3, breaching=("ttft",))],
        dict(max_instances=4, breach_ticks=1, scale_out_step=5.0,
             defaults=True)),
    "scale_out_cooldown": (
        dict(desired=2, breach_streak=5, last_scale_out_s=995.0),
        [tick(breaching=("ttft",)),
         dict(tick(breaching=("ttft",)),
              state=dict(desired=2, breach_streak=5,
                         last_scale_out_s=985.0))], {}),
    "idle_hysteresis_and_scale_in": (
        dict(desired=3),
        [tick(now_s=1000.0 + t, live=3, scale_in_candidate="e3")
         for t in range(2)]
        + [tick(now_s=1010.0, live=3, scale_in_candidate="e3")], {}),
    "min_instances_clamp": (
        dict(desired=1, idle_streak=99),
        [tick(live=1, scale_in_candidate="e1")], {}),
    "scale_in_needs_candidate": (
        dict(desired=3, idle_streak=99),
        [tick(live=3, scale_in_candidate="")], {}),
    "scale_in_waits_for_inflight_drain": (
        dict(desired=3, idle_streak=99),
        [tick(live=2, draining=1, scale_in_candidate="e2")], {}),
    "stale_telemetry_holds_and_freezes_streaks": (
        dict(desired=2, breach_streak=1),
        [dict(tick(breaching=("ttft",), max_load_age_s=age),
              state=dict(desired=2, breach_streak=1))
         for age in (-1.0, 16.0)], {}),
    "replacement_bypasses_cooldown_and_hysteresis": (
        dict(desired=3, last_scale_out_s=999.0), [tick(live=1)], {}),
    "replacement_honors_spawn_retry_backoff": (
        dict(desired=3, retry_at_s=1005.0, retry_count=2),
        [tick(live=1),
         dict(tick(now_s=1006.0, live=1),
              state=dict(desired=3, retry_at_s=1005.0, retry_count=2))],
        {}),
    "external_join_raises_desired": (dict(desired=2), [tick(live=4)], {}),
    "flip_proposal_enacted_with_cooldown": (
        dict(desired=2),
        [tick(flip_proposals=(("p2", "DECODE"),)),
         tick(now_s=1002.0, flip_proposals=(("p1", "DECODE"),))], {}),
    "replacement_never_exceeds_max_instances": (
        dict(desired=2), [tick(live=10), tick(live=5), tick(live=3)], {}),
    "suspect_instance_is_not_lost_capacity": (
        dict(desired=3), [tick(live=2, suspect=1), tick(live=2, suspect=0)],
        {}),
    "one_scale_action_per_tick": (
        dict(desired=3, breach_streak=9),
        [tick(live=2, breaching=("ttft",))], {}),
}


def run_ticks(pkg, state, ticks, cfg_kw):
    """Each tick's (actions as dicts, next state as a dict, reasons).
    ``cfg_kw`` overrides CFG, or with ``defaults`` the config's defaults."""
    cfg_kw = dict(cfg_kw)
    base = {} if cfg_kw.pop("defaults", False) else CFG
    cfg = pkg.AutoscalerConfig(**{**base, **cfg_kw})
    st_ = pkg.KernelState(**state)
    out = []
    for t in ticks:
        t = dict(t)
        if "state" in t:
            st_ = pkg.KernelState(**t.pop("state"))
        actions, st_, reasons = pkg.decide(pkg.KernelInputs(**t), st_, cfg)
        out.append(([a.to_dict() for a in actions],
                    dataclasses.asdict(st_), reasons))
    return out


# What each reference test asserts, on the port's outcome.
def _kinds(step):
    return [a["kind"] for a in step[0]]


EXPECT = {
    "quiet_fleet_no_action": lambda o: o[0][0] == [] and o[0][1]["desired"]
    == 2 and o[0][1]["breach_streak"] == 0,
    "breach_below_hysteresis_waits": lambda o: o[0][0] == []
    and o[0][1]["breach_streak"] == 1,
    "breach_at_hysteresis_scales_out": lambda o: _kinds(o[0]) == ["scale_out"]
    and o[0][0][0]["count"] == 1 and o[0][1]["desired"] == 3
    and o[0][1]["last_scale_out_s"] == 1000.0,
    "pressure_alone_triggers_breach": lambda o: _kinds(o[0]) == ["scale_out"],
    "kv_pressure_alone_triggers_breach": lambda o: _kinds(o[0])
    == ["scale_out"],
    "max_instances_clamp": lambda o: o[0][0] == [] and o[0][1]["desired"] == 4
    and any("max_instances" in r for r in o[0][2]),
    "scale_out_step_clamped_to_max": lambda o: o[0][0][0]["count"] == 1
    and o[0][1]["desired"] == 4,
    "scale_out_cooldown": lambda o: o[0][0] == []
    and any("cooldown" in r for r in o[0][2])
    and _kinds(o[1]) == ["scale_out"],
    "idle_hysteresis_and_scale_in": lambda o: o[0][0] == o[1][0] == []
    and [(a["kind"], a["instance"]) for a in o[2][0]] == [("scale_in", "e3")]
    and o[2][1]["desired"] == 2 and o[2][1]["idle_streak"] == 0,
    "min_instances_clamp": lambda o: o[0][0] == [] and o[0][1]["desired"] == 1
    and any("min_instances" in r for r in o[0][2]),
    "scale_in_needs_candidate": lambda o: o[0][0] == []
    and any("role availability" in r for r in o[0][2]),
    "scale_in_waits_for_inflight_drain": lambda o: o[0][0] == []
    and any("drain is already in progress" in r for r in o[0][2]),
    "stale_telemetry_holds_and_freezes_streaks": lambda o: all(
        _kinds(s) == ["hold"] and s[1]["breach_streak"] == 1
        and s[1]["desired"] == 2 and any("HOLD" in r for r in s[2])
        for s in o),
    "replacement_bypasses_cooldown_and_hysteresis": lambda o: [
        (a["kind"], a["count"]) for a in o[0][0]] == [("scale_out", 2)]
    and "replacing lost capacity" in o[0][0][0]["reason"],
    "replacement_honors_spawn_retry_backoff": lambda o: o[0][0] == []
    and any("backed off" in r for r in o[0][2])
    and _kinds(o[1]) == ["scale_out"],
    "external_join_raises_desired": lambda o: o[0][1]["desired"] == 4
    and any("observed fleet" in r for r in o[0][2]),
    "flip_proposal_enacted_with_cooldown": lambda o: [
        (a["kind"], a["instance"], a["target_type"]) for a in o[0][0]]
    == [("flip", "p2", "DECODE")] and o[1][0] == []
    and any("deferred" in r for r in o[1][2]),
    "replacement_never_exceeds_max_instances": lambda o: o[0][1]["desired"]
    == 4 and o[1][0] == [] and [(a["kind"], a["count"]) for a in o[2][0]]
    == [("scale_out", 1)],
    "suspect_instance_is_not_lost_capacity": lambda o: o[0][0] == []
    and o[0][1]["desired"] == 3 and [(a["kind"], a["count"])
                                     for a in o[1][0]] == [("scale_out", 1)],
    "one_scale_action_per_tick": lambda o: len(
        [a for a in o[0][0] if a["kind"] in ("scale_out", "scale_in")]) == 1
    and "replacing lost capacity" in o[0][0][0]["reason"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decision_kernel_case_matches_reference(case):
    state, ticks, cfg_kw = CASES[case]
    got = run_ticks(port, state, ticks, cfg_kw)
    assert got == run_ticks(ref, state, ticks, cfg_kw)
    assert EXPECT[case](got), got


def test_min_above_max_misconfig_normalized():
    kw = dict(autoscaler_min_instances=9, autoscaler_max_instances=4)
    got = port.AutoscalerConfig.from_options(ServiceOptions(**kw))
    want = ref.AutoscalerConfig.from_options(RefOptions(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.max_instances >= got.min_instances


_names = st.sampled_from(["e1", "e2", "e3", ""])
_inputs = st.fixed_dictionaries({
    "dt": st.floats(0.0, 30.0),
    "breaching": st.sampled_from([(), ("ttft",), ("ttft", "tpot")]),
    "worst_fast_burn": st.floats(0.0, 50.0),
    "worst_slow_burn": st.floats(0.0, 50.0),
    "pressure": st.floats(0.0, 3.0),
    "kv_pressure": st.floats(0.0, 1.0),
    "live": st.integers(0, 9),
    "draining": st.integers(0, 2),
    "suspect": st.integers(0, 2),
    "pending_launches": st.integers(0, 2),
    "shed_rate": st.sampled_from([0.0, 0.0, 2.5]),
    "max_load_age_s": st.sampled_from([-1.0, 0.5, 3.0, 20.0]),
    "scale_in_candidate": _names,
    "flip_proposals": st.sampled_from(
        [(), (("p1", "DECODE"),), (("p1", "DECODE"), ("p2", "PREFILL"))]),
})


@settings(max_examples=60, deadline=None)
@given(ticks=st.lists(_inputs, min_size=1, max_size=12),
       cfg=st.fixed_dictionaries({
           "min_instances": st.integers(1, 3),
           "max_instances": st.integers(1, 6),
           "breach_ticks": st.integers(1, 3),
           "idle_ticks": st.integers(1, 4),
           "scale_out_step": st.sampled_from([0.0, 0.5, 1.0, 5.0]),
           "scale_out_cooldown_s": st.sampled_from([0.0, 5.0, 20.0]),
           "scale_in_cooldown_s": st.sampled_from([0.0, 5.0, 45.0]),
           "flip_cooldown_s": st.sampled_from([0.0, 10.0]),
           "stale_hold_s": st.sampled_from([1.0, 15.0])}),
       retry=st.sampled_from([(0.0, 0), (1010.0, 1), (2000.0, 3)]))
def test_drawn_tick_sequences_match_reference(ticks, cfg, retry):
    now, seq = 1000.0, []
    for t in ticks:
        t = dict(t)
        now += t.pop("dt")
        seq.append(dict(t, now_s=now))
    state = dict(desired=0, retry_at_s=retry[0], retry_count=retry[1])
    assert run_ticks(port, state, seq, cfg) == run_ticks(ref, state, seq, cfg)
