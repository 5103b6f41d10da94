"""The port's ``overload_bench`` and ``outage_bench`` twins against the
reference's, on the CPU: the shed leg (a 4x burst on a per-instance
admission limit of 1) and the degraded leg (the coordination server
SIGKILLed mid-load and restarted empty on the same port). Each twin runs
as ``python -m`` at a small size, then the reference bench at the same
size: both meet the reference's gate, count the same requests and
status codes (never times) and write the same report keys, and the twin
leaves no process behind.
"""

import json

import torch

from test_torch_service_benches import both, shape
from xllm_service_tpu_torch.benchmarks import outage_bench, overload_bench

torch.set_num_threads(1)   # six xdist workers share the CPU's cores


OVERLOAD = ["--steady-s", "1", "--burst-s", "3", "--skip-noshed",
            "--skip-autoscale", "--skip-overhead"]


def test_overload_twin_shed_leg_against_reference(tmp_path):
    t_out, r_out = both("overload_bench", OVERLOAD, OVERLOAD, tmp_path)
    got, want = json.loads(t_out), json.loads(r_out)
    skip = ("timeline",)
    assert shape(got, skip) == shape(want, skip)
    assert got["config"] == want["config"]
    burst_slots = int(got["config"]["burst_rps"] * 3)
    for rep in (got, want):
        shed = rep["shed"]
        assert overload_bench.gate(rep) == []
        assert shed["errors"] == 0
        assert shed["burst_shed_count"] > 0 and \
            shed["burst_admitted_count"] > 0
        assert shed["burst_shed_count"] + shed["burst_admitted_count"] \
            == burst_slots
    assert set(got["shed"]["timeline"][0]) == \
        set(want["shed"]["timeline"][0])


OUTAGE = ["--steady-s", "2", "--outage-s", "4", "--recovery-s", "2",
          "--skip-control"]


def test_outage_twin_degraded_leg_against_reference(tmp_path):
    t_out, r_out = both("outage_bench", OUTAGE, OUTAGE, tmp_path)
    got, want = json.loads(t_out), json.loads(r_out)
    skip = ("timeline",)
    assert shape(got, skip) == shape(want, skip)
    assert got["config"] == want["config"]
    for rep in (got, want):
        deg = rep["degraded"]
        assert outage_bench.gate(rep) == []
        for phase, secs in (("steady", 2), ("outage", 4),
                            ("recovery", 2)):
            st = deg[phase]
            assert st["completed"] + st["errors"] == 8 * secs, phase
        assert deg["fleet_final"] == outage_bench.N_ENGINES
        assert deg["state_at_outage_end"] == "DEGRADED"
        assert deg["reconnect_accepts"] >= 1
    assert set(got["degraded"]["timeline"][0]) == \
        set(want["degraded"]["timeline"][0])
