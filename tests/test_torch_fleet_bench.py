"""The port's ``fleet_bench`` twin against the reference's, on the CPU
(``test_torch_service_benches.py`` and ``test_torch_plane_benches.py``
hold the other seven).

``fleet_bench``'s CPU-set planner is given explicit affinity sets (4, 6
and 12 CPUs) rather than this machine's and must choose as the reference
does, down to the ``phased-projection`` fallback; its stream population
must draw the same requests. The twin's native A/B runs as ``python -m``
at a small size, then the reference's at the same size: both serve every
request, count the same requests and errors (never times) and write the
same report keys, and the twin leaves no process behind.
"""

import json
import os

import pytest
import torch

from benchmarks import fleet_bench as ref_fleet
from test_torch_service_benches import both, shape
from xllm_service_tpu_torch.benchmarks import fleet_bench

torch.set_num_threads(1)   # six xdist workers share the CPU's cores


@pytest.mark.parametrize("n_cpus", [4, 6, 12])
@pytest.mark.parametrize("n_masters", [1, 2, 4])
def test_plan_cpu_sets_equal(n_cpus, n_masters, monkeypatch):
    cpus = set(range(3, 3 + 2 * n_cpus, 2))     # sparse, not from 0
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(cpus))
    want = ref_fleet.plan_cpu_sets(n_masters)
    monkeypatch.undo()
    got = fleet_bench.plan_cpu_sets(n_masters, cpus)
    assert got == want
    plan, _ = got
    if n_cpus < n_masters + 2:
        assert plan is None        # the phased-projection choice
    else:
        masters = [plan[f"master{i}"] for i in range(n_masters)]
        assert all(len(s) == 1 for s in masters)
        assert len(set().union(*masters)) == n_masters


def test_stream_population_equal():
    for scale in (1.0, 0.1):
        a = ref_fleet.StreamPopulation(1000, seed=0x21, prompt_scale=scale)
        b = fleet_bench.StreamPopulation(1000, seed=0x21,
                                         prompt_scale=scale)
        assert [a.request_for(k) for k in range(200)] == \
            [b.request_for(k) for k in range(200)]
        assert a.stats() == b.stats()
    assert fleet_bench.TENANTS == ref_fleet.TENANTS


LEG_SKIP = ("cpu_isolation", "windows", "master_cpu_s_during_drive",
            "master_cpu_attr", "native_status_per_master",
            "profile_per_master")


def test_fleet_twin_native_ab_against_reference(tmp_path):
    t_out, r_out = both(
        "fleet_bench", ["--quick", "--prompt-scale", "0.1"],
        ["--requests", str(fleet_bench.QUICK["requests"]),
         "--max-masters", "0", "--prompt-scale", "0.1"], tmp_path)
    got, want = json.loads(t_out), json.loads(r_out)
    assert fleet_bench.gate(got) == [] and fleet_bench.gate(want) == []
    assert shape(got, LEG_SKIP) == shape(want, LEG_SKIP)
    assert set(got["headline"]) == set(want["headline"])
    for g, w in zip(got["legs"], want["legs"]):
        for k in ("masters", "native_on", "purpose", "offered_rps",
                  "served", "errors", "mode"):
            assert g[k] == w[k], k
        assert shape(g["windows"]) == shape(w["windows"])
        assert g["windows"][0]["streams"] == w["windows"][0]["streams"]
    on = [leg for leg in got["legs"] if leg["native_on"]][0]
    off = [leg for leg in got["legs"] if not leg["native_on"]][0]
    assert set(on["native_status_per_master"][0].values()) == {1.0}
    assert set(off["native_status_per_master"][0].values()) == {0.0}
