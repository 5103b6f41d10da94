"""The ``kvtier_bench`` twin (``xllm_service_tpu_torch/benchmarks/
kvtier_bench.py``) at tiny CPU shapes: its four legs run on the port's
engine at the MLA family's pool (``tiny_mla``) and at ``tiny``, and its
report carries the reference's JSON keys (``benchmarks/kvtier_bench.py``):
the stream leg's keys are checked against the reference's own function's
output, the engine legs' against the keys the reference writes. Without a
card and without ``--device cpu`` it raises and prints nothing.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from xllm_service_tpu_torch.benchmarks import kvtier_bench

ROOT = Path(__file__).resolve().parents[1]
MODULE = "xllm_service_tpu_torch.benchmarks.kvtier_bench"
TTFT_KEYS = {"prefix_tokens", "prefix_blocks", "block_nbytes",
             "hot_hbm_ttft_ms", "warm_dram_ttft_ms", "warm_ssd_ttft_ms",
             "cold_recompute_ttft_ms", "warm_vs_cold_speedup",
             "ssd_vs_cold_speedup", "tier_stats"}
CAPACITY_KEYS = {"distinct_prefixes", "prefix_blocks_fed",
                 "hbm_budget_pages", "hbm_only_addressable_blocks",
                 "tiered_addressable_blocks", "tiered_split",
                 "offload_dropped", "capacity_multiplier"}
STEP_KEYS = {"rounds", "baseline_step_p50_ms", "tiered_step_p50_ms",
             "baseline_step_p90_ms", "tiered_step_p90_ms", "delta_p50_perc",
             "offloads_during_tiered_run", "offload_dropped"}


def _keys(node):
    """The nested key structure of a JSON object."""
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    return None


@pytest.fixture(scope="module")
def report():
    return kvtier_bench.run("cpu", "tiny_mla", prefix_tokens=256, rounds=1,
                            prefixes=12, payload_mb=2)


def test_report_has_the_reference_keys(report):
    assert {"round", "box", "bench", "tier_ttft", "capacity",
            "step_latency", "stream"} <= set(report)
    assert report["model"] == "tiny_mla" and report["box"] == "CPU"
    assert set(report["tier_ttft"]) == TTFT_KEYS | {"onload_ms_per_block"}
    assert set(report["capacity"]) == CAPACITY_KEYS
    assert set(report["step_latency"]) == STEP_KEYS
    assert set(report["capacity"]["tiered_split"]) == {"hbm", "dram", "ssd"}


def test_stream_leg_matches_the_reference_shape(report):
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import kvtier_bench as ref_bench
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    assert _keys(report["stream"]) == _keys(ref_bench.bench_stream(2))


def test_tiers_hold_what_the_pool_cannot(report):
    """The MLA pool's blocks (one latent head of 48) move through the
    tiers: the prefix onloads warm and from SSD, every block fed stays
    addressable, and no offload is dropped."""
    ttft, cap = report["tier_ttft"], report["capacity"]
    assert ttft["block_nbytes"] == 2 * 2 * 4 * 1 * 16 * 48 * 4
    assert ttft["tier_stats"]["onload_total"] >= ttft["prefix_blocks"]
    assert ttft["onload_ms_per_block"] > 0
    assert cap["tiered_addressable_blocks"] == cap["prefix_blocks_fed"]
    assert cap["hbm_only_addressable_blocks"] < cap["prefix_blocks_fed"]
    assert cap["offload_dropped"] == 0
    assert report["step_latency"]["offloads_during_tiered_run"] > 0


def test_command_line_on_the_cpu_and_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", MODULE, "--device", "cpu", "--quick",
         "--legs", "capacity"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout)
    assert rec["model"] == "tiny" and "capacity" in rec
    assert "tier_ttft" not in rec and "stream" not in rec
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = [{MODULE!r}, '--legs', 'stream']\n"
            f"runpy.run_module({MODULE!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "device='cpu'" in out.stderr
