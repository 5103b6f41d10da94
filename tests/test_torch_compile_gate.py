"""The port's CUDA compile gate (``benchmarks/compile_gate.py``): its arms
cover the six kernels and the two routes of ``csrc/split_routes.cu``; a
failed build or launch is a named verdict in the one JSON line, never a
crash; without a card nothing is built and the line says ``"backend":
"cpu"``. One card-only case builds and launches an arm."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from xllm_service_tpu_torch.benchmarks import compile_gate
from xllm_service_tpu_torch.ops import _build

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ROOT = Path(__file__).resolve().parents[1]


def test_arms_cover_every_library_and_kernel():
    assert set(compile_gate.ARMS.values()) == set(_build.KERNELS) | {
        "split_routes"}
    assert list(compile_gate.ARMS) == [
        "paged_default", "paged_hd256_softcap_window", "split_route_mma",
        "split_route_fma", "mq_verify_k4", "mq_prefill_s128",
        "fused_writeback", "page_gather", "page_scatter",
        "cp_partial_stats"]


def test_cpu_run_reports_cpu_and_builds_nothing(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the gate built on the CPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "build", no_build)
    out = compile_gate.run_gate()
    assert out["backend"] == "cpu" and out["arms"] == {}
    assert out["arm_names"] == list(compile_gate.ARMS)
    assert "failed_arms" not in out


def test_cpu_entry_point_prints_one_line_and_exits_1():
    env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-m", "xllm_service_tpu_torch.benchmarks."
         "compile_gate"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    lines = out.stdout.splitlines()
    assert out.returncode == 1 and len(lines) == 1, (out.stdout, out.stderr)
    assert json.loads(lines[0])["backend"] == "cpu"


def test_failures_are_verdicts(monkeypatch):
    """A library nvcc rejects fails its arms; a launch that raises fails
    its own arm; the rest stay ok and nothing raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def build(names, verbose=False):
        if list(names) == ["page_dma"]:
            raise RuntimeError("nvcc failed for page_dma (exit 2):\nerror")
        return {}

    def boom():
        raise RuntimeError("launch failed (700)")

    thunks = {name: (lambda: None) for name in compile_gate.ARMS}
    thunks["mq_verify_k4"] = boom
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(compile_gate, "_arm_thunks", lambda: thunks)
    out = compile_gate.run_gate()
    assert out["backend"] == "cuda"
    assert out["failed_arms"] == ["mq_verify_k4", "page_gather",
                                  "page_scatter"]
    assert "launch failed (700)" in out["arms"]["mq_verify_k4"]["error"]
    assert "nvcc failed" in out["arms"]["page_gather"]["error"]
    assert all(out["arms"][n]["ok"] for n in compile_gate.ARMS
               if n not in out["failed_arms"])
    assert all("build_s" in v for v in out["arms"].values())
    assert out["error"] == "3 arm(s) failed to build or launch"


def test_arm_setup_failure_is_a_verdict(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda names, verbose=False: {})

    def broken():
        raise ImportError("no module named kernels")

    monkeypatch.setattr(compile_gate, "_arm_thunks", broken)
    out = compile_gate.run_gate()
    assert out["failed_arms"] == list(compile_gate.ARMS)
    assert out["error"].startswith("arm setup failed: ImportError")


@pytest.mark.cuda
def test_gate_builds_and_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the gate builds and "
                    "launches the kernels)")
    out = compile_gate.run_gate()
    assert out["backend"] == "cuda" and out["failed_arms"] == [], out
    assert all(v["ok"] for v in out["arms"].values())
