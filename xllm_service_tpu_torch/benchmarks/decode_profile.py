"""Decode-step component profile of the port on one NVIDIA GPU (twin of the
repository's ``benchmarks/decode_profile.py``): where a decode token-step's
time goes.

    python -m xllm_service_tpu_torch.benchmarks.decode_profile
    python -m xllm_service_tpu_torch.benchmarks.decode_profile --device cpu

At the bench twin's shapes (``xllm_service_tpu_torch/bench.py``: B 16, ctx
512, ``XLLM_BENCH_MODEL`` 1b or 8b, bf16) on an engine holding B admitted
prompts, it times the reference's components, each as wall time per call
over ``iters`` calls with one sync at the end:

- ``full_step_ms``: the engine's decode step (forward, sampling, the
  penalty histogram, the device-side stop and budget update, the row
  pack), its ops called one by one; ``full_step_graphed_ms``: the same
  step function as the engine's captured graph, replayed (card only);
- ``forward_only_ms``: ``decode_forward`` alone;
- ``attention_only_ms`` / ``attention_per_layer_ms``: kernel 1 over one
  layer's pool, scaled by the layers (kernel 3 under
  ``XLLM_KV_WRITEBACK=fused``);
- ``sampling_only_ms``: ``sample_tokens`` on random logits, greedy;
- derived ``matmul_and_rest_ms`` (forward - attention) and
  ``sample_overhead_ms`` (full step - forward);
- ``dispatch_fetch_rtt_ms`` (a one-element op and its fetch) and
  ``upload_32kb_ms`` (an admission-sized pageable upload);
- ``ideal_weight_stream_ms``: ``decode_weight_stream_bytes()`` over
  3.35 TB/s.

A ``torch.profiler`` trace of one decode horizon of the step, eager and
graphed, gives the CUDA kernels run per step, the device's busy share (the
union of the device intervals over the horizon's wall time), the host's
ms per step and per layer (the time the host takes to enqueue the horizon,
over steps and layers) and the kernels that take the most device time.
``engine_loop`` splits one horizon of the engine's own loop (untraced)
into the host's dispatch, its wait for the device and its emission.

Prints ONE JSON line. Without a card and without ``--device cpu`` it
raises; a CPU run checks only that the twin works.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..bench import HBM_BYTES_PER_S, BenchShape, admit_batch, bench_shape
from ..common.device import card_line, resolve_device
from ..engine import InferenceEngine
from ..engine.sampling import SamplingState, sample_tokens
from ..ops.attention import kv_writeback_mode
from ..ops.fused_decode_attention import fused_decode_attention
from ..ops.paged_attention import paged_attention


# Kernel names of the matrix products (cuBLAS and its CUTLASS kernels).
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_fn(fn: Callable[[], object], dev: torch.device,
             iters: int) -> float:
    """Wall ms per call of ``fn`` over ``iters`` calls after one warm-up
    call, with one sync at the end (the reference's ``bench_fn``)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e3


def trace_horizon(step: Callable[[], None], dev: torch.device, steps: int,
                  layers: int) -> dict:
    """One horizon of ``steps`` calls of ``step`` under ``torch.profiler``:
    kernels per step, the device's busy share, the host's enqueue time per
    step and per layer, the matrix products' share of the device time and
    the kernels that take the most device time (per step: launches, ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        t_host = time.perf_counter() - t0
        _sync(dev)
        t_wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    kernels = sum(not n.startswith(("Memcpy", "Memset")) for *_, n in spans)
    busy, end = 0.0, float("-inf")
    by_name: dict[str, list[float]] = {}
    for s, e, name in spans:              # union of the device intervals
        if e > end:
            busy += e - max(s, end)
            end = e
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e - s
    total = sum(t for _, t in by_name.values()) or 1.0
    gemm = sum(t for n, (_, t) in by_name.items()
               if any(w in n.lower() for w in GEMM_NAMES))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "kernels_per_step": kernels / steps if spans else None,
        "busy_share": busy / (t_wall * 1e6) if spans else None,
        "device_busy_ms_per_step": busy / 1e3 / steps if spans else None,
        "host_ms_per_step": t_host * 1e3 / steps,
        "host_ms_per_layer": t_host * 1e3 / (steps * layers),
        "wall_ms_per_step": t_wall * 1e3 / steps,
        "gemm_share_of_device_time": gemm / total if spans else None,
        "top_kernels": [{"name": n[:90], "per_step": c / steps,
                         "ms_per_step": t / 1e3 / steps}
                        for n, (c, t) in top],
    }


def engine_loop_host(engine: InferenceEngine, horizon: int) -> dict:
    """The engine loop's host time for one horizon, per step, apart from
    its wait for the device: the dispatch (the steps, on a card graph
    replays, the rows' copies and the fetch's enqueue) and the emission
    of the fetched rows (detokenization and callbacks)."""
    dev = engine.device
    snapshot = dict(engine._running)
    _sync(dev)
    t0 = time.perf_counter()
    rows, ready = engine._decode_multi(horizon, snapshot)
    t1 = time.perf_counter()
    if ready is not None:
        ready.synchronize()
    t2 = time.perf_counter()
    engine._drain_one_decode((rows, None, t0, horizon, snapshot))
    t3 = time.perf_counter()
    return {"dispatch_host_ms_per_step": (t1 - t0) * 1e3 / horizon,
            "device_wait_ms_per_step": (t2 - t1) * 1e3 / horizon,
            "emit_host_ms_per_step": (t3 - t2) * 1e3 / horizon}


def run(device: Optional[Union[str, torch.device]] = None,
        params: Optional[dict] = None, iters: Optional[int] = None,
        trace_steps: Optional[int] = None) -> dict:
    """One profile; returns the JSON record. ``params`` replaces the random
    weights drawn from seed 0; ``iters`` and ``trace_steps`` override the
    calls per component (30 on the card) and the traced horizon (the
    shape's ``decode_horizon``)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    shape: BenchShape = bench_shape(dev)
    iters = iters or (30 if on_card else 3)
    trace_steps = trace_steps or shape.horizon
    mcfg, B = shape.mcfg, shape.batch
    L = mcfg.num_layers
    engine = InferenceEngine(shape.engine_config(), device=dev,
                             params=params)
    admit_batch(engine, shape, lambda out: None)
    fam = engine.family
    result = {"metric": "decode_step_component_ms", "unit": "ms",
              "backend": dev.type, "model": shape.model_key, "B": B,
              "ctx": shape.ctx, "kv_writeback": kv_writeback_mode() or
              "default"}

    def forward():
        return fam.decode_forward(engine.params, mcfg, engine._last,
                                  engine._clens - 1, engine.kv_pages,
                                  engine._pt, engine._clens)[0]

    def eager():
        engine._decode_step(False, False)

    def graphed():
        engine._graphs.run(False, False)

    result["forward_only_ms"] = bench_fn(forward, dev, iters)
    result["full_step_ms"] = bench_fn(eager, dev, iters)
    result["full_step_graphed_ms"] = (bench_fn(graphed, dev, iters)
                                      if on_card else None)

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, mcfg.num_heads, mcfg.head_dim), generator=g,
                    device=dev).to(mcfg.dtype)
    kv0 = engine.kv_pages[0]
    if kv_writeback_mode() == "fused":
        k_new = torch.randn((B, mcfg.num_kv_heads, mcfg.head_dim),
                            generator=g, device=dev).to(mcfg.dtype)

        def attn():
            return fused_decode_attention(q, k_new, k_new, kv0[0], kv0[1],
                                          engine._pt, engine._clens)
    else:
        def attn():
            return paged_attention(q, kv0[0], kv0[1], engine._pt,
                                   engine._clens)
    per_layer = bench_fn(attn, dev, iters)
    result["attention_only_ms"] = per_layer * L
    result["attention_per_layer_ms"] = per_layer

    logits = torch.randn((B, mcfg.vocab_size), generator=g, device=dev)
    greedy = SamplingState.init(B, mcfg.vocab_size, dev)
    greedy.temperature.zero_()
    result["sampling_only_ms"] = bench_fn(
        lambda: sample_tokens(logits, greedy, [None] * B), dev, iters)

    tiny = torch.zeros((8,), dtype=torch.float32, device=dev)
    result["dispatch_fetch_rtt_ms"] = bench_fn(lambda: (tiny + 1).cpu(),
                                               dev, iters)
    up = np.zeros((8192,), np.int32)      # about an admission's upload
    result["upload_32kb_ms"] = bench_fn(
        lambda: torch.from_numpy(up).to(dev), dev, iters)

    result["matmul_and_rest_ms"] = (result["forward_only_ms"]
                                    - result["attention_only_ms"])
    result["sample_overhead_ms"] = (result["full_step_ms"]
                                    - result["forward_only_ms"])
    result["value"] = result["full_step_ms"]
    result["trace_steps"] = trace_steps
    result["trace"] = trace_horizon(eager, dev, trace_steps, L)
    result["trace_graphed"] = (trace_horizon(graphed, dev, trace_steps, L)
                               if on_card else None)
    result["engine_loop"] = engine_loop_host(engine, shape.horizon)
    wbytes = mcfg.decode_weight_stream_bytes()
    result["weight_stream_mb"] = wbytes / 1e6
    if on_card:
        result["ideal_weight_stream_ms"] = wbytes / HBM_BYTES_PER_S * 1e3
        result["device"] = torch.cuda.get_device_name(dev)
        result["card"] = card_line()
    engine.stop()
    return result


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))


if __name__ == "__main__":
    main()
