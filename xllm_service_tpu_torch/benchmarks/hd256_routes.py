"""Kernel 1's two bf16 routes at head dim 256, timed at Gemma-2-9B's
decode shapes (card only).

    python -m xllm_service_tpu_torch.benchmarks.hd256_routes

The split-K decode walk (``csrc/split_decode.cuh``) takes bf16 at head dim
256 on the tensor cores (``mma.sync``). The CUDA-core kernel in f32 that
it takes for f32 rows could take bf16 rows too. This script builds both
for bf16 at head dim 256 (``csrc/split_routes.cu``), checks each against
``paged_attention_plain`` and times each, median of 20 with L2 flushed,
at Gemma-2-9B's decode (B 8, 16/8 heads, scale 1/16, softcap 50):

- behind 1024 tokens, no options;
- behind 4608 tokens on a local layer (window 4096);
- behind 4608 tokens on a global layer.

Both routes run with the split count that ``paged_attention`` plans
(``planned_blocks_per_sm``). The script prints ``ptxas``'s report for the
two kernels (registers, spills), one JSON line per shape with both
times, the bound and the error of each route, and the card's name and
power limit last. Without a card it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from typing import Optional

import torch

from ..common.device import card_line
from ..ops import _build
from ..ops.paged_attention import (
    paged_attention_plain,
    planned_blocks_per_sm,
    sm_count,
    split_count,
    split_work,
)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, H100 SXM
ROUTES = {"mma": 0, "fma": 1}
N_Q, N_KV, HD, PS, B = 16, 8, 256, 16, 8
GEMMA2 = {"softcap": 50.0, "scale": 1 / 16}
SHAPES = (("ctx 1024", 1024, {}),
          ("gemma2 local", 4608, {**GEMMA2, "window": 4096}),
          ("gemma2 global", 4608, GEMMA2))
TOL = 2e-2                       # bf16 against the f32 plain version


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, with L2 flushed before each and the
    card kept busy while the host enqueues it."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


def route_call(route: str, q, k, v, pt, cl, out, opts):
    """A closure launching ``route``'s kernel on these operands."""
    launch = _build.kernel_fn("split_routes", "split_routes_launch",
                              [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                              + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                              + [ctypes.c_void_p])
    max_pages = pt.shape[1]
    splits = split_count(B, N_KV, max_pages, PS, sm_count(q.device),
                         planned_blocks_per_sm("paged_attention", HD,
                                               N_Q // N_KV, True))
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def call():
        scratch, tickets = split_work(q, N_KV, splits, stream)
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), pt.data_ptr(),
                     cl.data_ptr(), out.data_ptr(), scratch, tickets, B, N_Q,
                     N_KV, PS, max_pages, splits,
                     float(opts.get("scale", HD ** -0.5)),
                     float(opts.get("softcap", 0.0)),
                     int(opts.get("window", 0)), ROUTES[route], stream)
        if err != 0:
            raise RuntimeError(f"split_routes {route}: launch failed ({err})")
        return out

    return call, splits


def inputs(ctx: int, seed: int):
    """A pool with a private span of ``ctx // PS`` pages per row, q, the
    table and the lengths (bf16, on the card)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = ctx // PS
    P = B * n_pages + 1
    k = torch.randn((P, N_KV, PS, HD), generator=g, device="cuda").bfloat16()
    v = torch.randn((P, N_KV, PS, HD), generator=g, device="cuda").bfloat16()
    q = torch.randn((B, N_Q, HD), generator=g, device="cuda").bfloat16()
    pt = (torch.arange(B * n_pages, dtype=torch.int32, device="cuda")
          .reshape(B, n_pages) + 1)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    return q, k, v, pt, cl


def run() -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("hd256_routes: needs a CUDA card")
    logs = _build.build(["split_routes"], verbose=True)
    for line in logs.get("split_routes", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    per_sm = {r: -1 for r in ROUTES}
    for r, code in ROUTES.items():
        per_sm[r] = _build.kernel_fn(
            "split_routes", "split_routes_blocks_per_sm",
            [ctypes.c_int] * 2)(N_Q // N_KV, code)
    rows = []
    for seed, (name, ctx, opts) in enumerate(SHAPES):
        q, k, v, pt, cl = inputs(ctx, seed)
        want = paged_attention_plain(q, k, v, pt, cl, **opts).float()
        visible = min(ctx, opts.get("window", ctx))
        nbytes = (2 * q.numel() * 2 + B * visible * N_KV * HD * 2 * 2
                  + B * (-(-visible // PS)) * 4 + B * 4)
        ops = 4 * N_Q * HD * B * visible
        row = {"shape": name, "batch": B, "heads": f"{N_Q}/{N_KV}",
               "head_dim": HD, "ctx": ctx, "visible": visible, "opts": opts,
               "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     ops / BF16_FLOPS)}
        for r in ROUTES:
            out = torch.empty_like(q)
            call, splits = route_call(r, q, k, v, pt, cl, out, opts)
            err = (call().float() - want).abs().max().item()
            if not err <= TOL:
                raise AssertionError(f"{r} at {name}: max_abs_err {err}")
            row[r] = {"ms": time_ms(call), "max_abs_err": err,
                      "splits": splits, "blocks_per_sm": per_sm[r]}
        row["fma_over_mma"] = row["fma"]["ms"] / row["mma"]["ms"]
        rows.append(row)
        print(json.dumps(row))
    return rows


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    run()
    print(card_line())


if __name__ == "__main__":
    main()
