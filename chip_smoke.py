#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xllm_service_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port starts, that its hand-written
kernels build and agree with their plain versions, and that the engine
serves Llama-3-8B through them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
1. environment: torch/CUDA versions, the card's name and power limit;
2. build the five CUDA libraries from ``xllm_service_tpu_torch/csrc`` (one
   nvcc per source, in parallel) into ``build/torch_kernels``;
3. each kernel against its plain PyTorch version on the card at Llama-3-8B
   shapes, timed beside its plain version and a PyTorch yardstick: the two
   attention kernels and the fused append-and-attend (bf16 and f32, ragged
   contexts, NaN garbage past every context; for the three split-K decode
   kernels also contexts shorter than a split, a split holding part of one
   page, empty splits and a lone row, windows for kernel 1; for the
   tensor-core prefill kernel a suffix that is no multiple of its tile and
   a row with no block; their splits, registers, blocks per SM, splits
   sweeps and shares of the library's time and of the bound are logged;
   ``scaled_dot_product_attention`` on the K/V already gathered dense), the
   page movers at one hash block (bit for bit; ``index_select`` /
   ``index_copy_``; also on the pool sharded four ways, one launch per
   call; the copy floor, a contiguous ``copy_`` of the same bytes; the
   sweep of the bulk route's stages, chunk and blocks per SM) and the
   context-parallel partial per shard at seq 2
   and 4 (NaN in every page a shard does not own and occupy, a shard that
   owns only a row's last, partial page; the whole CP op against
   single-device attention, and timed against kernel 1);
4. serving at Llama-3-8B's full width and depth (random weights from a
   fixed seed) through ``InferenceEngine`` with its background loop: ten
   greedy requests (two of them sharing a 512-token prefix with the first,
   submitted after its prefill) and one seeded sampled request, run twice
   on fresh engines; every decode step after a variant's first is a replay
   of the engine's captured step (``engine/decode_graph.py``), and the
   launch counts include the replays; checks lengths, determinism, prefix
   hits, kernel launches, the replays, and one prompt's logits by the
   cold, cached-prefix and decode routes;
4a. KV tiers at the same width: a 1024-token prompt served from HBM, its
   blocks evicted into a DRAM arena of four blocks and an SSD spill file,
   then served again from the tiers; the tokens must match, both tiers
   must have onloaded, and the restored pages must equal the evicted ones;
4b. the fused decode writeback (``XLLM_KV_WRITEBACK=fused``): phase 4's
   batch served twice through the fused kernel (replayed in the captured
   step), with kernel 1 idle, and the decode-step logits checked again;
4c. context-parallel serving at the same width and depth: the KV pool
   sharded four ways over a ``seq`` mesh (on one card, ``cuda:0`` four
   times); a long prefix-free prompt (ring prefill), a short one, one
   sharing the long one's first 512 tokens (a prefix hit through kernel 2)
   and a seeded sampled one, run twice on fresh engines; every decode step
   through kernel 6, kernels 1 and 3 idle; one decode step's logits against
   the single-device engine's (the step stays eager under the mesh);
4d. KV tiers under that seq mesh: phase 4a's round trip on a pool sharded
   four ways, with hash blocks that straddle shards; both tiers must have
   been used, the restored pages must equal the evicted ones, A's first
   token after the onload must equal its first from HBM, a decode step
   over the restored pages must agree with one over the evicted bytes on
   one device, and kernels 4, 5 and 6 must have launched, kernel 4 once
   per offloaded block;
4e. the decode step's host path: from the same state at full width, one
   replay of the captured step and the same step run op by op must agree
   bit for bit (packed rows, KV pool, slot state; greedy, seeded sampled
   and logprob rows, on both writeback routes); then the bench twin
   (``xllm_service_tpu_torch/bench.py``, Llama-3-8B, B 16, ctx 512,
   horizon 32) and the decode-profile twin
   (``xllm_service_tpu_torch/benchmarks/decode_profile.py``): tok/s and
   pct_roofline, eager and graphed ``full_step_ms``, kernels per step and
   the device's busy share from a ``torch.profiler`` trace;
5. a ``kernels`` JSON line, the card line, and the result line.

It needs one card; without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import gc
import json
import os
import sys
import threading
import time

import numpy as np
import torch

# Tolerances of the kernel checks, with their reasons.
# f32: kernel and plain version both accumulate in f32 and differ only in
#      summation order; outputs are weighted means of N(0, 1) values.
# bf16: both compute in f32 from identical bf16 inputs and round the output
#      once, so they differ by at most one bf16 ulp: 2**-6 for outputs in
#      [2, 4) (plus the f32 ordering noise).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Cold prefill versus the paged routes (cached prefix, decode step) through
# the full bf16 model: 32 layers of bf16 rounding (unit roundoff 2**-9) on
# differently ordered computations drift by a few percent of the logit
# scale; a masking or page bug moves logits by their whole scale. Bound:
# 10% of max |logit|.
PREFILL_REL_TOL = 0.1
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same source
N_Q, N_KV, HD, PS, B, MAX_PAGES = 32, 8, 128, 16, 8, 128


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers
def ptxas_report(text: str) -> list[str]:
    """ptxas -v's output, one line per kernel: its (mangled) name, registers
    and spills."""
    out, fn, spills = [], "", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            used = line[line.index("Used"):].strip()
            out.append(f"{fn}: {used}; {spills}")
    return out


KERNEL_WRAPPERS = []     # every kernel wrapper with a launch count


def reset_counts() -> None:
    """Zero every kernel's launch count (just before a path is driven)."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, with L2 flushed before each (the
    serving path finds K/V cold: other layers ran in between). A spin
    kernel keeps the card busy while the host enqueues the call, so the
    events time the call's kernels and not the host's launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)      # ~1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sweep_splits(module, name, counts, fn):
    """The same call with the host's choice of splits overridden by each of
    ``counts`` (``module.name`` replaced by a constant), timed; information
    only, the timed row is the wrapper's own choice."""
    real = getattr(module, name)
    sweep = {}
    try:
        for n in counts:
            setattr(module, name, lambda *args, n=n: n)
            sweep[n] = time_ms(fn)
    finally:
        setattr(module, name, real)
    return ", ".join(f"{n}: {t:.4f} ms" for n, t in sweep.items())


def paged_inputs(dtype, ctxs, n_pages=MAX_PAGES, seed=0):
    """Pool with a private page span per row, NaN in every slot past each
    row's context (a pool made with torch.empty can hold NaN there)."""
    rows = len(ctxs)
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = rows * n_pages + 1
    k = torch.randn((P, N_KV, PS, HD), generator=g, device="cuda").to(dtype)
    v = torch.randn((P, N_KV, PS, HD), generator=g, device="cuda").to(dtype)
    pt = (torch.arange(rows * n_pages, dtype=torch.int32, device="cuda")
          .reshape(rows, n_pages) + 1)
    pos = torch.arange(n_pages * PS, device="cuda")
    dead = pos[None, :] >= torch.tensor(ctxs, device="cuda")[:, None]
    b_idx, p_idx = dead.nonzero(as_tuple=True)
    page = pt[b_idx, p_idx // PS].long()
    k[page, :, p_idx % PS] = float("nan")
    v[page, :, p_idx % PS] = float("nan")
    return k, v, pt


def gathered(pages, pt, T):
    """[P, n_kv, ps, hd] x [B, mp] -> dense [B, n_kv, T, hd] (first T)."""
    g = pages[pt.long()]                              # [B, mp, n_kv, ps, hd]
    Bn, mp = g.shape[:2]
    return g.permute(0, 2, 1, 3, 4).reshape(Bn, N_KV, mp * PS, HD)[:, :, :T]


def sdpa(q, k, v, mask=None):
    """The yardstick: PyTorch's fused attention (GQA-aware) on K/V already
    gathered dense. Timed here only; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------- phase 3
def check_decode_kernel(paged_attention, paged_attention_plain, split_count,
                        kernel_fn):
    err = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # Ragged contexts up to the full table, then what split-K brings: a
    # context shorter than one split (3), one whose last split holds part of
    # one page (67: units 0-1, 2-3, 4 and an empty split at four splits),
    # one row alone (the most splits), and a window that starts inside a
    # later split's unit (ctx 1000, window 300: position 700).
    cases = [
        ([0, 1, 7, 16, 17, 500, 1000, MAX_PAGES * PS], {}),
        ([67, 3, 33, MAX_PAGES * PS, 1029, 515, 130, 64], {}),
        ([777], {}),
        ([1000, 67, 301, 0, 2048, 300, 16, 1500], {"window": 300}),
        ([1000], {"window": 300, "softcap": 30.0}),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for ctxs, opts in cases:
            rows = len(ctxs)
            k, v, pt = paged_inputs(dtype, ctxs)
            q = torch.randn((rows, N_Q, HD), device="cuda").to(dtype)
            cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            got = paged_attention(q, k, v, pt, cl, **opts)
            want = paged_attention_plain(q, k, v, pt, cl, **opts)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), "decode kernel: non-finite"
            for b, c in enumerate(ctxs):
                assert c > 0 or (got[b] == 0).all(), \
                    "decode kernel: ctx 0 row not zero"
            e = (got.float() - want.float()).abs().max().item()
            log(f"  paged_attention {str(dtype)[6:]:8s} ctx={ctxs} {opts} "
                f"splits={split_count(rows, N_KV, MAX_PAGES, PS, sms)} "
                f"max_abs_err={e:.3g} (tol {TOL[dtype]})")
            assert e <= TOL[dtype], "decode kernel disagrees with plain"
            err = max(err, e)

    # Timing at the decode step's shapes: B 8, ctx 1024, bf16.
    ctx = 1024
    k, v, pt = paged_inputs(torch.bfloat16, [ctx] * B, seed=1)
    q = torch.randn((B, N_Q, HD), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    kd, vd = gathered(k, pt, ctx).contiguous(), gathered(v, pt, ctx).contiguous()
    qd = q[:, :, None, :]
    ms = time_ms(lambda: paged_attention(q, k, v, pt, cl))
    plain_ms = time_ms(lambda: paged_attention_plain(q, k, v, pt, cl))
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd))
    nbytes = (2 * q.numel() * 2 + B * ctx * N_KV * HD * 2 * 2
              + B * (ctx // PS) * 4 + B * 4)
    ops = 4 * N_Q * HD * B * ctx
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  paged_attention bf16 B={B} ctx={ctx}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    per_sm = kernel_fn("paged_attention", "paged_attention_blocks_per_sm",
                       [ctypes.c_int] * 3)(HD, N_Q // N_KV, 1)
    log(f"  paged_attention: splits {split_count(B, N_KV, MAX_PAGES, PS, sms)}"
        f" on {sms} SMs, {per_sm} blocks per SM; "
        f"{ms / lib_ms:.2f}x the library's time, "
        f"{ms / bound:.1f}x the bound, "
        f"{nbytes / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")
    # What the host's choice of splits is worth.
    from xllm_service_tpu_torch.ops import paged_attention as pa_mod
    log("  paged_attention: splits sweep " + sweep_splits(
        pa_mod, "split_count", (1, 2, 4, 8),
        lambda: paged_attention(q, k, v, pt, cl)))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


def check_mq_kernel(mq_paged_attention, mq_paged_attention_plain, kernel_fn):
    err = 0.0
    # Sq 70 is no multiple of the 16-query tile; its second row has a block
    # length of 0 (every query padding, so the row comes out zero).
    for dtype in (torch.bfloat16, torch.float32):
        for s_q in (1, 17, 70, 512):
            for prefix in (0, 5, 384):      # none, a partial page, 3 blocks
                blocks = [s_q, 0 if s_q == 70 else max(1, s_q - 3)]
                ends = [prefix + b for b in blocks]
                k, v, pt = paged_inputs(dtype, ends, seed=2)
                q = torch.randn((2, s_q, N_Q, HD), device="cuda").to(dtype)
                pre = torch.full((2,), prefix, dtype=torch.int32,
                                 device="cuda")
                blk = torch.tensor(blocks, dtype=torch.int32, device="cuda")
                got = mq_paged_attention(q, k, v, pt, pre, blk)
                want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), "mq kernel: non-finite"
                assert blocks[1] > 0 or (got[1] == 0).all(), \
                    "mq kernel: a row with no block is not zero"
                e = (got.float() - want.float()).abs().max().item()
                log(f"  mq_paged_attention {str(dtype)[6:]:8s} Sq={s_q:3d} "
                    f"prefix={prefix:3d} max_abs_err={e:.3g} "
                    f"(tol {TOL[dtype]})")
                assert e <= TOL[dtype], "mq kernel disagrees with plain"
                err = max(err, e)

    # Timing at a prefix-hit prefill's shapes: one row, 512 new tokens
    # behind a 512-token cached prefix, bf16.
    s_q, prefix = 512, 512
    k, v, pt = paged_inputs(torch.bfloat16, [prefix + s_q], seed=3)
    q = torch.randn((1, s_q, N_Q, HD), device="cuda").to(torch.bfloat16)
    pre = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    blk = torch.tensor([s_q], dtype=torch.int32, device="cuda")
    T = prefix + s_q
    kd, vd = gathered(k, pt, T).contiguous(), gathered(v, pt, T).contiguous()
    qd = q.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :]
            <= prefix + torch.arange(s_q, device="cuda")[:, None])
    ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
    plain_ms = time_ms(lambda: mq_paged_attention_plain(q, k, v, pt, pre, blk))
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd, mask))
    nbytes = 2 * q.numel() * 2 + T * N_KV * HD * 2 * 2 + (T // PS) * 4 + 8
    pairs = s_q * prefix + s_q * (s_q + 1) // 2
    ops = 4 * N_Q * HD * pairs
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  mq_paged_attention bf16 Sq={s_q} prefix={prefix}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    per_sm = kernel_fn("mq_paged_attention",
                       "mq_paged_attention_blocks_per_sm", [ctypes.c_int])(HD)
    log(f"  mq_paged_attention: {per_sm} blocks per SM; "
        f"{ms / lib_ms:.2f}x the library's time, "
        f"{ms / bound:.1f}x the bound, {ops / ms / 1e9:.1f} TFLOP/s")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


def check_fused_kernel(fused_decode_attention, fused_decode_attention_plain,
                       split_count, kernel_fn):
    """Kernel 3 against its plain version: the output within TOL, both pools
    after the call equal bit for bit (the append is a copy). Its walk covers
    ctx - 1 pooled tokens, so the split-K edges sit one token later than
    kernel 1's: a walk shorter than one split (ctx 4), one whose last split
    holds part of one page (68: units 0-1, 2-3, 4 and an empty split at four
    splits), a full table, and one row alone (the most splits)."""
    from xllm_service_tpu_torch.ops import fused_decode_attention as fd_mod

    err = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [[0, 1, 16, 17, 500, 777, 1024, MAX_PAGES * PS],
             [68, 4, 34, MAX_PAGES * PS, 1030, 516, 131, 65],
             [778]]
    for dtype in (torch.bfloat16, torch.float32):
        for ctxs in cases:
            rows = len(ctxs)
            k, v, pt = paged_inputs(dtype, ctxs, seed=4)
            q = torch.randn((rows, N_Q, HD), device="cuda").to(dtype)
            k_new = torch.randn((rows, N_KV, HD), device="cuda").to(dtype)
            v_new = torch.randn((rows, N_KV, HD), device="cuda").to(dtype)
            cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            kp, vp = k.clone(), v.clone()
            got = fused_decode_attention(q, k_new, v_new, kp, vp, pt, cl)[0]
            want = fused_decode_attention_plain(q, k_new, v_new, k, v, pt,
                                                cl)[0]
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), "fused kernel: non-finite output"
            e = (got.float() - want.float()).abs().max().item()
            same_pools = all(
                torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in ((kp, k), (vp, v)))
            log(f"  fused_decode_attention {str(dtype)[6:]:8s} ctx={ctxs} "
                f"splits={split_count(rows, N_KV, MAX_PAGES, PS, sms)} "
                f"max_abs_err={e:.3g} (tol {TOL[dtype]}), pools "
                f"bit-identical {same_pools}")
            assert e <= TOL[dtype], "fused kernel disagrees with plain"
            assert same_pools, "fused kernel's append differs from plain"
            err = max(err, e)

    # Timing at the decode step's shapes: B 8, ctx 1024, bf16.
    ctx = 1024
    k, v, pt = paged_inputs(torch.bfloat16, [ctx] * B, seed=5)
    q = torch.randn((B, N_Q, HD), device="cuda").to(torch.bfloat16)
    k_new = torch.randn((B, N_KV, HD), device="cuda").to(torch.bfloat16)
    v_new = torch.randn((B, N_KV, HD), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    kd, vd = gathered(k, pt, ctx).contiguous(), gathered(v, pt, ctx).contiguous()
    qd = q[:, :, None, :]

    def call():
        return fused_decode_attention(q, k_new, v_new, k, v, pt, cl)

    ms = time_ms(call)
    plain_ms = time_ms(lambda: fused_decode_attention_plain(
        q, k_new, v_new, k, v, pt, cl))
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd))
    # q and the output, the new rows read and written, ctx - 1 pooled tokens
    # of K and V, one page-table entry per page read, the lengths.
    nbytes = (2 * q.numel() * 2 + 2 * 2 * k_new.numel() * 2
              + B * (ctx - 1) * N_KV * HD * 2 * 2
              + B * (-(-(ctx - 1) // PS)) * 4 + B * 4)
    ops = 4 * N_Q * HD * B * ctx
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  fused_decode_attention bf16 B={B} ctx={ctx}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    per_sm = kernel_fn("fused_decode_attention",
                       "fused_decode_attention_blocks_per_sm",
                       [ctypes.c_int] * 3)(HD, N_Q // N_KV, 1)
    log(f"  fused_decode_attention: splits "
        f"{split_count(B, N_KV, MAX_PAGES, PS, sms)} on {sms} SMs, {per_sm} "
        f"blocks per SM; {ms / lib_ms:.2f}x the library's time, "
        f"{ms / bound:.1f}x the bound")
    log("  fused_decode_attention: splits sweep "
        + sweep_splits(fd_mod, "split_count", (1, 2, 4, 8), call))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


def mover_case(page_dma, kv, ids, untouched, block, tag):
    """Gather and scatter of ``ids`` on pool ``kv`` (a tensor or a
    ``ShardedPages``) against the plain versions, bit for bit; the pages
    in ``untouched`` must keep their bits, and each call must be one
    launch."""
    full = (lambda t: t.full()) if hasattr(kv, "shards") else (lambda t: t)
    clone = ((lambda t: type(t)([s.clone() for s in t.shards], t.mesh))
             if hasattr(kv, "shards") else (lambda t: t.clone()))
    dtype = block.dtype
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    g0 = page_dma.gather_kv_pages.launches
    s0 = page_dma.scatter_kv_pages.launches
    got = page_dma.gather_kv_pages(kv, ids)
    want = page_dma.gather_kv_pages_plain(kv, ids)
    pool, ref = clone(kv), clone(kv)
    page_dma.scatter_kv_pages(pool, ids, block)
    page_dma.scatter_kv_pages_plain(ref, ids, block)
    torch.cuda.synchronize()
    launches = (page_dma.gather_kv_pages.launches - g0,
                page_dma.scatter_kv_pages.launches - s0)
    g_ok = torch.equal(got.view(bits), want.view(bits))
    s_ok = torch.equal(full(pool).view(bits), full(ref).view(bits))
    kept = torch.equal(full(pool)[:, :, untouched].view(bits),
                       full(kv)[:, :, untouched].view(bits))
    log(f"  page movers {tag} {str(dtype)[6:]:8s} block {tuple(want.shape)}: "
        f"gather bit-identical {g_ok}, scatter bit-identical {s_ok}, other "
        f"pages untouched {kept}, launches gather/scatter {launches}")
    assert g_ok and s_ok and kept, "a page mover disagrees with plain"
    assert launches == (1, 1), "a page mover call took more than one launch"


def sweep_movers(page_dma, gather, scatter):
    """The movers with the bulk route's shape overridden (stages x chunk x
    blocks per SM, every combination whose ring fits the SM's shared
    memory), each timed; information only, the timed rows use the
    module's own shape."""
    keys = ("STAGES", "CHUNK_BYTES", "BLOCKS_PER_SM")
    real = {k: getattr(page_dma, k) for k in keys}
    configs = [(st, ck << 10, bps) for bps in (1, 2) for st in (2, 4, 8)
               for ck in (4, 8, 16, 32) if bps * st * ck <= 220]
    out = []
    try:
        for cfg in configs:
            for k, val in zip(keys, cfg):
                setattr(page_dma, k, val)
            g_ms, s_ms = time_ms(gather), time_ms(scatter)
            log(f"  page movers sweep stages={cfg[0]} chunk={cfg[1] >> 10}K "
                f"blocks/SM={cfg[2]}: gather {g_ms:.4f} ms, scatter "
                f"{s_ms:.4f} ms")
            out.append((g_ms + s_ms, cfg))
    finally:
        for k, val in real.items():
            setattr(page_dma, k, val)
    best = min(out)
    log(f"  page movers sweep: fastest {best[1]} ({best[0] / 2:.4f} ms "
        f"mean); shipped {tuple(real.values())}")


def check_page_movers(page_dma, build_mesh, MeshConfig, ShardedPages):
    """Kernels 4-5 against their plain versions at one Llama-3-8B hash block
    ([32, 2, 8, 8, 16, 128]): bit for bit, with NaN in every page they must
    not touch, on one pool and on the same pool sharded four ways on one
    card (the block's eight pages on all four shards), one launch per
    call. Then times, the bulk route's sweep and the copy floor. Returns
    (gather row, scatter row)."""
    L, ppb, n_pages = 32, 8, 40
    ids = [17, 3, 29, 8, 35, 1, 22, 12]                  # shuffled, 8 pages
    untouched = [p for p in range(n_pages) if p not in ids]
    mesh = build_mesh(MeshConfig(seq=4), ["cuda:0"] * 4)
    assert sorted({p // (n_pages // 4) for p in ids}) == [0, 1, 2, 3]
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(6)
        kv = torch.randn((L, 2, n_pages, N_KV, PS, HD), generator=g,
                         device="cuda").to(dtype)
        kv[:, :, untouched] = float("nan")
        block = torch.randn((L, 2, ppb, N_KV, PS, HD), generator=g,
                            device="cuda").to(dtype)
        mover_case(page_dma, kv, ids, untouched, block, "pool")
        sharded = ShardedPages([c.contiguous() for c in kv.chunk(4, dim=2)],
                               mesh)
        mover_case(page_dma, sharded, ids, untouched, block, "4 shards")

    # Timing at one bf16 hash block (the offload and onload of one block).
    kv = torch.randn((L, 2, n_pages, N_KV, PS, HD), device="cuda").to(
        torch.bfloat16)
    block = torch.randn((L, 2, ppb, N_KV, PS, HD), device="cuda").to(
        torch.bfloat16)
    ids_d = torch.tensor(ids, device="cuda")
    # Each byte of the block read once and written once, and the ids.
    nbytes = 2 * block.numel() * 2 + len(ids) * 4
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    sharded = ShardedPages([c.contiguous() for c in kv.chunk(4, dim=2)], mesh)
    # The copy floor: the card's own contiguous copy of the same 16 MiB (a
    # yardstick only; the port never calls it).
    src = torch.empty_like(block)
    dst = torch.empty_like(block)
    floor_ms = time_ms(lambda: dst.copy_(src))
    rows = []
    for name, kernel, plain, lib, shard_call in (
            ("gather_kv_pages",
             lambda: page_dma.gather_kv_pages(kv, ids),
             lambda: page_dma.gather_kv_pages_plain(kv, ids_d),
             lambda: kv.index_select(2, ids_d),
             lambda: page_dma.gather_kv_pages(sharded, ids)),
            ("scatter_kv_pages",
             lambda: page_dma.scatter_kv_pages(kv, ids, block),
             lambda: page_dma.scatter_kv_pages_plain(kv, ids_d, block),
             lambda: kv.index_copy_(2, ids_d, block),
             lambda: page_dma.scatter_kv_pages(sharded, ids, block))):
        ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(lib)
        shard_ms = time_ms(shard_call)
        log(f"  {name} bf16 block {tuple(block.shape)}: kernel {ms:.4f} ms "
            f"(4 shards {shard_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, copy floor {floor_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{nbytes / ms / 1e9:.3f} TB/s, {bound / ms:.1%} of the bound)")
        rows.append(dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by="bytes", library_ms=lib_ms))
    sweep_movers(page_dma, lambda: page_dma.gather_kv_pages(kv, ids),
                 lambda: page_dma.scatter_kv_pages(kv, ids, block))
    return rows


def poison_unowned(k, v, pt, ctxs):
    """NaN into every (page, slot) of the pool that no row occupies below
    its context: what a shard holds outside its owned, occupied pages."""
    P = k.shape[0]
    keep = torch.zeros((P, PS), dtype=torch.bool, device="cuda")
    pos = torch.arange(pt.shape[1] * PS, device="cuda")
    for b, ctx in enumerate(ctxs):
        live = pos[:ctx]
        keep[pt[b, live // PS].long(), live % PS] = True
    k.masked_fill_(~keep[:, None, :, None], float("nan"))
    v.masked_fill_(~keep[:, None, :, None], float("nan"))


def cp_case(dtype, ctxs, seed, tail_row=None):
    """Inputs of kernel 6's check: a pool of B * MAX_PAGES + 8 pages (the
    count divides by 2 and 4), tables a permutation of pages 4..P-2 across
    every shard, NaN in every slot no row occupies below its context. Row 1
    (when there are two rows or more) sits on the garbage page. Row
    ``tail_row`` (four pages long) holds pages 1, 2, 3 of shard 0's range
    and, for its last, partial page, page P - 1 of the last shard's range,
    so that shard owns only that page of the row."""
    rows = len(ctxs)
    P = B * MAX_PAGES + 8
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((P, N_KV, PS, HD), generator=g, device="cuda").to(dtype)
    v = torch.randn((P, N_KV, PS, HD), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(P - 5, generator=torch.Generator().manual_seed(seed))
    pt = (perm[:rows * MAX_PAGES] + 4).reshape(rows, MAX_PAGES).to(
        torch.int32).cuda()
    if rows > 1:
        pt[1] = 0
    if tail_row is not None:
        assert -(-ctxs[tail_row] // PS) == 4, "the tail row holds four pages"
        pt[tail_row, :4] = torch.tensor([1, 2, 3, P - 1], dtype=torch.int32)
    poison_unowned(k, v, pt, ctxs)
    q = torch.randn((rows, N_Q, HD), device="cuda").to(dtype)
    cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    return q, k, v, pt, cl


def check_cp_kernel(cp, paged_attention, paged_attention_plain,
                    build_mesh, MeshConfig, kernel_fn):
    """Kernel 6 against its plain version, shard by shard, at seq 2 and 4;
    the whole CP op against single-device attention on the same pool; then
    times at the decode step's shapes.

    Cases: ragged contexts up to the full table; kernel 1's split-K edges
    (a context shorter than one split, 3; one whose last split holds part
    of one page, 67; a row whose last, partial page is all one shard owns
    of it, 3 * 16 + 5) beside empty rows; one row alone (the most splits).
    Checks: rows where the plain version sees nothing (m <= NEG_INF / 2)
    must match exactly (m = NEG_INF, l = 0, acc = 0); elsewhere m within
    TOL, and l and acc within TOL after dividing by max(l, 1): both are
    sums of up to ctx terms weighted by p <= 1, so their rounding grows
    with l. The merged output is compared within TOL."""
    from xllm_service_tpu_torch.ops.paged_attention import NEG_INF

    err = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [([0, 1, 16, 17, 500, 777, 1024, MAX_PAGES * PS], None),
             ([67, 3, 33, 3 * PS + 5, 0, 1029, 130, MAX_PAGES * PS], 3),
             ([777], None)]
    for dtype in (torch.bfloat16, torch.float32):
        for ci, (ctxs, tail_row) in enumerate(cases):
            q, k, v, pt, cl = cp_case(dtype, ctxs, 8 + ci, tail_row)
            rows, P = len(ctxs), k.shape[0]
            want = paged_attention_plain(q, k, v, pt, cl)
            for n in (2, 4):
                mesh = build_mesh(MeshConfig(seq=n), ["cuda:0"] * n)
                k_sh, v_sh = list(k.chunk(n)), list(v.chunk(n))
                P_loc = P // n
                splits = cp.partial_split_count(rows, N_KV, MAX_PAGES, PS,
                                                sms, n)
                for d in range(n):
                    tables = cp.compact_local_table(pt, cl, d * P_loc, P_loc,
                                                    PS)
                    m, l, acc = cp.paged_partial(q, k_sh[d], v_sh[d],
                                                 *tables, cl, shards=n)
                    m0, l0, a0 = cp.paged_partial_plain(q, k_sh[d], v_sh[d],
                                                        *tables, cl)
                    torch.cuda.synchronize()
                    dead = m0 <= NEG_INF / 2
                    assert torch.equal(dead, m <= NEG_INF / 2), \
                        "cp partial: masked rows differ"
                    assert (m[dead] == m0[dead]).all() and \
                        (l[dead] == 0).all() and (acc[dead] == 0).all(), \
                        "cp partial: a row the shard does not touch is not " \
                        "empty"
                    assert torch.isfinite(acc).all() and \
                        torch.isfinite(l).all()
                    lsc = l0.clamp_min(1.0)
                    e = max((m - m0)[~dead].abs().max().item()
                            if (~dead).any() else 0.0,
                            ((l - l0).abs() / lsc).max().item(),
                            ((acc - a0).abs() / lsc[..., None]).max().item())
                    log(f"  cp_paged_partial {str(dtype)[6:]:8s} ctx={ctxs} "
                        f"seq={n} shard {d} splits={splits}: n_local "
                        f"{tables[2].tolist()}, err={e:.3g} "
                        f"(tol {TOL[dtype]})")
                    assert e <= TOL[dtype], "cp partial disagrees with plain"
                    err = max(err, e)
                got = cp.cp_paged_attention(q, k_sh, v_sh, pt, cl, mesh)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                log(f"  cp_paged_attention {str(dtype)[6:]:8s} ctx={ctxs} "
                    f"seq={n} vs single-device plain: max_abs_err={e:.3g} "
                    f"(tol {TOL[dtype]})")
                assert torch.isfinite(got).all()
                for b, c in enumerate(ctxs):
                    assert c > 0 or (got[b] == 0).all(), \
                        "cp op: a ctx-0 row is not zero"
                assert e <= TOL[dtype], "cp op disagrees with single-device"
                err = max(err, e)

    # Timing at the decode step's shapes over four shards: B 8, ctx 1024,
    # bf16; entry j of every row on shard j % 4, so each shard owns 16 of
    # a row's 64 pages, at positions that are not contiguous.
    n, ctx, mp = 4, 1024, 1024 // PS
    P = 4 * B * mp + 4
    P_loc = P // n
    k = torch.randn((P, N_KV, PS, HD), device="cuda").to(torch.bfloat16)
    v = torch.randn((P, N_KV, PS, HD), device="cuda").to(torch.bfloat16)
    j = torch.arange(mp, device="cuda")
    pt = ((j % n) * P_loc + 1 + torch.arange(B, device="cuda")[:, None] * mp
          // n + j // n).to(torch.int32)                   # [B, 64], unique
    q = torch.randn((B, N_Q, HD), device="cuda").to(torch.bfloat16)
    cl = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    mesh = build_mesh(MeshConfig(seq=n), ["cuda:0"] * n)
    k_sh, v_sh = list(k.chunk(n)), list(v.chunk(n))
    tabs = cp.cp_tables(pt, cl, cp.ShardedPages(k_sh, mesh))
    t0 = tabs[0]
    own = int(t0[2].sum())                      # pages shard 0 walks
    assert own == B * mp // n

    def call():
        return cp.paged_partial(q, k_sh[0], v_sh[0], *t0, shards=n)

    ms = time_ms(call)
    plain_ms = time_ms(lambda: cp.paged_partial_plain(q, k_sh[0], v_sh[0],
                                                      *t0))
    # The yardstick: SDPA over shard 0's owned pages of each row, gathered
    # dense (each row owns the same count here).
    local = t0[0][:, :mp // n].long()
    kd = k_sh[0][local].permute(0, 2, 1, 3, 4).reshape(
        B, N_KV, mp // n * PS, HD).contiguous()
    vd = v_sh[0][local].permute(0, 2, 1, 3, 4).reshape(
        B, N_KV, mp // n * PS, HD).contiguous()
    lib_ms = time_ms(lambda: sdpa(q[:, :, None, :], kd, vd))
    # q, the f32 outputs (m, l, acc), the owned K/V, the owned entries of
    # local_pt and starts, n_local and the lengths.
    tok = own * PS
    nbytes = (q.numel() * 2 + B * N_Q * (2 + HD) * 4 + tok * N_KV * HD * 2 * 2
              + own * 4 * 2 + B * 4 * 2)
    ops = 4 * N_Q * HD * tok
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    log(f"  cp_paged_partial bf16 B={B} ctx={ctx} shard 0 of {n} "
        f"({own} owned pages): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} GFLOP)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = kernel_fn("cp_paged_partial", "cp_paged_partial_blocks_per_sm",
                       [ctypes.c_int] * 3)(HD, N_Q // N_KV, 1)
    log(f"  cp_paged_partial: splits "
        f"{cp.partial_split_count(B, N_KV, mp, PS, sms, n)} on {sms} SMs, "
        f"{per_sm} blocks per SM; {ms / lib_ms:.2f}x the library's time, "
        f"{ms / bound:.1f}x the bound")
    log("  cp_paged_partial: splits sweep "
        + sweep_splits(cp, "partial_split_count", (1, 2, 4), call))
    # The whole CP op (n partial launches and the merge) against kernel 1
    # at the same B and ctx on the unsharded pool; the step's compaction,
    # shared by all layers, apart.
    op_ms = time_ms(lambda: cp.cp_paged_attention(q, k_sh, v_sh, pt, cl, mesh,
                                                  tables=tabs))
    tab_ms = time_ms(lambda: cp.cp_tables(pt, cl, cp.ShardedPages(k_sh, mesh)))
    k1_ms = time_ms(lambda: paged_attention(q, k, v, pt, cl))
    log(f"  cp_paged_attention bf16 B={B} ctx={ctx} seq={n}: {op_ms:.4f} ms "
        f"(4 partials + merge), tables {tab_ms:.4f} ms per step; kernel 1 "
        f"on the unsharded pool {k1_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


# ---------------------------------------------------------------- phase 4
class Collector:
    def __init__(self):
        self.tokens: list[int] = []
        self.reason = ""
        self.t_first = 0.0
        self.first = threading.Event()
        self.done = threading.Event()

    def __call__(self, out) -> None:
        if not out.status.ok():
            self.reason = f"error: {out.status.message}"
        for s in out.outputs:
            self.tokens.extend(s.token_ids)
            self.reason = s.finish_reason or self.reason
        if not self.first.is_set():
            self.t_first = time.monotonic()
            self.first.set()
        if out.finished:
            self.done.set()


def serve_once(engine_mod, cfg, params, prompts, shared, sampled_prompt,
               mesh=None):
    """One serving run on a fresh engine (on ``mesh`` if given) with its
    background loop. Returns (tokens per request, finish reasons, stats
    with the count of ring prefills, ttft ms, generated tokens/s over the
    run)."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params, mesh=mesh)
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    samp = SamplingParams(max_tokens=64, temperature=0.8, top_p=0.9,
                          seed=1234, ignore_eos=True)
    cols = {}
    t_sub = {}
    eng.start()
    try:
        t0 = time.monotonic()

        def submit(name, toks, sp):
            cols[name] = Collector()
            t_sub[name] = time.monotonic()
            eng.submit(engine_mod.EngineRequest(name, token_ids=toks,
                                                sampling=sp,
                                                on_output=cols[name]))

        for i, p in enumerate(prompts):
            submit(f"g{i}", p, greedy)
        submit("sampled", sampled_prompt, samp)
        # The two prefix-sharing requests arrive after request 0's prefill
        # has finished (its blocks are donated before its first token).
        assert cols["g0"].first.wait(600), "request 0 never started"
        for j, p in enumerate(shared):
            submit(f"s{j}", p, greedy)
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        wall = time.monotonic() - t0
    finally:
        eng.stop()
    stats = dict(eng.stats(), ring_prefills=eng.ring_prefills)
    ttft = sorted((c.t_first - t_sub[n]) * 1e3 for n, c in cols.items())
    toks = {n: c.tokens for n, c in cols.items()}
    reasons = {n: c.reason for n, c in cols.items()}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, reasons, stats, ttft, sum(map(len, toks.values())) / wall


def check_replays(stats, name):
    """The run decoded through the captured step: a variant is captured at
    its first use (greedy; with a sampled request, sampling), every later
    step is a replay."""
    graph = stats["decode_graph"]
    log(f"  {name}: decode graph captures {graph['captures']}, replays "
        f"{graph['replays']}")
    assert 1 <= graph["captures"] <= 4, "unexpected captures"
    assert graph["replays"] > 10 * graph["captures"], "few replays"


def check_logits(llama, cfg, params, prompt, prefix):
    """Last-token logits of one shared prompt three ways: a cold prefill
    (dense attention), a prefill behind its first ``prefix`` tokens cached
    (the multi-query kernel), and a prefill of all but the last token then
    one decode step (the decode kernel). The two paged routes must agree
    with the cold one."""
    mcfg = cfg.model
    n = len(prompt)
    n_pages = -(-n // PS)
    i32 = dict(dtype=torch.int32, device="cuda")

    def pool():
        return torch.zeros((mcfg.num_layers, 2, n_pages + 1, N_KV, PS, HD),
                           dtype=mcfg.dtype, device="cuda")

    def prefill(kv, lo, hi):
        return llama.prefill_forward(
            params, mcfg, toks[:, lo:hi], torch.arange(lo, hi, **i32)[None],
            kv, pt, torch.tensor([lo], **i32), torch.tensor([hi - lo], **i32),
            has_prefix=lo > 0)[0]

    pt = torch.arange(1, n_pages + 1, **i32)[None]
    toks = torch.tensor([prompt], **i32)
    cold = prefill(pool(), 0, n)
    kv = pool()
    prefill(kv, 0, prefix)
    routes = {"cached prefix": prefill(kv, prefix, n)}
    kv = pool()
    prefill(kv, 0, n - 1)
    routes["decode step"] = llama.decode_forward(
        params, mcfg, toks[:, n - 1], torch.tensor([n - 1], **i32), kv, pt,
        torch.tensor([n], **i32))[0]
    scale = cold.abs().max().item()
    for name, got in routes.items():
        err = (cold - got).abs().max().item()
        log(f"  logits cold vs {name} ({prefix}/{n} tokens): max_abs_err="
            f"{err:.4g}, max|logit|={scale:.4g} (tol {PREFILL_REL_TOL} x "
            f"max|logit|), argmax {int(cold.argmax())} vs {int(got.argmax())}")
        assert torch.isfinite(got).all(), name
        assert err <= PREFILL_REL_TOL * scale, f"{name} logits drifted"


# --------------------------------------------------------------- phase 4a
def serve_one(eng, engine_mod, name, toks, max_tokens=16):
    """One greedy request through a running engine; returns its tokens."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    col = Collector()
    eng.submit(engine_mod.EngineRequest(
        name, token_ids=toks, on_output=col,
        sampling=SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                ignore_eos=True)))
    assert col.done.wait(600), f"{name} never finished"
    assert len(col.tokens) == max_tokens and col.reason == "length", \
        f"{name}: {len(col.tokens)} tokens, reason {col.reason!r}"
    return col.tokens


def wait_for(pred, what, timeout=120.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.01)


def tier_phase(engine_mod, cfg, params, page_dma, card):
    """Prompt A (1024 tokens = 8 hash blocks) served from HBM, evicted into
    the tiers by two unrelated prompts, served again from the tiers.

    The pool holds A's 65 pages plus one more request's, so the second
    unrelated prompt evicts exactly A's eight blocks. A request on A's
    first four blocks in between makes blocks 4-7 the least recently used:
    they are evicted first, so the DRAM arena (four blocks) ends holding
    blocks 0-3 and blocks 4-7 are demoted to the SSD file. The onload walk
    then reads 0-3 from DRAM, each fetch freeing the arena slot that the
    walk's own evictions refill, and 4-6 from SSD (block 7 is prefilled: a
    prefill keeps at least one token).

    One tier worker: installs land in eviction order, and an install that
    the walk's own eviction starts cannot demote the next block before the
    walk fetches it (with two workers, two installs could race one
    fetch)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.hashing import prefix_block_hashes

    hbs = cfg.hash_block_size
    rng = np.random.default_rng(7)
    V = cfg.model.vocab_size
    prompt_a = rng.integers(3, V, size=8 * hbs).tolist()
    m = cfg.model
    blk = (m.num_layers * 2 * hbs * m.num_kv_heads * m.head_dim
           * torch.empty((), dtype=m.dtype).element_size())
    # 129 usable pages: A's 65 (1024 + 16 tokens) and U1's 64 cached pages.
    tcfg = replace(cfg, num_pages=130, kv_tier_dram_bytes=4 * blk,
                   kv_tier_ssd_bytes=16 * blk, kv_tier_threads=1)
    eng = engine_mod.InferenceEngine(tcfg, params=params)
    store = eng.tier_store
    assert store is not None and store.block_nbytes == blk
    log(f"  block {blk / (1 << 20):.0f} MiB; DRAM arena 4 blocks, SSD file "
        "16 blocks, one tier worker")
    hashes = [h.hex() for h in prefix_block_hashes(prompt_a, hbs)]
    reset_counts()
    eng.start()
    try:
        serve_one(eng, engine_mod, "A0", prompt_a)
        t_hbm = serve_one(eng, engine_mod, "A1", prompt_a)        # HBM hit
        # The bytes to be evicted, for the check after the onload (plain
        # gather; looking the blocks up refreshes them in LRU order).
        before = {}
        for h in hashes[:7]:
            pages = eng.page_mgr.match_block(h)
            before[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
            eng.page_mgr.release_prefix([h])
        serve_one(eng, engine_mod, "A-half",
                  prompt_a[:4 * hbs] + rng.integers(3, V, 100).tolist())
        t0 = time.monotonic()
        serve_one(eng, engine_mod, "U1", rng.integers(3, V, 8 * hbs).tolist())
        serve_one(eng, engine_mod, "U2", rng.integers(3, V, 8 * hbs).tolist())
        wait_for(lambda: all(store.ready(h) for h in hashes),
                 "A's blocks in the tiers")
        t_off = time.monotonic() - t0
        st0 = store.stats()
        tiers = [store.tier_of(h) for h in hashes]
        log(f"  after eviction: A's blocks in tiers {tiers}, stats {st0}")
        t0 = time.monotonic()
        t_tier = serve_one(eng, engine_mod, "A2", prompt_a)      # tiers
        t_on = time.monotonic() - t0
        launches = (page_dma.gather_kv_pages.launches,
                    page_dma.scatter_kv_pages.launches)
        wait_for(lambda: not store._pending, "the tier pump settling")
        st = store.stats()
        ev = eng.drain_kv_events()
        after = {}
        for h in hashes[:7]:
            pages = eng.page_mgr.match_block(h)
            assert pages is not None, "an onloaded block is not in HBM"
            after[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
    finally:
        eng.stop()
    same = all(torch.equal(before[h].view(torch.int16),
                           after[h].view(torch.int16)) for h in before)
    log(f"  tier stats {st}; events stored {len(ev.stored)} offloaded "
        f"{len(ev.offloaded)} removed {len(ev.removed)}; launches "
        f"gather/scatter {launches}")
    log(f"  T_hbm == T_tier: {t_hbm == t_tier}; restored pages bit-identical "
        f"to the evicted ones: {same}")
    mb = 1 << 20
    log(f"  offload {st0['bytes_offloaded'] / mb:.0f} MiB in {t_off:.2f} s "
        f"(two 1024-token requests and the downloads: "
        f"{st0['bytes_offloaded'] / mb / t_off:.0f} MiB/s); onload "
        f"{(st['bytes_onloaded']) / mb:.0f} MiB within A's second request "
        f"of {t_on:.2f} s ({st['bytes_onloaded'] / mb / t_on:.0f} MiB/s, "
        f"prefill and decode included); information only, {card}")
    assert t_tier == t_hbm, "tokens after the tier round trip differ"
    assert same, "restored pages differ from the evicted ones"
    assert "dram" in tiers and "ssd" in tiers, "not both tiers were used"
    assert st["onload_total"] >= 7 and st["demote_total"] >= 1
    assert ev.offloaded, "no offloaded events were drained"
    assert launches[0] > 0 and launches[1] > 0, "a page mover never ran"
    return launches


# --------------------------------------------------------------- phase 4b
def fused_phase(engine_mod, cfg, params, prompts, shared, sampled_prompt,
                kernels, llama):
    """Phase 4's batch twice under XLLM_KV_WRITEBACK=fused: every decode step
    through kernel 3 and none through kernel 1."""
    fused, paged = kernels
    os.environ["XLLM_KV_WRITEBACK"] = "fused"
    try:
        runs = []
        for r in range(2):
            reset_counts()
            t = time.monotonic()
            toks, reasons, stats, ttft, tps = serve_once(
                engine_mod, cfg, params, prompts, shared, sampled_prompt)
            launches = (fused.launches, paged.launches)
            log(f"  fused run {r}: {time.monotonic() - t:.1f} s, launches "
                f"fused/decode {launches}, {tps:.1f} generated tok/s "
                f"(information only)")
            for name, tk in toks.items():
                assert len(tk) == 64 and reasons[name] == "length", \
                    f"{name}: {len(tk)} tokens, reason {reasons[name]!r}"
            assert launches[0] > 0, "the fused kernel never launched"
            assert launches[1] == 0, "kernel 1 launched under fused mode"
            check_replays(stats, f"fused run {r}")
            runs.append((toks, launches))
        assert runs[0][0] == runs[1][0], "two fused runs differ"
        log("  both fused runs gave identical tokens for all 11 requests")
        check_logits(llama, cfg, params, shared[0], 512)
    finally:
        del os.environ["XLLM_KV_WRITEBACK"]
    return runs[0]


# --------------------------------------------------------------- phase 4c
def check_cp_logits(llama, cfg, params, prompt, mesh, ShardedPages):
    """One prompt's decode-step logits two ways: the single-device route
    (dense prefill, kernel 1) and the context-parallel route the engine
    takes (ring prefill over the suffix padded to the axis, then the CP op
    over a pool sharded four ways). They must agree within PREFILL_REL_TOL
    of max |logit|."""
    mcfg = cfg.model
    n = len(prompt)
    n_pages = -(-n // PS)
    shards = len(mesh.axis_devices("seq"))
    n_pool = -(-(n_pages + 1) // shards) * shards
    i32 = dict(dtype=torch.int32, device="cuda")
    shape = (mcfg.num_layers, 2, n_pool, N_KV, PS, HD)
    pt = torch.arange(1, n_pages + 1, **i32)[None]
    toks = torch.tensor([prompt], **i32)

    def route(kv, ring):
        pre = list(prompt[:-1])
        if ring:
            pre += [0] * (-len(pre) % shards)
        llama.prefill_forward(
            params, mcfg, torch.tensor([pre], **i32),
            torch.arange(len(pre), **i32)[None], kv, pt,
            torch.zeros((1,), **i32), torch.tensor([n - 1], **i32),
            has_prefix=False, ring=ring)
        return llama.decode_forward(
            params, mcfg, toks[:, n - 1], torch.tensor([n - 1], **i32), kv,
            pt, torch.tensor([n], **i32))[0]

    single = route(torch.zeros(shape, dtype=mcfg.dtype, device="cuda"), False)
    cp = route(ShardedPages.zeros(shape, mcfg.dtype, mesh), True)
    scale = single.abs().max().item()
    err = (single - cp).abs().max().item()
    log(f"  logits single-device vs context-parallel decode step ({n} "
        f"tokens, ring prefill): max_abs_err={err:.4g}, max|logit|="
        f"{scale:.4g} (tol {PREFILL_REL_TOL} x max|logit|), argmax "
        f"{int(single.argmax())} vs {int(cp.argmax())}")
    assert torch.isfinite(cp).all()
    assert err <= PREFILL_REL_TOL * scale, "CP decode-step logits drifted"


def cp_phase(engine_mod, cfg, params, llama, kernels, card):
    """Context-parallel serving of Llama-3-8B on a seq=4 mesh, twice on
    fresh engines: ring prefill for the long prompt, a prefix hit through
    kernel 2, every decode step through kernel 6, kernels 1 and 3 idle.
    Returns (the first run's tokens and launches, single-device tokens)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    partial, paged, mq, fused = kernels
    count = torch.cuda.device_count()
    mesh = build_mesh(MeshConfig(seq=4),
                      [torch.device("cuda", i % count) for i in range(4)])
    log(f"  mesh seq=4 on {[str(d) for d in mesh.devices]}")
    cp_cfg = replace(cfg, seq_parallel_min_tokens=1024)
    rng = np.random.default_rng(11)
    V = cfg.model.vocab_size
    long = rng.integers(3, V, size=int(rng.integers(1100, 1501))).tolist()
    short = rng.integers(3, V, size=int(rng.integers(64, 513))).tolist()
    shared = [long[:512] + rng.integers(3, V, size=200).tolist()]
    sampled_prompt = rng.integers(3, V, size=200).tolist()
    log(f"  prompts: long {len(long)}, short {len(short)}, shared 512 + 200, "
        f"sampled 200 tokens; 64 generated each")
    runs = []
    for r in range(2):
        reset_counts()
        t = time.monotonic()
        toks, reasons, stats, ttft, tps = serve_once(
            engine_mod, cp_cfg, params, [long, short], shared,
            sampled_prompt, mesh=mesh)
        launches = dict(partial=partial.launches, decode=paged.launches,
                        mq=mq.launches, fused=fused.launches)
        log(f"  cp run {r}: {time.monotonic() - t:.1f} s, ring prefills "
            f"{stats['ring_prefills']}, prefix hits {stats['prefix_hits']}, "
            f"launches {launches}")
        log(f"  cp run {r}: TTFT ms p50 {ttft[len(ttft) // 2]:.1f} max "
            f"{ttft[-1]:.1f}; {tps:.1f} generated tok/s over the run "
            f"(information only; {card})")
        for name, tk in toks.items():
            assert len(tk) == 64 and reasons[name] == "length", \
                f"{name}: {len(tk)} tokens, reason {reasons[name]!r}"
        assert launches["partial"] > 0, "kernel 6 never launched"
        assert "decode_graph" not in stats, "a graph under the seq mesh"
        assert launches["decode"] == 0 and launches["fused"] == 0, \
            "kernel 1 or 3 launched under the seq mesh"
        assert launches["mq"] > 0, "the prefix hit did not take kernel 2"
        assert stats["ring_prefills"] == 1, "the ring route did not run once"
        assert stats["prefix_hits"] >= 1 and \
            stats["prefix_hit_tokens"] >= 512, "no prefix hit"
        runs.append((toks, launches))
    assert runs[0][0] == runs[1][0], "two CP runs of the same batch differ"
    log("  both CP runs gave identical tokens for all 4 requests")
    single, *_ = serve_once(engine_mod, cfg, params, [long, short], shared,
                            sampled_prompt)
    same = sum(single[n] == runs[0][0][n] for n in single)
    log(f"  CP vs single-device engine: {same}/{len(single)} requests with "
        "identical tokens (information only: random bf16 weights give "
        "near-ties, and the two sum in another order)")
    check_cp_logits(llama, cfg, params, long[:1100], mesh, ShardedPages)
    return runs[0]


# --------------------------------------------------------------- phase 4d
def restored_decode_check(llama, cfg, params, eng, pages, blocks, token):
    """One decode step of prompt A at position 1024 two ways: on the
    engine's sharded pool, whose rows ``pages`` (A's 64) hold blocks
    restored from the tiers (kernel 6 per shard, then the merge), and on a
    single-device pool filled with ``blocks``, the bytes gathered before
    the eviction (kernel 1). They must agree within PREFILL_REL_TOL of max
    |logit|."""
    mcfg = cfg.model
    i32 = dict(dtype=torch.int32, device=eng.device)
    n = len(pages)
    extra = eng.page_mgr.allocate(1)             # the new token's page
    tok = torch.tensor([token], **i32)
    pos = torch.tensor([n * cfg.page_size], **i32)
    cp_logits = llama.decode_forward(
        params, mcfg, tok, pos, eng.kv_pages,
        torch.tensor([pages + extra], **i32), pos + 1)[0]
    single = torch.zeros((*blocks[0].shape[:2], n + 2, *blocks[0].shape[3:]),
                         dtype=mcfg.dtype, device=eng.device)
    single[:, :, 1:n + 1] = torch.cat(blocks, dim=2)
    one_logits = llama.decode_forward(
        params, mcfg, tok, pos, single,
        torch.arange(1, n + 2, **i32)[None], pos + 1)[0]
    scale = one_logits.abs().max().item()
    err = (one_logits - cp_logits).abs().max().item()
    log(f"  logits of the decode step after A's prompt, restored sharded "
        f"pool vs the evicted bytes on one device: max_abs_err={err:.4g}, "
        f"max|logit|={scale:.4g} (tol {PREFILL_REL_TOL} x max|logit|), "
        f"argmax {int(one_logits.argmax())} vs {int(cp_logits.argmax())}")
    assert torch.isfinite(cp_logits).all()
    assert err <= PREFILL_REL_TOL * scale, "decode over restored pages drifted"


def tier_cp_phase(engine_mod, cfg, params, llama, page_dma, partial,
                  devices, card):
    """Phase 4a's round trip on a pool sharded four ways over a seq mesh
    (``devices``, four of them): prompt A (1024 tokens, 8 hash blocks)
    served from HBM, evicted into a DRAM arena of four blocks and an SSD
    file by two unrelated prompts, served again from the tiers.

    136 pages (34 a shard): A's 65 and U1's 64 fit with 6 to spare, and
    U2 evicts A's eight blocks in phase 4a's order (blocks 4-7 first, so
    they are demoted to SSD when 0-3 fill the arena). A's block 4 lies on
    pages 33-40, across shards 0 and 1, and the onload walk restores
    blocks across shards too (the phase logs each block's shards): one
    launch moves pages of two shards.

    Checks: the restored pages equal the evicted ones bit for bit; A's
    first token after the onload (the prefill behind the restored prefix,
    whose pages are gathered in table order) equals its first token from
    HBM; a decode step over the restored sharded pages agrees with one
    over the evicted bytes on one device (``restored_decode_check``). The
    later tokens are compared for information only: each decode step sums
    every shard's partial, and the restored pages lie on other shards than
    before, so the f32 sums run in another order and random bf16 weights
    give near-ties. Returns the gather and scatter launch counts."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.hashing import prefix_block_hashes
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    hbs = cfg.hash_block_size
    rng = np.random.default_rng(13)
    V = cfg.model.vocab_size
    prompt_a = rng.integers(3, V, size=8 * hbs).tolist()
    m = cfg.model
    blk = (m.num_layers * 2 * hbs * m.num_kv_heads * m.head_dim
           * torch.empty((), dtype=m.dtype).element_size())
    tcfg = replace(cfg, num_pages=136, kv_tier_dram_bytes=4 * blk,
                   kv_tier_ssd_bytes=16 * blk, kv_tier_threads=1)
    mesh = build_mesh(MeshConfig(seq=4), devices)
    eng = engine_mod.InferenceEngine(tcfg, params=params, mesh=mesh)
    store = eng.tier_store
    P_loc = eng.kv_pages.pages_per_shard
    assert store is not None and P_loc == 34
    log(f"  mesh seq=4 on {[str(d) for d in mesh.devices]}, {P_loc} pages a "
        "shard; DRAM arena 4 blocks, SSD file 16 blocks, one tier worker")
    hashes = [h.hex() for h in prefix_block_hashes(prompt_a, hbs)]
    reset_counts()
    eng.start()
    try:
        serve_one(eng, engine_mod, "A0", prompt_a)
        t_hbm = serve_one(eng, engine_mod, "A1", prompt_a)        # HBM hit
        before, spans = {}, []
        for h in hashes[:7]:
            pages = eng.page_mgr.match_block(h)
            spans.append(sorted({p // P_loc for p in pages}))
            before[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
            eng.page_mgr.release_prefix([h])
        serve_one(eng, engine_mod, "A-half",
                  prompt_a[:4 * hbs] + rng.integers(3, V, 100).tolist())
        t0 = time.monotonic()
        serve_one(eng, engine_mod, "U1", rng.integers(3, V, 8 * hbs).tolist())
        serve_one(eng, engine_mod, "U2", rng.integers(3, V, 8 * hbs).tolist())
        wait_for(lambda: all(store.ready(h) for h in hashes),
                 "A's blocks in the tiers")
        t_off = time.monotonic() - t0
        st0 = store.stats()
        tiers = [store.tier_of(h) for h in hashes]
        log(f"  A's blocks on shards {spans} (blocks 0-6); after eviction in "
            f"tiers {tiers}")
        t0 = time.monotonic()
        t_tier = serve_one(eng, engine_mod, "A2", prompt_a)      # tiers
        t_on = time.monotonic() - t0
        launches = (page_dma.gather_kv_pages.launches,
                    page_dma.scatter_kv_pages.launches, partial.launches)
        wait_for(lambda: not store._pending, "the tier pump settling")
        st = store.stats()
        ev = eng.drain_kv_events()
        after, spans, rows = {}, [], []
        for h in hashes:
            pages = eng.page_mgr.match_block(h)
            assert pages is not None, "an onloaded block is not in HBM"
            spans.append(sorted({p // P_loc for p in pages}))
            after[h] = page_dma.gather_kv_pages_plain(eng.kv_pages, pages)
            rows += pages
    finally:
        eng.stop()
    same = all(torch.equal(before[h].view(torch.int16),
                           after[h].view(torch.int16)) for h in before)
    restored_decode_check(llama, cfg, params, eng, rows,
                          [before[h] for h in hashes[:7]] + [after[hashes[7]]],
                          t_tier[0])
    del eng
    torch.cuda.empty_cache()
    agree = [a == b for a, b in zip(t_hbm, t_tier)]
    log(f"  restored on shards {spans}; tier stats {st}; events stored "
        f"{len(ev.stored)} offloaded {len(ev.offloaded)} removed "
        f"{len(ev.removed)}; launches gather/scatter/partial {launches}")
    log(f"  A's first token from HBM and from the tiers equal: "
        f"{t_hbm[0] == t_tier[0]}; restored pages bit-identical to the "
        f"evicted ones: {same}; decode tokens equal {sum(agree)}/{len(agree)}"
        f" (information only), first difference at "
        f"{agree.index(False) if not all(agree) else None}")
    mb = 1 << 20
    log(f"  offload {st0['bytes_offloaded'] / mb:.0f} MiB in {t_off:.2f} s "
        f"({st0['bytes_offloaded'] / mb / t_off:.0f} MiB/s, two 1024-token "
        f"requests included); onload {st['bytes_onloaded'] / mb:.0f} MiB "
        f"within A's second request of {t_on:.2f} s "
        f"({st['bytes_onloaded'] / mb / t_on:.0f} MiB/s, prefill and decode "
        f"included); information only, {card}")
    assert t_tier[0] == t_hbm[0], "the first token after the onload differs"
    assert same, "restored pages differ from the evicted ones"
    assert "dram" in tiers and "ssd" in tiers, "not both tiers were used"
    assert st["onload_total"] >= 7 and st["demote_total"] >= 1
    assert ev.offloaded, "no offloaded events were drained"
    assert launches[0] == st["offload_total"], \
        "not one gather launch per offloaded block"
    assert launches[1] > 0 and launches[2] > 0, "kernel 5 or 6 never ran"
    return launches[:2]


# --------------------------------------------------------------- phase 4e
def graph_step_check(engine_mod, cfg, params):
    """From one state at full width, the captured step's replay and the
    same step run op by op must agree bit for bit: the packed rows, the KV
    pool and the slot state, for greedy rows, seeded sampled rows and
    logprob rows, on both writeback routes. Every slot is busy (an idle
    slot's write to the garbage page races the others' in either run)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    B_ = cfg.max_batch_size
    gcfg = replace(cfg, num_pages=B_ * 24 + 8)
    rng = np.random.default_rng(5)
    V = cfg.model.vocab_size
    cases = [("default", False, False), ("default", False, True),
             ("default", True, True), ("fused", False, True)]
    for route, want_lp, sample in cases:
        if route == "fused":
            os.environ["XLLM_KV_WRITEBACK"] = "fused"
        try:
            eng = engine_mod.InferenceEngine(gcfg, params=params)
            for i in range(B_):
                sp = (dict(temperature=0.8, top_p=0.9, seed=100 + i)
                      if sample and i % 2 else dict(temperature=0.0))
                eng.submit(engine_mod.EngineRequest(
                    f"c{i}", token_ids=rng.integers(3, V, 200).tolist(),
                    sampling=SamplingParams(max_tokens=100, ignore_eos=True,
                                            logprobs=want_lp, **sp)))
            eng._admit()
            assert len(eng._running) == B_
            st = [eng._row, eng.kv_pages, eng._last, eng._clens,
                  eng._active, eng._st.token_counts]

            def restore(snap):
                for t_, v in zip(st, snap):
                    t_.copy_(v)
                for b, g in enumerate(eng._gens):
                    g.manual_seed(1000 + b)

            snap = [t_.clone() for t_ in st]
            restore(snap)
            eng._decode_step(want_lp, sample)
            eager = [t_.clone() for t_ in st]
            same = []
            # The first step of the variant (warm-up, capture, replay),
            # then a plain replay, each from the same state.
            for _ in range(2):
                restore(snap)
                eng._graphs.run(want_lp, sample)
                torch.cuda.synchronize()
                same.append([torch.equal(a.view(torch.uint8),
                                         b.view(torch.uint8))
                             if a.is_floating_point() else torch.equal(a, b)
                             for a, b in zip(eager, st)])
            toks = eager[0][:, 0].long().tolist()
            log(f"  {route}, logprobs {want_lp}, sampled rows {sample}: "
                f"eager == graphed bit for bit (row, pool, last, clens, "
                f"active, counts; first replay, second) {same}; tokens "
                f"{toks}")
            assert all(map(all, same)), \
                "the replayed step differs from the eager one"
            assert eng._graphs.captures == 1 and eng._graphs.replays == 2
            assert torch.equal(st[3], snap[3] + 1), "a row did not advance"
            eng.stop()
            del eng, st, snap, eager
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            os.environ.pop("XLLM_KV_WRITEBACK", None)


def twins_phase(params, card):
    """The two benchmark twins at Llama-3-8B on the card (the weights are
    the smoke's own, which are the twins' seed-0 weights)."""
    from xllm_service_tpu_torch import bench
    from xllm_service_tpu_torch.benchmarks import decode_profile

    os.environ["XLLM_BENCH_MODEL"] = "8b"
    try:
        t = time.monotonic()
        b = bench.run("cuda", params=params)
        log(f"  bench twin (8b, B {b['batch']}, ctx {b['ctx']}, horizon "
            f"{b['decode_horizon']}): {b['value']:.1f} tok/s, pct_roofline "
            f"{b['pct_roofline']:.2f}, {b['ms_per_token_step']:.3f} ms a "
            f"token-step, {time.monotonic() - t:.1f} s; {card}")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.monotonic()
        prof = decode_profile.run("cuda", params=params, iters=10,
                                  trace_steps=8)
        log(f"  profile twin (8b): full_step_ms eager "
            f"{prof['full_step_ms']:.3f}, graphed "
            f"{prof['full_step_graphed_ms']:.3f}; forward "
            f"{prof['forward_only_ms']:.3f}, attention "
            f"{prof['attention_only_ms']:.3f}, sampling "
            f"{prof['sampling_only_ms']:.3f}; ideal weight stream "
            f"{prof['ideal_weight_stream_ms']:.3f} ms; "
            f"{time.monotonic() - t:.1f} s; {card}")
        for name in ("trace", "trace_graphed"):
            tr = prof[name]
            log(f"  {name}: kernels/step {tr['kernels_per_step']}, busy "
                f"share {tr['busy_share']}, device busy ms/step "
                f"{tr['device_busy_ms_per_step']}, host ms/step "
                f"{tr['host_ms_per_step']:.3f} (/layer "
                f"{tr['host_ms_per_layer']:.4f}), matrix products' share "
                f"{tr['gemm_share_of_device_time']}")
        log(f"  engine loop per step (host, untraced): {prof['engine_loop']}")
        log("  bench " + json.dumps(b))
        log("  profile " + json.dumps(prof))
        assert b["value"] > 0 and b["tokens"] > 0
        assert prof["full_step_graphed_ms"] < prof["full_step_ms"], \
            "the graphed step is not faster than the eager one"
    finally:
        del os.environ["XLLM_BENCH_MODEL"]
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xllm_service_tpu_torch.common.device import card_line
    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.engine import engine as engine_mod
    from xllm_service_tpu_torch.models import llama
    from xllm_service_tpu_torch.models.base import llama3_8b_config
    from xllm_service_tpu_torch.ops import _build, page_dma
    from xllm_service_tpu_torch.ops import cp_paged_attention as cp
    from xllm_service_tpu_torch.ops.fused_decode_attention import (
        fused_decode_attention,
        fused_decode_attention_plain,
    )
    from xllm_service_tpu_torch.ops.mq_paged_attention import (
        mq_paged_attention,
        mq_paged_attention_plain,
    )
    from xllm_service_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_plain,
        split_count,
    )
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    KERNEL_WRAPPERS.extend([paged_attention, mq_paged_attention,
                            fused_decode_attention, page_dma.gather_kv_pages,
                            page_dma.scatter_kv_pages, cp.paged_partial])

    # Phase 1: environment.
    card = card_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {card} | "
        f"devices {torch.cuda.device_count()}")

    # Phase 2: build the five libraries in parallel.
    t = time.monotonic()
    logs = _build.build(verbose=True)
    log(f"[2] built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.monotonic() - t:.1f} s into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in ptxas_report(text):
            log(f"  {name}: {line}")
        for line in text.splitlines():
            if "Performance Loss" in line:       # e.g. serialized wgmma
                log(f"  {name}: {line.strip()[:200]}")

    # Phase 3: kernels against plain, and times.
    log("[3] kernels against their plain versions")
    k1 = check_decode_kernel(paged_attention, paged_attention_plain,
                             split_count, _build.kernel_fn)
    k2 = check_mq_kernel(mq_paged_attention, mq_paged_attention_plain,
                         _build.kernel_fn)
    k3 = check_fused_kernel(fused_decode_attention,
                            fused_decode_attention_plain, split_count,
                            _build.kernel_fn)
    k4, k5 = check_page_movers(page_dma, build_mesh, MeshConfig,
                               cp.ShardedPages)
    k6 = check_cp_kernel(cp, paged_attention, paged_attention_plain,
                         build_mesh, MeshConfig, _build.kernel_fn)

    # Phase 4: serving Llama-3-8B at full width and depth.
    log("[4] serving llama3-8b (32 layers, random weights, seed 0)")
    cfg = EngineConfig(model=llama3_8b_config(),
                       num_pages=2048, page_size=16, hash_block_size=128,
                       max_batch_size=8, max_seq_len=2048, decode_horizon=8,
                       admission_horizon=8, seed=0)
    t = time.monotonic()
    params = llama.init_params(cfg.model,
                               torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
    torch.cuda.synchronize()
    n_params = sum(t_.numel() for group in params.values()
                   for leaf in group.values()
                   for t_ in (leaf.values() if isinstance(leaf, dict)
                              else [leaf]))
    log(f"  weights: {n_params / 1e9:.2f} B parameters in "
        f"{time.monotonic() - t:.1f} s")
    rng = np.random.default_rng(0)
    V = cfg.model.vocab_size
    lens = [int(rng.integers(640, 1025))] + \
        [int(x) for x in rng.integers(64, 1025, size=7)]
    prompts = [rng.integers(3, V, size=n).tolist() for n in lens]
    shared = [prompts[0][:512] + rng.integers(3, V, size=int(n)).tolist()
              for n in rng.integers(64, 513, size=2)]
    sampled_prompt = rng.integers(3, V, size=200).tolist()

    runs = []
    for r in range(2):
        reset_counts()
        t = time.monotonic()
        toks, reasons, stats, ttft, tps = serve_once(
            engine_mod, cfg, params, prompts, shared, sampled_prompt)
        launches = (paged_attention.launches, mq_paged_attention.launches)
        log(f"  run {r}: {time.monotonic() - t:.1f} s, stats {stats}, "
            f"launches decode/mq {launches}")
        log(f"  run {r}: TTFT ms p50 {ttft[len(ttft) // 2]:.1f} max "
            f"{ttft[-1]:.1f}; {tps:.1f} generated tok/s over the run "
            f"(information only; {card})")
        for name, tk in toks.items():
            assert len(tk) == 64 and reasons[name] == "length", \
                f"{name}: {len(tk)} tokens, reason {reasons[name]!r}"
        assert stats["prefix_hits"] >= 2 and \
            stats["prefix_hit_tokens"] >= 2 * 512, "no prefix hits"
        assert launches[0] > 0 and launches[1] > 0, "a kernel never launched"
        check_replays(stats, f"run {r}")
        runs.append((toks, launches))
    assert runs[0][0] == runs[1][0], "two runs of the same batch differ"
    log("  both runs gave identical tokens for all 11 requests")
    check_logits(llama, cfg, params, shared[0], 512)

    # Phase 4a: KV tiers at full width.
    log("[4a] KV tiers: HBM -> DRAM -> SSD and back, llama3-8b")
    tier_launches = tier_phase(engine_mod, cfg, params, page_dma, card)

    # Phase 4b: the fused decode writeback.
    log("[4b] serving under XLLM_KV_WRITEBACK=fused")
    fused_toks, fused_launches = fused_phase(
        engine_mod, cfg, params, prompts, shared, sampled_prompt,
        (fused_decode_attention, paged_attention), llama)
    same = sum(fused_toks[n] == runs[0][0][n] for n in fused_toks)
    log(f"  fused vs default route: {same}/{len(fused_toks)} requests with "
        "identical tokens (information only: the two sum in another order)")

    # Phase 4c: context-parallel serving.
    log("[4c] context-parallel serving on a seq=4 mesh, llama3-8b")
    _, cp_launches = cp_phase(
        engine_mod, cfg, params, llama,
        (cp.paged_partial, paged_attention, mq_paged_attention,
         fused_decode_attention), card)

    # Phase 4d: KV tiers under the seq mesh.
    log("[4d] KV tiers on a seq=4 mesh: HBM -> DRAM -> SSD and back, "
        "llama3-8b")
    count = torch.cuda.device_count()
    tier_cp_phase(engine_mod, cfg, params, llama, page_dma, cp.paged_partial,
                  [torch.device("cuda", i % count) for i in range(4)], card)

    # Phase 4e: the decode step's host path.
    log("[4e] the captured decode step against the eager one; the bench "
        "and decode-profile twins, llama3-8b")
    graph_step_check(engine_mod, cfg, params)
    twins_phase(params, card)

    # Phase 5: the kernels line, the card line, the result.
    rows = []
    csrc = "xllm_service_tpu_torch/csrc/"
    for name, src, tpu, res, n in (
            ("paged_attention", csrc + "paged_attention.cu",
             "xllm_service_tpu/ops/pallas_paged_attention.py:107", k1,
             runs[0][1][0]),
            ("mq_paged_attention", csrc + "mq_paged_attention.cu",
             "xllm_service_tpu/ops/pallas_mq_paged_attention.py:100", k2,
             runs[0][1][1]),
            ("fused_decode_attention", csrc + "fused_decode_attention.cu",
             "xllm_service_tpu/ops/pallas_fused_decode_attention.py:158", k3,
             fused_launches[0]),
            ("gather_kv_pages", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:222", k4,
             tier_launches[0]),
            ("scatter_kv_pages", csrc + "page_dma.cu",
             "xllm_service_tpu/ops/pallas_page_dma.py:250", k5,
             tier_launches[1]),
            ("cp_paged_partial", csrc + "cp_paged_partial.cu",
             "xllm_service_tpu/ops/cp_paged_attention.py:179", k6,
             cp_launches["partial"])):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": n, **res})
    log(f"  total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
