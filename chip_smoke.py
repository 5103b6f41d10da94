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
   single-device attention, and timed against kernel 1); kernel 2 also at
   the speculative verify's shapes (B 8, Sq 5, block lengths 5, 1 and 0 in
   one call behind prefixes 256-1536, bf16 and f32), timed beside SDPA and
   the bound there and at a uniform context of 1024;
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
4f. serving through the agent: the port's ``EngineAgent`` on the card,
   with phase 4's engine configuration and weights, behind a stub master
   of the standard library here (it writes its address under
   ``XLLM:SERVICE:MASTER`` in the agent's in-process coordination store and
   takes ``/rpc/heartbeat`` and ``/rpc/generations`` as the reference master
   does). Phase 4's eleven requests are posted as enriched JSON dispatches
   on one kept-alive connection, in phase 4's order, then an ``n: 2`` seeded request, a logprob request,
   a request cancelled through ``/rpc/cancel`` after its first delta, a
   dispatch past its deadline (504) and an embeddings call; checks the
   registration, every request's deltas (``delta_seq`` 1..k, instance and
   incarnation, one ``finished`` with usage), the greedy and sampled tokens
   against phase 4's, the heartbeats (load, latency, KV events), the
   launches of kernels 1 and 2, the graph's replays, the embeddings
   against ``engine.embed``, and the first against plain f32 math (within
   4x the error of the same math in bf16). Information only: the host's
   split of phase 4 run 1 and of phase 4f (``StepClock``, ``CallClock``);
4g. the admission path at the same width and depth: kernel 2 at the chunk
   shapes (Sq 256 behind 0-1536 written tokens, Sq 1024 behind 0, 256 and
   1024, the 1100-token prompt's ragged ride of 76 rows behind 768 and its
   install behind 844) against its plain version, timed beside SDPA; the
   prefix-free prefill's SDPA route against the f32 path on a 2048-token
   prompt's shapes (valid rows, within 4x a bf16 control); one 1792-token
   prompt's first-token logits with its chunks riding mixed steps and as
   standalone chunks against the prompt installed whole; the mixed step's
   decode-row logits against ``decode_forward`` from one state, and
   unchanged bit for bit by the chunk; the captured mixed step against
   the same step op by op, bit for bit, at spans 256 and 1024; then six
   short requests decoding while two 1792-token prompts and one of 1100
   arrive, three times (chunks of 256 riding the decode steps,
   ``XLLM_SARATHI=0``, whole installs): rides happen, kernel 2 runs inside
   every captured mixed step, every request gets its budget, and the
   chunked runs' greedy streams equal the whole installs' but at a
   near-tie (the token taken at one of the two largest logit values,
   within TIE_STEPS bf16 steps of the top); an online request preempting
   an offline one on a 100-page pool (the offline stream equal to its
   unpreempted run up to the preemption in bf16, and in full in f32 at
   full width and 4 layers); and phase 4's eleven requests submitted at
   once (the burst's admission split, information);
4h. speculative decoding at the same width and depth (``speculate_k`` 4,
   ``speculate_cycles`` 4, batch 10): eight greedy requests on the
   reference spec bench's repetitive prompts (256 ids plus the request's
   index), a seeded sampled one and a logprob one, 128 new tokens each,
   served with speculation and without after a warm pass: every budget
   met, the spec path taken (a spy on ``_spec_multi``), a cycle accepting
   a draft, kernel 2 in every layer of the captured spec cycle, each
   greedy stream equal to the plain run's but at a near-tie (as in 4g);
   the same traffic in f32 at full width and 4 layers, every stream and
   logprob (1e-4) equal with and without speculation; the captured spec
   cycle against the same cycle op by op, bit for bit; the
   ``spec_bench`` twin (``bench_1b_config``). Tokens per cycle and tokens/s
   are information;
5. a ``kernels`` JSON line, the card line, and the result line.

It needs one card; without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
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
# Two routes' greedy streams may part at a near-tie that bf16 rounding
# breaks either way. A parting passes only where the token taken holds one
# of the reference's two largest logit values (bf16 values tie exactly) and
# trails its top by at most TIE_STEPS bf16 steps at max |logit| (a step is
# 2**-5 for logits in [4, 8)).
TIE_STEPS = 4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same source
F32_FLOPS = 67e12                # f32 outside the tensor cores, same source
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
    gathered dense. Timed here only: no kernel route of the port calls it
    (the port's one SDPA call is the prefix-free prefill, work that no
    Pallas kernel did, held against the f32 path in phase 4g)."""
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


VERIFY_SQ = 5                          # a verify block at speculate_k=4
VERIFY_BLOCKS = [5, 5, 1, 0, 5, 5, 1, 5]   # eligible, ineligible, idle rows
VERIFY_PREFIXES = [256, 512, 768, 1024, 1280, 1536, 384, 1152]


def check_mq_verify(mq_paged_attention, mq_paged_attention_plain):
    """Kernel 2 at the speculative verify's shapes (B 8, Sq 5, block
    lengths 5, 1 and 0 in one call, prefixes 256-1536), bf16 (the
    tensor-core route) and f32 (the walk), each against its plain version,
    and timed beside one masked SDPA call on the same K/V gathered dense
    and the bound; bf16 also at a uniform prefix of 1024, every block 5
    (kernel 1's timing context). Returns the timings by case."""
    out = {}
    for dtype, name, prefixes, blocks in (
            (torch.bfloat16, "mixed", VERIFY_PREFIXES, VERIFY_BLOCKS),
            (torch.float32, "mixed", VERIFY_PREFIXES, VERIFY_BLOCKS),
            (torch.bfloat16, "ctx 1024", [1024] * B, [VERIFY_SQ] * B)):
        ends = [p + b for p, b in zip(prefixes, blocks)]
        k, v, pt = paged_inputs(dtype, ends, seed=8)
        q = torch.randn((B, VERIFY_SQ, N_Q, HD), device="cuda").to(dtype)
        pre = torch.tensor(prefixes, dtype=torch.int32, device="cuda")
        blk = torch.tensor(blocks, dtype=torch.int32, device="cuda")
        got = mq_paged_attention(q, k, v, pt, pre, blk)
        want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "mq kernel: non-finite (verify)"
        e = (got.float() - want.float()).abs().max().item()
        for b_, n in enumerate(blocks):
            assert (got[b_, n:] == 0).all(), "a padding query is not zero"
        assert e <= TOL[dtype], "mq kernel disagrees with plain (verify)"
        T = max(ends)
        kd = gathered(k, pt, T).contiguous()
        vd = gathered(v, pt, T).contiguous()
        qd = q.transpose(1, 2).contiguous()
        s_idx = torch.arange(VERIFY_SQ, device="cuda")
        # Query s of row b sees keys <= prefix_b + s; a padding query sees
        # key 0 only (its output is dropped; an empty row would be NaN).
        hi = torch.where(s_idx[None, :] < blk[:, None],
                         pre[:, None] + s_idx[None, :], 0)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= hi[:, :, None])[:, None]
        ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
        plain_ms = time_ms(
            lambda: mq_paged_attention_plain(q, k, v, pt, pre, blk))
        lib = time_ms(lambda: sdpa(qd, kd, vd, mask))
        eb = q.element_size()
        nbytes = (2 * q.numel() * eb
                  + sum(e_ for e_, bl in zip(ends, blocks) if bl > 0)
                  * N_KV * HD * 2 * eb + B * MAX_PAGES * 4 + 2 * B * 4)
        ops = 4 * N_Q * HD * sum(bl * p + bl * (bl + 1) // 2
                                 for p, bl in zip(prefixes, blocks))
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / peak)
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak \
            else "operations"
        out[(str(dtype)[6:], name)] = dict(ms=ms, plain_ms=plain_ms,
                                           library_ms=lib, bound_ms=bound,
                                           bound_by=by, max_abs_err=e)
        log(f"  mq_paged_attention {str(dtype)[6:]} verify B={B} "
            f"Sq={VERIFY_SQ} ({name}: blocks {blocks}, prefixes "
            f"{min(prefixes)}-{max(prefixes)}): max_abs_err={e:.3g} (tol "
            f"{TOL[dtype]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound {bound:.4f} ms "
            f"({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), "
            f"{ms / bound:.1f}x the bound")
    return out


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
        self.times: list[float] = []     # arrival of each delta with tokens
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
        if any(s.token_ids for s in out.outputs):
            self.times.append(time.monotonic())
        if not self.first.is_set():
            self.t_first = time.monotonic()
            self.first.set()
        if out.finished:
            self.done.set()


class StepClock:
    """Where a serving run's wall time goes on the host (information only).
    Wraps one engine's ``submit``, ``_admit``, ``_start_sequence`` (one
    admission's prefix match and install dispatch, inside an admission
    pass, whose end waits once for the burst) and ``_decode``: the calls
    that did work, each with its wall time and the engine thread's CPU
    time (a call still running when the window closes counts up to then),
    the rest of the window as the loop's idle time, the time of the last
    submit, and the CPU time of the process outside the engine thread (the
    agent's, the stub master's and the driver's threads)."""

    def __init__(self, eng):
        self.eng = eng
        self.parts = {"admit": [0, 0.0, 0.0], "prefill": [0, 0.0, 0.0],
                      "decode": [0, 0.0, 0.0]}
        self.admit_walls: list[float] = []
        self.submits: list[float] = []
        self.lock = threading.Lock()
        self.closed = False
        self.inflight = None   # (part, wall at entry, thread CPU at entry)
        for part, name in (("admit", "_admit"), ("decode", "_decode"),
                           ("prefill", "_start_sequence")):
            setattr(eng, name, self._timed(getattr(eng, name), part))
        submit = eng.submit

        def timed_submit(req):
            self.submits.append(time.perf_counter())
            submit(req)

        eng.submit = timed_submit

    def _timed(self, fn, part):
        outer = part != "prefill"

        def wrapped(*args):
            w, c = time.perf_counter(), time.thread_time()
            if outer:
                self.inflight = (part, w, c)
            did = fn(*args)
            with self.lock:
                if outer:
                    self.inflight = None
                if did and not self.closed:
                    self._add(part, time.perf_counter() - w,
                              time.thread_time() - c)
            return did
        return wrapped

    def _add(self, part, wall, cpu):
        acc = self.parts[part]
        acc[0] += 1
        acc[1] += wall
        acc[2] += cpu
        if part == "admit":
            self.admit_walls.append(wall * 1e3)

    def _engine_cpu(self) -> float:
        return time.clock_gettime(
            time.pthread_getcpuclockid(self.eng._thread.ident))

    def begin(self) -> None:
        self.t0 = time.perf_counter()
        self.cpu0 = time.process_time()
        self.eng_cpu0 = self._engine_cpu()

    def end(self) -> dict:
        with self.lock:
            self.closed = True
            now, eng_now = time.perf_counter(), self._engine_cpu()
            if self.inflight is not None:
                part, w, c = self.inflight
                self._add(part, now - w, eng_now - c)
        wall = now - self.t0
        eng_cpu = eng_now - self.eng_cpu0
        out = {"wall_ms": wall * 1e3,
               "last_submit_ms": (max(self.submits) - self.t0) * 1e3,
               "engine_cpu_ms": eng_cpu * 1e3,
               "other_cpu_ms": (time.process_time() - self.cpu0 - eng_cpu)
               * 1e3,
               "admit_walls_ms": list(self.admit_walls)}
        for part, (n, w, c) in self.parts.items():
            out[part] = (n, w * 1e3, c * 1e3)
        out["idle_ms"] = wall * 1e3 - out["admit"][1] - out["decode"][1]
        return out

    @staticmethod
    def line(r: dict) -> str:
        return (f"wall {r['wall_ms']:.1f} ms, last submit at "
                f"+{r['last_submit_ms']:.1f} ms; admissions "
                f"{r['admit'][0]} calls {r['admit'][1]:.1f} ms wall ("
                + " + ".join(f"{w:.1f}" for w in r["admit_walls_ms"])
                + f") {r['admit'][2]:.1f} ms engine CPU, of which "
                f"{r['prefill'][0]} install dispatches {r['prefill'][1]:.1f} "
                f"ms wall; "
                f"decode {r['decode'][0]} calls {r['decode'][1]:.1f} ms "
                f"wall {r['decode'][2]:.1f} ms engine CPU; loop idle "
                f"{r['idle_ms']:.1f} ms; engine thread CPU "
                f"{r['engine_cpu_ms']:.1f} ms, other threads CPU "
                f"{r['other_cpu_ms']:.1f} ms")


def serve_once(engine_mod, cfg, params, prompts, shared, sampled_prompt,
               mesh=None, clocks=None):
    """One serving run on a fresh engine (on ``mesh`` if given) with its
    background loop. Returns (tokens per request, finish reasons, stats
    with the count of ring prefills, ttft ms, generated tokens/s over the
    run). With a ``clocks`` list, a ``StepClock`` summary of the run is
    appended to it."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params, mesh=mesh)
    clock = StepClock(eng) if clocks is not None else None
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    samp = SamplingParams(max_tokens=64, temperature=0.8, top_p=0.9,
                          seed=1234, ignore_eos=True)
    cols = {}
    t_sub = {}
    eng.start()
    try:
        t0 = time.monotonic()
        if clock is not None:
            clock.begin()

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
        if clock is not None:
            clocks.append(clock.end())
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


# --------------------------------------------------------------- phase 4f
class CallClock:
    """Calls, wall time and the calling thread's CPU time of one wrapped
    callable (information only). For a thread that does no blocking I/O
    in the call, wall minus CPU is time spent waiting for the GIL or a
    core."""

    def __init__(self, fn):
        self.fn = fn
        self.n, self.wall, self.cpu = 0, 0.0, 0.0
        self.lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        w, c = time.perf_counter(), time.thread_time()
        try:
            return self.fn(*args, **kwargs)
        finally:
            dw, dc = time.perf_counter() - w, time.thread_time() - c
            with self.lock:
                self.n += 1
                self.wall += dw
                self.cpu += dc

    def line(self, what: str) -> str:
        return (f"{what} {self.n} calls {self.wall * 1e3:.1f} ms wall "
                f"{self.cpu * 1e3:.1f} ms CPU")


def plain_embedding(params, mcfg, ids, dtype):
    """One row's embedding by plain tensor math in ``dtype``, weights cast
    one layer at a time: rotate-half rope, causal GQA attention through an
    explicit f32 softmax, SwiGLU, the final norm, the mean over the row.
    It shares no code with the port's forwards or attention ops."""
    dev = params["final_norm"]["scale"].device
    S, H, G, hd = len(ids), mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim

    def norm(x, w):
        x = x.float()
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + mcfg.rms_eps)
        return (x * w.float()).to(dtype)

    inv = 1.0 / mcfg.rope_theta ** (
        torch.arange(0, hd, 2, device=dev, dtype=torch.float64) / hd)
    ang = torch.arange(S, device=dev, dtype=torch.float64)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]

    def rope(t):
        a, b = t.float()[..., :hd // 2], t.float()[..., hd // 2:]
        return torch.cat([a * cos - b * sin, a * sin + b * cos], -1).to(dtype)

    x = params["embed"]["embedding"][torch.tensor(ids, device=dev)].to(dtype)
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for l in range(mcfg.num_layers):
        w = {name: next(iter(leaf.values()))[l].to(dtype)
             for name, leaf in params["layers"].items()}
        h = norm(x, w["input_norm"])
        q = rope((h @ w["q_proj"]).view(S, H, hd))
        k = rope((h @ w["k_proj"]).view(S, G, hd)).repeat_interleave(H // G, 1)
        v = (h @ w["v_proj"]).view(S, G, hd).repeat_interleave(H // G, 1)
        p = (torch.einsum("qhd,khd->hqk", q.float(), k.float()) * hd ** -0.5
             ).masked_fill(~causal, float("-inf")).softmax(-1)
        a = torch.einsum("hqk,khd->qhd", p, v.float()).to(dtype)
        x = x + a.reshape(S, H * hd) @ w["o_proj"]
        h = norm(x, w["post_attn_norm"])
        x = x + (torch.nn.functional.silu(h @ w["gate_proj"])
                 * (h @ w["up_proj"])) @ w["down_proj"]
    return norm(x, params["final_norm"]["scale"]).float().mean(0)


class StubMaster:
    """The master's two ingest routes on the standard library:
    ``/rpc/generations`` (deltas per request, in arrival order) and
    ``/rpc/heartbeat``, each answered ``{"ok": true, "alive": {...}}``."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.gens: dict[str, list] = {}
        self.first: dict[str, float] = {}
        self.posts = 0
        self.busy = [0, 0.0, 0.0]   # handled POSTs, wall s, thread CPU s
        self.heartbeats: list = []
        self.lock = threading.Lock()
        self.changed = threading.Condition(self.lock)
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # As the master's server: a reply written in two pieces must
            # not wait on Nagle for the ACK of the first.
            disable_nagle_algorithm = True

            def do_POST(self):
                w, c = time.perf_counter(), time.thread_time()
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n))
                with stub.changed:
                    if self.path == "/rpc/generations":
                        stub.posts += 1
                        for g in body["gens"]:
                            sid = g["service_request_id"]
                            stub.first.setdefault(sid, time.monotonic())
                            stub.gens.setdefault(sid, []).append(g)
                    else:
                        stub.heartbeats.append(body)
                    stub.changed.notify_all()
                data = json.dumps({"ok": True, "alive": {}}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                with stub.lock:
                    stub.busy[0] += 1
                    stub.busy[1] += time.perf_counter() - w
                    stub.busy[2] += time.thread_time() - c

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"

    def wait(self, pred, what, timeout=300.0):
        with self.changed:
            assert self.changed.wait_for(pred, timeout), f"timed out: {what}"

    def finished(self, sid):
        return any(g["finished"] for g in self.gens.get(sid, ()))

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class Poster:
    """POSTs JSON to one address on one kept-alive connection, as the
    master's client does: ``post(path, obj)`` -> (status, parsed reply)."""

    def __init__(self, addr):
        import http.client

        host, _, port = addr.rpartition(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=300)

    def __call__(self, path, obj):
        self.conn.request("POST", path, body=json.dumps(obj).encode(),
                          headers={"Content-Type": "application/json"})
        r = self.conn.getresponse()
        return r.status, json.loads(r.read())

    def close(self):
        self.conn.close()


def check_deltas(name, gens, agent):
    """Every delta of one request: delta_seq 1..k in order, stamped with
    the agent's instance and incarnation, exactly one finished (the last),
    carrying usage. Returns the token ids per choice."""
    assert gens, f"{name}: no deltas"
    assert [g["delta_seq"] for g in gens] == list(range(1, len(gens) + 1)), \
        f"{name}: delta_seq out of order"
    assert all(g["instance"] == agent.name
               and g["incarnation"] == agent.incarnation_id for g in gens), \
        f"{name}: unstamped delta"
    assert [g["finished"] for g in gens].count(True) == 1 \
        and gens[-1]["finished"] and "usage" in gens[-1], \
        f"{name}: not one finished delta with usage"
    toks: dict[int, list] = {}
    for g in gens:
        for o in g["outputs"]:
            toks.setdefault(o["index"], []).extend(o["token_ids"])
    return toks


def agent_phase(cfg, params, prompts, shared, sampled_prompt, phase4,
                kernels, card):
    """Phase 4's traffic through the agent's HTTP routes, then the
    agent-only requests. ``phase4`` = phase 4's runs, each (tokens per
    request, launches, tok/s, sorted TTFTs, ``StepClock`` summary); the
    first is the cold one. Returns the launches of kernels 1 and 2 in this
    phase."""
    from xllm_service_tpu_torch.common.types import InstanceMetaInfo, now_ms
    from xllm_service_tpu_torch.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
    from xllm_service_tpu_torch.rpc import MASTER_KEY, instance_key

    mcfg = cfg.model
    store = MemoryStore()
    master = StubMaster()
    InMemoryCoordination(store).set(MASTER_KEY, master.addr)
    agent = EngineAgent(cfg, AgentConfig(model_id="llama3-8b",
                                         heartbeat_interval_s=1.0),
                        coord=InMemoryCoordination(store), params=params,
                        device="cuda")
    greedy = dict(max_tokens=64, temperature=0.0, ignore_eos=True)
    samp = dict(max_tokens=64, temperature=0.8, top_p=0.9, seed=1234,
                ignore_eos=True)

    rtts: list[float] = []

    def dispatch(sid, toks, **sp):
        t_ = time.perf_counter()
        reply = post("/v1/completions", dict(
            service_request_id=sid, request_id=sid, token_ids=toks,
            source_service_addr=master.addr, **sp))
        rtts.append((time.perf_counter() - t_) * 1e3)
        return reply

    # Where the wall time of phase 4's traffic goes (information only).
    clock = StepClock(agent.engine)
    agent._route = routes = CallClock(agent._route)
    agent.streamer._send = sends = CallClock(agent.streamer._send)
    reset_counts()
    agent.start()
    post = Poster(agent.name)
    try:
        meta = InstanceMetaInfo.from_json(
            store.get(instance_key("MIX", agent.name)))
        assert meta.wire_formats == ["json"] and \
            (meta.num_layers, meta.num_kv_heads, meta.head_dim) == (
                mcfg.num_layers, mcfg.num_kv_heads, mcfg.head_dim), meta
        log(f"  registered {instance_key('MIX', agent.name)}: wire "
            f"{meta.wire_formats}, layers {meta.num_layers}, kv heads "
            f"{meta.num_kv_heads}, head dim {meta.head_dim}")
        with master.lock:
            master.busy = [0, 0.0, 0.0]
        t0 = time.monotonic()
        clock.begin()
        for i, p in enumerate(prompts):
            assert dispatch(f"g{i}", p, **greedy)[0] == 200
        assert dispatch("sampled", sampled_prompt, **samp)[0] == 200
        master.wait(lambda: "g0" in master.first, "request 0's first delta")
        for j, p in enumerate(shared):
            assert dispatch(f"s{j}", p, **greedy)[0] == 200
        names = [f"g{i}" for i in range(len(prompts))] + ["sampled"] + \
            [f"s{j}" for j in range(len(shared))]
        master.wait(lambda: all(map(master.finished, names)),
                    "phase 4's requests")
        wall = time.monotonic() - t0
        split = clock.end()
        log(f"  host split, phase 4's traffic through the agent: "
            f"{StepClock.line(split)}")
        log(f"  same split, phase 4 run 1: {StepClock.line(phase4[1][4])}")
        r_ = sorted(rtts)
        log(f"  dispatch POSTs {len(r_)} (one kept-alive connection): round "
            f"trip sum {sum(r_):.1f} ms, p50 {r_[len(r_) // 2]:.1f} max "
            f"{r_[-1]:.1f} ms; {routes.line('agent handlers')}; "
            f"{sends.line('streamer sends')}; stub master {master.busy[0]} "
            f"POSTs {master.busy[1] * 1e3:.1f} ms wall "
            f"{master.busy[2] * 1e3:.1f} ms CPU (information only)")
        toks = {n: check_deltas(n, master.gens[n], agent)[0] for n in names}
        tps = sum(map(len, toks.values())) / wall
        same = [n for n in names if toks[n] == phase4[0][0][n]]
        log(f"  phase 4's 11 requests through the agent: {len(same)}/"
            f"{len(names)} with phase 4's tokens")
        assert len(same) == len(names), \
            f"tokens differ from phase 4's: {sorted(set(names) - set(same))}"

        # The agent-only requests, together.
        assert dispatch("n2", sampled_prompt, max_tokens=16, temperature=0.8,
                        seed=7, n=2, ignore_eos=True)[0] == 200
        assert dispatch("lp", prompts[1], max_tokens=8, temperature=0.0,
                        logprobs=True, top_logprobs=2,
                        ignore_eos=True)[0] == 200
        assert dispatch("cancel", prompts[2], max_tokens=1024,
                        temperature=0.0, ignore_eos=True)[0] == 200
        status, reply = dispatch("late", prompts[3], max_tokens=8,
                                 deadline_ms=now_ms() - 1000)
        assert status == 504, (status, reply)
        master.wait(lambda: "cancel" in master.first, "the first delta")
        assert post("/rpc/cancel",
                         {"service_request_id": "cancel"})[0] == 200
        texts = ["the agent serves embeddings", "a second input, longer "
                 "than the first one by a few words"]
        status, emb = post("/v1/embeddings",
                                {"input": texts})
        assert status == 200, emb
        master.wait(lambda: all(map(master.finished, ("n2", "lp", "cancel"))),
                    "the agent-only requests")
        n2 = check_deltas("n2", master.gens["n2"], agent)
        assert sorted(n2) == [0, 1] and all(len(v) == 16 for v in n2.values())
        lp = master.gens["lp"]
        check_deltas("lp", lp, agent)
        rows = [r for g in lp for o in g["outputs"] for r in o["logprobs"]]
        assert len(rows) == 8 and all(len(r["top_logprobs"]) == 2
                                      for r in rows), "logprob rows"
        cancel = master.gens["cancel"]
        n_cancel = sum(len(o["token_ids"]) for g in cancel
                       for o in g["outputs"])
        assert cancel[-1]["finished"] and n_cancel < 1024, "not cancelled"
        assert "late" not in master.gens, "an expired dispatch streamed"
        vecs = np.asarray([d["embedding"] for d in emb["data"]], np.float32)
        want = agent.engine.embed([agent.engine.tokenizer.encode(t)
                                   for t in texts])
        emb_err = float(np.abs(vecs - want).max())
        assert vecs.shape == (2, mcfg.hidden_size) and \
            np.isfinite(vecs).all(), vecs.shape
        assert emb_err <= 1e-4, f"embeddings differ from engine.embed: " \
            f"{emb_err}"
        # An independent check of the bf16 embed forward: the first row
        # against plain f32 math, held within 4x the error of the same
        # plain math in bf16 (the control), plus 1e-3 of the row's largest
        # value so that a small control cannot fail it by chance.
        ids = agent.engine.tokenizer.encode(texts[0])
        ref = plain_embedding(params, mcfg, ids, torch.float32)
        ctl = plain_embedding(params, mcfg, ids, mcfg.dtype)
        got = torch.from_numpy(vecs[0]).to(ref.device)
        f32_err = float((got - ref).abs().max())
        ctl_err = float((ctl - ref).abs().max())
        scale = float(ref.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=0))
        log(f"  embedding row 0 ({len(ids)} tokens) vs plain f32 math: "
            f"max_abs_err {f32_err:.4g}, cosine {cos:.6f}; bf16 control "
            f"max_abs_err {ctl_err:.4g}; max|ref| {scale:.4g} (tol "
            f"4 x control + 1e-3 x max|ref|)")
        assert f32_err <= 4 * ctl_err + 1e-3 * scale, \
            f"embed forward off the plain f32 math: {f32_err}"
        log(f"  n 2 choices {sorted(n2)}; logprob rows {len(rows)}; "
            f"cancelled after {n_cancel} tokens (status "
            f"{cancel[-1]['status']}); expired dispatch 504; embeddings "
            f"{vecs.shape} vs engine.embed max_abs_err {emb_err:.3g} "
            f"(tol 1e-4)")

        # Heartbeats: load, latency and the 512-token prompts' KV events.
        master.wait(lambda: any(
            h["latency_metrics"]["recent_max_ttft"] > 0
            for h in master.heartbeats) and any(
            h["kv_cache_event"]["stored"] for h in master.heartbeats),
            "a heartbeat with latency and KV events", timeout=30)
        beats = list(master.heartbeats)
        assert all("load_metrics" in h and "latency_metrics" in h
                   and h["name"] == agent.name for h in beats)
        stats = agent.engine.stats()
        launches = (kernels[0].launches, kernels[1].launches)
        check_replays(stats, "4f")
        assert launches[0] > 0 and launches[1] > 0, \
            f"kernels 1/2 launches {launches}"
        spans = sorted(agent.ttft_spans)
        n_gens = sum(map(len, master.gens.values()))
        log(f"  launches decode/mq {launches}; stats {stats}")
        before = "; ".join(
            f"run {r}: TTFT p50 {t_[len(t_) // 2]:.1f} max {t_[-1]:.1f} ms, "
            f"{tps_:.1f} tok/s" for r, (_, _, tps_, t_, _) in enumerate(phase4))
        log(f"  agent-side TTFT (accept -> first delta) ms p50 "
            f"{spans[len(spans) // 2]:.1f} max {spans[-1]:.1f}; "
            f"{tps:.1f} generated tok/s through the agent (phase 4 {before}); "
            f"{n_gens / master.posts:.2f} deltas per "
            f"POST ({n_gens} in {master.posts}); {len(beats)} heartbeats, "
            f"max recent_max_ttft "
            f"{max(h['latency_metrics']['recent_max_ttft'] for h in beats):.1f}"
            f" ms, {sum(len(h['kv_cache_event']['stored']) for h in beats)} "
            f"stored blocks (information only; {card})")
        return launches
    finally:
        post.close()
        agent.stop()
        master.close()
        store.close()
        del agent
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4g
CHUNK = 256                  # phase 4g's prefill_chunk_tokens


def time_mq_chunk_shapes(mq_paged_attention, mq_paged_attention_plain):
    """Kernel 2 at the chunked path's shapes, bf16, one row, each held
    against its plain version and timed beside SDPA on the same K/V
    gathered dense (the times are information). (Sq, prefix, valid rows):
    a chunk of C behind 256-1536 written tokens; 4C (a pressure ride)
    behind 256 and 1024; the first chunk, C or 4C, at prefix 0 (the
    mixed step's route for every chunk); the 1100-token prompt's ragged
    ride (76 valid rows of C behind 768) and its install (C behind the
    unaligned prefix 844)."""
    for s_q, prefix, valid in ((CHUNK, 256, CHUNK), (CHUNK, 1024, CHUNK),
                               (CHUNK, 1536, CHUNK),
                               (4 * CHUNK, 256, 4 * CHUNK),
                               (4 * CHUNK, 1024, 4 * CHUNK),
                               (CHUNK, 0, CHUNK), (4 * CHUNK, 0, 4 * CHUNK),
                               (CHUNK, 768, 76), (CHUNK, 844, CHUNK)):
        k, v, pt = paged_inputs(torch.bfloat16, [prefix + valid], seed=7)
        q = torch.randn((1, s_q, N_Q, HD), device="cuda").to(torch.bfloat16)
        pre = torch.tensor([prefix], dtype=torch.int32, device="cuda")
        blk = torch.tensor([valid], dtype=torch.int32, device="cuda")
        got = mq_paged_attention(q, k, v, pt, pre, blk)
        want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16], (
            f"mq kernel disagrees with plain at Sq {s_q}, prefix {prefix}, "
            f"{valid} valid rows")
        T = prefix + valid
        kd = gathered(k, pt, T).contiguous()
        vd = gathered(v, pt, T).contiguous()
        qd = q[:, :valid].transpose(1, 2).contiguous()
        mask = (torch.arange(T, device="cuda")[None, :]
                <= prefix + torch.arange(valid, device="cuda")[:, None])
        ms = time_ms(lambda: mq_paged_attention(q, k, v, pt, pre, blk))
        lib = time_ms(lambda: sdpa(qd, kd, vd, mask))
        nbytes = 2 * q.numel() * 2 + T * N_KV * HD * 2 * 2 + (-(-T // PS)) * 4
        ops = 4 * N_Q * HD * (valid * prefix + valid * (valid + 1) // 2)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
        log(f"  mq_paged_attention bf16 Sq={s_q} prefix={prefix} valid="
            f"{valid}: kernel {ms:.4f} ms, sdpa {lib:.4f} ms "
            f"({ms / lib:.2f}x), bound {bound:.4f} ms, max_abs_err {err:.3g}")


def sdpa_route_check(attention):
    """The prefix-free prefill's card route (one causal SDPA call) against
    the f32 path (``dense_prefill_attention``) at one 2048-token prompt's
    shapes, bf16, two rows (valid lengths 2048 and 1100), on the valid
    rows (the padding rows' outputs are dropped by every caller).
    Tolerance: 4x the error of the same attention computed in bf16 (the
    products and the softmax in bf16, a control of bf16 rounding alone)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    S = 2048

    def rnd(heads):
        return torch.randn((2, S, heads, HD), generator=g,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rnd(N_Q), rnd(N_KV), rnd(N_KV)
    lens = torch.tensor([S, 1100], dtype=torch.int32, device="cuda")
    zero = torch.zeros((2,), dtype=torch.int32, device="cuda")
    got = attention.prefill_attention(q, k, v, None, None, None, zero, lens)
    want = attention.dense_prefill_attention(q, k, v, None, None, None, zero,
                                             lens)
    rep = N_Q // N_KV
    kk, vv = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    pos = torch.arange(S, device="cuda")
    s_ = torch.einsum("bqhd,bkhd->bhqk", q, kk) * (HD ** -0.5)
    s_ = s_.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    ctrl = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, dim=-1), vv)
    err = ctl = 0.0
    for b, n in enumerate(lens.tolist()):
        err = max(err, (got[b, :n].float() - want[b, :n].float())
                  .abs().max().item())
        ctl = max(ctl, (ctrl[b, :n].float() - want[b, :n].float())
                  .abs().max().item())
    ms = time_ms(lambda: attention.prefill_attention(q, k, v, None, None,
                                                     None, zero, lens))
    f32_ms = time_ms(lambda: attention.dense_prefill_attention(
        q, k, v, None, None, None, zero, lens), reps=5, warmup=1)
    log(f"  prefix-free prefill, SDPA route vs the f32 path (2 rows, S "
        f"{S}, lengths 2048/1100, valid rows): max_abs_err {err:.4g} (tol "
        f"4 x bf16 control {ctl:.4g}); {ms:.4f} ms against {f32_ms:.4f} ms")
    assert torch.isfinite(got).all(), "SDPA route: non-finite"
    assert err <= 4 * ctl, "the SDPA route disagrees with the f32 path"
    del s_, ctrl, want


def chunked_logits_check(llama, cfg, params, prompt):
    """One long prompt's first-token logits, its non-final chunks written
    as the engine writes them, against the same prompt installed whole
    (the SDPA route): (a) each chunk riding a mixed step beside eight idle
    decode rows (kernel 2 at every start, kernel 1 on the rows), (b) each
    as a standalone chunk (the first prefix-free, the later ones through
    kernel 2); the final chunk is an install behind its written prefix
    (kernel 2). Tolerance: PREFILL_REL_TOL of max |logit|, as phase 4's
    check_logits."""
    n = len(prompt)
    n_pages = -(-n // cfg.page_size)
    i32 = dict(dtype=torch.int32, device=params["final_norm"]["scale"].device)
    mcfg = cfg.model
    toks = torch.tensor([prompt], **i32)
    pt = torch.arange(1, n_pages + 1, **i32)[None]
    B_ = cfg.max_batch_size
    idle = torch.zeros((B_,), **i32)
    idle_pt = torch.zeros((B_, cfg.pages_per_seq), **i32)

    def pool():
        return empty_pool(cfg, n_pages + 1, i32["device"])

    def prefill(kv, lo, hi):
        return llama.prefill_forward(
            params, mcfg, toks[:, lo:hi], torch.arange(lo, hi, **i32)[None],
            kv, pt, torch.tensor([lo], **i32), torch.tensor([hi - lo], **i32),
            has_prefix=lo > 0)[0]

    whole = prefill(pool(), 0, n)
    last = (n - 1) // CHUNK * CHUNK
    routes = {}
    for name in ("riding", "standalone"):
        kv = pool()
        for lo in range(0, last, CHUNK):
            if name == "riding":
                llama.mixed_decode_chunk_forward(
                    params, mcfg, idle, idle - 1, toks[0, lo:lo + CHUNK],
                    torch.arange(lo, lo + CHUNK, **i32), kv, idle_pt, pt,
                    idle, torch.tensor([lo], **i32),
                    torch.tensor([CHUNK], **i32))
            else:
                prefill(kv, lo, lo + CHUNK)
        routes[name] = prefill(kv, last, n)
    scale = whole.abs().max().item()
    for name, got in routes.items():
        err = (whole - got).abs().max().item()
        log(f"  first-token logits, whole install vs {name} chunks of "
            f"{CHUNK} ({n} tokens): max_abs_err={err:.4g}, max|logit|="
            f"{scale:.4g} (tol {PREFILL_REL_TOL} x max|logit|), argmax "
            f"{int(whole.argmax())} vs {int(got.argmax())}")
        assert torch.isfinite(got).all(), name
        assert err <= PREFILL_REL_TOL * scale, f"{name} chunks drifted"


def mixed_rows_check(llama, cfg, params):
    """The mixed step's decode rows against ``decode_forward`` from one
    state at full width: eight decode rows (contexts 200-1500 tokens, the
    pool's K/V random) and one chunk of C at start 512 of its prompt.
    (a) With that chunk and with an empty one (``chunk_valid`` 0), the
    decode rows' logits and every page but the chunk's and the garbage
    page are equal bit for bit: the chunk reaches no decode row. (b) The
    decode rows' logits against ``decode_forward``'s, within
    PREFILL_REL_TOL of max |logit|: the two differ in the row count of
    every GEMM (B + C against B), so by bf16 rounding alone."""
    mcfg = cfg.model
    dev = params["final_norm"]["scale"].device
    i32 = dict(dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    B_, P_ = cfg.max_batch_size, cfg.pages_per_seq
    ctxs = [200, 333, 517, 700, 901, 1100, 1300, 1500][:B_]
    per_row = -(-max(ctxs) // cfg.page_size)
    chunk_pages = -(-(512 + CHUNK) // cfg.page_size)
    n_pages = 1 + B_ * per_row + chunk_pages
    base = torch.randn((mcfg.num_layers, 2, n_pages, mcfg.num_kv_heads,
                        cfg.page_size, mcfg.head_dim), generator=g,
                       device=dev).to(mcfg.dtype)
    dec_pt = torch.zeros((B_, P_), **i32)
    dec_pt[:, :per_row] = torch.arange(1, 1 + B_ * per_row,
                                       **i32).reshape(B_, per_row)
    chunk_pt = torch.zeros((1, P_), **i32)
    chunk_pt[0, :chunk_pages] = torch.arange(1 + B_ * per_row, n_pages, **i32)
    V = mcfg.vocab_size
    tok = torch.randint(3, V, (B_,), generator=g, device=dev).to(torch.int32)
    clens = torch.tensor(ctxs, **i32)
    chunk_tok = torch.randint(3, V, (CHUNK,), generator=g,
                              device=dev).to(torch.int32)
    chunk_pos = torch.arange(512, 512 + CHUNK, **i32)
    start = torch.tensor([512], **i32)

    def mixed(valid):
        kv = base.clone()
        logits = llama.mixed_decode_chunk_forward(
            params, mcfg, tok, clens - 1, chunk_tok, chunk_pos, kv, dec_pt,
            chunk_pt, clens, start, torch.tensor([valid], **i32))[0]
        return logits, kv

    with_chunk, kv_c = mixed(CHUNK)
    empty, kv_e = mixed(0)
    decode = llama.decode_forward(params, mcfg, tok, clens - 1, base.clone(),
                                  dec_pt, clens)[0]
    rows = 1 + B_ * per_row
    same_logits = torch.equal(with_chunk, empty)
    same_pages = torch.equal(kv_c[:, :, 1:rows].view(torch.int16),
                             kv_e[:, :, 1:rows].view(torch.int16))
    scale = decode.abs().max().item()
    err = (with_chunk - decode).abs().max().item()
    log(f"  mixed step's decode rows (contexts {ctxs}, a chunk of {CHUNK} "
        f"at 512): with the chunk == with an empty one bit for bit: logits "
        f"{same_logits}, decode rows' pages {same_pages}; against "
        f"decode_forward max_abs_err={err:.4g}, max|logit|={scale:.4g} (tol "
        f"{PREFILL_REL_TOL} x max|logit|), argmax equal "
        f"{int((with_chunk.argmax(-1) == decode.argmax(-1)).sum())}/{B_}")
    assert same_logits and same_pages, "the chunk reached a decode row"
    assert torch.isfinite(with_chunk).all(), "mixed step: non-finite"
    assert err <= PREFILL_REL_TOL * scale, \
        "the mixed step's decode rows disagree with decode_forward"
    del base, kv_c, kv_e
    gc.collect()
    torch.cuda.empty_cache()


def empty_pool(cfg, n_pages, device):
    """A zeroed KV pool of ``n_pages`` pages for ``cfg``'s model."""
    m = cfg.model
    return torch.zeros((m.num_layers, 2, n_pages, m.num_kv_heads,
                        cfg.page_size, m.head_dim), dtype=m.dtype,
                       device=device)


def next_token_logits(llama, cfg, params, context):
    """The logits of the token after ``context``, installed whole."""
    n = len(context)
    n_pages = -(-n // cfg.page_size)
    i32 = dict(dtype=torch.int32, device=params["final_norm"]["scale"].device)
    kv = empty_pool(cfg, n_pages + 1, i32["device"])
    return llama.prefill_forward(
        params, cfg.model, torch.tensor([context], **i32),
        torch.arange(n, **i32)[None], kv,
        torch.arange(1, n_pages + 1, **i32)[None],
        torch.zeros((1,), **i32), torch.tensor([n], **i32),
        has_prefix=False)[0][0]


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def compare_streams(llama, cfg, params, prompts, got, want, what):
    """Greedy streams ``got`` against ``want`` (name -> tokens). At the
    first difference the logits after the shared context (installed
    whole) must show a near-tie: the token taken holds one of their two
    largest values and trails the top by at most TIE_STEPS bf16 steps at
    max |logit|. Logs each parting; returns how many streams parted."""
    diverged = 0
    for name, w in want.items():
        g = got[name]
        assert len(g) == len(w), f"{what}: {name} length {len(g)}"
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            continue
        diverged += 1
        logits = next_token_logits(llama, cfg, params, prompts[name] + w[:i])
        # bf16 logits tie exactly, so rank the distinct values.
        values = torch.unique(logits)
        took = logits[g[i]]
        rank = int((values > took).sum()) + 1
        gap = (values[-1] - took).item()
        tol = TIE_STEPS * bf16_step(logits.abs().max().item())
        log(f"  {what}: {name} parts at token {i}: took {g[i]} (value rank "
            f"{rank} there, {int((logits == took).sum())} token(s) at that "
            f"value), {gap:.4g} below the top (tol {TIE_STEPS} bf16 steps "
            f"= {tol:.4g})")
        assert rank <= 2 and gap <= tol, \
            f"{what}: {name} parts at a decided token"
    log(f"  {what}: {len(want) - diverged}/{len(want)} streams identical")
    return diverged


def admission_run(engine_mod, cfg, params, passes, chunk, sarathi, kernels):
    """``passes`` = [(shorts, longs), ...] served one after the other on
    one engine: six short greedy requests (128 new tokens) decoding, then
    the long prompts (16 new tokens each) arriving at once. The first pass
    warms the engine (its mixed-step captures, first-use costs); the last
    is the measured one: the counts are set to 0 before its shorts are
    submitted and read after its last request ends. Returns a dict of the
    last pass: tokens per request, the longs' TTFT ms, the shorts' largest
    gap between deltas while the longs install, rides and standalone
    chunks, kernel launches (``kernels`` order), and the engine's
    mixed-step graph variants with their launches per replay."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    rcfg = replace(cfg, prefill_chunk_tokens=chunk, max_concurrent_prefills=2)
    os.environ["XLLM_SARATHI"] = "1" if sarathi else "0"
    try:
        eng = engine_mod.InferenceEngine(rcfg, params=params)
    finally:
        del os.environ["XLLM_SARATHI"]
    chunks = [0]
    prefill_chunk = eng._prefill_chunk

    def counted(*args):
        chunks[0] += 1
        return prefill_chunk(*args)

    eng._prefill_chunk = counted

    def serve(shorts, longs):
        cols, t_sub = {}, {}

        def submit(name, toks, n):
            cols[name] = Collector()
            t_sub[name] = time.monotonic()
            eng.submit(engine_mod.EngineRequest(
                name, token_ids=toks, on_output=cols[name],
                sampling=SamplingParams(max_tokens=n, temperature=0.0,
                                        ignore_eos=True)))

        for name, toks in shorts.items():
            submit(name, toks, 128)
        for name in shorts:
            assert cols[name].first.wait(600), f"{name} never started"
        t_long = time.monotonic()
        for name, toks in longs.items():
            submit(name, toks, 16)
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        return cols, t_sub, t_long

    eng.start()
    try:
        for i, (shorts, longs) in enumerate(passes):
            if i == len(passes) - 1:
                reset_counts()
                rides0, chunks[0] = eng.sarathi_rides, 0
            cols, t_sub, t_long = serve(shorts, longs)
        launches = tuple(fn.launches for fn in kernels)
    finally:
        eng.stop()
    t_end = max(cols[n].t_first for n in longs)
    gaps = []
    for name in shorts:
        ts = [t for t in cols[name].times if t_long <= t <= t_end]
        before = [t for t in cols[name].times if t < t_long]
        ts = before[-1:] + ts
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    mixed = {key: deltas for key, (_, deltas) in eng._graphs._graphs.items()
             if len(key) == 3}
    out = dict(tokens={n: c.tokens for n, c in cols.items()},
               reasons={n: c.reason for n, c in cols.items()},
               ttft={n: (cols[n].t_first - t_sub[n]) * 1e3 for n in longs},
               gap_ms=max(gaps, default=0.0) * 1e3,
               rides=eng.sarathi_rides - rides0, chunks=chunks[0],
               launches=launches, mixed=mixed)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def preemption_phase(engine_mod, llama, cfg, params, rng, card):
    """An engine with 100 pages: an offline request (512-token prompt, 128
    new tokens: 40 pages) runs; an online one (1024 + 16: 65 pages) finds
    59 free and preempts it; the offline request resumes as a continuation
    once the online one is done. Checks the preemption and the offline
    output against an unpreempted run of the same request: at the phase's
    model in bf16, equal up to the preemption (the same work); in f32, at
    full width and 4 layers, equal in full (lossless resume). In bf16 the
    continuation's prefill of its emitted tokens rounds their K/V
    otherwise than the decode steps that wrote them, and the streams part
    at the next near-tie (information); in f32 that difference is far
    below any logit gap."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    V = cfg.model.vocab_size
    off_prompt = rng.integers(3, V, size=512).tolist()
    on_prompt = rng.integers(3, V, size=1024).tolist()

    def run(rcfg, rparams, num_pages, with_online):
        eng = engine_mod.InferenceEngine(replace(rcfg, num_pages=num_pages),
                                         params=rparams)
        off, on = Collector(), Collector()
        resumed_at = []
        preempt = eng._preempt_one_offline

        def recorded_preempt():
            # The continuation is queued last; it carries the tokens known
            # at the preemption.
            done = preempt()
            if done:
                with eng._lock:
                    resumed_at.append(len(eng._waiting[-1].resume_output_ids))
            return done

        eng._preempt_one_offline = recorded_preempt
        eng.start()
        try:
            eng.submit(engine_mod.EngineRequest(
                "off", token_ids=off_prompt, offline=True, on_output=off,
                sampling=SamplingParams(max_tokens=128, temperature=0.0,
                                        ignore_eos=True)))
            if with_online:
                wait_for(lambda: len(off.tokens) >= 16, "offline tokens")
                eng.submit(engine_mod.EngineRequest(
                    "on", token_ids=on_prompt, on_output=on,
                    sampling=SamplingParams(max_tokens=16, temperature=0.0,
                                            ignore_eos=True)))
                assert on.done.wait(600), "online request never finished"
            assert off.done.wait(600), "offline request never finished"
        finally:
            eng.stop()
        out = (off.tokens, on.tokens, off.reason, eng.preemption_count,
               resumed_at)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return out

    f32 = replace(cfg, model=replace(cfg.model, dtype=torch.float32,
                                     num_layers=4))
    f32_params = llama.init_params(
        f32.model, torch.Generator(device="cuda").manual_seed(5))
    for name, rcfg, rparams in (("bf16", cfg, params),
                                ("f32, 4 layers", f32, f32_params)):
        t = time.monotonic()
        off_tok, on_tok, reason, preempted, resumed_at = run(
            rcfg, rparams, 100, True)
        alone = run(rcfg, rparams, cfg.num_pages, False)[0]
        parts = next((i for i, (a, b) in enumerate(zip(off_tok, alone))
                      if a != b), None)
        log(f"  preemption, {name}: {preempted} preemption(s), resumed "
            f"after {resumed_at} tokens; offline {len(off_tok)} tokens "
            f"({reason}, {len(set(off_tok))} distinct), online "
            f"{len(on_tok)}; against the unpreempted run: first difference "
            f"at {parts}; {time.monotonic() - t:.1f} s; {card}")
        assert preempted >= 1, f"{name}: the online request preempted nothing"
        assert len(on_tok) == 16 and len(off_tok) == 128 \
            and reason == "length", name
        assert off_tok[:resumed_at[0]] == alone[:resumed_at[0]], \
            f"{name}: the tokens before the preemption differ"
        if rcfg is f32:
            assert off_tok == alone, f"{name}: the resumed stream differs"
    del f32_params
    gc.collect()
    torch.cuda.empty_cache()
    return preempted


def mixed_graph_check(engine_mod, cfg, params):
    """From one state at full width, the captured mixed step's replay and
    the same step run op by op must agree bit for bit (packed row, KV
    pool, slot state): eight busy slots and one prompt chunk-prefilling,
    for each span (C and 4C)."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    B_ = cfg.max_batch_size
    rng = np.random.default_rng(9)
    V = cfg.model.vocab_size
    gcfg = replace(cfg, num_pages=512, prefill_chunk_tokens=CHUNK,
                   max_batch_size=B_ + 1)
    eng = engine_mod.InferenceEngine(gcfg, params=params)
    greedy = SamplingParams(max_tokens=100, temperature=0.0, ignore_eos=True)
    for i in range(B_):
        eng.submit(engine_mod.EngineRequest(
            f"c{i}", token_ids=rng.integers(3, V, 200).tolist(),
            sampling=greedy))
    eng._admit()
    assert len(eng._running) == B_
    for span_chunks in (1, 4):
        eng.submit(engine_mod.EngineRequest(
            f"long{span_chunks}",
            token_ids=rng.integers(3, V, 6 * CHUNK).tolist(),
            sampling=greedy))
        eng._admit()
        if span_chunks == 4:
            eng.submit(engine_mod.EngineRequest(       # queue pressure
                "waiting", token_ids=[5, 6, 7], sampling=greedy))
        assert eng._prefillings
        span = eng._ride_chunk_args()
        assert span == span_chunks * CHUNK, span
        st = [eng._row, eng.kv_pages, eng._last, eng._clens, eng._active,
              eng._st.token_counts]
        snap = [t_.clone() for t_ in st]
        eng._decode_step(False, False, span)
        eager = [t_.clone() for t_ in st]
        for t_, v in zip(st, snap):
            t_.copy_(v)
        eng._graphs.run(False, False, span)
        torch.cuda.synchronize()
        same = [torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                if a.is_floating_point() else torch.equal(a, b)
                for a, b in zip(eager, st)]
        log(f"  mixed step, span {span}: eager == graphed bit for bit "
            f"(row, pool, last, clens, active, counts) {same}")
        assert all(same), "the replayed mixed step differs from the eager one"
        with eng._lock:
            eng._waiting.clear()
        eng.cancel(f"long{span_chunks}")
        eng._process_cancellations()
    eng.stop()
    del eng, st, snap, eager
    gc.collect()
    torch.cuda.empty_cache()


def admission_phase(engine_mod, llama, attention, cfg, params, prompts,
                    shared, sampled_prompt, phase4_clock, paged_attention,
                    mq, mq_plain, card):
    """Phase 4g: the admission path at Llama-3-8B. Returns the launches of
    kernels 1 and 2 in the chunked run with rides (the path's main run)."""
    time_mq_chunk_shapes(mq, mq_plain)
    sdpa_route_check(attention)
    rng = np.random.default_rng(4)
    V = cfg.model.vocab_size
    chunked_logits_check(llama, cfg, params,
                         rng.integers(3, V, size=1792).tolist())
    mixed_rows_check(llama, cfg, params)
    mixed_graph_check(engine_mod, cfg, params)

    # Two sets of prompts of the same lengths: the first warms each engine
    # (distinct tokens, so the second misses the prefix cache), the second
    # is measured and checked.
    passes = [({f"short{i}": rng.integers(3, V, size=128).tolist()
                for i in range(6)},
               {f"long{i}": rng.integers(3, V, size=n).tolist()
                for i, n in enumerate((1792, 1792, 1100))})
              for _ in range(2)]
    prompts_4g = {**passes[-1][0], **passes[-1][1]}
    counters = (paged_attention, mq)
    runs = {}
    for name, chunk, sarathi in (("chunked, rides", CHUNK, True),
                                 ("chunked, XLLM_SARATHI=0", CHUNK, False),
                                 ("whole installs", 0, True)):
        t = time.monotonic()
        r = runs[name] = admission_run(engine_mod, cfg, params, passes,
                                       chunk, sarathi, counters)
        for n, tk in r["tokens"].items():
            want = 16 if n.startswith("long") else 128
            assert len(tk) == want and r["reasons"][n] == "length", \
                f"{name}: {n}: {len(tk)} tokens, reason {r['reasons'][n]!r}"
        log(f"  {name} (warm pass, then this one): "
            f"{time.monotonic() - t:.1f} s; longs' TTFT ms "
            + ", ".join(f"{v:.1f}" for v in r["ttft"].values())
            + f"; shorts' largest inter-token gap while they install "
            f"{r['gap_ms']:.1f} ms; rides {r['rides']}, standalone chunks "
            f"{r['chunks']}; launches kernel 1 / kernel 2 {r['launches']}; "
            f"mixed-step variants {sorted(r['mixed'])} (information only; "
            f"{card})")
    main = runs["chunked, rides"]
    assert main["rides"] > 0, "no chunk rode a decode step"
    assert runs["chunked, XLLM_SARATHI=0"]["rides"] == 0
    assert runs["whole installs"]["chunks"] == 0
    assert main["mixed"], "no mixed step was captured"
    for key, deltas in main["mixed"].items():
        per_replay = dict((fn.__name__, n) for fn, n in deltas)
        assert per_replay.get("mq_paged_attention", 0) == \
            cfg.model.num_layers, f"kernel 2 not in the mixed step {key}"
    assert main["launches"][1] >= main["rides"] * cfg.model.num_layers
    for name in ("chunked, rides", "chunked, XLLM_SARATHI=0"):
        compare_streams(llama, cfg, params, prompts_4g,
                        runs[name]["tokens"],
                        runs["whole installs"]["tokens"],
                        f"{name} vs whole installs")

    log("  preemption at llama3-8b")
    preemption_phase(engine_mod, llama, cfg, params, rng, card)

    # The burst: phase 4's eleven requests submitted at once.
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params)
    clock = StepClock(eng)
    cols = {}
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    samp = SamplingParams(max_tokens=64, temperature=0.8, top_p=0.9,
                          seed=1234, ignore_eos=True)
    reqs = ([(f"g{i}", p, greedy) for i, p in enumerate(prompts)]
            + [("sampled", sampled_prompt, samp)]
            + [(f"s{j}", p, greedy) for j, p in enumerate(shared)])
    eng.start()
    try:
        clock.begin()
        for name, toks, sp in reqs:
            cols[name] = Collector()
            eng.submit(engine_mod.EngineRequest(name, token_ids=toks,
                                                sampling=sp,
                                                on_output=cols[name]))
        for name, c in cols.items():
            assert c.done.wait(900), f"{name} never finished"
        split = clock.end()
    finally:
        eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    assert all(len(c.tokens) == 64 for c in cols.values())
    log(f"  the burst (11 requests at once), host split: "
        f"{StepClock.line(split)}")
    log(f"  phase 4 run 1 (9 at once, then 2), admissions ms: "
        + " + ".join(f"{w:.1f}" for w in phase4_clock["admit_walls_ms"])
        + f"; the burst's: "
        + " + ".join(f"{w:.1f}" for w in split["admit_walls_ms"])
        + f" (information only; {card})")
    return main["launches"]


# --------------------------------------------------------------- phase 4h
SPEC_UNIT = list(range(11, 19))     # the reference spec bench's id unit
SPEC_NEW = 128                      # new tokens per phase 4h request


class LpCollector(Collector):
    """A Collector that also keeps each token's (id, logprob)."""

    def __init__(self):
        super().__init__()
        self.logprobs: list[tuple[int, float]] = []

    def __call__(self, out) -> None:
        super().__call__(out)
        for s in out.outputs:
            self.logprobs.extend((lp.token_id, lp.logprob)
                                 for lp in (s.logprobs or []))


def spec_requests(unit):
    """Phase 4h's traffic: eight greedy requests on the reference spec
    bench's repetitive prompts (``unit`` repeated to 256 ids, plus the
    request's index), a seeded sampled request and a logprob request on
    prompts of the same kind. Returns {name: (prompt, sampling fields)}."""
    body = (unit * (256 // len(unit)))[:256]
    reqs = {f"g{i}": (body + [i], dict(temperature=0.0)) for i in range(8)}
    reqs["sampled"] = (body + [8], dict(temperature=0.8, top_p=0.9,
                                        seed=4321))
    reqs["logprobs"] = (body + [9], dict(temperature=0.0, logprobs=True,
                                         top_logprobs=5))
    return reqs


def spec_serve(engine_mod, cfg, params, passes, kernels,
               max_tokens=SPEC_NEW):
    """Serve each request set of ``passes`` (``max_tokens`` each) to the
    end, one after the other, on one engine with its loop; the last pass
    is measured (the counts set to 0 just before its submits, read after
    its last request ends; earlier passes take the captures and first
    uses). Returns the last pass's tokens, finish reasons, logprobs,
    generated tokens/s over the pass and over the greedy requests' window
    (their tokens until the last of them ends: the sampled and logprob
    streams emit one token a cycle, so they bound the pass either way),
    spec calls (a spy on ``_spec_multi``, as the reference's tests),
    tokens emitted per cycle per request (from the drained rows), the
    launches of ``kernels`` and the engine's captured spec variants with
    their launches per replay."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params)
    calls, per_cycle = [0], {}
    spec_multi, drain_one = eng._spec_multi, eng._drain_one_spec

    def counted(*args):
        calls[0] += 1
        return spec_multi(*args)

    def drained(pend):
        drain_one(pend)
        rows, _, _, snapshot = pend
        out = rows.numpy()
        for slot, seq in snapshot.items():
            per_cycle.setdefault(seq.req.service_request_id, []).extend(
                int(n) for n in out[:, slot, 0] if n > 0)

    eng._spec_multi, eng._drain_one_spec = counted, drained
    eng.start()
    try:
        for i, reqs in enumerate(passes):
            if i == len(passes) - 1:
                reset_counts()
                calls[0] = 0
                per_cycle.clear()
                t0 = time.monotonic()
            cols = {}
            for name, (prompt, sp) in reqs.items():
                cols[name] = LpCollector()
                eng.submit(engine_mod.EngineRequest(
                    name, token_ids=prompt, on_output=cols[name],
                    sampling=SamplingParams(max_tokens=max_tokens,
                                            ignore_eos=True, **sp)))
            for name, c in cols.items():
                assert c.done.wait(900), f"{name} never finished"
        wall = time.monotonic() - t0
        launches = tuple(fn.launches for fn in kernels)
    finally:
        eng.stop()
    graphs = {} if eng._graphs is None else {
        key: dict((fn.__name__, n) for fn, n in deltas)
        for key, (_, deltas) in eng._graphs._graphs.items()
        if key[0] == "spec"}
    greedy = [c for n, c in cols.items() if n.startswith("g")]
    out = dict(tokens={n: c.tokens for n, c in cols.items()},
               reasons={n: c.reason for n, c in cols.items()},
               logprobs={n: c.logprobs for n, c in cols.items()},
               tps=sum(len(c.tokens) for c in cols.values()) / wall,
               greedy_tps=sum(len(c.tokens) for c in greedy)
               / (max(c.times[-1] for c in greedy) - t0),
               calls=calls[0], per_cycle=per_cycle, launches=launches,
               graphs=graphs)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_graph_check(engine_mod, cfg, params):
    """From one state at full width, the captured spec cycle's replay and
    the same cycle run op by op must agree bit for bit (packed row, KV
    pool, slot state, history, room), for a greedy-only variant and one
    with sampled and logprob rows; phase 4h's ten requests admitted."""
    from dataclasses import replace

    from xllm_service_tpu_torch.common.request import SamplingParams

    reqs = spec_requests(SPEC_UNIT)
    gcfg = replace(cfg, num_pages=512)
    for want_lp, sample in ((False, False), (True, True)):
        eng = engine_mod.InferenceEngine(gcfg, params=params)
        for name, (prompt, sp) in reqs.items():
            eng.submit(engine_mod.EngineRequest(
                name, token_ids=prompt, sampling=SamplingParams(
                    max_tokens=100, ignore_eos=True, **sp)))
        eng._admit()
        assert len(eng._running) == len(reqs)
        eng._room.fill_(60)
        st = [eng._srow, eng.kv_pages, eng._last, eng._clens, eng._active,
              eng._st.token_counts, eng._hist_buf, eng._room]

        def restore(snap):
            for t_, v in zip(st, snap):
                t_.copy_(v)
            for b, g in enumerate(eng._gens):
                g.manual_seed(1000 + b)

        snap = [t_.clone() for t_ in st]
        restore(snap)
        eng._spec_cycle(want_lp, sample)
        eager = [t_.clone() for t_ in st]
        same = []
        for _ in range(2):        # the first use (capture), then a replay
            restore(snap)
            eng._graphs.run("spec", want_lp, sample)
            torch.cuda.synchronize()
            same.append([torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                         if a.is_floating_point() else torch.equal(a, b)
                         for a, b in zip(eager, st)])
        emitted = eager[0][:, 0].long().tolist()
        log(f"  spec cycle, logprobs {want_lp}, sampled rows {sample}: "
            f"eager == graphed bit for bit (row, pool, last, clens, active, "
            f"counts, history, room; first use, replay) {same}; tokens "
            f"emitted per slot {emitted}")
        assert all(map(all, same)), \
            "the replayed spec cycle differs from the eager one"
        eng.stop()
        del eng, st, snap, eager
        gc.collect()
        torch.cuda.empty_cache()


def spec_phase(engine_mod, llama, cfg, params, kernels, card):
    """Phase 4h: speculative decoding at Llama-3-8B. Returns the launches
    of ``kernels`` in the measured speculative run (the path's main run)."""
    from dataclasses import replace

    L = cfg.model.num_layers
    scfg = replace(cfg, max_batch_size=10, speculate_k=4, speculate_cycles=4)
    pcfg = replace(cfg, max_batch_size=10)
    warm, reqs = spec_requests(list(range(21, 29))), spec_requests(SPEC_UNIT)
    prompts = {n: p for n, (p, _) in reqs.items()}

    # (a) Serving, bf16, speculation on and off, each after a warm pass.
    runs = {}
    for name, rcfg in (("speculate_k=4", scfg), ("plain", pcfg)):
        t = time.monotonic()
        r = runs[name] = spec_serve(engine_mod, rcfg, params, [warm, reqs],
                                    kernels)
        for n, tk in r["tokens"].items():
            assert len(tk) == SPEC_NEW and r["reasons"][n] == "length", \
                f"{name}: {n}: {len(tk)} tokens, reason {r['reasons'][n]!r}"
        log(f"  {name} (warm pass, then this one): {r['tps']:.1f} generated "
            f"tok/s over the pass, {r['greedy_tps']:.1f} over the greedy "
            f"requests' window, spec calls {r['calls']}, launches kernel "
            f"1 / kernel 2 {r['launches']}, {time.monotonic() - t:.1f} s "
            f"(information only; {card})")
    spec, plain = runs["speculate_k=4"], runs["plain"]
    assert spec["calls"] > 0, "the spec path never ran"
    assert plain["calls"] == 0
    for n in reqs:
        # The cycles until the stream's budget (the install gave its first
        # token; rows past the budget are overshoot, and a stream left
        # with no eligible neighbour finishes on the plain path).
        c, got = [], 1
        for e in spec["per_cycle"].get(n, []):
            if got >= SPEC_NEW:
                break
            c.append(min(e, SPEC_NEW - got))
            got += e
        log(f"  {n}: {sum(c)} tokens in {len(c)} spec cycles, "
            f"{sum(c) / max(1, len(c)):.2f} per cycle, most {max(c or [0])}")
    assert max(max(spec["per_cycle"].get(f"g{i}", [0])) for i in range(8)) \
        >= 2, "no cycle accepted a draft"
    assert spec["graphs"], "no spec cycle was captured"
    for key, per_replay in spec["graphs"].items():
        assert per_replay.get("mq_paged_attention", 0) == L, \
            f"kernel 2 not in every layer of the spec cycle {key}"
    assert spec["launches"][1] >= spec["calls"] * scfg.speculate_cycles * L
    log(f"  speculation against the plain path: {spec['tps']:.1f} / "
        f"{plain['tps']:.1f} tok/s = {spec['tps'] / plain['tps']:.3f}x over "
        f"the pass; greedy window {spec['greedy_tps']:.1f} / "
        f"{plain['greedy_tps']:.1f} = "
        f"{spec['greedy_tps'] / plain['greedy_tps']:.3f}x (information "
        f"only; {card})")
    greedy = [n for n in reqs if n != "sampled"]
    compare_streams(llama, cfg, params, prompts,
                    {n: spec["tokens"][n] for n in greedy},
                    {n: plain["tokens"][n] for n in greedy},
                    "speculation vs plain, bf16")
    log(f"  sampled stream, bf16: identical "
        f"{spec['tokens']['sampled'] == plain['tokens']['sampled']} "
        "(information only)")

    # (b) Exactness in f32 at full width and 4 layers.
    t = time.monotonic()
    f32 = replace(cfg.model, dtype=torch.float32, num_layers=4)
    f32_params = llama.init_params(
        f32, torch.Generator(device="cuda").manual_seed(5))
    exact = [spec_serve(engine_mod, replace(rcfg, model=f32), f32_params,
                        [reqs], kernels) for rcfg in (scfg, pcfg)]
    lp_err = max(abs(a[1] - b[1]) for a, b in zip(
        exact[0]["logprobs"]["logprobs"], exact[1]["logprobs"]["logprobs"]))
    same = sum(exact[0]["tokens"][n] == exact[1]["tokens"][n] for n in reqs)
    log(f"  f32, full width, 4 layers: {same}/{len(reqs)} streams identical "
        f"with and without speculation (greedy, sampled, logprobs); spec "
        f"calls {exact[0]['calls']}; logprobs max diff {lp_err:.3g} (tol "
        f"1e-4); {time.monotonic() - t:.1f} s")
    assert exact[0]["calls"] > 0
    assert same == len(reqs), "speculation changed a stream in f32"
    assert [a[0] for a in exact[0]["logprobs"]["logprobs"]] == \
        [b[0] for b in exact[1]["logprobs"]["logprobs"]]
    assert len(exact[0]["logprobs"]["logprobs"]) == SPEC_NEW
    assert lp_err <= 1e-4, "logprobs moved under speculation"

    # (e) Budgets that fill the context, on the same f32 weights. The room
    # lags one call, so the last verify blocks run past max_seq_len: the
    # history's and the pool's writes there must go nowhere, with every
    # stream still equal to the plain path's.
    t = time.monotonic()
    L_end = 384                            # 24 pages: the table's end
    g_reqs = {n: r for n, r in reqs.items() if n.startswith("g")}
    new = L_end - len(g_reqs["g0"][0])
    ends = [spec_serve(engine_mod, replace(rcfg, model=f32,
                                           max_seq_len=L_end),
                       f32_params, [g_reqs], kernels, max_tokens=new)
            for rcfg in (scfg, pcfg)]
    assert ends[0]["calls"] > 0, "the spec path never ran"
    most = max(max(v) for v in ends[0]["per_cycle"].values())
    same = sum(ends[0]["tokens"][n] == ends[1]["tokens"][n] for n in g_reqs)
    log(f"  f32, budgets filling max_seq_len {L_end}: {same}/{len(g_reqs)} "
        f"greedy streams identical with and without speculation; spec "
        f"calls {ends[0]['calls']}, most tokens in a cycle {most}; "
        f"{time.monotonic() - t:.1f} s")
    for r in ends:
        assert all(len(tk) == new for tk in r["tokens"].values())
    assert same == len(g_reqs), "a stream moved at the context's end"
    del f32_params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The captured spec cycle against the eager one.
    spec_graph_check(engine_mod, scfg, params)

    # (d) The spec_bench twin (bench_1b_config, B 8).
    from xllm_service_tpu_torch.benchmarks import spec_bench

    t = time.monotonic()
    for rec in spec_bench.run("cuda"):
        log("  spec_bench " + json.dumps(rec))
    log(f"  spec_bench twin: {time.monotonic() - t:.1f} s; {card}")
    return spec["launches"]


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
    check_mq_verify(mq_paged_attention, mq_paged_attention_plain)
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
        clocks = []
        toks, reasons, stats, ttft, tps = serve_once(
            engine_mod, cfg, params, prompts, shared, sampled_prompt,
            clocks=clocks)
        launches = (paged_attention.launches, mq_paged_attention.launches)
        log(f"  run {r}: {time.monotonic() - t:.1f} s, stats {stats}, "
            f"launches decode/mq {launches}")
        log(f"  run {r}: TTFT ms p50 {ttft[len(ttft) // 2]:.1f} max "
            f"{ttft[-1]:.1f}; {tps:.1f} generated tok/s over the run "
            f"(information only; {card})")
        log(f"  run {r}, host split: {StepClock.line(clocks[0])}")
        for name, tk in toks.items():
            assert len(tk) == 64 and reasons[name] == "length", \
                f"{name}: {len(tk)} tokens, reason {reasons[name]!r}"
        assert stats["prefix_hits"] >= 2 and \
            stats["prefix_hit_tokens"] >= 2 * 512, "no prefix hits"
        assert launches[0] > 0 and launches[1] > 0, "a kernel never launched"
        check_replays(stats, f"run {r}")
        runs.append((toks, launches, tps, ttft, clocks[0]))
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

    # Phase 4f: serving through the agent.
    log("[4f] serving llama3-8b through the engine agent behind a stub "
        f"master ({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated "
        "before: the weights alone)")
    t = time.monotonic()
    agent_launches = agent_phase(
        cfg, params, prompts, shared, sampled_prompt,
        runs, (paged_attention, mq_paged_attention),
        card)
    log(f"  phase 4f: {time.monotonic() - t:.1f} s")

    # Phase 4g: the admission path.
    log("[4g] the admission path at llama3-8b: chunked prefill, the "
        "Sarathi mixed step, offline preemption, the asynchronous install")
    t = time.monotonic()
    from xllm_service_tpu_torch.ops import attention
    g_launches = admission_phase(
        engine_mod, llama, attention, cfg, params, prompts, shared,
        sampled_prompt, runs[1][4], paged_attention, mq_paged_attention,
        mq_paged_attention_plain, card)
    log(f"  phase 4g: {time.monotonic() - t:.1f} s")

    # Phase 4h: speculative decoding.
    log("[4h] speculative decoding at llama3-8b: device-side n-gram "
        "drafts, the batched verify through kernel 2")
    t = time.monotonic()
    h_launches = spec_phase(engine_mod, llama, cfg, params,
                            (paged_attention, mq_paged_attention), card)
    log(f"  phase 4h: {time.monotonic() - t:.1f} s")

    # Phase 5: the kernels line, the card line, the result.
    rows = []
    csrc = "xllm_service_tpu_torch/csrc/"
    for name, src, tpu, res, n in (
            ("paged_attention", csrc + "paged_attention.cu",
             "xllm_service_tpu/ops/pallas_paged_attention.py:107", k1,
             runs[0][1][0] + agent_launches[0] + g_launches[0]
             + h_launches[0]),
            ("mq_paged_attention", csrc + "mq_paged_attention.cu",
             "xllm_service_tpu/ops/pallas_mq_paged_attention.py:100", k2,
             runs[0][1][1] + agent_launches[1] + g_launches[1]
             + h_launches[1]),
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
