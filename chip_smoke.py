#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xllm_service_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port starts, that its hand-written
kernels build and agree with their plain versions, and that the engine
serves Llama-3-8B through them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
1. environment: torch/CUDA versions, the card's name and power limit;
2. build both CUDA kernels from ``xllm_service_tpu_torch/csrc`` (one nvcc
   per source, in parallel) into ``build/torch_kernels``;
3. each kernel against its plain PyTorch version on the card at Llama-3-8B
   shapes (bf16 and f32, ragged contexts, NaN garbage past every context),
   and timed beside its plain version and a PyTorch yardstick
   (``scaled_dot_product_attention`` on the K/V already gathered dense);
4. serving at Llama-3-8B's full width and depth (random weights from a
   fixed seed) through ``InferenceEngine`` with its background loop: ten
   greedy requests (two of them sharing a 512-token prefix with the first,
   submitted after its prefill) and one seeded sampled request, run twice
   on fresh engines; checks lengths, determinism, prefix hits, kernel
   launches, and one prompt's logits by the cold, cached-prefix and decode
   routes;
5. a ``kernels`` JSON line, the card line, and the result line.

It needs one card; without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- helpers
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
def check_decode_kernel(paged_attention, paged_attention_plain):
    err = 0.0
    ctxs = [0, 1, 7, 16, 17, 500, 1000, MAX_PAGES * PS]   # ragged, full table
    for dtype in (torch.bfloat16, torch.float32):
        k, v, pt = paged_inputs(dtype, ctxs)
        q = torch.randn((B, N_Q, HD), device="cuda").to(dtype)
        cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
        got = paged_attention(q, k, v, pt, cl)
        want = paged_attention_plain(q, k, v, pt, cl)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "decode kernel: non-finite output"
        assert (got[0] == 0).all(), "decode kernel: ctx 0 row not zero"
        e = (got.float() - want.float()).abs().max().item()
        log(f"  paged_attention {str(dtype)[6:]:8s} ctx={ctxs} "
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
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_FLOPS else "operations", library_ms=lib_ms)


def check_mq_kernel(mq_paged_attention, mq_paged_attention_plain):
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for s_q in (1, 17, 512):
            for prefix in (0, 5, 384):      # none, a partial page, 3 blocks
                blocks = [s_q, max(1, s_q - 3)]
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


def serve_once(engine_mod, cfg, params, prompts, shared, sampled_prompt):
    """One serving run on a fresh engine with its background loop. Returns
    (greedy tokens per request, sampled tokens, stats, ttft ms, decode
    tokens/s over the run)."""
    from xllm_service_tpu_torch.common.request import SamplingParams

    eng = engine_mod.InferenceEngine(cfg, params=params)
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
    stats = eng.stats()
    ttft = sorted((c.t_first - t_sub[n]) * 1e3 for n, c in cols.items())
    toks = {n: c.tokens for n, c in cols.items()}
    reasons = {n: c.reason for n, c in cols.items()}
    del eng
    torch.cuda.empty_cache()
    return toks, reasons, stats, ttft, sum(map(len, toks.values())) / wall


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xllm_service_tpu_torch.engine import EngineConfig
    from xllm_service_tpu_torch.engine import engine as engine_mod
    from xllm_service_tpu_torch.models import llama
    from xllm_service_tpu_torch.models.base import llama3_8b_config
    from xllm_service_tpu_torch.ops import _build
    from xllm_service_tpu_torch.ops.mq_paged_attention import (
        mq_paged_attention,
        mq_paged_attention_plain,
    )
    from xllm_service_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_plain,
    )

    # Phase 1: environment.
    card = smi_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {card} | "
        f"devices {torch.cuda.device_count()}")

    # Phase 2: build both kernels in parallel.
    t = time.monotonic()
    logs = _build.build(verbose=True)
    log(f"[2] built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.monotonic() - t:.1f} s into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # Phase 3: kernels against plain, and times.
    log("[3] kernels against their plain versions")
    k1 = check_decode_kernel(paged_attention, paged_attention_plain)
    k2 = check_mq_kernel(mq_paged_attention, mq_paged_attention_plain)

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
        paged_attention.launches = 0
        mq_paged_attention.launches = 0
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
        runs.append((toks, launches))
    assert runs[0][0] == runs[1][0], "two runs of the same batch differ"
    log("  both runs gave identical tokens for all 11 requests")
    check_logits(llama, cfg, params, shared[0], 512)

    # Phase 5: the kernels line, the card line, the result.
    rows = []
    for name, src, tpu, res, n in (
            ("paged_attention", "xllm_service_tpu_torch/csrc/paged_attention.cu",
             "xllm_service_tpu/ops/pallas_paged_attention.py:107", k1,
             runs[0][1][0]),
            ("mq_paged_attention",
             "xllm_service_tpu_torch/csrc/mq_paged_attention.cu",
             "xllm_service_tpu/ops/pallas_mq_paged_attention.py:100", k2,
             runs[0][1][1])):
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
