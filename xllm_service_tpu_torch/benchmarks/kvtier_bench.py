"""Tiered KV-cache data-plane benchmark of the port (twin of the
repository's ``benchmarks/kvtier_bench.py``): the reference's four legs on
the port's engine, with its JSON keys.

    python -m xllm_service_tpu_torch.benchmarks.kvtier_bench
    python -m xllm_service_tpu_torch.benchmarks.kvtier_bench --device cpu --quick
    python -m xllm_service_tpu_torch.benchmarks.kvtier_bench --legs ttft,capacity

1. **Tier-aware TTFT**: one shared prefix of ``--prefix-tokens`` (1024)
   tokens plus a 16-token tail, measured hot (prefix in the pool), warm
   (offloaded to the DRAM arena), cold SSD (the arena squeezed to two
   blocks, so the prefix demotes to the spill file) and cold recompute
   (tiers off: the whole prefill again). Beside the reference's keys,
   ``onload_ms_per_block``: one more warm re-send with the engine's cold
   onload (``_onload_cold_prefix``) timed to the device's completion,
   divided by the blocks it restored.
2. **Capacity multiplier**: ``--prefixes`` distinct 256-token prefixes
   through a 64-page pool; addressable prefix blocks (pool + fence-complete
   tier blocks) against the pool alone.
3. **Decode-step latency under background offload**: one 160-token decode
   with churn admissions every 12 steps, on a tiered and an untiered
   engine in interleaved rounds; p50/p90 ``step()`` wall times.
4. **Streaming transfer framing**: chunked offer/pull of a
   ``--payload-mb`` payload at 256 KiB and 1 MiB chunks, and a run paced
   by a DCN budget of a third of the payload a second.

The engines take the reference's configuration (page 16, hash block 64,
batch 4, the same pool sizes and prompts: ids 2..499) at the model of
``--model-config``: ``deepseek_v2_lite`` on a card by default (its MLA
pool, one 576-wide latent head, bf16), ``tiny`` (f32) with ``--device
cpu``. Random weights from seed 0 are drawn once (or taken from
``run``'s caller) and shared by every engine. Each tier arena holds at
least the reference's bytes and at least as many blocks as the leg's
traffic offloads (a DeepSeek-V2-Lite block of 64 tokens is 3,981,312
bytes; the reference's tiny block 65,536).

Prints one JSON object (``--out`` writes it to a file too). Without a
card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..common.device import card_line, resolve_device
from ..common.hashing import prefix_block_hashes
from ..common.request import RequestOutput, SamplingParams
from ..engine import EngineConfig, EngineRequest, InferenceEngine
from ..engine.kv_transfer import (
    BandwidthAccountant,
    StreamOfferTable,
    pull_stream,
)
from ..models import base as model_base
from ..models import deepseek_moe
from ..models.base import ModelConfig, get_model_family

MODEL_CONFIGS: dict[str, Callable[[], ModelConfig]] = {
    "tiny": lambda: model_base.tiny_config(dtype=torch.float32,
                                           max_context_len=2048),
    "tiny_mla": lambda: deepseek_moe.tiny_mla_config(
        dtype=torch.float32, max_context_len=2048),
    "deepseek_v2_lite": deepseek_moe.deepseek_v2_lite_config,
}
LEGS = ("ttft", "capacity", "step_latency", "stream")


def percentile(xs, p):
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
    return xs[i]


class _FirstToken:
    """Records the wall time of the first emitted token."""

    def __init__(self):
        self.t_first = None
        self.done = False

    def __call__(self, out: RequestOutput) -> None:
        if self.t_first is None and any(s.token_ids for s in out.outputs):
            self.t_first = time.perf_counter()
        if out.finished:
            self.done = True


class _Bench:
    """The model, its shared weights and the engines' common settings."""

    def __init__(self, mcfg: ModelConfig, dev: torch.device,
                 params: Optional[dict] = None):
        self.mcfg, self.dev = mcfg, dev
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = get_model_family(mcfg.name).init_params(mcfg, gen, dev)
        self.params = params

    def tier_bytes(self, ref_bytes: int, blocks: int) -> int:
        """The reference's arena bytes, or ``blocks`` of this model's
        blocks of 64 tokens where that is more."""
        m = self.mcfg
        block = (m.num_layers * 2 * 64 * m.num_kv_heads * m.head_dim
                 * torch.empty((), dtype=m.dtype).element_size())
        return max(ref_bytes, blocks * block)

    def engine(self, num_pages: int, tier_dram: int = 0, tier_ssd: int = 0,
               max_ctx: int = 2048) -> InferenceEngine:
        return InferenceEngine(EngineConfig(
            model=self.mcfg, model_family=self.mcfg.name,
            num_pages=num_pages, page_size=16, hash_block_size=64,
            max_batch_size=4, max_seq_len=min(max_ctx,
                                              self.mcfg.max_context_len),
            kv_tier_dram_bytes=tier_dram, kv_tier_ssd_bytes=tier_ssd),
            device=self.dev, params=self.params)


def _run(engine: InferenceEngine, rid: str, prompt, max_tokens=8) -> float:
    """Submit one request, drive the loop to completion; returns TTFT s."""
    col = _FirstToken()
    t0 = time.perf_counter()
    engine.submit(EngineRequest(
        rid, rid, token_ids=[int(t) for t in prompt],
        sampling=SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                ignore_eos=True),
        on_output=col))
    while not col.done:
        if not engine.step():
            time.sleep(0.0005)
    return col.t_first - t0


def _wait(pred, timeout=60.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("tier state never converged")
        time.sleep(0.01)


def _timed_onload(engine: InferenceEngine, rid: str, prompt) -> float:
    """One warm re-send with the cold onload timed to the device's
    completion; returns ms per restored block."""
    real = engine._onload_cold_prefix
    seen = []

    def timed(prompt_hashes, matched, *a):
        t0 = time.perf_counter()
        out = real(prompt_hashes, matched, *a)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        seen.append((time.perf_counter() - t0,
                     (out - matched) // engine.cfg.hash_block_size))
        return out

    engine._onload_cold_prefix = timed
    try:
        _run(engine, rid, prompt)
    finally:
        engine._onload_cold_prefix = real
    dt, blocks = seen[0]
    return dt * 1e3 / max(1, blocks)


# --------------------------------------------------------- leg 1: TTFT
def bench_tier_ttft(b: _Bench, prefix_tokens: int, rounds: int) -> dict:
    hbs = 64
    n_blocks = prefix_tokens // hbs
    prefix = list(np.random.default_rng(7).integers(
        2, 500, size=prefix_tokens))
    tail = list(range(16))           # distinct suffix past the prefix

    def prompt():
        return prefix + tail

    def churn(engine, start, count, tokens=384):
        """Distinct throwaway prompts that force LRU eviction of the
        shared prefix (and, tiered, its offload)."""
        for i in range(count):
            base = 10_000 + (start + i) * 1000
            p = list(np.random.default_rng(base).integers(
                2, 500, size=tokens))
            _run(engine, f"churn-{base}", p, max_tokens=2)

    out = {"prefix_tokens": prefix_tokens, "prefix_blocks": n_blocks}
    hx = [h.hex()
          for h in prefix_block_hashes(prompt(), hbs)][:n_blocks]
    # The arena holds the prefix and every churn block of the rounds.
    arena_blocks = n_blocks + 6 * 5 * (rounds + 3)

    # Tiered engine: DRAM generously sized; the prefix offloads whole.
    eng = b.engine(num_pages=96,
                   tier_dram=b.tier_bytes(256 << 20, arena_blocks))
    blk = eng.tier_store.block_nbytes
    hot, warm = [], []
    try:
        _run(eng, "seed", prompt())      # donate the prefix blocks
        # Warm-up cycle: first uses outside the measured rounds.
        _run(eng, "wu-hot", prompt())
        churn(eng, 900, 5)
        _wait(lambda: all(eng.tier_store.ready(h) for h in hx))
        _run(eng, "wu-warm", prompt())
        for r in range(rounds):
            hot.append(_run(eng, f"hot-{r}", prompt()))
            churn(eng, r * 10, 5)
            _wait(lambda: all(eng.tier_store.ready(h) for h in hx))
            warm.append(_run(eng, f"warm-{r}", prompt()))
        churn(eng, 800, 5)
        _wait(lambda: all(eng.tier_store.ready(h) for h in hx))
        onload = _timed_onload(eng, "onload", prompt())
        tier_stats = eng.tier_store.stats()
    finally:
        eng.stop()

    # SSD leg: DRAM squeezed to 2 blocks so the prefix demotes to disk.
    eng_ssd = b.engine(num_pages=96, tier_dram=2 * blk,
                       tier_ssd=b.tier_bytes(256 << 20, arena_blocks))
    ssd = []
    try:
        _run(eng_ssd, "seed", prompt())
        for r in range(-1, rounds):      # round -1 = warm-up
            churn(eng_ssd, 100 + r * 10, 5)
            _wait(lambda: all(eng_ssd.tier_store.ready(h) for h in hx)
                  and eng_ssd.tier_store.stats()["ssd_blocks"]
                  >= n_blocks - 2)
            t = _run(eng_ssd, f"ssd-{r}", prompt())
            if r >= 0:
                ssd.append(t)
    finally:
        eng_ssd.stop()

    # Cold recompute: tiering off; eviction destroys the prefix, every
    # re-admission pays the whole prefill.
    eng_cold = b.engine(num_pages=96)
    cold = []
    try:
        _run(eng_cold, "seed", prompt())
        for r in range(rounds):
            churn(eng_cold, 200 + r * 10, 5)
            cold.append(_run(eng_cold, f"cold-{r}", prompt()))
    finally:
        eng_cold.stop()

    out.update({
        "block_nbytes": blk,
        "hot_hbm_ttft_ms": round(statistics.median(hot) * 1e3, 2),
        "warm_dram_ttft_ms": round(statistics.median(warm) * 1e3, 2),
        "warm_ssd_ttft_ms": round(statistics.median(ssd) * 1e3, 2),
        "cold_recompute_ttft_ms": round(statistics.median(cold) * 1e3, 2),
        "warm_vs_cold_speedup": round(
            statistics.median(cold) / statistics.median(warm), 2),
        "ssd_vs_cold_speedup": round(
            statistics.median(cold) / statistics.median(ssd), 2),
        "onload_ms_per_block": round(onload, 4),
        "tier_stats": tier_stats,
    })
    return out


# ------------------------------------------------- leg 2: capacity
def bench_capacity(b: _Bench, num_prefixes: int) -> dict:
    """Fixed pool; distinct 256-token prefixes far past its capacity.
    Addressable = still-matchable prefix blocks."""
    def feed(engine):
        for i in range(num_prefixes):
            p = list(np.random.default_rng(5_000 + i).integers(
                2, 500, size=256))
            _run(engine, f"cap-{i}", p, max_tokens=2)

    base = b.engine(num_pages=64, max_ctx=512)
    try:
        feed(base)
        hbm_only = base.page_mgr.cached_block_count()
    finally:
        base.stop()

    fed = num_prefixes * 4
    tiered = b.engine(num_pages=64, tier_dram=b.tier_bytes(16 << 20, fed),
                      tier_ssd=b.tier_bytes(64 << 20, fed), max_ctx=512)
    try:
        feed(tiered)
        _wait(lambda: not tiered.page_mgr._evicted_pending)
        _wait(lambda: not tiered.tier_store._pending)
        st = tiered.tier_store.stats()
        hbm = tiered.page_mgr.cached_block_count()
    finally:
        tiered.stop()
    addressable = hbm + st["dram_blocks"] + st["ssd_blocks"]
    return {
        "distinct_prefixes": num_prefixes,
        "prefix_blocks_fed": fed,
        "hbm_budget_pages": 64,
        "hbm_only_addressable_blocks": hbm_only,
        "tiered_addressable_blocks": addressable,
        "tiered_split": {"hbm": hbm, "dram": st["dram_blocks"],
                         "ssd": st["ssd_blocks"]},
        "offload_dropped": st["offload_dropped"],
        "capacity_multiplier": round(addressable / max(1, hbm_only), 2),
    }


# -------------------------------------- leg 3: step latency under offload
def _step_workload(engine: InferenceEngine, churn_every: int,
                   n_churn: int) -> list[float]:
    """One long decode + periodic churn admissions; returns step() wall
    times for steps taken while the long decode is live."""
    col = _FirstToken()
    engine.submit(EngineRequest(
        "longdec", "longdec", token_ids=list(range(40, 72)),
        sampling=SamplingParams(max_tokens=160, temperature=0.0,
                                ignore_eos=True),
        on_output=col))
    durs = []
    steps = 0
    injected = 0
    sink = []
    while not col.done:
        if injected < n_churn and steps and steps % churn_every == 0:
            c = _FirstToken()
            sink.append(c)
            p = [int(t) for t in np.random.default_rng(
                9_000 + injected).integers(2, 500, size=192)]
            engine.submit(EngineRequest(
                f"churn-{injected}", f"churn-{injected}", token_ids=p,
                sampling=SamplingParams(max_tokens=2, temperature=0.0,
                                        ignore_eos=True),
                on_output=c))
            injected += 1
        t0 = time.perf_counter()
        busy = engine.step()
        durs.append(time.perf_counter() - t0)
        steps += 1
        if not busy:
            time.sleep(0.0005)
    while not all(c.done for c in sink):
        engine.step()
    return durs


def bench_step_latency(b: _Bench, rounds: int) -> dict:
    base = b.engine(num_pages=64, max_ctx=512)
    tier = b.engine(num_pages=64, max_ctx=512,
                    tier_dram=b.tier_bytes(256 << 20, 8 * 3 * rounds + 8))
    try:
        base_durs, tier_durs = [], []
        for _ in range(rounds):          # interleaved rounds: drift-proof
            base_durs += _step_workload(base, churn_every=12, n_churn=8)
            tier_durs += _step_workload(tier, churn_every=12, n_churn=8)
        st = tier.tier_store.stats()
    finally:
        base.stop()
        tier.stop()
    b50 = statistics.median(base_durs)
    t50 = statistics.median(tier_durs)
    return {
        "rounds": rounds,
        "baseline_step_p50_ms": round(b50 * 1e3, 3),
        "tiered_step_p50_ms": round(t50 * 1e3, 3),
        "baseline_step_p90_ms": round(percentile(base_durs, 90) * 1e3, 3),
        "tiered_step_p90_ms": round(percentile(tier_durs, 90) * 1e3, 3),
        "delta_p50_perc": round((t50 - b50) / b50 * 100, 2),
        "offloads_during_tiered_run": st["offload_total"],
        "offload_dropped": st["offload_dropped"],
    }


# ----------------------------------------------- leg 4: stream framing
def bench_stream(payload_mb: int) -> dict:
    data = np.random.default_rng(3).standard_normal(
        payload_mb * (1 << 20) // 4).astype(np.float32)

    def pull(table, desc, bw):
        def post(url, payload):
            return table.read_chunk(payload["uuid"], payload["offset"],
                                    payload["max_bytes"])
        return pull_stream("peer:0", desc, accountant=bw, link="dcn",
                           post=post)

    out = {"payload_mb": payload_mb, "chunks": {}}
    for chunk in (1 << 18, 1 << 20):
        table = StreamOfferTable(default_chunk_bytes=chunk)
        desc = table.offer("bench", data.tobytes(),
                           shape=[data.size], dtype="float32")
        bw = BandwidthAccountant()
        t0 = time.perf_counter()
        got = pull(table, desc, bw)
        el = time.perf_counter() - t0
        assert got.numel() * got.element_size() == data.nbytes
        table.release(desc["stream_uuid"])
        out["chunks"][f"{chunk >> 10}KiB"] = {
            "mb_per_s": round(data.nbytes / el / 1e6, 1),
            "round_trips": -(-data.nbytes // chunk),
        }
    # Budgeted run: the token bucket allows ONE budget-second of burst,
    # so a payload of ~3 budget-seconds must take ~2 s of pacing sleep.
    budget = data.nbytes // 3
    table = StreamOfferTable(default_chunk_bytes=1 << 20)
    desc = table.offer("bench-paced", data.tobytes(),
                       shape=[data.size], dtype="float32")
    bw = BandwidthAccountant(dcn_bytes_per_s=budget)
    t0 = time.perf_counter()
    pull(table, desc, bw)
    el = time.perf_counter() - t0
    out["paced_dcn"] = {
        "budget_mb_per_s": round(budget / 1e6, 1),
        "achieved_mb_per_s": round(data.nbytes / el / 1e6, 1),
    }
    return out


def run(device: Optional[Union[str, torch.device]] = None,
        model_config: Optional[str] = None, prefix_tokens: int = 1024,
        rounds: int = 3, prefixes: int = 14, payload_mb: int = 8,
        legs: tuple = LEGS, params: Optional[dict] = None) -> dict:
    """The legs named in ``legs`` on ``device``; returns the report.
    ``params``: the model's weights already on the device (seed 0's
    random weights are drawn otherwise)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    name = model_config or ("deepseek_v2_lite" if on_card else "tiny")
    mcfg = MODEL_CONFIGS[name]()
    report: dict = {
        "round": 9,
        "box": (f"{torch.cuda.get_device_name(dev)} ({card_line()})"
                if on_card else "CPU"),
        "bench": "xllm_service_tpu_torch/benchmarks/kvtier_bench.py",
        "model": name, "dtype": str(mcfg.dtype).replace("torch.", ""),
    }
    b = _Bench(mcfg, dev, params) if set(legs) - {"stream"} else None
    if "ttft" in legs:
        report["tier_ttft"] = bench_tier_ttft(b, prefix_tokens, rounds)
    if "capacity" in legs:
        report["capacity"] = bench_capacity(b, prefixes)
    if "step_latency" in legs:
        report["step_latency"] = bench_step_latency(b, max(1, rounds - 1))
    if "stream" in legs:
        report["stream"] = bench_stream(payload_mb)
    return report


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--model-config", default=None,
                    choices=sorted(MODEL_CONFIGS),
                    help="deepseek_v2_lite on a card, tiny on the CPU")
    ap.add_argument("--quick", action="store_true",
                    help="CI scale: small prefix, 1 round")
    ap.add_argument("--prefix-tokens", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--prefixes", type=int, default=14)
    ap.add_argument("--payload-mb", type=int, default=8)
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma-separated subset of " + ",".join(LEGS))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.quick:
        args.prefix_tokens, args.rounds, args.prefixes = 256, 1, 12
        args.payload_mb = 2
    legs = tuple(x for x in args.legs.split(",") if x)
    unknown = set(legs) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}")
    report = run(args.device, args.model_config, args.prefix_tokens,
                 args.rounds, args.prefixes, args.payload_mb, legs)
    print(json.dumps(report, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")


if __name__ == "__main__":
    main()
