"""Steady-state decode throughput of the port on one NVIDIA GPU (twin of
the repository's ``bench.py``).

    python -m xllm_service_tpu_torch.bench                 # on the card
    python -m xllm_service_tpu_torch.bench --device cpu    # checks the twin

It keeps the reference's metric and method: admit B prompts of ``ctx``
random tokens (greedy, ``ignore_eos``), run warm-up horizons, time
``n_steps`` calls of ``engine.step()`` and count the tokens delivered. It
prints ONE JSON line:

    {"metric": "decode_tokens_per_sec_per_chip", "value": N,
     "unit": "tok/s", "pct_roofline": P, "card": "...", ...}

On the card the shapes are the reference's: B 16, ctx 512, max_seq 1024,
``decode_horizon`` 32, page 16, hash block 128, bf16 weights drawn from
seed 0. ``XLLM_BENCH_MODEL`` picks ``1b`` (default), ``8b`` (Llama-3-8B)
or ``moe`` (the reference's MLA+MoE bench shape, ``bench_moe_config``, in
weight-only int8 unless ``XLLM_QUANT`` names another mode, as the
reference's bench has it); ``XLLM_BENCH_CTX`` runs the long-context
variant (the batch shrinks so the pool fits); ``XLLM_QUANT=int8`` serves
weight-only int8 (the engine quantizes the weights). ``pct_roofline`` is
the weight and KV stream of one token-step
(``decode_weight_stream_bytes() + B * kv_bytes_per_token(mid_ctx)``) at
the achieved step rate, over the card's 3.35 TB/s. There is no CPU
fallback: without a card and without ``--device cpu`` it raises. A CPU run
uses ``tiny_config`` and checks only that the twin works.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from .common.device import card_line, resolve_device
from .common.request import SamplingParams
from .engine import EngineConfig, EngineRequest, InferenceEngine
from .models.base import (
    ModelConfig,
    bench_1b_config,
    llama3_8b_config,
    tiny_config,
)
from .models.deepseek_moe import bench_moe_config

METRIC = "decode_tokens_per_sec_per_chip"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet


@dataclasses.dataclass(frozen=True)
class BenchShape:
    model_key: str
    mcfg: ModelConfig
    batch: int
    ctx: int
    max_seq: int
    horizon: int
    hash_block: int
    n_steps: int

    def engine_config(self) -> EngineConfig:
        return EngineConfig(
            model=self.mcfg, model_family=self.mcfg.name,
            num_pages=self.batch * self.max_seq // 16 + 64,
            page_size=16, max_batch_size=self.batch,
            max_seq_len=self.max_seq, hash_block_size=self.hash_block,
            decode_horizon=self.horizon, seed=0)


def bench_shape(device: torch.device) -> BenchShape:
    """The reference's bench shapes on the card (``XLLM_BENCH_MODEL``,
    ``XLLM_BENCH_CTX``, ``XLLM_QUANT``), ``tiny_config`` in f32 on the
    CPU."""
    if device.type != "cuda":
        return BenchShape("tiny", tiny_config(dtype=torch.float32), batch=8,
                          ctx=64, max_seq=128, horizon=4, hash_block=32,
                          n_steps=4)
    model_key = os.environ.get("XLLM_BENCH_MODEL", "1b")
    if model_key not in ("1b", "8b", "moe"):
        raise ValueError(f"XLLM_BENCH_MODEL={model_key!r}: 1b, 8b or moe")
    mcfg = {"1b": bench_1b_config, "8b": llama3_8b_config,
            "moe": bench_moe_config}[model_key]()
    # Weight-only int8 (the reference bench's switch): the default for moe
    # as there; bf16 for 8b here, where its weights fit the card.
    quant = os.environ.get("XLLM_QUANT",
                           "int8" if model_key == "moe" else "")
    if quant:
        mcfg = dataclasses.replace(mcfg, quant=quant)
    B, ctx, max_seq = 16, 512, 1024
    if os.environ.get("XLLM_BENCH_CTX", ""):
        # Long-context variant: the page walk dominates; the batch shrinks
        # to keep the pool on one card, the rope window widens to fit.
        ctx_req = int(os.environ["XLLM_BENCH_CTX"])
        if ctx_req + 512 > mcfg.max_context_len:
            mcfg = dataclasses.replace(mcfg, max_context_len=ctx_req + 512)
        ctx = min(ctx_req, mcfg.max_context_len - 512)
        B = (16 if ctx <= 512 else 8 if ctx <= 1024 else
             4 if ctx <= 4096 else 2 if ctx <= 16384 else 1)
        max_seq = ctx + 512
    return BenchShape(model_key, mcfg, batch=B, ctx=ctx, max_seq=max_seq,
                      horizon=32, hash_block=128, n_steps=10)


def admit_batch(engine: InferenceEngine, shape: BenchShape,
                on_output, seed: int = 0) -> None:
    """Submit B greedy prompts of ``ctx`` random tokens and step the engine
    until all are admitted (prefill, not timed)."""
    rng = np.random.default_rng(seed)
    V = shape.mcfg.vocab_size
    for i in range(shape.batch):
        engine.submit(EngineRequest(
            f"bench-{i}", token_ids=rng.integers(10, V - 10,
                                                 shape.ctx).tolist(),
            sampling=SamplingParams(max_tokens=shape.max_seq - shape.ctx - 8,
                                    temperature=0.0, ignore_eos=True),
            on_output=on_output))
    deadline = time.perf_counter() + 600
    while engine._waiting or len(engine._running) < shape.batch:
        engine.step()
        if not engine._waiting and engine._running:
            break
        if time.perf_counter() > deadline:
            raise RuntimeError("admission stalled")


def run(device: Optional[Union[str, torch.device]] = None,
        params: Optional[dict] = None) -> dict:
    """One bench run; returns the JSON record. ``params`` (the family's
    tree for the shape's model) replaces the random weights drawn from
    seed 0."""
    dev = resolve_device(device)
    shape = bench_shape(dev)
    counts = {"tokens": 0}

    def on_output(out):
        counts["tokens"] += sum(len(s.token_ids) for s in out.outputs)

    engine = InferenceEngine(shape.engine_config(), device=dev,
                             params=params)
    try:
        admit_batch(engine, shape, on_output)
        for _ in range(2):                        # warm-up horizons
            engine.step()
        start = counts["tokens"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(shape.n_steps):
            engine.step()
        dt = time.perf_counter() - t0
        generated = counts["tokens"] - start
    finally:
        engine.stop()
    B, mcfg = shape.batch, shape.mcfg
    toks_per_s = generated / dt
    # One token-step streams every weight once and each row's K/V over
    # its context (taken at the middle of the timed run).
    mid_ctx = shape.ctx + generated // (2 * B)
    bytes_per_step = (mcfg.decode_weight_stream_bytes()
                      + B * mcfg.kv_bytes_per_token(mid_ctx))
    step_rate = toks_per_s / B
    out = {
        "metric": METRIC, "value": toks_per_s, "unit": "tok/s",
        "backend": dev.type, "model": shape.model_key, "batch": B,
        "ctx": shape.ctx, "decode_horizon": shape.horizon,
        "n_steps": shape.n_steps, "tokens": generated, "seconds": dt,
        "quant": mcfg.quant,
        "ms_per_token_step": 1e3 / step_rate if step_rate else None,
        "bytes_per_step_mb": bytes_per_step / 1e6,
        "effective_gbps": bytes_per_step * step_rate / 1e9,
    }
    if dev.type == "cuda":
        out["pct_roofline"] = (100.0 * bytes_per_step * step_rate
                               / HBM_BYTES_PER_S)
        out["device"] = torch.cuda.get_device_name(dev)
        out["card"] = card_line()
    return out


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))


if __name__ == "__main__":
    main()
