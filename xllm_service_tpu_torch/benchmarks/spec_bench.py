"""Speculative-decoding benchmark of the port (twin of the repository's
``benchmarks/spec_bench.py``): tokens/s with prompt-lookup speculation on
and off, greedy, on a repetitive workload (where the drafts accept).

    python -m xllm_service_tpu_torch.benchmarks.spec_bench
    python -m xllm_service_tpu_torch.benchmarks.spec_bench --device cpu

The reference's shapes and method: ``bench_1b_config`` in bf16 on the card
(the tiny f32 config with ``--device cpu``), random weights from the
engine's seed, B 8 requests whose prompt is a unit of 8 ids repeated to
256 tokens (64 on the CPU) plus the request's index, 640 new tokens each
(160), ``max_seq_len`` 1024 (256); ``speculate_k`` 0 with a decode horizon
of 8, then 4 with a horizon of 1 (``speculate_cycles`` at its default, 4).
Each mode admits the batch and runs 3 engine steps (captures and first
uses fall there), then times 10 steps at full batch.

Prints one JSON line per mode, then the speedup line. Without a card and
without ``--device cpu`` it raises; a CPU run checks only that the twin
works.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Union

import torch

from ..common.device import card_line, resolve_device
from ..common.request import SamplingParams
from ..engine import EngineConfig, EngineRequest, InferenceEngine
from ..models.base import bench_1b_config, tiny_config

B = 8
MODES = (0, 4)


def run(device: Optional[Union[str, torch.device]] = None) -> list[dict]:
    """Both modes on ``device``; returns the JSON records, the speedup's
    last."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    mcfg = (bench_1b_config() if on_card
            else tiny_config(dtype=torch.float32))
    ctx, new = (256, 640) if on_card else (64, 160)
    max_seq = 1024 if on_card else 256
    unit = list(range(11, 11 + 8))
    prompt = (unit * (ctx // len(unit)))[:ctx]
    records, rates = [], {}
    for spec_k in MODES:
        cfg = EngineConfig(
            model=mcfg, num_pages=(B * max_seq) // 16 + 64, page_size=16,
            max_batch_size=B, max_seq_len=max_seq,
            hash_block_size=128 if on_card else 32,
            decode_horizon=8 if spec_k == 0 else 1, speculate_k=spec_k)
        engine = InferenceEngine(cfg, device=dev)
        counts = {"tokens": 0}

        def on_output(out, counts=counts):
            counts["tokens"] += sum(len(s.token_ids) for s in out.outputs)

        for i in range(B):
            engine.submit(EngineRequest(
                f"s{i}", token_ids=list(prompt) + [i],
                sampling=SamplingParams(max_tokens=new, temperature=0.0,
                                        ignore_eos=True),
                on_output=on_output))
        while engine._waiting:
            engine.step()
        for _ in range(3):
            engine.step()
        n_steps = 10
        t0 = time.perf_counter()
        start = counts["tokens"]
        for _ in range(n_steps):
            engine.step()
        dt = time.perf_counter() - t0
        toks = counts["tokens"] - start
        rates[spec_k] = toks / dt
        records.append({"mode": f"speculate_k={spec_k}",
                        "tok_per_s": toks / dt, "tokens": toks})
        engine.stop()
    last = {"metric": "speculative_speedup", "value": rates[4] / rates[0],
            "unit": "x", "backend": dev.type}
    if on_card:
        last["device"] = torch.cuda.get_device_name(dev)
        last["card"] = card_line()
    records.append(last)
    return records


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    for rec in run(args.device):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
