"""Continuous-profiler overhead micro-bench of the port (twin of the
repository's ``benchmarks/bench_profile_overhead.py``).

Measures the fake-engine request path end to end (the port's HTTP
frontend -> scheduler -> fake engine -> generations ingest -> response)
with the sampling profiler OFF against ON at the default ~19 Hz, on ONE
shared in-process cluster with the modes interleaved round-robin. The
profiler toggles through its public refcounted start/stop, so every
round also exercises the spawn/join lifecycle.

Also times one raw sampler tick in isolation (``sample_tick_us``: the
per-tick cost amortized over ``1/hz`` seconds is the first-principles
overhead bound), and records the loaded run's composition: the
profiler's own per-role sample split next to ``CPU_ATTR``'s per-loop CPU
split.

    python -m xllm_service_tpu_torch.benchmarks.bench_profile_overhead
    python -m xllm_service_tpu_torch.benchmarks.bench_profile_overhead --quick

Prints one JSON line per mode, the overhead ratio and a ``BENCH_DOC``
line with the reference's document keys; exits non-zero when the measured
p50 overhead exceeds the gate (``PROFILE_GATE_PCT``, default 1.0
points). ``--quick`` (not in the reference) is 2 rounds of 20 requests
a mode (the reference's 16 of 40).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time

from .stack import Session

MODES = ("off", "on")
PROFILE_HZ = 19.0
ROUNDS, PER_ROUND = 16, 40
QUICK_ROUNDS, QUICK_PER_ROUND = 2, 20


def sample_tick_us(iters: int = 2000) -> float:
    """Cost of one raw sampler tick (all threads walked, stacks folded,
    merged under the leaf lock) against the current thread population."""
    from ..profiling import SamplingProfiler

    p = SamplingProfiler()
    p.configure(hz=0)   # never spawns; we drive ticks by hand
    ident = threading.get_ident()
    p._sample_once(ident)   # warm the label cache
    t0 = time.perf_counter()
    for _ in range(iters):
        p._sample_once(ident)
    return (time.perf_counter() - t0) / iters * 1e6


def gate_pct() -> float:
    return float(os.environ.get("PROFILE_GATE_PCT", "1.0"))


def passes(doc: dict, gate: float) -> bool:
    """The reference's exit rule: the smaller of the overall p50 delta
    and the paired-round median within the gate."""
    return min(doc["overall_p50_delta_pct"],
               doc["headline"]["profile_overhead_pct"]) <= gate


def run(rounds: int = ROUNDS, per_round: int = PER_ROUND) -> dict:
    """The bench at ``rounds`` rounds of ``per_round`` requests a mode;
    prints the reference's JSON lines and returns its document."""
    from ..common.config import ServiceOptions
    from ..common.hotpath import CPU_ATTR
    from ..coordination.memory import InMemoryCoordination, MemoryStore
    from ..master import Master
    from ..profiling import PROFILER
    from ..testing.fake_engine import FakeEngine, FakeEngineConfig

    store = MemoryStore(expiry_tick_s=0.05)
    opts = ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                          lease_ttl_s=2.0, sync_interval_s=1.0,
                          profile_hz=PROFILE_HZ)
    master = Master(opts, coord=InMemoryCoordination(store))
    engine = None
    session = Session()
    net_refs = 0    # the bench's starts less its stops
    try:
        master.start()
        engine = FakeEngine(
            InMemoryCoordination(store),
            FakeEngineConfig(reply_text="x" * 8, chunk_size=8,
                             delay_s=0.0)).start()
        deadline = time.time() + 10
        while not master.scheduler.has_available_instances():
            if time.time() > deadline:
                raise RuntimeError("fake engine never became available")
            time.sleep(0.05)

        tick_us = sample_tick_us()
        # First-principles bound: one tick every 1/hz seconds.
        amortized_pct = tick_us * 1e-6 * PROFILE_HZ * 100.0
        print(json.dumps({"sample_tick_us": round(tick_us, 1),
                         "amortized_cpu_pct": round(amortized_pct, 4)}))

        def set_mode(mode: str) -> None:
            # The master owns one profiler ref; the bench borrows/returns
            # a second through the public refcounted lifecycle. "off"
            # drops BOTH (master's comes back at the end of the round),
            # so the sampler thread is truly gone during off rounds.
            nonlocal net_refs
            if mode == "off":
                PROFILER.stop()
                net_refs -= 1
            else:
                PROFILER.start()
                net_refs += 1

        url = f"http://127.0.0.1:{master.http_port}/v1/completions"
        body = {"model": "fake-model", "prompt": "bench", "max_tokens": 8}

        def one() -> float:
            t0 = time.perf_counter()
            r = session.post(url, json=body, timeout=30)
            assert r.status_code == 200, r.text
            return (time.perf_counter() - t0) * 1000.0

        for _ in range(50):   # warmup (threads, sockets, code paths)
            one()
        CPU_ATTR.clear()
        PROFILER.clear()

        lat: dict[str, list[float]] = {m: [] for m in MODES}
        round_p50: dict[str, list[float]] = {m: [] for m in MODES}
        for r in range(rounds):
            # Alternate leg order: a monotonic machine-load drift would
            # otherwise systematically penalize whichever mode runs
            # second.
            for mode in (MODES if r % 2 == 0 else MODES[::-1]):
                set_mode(mode)
                xs = [one() for _ in range(per_round)]
                lat[mode].extend(xs)
                round_p50[mode].append(sorted(xs)[len(xs) // 2])
        # Every cycle ends "on": the master's ref is outstanding and its
        # cleanup pairs the final stop.

        results = {}
        for mode in MODES:
            xs = sorted(lat[mode])
            results[mode] = {
                "mode": mode,
                "n": len(xs),
                "mean_ms": round(statistics.fmean(xs), 3),
                "p50_ms": round(xs[len(xs) // 2], 3),
                "p95_ms": round(xs[int(len(xs) * 0.95)], 3),
            }
            print(json.dumps(results[mode]))
        base = results["off"]["p50_ms"]
        overhead_pct = round(
            (results["on"]["p50_ms"] - base) / base * 100.0, 2)
        # Noise-robust secondary estimate: median of the per-round paired
        # p50 deltas (drift cancels within each interleaved round).
        deltas = sorted((b - a) / a * 100.0
                        for a, b in zip(round_p50["off"], round_p50["on"]))
        paired_median_pct = round(deltas[len(deltas) // 2], 2)
        print(json.dumps({"profile_overhead_p50_pct": overhead_pct,
                         "paired_round_median_pct": paired_median_pct}))

        # Composition: the profiler's own view of the loaded run next to
        # the coarse CPU attribution.
        snap = PROFILER.snapshot(top_n=8)
        composition = {
            "profile_role_samples": {role: r["samples"]
                                     for role, r in snap["roles"].items()},
            "profile_top_frames": snap["top_frames"][:8],
            "cpu_attr": CPU_ATTR.summary(),
        }
        print(json.dumps(
            {"composition": composition["profile_role_samples"]}))

        doc = {
            "bench": "xllm_service_tpu_torch/benchmarks/"
                     "bench_profile_overhead.py",
            "profile_hz": PROFILE_HZ,
            "sample_tick_us": round(tick_us, 1),
            "amortized_cpu_pct": round(amortized_pct, 4),
            "modes": results,
            "overall_p50_delta_pct": overhead_pct,
            "composition": composition,
            # Signed: negative = measured faster than off (noise). The
            # headline is the paired-round median — the overall p50
            # delta is the more drift-contaminated estimator.
            "headline": {
                "profile_overhead_pct": paired_median_pct,
            },
        }
        print("BENCH_DOC " + json.dumps(doc))
        return doc
    finally:
        for _ in range(-net_refs):      # a round cut short: the refs
            PROFILER.start()           # back as the master holds them
        for _ in range(net_refs):
            PROFILER.stop()
        session.close()
        if engine is not None:
            engine.stop()
        master.stop()
        store.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_ROUNDS} rounds of {QUICK_PER_ROUND}")
    args = ap.parse_args(argv)
    doc = run(*((QUICK_ROUNDS, QUICK_PER_ROUND) if args.quick
               else (ROUNDS, PER_ROUND)))
    gate = gate_pct()
    overhead_pct = doc["overall_p50_delta_pct"]
    paired_median_pct = doc["headline"]["profile_overhead_pct"]
    if not passes(doc, gate):
        print(f"FAIL: profiler overhead {overhead_pct}% (paired "
              f"{paired_median_pct}%) exceeds the {gate}% gate")
        sys.exit(1)
    print(f"OK: profiler overhead {overhead_pct}% (paired "
          f"{paired_median_pct}%) within the {gate}% gate")


if __name__ == "__main__":
    main()
