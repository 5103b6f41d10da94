"""Tracing-overhead micro-bench of the port (twin of the repository's
``benchmarks/bench_tracing_overhead.py``).

Measures the fake-engine request path end to end (the port's HTTP
frontend -> scheduler -> fake engine -> generations ingest -> response)
under four tracer configurations, against ONE shared in-process cluster
with the modes interleaved round-robin (cluster-to-cluster and drift
noise would otherwise swamp the sub-ms effect being measured):

- ``off``     — tracing disabled: every span call is one attribute check +
                shared no-op singleton.
- ``ring``    — spans recorded into the in-memory SpanStore ring (default).
- ``sampled`` — ring at ``sample_rate=0.1`` with tail-based keep.
- ``jsonl``   — ring + every finished span mirrored into a RequestTracer
                JSONL.

Also times the disabled ``start_span`` call in isolation (ns/call), and
the cost of one ``/admin/trace?scope=fleet`` assembly and one
``/metrics/fleet`` scrape against the live cluster.

    python -m xllm_service_tpu_torch.benchmarks.bench_tracing_overhead
    python -m xllm_service_tpu_torch.benchmarks.bench_tracing_overhead --quick

Prints one JSON line per mode plus p50 overhead ratios against ``off``,
and a ``BENCH_DOC`` line with the reference's document keys.
``--quick`` (not in the reference) is 2 rounds of 20 requests a mode
(the reference's 12 of 40).
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

from .stack import Session

MODES = ("off", "ring", "sampled", "jsonl")
ROUNDS, PER_ROUND = 12, 40
QUICK_ROUNDS, QUICK_PER_ROUND = 2, 20


def disabled_span_call_ns(iters: int = 200_000) -> float:
    from ..common.tracing import Tracer

    tr = Tracer()
    tr.configure(enabled=False)
    t0 = time.perf_counter()
    for _ in range(iters):
        sp = tr.start_span("frontend.request")
        sp.end()
    return (time.perf_counter() - t0) / iters * 1e9


def run(rounds: int = ROUNDS, per_round: int = PER_ROUND) -> dict:
    """The bench at ``rounds`` rounds of ``per_round`` requests a mode;
    prints the reference's JSON lines and returns its document."""
    from ..common.config import ServiceOptions
    from ..common.tracing import TRACER
    from ..coordination.memory import InMemoryCoordination, MemoryStore
    from ..http_service.request_tracer import RequestTracer
    from ..master import Master
    from ..testing.fake_engine import FakeEngine, FakeEngineConfig

    print(json.dumps({"disabled_span_call_ns":
                     round(disabled_span_call_ns(), 1)}))

    store = MemoryStore(expiry_tick_s=0.05)
    opts = ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                          lease_ttl_s=2.0, sync_interval_s=1.0)
    master = Master(opts, coord=InMemoryCoordination(store))
    engine = jsonl_tracer = None
    session = Session()
    trace_dir = tempfile.TemporaryDirectory(prefix="bench-trace-")
    try:
        master.start()
        # Single-delta replies: the per-request fixed path (accept ->
        # schedule -> forward -> generate -> ingest -> respond) is what
        # tracing instruments; multi-delta streaming only adds thread-
        # scheduling noise.
        engine = FakeEngine(
            InMemoryCoordination(store),
            FakeEngineConfig(reply_text="x" * 8, chunk_size=8,
                             delay_s=0.0)).start()
        deadline = time.time() + 10
        while not master.scheduler.has_available_instances():
            if time.time() > deadline:
                raise RuntimeError("fake engine never became available")
            time.sleep(0.05)

        jsonl_tracer = RequestTracer(trace_dir.name, enabled=True)

        def mirror(span: dict) -> None:
            jsonl_tracer.log(span.get("request_id", ""),
                             {"type": "span", "span": span})

        def set_mode(mode: str) -> None:
            TRACER.configure(enabled=mode != "off",
                             mirror=mirror if mode == "jsonl" else None,
                             sample_rate=0.1 if mode == "sampled" else 1.0)

        url = f"http://127.0.0.1:{master.http_port}/v1/completions"
        body = {"model": "fake-model", "prompt": "bench", "max_tokens": 8}

        def one() -> float:
            t0 = time.perf_counter()
            r = session.post(url, json=body, timeout=30)
            assert r.status_code == 200, r.text
            return (time.perf_counter() - t0) * 1000.0

        for _ in range(50):   # warmup (threads, sockets, code paths)
            one()

        lat: dict[str, list[float]] = {m: [] for m in MODES}
        for _ in range(rounds):
            for mode in MODES:
                set_mode(mode)
                lat[mode].extend(one() for _ in range(per_round))
        set_mode("ring")

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
        overheads = {}
        for mode in ("ring", "sampled", "jsonl"):
            ratio = (results[mode]["p50_ms"] - base) / base * 100.0
            overheads[mode] = round(ratio, 2)
            print(json.dumps({"overhead_vs_off": mode, "p50_pct": ratio}))

        # Fleet-endpoint query cost (not on the request path).
        recent = session.get(
            f"http://127.0.0.1:{master.http_port}/admin/trace/recent",
            timeout=10).json()
        sid = recent["traces"][0]["request_id"] if recent["traces"] else ""
        fleet = {}
        for name, path, params in (
                ("fleet_trace_ms", "/admin/trace",
                 {"scope": "fleet", "request_id": sid}),
                ("fleet_metrics_ms", "/metrics/fleet", {})):
            t0 = time.perf_counter()
            r = session.get(f"http://127.0.0.1:{master.http_port}{path}",
                            params=params, timeout=10)
            fleet[name] = round((time.perf_counter() - t0) * 1000.0, 3)
            assert r.status_code == 200, (path, r.status_code)
        print(json.dumps(fleet))

        doc = {
            "bench": "xllm_service_tpu_torch/benchmarks/"
                     "bench_tracing_overhead.py",
            "modes": results,
            "fleet_endpoint_cost": fleet,
            # Signed: negative = measured faster than off (noise).
            "headline": {
                "ring_overhead_p50_pct": overheads["ring"],
                "sampled_overhead_p50_pct": overheads["sampled"],
            },
        }
        print("BENCH_DOC " + json.dumps(doc))
        return doc
    finally:
        TRACER.configure(enabled=True, mirror=None, sample_rate=1.0)
        session.close()
        if jsonl_tracer is not None:
            jsonl_tracer.close()
        if engine is not None:
            engine.stop()
        master.stop()
        store.close()
        trace_dir.cleanup()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_ROUNDS} rounds of {QUICK_PER_ROUND}")
    args = ap.parse_args(argv)
    run(*((QUICK_ROUNDS, QUICK_PER_ROUND) if args.quick
               else (ROUNDS, PER_ROUND)))


if __name__ == "__main__":
    main()
