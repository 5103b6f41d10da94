"""Generations-ingest micro-bench of the port (twin of the repository's
``benchmarks/generations_bench.py``): deltas/sec the port's service plane
sustains on ``/rpc/generations`` (HTTP parse + scheduler dispatch + SSE
fan-out), for msgpack against JSON framing. The msgpack frames come from
``rpc/msgpack_lite.py``.

    python -m xllm_service_tpu_torch.benchmarks.generations_bench
    python -m xllm_service_tpu_torch.benchmarks.generations_bench --quick

Prints one JSON line per framing and the ratio. ``--quick`` (not in the
reference) stops each framing's drive of 60 POSTs of 32 deltas once it
has run 2 s.
"""

from __future__ import annotations

import argparse
import json
import time
import uuid

from ..rpc import msgpack_lite
from .stack import Session

BATCH = 32        # deltas per POST (the agent's flush batching)
ROUNDS = 60
N_REQ = 64
QUICK_DRIVE_S = 2.0


def generations_payload(sids, seq, r: int) -> dict:
    """The body of round ``r``: BATCH deltas over the in-flight requests
    (``seq`` counts each request's deltas)."""
    gens = []
    for k in range(BATCH):
        sid = sids[(r * BATCH + k) % len(sids)]
        seq[sid] += 1
        gens.append({
            "request_id": sid, "service_request_id": sid,
            "status": {"code": 0, "message": ""},
            "outputs": [{"index": 0, "text": "tok ",
                         "token_ids": [7], "finish_reason": "",
                         "logprobs": []}],
            "finished": False, "finished_on_prefill": False,
            "delta_seq": seq[sid],
        })
    return {"gens": gens}


def run(max_drive_s: float = 0.0) -> dict:
    """Both framings' drives of ROUNDS POSTs, each cut at ``max_drive_s``
    seconds when that is set; returns the reference's JSON lines."""
    from ..common.call_data import CollectingConnection
    from ..common.config import ServiceOptions
    from ..common.request import Request
    from ..common.types import InstanceType
    from ..coordination.memory import InMemoryCoordination, MemoryStore
    from ..master import Master
    from ..testing.fake_engine import FakeEngine, FakeEngineConfig

    store = MemoryStore(expiry_tick_s=0.05)
    opts = ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                          lease_ttl_s=2.0, sync_interval_s=1.0)
    master = Master(opts, coord=InMemoryCoordination(store))
    engine = None
    session = Session()
    try:
        master.start()
        engine = FakeEngine(
            InMemoryCoordination(store),
            FakeEngineConfig(instance_type=InstanceType.MIX)).start()
        deadline = time.time() + 10
        while not master.scheduler.has_available_instances():
            if time.time() > deadline:
                raise RuntimeError("fake engine never became available")
            time.sleep(0.05)

        # In-flight streaming requests for the deltas to land on.
        sids = []
        for _ in range(N_REQ):
            sid = f"bench-{uuid.uuid4().hex[:8]}"
            req = Request(service_request_id=sid, request_id=sid,
                          model="fake", stream=True, prompt="x",
                          token_ids=[1, 2, 3])
            assert master.scheduler.schedule(req).ok()
            master.scheduler.record_new_request(
                req, CollectingConnection(stream=True), "completion")
            sids.append(sid)

        url = f"http://127.0.0.1:{master.rpc_port}/rpc/generations"
        results, lines = {}, []
        for mode in ("json", "msgpack"):
            seq = {sid: 0 for sid in sids}
            t0 = time.perf_counter()
            n = 0
            for r in range(ROUNDS):
                body = generations_payload(sids, seq, r)
                if mode == "msgpack":
                    resp = session.post(
                        url, data=msgpack_lite.packb(body),
                        headers={"Content-Type": "application/msgpack"},
                        timeout=10)
                else:
                    resp = session.post(url, json=body, timeout=10)
                assert resp.status_code == 200, resp.text
                n += BATCH
                if max_drive_s and time.perf_counter() - t0 >= max_drive_s:
                    break
            dt = time.perf_counter() - t0
            results[mode] = n / dt
            lines.append({"mode": mode, "deltas_per_s": round(n / dt, 1),
                          "batch": BATCH})
        lines.append({
            "metric": "generations_ingest_msgpack_vs_json",
            "value": round(results["msgpack"] / results["json"], 3),
            "unit": "x",
            "deltas_per_s": round(results["msgpack"], 1),
        })
        return {"lines": lines}
    finally:
        session.close()
        if engine is not None:
            engine.stop()
        master.stop()
        store.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help=f"stop each framing's drive after {QUICK_DRIVE_S:g} "
                         "s")
    args = ap.parse_args(argv)
    for line in run(max_drive_s=QUICK_DRIVE_S if args.quick else 0.0)[
            "lines"]:
        print(json.dumps(line))


if __name__ == "__main__":
    main()
