"""Master hot-path micro-benchmark of the port (twin of the repository's
``benchmarks/master_hotpath_bench.py``): the master+wire span, measured
directly per stage, on the port's processes.

A deployment-shaped stack — the port's coordination server, master(s)
and fake engine(s), each its own OS process (``python -m
xllm_service_tpu_torch.coordination.server``, ``...master``,
``...testing.fake_engine``) — where the fake engine replies instantly, so
client TTFT ~= frontend parse + schedule + dispatch wire + token-return
wire + SSE emit. Per-stage attribution comes from the master's ``GET
/admin/hotpath`` (schedule / enrich / forward / first_delta, and the
ingest/route/stream CPU buckets).

    python -m xllm_service_tpu_torch.benchmarks.master_hotpath_bench \\
        --requests 256 --concurrency 8
    python -m xllm_service_tpu_torch.benchmarks.master_hotpath_bench --quick

The reference's flags, defaults and report keys: ``--masters N`` spreads
the driver's workers over N active frontends; ``--heartbeat-storm M``
heartbeats M simulated instances at ``--storm-hz`` from driver threads
for the whole drive window; ``--telemetry-mode shard|master``;
``--traffic diurnal|burst`` on top of ``--rps`` (:func:`_due_offsets`).
``--quick`` (not in the reference) is 48 requests at concurrency 4.

The driver is the standard library's: each worker keeps one connection
(``stack.Session``), streams are read line by line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

from .stack import (
    Children,
    RequestException,
    Session,
    free_port,
    module_cmd,
    percentile,
    proc_cpu_s,
)
from .stack import get as http_get
from .stack import post as http_post

QUICK = dict(requests=48, concurrency=4)


def _due_offsets(n: int, args) -> "list[float]":
    """Open-loop due times (seconds from pace start) for request k=0..n-1
    under the selected traffic shape. steady = constant --rps;
    diurnal = sinusoidal rate swing (amplitude --diurnal-amp around the
    base, period --diurnal-period); burst = --burst-mult x the base rate
    for --burst-len out of every --burst-every seconds. Time-varying
    schedules integrate 1/rate(t) stepwise so the OFFERED rate follows
    the profile exactly."""
    base = getattr(args, "rps", 0.0) or 0.0
    mode = getattr(args, "traffic", "steady")
    if base <= 0 or mode == "steady":
        return [k / base if base > 0 else 0.0 for k in range(n)]
    import math

    offsets: list[float] = []
    t = 0.0
    for _ in range(n):
        offsets.append(t)
        if mode == "diurnal":
            amp = min(0.95, max(0.0, getattr(args, "diurnal_amp", 0.6)))
            period = max(1.0, getattr(args, "diurnal_period", 20.0))
            rate = base * (1.0 + amp * math.sin(2 * math.pi * t / period))
        else:   # burst
            every = max(1.0, getattr(args, "burst_every", 10.0))
            blen = min(every, max(0.1, getattr(args, "burst_len", 2.0)))
            mult = max(1.0, getattr(args, "burst_mult", 4.0))
            # Off-window rate compensates so the MEAN offered rate stays
            # at the base (bursts test absorption, not extra volume).
            off_rate = base * max(0.1, (every - blen * mult)
                                  / max(0.1, every - blen))
            rate = base * mult if (t % every) < blen else off_rate
        t += 1.0 / max(0.1, rate)
    return offsets


class HeartbeatStorm:
    """Driver-side heartbeat storm: M simulated instances (DEFAULT role,
    draining=True so they never enter routing) registered in
    coordination with kept-alive leases, heartbeating at ``hz`` each.
    Destination: the rendezvous telemetry owner (shard mode — resolved
    from the mirrored SERVICE membership, like a real engine) or the
    elected master (the legacy-funnel baseline)."""

    def __init__(self, coord, n: int, hz: float, mode: str,
                 workers: int = 8):
        self.coord = coord
        self.n = n
        self.hz = max(0.1, hz)
        self.mode = mode
        self.names = [f"127.1.{i // 250}.{1 + i % 250}:9"
                      for i in range(n)]
        self.sent = 0
        self.errors = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._workers = max(1, min(workers, n))
        self._members: list[str] = []
        self._master = ""

    def start(self) -> "HeartbeatStorm":
        import uuid

        from ..common.types import InstanceMetaInfo, InstanceType
        from ..rpc import instance_key

        for name in self.names:
            meta = InstanceMetaInfo(
                name=name, rpc_address=name, type=InstanceType.DEFAULT,
                draining=True, incarnation_id=uuid.uuid4().hex[:12],
                models=["fake-model"])
            self.coord.set(instance_key("DEFAULT", name), meta.to_json(),
                           ttl_s=10.0)
        t = threading.Thread(target=self._membership_loop, daemon=True)
        t.start()
        self._threads.append(t)
        self._refresh_membership()
        for w in range(self._workers):
            t = threading.Thread(target=self._worker, args=(w,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _refresh_membership(self) -> None:
        from ..rpc import MASTER_KEY, SERVICE_KEY_PREFIX

        try:
            self._members = [
                k[len(SERVICE_KEY_PREFIX):]
                for k in self.coord.get_prefix(SERVICE_KEY_PREFIX)
                if k != MASTER_KEY]
            self._master = self.coord.get(MASTER_KEY) or ""
        except Exception:  # noqa: BLE001 — next refresh retries
            pass

    def _membership_loop(self) -> None:
        while not self._stop.wait(1.0):
            self._refresh_membership()

    def _worker(self, w: int) -> None:
        from ..multimaster import telemetry_owner
        from ..rpc import wire as _wire

        session = Session()
        mine = self.names[w::self._workers]
        interval = 1.0 / self.hz
        while not self._stop.is_set():
            t0 = time.monotonic()
            for i, name in enumerate(mine):
                if self._stop.is_set():
                    session.close()
                    return
                if self.mode == "shard":
                    target = telemetry_owner(self._members, name) \
                        or self._master
                else:
                    target = self._master
                if not target:
                    continue
                payload = {
                    "name": name, "incarnation_id": "",
                    "load_metrics": {
                        "waiting_requests_num": i % 5,
                        "running_requests_num": i % 3,
                        "hbm_cache_usage_perc": 0.2,
                    },
                    "latency_metrics": {"recent_max_ttft": 20.0,
                                        "recent_max_tbt": 5.0},
                }
                body, ctype = _wire.encode_dispatch(payload,
                                                    _wire.WIRE_MSGPACK)
                try:
                    session.post(f"http://{target}/rpc/heartbeat",
                                 data=body,
                                 headers={"Content-Type": ctype},
                                 timeout=3)
                    self.sent += 1
                except RequestException:
                    self.errors += 1
            # Pace the sweep so each instance beats at ~hz.
            elapsed = time.monotonic() - t0
            if elapsed < interval:
                time.sleep(interval - elapsed)
        session.close()

    def stop(self) -> dict:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        return {"instances": self.n, "hz": self.hz, "mode": self.mode,
                "beats_sent": self.sent, "errors": self.errors}


def _admin_cpu(base: str) -> dict:
    """One master's /admin/hotpath cpu + telemetry sections ({} when
    unreachable)."""
    try:
        r = http_get(base + "/admin/hotpath", timeout=5)
        if r.status_code != 200:
            return {}
        payload = r.json()
        return {"cpu": payload.get("cpu", {}),
                "telemetry": {k: v for k, v in
                              (payload.get("telemetry") or {}).items()
                              if k != "load_info_ages_s"}}
    except (RequestException, ValueError):
        return {}


def _engine_telemetry(coord) -> "list[dict]":
    """Scrape every registered engine's /metrics for the telemetry
    connection counters (the O(engines) fan-out evidence)."""
    from ..rpc import INSTANCE_KEY_PREFIX, parse_instance_key

    out = []
    for key in coord.get_prefix(INSTANCE_KEY_PREFIX):
        _t, name = parse_instance_key(key)
        if name.endswith(":9"):
            continue   # storm instances have no HTTP surface
        try:
            r = http_get(f"http://{name}/metrics", timeout=3)
        except RequestException:
            continue
        row = {"engine": name}
        for line in r.text.splitlines():
            if line.startswith("engine_telemetry_"):
                k, _, v = line.rpartition(" ")
                try:
                    row[k.replace("engine_telemetry_", "")] = float(v)
                except ValueError:
                    pass
        out.append(row)
    return out


# ~1 KiB prompt -> 1024 token ids through the byte-level SimpleTokenizer:
# the enriched dispatch payload carries a multi-thousand-byte token_ids
# list, which is exactly the wire cost this bench exists to attribute.
_PROMPT_WORD = "hotpath "


def _make_prompt(n_chars: int) -> str:
    return (_PROMPT_WORD * (n_chars // len(_PROMPT_WORD) + 1))[:n_chars]


def read_stream(r, t0: float) -> "tuple[float | None, bool]":
    """(seconds from ``t0`` to the first data line, whether ``[DONE]``
    came) of one SSE response, read to its end."""
    ttft = None
    done = False
    for line in r.iter_lines():
        if not line.startswith(b"data: "):
            continue
        if ttft is None:
            ttft = time.perf_counter() - t0
        if line == b"data: [DONE]":
            done = True
            break
    r.close()
    return ttft, done


def drive(base, args) -> dict:
    """Fire the streaming workload at the master(s) and collect
    client-side TTFT/E2E percentiles plus the per-stage span table.
    `base` may be one URL or a list (multi-master: workers spread
    round-robin across the active frontends)."""
    bases = [base] if isinstance(base, str) else list(base)
    prompt = _make_prompt(args.prompt_chars)
    # Heterogeneous mix (the CAR-default soak): every request gets a
    # UNIQUE prompt (index prefix changes block 0, so the whole hash
    # chain differs -> zero prefix overlap, CAR's worst case) at one of
    # three lengths. Identical-prompt mode (default) is the cache-hot
    # best case.
    distinct = bool(getattr(args, "distinct_prompts", False))

    def prompt_for(k: int) -> str:
        if not distinct:
            return prompt
        n = (args.prompt_chars // 2, args.prompt_chars,
             args.prompt_chars * 2)[k % 3]
        return f"{k:08d}" + _make_prompt(n - 8)

    # Warmup: prime connection pools, lazy imports, the schedule executor.
    for b in bases:
        for _ in range(4):
            r = http_post(b + "/v1/completions", json={
                "model": "fake-model", "prompt": prompt, "max_tokens": 4,
                "stream": True}, timeout=30)
            r.close()

    ttfts, e2es, errors = [], [], [0]
    lock = threading.Lock()  # xlint: allow-local-lock(the drive's result lists; its workers join before it returns)
    work = list(range(args.requests))
    rps = getattr(args, "rps", 0.0) or 0.0
    # Precomputed open-loop schedule (steady constant-rate, or the
    # diurnal/burst profile): slot j = offsets[j] seconds after start.
    offsets = _due_offsets(args.requests, args) if rps > 0 else None
    pace_start = time.perf_counter() + 0.05

    def worker(wbase):
        session = Session()
        base = wbase
        while True:
            with lock:
                if not work:
                    session.close()
                    return
                k = work.pop()
            if rps > 0:
                # Paced (open-loop) mode: request k is DUE at a fixed wall
                # slot, and latency is measured from the slot, not from
                # the actual send — a tree that can't keep up accrues the
                # queueing delay instead of hiding it (coordinated
                # omission). k counts down; slots are order-insensitive.
                due = pace_start + offsets[args.requests - 1 - k]
                now = time.perf_counter()
                if due > now:
                    time.sleep(due - now)
                t0 = due
            else:
                t0 = time.perf_counter()
            try:
                r = session.post(base + "/v1/completions", json={
                    "model": "fake-model", "prompt": prompt_for(k),
                    "max_tokens": args.max_tokens, "stream": True},
                    stream=True, timeout=60)
                ttft, _ = read_stream(r, t0)
                e2e = time.perf_counter() - t0
                if ttft is None:
                    raise RuntimeError("stream produced no deltas")
                with lock:
                    ttfts.append(ttft * 1000)
                    e2es.append(e2e * 1000)
            except Exception:  # noqa: BLE001 — counted, not fatal
                with lock:
                    errors[0] += 1

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(bases[i % len(bases)],))
               for i in range(args.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start

    report = {
        "requests": args.requests,
        "masters": len(bases),
        "concurrency": args.concurrency,
        "prompt_chars": args.prompt_chars,
        "max_tokens": args.max_tokens,
        "offered_rps": rps or None,
        "errors": errors[0],
        "req_per_s": round(len(e2es) / wall, 1) if wall else 0.0,
        "master_wire_ttft_ms": {
            "p50": round(percentile(ttfts, 50), 2),
            "p90": round(percentile(ttfts, 90), 2),
            "p99": round(percentile(ttfts, 99), 2),
            "mean": round(statistics.mean(ttfts), 2) if ttfts else 0.0,
        },
        "e2e_ms": {"p50": round(percentile(e2es, 50), 2),
                   "p99": round(percentile(e2es, 99), 2)},
    }
    # Per-stage master span table. Multi-master: the first frontend's
    # table is representative (workers are spread evenly); ownership
    # stats show mining hit rate per master.
    try:
        r = http_get(bases[0] + "/admin/hotpath", timeout=5)
        if r.status_code == 200:
            payload = r.json()
            report["master_stages_ms"] = payload.get("stages", {})
            if payload.get("ownership"):
                report["ownership"] = payload["ownership"]
    except (RequestException, ValueError):
        pass
    if len(bases) > 1:
        # Per-frontend ownership/mining stats: mined-to-self accepts pay
        # no forward hop.
        per_master = []
        for b in bases:
            try:
                r = http_get(b + "/admin/hotpath", timeout=5)
                per_master.append(r.json().get("ownership", {})
                                  if r.status_code == 200 else {})
            except (RequestException, ValueError):
                per_master.append({})
        report["ownership_per_master"] = per_master
    return report


def wait_serving(children: Children, bases: "list[str]",
                 timeout: float = 60.0) -> None:
    """Poll each frontend with a tiny completion until every one answers
    200; raise if a child dies or the deadline passes."""
    deadline = time.monotonic() + timeout
    ready: set[str] = set()
    while time.monotonic() < deadline:
        children.check()
        for base in bases:
            if base in ready:
                continue
            try:
                r = http_post(base + "/v1/completions", json={
                    "model": "fake-model", "prompt": "ready?",
                    "max_tokens": 2}, timeout=10)
                if r.status_code == 200:
                    ready.add(base)
            except RequestException:
                pass
        if len(ready) == len(bases):
            return
        time.sleep(0.25)
    raise RuntimeError(
        f"cluster never became ready ({len(ready)}/{len(bases)} "
        f"frontends serving)")


def run_bench(requests_n: int = 256, concurrency: int = 8,
              prompt_chars: int = 1024, max_tokens: int = 16,
              reply_chars: int = 64, rps: float = 0.0,
              policy: str = "RR", n_engines: int = 1,
              n_masters: int = 1,
              master_args: tuple = (),
              distinct_prompts: bool = False,
              telemetry_mode: str = "shard",
              heartbeat_storm: int = 0, storm_hz: float = 2.0,
              traffic: str = "steady", diurnal_period: float = 20.0,
              diurnal_amp: float = 0.6, burst_every: float = 10.0,
              burst_len: float = 2.0, burst_mult: float = 4.0) -> dict:
    """Spawn the port's multiproc stack, drive it, tear it down.
    ``policy`` selects the master's load-balance policy (RR | CAR |
    SLO_AWARE); ``n_engines`` > 1 gives the policy a real choice.
    ``n_masters`` > 1 spawns an active-active multi-master service plane
    (the first wins the election and carries the write lease) and the
    driver spreads its workers evenly across the frontends."""
    n_masters = max(1, n_masters)
    args = argparse.Namespace(
        requests=requests_n, concurrency=concurrency,
        prompt_chars=prompt_chars, max_tokens=max_tokens, rps=rps,
        distinct_prompts=distinct_prompts, traffic=traffic,
        diurnal_period=diurnal_period, diurnal_amp=diurnal_amp,
        burst_every=burst_every, burst_len=burst_len,
        burst_mult=burst_mult)
    coord_port = free_port()
    http_ports = [free_port() for _ in range(n_masters)]
    rpc_ports = [free_port() for _ in range(n_masters)]
    children = Children("hotpath_bench")
    coord = None
    storm = None
    try:
        children.spawn("coord", module_cmd(
            "xllm_service_tpu_torch.coordination.server",
            "--host", "127.0.0.1", "--port", str(coord_port)))
        time.sleep(0.3)
        for i in range(n_masters):
            children.spawn(f"master{i}", module_cmd(
                "xllm_service_tpu_torch.master",
                "--coordination-addr", f"127.0.0.1:{coord_port}",
                "--host", "127.0.0.1",
                "--http-port", str(http_ports[i]),
                "--rpc-port", str(rpc_ports[i]),
                "--load-balance-policy", policy,
                "--telemetry-ingest-mode", telemetry_mode,
                *master_args))
            if i == 0 and n_masters > 1:
                # Let master0 win the election deterministically so the
                # write lease (frames, LOADMETRICS, planner) sits on a
                # known process for the whole run.
                time.sleep(0.5)
        # Engines mirror the service-plane mode: multiplexed owner-routed
        # telemetry under sharding, the legacy elected-master funnel for
        # the baseline.
        engine_telemetry = "mux" if telemetry_mode == "shard" else "master"
        for i in range(max(1, n_engines)):
            children.spawn(f"engine{i}", module_cmd(
                "xllm_service_tpu_torch.testing.fake_engine",
                "--coordination-addr", f"127.0.0.1:{coord_port}",
                "--reply", "x" * reply_chars,
                "--chunk-size", "4", "--delay", "0",
                "--telemetry-mode", engine_telemetry))

        bases = [f"http://127.0.0.1:{p}" for p in http_ports]
        wait_serving(children, bases)
        if heartbeat_storm > 0:
            from ..coordination import connect
            coord = connect(f"127.0.0.1:{coord_port}")
            storm = HeartbeatStorm(coord, heartbeat_storm, storm_hz,
                                   telemetry_mode).start()
            # Let the fleet register the storm instances before driving.
            time.sleep(2.0)
        names = [n for n, _ in children.procs]
        procs = [p for _, p in children.procs]
        cpu0 = {n: proc_cpu_s(p.pid) for n, p in zip(names, procs)}
        attr0 = {f"master{i}": _admin_cpu(b) for i, b in enumerate(bases)}
        report = drive(bases if n_masters > 1 else bases[0], args)
        # Per-process CPU attribution over the drive window: on a small
        # box the aggregate rps saturates on TOTAL cpu, so the scaling
        # evidence is each of N masters doing ~1/N of the frontend work.
        cpu = {n: round(proc_cpu_s(p.pid) - cpu0[n], 2)
               for n, p in zip(names, procs)}
        report["cpu_s_during_drive"] = cpu
        # Per-master ingest/route/stream CPU buckets over the drive
        # (thread_time measured inside the handlers) and each bucket's
        # share of the process's total CPU.
        attr: dict = {}
        for i, b in enumerate(bases):
            name = f"master{i}"
            after = _admin_cpu(b)
            buckets = {}
            for cat, row in (after.get("cpu") or {}).items():
                before = ((attr0.get(name) or {}).get("cpu") or {}) \
                    .get(cat, {})
                cpu_s = round(row.get("cpu_s", 0.0)
                              - before.get("cpu_s", 0.0), 3)
                total = max(1e-9, cpu.get(name, 0.0))
                buckets[cat] = {
                    "cpu_s": cpu_s,
                    "share_of_proc": round(cpu_s / total, 4),
                    "n": row.get("n", 0) - before.get("n", 0),
                }
            attr[name] = {"buckets": buckets,
                          "telemetry": after.get("telemetry", {})}
        report["master_cpu_attribution"] = attr
        if storm is not None:
            report["heartbeat_storm"] = storm.stop()
            storm = None
        if coord is not None:
            report["engine_telemetry"] = _engine_telemetry(coord)
        served = max(1, args.requests - report.get("errors", 0))
        master_cpu = sum(v for n, v in cpu.items() if n.startswith("master"))
        report["master_cpu_ms_per_request"] = round(
            master_cpu * 1000.0 / served, 2)
        report["policy"] = policy
        report["n_engines"] = max(1, n_engines)
        report["telemetry_mode"] = telemetry_mode
        report["traffic"] = traffic
        return report
    finally:
        if storm is not None:
            storm.stop()
        if coord is not None:
            coord.close()
        children.stop()


STAGES = ("schedule", "enrich", "forward", "first_delta")


def gate(report: dict) -> "list[str]":
    """The reference's acceptance for one run: no errors, and the four
    stages of ``/admin/hotpath`` present. Returns what failed."""
    bad = []
    if report.get("errors"):
        bad.append(f"errors {report['errors']}")
    missing = [s for s in STAGES
               if s not in (report.get("master_stages_ms") or {})]
    if missing:
        bad.append(f"stages missing: {missing}")
    return bad


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--prompt-chars", type=int, default=1024,
                    help="prompt length in bytes (byte-level tokenizer: "
                         "== token_ids length on the dispatch wire)")
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--reply-chars", type=int, default=64)
    ap.add_argument("--rps", type=float, default=0.0,
                    help="paced open-loop request rate (0 = closed-loop); "
                         "paced TTFT is measured from the request's due "
                         "slot, so queueing delay is counted, not hidden")
    ap.add_argument("--policy", default="RR",
                    help="master load-balance policy (RR | CAR | SLO_AWARE)")
    ap.add_argument("--engines", type=int, default=1,
                    help="fake engine instances (give CAR a real choice)")
    ap.add_argument("--masters", type=int, default=1,
                    help="active frontends (multi-master service plane); "
                         "workers are spread evenly across them")
    ap.add_argument("--distinct-prompts", action="store_true",
                    help="unique prompt per request at 3 lengths (zero "
                         "prefix overlap — the heterogeneous-mix soak for "
                         "the CAR default)")
    ap.add_argument("--telemetry-mode", default="shard",
                    choices=["shard", "master"],
                    help="shard = rendezvous-owned heartbeat ingest + "
                         "multiplexed engine sessions (default); master "
                         "= legacy elected-master funnel (the ingest-"
                         "share baseline)")
    ap.add_argument("--heartbeat-storm", type=int, default=0,
                    help="register this many simulated instances and "
                         "heartbeat them from the driver for the whole "
                         "drive window (the telemetry-ingest load)")
    ap.add_argument("--storm-hz", type=float, default=2.0,
                    help="heartbeats per second per storm instance")
    ap.add_argument("--traffic", default="steady",
                    choices=["steady", "diurnal", "burst"],
                    help="open-loop schedule shape on top of --rps")
    ap.add_argument("--diurnal-period", type=float, default=20.0)
    ap.add_argument("--diurnal-amp", type=float, default=0.6)
    ap.add_argument("--burst-every", type=float, default=10.0)
    ap.add_argument("--burst-len", type=float, default=2.0)
    ap.add_argument("--burst-mult", type=float, default=4.0)
    ap.add_argument("--quick", action="store_true",
                    help=f"CI-sized: {QUICK['requests']} requests at "
                         f"concurrency {QUICK['concurrency']}")
    args = ap.parse_args(argv)
    if args.quick:
        args.requests, args.concurrency = (QUICK["requests"],
                                           QUICK["concurrency"])
    report = run_bench(args.requests, args.concurrency, args.prompt_chars,
                       args.max_tokens, args.reply_chars, args.rps,
                       policy=args.policy, n_engines=args.engines,
                       n_masters=args.masters,
                       distinct_prompts=args.distinct_prompts,
                       telemetry_mode=args.telemetry_mode,
                       heartbeat_storm=args.heartbeat_storm,
                       storm_hz=args.storm_hz,
                       traffic=args.traffic,
                       diurnal_period=args.diurnal_period,
                       diurnal_amp=args.diurnal_amp,
                       burst_every=args.burst_every,
                       burst_len=args.burst_len,
                       burst_mult=args.burst_mult)
    report["distinct_prompts"] = args.distinct_prompts
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
