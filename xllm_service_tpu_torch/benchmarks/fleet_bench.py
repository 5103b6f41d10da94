"""Fleet-scale service-plane bench of the port (twin of the repository's
``benchmarks/fleet_bench.py``): masters-N scaling + native A/B.

One run spawns a deployment-shaped fleet — the port's coordination
server, N masters, M fake engines and an OPEN-LOOP driver, each its own
OS process — and measures two things:

1. **masters-{1,2,4} scaling curve**: aggregate served rps as active
   frontends are added, with per-master CPU attribution
   (``/admin/hotpath`` route/ingest/stream buckets) and continuous-
   profiler composition (``/admin/profile``) alongside.
2. **native hot-path A/B** (masters=1): the same drive with
   ``XLLM_NATIVE`` on against off — the per-request route+stream CPU that
   the port's native core (``common/native.py`` on ``csrc/hotcore.c``)
   buys.

CPU isolation: :func:`plan_cpu_sets` assigns DISJOINT CPU sets — one
exclusive core per master, one set for the engines+coordination, the
remainder to the driver — and :func:`pin` pins each process with
``sched_setaffinity``. When the box is too small (fewer than masters+2
cores) the bench falls back to ``phased-projection`` mode with a warning:
each master is driven alone in its own window and the aggregate is the
SUM of per-master rates — an upper-bound projection, labeled as such in
the artifact (``"mode"``).

Workload: the ``master_hotpath_bench`` twin's diurnal/burst open-loop
generator (:func:`_due_offsets`) over a ``--streams`` pool (default
200k) of DISTINCT prompt streams across three tenant classes.

    python -m xllm_service_tpu_torch.benchmarks.fleet_bench --out fleet.json
    python -m xllm_service_tpu_torch.benchmarks.fleet_bench --quick
    python -m xllm_service_tpu_torch.benchmarks.fleet_bench --topo

``--quick`` (not in the reference) is the native A/B alone (``--max-masters
0``: no scaling legs) at 64 requests a side. The driver window runs as
``python -m xllm_service_tpu_torch.benchmarks.fleet_bench --drive SPEC``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

from .master_hotpath_bench import _admin_cpu, _due_offsets, wait_serving
from .stack import (
    ROOT,
    Children,
    RequestException,
    Session,
    child_env,
    free_port,
    module_cmd,
    percentile,
    proc_cpu_s,
)
from .stack import get as http_get
from .stack import post as http_post

QUICK = dict(requests=64, max_masters=0)

# Heterogeneous tenant mix: share of the stream population, prompt bytes
# (== token_ids length through the byte-level tokenizer) and the token
# budget. ``--prompt-scale`` shrinks the mix proportionally for smoke
# runs.
TENANTS = (
    {"name": "interactive", "share": 0.60, "prompt_chars": 2048,
     "max_tokens": 8},
    {"name": "agent", "share": 0.25, "prompt_chars": 8192,
     "max_tokens": 16},
    {"name": "batch", "share": 0.15, "prompt_chars": 24576,
     "max_tokens": 12},
)


def _warn(msg: str) -> None:
    print(f"[fleet_bench] WARNING: {msg}", file=sys.stderr, flush=True)


def _info(msg: str) -> None:
    print(f"[fleet_bench] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------ stream population
class StreamPopulation:
    """Deterministic sampler over ``n_streams`` distinct prompt streams.

    Stream k's identity prefix changes block 0 of the prompt, so every
    stream is a distinct prefix chain. Tenant class is a deterministic
    function of the stream id, so reruns and the native A/B legs see the
    SAME offered mix."""

    def __init__(self, n_streams: int, seed: int = 0x20,
                 prompt_scale: float = 1.0):
        self.n_streams = max(1, n_streams)
        self.seed = seed
        self.prompt_scale = max(0.01, prompt_scale)
        self._hit: set = set()
        # Cumulative tenant shares for the id->class map.
        acc, self._cut = 0.0, []
        for t in TENANTS:
            acc += t["share"]
            self._cut.append((acc, t))

    def _stream_id(self, k: int) -> int:
        # SplitMix64-style scramble: uniform over the population without
        # materializing it.
        z = (k + self.seed) * 0x9E3779B97F4A7C15 % (1 << 64)
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
        return (z ^ (z >> 31)) % self.n_streams

    def request_for(self, k: int) -> dict:
        sid = self._stream_id(k)
        self._hit.add(sid)
        frac = (sid + 0.5) / self.n_streams
        tenant = next(t for cut, t in self._cut if frac <= cut)
        chars = max(64, int(tenant["prompt_chars"] * self.prompt_scale))
        head = f"{tenant['name']}:{sid:08d}|"
        body = "fleet load " * (chars // 11 + 1)
        return {
            "tenant": tenant["name"],
            "prompt": (head + body)[:chars],
            "max_tokens": tenant["max_tokens"],
        }

    def stats(self) -> dict:
        return {"population": self.n_streams,
                "distinct_streams_hit": len(self._hit),
                "tenants": [{"name": t["name"], "share": t["share"],
                             "prompt_chars": t["prompt_chars"],
                             "max_tokens": t["max_tokens"]}
                            for t in TENANTS]}


# ---------------------------------------------------------------- CPU planning
def plan_cpu_sets(n_masters: int,
                  avail=None) -> "tuple[dict | None, str]":
    """Disjoint CPU sets: one exclusive core per master, one for the
    engine+coordination side, the rest for the driver. ``avail`` is the
    usable CPU set (this process's affinity when None). Returns (plan,
    reason); plan is None when the box cannot isolate (the caller then
    falls back to phased-projection mode)."""
    if avail is None:
        try:
            avail = os.sched_getaffinity(0)
        except (AttributeError, OSError):
            return None, "sched_getaffinity unavailable on this platform"
    avail = sorted(avail)
    need = n_masters + 2
    if len(avail) < need:
        return None, (f"{len(avail)} usable core(s) < {need} needed for "
                      f"{n_masters} exclusive master core(s) + engines + "
                      f"driver")
    plan = {f"master{i}": {avail[i]} for i in range(n_masters)}
    rest = avail[n_masters:]
    # Engines + coord share one set; the driver gets the remainder (at
    # least one core each by the `need` check above).
    split = max(1, len(rest) // 2)
    plan["engines"] = set(rest[:split])
    plan["driver"] = set(rest[split:]) or set(rest[:split])
    return plan, f"{len(avail)} cores, exclusive per-master sets"


def pin(pid: int, cpuset: "set[int]", what: str) -> bool:
    try:
        os.sched_setaffinity(pid, cpuset)
        return True
    except (AttributeError, OSError) as e:
        _warn(f"could not pin {what} to {sorted(cpuset)}: {e}")
        return False


# ------------------------------------------------------------------ the driver
#
# The driver is a SEPARATE PROCESS (this module run with --drive):
# process isolation keeps client-side JSON/HTTP work off the masters'
# cores even when pinning is unavailable, and gives the planner one pid
# to pin. The parent passes the window spec on the command line and
# reads one JSON report from stdout.

def drive_window(spec: dict) -> dict:
    """Open-loop drive of one measurement window (runs in the driver
    process). Latency is measured from each request's DUE slot
    (coordinated omission counted, not hidden)."""
    bases = spec["bases"]
    n = spec["requests"]
    pop = StreamPopulation(spec["streams"], seed=spec.get("seed", 0x20),
                           prompt_scale=spec.get("prompt_scale", 1.0))
    sched_args = argparse.Namespace(
        rps=spec["rps"], traffic=spec["traffic"],
        diurnal_amp=spec.get("diurnal_amp", 0.6),
        diurnal_period=spec.get("diurnal_period", 12.0),
        burst_every=spec.get("burst_every", 10.0),
        burst_len=spec.get("burst_len", 2.0),
        burst_mult=spec.get("burst_mult", 4.0))
    offsets = _due_offsets(n, sched_args)
    reqs = [pop.request_for(k) for k in range(n)]

    if spec.get("warmup", True):
        # Driver-side warmup (connection pools + lazy paths): the
        # standalone-driver fallback; the parent normally pre-warms.
        for b in bases:
            for w in range(3):
                try:
                    http_post(b + "/v1/completions", json={
                        "model": "fake-model", "prompt": reqs[w]["prompt"],
                        "max_tokens": 2, "stream": True}, timeout=30)
                except RequestException:
                    pass

    ttfts: list = []
    e2es: list = []
    per_tenant: dict = {t["name"]: [] for t in TENANTS}
    errors = [0]
    lock = threading.Lock()  # xlint: allow-local-lock(the drive's result lists; its workers join before it returns)
    # FIFO dispatch in due order: popping from the tail would have every
    # worker sleep to the LAST due slot first.
    next_k = [0]
    pace_start = time.perf_counter() + 0.05

    def worker(wbase: str) -> None:
        session = Session()
        while True:
            with lock:
                if next_k[0] >= n:
                    session.close()
                    return
                k = next_k[0]
                next_k[0] += 1
            due = pace_start + offsets[k]
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            req = reqs[k]
            try:
                r = session.post(wbase + "/v1/completions", json={
                    "model": "fake-model", "prompt": req["prompt"],
                    "max_tokens": req["max_tokens"], "stream": True},
                    stream=True, timeout=60)
                ttft = None
                for line in r.iter_lines():
                    if not line.startswith(b"data: "):
                        continue
                    if ttft is None:
                        ttft = time.perf_counter() - due
                    if line == b"data: [DONE]":
                        break
                r.close()
                e2e = time.perf_counter() - due
                if ttft is None:
                    raise RuntimeError("stream produced no deltas")
                with lock:
                    ttfts.append(ttft * 1000)
                    e2es.append(e2e * 1000)
                    per_tenant[req["tenant"]].append(ttft * 1000)
            except Exception:  # noqa: BLE001 — counted, not fatal
                with lock:
                    errors[0] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker,
                                args=(bases[i % len(bases)],))
               for i in range(spec["concurrency"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    served = len(e2es)
    return {
        "requests": n,
        "served": served,
        "errors": errors[0],
        "wall_s": round(wall, 2),
        "req_per_s": round(served / wall, 2) if wall else 0.0,
        "ttft_ms": {"p50": round(percentile(ttfts, 50), 2),
                    "p90": round(percentile(ttfts, 90), 2),
                    "p99": round(percentile(ttfts, 99), 2),
                    "mean": round(statistics.mean(ttfts), 2)
                    if ttfts else 0.0},
        "e2e_ms": {"p50": round(percentile(e2es, 50), 2),
                   "p99": round(percentile(e2es, 99), 2)},
        "ttft_p50_ms_by_tenant": {
            t: round(percentile(v, 50), 2) for t, v in per_tenant.items()},
        "streams": pop.stats(),
    }


def _spawn_driver(spec: dict, cpuset: "set[int] | None") -> dict:
    """Run one drive window in a separate driver process."""
    p = subprocess.Popen(
        module_cmd("xllm_service_tpu_torch.benchmarks.fleet_bench",
                   "--drive", json.dumps(spec)),
        stdout=subprocess.PIPE, cwd=str(ROOT), env=child_env())
    try:
        if cpuset:
            pin(p.pid, cpuset, "driver")
        out, _ = p.communicate(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    if p.returncode != 0:
        raise RuntimeError(f"driver window failed rc={p.returncode}")
    return json.loads(out)


# ------------------------------------------------------------------- the fleet
class Fleet:
    """The port's coordination server + N masters + M engines, each a
    separate process."""

    def __init__(self, n_masters: int, n_engines: int,
                 native_on: bool, reply_chars: int = 32,
                 chunk_size: int = 32,
                 master_extra: "list[str] | None" = None,
                 engine_specs: "list[list[str]] | None" = None):
        self.n_masters = n_masters
        self.n_engines = n_engines
        self.native_on = native_on
        self.reply_chars = reply_chars
        self.chunk_size = chunk_size
        # Topology A/B leg hooks: extra master flags (e.g.
        # --topology-tradeoff) and per-engine extra flags (role + slice
        # coordinates). engine_specs engines get explicit ports so their
        # /admin/topology endpoints are scrapeable (engine_bases).
        self.master_extra = list(master_extra or ())
        self.engine_specs = engine_specs
        self.engine_bases: "list[str]" = []
        self.children = Children(
            "fleet_bench",
            env=child_env(XLLM_NATIVE="1" if native_on else "0"))
        self.bases: "list[str]" = []
        self.pinned = False
        # Per-process affinity verdicts (machine-readable isolation
        # evidence for the artifact): name -> {cpuset, pinned}.
        self.pin_verdicts: "dict[str, dict]" = {}

    @property
    def names(self) -> "list[str]":
        return [n for n, _ in self.children.procs]

    @property
    def procs(self) -> list:
        return [p for _, p in self.children.procs]

    def start(self, plan: "dict | None") -> "Fleet":
        coord_port = free_port()
        http_ports = [free_port() for _ in range(self.n_masters)]
        rpc_ports = [free_port() for _ in range(self.n_masters)]
        self.children.spawn("coord", module_cmd(
            "xllm_service_tpu_torch.coordination.server",
            "--host", "127.0.0.1", "--port", str(coord_port)))
        time.sleep(0.3)
        for i in range(self.n_masters):
            self.children.spawn(f"master{i}", module_cmd(
                "xllm_service_tpu_torch.master",
                "--coordination-addr", f"127.0.0.1:{coord_port}",
                "--host", "127.0.0.1",
                "--http-port", str(http_ports[i]),
                "--rpc-port", str(rpc_ports[i]),
                "--load-balance-policy", "RR",
                "--telemetry-ingest-mode", "shard",
                *self.master_extra))
            if i == 0 and self.n_masters > 1:
                time.sleep(0.5)   # deterministic election winner
        n_engines = len(self.engine_specs) \
            if self.engine_specs is not None else self.n_engines
        for i in range(n_engines):
            cmd = module_cmd(
                "xllm_service_tpu_torch.testing.fake_engine",
                "--coordination-addr", f"127.0.0.1:{coord_port}",
                "--reply", "x" * self.reply_chars,
                "--chunk-size", str(self.chunk_size),
                "--delay", "0",
                "--telemetry-mode", "mux")
            if self.engine_specs is not None:
                eport = free_port()
                cmd += ["--host", "127.0.0.1", "--port", str(eport)]
                cmd += self.engine_specs[i]
                self.engine_bases.append(f"http://127.0.0.1:{eport}")
            self.children.spawn(f"engine{i}", cmd)
        if plan:
            ok = True
            for name, p in zip(self.names, self.procs):
                cpuset = plan.get(name) or plan["engines"]
                pinned = pin(p.pid, cpuset, name)
                self.pin_verdicts[name] = {"cpuset": sorted(cpuset),
                                           "pinned": pinned}
                ok = pinned and ok
            self.pinned = ok
        else:
            self.pin_verdicts = {n: {"cpuset": [], "pinned": False}
                                 for n in self.names}
        self.bases = [f"http://127.0.0.1:{p}" for p in http_ports]
        return self

    def wait_ready(self, timeout: float = 90.0) -> None:
        wait_serving(self.children, self.bases, timeout)

    def master_pids(self) -> "dict[str, int]":
        return {n: p.pid for n, p in zip(self.names, self.procs)
                if n.startswith("master")}

    def native_status(self) -> "list[dict]":
        """Per-master ``native_path_active{component}`` gauges (scraped
        from /metrics)."""
        out = []
        for base in self.bases:
            row: dict = {}
            try:
                r = http_get(base + "/metrics", timeout=5)
                for line in r.text.splitlines():
                    if not line.startswith("native_path_active{"):
                        continue
                    label, _, val = line.rpartition(" ")
                    comp = label.split('component="', 1)[-1].split('"')[0]
                    try:
                        row[comp] = float(val)
                    except ValueError:
                        pass
            except RequestException:
                pass
            out.append(row)
        return out

    def profile_composition(self, top: int = 12) -> "list[dict]":
        """Per-master continuous-profiler top-N (the 'why' behind the
        CPU numbers)."""
        out = []
        for base in self.bases:
            try:
                r = http_get(base + "/admin/profile",
                             params={"top": top}, timeout=5)
                payload = r.json() if r.status_code == 200 else {}
            except (RequestException, ValueError):
                payload = {}
            # The artifact keeps the composition (hottest frames), not
            # the full stack table.
            out.append({"samples": payload.get("samples", 0),
                        "top_frames": payload.get("top_frames", [])[:top]})
        return out

    def stop(self) -> None:
        self.children.stop()


def _cpu_isolation(mode: str, reason: str, fleet: "Fleet") -> dict:
    """Machine-readable isolation record: how many cores the box gave
    us, which measurement mode that forced, and the per-process affinity
    verdict."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = 0
    return {
        "cores_available": cores,
        "mode": mode,
        "mode_reason": reason,
        "all_pinned": fleet.pinned,
        "per_process": fleet.pin_verdicts,
    }


# ------------------------------------------------------------------- one leg
def run_leg(n_masters: int, args, native_on: bool = True,
            rps: float = None, purpose: str = "scale") -> dict:
    """One point on the scaling curve: spawn the fleet, drive it, read
    the per-master attribution, tear it down.

    `rps` overrides the open-loop rate for this leg: the scaling legs
    drive above capacity (the window measures capacity), while the
    native A/B legs drive at the stable `--ab-rps` point."""
    plan, plan_reason = plan_cpu_sets(n_masters, args.cpus)
    mode = "pinned-concurrent" if plan else "phased-projection"
    if plan is None:
        _warn(f"CPU isolation unavailable ({plan_reason}); falling back "
              f"to PHASED-PROJECTION mode — each master is driven alone "
              f"in an exclusive window and aggregate rps is the sum of "
              f"per-master rates (an upper-bound projection, labeled in "
              f"the artifact)")
    else:
        _info(f"CPU plan: {plan_reason}: "
              f"{ {k: sorted(v) for k, v in plan.items()} }")
    fleet = Fleet(n_masters, args.engines, native_on,
                  reply_chars=args.reply_chars,
                  chunk_size=args.chunk_size)
    try:
        fleet.start(plan)
        fleet.wait_ready()
        # Pre-warm every frontend across the tenant shapes BEFORE the
        # attribution snapshot: first-request costs (lazy imports, .so
        # load, session setup) must not pollute the native A/B.
        warm_pop = StreamPopulation(args.streams, seed=0x7777,
                                    prompt_scale=args.prompt_scale)
        for base in fleet.bases:
            for w in range(8):
                req = warm_pop.request_for(w)
                try:
                    http_post(base + "/v1/completions", json={
                        "model": "fake-model", "prompt": req["prompt"],
                        "max_tokens": req["max_tokens"], "stream": True},
                        timeout=30)
                except RequestException:
                    pass
        pids = fleet.master_pids()
        cpu0 = {n: proc_cpu_s(p) for n, p in pids.items()}
        attr0 = {f"master{i}": _admin_cpu(b)
                 for i, b in enumerate(fleet.bases)}
        leg_rps = rps if rps is not None else args.rps
        spec_base = {
            "requests": args.requests, "concurrency": args.concurrency,
            "rps": leg_rps, "traffic": args.traffic,
            "streams": args.streams,
            "prompt_scale": args.prompt_scale,
            "diurnal_amp": args.diurnal_amp,
            "diurnal_period": args.diurnal_period,
            "burst_every": args.burst_every, "burst_len": args.burst_len,
            "burst_mult": args.burst_mult,
            "warmup": False,   # the parent pre-warmed before snapshotting
        }
        driver_set = plan["driver"] if plan else None
        if mode == "pinned-concurrent":
            # True concurrent drive: workers spread across frontends,
            # masters on exclusive cores.
            spec = dict(spec_base, bases=fleet.bases, seed=0x20)
            window = _spawn_driver(spec, driver_set)
            windows = [window]
            agg_rps = window["req_per_s"]
        else:
            # Phased projection: each master alone in its own window.
            # Different seed per window so the population sampling
            # doesn't repeat streams.
            windows = []
            for i, base in enumerate(fleet.bases):
                _info(f"phased window {i + 1}/{n_masters} -> {base}")
                spec = dict(spec_base, bases=[base], seed=0x20 + i,
                            requests=max(1,
                                         args.requests // n_masters))
                windows.append(_spawn_driver(spec, None))
            agg_rps = round(sum(w["req_per_s"] for w in windows), 2)
        cpu = {n: round(proc_cpu_s(p) - cpu0[n], 2)
               for n, p in pids.items()}
        served = max(1, sum(w["served"] for w in windows))
        attr: dict = {}
        for i, base in enumerate(fleet.bases):
            name = f"master{i}"
            after = _admin_cpu(base)
            buckets = {}
            for cat, row in (after.get("cpu") or {}).items():
                before = ((attr0.get(name) or {}).get("cpu") or {}) \
                    .get(cat, {})
                buckets[cat] = {
                    "cpu_s": round(row.get("cpu_s", 0.0)
                                   - before.get("cpu_s", 0.0), 4),
                    "n": row.get("n", 0) - before.get("n", 0),
                }
            attr[name] = buckets
        route_s = sum(b.get("route", {}).get("cpu_s", 0.0)
                      for b in attr.values())
        stream_s = sum(b.get("stream", {}).get("cpu_s", 0.0)
                       for b in attr.values())
        return {
            "masters": n_masters,
            "engines": args.engines,
            "native_on": native_on,
            "purpose": purpose,
            "offered_rps": leg_rps,
            "mode": mode,
            "mode_reason": plan_reason,
            "pinned": fleet.pinned,
            "cpu_isolation": _cpu_isolation(mode, plan_reason, fleet),
            "agg_req_per_s": agg_rps,
            "served": served,
            "errors": sum(w["errors"] for w in windows),
            "windows": windows,
            "master_cpu_s_during_drive": cpu,
            "master_cpu_attr": attr,
            "route_cpu_us_per_req": round(route_s * 1e6 / served, 2),
            "stream_cpu_us_per_req": round(stream_s * 1e6 / served, 2),
            "route_stream_cpu_us_per_req": round(
                (route_s + stream_s) * 1e6 / served, 2),
            "native_status_per_master": fleet.native_status(),
            "profile_per_master": fleet.profile_composition(),
        }
    finally:
        fleet.stop()


# --------------------------------------------------------- topology A/B legs
#
# The same 2-slice fleet (1 PREFILL + 1 DECODE on slice-a, 2 DECODE on
# slice-b) driven twice — topology-aware routing (--topology-tradeoff > 0)
# vs flat (0) — with the DCN link throttled so a cross-slice KV handoff
# costs real wall time. The fake engines model the handoff as a sleep
# before the first delta.

TOPO_ENGINE_SPECS = (
    ["--type", "PREFILL", "--slice-id", "slice-a", "--topo-host", "host-a0"],
    ["--type", "DECODE", "--slice-id", "slice-a", "--topo-host", "host-a1"],
    ["--type", "DECODE", "--slice-id", "slice-b", "--topo-host", "host-b0"],
    ["--type", "DECODE", "--slice-id", "slice-b", "--topo-host", "host-b1"],
)


def run_topo_leg(args, tradeoff: float, label: str) -> dict:
    throttle = ["--kv-handoff-bytes-per-token", str(args.topo_kv_bytes),
                "--ici-bytes-per-s", str(args.topo_ici_bytes_per_s),
                "--dcn-bytes-per-s", str(args.topo_dcn_bytes_per_s)]
    specs = [spec + throttle for spec in TOPO_ENGINE_SPECS]
    plan, plan_reason = plan_cpu_sets(1, args.cpus)
    mode = "pinned-concurrent" if plan else "phased-projection"
    fleet = Fleet(1, len(specs), native_on=True,
                  reply_chars=args.reply_chars,
                  chunk_size=args.chunk_size,
                  master_extra=["--topology-tradeoff", str(tradeoff)],
                  engine_specs=specs)
    try:
        fleet.start(plan)
        fleet.wait_ready()
        spec = {
            "bases": fleet.bases,
            "requests": args.topo_requests,
            "concurrency": args.topo_concurrency,
            "rps": args.topo_rps, "traffic": "steady",
            "streams": args.streams,
            "prompt_scale": args.topo_prompt_scale,
            "seed": 0x21,
            "warmup": True,
        }
        window = _spawn_driver(spec, plan["driver"] if plan else None)
        # Pair-link census from the master (authoritative: every
        # SCHEDULE's prefill->decode link class).
        pair_links: dict = {}
        try:
            hot = http_get(fleet.bases[0] + "/admin/hotpath",
                           timeout=5).json()
            pair_links = ((hot.get("telemetry") or {})
                          .get("topology") or {}).get("pair_links") or {}
        except (RequestException, ValueError):
            _warn("could not scrape /admin/hotpath pair_links")
        # Modeled-handoff latencies from the engines, by link class.
        by_link: "dict[str, list[float]]" = {}
        for base in fleet.engine_bases:
            try:
                t = http_get(base + "/admin/topology", timeout=5).json()
            except (RequestException, ValueError):
                continue
            for row in t.get("handoffs", ()):
                by_link.setdefault(row["link"], []).append(row["ms"])
        split = {link: n for link, n in pair_links.items()
                 if link in ("local", "ici", "dcn")}
        total_split = sum(split.values())
        same = split.get("local", 0) + split.get("ici", 0)
        handoffs = [ms for rows in by_link.values() for ms in rows]
        return {
            "label": label,
            "topology_tradeoff": tradeoff,
            "engines": [" ".join(s) for s in TOPO_ENGINE_SPECS],
            "mode": mode,
            "cpu_isolation": _cpu_isolation(mode, plan_reason, fleet),
            "window": window,
            "pair_links": pair_links,
            "same_slice_pair_share": round(same / total_split, 4)
            if total_split else 0.0,
            "handoff_ms_by_link": {
                link: {"n": len(v),
                       "p50": round(percentile(v, 50), 2),
                       "p95": round(percentile(v, 95), 2)}
                for link, v in sorted(by_link.items())},
            "handoff_ms": {"n": len(handoffs),
                           "p50": round(percentile(handoffs, 50), 2),
                           "p95": round(percentile(handoffs, 95), 2)},
        }
    finally:
        fleet.stop()


def run_topo(args) -> dict:
    _info(f"topo leg: flat routing (tradeoff=0, DCN throttled to "
          f"{args.topo_dcn_bytes_per_s:g} B/s)")
    flat = run_topo_leg(args, 0.0, "flat")
    _info("topo leg: topology-aware routing "
          f"(tradeoff={args.topo_tradeoff:g})")
    topo_leg = run_topo_leg(args, args.topo_tradeoff, "topo")
    flat_p50 = flat["window"]["ttft_ms"]["p50"]
    topo_p50 = topo_leg["window"]["ttft_ms"]["p50"]
    headline = {
        "topo_ttft_p50_speedup": round(flat_p50 / max(0.01, topo_p50), 2),
        "same_slice_pair_share": topo_leg["same_slice_pair_share"],
        "topo_ttft_p50_ms": topo_p50,
        "topo_handoff_p95_ms": topo_leg["handoff_ms"]["p95"],
    }
    return {
        "bench": "topo",
        "kv_handoff_bytes_per_token": args.topo_kv_bytes,
        "ici_bytes_per_s": args.topo_ici_bytes_per_s,
        "dcn_bytes_per_s": args.topo_dcn_bytes_per_s,
        "requests_per_leg": args.topo_requests,
        "offered_rps": args.topo_rps,
        "legs": [flat, topo_leg],
        "headline": headline,
    }


# ---------------------------------------------------------------------- main
def run(args) -> dict:
    legs: "list[dict]" = []
    report: dict = {
        "bench": "fleet",
        "traffic": args.traffic,
        "offered_rps_per_window": args.rps,
        "ab_rps": args.ab_rps,
        "stream_population": args.streams,
        "prompt_scale": args.prompt_scale,
        "reply_chars": args.reply_chars,
        "chunk_size": args.chunk_size,
        "legs": legs,
    }
    # Native A/B at masters=1 first (the per-request CPU cut, driven at
    # the stable --ab-rps point), then the scaling curve at the
    # saturating rate with the native core on.
    _info(f"leg: masters=1 native=off (A/B baseline, "
          f"{args.ab_rps} rps stable)")
    off = run_leg(1, args, native_on=False, rps=args.ab_rps,
                  purpose="native-ab")
    legs.append(off)
    _info(f"leg: masters=1 native=on (A/B, {args.ab_rps} rps stable)")
    on = run_leg(1, args, native_on=True, rps=args.ab_rps,
                 purpose="native-ab")
    legs.append(on)
    for n in (1, 2, 4):
        if n > args.max_masters:
            continue
        _info(f"leg: masters={n} native=on (scaling, {args.rps} rps)")
        legs.append(run_leg(n, args, native_on=True))

    by_masters = {leg["masters"]: leg for leg in legs
                  if leg["native_on"] and leg["purpose"] == "scale"}
    rs_on = on["route_stream_cpu_us_per_req"]
    rs_off = off["route_stream_cpu_us_per_req"]
    headline = {
        "agg_rps_masters_1": by_masters.get(1, {}).get("agg_req_per_s"),
        "agg_rps_masters_2": by_masters.get(2, {}).get("agg_req_per_s"),
        "agg_rps_masters_4": by_masters.get(4, {}).get("agg_req_per_s"),
        "route_stream_cpu_us_per_req": rs_on,
        "native_route_stream_speedup": round(rs_off / rs_on, 2)
        if rs_on else 0.0,
        "native_route_speedup": round(
            off["route_cpu_us_per_req"]
            / max(0.01, on["route_cpu_us_per_req"]), 2),
        "native_stream_speedup": round(
            off["stream_cpu_us_per_req"]
            / max(0.01, on["stream_cpu_us_per_req"]), 2),
    }
    if headline["agg_rps_masters_4"] and headline["agg_rps_masters_1"]:
        headline["masters_4_over_1_scaling"] = round(
            headline["agg_rps_masters_4"]
            / headline["agg_rps_masters_1"], 2)
    report["headline"] = {k: v for k, v in headline.items()
                          if v is not None}
    report["native_ab"] = {
        "route_cpu_us_per_req": {"off": off["route_cpu_us_per_req"],
                                 "on": on["route_cpu_us_per_req"]},
        "stream_cpu_us_per_req": {"off": off["stream_cpu_us_per_req"],
                                  "on": on["stream_cpu_us_per_req"]},
        "route_stream_cpu_us_per_req": {"off": rs_off, "on": rs_on},
    }
    return report


def gate(report: dict) -> "list[str]":
    """The acceptance this twin is held to: both sides of the native A/B
    served every request. Returns what failed."""
    bad = []
    for leg in report["legs"]:
        if leg["purpose"] != "native-ab":
            continue
        want = sum(w["requests"] for w in leg["windows"])
        if leg["errors"] or leg["served"] != want:
            bad.append(f"native {'on' if leg['native_on'] else 'off'}: "
                       f"served {leg['served']} of {want}, errors "
                       f"{leg['errors']}")
    return bad


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--drive", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--requests", type=int, default=240,
                    help="requests per measurement window")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--rps", type=float, default=120.0,
                    help="open-loop base rate per window (offered above "
                         "capacity -> the window measures capacity under "
                         "the diurnal shape; due-slot latency counts the "
                         "queueing)")
    ap.add_argument("--ab-rps", type=float, default=40.0,
                    help="open-loop rate for the native A/B legs — a "
                         "stable sub-capacity point so per-request CPU "
                         "reflects the code path, not overload thrash")
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--prompt-scale", type=float, default=1.0,
                    help="scale the tenant-mix prompt lengths (smoke "
                         "runs: 0.1)")
    ap.add_argument("--reply-chars", type=int, default=32)
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="engine delta chunk size (reply-chars/chunk = "
                         "generation deltas per request)")
    ap.add_argument("--streams", type=int, default=200_000,
                    help="distinct prompt-stream population (simulated "
                         "user base; each request samples one stream)")
    ap.add_argument("--max-masters", type=int, default=4)
    ap.add_argument("--traffic", default="diurnal",
                    choices=["steady", "diurnal", "burst"])
    ap.add_argument("--diurnal-amp", type=float, default=0.6)
    ap.add_argument("--diurnal-period", type=float, default=12.0)
    ap.add_argument("--burst-every", type=float, default=10.0)
    ap.add_argument("--burst-len", type=float, default=2.0)
    ap.add_argument("--burst-mult", type=float, default=4.0)
    ap.add_argument("--topo", action="store_true",
                    help="run the topology A/B instead of the fleet "
                         "scaling suite: topology-aware vs flat routing "
                         "over a 2-slice fleet with the DCN link "
                         "throttled")
    ap.add_argument("--topo-tradeoff", type=float, default=0.25,
                    help="--topology-tradeoff for the topo-aware leg")
    ap.add_argument("--topo-requests", type=int, default=90,
                    help="requests per topo A/B leg")
    ap.add_argument("--topo-rps", type=float, default=3.0,
                    help="steady open-loop rate for the topo legs")
    ap.add_argument("--topo-concurrency", type=int, default=6,
                    help="driver workers for the topo legs")
    ap.add_argument("--topo-prompt-scale", type=float, default=0.1,
                    help="prompt scale for the topo legs")
    ap.add_argument("--topo-kv-bytes", type=int, default=1024,
                    help="modeled KV payload per prompt token for the "
                         "topo legs")
    ap.add_argument("--topo-ici-bytes-per-s", type=float, default=2e8,
                    help="modeled ICI bandwidth for the topo legs")
    ap.add_argument("--topo-dcn-bytes-per-s", type=float, default=2e6,
                    help="modeled (throttled) DCN bandwidth for the "
                         "topo legs")
    ap.add_argument("--out", default=None,
                    help="write the artifact here (stdout otherwise)")
    ap.add_argument("--quick", action="store_true",
                    help=f"the native A/B alone at {QUICK['requests']} "
                         "requests a side")
    args = ap.parse_args(argv)
    if args.quick:
        args.requests, args.max_masters = (QUICK["requests"],
                                           QUICK["max_masters"])
    args.cpus = None    # this process's affinity
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.drive:
        # Driver-process mode: one measurement window, JSON on stdout.
        print(json.dumps(drive_window(json.loads(args.drive))))
        return
    report = run_topo(args) if args.topo else run(args)
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
        _info(f"wrote {args.out}")
    else:
        print(text)


if __name__ == "__main__":
    main()
