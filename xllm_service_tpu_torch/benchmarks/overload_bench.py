"""Closed-loop overload drill of the port (twin of the repository's
``benchmarks/overload_bench.py``): burst -> shed -> hold TTFT.

A deployment-shaped multiproc stack — the port's coordination server,
master and capacity-capped fake engines with the deterministic
service-rate model, each its own OS process — is driven through a steady
phase and then a burst at ~4x fleet capacity, in three configurations:

- **shed**: admission control ON — the gate 429s the excess fast while
  ADMITTED requests keep a TTFT p50 within 1.5x of steady state, and
  shed responses complete in well under 50 ms p99,
- **noshed**: admission OFF — the same burst queues unboundedly until
  BOTH SLO burn windows breach,
- **shed+autoscale**: admission ON + the closed-loop autoscaler with the
  local process actuator spawning the port's fake engines — the shed
  rate drives scale-out and decays to ~0 as the capacity arrives.

An idle-overhead A/B (light load, overload plane configured vs
default-off) prices the per-request cost of the deadline parse +
admission gate.

    python -m xllm_service_tpu_torch.benchmarks.overload_bench            # full run
    python -m xllm_service_tpu_torch.benchmarks.overload_bench --quick    # CI-sized

Output: the reference's JSON report and headline keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from .master_hotpath_bench import wait_serving
from .stack import (
    Children,
    RequestException,
    Session,
    free_port,
    module_cmd,
    percentile,
)

SERVICE_RATE_RPS = 6.0        # per-engine capacity (deterministic model)
FIRST_DELTA_DELAY_S = 0.2     # simulated prefill: the TTFT floor
N_ENGINES = 2                 # steady fleet (shed/noshed legs)
REPLY_CHARS = 8
SHED_P99_GATE_MS = 50.0


class Stack:
    """The port's coordination server + master + engines, each an OS
    process."""

    def __init__(self, args, admission_limit: int = 0,
                 autoscale: bool = False, n_engines: int = N_ENGINES,
                 deadline_ms: float = 0.0):
        self.args = args
        self.admission_limit = admission_limit
        self.autoscale = autoscale
        self.n_engines = n_engines
        self.deadline_ms = deadline_ms
        self.children = Children("overload_bench")
        self.coord_port = free_port()
        self.http_port = free_port()
        self.rpc_port = free_port()

    def engine_cmd_template(self) -> str:
        return (f"{sys.executable} -m "
                f"xllm_service_tpu_torch.testing.fake_engine "
                f"--coordination-addr {{coordination_addr}} "
                f"--port {{port}} --service-rate {SERVICE_RATE_RPS} "
                f"--accept-queue 512 "
                f"--first-delta-delay {FIRST_DELTA_DELAY_S} "
                f"--reply {'x' * REPLY_CHARS} --chunk-size 8 --delay 0")

    def start(self):
        a = self.args
        self.children.spawn("coord", module_cmd(
            "xllm_service_tpu_torch.coordination.server",
            "--host", "127.0.0.1", "--port", str(self.coord_port)))
        time.sleep(0.3)
        master_cmd = module_cmd(
            "xllm_service_tpu_torch.master",
            "--coordination-addr", f"127.0.0.1:{self.coord_port}",
            "--host", "127.0.0.1",
            "--http-port", str(self.http_port),
            "--rpc-port", str(self.rpc_port),
            "--load-balance-policy", "RR",
            "--sync-interval-s", "0.5",
            "--slo-ttft-ms", str(a.slo_ttft_ms),
            "--slo-tpot-ms", "60000",
            "--slo-fast-window-s", str(a.fast_window_s),
            "--slo-slow-window-s", str(a.slow_window_s),
            "--slo-burn-alert", "14.4")
        if self.admission_limit:
            master_cmd += ["--admission-max-inflight-per-instance",
                           str(self.admission_limit)]
        if self.deadline_ms:
            master_cmd += ["--default-request-deadline-ms",
                           str(self.deadline_ms)]
        if self.autoscale:
            # Scale-OUT settings compressed for the burst; scale-IN
            # hysteresis deliberately SLOW relative to the burst (a fleet
            # the admission gate holds exactly at capacity looks idle to
            # the burn monitor, and an aggressive idle streak would scale
            # in mid-burst).
            master_cmd += [
                "--autoscaler-enabled",
                "--autoscaler-actuator", "local",
                "--autoscaler-min-instances", "1",
                "--autoscaler-max-instances", str(a.max_instances),
                "--autoscaler-breach-ticks", "2",
                "--autoscaler-idle-ticks", "60",
                "--autoscaler-scale-out-cooldown-s", "3",
                "--autoscaler-scale-in-cooldown-s", "45",
                "--autoscaler-stale-hold-s", "30",
                "--autoscaler-drain-grace-s", "0.5",
                "--autoscaler-spawn-cmd", self.engine_cmd_template(),
            ]
        self.children.spawn("master", master_cmd)
        tmpl = self.engine_cmd_template()
        for i in range(self.n_engines):
            self.children.spawn(f"engine{i}", tmpl.format(
                coordination_addr=f"127.0.0.1:{self.coord_port}",
                port=free_port()).split())
        wait_serving(self.children, [self.base()])

    def base(self) -> str:
        return f"http://127.0.0.1:{self.http_port}"

    def stop(self):
        self.children.stop()


class Sampler(threading.Thread):
    """1 Hz poll of /admin/slo + /admin/overload + /admin/autoscaler."""

    def __init__(self, base: str):
        super().__init__(daemon=True, name="bench-sampler")
        self.base = base
        self.rows: list[dict] = []
        self._halt = threading.Event()

    def run(self):
        t0 = time.monotonic()
        session = Session()
        while not self._halt.wait(1.0):
            row = {"t_s": round(time.monotonic() - t0, 1)}
            try:
                slo = session.get(self.base + "/admin/slo",
                                  timeout=3).json()
                ttft = slo["objectives"]["ttft"]
                row["burn_fast"] = ttft["fast"]["burn_rate"]
                row["burn_slow"] = ttft["slow"]["burn_rate"]
                row["breaching"] = slo["breaching"]
            except (RequestException, KeyError, ValueError):
                pass
            try:
                ov = session.get(self.base + "/admin/overload",
                                 timeout=3).json()
                row["shed_rate"] = ov["admission"]["shed_rate_per_s"]
                row["pending"] = ov["admission"]["pending"]
                row["brownout"] = ov["brownout"]["active"]
            except (RequestException, KeyError, ValueError):
                pass
            try:
                rep = session.get(self.base + "/admin/autoscaler",
                                  timeout=3).json()
                if rep.get("decisions"):
                    row["live"] = rep["decisions"][0]["inputs"]["live"]
            except (RequestException, ValueError):
                pass
            self.rows.append(row)
        session.close()

    def stop(self):
        self._halt.set()
        self.join(timeout=3)


def drive_phase(base: str, rps: float, duration_s: float, workers: int,
                out: dict) -> None:
    """Open-loop paced phase: requests are DUE at fixed wall slots;
    TTFT is measured from the slot (coordinated-omission-corrected).
    200s record into out["ttfts"]; 429s into out["shed_ms"] (request
    turnaround — the 'shed fast' claim); other codes into
    out["errors"]."""
    lock = threading.Lock()  # xlint: allow-local-lock(the drive's result lists; its workers join before it returns)
    out.setdefault("ttfts", [])
    out.setdefault("shed_ms", [])
    out.setdefault("errors", 0)
    t_start = time.monotonic()
    stop_at = t_start + duration_s
    slot = [0]

    def worker():
        session = Session()
        while True:
            with lock:
                k = slot[0]
                slot[0] += 1
            due = t_start + k / rps
            if due >= stop_at:
                session.close()
                return
            now = time.monotonic()
            if due > now:
                time.sleep(due - now)
            try:
                t_send = time.monotonic()
                r = session.post(base + "/v1/completions", json={
                    "model": "fake-model", "prompt": "overload bench",
                    "max_tokens": 8, "stream": True},
                    stream=True, timeout=120)
                if r.status_code == 429:
                    r.content   # the short body: the connection stays
                    with lock:
                        out["shed_ms"].append(
                            (time.monotonic() - t_send) * 1000)
                    continue
                if r.status_code != 200:
                    r.close()
                    with lock:
                        out["errors"] += 1
                    continue
                ttft = None
                for line in r.iter_lines():
                    if ttft is None and line.startswith(b"data: "):
                        ttft = time.monotonic() - due   # from the SLOT
                    if line == b"data: [DONE]":
                        break
                r.close()
                if ttft is not None:
                    with lock:
                        out["ttfts"].append(ttft * 1000)
            except RequestException:
                with lock:
                    out["errors"] += 1
                time.sleep(0.1)

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run_leg(args, admission_limit: int, autoscale: bool,
            n_engines: int, burst_rps: float) -> dict:
    stack = Stack(args, admission_limit=admission_limit,
                  autoscale=autoscale, n_engines=n_engines)
    sampler = None
    steady: dict = {}
    burst: dict = {}
    try:
        stack.start()
        sampler = Sampler(stack.base())
        sampler.start()
        drive_phase(stack.base(), args.steady_rps, args.steady_s,
                    args.workers, steady)
        burst_start = len(sampler.rows)
        drive_phase(stack.base(), burst_rps, args.burst_s,
                    args.workers, burst)
        burst_rows = sampler.rows[burst_start:] or [{}]
        end_row = burst_rows[-1]
        # Shed-rate decay (autoscale leg): mean over the last quarter of
        # the burst vs the first quarter.
        q = max(1, len(burst_rows) // 4)
        shed_head = [r.get("shed_rate") for r in burst_rows[:q]
                     if r.get("shed_rate") is not None]
        shed_tail = [r.get("shed_rate") for r in burst_rows[-q:]
                     if r.get("shed_rate") is not None]
        peak_live = max((r.get("live") or n_engines
                         for r in sampler.rows), default=n_engines)
        return {
            "admission_limit": admission_limit,
            "autoscale": autoscale,
            "steady_ttft_p50_ms": round(percentile(steady["ttfts"], 50), 1),
            "burst_admitted_ttft_p50_ms":
                round(percentile(burst["ttfts"], 50), 1),
            "burst_admitted_ttft_p99_ms":
                round(percentile(burst["ttfts"], 99), 1),
            "burst_shed_count": len(burst["shed_ms"]),
            "burst_admitted_count": len(burst["ttfts"]),
            "burst_shed_p50_ms": round(percentile(burst["shed_ms"], 50), 2),
            "burst_shed_p99_ms": round(percentile(burst["shed_ms"], 99), 2),
            "errors": steady["errors"] + burst["errors"],
            "burn_at_burst_end": {
                "fast": end_row.get("burn_fast"),
                "slow": end_row.get("burn_slow"),
                "breaching": end_row.get("breaching"),
            },
            "shed_rate_first_quarter": round(
                sum(shed_head) / len(shed_head), 2) if shed_head else None,
            "shed_rate_last_quarter": round(
                sum(shed_tail) / len(shed_tail), 2) if shed_tail else None,
            "peak_live_instances": peak_live,
            "timeline": sampler.rows,
        }
    finally:
        if sampler is not None:
            sampler.stop()
        stack.stop()


def run_idle_overhead(args) -> dict:
    """A/B light load with the overload plane configured (admission
    gate + default deadline: the per-request parse/check cost) vs the
    default-off config."""
    p50s = {}
    for on in (False, True):
        stack = Stack(args, admission_limit=64 if on else 0,
                      deadline_ms=30000.0 if on else 0.0)
        try:
            stack.start()
            out: dict = {}
            drive_phase(stack.base(), args.steady_rps, args.overhead_s,
                        args.workers, out)
            p50s["on" if on else "off"] = percentile(out["ttfts"], 50)
        finally:
            stack.stop()
    off, on = p50s["off"], p50s["on"]
    return {
        "ttft_p50_off_ms": round(off, 2),
        "ttft_p50_on_ms": round(on, 2),
        "delta_pct": round((on - off) / off * 100, 2) if off else 0.0,
    }


def gate(report: dict) -> "list[str]":
    """The reference's acceptance for the shed leg: some 429s, the shed
    responses' p99 under 50 ms. Returns what failed."""
    shed = report["shed"]
    bad = []
    if not shed["burst_shed_count"]:
        bad.append("no 429 in the burst")
    if not report["acceptance"]["shed_under_50ms_p99"]:
        bad.append(f"shed p99 {shed['burst_shed_p99_ms']} ms >= "
                   f"{SHED_P99_GATE_MS}")
    return bad


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized phases (functional, not publication)")
    ap.add_argument("--steady-s", type=float, default=20.0)
    ap.add_argument("--burst-s", type=float, default=45.0)
    ap.add_argument("--overhead-s", type=float, default=20.0)
    ap.add_argument("--steady-rps", type=float, default=6.0)
    ap.add_argument("--burst-multiple", type=float, default=4.0)
    ap.add_argument("--workers", type=int, default=24)
    ap.add_argument("--admission-limit", type=int, default=1,
                    help="per-instance admitted-in-flight watermark for "
                         "the shed leg")
    ap.add_argument("--autoscale-admission-limit", type=int, default=2)
    ap.add_argument("--max-instances", type=int, default=4)
    ap.add_argument("--slo-ttft-ms", type=float, default=600.0)
    ap.add_argument("--fast-window-s", type=float, default=8.0)
    ap.add_argument("--slow-window-s", type=float, default=16.0)
    ap.add_argument("--skip-noshed", action="store_true")
    ap.add_argument("--skip-autoscale", action="store_true")
    ap.add_argument("--skip-overhead", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.steady_s, args.burst_s = 10.0, 30.0
        args.overhead_s = 10.0
    return args


def run(args) -> dict:
    capacity = SERVICE_RATE_RPS * N_ENGINES
    burst_rps = args.burst_multiple * capacity

    print("== shed leg (admission ON) ==", file=sys.stderr)
    shed = run_leg(args, args.admission_limit, autoscale=False,
                   n_engines=N_ENGINES, burst_rps=burst_rps)
    noshed = None
    if not args.skip_noshed:
        print("== noshed control (admission OFF) ==", file=sys.stderr)
        noshed = run_leg(args, 0, autoscale=False,
                         n_engines=N_ENGINES, burst_rps=burst_rps)
    autoscale = None
    if not args.skip_autoscale:
        print("== shed+autoscale leg ==", file=sys.stderr)
        # Burst sized to the MAX fleet: shedding bridges the gap while
        # capacity arrives, then decays to ~0.
        autoscale = run_leg(
            args, args.autoscale_admission_limit, autoscale=True,
            n_engines=1,
            burst_rps=3.0 * SERVICE_RATE_RPS)
    overhead = None
    if not args.skip_overhead:
        print("== idle-overhead A/B ==", file=sys.stderr)
        overhead = run_idle_overhead(args)

    alert = 14.4
    ttft_ratio = (shed["burst_admitted_ttft_p50_ms"]
                  / shed["steady_ttft_p50_ms"]
                  if shed["steady_ttft_p50_ms"] else None)
    noshed_end = (noshed or {}).get("burn_at_burst_end", {})
    shed_end = shed["burn_at_burst_end"]
    decay_ok = None
    if autoscale is not None and \
            autoscale["shed_rate_first_quarter"] is not None:
        decay_ok = (autoscale["shed_rate_last_quarter"] is not None
                    and autoscale["shed_rate_last_quarter"] <= max(
                        0.5, 0.1 * autoscale["shed_rate_first_quarter"]))
    return {
        "config": {
            "service_rate_rps": SERVICE_RATE_RPS,
            "first_delta_delay_s": FIRST_DELTA_DELAY_S,
            "n_engines": N_ENGINES,
            "fleet_capacity_rps": capacity,
            "burst_rps": burst_rps,
            "steady_rps": args.steady_rps,
            "admission_limit": args.admission_limit,
            "phases_s": [args.steady_s, args.burst_s],
            "slo_ttft_ms": args.slo_ttft_ms,
            "windows_s": [args.fast_window_s, args.slow_window_s],
            "quick": args.quick,
        },
        "shed": shed,
        "noshed": noshed,
        "autoscale": autoscale,
        "idle_overhead": overhead,
        "acceptance": {
            "admitted_ttft_ratio_vs_steady":
                round(ttft_ratio, 2) if ttft_ratio else None,
            "admitted_ttft_within_1p5x":
                bool(ttft_ratio and ttft_ratio <= 1.5),
            "shed_p99_ms": shed["burst_shed_p99_ms"],
            "shed_under_50ms_p99":
                shed["burst_shed_p99_ms"] < SHED_P99_GATE_MS,
            "shed_leg_burn_at_end": shed_end,
            "noshed_breaches_both_windows":
                (noshed_end.get("fast") is not None
                 and noshed_end["fast"] >= alert
                 and noshed_end["slow"] >= alert) if noshed else None,
            "autoscale_shed_rate_decays_to_zero": decay_ok,
            "autoscale_peak_live":
                (autoscale or {}).get("peak_live_instances"),
        },
        "headline": {
            "admitted_ttft_ratio_vs_steady":
                round(ttft_ratio, 3) if ttft_ratio else None,
            "shed_p99_ms": shed["burst_shed_p99_ms"],
            "idle_overhead_ttft_delta_pct":
                (overhead or {}).get("delta_pct"),
        },
    }


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv)), indent=2))


if __name__ == "__main__":
    main()
