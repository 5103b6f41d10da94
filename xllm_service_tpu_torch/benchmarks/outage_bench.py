"""Coordination-outage static-stability bench of the port (twin of the
repository's ``benchmarks/outage_bench.py``).

A deployment-shaped multiproc stack — the port's coordination server,
master and fake engines, each its own OS process — is driven with paced
open-loop load through three phases: steady, a TOTAL coordination outage
(the server process is SIGKILLed mid-load), and recovery (a fresh, EMPTY
server restarted on the same port; the port's server sets
``allow_reuse_address``, so it binds while the killed one's sockets
linger), in two configurations:

- **degraded** (static stability ON): rps and TTFT p50 during the
  outage hold, zero instances are evicted, no evictions are even *held*,
  and recovery is storm-free — the restarted server's accept log shows
  the fleet's re-registration spread over the jitter window, after which
  the monitor returns to CONNECTED with the fleet intact.
- **control** (``--coordination-degraded-mode off``, engines
  ``--degraded-mode off``): the legacy behavior loses the fleet.

    python -m xllm_service_tpu_torch.benchmarks.outage_bench            # full run
    python -m xllm_service_tpu_torch.benchmarks.outage_bench --quick    # CI-sized

Output: the reference's JSON report and headline keys.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time
from pathlib import Path

from .stack import (
    Children,
    RequestException,
    Session,
    free_port,
    module_cmd,
    percentile,
)
from .stack import get as http_get
from .stack import post as http_post

SERVICE_RATE_RPS = 6.0        # per-engine capacity (deterministic model)
FIRST_DELTA_DELAY_S = 0.2     # simulated prefill: the TTFT floor
N_ENGINES = 4
RECONNECT_JITTER_S = 2.0      # recovery spread window (master + engines)


class Stack:
    """The port's coordination server + master + engines, each an OS
    process. The coordination server is killable (SIGKILL) and
    restartable on the same port with a fresh accept log."""

    def __init__(self, args, degraded: bool):
        self.args = args
        self.degraded = degraded
        self.children = Children("outage_bench")
        self.coord_proc = None
        self.coord_port = free_port()
        self.http_port = free_port()
        self.rpc_port = free_port()
        fd, path = tempfile.mkstemp(prefix="outage_bench_accepts_")
        os.close(fd)
        self.accept_log = Path(path)

    def start_coord(self, name="coord") -> None:
        self.coord_proc = self.children.spawn(name, module_cmd(
            "xllm_service_tpu_torch.coordination.server",
            "--host", "127.0.0.1", "--port", str(self.coord_port),
            "--accept-log", str(self.accept_log)), mode="a")

    def kill_coord(self) -> None:
        """SIGKILL — no graceful teardown; clients see dead sockets."""
        assert self.coord_proc is not None
        self.coord_proc.send_signal(signal.SIGKILL)
        self.coord_proc.wait(timeout=10)

    def start(self):
        mode = "on" if self.degraded else "off"
        self.start_coord()
        time.sleep(0.3)
        self.children.spawn("master", module_cmd(
            "xllm_service_tpu_torch.master",
            "--coordination-addr", f"127.0.0.1:{self.coord_port}",
            "--host", "127.0.0.1",
            "--http-port", str(self.http_port),
            "--rpc-port", str(self.rpc_port),
            "--load-balance-policy", "RR",
            "--sync-interval-s", "0.5",
            "--lease-ttl-s", "1.5",
            "--heartbeat-silence-to-suspect-s", "2.0",
            "--detect-disconnected-instance-interval-s", "2.0",
            "--coordination-degraded-mode", mode,
            "--coordination-degraded-after-ticks", "2",
            "--degraded-heartbeat-silence-s", "10.0",
            "--coordination-reconnect-jitter-s", str(RECONNECT_JITTER_S)),
            mode="a")
        for i in range(N_ENGINES):
            self.children.spawn(f"engine{i}", module_cmd(
                "xllm_service_tpu_torch.testing.fake_engine",
                "--coordination-addr", f"127.0.0.1:{self.coord_port}",
                "--port", str(free_port()),
                "--service-rate", str(SERVICE_RATE_RPS),
                "--accept-queue", "512",
                "--first-delta-delay", str(FIRST_DELTA_DELAY_S),
                "--reply", "x" * 8, "--chunk-size", "8", "--delay", "0",
                "--heartbeat-interval", "0.25",
                "--lease-ttl", "1.5",
                "--degraded-mode", mode), mode="a")

        base = self.base()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            self.children.check()
            try:
                r = http_post(base + "/v1/completions", json={
                    "model": "fake-model", "prompt": "ready?",
                    "max_tokens": 2}, timeout=5)
                if r.status_code == 200 and self.fleet_size() >= N_ENGINES:
                    return
            except RequestException:
                pass
            time.sleep(0.25)
        raise RuntimeError("stack never became ready")

    def base(self) -> str:
        return f"http://127.0.0.1:{self.http_port}"

    def metrics(self) -> str:
        try:
            return http_get(self.base() + "/metrics", timeout=5).text
        except RequestException:
            return ""

    def fleet_size(self) -> int:
        """Distinct registered instances, from the per-instance queue
        gauge (one series per registered engine; deregistration removes
        it)."""
        return sum(1 for ln in self.metrics().splitlines()
                   if ln.startswith("instance_queue_depth{"))

    def evictions_total(self) -> float:
        total = 0.0
        for ln in self.metrics().splitlines():
            if ln.startswith("instance_evictions_total{"):
                total += float(ln.rsplit(" ", 1)[1])
        return total

    def coordination_report(self) -> dict:
        try:
            return http_get(self.base() + "/admin/coordination",
                            timeout=5).json()
        except (RequestException, ValueError):
            return {}

    def accept_times(self) -> list[float]:
        try:
            return [float(ln) for ln in
                    self.accept_log.read_text().splitlines() if ln]
        except OSError:
            return []

    def stop(self):
        self.children.stop()
        try:
            self.accept_log.unlink()
        except OSError:
            pass


class Sampler(threading.Thread):
    """1 Hz poll of /admin/coordination: monitor state + held-log shape
    over the run (the 'what was held back' timeline)."""

    def __init__(self, stack: Stack):
        super().__init__(daemon=True, name="bench-sampler")
        self.stack = stack
        self.rows: list[dict] = []
        self._halt = threading.Event()

    def run(self):
        t0 = time.monotonic()
        while not self._halt.wait(1.0):
            rep = self.stack.coordination_report()
            held = rep.get("held", {})
            actions = held.get("actions", [])
            self.rows.append({
                "t_s": round(time.monotonic() - t0, 1),
                "state": rep.get("state"),
                "held_depth": held.get("depth"),
                "held_evicts": sum(1 for a in actions
                                   if a.get("kind") == "evict"),
                "fleet": self.stack.fleet_size(),
            })

    def stop(self):
        self._halt.set()
        self.join(timeout=3)


def drive_phase(base: str, rps: float, duration_s: float, workers: int,
                out: dict) -> None:
    """Open-loop paced phase: requests are DUE at fixed wall slots; TTFT
    is measured from the slot (coordinated-omission-corrected)."""
    lock = threading.Lock()  # xlint: allow-local-lock(the drive's result lists; its workers join before it returns)
    out.setdefault("ttfts", [])
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
                r = session.post(base + "/v1/completions", json={
                    "model": "fake-model", "prompt": "outage bench",
                    "max_tokens": 8, "stream": True},
                    stream=True, timeout=60)
                if r.status_code != 200:
                    r.close()
                    with lock:
                        out["errors"] += 1
                    continue
                ttft = None
                done = False
                for line in r.iter_lines():
                    if ttft is None and line.startswith(b"data: "):
                        ttft = time.monotonic() - due   # from the SLOT
                    if line == b"data: [DONE]":
                        done = True
                        break
                r.close()
                if done and ttft is not None:
                    with lock:
                        out["ttfts"].append(ttft * 1000)
                else:
                    with lock:
                        out["errors"] += 1
            except RequestException:
                with lock:
                    out["errors"] += 1
                time.sleep(0.05)

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def phase_stats(out: dict, duration_s: float) -> dict:
    return {
        "completed": len(out["ttfts"]),
        "errors": out["errors"],
        "rps": round(len(out["ttfts"]) / duration_s, 2),
        "ttft_p50_ms": round(percentile(out["ttfts"], 50), 1),
        "ttft_p99_ms": round(percentile(out["ttfts"], 99), 1),
    }


def run_leg(args, degraded: bool) -> dict:
    stack = Stack(args, degraded=degraded)
    sampler = None
    try:
        stack.start()
        sampler = Sampler(stack)
        sampler.start()
        steady: dict = {}
        drive_phase(stack.base(), args.rps, args.steady_s, args.workers,
                    steady)
        evictions_pre = stack.evictions_total()

        # Kill the coordination server ~1 s INTO the outage-phase load:
        # the paced driver is mid-flight when the plane dies.
        outage: dict = {}
        driver = threading.Thread(
            target=drive_phase,
            args=(stack.base(), args.rps, args.outage_s, args.workers,
                  outage))
        driver.start()
        time.sleep(1.0)
        stack.kill_coord()
        t_killed = time.time()
        driver.join()
        fleet_at_outage_end = stack.fleet_size()
        rep = stack.coordination_report()
        state_at_outage_end = rep.get("state")
        held_at_outage_end = rep.get("held", {}).get("depth")
        max_held_evicts = max((r["held_evicts"] or 0
                               for r in sampler.rows
                               if r.get("held_evicts") is not None),
                              default=0)

        # Restart EMPTY on the same port; the recovery phase drives load
        # while the fleet reconnects with jittered backoff + spread
        # re-registration.
        stack.start_coord(name="coord2")
        t_restarted = time.time()
        recovery: dict = {}
        drive_phase(stack.base(), args.rps, args.recovery_s, args.workers,
                    recovery)
        deadline = time.monotonic() + 30
        final_state = None
        while time.monotonic() < deadline:
            final_state = stack.coordination_report().get("state")
            if final_state == "CONNECTED" or not degraded:
                break
            time.sleep(0.5)
        accepts = [t - t_restarted for t in stack.accept_times()
                   if t >= t_restarted]
        return {
            "degraded_mode": degraded,
            "steady": phase_stats(steady, args.steady_s),
            "outage": phase_stats(outage, args.outage_s),
            "recovery": phase_stats(recovery, args.recovery_s),
            "evictions_total": stack.evictions_total() - evictions_pre,
            "fleet_at_outage_end": fleet_at_outage_end,
            "fleet_final": stack.fleet_size(),
            "state_at_outage_end": state_at_outage_end,
            "held_depth_at_outage_end": held_at_outage_end,
            "max_held_evictions_observed": max_held_evicts,
            "final_monitor_state": final_state,
            "outage_started_unix": t_killed,
            "reconnect_accepts": len(accepts),
            "reconnect_spread_s": round(max(accepts) - min(accepts), 3)
                if len(accepts) >= 2 else 0.0,
            "reconnect_first_s": round(min(accepts), 3) if accepts
                else None,
            "timeline": sampler.rows,
        }
    finally:
        if sampler is not None:
            sampler.stop()
        stack.stop()


def gate(report: dict) -> "list[str]":
    """The reference's acceptance for the degraded leg that a short run
    can hold: zero evictions, the monitor back to CONNECTED. Returns
    what failed."""
    deg = report["degraded"]
    bad = []
    if deg["evictions_total"] != 0:
        bad.append(f"evictions {deg['evictions_total']}")
    if deg["final_monitor_state"] != "CONNECTED":
        bad.append(f"monitor {deg['final_monitor_state']}")
    return bad


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized phases (functional, not publication)")
    ap.add_argument("--steady-s", type=float, default=15.0)
    ap.add_argument("--outage-s", type=float, default=30.0)
    ap.add_argument("--recovery-s", type=float, default=15.0)
    ap.add_argument("--rps", type=float, default=8.0)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--skip-control", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.steady_s, args.outage_s, args.recovery_s = 8.0, 15.0, 10.0
    return args


def run(args) -> dict:
    print("== degraded leg (static stability ON) ==", file=sys.stderr)
    deg = run_leg(args, degraded=True)
    control = None
    if not args.skip_control:
        print("== control leg (degraded mode OFF) ==", file=sys.stderr)
        control = run_leg(args, degraded=False)

    steady, outage = deg["steady"], deg["outage"]
    rps_ratio = (outage["rps"] / steady["rps"]) if steady["rps"] else None
    rec_ratio = (deg["recovery"]["rps"] / steady["rps"]) \
        if steady["rps"] else None
    ttft_ratio = (outage["ttft_p50_ms"] / steady["ttft_p50_ms"]) \
        if steady["ttft_p50_ms"] else None
    ctl = control or {}
    ctl_rps_ratio = None
    if ctl and ctl["steady"]["rps"]:
        ctl_rps_ratio = round(ctl["outage"]["rps"] / ctl["steady"]["rps"],
                              3)
    control_loses_fleet = None
    if ctl:
        control_loses_fleet = bool(
            ctl["evictions_total"] > 0
            or ctl["fleet_at_outage_end"] < N_ENGINES
            or ctl["outage"]["errors"] > ctl["outage"]["completed"])
    spread_frac = round(deg["reconnect_spread_s"] / RECONNECT_JITTER_S, 3)
    return {
        "config": {
            "service_rate_rps": SERVICE_RATE_RPS,
            "first_delta_delay_s": FIRST_DELTA_DELAY_S,
            "n_engines": N_ENGINES,
            "drive_rps": args.rps,
            "phases_s": [args.steady_s, args.outage_s, args.recovery_s],
            "reconnect_jitter_s": RECONNECT_JITTER_S,
            "quick": args.quick,
        },
        "degraded": deg,
        "control": control,
        "acceptance": {
            "outage_rps_within_10pct":
                bool(rps_ratio and rps_ratio >= 0.9),
            "outage_ttft_p50_within_10pct":
                bool(ttft_ratio and ttft_ratio <= 1.1),
            "zero_evictions": deg["evictions_total"] == 0,
            "zero_spurious_held_evictions":
                deg["max_held_evictions_observed"] == 0,
            "fleet_intact_after_recovery":
                deg["fleet_final"] == N_ENGINES,
            "monitor_reconnected":
                deg["final_monitor_state"] == "CONNECTED",
            "recovery_spread_over_jitter_window": spread_frac >= 0.1,
            "control_outage_rps_ratio": ctl_rps_ratio,
            "control_loses_fleet": control_loses_fleet,
        },
        "headline": {
            "outage_rps_ratio_vs_steady":
                round(rps_ratio, 3) if rps_ratio else None,
            "recovery_rps_ratio_vs_steady":
                round(rec_ratio, 3) if rec_ratio else None,
            "outage_ttft_p50_ms": outage["ttft_p50_ms"],
            "fleet_survival_ratio":
                round(deg["fleet_final"] / N_ENGINES, 3),
            "reconnect_spread_frac_of_window": spread_frac,
        },
    }


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv)), indent=2))


if __name__ == "__main__":
    main()
