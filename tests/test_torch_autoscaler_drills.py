"""The closed-loop drills of ``tests/test_autoscaler.py``
(``TestClosedLoopDrills``) on a JAX master and on a port master, on the
CPU: each master with the autoscaler on, two of its package's fake
engines and an in-process actuator that launches more of them. The
outcomes must be equal:

- the admin surface: ``/admin/autoscaler`` ticks, holds the fleet's size
  as its target and names the actuator; ``/metrics`` carries the
  autoscaler's and the fleet's gauges;
- an instance killed mid-burst: its stream completes by failover and the
  controller replaces the lost capacity through the actuator;
- a graceful drain retires an idle instance without an eviction, and the
  survivor serves;
- a draining instance killed mid-drain falls back to the failover path.
"""

import http.client
import importlib
import json
import threading
import time

import torch

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

PKGS = {"ref": "xllm_service_tpu", "port": "xllm_service_tpu_torch"}
REPLY = "Scaling is the art of adding exactly what the burst demands."
ENGINE_CFG = dict(reply_text=REPLY, chunk_size=4, delay_s=0.05,
                  heartbeat_interval_s=0.1, lease_ttl_s=0.5)
MASTER_OPTS = dict(
    host="127.0.0.1", http_port=0, rpc_port=0,
    lease_ttl_s=0.5, reconcile_interval_s=0.05,
    heartbeat_silence_to_suspect_s=0.3,
    detect_disconnected_instance_interval_s=0.3,
    health_probe_attempts=1, health_probe_timeout_s=0.2,
    sync_interval_s=0.1,
    failover_backoff_base_s=0.05, failover_backoff_max_s=0.3,
    rpc_backoff_base_s=0.02, rpc_backoff_max_s=0.1,
    autoscaler_enabled=True, autoscaler_min_instances=2,
    autoscaler_breach_ticks=2, autoscaler_idle_ticks=3,
    autoscaler_scale_out_cooldown_s=0.3,
    autoscaler_scale_in_cooldown_s=0.3,
    autoscaler_stale_hold_s=30.0,
    autoscaler_drain_grace_s=0.05,
    autoscaler_drain_deadline_s=10.0,
    autoscaler_spawn_retry_base_s=0.05,
    autoscaler_spawn_retry_max_s=0.3,
    slo_ttft_ms=60000.0, slo_tpot_ms=60000.0)


def mod(P, name):
    return importlib.import_module(f"{PKGS[P]}.{name}")


def engine_actuator(P, store):
    """The drills' in-process actuator: a launch starts a fake engine of
    package ``P`` on the shared store."""
    memory = mod(P, "coordination.memory")
    fe = mod(P, "testing.fake_engine")

    class FakeEngineActuator(mod(P, "autoscaler.actuator").FleetActuator):
        name = "fake-engine"

        def __init__(self):
            self.engines = {}

        def scale_out(self, count, reason, slice_id=""):
            for _ in range(count):
                e = fe.FakeEngine(memory.InMemoryCoordination(store),
                                  fe.FakeEngineConfig(**ENGINE_CFG)).start()
                self.engines[e.name] = e
            return count

        def pending(self, live):
            return sum(1 for n in self.engines if n not in live)

        def reap(self, instance):
            e = self.engines.pop(instance, None)
            if e is not None:
                e.stop()

        def stop(self):
            for e in list(self.engines.values()):
                e.stop()
            self.engines.clear()

    return FakeEngineActuator()


class Cluster:
    """Master (autoscaler on) + two fake engines; the in-process actuator
    goes in once the external fleet registered (the cold-start ticks go to
    the hint actuator)."""

    def __init__(self, P):
        self.P = P
        memory = mod(P, "coordination.memory")
        fe = mod(P, "testing.fake_engine")
        self.store = memory.MemoryStore(expiry_tick_s=0.02)
        self.master = mod(P, "master").Master(
            mod(P, "common.config").ServiceOptions(**MASTER_OPTS),
            coord=memory.InMemoryCoordination(self.store))
        self.master.start()
        self.engines = [fe.FakeEngine(memory.InMemoryCoordination(self.store),
                                      fe.FakeEngineConfig(**ENGINE_CFG))
                        .start() for _ in range(2)]
        self.mgr = self.master.scheduler.instance_mgr
        assert wait_until(
            lambda: len(self.mgr.routing_snapshot().schedulable) == 2,
            timeout=5)
        self.act = engine_actuator(P, self.store)
        self.master.scheduler.autoscaler._actuator = self.act

    def get(self, path):
        c = http.client.HTTPConnection("127.0.0.1", self.master.http_port,
                                       timeout=10)
        try:
            c.request("GET", path)
            return c.getresponse().read().decode()
        finally:
            c.close()

    def stream(self):
        c = http.client.HTTPConnection("127.0.0.1", self.master.http_port,
                                       timeout=30)
        try:
            c.request("POST", "/v1/completions", body=json.dumps({
                "model": "fake-model", "prompt": "autoscale",
                "stream": True, "max_tokens": 64}),
                headers={"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200
            text = []
            for frame in r.read().split(b"\n\n"):
                if frame.startswith(b"data: ") and frame != b"data: [DONE]":
                    text.append(json.loads(frame[6:])["choices"][0]["text"])
            return "".join(text)
        finally:
            c.close()

    def stream_in_background(self):
        texts = []
        t = threading.Thread(target=lambda: texts.append(self.stream()))
        t.start()
        assert wait_until(lambda: any(e.accepted_requests
                                      for e in self.engines), timeout=5)
        return t, texts, next(e for e in self.engines
                              if e.accepted_requests)

    def close(self):
        self.act.stop()
        for e in self.engines:
            e.stop()
        self.master.stop()
        self.store.close()


def both(drill):
    outs = {}
    for P in ("ref", "port"):
        c = Cluster(P)
        try:
            outs[P] = drill(c)
        finally:
            c.close()
    assert outs["port"] == outs["ref"], (outs["port"], outs["ref"])
    return outs["port"]


def drill_admin_surface(c):
    def rep():
        return json.loads(c.get("/admin/autoscaler"))
    ticked = wait_until(lambda: rep()["ticks"] > 0, timeout=10)
    desired = wait_until(lambda: rep()["state"]["desired"] == 2, timeout=10)
    r = rep()
    metrics = c.get("/metrics")
    return (ticked, desired, r["enabled"], r["master"], r["actuator"],
            bool(r["decisions"]),
            "autoscaler_last_decision_age_seconds" in metrics,
            'fleet_size{role="prefill"}' in metrics)


def test_admin_autoscaler_surface():
    assert both(drill_admin_surface) == (True, True, True, True,
                                         "fake-engine", True, True, True)


def drill_killed_mid_burst(c):
    desired = wait_until(lambda: c.master.scheduler.autoscaler.report()
                         ["state"]["desired"] == 2, timeout=10)
    t, texts, victim = c.stream_in_background()
    time.sleep(0.1)           # a few deltas in flight
    victim.kill()
    t.join(timeout=30)
    launched = wait_until(lambda: len(c.act.engines) >= 1, timeout=10)
    restored = wait_until(
        lambda: len(c.mgr.routing_snapshot().schedulable) == 2, timeout=10)
    return desired, texts, launched, restored


def test_instance_killed_mid_burst_is_replaced():
    assert both(drill_killed_mid_burst) == (True, [REPLY], True, True)


def drill_graceful_drain(c):
    victim = c.engines[1].name
    c.mgr.request_drain(victim)
    gone = wait_until(lambda: c.mgr.get_instance_meta(victim) is None,
                      timeout=10)
    evictions = mod(c.P, "common.metrics").INSTANCE_EVICTIONS_TOTAL.labels(
        instance=victim).value()
    return gone, evictions, c.stream()


def test_graceful_drain_retires_idle_instance():
    assert both(drill_graceful_drain) == (True, 0, REPLY)


def drill_killed_mid_drain(c):
    t, texts, victim = c.stream_in_background()
    c.mgr.request_drain(victim.name)
    draining = wait_until(
        lambda: c.mgr.get_instance_state(victim.name).name == "DRAINING",
        timeout=5)
    victim.kill()             # dies mid-drain with the stream in flight
    t.join(timeout=30)
    gone = wait_until(lambda: c.mgr.get_instance_meta(victim.name) is None,
                      timeout=10)
    return draining, texts, gone


def test_draining_instance_killed_mid_drain_fails_over():
    assert both(drill_killed_mid_drain) == (True, [REPLY], True)
