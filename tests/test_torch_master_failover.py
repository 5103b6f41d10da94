"""Failover across several masters of the port, against the JAX masters'
drills (``tests/test_multimaster.py``, ``tests/test_e2e_ha.py``), on the
CPU: each drill runs on a pair of JAX masters and on a pair of port
masters with the reference's fake engines, and the outcomes must be
equal.

- Sharded telemetry ingest: the owner ingests and publishes a load frame
  the other master mirrors; the owner's death hands ingest to the
  rendezvous successor without a SUSPECT transition; a re-registration
  supersedes a tombstone, and a former owner's tombstone is ignored.
- The write-lease proxy: a replica's flip hint is enacted by the elected
  master, and every frontend sees the moved registration.
- Fencing: a degraded master that observes another owner of the election
  key demotes and discards what it held.
- The HA drill: the elected master stops, the replica takes the key and
  serves.
- Processes: two ``python -m xllm_service_tpu_torch.master`` beside the
  port's coordination server, the second at ``--load-balance-policy
  SLO_AWARE``; SIGKILL of the elected one, and the other holds the key
  within the lease TTL plus one sync and serves.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from xllm_service_tpu.common.types import InstanceType as RefInstanceType
from xllm_service_tpu.coordination.client import (
    TcpCoordinationClient as RefTcpClient,
)
from xllm_service_tpu.testing.fake_engine import FakeEngine, FakeEngineConfig
from xllm_service_tpu_torch.common.net import pick_free_port

from fakes import wait_until
from test_torch_master_multimaster import (
    FAST,
    PKGS,
    REPLY,
    Plane,
    both,
    completion,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
OK = (REPLY, ["stop"], [])


def _owner_and_mirror(pl):
    m1, m2 = pl.masters
    name = pl.engines[0].name
    return (m1, m2) if m1.scheduler.instance_mgr.owns_telemetry(name) \
        else (m2, m1)


def _fresh(m, name):
    return wait_until(lambda: 0 <= m.scheduler.instance_mgr
                      .load_info_ages_s().get(name, -1) < 5, timeout=10)


# ------------------------------------------------ sharded telemetry ingest
def drill_frames_mirror(P):
    pl = Plane(P)
    try:
        owner, mirror = _owner_and_mirror(pl)
        name = pl.engines[0].name
        coord = owner.scheduler._coord
        st = owner.scheduler.instance_mgr.stats()
        return dict(
            sole=not mirror.scheduler.instance_mgr.owns_telemetry(name),
            fresh=(_fresh(owner, name), _fresh(mirror, name)),
            no_loadmetrics=not coord.get_prefix(
                P.rpc.LOADMETRICS_KEY_PREFIX),
            frame=P.rpc.LOADFRAME_KEY_PREFIX + owner.scheduler.self_addr
            in coord.get_prefix(P.rpc.LOADFRAME_KEY_PREFIX),
            mode=st["mode"], owned=name in st["owned_instances"],
            aged=name in st["load_info_ages_s"])
    finally:
        pl.close()


def test_frames_mirror_load_and_shard_detection():
    out = both(drill_frames_mirror)
    assert out == dict(sole=True, fresh=(True, True), no_loadmetrics=True,
                       frame=True, mode="shard", owned=True, aged=True)


def drill_owner_death_ingest(P):
    """Kill the master that owns an engine's telemetry: the survivor
    takes ingest and detection over with a heartbeat grace, and the
    engine never turns SUSPECT there."""
    pl = Plane(P)
    try:
        owner, survivor = _owner_and_mirror(pl)
        name = pl.engines[0].name
        smgr = survivor.scheduler.instance_mgr
        assert _fresh(owner, name)
        observed, stop = [], threading.Event()

        def watch():
            while not stop.is_set():
                st = smgr.get_instance_state(name)
                if not observed or observed[-1] != st:
                    observed.append(st)
                time.sleep(0.02)
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        pl.kill(owner)
        took_over = wait_until(lambda: smgr.owns_telemetry(name), timeout=10)
        ages_ok = True
        deadline = time.monotonic() + 3 * FAST[
            "heartbeat_silence_to_suspect_s"]
        while time.monotonic() < deadline:
            age = smgr.load_info_ages_s().get(name, -1)
            ages_ok &= age == -1 or age < 2.0
            time.sleep(0.05)
        stop.set()
        watcher.join(timeout=5)

        def frame_fresh():
            raw = survivor.scheduler._coord.get(
                P.rpc.LOADFRAME_KEY_PREFIX + survivor.scheduler.self_addr)
            if not raw:
                return False
            frame = P.wire.decode_load_frame(raw)
            row = frame["i"].get(name)
            return row is not None and frame["ms"] - row["hb"] < 2000
        return dict(
            took_over=took_over, ages_ok=ages_ok,
            fresh=0 <= smgr.load_info_ages_s().get(name, -1) < 2.0,
            states=sorted({s.name for s in observed}),
            registered=smgr.get_instance_meta(name) is not None,
            frame=wait_until(frame_fresh, timeout=10),
            served=completion(survivor).text())
    finally:
        pl.close()


def test_owner_death_hands_ingest_to_successor_without_suspect():
    out = both(drill_owner_death_ingest)
    assert "SUSPECT" not in out["states"], out["states"]
    assert out == dict(took_over=True, ages_ok=True, fresh=True,
                       states=out["states"], registered=True, frame=True,
                       served=OK)


def drill_reregistration(P):
    pl = Plane(P)
    try:
        owner, mirror = _owner_and_mirror(pl)
        name = pl.engines[0].name
        omgr, mmgr = (owner.scheduler.instance_mgr,
                      mirror.scheduler.instance_mgr)
        omgr.deregister_instance(name, reason="replaced")
        back = wait_until(lambda: omgr.get_instance_meta(name) is not None,
                          timeout=10)
        omgr.publish_telemetry_frames()
        raw = owner.scheduler._coord.get(
            P.rpc.LOADFRAME_KEY_PREFIX + owner.scheduler.self_addr)
        frame = P.wire.decode_load_frame(raw)
        mirrored = wait_until(lambda: mmgr.get_instance_meta(name)
                              is not None, timeout=10)
        time.sleep(0.5)     # a frame tick later it must still be there
        return (back, name in frame["i"], name in (frame["g"] or {}),
                mirrored, mmgr.get_instance_meta(name) is not None)
    finally:
        pl.close()


def test_reregistration_supersedes_tombstone():
    assert both(drill_reregistration) == (True, True, False, True, True)


def drill_stale_tombstone(P):
    pl = Plane(P)
    try:
        _, mirror = _owner_and_mirror(pl)
        name = pl.engines[0].name
        mmgr = mirror.scheduler.instance_mgr
        mmgr._apply_load_frame("203.0.113.9:1", {
            "i": {}, "g": {name: "stale"}, "s": 1, "ms": 1})
        return mmgr.get_instance_meta(name) is not None
    finally:
        pl.close()


def test_mirror_ignores_stale_owner_tombstone():
    assert both(drill_stale_tombstone) is True


# -------------------------------------------------- write-lease proxying
def drill_flip_hint(P):
    """A replica's flip hint reaches the elected master's /rpc/flip_hint;
    its reconcile thread flips the engine, and both frontends see it."""
    pl = Plane(P, engines=({"instance_type": RefInstanceType.PREFILL},
                           {"instance_type": RefInstanceType.DECODE}))
    try:
        m1, m2 = pl.masters
        prefill = pl.engines[0]
        replica = not m2.scheduler.is_master
        DECODE = P.types.InstanceType.DECODE
        m2.scheduler.instance_mgr.request_flip(prefill.name, DECODE)
        moved = wait_until(lambda: all(
            (meta := m.scheduler.instance_mgr.get_instance_meta(
                prefill.name)) is not None and meta.type == DECODE
            for m in (m1, m2)), timeout=10)
        return replica, moved, prefill.instance_type.value
    finally:
        pl.close()


def test_replica_flip_hint_funnels_through_master():
    assert both(drill_flip_hint) == (True, True, "DECODE")


def drill_flip_hint_route(P):
    """The route itself: a flip hint posted to the master's RPC port."""
    pl = Plane(P, n_masters=1,
               engines=({"instance_type": RefInstanceType.PREFILL},
                        {"instance_type": RefInstanceType.DECODE}))
    try:
        import http.client

        m = pl.masters[0]
        prefill = pl.engines[0]

        def post(body):
            c = http.client.HTTPConnection("127.0.0.1", m.rpc_port,
                                           timeout=10)
            try:
                c.request("POST", "/rpc/flip_hint", body=body,
                          headers={"Content-Type": "application/json"})
                r = c.getresponse()
                return r.status, json.loads(r.read())
            finally:
                c.close()
        answers = [post(b"{not json"), post(json.dumps({"type": "DECODE"})),
                   post(json.dumps({"name": prefill.name, "type": "NOPE"}))]
        answers = [(s, b["error"]["code"]) for s, b in answers]
        ok = post(json.dumps({"name": prefill.name, "type": "DECODE"}))
        DECODE = P.types.InstanceType.DECODE
        moved = wait_until(lambda: (meta := m.scheduler.instance_mgr
                                    .get_instance_meta(prefill.name))
                           is not None and meta.type == DECODE, timeout=10)
        return answers, ok, moved
    finally:
        pl.close()


def test_flip_hint_route_validates_and_enacts():
    answers, ok, moved = both(drill_flip_hint_route)
    assert answers == [(400, 400)] * 3
    assert ok == (200, {"ok": True, "master": True}) and moved


# ------------------------------------------------------------- fencing
OUTAGE = dict(coordination_degraded_after_ticks=2,
              coordination_reconnect_jitter_s=0.2,
              degraded_heartbeat_silence_s=0.5)


def drill_fencing(P):
    pl = Plane(P, n_masters=1, engines=(), **OUTAGE)
    m = pl.masters[0]
    try:
        first = wait_until(lambda: m.scheduler.is_master, timeout=5)
        mon = m.scheduler.coordination_health
        P.FAULTS.add("coord.outage", action="error")
        degraded = wait_until(lambda: mon.state() == "DEGRADED", timeout=5)
        held = wait_until(lambda: mon.held.depth() >= 3, timeout=5)
        sticky = m.scheduler.is_master
        # The plane now answers with another owner: fencing demotes.
        pl.coord().set(P.rpc.MASTER_KEY, "10.9.9.9:1", ttl_s=30)
        demoted = wait_until(lambda: not m.scheduler.is_master, timeout=5)
        kinds = {"kvframe_publish", "loadmetrics_upload", "planner_publish",
                 "autoscaler_tick"}

        def kept():
            return sorted(a["kind"] for a in mon.held.report()["actions"]
                          if a["kind"] in kinds)

        def discarded():
            return any("demoted" in r["detail"].get("discard_reason", "")
                       for r in P.RECORDER.recent(
                           limit=50, kind="held_action_discarded"))
        # The demotion drops and flight-records the held actions just after
        # it clears is_master (each record runs the recorder's context
        # providers): both are awaited, not read at once.
        wait_until(lambda: not kept() and discarded(), timeout=5)
        return dict(first=first, degraded=degraded, held=held,
                    sticky=sticky, demoted=demoted, kept=kept(),
                    discarded=discarded(), still_degraded=mon.degraded())
    finally:
        P.FAULTS.clear()
        pl.close()


def test_fencing_observed_owner_demotes_and_discards():
    assert both(drill_fencing) == dict(
        first=True, degraded=True, held=True, sticky=True, demoted=True,
        kept=[], discarded=True, still_degraded=True)


# ------------------------------------------------------------ HA drill
def drill_ha(P):
    pl = Plane(P, engines=({"reply_text": "Hello from the fake engine!"},),
               reconcile_interval_s=0.1, heartbeat_silence_to_suspect_s=1.0,
               detect_disconnected_instance_interval_s=2.0)
    try:
        m1, m2 = pl.masters
        roles = (m1.scheduler.is_master, m2.scheduler.is_master)
        before = [completion(m, prompt="hi").status for m in (m1, m2)]
        m1.stop()
        m1._killed = True
        promoted = wait_until(lambda: m2.scheduler.is_master, timeout=5)
        holder = pl.coord().get(P.rpc.MASTER_KEY) == m2.scheduler.self_addr
        after = completion(m2, prompt="after failover")
        return roles, before, promoted, holder, after.status, after.text()
    finally:
        pl.close()


def test_replica_takeover_and_serving():
    assert both(drill_ha) == (
        (True, False), [200, 200], True, True, 200,
        ("Hello from the fake engine!", ["stop"], []))


# ------------------------------------------------------------- processes
def test_two_master_processes_take_over_after_sigkill(tmp_path):
    """The port's coordination server and two port masters as processes,
    a fake engine in this process: SIGKILL the elected master, and the
    other holds XLLM:SERVICE:MASTER within the lease TTL plus one sync and
    serves. SIGTERM stops the rest with exit 0."""
    T = PKGS["port"]
    ttl, sync = 1.0, 0.3
    coord_port = pick_free_port()
    addr = f"127.0.0.1:{coord_port}"
    procs, logs, engine, watcher = {}, {}, None, None

    def spawn(name, *argv):
        logs[name] = open(tmp_path / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=ROOT, env=ENV,
            stdout=logs[name], stderr=subprocess.STDOUT)

    def master(name, *extra):
        ports = (pick_free_port(), pick_free_port())
        spawn(name, "xllm_service_tpu_torch.master", "--host", "127.0.0.1",
              "--http-port", str(ports[0]), "--rpc-port", str(ports[1]),
              "--coordination-addr", addr, "--lease-ttl-s", str(ttl),
              "--sync-interval-s", str(sync), *extra)
        return ports

    try:
        spawn("coord", "xllm_service_tpu_torch.coordination.server",
              "--host", "127.0.0.1", "--port", str(coord_port))
        clients = []

        def connected():
            try:
                clients.append(T.client.TcpCoordinationClient(addr))
                return True
            except OSError:
                return False
        assert wait_until(connected, timeout=30)
        watcher = clients[0]
        a_http, a_rpc = master("a")
        assert wait_until(lambda: watcher.get(T.rpc.MASTER_KEY)
                          == f"127.0.0.1:{a_rpc}", timeout=30), \
            (tmp_path / "a.log").read_text()[-2000:]
        b_http, b_rpc = master("b", "--load-balance-policy", "SLO_AWARE")
        engine = FakeEngine(RefTcpClient(addr), FakeEngineConfig(
            reply_text=REPLY, chunk_size=4, heartbeat_interval_s=0.2,
            lease_ttl_s=1.0)).start()

        class M:          # what ``completion`` needs of a master
            def __init__(self, port):
                self.http_port = port

        def serves(port):
            try:
                return completion(M(port)).text() == OK
            except (OSError, ValueError, KeyError):
                return False
        assert wait_until(lambda: serves(a_http) and serves(b_http),
                          timeout=30), (tmp_path / "b.log").read_text()[-2000:]
        assert watcher.get(T.rpc.MASTER_KEY) == f"127.0.0.1:{a_rpc}"
        members = watcher.get_prefix(T.rpc.SERVICE_KEY_PREFIX)
        assert {f"127.0.0.1:{a_rpc}", f"127.0.0.1:{b_rpc}"} <= {
            k[len(T.rpc.SERVICE_KEY_PREFIX):] for k in members}

        t0 = time.monotonic()
        procs["a"].send_signal(signal.SIGKILL)
        procs["a"].wait(timeout=10)
        took_over = wait_until(lambda: watcher.get(T.rpc.MASTER_KEY)
                               == f"127.0.0.1:{b_rpc}", timeout=10)
        took = time.monotonic() - t0
        assert took_over, (tmp_path / "b.log").read_text()[-2000:]
        assert took <= ttl + sync, took
        assert wait_until(lambda: serves(b_http), timeout=10)
    finally:
        if engine is not None:
            engine.stop()
        if watcher is not None:
            watcher.close()
        for name in ("b", "a", "coord"):
            p = procs.get(name)
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for f in logs.values():
            f.close()
    assert procs["a"].returncode == -signal.SIGKILL
    for name in ("b", "coord"):
        assert procs[name].returncode in (0, -signal.SIGTERM), \
            (name, (tmp_path / f"{name}.log").read_text()[-2000:])
