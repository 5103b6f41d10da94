"""What the port's master does not serve yet is refused by name, never
given way to.

- ``--load-balance-policy SLO_AWARE`` and ``--autoscaler-enabled``: the
  master exits 2 before it starts, naming ROADMAP queue 1 item 23; a
  ``Scheduler`` built with them raises.
- Another live master: a port master refuses to start while another
  address holds ``XLLM:SERVICE:MASTER`` (item 22), against the port's
  store, and as a process against a JAX master elected through the port's
  coordination server.
- A request owned by another live frontend answers 503 naming item 22.
- The admin and fleet surface (item 24), the handoff routes (item 22) and
  ``/rpc/flip_hint`` (item 23) are unknown routes: 404, while the JAX
  master serves them.
"""

import http.client
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from xllm_service_tpu.common.config import ServiceOptions as RefOptions
from xllm_service_tpu.coordination.client import (
    TcpCoordinationClient as RefTcpClient,
)
from xllm_service_tpu.master import Master as RefMaster
from xllm_service_tpu_torch.common.config import ServiceOptions
from xllm_service_tpu_torch.coordination import memory
from xllm_service_tpu_torch.coordination.server import CoordinationServer
from xllm_service_tpu_torch.master import Master
from xllm_service_tpu_torch.multimaster.ownership import rendezvous_owner
from xllm_service_tpu_torch.rpc import MASTER_KEY, SERVICE_KEY_PREFIX
from xllm_service_tpu_torch.scheduler.scheduler import (
    Scheduler,
    UnportedFeatureError,
)

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def _opts(**kw):
    return ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                          lease_ttl_s=1.0, **kw)


def _run_master(*argv, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "xllm_service_tpu_torch.master",
         "--host", "127.0.0.1", "--http-port", "0", "--rpc-port", "0",
         *argv], cwd=ROOT, env=ENV, capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.parametrize("argv", [
    ["--load-balance-policy", "SLO_AWARE"], ["--autoscaler-enabled"]],
    ids=["slo_aware", "autoscaler"])
def test_unported_options_exit_2_naming_the_item(argv):
    out = _run_master(*argv)
    assert out.returncode == 2, (out.stdout, out.stderr)
    assert "ROADMAP queue 1 item 23" in out.stderr


@pytest.mark.parametrize("kw", [dict(load_balance_policy="slo_aware"),
                                dict(autoscaler_enabled=True)])
def test_scheduler_refuses_unported_options(kw):
    store = memory.MemoryStore(expiry_tick_s=0.05)
    try:
        with pytest.raises(UnportedFeatureError, match="item 23"):
            Scheduler(_opts(**kw), coord=memory.InMemoryCoordination(store),
                      start_threads=False)
        # Nothing was registered on the way out.
        assert store.get_prefix(SERVICE_KEY_PREFIX) == {}
    finally:
        store.close()


def test_second_master_is_refused():
    store = memory.MemoryStore(expiry_tick_s=0.05)
    holder = memory.InMemoryCoordination(store)
    try:
        holder.set(MASTER_KEY, "10.9.9.9:1", ttl_s=1.0)
        with pytest.raises(UnportedFeatureError, match="item 22"):
            Master(_opts(), coord=memory.InMemoryCoordination(store))
        assert set(store.get_prefix(SERVICE_KEY_PREFIX)) == {MASTER_KEY}
        # Once the other master's lease lapses, a port master starts.
        holder.close()
        assert wait_until(lambda: store.get(MASTER_KEY) is None, timeout=5)
        m = Master(_opts(), coord=memory.InMemoryCoordination(store))
        m.start()
        try:
            assert m.scheduler.is_master
        finally:
            m.stop()
    finally:
        store.close()


def test_second_master_process_refused_beside_a_jax_master():
    srv = CoordinationServer(host="127.0.0.1", port=0,
                             store=memory.MemoryStore(expiry_tick_s=0.05))
    srv.start_background()
    addr = f"127.0.0.1:{srv.port}"
    ref = RefMaster(RefOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                               lease_ttl_s=1.0, coordination_addr=addr),
                    coord=RefTcpClient(addr))
    ref.start()
    try:
        assert ref.scheduler.is_master
        out = _run_master("--coordination-addr", addr)
        assert out.returncode == 2, (out.stdout, out.stderr)
        assert "ROADMAP queue 1 item 22" in out.stderr
        assert ref.scheduler.self_addr in out.stderr
    finally:
        ref.stop()
        srv.stop()


def _call(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request(method, path, body=json.dumps(body) if body else None,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.fixture(scope="module")
def masters():
    made = []
    for cls, opts_cls in ((RefMaster, RefOptions), (Master, ServiceOptions)):
        mod = sys.modules[cls.__module__.rsplit(".", 1)[0]
                          + ".coordination.memory"]
        store = mod.MemoryStore(expiry_tick_s=0.05)
        m = cls(opts_cls(host="127.0.0.1", http_port=0, rpc_port=0,
                         lease_ttl_s=1.0),
                coord=mod.InMemoryCoordination(store))
        m.start()
        made.append((m, store))
    yield [m for m, _ in made]
    for m, store in made:
        m.stop()
        store.close()


@pytest.mark.parametrize("site,method,path", [
    ("http", "GET", "/admin/config"), ("http", "GET", "/admin/hotpath"),
    ("http", "GET", "/admin/overload"), ("http", "GET", "/metrics/fleet"),
    ("http", "GET", "/admin/trace/recent"),
    ("http", "GET", "/admin/flightrecorder/recent"),
    ("rpc", "POST", "/rpc/handoff?sid=x"),
    ("rpc", "POST", "/rpc/handoff_abort?sid=x"),
    ("rpc", "POST", "/rpc/flip_hint")])
def test_unported_routes_are_unknown(masters, site, method, path):
    ref, port = masters
    p = port.http_port if site == "http" else port.rpc_port
    status, body = _call(p, method, path, {} if method == "POST" else None)
    assert (status, body) == (404, b"404: Not Found")
    rp = ref.http_port if site == "http" else ref.rpc_port
    assert _call(rp, method, path,
                 {} if method == "POST" else None)[0] != 404


def test_request_owned_by_another_frontend_is_refused(masters):
    port = masters[1]
    sched = port.scheduler
    other = "10.9.9.9:1"
    sched._coord.set(SERVICE_KEY_PREFIX + other, "{}", ttl_s=1.0)
    try:
        assert wait_until(lambda: other in sched.ownership.members(),
                          timeout=5)
        key = next(k for k in (f"affinity-{i}" for i in range(200))
                   if rendezvous_owner(sched.ownership.members(), k)
                   == other)
        # No engine is needed: ownership is decided before admission.
        sched.instance_mgr.has_available_instances = lambda: True
        status, body = _call(port.http_port, "POST", "/v1/completions", {
            "model": "m", "prompt": "x", "ownership_key": key})
        assert status == 503
        assert "ROADMAP queue 1 item 22" in json.loads(body)["error"]["message"]
    finally:
        del sched.instance_mgr.has_available_instances
        sched._coord.rm(SERVICE_KEY_PREFIX + other)
