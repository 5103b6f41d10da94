"""What the port's master does not serve yet is refused by name, never
given way to.

- ``--autoscaler-enabled``: the master exits 2 before it starts, naming
  ROADMAP queue 1 item 23; a ``Scheduler`` built with it raises.
- The admin and fleet surface (item 24) is unknown routes: 404, while the
  JAX master serves them.

Several masters, the handoff routes, ``/rpc/flip_hint`` and SLO_AWARE are
served: ``tests/test_torch_master_multimaster.py``, ``_failover.py`` and
``_slo.py``.
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
from xllm_service_tpu.master import Master as RefMaster
from xllm_service_tpu_torch.common.config import ServiceOptions
from xllm_service_tpu_torch.coordination import memory
from xllm_service_tpu_torch.master import Master
from xllm_service_tpu_torch.rpc import SERVICE_KEY_PREFIX
from xllm_service_tpu_torch.scheduler.scheduler import (
    Scheduler,
    UnportedFeatureError,
)

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


@pytest.mark.parametrize("argv", [["--autoscaler-enabled"]],
                         ids=["autoscaler"])
def test_unported_options_exit_2_naming_the_item(argv):
    out = _run_master(*argv)
    assert out.returncode == 2, (out.stdout, out.stderr)
    assert "ROADMAP queue 1 item 23" in out.stderr


@pytest.mark.parametrize("kw", [
    pytest.param(dict(autoscaler_enabled=True), id="kw1")])
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
    ("http", "GET", "/admin/flightrecorder/recent")])
def test_unported_routes_are_unknown(masters, site, method, path):
    ref, port = masters
    p = port.http_port if site == "http" else port.rpc_port
    status, body = _call(p, method, path, {} if method == "POST" else None)
    assert (status, body) == (404, b"404: Not Found")
    rp = ref.http_port if site == "http" else ref.rpc_port
    assert _call(rp, method, path,
                 {} if method == "POST" else None)[0] != 404

