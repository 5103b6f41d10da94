"""The port's ``TcpCoordinationClient`` against the repo-root native (C++)
coordination server, ``csrc/coordination_server``, built with
``make -C csrc`` as ``tests/test_native_coordination.py`` builds it.

The binary belongs to neither Python package; the port does not copy it.
Covered: plain and bulk operations, watches, leases kept alive and lapsing
at a client's death, ``create_if_absent`` elections, guarded prefix
removal, and the port's master with a port fake engine coordinated by it.
"""

import http.client
import json
import re
import subprocess
import threading
import time
from pathlib import Path

import pytest

from xllm_service_tpu_torch.coordination.base import WatchEventType
from xllm_service_tpu_torch.coordination.client import TcpCoordinationClient

from fakes import wait_until

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native_server():
    binary = REPO / "csrc" / "coordination_server"
    build = subprocess.run(["make", "-C", str(REPO / "csrc")],
                           capture_output=True, text=True)
    if build.returncode != 0 or not binary.exists():
        pytest.skip(f"native build failed: {build.stderr[-500:]}")
    proc = subprocess.Popen([str(binary), "--port", "0"],
                            stderr=subprocess.PIPE, text=True)
    line = proc.stderr.readline()
    m = re.search(r"listening on :(\d+)", line)
    assert m, f"unexpected server banner: {line!r}"
    time.sleep(0.1)
    yield f"127.0.0.1:{m.group(1)}"
    proc.terminate()
    proc.wait(timeout=5)


class _Sink:
    def __init__(self):
        self.events = []
        self.cv = threading.Condition()

    def __call__(self, events, prefix):
        with self.cv:
            self.events.extend(events)
            self.cv.notify_all()

    def wait_for(self, pred, timeout=5.0):
        with self.cv:
            return self.cv.wait_for(lambda: pred(self.events), timeout)


def test_plain_and_bulk_operations(native_server):
    c = TcpCoordinationClient(native_server, namespace="port-kv")
    try:
        assert c.set("a/b", 'va"l\nue')      # JSON escaping on the wire
        assert c.get("a/b") == 'va"l\nue'
        meta = '{"name": "host:1", "模型": "型号", "emoji": "🚀"}'
        assert c.set("uni", meta) and c.get("uni") == meta
        c.bulk_set({"a/c": "2", "z": "3"})
        assert c.get_prefix("a/") == {"a/b": 'va"l\nue', "a/c": "2"}
        assert c.rm("a/b") and c.get("a/b") is None
        assert c.bulk_rm(["a/c", "missing"]) == 1
        assert c.get("z") == "3"
    finally:
        c.close()


def test_watch_sees_puts_and_a_lapsed_lease(native_server):
    owner = TcpCoordinationClient(native_server)
    observer = TcpCoordinationClient(native_server)
    try:
        sink = _Sink()
        observer.add_watch("psvc/", sink)
        owner.set("psvc/me", "alive", ttl_s=0.3)
        assert sink.wait_for(lambda ev: any(
            e.type == WatchEventType.PUT and e.key == "psvc/me"
            for e in ev))
        time.sleep(0.9)
        assert observer.get("psvc/me") == "alive"   # keepalive holds it
        owner.close()                               # the owner dies
        assert sink.wait_for(lambda ev: any(
            e.type == WatchEventType.DELETE and e.key == "psvc/me"
            for e in ev), timeout=8.0)
    finally:
        owner.close()
        observer.close()


def test_create_if_absent_election(native_server):
    a = TcpCoordinationClient(native_server)
    b = TcpCoordinationClient(native_server)
    try:
        assert a.create_if_absent("PEL/MASTER", "a", ttl_s=0.3)
        assert not b.create_if_absent("PEL/MASTER", "b", ttl_s=0.3)
        a.close()
        assert wait_until(lambda: b.create_if_absent("PEL/MASTER", "b",
                                                     ttl_s=0.3), timeout=5)
        assert b.get("PEL/MASTER") == "b"
    finally:
        a.close()
        b.close()


def test_guarded_prefix_removal(native_server):
    c = TcpCoordinationClient(native_server)
    try:
        c.set("PG/CACHE/a", "1")
        c.set("PG/CACHE/b", "2")
        assert c.rm_prefix("PG/CACHE/", guard_key="PG/MASTER") == 0
        c.set("PG/MASTER", "me")
        assert c.rm_prefix("PG/CACHE/", guard_key="PG/MASTER") == 2
        assert c.get_prefix("PG/CACHE/") == {}
    finally:
        c.close()


def test_port_master_and_fake_engine_on_native_coordination(native_server):
    from xllm_service_tpu_torch.common.config import ServiceOptions
    from xllm_service_tpu_torch.master import Master
    from xllm_service_tpu_torch.testing.fake_engine import (
        FakeEngine,
        FakeEngineConfig,
    )

    opts = ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                          coordination_addr=native_server,
                          coordination_namespace="port-native-e2e",
                          lease_ttl_s=1.0, sync_interval_s=0.3)
    master = Master(opts)
    master.start()
    engine = FakeEngine(
        TcpCoordinationClient(native_server,
                              namespace="port-native-e2e"),
        FakeEngineConfig()).start()
    try:
        assert wait_until(
            lambda: master.scheduler.instance_mgr.get_instance_meta(
                engine.name) is not None, timeout=10)
        c = http.client.HTTPConnection("127.0.0.1", master.http_port,
                                       timeout=10)
        c.request("POST", "/v1/completions", body=json.dumps(
            {"model": "fake-model", "prompt": "hi",
             "max_tokens": 32}).encode(),
            headers={"Content-Type": "application/json"})
        r = c.getresponse()
        body = r.read()
        c.close()
        assert r.status == 200, body
        assert json.loads(body)["choices"][0]["text"] == \
            "Hello from the fake engine!"
    finally:
        engine.stop()
        master.stop()
