"""The port as a cluster of its own processes, on the CPU:
``python -m xllm_service_tpu_torch.coordination.server``, ``python -m
xllm_service_tpu_torch.master`` and ``python -m
xllm_service_tpu_torch.engine.agent --device cpu`` (tiny random model)
serve the OpenAI API with no process of the JAX package. The agent
registers through the coordination server, the master answers
``/v1/models``, a completion, a streamed chat and ``/metrics``; SIGTERM
stops every process with exit 0 or the signal's code."""

import http.client
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

from xllm_service_tpu_torch.common.net import pick_free_port

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def _get(port, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("POST" if body is not None else "GET", path,
                  body=json.dumps(body) if body is not None else None,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def test_port_processes_make_a_cluster(tmp_path):
    coord_port, http_port, rpc_port = (pick_free_port() for _ in range(3))
    addr = f"127.0.0.1:{coord_port}"
    logs = {n: open(tmp_path / f"{n}.log", "w")
            for n in ("coord", "master", "agent")}
    procs = {}

    def spawn(name, *argv):
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=ROOT, env=ENV,
            stdout=logs[name], stderr=subprocess.STDOUT)

    try:
        spawn("coord", "xllm_service_tpu_torch.coordination.server",
              "--host", "127.0.0.1", "--port", str(coord_port))
        time.sleep(0.5)
        spawn("master", "xllm_service_tpu_torch.master",
              "--host", "127.0.0.1", "--http-port", str(http_port),
              "--rpc-port", str(rpc_port), "--coordination-addr", addr,
              "--lease-ttl-s", "1.0", "--sync-interval-s", "0.3")
        spawn("agent", "xllm_service_tpu_torch.engine.agent",
              "--coordination-addr", addr, "--host", "127.0.0.1",
              "--model-config", "tiny", "--model-id", "tiny",
              "--device", "cpu", "--max-seq-len", "128")
        deadline = time.monotonic() + 90
        models = []
        while time.monotonic() < deadline and not models:
            for p in procs.values():
                assert p.poll() is None, (tmp_path / "agent.log").read_text()
            try:
                status, body = _get(http_port, "/v1/models")
                models = json.loads(body)["data"] if status == 200 else []
            except OSError:
                pass
            time.sleep(0.3)
        assert [m["id"] for m in models] == ["tiny"]
        status, body = _get(http_port, "/v1/completions", {
            "model": "tiny", "prompt": [5, 7, 9, 11], "max_tokens": 6,
            "temperature": 0, "ignore_eos": True})
        assert status == 200, body
        out = json.loads(body)
        assert out["usage"]["completion_tokens"] == 6
        status, body = _get(http_port, "/v1/chat/completions", {
            "model": "tiny", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4, "temperature": 0, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}})
        assert status == 200 and body.endswith(b"data: [DONE]\n\n")
        last = json.loads(body.split(b"\n\n")[-3][6:])
        assert last["usage"]["completion_tokens"] == 4
        status, body = _get(http_port, "/metrics")
        assert status == 200 and b"server_request_in_total" in body
    finally:
        for name in ("agent", "master", "coord"):
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
    for name, p in procs.items():
        assert p.returncode in (0, -signal.SIGTERM), \
            (name, (tmp_path / f"{name}.log").read_text()[-2000:])
