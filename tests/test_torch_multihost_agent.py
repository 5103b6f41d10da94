"""One port agent instance over two processes behind the reference master
(the port's counterpart of tests/test_multihost.py::TestMultihostAgentE2E):
the reference coordination server and ``Master`` run here, and two ranks
of ``python -m xllm_service_tpu_torch.engine.agent --tp 2 --device cpu``
join one gloo group (``XLLM_MH_COORDINATOR``, ``XLLM_MH_NUM_HOSTS``,
``XLLM_MH_HOST_ID``) over 127.0.0.1, each holding one model shard of a
``model=2`` mesh. The primary registers and serves HTTP, the follower
mirrors its engine events in lockstep. A completion must come back through
the master with ``finish_reason == "length"`` and six tokens, and the
follower must exit 0 once the primary stops.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from xllm_service_tpu.common.config import ServiceOptions
from xllm_service_tpu.coordination.server import CoordinationServer
from xllm_service_tpu.master import Master

ROOT = Path(__file__).resolve().parents[1]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_completion_through_the_master_from_two_ranks(tmp_path):
    server = CoordinationServer(host="127.0.0.1", port=0)
    server.start_background()
    coord = f"127.0.0.1:{server.port}"
    master = Master(ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                                   coordination_addr=coord,
                                   lease_ttl_s=1.0, sync_interval_s=0.3,
                                   reconcile_interval_s=0.1))
    master.start()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "XLLM_MH_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "XLLM_MH_NUM_HOSTS": "2"}
    cmd = [sys.executable, "-m", "xllm_service_tpu_torch.engine.agent",
           "--coordination-addr", coord, "--model-id", "tiny-model",
           "--model-config", "tiny", "--tp", "2", "--device", "cpu",
           "--max-seq-len", "128", "--num-pages", "64",
           "--max-batch-size", "2"]
    procs, logs = [], []
    try:
        for rank in (1, 0):
            log = open(tmp_path / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env={**env, "XLLM_MH_HOST_ID": str(rank)},
                stdout=log, stderr=subprocess.STDOUT))
        follower, primary = procs
        body = json.dumps({"model": "tiny-model", "prompt": [5, 7, 9, 11],
                           "max_tokens": 6}).encode()
        deadline = time.monotonic() + 180
        out, last = None, None
        while out is None and time.monotonic() < deadline:
            assert primary.poll() is None and follower.poll() is None, \
                (tmp_path / "rank0.log").read_text()[-3000:]
            try:
                resp = urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{master.http_port}/v1/completions",
                    data=body, headers={"Content-Type": "application/json"}),
                    timeout=20)
                out = json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 — the ranks warming up
                last = e
                time.sleep(0.5)
        assert out is not None, f"never served: {last}"
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["completion_tokens"] == 6
        # SIGTERM drains the primary's agent; its stop sends the shutdown
        # event, on which the follower leaves its loop and exits 0.
        primary.send_signal(signal.SIGTERM)
        assert follower.wait(timeout=60) == 0, \
            (tmp_path / "rank1.log").read_text()[-3000:]
        assert "exiting (shutdown event)" in \
            (tmp_path / "rank1.log").read_text()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for log in logs:
            log.close()
        master.stop()
        server.shutdown()
        server.server_close()
