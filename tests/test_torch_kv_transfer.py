"""The port's KV transfer (``engine/kv_transfer.py``) against the
reference module's, on the same inputs: ``transfer_uuid``, the bandwidth
accountant (on a shared fake clock), the stream offer table (descriptors,
frames, TTL ``gc``) and ``pull_stream`` (the same frames through an
injected transport, and each side's default transport against the port's
codec on a loopback server). The CUDA IPC manager is held between two
processes on a card (``cuda``-marked; it skips here)."""

import json
import subprocess
import sys
import textwrap
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from xllm_service_tpu.engine import kv_transfer as ref
from xllm_service_tpu_torch.engine import kv_transfer as port
from xllm_service_tpu_torch.rpc import msgpack_lite

ROOT = Path(__file__).resolve().parents[1]


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    # Both modules read the one ``time`` module.
    monkeypatch.setattr(time, "monotonic", c)
    return c


def test_transfer_uuid():
    for sid, inc in (("a", ""), ("req-1", "inc"), ("x" * 300, "stream:i"),
                     ("é", "")):
        u = port.transfer_uuid(sid, inc)
        assert u == ref.transfer_uuid(sid, inc) and 0 <= u < 2**63


def test_bandwidth_accountant(clock):
    a, b = (m.BandwidthAccountant(ici_bytes_per_s=1e6, dcn_bytes_per_s=0)
            for m in (port, ref))
    for link, n, dt, busy in (("ici", 400_000, 0.0, 0.1),
                              ("ici", 900_000, 0.2, 0.3),
                              ("dcn", 5_000_000, 0.1, 0.05),
                              ("ici", 10, 3.0, 0.0)):
        clock.t += dt
        assert a.debit(link, n) == b.debit(link, n)
        a.record_busy(link, busy)
        b.record_busy(link, busy)
    assert a.stats() == b.stats()
    assert a.stats()["ici"]["budget_bytes_per_s"] == 1e6


def test_stream_offer_table(clock):
    data = bytes(range(256)) * 40
    a, b = port.StreamOfferTable(3000), ref.StreamOfferTable(3000)
    da = a.offer("r1", data, [10240], "uint8", incarnation="i",
                 block_bytes=1024)
    db = b.offer("r1", data, [10240], "uint8", incarnation="i",
                 block_bytes=1024)
    assert da == db and da["stream_uuid"] == port.transfer_uuid(
        "r1", "stream:i")
    u = da["stream_uuid"]
    for off, mx in ((0, 3000), (9000, 3000), (10239, 5), (20000, 10)):
        assert a.read_chunk(u, off, mx) == b.read_chunk(u, off, mx)
    assert a.read_chunk(u + 1, 0, 10) is None is b.read_chunk(u + 1, 0, 10)
    assert a.count() == b.count() == 1
    clock.t += port.OFFER_TTL_S - 1
    a.gc(), b.gc()
    assert a.count() == b.count() == 1
    clock.t += 2
    a.gc(), b.gc()
    assert a.count() == b.count() == 0
    a.offer("r2", data, [10240], "uint8")
    a.release(port.transfer_uuid("r2", "stream:"))
    assert a.count() == 0


def _table_post(table):
    """A transport serving ``table`` as the agent's /rpc/kv_stream_pull
    does, through the codec; counts round trips."""
    calls = []

    def post(url, payload):
        calls.append(url)
        frame = table.read_chunk(payload["uuid"], payload["offset"],
                                 payload["max_bytes"])
        return msgpack_lite.unpackb(msgpack_lite.packb(frame))
    return post, calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pull_stream_against_the_reference(dtype):
    x = np.random.default_rng(0).standard_normal((2, 2, 5, 2, 16, 8))
    arr = x.astype(np.float32 if dtype == "float32" else ml_dtypes.bfloat16)
    t = port.tensor_from_bytes(arr.tobytes(), list(arr.shape), dtype)
    assert port.tensor_bytes(t) == arr.tobytes()
    table = port.StreamOfferTable(5000)
    desc = table.offer("r", port.tensor_bytes(t), list(t.shape),
                       port.dtype_name(t.dtype))
    results = []
    for mod in (port, ref):
        post, calls = _table_post(table)
        acc = mod.BandwidthAccountant()
        results.append((mod.pull_stream("peer:1", desc, accountant=acc,
                                        link="ici", post=post),
                        acc.stats()["ici"]["bytes_total"], len(calls)))
    (got, nb, n), (want, nb_ref, n_ref) = results
    assert got.dtype == t.dtype and tuple(got.shape) == arr.shape
    assert port.tensor_bytes(got) == np.asarray(want).tobytes()
    assert nb == nb_ref == arr.nbytes and n == n_ref == -(-arr.nbytes // 5000)


def test_pull_stream_refuses_bad_frames():
    table = port.StreamOfferTable(64)
    desc = table.offer("r", b"\x01" * 100, [100], "uint8")
    post, _ = _table_post(table)
    for mod in (port, ref):
        with pytest.raises(ValueError, match="checksum"):
            mod.pull_stream("p:1", dict(desc, checksum="0" * 16), post=post)
        with pytest.raises(ValueError, match="expired or unknown"):
            mod.pull_stream("p:1", dict(desc, stream_uuid=1), post=post)
    with pytest.raises(ValueError):
        port.tensor_from_bytes(b"\x00" * 6, [2], "float32")
    with pytest.raises(ValueError):
        port.wire_dtype("complex_thing")


@pytest.fixture
def stream_server():
    """A loopback /rpc/kv_stream_pull over a port StreamOfferTable, framed
    by the port's codec."""
    table = port.StreamOfferTable(1 << 12)

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            req = msgpack_lite.unpackb(self.rfile.read(
                int(self.headers["Content-Length"])))
            frame = table.read_chunk(req["uuid"], req["offset"],
                                     req["max_bytes"])
            status, body = (200, msgpack_lite.packb(frame)) if frame else \
                (404, json.dumps({"error": "unknown"}).encode())
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield table, f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_default_transports_over_http(stream_server):
    """The port's pull (http.client + the codec) and the reference's
    (requests + msgpack) read the same payload from the port's frames."""
    table, addr = stream_server
    x = np.arange(3000, dtype=np.float32).reshape(3, 1000)
    desc = table.offer("h", x.tobytes(), [3, 1000], "float32")
    got = port.pull_stream(addr, desc)
    want = ref.pull_stream(addr, desc)
    assert np.array_equal(got.numpy(), x) and np.array_equal(want, x)
    with pytest.raises(ValueError):
        port.pull_stream(addr, dict(desc, stream_uuid=7))


def test_ipc_handle_keeps_every_byte():
    """The 64 opaque bytes of a handle round-trip whole, NULs included."""
    raw = bytes([0, 7, 0, 0, 255] * 12 + [0, 1, 0, 2])
    assert port._IpcHandle.from_bytes(raw).to_bytes() == raw
    with pytest.raises(ValueError):
        port._IpcHandle.from_bytes(raw[:63])


def test_manager_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        port.KvTransferManager.create("cpu")


# ----------------------------------------------------------------- the card
_PEER = textwrap.dedent("""
    import json, sys, torch
    from xllm_service_tpu_torch.engine.kv_transfer import KvTransferManager
    from xllm_service_tpu_torch.rpc import msgpack_lite
    mgr = KvTransferManager.create("cuda")
    for line in sys.stdin:
        desc = msgpack_lite.unpackb(bytes.fromhex(line.strip()))
        out = mgr.pull(desc)
        print(json.dumps({"sum": float(out.float().sum()),
                          "first": float(out.reshape(-1)[0].float()),
                          "dtype": str(out.dtype), "shape": list(out.shape),
                          **mgr.last_pull}), flush=True)
""")


@pytest.mark.cuda
def test_cuda_ipc_between_two_processes():
    """Offer buffers here (one carved out of a larger block of the caching
    allocator, at an offset), pull them in a second process on the same
    card: bytes, dtype and shape arrive; a release frees the offer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA IPC between two processes "
                    "on one card)")
    mgr = port.KvTransferManager.create("cuda")
    peer = subprocess.Popen([sys.executable, "-c", _PEER], cwd=ROOT,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        big = torch.randn(4 << 20, device="cuda")
        for i, blob in enumerate((
                torch.randn(2, 2, 3, 2, 16, 64, device="cuda"),
                big[1 << 20:].view(-1, 2, 16, 128).to(torch.bfloat16),
                big[(1 << 20) + 4096:(2 << 20)].view(2, 2, -1, 8, 16, 8))):
            blob = blob.contiguous()
            ready = torch.cuda.Event()
            ready.record()
            desc = mgr.offer(f"r{i}", blob, ready=ready)
            assert desc["addr"] == mgr.address and len(mgr._pending) == 1
            peer.stdin.write(msgpack_lite.packb(desc).hex() + "\n")
            peer.stdin.flush()
            got = json.loads(peer.stdout.readline())
            mgr.release(desc["uuid"])
            assert not mgr._pending
            assert got["shape"] == list(blob.shape)
            assert got["dtype"] == str(blob.dtype)
            assert got["first"] == float(blob.reshape(-1)[0].float())
            assert abs(got["sum"] - float(blob.float().sum())) <= 1e-3 * (
                1 + abs(float(blob.float().sum())))
    finally:
        peer.stdin.close()
        peer.wait(timeout=60)


def test_pd_handoff_bench_twin_on_the_cpu():
    """The twin's host paths run here (tiny f32 blob, no device path);
    without a card and without ``--device cpu`` it raises."""
    from xllm_service_tpu_torch.benchmarks import pd_handoff_bench

    rec = pd_handoff_bench.run("cpu")
    row = rec["ctx_256"]
    assert rec["backend"] == "cpu" and "device_ms" not in row
    assert row["stream_ms"] > 0 and row["inline_ms"] > 0
    assert rec["value"] == row["inline_ms"]
    out = subprocess.run(
        [sys.executable, "-m", "xllm_service_tpu_torch.benchmarks."
         "pd_handoff_bench"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                          "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "device='cpu'" in out.stderr
