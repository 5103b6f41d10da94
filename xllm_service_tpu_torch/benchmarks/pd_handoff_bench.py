"""PD KV-handoff latency of the port (twin of the repository's
``benchmarks/pd_handoff_bench.py``): one handoff on each path.

    python -m xllm_service_tpu_torch.benchmarks.pd_handoff_bench
    python -m xllm_service_tpu_torch.benchmarks.pd_handoff_bench --device cpu

The reference's shapes and method: a KV blob ``[L, 2, n_pages, n_kv, ps,
hd]`` at ``bench_1b_config``'s KV shapes (16 layers, 8 KV heads, page 16,
head 128, bf16) for contexts of 2048 and 8192 tokens on the card (2
layers, 2 heads, head 32, f32, 256 tokens with ``--device cpu``), timed
per handoff from the blob in device memory to the blob in the receiver's
device memory, best of five (device) or three (host):

- **device**: offer + pull + release over CUDA IPC
  (``engine/kv_transfer.py::KvTransferManager``), the pull in a second
  process on the same card that this twin spawns (a handle cannot be
  opened in the process that exported it); the time includes handing the
  descriptor over a pipe and the reply, and the puller's split of its pull
  (opening the handle, the copy) is reported beside it. Only on a card.
- **stream**: download, offer, the handoff POST with the stream
  descriptor, the receiver's chunked pulls (1 MiB frames) and its upload,
  over loopback HTTP;
- **inline**: download, ``pack_handoff``, the POST, ``unpack_handoff``
  and the upload, over loopback HTTP.

Prints one JSON line, with the card's name and power limit in it on a
card. Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import http.client
import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Union

import torch

from ..common.device import card_line, resolve_device
from ..common.request import SamplingParams
from ..engine.agent import pack_handoff, unpack_handoff
from ..engine.engine import PrefillHandoff
from ..engine.kv_transfer import (
    KvTransferManager,
    StreamOfferTable,
    dtype_name,
    pull_stream,
    tensor_bytes,
)
from ..rpc import msgpack_lite

ROOT = Path(__file__).resolve().parents[2]


class _Receiver:
    """A loopback decode side: ``/rpc/kv_transfer`` takes a handoff
    (inline, or a stream descriptor it pulls back from this server's
    ``/rpc/kv_stream_pull``) and uploads the blob to the device."""

    def __init__(self, dev: torch.device):
        self.offers = StreamOfferTable(1 << 20)
        rx = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if self.path == "/rpc/kv_stream_pull":
                    req = msgpack_lite.unpackb(body)
                    out = msgpack_lite.packb(rx.offers.read_chunk(
                        req["uuid"], req["offset"], req["max_bytes"]))
                else:
                    obj = unpack_handoff(body)
                    blob = obj.get("kv_blob")
                    if blob is None:
                        blob = pull_stream(rx.addr, obj["kv_stream"])
                    blob.to(dev)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    out = b"{}"
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def post(self, payload: bytes) -> None:
        host, _, port = self.addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=300)
        try:
            conn.request("POST", "/rpc/kv_transfer", body=payload,
                         headers={"Content-Type": msgpack_lite.CONTENT_TYPE})
            r = conn.getresponse()
            r.read()
        finally:
            conn.close()
        assert r.status == 200, r.status

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class _Puller:
    """The device path's second process: pulls each descriptor written to
    its stdin and answers with its split (and, when asked, a checksum of
    the bytes)."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--puller"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        ready = self.proc.stdout.readline()
        if not ready.startswith("ready"):
            self.close()
            raise RuntimeError(f"puller did not start: {ready!r}")

    def pull(self, desc: dict, check: bool = False) -> dict:
        self.proc.stdin.write(("c" if check else "p")
                              + msgpack_lite.packb(desc).hex() + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the puller exited (its error is above)")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.stdin:
            self.proc.stdin.close()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _checksum(t: torch.Tensor) -> int:
    """The sum of the buffer's 32-bit words (bytes where they do not
    divide), accumulated in int64 on its device."""
    flat = t.reshape(-1).view(torch.uint8)
    if flat.numel() % 4 == 0:
        flat = flat.view(torch.int32)
    return int(flat.sum(dtype=torch.int64))


def _puller_main() -> None:
    mgr = KvTransferManager.create("cuda")
    print("ready", flush=True)
    for line in sys.stdin:
        out = mgr.pull(msgpack_lite.unpackb(bytes.fromhex(line[1:].strip())))
        rec = dict(mgr.last_pull)
        if line[0] == "c":
            rec["checksum"] = _checksum(out)
        del out
        print(json.dumps(rec), flush=True)


def run(device: Optional[Union[str, torch.device]] = None) -> dict:
    """Time each path on ``device``; returns the JSON record."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    L, n_kv, ps, hd = (16, 8, 16, 128) if on_card else (2, 2, 16, 32)
    dtype = torch.bfloat16 if on_card else torch.float32
    ctxs = (2048, 8192) if on_card else (256,)
    result: dict = {"metric": "pd_handoff_ms_per_transfer", "unit": "ms",
                    "backend": dev.type, "dtype": dtype_name(dtype),
                    "kv_shape": [L, 2, "n_pages", n_kv, ps, hd]}
    if on_card:
        result["device"] = torch.cuda.get_device_name(dev)
        result["card"] = card_line()
    rx = _Receiver(dev)
    mgr = KvTransferManager.create(dev) if on_card else None
    puller = _Puller() if on_card else None
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        for ctx in ctxs:
            blob = torch.randn((L, 2, ctx // ps, n_kv, ps, hd), device=dev,
                               generator=gen).to(dtype)
            nbytes = blob.numel() * blob.element_size()
            row: dict = {"ctx": ctx, "blob_mb": nbytes / 1e6}
            if mgr is not None:
                ready = torch.cuda.Event()
                ready.record()
                times, splits = [], []
                for i in range(5):
                    t0 = time.perf_counter()
                    desc = mgr.offer(f"bench-{ctx}-{i}", blob, ready=ready)
                    split = puller.pull(desc, check=i == 4)
                    mgr.release(desc["uuid"])
                    times.append(time.perf_counter() - t0)
                    splits.append(split)
                assert splits[-1]["checksum"] == _checksum(blob), \
                    "the pulled bytes differ from the offered ones"
                best = min(range(5), key=times.__getitem__)
                row["device_ms"] = times[best] * 1e3
                row["device_open_ms"] = splits[best]["open_ms"]
                row["device_copy_ms"] = splits[best]["copy_ms"]
                row["device_gbps"] = nbytes / 1e9 / times[best]
            h = PrefillHandoff(
                service_request_id=f"bench-{ctx}", request_id="r0",
                token_ids=list(range(ctx)), first_token=1,
                first_logprob=None, sampling=SamplingParams(max_tokens=16),
                kv_blob=blob)
            for path in ("stream", "inline"):
                times = []
                for i in range(3):
                    t0 = time.perf_counter()
                    host = blob.cpu()
                    if path == "stream":
                        sid = f"bench-{ctx}-{i}"
                        desc = rx.offers.offer(
                            sid, tensor_bytes(host), list(host.shape),
                            dtype_name(host.dtype),
                            block_bytes=nbytes // host.shape[2])
                        rx.post(pack_handoff(h, "127.0.0.1:0",
                                             kv_stream=desc))
                        rx.offers.release(desc["stream_uuid"])
                    else:
                        h.kv_blob = host
                        rx.post(pack_handoff(h, "127.0.0.1:0"))
                        h.kv_blob = blob
                    times.append(time.perf_counter() - t0)
                row[f"{path}_ms"] = min(times) * 1e3
                row[f"{path}_gbps"] = nbytes / 1e9 / min(times)
            if "device_ms" in row:
                row["device_speedup_vs_inline"] = (row["inline_ms"]
                                                   / row["device_ms"])
            result[f"ctx_{ctx}"] = row
            del blob
    finally:
        if puller is not None:
            puller.close()
        rx.close()
    last = result[f"ctx_{ctxs[-1]}"]
    result["value"] = last.get("device_ms", last["inline_ms"])
    return result


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--puller", action="store_true",
                    help="run as the device path's pulling process")
    args = ap.parse_args(argv)
    if args.puller:
        _puller_main()
        return
    print(json.dumps(run(args.device)))


if __name__ == "__main__":
    main()
