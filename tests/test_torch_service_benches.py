"""The port's service-plane bench twins against the reference's benches,
on the CPU.

``xllm_service_tpu_torch/benchmarks/`` twins ``benchmarks/``'s
``master_hotpath_bench``, ``kvcache_routing_bench``,
``generations_bench``, ``bench_tracing_overhead`` and
``bench_profile_overhead`` (``fleet_bench`` is held in
``test_torch_fleet_bench.py``, ``overload_bench`` and ``outage_bench`` in
``test_torch_plane_benches.py``). Held here:

- the pure pieces give equal results: ``_due_offsets`` for the same seed
  and arguments; ``make_workload``, and the matched blocks of both
  ``LegacyKVCacheIndex`` copies and of both shipped indexes on that
  workload; the generations bench's msgpack frames byte for byte against
  ``msgpack.packb``;
- each twin, run as ``python -m`` at a tiny size against the port's
  master, coordination server and fake engine, writes the reference's
  report keys, meets the reference's gate where it has one, counts the
  same requests and errors as the reference run at the same size (never
  times), and leaves no process behind;
- the HTTP client on ``http.client``: one kept-alive connection a
  worker, given back only once a stream has been read to its end, and
  closed when the reader stops early (the server sees the client go).

The reference's in-process benches have no size flags: they run here at
a small size by substituting their round counts in the source text, in a
process of their own; the files are not edited.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import msgpack
import pytest
import torch

from benchmarks import kvcache_routing_bench as ref_kv
from benchmarks import master_hotpath_bench as ref_hot
from xllm_service_tpu_torch.benchmarks import bench_profile_overhead
from xllm_service_tpu_torch.benchmarks import generations_bench
from xllm_service_tpu_torch.benchmarks import kvcache_routing_bench as kv
from xllm_service_tpu_torch.benchmarks import master_hotpath_bench as hot
from xllm_service_tpu_torch.benchmarks import stack
from xllm_service_tpu_torch.rpc import msgpack_lite

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ROOT = Path(__file__).resolve().parents[1]
TWINS = "xllm_service_tpu_torch.benchmarks."


def env_for(logdir: Path) -> dict:
    """A bench's environment: one OpenMP thread, the checkout importable,
    its children's logs (and the marker of its descendants) in
    ``logdir``."""
    return {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": str(ROOT), "XLLM_BENCH_LOGDIR": str(logdir)}


def launch_twin(name, *argv, logdir: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", TWINS + name, *argv],
                            cwd=ROOT, env=env_for(logdir),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def launch_reference(name, *argv, logdir: Path,
                     patch=()) -> subprocess.Popen:
    """``benchmarks/<name>.py`` in a process of its own; ``patch`` is a
    list of (text, replacement) applied to its source first."""
    path = str(ROOT / "benchmarks" / f"{name}.py")
    code = ("import sys\n"
            f"p = {path!r}\n"
            "src = open(p).read()\n"
            f"for a, b in {list(patch)!r}:\n"
            "    assert a in src, a\n"
            "    src = src.replace(a, b)\n"
            f"sys.argv = [p, *{list(argv)!r}]\n"
            "exec(compile(src, p, 'exec'), {'__name__': '__main__', "
            "'__file__': p})\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env=env_for(logdir), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(p: subprocess.Popen, timeout: float = 120) -> str:
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, err[-3000:]
    return out


def run_twin(name, *argv, logdir: Path, timeout=120) -> str:
    """The twin's standard output; it must leave no process behind."""
    try:
        out = finish(launch_twin(name, *argv, logdir=logdir), timeout)
        assert_reaped(logdir)
        return out
    finally:
        kill_all(logdir)


def both(name, twin_argv, ref_argv, tmp_path, patch=(), timeout=120,
         side_by_side=False):
    """The twin and the reference bench; returns their standard outputs.
    Benches whose stacks pick free ports run one after the other (two
    picking at once could pick the same port); ``side_by_side`` is for
    the in-process ones, whose servers bind port 0."""
    tdir, rdir = tmp_path / "twin", tmp_path / "ref"
    tdir.mkdir()
    rdir.mkdir()
    ref = None
    try:
        if side_by_side:
            ref = launch_reference(name, *ref_argv, logdir=rdir,
                                   patch=patch)
        t_out = run_twin(name, *twin_argv, logdir=tdir, timeout=timeout)
        if ref is None:
            ref = launch_reference(name, *ref_argv, logdir=rdir,
                                   patch=patch)
        r_out = finish(ref, timeout)
    finally:
        if ref is not None and ref.poll() is None:
            ref.kill()
            ref.communicate()
        # The reference spawns its stack before its leg's try: a stack
        # that fails to start stays up.
        kill_all(rdir)
    return t_out, r_out


def kill_all(logdir: Path) -> None:
    for pid in descendants(logdir):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def descendants(logdir: Path) -> list:
    """The processes whose environment names ``logdir``: every
    descendant of the bench run with it."""
    marker = f"XLLM_BENCH_LOGDIR={logdir}".encode()
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker in f.read().split(b"\0"):
                    found.append(int(pid))
        except OSError:
            pass
    return found


def assert_reaped(logdir: Path) -> None:
    deadline = time.monotonic() + 5
    while descendants(logdir) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = descendants(logdir)
    assert not left, f"processes left behind: {left}"


def json_lines(out: str) -> list:
    rows = []
    for line in out.splitlines():
        if line.startswith("BENCH_DOC "):
            rows.append(("BENCH_DOC", json.loads(line[len("BENCH_DOC "):])))
        elif line.startswith("{"):
            rows.append(json.loads(line))
    return rows


def shape(obj, skip=()):
    """The key structure of a report: nested dicts' keys (lists by their
    first element), with the subtrees named in ``skip`` left out."""
    if isinstance(obj, dict):
        return {k: (None if k in skip else shape(v, skip))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [shape(obj[0], skip)] if obj and isinstance(
            obj[0], (dict, list)) else []
    return None


# ------------------------------------------------------------ pure pieces
@pytest.mark.parametrize("traffic,kw", [
    ("steady", dict(rps=7.0)),
    ("steady", dict(rps=0.0)),
    ("diurnal", dict(rps=25.0, diurnal_amp=0.6, diurnal_period=3.0)),
    ("diurnal", dict(rps=9.0, diurnal_amp=2.0, diurnal_period=0.5)),
    ("burst", dict(rps=12.0, burst_every=2.0, burst_len=0.5,
                   burst_mult=4.0)),
    ("burst", dict(rps=5.0, burst_every=0.2, burst_len=9.0,
                   burst_mult=0.5)),
])
def test_due_offsets_equal(traffic, kw):
    args = argparse.Namespace(traffic=traffic, **kw)
    want = ref_hot._due_offsets(300, args)
    got = hot._due_offsets(300, args)
    assert len(got) == 300 and got == want


def test_kvcache_workload_and_matches_equal():
    want = ref_kv.make_workload(3, 700, 24, 4, seed=5)
    got = kv.make_workload(3, 700, 24, 4, seed=5)
    assert got == want
    instances, per_keys, prompts, prompt_hashes, flags = got
    assert sum(flags) == 18 and all(
        len(per_keys[n]) >= 700 for n in instances)

    ref_new, ref_legacy, ref_coord, ref_store = _ref_build(instances,
                                                           per_keys)
    new, legacy, n_keys, _, _, coord, store = kv.build_indexes(
        instances, per_keys)
    try:
        assert new.num_blocks() == ref_new.num_blocks()

        def scores(o):
            return (o.scores, o.max_block_num, o.matched_blocks)
        for toks, chain, hit in zip(prompts, prompt_hashes, flags):
            legacy_scores = legacy.match(toks)
            assert legacy_scores == ref_legacy.match(toks)
            assert bool(legacy_scores) == hit
            a = scores(new.match(block_hashes=chain))
            assert a == scores(ref_new.match(block_hashes=chain))
            assert a == scores(new.match(toks))
            assert a == scores(ref_new.match(toks))
            assert a[0] == legacy_scores
        victim = instances[0]
        new.remove_instance(victim)
        ref_new.remove_instance(victim)
        legacy.remove_instance(victim)
        ref_legacy.remove_instance(victim)
        for toks, chain in zip(prompts, prompt_hashes):
            assert scores(new.match(block_hashes=chain)) == \
                scores(ref_new.match(block_hashes=chain))
            assert legacy.match(toks) == ref_legacy.match(toks)
        assert kv.legacy_prefix_block_hash_hexes(prompts[0]) == \
            ref_kv.legacy_prefix_block_hash_hexes(prompts[0])
    finally:
        for c in (coord, ref_coord):
            c.close()
        store.close()
        ref_store.close()


def _ref_build(instances, per_keys):
    """The reference's two indexes filled as its ``run_index_bench``
    fills them."""
    from xllm_service_tpu.common.types import KvCacheEvent
    from xllm_service_tpu.coordination.memory import (
        InMemoryCoordination,
        MemoryStore,
    )
    from xllm_service_tpu.scheduler.global_kvcache_mgr import (
        GlobalKVCacheMgr,
    )

    store = MemoryStore()
    coord = InMemoryCoordination(store)
    new = GlobalKVCacheMgr(coord, block_size=ref_kv.BLOCK, is_master=True)
    legacy = ref_kv.LegacyKVCacheIndex(ref_kv.BLOCK)
    for name in instances:
        keys = per_keys[name]
        for i in range(0, len(keys), 10_000):
            batch = keys[i:i + 10_000]
            new.record_updated_kvcaches(name, KvCacheEvent(stored=batch))
            legacy.record_updated_kvcaches(name, [b.hex() for b in batch])
    return new, legacy, coord, store


def test_generations_frames_equal_msgpack():
    sids = [f"bench-{i:08x}" for i in range(generations_bench.N_REQ)]
    seq = {sid: 0 for sid in sids}
    for r in range(5):
        body = generations_bench.generations_payload(sids, seq, r)
        assert len(body["gens"]) == generations_bench.BATCH
        assert msgpack_lite.packb(body) == msgpack.packb(
            body, use_bin_type=True)
    assert max(seq.values()) == 3
    # The rest of the wire's value kinds, as msgpack frames them.
    odd = {"b": b"\x00\xff" * 40, "f": 0.1, "neg": [-1, -33, -200, -70000,
           -(1 << 40)], "big": [127, 128, 255, 256, 65536, 1 << 33],
           "none": None, "t": True, "s": "é" * 40, "l": list(range(20))}
    assert msgpack_lite.packb(odd) == msgpack.packb(odd, use_bin_type=True)


def test_profile_gate_rule():
    doc = {"overall_p50_delta_pct": 3.0,
           "headline": {"profile_overhead_pct": 0.4}}
    assert bench_profile_overhead.passes(doc, 1.0)
    doc["headline"]["profile_overhead_pct"] = 1.5
    assert not bench_profile_overhead.passes(doc, 1.0)
    assert bench_profile_overhead.passes(doc, 1.5)


# ------------------------------------------------------------ the client
class _SSE:
    """A one-thread SSE server on the standard library: ``/done`` streams
    frames then ``[DONE]``, ``/slow`` streams until its client goes."""

    def __init__(self):
        import http.server

        self.gone = threading.Event()
        self.conns = 0
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                outer.conns += 1

            def log_message(self, *a):
                pass

            def _chunk(self, data: bytes):
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

            def do_POST(self):
                self.rfile.read(int(self.headers["Content-Length"]))
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                if self.path == "/done":
                    for i in range(3):
                        self._chunk(b"data: {\"i\": %d}\n\n" % i)
                    self._chunk(b"data: [DONE]\n\n")
                    self.wfile.write(b"0\r\n\r\n")
                    return
                try:
                    for i in range(400):
                        self._chunk(b"data: {\"i\": %d}\n\n" % i)
                        time.sleep(0.01)
                except OSError:
                    outer.gone.set()
                    self.close_connection = True
                    return
                self.wfile.write(b"0\r\n\r\n")

        self.srv = http.server.HTTPServer(("127.0.0.1", 0), H)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_session_keeps_one_connection_and_drops_a_broken_stream():
    srv = _SSE()
    s = stack.Session()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        for _ in range(3):
            r = s.post(url + "/done", json={"x": 1}, stream=True)
            assert r.status_code == 200
            t0 = time.perf_counter()
            ttft, done = hot.read_stream(r, t0)
            assert done and ttft is not None
        assert srv.conns == 1          # kept alive across streams
        lines = []
        r = s.post(url + "/done", json={}, stream=True)
        for line in r.iter_lines():
            lines.append(line)
        assert lines == [b'data: {"i": 0}', b"", b'data: {"i": 1}', b"",
                         b'data: {"i": 2}', b"", b"data: [DONE]"]
        assert srv.conns == 1
        # A reader that stops early closes its connection: the server's
        # next write fails.
        r = s.post(url + "/slow", json={}, stream=True)
        for n, line in enumerate(r.iter_lines()):
            if n >= 4:
                break
        r.close()
        assert srv.gone.wait(5)
        r = s.post(url + "/done", json={}, stream=True)
        assert hot.read_stream(r, time.perf_counter())[1]
        assert srv.conns == 2          # a fresh connection after the drop
    finally:
        s.close()
        srv.close()


# ------------------------------------------------------------- the twins
HOT_SKIP = ("telemetry", "ownership", "cpu_s_during_drive")


def test_master_hotpath_twin_against_reference(tmp_path):
    argv = ["--requests", "24", "--concurrency", "3",
            "--prompt-chars", "256", "--max-tokens", "8"]
    t_out, r_out = both("master_hotpath_bench", argv, argv, tmp_path)
    got, want = json.loads(t_out), json.loads(r_out)
    assert hot.gate(got) == [] and hot.gate(want) == []
    assert shape(got, HOT_SKIP) == shape(want, HOT_SKIP)
    for k in ("requests", "masters", "concurrency", "prompt_chars",
              "max_tokens", "offered_rps", "errors", "policy",
              "n_engines", "telemetry_mode", "traffic"):
        assert got[k] == want[k], k
    assert got["master_stages_ms"]["schedule"]["n"] == \
        want["master_stages_ms"]["schedule"]["n"]


def test_master_hotpath_twin_quick_paced_and_two_masters(tmp_path):
    """``--quick`` with a paced diurnal schedule over two frontends and a
    small heartbeat storm: every request served, the report's multi-
    master and storm sections."""
    report = json.loads(run_twin(
        "master_hotpath_bench", "--quick", "--masters", "2", "--rps", "60",
        "--traffic", "diurnal", "--heartbeat-storm", "6", "--storm-hz", "4",
        logdir=tmp_path))
    assert hot.gate(report) == []
    assert report["requests"] == hot.QUICK["requests"]
    assert report["masters"] == 2 and len(report["ownership_per_master"]) \
        == 2
    assert report["heartbeat_storm"]["instances"] == 6
    assert report["heartbeat_storm"]["beats_sent"] > 0
    assert {r["engine"] for r in report["engine_telemetry"]}
    assert set(report["master_cpu_attribution"]) == {"master0", "master1"}


def test_kvcache_routing_twin_against_reference(tmp_path):
    """The twin's ``--quick`` run, and the reference's index and hashing
    legs at the same sizes: the same keys, the same workload counts."""
    got = json.loads(run_twin("kvcache_routing_bench", "--quick",
                              logdir=tmp_path))
    q = kv.QUICK
    want = {
        "index": ref_kv.run_index_bench(q["instances"], q["blocks"],
                                        q["prompts"], 32, 4, q["rounds"]),
        "hashing": ref_kv.run_hashing_bench(iters=q["hash_iters"],
                                            rounds=q["hash_rounds"]),
    }
    assert shape(got) == shape(want)
    g_cfg, w_cfg = got["index"]["config"], want["index"]["config"]
    assert {k: v for k, v in g_cfg.items() if k != "native_hash"} == \
        {k: v for k, v in w_cfg.items() if k != "native_hash"}
    assert g_cfg["total_keys_ingested"] == q["instances"] * q["blocks"]
    assert got["hashing"]["prompt_tokens"] == \
        want["hashing"]["prompt_tokens"]
    # libblockhash from the port's csrc/blockhash.c where a C compiler
    # is (this machine has one).
    assert got["hashing"]["native_hash"] is True


def test_generations_twin_against_reference(tmp_path):
    t_out, r_out = both(
        "generations_bench", [], [], tmp_path, side_by_side=True)
    got, want = json_lines(t_out), json_lines(r_out)
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    assert [g.get("mode") for g in got] == ["json", "msgpack", None]
    assert got[-1]["metric"] == want[-1]["metric"]
    assert got[-1]["value"] > 0 and all(
        g["deltas_per_s"] > 0 for g in got)


TRACING_PATCH = [("ROUNDS, PER_ROUND = 12, 40", "ROUNDS, PER_ROUND = 2, 20")]


def test_tracing_overhead_twin_against_reference(tmp_path):
    t_out, r_out = both(
        "bench_tracing_overhead", ["--quick"], [], tmp_path,
        patch=TRACING_PATCH, side_by_side=True)
    got, want = json_lines(t_out), json_lines(r_out)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            assert shape(g[1]) == shape(w[1])
            assert [m["n"] for m in g[1]["modes"].values()] == \
                [m["n"] for m in w[1]["modes"].values()] == [40] * 4
        else:
            assert sorted(g) == sorted(w)
    assert got[0]["disabled_span_call_ns"] > 0


PROFILE_PATCH = [("ROUNDS, PER_ROUND = 16, 40", "ROUNDS, PER_ROUND = 2, 20")]


def test_profile_overhead_twin_against_reference(tmp_path):
    # The exit gate is a timing: not held here (PROFILE_GATE_PCT lifted
    # for both); the rule itself is test_profile_gate_rule's.
    os.environ["PROFILE_GATE_PCT"] = "1e9"
    try:
        t_out, r_out = both(
            "bench_profile_overhead", ["--quick"], [], tmp_path,
            patch=PROFILE_PATCH, side_by_side=True)
    finally:
        del os.environ["PROFILE_GATE_PCT"]
    got, want = json_lines(t_out), json_lines(r_out)
    skip = ("profile_role_samples", "profile_top_frames", "cpu_attr",
            "composition")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            assert shape(g[1], skip) == shape(w[1], skip)
            assert set(g[1]["composition"]) == set(w[1]["composition"])
            assert [m["n"] for m in g[1]["modes"].values()] == \
                [m["n"] for m in w[1]["modes"].values()] == [40] * 2
        elif "composition" in g:
            assert g["composition"]     # the loaded run's roles
        else:
            assert sorted(g) == sorted(w)
    assert t_out.splitlines()[-1].startswith("OK: profiler overhead")
    assert r_out.splitlines()[-1].startswith("OK: profiler overhead")
