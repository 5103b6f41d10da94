"""One engine instance over processes: the port's ranks (processes joined
in a gloo group over 127.0.0.1, each holding only its mesh coordinates'
shards, driven in lockstep by ``engine/multihost_driver.py``) against the
reference engine on the same mesh (the virtual CPU devices of
tests/conftest.py) and against the port's one-process engine on that
mesh, on the same f32 weights: the reference's ``init_params`` with norm
scales and biases drawn non-zero, handed to every rank as an ``.npz`` and
cut there by ``params_from_jax``.

Three cases, each serving two greedy requests (a 35-token prompt and a
37-token one sharing its first 32: a prefix hit) and one seeded sampled
request, six tokens each:

- tiny llama on ``model=2`` as two ranks (also: ``broadcast_bytes`` with
  an empty and a 3 MiB payload, the KV tiers asked for and turned off
  with the reference's warning, and a step that fails on every rank: the
  primary's request fails, the ranks keep ticking and serve the next);
- tiny mixtral on ``expert=2 x model=2`` as four ranks;
- tiny llama on ``seq=2`` as two ranks, plus a 100-token prompt that
  takes the ring.

Greedy tokens are identical to the reference's and to the one-process
engine's; the seeded sampled stream is identical to the one-process
engine's (the reference draws from another generator, so its sampled
stream is another one); every follower emits what the primary emits;
each rank's pool shard after the greedy requests equals the one-process
engine's shard bit for bit and is within 1e-5 of the reference pool's
shard, the garbage page 0 excluded. The driver's and the proxy's refusals are the reference's, and
``--dp-size 2`` over two processes is an error.

This file is also the rank worker: ``python tests/test_torch_multihost.py
SPEC RANK WORLD PORT OUT`` (no JAX there).
"""

import json
import logging
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=512,
                 seq_parallel_min_tokens=64)
A = list(range(40, 75))
B = list(range(40, 72)) + [7, 9, 11, 13, 15]
LONG = [(i * 11 + 5) % 300 + 10 for i in range(100)]
SAMPLED = [(i * 7 + 3) % 200 + 20 for i in range(20)]
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
SEEDED = dict(max_tokens=6, temperature=0.9, top_k=50, seed=7,
              ignore_eos=True)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {
    "model2": dict(family="llama", axes=dict(model=2),
                   requests=[("a", A, GREEDY), ("b", B, GREEDY),
                             ("s", SAMPLED, SEEDED)], drill=True),
    "expert2_model2": dict(family="mixtral", axes=dict(expert=2, model=2),
                           requests=[("a", A, GREEDY), ("b", B, GREEDY),
                                     ("s", SAMPLED, SEEDED)]),
    # 16 pages, so that the requests' pages lie on both seq shards.
    "seq2": dict(family="llama", axes=dict(seq=2), engine=dict(num_pages=16),
                 requests=[("a", A, GREEDY), ("b", B, GREEDY),
                           ("long", LONG, GREEDY), ("s", SAMPLED, SEEDED)]),
}
BIG = bytes(np.random.default_rng(3).integers(0, 256, 3 << 20,
                                              dtype=np.uint8))
# A bound on a rank's whole run (about 10 s alone), against a hang.
RANK_TIMEOUT_S = 240


# ------------------------------------------------------------ rank worker
class Collector:
    def __init__(self):
        self.tokens = []
        self.status = None
        self.done = threading.Event()

    def __call__(self, out) -> None:
        for s in out.outputs:
            self.tokens.extend(s.token_ids)
        if out.finished:
            self.status = out.status.message if out.status else ""
            self.done.set()


def _nest(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def rank_main(spec_path, rank, world, port, out_path):
    """One rank: join the group, cut the weights, build the engine on the
    mesh over the ranks and serve the case's requests through the driver
    (the primary submits them one after another; followers run the
    lockstep loop). Writes what it saw to ``out_path``."""
    torch.set_num_threads(1)
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )
    from xllm_service_tpu_torch.engine import multihost_driver as md
    from xllm_service_tpu_torch.models.base import get_model_family
    from xllm_service_tpu_torch.models.weights import params_from_jax
    from xllm_service_tpu_torch.parallel import multihost
    from xllm_service_tpu_torch.parallel.mesh import (
        MeshConfig,
        mesh_from_config,
    )

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, timeout_s=60)
    out = {"rank": rank}
    if spec.get("drill"):
        got = [multihost.broadcast_bytes(p if rank == 0 else None)
               for p in (b"", BIG, b"abc")]
        out["bcast"] = [len(g) for g in got]
        out["bcast_big_ok"] = got[1] == BIG
    warnings = []

    class Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    logging.getLogger("xllm_service_tpu_torch.engine.engine").addHandler(
        Catch(logging.WARNING))
    axes = spec["axes"]
    mesh = mesh_from_config(MeshConfig(**axes), torch.device("cpu"))
    fam = get_model_family(spec["family"])
    tree = _nest(dict(np.load(spec["npz"])))
    sharded = axes.get("model", 1) * axes.get("expert", 1) > 1
    params = (params_from_jax(tree, "cpu", mesh, fam.sharding_rules)
              if sharded else params_from_jax(tree, "cpu"))
    kw = {**ENGINE_KW, **spec.get("engine", {})}
    if spec.get("drill"):
        kw["kv_tier_dram_bytes"] = 1 << 20
    eng = InferenceEngine(EngineConfig(model=spec["cfg"],
                                       model_family=spec["family"], **kw),
                          device="cpu", params=params, mesh=mesh)
    out["tier_store"] = eng.tier_store is not None
    out["warnings"] = warnings
    out["local_shards"] = (params.coords if sharded else None)
    drv = md.MultihostEngineDriver(eng)
    streams = {}

    last_greedy = [sid for sid, _, sp in spec["requests"]
                   if not sp.get("temperature")][-1]
    snap = []

    def snapshot():
        pool = eng.kv_pages
        snap.extend(s.clone() for s in
                    (pool.shards if hasattr(pool, "shards") else [pool]))

    def follower_sink(o):
        streams.setdefault(o.service_request_id, []).extend(
            t for s in o.outputs for t in s.token_ids)
        if o.finished and o.service_request_id == last_greedy:
            snapshot()

    md._drop = follower_sink
    if spec.get("drill"):
        admit = InferenceEngine._admit

        def failing_admit(self):
            if any(r.service_request_id == "boom" for r in self._waiting):
                raise RuntimeError("injected step failure")
            return admit(self)

        InferenceEngine._admit = failing_admit
    requests = list(spec["requests"])
    if spec.get("drill"):
        requests += [("boom", A, GREEDY), ("after", B, GREEDY)]
    if rank == 0:
        statuses = {}
        for sid, prompt, sampling in requests:
            col = Collector()
            drv.submit(EngineRequest(sid, token_ids=list(prompt),
                                     sampling=SamplingParams(**sampling),
                                     on_output=col))
            for _ in range(400):
                if col.done.is_set():
                    break
                drv.tick()
            assert col.done.is_set(), f"{sid} did not finish"
            if sid == last_greedy:
                snapshot()
            streams[sid] = col.tokens
            statuses[sid] = col.status
        out["statuses"] = statuses
        drv.shutdown()
        while drv.tick():
            pass
    else:
        drv.follower_loop()
    out["tokens"] = streams
    out["stats"] = {**eng.stats(), "ring_prefills": eng.ring_prefills}
    out["backend"] = multihost.backend()
    out["pool_index"] = list(getattr(eng.kv_pages, "index", [0]))
    np.savez(out_path + ".npz", *[s.numpy() for s in snap])
    eng.stop()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


# ------------------------------------------------------------- test side
def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _configs():
    import jax.numpy as jnp

    from xllm_service_tpu.models import mixtral as ref_mixtral
    from xllm_service_tpu.models.base import tiny_config as ref_tiny

    return {"llama": ref_tiny(dtype=jnp.float32, max_context_len=512),
            "mixtral": ref_mixtral.mixtral_tiny_config(dtype=jnp.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _spawn(case, spec_path, tmp):
    world = 1
    for n in CASES[case]["axes"].values():
        world *= n
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        out = str(tmp / f"{case}.{r}.json")
        log = open(tmp / f"{case}.{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, spec_path, str(r), str(world),
             str(port), out], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), out, log))
    return procs


def _collect(procs):
    results = []
    try:
        for p, out, log in procs:
            rc = p.wait(timeout=RANK_TIMEOUT_S)
            log.close()
            text = Path(log.name).read_text()
            assert rc == 0, f"rank exited {rc}:\n{text[-3000:]}"
            with open(out) as f:
                res = json.load(f)
            res["pool"] = list(np.load(out + ".npz").values())
            results.append(res)
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return results


def _one_process(case, rcfg, tree):
    """The reference engine and the port's one-process engine on the
    case's mesh, serving its greedy requests (the reference) and all of
    them (the port) one after another."""
    from xllm_service_tpu.common.request import SamplingParams as RefSampling
    from xllm_service_tpu.engine.config import EngineConfig as RefConfig
    from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
    from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
    from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )
    from xllm_service_tpu_torch.models.weights import params_from_jax
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    from test_torch_gemma import port_config

    spec = CASES[case]
    axes = spec["axes"]
    mcfg = MeshConfig(**axes)
    kw = {**ENGINE_KW, **spec.get("engine", {})}
    ref = RefEngine(RefConfig(model=rcfg, model_family=rcfg.name,
                              prefill_buckets=(32, 64, 128, 512),
                              mesh=RefMeshConfig(**axes), **kw),
                    params=tree)
    port = InferenceEngine(
        EngineConfig(model=port_config(rcfg), model_family=rcfg.name, **kw),
        device="cpu", params=params_from_jax(tree, device="cpu"),
        mesh=build_mesh(mcfg, ["cpu"] * mcfg.num_devices()))
    toks = {"ref": {}, "port": {}}
    port_shards = None
    for sid, prompt, sampling in spec["requests"]:
        if port_shards is None and sampling.get("temperature", 0) > 0:
            # The pools after the greedy requests (the reference serves
            # no sampled one).
            pool = port.kv_pages
            port_shards = [s.numpy().copy() for s in pool.shards] \
                if hasattr(pool, "shards") else [pool.numpy().copy()]
        for name, eng, req_cls, sp_cls in (
                ("ref", ref, RefRequest, RefSampling),
                ("port", port, EngineRequest, SamplingParams)):
            if name == "ref" and sampling.get("temperature", 0) > 0:
                continue
            col = Collector()
            eng.submit(req_cls(sid, token_ids=list(prompt),
                               sampling=sp_cls(**sampling), on_output=col))
            for _ in range(400):
                if col.done.is_set():
                    break
                eng.step()
            toks[name][sid] = col.tokens
    ref_pool = np.asarray(ref._dstate["kv"])
    stats = {**port.stats(), "ring_prefills": port.ring_prefills}
    ref.stop()
    port.stop()
    return toks, ref_pool, port_shards, stats


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case's ranks, spawned together, then the one-process engines
    here while they run: {case: (ranks' results, tokens, reference pool,
    the one-process shards, its stats)}."""
    from test_torch_gemma import drawn_tree, port_config

    tmp = tmp_path_factory.mktemp("multihost")
    cfgs = _configs()
    trees, running = {}, {}
    for case, spec in CASES.items():
        rcfg = cfgs[spec["family"]]
        if spec["family"] not in trees:
            trees[spec["family"]] = drawn_tree(rcfg)
            np.savez(tmp / f"{spec['family']}.npz",
                     **_flat(trees[spec["family"]]))
        spec_path = str(tmp / f"{case}.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump({**spec, "cfg": port_config(rcfg),
                         "npz": str(tmp / f"{spec['family']}.npz")}, f)
        running[case] = _spawn(case, spec_path, tmp)
    out = {}
    for case, spec in CASES.items():
        rcfg = cfgs[spec["family"]]
        one = _one_process(case, rcfg, trees[spec["family"]])
        out[case] = (_collect(running[case]), *one)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_match_reference_and_one_process(served, case):
    ranks, toks, _, _, stats = served[case]
    spec = CASES[case]
    primary = ranks[0]
    want = {sid: toks["port"][sid] for sid, _, _ in spec["requests"]}
    got = {sid: primary["tokens"][sid] for sid, _, _ in spec["requests"]}
    assert got == want, case
    for sid, greedy in toks["ref"].items():
        assert got[sid] == greedy, (case, sid)
    assert all(len(t) == 6 for t in got.values())
    for r in ranks[1:]:
        # A follower emits what the primary emits (its sink drops them).
        assert r["tokens"] == primary["tokens"], (case, r["rank"])
    for r in ranks:
        assert r["backend"] == "gloo"
        # The drill's last request hits the prefix cache once more.
        assert r["stats"]["prefix_hits"] == \
            stats["prefix_hits"] + bool(spec.get("drill")) >= 1
        assert r["stats"]["decode_route"] == "eager"
        assert r["stats"]["mesh"] == stats["mesh"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_pool_shards(served, case):
    ranks, _, ref_pool, port_shards, _ = served[case]
    axes = CASES[case]["axes"]
    for r in ranks:
        assert len(r["pool"]) == 1, "a rank holds one coordinate's shard"
        got, idx = r["pool"][0], r["pool_index"][0]
        if "seq" in axes:
            n = axes["seq"]
            P = ref_pool.shape[2] // n
            want = ref_pool[:, :, idx * P:(idx + 1) * P]
            lo = 1 if idx == 0 else 0          # the garbage page
            np.testing.assert_array_equal(got, port_shards[idx])
            assert np.abs(got[:, :, lo:]).max() > 0
            np.testing.assert_allclose(got[:, :, lo:], want[:, :, lo:],
                                       **POOL_TOL)
        else:
            n = axes["model"]
            H = ref_pool.shape[3] // n
            want = ref_pool[:, :, :, idx * H:(idx + 1) * H]
            np.testing.assert_array_equal(got, port_shards[idx])
            assert np.abs(got[:, :, 1:]).max() > 0
            np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:],
                                       **POOL_TOL)


def test_shards_are_the_ranks_own(served):
    ranks = served["expert2_model2"][0]
    assert [tuple(r["local_shards"][0]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(len(r["local_shards"]) == 1 for r in ranks)


def test_ring_prefill_over_ranks(served):
    """The long prompt took the ring on every rank, as on the one-process
    engine (its tokens equal the reference's ring run, checked above);
    each rank held one seq shard."""
    ranks, _, _, _, stats = served["seq2"]
    assert stats["ring_prefills"] == 1
    assert [r["stats"]["ring_prefills"] for r in ranks] == [1, 1]
    assert [r["pool_index"] for r in ranks] == [[0], [1]]


def test_broadcast_bytes_empty_and_large(served):
    ranks = served["model2"][0]
    for r in ranks:
        assert r["bcast"] == [0, len(BIG), 3]
        assert r["bcast_big_ok"]


def test_tiers_off_with_the_reference_warning(served):
    for r in served["model2"][0]:
        assert not r["tier_store"]
        assert "KV tiering disabled: multi-host mesh" in r["warnings"]


def test_failed_step_fails_the_request_and_ranks_keep_ticking(served):
    ranks, toks, _, _, _ = served["model2"]
    primary = ranks[0]
    assert "engine failure: injected step failure" in \
        primary["statuses"]["boom"]
    assert primary["tokens"]["boom"] == []
    # The next request is served by every rank after the failure (B
    # again, behind the same cached prefix: B's tokens).
    assert primary["tokens"]["after"] == toks["port"]["b"]
    for r in ranks[1:]:
        assert r["tokens"]["after"] == primary["tokens"]["after"]


def test_refusals_are_the_references():
    from xllm_service_tpu.engine import multihost_driver as ref_md
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import EngineRequest
    from xllm_service_tpu_torch.engine import multihost_driver as md

    assert md.MultihostEngineProxy._UNSAFE == \
        ref_md.MultihostEngineProxy._UNSAFE

    class Engine:
        cfg = "cfg"

    drv = md.MultihostEngineDriver(Engine())
    proxy = md.MultihostEngineProxy(drv)
    for name in md.MultihostEngineProxy._UNSAFE:
        with pytest.raises(NotImplementedError):
            getattr(proxy, name)
    assert proxy.cfg == "cfg"
    sp = SamplingParams(max_tokens=2)
    for field, value in (("prefill_only", True),
                         ("injected_kv", torch.zeros(1)),
                         ("injected_first_token", 5),
                         ("mm_embeds", np.zeros((1, 4), np.float32)),
                         ("resume_output_ids", [3])):
        req = EngineRequest("x", token_ids=[1, 2], sampling=sp,
                            **{field: value})
        with pytest.raises(NotImplementedError):
            drv.submit(req)
    assert drv._pending == []
    drv.submit(EngineRequest("ok", token_ids=[1, 2], sampling=sp))
    drv.cancel("ok")
    drv.shutdown()
    assert [e["op"] for e in drv._pending] == ["submit", "cancel",
                                               "shutdown"]


def test_dp_size_over_processes_is_an_error(monkeypatch):
    from xllm_service_tpu_torch.engine import agent
    from xllm_service_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "initialize_from_env", lambda: True)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(SystemExit) as e:
        agent.main(["--coordination-addr", "127.0.0.1:1", "--device", "cpu",
                    "--model-config", "tiny", "--dp-size", "2"])
    assert e.value.code == 2


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                       int(sys.argv[4]), sys.argv[5]))
