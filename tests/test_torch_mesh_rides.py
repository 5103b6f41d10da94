"""Chunks riding decode steps (the Sarathi mixed step) on a mesh without a
``seq`` axis: the port's engine on the mesh (``cpu`` repeated) against
the reference engine on the same mesh (the virtual CPU devices of
tests/conftest.py), on the same f32 weights (the reference's
``init_params`` with norm scales and biases drawn non-zero,
``params_from_jax``).

The reference rides a chunk on every mesh but ``seq``
(``xllm_service_tpu/engine/engine.py::_ride_chunk_args``). Each case
serves, submitted together with chunks of 32 and two batch slots, a
35-token greedy prompt (8 tokens), a 200-token one (5 tokens: its chunks
ride the first one's decode steps) and a 37-token one that waits for a
slot (so the first rides take the four-chunk span of queue pressure).
The greedy tokens, the number of rides and the span of each ride are the
reference's.

Cases: llama on ``data=2``, ``pipe=2`` and ``model=2 x data=2``; qwen2
and Gemma-2 on ``model=2``; llama on ``seq=2``, where neither engine
rides. Llama on ``model=2`` is in tests/test_torch_tp_engine.py.

Over processes: llama on ``model=2`` as two ranks joined in a gloo group
(engine/multihost_driver.py's lockstep), plus a seeded sampled request.
Both ranks ride in the same steps as the port's one-process engine on
that mesh, and every stream equals that engine's.

This file is also the rank worker: ``python tests/test_torch_mesh_rides.py
SPEC RANK WORLD PORT OUT`` (no JAX there).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_multihost as mh

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

CHUNK = 32
LONG = [(i * 13 + 7) % 400 + 20 for i in range(200)]
SHORT = list(range(40, 75))
LATE = list(range(40, 72)) + [7, 9, 11, 13, 15]
GREEDY = dict(temperature=0.0, ignore_eos=True)
REQUESTS = [("short", SHORT, 8), ("long", LONG, 5), ("late", LATE, 4)]
CASES = [("llama", dict(data=2)), ("llama", dict(pipe=2)),
         ("llama", dict(model=2, data=2)), ("qwen2", dict(model=2)),
         ("gemma2", dict(model=2))]


# ------------------------------------------------------------ rank worker
def rank_main(spec_path, rank, world, port, out_path):
    """One rank of the model=2 case: the engine on the mesh over the
    ranks, every request submitted before the first tick; records the
    rides of each step and the streams it saw."""
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
    mesh = mesh_from_config(MeshConfig(**spec["axes"]), torch.device("cpu"))
    fam = get_model_family("llama")
    params = params_from_jax(mh._nest(dict(np.load(spec["npz"]))), "cpu",
                             mesh, fam.sharding_rules)
    eng = InferenceEngine(EngineConfig(model=spec["cfg"], **spec["engine"]),
                          device="cpu", params=params, mesh=mesh)
    rides = []
    step = eng.step

    def counted():
        before = eng.sarathi_rides
        worked = step()
        rides.append(eng.sarathi_rides - before)
        return worked

    eng.step = counted
    drv = md.MultihostEngineDriver(eng)
    streams = {}

    def follower_sink(o):
        streams.setdefault(o.service_request_id, []).extend(
            t for s in o.outputs for t in s.token_ids)

    md._drop = follower_sink
    if rank == 0:
        cols = {}
        for sid, prompt, sampling in spec["requests"]:
            cols[sid] = mh.Collector()
            drv.submit(EngineRequest(sid, token_ids=list(prompt),
                                     sampling=SamplingParams(**sampling),
                                     on_output=cols[sid]))
        for _ in range(400):
            if all(c.done.is_set() for c in cols.values()):
                break
            drv.tick()
        assert all(c.done.is_set() for c in cols.values())
        streams = {sid: c.tokens for sid, c in cols.items()}
        drv.shutdown()
        while drv.tick():
            pass
    else:
        drv.follower_loop()
    eng.stop()
    np.savez(out_path + ".npz")         # no pool to compare here
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "tokens": streams, "rides": rides,
                   "sarathi_rides": eng.sarathi_rides,
                   "backend": multihost.backend()}, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------- test side
def _serve(eng, ref):
    """Every request submitted before the first step; the tokens, and the
    span of each ride in order."""
    from test_torch_chunked_prefill import step_until
    from test_torch_vl_engine import submitter

    spans = []
    ride = eng._ride_chunk_args

    def logged(*a):
        out = ride(*a)
        if out is not None:
            spans.append(len(out[1]) if ref else out)
        return out

    eng._ride_chunk_args = logged
    submit = submitter(eng, ref)
    cols = [submit(sid, prompt, n, sampling=GREEDY)
            for sid, prompt, n in REQUESTS]
    step_until(eng, cols)
    return [c.tokens for c in cols], spans


@pytest.fixture(scope="module")
def trees():
    from test_torch_gemma import drawn_tree
    from test_torch_tp_engine import FAMILIES

    return {name: drawn_tree(FAMILIES[name]())
            for name in ("llama", "qwen2", "gemma2")}


@pytest.mark.parametrize("name,axes", CASES + [("llama", dict(seq=2))],
                         ids=[f"{n}-" + "x".join(f"{a}{k}" for a, k in
                                                 ax.items())
                              for n, ax in CASES + [("llama",
                                                     dict(seq=2))]])
def test_rides_match_reference_on_mesh(trees, name, axes):
    from test_torch_tp_engine import FAMILIES, engines

    rcfg = FAMILIES[name]()
    ref, port = engines(rcfg, trees[name], axes, prefill_chunk_tokens=CHUNK)
    try:
        want, want_spans = _serve(ref, True)
        got, got_spans = _serve(port, False)
    finally:
        ref.stop()
        port.stop()
    assert got == want
    assert [len(t) for t in got] == [n for _, _, n in REQUESTS]
    assert port.sarathi_rides == ref.sarathi_rides == len(got_spans)
    assert got_spans == want_spans
    if "seq" in axes:
        assert port.sarathi_rides == 0
    else:
        assert port.sarathi_rides > 0
        # Queue pressure took the four-chunk span at least once.
        assert 4 * CHUNK in got_spans and CHUNK in got_spans


MH_SPEC = dict(axes=dict(model=2),
               engine=dict(mh.ENGINE_KW, prefill_chunk_tokens=CHUNK),
               requests=[("short", SHORT, dict(GREEDY, max_tokens=8)),
                         ("long", LONG, dict(GREEDY, max_tokens=5)),
                         ("s", mh.SAMPLED, mh.SEEDED)])


def _one_process(tree, cfg):
    """The port's one-process engine on ``model=2``: streams and rides of
    each step, every request submitted before the first."""
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )
    from xllm_service_tpu_torch.models.weights import params_from_jax
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    eng = InferenceEngine(
        EngineConfig(model=cfg, **MH_SPEC["engine"]), device="cpu",
        params=params_from_jax(tree, device="cpu"),
        mesh=build_mesh(MeshConfig(model=2), ["cpu"] * 2))
    cols = {}
    for sid, prompt, sampling in MH_SPEC["requests"]:
        cols[sid] = mh.Collector()
        eng.submit(EngineRequest(sid, token_ids=list(prompt),
                                 sampling=SamplingParams(**sampling),
                                 on_output=cols[sid]))
    rides = []
    for _ in range(400):
        if all(c.done.is_set() for c in cols.values()):
            break
        before = eng.sarathi_rides
        eng.step()
        rides.append(eng.sarathi_rides - before)
    eng.stop()
    return {sid: c.tokens for sid, c in cols.items()}, rides


def test_ranks_ride_in_the_same_steps(tmp_path):
    from test_torch_gemma import drawn_tree, port_config

    rcfg = mh._configs()["llama"]
    tree = drawn_tree(rcfg)
    np.savez(tmp_path / "llama.npz", **mh._flat(tree))
    spec_path = str(tmp_path / "rides.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump({**MH_SPEC, "cfg": port_config(rcfg),
                     "npz": str(tmp_path / "llama.npz")}, f)
    port = mh._free_port()
    env = {**os.environ, "PYTHONPATH": str(mh.ROOT), "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(2):
        out = str(tmp_path / f"rides.{r}.json")
        log = open(tmp_path / f"rides.{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, spec_path, str(r), "2", str(port),
             out], cwd=mh.ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), out, log))
    want, want_rides = _one_process(tree, port_config(rcfg))
    ranks = mh._collect(procs)
    assert sum(want_rides) > 0
    primary, follower = ranks
    assert primary["tokens"] == want
    assert follower["tokens"] == want
    assert [len(t) for t in want.values()] == [8, 5, 6]
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["sarathi_rides"] == sum(want_rides)
        steps = [i for i, n in enumerate(r["rides"]) if n]
        assert steps == [i for i, n in enumerate(want_rides) if n], r["rank"]


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                       int(sys.argv[4]), sys.argv[5]))
