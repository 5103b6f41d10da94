"""The port's GPipe op (``ops/pipeline.py::pipeline_forward``) against the
reference's (``xllm_service_tpu/ops/pipeline.py``) on
tests/test_pipeline.py's toy layers (a residual tanh MLP; L 8, D 16, H 32,
B 8), drawn with numpy from a seed. The reference runs on the virtual CPU
devices of tests/conftest.py, the port on ``cpu`` repeated.

Cases: (stages, microbatches) = (2, 2), (4, 4) and (4, 2); a single
stage; two gloo ranks as ``pipe=2`` (the process harness of
tests/test_torch_multihost.py), each rank holding one stage; and both
refusals (a batch the microbatches do not divide, a layer count the
stages do not divide). f32, within 2e-5 (relative and absolute) of the
reference.

This file is also the rank worker: ``python tests/test_torch_pipeline.py
NPZ RANK WORLD PORT OUT`` (no JAX there).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_multihost as mh

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

TOL = dict(rtol=2e-5, atol=2e-5)
L, D, H, B = 8, 16, 32, 8


def layer_fn(x, lp):
    """tests/test_pipeline.py's toy layer in torch."""
    h = torch.tanh(x @ lp["w1"] + lp["b1"])
    return x + h @ lp["w2"]


def draw(L, D, H, B, seed=0):
    """The toy layers and an input, with numpy (tests/test_pipeline.py's
    draws)."""
    rng = np.random.default_rng(seed)
    layers = {"w1": rng.normal(0, 0.3, (L, D, H)).astype(np.float32),
              "b1": rng.normal(0, 0.1, (L, H)).astype(np.float32),
              "w2": rng.normal(0, 0.3, (L, H, D)).astype(np.float32)}
    x = np.random.default_rng(seed + 1).normal(size=(B, D)).astype(
        np.float32)
    return layers, x


def reference(layers, x, stages, micro):
    import jax
    import jax.numpy as jnp

    from xllm_service_tpu.ops.pipeline import pipeline_forward
    from xllm_service_tpu.parallel.mesh import MeshConfig, build_mesh

    from test_pipeline import layer_fn as ref_layer_fn

    mesh = build_mesh(MeshConfig(pipe=stages),
                      devices=jax.devices()[:stages])
    lyr = {k: jnp.asarray(v) for k, v in layers.items()}
    with mesh:
        out = jax.jit(lambda a, b: pipeline_forward(
            ref_layer_fn, a, b, mesh, n_microbatches=micro))(
                lyr, jnp.asarray(x))
    return np.asarray(out)


def port(layers, x, stages, micro):
    from xllm_service_tpu_torch.ops.pipeline import pipeline_forward
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(pipe=stages), ["cpu"] * stages)
    lyr = {k: torch.from_numpy(v) for k, v in layers.items()}
    return pipeline_forward(layer_fn, lyr, torch.from_numpy(x), mesh,
                            n_microbatches=micro).numpy()


def sequential(layers, x):
    h = torch.from_numpy(x)
    for l in range(layers["w1"].shape[0]):
        h = layer_fn(h, {k: torch.from_numpy(v[l])
                         for k, v in layers.items()})
    return h.numpy()


@pytest.mark.parametrize("stages,micro", [(2, 2), (4, 4), (4, 2)])
def test_matches_reference(stages, micro):
    layers, x = draw(L, D, H, B)
    got = port(layers, x, stages, micro)
    assert got.shape == (B, D)
    np.testing.assert_allclose(got, reference(layers, x, stages, micro),
                               **TOL)
    np.testing.assert_allclose(got, sequential(layers, x), **TOL)


def test_single_stage():
    layers, x = draw(4, 8, 16, 4, seed=3)
    got = port(layers, x, 1, 2)
    np.testing.assert_allclose(got, reference(layers, x, 1, 2), **TOL)


def test_refusals_are_the_references():
    layers, x = draw(L, D, H, B)
    with pytest.raises(ValueError, match="microbatches"):
        port(layers, x, 2, 3)
    with pytest.raises(AssertionError, match="microbatches"):
        reference(layers, x, 2, 3)
    odd = {k: v[:6] for k, v in layers.items()}
    with pytest.raises(ValueError, match="pipe stages"):
        port(odd, x, 4, 2)
    with pytest.raises(Exception):
        reference(odd, x, 4, 2)


# ------------------------------------------------------------ rank worker
def rank_main(npz, rank, world, port_no, out_path):
    """One rank of ``pipe=2``: its stage of the layers, the forward, and
    the output it was handed."""
    torch.set_num_threads(1)
    from xllm_service_tpu_torch.ops.pipeline import pipeline_forward
    from xllm_service_tpu_torch.parallel import multihost
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, process_mesh

    multihost.initialize(f"127.0.0.1:{port_no}", world, rank, timeout_s=60)
    data = dict(np.load(npz))
    mesh = process_mesh(MeshConfig(pipe=world), ["cpu"])
    lyr = {k: torch.from_numpy(data[k]) for k in ("w1", "b1", "w2")}
    multihost.reset_stats()
    out = pipeline_forward(layer_fn, lyr, torch.from_numpy(data["x"]), mesh,
                           n_microbatches=int(data["micro"]))
    np.save(out_path, out.numpy())
    with open(out_path + ".calls", "w") as f:
        f.write(str(multihost.STATS["collective_calls"]))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def test_two_ranks_as_pipe2(tmp_path):
    layers, x = draw(L, D, H, B)
    micro = 4
    np.savez(tmp_path / "pp.npz", x=x, micro=micro, **layers)
    port_no = mh._free_port()
    env = {**os.environ, "PYTHONPATH": str(mh.ROOT), "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(2):
        log = open(tmp_path / f"pp.{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(tmp_path / "pp.npz"), str(r), "2",
             str(port_no), str(tmp_path / f"pp.{r}.npy")], cwd=mh.ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    want = reference(layers, x, 2, micro)
    try:
        for p, log in procs:
            rc = p.wait(timeout=mh.RANK_TIMEOUT_S)
            log.close()
            assert rc == 0, open(log.name).read()[-3000:]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [np.load(tmp_path / f"pp.{r}.npy") for r in range(2)]
    for got in outs:
        np.testing.assert_allclose(got, want, **TOL)
    # Every rank was handed the last stage's bits.
    assert np.array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], port(layers, x, 2, micro))
    # One hop per microbatch crossing (M shifts), then the broadcast.
    for r in range(2):
        assert (tmp_path / f"pp.{r}.npy.calls").read_text() == str(micro + 1)


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                       int(sys.argv[4]), sys.argv[5]))
