"""The MoE families and qwen2_vl with ``seq`` together with ``model`` or
``expert``: the port's engine against the reference engine on the same
mesh (four of the virtual CPU devices of tests/conftest.py), on the same
f32 weights (the reference's ``init_params`` with norm scales drawn
non-zero, ``params_from_jax``):

- deepseek_moe with MLA (``tiny_mla_config``: one latent head of 48, so
  the grid's model shards each hold the whole latent pool split over
  seq) and mixtral, each on ``seq=2 x model=2`` and ``seq=2 x expert=2``;
- qwen2_vl on ``seq=2 x model=2`` with text prompts.

Each engine serves a short prompt, a long prefix-free one (the ring) and
the long one again (a prefix hit): tests/test_torch_moe_seq_parallel.py's
SHORT and LONG, and for qwen2_vl tests/test_torch_vl_seq_parallel.py's
odd-length LONG, whose ring suffix is padded by one token with its M-RoPE
rows padded alike. Greedy tokens are identical to the reference's, the
ring is taken once on both, and the port's pool (``full()``) is within
1e-5 of the reference's, page 0 excluded.
"""

import jax
import numpy as np
import pytest

from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from xllm_service_tpu_torch.parallel.sharding import ModelShardedPages

import test_torch_qwen2_vl
import test_torch_vl_seq_parallel as vl_seq
from test_torch_gemma import drawn_tree, port_config
from test_torch_moe_seq_parallel import (
    ENGINE_KW,
    LONG,
    POOL_TOL,
    SHORT,
    run_one,
    spy_ring,
)

F32 = jax.numpy.float32
CONFIGS = {
    "mla": lambda: ref_ds.tiny_mla_config(dtype=F32),
    "mixtral": lambda: ref_mixtral.mixtral_tiny_config(dtype=F32),
    "qwen2_vl": lambda: ref_vl.tiny_vl_config(dtype=F32,
                                              max_context_len=512,
                                              image_token_id=100),
}
SEQ_MODEL, SEQ_EXPERT = dict(seq=2, model=2), dict(seq=2, expert=2)
CASES = [("mla", SEQ_MODEL), ("mla", SEQ_EXPERT), ("mixtral", SEQ_MODEL),
         ("mixtral", SEQ_EXPERT), ("qwen2_vl", SEQ_MODEL)]


def port_cfg(rcfg):
    if rcfg.name == "qwen2_vl":
        return test_torch_qwen2_vl.port_config(rcfg)
    return port_config(rcfg)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}-" + "x".join(f"{a}{k}" for a, k in ax.items())
                     for n, ax in CASES])
def served(request):
    """The reference and the port on one case's mesh after SHORT, LONG and
    LONG again: (name, axes, rcfg, ref, port, tokens, ring counts)."""
    name, axes = request.param
    rcfg = CONFIGS[name]()
    tree = drawn_tree(rcfg)
    ref = RefEngine(RefConfig(model=rcfg, model_family=rcfg.name,
                              prefill_buckets=(32, 64, 128, 512),
                              mesh=RefMeshConfig(**axes), **ENGINE_KW),
                    params=tree)
    ring = spy_ring(ref)
    mcfg = MeshConfig(**axes)
    port = InferenceEngine(
        EngineConfig(model=port_cfg(rcfg), model_family=rcfg.name,
                     **ENGINE_KW),
        device="cpu", params=params_from_jax(tree, device="cpu"),
        mesh=build_mesh(mcfg, ["cpu"] * mcfg.num_devices()))
    long = vl_seq.LONG if name == "qwen2_vl" else LONG
    toks, rings = {"ref": [], "port": []}, []
    for prompt in (SHORT, long, long):
        toks["ref"].append(run_one(ref, prompt))
        toks["port"].append(run_one(port, prompt))
        rings.append((ring["n"], port.ring_prefills))
    yield name, axes, rcfg, ref, port, toks, rings
    ref.stop()
    port.stop()


def test_greedy_tokens_match_reference(served):
    name, axes, rcfg, _, port, toks, _ = served
    assert toks["port"] == toks["ref"], (name, axes)
    assert all(len(t) == 5 for t in toks["port"])
    pool = port.kv_pages
    if "model" in axes:
        # The grid: each model shard's part split over its seq line; MLA's
        # one latent head is whole on every model shard.
        assert isinstance(pool, ModelShardedPages)
        assert pool.replicated == (name == "mla")
        heads = rcfg.num_kv_heads // (1 if pool.replicated else 2)
        for part in pool.shards:
            assert isinstance(part, ShardedPages)
            assert part.shards[0].shape == (rcfg.num_layers, 2, 32, heads,
                                            16, rcfg.head_dim)
    else:
        assert isinstance(pool, ShardedPages)
        assert pool.shards[0].shape == (rcfg.num_layers, 2, 32,
                                        rcfg.num_kv_heads, 16,
                                        rcfg.head_dim)


def test_ring_taken_once(served):
    *_, port, _, rings = served
    assert rings == [(0, 0), (1, 1), (1, 1)]
    assert port.stats()["prefix_hits"] == 1


def test_pool_matches_reference_pool(served):
    _, _, rcfg, ref, port, _, _ = served
    want = np.asarray(ref._dstate["kv"])
    got = port.kv_pages.full().numpy()
    assert got.shape == want.shape == (rcfg.num_layers, 2, 64,
                                       rcfg.num_kv_heads, 16, rcfg.head_dim)
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], **POOL_TOL)
