"""Expert parallelism: the MoE families on an ``expert=2 x model=2`` mesh
and an ``expert=4`` mesh. The port's engine on the mesh (``cpu``
repeated) is held against the reference engine on the same mesh (the
virtual CPU devices of tests/conftest.py) and against the port's unmeshed
engine, for ``tiny_moe_config`` (GQA, shared experts),
``tiny_mla_config`` (MLA's one latent head, whose pool is replicated over
``model``) and ``mixtral_tiny_config``, on the same f32 weights (the
reference's ``init_params`` with norm scales drawn non-zero,
``params_from_jax``).

Each engine serves a 35-token prompt and a 37-token one sharing its first
32 (a prefix hit), five greedy tokens each: the tokens are identical on
the three engines, and the port's pool (shards joined on the head axis)
equals the reference's within 1e-5 (f32 arithmetic in another order), the
garbage page 0 excluded.
"""

import jax
import numpy as np
import pytest
import torch

from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from xllm_service_tpu_torch.parallel.sharding import (
    ModelShardedPages,
    ShardedParams,
)

from test_torch_gemma import drawn_tree, port_config
from test_torch_moe_seq_parallel import run_one

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=512)
PROMPTS = (list(range(40, 75)), list(range(40, 72)) + [7, 9, 11, 13, 15])
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    "moe": lambda: ref_ds.tiny_moe_config(dtype=jax.numpy.float32),
    "mla": lambda: ref_ds.tiny_mla_config(dtype=jax.numpy.float32),
    "mixtral": lambda: ref_mixtral.mixtral_tiny_config(
        dtype=jax.numpy.float32),
}
MESHES = {"ep2xtp2": dict(expert=2, model=2), "ep4": dict(expert=4)}


def cpu_mesh(**axes):
    cfg = MeshConfig(**axes)
    return build_mesh(cfg, ["cpu"] * cfg.num_devices())


def serve(engine):
    return [run_one(engine, p) for p in PROMPTS]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def family(request):
    """(name, reference config, tree, the port's unmeshed tokens)."""
    rcfg = CONFIGS[request.param]()
    tree = drawn_tree(rcfg)
    single = InferenceEngine(
        EngineConfig(model=port_config(rcfg), model_family=rcfg.name,
                     **ENGINE_KW),
        device="cpu", params=params_from_jax(tree, device="cpu"))
    yield request.param, rcfg, tree, serve(single)
    single.stop()


@pytest.fixture(scope="module", params=sorted(MESHES))
def served(request, family):
    """The reference and the port on one mesh after serving PROMPTS."""
    name, rcfg, tree, single = family
    axes = MESHES[request.param]
    ref = RefEngine(RefConfig(model=rcfg, model_family=rcfg.name,
                              prefill_buckets=(32, 64, 512),
                              mesh=RefMeshConfig(**axes), **ENGINE_KW),
                    params=tree)
    port = InferenceEngine(
        EngineConfig(model=port_config(rcfg), model_family=rcfg.name,
                     **ENGINE_KW),
        device="cpu", params=params_from_jax(tree, device="cpu"),
        mesh=cpu_mesh(**axes))
    toks = {"ref": serve(ref), "port": serve(port), "single": single}
    yield name, axes, rcfg, ref, port, toks
    ref.stop()
    port.stop()


def test_greedy_tokens_match_reference_and_unmeshed(served):
    name, axes, rcfg, _, port, toks = served
    assert isinstance(port.params, ShardedParams)
    assert len(port.params.trees) == axes.get("expert", 1) * \
        axes.get("model", 1)
    ex = port.params.tree(0, 0)["moe"]["experts"]["gate_proj"]["kernel"]
    assert ex.shape[1] == rcfg.num_experts // axes.get("expert", 1)
    assert ex.shape[-1] == rcfg.moe_ffn_size // axes.get("model", 1)
    assert toks["port"] == toks["ref"] == toks["single"], (name, axes)
    assert all(len(t) == 5 for t in toks["port"])
    assert port.stats()["prefix_hits"] == 1
    assert port.stats()["decode_route"] == "eager"


def test_pool_matches_reference_pool(served):
    name, axes, rcfg, ref, port, _ = served
    tp = axes.get("model", 1)
    if tp > 1:
        assert isinstance(port.kv_pages, ModelShardedPages)
        # MLA's one latent head does not divide: the pool is replicated.
        assert port.kv_pages.replicated == (name == "mla")
        heads = rcfg.num_kv_heads if name == "mla" \
            else rcfg.num_kv_heads // tp
        assert port.kv_pages.shards[0].shape[3] == heads
        got = port.kv_pages.full().numpy()
    else:
        got = port.kv_pages.numpy()
    want = np.asarray(ref._dstate["kv"])
    assert got.shape == want.shape
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], **POOL_TOL)


def test_router_is_replicated_and_experts_split():
    """Every (expert, model) shard holds the whole router; the expert
    stacks split over ``expert``, their ffn over ``model``, and a shard's
    leaves are views of the tree on a repeated device."""
    rcfg = CONFIGS["moe"]()
    tree = params_from_jax(drawn_tree(rcfg), device="cpu")
    from xllm_service_tpu_torch.models.deepseek_moe import MOE_STACKED_RULES
    from xllm_service_tpu_torch.parallel.sharding import shard_params

    sp = shard_params(tree, cpu_mesh(expert=2, model=2), MOE_STACKED_RULES)
    router = tree["moe"]["router"]["kernel"]
    up = tree["moe"]["experts"]["up_proj"]["kernel"]
    for e in range(2):
        for m in range(2):
            t = sp.tree(e, m)["moe"]
            assert t["router"]["kernel"] is router
            got = t["experts"]["up_proj"]["kernel"]
            torch.testing.assert_close(got, up[:, 2 * e:2 * e + 2, :,
                                               32 * m:32 * m + 32],
                                       rtol=0, atol=0)
            assert got.untyped_storage().data_ptr() == \
                up.untyped_storage().data_ptr()
