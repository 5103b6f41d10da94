"""The port's sharding rules and ``shard_params`` against the reference's.

Every family's rules give the reference's spec for every leaf path of its
tree (the reference's ``init_params`` at a tiny size), the int8 ``q8`` and
``scale`` leaves of a quantized tree included; ``KV_PAGES_SPEC`` is the
reference's.
``shard_params`` on a ``cpu``-repeated mesh gives each (expert, model)
coordinate the slice the reference's ``NamedSharding`` puts on the same
coordinate of its virtual devices, as views of the unsharded tree; a
replicated leaf is the same tensor in every shard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu.models import gemma as ref_gemma
from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu.models import quant as ref_quant
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu.parallel import sharding as ref_sharding
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu.parallel.mesh import build_mesh as ref_build_mesh
from xllm_service_tpu_torch.models.base import get_model_family
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel import sharding
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

CONFIGS = {
    "llama": lambda: ref_base.tiny_config(dtype=jnp.float32),
    "qwen2": lambda: ref_base.tiny_config(name="qwen2", qkv_bias=True,
                                          dtype=jnp.float32),
    "gemma": lambda: ref_gemma.gemma2_tiny_config(dtype=jnp.float32),
    "deepseek_moe": lambda: ref_ds.tiny_moe_config(dtype=jnp.float32),
    "deepseek_mla": lambda: ref_ds.tiny_mla_config(
        dtype=jnp.float32, first_dense_layers=1),
    "mixtral": lambda: ref_mixtral.mixtral_tiny_config(dtype=jnp.float32),
    "qwen2_vl": lambda: ref_vl.tiny_vl_config(dtype=jnp.float32),
}


def ref_tree(name, quant=False):
    rcfg = CONFIGS[name]()
    tree = ref_base.get_model_family(rcfg.name).init_params(
        rcfg, jax.random.PRNGKey(0))
    if quant:
        tree = ref_quant.quantize_tree(tree)
    return rcfg, tree


def paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from paths(v, p)
        else:
            yield p


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spec_for_equals_the_reference(name, quant):
    rcfg, tree = ref_tree(name, quant)
    want_rules = ref_base.get_model_family(rcfg.name).sharding_rules
    got_rules = get_model_family(rcfg.name).sharding_rules
    leaves = list(paths(tree))
    assert len(leaves) > 10
    if quant:
        assert any(p.endswith("/q8") for p in leaves)
    for p in leaves:
        assert got_rules.spec_for(p) == tuple(want_rules.spec_for(p)), p


def test_pool_spec_equals_the_reference():
    assert sharding.KV_PAGES_SPEC == tuple(ref_sharding.KV_PAGES_SPEC)
    assert sharding.HEAD_DIM == 3


@pytest.mark.parametrize("name,axes", [
    ("llama", dict(model=2)), ("qwen2", dict(data=2, model=2)),
    ("mixtral", dict(expert=2, model=2)), ("deepseek_mla", dict(expert=4)),
])
def test_shards_equal_the_references_device_shards(name, axes):
    """Each coordinate's shard equals the reference's shard on the device
    at that coordinate; replicated leaves are shared, sharded ones are
    views of the tree (``cpu`` repeated)."""
    rcfg, tree = ref_tree(name, quant=name == "mixtral")
    rules = ref_base.get_model_family(rcfg.name).sharding_rules
    rmesh = ref_build_mesh(RefMeshConfig(**axes),
                           devices=jax.devices()[:RefMeshConfig(
                               **axes).num_devices()])
    want = ref_sharding.shard_params(tree, rmesh, rules)
    cfg = MeshConfig(**axes)
    mesh = build_mesh(cfg, ["cpu"] * cfg.num_devices())
    port = params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    got = sharding.shard_params(port, mesh, get_model_family(
        rcfg.name).sharding_rules)
    ep, tp = cfg.expert, cfg.model
    assert len(got.trees) == ep * tp
    assert got.devices == [torch.device("cpu")] * (ep * tp)
    dev_grid = np.asarray(rmesh.devices)

    def leaf(t, p):
        for k in p.split("/"):
            t = t[k]
        return t

    for p in paths(tree):
        full = leaf(port, p)
        shards = {s.device: np.asarray(s.data)
                  for s in leaf(want, p).addressable_shards}
        for e in range(ep):
            for m in range(tp):
                dev = dev_grid[0, e, 0, 0, m]
                mine = leaf(got.tree(e, m), p)
                np.testing.assert_array_equal(mine.numpy(), shards[dev],
                                              err_msg=p)
                assert mine.untyped_storage().data_ptr() == \
                    full.untyped_storage().data_ptr(), p


def test_split_dim_must_divide():
    rules = sharding.ShardingRules(rules=[(r"w", (None, "model"))])
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_params({"w": torch.zeros(2, 3)},
                              build_mesh(MeshConfig(model=2), ["cpu"] * 2),
                              rules)


def test_collectives():
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])]
    assert sharding.all_reduce(parts).tolist() == [4.0, 6.0]
    assert sharding.all_gather(parts, 0).tolist() == [1.0, 2.0, 3.0, 4.0]
    assert sharding.all_reduce(parts[:1]) is parts[0]
    x = torch.ones(3)
    assert all(y is x for y in sharding.broadcast(x, [x.device] * 3))


def test_mesh_for_devices_and_coordinates():
    assert MeshConfig.for_devices(8).shape == (1, 1, 1, 1, 8)
    assert MeshConfig.for_devices(8, tp=2).shape == (4, 1, 1, 1, 2)
    with pytest.raises(ValueError):
        MeshConfig.for_devices(6, tp=4)
    mesh = build_mesh(MeshConfig(data=2, expert=2, model=2),
                      [f"cuda:{i}" for i in range(8)])
    assert mesh.shard_devices() == [torch.device("cuda", i)
                                    for i in (0, 1, 2, 3)]
    assert mesh.device_at(data=1) == torch.device("cuda", 4)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_loader_on_a_mesh_equals_shard_params_of_the_load(tmp_path, quant):
    """An HF directory loaded with ``mesh``/``rules`` equals
    ``shard_params`` of the unsharded load (int8: quantized first), leaf
    for leaf and shard for shard, and serves on an engine of that mesh."""
    import dataclasses

    from test_torch_loader import _write
    from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
    from xllm_service_tpu_torch.models import loader
    from xllm_service_tpu_torch.models.llama import LLAMA_STACKED_RULES
    from xllm_service_tpu_torch.models.quant import quantize_tree

    _, cfg, _ = _write(tmp_path, "llama")
    cfg = dataclasses.replace(cfg, quant=quant)
    mesh = build_mesh(MeshConfig(model=2), ["cpu"] * 2)
    got = loader.load_hf_llama_safetensors(tmp_path, cfg, mesh=mesh,
                                           rules=LLAMA_STACKED_RULES)
    flat = loader.load_hf_llama_safetensors(tmp_path, cfg, device="cpu")
    want = sharding.shard_params(quantize_tree(flat) if quant else flat,
                                 mesh, LLAMA_STACKED_RULES)
    assert isinstance(got, sharding.ShardedParams)
    for g, w in zip(got.trees, want.trees):
        gl, wl = dict(paths_and_leaves(g)), dict(paths_and_leaves(w))
        assert sorted(gl) == sorted(wl)
        for p in wl:
            assert torch.equal(gl[p], wl[p]), p
    eng = InferenceEngine(EngineConfig(model=cfg, num_pages=16,
                                       max_batch_size=1, max_seq_len=128),
                          device="cpu", params=got, mesh=mesh)
    assert eng.params is got
    with pytest.raises(ValueError, match="sharded on"):
        InferenceEngine(EngineConfig(model=cfg, num_pages=16,
                                     max_batch_size=1, max_seq_len=128),
                        device="cpu", params=got,
                        mesh=build_mesh(MeshConfig(expert=2, model=2),
                                        ["cpu"] * 4))


def paths_and_leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from paths_and_leaves(v, p)
        else:
            yield p, v


def test_int8_draw_equals_quantize_tree_of_the_bf16_draw(monkeypatch):
    """The llama family's int8 draw (one layer of one projection at a
    time, in column blocks; a ragged last block here) equals
    ``quantize_tree`` of the model-dtype tree drawn from the same
    generator, bit for bit: Llama-3-70B's int8 tree is drawn without its
    bf16 tree."""
    import dataclasses

    from xllm_service_tpu_torch.models import llama
    from xllm_service_tpu_torch.models.base import tiny_config
    from xllm_service_tpu_torch.models.quant import quantize_tree

    monkeypatch.setattr(llama, "QUANT_COLUMNS", 96)
    cfg = tiny_config(dtype=torch.bfloat16, vocab_size=500)
    got = llama.init_params(dataclasses.replace(cfg, quant="int8"),
                            torch.Generator().manual_seed(3), "cpu")
    want = quantize_tree(llama.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    g, w = dict(paths_and_leaves(got)), dict(paths_and_leaves(want))
    assert sorted(g) == sorted(w) and any(p.endswith("/q8") for p in g)
    for p in w:
        assert torch.equal(g[p], w[p]), p
