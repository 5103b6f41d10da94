"""Tensor parallelism: the dense families on a ``model=2`` mesh, and the
``data`` and ``pipe`` axes. The port's engine on the mesh (``cpu``
repeated) is held against the reference engine on the same mesh (the
virtual CPU devices of tests/conftest.py) and against the port's unmeshed
engine, on the same f32 weights (the reference's ``init_params`` with norm
scales and biases drawn non-zero, ``params_from_jax``).

Families on ``model=2``: llama, qwen2 (its q/k/v biases split with their
heads), Gemma-2 (its tied table split by vocabulary, its score softcap and
window per head) and qwen2_vl (an image prompt and a text one; its tower
replicated), and llama in weight-only int8 (quantized, then sharded).
Llama also on ``data=2 x model=2`` and ``pipe=2`` (replicated axes). Each
engine serves a 35-token prompt and a 37-token one sharing its first 32 (a
prefix hit), five greedy tokens each: the tokens are identical on the
three engines, and the port's pool (shards joined on the head axis)
equals the reference's within 1e-5, the garbage page 0 excluded. On
``model=2`` also: a chunked prompt (chunks of 32) against the reference's
chunked engine, riding decode steps as often, and the KV tiers' round trip of
tests/test_torch_tier_seq_parallel.py against the reference on the same
mesh, with the restored pages bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import gemma as ref_gemma
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from xllm_service_tpu_torch.parallel.sharding import (
    ModelShardedPages,
    ShardedParams,
)

import test_torch_qwen2_vl
import test_torch_tier_seq_parallel as tier
from test_torch_chunked_prefill import step_until
from test_torch_gemma import drawn_tree, port_config
from test_torch_vl_engine import rows, submitter

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=512)
PROMPTS = (list(range(40, 75)), list(range(40, 72)) + [7, 9, 11, 13, 15])
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
IMG = 100
IMAGE = list(range(10, 22)) + [IMG] * 4 + list(range(30, 45))    # 31
CHUNKED = [(i * 7 + 3) % 400 + 20 for i in range(100)]


def _llama(**kw):
    return ref_tiny(dtype=jnp.float32, max_context_len=512, **kw)


FAMILIES = {
    "llama": lambda: _llama(),
    "qwen2": lambda: _llama(name="qwen2", qkv_bias=True,
                            rope_theta=1e6),
    "gemma2": lambda: ref_gemma.gemma2_tiny_config(dtype=jnp.float32),
    "llama_int8": lambda: _llama(quant="int8"),
    "qwen2_vl": lambda: ref_vl.tiny_vl_config(
        dtype=jnp.float32, max_context_len=512, image_token_id=IMG),
}
CASES = [("llama", dict(model=2)), ("qwen2", dict(model=2)),
         ("gemma2", dict(model=2)), ("llama_int8", dict(model=2)),
         ("qwen2_vl", dict(model=2)), ("llama", dict(data=2, model=2)),
         ("llama", dict(pipe=2))]


def cpu_mesh(**axes):
    cfg = MeshConfig(**axes)
    return build_mesh(cfg, ["cpu"] * cfg.num_devices())


def port_cfg(rcfg):
    if rcfg.name == "qwen2_vl":
        return test_torch_qwen2_vl.port_config(rcfg)
    return port_config(rcfg)


def requests_of(rcfg):
    """(prompt, visual rows) pairs a case serves."""
    if rcfg.name == "qwen2_vl":
        return [(IMAGE, rows(1, 4)), (PROMPTS[0], None), (PROMPTS[1], None)]
    return [(p, None) for p in PROMPTS]


def serve(engine, rcfg, ref):
    out = []
    for i, (prompt, mm) in enumerate(requests_of(rcfg)):
        col = submitter(engine, ref)(f"r{i}", prompt, 5, mm)
        step_until(engine, [col])
        out.append(col.tokens)
    return out


def engines(rcfg, tree, axes, **kw):
    """The reference and the port on the mesh of ``axes``."""
    ekw = {**ENGINE_KW, **kw}
    ref = RefEngine(RefConfig(model=rcfg, model_family=rcfg.name,
                              prefill_buckets=(32, 64, 128, 512),
                              mesh=RefMeshConfig(**axes), **ekw),
                    params=tree)
    port = InferenceEngine(
        EngineConfig(model=port_cfg(rcfg), model_family=rcfg.name, **ekw),
        device="cpu", params=params_from_jax(tree, device="cpu"),
        mesh=cpu_mesh(**axes))
    return ref, port


@pytest.fixture(scope="module")
def trees():
    return {name: drawn_tree(make()) for name, make in FAMILIES.items()}


@pytest.fixture(scope="module")
def unmeshed(trees):
    """The port's unmeshed tokens of every family."""
    out = {}
    for name, make in FAMILIES.items():
        rcfg = make()
        eng = InferenceEngine(
            EngineConfig(model=port_cfg(rcfg), model_family=rcfg.name,
                         **ENGINE_KW),
            device="cpu", params=params_from_jax(trees[name], device="cpu"))
        out[name] = serve(eng, rcfg, False)
        eng.stop()
    return out


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}-" + "x".join(f"{a}{k}" for a, k in ax.items())
                     for n, ax in CASES])
def served(request, trees, unmeshed):
    name, axes = request.param
    rcfg = FAMILIES[name]()
    ref, port = engines(rcfg, trees[name], axes)
    toks = {"ref": serve(ref, rcfg, True), "port": serve(port, rcfg, False),
            "single": unmeshed[name]}
    yield name, axes, rcfg, ref, port, toks
    ref.stop()
    port.stop()


def test_greedy_tokens_match_reference_and_unmeshed(served):
    name, axes, rcfg, _, port, toks = served
    assert toks["port"] == toks["ref"] == toks["single"], (name, axes)
    assert all(len(t) == 5 for t in toks["port"])
    assert port.stats()["prefix_hits"] == 1
    assert port.stats()["decode_route"] == "eager"
    assert port.stats()["mesh"] == {"data": 1, "expert": 1, "pipe": 1,
                                    "seq": 1, "model": 1, **axes}
    tp = axes.get("model", 1)
    if tp > 1:
        assert isinstance(port.params, ShardedParams)
        q = port.params.tree(0, 1)["layers"]["q_proj"]["kernel"]
        if name == "llama_int8":
            assert q["q8"].dtype == torch.int8
            assert q["scale"].shape[-1] == rcfg.num_heads * \
                rcfg.head_dim // tp
            q = q["q8"]
        assert q.shape[-1] == rcfg.num_heads * rcfg.head_dim // tp
    else:
        assert isinstance(port.params, dict)


def test_pool_matches_reference_pool(served):
    _, axes, rcfg, ref, port, _ = served
    tp = axes.get("model", 1)
    if tp > 1:
        assert isinstance(port.kv_pages, ModelShardedPages)
        assert not port.kv_pages.replicated
        assert port.kv_pages.shards[0].shape == (
            rcfg.num_layers, 2, 64, rcfg.num_kv_heads // tp, 16,
            rcfg.head_dim)
        got = port.kv_pages.full().numpy()
    else:
        got = port.kv_pages.numpy()
    want = np.asarray(ref._dstate["kv"])
    assert got.shape == want.shape
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], **POOL_TOL)


def test_chunked_prompt_on_model_axis(trees, unmeshed):
    """A 100-token prompt in chunks of 32 on ``model=2``: the port's
    tokens equal the reference's chunked engine's on the same mesh and the
    port's unmeshed chunked engine's, and the port's chunks ride decode
    steps as often as the reference's on the same mesh."""
    rcfg = FAMILIES["llama"]()
    ref, port = engines(rcfg, trees["llama"], dict(model=2),
                        prefill_chunk_tokens=32)
    single = InferenceEngine(
        EngineConfig(model=port_cfg(rcfg), prefill_chunk_tokens=32,
                     **ENGINE_KW),
        device="cpu", params=params_from_jax(trees["llama"], device="cpu"))
    got = []
    for eng, is_ref in ((ref, True), (port, False), (single, False)):
        cols = [submitter(eng, is_ref)("short", PROMPTS[0], 8),
                submitter(eng, is_ref)("long", CHUNKED, 5)]
        step_until(eng, cols)
        got.append([c.tokens for c in cols])
        eng.stop()
    assert got[0] == got[1] == got[2]
    assert port.sarathi_rides == ref.sarathi_rides > 0


@pytest.fixture(scope="module")
def tiers_served():
    kw = {**tier.ENGINE_KW, **tier.CASES["dram"]}
    rcfg = ref_tiny(dtype=jnp.float32, max_context_len=256)
    tree = jax.tree.map(np.asarray, tier.ref_llama.init_params(
        rcfg, jax.random.PRNGKey(0)))
    prompt_a, prompt_u = tier._prompts()
    ref = RefEngine(RefConfig(model=rcfg, prefill_buckets=(32, 64, 128, 256),
                              mesh=RefMeshConfig(model=2), **kw),
                    params=tree)
    port = InferenceEngine(
        EngineConfig(model=dataclasses.replace(port_config(rcfg),
                                               max_context_len=256), **kw),
        device="cpu", params=params_from_jax(tree, device="cpu"),
        mesh=cpu_mesh(model=2))
    try:
        yield (ref, port, tier._serve(ref, prompt_a, prompt_u),
               tier._serve(port, prompt_a, prompt_u))
    finally:
        port.stop()
        ref.stop()


def test_tier_round_trip_on_model_axis(tiers_served):
    """Evict a prompt's blocks into the DRAM tier and serve it again from
    there: the same tokens, events and tier stats as the reference's on
    ``model=2``; each block gathered and scattered once per shard, joined
    on the head axis in the reference's layout; the restored pages equal
    the ones gathered before the eviction bit for bit."""
    ref, port, ref_out, out = tiers_served
    assert isinstance(port.kv_pages, ModelShardedPages)
    assert out["tokens"] == ref_out["tokens"]
    assert out["tokens"][2] == out["tokens"][0]
    assert out["events"] == ref_out["events"]
    assert out["stats"] == ref_out["stats"]
    assert out["stats"]["onload_total"] == 2
    for want, got in zip(out["before"], out["after"]):
        assert got.shape == (2, 2, 2, 2, 16, 32)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    want = np.asarray(ref._dstate["kv"])
    np.testing.assert_allclose(port.kv_pages.full().numpy()[:, :, 1:],
                               want[:, :, 1:], **POOL_TOL)
