"""The port's deepseek_moe family (routed and shared experts, GQA) against
the reference's, on the CPU (mirrors tests/test_models_extra.py's
TestDeepSeekMoE and TestMoeSpecAndEmbed, and tests/test_quant.py's
TestQuantMoE).

The same numpy weights (the reference's ``init_params``, norm scales drawn
non-zero) go through the JAX forwards and the port's, in f32, at
``tiny_moe_config`` (every layer MoE, one shared expert) and at a variant
with a leading dense layer (the ``dense_mlp`` subtree). Tolerances, as in
tests/test_torch_gemma.py: logits 1e-4, the KV pool 1e-5; ``_moe_mlp``
alone 1e-5 (one layer of f32 in another summation order); greedy engine
tokens identical, plain, with ``speculate_k=4`` and in int8. The int8
trees: ``quantize_tree`` equal to the reference's bit for bit (q8 and
scales), and the port's streamed int8 build equal to build-then-quantize
bit for bit.

``moe_models``, ``engine_checks`` and the ``check_*`` helpers are shared
with test_torch_mla.py and test_torch_mixtral.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu.models import quant as ref_quant
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.models import base, deepseek_moe, quant
from xllm_service_tpu_torch.models.base import get_model_family
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

from test_torch_gemma import (
    ENGINE_KW,
    check_decode,
    check_embed,
    check_prefill,
    check_verify,
    drawn_tree,
    port_config,
    serve_both,
    traffic,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

MLP_TOL = dict(rtol=1e-5, atol=1e-5)


def moe_models(rcfg, seed=0, quantized=False):
    """(reference config, numpy tree, port config, port params); with
    ``quantized`` the reference's int8 tree (``quantize_tree`` of the
    drawn weights) on both sides."""
    tree = drawn_tree(rcfg, seed)
    if quantized:
        rcfg = dataclasses.replace(rcfg, quant="int8")
        tree = jax.tree.map(np.asarray, ref_quant.quantize_tree(
            jax.tree.map(jnp.asarray, tree)))
    return rcfg, tree, port_config(rcfg), params_from_jax(tree,
                                                          device="cpu")


def assert_trees_bit_equal(got: dict, want: dict, path=""):
    """Same keys, shapes, dtypes and bits (torch trees)."""
    assert got.keys() == want.keys(), path
    for k in got:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            assert_trees_bit_equal(g, w, f"{path}/{k}")
        else:
            assert g.dtype == w.dtype and g.shape == w.shape and \
                torch.equal(g, w), f"{path}/{k}"


def check_quantize_tree(rcfg):
    """``quantize_tree`` on the drawn tree against the reference's: the
    same leaves quantized, q8 and scales bit for bit."""
    tree = drawn_tree(rcfg)
    want = jax.tree.map(np.asarray, ref_quant.quantize_tree(
        jax.tree.map(jnp.asarray, tree)))
    got = quant.quantize_tree(params_from_jax(tree, device="cpu"))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got)))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        g = flat_g[path]
        assert g.shape == leaf.shape and g.dtype == leaf.dtype, path
        np.testing.assert_array_equal(g, leaf, err_msg=str(path))
    return got


def check_streamed_int8_build(cfg):
    """The port's int8 init (one layer of one leaf at a time) equals
    ``quantize_tree`` of its bf16-mode init from the same seed."""
    fam = get_model_family(cfg.name)
    plain = fam.init_params(dataclasses.replace(cfg, quant=""),
                            torch.Generator().manual_seed(5), "cpu")
    streamed = fam.init_params(dataclasses.replace(cfg, quant="int8"),
                               torch.Generator().manual_seed(5), "cpu")
    assert_trees_bit_equal(streamed, quant.quantize_tree(plain))
    assert quant.is_quantized(streamed["moe"]["experts"]["up_proj"]["kernel"])
    assert streamed["moe"]["router"]["kernel"].dtype == torch.float32


def repetitive(eng, submit):
    """Greedy requests on repetitive prompts (the reference's MoE spec
    case): drafts get proposed and accepted."""
    from test_torch_chunked_prefill import step_until

    cols = [submit("r0", [5, 6, 7, 8] * 8, 16),
            submit("r1", [9, 10, 11] * 9, 12)]
    step_until(eng, cols)
    return [c.tokens for c in cols], getattr(eng, "prefix_hits", None)


def engine_checks(rcfg, variant):
    """Greedy tokens of the port's engine against the JAX engine's on the
    same weights: ``plain`` (the shared-prefix traffic), ``spec``
    (``speculate_k=4`` on repetitive prompts, also equal to the port's
    plain run, the spec path taken) or ``int8`` (both engines quantize)."""
    tree = drawn_tree(rcfg)
    if variant == "int8":
        rcfg = dataclasses.replace(rcfg, quant="int8")
    if variant == "spec":
        calls = {"n": 0}

        def spied(eng, submit):
            if isinstance(eng, InferenceEngine):
                real = eng._spec_multi

                def counted(*a):
                    calls["n"] += 1
                    return real(*a)

                eng._spec_multi = counted
            return repetitive(eng, submit)

        ref, port = serve_both(rcfg, tree, spied, speculate_k=4)
        _, plain = serve_both(rcfg, tree, repetitive)
        assert port[0] == plain[0]
        assert calls["n"] > 0
    else:
        ref, port = serve_both(rcfg, tree, traffic)
        assert port[1] >= 1                     # the prefix hit
    assert all(len(t) for t in port[0])
    assert port[0] == ref[0]


# ----------------------------------------------------------------- tests
@pytest.fixture(scope="module", params=["moe", "moe_dense1"])
def models(request):
    if request.param == "moe":
        rcfg = ref_ds.tiny_moe_config(dtype=jnp.float32)
    else:
        rcfg = ref_ds.tiny_moe_config(dtype=jnp.float32, num_layers=3,
                                      first_dense_layers=1)
    return moe_models(rcfg)


@pytest.mark.parametrize("name", ["deepseek_v2_lite_config",
                                  "bench_moe_config", "tiny_moe_config",
                                  "tiny_mla_config"])
def test_configs_match_the_reference(name):
    ref, port = getattr(ref_ds, name)(), getattr(deepseek_moe, name)()
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_model_config_defaults_are_the_reference():
    """Every field the port has, at its default, is the reference's
    default (first_dense_layers=1, num_experts_per_token=2 among them)."""
    ref, port = ref_base.ModelConfig(), base.ModelConfig()
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.first_dense_layers == 1


def test_registration():
    fam = get_model_family("deepseek_moe")
    assert fam.supports_int8 and fam.verify_forward is not None
    assert fam.embed_forward is not None
    assert fam.mixed_decode_chunk_forward is None
    # "deepseek" only imports the module, in the reference as here.
    for get in (ref_base.get_model_family, get_model_family):
        with pytest.raises(ValueError, match="unknown model family"):
            get("deepseek")


@pytest.mark.parametrize("name,quant_mode", [
    ("deepseek_v2_lite_config", ""), ("deepseek_v2_lite_config", "int8"),
    ("bench_moe_config", ""), ("bench_moe_config", "int8"),
    ("tiny_mla_config", "int8")])
def test_weight_stream_and_kv_bytes(name, quant_mode):
    """The MLA and MoE branches of the streamed-bytes count, as the
    reference's (bf16 weights: 2 bytes, as its)."""
    ref = dataclasses.replace(getattr(ref_ds, name)(), quant=quant_mode)
    port = dataclasses.replace(getattr(deepseek_moe, name)(),
                               quant=quant_mode)
    assert port.decode_weight_stream_bytes() == \
        ref.decode_weight_stream_bytes()
    assert port.kv_bytes_per_token(512) == ref.kv_bytes_per_token(512)


@pytest.mark.parametrize("shared", [1, 0])
@pytest.mark.parametrize("quantized", [False, True])
def test_moe_mlp_matches_the_reference(shared, quantized):
    rcfg = ref_ds.tiny_moe_config(dtype=jnp.float32,
                                  num_shared_experts=shared)
    _, tree, cfg, params = moe_models(rcfg, seed=1, quantized=quantized)
    x = np.random.default_rng(2).normal(
        size=(3, 5, rcfg.hidden_size)).astype(np.float32)
    for l in range(rcfg.num_layers):
        lp = jax.tree.map(lambda a, _l=l: jnp.asarray(a[_l]), tree["moe"])
        want = ref_ds._moe_mlp(lp, jnp.asarray(x), rcfg)
        got = deepseek_moe._moe_mlp(deepseek_moe._at(params["moe"], l),
                                    torch.from_numpy(x), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MLP_TOL)
    assert ("shared" in params["moe"]) == bool(shared)


def test_router_gates_only_the_top_k():
    """Each token's gate map has k non-zero entries summing to 1 (the
    softmax over the selected logits), and the layer's output is finite."""
    rcfg = ref_ds.tiny_moe_config(dtype=jnp.float32)
    _, _, cfg, params = moe_models(rcfg)
    mp = deepseek_moe._at(params["moe"], 0)
    x = torch.randn(5, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(3))
    logits = x @ mp["router"]["kernel"]
    topv, topi = torch.topk(logits, cfg.num_experts_per_token, dim=-1)
    gates = torch.zeros_like(logits).scatter_(1, topi,
                                              torch.softmax(topv, dim=-1))
    assert ((gates > 0).sum(dim=-1) == 2).all()
    torch.testing.assert_close(gates.sum(dim=-1), torch.ones(5))
    out = deepseek_moe._moe_mlp(mp, x, cfg)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_prefill_cold_and_behind_a_cached_prefix(models):
    check_prefill(models)


def test_decode_steps(models):
    check_decode(models)


def test_verify_forward(models):
    check_verify(models)


def test_embed_forward(models):
    check_embed(models)


def test_embed_ignores_padding():
    """tests/test_models_extra.py::test_moe_embed_forward: the pooled
    vector does not see the padding."""
    _, _, cfg, params = moe_models(ref_ds.tiny_moe_config(dtype=jnp.float32))
    fam = get_model_family("deepseek_moe")
    lens = torch.tensor([3, 2], dtype=torch.int32)
    a = fam.embed_forward(params, cfg, torch.tensor(
        [[5, 6, 7, 0], [9, 10, 0, 0]], dtype=torch.int32), lens)
    b = fam.embed_forward(params, cfg, torch.tensor(
        [[5, 6, 7, 99], [9, 10, 42, 77]], dtype=torch.int32), lens)
    assert a.shape == (2, cfg.hidden_size)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dense1", [False, True])
def test_int8_forwards(dense1):
    kw = dict(num_layers=3, first_dense_layers=1) if dense1 else {}
    m = moe_models(ref_ds.tiny_moe_config(dtype=jnp.float32, **kw),
                   quantized=True)
    assert quant.is_quantized(
        m[3]["moe"]["experts"]["down_proj"]["kernel"])
    check_prefill(m)
    check_decode(m)


def test_quantize_tree_matches_the_reference_tree():
    got = check_quantize_tree(ref_ds.tiny_moe_config(
        dtype=jnp.float32, num_layers=3, first_dense_layers=1))
    assert not quant.is_quantized(got["moe"]["router"]["kernel"])
    assert quant.is_quantized(got["dense_mlp"]["up_proj"]["kernel"])
    assert quant.is_quantized(got["moe"]["shared"]["gate_proj"]["kernel"])


@pytest.mark.parametrize("kw", [{}, dict(num_layers=3,
                                         first_dense_layers=1)])
def test_streamed_int8_build_equals_build_then_quantize(kw):
    check_streamed_int8_build(deepseek_moe.tiny_moe_config(
        dtype=torch.bfloat16, **kw))


def test_init_layout_is_the_references():
    """The port's random tree has the reference's keys, shapes and
    dtypes (the router f32, the rest the model dtype)."""
    for kw in ({}, dict(num_layers=3, first_dense_layers=1),
               dict(num_shared_experts=0)):
        rcfg = ref_ds.tiny_moe_config(dtype=jnp.bfloat16, **kw)
        want = jax.tree.map(np.asarray, ref_ds.init_params(
            rcfg, jax.random.PRNGKey(0)))
        got = deepseek_moe.init_params(port_config(rcfg, torch.bfloat16),
                                       torch.Generator().manual_seed(0),
                                       "cpu")
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            g = flat_g[path]
            assert tuple(g.shape) == leaf.shape, path
            assert str(g.dtype).rsplit(".", 1)[-1] == leaf.dtype.name, path


def test_params_from_jax_carries_the_moe_trees():
    """The f32 router, the int8 {q8, scale} leaves and the dense_mlp and
    shared subtrees cross with their dtypes and bits."""
    rcfg = ref_ds.tiny_moe_config(dtype=jnp.bfloat16, num_layers=3,
                                  first_dense_layers=1, quant="int8")
    tree = jax.tree.map(np.asarray, ref_quant.quantize_tree(
        ref_ds.init_params(rcfg, jax.random.PRNGKey(0))))
    got = params_from_jax(tree, device="cpu")
    assert got["moe"]["router"]["kernel"].dtype == torch.float32
    ex = got["moe"]["experts"]["gate_proj"]["kernel"]
    assert ex["q8"].dtype == torch.int8 and ex["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        ex["q8"].numpy(), tree["moe"]["experts"]["gate_proj"]["kernel"]["q8"])
    assert got["dense_mlp"]["down_proj"]["kernel"]["q8"].shape[0] == 1
    norm = got["layers"]["input_norm"]["scale"]
    assert norm.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        norm.view(torch.int16).numpy(),
        tree["layers"]["input_norm"]["scale"].view(np.int16))
    assert "shared" in got["moe"]


@pytest.mark.parametrize("variant", ["plain", "spec", "int8"])
def test_engine_tokens_match_the_jax_engine(variant):
    engine_checks(ref_ds.tiny_moe_config(dtype=jnp.float32,
                                         max_context_len=512), variant)


def test_chunks_never_ride_for_the_moe_families():
    """No mixed step: with chunked prefill on, every chunk is standalone
    (no ride), and the tokens equal the whole installs'."""
    from test_torch_chunked_prefill import Collector, step_until

    cfg = deepseek_moe.tiny_moe_config(dtype=torch.float32)
    out = []
    for chunk in (0, 16):
        eng = InferenceEngine(EngineConfig(
            model=cfg, model_family=cfg.name, prefill_chunk_tokens=chunk,
            **ENGINE_KW), device="cpu")
        try:
            cols = [Collector(), Collector()]
            eng.submit(EngineRequest("a", token_ids=list(range(3, 20)),
                                     sampling=SamplingParams(
                                         max_tokens=24, temperature=0.0,
                                         ignore_eos=True),
                                     on_output=cols[0]))
            step_until(eng, cols[:1])
            eng.submit(EngineRequest("b", token_ids=list(range(30, 100)),
                                     sampling=SamplingParams(
                                         max_tokens=8, temperature=0.0,
                                         ignore_eos=True),
                                     on_output=cols[1]))
            step_until(eng, cols)
            assert eng.sarathi_rides == 0
            out.append([c.tokens for c in cols])
        finally:
            eng.stop()
    assert out[0] == out[1] and len(out[0][1]) == 8


def test_seq_mesh_is_refused():
    """A seq mesh is not refused for the MoE families: the engine builds a
    ``ShardedPages`` pool of the family's width (GQA heads, MLA's one
    latent head) split by page range over the axis, as the reference
    serves them on one (test_torch_moe_seq_parallel.py holds the tokens
    and pools to it)."""
    from xllm_service_tpu_torch.models import mixtral
    from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages

    for cfg in (deepseek_moe.tiny_moe_config(dtype=torch.float32),
                deepseek_moe.tiny_mla_config(dtype=torch.float32),
                mixtral.mixtral_tiny_config(dtype=torch.float32)):
        eng = InferenceEngine(EngineConfig(model=cfg, model_family=cfg.name,
                                           **ENGINE_KW), device="cpu",
                              mesh=build_mesh(MeshConfig(seq=2),
                                              ["cpu"] * 2))
        try:
            assert eng.seq_parallel == 2
            assert isinstance(eng.kv_pages, ShardedPages)
            P = ENGINE_KW["num_pages"]
            want = (cfg.num_layers, 2, P // 2, cfg.num_kv_heads,
                    ENGINE_KW["page_size"], cfg.head_dim)
            assert [tuple(s.shape) for s in eng.kv_pages.shards] == \
                [want, want], cfg
            assert tuple(eng.kv_pages.shape) == (*want[:2], P, *want[3:])
        finally:
            eng.stop()
