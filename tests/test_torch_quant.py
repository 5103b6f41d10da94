"""The port's weight-only int8 (``models/quant.py``) against the reference's
(mirrors tests/test_quant.py), on the CPU.

- ``quantize_kernel``: q8 bit-identical to the reference's (both divide in
  f32 and round half to even), scales within one f32 ulp;
- ``quantized_matmul`` within 1e-5 of ``quantized_einsum``;
- ``quantize_tree``: the projections only, one layer at a time, the
  reference's tree shapes;
- int8 forwards (llama, qwen2, Gemma-2) from the reference's quantized
  tree, logits within 1e-4 and the pool within 1e-5 in f32;
- the engine quantizes random or given weights as the reference's does,
  with greedy tokens identical to the JAX engine's;
- int8 weight-stream accounting.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import gemma as ref_gemma
from xllm_service_tpu.models import quant as ref_quant
from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
from xllm_service_tpu_torch.models import base, quant
from xllm_service_tpu_torch.models.base import ModelFamily
from xllm_service_tpu_torch.models.weights import params_from_jax

from test_torch_gemma import (
    ENGINE_KW,
    check_decode,
    check_mixed,
    check_prefill,
    drawn_tree,
    port_config,
    serve_both,
    traffic,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores


def _weights(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((64, 32), 0), ((3, 16, 8), 1),
                                        ((256, 128), 2)])
def test_quantize_kernel_matches_the_reference(shape, seed):
    w = _weights(shape, seed)
    w[..., 0, 0] = 0.0
    if len(shape) == 2:
        w[:, 1] = 0.0                       # an all-zero channel: the floor
    want = ref_quant.quantize_kernel(jnp.asarray(w))
    got = quant.quantize_kernel(torch.from_numpy(w))
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    ws, gs = np.asarray(want["scale"]), got["scale"].numpy()
    assert (np.abs(gs - ws) <= np.spacing(np.abs(ws))).all()


def test_bf16_kernels_quantize_as_the_reference():
    w = jnp.asarray(_weights((3, 48, 24), 3), jnp.bfloat16)
    want = ref_quant.quantize_kernel(w)
    got = quant.quantize_kernel(params_from_jax({"w": np.asarray(w)},
                                                device="cpu")["w"])
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=2e-7)


@pytest.mark.parametrize("lead", [(4,), (2, 5)])
def test_quantized_matmul_matches_quantized_einsum(lead):
    w = _weights((64, 32), 4)
    x = _weights((*lead, 64), 5)
    q_ref = ref_quant.quantize_kernel(jnp.asarray(w))
    want = ref_quant.quantized_einsum("...d,df->...f", jnp.asarray(x), q_ref)
    got = quant.quantized_matmul(torch.from_numpy(x),
                                 quant.quantize_kernel(torch.from_numpy(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # A plain kernel is a plain product.
    np.testing.assert_array_equal(
        quant.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w))
        .numpy(), (torch.from_numpy(x) @ torch.from_numpy(w)).numpy())


def test_scale_commutes_out_of_the_contraction():
    w = torch.from_numpy(_weights((64, 32), 6))
    x = torch.from_numpy(_weights((4, 64), 7))
    q = quant.quantize_kernel(w)
    w_dq = q["q8"].float() * q["scale"][None, :]
    torch.testing.assert_close(quant.quantized_matmul(x, q), x @ w_dq,
                               rtol=1e-5, atol=1e-5)
    rel = (quant.quantized_matmul(x, q) - x @ w).norm() / (x @ w).norm()
    assert rel < 0.01


def test_quantize_tree_matches_the_reference_tree():
    rcfg = ref_gemma.gemma2_tiny_config(dtype=jnp.float32, qkv_bias=True)
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
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(g, leaf)
    layers = got["layers"]
    assert quant.is_quantized(layers["down_proj"]["kernel"])
    assert not quant.is_quantized(layers["q_proj"]["bias"])
    assert isinstance(got["embed"]["embedding"], torch.Tensor)
    # Already quantized leaves pass through.
    again = quant.quantize_tree(got)
    assert again["layers"]["q_proj"]["kernel"]["q8"] is \
        layers["q_proj"]["kernel"]["q8"]


def _int8_models(rcfg):
    """The reference's int8 tree (quantize_tree of the drawn weights) on
    both sides."""
    rcfg = dataclasses.replace(rcfg, quant="int8")
    tree = jax.tree.map(np.asarray, ref_quant.quantize_tree(
        jax.tree.map(jnp.asarray, drawn_tree(rcfg))))
    return rcfg, tree, port_config(rcfg), params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module", params=["llama", "qwen2", "gemma2"])
def int8_models(request):
    if request.param == "gemma2":
        rcfg = ref_gemma.gemma2_tiny_config(dtype=jnp.float32)
    else:
        rcfg = ref_base.tiny_config(name=request.param, dtype=jnp.float32,
                                    qkv_bias=request.param == "qwen2")
    return _int8_models(rcfg)


def test_int8_prefill(int8_models):
    assert quant.is_quantized(int8_models[3]["layers"]["o_proj"]["kernel"])
    check_prefill(int8_models)


def test_int8_decode(int8_models):
    check_decode(int8_models)


def test_int8_mixed_step(int8_models):
    check_mixed(int8_models, 24, 12)


@pytest.mark.parametrize("make", [
    lambda: ref_base.tiny_config(dtype=jnp.float32, max_context_len=512),
    lambda: ref_gemma.gemma_tiny_config(dtype=jnp.float32,
                                        max_context_len=512),
])
def test_int8_engine_tokens_match_the_jax_engine(make):
    """Both engines get the same bf16-free f32 weights and quantize them
    themselves (``model.quant = "int8"``)."""
    rcfg = dataclasses.replace(make(), quant="int8")
    ref, port = serve_both(rcfg, drawn_tree(rcfg), traffic)
    assert port[0] == ref[0]


def test_engine_quantizes_random_weights():
    cfg = base.tiny_config(dtype=torch.float32, quant="int8")
    eng = InferenceEngine(EngineConfig(model=cfg, **ENGINE_KW), device="cpu")
    try:
        kern = eng.params["layers"]["gate_proj"]["kernel"]
        assert quant.is_quantized(kern) and kern["q8"].dtype == torch.int8
        assert quant.is_quantized(eng.params["lm_head"]["kernel"])
    finally:
        eng.stop()


def test_engine_refuses_int8_for_a_family_without_it(monkeypatch):
    from xllm_service_tpu_torch.models import llama

    monkeypatch.setitem(base._REGISTRY, "no_int8_test_family", ModelFamily(
        name="no_int8_test_family", init_params=llama.init_params,
        prefill_forward=llama.prefill_forward,
        decode_forward=llama.decode_forward))
    cfg = base.tiny_config(name="no_int8_test_family", dtype=torch.float32,
                           quant="int8")
    with pytest.raises(NotImplementedError, match="supports_int8"):
        InferenceEngine(EngineConfig(model=cfg, model_family=cfg.name,
                                     **ENGINE_KW), device="cpu")
    with pytest.raises(ValueError, match="unknown quant mode"):
        InferenceEngine(EngineConfig(
            model=base.tiny_config(dtype=torch.float32, quant="int4"),
            **ENGINE_KW), device="cpu")


def test_int8_weight_stream_bytes():
    """1 byte a projection weight; the norms and a tied head keep the
    model dtype. An untied llama config counts what the reference's
    accounting counts."""
    for name in ("llama3_8b_config", "bench_1b_config"):
        ref = dataclasses.replace(getattr(ref_base, name)(), quant="int8")
        port = dataclasses.replace(getattr(base, name)(), quant="int8")
        assert port.decode_weight_stream_bytes() == \
            ref.decode_weight_stream_bytes()
        full = getattr(base, name)().decode_weight_stream_bytes()
        assert port.decode_weight_stream_bytes() < 0.6 * full
    from xllm_service_tpu_torch.models.gemma import gemma2_9b_config

    g = gemma2_9b_config()
    D, L = g.hidden_size, g.num_layers
    proj = L * (D * g.q_size * 2 + 2 * D * g.kv_size + 3 * D * g.ffn_size)
    norms = (4 * L + 1) * D * 2
    head = g.vocab_size * D * 2
    assert g.decode_weight_stream_bytes() == 2 * proj + norms + head
    assert dataclasses.replace(g, quant="int8").decode_weight_stream_bytes() \
        == proj + norms + head
