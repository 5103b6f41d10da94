"""The port's mixtral family against the reference's, on the CPU (mirrors
tests/test_mixtral.py; its expert-sharded case is in
tests/test_torch_ep_engine.py).

``mixtral_tiny_config`` (GQA 4/2, every layer MoE, no shared expert) on the
reference's weights, norm scales drawn non-zero: prefill, decode (also
under ``XLLM_KV_WRITEBACK=fused``), verify and embed logits within 1e-4
and the pool within 1e-5 in f32, plain and int8; greedy engine tokens
identical to the JAX engine's, plain, with ``speculate_k=4`` and in int8;
the agent's ``mixtral_tiny`` and ``mixtral_8x7b`` configs.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu_torch.engine.agent import _parser, engine_config
from xllm_service_tpu_torch.models import deepseek_moe, mixtral
from xllm_service_tpu_torch.models.base import get_model_family

from test_torch_gemma import (
    check_decode,
    check_embed,
    check_prefill,
    check_verify,
)
from test_torch_moe import (
    check_quantize_tree,
    check_streamed_int8_build,
    engine_checks,
    moe_models,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores


@pytest.fixture(scope="module")
def models():
    return moe_models(ref_mixtral.mixtral_tiny_config(dtype=jnp.float32))


@pytest.mark.parametrize("name", ["mixtral_8x7b_config",
                                  "mixtral_tiny_config"])
def test_configs_match_the_reference(name):
    ref, port = getattr(ref_mixtral, name)(), getattr(mixtral, name)()
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_registration_and_layout(models):
    _, _, cfg, params = models
    fam = get_model_family("mixtral")
    assert fam.prefill_forward is deepseek_moe.prefill_forward
    assert fam.supports_int8 and fam.mixed_decode_chunk_forward is None
    assert "shared" not in params["moe"] and "dense_mlp" not in params
    assert params["moe"]["experts"]["gate_proj"]["kernel"].shape[1] == \
        cfg.num_experts
    mine = mixtral.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "shared" not in mine["moe"] and "k_proj" in mine["layers"]


def test_weight_stream_bytes():
    for q in ("", "int8"):
        ref = dataclasses.replace(ref_mixtral.mixtral_8x7b_config(), quant=q)
        port = dataclasses.replace(mixtral.mixtral_8x7b_config(), quant=q)
        assert port.decode_weight_stream_bytes() == \
            ref.decode_weight_stream_bytes()


def test_prefill_cold_and_behind_a_cached_prefix(models):
    check_prefill(models)


def test_decode_steps(models):
    check_decode(models)


def test_decode_steps_fused_writeback(models, monkeypatch):
    monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    check_decode(models)


def test_verify_forward(models):
    check_verify(models)


def test_embed_forward(models):
    check_embed(models)


def test_int8_forwards():
    m = moe_models(ref_mixtral.mixtral_tiny_config(dtype=jnp.float32),
                   quantized=True)
    check_prefill(m)
    check_decode(m)
    check_verify(m)


def test_quantize_tree_matches_the_reference_tree():
    check_quantize_tree(ref_mixtral.mixtral_tiny_config(dtype=jnp.float32))


def test_streamed_int8_build_equals_build_then_quantize():
    check_streamed_int8_build(mixtral.mixtral_tiny_config())


@pytest.mark.parametrize("variant", ["plain", "spec", "int8"])
def test_engine_tokens_match_the_jax_engine(variant):
    engine_checks(ref_mixtral.mixtral_tiny_config(dtype=jnp.float32),
                  variant)


@pytest.mark.parametrize("name", ["mixtral_tiny", "mixtral_8x7b"])
def test_agent_model_configs(name):
    """``--model-config mixtral_tiny|mixtral_8x7b --quant int8``, as the
    reference agent takes them."""
    ecfg = engine_config(_parser().parse_args(
        ["--model-config", name, "--quant", "int8"]))
    want = getattr(mixtral, f"{name}_config")()
    assert ecfg.model == dataclasses.replace(want, quant="int8")
    assert ecfg.model_family == "mixtral"
