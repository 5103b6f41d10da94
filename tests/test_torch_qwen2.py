"""The port's qwen2 family against the reference's, on the CPU.

A tiny qwen2 (the llama body with qkv biases, drawn non-zero so a bias
fault shows) through the JAX forwards and the port's on the same numpy
weights: prefill, decode, verify, embed and mixed-step logits within 1e-4
and the KV pool within 1e-5 in f32 (tests/test_torch_gemma.py's helpers
and tolerances), greedy engine tokens identical, and the M-RoPE section
path of a prefill (positions [B, S, 3]) against the reference's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import qwen2 as ref_qwen2
from xllm_service_tpu_torch.models import llama, qwen2
from xllm_service_tpu_torch.models.base import get_model_family

from test_torch_gemma import (
    KV_TOL,
    TOL,
    _pool,
    check_decode,
    check_embed,
    check_mixed,
    check_prefill,
    check_verify,
    drawn_tree,
    make_models,
    ref_fn,
    serve_both,
    traffic,
)


def tiny_qwen2(**kw):
    return ref_base.tiny_config(name="qwen2", dtype=jnp.float32,
                                qkv_bias=True, **kw)


@pytest.fixture(scope="module")
def models():
    return make_models(tiny_qwen2())


def test_configs_and_registration():
    for name in ("qwen2_7b_config", "qwen2_72b_config"):
        ref, port = getattr(ref_qwen2, name)(), getattr(qwen2, name)()
        for f in dataclasses.fields(port):
            if f.name != "dtype":
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
    fam = get_model_family("qwen2")
    for alias in ("qwen2.5", "qwen"):
        # The aliases only import the module, in the reference as here:
        # the family is registered as "qwen2".
        for get in (ref_base.get_model_family, get_model_family):
            with pytest.raises(ValueError, match="unknown model family"):
                get(alias)
    assert fam.decode_forward is llama.decode_forward and fam.supports_int8
    cfg = qwen2.qwen2_7b_config()
    assert cfg.num_heads // cfg.num_kv_heads == 7        # kernel 2's walk
    params = fam.init_params(dataclasses.replace(cfg, num_layers=1,
                                                 vocab_size=64,
                                                 hidden_size=64,
                                                 num_heads=7,
                                                 num_kv_heads=1,
                                                 head_dim=16, ffn_size=32),
                             torch.Generator().manual_seed(0), "cpu")
    assert params["layers"]["q_proj"]["bias"].shape == (1, 7 * 16)
    assert (params["layers"]["v_proj"]["bias"] == 0).all()


def test_prefill_cold_and_behind_a_cached_prefix(models):
    check_prefill(models)


def test_decode_steps(models):
    check_decode(models)


def test_verify_forward(models):
    check_verify(models)


def test_embed_forward(models):
    check_embed(models)


@pytest.mark.parametrize("start,valid", [(24, 12), (0, 16)])
def test_mixed_step(models, start, valid):
    check_mixed(models, start, valid)


def test_the_bias_moves_the_logits(models):
    """The drawn biases matter: zeroing them moves the logits."""
    rcfg, tree, cfg, params = models
    zeroed = {**params, "layers": {
        k: ({**v, "bias": torch.zeros_like(v["bias"])} if "bias" in v else v)
        for k, v in params["layers"].items()}}
    tokens = torch.arange(3, 15, dtype=torch.int32)[None]
    lens = torch.tensor([12], dtype=torch.int32)
    a = llama.embed_forward(params, cfg, tokens, lens)
    b = llama.embed_forward(zeroed, cfg, tokens, lens)
    assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("chunk", [0, 32])
def test_engine_greedy_tokens_match_the_jax_engine(chunk):
    rcfg = tiny_qwen2(max_context_len=512)
    ref, port = serve_both(rcfg, drawn_tree(rcfg), traffic,
                           prefill_chunk_tokens=chunk)
    assert port[1] >= 1
    assert port[0] == ref[0]


def test_mrope_prefill_matches_the_reference():
    """Positions with a trailing axis of three streams (temporal, h, w)
    rotate each half-dim section by its own stream; distinct streams give
    other logits than 1-D positions, and the port's are the reference's.
    """
    rcfg = tiny_qwen2(mrope_section=(4, 6, 6))
    m = make_models(rcfg)
    _, tree, cfg, params = m
    rng = np.random.default_rng(9)
    B, S = 2, 11
    tokens = rng.integers(3, 500, size=(B, S)).astype(np.int32)
    pos = np.stack([np.arange(S), np.arange(S) // 2 + 3,
                    np.arange(S) % 4 + 5], -1)[None].repeat(B, 0).astype(
        np.int32)
    pt = np.arange(1, 1 + B * 4, dtype=np.int32).reshape(B, 4)
    zero, lens = np.zeros((B,), np.int32), np.asarray([S, 7], np.int32)
    kv = _pool(rcfg)
    want, kv_ref = ref_fn(rcfg, "prefill_forward")(
        tree, rcfg, *(jnp.asarray(a) for a in (tokens, pos, kv, pt, zero,
                                               lens)))
    tkv = torch.from_numpy(kv.copy())
    t = torch.from_numpy
    got, _ = llama.prefill_forward(params, cfg, t(tokens), t(pos), tkv,
                                   t(pt), t(zero), t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tkv.numpy()[:, :, 1:],
                               np.asarray(kv_ref)[:, :, 1:], **KV_TOL)
    flat, _ = llama.prefill_forward(params, cfg, t(tokens),
                                    t(np.ascontiguousarray(pos[..., 0])),
                                    torch.from_numpy(kv.copy()), t(pt),
                                    t(zero), t(lens))
    assert (flat - got).abs().max() > 1e-3
