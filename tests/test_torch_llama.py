"""The port's Llama forwards against the reference's on shared weights
(carried by ``llama_params_from_jax``), on the CPU in f32: prefill (cold
and against a cached prefix) and decode logits, and the updated KV pool.

Tolerance 1e-4 (absolute, on logits of magnitude ~1 and K/V of magnitude
~1): f32 through two layers, where the two frameworks differ only in
summation order and in the rope angles' cos/sin (~1e-6 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.models import llama
from xllm_service_tpu_torch.models.base import get_model_family, tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

TOL = dict(rtol=1e-4, atol=1e-4)
L, P, PS = 2, 24, 4
# The reference forwards, compiled once per shape (eager op-by-op dispatch
# of the JAX layers is what would dominate this file's time).
ref_prefill = jax.jit(ref_llama.prefill_forward, static_argnums=1)
ref_decode = jax.jit(ref_llama.decode_forward, static_argnums=1)


@pytest.fixture(scope="module")
def models():
    rcfg = ref_tiny(dtype=jnp.float32)
    tree = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                   device="cpu")
    return rcfg, tree, tiny_config(dtype=torch.float32), params


def _pool(rcfg):
    return np.zeros((L, 2, P, rcfg.num_kv_heads, PS, rcfg.head_dim),
                    np.float32)


def _prefill(models, kv, tokens, prefix, seq_lens, pt):
    rcfg, tree, cfg, params = models
    B, S = tokens.shape
    pos = prefix[:, None] + np.arange(S, dtype=np.int32)[None]
    want, kv_ref = ref_prefill(
        tree, rcfg, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(kv),
        jnp.asarray(pt), jnp.asarray(prefix), jnp.asarray(seq_lens))
    tkv = torch.from_numpy(kv.copy())
    got, kv_out = llama.prefill_forward(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(pos), tkv,
        torch.from_numpy(pt), torch.from_numpy(prefix),
        torch.from_numpy(seq_lens))
    assert kv_out is tkv                       # updated in place
    return got.numpy(), np.asarray(want), tkv.numpy(), np.asarray(kv_ref)


def test_weight_bridge_layout(models):
    rcfg, tree, cfg, params = models
    q = params["layers"]["q_proj"]["kernel"]
    assert q.shape == (rcfg.num_layers, rcfg.hidden_size, rcfg.q_size)
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(tree["layers"]["q_proj"]["kernel"]))
    # bf16 leaves come out of numpy as ml_dtypes.bfloat16: carried bit-exact.
    bf = llama_params_from_jax(
        {"w": np.asarray(jnp.asarray([1.5, -3.25, 1e-3], jnp.bfloat16))},
        device="cpu")["w"]
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  np.asarray([1.5, -3.25, 1e-3], np.float32)
                                  .astype(jnp.bfloat16).astype(np.float32))
    assert get_model_family("llama").prefill_forward is llama.prefill_forward


def test_prefill_cold_and_with_cached_prefix(models):
    rcfg = models[0]
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, 500, size=(2, 12)).astype(np.int32)
    pt = np.arange(1, 1 + 2 * 8, dtype=np.int32).reshape(2, 8)
    zero = np.zeros((2,), np.int32)
    lens = np.asarray([12, 9], np.int32)
    got, want, kv, kv_ref = _prefill(models, _pool(rcfg), tokens, zero,
                                     lens, pt)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(kv[:, :, 1:], kv_ref[:, :, 1:], **TOL)

    # Second call: a suffix behind the 12/9 cached tokens of each row.
    suffix = rng.integers(3, 500, size=(2, 5)).astype(np.int32)
    got2, want2, kv2, kv_ref2 = _prefill(models, kv_ref, suffix, lens,
                                         np.asarray([5, 3], np.int32), pt)
    np.testing.assert_allclose(got2, want2, **TOL)
    np.testing.assert_allclose(kv2[:, :, 1:], kv_ref2[:, :, 1:], **TOL)


def test_decode_steps(models):
    rcfg, tree, cfg, params = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(3, 500, size=(3, 10)).astype(np.int32)
    pt = np.arange(1, 1 + 3 * 6, dtype=np.int32).reshape(3, 6)
    lens = np.asarray([10, 7, 4], np.int32)
    _, _, kv, kv_ref = _prefill(models, _pool(rcfg), tokens,
                                np.zeros((3,), np.int32), lens, pt)
    jkv, tkv = jnp.asarray(kv_ref), torch.from_numpy(kv_ref.copy())
    last = np.asarray([5, 6, 7], np.int32)
    clens = lens + 1
    for _ in range(3):
        want, jkv = ref_decode(
            tree, rcfg, jnp.asarray(last), jnp.asarray(clens - 1), jkv,
            jnp.asarray(pt), jnp.asarray(clens))
        got, _ = llama.decode_forward(
            params, cfg, torch.from_numpy(last), torch.from_numpy(clens - 1),
            tkv, torch.from_numpy(pt), torch.from_numpy(clens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tkv.numpy()[:, :, 1:],
                                   np.asarray(jkv)[:, :, 1:], **TOL)
        last = np.array(jnp.argmax(want, axis=-1), np.int32)
        clens = clens + 1


def test_init_params_shapes_and_seed():
    cfg = tiny_config(dtype=torch.float32)
    a = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert a["layers"]["down_proj"]["kernel"].shape == (2, 256, 128)
    assert a["lm_head"]["kernel"].shape == (128, 512)
    assert torch.equal(a["layers"]["up_proj"]["kernel"],
                       b["layers"]["up_proj"]["kernel"])
    assert not torch.equal(a["layers"]["up_proj"]["kernel"][0],
                           a["layers"]["up_proj"]["kernel"][1])


def test_out_of_vocabulary_ids_take_the_reference_rows(models):
    """The reference's ``embedding[tokens]`` clamps an id past the
    vocabulary to the last row and wraps a negative one; the port's
    lookup does the same instead of raising."""
    rcfg = models[0]
    V = rcfg.vocab_size
    tokens = np.array([[5, V, V + 77, -1, -V, 9]], np.int32)
    seq = np.array([6], np.int32)
    pt = np.arange(1, 3, dtype=np.int32)[None]
    got, want, kv, kv_ref = _prefill(models, _pool(rcfg), tokens,
                                     np.zeros(1, np.int32), seq, pt)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(kv, kv_ref, **TOL)
