"""The port's qwen2_vl family against the reference's, on the CPU.

The same numpy weights (the reference's ``init_params`` with every bias and
norm scale drawn non-zero, carried over by ``params_from_jax``) go through
``xllm_service_tpu.models.qwen2_vl`` and ``xllm_service_tpu_torch.models.
qwen2_vl``, in f32:

- ``encode_images`` within 1e-5 (embeddings of magnitude ~1; the same f32
  program in another summation order), with the window mask off and on;
- ``splice_mm_embeds`` exactly (a gather and a select);
- ``mrope_positions`` integer-exact over a sweep of image layouts;
- the VL prefill's logits within 1e-4 and the KV pool within 1e-5 (the
  tolerances of tests/test_torch_gemma.py), cold and behind a prefix;
- ``decode_forward`` with ``rope_positions`` within 1e-4;
- the configurations field by field and the family's registration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu_torch.models import llama, qwen2_vl
from xllm_service_tpu_torch.models.base import (
    ModelConfig,
    VisionConfig,
    get_model_family,
)
from xllm_service_tpu_torch.models.weights import params_from_jax

from test_torch_gemma import KV_TOL, TOL, drawn_tree

ENC_TOL = dict(rtol=1e-5, atol=1e-5)
P, PS = 48, 4
IMG = 100      # the placeholder id of the tiny configs here


def port_config(rcfg, dtype=torch.float32) -> ModelConfig:
    """The port's ModelConfig with every field of the reference's."""
    fields = {f.name: getattr(rcfg, f.name)
              for f in dataclasses.fields(ModelConfig)
              if f.name not in ("dtype", "vision")}
    vision = None
    if rcfg.vision is not None:
        vision = VisionConfig(**dataclasses.asdict(rcfg.vision))
    return ModelConfig(**fields, vision=vision, dtype=dtype)


def assert_configs_equal(port: ModelConfig, ref) -> None:
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "dtype":
            continue
        if f.name == "vision":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name


def wide_vision(**kw):
    """A 4 x 4 patch grid with a 2 x 2 merge and a temporal patch of 2, so
    the patchify, the merge and a window of 2 all have work."""
    return ref_base.VisionConfig(image_size=56, patch_size=14, hidden_size=64,
                                 num_layers=2, num_heads=4, out_tokens=4,
                                 temporal_patch_size=2, spatial_merge_size=2,
                                 **kw)


@pytest.fixture(scope="module")
def models():
    rcfg = ref_vl.tiny_vl_config(dtype=jnp.float32, image_token_id=IMG,
                                 vision=wide_vision())
    tree = drawn_tree(rcfg)
    return rcfg, tree, port_config(rcfg), params_from_jax(tree, device="cpu")


def test_configs_and_registration():
    for name in ("tiny_vl_config", "qwen2_vl_2b_config"):
        assert_configs_equal(getattr(qwen2_vl, name)(),
                             getattr(ref_vl, name)())
    big = qwen2_vl.qwen2_vl_2b_config()
    assert (big.num_heads // big.num_kv_heads, big.vision.out_tokens,
            sum(big.mrope_section)) == (6, 64, big.head_dim // 2)
    assert qwen2_vl.IMAGE_TOKEN_ID == ref_vl.IMAGE_TOKEN_ID
    fam = get_model_family("qwen2_vl")
    assert fam.decode_forward is llama.decode_forward
    # No verify and no mixed step: speculation and rides are off for VL.
    assert fam.verify_forward is None
    assert fam.mixed_decode_chunk_forward is None
    assert fam.embed_forward is None and not fam.supports_int8
    cfg = qwen2_vl.tiny_vl_config(dtype=torch.float32)
    params = fam.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_tree = jax.eval_shape(
        lambda k: ref_vl.init_params(ref_vl.tiny_vl_config(
            dtype=jnp.float32), k), jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_tree)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    bad = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, out_tokens=3))
    with pytest.raises(AssertionError, match="out_tokens"):
        fam.init_params(bad, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("window", [0, 2])
def test_encode_images(models, window):
    rcfg, tree, cfg, params = models
    if window:
        rcfg = dataclasses.replace(rcfg, vision=dataclasses.replace(
            rcfg.vision, window_size=window, fullatt_block_indexes=(1,)))
        cfg = port_config(rcfg)
    pixels = np.random.default_rng(3).uniform(
        size=(3, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jax.jit(ref_vl.encode_images, static_argnums=1)(
        tree, rcfg, jnp.asarray(pixels)))
    got = qwen2_vl.encode_images(params, cfg, torch.from_numpy(pixels))
    assert got.shape == (3, 4, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **ENC_TOL)


def test_window_index_and_vision_rope():
    for grid, win in ((4, 2), (6, 3), (8, 8)):
        np.testing.assert_array_equal(
            qwen2_vl._window_index(grid, win).numpy(),
            np.asarray(ref_vl._window_index(grid, win)))
    np.testing.assert_allclose(qwen2_vl._vision_rope(4, 16, 1e4).numpy(),
                               np.asarray(ref_vl._vision_rope(4, 16, 1e4)),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError, match="window_size"):
        qwen2_vl._window_index(4, 3)


def test_splice_mm_embeds(models):
    rcfg, tree, cfg, params = models
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, 90, size=(2, 14)).astype(np.int32)
    tokens[0, 2:6] = IMG
    tokens[1, 5:9] = IMG
    tokens[1, 11:13] = IMG          # a second, shorter run in row 1
    mm = rng.normal(size=(2, 6, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(ref_vl.splice_mm_embeds(tree, rcfg,
                                              jnp.asarray(tokens),
                                              jnp.asarray(mm)))
    got = qwen2_vl.splice_mm_embeds(params, cfg, torch.from_numpy(tokens),
                                    torch.from_numpy(mm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[1, 11], mm[1, 4])
    np.testing.assert_array_equal(
        qwen2_vl.splice_mm_embeds(params, cfg, torch.from_numpy(tokens),
                                  None).numpy(),
        np.asarray(ref_vl.splice_mm_embeds(tree, rcfg, jnp.asarray(tokens),
                                           None)))


MROPE_LAYOUTS = {
    "text": list(range(10, 20)),
    "one_grid": list(range(30, 34)) + [498] + [IMG] * 4 + [499]
    + list(range(40, 45)),
    "two_grids": [1, 2] + [IMG] * 4 + [3] + [IMG] * 9 + [4, 5, 6],
    "ragged": [7] + [IMG] * 5 + [8, 9],
    "image_first": [IMG] * 16 + [11, 12],
    "image_last": [11, 12, 13] + [IMG] * 64,
    "adjacent": [IMG] * 4 + [IMG] * 4,
    "single": [IMG],
}


@pytest.mark.parametrize("layout", sorted(MROPE_LAYOUTS))
def test_mrope_positions_are_the_references(layout):
    toks = MROPE_LAYOUTS[layout]
    got_pos, got_delta = qwen2_vl.mrope_positions(toks, IMG)
    want_pos, want_delta = ref_vl.mrope_positions(toks, IMG)
    assert got_pos.dtype == np.int32 and got_delta == want_delta
    np.testing.assert_array_equal(got_pos, want_pos)


def _prefill_both(models, kv, tokens, pos3, prefix, lens, pt, mm):
    rcfg, tree, cfg, params = models
    want, kv_ref = jax.jit(ref_vl.prefill_forward, static_argnums=1)(
        tree, rcfg, *(jnp.asarray(a) for a in (tokens, pos3, kv, pt, prefix,
                                               lens)),
        mm_embeds=None if mm is None else jnp.asarray(mm))
    tkv = torch.from_numpy(kv.copy())
    t = torch.from_numpy
    got, _ = qwen2_vl.prefill_forward(
        params, cfg, t(tokens), t(pos3), tkv, t(pt), t(prefix), t(lens),
        mm_embeds=None if mm is None else t(mm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tkv.numpy()[:, :, 1:],
                               np.asarray(kv_ref)[:, :, 1:], **KV_TOL)
    return np.asarray(kv_ref)


def test_vl_prefill_logits_and_pool(models):
    """Two image rows (one grid of 4 each, 19 and 14 valid tokens) cold,
    then a text suffix behind both, with its M-RoPE rows continuing past
    the grids (the decode delta)."""
    rcfg, tree, cfg, params = models
    rng = np.random.default_rng(5)
    rows = [[5, 6, 7] + [IMG] * 4 + list(rng.integers(3, 90, 12)),
            [9] + [IMG] * 4 + list(rng.integers(3, 90, 9))]
    S = 19
    tokens = np.zeros((2, S), np.int32)
    pos3 = np.zeros((2, S, 3), np.int32)
    deltas = []
    for b, r in enumerate(rows):
        tokens[b, :len(r)] = r
        p, d = ref_vl.mrope_positions(r, IMG)
        pos3[b, :len(r)] = p
        deltas.append(d)
    lens = np.asarray([len(r) for r in rows], np.int32)
    pt = np.arange(1, 1 + 2 * 12, dtype=np.int32).reshape(2, 12)
    pool = np.zeros((rcfg.num_layers, 2, P, rcfg.num_kv_heads, PS,
                     rcfg.head_dim), np.float32)
    mm = rng.normal(size=(2, 4, cfg.hidden_size)).astype(np.float32)
    kv = _prefill_both(models, pool, tokens, pos3, np.zeros((2,), np.int32),
                       lens, pt, mm)
    suffix = rng.integers(3, 90, size=(2, 5)).astype(np.int32)
    spos = (lens + np.asarray(deltas))[:, None] + np.arange(5)[None]
    _prefill_both(models, kv, suffix, np.repeat(spos[..., None], 3, -1)
                  .astype(np.int32), lens, np.asarray([5, 3], np.int32), pt,
                  None)


def test_decode_with_rope_positions(models):
    """Three rows decode three steps behind image prompts; the rope
    rotates at the sequence index plus each row's delta, the KV write
    stays at the index."""
    rcfg, tree, cfg, params = models
    rng = np.random.default_rng(6)
    kv = (rng.normal(size=(rcfg.num_layers, 2, P, rcfg.num_kv_heads, PS,
                           rcfg.head_dim)) * 0.3).astype(np.float32)
    pt = np.arange(1, 1 + 3 * 8, dtype=np.int32).reshape(3, 8)
    clens = np.asarray([18, 9, 25], np.int32)
    delta = np.asarray([-2, 0, -6], np.int32)
    last = np.asarray([5, 6, 7], np.int32)
    jkv, tkv = jnp.asarray(kv), torch.from_numpy(kv.copy())
    ref_dec = jax.jit(ref_base.get_model_family("qwen2_vl").decode_forward,
                      static_argnums=1)
    t = torch.from_numpy
    for _ in range(3):
        pos = clens - 1
        want, jkv = ref_dec(tree, rcfg, jnp.asarray(last), jnp.asarray(pos),
                            jkv, jnp.asarray(pt), jnp.asarray(clens),
                            rope_positions=jnp.asarray(pos + delta))
        got, _ = llama.decode_forward(
            params, cfg, t(last), t(pos), tkv, t(pt), t(clens),
            rope_positions=t(pos + delta))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tkv.numpy()[:, :, 1:],
                                   np.asarray(jkv)[:, :, 1:], **KV_TOL)
        last = np.array(jnp.argmax(want, axis=-1), np.int32)
        clens = clens + 1
    # Without rope_positions the step is the plain one (delta 0).
    plain, _ = llama.decode_forward(params, cfg, t(last), t(clens - 1),
                                       torch.from_numpy(kv.copy()), t(pt),
                                       t(clens))
    same, _ = llama.decode_forward(params, cfg, t(last), t(clens - 1),
                                      torch.from_numpy(kv.copy()), t(pt),
                                      t(clens), rope_positions=t(clens - 1))
    np.testing.assert_array_equal(plain.numpy(), same.numpy())
