"""The port's gemma family (Gemma-1 and Gemma-2) against the reference's,
on the CPU (mirrors tests/test_gemma.py).

The same numpy weights go through the JAX forwards (XLA on the CPU) and the
port's, for ``gemma_tiny_config`` and ``gemma2_tiny_config`` (window 8 on
its even layers, so contexts of 13-40 tokens see keys both inside and
outside the window), with every norm scale drawn non-zero: a (1 + w) or
sandwich-norm fault would move the logits by their scale.

Tolerances, f32: logits 1e-4 (magnitude ~1 under the final softcap of 30,
two to four layers of f32 in another summation order) and the KV pool
1e-5 (projections of normed rows, ~1e-6 apart). bf16: the two frameworks
round at different points of the same bf16 program, so the prefill logits
agree within 5% of max |logit| (measured 0.5% and 1.0% for the two
configs; a masking or norm fault moves them by their whole scale). Greedy engine tokens must be identical.

``models`` and the ``check_*`` helpers are shared with test_torch_qwen2.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import gemma as ref_gemma
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models import gemma, llama
from xllm_service_tpu_torch.models.base import get_model_family
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
P, PS = 48, 4
GREEDY = dict(temperature=0.0, ignore_eos=True)


def port_config(rcfg, dtype=torch.float32):
    """The port's ModelConfig with the reference config's fields."""
    names = {f.name for f in dataclasses.fields(gemma.gemma_tiny_config())}
    fields = {f.name: getattr(rcfg, f.name)
              for f in dataclasses.fields(type(rcfg))
              if f.name in names and f.name != "dtype"}
    return dataclasses.replace(gemma.gemma_tiny_config(), **fields,
                               dtype=dtype)


def drawn_tree(rcfg, seed=0):
    """The reference's init_params, with every norm scale and bias drawn
    from N(0, 0.3) (the reference initialises them to 0, 1 or 0)."""
    fam = ref_base.get_model_family(rcfg.name)
    tree = jax.tree.map(np.asarray, fam.init_params(
        rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def walk(node, name=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif k == "bias" or (k == "scale" and "norm" in name):
                out[k] = (rng.normal(0, 0.3, v.shape) + (
                    0 if rcfg.rms_unit_offset or k == "bias" else 1)
                    ).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree)


def make_models(rcfg, seed=0):
    """(reference config, numpy tree, port config, port params)."""
    tree = drawn_tree(rcfg, seed)
    return (rcfg, tree, port_config(rcfg),
            params_from_jax(tree, device="cpu"))


_jit = {}


def ref_fn(rcfg, name):
    """The reference family's forward ``name``, compiled once per config."""
    key = (rcfg, name)
    if key not in _jit:
        fam = ref_base.get_model_family(rcfg.name)
        _jit[key] = jax.jit(getattr(fam, name), static_argnums=1)
    return _jit[key]


def _pool(rcfg, seed=None):
    shape = (rcfg.num_layers, 2, P, rcfg.num_kv_heads, PS, rcfg.head_dim)
    if seed is None:
        return np.zeros(shape, np.float32)
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(
        np.float32)


def _prefill(models, kv, tokens, prefix, lens, pt):
    rcfg, tree, cfg, params = models
    S = tokens.shape[1]
    pos = prefix[:, None] + np.arange(S, dtype=np.int32)[None]
    want, kv_ref = ref_fn(rcfg, "prefill_forward")(
        tree, rcfg, *(jnp.asarray(a) for a in (tokens, pos, kv, pt, prefix,
                                               lens)))
    tkv = torch.from_numpy(kv.copy())
    got, _ = get_model_family(cfg.name).prefill_forward(
        params, cfg, *(torch.from_numpy(a) for a in (tokens, pos)), tkv,
        *(torch.from_numpy(a) for a in (pt, prefix, lens)))
    return got.numpy(), np.asarray(want), tkv.numpy(), np.asarray(kv_ref)


def check_prefill(models):
    """A cold prefill of two rows (21 and 13 tokens), then a suffix behind
    both cached contexts: logits and the pool against the reference."""
    rcfg = models[0]
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, 500, size=(2, 21)).astype(np.int32)
    pt = np.arange(1, 1 + 2 * 12, dtype=np.int32).reshape(2, 12)
    lens = np.asarray([21, 13], np.int32)
    got, want, kv, kv_ref = _prefill(models, _pool(rcfg), tokens,
                                     np.zeros((2,), np.int32), lens, pt)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(kv[:, :, 1:], kv_ref[:, :, 1:], **KV_TOL)
    suffix = rng.integers(3, 500, size=(2, 7)).astype(np.int32)
    got, want, kv, kv_ref = _prefill(models, kv_ref, suffix, lens,
                                     np.asarray([7, 4], np.int32), pt)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(kv[:, :, 1:], kv_ref[:, :, 1:], **KV_TOL)
    return kv_ref


def check_decode(models):
    """Three rows decode four steps each behind 21, 13 and 4 cached
    tokens (against a window of 8 the first two see keys on both sides
    of it, the last only inside)."""
    rcfg, tree, cfg, params = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(3, 500, size=(3, 21)).astype(np.int32)
    pt = np.arange(1, 1 + 3 * 8, dtype=np.int32).reshape(3, 8)
    lens = np.asarray([21, 13, 4], np.int32)
    _, _, _, kv_ref = _prefill(models, _pool(rcfg), tokens,
                               np.zeros((3,), np.int32), lens, pt)
    jkv, tkv = jnp.asarray(kv_ref), torch.from_numpy(kv_ref.copy())
    last = np.asarray([5, 6, 7], np.int32)
    clens = lens + 1
    fam = get_model_family(cfg.name)
    for _ in range(4):
        want, jkv = ref_fn(rcfg, "decode_forward")(
            tree, rcfg, jnp.asarray(last), jnp.asarray(clens - 1), jkv,
            jnp.asarray(pt), jnp.asarray(clens))
        got, _ = fam.decode_forward(
            params, cfg, torch.from_numpy(last), torch.from_numpy(clens - 1),
            tkv, torch.from_numpy(pt), torch.from_numpy(clens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tkv.numpy()[:, :, 1:],
                                   np.asarray(jkv)[:, :, 1:], **KV_TOL)
        last = np.array(jnp.argmax(want, axis=-1), np.int32)
        clens = clens + 1


def check_verify(models):
    """A speculative verify block of 5 behind 17, 3 and 0 cached tokens
    (valid lengths 5, 5 and 2), every position's logits."""
    rcfg, tree, cfg, params = models
    rng = np.random.default_rng(2)
    kv = _pool(rcfg, seed=3)
    pt = np.arange(1, 1 + 3 * 8, dtype=np.int32).reshape(3, 8)
    prefix = np.asarray([17, 3, 0], np.int32)
    lens = np.asarray([5, 5, 2], np.int32)
    tokens = rng.integers(3, 500, size=(3, 5)).astype(np.int32)
    pos = prefix[:, None] + np.arange(5, dtype=np.int32)[None]
    want, kv_ref = ref_fn(rcfg, "verify_forward")(
        tree, rcfg, *(jnp.asarray(a) for a in (tokens, pos, kv, pt, prefix,
                                               lens)))
    tkv = torch.from_numpy(kv.copy())
    got, _ = get_model_family(cfg.name).verify_forward(
        params, cfg, *(torch.from_numpy(a) for a in (tokens, pos)), tkv,
        *(torch.from_numpy(a) for a in (pt, prefix, lens)))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got.numpy()[b, :n],
                                   np.asarray(want)[b, :n], **TOL)
    np.testing.assert_allclose(tkv.numpy()[:, :, 1:],
                               np.asarray(kv_ref)[:, :, 1:], **KV_TOL)


def check_embed(models):
    rcfg, tree, cfg, params = models
    tokens = np.random.default_rng(4).integers(3, 500, size=(2, 19)).astype(
        np.int32)
    lens = np.asarray([19, 6], np.int32)
    want = ref_fn(rcfg, "embed_forward")(tree, rcfg, jnp.asarray(tokens),
                                         jnp.asarray(lens))
    got = get_model_family(cfg.name).embed_forward(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def check_mixed(models, start, valid):
    """The mixed step: decode rows on pages 1..6 (contexts 5, 20, 17),
    one chunk of 16 rows (``valid`` live) behind ``start`` written tokens
    on pages 10..21; decode-row logits and the whole pool."""
    rcfg, tree, cfg, params = models
    pool = _pool(rcfg, seed=5)
    dec_pt = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8], [9, 22, 23, 24, 25, 26,
                                                    27, 28],
                         [29, 30, 31, 32, 33, 34, 35, 36]], np.int32)
    clens = np.asarray([5, 20, 17], np.int32)
    dec_tok = np.asarray([7, 8, 9], np.int32)
    chunk_pt = np.arange(10, 22, dtype=np.int32)[None]
    toks = np.random.default_rng(6).integers(1, 500, 16).astype(np.int32)
    pos = start + np.arange(16, dtype=np.int32)
    want_logits, want_pool = ref_fn(rcfg, "mixed_decode_chunk_forward")(
        tree, rcfg, jnp.asarray(dec_tok), jnp.asarray(clens - 1),
        jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pool),
        jnp.asarray(dec_pt), jnp.asarray(chunk_pt), jnp.asarray(clens),
        jnp.asarray(start, jnp.int32), jnp.asarray(valid, jnp.int32))
    t = torch.from_numpy
    kv = t(pool.copy())
    got, _ = get_model_family(cfg.name).mixed_decode_chunk_forward(
        params, cfg, t(dec_tok), t(clens - 1), t(toks), t(pos), kv,
        t(dec_pt), t(chunk_pt), t(clens),
        torch.tensor(start, dtype=torch.int32),
        torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(kv.numpy(), np.asarray(want_pool), **KV_TOL)


# ----------------------------------------------------------- the engines
ENGINE_KW = dict(num_pages=96, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)


def serve_both(rcfg, tree, scenario, **kw):
    """``scenario(engine, submit)`` on the JAX engine, then on the port,
    with the same weights and configuration (``ENGINE_KW`` updated by
    ``kw``); ``submit(name, prompt, max_tokens)`` returns a Collector.
    Returns (the reference's result, the port's)."""
    from test_torch_chunked_prefill import Collector

    kw = {**ENGINE_KW, **kw}
    out = []
    for ref in (True, False):
        if ref:
            eng = RefEngine(RefConfig(
                model=rcfg, model_family=rcfg.name,
                prefill_buckets=(32, 64, kw["max_seq_len"]), **kw),
                params=tree)
            req_cls, sp_cls = RefRequest, RefSampling
        else:
            eng = InferenceEngine(EngineConfig(
                model=port_config(rcfg), model_family=rcfg.name, **kw),
                device="cpu", params=params_from_jax(tree, device="cpu"))
            req_cls, sp_cls = EngineRequest, SamplingParams

        def submit(name, prompt, max_tokens, _e=eng, _r=req_cls, _s=sp_cls):
            col = Collector()
            _e.submit(_r(name, token_ids=list(prompt),
                         sampling=_s(max_tokens=max_tokens, **GREEDY),
                         on_output=col))
            return col

        try:
            out.append(scenario(eng, submit))
        finally:
            eng.stop()
    return out


def traffic(eng, submit):
    """Four greedy requests: a prompt past the window, a short one, one
    sharing the first's two hash blocks (a prefix hit), and a long one."""
    from test_torch_chunked_prefill import step_until

    cols = [submit("a", range(3, 73), 12), submit("b", range(40, 49), 12)]
    step_until(eng, cols)
    cols += [submit("c", list(range(3, 67)) + [9, 8, 7], 10),
             submit("d", range(100, 190), 6)]
    step_until(eng, cols)
    return [c.tokens for c in cols], getattr(eng, "prefix_hits", None)


# ----------------------------------------------------------------- tests
@pytest.fixture(scope="module", params=["gemma", "gemma2"])
def models(request):
    make = (ref_gemma.gemma_tiny_config if request.param == "gemma"
            else ref_gemma.gemma2_tiny_config)
    return make_models(make(dtype=jnp.float32))


def test_configs_and_registration():
    for name in ("gemma_tiny_config", "gemma2_tiny_config",
                 "gemma2_9b_config", "gemma_2b_config"):
        ref, port = getattr(ref_gemma, name)(), getattr(gemma, name)()
        for f in dataclasses.fields(port):
            if f.name != "dtype":
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
    cfg = gemma.gemma2_tiny_config()
    assert [cfg.layer_is_local(l) for l in range(4)] == \
        [True, False, True, False]
    fam = get_model_family("gemma")
    assert fam.prefill_forward is llama.prefill_forward and fam.supports_int8
    params = fam.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "pre_ffw_norm" in params["layers"] and "lm_head" not in params
    assert (params["final_norm"]["scale"] == 0).all()


def test_prefill_cold_and_behind_a_cached_prefix(models):
    check_prefill(models)


def test_decode_steps(models):
    check_decode(models)


def test_verify_forward(models):
    check_verify(models)


def test_embed_forward(models):
    check_embed(models)


@pytest.mark.parametrize("start,valid", [(24, 12), (0, 16), (9, 16)])
def test_mixed_step(models, start, valid):
    check_mixed(models, start, valid)


def test_embedding_scale_is_cast_to_the_model_dtype():
    """sqrt(3584) = 59.866 is 59.75 in bf16, as the reference's
    jnp.asarray(h ** 0.5, bf16) makes it."""
    cfg = gemma.gemma2_9b_config()
    table = torch.ones((4, cfg.hidden_size), dtype=torch.bfloat16)
    x = llama._embed({"embed": {"embedding": table}}, cfg,
                     torch.tensor([1]))
    assert x.dtype == torch.bfloat16 and float(x[0, 0]) == 59.75


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_window_regimes_both_occur():
    """At the test contexts the window excludes keys on local layers:
    the logits move when the window is widened past the context."""
    rcfg = ref_gemma.gemma2_tiny_config(dtype=jnp.float32)
    models_ = make_models(rcfg)
    wide = make_models(dataclasses.replace(rcfg, sliding_window=64))
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, 500, size=(1, 21)).astype(np.int32)
    pt = np.arange(1, 7, dtype=np.int32)[None]
    zero, lens = np.zeros((1,), np.int32), np.asarray([21], np.int32)
    a = _prefill(models_, _pool(rcfg), tokens, zero, lens, pt)
    b = _prefill(wide, _pool(rcfg), tokens, zero, lens, pt)
    np.testing.assert_allclose(b[0], b[1], **TOL)
    assert np.abs(a[0] - b[0]).max() > 1e-3
    # Within the window (8 tokens) both agree.
    short = _prefill(models_, _pool(rcfg), tokens[:, :8], zero,
                     np.asarray([8], np.int32), pt)
    short_w = _prefill(wide, _pool(rcfg), tokens[:, :8], zero,
                       np.asarray([8], np.int32), pt)
    np.testing.assert_allclose(short[0], short_w[0], **TOL)


def test_softcapped_prefill_takes_the_dense_route():
    """Each layer's prefill attention under Gemma-2's softcap and window
    goes through ``dense_prefill_route`` and counts; Gemma-1 and llama
    shapes do not."""
    for make, want in ((ref_gemma.gemma2_tiny_config, 4),
                       (ref_gemma.gemma_tiny_config, 0)):
        m = make_models(make(dtype=jnp.float32))
        before = attention.dense_prefill_route.launches
        check_embed(m)
        assert attention.dense_prefill_route.launches - before == want


@pytest.mark.parametrize("make", ["gemma_tiny_config", "gemma2_tiny_config"])
def test_bf16_prefill_logits(make):
    rcfg = getattr(ref_gemma, make)(dtype=jnp.bfloat16)
    tree = drawn_tree(rcfg)
    cfg = port_config(rcfg, torch.bfloat16)
    params = params_from_jax(tree, device="cpu")
    tokens = np.random.default_rng(7).integers(3, 500, size=(2, 21)).astype(
        np.int32)
    pt = np.arange(1, 13, dtype=np.int32).reshape(2, 6)
    zero, lens = np.zeros((2,), np.int32), np.asarray([21, 13], np.int32)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21)).copy()
    kv = np.zeros((rcfg.num_layers, 2, 13, rcfg.num_kv_heads, PS,
                   rcfg.head_dim), np.float32)
    want, _ = ref_fn(rcfg, "prefill_forward")(
        tree, rcfg, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(kv, jnp.bfloat16), jnp.asarray(pt), jnp.asarray(zero),
        jnp.asarray(lens))
    got, _ = get_model_family("gemma").prefill_forward(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.zeros(kv.shape, dtype=torch.bfloat16), torch.from_numpy(pt),
        torch.from_numpy(zero), torch.from_numpy(lens))
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.parametrize("make,chunk", [("gemma_tiny_config", 0),
                                        ("gemma2_tiny_config", 0),
                                        ("gemma2_tiny_config", 32)])
def test_engine_greedy_tokens_match_the_jax_engine(make, chunk):
    rcfg = getattr(ref_gemma, make)(dtype=jnp.float32, max_context_len=512)
    ref, port = serve_both(rcfg, drawn_tree(rcfg), traffic,
                           prefill_chunk_tokens=chunk)
    assert port[1] >= 1                      # the prefix hit happened
    assert port[0] == ref[0]


def test_seq_mesh_refused_for_gemma2():
    mesh = build_mesh(MeshConfig(seq=2), [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="seq-axis parallelism"):
        InferenceEngine(EngineConfig(
            model=gemma.gemma2_tiny_config(dtype=torch.float32),
            model_family="gemma", **ENGINE_KW), device="cpu", mesh=mesh)
    # Gemma-1 has neither option: the mesh is taken.
    InferenceEngine(EngineConfig(
        model=gemma.gemma_tiny_config(dtype=torch.float32),
        model_family="gemma", **ENGINE_KW), device="cpu", mesh=mesh).stop()
