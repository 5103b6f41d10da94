"""Kernel 3's plain version (the port's ``fused_decode_attention`` on CPU
tensors) against the reference's ``fused_decode_attention_pallas`` in
interpret mode, at the cases of tests/test_pallas_attention.py's fused
tests: mid-page appends, page starts and edges, a full pool, empty
contexts, GQA, ctx 1, ctx on a page boundary and a ctx-0 row on the
garbage page. Both the output and both pools after the call are compared.

Tolerance on the output, f32: rtol/atol 1e-5. Both sides attend in f32 over
the same values (outputs are weighted means of N(0, 1) values, |out| < 4)
and differ only in summation order, which moves the result by a few f32
ulps. bf16: one bf16 ulp at |out| < 4 (2**-6), since both round an f32
result once. Pools are compared exactly (the append is a copy), outside
page 0 where the inactive rows' writes race.

The split-K cases hold ``fused_decode_attention_split_plain`` (the CUDA
kernel's passes: per-split partials over the pooled slots, the new token as
one more partial, the merge, the append) at splits 1/2/3/8 against the
interpret-mode kernel at the parity cases, within the f32 tolerance above;
the pools after the append are compared exactly.

Engine level: the port's engine under ``XLLM_KV_WRITEBACK=fused`` against
the reference engine on the same switch (Pallas in interpret mode) and the
port's own default route, mirroring
tests/test_pallas_engine_routing.py::test_fused_decode_writeback_matches_default.
"""

import functools
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu.ops.pallas_fused_decode_attention import (
    fused_decode_attention_pallas,
)
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.fused_decode_attention import (
    fused_decode_attention,
    fused_decode_attention_plain,
    fused_decode_attention_split_plain,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=0, atol=2 ** -6)}


def _setup(B=4, n_q=8, n_kv=4, hd=128, pages=32, ps=16, max_pages=6,
           seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(pages, n_kv, ps, hd)).astype(np.float32)
    v = rng.normal(size=(pages, n_kv, ps, hd)).astype(np.float32)
    q = rng.normal(size=(B, n_q, hd)).astype(np.float32)
    k_new = rng.normal(size=(B, n_kv, hd)).astype(np.float32)
    v_new = rng.normal(size=(B, n_kv, hd)).astype(np.float32)
    # Distinct pages per row, nonzero ids (page 0 = garbage).
    pt = (np.arange(B * max_pages, dtype=np.int32).reshape(B, max_pages) + 1)
    return q, k_new, v_new, k, v, pt


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x) -> np.ndarray:
    """f32 numpy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _compare(q, k_new, v_new, k, v, pt, cl, dtype=torch.float32):
    ts = [_t(a, dtype) for a in (q, k_new, v_new, k, v)]
    want, kp_want, vp_want = fused_decode_attention_pallas(
        *[_j(t) for t in ts], jnp.asarray(pt),
        jnp.asarray(cl, jnp.int32), interpret=True)
    got, kp, vp = fused_decode_attention(
        *ts, torch.from_numpy(pt), torch.tensor(cl, dtype=torch.int32))
    assert kp is ts[3] and vp is ts[4]            # pools updated in place
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    # Exact outside the garbage page.
    np.testing.assert_array_equal(_np(kp)[1:], _np(kp_want)[1:])
    np.testing.assert_array_equal(_np(vp)[1:], _np(vp_want)[1:])
    return _np(got), _np(kp), _np(vp)


PREV_CASES = [
    [10, 20, 30, 40],       # mid-page appends
    [0, 16, 31, 95],        # page starts/edges + pool-full row
    [0, 0, 0, 0],           # empty contexts: first token ever
    [15, 16, 31, 32],       # ctx on a page boundary (16, 17, 32, 33)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prev", PREV_CASES)
def test_parity_with_pallas(dtype, prev):
    args = _setup()
    _, kp, _ = _compare(*args, [p + 1 for p in prev], dtype)
    # The append landed at position prev in each row's own page.
    k_new, pt = args[1], args[5]
    for b, p in enumerate(prev):
        want = torch.from_numpy(k_new[b]).to(dtype).float().numpy()
        np.testing.assert_array_equal(kp[pt[b, p // 16], :, p % 16], want)


@functools.lru_cache(maxsize=None)
def _pallas_fused(prev: tuple) -> tuple:
    """The interpret-mode kernel's (out, k_pages, v_pages) at _setup()'s
    f32 inputs and contexts prev + 1, as numpy."""
    q, k_new, v_new, k, v, pt = _setup()
    out = fused_decode_attention_pallas(
        *[jnp.asarray(a) for a in (q, k_new, v_new, k, v, pt)],
        jnp.asarray([p + 1 for p in prev], jnp.int32), interpret=True)
    return tuple(_np(x) for x in out)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("prev", PREV_CASES)
def test_split_plain_matches_pallas(prev, splits):
    """The kernel's passes at several split counts (6 units per row: at 8
    splits two are empty, at 3 each holds two) against the reference
    kernel: the output within the f32 tolerance, the pools after the
    append exactly, outside the garbage page."""
    q, k_new, v_new, k, v, pt = _setup()
    want, kp_want, vp_want = _pallas_fused(tuple(prev))
    kp, vp = _t(k, torch.float32), _t(v, torch.float32)
    got, kp_out, vp_out = fused_decode_attention_split_plain(
        *[_t(a, torch.float32) for a in (q, k_new, v_new)], kp, vp,
        torch.from_numpy(pt),
        torch.tensor([p + 1 for p in prev], dtype=torch.int32),
        splits=splits)
    assert kp_out is kp and vp_out is vp          # pools updated in place
    np.testing.assert_allclose(got.numpy(), want, **TOL[torch.float32])
    np.testing.assert_array_equal(kp.numpy()[1:], kp_want[1:])
    np.testing.assert_array_equal(vp.numpy()[1:], vp_want[1:])


def test_gqa():
    _compare(*_setup(n_q=16, n_kv=2), [4, 41, 65, 96])


def test_ctx_one_attends_only_the_new_token():
    q, k_new, v_new, k, v, pt = _setup()
    got, _, _ = _compare(q, k_new, v_new, k, v, pt, [1, 1, 1, 1])
    np.testing.assert_allclose(got, np.repeat(v_new, 2, axis=1), rtol=1e-6,
                               atol=1e-6)


def test_ctx_zero_row_on_the_garbage_page():
    """An inactive slot (ctx 0, page-table row on page 0): the reference
    kernel attends the new token alone (output v_new) and writes page 0."""
    q, k_new, v_new, k, v, pt = _setup()
    pt[2] = 0
    k[0] = v[0] = np.nan                  # page 0 holds garbage
    got, kp, _ = _compare(q, k_new, v_new, k, v, pt, [12, 40, 0, 7])
    np.testing.assert_allclose(got[2], np.repeat(v_new[2], 2, axis=0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(kp[0, :, 0], k_new[2])


def test_nan_past_each_context_never_reaches_the_output():
    q, k_new, v_new, k, v, pt = _setup(seed=3)
    cl = [5, 17, 33, 90]
    for b, c in enumerate(cl):
        for pos in range(c - 1, pt.shape[1] * 16):
            k[pt[b, pos // 16], :, pos % 16] = np.nan
            v[pt[b, pos // 16], :, pos % 16] = np.nan
    got, _, _ = _compare(q, k_new, v_new, k, v, pt, cl)
    assert np.isfinite(got).all()


# --------------------------------------------------------------- routing
def test_decode_step_routes_on_the_writeback_switch(monkeypatch):
    q, k_new, v_new, k, v, pt = (_t(a, torch.float32) if a.dtype != np.int32
                                 else torch.from_numpy(a)
                                 for a in _setup())
    cl = torch.tensor([11, 21, 31, 41], dtype=torch.int32)
    calls = []

    def spy(*a):
        calls.append(1)
        return fused_decode_attention(*a)

    monkeypatch.setattr(attention, "fused_decode_attention", spy)
    unfused = attention.decode_attention_step(q, k_new, v_new, k.clone(),
                                              v.clone(), pt, cl)[0]
    assert not calls
    monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    fused = attention.decode_attention_step(q, k_new, v_new, k.clone(),
                                            v.clone(), pt, cl)[0]
    assert len(calls) == 1
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-5)
    # Softcap, window or an explicit scale keep the unfused route.
    for opts in ({"softcap": 30.0}, {"window": 8}, {"scale": 0.1}):
        attention.decode_attention_step(q, k_new, v_new, k.clone(),
                                        v.clone(), pt, cl, **opts)
    assert len(calls) == 1


def test_unknown_writeback_mode_warns_once(monkeypatch, caplog):
    monkeypatch.setattr(attention, "_warned_writeback_modes", set())
    monkeypatch.setenv("XLLM_KV_WRITEBACK", "bogus-mode")
    with caplog.at_level(logging.WARNING):
        assert attention.kv_writeback_mode() == ""
        assert attention.kv_writeback_mode() == ""
    assert sum("bogus-mode" in r.getMessage() for r in caplog.records) == 1
    for mode in ("", "slice", "scatter", "fused"):
        monkeypatch.setenv("XLLM_KV_WRITEBACK", mode)
        assert attention.kv_writeback_mode() == mode


def test_plain_version_is_the_cpu_route():
    args = [_t(a, torch.float32) if a.dtype != np.int32 else
            torch.from_numpy(a) for a in _setup()]
    cl = torch.tensor([3, 9, 0, 50], dtype=torch.int32)
    a = fused_decode_attention(*[x.clone() for x in args], cl)
    b = fused_decode_attention_plain(*[x.clone() for x in args], cl)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- engine
MODEL_KW = dict(hidden_size=128, num_heads=2, num_kv_heads=1, head_dim=128,
                num_layers=1, ffn_size=128, max_context_len=128)
ENGINE_KW = dict(num_pages=40, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=128, decode_horizon=4)
PROMPT = [7, 11, 13, 17, 19, 23, 29, 31, 37, 41]


class _Collector:
    def __init__(self):
        self.tokens = []
        self.done = threading.Event()

    def __call__(self, out):
        for s in out.outputs:
            self.tokens.extend(s.token_ids)
        if out.finished:
            self.done.set()


def _greedy(engine, req_cls, sp_cls, n=6):
    col = _Collector()
    engine.submit(req_cls("r0", token_ids=list(PROMPT),
                          sampling=sp_cls(max_tokens=n, temperature=0.0),
                          on_output=col))
    while not col.done.is_set():
        engine.step()
    return col.tokens


def test_engine_fused_route_matches_reference_and_default(monkeypatch):
    tree = ref_llama.init_params(ref_tiny(dtype=jnp.float32, **MODEL_KW),
                                 jax.random.PRNGKey(0))
    params = llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                   device="cpu")

    def port_engine():
        return InferenceEngine(
            EngineConfig(model=tiny_config(dtype=torch.float32, **MODEL_KW),
                         **ENGINE_KW), device="cpu", params=params)

    default = _greedy(port_engine(), EngineRequest, SamplingParams)
    assert len(default) == 6
    calls = []
    real = attention.fused_decode_attention
    monkeypatch.setattr(attention, "fused_decode_attention",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    fused = _greedy(port_engine(), EngineRequest, SamplingParams)
    assert calls                            # the decode steps went fused
    monkeypatch.setenv("XLLM_PALLAS_INTERPRET", "1")
    ref = RefEngine(RefConfig(model=ref_tiny(dtype=jnp.float32, **MODEL_KW),
                              prefill_buckets=(16, 32, 128), **ENGINE_KW),
                    params=tree)
    want = _greedy(ref, RefRequest, RefSampling)
    assert fused == want == default
