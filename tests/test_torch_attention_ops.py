"""The port's plain attention ops against the reference's, on the CPU, in
f32 and bf16: norm, rope, the paged K/V writes (page-0 redirection and
dropped writes), the page gather, prefill attention with and without a
cached prefix, and the decode step.

Tolerances: f32 results differ only by summation order and transcendental
implementations (~1e-6 relative at these sizes), so 2e-5; bf16 outputs
are computed in f32 on both sides from identical bf16 inputs and rounded
once, so they agree to one bf16 ulp (2**-8 relative) — 1e-2 covers values
up to ~2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.ops import attention as ref
from xllm_service_tpu_torch.ops import attention as port

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(x: np.ndarray, dt: str):
    """The same values in both frameworks (bf16 rounding is identical)."""
    return jnp.asarray(x, JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dt):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


def _ints(x):
    return jnp.asarray(np.asarray(x, np.int32)), \
        torch.tensor(np.asarray(x, np.int32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_and_rope(dt):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dt), _pair(w, dt)
    _close(port.rms_norm(tx, tw, 1e-5), ref.rms_norm(jx, jw, 1e-5), dt)

    pos = rng.integers(0, 2048, size=(3, 5))
    jp, tp = _ints(pos)
    c_ref, s_ref = ref.rope_cos_sin(jp, 32, 500000.0)
    c, s = port.rope_cos_sin(tp, 32, 500000.0)
    # Angles reach ~2e3 rad: f32 cos/sin of such arguments differ by ~1e-4
    # between implementations (argument reduction of a rounded angle).
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=2e-4)
    h = rng.normal(size=(3, 5, 4, 32)).astype(np.float32)
    jh, th = _pair(h, dt)
    got = port.apply_rope(th, tp, 500000.0)
    want = ref.apply_rope(jh, jp, 500000.0)
    tol = dict(TOL[dt])
    if dt == "f32":
        tol = dict(rtol=1e-3, atol=1e-3)   # the angle difference above
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _pools(dt, P=12, n_kv=2, ps=4, hd=32, seed=1):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(P, n_kv, ps, hd)).astype(np.float32)
    v = rng.normal(size=(P, n_kv, ps, hd)).astype(np.float32)
    (jk, tk), (jv, tv) = _pair(k, dt), _pair(v, dt)
    return jk, jv, tk, tv


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_write_prefill_kv_in_place(dt):
    rng = np.random.default_rng(2)
    jk, jv, tk, tv = _pools(dt)
    B, S = 2, 7
    kn = rng.normal(size=(B, S, 2, 32)).astype(np.float32)
    vn = rng.normal(size=(B, S, 2, 32)).astype(np.float32)
    (jkn, tkn), (jvn, tvn) = _pair(kn, dt), _pair(vn, dt)
    jpt, tpt = _ints([[3, 5, 7], [9, 2, 11]])
    jpre, tpre = _ints([2, 4])
    jlen, tlen = _ints([7, 5])             # row 1: two padding tokens
    rk, rv = ref.write_prefill_kv(jk, jv, jkn, jvn, jpt, jpre, jlen)
    ok, ov = port.write_prefill_kv(tk, tv, tkn, tvn, tpt, tpre, tlen)
    assert ok is tk and ov is tv           # updated in place
    # Page 0 takes the padding rows' garbage; live pages must be identical.
    np.testing.assert_array_equal(_np(ok)[1:], _np(rk)[1:])
    np.testing.assert_array_equal(_np(ov)[1:], _np(rv)[1:])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_write_decode_kv_redirects_and_drops(dt):
    rng = np.random.default_rng(3)
    jk, jv, tk, tv = _pools(dt)
    kn = rng.normal(size=(3, 2, 32)).astype(np.float32)
    vn = rng.normal(size=(3, 2, 32)).astype(np.float32)
    (jkn, tkn), (jvn, tvn) = _pair(kn, dt), _pair(vn, dt)
    jpt, tpt = _ints([[3, 5, 7], [9, 2, 11], [4, 6, 8]])
    # Row 1 writes past its table (position 12 = page slot 3 of 3): the
    # reference drops it, and so must the port — page 0 stays untouched.
    for positions in ([5, 12, 0], [11, 3, 7]):
        jpos, tpos = _ints(positions)
        rk, rv = ref.write_decode_kv(jk, jv, jkn, jvn, jpt, jpos)
        port.write_decode_kv(tk, tv, tkn, tvn, tpt, tpos)
        np.testing.assert_array_equal(_np(tk), _np(rk))
        np.testing.assert_array_equal(_np(tv), _np(rv))
        jk, jv = rk, rv


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gather_pages(dt):
    jk, _, tk, _ = _pools(dt)
    jpt, tpt = _ints([[3, 5, 0], [9, 2, 11]])
    np.testing.assert_array_equal(_np(port.gather_pages(tk, tpt)),
                                  _np(ref.gather_pages(jk, jpt)))


def _prefill_case(dt, prefix, seq_lens, S=6, n_q=4, n_kv=2, hd=32, ps=4,
                  seed=4):
    rng = np.random.default_rng(seed)
    B = len(prefix)
    jk, jv, tk, tv = _pools(dt, P=16, n_kv=n_kv, ps=ps, hd=hd, seed=seed)
    q = rng.normal(size=(B, S, n_q, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, n_kv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, n_kv, hd)).astype(np.float32)
    pt = np.arange(1, 1 + B * 4, dtype=np.int32).reshape(B, 4)
    return (q, k, v, pt, np.asarray(prefix, np.int32),
            np.asarray(seq_lens, np.int32), jk, jv, tk, tv)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("prefix", [[0, 0], [5, 8], [0, 3]])
def test_prefill_attention(dt, prefix):
    q, k, v, pt, pre, lens, jk, jv, tk, tv = _prefill_case(
        dt, prefix, [6, 4])
    (jq, tq), (jkk, tkk), (jvv, tvv) = (_pair(q, dt), _pair(k, dt),
                                        _pair(v, dt))
    jpt, tpt = _ints(pt)
    jpre, tpre = _ints(pre)
    jlen, tlen = _ints(lens)
    jk, jv = ref.write_prefill_kv(jk, jv, jkk, jvv, jpt, jpre, jlen)
    port.write_prefill_kv(tk, tv, tkk, tvv, tpt, tpre, tlen)
    want = ref.prefill_attention(jq, jkk, jvv, jk, jv, jpt, jpre, jlen)
    got = port.prefill_attention(tq, tkk, tvv, tk, tv, tpt, tpre, tlen)
    for b, n in enumerate(lens):           # padding queries are undefined
        _close(got[b, :n], want[b, :n], dt)
    # With the pool omitted (no paged prefix at all) both take the
    # suffix-only path.
    if not any(prefix):
        want = ref.prefill_attention(jq, jkk, jvv, None, None, None, jpre,
                                     jlen)
        got = port.prefill_attention(tq, tkk, tvv, None, None, None, tpre,
                                     tlen)
        for b, n in enumerate(lens):
            _close(got[b, :n], want[b, :n], dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_step(dt):
    rng = np.random.default_rng(5)
    jk, jv, tk, tv = _pools(dt, P=16)
    B = 3
    q = rng.normal(size=(B, 4, 32)).astype(np.float32)
    kn = rng.normal(size=(B, 2, 32)).astype(np.float32)
    vn = rng.normal(size=(B, 2, 32)).astype(np.float32)
    (jq, tq), (jkn, tkn), (jvn, tvn) = (_pair(q, dt), _pair(kn, dt),
                                        _pair(vn, dt))
    jpt, tpt = _ints([[3, 5, 7], [9, 2, 11], [4, 6, 8]])
    jcl, tcl = _ints([1, 9, 12])           # includes the new token
    attn_r, rk, rv = ref.decode_attention_step(jq, jkn, jvn, jk, jv, jpt, jcl)
    attn, ok, ov = port.decode_attention_step(tq, tkn, tvn, tk, tv, tpt, tcl)
    _close(attn, attn_r, dt)
    np.testing.assert_array_equal(_np(ok), _np(rk))
    np.testing.assert_array_equal(_np(ov), _np(rv))
