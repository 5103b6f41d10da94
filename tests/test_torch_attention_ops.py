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

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

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
def test_write_prefill_kv_drops_past_the_table(dt):
    """Row 0's block runs three positions past its 12-position table (a
    verify block overshooting the context). Those writes go to page 0:
    the live pages hold exactly the reference's write of the in-table
    part, where clamping would wrap them onto positions 8-10."""
    rng = np.random.default_rng(5)
    jk, jv, tk, tv = _pools(dt)
    B, S = 2, 7
    kn = rng.normal(size=(B, S, 2, 32)).astype(np.float32)
    vn = rng.normal(size=(B, S, 2, 32)).astype(np.float32)
    (jkn, tkn), (jvn, tvn) = _pair(kn, dt), _pair(vn, dt)
    jpt, tpt = _ints([[3, 5, 7], [9, 2, 11]])
    jpre, tpre = _ints([8, 4])
    _, tlen = _ints([7, 5])
    jin, _ = _ints([4, 5])                 # row 0's positions 8-11 only
    rk, rv = ref.write_prefill_kv(jk, jv, jkn, jvn, jpt, jpre, jin)
    port.write_prefill_kv(tk, tv, tkn, tvn, tpt, tpre, tlen)
    np.testing.assert_array_equal(_np(tk)[1:], _np(rk)[1:])
    np.testing.assert_array_equal(_np(tv)[1:], _np(rv)[1:])


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


@pytest.mark.parametrize("lens", [(33, 33), (33, 20), (33, 1)])
def test_sdpa_prefill_route_masks_as_the_dense_path(lens, monkeypatch):
    """The card's prefix-free route (one causal
    ``scaled_dot_product_attention`` call) against the dense f32 path, on
    the valid rows (the padding rows' outputs are dropped by every
    caller). On the card the call is held to the memory-efficient backend;
    here, where that backend does not exist, PyTorch's math backend
    computes the same causal attention."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    monkeypatch.setattr(port, "sdpa_kernel",
                        lambda _: sdpa_kernel(SDPBackend.MATH))
    g = torch.Generator().manual_seed(len(lens) + lens[1])
    q = torch.randn((2, 33, 4, 32), generator=g)
    k = torch.randn((2, 33, 2, 32), generator=g)
    v = torch.randn((2, 33, 2, 32), generator=g)
    seq_lens = torch.tensor(lens, dtype=torch.int32)
    zero = torch.zeros((2,), dtype=torch.int32)
    got = port.sdpa_prefill_attention(q, k, v)
    want = port.dense_prefill_attention(q, k, v, None, None, None, zero,
                                        seq_lens)
    for b, n in enumerate(lens):
        _close(got[b, :n], want[b, :n], "f32")


def test_sdpa_route_keeps_its_backend_under_concurrent_engines(monkeypatch):
    """The backend flags ``sdpa_kernel`` sets are the process's: engines
    of one process calling the prefix-free route at once must each run
    inside their own selection (the memory-efficient backend alone), never
    inside flags another call just restored."""
    import sys
    import threading
    import types

    import torch.nn.functional as F

    seen: list = []

    def recording_sdpa(q, k, v, **kw):
        seen.append((torch.backends.cuda.flash_sdp_enabled(),
                     torch.backends.cuda.mem_efficient_sdp_enabled(),
                     torch.backends.cuda.math_sdp_enabled()))
        # The CPU has no memory-efficient backend: compute with math (its
        # own set and restore of the flags, as another caller's would be).
        with torch.nn.attention.sdpa_kernel(
                torch.nn.attention.SDPBackend.MATH):
            return F.scaled_dot_product_attention(q, k, v, **kw)

    monkeypatch.setattr(port, "F", types.SimpleNamespace(
        scaled_dot_product_attention=recording_sdpa))
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 8, 4, 16), generator=g)
    k = torch.randn((1, 8, 2, 16), generator=g)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            port.sdpa_prefill_attention(q, k, k) for _ in range(40)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(seen) == 320 and set(seen) == {(False, True, False)}
    assert (torch.backends.cuda.flash_sdp_enabled(),
            torch.backends.cuda.mem_efficient_sdp_enabled(),
            torch.backends.cuda.math_sdp_enabled()) == (True, True, True)


# ------------------------------------- M-RoPE, softcap and sliding window
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mrope_sections(dt):
    """Positions [B, S, 3] rotate each half-dim section (4, 6, 6 of 16) by
    its own stream; 1-D positions with the sections set keep 1-D rope."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    jx, tx = _pair(x, dt)
    pos3 = rng.integers(0, 300, size=(2, 5, 3))
    jp, tp = _ints(pos3)
    sec = (4, 6, 6)
    want = ref.apply_rope(jx, jp, 10000.0, sec)
    got = port.apply_rope(tx, tp, 10000.0, sec)
    _close(got, want, dt)
    jp1, tp1 = _ints(pos3[..., 0])
    _close(port.apply_rope(tx, tp1, 10000.0, sec),
           ref.apply_rope(jx, jp1, 10000.0), dt)
    _close(port.apply_rope(tx, tp1, 10000.0, sec),
           port.apply_rope(tx, tp1, 10000.0), dt)


OPTS = [dict(softcap=5.0), dict(window=3), dict(scale=0.1, softcap=5.0,
                                                window=3)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("prefix", [[0, 0], [5, 8], [0, 3]])
def test_prefill_attention_softcap_and_window(dt, opts, prefix):
    """Gemma-2's options against the reference's XLA path, with a cached
    prefix (the window reaches back into it: prefix_lens + r - c <
    window) and without; every such call counts on the dense route."""
    q, k, v, pt, pre, lens, jk, jv, tk, tv = _prefill_case(
        dt, prefix, [6, 4], seed=12)
    (jq, tq), (jkk, tkk), (jvv, tvv) = (_pair(q, dt), _pair(k, dt),
                                        _pair(v, dt))
    jpt, tpt = _ints(pt)
    jpre, tpre = _ints(pre)
    jlen, tlen = _ints(lens)
    jk, jv = ref.write_prefill_kv(jk, jv, jkk, jvv, jpt, jpre, jlen)
    port.write_prefill_kv(tk, tv, tkk, tvv, tpt, tpre, tlen)
    before = port.dense_prefill_route.launches
    want = ref.prefill_attention(jq, jkk, jvv, jk, jv, jpt, jpre, jlen,
                                 **opts)
    got = port.prefill_attention(tq, tkk, tvv, tk, tv, tpt, tpre, tlen,
                                 **opts)
    assert port.dense_prefill_route.launches == before + 1
    for b, n in enumerate(lens):
        _close(got[b, :n], want[b, :n], dt)
    plain = port.prefill_attention(tq, tkk, tvv, tk, tv, tpt, tpre, tlen)
    assert (_np(plain) - _np(got)).__abs__().max() > 1e-3


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("opts", OPTS)
def test_decode_attention_step_softcap_and_window(dt, opts):
    """The decode step with Gemma-2's options takes kernel 1's plain
    version here (the fused route stays off), as the reference's."""
    rng = np.random.default_rng(13)
    jk, jv, tk, tv = _pools(dt, P=16)
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    kn = rng.normal(size=(3, 2, 32)).astype(np.float32)
    vn = rng.normal(size=(3, 2, 32)).astype(np.float32)
    (jq, tq), (jkn, tkn), (jvn, tvn) = (_pair(q, dt), _pair(kn, dt),
                                        _pair(vn, dt))
    jpt, tpt = _ints([[3, 5, 7], [9, 2, 11], [4, 6, 8]])
    jcl, tcl = _ints([1, 9, 12])
    attn_r, rk, rv = ref.decode_attention_step(jq, jkn, jvn, jk, jv, jpt,
                                               jcl, **opts)
    attn, ok, ov = port.decode_attention_step(tq, tkn, tvn, tk, tv, tpt, tcl,
                                              **opts)
    _close(attn, attn_r, dt)
    np.testing.assert_array_equal(_np(ok), _np(rk))
    np.testing.assert_array_equal(_np(ov), _np(rv))


def test_ring_prefill_refuses_softcap_and_window():
    q = torch.zeros((1, 4, 2, 32))
    for opts in OPTS:
        with pytest.raises(NotImplementedError, match="softcap"):
            port.prefill_attention(q, q[:, :, :1], q[:, :, :1], None, None,
                                   None, torch.zeros(1, dtype=torch.int32),
                                   torch.full((1,), 4, dtype=torch.int32),
                                   ring=True, **opts)
