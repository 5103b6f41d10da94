"""Kernel 2's plain version against the reference's multi-query Pallas
kernel (``mq_paged_attention_pallas``, interpret mode on the CPU) and
against ``prefill_attention``, as tests/test_mq_paged_attention.py does.

Tolerance rtol/atol 2e-5, as the reference's own test: both sides attend in
f32 and differ only in summation order. Padding queries (s >=
block_lens[b]) are undefined in the reference; the port zeroes them.

The tiled cases hold ``mq_paged_attention_tiled_plain`` (the tensor-core
kernel's arithmetic: 16-row groups walking 64-key chunks, base-2 online
softmax, P rounded to the input type before P @ V, unmasked chunks below
the diagonal, select-masked chunks across and above it) against the plain
version and the Pallas kernel. In f32 nothing is rounded, so it agrees within the
tolerance above; in bf16 P's rounding (2**-9 relative) and the output's
(one bf16 ulp, 2**-6 for outputs in [2, 4)) give the kernel's stated
tolerance of 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.ops.attention import paged_attention_xla
from xllm_service_tpu.ops.attention import prefill_attention as ref_prefill
from xllm_service_tpu.ops.attention import write_prefill_kv as ref_write
from xllm_service_tpu.ops.pallas_mq_paged_attention import (
    mq_paged_attention_pallas,
)
from xllm_service_tpu_torch.ops.mq_paged_attention import (
    mq_paged_attention,
    mq_paged_attention_plain,
    mq_paged_attention_tiled_plain,
    mq_route,
    query_tile,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(B=3, s_q=5, n_q=8, n_kv=4, hd=128, pages=32, ps=16, max_pages=6,
           seed=0, block=None):
    """Pools where each row's prefix AND block K/V are written (the
    kernel's invariant), plus the dense block K/V for the reference."""
    rng = np.random.default_rng(seed)
    k_pages = jnp.zeros((pages, n_kv, ps, hd), jnp.float32)
    v_pages = jnp.zeros((pages, n_kv, ps, hd), jnp.float32)
    pt = np.arange(B * max_pages, dtype=np.int32).reshape(B, max_pages) + 1
    prefix = rng.integers(1, 3 * ps, B).astype(np.int32)
    if block is None:
        block = rng.integers(1, s_q + 1, B)
    block = np.asarray(block, np.int32)
    pk = rng.normal(size=(B, 3 * ps, n_kv, hd)).astype(np.float32)
    pv = rng.normal(size=(B, 3 * ps, n_kv, hd)).astype(np.float32)
    k_pages, v_pages = ref_write(k_pages, v_pages, jnp.asarray(pk),
                                 jnp.asarray(pv), jnp.asarray(pt),
                                 jnp.zeros((B,), jnp.int32),
                                 jnp.asarray(prefix))
    bk = rng.normal(size=(B, s_q, n_kv, hd)).astype(np.float32)
    bv = rng.normal(size=(B, s_q, n_kv, hd)).astype(np.float32)
    k_pages, v_pages = ref_write(k_pages, v_pages, jnp.asarray(bk),
                                 jnp.asarray(bv), jnp.asarray(pt),
                                 jnp.asarray(prefix), jnp.asarray(block))
    q = rng.normal(size=(B, s_q, n_q, hd)).astype(np.float32)
    return (q, bk, bv, np.array(k_pages), np.array(v_pages), pt, prefix,
            block)


def _port(q, kp, vp, pt, prefix, block):
    return mq_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(prefix),
        torch.from_numpy(block)).numpy()


@pytest.mark.parametrize("seed", [0, 3])
def test_matches_pallas_kernel_and_prefill_attention(seed):
    q, bk, bv, kp, vp, pt, prefix, block = _setup(seed=seed)
    args = [jnp.asarray(a) for a in (q, kp, vp, pt, prefix, block)]
    pallas = np.asarray(mq_paged_attention_pallas(*args, interpret=True))
    dense = np.asarray(ref_prefill(
        args[0], jnp.asarray(bk), jnp.asarray(bv), args[1], args[2],
        args[3], args[4], args[5]))
    got = _port(q, kp, vp, pt, prefix, block)
    for b in range(q.shape[0]):
        n = int(block[b])
        np.testing.assert_allclose(got[b, :n], pallas[b, :n], **TOL)
        np.testing.assert_allclose(got[b, :n], dense[b, :n], **TOL)
        assert np.all(got[b, n:] == 0.0)


def test_single_query_degenerates_to_decode_semantics():
    q, bk, bv, kp, vp, pt, prefix, block = _setup(s_q=1, seed=7)
    one = np.ones_like(block)
    got = _port(q, kp, vp, pt, prefix, one)
    want = paged_attention_xla(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(pt),
                               jnp.asarray(prefix + 1))
    np.testing.assert_allclose(got[:, 0], np.asarray(want), **TOL)


def test_long_suffix_gqa():
    """A suffix far past the reference route's S * n_heads cap, with a
    GQA group of 4 (Llama-3's ratio)."""
    q, bk, bv, kp, vp, pt, prefix, block = _setup(
        B=2, s_q=40, n_q=16, n_kv=4, hd=32, pages=24, max_pages=8, seed=5,
        block=[40, 23])
    got = _port(q, kp, vp, pt, prefix, block)
    want = np.asarray(ref_prefill(
        jnp.asarray(q), jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(prefix),
        jnp.asarray(block)))
    for b in range(2):
        n = int(block[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


def test_query_tile_fits_the_block():
    # Llama-3-8B: G 4 and 32 rows per block -> 8 queries per block.
    assert query_tile(4, 32) == 8
    assert query_tile(8, 32) == 4
    assert query_tile(4, 16) == 4
    assert query_tile(64, 32) == 1


def test_plain_is_the_cpu_path():
    q, bk, bv, kp, vp, pt, prefix, block = _setup(seed=1)
    before = mq_paged_attention.launches
    got = _port(q, kp, vp, pt, prefix, block)
    plain = mq_paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(prefix),
        torch.from_numpy(block)).numpy()
    np.testing.assert_array_equal(got, plain)
    assert mq_paged_attention.launches == before


# --------------------------------------- the tensor-core kernel's arithmetic
BF16_TOL = 2e-2


def _tiled_case(dtype, s_q, block, seed, **kw):
    """A case whose pages hold NaN past each row's context."""
    q, bk, bv, kp, vp, pt, prefix, block = _setup(s_q=s_q, block=block,
                                                  seed=seed, **kw)
    ps = kp.shape[2]
    for b in range(q.shape[0]):
        for pos in range(int(prefix[b] + block[b]), pt.shape[1] * ps):
            kp[pt[b, pos // ps], :, pos % ps] = np.nan
            vp[pt[b, pos // ps], :, pos % ps] = np.nan
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [
        torch.from_numpy(pt), torch.from_numpy(prefix),
        torch.from_numpy(block)]
    return args, block


@pytest.mark.parametrize("s_q,block,rows", [
    (5, None, 64),              # one partial tile
    (40, [40, 23, 0], 64),      # three tiles, a ragged row, an empty row
    (70, [70, 64, 1], 64),      # Sq no multiple of the 8-query tile
    (70, [70, 64, 1], 128),     # two warpgroups per block, as shipped
    (1, [1, 1, 1], 64),         # a single query
])
def test_tiled_plain_matches_plain_f32(s_q, block, rows):
    args, block = _tiled_case(torch.float32, s_q, block, seed=11,
                              max_pages=8, n_q=16, n_kv=2)
    got = mq_paged_attention_tiled_plain(*args, rows=rows).numpy()
    want = mq_paged_attention_plain(*args).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    for b in range(3):
        assert np.all(got[b, int(block[b]):] == 0.0)


@pytest.mark.parametrize("s_q,block", [(5, None), (40, [40, 23, 0]),
                                       (70, [70, 64, 1])])
def test_tiled_plain_matches_plain_bf16(s_q, block):
    args, block = _tiled_case(torch.bfloat16, s_q, block, seed=12,
                              max_pages=8, n_q=16, n_kv=2)
    got = mq_paged_attention_tiled_plain(*args).float().numpy()
    want = mq_paged_attention_plain(*args).float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_TOL
    for b in range(3):
        assert np.all(got[b, int(block[b]):] == 0.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_tiled_plain_matches_pallas_kernel(dtype, tol):
    """Against the reference kernel in interpret mode on the same (bf16-
    representable, for the bf16 case) values in f32."""
    q, bk, bv, kp, vp, pt, prefix, block = _setup(s_q=24, block=[24, 9, 17],
                                                  seed=13, max_pages=8)
    t = [torch.from_numpy(a).to(dtype) for a in (q, kp, vp)]
    ints = [torch.from_numpy(a) for a in (pt, prefix, block)]
    got = mq_paged_attention_tiled_plain(*t, *ints).float().numpy()
    want = np.asarray(mq_paged_attention_pallas(
        *[jnp.asarray(a.float().numpy()) for a in t],
        *[jnp.asarray(a) for a in (pt, prefix, block)], interpret=True))
    for b in range(3):
        n = int(block[b])
        assert np.abs(got[b, :n] - want[b, :n]).max() <= tol
        assert np.all(got[b, n:] == 0.0)


def test_tiled_plain_unmasked_shortcut_is_exact():
    """A long prefix puts whole chunks below every query's diagonal: those
    take no mask, and the result is the plain version's."""
    args, _ = _tiled_case(torch.float32, 20, [20, 20, 3], seed=14,
                          max_pages=16, pages=64, n_q=8, n_kv=2)
    args[4] = torch.tensor([200, 130, 64], dtype=torch.int32)   # prefixes
    # Rewrite the pools so every position below prefix + block is finite.
    rng = np.random.default_rng(15)
    args[1] = torch.from_numpy(
        rng.normal(size=tuple(args[1].shape)).astype(np.float32))
    args[2] = torch.from_numpy(
        rng.normal(size=tuple(args[2].shape)).astype(np.float32))
    got = mq_paged_attention_tiled_plain(*args).numpy()
    want = mq_paged_attention_plain(*args).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype,hd,ps,group,route", [
    (torch.bfloat16, 128, 16, 4, "mma"),       # Llama-3-8B
    (torch.bfloat16, 64, 16, 8, "mma"),
    (torch.bfloat16, 128, 64, 1, "mma"),
    (torch.float32, 128, 16, 4, "walk"),       # full f32 arithmetic
    (torch.bfloat16, 32, 16, 2, "walk"),       # head dim under 64
    (torch.bfloat16, 128, 16, 3, "walk"),      # a group not dividing 64
    (torch.bfloat16, 128, 48, 4, "walk"),      # the walk then raises on ps
])
def test_mq_route_names_the_device_route(dtype, hd, ps, group, route):
    assert mq_route(dtype, hd, ps, group) == route
