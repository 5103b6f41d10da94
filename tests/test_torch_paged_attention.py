"""Kernel 1's plain version against the reference's Pallas decode kernel
(``paged_attention_pallas``, interpret mode on the CPU) at the cases of
tests/test_pallas_attention.py: ragged contexts, an inactive row (ctx 0),
GQA grouping, gemma-2 options and a write-then-attend step.

Tolerance rtol/atol 2e-5, as the reference's own kernel tests: both sides
attend in f32 and differ only in summation order.

The split-K cases hold ``paged_attention_split_plain`` (the CUDA kernel's
two passes: per-split partials over the 16-token units the kernel takes,
base-2 softmax, then the log-sum-exp merge) against the plain version
within 1e-5 (f32 on both sides, another summation order) and against the
Pallas kernel within the tolerance above, and ``split_count`` /
``split_unit_range`` as pure functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.ops.attention import paged_attention_xla, write_decode_kv
from xllm_service_tpu.ops.pallas_paged_attention import paged_attention_pallas
from xllm_service_tpu_torch.ops import attention as port
from xllm_service_tpu_torch.ops.paged_attention import (
    MAX_SPLITS,
    paged_attention,
    paged_attention_plain,
    paged_attention_split_plain,
    split_count,
    split_unit_range,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(B=4, n_q=8, n_kv=4, hd=128, pages=32, ps=16, max_pages=6,
           seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(pages, n_kv, ps, hd)).astype(np.float32)
    v = rng.normal(size=(pages, n_kv, ps, hd)).astype(np.float32)
    q = rng.normal(size=(B, n_q, hd)).astype(np.float32)
    # Distinct pages per row, nonzero ids (page 0 = garbage).
    pt = (np.arange(B * max_pages, dtype=np.int32).reshape(B, max_pages) + 1)
    return q, k, v, pt


def _both(q, k, v, pt, cl, **opts):
    want = paged_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pt),
                                  jnp.asarray(cl, jnp.int32),
                                  interpret=True, **opts)
    got = paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(pt),
                          torch.tensor(cl, dtype=torch.int32), **opts)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("context_lens", [
    [96, 96, 96, 96],          # full pages
    [1, 17, 33, 90],           # ragged, partial pages
    [5, 96, 0, 50],            # includes an inactive row (ctx 0)
])
def test_matches_pallas_kernel(context_lens):
    got, want = _both(*_setup(), context_lens)
    for b, c in enumerate(context_lens):
        if c > 0:
            np.testing.assert_allclose(got[b], want[b], **TOL)
        else:
            # The kernel's invariant: a row that sees no key writes zeros.
            assert np.all(got[b] == 0.0)


def test_gqa_grouping():
    got, want = _both(*_setup(n_q=16, n_kv=2), [40, 96, 8, 64])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("opts", [
    {"softcap": 30.0},
    {"window": 40},
    {"scale": 0.0883883},
    {"softcap": 50.0, "window": 33, "scale": 0.0625},
])
def test_gemma2_options(opts):
    got, want = _both(*_setup(), [96, 41, 8, 64], **opts)
    np.testing.assert_allclose(got, want, **TOL)


def test_after_decode_write():
    """Write one token then attend, both sides."""
    q, k, v, pt = _setup()
    rng = np.random.default_rng(9)
    k_new = rng.normal(size=(4, 4, 128)).astype(np.float32)
    v_new = rng.normal(size=(4, 4, 128)).astype(np.float32)
    prev = np.asarray([10, 20, 30, 40], np.int32)
    jk, jv = write_decode_kv(jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(pt), jnp.asarray(prev))
    want = paged_attention_pallas(jnp.asarray(q), jk, jv, jnp.asarray(pt),
                                  jnp.asarray(prev + 1), interpret=True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got, _, _ = port.decode_attention_step(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tk, tv, torch.from_numpy(pt), torch.from_numpy(prev + 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_nan_garbage_never_reaches_the_output():
    """A pool made with torch.empty, or page 0 after garbage writes, can
    hold NaN past each row's context: the plain version (like the kernel)
    zeroes V there and masks the scores, matching the XLA path on a clean
    pool."""
    q, k, v, pt = _setup()
    cl = [7, 33, 0, 96]
    want = paged_attention_xla(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(pt),
                               jnp.asarray(cl, jnp.int32))
    kd, vd = k.copy(), v.copy()
    for b, c in enumerate(cl):
        for pos in range(c, pt.shape[1] * 16):
            kd[pt[b, pos // 16], :, pos % 16] = np.nan
            vd[pt[b, pos // 16], :, pos % 16] = np.nan
    got = paged_attention_plain(torch.from_numpy(q), torch.from_numpy(kd),
                                torch.from_numpy(vd), torch.from_numpy(pt),
                                torch.tensor(cl, dtype=torch.int32))
    assert np.isfinite(got.numpy()).all()
    for b, c in enumerate(cl):
        if c:
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want[b]),
                                       **TOL)


def test_cpu_wrapper_counts_no_launch():
    before = paged_attention.launches
    _both(*_setup(), [96, 41, 8, 64])
    assert paged_attention.launches == before


# ------------------------------------------------- the split-K arithmetic
SPLIT_CTX = [96, 0, 1, 17, 50, 16]          # ragged, an inactive row, one unit


def _torch_args(q, k, v, pt, cl):
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(pt), torch.tensor(cl, dtype=torch.int32))


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("opts", [
    {},
    {"softcap": 30.0},
    {"window": 40},
    {"softcap": 50.0, "window": 33, "scale": 0.0625},
], ids=["plain", "softcap", "window", "all"])
def test_split_plain_matches_plain(splits, opts):
    args = _torch_args(*_setup(B=6, pages=40), SPLIT_CTX)
    want = paged_attention_plain(*args, **opts)
    got = paged_attention_split_plain(*args, splits=splits, **opts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got[1].numpy() == 0.0)           # ctx 0: zeros, not NaN


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("opts", [{}, {"softcap": 30.0, "window": 40}],
                         ids=["plain", "gemma2"])
def test_split_plain_matches_pallas_kernel(splits, opts):
    q, k, v, pt = _setup(B=6, pages=40)
    want = np.asarray(paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(SPLIT_CTX, jnp.int32), interpret=True, **opts))
    got = paged_attention_split_plain(*_torch_args(q, k, v, pt, SPLIT_CTX),
                                      splits=splits, **opts).numpy()
    for b, c in enumerate(SPLIT_CTX):
        if c > 0:
            np.testing.assert_allclose(got[b], want[b], **TOL)
        else:
            assert np.all(got[b] == 0.0)


def test_split_plain_ignores_nan_past_the_context():
    q, k, v, pt = _setup(B=6, pages=40)
    want = paged_attention_split_plain(*_torch_args(q, k, v, pt, SPLIT_CTX),
                                       splits=3)
    for b, c in enumerate(SPLIT_CTX):
        for pos in range(c, pt.shape[1] * 16):
            k[pt[b, pos // 16], :, pos % 16] = np.nan
            v[pt[b, pos // 16], :, pos % 16] = np.nan
    got = paged_attention_split_plain(*_torch_args(q, k, v, pt, SPLIT_CTX),
                                      splits=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("ctx,window,splits", [
    (0, 0, 4), (1, 0, 4), (67, 0, 4), (1000, 0, 4), (1000, 300, 4),
    (2048, 0, 16), (777, 5, 3), (16, 0, 1),
])
def test_split_unit_ranges_tile_the_visible_units(ctx, window, splits):
    """The splits' unit ranges are disjoint, in order, and together cover
    exactly the units that hold a visible position."""
    lo_pos = max(ctx - window, 0) if window > 0 else 0
    covered = []
    for sp in range(splits):
        u0, u1, lo = split_unit_range(ctx, window, splits, sp)
        assert lo == lo_pos
        covered.extend(range(u0, u1))
    want = sorted({pos // 16 for pos in range(lo_pos, ctx)})
    assert covered == want


def test_split_count_llama3_decode_shape():
    # B 8 x n_kv 8 on 132 SMs: 4 splits, 256 blocks, about two per SM.
    assert split_count(8, 8, 128, 16, 132) == 4


def test_split_count_is_monotone_in_the_rows():
    counts = [split_count(b, 8, 128, 16, 132) for b in (1, 2, 4, 8, 16, 64)]
    assert counts == sorted(counts, reverse=True)
    assert counts[-1] == 1                      # 512 blocks already fill it


@pytest.mark.parametrize("max_pages,ps", [(128, 16), (6, 16), (1, 16),
                                          (64, 64), (512, 1), (4096, 16)])
def test_split_count_never_exceeds_the_tables_chunks(max_pages, ps):
    chunks = -(-(max_pages * ps) // 64)
    n = split_count(1, 1, max_pages, ps, 132)
    assert 1 <= n <= max(1, chunks) and n <= MAX_SPLITS


def test_split_count_short_table_is_not_split():
    assert split_count(1, 1, 6, 16, 132) == 1          # 96 tokens: 2 chunks
    assert split_count(1, 1, 7, 16, 132) == 1          # under two per split
