"""Kernel 1's plain version against the reference's Pallas decode kernel
(``paged_attention_pallas``, interpret mode on the CPU) at the cases of
tests/test_pallas_attention.py: ragged contexts, an inactive row (ctx 0),
GQA grouping, gemma-2 options and a write-then-attend step.

Tolerance rtol/atol 2e-5, as the reference's own kernel tests: both sides
attend in f32 and differ only in summation order.
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
    paged_attention,
    paged_attention_plain,
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
