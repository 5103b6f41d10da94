"""Kernels 4-5's plain versions (the port's ``gather_kv_pages`` /
``scatter_kv_pages`` on CPU tensors) against the reference's Pallas page
movers run in interpret mode (``XLLM_PALLAS_INTERPRET=1``), on a
``[L, 2, P, n_kv, ps, hd]`` pool with shuffled ids and NaN in every page
the call must not touch.

Both are pure copies, so results are compared bit for bit (as unsigned
integer views, which also pins NaN payloads).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.ops import pallas_page_dma as ref
from xllm_service_tpu_torch.ops.page_dma import (
    gather_kv_pages,
    scatter_kv_pages,
)

SHAPE = (2, 2, 6, 2, 4, 8)          # [L, 2, P, n_kv, ps, hd]
IDS = [4, 1, 5]                     # shuffled; pages 0, 2, 3 untouched


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("XLLM_PALLAS_INTERPRET", "1")


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        w = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
        return x.contiguous().view(w).numpy().view(f"u{x.element_size()}")
    a = np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}")


def _to_jax(t: torch.Tensor):
    """The same bits as a JAX array (bf16 travels as a 16-bit view)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _pool(dtype, seed=0):
    rng = np.random.default_rng(seed)
    kv = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    kv = kv.to(dtype)
    untouched = [p for p in range(SHAPE[2]) if p not in IDS]
    kv[:, :, untouched] = float("nan")      # the canonical quiet NaN
    return kv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_bit_identical_to_pallas(dtype):
    kv = _pool(dtype)
    got = gather_kv_pages(kv, IDS)
    want = ref.gather_kv_pages(_to_jax(kv), jnp.asarray(IDS, jnp.int32))
    assert tuple(got.shape) == (2, 2, len(IDS), 2, 4, 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The new block is a copy: writing the pool afterwards leaves it be.
    before = _bits(got).copy()
    kv.zero_()
    np.testing.assert_array_equal(_bits(got), before)


@pytest.mark.parametrize("pool_dtype,block_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),     # block cast to the pool's dtype
])
def test_scatter_bit_identical_to_pallas(pool_dtype, block_dtype):
    kv = _pool(pool_dtype, seed=1)
    rng = np.random.default_rng(2)
    block = torch.from_numpy(rng.standard_normal(
        (2, 2, len(IDS), 2, 4, 8)).astype(np.float32)).to(block_dtype)
    want = ref.scatter_kv_pages(_to_jax(kv), jnp.asarray(IDS, jnp.int32),
                                _to_jax(block))
    untouched = kv[:, :, [0, 2, 3]].clone()
    got = scatter_kv_pages(kv, IDS, block)
    assert got is kv                                 # in place
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(kv[:, :, [0, 2, 3]]),
                                  _bits(untouched))


def test_scatter_then_gather_round_trip():
    kv = _pool(torch.float32, seed=3)
    block = gather_kv_pages(kv, IDS).clone()
    fresh = torch.full_like(kv, float("nan"))
    scatter_kv_pages(fresh, [3, 0, 2], block)
    np.testing.assert_array_equal(_bits(gather_kv_pages(fresh, [3, 0, 2])),
                                  _bits(block))


@pytest.mark.parametrize("ids,err", [([0, 6], IndexError),
                                     ([-1], IndexError)])
def test_ids_checked_on_the_host(ids, err):
    kv = _pool(torch.float32)
    with pytest.raises(err):
        gather_kv_pages(kv, ids)
    with pytest.raises(err):
        scatter_kv_pages(kv, ids, torch.zeros((2, 2, len(ids), 2, 4, 8)))


def test_scatter_rejects_repeats_and_bad_blocks():
    kv = _pool(torch.float32)
    with pytest.raises(ValueError, match="repeated"):
        scatter_kv_pages(kv, [1, 1], torch.zeros((2, 2, 2, 2, 4, 8)))
    with pytest.raises(ValueError, match="block shape"):
        scatter_kv_pages(kv, [1, 2], torch.zeros((2, 2, 3, 2, 4, 8)))
