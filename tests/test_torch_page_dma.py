"""Kernels 4-5's plain versions (the port's ``gather_kv_pages`` /
``scatter_kv_pages`` on CPU tensors) against the reference's Pallas page
movers run in interpret mode (``XLLM_PALLAS_INTERPRET=1``), on a
``[L, 2, P, n_kv, ps, hd]`` pool with shuffled ids and NaN in every page
the call must not touch.

Both are pure copies, so results are compared bit for bit (as unsigned
integer views, which also pins NaN payloads).

The same holds for a pool sharded four ways over a ``seq`` mesh of CPU
devices (``ShardedPages``), against the reference's movers on the same
pool unsharded; and the launch plan that groups a block's pages by the
device of their shard is checked as a plain function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.ops import pallas_page_dma as ref
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
from xllm_service_tpu_torch.ops.page_dma import (
    Launch,
    gather_kv_pages,
    launch_plan,
    scatter_kv_pages,
)
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

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


# ------------------------------------------------------ sharded over seq
SHARDED = (2, 2, 12, 2, 4, 8)       # P 12: four shards of 3 pages
SHARDED_IDS = [10, 2, 3, 7, 0, 5]   # every shard; [2, 3] straddles 0 and 1


def _sharded(kv: torch.Tensor) -> ShardedPages:
    mesh = build_mesh(MeshConfig(seq=4), ["cpu"] * 4)
    return ShardedPages([c.clone() for c in kv.chunk(4, dim=2)], mesh)


def _sharded_pool(dtype, seed):
    rng = np.random.default_rng(seed)
    kv = torch.from_numpy(rng.standard_normal(SHARDED).astype(np.float32))
    kv = kv.to(dtype)
    kv[:, :, [p for p in range(12) if p not in SHARDED_IDS]] = float("nan")
    return kv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_gather_bit_identical_to_pallas(dtype):
    kv = _sharded_pool(dtype, seed=4)
    pool = _sharded(kv)
    got = gather_kv_pages(pool, SHARDED_IDS)
    want = ref.gather_kv_pages(_to_jax(kv), jnp.asarray(SHARDED_IDS,
                                                        jnp.int32))
    assert tuple(got.shape) == (2, 2, len(SHARDED_IDS), 2, 4, 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_scatter_bit_identical_to_pallas(dtype):
    kv = _sharded_pool(dtype, seed=5)
    pool = _sharded(kv)
    block = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 2, len(SHARDED_IDS), 2, 4, 8)).astype(np.float32)).to(dtype)
    want = ref.scatter_kv_pages(_to_jax(kv), jnp.asarray(SHARDED_IDS,
                                                         jnp.int32),
                                _to_jax(block))
    assert scatter_kv_pages(pool, SHARDED_IDS, block) is pool
    np.testing.assert_array_equal(_bits(pool.full()), _bits(want))


def test_sharded_ids_checked_on_the_host():
    pool = _sharded(_sharded_pool(torch.float32, seed=7))
    block = torch.zeros((2, 2, 2, 2, 4, 8))
    for ids in ([3, 12], [-1, 3]):
        with pytest.raises(IndexError):
            gather_kv_pages(pool, ids)
        with pytest.raises(IndexError):
            scatter_kv_pages(pool, ids, block)
    with pytest.raises(ValueError, match="repeated"):
        scatter_kv_pages(pool, [4, 4], block)


def test_launch_plan_one_device_four_shards():
    """Four shards on one device: one launch, each entry naming its
    shard, its page within the shard and its block slot."""
    cpu = torch.device("cpu")
    plan = launch_plan(SHARDED_IDS, 3, [cpu] * 4)
    assert plan == [Launch(cpu, shards=(3, 0, 1, 2),
                           owner=(0, 1, 2, 3, 1, 2),
                           local=(1, 2, 0, 1, 0, 2),
                           slots=(0, 1, 2, 3, 4, 5))]
    unsharded = launch_plan([4, 1, 5], 6, [cpu])
    assert unsharded == [Launch(cpu, (0,), (0, 0, 0), (4, 1, 5), (0, 1, 2))]


def test_launch_plan_four_devices():
    """One shard per device: one launch per device that holds pages of
    the block, the block's device (the first) first."""
    devs = [torch.device("cuda", i) for i in range(4)]
    plan = launch_plan([10, 2, 3, 7, 5], 3, devs)
    assert plan == [
        Launch(devs[0], (0,), (0,), (2,), (1,)),
        Launch(devs[1], (1,), (0, 0), (0, 2), (2, 4)),
        Launch(devs[2], (2,), (0,), (1,), (3,)),
        Launch(devs[3], (3,), (0,), (1,), (0,))]
    # Shard 0's device holds none of these pages: no launch there.
    assert [p.device for p in launch_plan([9, 4], 3, devs)] == \
        [devs[1], devs[3]]


def test_launch_plan_splits_at_the_kernel_limits():
    cpu = torch.device("cpu")
    plan = launch_plan(list(range(1, 8)), 100, [cpu], max_slots=3)
    assert [p.slots for p in plan] == [(0, 1, 2), (3, 4, 5), (6,)]
    assert [p.local for p in plan] == [(1, 2, 3), (4, 5, 6), (7,)]
    plan = launch_plan([0, 2, 4, 6], 1, [cpu] * 8, max_slots=8,
                       max_shards=2)
    assert [p.shards for p in plan] == [(0, 2), (4, 6)]
    assert [p.owner for p in plan] == [(0, 1), (0, 1)]
