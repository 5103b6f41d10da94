"""The CUDA kernels against their plain versions, on the card: the two
attention kernels, the fused append-and-attend, the page movers (bit for
bit: they are copies), the context-parallel partial and the CP op, and the
engine's tier round trip and context-parallel serving through them.

Marked ``cuda``: they need a GPU and nvcc and skip elsewhere. Run them on
a machine with an H100 with ``python -m pytest -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances: f32 kernels sum in another order than the plain versions
(1e-4 absolute on outputs of magnitude ~1); bf16 outputs are rounded once
from f32 on both sides, so they differ by at most one bf16 ulp (2e-2 on
outputs below 4). The context-parallel partial's raw statistics (f32 on
both sides) are compared within the same tolerances after dividing l and
acc by max(l, 1): both are sums of up to ctx terms weighted by p <= 1.
"""

import threading
import time

import numpy as np
import pytest
import torch

from xllm_service_tpu_torch.ops import attention, page_dma
from xllm_service_tpu_torch.ops import cp_paged_attention as cp
from xllm_service_tpu_torch.ops import fused_decode_attention as fused_mod
from xllm_service_tpu_torch.ops.fused_decode_attention import (
    fused_decode_attention,
    fused_decode_attention_plain,
)
from xllm_service_tpu_torch.ops.mq_paged_attention import (
    mq_paged_attention,
    mq_paged_attention_plain,
    mq_route,
)
from xllm_service_tpu_torch.ops.paged_attention import (
    NEG_INF,
    paged_attention,
    paged_attention_plain,
    split_count,
)
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _pool(dev, dtype, P, n_kv, ps, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn((P, n_kv, ps, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((P, n_kv, ps, hd), generator=g, device=dev).to(dtype)
    return k, v


def _poison_past(k, v, pt, ends, ps):
    """NaN into every slot of each row's table at positions >= ends[b]."""
    for b, end in enumerate(ends):
        for pos in range(end, pt.shape[1] * ps):
            k[pt[b, pos // ps], :, pos % ps] = float("nan")
            v[pt[b, pos // ps], :, pos % ps] = float("nan")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_kv,hd", [(8, 2, 128), (32, 8, 128),
                                         (4, 2, 32)])
def test_decode_kernel_matches_plain(dev, dtype, n_q, n_kv, hd):
    B, ps, mp = 5, 16, 6
    k, v = _pool(dev, dtype, B * mp + 1, n_kv, ps, hd, 0)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    ctx = [0, 1, 17, 50, 96]
    _poison_past(k, v, pt.cpu(), ctx, ps)
    q = torch.randn((B, n_q, hd), device=dev).to(dtype)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    got = paged_attention(q, k, v, pt, cl)
    want = paged_attention_plain(q, k, v, pt, cl)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("opts", [{"softcap": 30.0}, {"window": 40},
                                  {"scale": 0.0625, "softcap": 50.0,
                                   "window": 33}])
def test_decode_kernel_gemma2_options(dev, opts):
    B, ps, mp = 4, 16, 6
    k, v = _pool(dev, torch.float32, B * mp + 1, 4, ps, 128, 1)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    q = torch.randn((B, 8, 128), device=dev)
    cl = torch.tensor([96, 41, 8, 64], dtype=torch.int32, device=dev)
    got = paged_attention(q, k, v, pt, cl, **opts)
    want = paged_attention_plain(q, k, v, pt, cl, **opts)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx,opts", [
    ([3, 67, 1029, 2048], {}),           # shorter than a split; a split that
                                         # holds part of one page; full table
    ([777], {}),                         # one row: the most splits
    ([1000, 301, 0, 300], {"window": 300}),   # the window starts inside a
    ([1000], {"window": 300, "softcap": 30.0}),   # later split's unit
])
def test_decode_kernel_split_k_edges(dev, dtype, ctx, opts):
    """Wide tables (128 pages), so the wrapper splits each (row, KV head)
    over several blocks: every split's share, empty splits and the merge."""
    B, n_q, n_kv, hd, ps, mp = len(ctx), 32, 8, 128, 16, 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert split_count(B, n_kv, mp, ps, sms) > 1
    k, v = _pool(dev, dtype, B * mp + 1, n_kv, ps, hd, 10)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    dead = (torch.arange(mp * ps, device=dev)[None, :] >= cl[:, None])
    b_idx, p_idx = dead.nonzero(as_tuple=True)
    page = pt[b_idx, p_idx // ps].long()
    k[page, :, p_idx % ps] = float("nan")
    v[page, :, p_idx % ps] = float("nan")
    q = torch.randn((B, n_q, hd), device=dev).to(dtype)
    for _ in range(2):          # twice: the merge's tickets reset themselves
        got = paged_attention(q, k, v, pt, cl, **opts)
        want = paged_attention_plain(q, k, v, pt, cl, **opts)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        for b, c in enumerate(ctx):
            assert c > 0 or (got[b] == 0).all()
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_decode_kernel_group_of_16(dev):
    """The widest GQA group the kernel reports (16 query heads per KV head),
    in both types."""
    B, n_q, n_kv, hd, ps, mp = 3, 32, 2, 128, 16, 40
    for dtype in (torch.bfloat16, torch.float32):
        k, v = _pool(dev, dtype, B * mp + 1, n_kv, ps, hd, 11)
        pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
              .reshape(B, mp) + 1)
        q = torch.randn((B, n_q, hd), device=dev).to(dtype)
        cl = torch.tensor([640, 17, 333], dtype=torch.int32, device=dev)
        got = paged_attention(q, k, v, pt, cl)
        want = paged_attention_plain(q, k, v, pt, cl)
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mq_kernel_tile_edges(dev, dtype):
    """An Sq that is no multiple of the 16-query tile, a row whose block
    length is 0 (all padding: zeros), a row that ends inside a tile."""
    B, s_q, n_q, n_kv, hd, ps, mp = 3, 70, 32, 8, 128, 16, 16
    prefix = 100
    k, v = _pool(dev, dtype, B * mp + 1, n_kv, ps, hd, 12)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    blocks = [70, 0, 41]
    _poison_past(k, v, pt.cpu(), [prefix + b for b in blocks], ps)
    q = torch.randn((B, s_q, n_q, hd), device=dev).to(dtype)
    pre = torch.full((B,), prefix, dtype=torch.int32, device=dev)
    blk = torch.tensor(blocks, dtype=torch.int32, device=dev)
    got = mq_paged_attention(q, k, v, pt, pre, blk)
    want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all() and (got[2, 41:] == 0).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_mq_kernel_bf16_shapes_off_the_tensor_core_path(dev):
    """bf16 with a GQA group that does not divide 64 takes the f32 walk (the
    route the wrapper names), and agrees with the plain version."""
    B, s_q, n_q, n_kv, hd, ps, mp = 2, 19, 6, 2, 128, 16, 8
    assert mq_route(torch.bfloat16, hd, ps, n_q // n_kv) == "walk"
    k, v = _pool(dev, torch.bfloat16, B * mp + 1, n_kv, ps, hd, 13)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    q = torch.randn((B, s_q, n_q, hd), device=dev).to(torch.bfloat16)
    pre = torch.tensor([40, 3], dtype=torch.int32, device=dev)
    blk = torch.tensor([19, 7], dtype=torch.int32, device=dev)
    got = mq_paged_attention(q, k, v, pt, pre, blk)
    want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
    assert (got.float() - want.float()).abs().max().item() <= TOL[
        torch.bfloat16]


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """A CUDA tensor never takes the plain version: an unsupported type or
    shape raises."""
    B, n_q, n_kv, ps, mp = 2, 8, 2, 16, 4
    pt = torch.ones((B, mp), dtype=torch.int32, device=dev)
    cl = torch.full((B,), 5, dtype=torch.int32, device=dev)

    def decode(dtype, hd, page_size=ps):
        q = torch.zeros((B, n_q, hd), dtype=dtype, device=dev)
        kp = torch.zeros((B * mp + 1, n_kv, page_size, hd), dtype=dtype,
                         device=dev)
        return paged_attention(q, kp, kp.clone(), pt, cl)

    def prefill(dtype, hd, page_size=ps):
        q = torch.zeros((B, 3, n_q, hd), dtype=dtype, device=dev)
        kp = torch.zeros((B * mp + 1, n_kv, page_size, hd), dtype=dtype,
                         device=dev)
        return mq_paged_attention(q, kp, kp.clone(), pt, cl, cl)

    for fn in (decode, prefill):
        with pytest.raises(TypeError, match="f32 or bf16"):
            fn(torch.float16, 128)
        with pytest.raises(ValueError, match="not supported"):
            fn(torch.bfloat16, 48)              # head dim
        with pytest.raises(ValueError, match="not supported"):
            fn(torch.float32, 128, page_size=24)    # page size
    q = torch.zeros((B, 34, 128), dtype=torch.bfloat16, device=dev)
    kp = torch.zeros((B * mp + 1, 2, ps, 128), dtype=torch.bfloat16,
                     device=dev)
    with pytest.raises(ValueError, match="exceed"):
        paged_attention(q, kp, kp.clone(), pt, cl)      # a group of 17
    with pytest.raises(TypeError, match="int32"):
        decode_lens = cl.long()
        paged_attention(q[:, :8].contiguous(), kp, kp.clone(), pt,
                        decode_lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,prefix", [(1, 5), (17, 0), (17, 37),
                                        (70, 128)])
def test_mq_kernel_matches_plain(dev, dtype, s_q, prefix):
    B, n_q, n_kv, hd, ps, mp = 3, 32, 8, 128, 16, 16
    k, v = _pool(dev, dtype, B * mp + 1, n_kv, ps, hd, 2)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    blocks = [s_q, max(1, s_q // 2), max(1, s_q - 3)]
    _poison_past(k, v, pt.cpu(), [prefix + b for b in blocks], ps)
    q = torch.randn((B, s_q, n_q, hd), device=dev).to(dtype)
    pre = torch.full((B,), prefix, dtype=torch.int32, device=dev)
    blk = torch.tensor(blocks, dtype=torch.int32, device=dev)
    got = mq_paged_attention(q, k, v, pt, pre, blk)
    want = mq_paged_attention_plain(q, k, v, pt, pre, blk)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_prefill_attention_routes_through_the_mq_kernel(dev):
    B, S, n_q, n_kv, hd, ps = 1, 20, 8, 2, 128, 16
    k_pages, v_pages = _pool(dev, torch.float32, 8, n_kv, ps, hd, 3)
    pt = torch.arange(1, 8, dtype=torch.int32, device=dev)[None]
    q = torch.randn((B, S, n_q, hd), device=dev)
    k = torch.randn((B, S, n_kv, hd), device=dev)
    v = torch.randn((B, S, n_kv, hd), device=dev)
    pre = torch.tensor([35], dtype=torch.int32, device=dev)
    lens = torch.tensor([S], dtype=torch.int32, device=dev)
    attention.write_prefill_kv(k_pages, v_pages, k, v, pt, pre, lens)
    before = mq_paged_attention.launches
    got = attention.prefill_attention(q, k, v, k_pages, v_pages, pt, pre,
                                      lens, has_prefix=True)
    assert mq_paged_attention.launches == before + 1
    want = attention.prefill_attention(q.cpu(), k.cpu(), v.cpu(),
                                       k_pages.cpu(), v_pages.cpu(),
                                       pt.cpu(), pre.cpu(), lens.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


# ------------------------------------------------- kernel 3: fused decode
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_kv,hd", [(8, 2, 128), (32, 8, 128),
                                         (4, 2, 32)])
def test_fused_decode_kernel_matches_plain(dev, dtype, n_q, n_kv, hd):
    B, ps, mp = 6, 16, 6
    k, v = _pool(dev, dtype, B * mp + 1, n_kv, ps, hd, 4)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    ctx = [0, 1, 16, 17, 50, 96]
    # NaN from the new token's position on: never read, the slot rewritten.
    _poison_past(k, v, pt.cpu(), [max(c - 1, 0) for c in ctx], ps)
    q = torch.randn((B, n_q, hd), device=dev).to(dtype)
    k_new = torch.randn((B, n_kv, hd), device=dev).to(dtype)
    v_new = torch.randn((B, n_kv, hd), device=dev).to(dtype)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    kp, vp = k.clone(), v.clone()
    before = fused_decode_attention.launches
    got, kp_out, vp_out = fused_decode_attention(q, k_new, v_new, kp, vp, pt,
                                                 cl)
    want, _, _ = fused_decode_attention_plain(q, k_new, v_new, k, v, pt, cl)
    torch.cuda.synchronize()
    assert fused_decode_attention.launches == before + 1
    assert kp_out is kp and vp_out is vp
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(kp.view(bits), k.view(bits))
    assert torch.equal(vp.view(bits), v.view(bits))
    # The ctx-0 row attends only the new token.
    assert (got[0].float() - v_new[0].float().repeat_interleave(
        n_q // n_kv, dim=0)).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx", [[4, 68, 1030, 2048], [778]])
@pytest.mark.parametrize("splits", [None, 1, 3, 8])
def test_fused_decode_kernel_split_k_edges(dev, monkeypatch, dtype, ctx,
                                           splits):
    """Wide tables (128 pages) at the wrapper's split count (None) and at
    counts forced on it: a walk shorter than one split (ctx 4), a last split
    holding part of one page (68), empty splits, one row alone; twice, as
    the merge's tickets reset themselves. Output within TOL, pools bit for
    bit."""
    B, n_q, n_kv, hd, ps, mp = len(ctx), 32, 8, 128, 16, 128
    if splits is not None:
        monkeypatch.setattr(fused_mod, "split_count",
                            lambda *args: splits)
    k, v = _pool(dev, dtype, B * mp + 1, n_kv, ps, hd, 12)
    pt = (torch.arange(B * mp, dtype=torch.int32, device=dev)
          .reshape(B, mp) + 1)
    _poison_past(k, v, pt.cpu(), [c - 1 for c in ctx], ps)
    q = torch.randn((B, n_q, hd), device=dev).to(dtype)
    k_new = torch.randn((B, n_kv, hd), device=dev).to(dtype)
    v_new = torch.randn((B, n_kv, hd), device=dev).to(dtype)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    want, k_want, v_want = fused_decode_attention_plain(
        q, k_new, v_new, k.clone(), v.clone(), pt, cl)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for _ in range(2):
        kp, vp = k.clone(), v.clone()
        got = fused_decode_attention(q, k_new, v_new, kp, vp, pt, cl)[0]
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        assert torch.equal(kp.view(bits), k_want.view(bits))
        assert torch.equal(vp.view(bits), v_want.view(bits))


def test_decode_step_routes_through_the_fused_kernel(dev, monkeypatch):
    B, n_q, n_kv, hd, ps = 3, 8, 2, 128, 16
    k, v = _pool(dev, torch.float32, 13, n_kv, ps, hd, 5)
    pt = torch.arange(1, 13, dtype=torch.int32, device=dev).reshape(B, 4)
    q = torch.randn((B, n_q, hd), device=dev)
    kn = torch.randn((B, n_kv, hd), device=dev)
    vn = torch.randn((B, n_kv, hd), device=dev)
    cl = torch.tensor([5, 33, 64], dtype=torch.int32, device=dev)
    want = attention.decode_attention_step(q, kn, vn, k.clone(), v.clone(),
                                           pt, cl)[0]
    monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    fused_before = fused_decode_attention.launches
    paged_before = paged_attention.launches
    got = attention.decode_attention_step(q, kn, vn, k, v, pt, cl)[0]
    assert fused_decode_attention.launches == fused_before + 1
    assert paged_attention.launches == paged_before
    assert (got - want).abs().max().item() <= 1e-4


# ---------------------------------------------- kernels 4-5: page movers
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (4, 2, 20, 8, 16, 128)),    # Llama-3-8B page rows
    (torch.float32, (2, 2, 9, 2, 16, 32)),
    (torch.bfloat16, (2, 2, 7, 1, 1, 3)),        # 6-byte rows: byte loop
])
def test_page_movers_match_plain(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(7)
    kv = torch.randn(shape, generator=g, device=dev).to(dtype)
    ids = [5, 0, 3, 6]
    untouched = [p for p in range(shape[2]) if p not in ids]
    kv[:, :, untouched] = float("nan")
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    g0, s0 = page_dma.gather_kv_pages.launches, \
        page_dma.scatter_kv_pages.launches
    got = page_dma.gather_kv_pages(kv, ids)
    assert torch.equal(got.view(bits),
                       page_dma.gather_kv_pages_plain(kv, ids).view(bits))
    block = torch.randn(got.shape, generator=g, device=dev)   # f32: cast
    pool, ref = kv.clone(), kv.clone()
    page_dma.scatter_kv_pages(pool, torch.tensor(ids), block)
    page_dma.scatter_kv_pages_plain(ref, ids, block)
    torch.cuda.synchronize()
    assert torch.equal(pool.view(bits), ref.view(bits))
    assert torch.equal(pool[:, :, untouched].view(bits),
                       kv[:, :, untouched].view(bits))
    assert (page_dma.gather_kv_pages.launches,
            page_dma.scatter_kv_pages.launches) == (g0 + 1, s0 + 1)


def _mover_pool(dev, dtype, shape, ids, seed):
    """A pool with NaN in every page outside ``ids``, and a block."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = torch.randn(shape, generator=g, device=dev).to(dtype)
    kv[:, :, [p for p in range(shape[2]) if p not in ids]] = float("nan")
    block = torch.randn((*shape[:2], len(ids), *shape[3:]), generator=g,
                        device=dev).to(dtype)
    return kv, block


def _check_movers(kv, pool_of, full_of, ids, block, launches):
    """Gather and scatter on ``pool_of(kv)`` against the plain versions,
    bit for bit, each call ``launches`` launches."""
    bits = {2: torch.int16, 4: torch.int32}[kv.element_size()]
    g0, s0 = page_dma.gather_kv_pages.launches, \
        page_dma.scatter_kv_pages.launches
    got = page_dma.gather_kv_pages(pool_of(kv), ids)
    assert torch.equal(got.view(bits), page_dma.gather_kv_pages_plain(
        kv, ids).view(bits))
    pool, ref = pool_of(kv), kv.clone()
    page_dma.scatter_kv_pages(pool, ids, block)
    page_dma.scatter_kv_pages_plain(ref, ids, block)
    torch.cuda.synchronize()
    assert torch.equal(full_of(pool).view(bits), ref.view(bits))
    assert (page_dma.gather_kv_pages.launches - g0,
            page_dma.scatter_kv_pages.launches - s0) == (launches, launches)


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (4, 2, 20, 8, 16, 128)),    # Llama-3-8B page rows
    (torch.float32, (2, 2, 12, 2, 16, 32)),
    (torch.bfloat16, (2, 2, 8, 1, 1, 3)),        # 6-byte rows: byte loop
])
def test_sharded_page_movers_one_launch(dev, dtype, shape):
    """Four shards on one card (the seq mesh of one card): one launch per
    call whatever the block's spread, bit-identical to plain."""
    P = shape[2]
    ids = [P - 1, 1, P // 4, P // 2 + 1]           # all four shards
    kv, block = _mover_pool(dev, dtype, shape, ids, seed=8)
    mesh = build_mesh(MeshConfig(seq=4), [dev] * 4)

    def shard(t):
        return cp.ShardedPages([c.contiguous() for c in t.chunk(4, dim=2)],
                               mesh)

    _check_movers(kv, shard, lambda p: p.full(), ids, block, 1)


@pytest.mark.parametrize("stages,chunk,per_sm", [
    (2, 16, 1), (2, 48, 2), (3, 4096, 1), (8, 1 << 10, 4), (4, 16 << 10, 2)])
def test_page_movers_any_ring_shape(dev, monkeypatch, stages, chunk, per_sm):
    """The bulk route's ring at shapes off the shipped one: chunks that do
    not divide a row (48 bytes into 4096), the fewest stages, more stages
    than a block has units."""
    for name, val in (("STAGES", stages), ("CHUNK_BYTES", chunk),
                      ("BLOCKS_PER_SM", per_sm)):
        monkeypatch.setattr(page_dma, name, val)
    ids = [6, 0, 3, 9, 1]
    kv, block = _mover_pool(dev, torch.float32, (3, 2, 11, 2, 16, 32), ids,
                            seed=9)
    _check_movers(kv, torch.Tensor.clone, lambda p: p, ids, block, 1)


def test_page_movers_split_past_the_slot_limit(dev):
    """More pages than one launch's table holds: one launch per full
    table, still bit-identical."""
    P = 700
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))
    ids = (ids[:600] + 1).tolist()
    kv, block = _mover_pool(dev, torch.bfloat16, (1, 2, P, 1, 2, 8), ids,
                            seed=10)
    _check_movers(kv, torch.Tensor.clone, lambda p: p, ids, block, 3)


def test_sharded_page_movers_on_four_cards(dev):
    """One shard per card: a launch on each card that holds pages of the
    block; the gather assembles the block on the first card, the scatter
    sends each card its slots."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    devs = [torch.device("cuda", i) for i in range(4)]
    ids = [22, 1, 7, 13, 18, 2]
    kv, block = _mover_pool(dev, torch.bfloat16, (4, 2, 24, 8, 16, 128), ids,
                            seed=11)
    mesh = build_mesh(MeshConfig(seq=4), devs)

    def shard(t):
        return cp.ShardedPages([c.to(d).contiguous() for c, d in
                                zip(t.chunk(4, dim=2), devs)], mesh)

    _check_movers(kv, shard, lambda p: p.full(), ids, block, 4)


def test_page_movers_refuse_device_ids_and_foreign_blocks(dev):
    kv = torch.zeros((1, 2, 4, 1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="host"):
        page_dma.gather_kv_pages(kv, torch.tensor([1], device=dev))
    with pytest.raises(ValueError, match="block on"):
        page_dma.scatter_kv_pages(kv, [1], torch.zeros((1, 2, 1, 1, 2, 8)))


def test_engine_tier_round_trip_on_the_card(dev):
    """The engine's fence on the card: gather on the engine's stream, the
    download on the tier stream into pinned memory, the upload and scatter
    ahead of the prefill. Greedy tokens survive the round trip."""
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )
    from xllm_service_tpu_torch.models.base import tiny_config

    eng = InferenceEngine(EngineConfig(
        model=tiny_config(dtype=torch.float32, max_context_len=256),
        num_pages=10, page_size=16, hash_block_size=32, max_batch_size=4,
        max_seq_len=256, kv_tier_dram_bytes=64 << 20,
        kv_tier_ssd_bytes=64 << 20), device=dev)

    def run(rid, prompt):
        toks, done = [], threading.Event()

        def on_output(out):
            for s in out.outputs:
                toks.extend(s.token_ids)
            if out.finished:
                done.set()

        eng.submit(EngineRequest(rid, token_ids=prompt, on_output=on_output,
                                 sampling=SamplingParams(
                                     max_tokens=8, temperature=0.0,
                                     ignore_eos=True)))
        while not done.is_set():
            eng.step()
        return toks

    g0 = page_dma.gather_kv_pages.launches
    s0 = page_dma.scatter_kv_pages.launches
    try:
        first = run("a1", list(range(100, 196)))
        run("b1", list(range(300, 428)))
        store = eng.tier_store
        t0 = time.monotonic()
        while store.offload_total < 3:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        assert run("a2", list(range(100, 196))) == first
        assert store.onload_total >= 2
        assert page_dma.gather_kv_pages.launches > g0
        assert page_dma.scatter_kv_pages.launches > s0
    finally:
        eng.stop()


@pytest.mark.parametrize("cards", [1, 4])
def test_engine_tiers_under_a_seq_mesh_on_the_card(dev, cards):
    """tests/test_torch_tier_seq_parallel.py's round trip (DRAM+SSD case)
    on a seq=4 mesh of one card (four shards on it) or of four cards: A's
    blocks straddle shards 0 and 1 when evicted and come back bit for bit;
    the first token after the onload equals the first one from HBM; the
    movers' launches as the launch plan gives them, kernel 6 launched."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    from xllm_service_tpu_torch.common.hashing import prefix_block_hashes
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )
    from xllm_service_tpu_torch.models.base import tiny_config

    devs = [torch.device("cuda", i % cards) for i in range(4)]
    blk = 2 * 2 * 2 * 2 * 16 * 32 * 4
    eng = InferenceEngine(EngineConfig(
        model=tiny_config(dtype=torch.float32, max_context_len=256),
        num_pages=12, page_size=16, hash_block_size=32, max_batch_size=2,
        max_seq_len=256, kv_tier_dram_bytes=blk, kv_tier_ssd_bytes=4 * blk,
        kv_tier_threads=1), mesh=build_mesh(MeshConfig(seq=4), devs))

    def run(rid, prompt, n=6):
        toks, done = [], threading.Event()

        def on_output(out):
            for s in out.outputs:
                toks.extend(s.token_ids)
            if out.finished:
                done.set()

        eng.submit(EngineRequest(rid, token_ids=prompt, on_output=on_output,
                                 sampling=SamplingParams(
                                     max_tokens=n, temperature=0.0,
                                     ignore_eos=True)))
        while not done.is_set():
            eng.step()
        return toks

    rng = np.random.default_rng(5)
    prompt_a = rng.integers(3, 250, size=96).tolist()
    hashes = [h.hex() for h in prefix_block_hashes(prompt_a, 32)][:2]
    store = eng.tier_store
    counts = (page_dma.gather_kv_pages, page_dma.scatter_kv_pages,
              cp.paged_partial)
    before_counts = [f.launches for f in counts]
    try:
        run("w", list(range(300, 316)), n=17)
        first = run("a1", prompt_a)
        pages = [eng.page_mgr._blocks[h].pages for h in hashes]
        assert pages == [[3, 2], [1, 4]]          # across shards 0 and 1
        before = [page_dma.gather_kv_pages_plain(eng.kv_pages, p)
                  for p in pages]
        run("u1", rng.integers(250, 500, size=90).tolist(), n=24)
        t0 = time.monotonic()
        while not all(store.ready(h) for h in hashes):
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        assert [store.tier_of(h) for h in hashes] == ["ssd", "dram"]
        again = run("a2", prompt_a)
        while store._pending:
            time.sleep(0.01)
        after = [page_dma.gather_kv_pages_plain(
            eng.kv_pages, eng.page_mgr._blocks[h].pages) for h in hashes]
        launches = [f.launches - b for f, b in zip(counts, before_counts)]
        st = store.stats()
    finally:
        eng.stop()
    assert again[0] == first[0]
    for want, got in zip(before, after):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert st["onload_total"] == 2 and st["demote_total"] == 1
    # Per offloaded block one launch on one card; on four, one per card
    # holding its pages ([3, 2], [1, 4] and [5, 6]: two cards each). The
    # restored blocks lie on one shard each.
    assert st["offload_total"] == 3
    assert launches[0] == (3 if cards == 1 else 6)
    assert launches[1] == 2 and launches[2] > 0


# ----------------------------------------- kernel 6: context-parallel partial
def _poison_unowned(k, v, pt, ctxs, ps):
    """NaN into every (page, slot) that no row occupies below its context."""
    keep = torch.zeros((k.shape[0], ps), dtype=torch.bool, device=k.device)
    for b, ctx in enumerate(ctxs):
        pos = torch.arange(ctx, device=k.device)
        keep[pt[b, pos // ps].long(), pos % ps] = True
    k.masked_fill_(~keep[:, None, :, None], float("nan"))
    v.masked_fill_(~keep[:, None, :, None], float("nan"))


def _cp_case(dev, dtype, n_q, n_kv, hd, mp, ctxs, seed):
    """A pool of B * mp + 4 pages, tables a permutation across all of it,
    row 1 (if any) on the garbage page, NaN outside the occupied slots."""
    B, ps = len(ctxs), 16
    P = B * mp + 4
    k, v = _pool(dev, dtype, P, n_kv, ps, hd, seed)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(seed))
    pt = (perm[:B * mp] + 1).reshape(B, mp).to(torch.int32).to(dev)
    if B > 1:
        pt[1] = 0
    _poison_unowned(k, v, pt, ctxs, ps)
    q = torch.randn((B, n_q, hd), device=dev).to(dtype)
    cl = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    return q, k, v, pt, cl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("n_q,n_kv,hd", [(32, 8, 128), (8, 2, 128),
                                         (4, 2, 32)])
def test_cp_partial_kernel_matches_plain(dev, dtype, n, n_q, n_kv, hd):
    ctxs = [0, 1, 16, 17, 500, 777, 1024, 2048]
    q, k, v, pt, cl = _cp_case(dev, dtype, n_q, n_kv, hd, 128, ctxs, 8)
    P_loc = k.shape[0] // n
    k_sh, v_sh = list(k.chunk(n)), list(v.chunk(n))
    for d in range(n):
        tables = cp.compact_local_table(pt, cl, d * P_loc, P_loc, 16)
        before = cp.paged_partial.launches
        m, l, acc = cp.paged_partial(q, k_sh[d], v_sh[d], *tables, cl)
        m0, l0, a0 = cp.paged_partial_plain(q, k_sh[d], v_sh[d], *tables, cl)
        torch.cuda.synchronize()
        assert cp.paged_partial.launches == before + 1
        dead = m0 <= NEG_INF / 2
        assert torch.equal(dead, m <= NEG_INF / 2)
        assert (m[dead] == NEG_INF).all() and (l[dead] == 0).all()
        assert (acc[dead] == 0).all()
        lsc = l0.clamp_min(1.0)
        assert (m - m0)[~dead].abs().max().item() <= TOL[dtype]
        assert ((l - l0).abs() / lsc).max().item() <= TOL[dtype]
        assert ((acc - a0).abs() / lsc[..., None]).max().item() <= TOL[dtype]
    got = cp.cp_paged_attention(q, k_sh, v_sh, pt, cl,
                                build_mesh(MeshConfig(seq=n), [dev] * n))
    want = paged_attention_plain(q, k, v, pt, cl)
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("splits", [None, 1, 3, 8])
def test_cp_partial_kernel_split_k_edges(dev, monkeypatch, dtype, n, splits):
    """Kernel 1's split-K edges per shard, at the wrapper's split count
    (None) and at counts forced on it: a context shorter than one split
    (3), a last split holding part of one page (67), row 3 whose last,
    partial page is all the last shard owns of it, empty rows, and one row
    alone; twice each, as the merge's tickets reset themselves."""
    if splits is not None:
        monkeypatch.setattr(cp, "partial_split_count", lambda *args: splits)
    for ctxs in ([67, 3, 33, 53, 0, 1029, 130, 2048], [777]):
        q, k, v, pt, cl = _cp_case(dev, dtype, 32, 8, 128, 128, ctxs, 13)
        if len(ctxs) > 3:
            # Row 3: pages 1-3 in shard 0's range, its last in the last's.
            P = k.shape[0]
            pt[3, :4] = torch.tensor([1, 2, 3, P - 1], dtype=torch.int32)
            k, v = _pool(dev, dtype, P, 8, 16, 128, 13)
            _poison_unowned(k, v, pt, ctxs, 16)
        P_loc = k.shape[0] // n
        k_sh, v_sh = list(k.chunk(n)), list(v.chunk(n))
        for d in range(n):
            tables = cp.compact_local_table(pt, cl, d * P_loc, P_loc, 16)
            m0, l0, a0 = cp.paged_partial_plain(q, k_sh[d], v_sh[d], *tables,
                                                cl)
            dead = m0 <= NEG_INF / 2
            lsc = l0.clamp_min(1.0)
            for _ in range(2):
                m, l, acc = cp.paged_partial(q, k_sh[d], v_sh[d], *tables, cl,
                                             shards=n)
                torch.cuda.synchronize()
                assert torch.equal(dead, m <= NEG_INF / 2)
                assert (m[dead] == NEG_INF).all() and (l[dead] == 0).all()
                assert (acc[dead] == 0).all()
                if (~dead).any():
                    assert (m - m0)[~dead].abs().max().item() <= TOL[dtype]
                assert ((l - l0).abs() / lsc).max().item() <= TOL[dtype]
                assert ((acc - a0).abs() / lsc[..., None]).max().item() \
                    <= TOL[dtype]


def test_cp_decode_step_routes_through_kernel_6(dev, monkeypatch):
    """A decode step on a sharded pool: the write lands on the owning
    shards and kernel 6 runs once per shard; kernels 1 and 3 stay idle even
    under XLLM_KV_WRITEBACK=fused."""
    monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    B, n_q, n_kv, hd, ps, n = 3, 8, 2, 128, 16, 4
    k, v = _pool(dev, torch.float32, 16, n_kv, ps, hd, 9)
    pt = torch.tensor([[5, 9, 14, 2], [1, 6, 11, 0], [13, 3, 0, 0]],
                      dtype=torch.int32, device=dev)
    cl = torch.tensor([60, 40, 17], dtype=torch.int32, device=dev)
    q = torch.randn((B, n_q, hd), device=dev)
    kn = torch.randn((B, n_kv, hd), device=dev)
    vn = torch.randn((B, n_kv, hd), device=dev)
    mesh = build_mesh(MeshConfig(seq=n), [dev] * n)
    kp = cp.ShardedPages(list(k.clone().chunk(n)), mesh)
    vp = cp.ShardedPages(list(v.clone().chunk(n)), mesh)
    counts = (cp.paged_partial.launches, paged_attention.launches,
              fused_decode_attention.launches)
    got = attention.decode_attention_step(q, kn, vn, kp, vp, pt, cl)[0]
    assert (cp.paged_partial.launches - counts[0],
            paged_attention.launches - counts[1],
            fused_decode_attention.launches - counts[2]) == (n, 0, 0)
    monkeypatch.delenv("XLLM_KV_WRITEBACK")
    kf, vf = k.clone(), v.clone()
    want = attention.decode_attention_step(q, kn, vn, kf, vf, pt, cl)[0]
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(kp.full(), kf) and torch.equal(vp.full(), vf)


def test_engine_context_parallel_serving_on_the_card(dev):
    """A tiny model on a seq=4 mesh of this card repeated: the ring prefill,
    a prefix hit through kernel 2 and decode through kernel 6 give the
    single-device engine's greedy tokens."""
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )
    from xllm_service_tpu_torch.models.base import tiny_config

    def cfg():
        return EngineConfig(
            model=tiny_config(dtype=torch.float32, max_context_len=512),
            num_pages=64, page_size=16, hash_block_size=32,
            max_batch_size=2, max_seq_len=512, seq_parallel_min_tokens=64)

    def run(eng, prompt):
        toks, done = [], threading.Event()

        def on_output(out):
            for s in out.outputs:
                toks.extend(s.token_ids)
            if out.finished:
                done.set()

        eng.submit(EngineRequest("r", token_ids=prompt, on_output=on_output,
                                 sampling=SamplingParams(
                                     max_tokens=6, temperature=0.0,
                                     ignore_eos=True)))
        while not done.is_set():
            eng.step()
        return toks

    single = InferenceEngine(cfg(), device=dev)
    eng = InferenceEngine(cfg(), params=single.params,
                          mesh=build_mesh(MeshConfig(seq=4), [dev] * 4))
    long = [(i * 11 + 5) % 300 + 10 for i in range(100)]
    p0, m0 = cp.paged_partial.launches, mq_paged_attention.launches
    for prompt in (list(range(40, 70)), long, long):
        assert run(eng, prompt) == run(single, prompt)
    assert eng.ring_prefills == 1
    assert cp.paged_partial.launches > p0
    assert mq_paged_attention.launches > m0
