"""The two CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a GPU and nvcc and skip elsewhere. Run them on
a machine with an H100 with ``python -m pytest -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances: f32 kernels sum in another order than the plain versions
(1e-4 absolute on outputs of magnitude ~1); bf16 outputs are rounded once
from f32 on both sides, so they differ by at most one bf16 ulp (2e-2 on
outputs below 4).
"""

import numpy as np
import pytest
import torch

from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.mq_paged_attention import (
    mq_paged_attention,
    mq_paged_attention_plain,
)
from xllm_service_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)

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
