"""Causal multi-query paged attention: kernel 2 of the port.

Replaces the TPU kernel
``xllm_service_tpu/ops/pallas_mq_paged_attention.py::mq_paged_attention_pallas``
with the hand-written CUDA kernel ``csrc/mq_paged_attention.cu``. A block
of Sq queries per sequence attends against pages that already hold prefix
+ block K/V (``write_prefill_kv`` runs first); query s, at absolute
position prefix + s, sees keys at positions <= prefix + s. In the port it
carries every prefill against a cached prefix (in the reference that route
is opt-in, ``XLLM_PREFILL_PALLAS=1``).

Bound on the H100: at serving shapes (a 512-token suffix behind a
512-token prefix, 32/8 heads, hd 128, bf16) the causal products are about
6.4 GFLOP against about 12.6 MB of data, so the bf16 tensor-core rate bounds
it (~6.5 us). The kernel tiles queries across blocks (any suffix length
fits; no cap like the TPU's ``S * n_heads <= 4096``) and shares each page
load among a tile of queries times the GQA group. Its time on the card is in
PERF.md (measured by ``chip_smoke.py``).

``mq_paged_attention`` is the wrapper: for a CPU tensor it computes
``mq_paged_attention_plain``; for a CUDA tensor it launches the kernel or
raises. ``mq_paged_attention.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .paged_attention import NEG_INF, check_cuda_operands

def mq_paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_table: torch.Tensor,
                             prefix_lens: torch.Tensor,
                             block_lens: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather each row's page span
    dense and attend in f32 with the per-query causal bound.

    q: [B, Sq, n_q, hd]; k/v_pages: [P, n_kv, ps, hd] holding prefix AND
    block K/V; prefix_lens/block_lens: [B]. Returns [B, Sq, n_q, hd].
    Padding queries (s >= block_lens[b]) come out zero, and V rows past the
    written context are zeroed before the product, as in the kernel.
    """
    B, S, n_q, hd = q.shape
    n_kv, ps = k_pages.shape[1], k_pages.shape[2]
    G = n_q // n_kv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    idx = page_table.long()
    T = idx.shape[1] * ps
    k = k_pages[idx].permute(0, 2, 1, 3, 4).reshape(B, n_kv, T, hd).float()
    v = v_pages[idx].permute(0, 2, 1, 3, 4).reshape(B, n_kv, T, hd).float()
    prefix = prefix_lens.long()
    blk = block_lens.long().clamp(max=S)
    key = torch.arange(T, device=q.device)
    v = torch.where((key[None, :] < (prefix + blk)[:, None])[:, None, :, None],
                    v, 0.0)
    s_idx = torch.arange(S, device=q.device)
    # [B, S, T]: query s sees keys <= prefix + s, and padding queries none.
    visible = ((key[None, None, :] <= (prefix[:, None] + s_idx[None, :])[..., None])
               & (s_idx[None, :] < blk[:, None])[..., None])
    qf = q.float().reshape(B, S, n_kv, G, hd) * scale
    sc = torch.einsum("bskgd,bktd->bkgst", qf, k)
    sc = torch.where(visible[:, None, None], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(sc <= NEG_INF / 2, 0.0, torch.exp(sc - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.einsum("bkgst,bktd->bskgd", p / l, v)
    return out.reshape(B, S, n_q, hd).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p]


def query_tile(group: int, max_rows: int) -> int:
    """Queries per block: as many as fit the kernel's ``max_rows`` rows of
    (query, GQA group head)."""
    return max(1, max_rows // group)


def mq_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       prefix_lens: torch.Tensor, block_lens: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Causal multi-query paged attention. q: [B, Sq, n_q, hd];
    k/v_pages: [P, n_kv, ps, hd]; page_table: [B, max_pages] int32;
    prefix_lens/block_lens: [B] int32. Returns [B, Sq, n_q, hd].

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, or raises. Any Sq is taken."""
    if q.device.type == "cpu":
        return mq_paged_attention_plain(q, k_pages, v_pages, page_table,
                                        prefix_lens, block_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mq_paged_attention: unsupported device {q.device}")
    B, S, n_q, hd = q.shape
    _, n_kv, ps, _ = k_pages.shape
    G = n_q // n_kv
    max_rows = _build.kernel_fn("mq_paged_attention",
                                "mq_paged_attention_max_rows",
                                [ctypes.c_int, ctypes.c_int])(hd, ps)
    tile = query_tile(G, max_rows)
    check_cuda_operands("mq_paged_attention", q, k_pages, v_pages,
                        [page_table, prefix_lens, block_lens], max_rows,
                        tile * G)
    if (page_table.shape[0] != B or prefix_lens.shape != (B,)
            or block_lens.shape != (B,)):
        raise ValueError("mq_paged_attention: page_table/prefix_lens/"
                         "block_lens rows must match q")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    launch = _build.kernel_fn("mq_paged_attention",
                              "mq_paged_attention_launch", _ARGTYPES)
    err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), prefix_lens.data_ptr(),
                 block_lens.data_ptr(), out.data_ptr(), B, S, n_q, n_kv, hd,
                 ps, page_table.shape[1], tile,
                 1 if q.dtype == torch.bfloat16 else 0, float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mq_paged_attention: CUDA launch failed with "
                           f"error {err}")
    mq_paged_attention.launches += 1
    return out


mq_paged_attention.launches = 0
