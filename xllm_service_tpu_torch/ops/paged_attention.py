"""Paged decode attention: kernel 1 of the port.

Replaces the TPU kernel
``xllm_service_tpu/ops/pallas_paged_attention.py::paged_attention_pallas``
with the hand-written CUDA kernel ``csrc/paged_attention.cu`` (built by
``ops/_build.py``). One query token per sequence attends over its paged
K/V; ``context_lens`` include the new token, whose K/V are already written.

Bound on the H100: the K/V bytes it reads. At Llama-3-8B decode shapes
(B 8, ctx 1024, n_kv 8, hd 128, bf16) that is 33.5 MB per call, about
10 us at 3.35 TB/s, and the engine launches it once per layer per decode
step. The kernel gives each (row, KV head) one block, so the G query heads
of a group share every page it loads, and walks only the pages below ctx.
Its time on the card beside that bound is in PERF.md (measured by
``chip_smoke.py``).

``paged_attention`` is the wrapper the engine calls: for a CPU tensor it
computes ``paged_attention_plain``; for a CUDA tensor it launches the kernel
or raises. ``paged_attention.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          context_lens: torch.Tensor,
                          scale: Optional[float] = None,
                          softcap: float = 0.0, window: int = 0
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the reference's
    ``paged_attention_xla``): gather the row's page span dense and attend
    in f32.

    q: [B, n_q, hd]; k/v_pages: [P, n_kv, ps, hd]; page_table:
    [B, max_pages]; context_lens: [B]. Returns [B, n_q, hd]. It keeps the
    kernel's invariants: V rows at positions >= ctx are zeroed before the
    product (0 x NaN never reaches the sum) and a row with no visible key
    (ctx == 0) comes out zero.
    """
    B, n_q, hd = q.shape
    n_kv, ps = k_pages.shape[1], k_pages.shape[2]
    G = n_q // n_kv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    idx = page_table.long()
    T = idx.shape[1] * ps
    k = k_pages[idx].permute(0, 2, 1, 3, 4).reshape(B, n_kv, T, hd).float()
    v = v_pages[idx].permute(0, 2, 1, 3, 4).reshape(B, n_kv, T, hd).float()
    pos = torch.arange(T, device=q.device)[None, :]
    ctx = context_lens.long()[:, None]
    visible = pos < ctx                                          # [B, T]
    v = torch.where(visible[:, None, :, None], v, 0.0)
    if window > 0:
        # The query sits at position ctx - 1: keys >= ctx - window.
        visible = visible & (pos >= ctx - window)
    qf = q.float().reshape(B, n_kv, G, hd) * scale
    s = torch.einsum("bkgd,bktd->bkgt", qf, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.einsum("bkgt,bktd->bkgd", p, v) / l
    return out.reshape(B, n_q, hd).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def check_cuda_operands(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, int_tensors: list,
                        max_rows: int, rows: int) -> None:
    """What both kernels take: contiguous, 16-byte aligned CUDA tensors on
    one device, f32 or bf16 data, int32 tables, and a block of ``rows``
    query rows within the ``max_rows`` the kernel reports for this head dim
    and page size (0: shape not supported). Raises on anything else."""
    dev = q.device
    for t in (k_pages, v_pages, *int_tensors):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} (f32 or bf16 only)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: pool dtype {k_pages.dtype}, q {q.dtype}")
    for t in int_tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32")
    for t in (q, k_pages, v_pages, *int_tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name}: pool shape {tuple(k_pages.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if q.shape[-2] % k_pages.shape[1]:
        raise ValueError(f"{name}: n_q must be a multiple of n_kv")
    if max_rows == 0:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} / page_size "
                         f"{k_pages.shape[2]} not supported (head_dim a "
                         "multiple of 32 dividing the block's threads, "
                         "page_size dividing 64)")
    if rows > max_rows:
        raise ValueError(f"{name}: {rows} query rows per block exceed the "
                         f"kernel's {max_rows}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    context_lens: torch.Tensor,
                    scale: Optional[float] = None,
                    softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Paged decode attention. q: [B, n_q, hd]; k/v_pages:
    [P, n_kv, ps, hd]; page_table: [B, max_pages] int32; context_lens: [B]
    int32 (including the new token). Returns [B, n_q, hd].

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, or raises."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     context_lens, scale=scale,
                                     softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    B, n_q, hd = q.shape
    _, n_kv, ps, _ = k_pages.shape
    max_group = _build.kernel_fn("paged_attention",
                                 "paged_attention_max_group",
                                 [ctypes.c_int, ctypes.c_int])(hd, ps)
    check_cuda_operands("paged_attention", q, k_pages, v_pages,
                        [page_table, context_lens], max_group, n_q // n_kv)
    if page_table.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("paged_attention: page_table/context_lens rows "
                         "must match q")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    launch = _build.kernel_fn("paged_attention", "paged_attention_launch",
                              _ARGTYPES)
    err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), context_lens.data_ptr(),
                 out.data_ptr(), B, n_q, n_kv, hd, ps, page_table.shape[1],
                 1 if q.dtype == torch.bfloat16 else 0, float(scale),
                 float(softcap), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention: CUDA launch failed with "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
