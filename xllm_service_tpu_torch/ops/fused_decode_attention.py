"""Fused decode step (append the new token's K/V and attend): kernel 3 of
the port.

Replaces the TPU kernel
``xllm_service_tpu/ops/pallas_fused_decode_attention.py::fused_decode_attention_pallas``
with the hand-written CUDA kernel ``csrc/fused_decode_attention.cu`` (built
by ``ops/_build.py``), on kernel 1's split-K walk (``csrc/split_decode.cuh``:
grid ``(splits, n_kv, B)``, ``split_count`` blocks per (row, KV head), a
``cp.async`` ring per warp, the splits merged in the same launch by a
ticket). ``context_lens`` include the new token, whose K/V arrive as
operands; the step attends over the ``ctx - 1`` pooled tokens plus the new
one (one more partial in the final merge) and writes the new K/V rows into
the pools IN PLACE, at position ``pos = max(ctx - 1, 0)``: slot ``pos % ps``
of page ``page_table[b, min(pos // ps, max_pages - 1)]``.

Safe in place because the block that writes is the one that runs the final
merge, after every split's walk, no walk stages slot ``pos``, and tail
pages are private to their sequence (the page manager donates only whole
hash blocks of whole pages). A row with ctx 0 attends only the new token
(its output is ``v_new``, as in the reference kernel) and writes slot 0 of
``page_table[b, 0]``, the garbage page for an inactive slot.

Bound on the H100: the K/V bytes it reads, as kernel 1 (33.5 MB at B 8,
ctx 1024, about 10 us at 3.35 TB/s). Its time on the card is in PERF.md
(measured by ``chip_smoke.py``).

``fused_decode_attention`` is the wrapper ``ops/attention.py`` routes to
under ``XLLM_KV_WRITEBACK=fused``: for a CPU tensor it computes
``fused_decode_attention_plain``; for a CUDA tensor it launches the kernel
or raises. ``fused_decode_attention.launches`` counts the launches.
``fused_decode_attention_split_plain`` mirrors the kernel's passes for the
CPU tests.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .paged_attention import (
    NEG_INF,
    check_cuda_operands,
    gather_rows,
    merge_splits,
    planned_blocks_per_sm,
    sm_count,
    split_count,
    split_partials,
    split_work,
)

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def fused_decode_attention_plain(q: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 context_lens: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch version of the kernel, step by step: attend over the
    pooled tokens below ``ctx - 1`` and the new token from the operands in
    f32 (V rows past the bound zeroed, p re-zeroed on masked scores, l
    clamped at 1e-9), then write the new rows into the pools in place.

    q: [B, n_q, hd]; k_new/v_new: [B, n_kv, hd]; k/v_pages:
    [P, n_kv, ps, hd]; page_table: [B, max_pages]; context_lens: [B]
    including the new token. Returns (out [B, n_q, hd], k_pages, v_pages).
    """
    B, n_q, hd = q.shape
    n_kv = k_pages.shape[1]
    G = n_q // n_kv
    scale = 1.0 / (hd ** 0.5)
    k, v = gather_rows(k_pages, page_table), gather_rows(v_pages, page_table)
    T = k.shape[2]
    pos = (context_lens.long() - 1).clamp_min(0)            # the new token
    visible = torch.arange(T, device=q.device)[None, :] < pos[:, None]
    v = torch.where(visible[:, None, :, None], v, 0.0)
    qf = q.float().reshape(B, n_kv, G, hd) * scale
    s = torch.einsum("bkgd,bktd->bkgt", qf, k)
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    s_new = torch.einsum("bkgd,bkd->bkg", qf, k_new.float())[..., None]
    s = torch.cat([s, s_new], dim=-1)
    v = torch.cat([v, v_new.float()[:, :, None, :]], dim=2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = (torch.einsum("bkgt,bktd->bkgd", p, v) / l).reshape(B, n_q, hd)
    _append(k_new, v_new, k_pages, v_pages, page_table, context_lens)
    return out.to(q.dtype), k_pages, v_pages


def _append(k_new: torch.Tensor, v_new: torch.Tensor, k_pages: torch.Tensor,
            v_pages: torch.Tensor, page_table: torch.Tensor,
            context_lens: torch.Tensor) -> None:
    """The new rows into slot ``pos % ps`` of page ``page_table[b,
    min(pos // ps, max_pages - 1)]``, ``pos = max(ctx - 1, 0)``, in
    place."""
    ps, max_pages = k_pages.shape[2], page_table.shape[1]
    pos = (context_lens.long() - 1).clamp_min(0)
    col = (pos // ps).clamp_max(max_pages - 1)
    page = torch.gather(page_table.long(), 1, col[:, None])[:, 0]
    slot = pos % ps
    k_pages[page, :, slot] = k_new.to(k_pages.dtype)
    v_pages[page, :, slot] = v_new.to(v_pages.dtype)


def fused_decode_attention_split_plain(q: torch.Tensor, k_new: torch.Tensor,
                                       v_new: torch.Tensor,
                                       k_pages: torch.Tensor,
                                       v_pages: torch.Tensor,
                                       page_table: torch.Tensor,
                                       context_lens: torch.Tensor,
                                       splits: int = 1
                                       ) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """The kernel's passes in plain PyTorch, for the CPU tests: per split
    the partial over its units of the pooled slots ``[0, ctx - 1)``
    (``split_partials``), the new token as one more partial in log2 units
    (m = its scaled score times log2(e), l = 1, acc = v_new), the merge
    with l floored at 1e-9, then the append. Shapes and result as
    :func:`fused_decode_attention_plain`."""
    B, n_q, hd = q.shape
    n_kv = k_pages.shape[1]
    G = n_q // n_kv
    log2e = 1.4426950408889634
    k, v = gather_rows(k_pages, page_table), gather_rows(v_pages, page_table)
    T = k.shape[2]
    qf = q.float().reshape(B, n_kv, G, hd) * (1.0 / (hd ** 0.5))
    parts = []
    for b in range(B):
        n = min(max(int(context_lens[b]) - 1, 0), T)
        parts.append(split_partials(qf[b], k[b], v[b], n,
                                    torch.arange(T) < n, splits))
    m, l, acc = (torch.stack(x, dim=1) for x in zip(*parts))
    m_new = torch.einsum("bkgd,bkd->bkg", qf, k_new.float()) * log2e
    acc_new = v_new.float()[:, :, None, :].expand(B, n_kv, G, hd)
    _, l_g, acc_g = merge_splits(torch.cat([m, m_new[None]]),
                                 torch.cat([l, torch.ones_like(l[:1])]),
                                 torch.cat([acc, acc_new[None]]))
    out = (acc_g / l_g.clamp_min(1e-9)[..., None]).reshape(B, n_q, hd)
    _append(k_new, v_new, k_pages, v_pages, page_table, context_lens)
    return out.to(q.dtype), k_pages, v_pages


def fused_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           context_lens: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Append-and-attend decode step; shapes as
    :func:`fused_decode_attention_plain`. Returns (out, k_pages, v_pages)
    with the pools updated in place.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, or raises."""
    if q.device.type == "cpu":
        return fused_decode_attention_plain(q, k_new, v_new, k_pages,
                                            v_pages, page_table,
                                            context_lens)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_attention: unsupported device "
                         f"{q.device}")
    B, n_q, hd = q.shape
    _, n_kv, ps, _ = k_pages.shape
    max_group = _build.kernel_fn("fused_decode_attention",
                                 "fused_decode_attention_max_group",
                                 [ctypes.c_int, ctypes.c_int])(hd, ps)
    check_cuda_operands("fused_decode_attention", q, k_pages, v_pages,
                        [page_table, context_lens], max_group, n_q // n_kv)
    for t in (k_new, v_new):
        if t.shape != (B, n_kv, hd) or t.dtype != q.dtype or \
                t.device != q.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError("fused_decode_attention: k_new/v_new must be "
                             f"contiguous [{B}, {n_kv}, {hd}] {q.dtype} on "
                             f"{q.device}")
    if page_table.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("fused_decode_attention: page_table/context_lens "
                         "rows must match q")
    out = torch.empty_like(q)
    if B == 0:
        return out, k_pages, v_pages
    max_pages = page_table.shape[1]
    splits = split_count(B, n_kv, max_pages, ps, sm_count(q.device),
                         planned_blocks_per_sm("fused_decode_attention", hd,
                                               n_q // n_kv,
                                               q.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch_ptr, tickets_ptr = split_work(q, n_kv, splits, stream)
    launch = _build.kernel_fn("fused_decode_attention",
                              "fused_decode_attention_launch", _ARGTYPES)
    err = launch(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), context_lens.data_ptr(),
                 out.data_ptr(), scratch_ptr, tickets_ptr, B, n_q, n_kv, hd,
                 ps, max_pages, 1 if q.dtype == torch.bfloat16 else 0,
                 splits, 1.0 / (hd ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_attention: CUDA launch failed "
                           f"with error {err}")
    _build.count_launch(fused_decode_attention)
    return out, k_pages, v_pages


fused_decode_attention.launches = 0
