"""Paged decode attention: kernel 1 of the port.

Replaces the TPU kernel
``xllm_service_tpu/ops/pallas_paged_attention.py::paged_attention_pallas``
with the hand-written CUDA kernel ``csrc/paged_attention.cu`` (built by
``ops/_build.py``) on the split-K walk of ``csrc/split_decode.cuh``, which
kernels 3 and 6 share. One query token per sequence attends over its paged
K/V; ``context_lens`` include the new token, whose K/V are already written.

Bound on the H100: the K/V bytes it reads. At Llama-3-8B decode shapes
(B 8, ctx 1024, n_kv 8, hd 128, bf16) that is 33.5 MB per call, about
10 us at 3.35 TB/s, and the engine launches it once per layer per decode
step. A kernel bound by bytes needs every SM busy and loads in flight the
whole time, so the kernel splits each (row, KV head) over the context
(flash-decoding: grid ``(splits, n_kv, B)``, ``split_count`` blocks per
(row, KV head), about two per SM), stages K/V by ``cp.async`` into a ring per
warp so that later units load while an earlier one is computed, and merges
the splits' ``(m, l, acc)`` in the same launch (the last block to finish a
(row, KV head), found by an atomic ticket, merges). The G query heads of a
group still share a block, so each K/V byte is read once.
``context_lens`` is never read on the host: each block reads ctx on the
device and takes its share of the visible 16-token units. Its time on the
card beside that bound is in PERF.md (measured by ``chip_smoke.py``).

``paged_attention`` is the wrapper the engine calls: for a CPU tensor it
computes ``paged_attention_plain``; for a CUDA tensor it launches the kernel
or raises. ``paged_attention.launches`` counts the launches.
``paged_attention_split_plain`` mirrors the kernel's two passes (per-split
partials over the unit ranges the kernel takes, then the merge) for the CPU
tests; ``split_partials`` and ``merge_splits`` are those passes, shared
with the split versions of kernels 3 and 6.
"""

from __future__ import annotations

import ctypes
import functools
import threading
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
    k, v = gather_rows(k_pages, page_table), gather_rows(v_pages, page_table)
    T = k.shape[2]
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


UNIT = 16          # tokens per step of a warp in the kernel
MAX_SPLITS = 32    # the merge reads every split's partial once per output


def split_count(batch: int, n_kv: int, max_pages: int, page_size: int,
                sm_count: int, per_sm: int) -> int:
    """Blocks per (row, KV head) of the split-K decode kernel, from what
    the host knows without a device sync: enough that the grid holds about
    ``per_sm`` blocks per SM (``planned_blocks_per_sm``), but no split
    shorter than two 64-token chunks of the table's width (so a short table
    is not split), and at most ``MAX_SPLITS``."""
    rows = max(1, batch * n_kv)
    want = max(1, (per_sm * sm_count) // rows)
    chunks = -(-(max_pages * page_size) // 64)
    return max(1, min(want, chunks // 2, MAX_SPLITS))


def split_unit_range(ctx: int, window: int, splits: int, split: int
                     ) -> tuple[int, int, int]:
    """What split ``split`` of ``splits`` walks for a row of context
    ``ctx``: 16-token units ``[u0, u1)`` (possibly empty) of the visible
    range ``[lo_pos, ctx)``; returns ``(u0, u1, lo_pos)``. The kernel
    computes the same on the device."""
    lo_pos = max(ctx - window, 0) if window > 0 else 0
    u_lo = lo_pos // UNIT
    u_hi = -(-ctx // UNIT)
    per = -(-max(u_hi - u_lo, 0) // splits)
    u0 = u_lo + split * per
    return u0, min(u0 + per, u_hi), lo_pos


def split_partials(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n: int, live: torch.Tensor, splits: int, window: int = 0,
                   softcap: float = 0.0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row's per-split partials as the split-K kernels form them.

    qf: [n_kv, G, hd] f32 queries, pre-scaled; k, v: [n_kv, T, hd] f32, the
    row's slots in walk order; the walk covers slots ``[0, n)`` and
    ``live`` [T] says which slots are staged (the others are zero and
    masked). Split ``sp`` takes the 16-slot units ``split_unit_range(n,
    window, splits, sp)``; scores are select-masked to live slots from the
    window's start, the softmax runs in base 2, and p is zero on the
    sentinel. Returns m, l [splits, n_kv, G] (log2 units) and acc
    [splits, n_kv, G, hd]; an empty split gives m = NEG_INF, l = 0,
    acc = 0."""
    log2e = 1.4426950408889634
    n_kv, G, hd = qf.shape
    T = k.shape[1]
    m = torch.full((splits, n_kv, G), NEG_INF)
    l = torch.zeros((splits, n_kv, G))
    acc = torch.zeros((splits, n_kv, G, hd))
    for sp in range(splits):
        u0, u1, lo = split_unit_range(n, window, splits, sp)
        if u1 <= u0:
            continue
        c = torch.arange(u0 * UNIT, u1 * UNIT)
        on = (c < T) & live[c.clamp(max=T - 1)]
        kc = torch.where(on[None, :, None], k[:, c.clamp(max=T - 1)], 0.0)
        vc = torch.where(on[None, :, None], v[:, c.clamp(max=T - 1)], 0.0)
        sc = torch.einsum("kgd,ktd->kgt", qf, kc)
        if softcap > 0:
            sc = softcap * torch.tanh(sc / softcap)
        visible = on & (c >= lo)
        sc = torch.where(visible[None, None, :], sc * log2e, NEG_INF)
        mm = sc.amax(dim=-1)
        p = torch.where(sc <= NEG_INF / 2, 0.0,
                        torch.exp2(sc - mm[..., None]))
        m[sp], l[sp] = mm, p.sum(dim=-1)
        acc[sp] = torch.einsum("kgt,ktd->kgd", p, vc)
    return m, l, acc


def merge_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' log-sum-exp merge of partials over dim 0, m in log2
    units: a part with m at the sentinel weighs 0. Returns the merged
    ``(m, l, acc)``, still unnormalised."""
    m_g = m.amax(dim=0)
    w = torch.where(m <= NEG_INF / 2, 0.0, torch.exp2(m - m_g))
    return m_g, (l * w).sum(dim=0), (acc * w[..., None]).sum(dim=0)


def gather_rows(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[P, n_kv, ps, hd] pages through a [B, mp] table -> [B, n_kv,
    mp * ps, hd] f32, each row's slots in table order."""
    B, mp = table.shape
    n_kv, ps, hd = pages.shape[1:]
    return (pages[table.long()].permute(0, 2, 1, 3, 4)
            .reshape(B, n_kv, mp * ps, hd).float())


def paged_attention_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                context_lens: torch.Tensor,
                                scale: Optional[float] = None,
                                softcap: float = 0.0, window: int = 0,
                                splits: int = 1) -> torch.Tensor:
    """The split-K kernel's two passes in plain PyTorch, for the CPU tests:
    per split the partial ``(m, l, acc)`` over the units the kernel gives it
    (``split_partials``: K/V past ctx zeroed), then the log-sum-exp merge
    with l floored at 1e-9."""
    B, n_q, hd = q.shape
    n_kv = k_pages.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    k, v = gather_rows(k_pages, page_table), gather_rows(v_pages, page_table)
    T = k.shape[2]
    qf = q.float().reshape(B, n_kv, n_q // n_kv, hd) * scale
    parts = []
    for b in range(B):
        ctx = min(int(context_lens[b]), T)
        parts.append(split_partials(qf[b], k[b], v[b], ctx,
                                    torch.arange(T) < ctx, splits, window,
                                    softcap))
    m, l, acc = (torch.stack(x, dim=1) for x in zip(*parts))
    _, l_g, acc_g = merge_splits(m, l, acc)
    out = acc_g / l_g.clamp_min(1e-9)[..., None]
    return out.reshape(B, n_q, hd).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

# Work space of the split-K merge, one per (device, stream): the zeroed
# ticket counters (the kernel leaves them zero) and the f32 scratch for the
# splits' partials. Launches on one stream run in order, so both are made
# once and only grow; no launch is added per call.
_work: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _device_index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_work_lock = threading.Lock()   # engines of one process launch at once


def _work_space(device: torch.device, stream: int, n_tickets: int,
                n_scratch: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (_device_index(device), stream)
    with _work_lock:
        tickets, scratch = _work.get(key, (None, None))
        if tickets is None or tickets.numel() < n_tickets:
            tickets = torch.zeros(max(n_tickets, 4096), dtype=torch.int32,
                                  device=device)
        if scratch is None or scratch.numel() < n_scratch:
            scratch = torch.empty(n_scratch, dtype=torch.float32,
                                  device=device)
        _work[key] = (tickets, scratch)
    return tickets, scratch


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA tensor's device."""
    return _sm_count(_device_index(device))


@functools.lru_cache(maxsize=None)
def blocks_per_sm(lib: str, hd: int, group: int, bf16: bool) -> int:
    """Blocks of library ``lib``'s split-K kernel (``paged_attention``,
    ``fused_decode_attention`` or ``cp_paged_partial``) that one SM holds
    at this head dim, GQA group and dtype, by the occupancy calculator.
    Raises if the query fails."""
    n = _build.kernel_fn(lib, f"{lib}_blocks_per_sm",
                         [ctypes.c_int] * 3)(hd, group, 1 if bf16 else 0)
    if n <= 0:
        raise RuntimeError(f"{lib}: blocks per SM query failed ({n})")
    return n


def planned_blocks_per_sm(lib: str, hd: int, group: int, bf16: bool) -> int:
    """Blocks per SM that ``split_count`` plans for at this shape: two at
    head dims up to 128 (the plan the splits sweeps measured, PERF.md), and
    at 256 what the occupancy calculator reports for library ``lib``
    (``blocks_per_sm``: one, as a bf16 block's ring takes 192 KB)."""
    return blocks_per_sm(lib, hd, group, bf16) if hd == 256 else 2


def split_work(q: torch.Tensor, n_kv: int, splits: int, stream: int
               ) -> tuple[int, int]:
    """Pointers ``(scratch, tickets)`` for a split-K launch of ``q``'s
    shape [B, n_q, hd] on ``stream``: the f32 partials (acc, then m and l)
    of every split and one zeroed ticket per (row, KV head); ``(0, 0)``
    with one split, which touches neither. Shared by kernels 1, 3 and 6:
    launches on one stream run in order, and each leaves its tickets
    zero."""
    if splits == 1:
        return 0, 0
    B, n_q, hd = q.shape
    tickets, scratch = _work_space(q.device, stream, B * n_kv,
                                   B * n_q * splits * (hd + 2))
    return scratch.data_ptr(), tickets.data_ptr()


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
    bf16 = q.dtype == torch.bfloat16
    if page_table.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("paged_attention: page_table/context_lens rows "
                         "must match q")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    max_pages = page_table.shape[1]
    splits = split_count(B, n_kv, max_pages, ps, sm_count(q.device),
                         planned_blocks_per_sm("paged_attention", hd,
                                               n_q // n_kv, bf16))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch_ptr, tickets_ptr = split_work(q, n_kv, splits, stream)
    launch = _build.kernel_fn("paged_attention", "paged_attention_launch",
                              _ARGTYPES)
    err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), context_lens.data_ptr(),
                 out.data_ptr(), scratch_ptr, tickets_ptr, B, n_q, n_kv, hd,
                 ps, max_pages, 1 if bf16 else 0, splits,
                 float(scale), float(softcap), int(window), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention: CUDA launch failed with "
                           f"error {err}")
    _build.count_launch(paged_attention)
    return out


paged_attention.launches = 0
