"""Context-parallel paged decode attention: the KV page pool sharded by
page range over the mesh's ``seq`` axis, and kernel 6 of the port.

Port of ``xllm_service_tpu/ops/cp_paged_attention.py``. Shard ``d`` of
``n`` owns global pages ``[d * P_loc, (d + 1) * P_loc)`` as its own tensor
on the axis's ``d``-th device (``ShardedPages``). Each decode step every
shard computes raw flash statistics ``(m, l, acc)`` of each query over
ONLY the pages it owns and that the row occupies, and the partials merge
with the reference's log-sum-exp reduction (its ``pmax``/``psum`` over the
axis) on the mesh's first device:

    m_g   = max_d m_d
    l_g   = sum_d l_d * exp(m_d - m_g)
    acc_g = sum_d acc_d * exp(m_d - m_g)
    out   = acc_g / max(l_g, 1e-9)

The per-shard partial is the hand-written CUDA kernel
``csrc/cp_paged_partial.cu`` (built by ``ops/_build.py``), which replaces
the TPU kernel ``_paged_partial_pallas``, on kernel 1's split-K walk
(``csrc/split_decode.cuh``) over the compacted slots. Like the TPU body
``_local_partial_kernelized``, the caller compacts each shard's owned,
occupied page-table entries to the front (``compact_local_table``) and the
kernel walks only those pages. The page table and context lengths are the
same for every layer of a decode step, so the engine compacts once per
step and shard (``cp_tables``) and reuses the tables for all layers; the
reference recomputes them inside its jit, with the same result.

Bound on the H100: the owned, occupied K/V bytes a shard reads (a quarter
of kernel 1's at four shards and even ownership). A shard walks about
``1 / n`` of a row, so ``partial_split_count`` sizes the split-K grid from
the table's chunks divided by the axis size. Its time on the card is in
PERF.md (measured by ``chip_smoke.py``).

``paged_partial`` is the wrapper: for a CPU tensor it computes
``paged_partial_plain``; for a CUDA tensor it launches the kernel or
raises. ``paged_partial.launches`` counts the launches.
``paged_partial_split_plain`` mirrors the kernel's passes for the CPU
tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..parallel.mesh import AXIS_SEQ, DeviceMesh
from . import _build
from .paged_attention import (
    NEG_INF,
    check_cuda_operands,
    gather_rows,
    merge_splits,
    sm_count,
    split_count,
    split_partials,
    split_work,
)


# ------------------------------------------------------------ sharded pool
class ShardedPages:
    """Pages ``[..., P, n_kv, ps, hd]`` sharded by page range over
    ``mesh``'s ``seq_axis``: ``shards[d]`` is ``[..., P / n, n_kv, ps,
    hd]`` on the axis's ``d``-th device and holds global pages ``[d * P_loc,
    (d + 1) * P_loc)``. The engine's pool is one (``[L, 2, P, ...]``);
    ``pool[l, i]`` indexes every shard alike, giving layer ``l``'s K (i = 0)
    or V (i = 1) pages, which the attention ops dispatch on.

    ``shape`` is the global shape (the page axis times ``n``), so code that
    reads page counts and sizes works on either kind of pool. Only shard 0
    holds the garbage page (global page 0)."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: DeviceMesh,
                 seq_axis: str = AXIS_SEQ):
        self.shards = list(shards)
        self.mesh = mesh
        self.seq_axis = seq_axis

    @classmethod
    def zeros(cls, shape: Sequence[int], dtype: torch.dtype,
              mesh: DeviceMesh, seq_axis: str = AXIS_SEQ) -> "ShardedPages":
        """A zero pool of global ``shape`` (page axis ``-4``, divisible by
        the axis size), one shard per device of the axis."""
        devs = mesh.axis_devices(seq_axis)
        shape = list(shape)
        if shape[-4] % len(devs):
            raise ValueError(f"{shape[-4]} pages do not divide over "
                             f"{len(devs)} shards")
        shape[-4] //= len(devs)
        return cls([torch.zeros(shape, dtype=dtype, device=d) for d in devs],
                   mesh, seq_axis)

    def __getitem__(self, key) -> "ShardedPages":
        return ShardedPages([s[key] for s in self.shards], self.mesh,
                            self.seq_axis)

    @property
    def pages_per_shard(self) -> int:
        return self.shards[0].shape[-4]

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[-4] *= len(self.shards)
        return torch.Size(s)

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where the model computes."""
        return self.shards[0].device

    def full(self) -> torch.Tensor:
        """The shards concatenated on the first device (tests, checks)."""
        return torch.cat([s.to(self.device) for s in self.shards], dim=-4)

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        """Pages ``ids`` (global, clamped into the pool) of a per-layer
        pool, ``[len(ids), n_kv, ps, hd]`` on the first device: each shard
        gathers the ids it owns, with no host sync."""
        P_loc = self.pages_per_shard
        ids = ids.long().clamp(0, P_loc * len(self.shards) - 1)
        owner = (ids // P_loc)[:, None, None, None]
        out = None
        for d, shard in enumerate(self.shards):
            local = (ids - d * P_loc).clamp(0, P_loc - 1).to(shard.device)
            rows = shard[local].to(self.device)
            out = rows if out is None else torch.where(owner == d, rows, out)
        return out


# --------------------------------------------------------- the compaction
def compact_local_table(page_table: torch.Tensor,
                        context_lens: torch.Tensor, lo: int,
                        pages_per_shard: int, page_size: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's compacted table (the reference's
    ``_local_partial_kernelized``, cp_paged_attention.py:262-279).

    Owned entries are those whose global page lies in ``[lo, lo +
    pages_per_shard)`` AND that the row occupies (``entry * ps < ctx``: the
    table's tail is garbage-page padding, which would otherwise count as
    owned on shard 0). A stable sort brings them to the front in table
    order. Returns int32 ``(local_pt, starts, n_local)``: ``local_pt[b, j]``
    the LOCAL page index of entry j (0 past the owned ones), ``starts[b,
    j]`` its global token start (``order * ps``; ``ctx`` for the rest) and
    ``n_local[b]`` the count of owned entries."""
    ctx = context_lens.long()[:, None]
    local_idx = page_table.long() - lo
    owned = (local_idx >= 0) & (local_idx < pages_per_shard)
    mp = page_table.shape[1]
    owned &= (torch.arange(mp, device=page_table.device)[None, :] * page_size
              < ctx)
    order = torch.argsort((~owned).to(torch.int32), dim=1, stable=True)
    local_pt = torch.gather(torch.where(owned, local_idx, 0), 1, order)
    starts = torch.where(torch.gather(owned, 1, order), order * page_size,
                         ctx)
    return (local_pt.to(torch.int32).contiguous(),
            starts.to(torch.int32).contiguous(),
            owned.sum(dim=1).to(torch.int32))


def cp_tables(page_table: torch.Tensor, context_lens: torch.Tensor,
              pages: ShardedPages) -> list[tuple[torch.Tensor, ...]]:
    """Every shard's ``(local_pt, starts, n_local, context_lens)``, on that
    shard's device: one decode step's tables, shared by all its layers."""
    P_loc, ps = pages.pages_per_shard, pages.shape[-2]
    out = []
    for d, shard in enumerate(pages.shards):
        pt, cl = page_table.to(shard.device), context_lens.to(shard.device)
        out.append((*compact_local_table(pt, cl, d * P_loc, P_loc, ps),
                    cl.to(torch.int32).contiguous()))
    return out


# ---------------------------------------------------------- the partial
def paged_partial_plain(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, local_pt: torch.Tensor,
                        starts: torch.Tensor, n_local: torch.Tensor,
                        context_lens: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 6: raw flash statistics of one shard
    over its compacted table.

    q: [B, n_q, hd]; k/v_pages: the shard's ``[P_loc, n_kv, ps, hd]``;
    local_pt, starts: [B, max_pages]; n_local, context_lens: [B]. Returns
    f32 ``m, l`` [B, n_q] and ``acc`` [B, n_q, hd] (unnormalised), with the
    kernel's invariants: entries past ``n_local`` sit at ``ctx`` (masked;
    their rows, read here through local page 0, never reach a sum), V rows
    at positions >= ctx are zero before the product, p is zero on masked
    scores, and a row with nothing visible gives m = NEG_INF, l = 0,
    acc = 0."""
    B, n_q, hd = q.shape
    n_kv, ps = k_pages.shape[1], k_pages.shape[2]
    G = n_q // n_kv
    mp = local_pt.shape[1]
    T = mp * ps
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    ctx = context_lens.long()[:, None]
    live = (torch.arange(mp, device=q.device)[None, :]
            < n_local.long().clamp(max=mp)[:, None])            # [B, mp]
    pos = torch.where(live, starts.long(), ctx)[:, :, None] + \
        torch.arange(ps, device=q.device)                        # [B, mp, ps]
    visible = pos.reshape(B, T) < ctx                            # [B, T]
    k, v = gather_rows(k_pages, local_pt), gather_rows(v_pages, local_pt)
    v = torch.where(visible[:, None, :, None], v, 0.0)
    qf = q.float().reshape(B, n_kv, G, hd) * scale
    s = torch.einsum("bkgd,bktd->bkgt", qf, k)
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgt,bktd->bkgd", p, v)
    return (m.reshape(B, n_q), l.reshape(B, n_q), acc.reshape(B, n_q, hd))


def paged_partial_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, local_pt: torch.Tensor,
                              starts: torch.Tensor, n_local: torch.Tensor,
                              context_lens: torch.Tensor,
                              scale: Optional[float] = None, splits: int = 1
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The kernel's passes in plain PyTorch, for the CPU tests: the walk
    covers compacted slots ``[0, n_local * ps)``, slot c of entry ``c //
    ps`` at position ``starts[c // ps] + c % ps``, staged and visible only
    below ctx; per split the partial over its 16-slot units
    (``split_partials``), then the merge, and m from log2 to natural-log
    units (a row with nothing visible keeps m = NEG_INF exactly, l = 0,
    acc = 0). Shapes and result as :func:`paged_partial_plain`."""
    B, n_q, hd = q.shape
    n_kv, ps = k_pages.shape[1], k_pages.shape[2]
    mp = local_pt.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    k, v = gather_rows(k_pages, local_pt), gather_rows(v_pages, local_pt)
    qf = q.float().reshape(B, n_kv, n_q // n_kv, hd) * scale
    c = torch.arange(mp * ps)
    parts = []
    for b in range(B):
        n = min(max(int(n_local[b]), 0), mp) * ps
        pos = starts[b].long()[c // ps] + c % ps
        live = (c < n) & (pos < int(context_lens[b]))
        parts.append(split_partials(qf[b], k[b], v[b], n, live, splits))
    m, l, acc = merge_splits(*(torch.stack(x, dim=1) for x in zip(*parts)))
    m = torch.where(m <= NEG_INF / 2, NEG_INF, m * 0.6931471805599453)
    return m.reshape(B, n_q), l.reshape(B, n_q), acc.reshape(B, n_q, hd)


MIN_SPLIT_SLOTS = 256   # four 16-slot units for each warp of a split


def partial_split_count(batch: int, n_kv: int, max_pages: int,
                        page_size: int, sms: int, shards: int) -> int:
    """Blocks per (row, KV head) of kernel 6 on one of ``shards`` shards,
    from what the host knows: kernel 1's ``split_count`` for the row's
    share of the table (``ceil(max_pages / shards)`` entries, about what a
    shard owns), with no split shorter than ``MIN_SPLIT_SLOTS``. Each split
    pays a merge through scratch and the ticket, and a shard's walk is
    short: at the decode shapes one split of 256 slots beat two of 128
    (``chip_smoke.py``'s splits sweep, in PERF.md)."""
    share = -(-max_pages // shards)
    return max(1, min(split_count(batch, n_kv, share, page_size, sms),
                      share * page_size // MIN_SPLIT_SLOTS))


_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def paged_partial(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, local_pt: torch.Tensor,
                  starts: torch.Tensor, n_local: torch.Tensor,
                  context_lens: torch.Tensor, scale: Optional[float] = None,
                  shards: int = 1
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's raw statistics ``(m, l, acc)`` (see
    ``paged_partial_plain``); ``shards`` is the size of the mesh axis the
    pool is sharded over, which sizes the split-K grid. A CPU tensor takes
    the plain version; a CUDA tensor launches the CUDA kernel on the
    current stream of its device, or raises."""
    if q.device.type == "cpu":
        return paged_partial_plain(q, k_pages, v_pages, local_pt, starts,
                                   n_local, context_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_partial: unsupported device {q.device}")
    B, n_q, hd = q.shape
    _, n_kv, ps, _ = k_pages.shape
    max_group = _build.kernel_fn("cp_paged_partial",
                                 "cp_paged_partial_max_group",
                                 [ctypes.c_int, ctypes.c_int])(hd, ps)
    check_cuda_operands("paged_partial", q, k_pages, v_pages,
                        [local_pt, starts, n_local, context_lens], max_group,
                        n_q // n_kv)
    if (local_pt.shape[0] != B or starts.shape != local_pt.shape
            or n_local.shape != (B,) or context_lens.shape != (B,)):
        raise ValueError("paged_partial: table rows must match q")
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, n_q), **f32)
    l = torch.empty((B, n_q), **f32)
    acc = torch.empty((B, n_q, hd), **f32)
    if B == 0:
        return m, l, acc
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    max_pages = local_pt.shape[1]
    splits = partial_split_count(B, n_kv, max_pages, ps, sm_count(q.device),
                                 shards)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch_ptr, tickets_ptr = split_work(q, n_kv, splits, stream)
    launch = _build.kernel_fn("cp_paged_partial", "cp_paged_partial_launch",
                              _ARGTYPES)
    err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 local_pt.data_ptr(), starts.data_ptr(), n_local.data_ptr(),
                 context_lens.data_ptr(), m.data_ptr(), l.data_ptr(),
                 acc.data_ptr(), scratch_ptr, tickets_ptr, B, n_q, n_kv, hd,
                 ps, max_pages, 1 if q.dtype == torch.bfloat16 else 0,
                 splits, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_partial: CUDA launch failed with error "
                           f"{err}")
    paged_partial.launches += 1
    return m, l, acc


paged_partial.launches = 0


# -------------------------------------------------------------- the merge
def merge_partials(parts: Sequence[tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]]) -> torch.Tensor:
    """The reference's ``pmax``/``psum`` merge (cp_paged_attention.py:
    285-293) of every shard's ``(m, l, acc)``, already on one device: a
    shard with nothing visible (``m <= NEG_INF / 2``) weighs 0, and l is
    clamped at 1e-9, so a row no shard sees comes out zero. Returns the
    f32 attention ``[B, n_q, hd]``."""
    m = torch.stack([p[0] for p in parts])                     # [n, B, n_q]
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])                   # [n, B, n_q, hd]
    m_g = m.amax(dim=0)
    dead = m <= NEG_INF / 2
    w = torch.exp(torch.where(dead, NEG_INF, m) - m_g)
    w = torch.where(dead, 0.0, w)
    l_g = (l * w).sum(dim=0)
    acc_g = (acc * w[..., None]).sum(dim=0)
    return acc_g / l_g.clamp_min(1e-9)[..., None]


def cp_paged_attention(q: torch.Tensor, k_shards: Sequence[torch.Tensor],
                       v_shards: Sequence[torch.Tensor],
                       page_table: torch.Tensor, context_lens: torch.Tensor,
                       mesh: DeviceMesh, seq_axis: str = AXIS_SEQ,
                       scale: Optional[float] = None,
                       tables: Optional[list] = None) -> torch.Tensor:
    """q: [B, n_heads, hd] on the mesh's first device; ``k_shards`` /
    ``v_shards``: the pool's ``[P / n, n_kv, ps, hd]`` shards, shard d on
    the axis's d-th device; page ids in ``page_table`` are global;
    ``context_lens`` include the new token. Returns [B, n_heads, hd],
    what single-device paged attention returns. ``tables`` are
    ``cp_tables``' output for this step (computed here when None)."""
    devs = mesh.axis_devices(seq_axis)
    if len(k_shards) != len(devs) or len(v_shards) != len(devs):
        raise ValueError(f"{len(k_shards)} shards for a {seq_axis} axis of "
                         f"{len(devs)}")
    if tables is None:
        tables = cp_tables(page_table, context_lens,
                           ShardedPages(k_shards, mesh, seq_axis))
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    parts = []
    for kd, vd, (lpt, st, nl, cl) in zip(k_shards, v_shards, tables):
        m, l, acc = paged_partial(q.to(kd.device), kd, vd, lpt, st, nl, cl,
                                  scale=scale, shards=len(devs))
        parts.append((m.to(q.device), l.to(q.device), acc.to(q.device)))
    return merge_partials(parts).to(q.dtype)
