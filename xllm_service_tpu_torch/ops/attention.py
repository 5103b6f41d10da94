"""Attention primitives for the paged-KV engine (port of
``xllm_service_tpu/ops/attention.py``, dense Llama path).

Layouts, as in the reference:
- KV pool per layer: ``k_pages/v_pages: [num_pages, n_kv, page_size, hd]``
  (the engine stacks them as ``[L, 2, P, n_kv, ps, hd]``); page 0 is the
  garbage page.
- ``page_table: [B, max_pages]`` int32 page ids per sequence, in order.
- ``context_lens: [B]`` int32 tokens in cache per sequence.

The writes update the pool in place (the reference returns new arrays from
a donated jit; PyTorch has no need for that) and return it.

Numerics: projections in model dtype, softmax in f32. These plain ops are
the CPU path and the oracles of the CUDA kernels; on a CUDA tensor,
``paged_attention`` launches kernel 1, a prefill against a cached prefix
launches kernel 2, and a decode step under ``XLLM_KV_WRITEBACK=fused``
launches kernel 3.

A pool sharded over the mesh's ``seq`` axis (``ShardedPages``, the
reference's pool under a seq mesh) changes three things, as in the
reference: each K/V write lands on the shard that owns its page; a decode
step is the write, then the context-parallel op (kernel 6 per shard and
the merge), whatever ``XLLM_KV_WRITEBACK`` says; and a prefill against a
cached prefix reads the row's pages gathered from their shards. A long
prefix-free prefill may take the ring (``ring=True``).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from .cp_paged_attention import ShardedPages, cp_paged_attention
from .fused_decode_attention import fused_decode_attention
from .mq_paged_attention import mq_paged_attention
from .paged_attention import NEG_INF, paged_attention
from .ring_attention import ring_attention


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos/sin [..., head_dim//2] in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., n_heads, head_dim]; positions broadcastable to
    x.shape[:-2]. 1-D rope (the rotate-half convention)."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    cos = cos[..., None, :]                          # broadcast over heads
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads. kv [..., n_kv, hd]."""
    if n_rep == 1:
        return kv
    return torch.repeat_interleave(kv, n_rep, dim=-2)


# --------------------------------------------------------------- KV writes
def _wrap(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Index semantics of the reference's gathers and scatters: an index
    in [-n, n) wraps like numpy; anything else is out of range. Returns
    (wrapped index clamped into range, in-range mask)."""
    ok = (idx >= -n) & (idx < n)
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1), ok


def _scatter_rows(pages, page_idx: torch.Tensor,
                  slot: torch.Tensor, rows: torch.Tensor) -> None:
    """pages[page_idx[i], :, slot[i], :] = rows[i] in place. Rows whose page
    id is outside the pool are dropped (the reference's mode="drop";
    ``index_put_`` would raise on them): they rewrite what the garbage
    page already holds at their slot."""
    if isinstance(pages, ShardedPages):
        _scatter_rows_sharded(pages, page_idx, slot, rows)
        return
    p, ok = _wrap(page_idx.long(), pages.shape[0])
    p = torch.where(ok, p, 0)
    s = slot.long()
    old = pages[p, :, s]
    pages[p, :, s] = torch.where(ok[:, None, None], rows.to(pages.dtype), old)


def _scatter_rows_sharded(pages: ShardedPages, page_idx: torch.Tensor,
                          slot: torch.Tensor, rows: torch.Tensor) -> None:
    """``_scatter_rows`` over a sharded pool: the global index semantics
    are the same, and each row lands on the shard that owns its page, at
    local index ``page - d * P_loc``.

    A row that shard d does not own is DROPPED there. It must not be
    redirected to local page 0 as the single-device write redirects
    out-of-range rows: only shard 0's local page 0 is the garbage page; on
    shard d > 0 it is the real page ``d * P_loc``, and a redirected row
    would race a kept row writing there. Without a host sync (the kept
    count is data on the device), a dropped row instead repeats the write
    of the shard's first kept row (same place, same value) or, when the
    shard keeps none, rewrites its slot of local page 0 with what it
    holds."""
    P_loc = pages.pages_per_shard
    p, ok = _wrap(page_idx.long(), P_loc * len(pages.shards))
    for d, shard in enumerate(pages.shards):
        dev = shard.device
        keep = (ok & (p // P_loc == d)).to(dev)
        local = (p - d * P_loc).clamp(0, P_loc - 1).to(dev)
        s = slot.long().to(dev)
        r = rows.to(dev, shard.dtype)
        first = keep.to(torch.int32).argmax()
        any_kept = keep.any()
        tp = torch.where(keep, local, torch.where(any_kept, local[first], 0))
        ts = torch.where(keep, s, torch.where(any_kept, s[first], s))
        val = torch.where(keep[:, None, None], r,
                          torch.where(any_kept, r[first],
                                      shard[torch.zeros_like(s), :, s]))
        shard[tp, :, ts] = val


def write_prefill_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor,
                     page_table: torch.Tensor, prefix_lens: torch.Tensor,
                     seq_lens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a prefill suffix's K/V into the paged pool, in place.

    k/v: [B, S, n_kv, hd]; token j of row b lands at absolute position
    prefix_lens[b] + j. Padding positions (j >= seq_lens[b]) go to the
    garbage page 0 so padding never overwrites live cache lines."""
    B, S = k.shape[0], k.shape[1]
    page_size = k_pages.shape[2]
    max_pages = page_table.shape[1]
    ar = torch.arange(S, device=k.device)
    pos = prefix_lens.long()[:, None] + ar[None, :]               # [B, S]
    valid = ar[None, :] < seq_lens.long()[:, None]
    page_idx = torch.gather(page_table.long(), 1,
                            torch.clamp(pos // page_size, 0, max_pages - 1))
    page_idx = torch.where(valid, page_idx, 0)
    slot = pos % page_size
    _scatter_rows(k_pages, page_idx.reshape(-1), slot.reshape(-1),
                  k.reshape(B * S, *k.shape[2:]))
    _scatter_rows(v_pages, page_idx.reshape(-1), slot.reshape(-1),
                  v.reshape(B * S, *v.shape[2:]))
    return k_pages, v_pages


def write_decode_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    page_table: torch.Tensor, context_lens: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Append one token's K/V per sequence, in place. k/v: [B, n_kv, hd];
    the new token occupies position context_lens[b]. A position past the
    page table is dropped."""
    page_size = k_pages.shape[2]
    pos = context_lens.long()
    col, ok = _wrap(pos // page_size, page_table.shape[1])
    page_idx = torch.gather(page_table.long(), 1, col[:, None])[:, 0]
    page_idx = torch.where(ok, page_idx, k_pages.shape[0])   # out of pool
    slot = pos % page_size
    _scatter_rows(k_pages, page_idx, slot, k)
    _scatter_rows(v_pages, page_idx, slot, v)
    return k_pages, v_pages


# ----------------------------------------------------------- prefill attn
def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[num_pages, n_kv, ps, hd] x [B, max_pages] -> [B, max_pages*ps, n_kv, hd]."""
    g = pages[page_table.long()]              # [B, max_pages, n_kv, ps, hd]
    B, mp, n_kv, ps, hd = g.shape
    return g.transpose(2, 3).reshape(B, mp * ps, n_kv, hd)


def gather_sharded_table(k_pages: ShardedPages, v_pages: ShardedPages,
                         page_table: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pages of every row's table gathered from their owning shards
    into a compact pool on the first mesh device, and the table remapped to
    it (row b's entries at ``b * max_pages + j``): what the reference's
    GSPMD gather does for a prefill that reads a sharded pool, so the
    prefix route (kernel 2 on the card) runs as on one device."""
    B, mp = page_table.shape
    ids = page_table.reshape(-1).to(k_pages.device)
    table = torch.arange(B * mp, dtype=torch.int32,
                         device=k_pages.device).reshape(B, mp)
    return k_pages.gather(ids), v_pages.gather(ids), table


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_pages: Optional[torch.Tensor],
                      v_pages: Optional[torch.Tensor],
                      page_table: Optional[torch.Tensor],
                      prefix_lens: torch.Tensor, seq_lens: torch.Tensor,
                      scale: Optional[float] = None,
                      has_prefix: Optional[bool] = None,
                      ring: bool = False) -> torch.Tensor:
    """Causal attention for a (possibly prefix-cached) prefill suffix.

    q/k/v: [B, S, n(_kv), hd] for the suffix being prefilled; queries also
    attend to the cached prefix (the first prefix_lens[b] tokens) read from
    the paged pool. seq_lens[b] = valid suffix length. Returns
    [B, S, n_heads, hd].

    ``has_prefix`` says whether any prefix_lens is > 0; the engine knows it
    on the host, so the choice needs no device sync (None computes it). On
    a CUDA tensor a prefill with a prefix launches the multi-query kernel,
    which reads the suffix's K/V from the pages (written first by
    write_prefill_kv); without one, and on the CPU, it is the dense f32
    computation below (the reference's XLA path).

    ``ring`` (the pool sharded over the seq axis, no cached prefix) takes
    ring attention over the pool's mesh axis, as the reference's
    sequence-parallel prefill: queries past ``seq_lens`` are end padding,
    which the causal mask keeps out of every valid query's window. A
    prefill with a prefix against a sharded pool reads the row's pages
    gathered from their shards (``gather_sharded_table``).
    """
    B, S, n_heads, hd = q.shape
    n_kv = k.shape[2]
    n_rep = n_heads // n_kv
    if k_pages is not None and has_prefix is None:
        has_prefix = bool((prefix_lens > 0).any())
    if ring:
        if not isinstance(k_pages, ShardedPages) or has_prefix:
            raise ValueError("ring prefill needs a pool sharded over the "
                             "seq axis and no cached prefix")
        return ring_attention(q, k, v, k_pages.mesh,
                              seq_axis=k_pages.seq_axis, scale=scale)
    with_prefix = k_pages is not None and has_prefix
    if with_prefix and isinstance(k_pages, ShardedPages):
        k_pages, v_pages, page_table = gather_sharded_table(
            k_pages, v_pages, page_table)
    if with_prefix and q.is_cuda:
        return mq_paged_attention(q, k_pages, v_pages, page_table,
                                  prefix_lens, seq_lens, scale=scale)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)

    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    qf = q.float() * scale

    # Suffix-suffix scores, causal + padding mask.
    ss = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    rows = torch.arange(S, device=q.device)[None, :, None]
    cols = torch.arange(S, device=q.device)[None, None, :]
    mask = (cols <= rows) & (cols < seq_lens.long()[:, None, None])
    ss = torch.where(mask[:, None, :, :], ss, NEG_INF)

    if not with_prefix:
        probs = torch.softmax(ss, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)

    pk = _repeat_kv(gather_pages(k_pages, page_table), n_rep).float()
    pv = _repeat_kv(gather_pages(v_pages, page_table), n_rep).float()
    T = pk.shape[1]
    live = (torch.arange(T, device=q.device)[None, :]
            < prefix_lens.long()[:, None])                        # [B, T]
    # masked_kv_f32: V rows past the prefix never reach the sum (0 x NaN).
    pv = torch.where(live[:, :, None, None], pv, 0.0)
    ps_scores = torch.einsum("bqhd,bkhd->bhqk", qf, pk)
    ps_scores = torch.where(live[:, None, None, :], ps_scores, NEG_INF)
    scores = torch.cat([ps_scores, ss], dim=-1)
    values = torch.cat([pv, vf], dim=1)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, values).to(q.dtype)


# ------------------------------------------------------------ decode attn
_warned_writeback_modes: set[str] = set()


def kv_writeback_mode() -> str:
    """The single reader of the ``XLLM_KV_WRITEBACK`` decode switch (the
    reference's own). "fused" routes the decode step through the fused
    append-and-attend kernel; "", "slice" and "scatter" are the
    reference's XLA layout variants of the same write, which the port
    treats alike (the write in place, then kernel 1). An unknown value
    falls back to the default with a one-time warning."""
    mode = os.environ.get("XLLM_KV_WRITEBACK", "")
    if mode not in ("", "slice", "scatter", "fused"):
        if mode not in _warned_writeback_modes:
            _warned_writeback_modes.add(mode)
            logging.getLogger(__name__).warning(
                "XLLM_KV_WRITEBACK=%r is not one of '', 'slice', "
                "'scatter', 'fused'; using the default writeback", mode)
        return ""
    return mode


def decode_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_pages: torch.Tensor, v_pages: torch.Tensor,
                          page_table: torch.Tensor,
                          context_lens: torch.Tensor,
                          scale: Optional[float] = None,
                          softcap: float = 0.0, window: int = 0,
                          cp_tables: Optional[list] = None,
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append one token's K/V (in place) and attend, as one step.

    q: [B, n_heads, hd]; k/v: [B, n_kv, hd] — the new token, written at
    position ``context_lens[b] - 1`` (context_lens INCLUDE it); attention
    covers positions < ``context_lens[b]``. Returns (attn [B, n_heads, hd],
    k_pages, v_pages).

    Under ``XLLM_KV_WRITEBACK=fused``, with no softcap, window or explicit
    scale (the reference's condition), the step is one fused append and
    attend (kernel 3 on the card, its plain version on the CPU); otherwise
    the write, then kernel 1.

    With a pool sharded over the seq axis the step is always the write,
    then ``cp_paged_attention`` (kernel 6 per shard on the card), as the
    reference keeps the unfused write under context-parallel decode;
    ``cp_tables`` are the step's compacted tables (``cp_tables`` of
    ``ops/cp_paged_attention.py``), computed per call when None."""
    if isinstance(k_pages, ShardedPages):
        if softcap != 0.0 or window != 0:
            raise NotImplementedError(
                "context-parallel decode does not support attn "
                "softcap/sliding window")
        write_decode_kv(k_pages, v_pages, k, v, page_table, context_lens - 1)
        attn = cp_paged_attention(q, k_pages.shards, v_pages.shards,
                                  page_table, context_lens, k_pages.mesh,
                                  seq_axis=k_pages.seq_axis, scale=scale,
                                  tables=cp_tables)
        return attn, k_pages, v_pages
    if (kv_writeback_mode() == "fused" and softcap == 0.0 and window == 0
            and scale is None):
        return fused_decode_attention(q, k, v, k_pages, v_pages, page_table,
                                      context_lens)
    write_decode_kv(k_pages, v_pages, k, v, page_table, context_lens - 1)
    attn = paged_attention(q, k_pages, v_pages, page_table, context_lens,
                           scale=scale, softcap=softcap, window=window)
    return attn, k_pages, v_pages
