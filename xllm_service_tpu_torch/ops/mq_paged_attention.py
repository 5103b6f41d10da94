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
it (~6.5 us). For bf16 the kernel therefore runs both products on the tensor
cores (``wgmma``: a warpgroup per 64 rows of (query, GQA head), two to a
block, K/V read from shared memory by the tensor cores themselves), keeps
K/V in bf16 in a ``cp.async`` ring of 64-key chunks, keeps the softmax in
registers with P rounded to bf16 as the second product's operand, runs the
next chunk's scores and the last chunk's value product under each chunk's
softmax, and masks only the chunks that cross a warp's causal diagonal. It
tiles queries across blocks (any suffix length fits; no cap like the TPU's
``S * n_heads <= 4096``). Its time on the card is in PERF.md (measured by
``chip_smoke.py``).

Routes on a CUDA tensor, none of them silent: bf16 with a head dim of 64 or
128 and a GQA group dividing 64 takes the tensor-core kernel; f32 (full f32
arithmetic, the tests' second type) and any other bf16 shape take the f32
walk on the CUDA cores (``csrc/page_walk.cuh``), which wants a head dim
that is a multiple of 32 dividing 256; everything else raises.
``mq_route`` returns the route a call takes.

``mq_paged_attention`` is the wrapper: for a CPU tensor it computes
``mq_paged_attention_plain``; for a CUDA tensor it launches the kernel or
raises. ``mq_paged_attention.launches`` counts the launches.
``mq_paged_attention_tiled_plain`` mirrors the tensor-core kernel's
arithmetic (tile by tile, P rounded to bf16, the unmasked-chunk shortcut)
for the CPU tests.
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


MMA_ROWS = 128    # rows of (query, GQA head) per block, tensor-core kernel
MMA_CHUNK = 64    # keys per chunk of its shared-memory ring


def mq_paged_attention_tiled_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   page_table: torch.Tensor,
                                   prefix_lens: torch.Tensor,
                                   block_lens: torch.Tensor,
                                   scale: Optional[float] = None,
                                   rows: int = MMA_ROWS,
                                   chunk: int = MMA_CHUNK) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch, for the CPU
    tests: per (row, KV head) tiles of ``rows`` rows of (query, GQA head),
    split into groups of 16 rows (a warp's), each walking ``chunk`` keys at
    a time up to the tile's last visible key, with an online softmax in
    base 2 (p = 2^(s * c - m * c), c = scale * log2 e, the maximum kept in
    raw score units); K/V past the context zeroed where they are staged;
    chunks wholly at or below a group's first query take no mask, the
    others are select-masked (a chunk wholly above a group's queries then
    gives p = 0 and leaves its maxima); P is rounded to the input type
    before P @ V while l sums the unrounded p; l is floored at 1e-9. Loops
    in Python: small shapes only."""
    B, S, n_q, hd = q.shape
    n_kv, ps = k_pages.shape[1], k_pages.shape[2]
    G = n_q // n_kv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    sl2 = scale * 1.4426950408889634
    q_tile = rows // G
    out = torch.zeros_like(q)
    T = page_table.shape[1] * ps
    for b in range(B):
        prefix = int(prefix_lens[b])
        blk = min(int(block_lens[b]), S)
        ctx = prefix + blk
        idx = page_table[b].long()
        live = (torch.arange(T) < ctx)[:, None]
        for kv in range(n_kv):
            # Staged K/V: [T, hd], zero at positions >= ctx.
            k = torch.where(live, k_pages[idx, kv].reshape(T, hd), 0)
            v = torch.where(live, v_pages[idx, kv].reshape(T, hd), 0)
            for s0 in range(0, S, q_tile):
                s_end = min(s0 + q_tile, blk)
                if s_end <= s0:
                    continue
                n_tok = min(prefix + s_end, T)
                for w0 in range(0, rows, 16):
                    r = torch.arange(w0, w0 + 16)
                    sq = s0 + r // G                    # query of each row
                    keep = sq < S
                    qw = torch.zeros((16, hd), dtype=q.dtype)
                    qw[keep] = q[b, sq[keep], kv * G + (r % G)[keep]]
                    hi = torch.where(sq < blk, prefix + sq + 1, 0)
                    sw_lo, sw_hi = int(sq[0]), int(sq[-1])
                    m = torch.full((16,), NEG_INF)
                    l = torch.zeros(16)
                    acc = torch.zeros((16, hd))
                    for start in range(0, n_tok, chunk):
                        kc = k[start:start + chunk].float()
                        vc = v[start:start + chunk].float()
                        sc = qw.float() @ kc.T
                        masked = not (sw_hi < blk
                                      and start + chunk <= prefix + sw_lo + 1)
                        if masked:
                            pos = torch.arange(start, start + kc.shape[0])
                            sc = torch.where(pos[None, :] < hi[:, None], sc,
                                             NEG_INF)
                        m_new = torch.maximum(m, sc.amax(dim=1))
                        p = torch.exp2(sc * sl2 - (m_new * sl2)[:, None])
                        if masked:
                            p = torch.where(sc <= NEG_INF / 2, 0.0, p)
                        alpha = torch.exp2((m - m_new) * sl2)
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p.to(q.dtype).float() @ vc
                        m = m_new
                    res = (acc / l.clamp_min(1e-9)[:, None]).to(q.dtype)
                    out[b, sq[keep], kv * G + (r % G)[keep]] = res[keep]
    return out


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p]


def query_tile(group: int, max_rows: int) -> int:
    """Queries per block: as many as fit the kernel's ``max_rows`` rows of
    (query, GQA group head)."""
    return max(1, max_rows // group)


def mq_route(dtype: torch.dtype, hd: int, ps: int, group: int) -> str:
    """The device route of a CUDA call: ``"mma"`` (the tensor-core kernel:
    bf16, head dim 64 or 128, page size a power of two up to 64, a GQA
    group dividing 64) or ``"walk"`` (f32 arithmetic on the CUDA cores: f32
    inputs, and bf16 shapes the tensor-core kernel does not take; the
    wrapper raises where the walk does not take them either)."""
    mma = (dtype == torch.bfloat16 and hd in (64, 128)
           and 0 < ps <= MMA_CHUNK and ps & (ps - 1) == 0
           and group > 0 and 64 % group == 0)
    return "mma" if mma else "walk"


def mq_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       prefix_lens: torch.Tensor, block_lens: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Causal multi-query paged attention. q: [B, Sq, n_q, hd];
    k/v_pages: [P, n_kv, ps, hd]; page_table: [B, max_pages] int32;
    prefix_lens/block_lens: [B] int32. Returns [B, Sq, n_q, hd].

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream (the route ``mq_route`` names), or raises.
    Any Sq is taken."""
    if q.device.type == "cpu":
        return mq_paged_attention_plain(q, k_pages, v_pages, page_table,
                                        prefix_lens, block_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mq_paged_attention: unsupported device {q.device}")
    B, S, n_q, hd = q.shape
    _, n_kv, ps, _ = k_pages.shape
    G = max(1, n_q // n_kv)
    route = mq_route(q.dtype, hd, ps, G)
    if route == "mma":
        max_rows = _build.kernel_fn("mq_paged_attention",
                                    "mq_paged_attention_mma_rows",
                                    [ctypes.c_int] * 3)(hd, ps, G)
        if max_rows != MMA_ROWS:
            raise RuntimeError("mq_paged_attention: the library gives "
                               f"{max_rows} rows per block where mq_route "
                               f"expects {MMA_ROWS}")
        tile = MMA_ROWS // G
    else:
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
                 1 if q.dtype == torch.bfloat16 else 0,
                 1 if route == "mma" else 0, float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mq_paged_attention: CUDA launch failed with "
                           f"error {err}")
    mq_paged_attention.launches += 1
    return out


mq_paged_attention.launches = 0
