"""Ring attention: causal self-attention with the sequence sharded over a
mesh axis (context-parallel long prefill). Port of
``xllm_service_tpu/ops/ring_attention.py``, plain PyTorch as the reference
computes it in XLA (no TPU kernel).

Mechanism, the reference's blockwise ring (``_ring_attention_local``):
device i of the ``n`` on the axis holds the i-th contiguous chunk of Q/K/V.
K/V chunks rotate around the ring, one hop per step; every hop each device
folds its queries' attention over the visiting chunk into an online
softmax. Across chunks the structure is causal: an earlier chunk is fully
attended, the device's own chunk gets the intra-chunk causal mask, a
later chunk contributes nothing. K/V rotate at their GQA head count and
are repeated only at use.

The reference runs all ``n`` hops on every device (static shapes for XLA)
and masks the later chunks; here a later chunk's hop is skipped. Its
masked hop adds exactly nothing: every row has a finite max after the
first hop (its own chunk's diagonal), so the rescale is exp(0) = 1 and
every p is re-zeroed.

With distinct devices a hop is a ``.to`` of each chunk to the next device;
with repeated devices (one card, or the CPU) it is a no-op. On a mesh over
processes a rank computes only the chunks of its own coordinates (q, k and
v are whole on every rank: the seq axis replicates the residual stream),
and a hop hands the K/V chunk of its last coordinate on to the next rank
of the seq axis's process group while it takes the previous rank's
(``AxisGroup.shift``, send and receive); the outputs of every rank's
chunks are gathered in chunk order. Each chunk's arithmetic is the one
process's, so the result is the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import AXIS_SEQ, DeviceMesh
from ..parallel.sharding import all_parts

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: DeviceMesh, seq_axis: str = AXIS_SEQ,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, S, H, hd], k/v: [B, S, H_kv, hd] (H_kv divides H) with S
    divisible by the axis size; returns the causal self-attention [B, S,
    H, hd] in q's dtype on q's device, each chunk computed on its device
    in f32."""
    n = mesh.shape[seq_axis]
    local = mesh.local_axis(seq_axis)          # [(chunk index, device)]
    mine = [i for i, _ in local]
    devs = dict(local)
    group = mesh.group(seq_axis)
    B, S, H, hd = q.shape
    if S % n:
        raise ValueError(f"sequence of {S} does not divide over {n} shards")
    Sl = S // n
    n_rep = H // k.shape[2]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)

    def chunk(x, i):
        return x[:, i * Sl:(i + 1) * Sl].to(devs[i])

    qf = {i: chunk(q, i).float() * scale for i in mine}
    kv = {i: (chunk(k, i), chunk(v, i)) for i in mine}   # visiting chunks
    m = {i: torch.full((B, H, Sl, 1), NEG_INF, device=devs[i]) for i in mine}
    l = {i: torch.zeros((B, H, Sl, 1), device=devs[i]) for i in mine}
    acc = {i: torch.zeros((B, Sl, H, hd), device=devs[i]) for i in mine}
    causal = torch.ones((Sl, Sl), dtype=torch.bool, device=q.device).tril()

    for step in range(n):
        for my in mine:
            src = (my - step) % n               # which chunk is visiting
            if src > my:
                continue                        # later chunk: adds nothing
            kc, vc = kv[my]
            ku = kc.repeat_interleave(n_rep, dim=2) if n_rep > 1 else kc
            vu = vc.repeat_interleave(n_rep, dim=2) if n_rep > 1 else vc
            s = torch.einsum("bqhd,bkhd->bhqk", qf[my], ku.float())
            if src == my:
                s = torch.where(causal.to(s.device), s, NEG_INF)
            m_new = torch.maximum(m[my], s.amax(dim=-1, keepdim=True))
            p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m_new))
            alpha = torch.exp(m[my] - m_new)
            alpha = torch.where(m[my] <= NEG_INF / 2, 0.0, alpha)
            l[my] = l[my] * alpha + p.sum(dim=-1, keepdim=True)
            alpha_b = alpha[..., 0].transpose(1, 2)[..., None]  # [B, Sl, H, 1]
            acc[my] = acc[my] * alpha_b + torch.einsum(
                "bhqk,bkhd->bhqd", p, vu.float()).transpose(1, 2)
            m[my] = m_new
        if step == n - 1:
            break
        # Rotate K/V one coordinate along the ring: from the previous
        # coordinate where this process holds it, else from the previous
        # rank, which takes this process's last chunk in turn.
        nxt = {i: (kv[(i - 1) % n][0].to(devs[i]),
                   kv[(i - 1) % n][1].to(devs[i]))
               for i in mine if (i - 1) % n in kv}
        if group is not None:
            got = group.shift(torch.stack(kv[mine[-1]]))
            nxt[mine[0]] = (got[0].to(devs[mine[0]]),
                            got[1].to(devs[mine[0]]))
        kv = nxt

    out = [(acc[i] / l[i][..., 0].transpose(1, 2)[..., None].clamp_min(1e-9))
           .to(q.dtype) for i in mine]
    return torch.cat(all_parts(out, q.device, group), dim=1)
