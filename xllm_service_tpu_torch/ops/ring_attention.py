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
with repeated devices (one card, or the CPU) it is a no-op.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import AXIS_SEQ, DeviceMesh

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: DeviceMesh, seq_axis: str = AXIS_SEQ,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, S, H, hd], k/v: [B, S, H_kv, hd] (H_kv divides H) with S
    divisible by the axis size; returns the causal self-attention [B, S,
    H, hd] in q's dtype on q's device, each chunk computed on its device
    in f32."""
    devs = mesh.axis_devices(seq_axis)
    n = len(devs)
    B, S, H, hd = q.shape
    if S % n:
        raise ValueError(f"sequence of {S} does not divide over {n} shards")
    Sl = S // n
    n_rep = H // k.shape[2]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)

    def chunk(x, i):
        return x[:, i * Sl:(i + 1) * Sl].to(devs[i])

    qf = [chunk(q, i).float() * scale for i in range(n)]
    kv = [(chunk(k, i), chunk(v, i)) for i in range(n)]   # visiting chunks
    m = [torch.full((B, H, Sl, 1), NEG_INF, device=d) for d in devs]
    l = [torch.zeros((B, H, Sl, 1), device=d) for d in devs]
    acc = [torch.zeros((B, Sl, H, hd), device=d) for d in devs]
    causal = torch.ones((Sl, Sl), dtype=torch.bool, device=q.device).tril()

    for step in range(n):
        for my in range(n):
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
        # Rotate K/V one device along the ring.
        kv = [(kv[(i - 1) % n][0].to(devs[i]), kv[(i - 1) % n][1].to(devs[i]))
              for i in range(n)]

    out = [(acc[i] / l[i][..., 0].transpose(1, 2)[..., None].clamp_min(1e-9))
           .to(q.dtype).to(q.device) for i in range(n)]
    return torch.cat(out, dim=1)
