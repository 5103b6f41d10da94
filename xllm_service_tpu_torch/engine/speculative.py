"""Device-side pieces of speculative decoding (port of the draft proposer
and the eligibility predicate inside ``spec_multi`` in
``xllm_service_tpu/engine/engine.py``).

``propose_drafts`` and ``spec_eligible`` are plain functions on device
tensors: they read nothing from the host and have no shape that depends
on data, so the engine's spec cycle that calls them can be captured as a
CUDA graph (``engine/decode_graph.py``). ``spec_ok`` is the same
eligibility rule on a request's sampling parameters, for the host's path
choice.
"""

from __future__ import annotations

import torch

from ..common.request import SamplingParams
from .sampling import SamplingState


def propose_drafts(hist: torch.Tensor, clens: torch.Tensor,
                   hist_lo: torch.Tensor, ngram: int, k: int
                   ) -> torch.Tensor:
    """Prompt-lookup drafts: the ``k``-token continuation of the most
    recent earlier occurrence of each row's trailing ``ngram`` tokens in
    ``hist[b, hist_lo[b]:clens[b]]``, -1 where there is none (-1 never
    matches a prediction, so a draftless slot emits exactly one token).

    hist: [B, L] int32, valid in [hist_lo, clens) (``hist[clens - 1]`` is
    the slot's last token); clens, hist_lo: [B] int32. Returns [B, k]
    int32. The match must end before the tail starts and its continuation
    is cut at ``clens``; positions before ``hist_lo`` (a cache-matched
    prefix whose tokens this engine never saw) are not searched. Gathers
    read clamped indices (the reference's ``take_along_axis`` with
    ``clip``); the [B, L] compare is small beside the verify forward."""
    B, L = hist.shape
    dev = hist.device
    clens = clens.long()
    tail_pos = clens[:, None] - ngram + torch.arange(ngram, device=dev)
    tail = torch.gather(hist, 1, tail_pos.clamp(0, L - 1))
    n = L - ngram + 1
    m = torch.ones((B, n), dtype=torch.bool, device=dev)
    for i in range(ngram):
        m &= hist[:, i:n + i] == tail[:, i:i + 1]
    p = torch.arange(n, device=dev)[None, :]
    valid = ((p >= hist_lo.long()[:, None])
             & (p <= clens[:, None] - ngram - 2)
             & (clens[:, None] > ngram))
    best = torch.where(m & valid, p, -1).amax(dim=1)               # [B]
    dpos = best[:, None] + ngram + torch.arange(k, device=dev)
    ok = (best[:, None] >= 0) & (dpos < clens[:, None])
    drafts = torch.gather(hist, 1, dpos.clamp(0, L - 1))
    return torch.where(ok, drafts, -1).to(torch.int32)


def spec_ok(sp: SamplingParams) -> bool:
    """``spec_eligible`` on the host, from one request's sampling
    parameters. It only informs the path choice; ineligible slots still
    run, a normal sampled step inside the same cycle."""
    return (sp.temperature == 0.0 and not sp.logprobs
            and sp.frequency_penalty == 0.0
            and sp.presence_penalty == 0.0
            and sp.repetition_penalty in (0.0, 1.0)
            and not sp.logit_bias)


def spec_eligible(st: SamplingState, want_lp: torch.Tensor) -> torch.Tensor:
    """[B] bool: the slots whose verify is greedy-exact, decided on the
    device from their sampling state: greedy, no frequency, presence or
    repetition penalty, no logprobs (``want_lp`` [B] bool), no logit bias.
    Every other slot takes a normal sampled step in the same cycle."""
    rp = st.repetition_penalty
    return ((st.temperature <= 0.0) & (st.frequency_penalty == 0.0)
            & (st.presence_penalty == 0.0) & ((rp == 1.0) | (rp == 0.0))
            & ~want_lp & (st.bias_ids < 0).all(dim=-1))
