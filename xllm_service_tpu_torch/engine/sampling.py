"""Batched token sampling on the device (port of
``xllm_service_tpu/engine/sampling.py``).

Per-slot controls are device tensors, so one code path serves any mix of
greedy/temperature/top-k/top-p/penalty settings. Greedy picks, penalties,
logit bias and the top-k/top-p masks are the reference's arithmetic;
random draws come from one ``torch.Generator`` per batch slot (Gumbel-max
over the filtered logits), which the engine re-seeds when a request takes
the slot, so a seeded request repeats exactly whatever batch it shares.
They are not the reference's random bits: ``jax.random`` and
``torch.Generator`` are different streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

_NEG_INF = -1e30

# Per-slot sparse logit_bias capacity (OpenAI caps the map at 300 keys;
# 32 covers practical use — extra keys are dropped).
NUM_BIAS = 32


@dataclass
class SamplingState:
    """Device-side per-slot sampling controls + penalty bookkeeping."""

    temperature: torch.Tensor        # [B] f32; 0 => greedy
    top_k: torch.Tensor              # [B] i32; <=0 => disabled
    top_p: torch.Tensor              # [B] f32; >=1 => disabled
    frequency_penalty: torch.Tensor  # [B] f32
    presence_penalty: torch.Tensor   # [B] f32
    repetition_penalty: torch.Tensor  # [B] f32; 1 => disabled
    token_counts: torch.Tensor       # [B, V] i32 — occurrences in prompt+output
    bias_ids: Optional[torch.Tensor] = None   # [B, NUM_BIAS] i32; -1 = empty
    bias_vals: Optional[torch.Tensor] = None  # [B, NUM_BIAS] f32

    @classmethod
    def init(cls, batch: int, vocab: int,
             device: torch.device) -> "SamplingState":
        f32, i32 = torch.float32, torch.int32
        return cls(
            temperature=torch.ones((batch,), dtype=f32, device=device),
            top_k=torch.zeros((batch,), dtype=i32, device=device),
            top_p=torch.ones((batch,), dtype=f32, device=device),
            frequency_penalty=torch.zeros((batch,), dtype=f32, device=device),
            presence_penalty=torch.zeros((batch,), dtype=f32, device=device),
            repetition_penalty=torch.ones((batch,), dtype=f32, device=device),
            token_counts=torch.zeros((batch, vocab), dtype=i32, device=device),
            bias_ids=torch.full((batch, NUM_BIAS), -1, dtype=i32,
                                device=device),
            bias_vals=torch.zeros((batch, NUM_BIAS), dtype=f32,
                                  device=device),
        )

    def reset_(self) -> "SamplingState":
        """Every slot back to :meth:`init`'s values, in place (a captured
        decode step keeps reading these tensors)."""
        self.temperature.fill_(1.0)
        self.top_k.zero_()
        self.top_p.fill_(1.0)
        self.frequency_penalty.zero_()
        self.presence_penalty.zero_()
        self.repetition_penalty.fill_(1.0)
        self.token_counts.zero_()
        self.bias_ids.fill_(-1)
        self.bias_vals.zero_()
        return self


def apply_penalties(logits: torch.Tensor, st: SamplingState) -> torch.Tensor:
    """OpenAI-style logit_bias + frequency/presence + HF-style repetition
    penalties. Returns a new tensor."""
    logits = logits.clone()
    if st.bias_ids is not None:
        B = logits.shape[0]
        rows = torch.arange(B, device=logits.device)[:, None].expand_as(
            st.bias_ids)
        has = st.bias_ids >= 0
        safe = torch.where(has, st.bias_ids, 0).long()
        vals = torch.where(has, st.bias_vals, 0.0)
        logits.index_put_((rows, safe), vals, accumulate=True)
    counts = st.token_counts.float()
    seen = (counts > 0).float()
    logits = logits - counts * st.frequency_penalty[:, None]
    logits = logits - seen * st.presence_penalty[:, None]
    rep = st.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(seen > 0, penalized, logits)


def _mask_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k mask with a per-row k (sort threshold)."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.clamp(top_k, 1, V).long()
    thresh = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    keep = (logits >= thresh) | (top_k[:, None] <= 0)
    return torch.where(keep, logits, _NEG_INF)


def _mask_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask: keep the smallest set of tokens with cumprob >= p."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    # Threshold prob: smallest sorted prob whose cumulative mass is still
    # below p keeps its place; everything smaller is dropped.
    still_needed = cum - sorted_probs < top_p[:, None]
    thresh = torch.where(still_needed, sorted_probs, 2.0).amin(
        dim=-1, keepdim=True)
    keep = (probs >= thresh) | (top_p[:, None] >= 1.0)
    return torch.where(keep, logits, _NEG_INF)


def filtered_logits(logits: torch.Tensor, st: SamplingState) -> torch.Tensor:
    """Tempered, top-k and top-p filtered logits of already-penalized
    ``logits``: the distribution a sampled slot draws from."""
    scaled = logits / torch.clamp(st.temperature, min=1e-6)[:, None]
    scaled = _mask_top_k(scaled, st.top_k)
    return _mask_top_p(scaled, st.top_p)


def sample_tokens(logits: torch.Tensor, st: SamplingState,
                  generators: Sequence[Optional[torch.Generator]],
                  want_logprobs: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] f32 -> (tokens [B] i32, logprobs_full [B, V] f32).

    Greedy where temperature == 0; otherwise penalized + tempered +
    top-k/top-p filtered sampling, drawing row b's noise from
    ``generators[b]`` (one draw of V uniforms per call). Rows whose
    generator is None are greedy-only rows: the caller passes a generator
    for every row that may sample, and None everywhere when no row does,
    which skips the full-vocab sorts (the common serving case; the host
    knows each slot's settings). ``want_logprobs`` False returns zeros
    instead of the full-vocab log_softmax.
    """
    logits = apply_penalties(logits, st)
    tokens = torch.argmax(logits, dim=-1)
    if any(g is not None for g in generators):
        scaled = filtered_logits(logits, st)
        u = torch.empty_like(scaled)
        for b, g in enumerate(generators):
            if g is not None:
                torch.rand(scaled.shape[1], generator=g,
                           device=scaled.device, out=u[b])
        noise = -torch.log(-torch.log(u.clamp_min(1e-20)))
        idle = [b for b, g in enumerate(generators) if g is None]
        if idle:
            noise[idle] = 0.0
        sampled = torch.argmax(scaled + noise, dim=-1)
        tokens = torch.where(st.temperature <= 0.0, tokens, sampled)
    if want_logprobs:
        logprobs = torch.log_softmax(logits, dim=-1)
    else:
        logprobs = torch.zeros_like(logits)
    return tokens.to(torch.int32), logprobs


def record_tokens(token_counts: torch.Tensor, tokens: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """Add sampled tokens into the penalty histogram (active slots), in
    place; returns the histogram."""
    B = token_counts.shape[0]
    rows = torch.arange(B, device=token_counts.device)
    token_counts.index_put_((rows, tokens.long()), active.to(torch.int32),
                            accumulate=True)
    return token_counts
