"""Llama-3 family over the paged KV pool (port of
``xllm_service_tpu/models/llama.py``, dense bf16 path).

Architecture: RMSNorm, GQA attention with RoPE, SwiGLU MLP, optional tied
embeddings. Parameters are a plain dict in the reference's layout — every
layer tensor stacked with a leading L dim, projections ``[in, out]`` — so
``models/weights.py`` carries a reference tree over unchanged and both
compute the same thing. The layer loop is a Python loop; the KV pool
``[L, 2, P, n_kv, ps, hd]`` is updated in place. The pool may be sharded
over a mesh's ``seq`` axis (``ShardedPages``): the forwards then compute on
the mesh's first device and the attention ops route per shard.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..common.device import resolve_device
from ..ops.attention import (
    decode_attention_step,
    prefill_attention,
    rms_norm,
    rope_cos_sin,
    rope_rotate,
    write_prefill_kv,
)
from ..ops.cp_paged_attention import ShardedPages, cp_tables
from .base import ModelConfig, ModelFamily, register_model_family

Params = dict


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random init (scaled normal, as the reference's ``init_params``)
    drawn from ``generator``, on ``device`` (``cuda`` unless named; the
    generator must live there too). Without a generator, seed 0.

    Layer tensors are drawn one layer at a time so a full-width model never
    holds an f32 copy of a whole stacked projection."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    D, L = cfg.hidden_size, cfg.num_layers
    Hq, Hkv, F_ = cfg.q_size, cfg.kv_size, cfg.ffn_size

    def dense(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = out[i] if len(shape) == 3 else out
            dst.copy_(torch.randn(dst.shape, generator=generator, device=dev,
                                  dtype=torch.float32) * (fan_in ** -0.5))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    params: Params = {
        "embed": {"embedding": dense((cfg.vocab_size, D), D)},
        "layers": {
            "input_norm": {"scale": ones((L, D))},
            "q_proj": {"kernel": dense((L, D, Hq), D)},
            "k_proj": {"kernel": dense((L, D, Hkv), D)},
            "v_proj": {"kernel": dense((L, D, Hkv), D)},
            "o_proj": {"kernel": dense((L, Hq, D), Hq)},
            "post_attn_norm": {"scale": ones((L, D))},
            "gate_proj": {"kernel": dense((L, D, F_), D)},
            "up_proj": {"kernel": dense((L, D, F_), D)},
            "down_proj": {"kernel": dense((L, F_, D), F_)},
        },
        "final_norm": {"scale": ones((D,))},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": dense((D, cfg.vocab_size), D)}
    return params


def _layer(params: Params, l: int) -> dict:
    return {name: {k: t[l] for k, t in leaf.items()}
            for name, leaf in params["layers"].items()}


def _project_qkv(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                 cos_sin: tuple[torch.Tensor, torch.Tensor]):
    """x: [B, S, D] (or [B, D] for decode) -> q, k, v heads with rope;
    ``cos_sin`` is the forward's ``rope_cos_sin`` of its positions."""
    q = x @ lp["q_proj"]["kernel"]
    k = x @ lp["k_proj"]["kernel"]
    v = x @ lp["v_proj"]["kernel"]
    q = q.reshape(*q.shape[:-1], cfg.num_heads, cfg.head_dim)
    k = k.reshape(*k.shape[:-1], cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(*v.shape[:-1], cfg.num_kv_heads, cfg.head_dim)
    return rope_rotate(q, cos_sin), rope_rotate(k, cos_sin), v


def _mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    gate = x @ lp["gate_proj"]["kernel"]
    up = x @ lp["up_proj"]["kernel"]
    return (F.silu(gate) * up) @ lp["down_proj"]["kernel"]


def _attn_mlp_residual(lp: dict, x: torch.Tensor, attn: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    x = x + attn @ lp["o_proj"]["kernel"]
    h2 = rms_norm(x, lp["post_attn_norm"]["scale"], cfg.rms_eps)
    return x + _mlp(lp, h2)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    """Embedding rows of ``tokens``, with the reference's gather semantics:
    a negative id wraps like numpy's and an id past the vocabulary is
    clamped to its last row (the reference's ``embedding[tokens]`` in JAX
    clamps out-of-range ids; a torch index would raise)."""
    table = params["embed"]["embedding"]
    V = table.shape[0]
    idx = tokens.long()
    idx = torch.where(idx < 0, idx + V, idx).clamp(0, V - 1)
    return table[idx].to(cfg.dtype)


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].T
    else:
        logits = x @ params["lm_head"]["kernel"]
    return logits.float()


def prefill_forward(params: Params, cfg: ModelConfig,
                    tokens: torch.Tensor,       # [B, S] suffix token ids
                    positions: torch.Tensor,    # [B, S] absolute positions
                    kv_pages: torch.Tensor,     # [L, 2, P, n_kv, ps, hd]
                    page_table: torch.Tensor,   # [B, max_pages] int32
                    prefix_lens: torch.Tensor,  # [B] cached-prefix lengths
                    seq_lens: torch.Tensor,     # [B] valid suffix lengths
                    has_prefix: Optional[bool] = None,
                    ring: bool = False,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (last-valid-token logits [B, V] f32, kv_pages). The suffix's
    K/V are written into ``kv_pages`` in place. ``has_prefix`` (any
    prefix_lens > 0) lets the caller pick the attention route without a
    device sync; a prefill with a prefix runs the multi-query kernel on the
    card. ``ring`` (a sharded pool, no prefix, S divisible by the seq
    axis) runs the suffix's self-attention as ring attention."""
    return prefill_from_embeddings(params, cfg, _embed(params, cfg, tokens),
                                   positions, kv_pages, page_table,
                                   prefix_lens, seq_lens,
                                   has_prefix=has_prefix, ring=ring)


def prefill_from_embeddings(params: Params, cfg: ModelConfig,
                            x: torch.Tensor,            # [B, S, D]
                            positions: torch.Tensor,
                            kv_pages: torch.Tensor,
                            page_table: torch.Tensor,
                            prefix_lens: torch.Tensor,
                            seq_lens: torch.Tensor,
                            has_prefix: Optional[bool] = None,
                            ring: bool = False,
                            all_logits: bool = False,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill body over input embeddings ``x`` (``prefill_forward``'s
    arguments otherwise). ``all_logits`` returns the logits of EVERY
    position [B, S, V] f32 (the speculative verify needs each position's
    prediction); by default only the last valid token's [B, V]."""
    if has_prefix is None:
        has_prefix = bool((prefix_lens > 0).any())
    cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_eps)
        q, k, v = _project_qkv(lp, h, cfg, cos_sin)
        k_pages, v_pages = kv_pages[l, 0], kv_pages[l, 1]
        write_prefill_kv(k_pages, v_pages, k, v, page_table, prefix_lens,
                         seq_lens)
        attn = prefill_attention(q, k, v, k_pages, v_pages, page_table,
                                 prefix_lens, seq_lens,
                                 has_prefix=has_prefix, ring=ring)
        x = _attn_mlp_residual(lp, x, attn.reshape(*attn.shape[:-2],
                                                   cfg.q_size), cfg)
    if all_logits:
        return _unembed(params, cfg, x), kv_pages
    idx = torch.clamp(seq_lens.long() - 1, min=0)
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    return _unembed(params, cfg, last), kv_pages


def verify_forward(params: Params, cfg: ModelConfig,
                   tokens: torch.Tensor,       # [B, S] block to verify
                   positions: torch.Tensor,    # [B, S]
                   kv_pages: torch.Tensor,
                   page_table: torch.Tensor,
                   prefix_lens: torch.Tensor,  # [B] K/V already in the pool
                   seq_lens: torch.Tensor,     # [B] valid block lengths
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify: one forward over a short block per sequence (the
    last accepted token and the drafts), returning the logits at EVERY
    block position [B, S, V] f32, the block's K/V written in place. It is
    a batched mini-prefill behind each row's context, always on the prefix
    route (``has_prefix`` a constant, so a captured cycle has one route):
    on the card every layer runs kernel 2 at Sq = S, which at a prefix of
    0 is the block's own causal attention, and a row of block length 0
    writes to the garbage page and comes out zero. The reference opts into
    its kernel for the verify (``XLLM_MQ_PALLAS=1``); here kernel 2
    already carries every prefill with a prefix, so the verify has that
    one route."""
    return prefill_from_embeddings(params, cfg, _embed(params, cfg, tokens),
                                   positions, kv_pages, page_table,
                                   prefix_lens, seq_lens, has_prefix=True,
                                   all_logits=True)


def decode_forward(params: Params, cfg: ModelConfig,
                   tokens: torch.Tensor,        # [B] last sampled tokens
                   positions: torch.Tensor,     # [B] their absolute positions
                   kv_pages: torch.Tensor,      # [L, 2, P, n_kv, ps, hd]
                   page_table: torch.Tensor,    # [B, max_pages] int32
                   context_lens: torch.Tensor,  # [B] lens INCLUDING new token
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. Returns (logits [B, V] f32, kv_pages); the new
    tokens' K/V are written into ``kv_pages`` in place and every layer's
    attention runs through the paged-attention wrapper (the CUDA kernel
    on the card). With a sharded pool every layer runs the
    context-parallel op on tables compacted once for the step."""
    tables = (cp_tables(page_table, context_lens, kv_pages)
              if isinstance(kv_pages, ShardedPages) else None)
    x = _embed(params, cfg, tokens)                                # [B, D]
    # Rope's cos/sin once for the step, shared by every layer's q and k.
    cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_eps)
        q, k, v = _project_qkv(lp, h, cfg, cos_sin)             # [B, H, hd]
        attn, _, _ = decode_attention_step(q, k, v, kv_pages[l, 0],
                                           kv_pages[l, 1], page_table,
                                           context_lens, cp_tables=tables)
        x = _attn_mlp_residual(lp, x, attn.reshape(*attn.shape[:-2],
                                                   cfg.q_size), cfg)
    return _unembed(params, cfg, x), kv_pages


def embed_forward(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor,     # [B, S] padded token ids
                  seq_lens: torch.Tensor,   # [B] valid lengths
                  ) -> torch.Tensor:
    """Text embeddings: a dense causal forward (no paged cache), the final
    norm, and a mean-pool over the valid positions -> [B, D] f32. Attention
    goes through ``prefill_attention`` without a pool, the plain route, as
    the reference's."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x = _embed(params, cfg, tokens)
    cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_eps)
        q, k, v = _project_qkv(lp, h, cfg, cos_sin)
        attn = prefill_attention(q, k, v, None, None, None, zeros, seq_lens)
        x = _attn_mlp_residual(lp, x, attn.reshape(*attn.shape[:-2],
                                                   cfg.q_size), cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    mask = (torch.arange(S, device=x.device)[None, :]
            < seq_lens.long()[:, None])[..., None]
    summed = torch.where(mask, x.float(), 0.0).sum(dim=1)
    return summed / torch.clamp(seq_lens.float()[:, None], min=1.0)


def mixed_decode_chunk_forward(
        params: Params, cfg: ModelConfig,
        dec_tokens: torch.Tensor,       # [B] last sampled tokens
        dec_positions: torch.Tensor,    # [B] their absolute positions
        chunk_tokens: torch.Tensor,     # [c] a prefill chunk (one sequence)
        chunk_positions: torch.Tensor,  # [c] absolute positions in its prompt
        kv_pages: torch.Tensor,         # [L, 2, P, n_kv, ps, hd]
        dec_pt: torch.Tensor,           # [B, max_pages]
        chunk_pt: torch.Tensor,         # [1, max_pages] the chunk's table
        dec_clens: torch.Tensor,        # [B] incl. the new token
        chunk_start: torch.Tensor,      # [] or [1] tokens written before it
        chunk_valid: torch.Tensor,      # [] or [1] live tokens (<= c)
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Sarathi mixed step: one forward that decodes the running batch
    AND writes and attends one chunk of a prefilling sequence. The
    projections, the MLP and the unembed run once over the concatenated
    ``B + c`` rows, so the decode rows ride the chunk's weight stream.

    Per layer the chunk's K/V are written first (its own pages), the
    decode rows attend through ``decode_attention_step`` (kernel 1 on the
    card, kernel 3 under ``XLLM_KV_WRITEBACK=fused``) and the chunk rows
    through ``prefill_attention`` behind ``chunk_start``, always on the
    prefix route (kernel 2 on the card): kernel 2 at a prefix of 0 is the
    causal attention of the chunk alone (its K/V are in the pages
    already), so one route serves every chunk and a captured mixed step
    needs no variant per route.

    Returns (decode-row logits [B, V] f32, kv_pages), the pool updated in
    place. Padding rows (``chunk_valid`` < c) write to the garbage page,
    and their outputs are dropped."""
    B = dec_tokens.shape[0]
    x = torch.cat([_embed(params, cfg, dec_tokens),
                   _embed(params, cfg, chunk_tokens)])            # [B+c, D]
    cos_sin = rope_cos_sin(torch.cat([dec_positions, chunk_positions]),
                           cfg.head_dim, cfg.rope_theta)
    start = chunk_start.reshape(1)
    valid = chunk_valid.reshape(1)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_eps)
        q, k, v = _project_qkv(lp, h, cfg, cos_sin)           # [B+c, H, hd]
        k_pages, v_pages = kv_pages[l, 0], kv_pages[l, 1]
        write_prefill_kv(k_pages, v_pages, k[None, B:], v[None, B:],
                         chunk_pt, start, valid)
        attn_d, _, _ = decode_attention_step(q[:B], k[:B], v[:B], k_pages,
                                             v_pages, dec_pt, dec_clens)
        attn_c = prefill_attention(q[None, B:], k[None, B:], v[None, B:],
                                   k_pages, v_pages, chunk_pt, start, valid,
                                   has_prefix=True)
        attn = torch.cat([attn_d, attn_c[0]])
        x = _attn_mlp_residual(lp, x, attn.reshape(*attn.shape[:-2],
                                                   cfg.q_size), cfg)
    return _unembed(params, cfg, x[:B]), kv_pages


register_model_family(ModelFamily(
    name="llama",
    init_params=init_params,
    prefill_forward=prefill_forward,
    decode_forward=decode_forward,
    embed_forward=embed_forward,
    mixed_decode_chunk_forward=mixed_decode_chunk_forward,
    verify_forward=verify_forward,
))
