"""Llama-3 family over the paged KV pool (port of
``xllm_service_tpu/models/llama.py``), and the shared body of qwen2 and
gemma (``models/qwen2.py``, ``models/gemma.py``).

Architecture: RMSNorm, GQA attention with RoPE, SwiGLU MLP, optional tied
embeddings. The body branches on the config as the reference's does: qkv
biases (qwen2), M-RoPE sections, the (1 + w) norm, the embedding scale,
GeGLU, sandwich norms and the final-logit softcap (gemma), and per layer
the query scale, score softcap and sliding window (``_attn_opts``,
Gemma-2). Every projection goes through ``models/quant.py``'s
``quantized_matmul``, so a weight-only int8 tree serves through the same
forwards. Parameters are a plain dict in the reference's layout — every
layer tensor stacked with a leading L dim, projections ``[in, out]`` — so
``models/weights.py`` carries a reference tree over unchanged and both
compute the same thing. The layer loop is a Python loop; the KV pool
``[L, 2, P, n_kv, ps, hd]`` is updated in place. The pool may be sharded
over a mesh's ``seq`` axis (``ShardedPages``): the forwards then compute on
the mesh's first device and the attention ops route per shard.

Under a mesh's ``model`` axis the parameters are a ``ShardedParams``
(``LLAMA_STACKED_RULES``) and the pool a ``ModelShardedPages``: every
forward runs each layer once per model shard (``forward_shards``) —
q/k/v, gate and up column-parallel, each shard's query heads against its
own KV heads, o and down row-parallel with the partial products summed
(``all_reduce``) — while the norms and the residual stream are computed
once on the mesh's first device. The embedding takes each row from the
shard that holds it, and the logits of the vocabulary shards are joined
before sampling (``all_gather``). An unsharded tree is the one-shard case
of the same loop, with no copy and no reduction.

On a mesh over processes each rank runs its own model shards and the sums
and joins gather every rank's parts over the model axis's process group
(``Shard.group``), in shard order: every rank ends each layer with the same
residual stream and the step with the same full logits, so every rank
samples the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

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
from ..parallel.mesh import AXIS_MODEL
from ..parallel.sharding import (
    ModelShardedPages,
    ShardedParams,
    ShardingRules,
    all_gather,
    all_parts,
    all_reduce,
    broadcast,
)
from .base import ModelConfig, ModelFamily, register_model_family, \
    shard_config
from .quant import quantize_kernel, quantized_matmul

Params = dict


# Stacked-layer sharding rules (the reference's, leading L dim on every
# layer tensor). int8 ``/scale`` leaves come first (the first match wins):
# a scale [L, out] shards with a column-parallel kernel's output dim and is
# replicated for a row-parallel one, whose sharded dim is the contraction
# it reduced over. The ``q8`` leaf matches its kernel's pattern.
LLAMA_STACKED_RULES = ShardingRules(rules=[
    (r"embed/embedding", (AXIS_MODEL, None)),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel/scale",
     (None, AXIS_MODEL)),
    (r"(o_proj|down_proj)/kernel/scale", ()),
    (r"lm_head/kernel/scale", (AXIS_MODEL,)),
    (r"(q_proj|k_proj|v_proj)/kernel", (None, None, AXIS_MODEL)),
    (r"(q_proj|k_proj|v_proj)/bias", (None, AXIS_MODEL)),
    (r"o_proj/kernel", (None, AXIS_MODEL, None)),
    (r"(gate_proj|up_proj)/kernel", (None, None, AXIS_MODEL)),
    (r"down_proj/kernel", (None, AXIS_MODEL, None)),
    (r"lm_head/kernel", (None, AXIS_MODEL)),
])


# Columns of a projection quantized at once by the int8 draw.
QUANT_COLUMNS = 8192


class Shard(NamedTuple):
    """One model shard of a forward: its tree, the config it computes
    with (its heads and ffn), its pool (None without one), its device
    (None for an unsharded tree: where the inputs lie) and the model
    axis's process group (None within one process)."""
    tree: dict
    cfg: ModelConfig
    pool: object
    device: Optional[torch.device]
    group: object = None


def forward_shards(params, cfg: ModelConfig, kv_pages=None) -> list[Shard]:
    """The model shards a forward runs: one (the tree itself) for an
    unsharded tree; for a ``ShardedParams`` the trees of the model axis
    this process holds (at expert index 0 on one process), each with its
    part of a ``ModelShardedPages`` pool."""
    if not isinstance(params, ShardedParams):
        return [Shard(params, cfg, kv_pages, None)]
    scfg = shard_config(cfg, params.model)
    trees = params.model_trees
    if isinstance(kv_pages, ModelShardedPages):
        pools = kv_pages.shards
    elif kv_pages is None or params.model == 1:
        pools = [kv_pages] * len(trees)
    else:
        raise TypeError("a tree sharded over a model axis needs a "
                        "ModelShardedPages pool")
    group = params.group(AXIS_MODEL)
    return [Shard(t, scfg, p, d, group) for t, p, d in
            zip(trees, pools, params.model_devices)]


def on_shards(shards: list[Shard], x):
    """``x`` (a tensor, or None) on each shard's device."""
    if x is None or shards[0].device is None:
        return [x] * len(shards)
    return broadcast(x, [s.device for s in shards])


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random init (scaled normal, as the reference's ``init_params``)
    drawn from ``generator``, on ``device`` (``cuda`` unless named; the
    generator must live there too). Without a generator, seed 0.

    Layer tensors are drawn one layer at a time so a full-width model never
    holds an f32 copy of a whole stacked projection. Biases are zeros and
    norm scales ones, or zeros under ``rms_unit_offset`` (the norm then
    computes 1 + w), as the reference draws them. Under ``cfg.quant ==
    "int8"`` each drawn layer of a projection is quantized at once into
    its ``{"q8", "scale"}`` (the draw does not depend on the mode, so the
    leaves equal ``quantize_tree`` of the model-dtype tree bit for bit),
    and the model dtype's peak is one layer of one projection: a model
    whose model-dtype tree does not fit the card (Llama-3-70B) never
    exists whole in it."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    D, L = cfg.hidden_size, cfg.num_layers
    Hq, Hkv, F_ = cfg.q_size, cfg.kv_size, cfg.ffn_size

    quant = cfg.quant == "int8"

    def dense(shape, fan_in, projection=True):
        if not (quant and projection):
            out = torch.empty(shape, dtype=cfg.dtype, device=dev)
            for i in range(shape[0] if len(shape) == 3 else 1):
                dst = out[i] if len(shape) == 3 else out
                dst.copy_(torch.randn(dst.shape, generator=generator,
                                      device=dev, dtype=torch.float32)
                          * (fan_in ** -0.5))
            return out
        out = {"q8": torch.empty(shape, dtype=torch.int8, device=dev),
               "scale": torch.empty((*shape[:-2], shape[-1]),
                                    dtype=torch.float32, device=dev)}
        for i in range(shape[0] if len(shape) == 3 else 1):
            part = shape[1:] if len(shape) == 3 else shape
            w = torch.randn(part, generator=generator, device=dev,
                            dtype=torch.float32)
            w = w.mul_(fan_in ** -0.5).to(cfg.dtype)
            q8, scale = ((out["q8"][i], out["scale"][i]) if len(shape) == 3
                         else (out["q8"], out["scale"]))
            # Output channels quantize independently: in column blocks,
            # so a [8192, 128256] lm_head needs no f32 copy of itself.
            for c in range(0, part[-1], QUANT_COLUMNS):
                q = quantize_kernel(w[:, c:c + QUANT_COLUMNS])
                q8[:, c:c + QUANT_COLUMNS] = q["q8"]
                scale[c:c + QUANT_COLUMNS] = q["scale"]
            del w
        return out

    def norm_init(shape):
        fill = torch.zeros if cfg.rms_unit_offset else torch.ones
        return fill(shape, dtype=cfg.dtype, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    params: Params = {
        "embed": {"embedding": dense((cfg.vocab_size, D), D, False)},
        "layers": {
            "input_norm": {"scale": norm_init((L, D))},
            "q_proj": {"kernel": dense((L, D, Hq), D)},
            "k_proj": {"kernel": dense((L, D, Hkv), D)},
            "v_proj": {"kernel": dense((L, D, Hkv), D)},
            "o_proj": {"kernel": dense((L, Hq, D), Hq)},
            "post_attn_norm": {"scale": norm_init((L, D))},
            "gate_proj": {"kernel": dense((L, D, F_), D)},
            "up_proj": {"kernel": dense((L, D, F_), D)},
            "down_proj": {"kernel": dense((L, F_, D), F_)},
        },
        "final_norm": {"scale": norm_init((D,))},
    }
    layers = params["layers"]
    if cfg.qkv_bias:
        layers["q_proj"]["bias"] = zeros((L, Hq))
        layers["k_proj"]["bias"] = zeros((L, Hkv))
        layers["v_proj"]["bias"] = zeros((L, Hkv))
    if cfg.sandwich_norms:       # gemma-2: pre/post feed-forward norms
        layers["pre_ffw_norm"] = {"scale": norm_init((L, D))}
        layers["post_ffw_norm"] = {"scale": norm_init((L, D))}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": dense((D, cfg.vocab_size), D)}
    return params


def _layer(params: Params, l: int) -> dict:
    """Layer ``l``'s leaves (an int8 kernel's q8 and scale included)."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return node[l]
    return pick(params["layers"])


def _rope(cfg: ModelConfig, positions: torch.Tensor, tokens: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rope's cos/sin of a forward's positions, once for every layer:
    positions with one axis more than the tokens carry the M-RoPE streams
    of ``cfg.mrope_section`` (``apply_rope``'s rule)."""
    mrope = (cfg.mrope_section
             if cfg.mrope_section and positions.ndim == tokens.ndim + 1
             else ())
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, mrope)


def _project_qkv(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                 cos_sin: tuple[torch.Tensor, torch.Tensor]):
    """x: [B, S, D] (or [B, D] for decode) -> q, k, v heads with rope;
    ``cos_sin`` is the forward's ``_rope`` of its positions."""
    q = quantized_matmul(x, lp["q_proj"]["kernel"])
    k = quantized_matmul(x, lp["k_proj"]["kernel"])
    v = quantized_matmul(x, lp["v_proj"]["kernel"])
    if "bias" in lp["q_proj"]:
        q = q + lp["q_proj"]["bias"]
        k = k + lp["k_proj"]["bias"]
        v = v + lp["v_proj"]["bias"]
    q = q.reshape(*q.shape[:-1], cfg.num_heads, cfg.head_dim)
    k = k.reshape(*k.shape[:-1], cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(*v.shape[:-1], cfg.num_kv_heads, cfg.head_dim)
    return rope_rotate(q, cos_sin), rope_rotate(k, cos_sin), v


def _attn_opts(cfg: ModelConfig, layer: int) -> dict:
    """Per-layer attention options of the Gemma-2 extras: the explicit
    query scale (query_pre_attn_scalar), the score softcap, and the sliding
    window on local layers. Empty for every other family, so their calls
    keep every kernel route (the fused decode needs no scale given)."""
    opts: dict = {}
    if cfg.query_pre_attn_scalar > 0:
        opts["scale"] = cfg.query_pre_attn_scalar ** -0.5
    if cfg.attn_logit_softcap > 0:
        opts["softcap"] = cfg.attn_logit_softcap
    if cfg.layer_is_local(layer):
        opts["window"] = cfg.sliding_window
    return opts


def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    """RMSNorm; the gemma family stores w with the norm computing (1 + w)
    in f32 (``rms_unit_offset``)."""
    if cfg.rms_unit_offset:
        scale = 1.0 + scale.float()
    return rms_norm(x, scale, cfg.rms_eps)


def _mlp(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU, or GeGLU with the tanh approximation of gelu (the
    reference's ``jax.nn.gelu`` default; torch's default is erf)."""
    gate = quantized_matmul(x, lp["gate_proj"]["kernel"])
    up = quantized_matmul(x, lp["up_proj"]["kernel"])
    act = (F.gelu(gate, approximate="tanh") if cfg.act == "gelu"
           else F.silu(gate))
    return quantized_matmul(act * up, lp["down_proj"]["kernel"])


def _attn_mlp_residual(shards: list[Shard], lps: list[dict],
                       x: torch.Tensor, o: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    """Fold the attention's output projection ``o`` (summed over the
    shards) and the MLP into the residual stream; each shard's MLP runs
    its ffn columns and their partial products are summed.
    ``sandwich_norms`` (Gemma-2) norms the attention and MLP outputs too:
    x += post_attn_norm(o); x += post_ffw_norm(mlp(pre_ffw_norm(x)))."""
    def mlp(h2: torch.Tensor) -> torch.Tensor:
        return all_reduce([_mlp(lp, h, s.cfg) for s, lp, h in
                           zip(shards, lps, on_shards(shards, h2))],
                          h2.device, shards[0].group)

    if cfg.sandwich_norms:
        x = x + _norm(o, lps[0]["post_attn_norm"]["scale"], cfg)
        h2 = _norm(x, lps[0]["pre_ffw_norm"]["scale"], cfg)
        return x + _norm(mlp(h2), lps[0]["post_ffw_norm"]["scale"], cfg)
    x = x + o
    h2 = _norm(x, lps[0]["post_attn_norm"]["scale"], cfg)
    return x + mlp(h2)


def _layers(shards: list[Shard], cfg: ModelConfig, x: torch.Tensor,
            attend) -> torch.Tensor:
    """Every layer over the residual stream ``x``: the input norm once,
    then on each shard ``attend(i, l, lp, h)`` (shard ``i``'s attention
    over its heads of layer ``l``, [..., H_i, hd], its K/V written into
    its pool) and its output projection, the partials summed in shard
    order, then the MLP."""
    for l in range(cfg.num_layers):
        lps = [_layer(s.tree, l) for s in shards]
        h = _norm(x, lps[0]["input_norm"]["scale"], cfg)
        parts = []
        for i, (s, lp, hi) in enumerate(zip(shards, lps,
                                            on_shards(shards, h))):
            attn = attend(i, l, lp, hi)
            parts.append(quantized_matmul(
                attn.reshape(*attn.shape[:-2], s.cfg.q_size),
                lp["o_proj"]["kernel"]))
        x = _attn_mlp_residual(
            shards, lps, x, all_reduce(parts, x.device, shards[0].group),
            cfg)
    return x


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens``, with the reference's gather semantics:
    a negative id wraps like numpy's and an id past the vocabulary is
    clamped to its last row (the reference's ``embedding[tokens]`` in JAX
    clamps out-of-range ids; a torch index would raise). A vocabulary-
    sharded table gives each row from the shard that holds it (every
    rank's rows gathered over processes)."""
    sharded = isinstance(params, ShardedParams)
    tables = ([t["embed"]["embedding"] for t in params.model_trees]
              if sharded else [params["embed"]["embedding"]])
    Vl = tables[0].shape[0]
    V = Vl * (params.model if sharded else 1)
    idx = tokens.long()
    idx = torch.where(idx < 0, idx + V, idx).clamp(0, V - 1)
    if V == Vl:
        x = tables[0][idx]
    else:
        owner = (idx // Vl)[..., None]
        rows = all_parts(
            [table[(idx - m * Vl).clamp(0, Vl - 1).to(table.device)]
             for m, table in zip(params.model_indices, tables)],
            idx.device, params.group(AXIS_MODEL))
        x = None
        for m, r in enumerate(rows):
            x = r if x is None else torch.where(owner == m, r, x)
    x = x.to(cfg.dtype)
    if cfg.embed_scale:
        # gemma scales by sqrt(hidden), cast to the model dtype first as
        # the reference's jnp.asarray(h ** 0.5, dtype) (bf16: 59.75 for
        # 3584 ** 0.5 = 59.866).
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype).item()
    return x


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and logits [..., V] f32; vocabulary shards' logits are
    joined on the first device."""
    shards = forward_shards(params, cfg)
    x = _norm(x, shards[0].tree["final_norm"]["scale"], cfg)
    parts = []
    for s, xi in zip(shards, on_shards(shards, x)):
        if cfg.tie_embeddings:
            parts.append(xi @ s.tree["embed"]["embedding"].T)
        else:
            parts.append(quantized_matmul(xi, s.tree["lm_head"]["kernel"]))
    logits = all_gather(parts, -1, x.device, shards[0].group).float()
    if cfg.final_logit_softcap > 0:       # gemma-2's tanh cap
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


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
    shards = forward_shards(params, cfg, kv_pages)
    cos, sin = (on_shards(shards, t) for t in _rope(cfg, positions, x[..., 0]))
    pts, pls, sls = (on_shards(shards, t)
                     for t in (page_table, prefix_lens, seq_lens))

    def attend(i, l, lp, h):
        s = shards[i]
        q, k, v = _project_qkv(lp, h, s.cfg, (cos[i], sin[i]))
        k_pages, v_pages = s.pool[l, 0], s.pool[l, 1]
        write_prefill_kv(k_pages, v_pages, k, v, pts[i], pls[i], sls[i])
        return prefill_attention(q, k, v, k_pages, v_pages, pts[i], pls[i],
                                 sls[i], has_prefix=has_prefix, ring=ring,
                                 **_attn_opts(cfg, l))

    x = _layers(shards, cfg, x, attend)
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
                   rope_positions: Optional[torch.Tensor] = None,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. Returns (logits [B, V] f32, kv_pages); the new
    tokens' K/V are written into ``kv_pages`` in place and every layer's
    attention runs through the paged-attention wrapper (the CUDA kernel
    on the card; once per model shard over a head-sharded pool). With a
    pool sharded over the seq axis every layer runs the context-parallel
    op on tables compacted once for the step.

    ``rope_positions`` [B] (M-RoPE, qwen2_vl): rope rotates q and k at
    these positions (the sequence index plus the slot's delta left by its
    image grids), while the K/V write and the paging stay at
    ``positions``."""
    tables = (cp_tables(page_table, context_lens, kv_pages)
              if isinstance(kv_pages, ShardedPages) else None)
    x = _embed(params, cfg, tokens)                                # [B, D]
    if rope_positions is None:
        rope_positions = positions
    # Rope's cos/sin once for the step, shared by every layer's q and k.
    shards = forward_shards(params, cfg, kv_pages)
    cos, sin = (on_shards(shards, t)
                for t in _rope(cfg, rope_positions, tokens))
    pts, cls = (on_shards(shards, t) for t in (page_table, context_lens))

    def attend(i, l, lp, h):
        s = shards[i]
        q, k, v = _project_qkv(lp, h, s.cfg, (cos[i], sin[i]))  # [B, H, hd]
        attn, _, _ = decode_attention_step(q, k, v, s.pool[l, 0],
                                           s.pool[l, 1], pts[i], cls[i],
                                           cp_tables=tables,
                                           **_attn_opts(cfg, l))
        return attn

    x = _layers(shards, cfg, x, attend)
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
    shards = forward_shards(params, cfg)
    cos, sin = (on_shards(shards, t) for t in _rope(cfg, positions, tokens))
    zeros = on_shards(shards, torch.zeros((B,), dtype=torch.int32,
                                          device=tokens.device))
    sls = on_shards(shards, seq_lens)

    def attend(i, l, lp, h):
        q, k, v = _project_qkv(lp, h, shards[i].cfg, (cos[i], sin[i]))
        return prefill_attention(q, k, v, None, None, None, zeros[i],
                                 sls[i], **_attn_opts(cfg, l))

    x = _layers(shards, cfg, x, attend)
    x = _norm(x, shards[0].tree["final_norm"]["scale"], cfg)
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
    tokens = torch.cat([dec_tokens, chunk_tokens])
    shards = forward_shards(params, cfg, kv_pages)
    cos, sin = (on_shards(shards, t) for t in _rope(
        cfg, torch.cat([dec_positions, chunk_positions]), tokens))
    dpt, cpt, dcl, start, valid = (on_shards(shards, t) for t in (
        dec_pt, chunk_pt, dec_clens, chunk_start.reshape(1),
        chunk_valid.reshape(1)))

    def attend(i, l, lp, h):
        s = shards[i]
        opts = _attn_opts(cfg, l)
        q, k, v = _project_qkv(lp, h, s.cfg, (cos[i], sin[i]))  # [B+c, H, hd]
        k_pages, v_pages = s.pool[l, 0], s.pool[l, 1]
        write_prefill_kv(k_pages, v_pages, k[None, B:], v[None, B:],
                         cpt[i], start[i], valid[i])
        attn_d, _, _ = decode_attention_step(q[:B], k[:B], v[:B], k_pages,
                                             v_pages, dpt[i], dcl[i], **opts)
        attn_c = prefill_attention(q[None, B:], k[None, B:], v[None, B:],
                                   k_pages, v_pages, cpt[i], start[i],
                                   valid[i], has_prefix=True, **opts)
        return torch.cat([attn_d, attn_c[0]])

    x = _layers(shards, cfg, x, attend)
    return _unembed(params, cfg, x[:B]), kv_pages


register_model_family(ModelFamily(
    name="llama",
    init_params=init_params,
    prefill_forward=prefill_forward,
    decode_forward=decode_forward,
    embed_forward=embed_forward,
    mixed_decode_chunk_forward=mixed_decode_chunk_forward,
    verify_forward=verify_forward,
    supports_int8=True,
    sharding_rules=LLAMA_STACKED_RULES,
))
