"""DeepSeek-V2-style MoE family (port of
``xllm_service_tpu/models/deepseek_moe.py``), and the body of the mixtral
family (``models/mixtral.py``).

A mixture-of-experts transformer with shared and routed experts and top-k
softmax gating. The dispatch is the reference's dense one: every token is
scored against every expert, every expert runs over every token
(``[E, T, F]``), and the gated combine contracts the expert dim in f32.
It has static shapes, so the decode step captures as a CUDA graph; a
sparse, grouped dispatch computes the same thing with less work (ROADMAP
queue 2).

Attention is MLA (multi-head latent attention) when ``kv_lora_rank > 0``:
the paged pool stores one compressed latent ``[kv_lora_rank ‖ rope_dim]``
a token as a single KV head (written as both K and V), the per-head K
up-projection is absorbed into the query, and the V up-projection runs
after attention. Its decode calls ``ops/attention.py::paged_attention_xla``
and its prefill behind a cached prefix takes the dense route (an explicit
scale), as the reference's does: no TPU kernel computes MLA attention.
Without MLA (mixtral) attention is llama's GQA with RoPE on the port's
kernels. On a pool sharded over a seq mesh (``ShardedPages``) both take
the ring for a long prefix-free install (MLA at its explicit scale over
the one latent head), GQA decodes through kernel 6 per shard on tables
compacted once a step, and MLA's decode route gathers the row's pages
from their shards. The first ``first_dense_layers`` layers run a dense
MLP (the ``dense_mlp`` subtree, stacked over those layers only); the
``moe`` subtree stacks the rest, so HF checkpoints map position for
position (``models/loader.py``).

On a mesh's ``expert`` and ``model`` axes (``MOE_STACKED_RULES``, a
``ShardedParams``) the experts lie on ``expert`` and each expert's ffn on
``model``: every (expert, model) shard runs its experts over every token
and combines them with its columns of the gate map in f32, and the
combines are summed over all shards (over processes, every rank's
gathered over the expert x model plane's group and added in shard order);
the router is replicated and the gate map computed once. Attention, the dense MLP and the shared experts
run per model shard as llama's do (``models/llama.py::forward_shards``);
MLA's ``k_up``/``v_up`` heads lie on ``model`` and its one-head latent
pool is replicated, each shard writing its copy.

Parameters are a plain dict in the reference's layout, so
``models/weights.py`` carries a reference tree over unchanged. Under
``cfg.quant == "int8"`` ``init_params`` builds every projection in its
int8 form one layer and one leaf at a time, so a model whose bf16 tree
does not fit the card (Mixtral-8x7B) never exists whole in bf16; its
leaves equal ``quantize_tree`` of the bf16 tree drawn from the same
generator, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..common.device import resolve_device
from ..ops.attention import (
    decode_attention_step,
    paged_attention_xla,
    prefill_attention,
    rms_norm,
    rope_cos_sin,
    rope_rotate,
    write_decode_kv,
    write_prefill_kv,
)
from ..parallel.mesh import AXIS_EXPERT, AXIS_MODEL
from ..parallel.sharding import (
    ShardedParams,
    ShardingRules,
    all_reduce,
    broadcast,
    replicated_tree,
)
from .base import ModelConfig, ModelFamily, register_model_family
from .llama import (
    _embed,
    _project_qkv,
    _rope,
    _unembed,
    forward_shards,
    on_shards,
    shard_cp_tables,
)
from .quant import (
    QUANT_KERNELS,
    quantize_kernel,
    quantized_einsum,
    quantized_matmul,
)

Params = dict

# The reference's stacked rules. int8 ``/scale`` leaves first (the first
# match wins): a scale has the kernel's dims minus the contraction (-2)
# and shards with the kernel's output dim.
MOE_STACKED_RULES = ShardingRules(rules=[
    (r"(k_up|v_up)/kernel/scale", (None, AXIS_MODEL, None)),
    (r"(kv_down|k_rope)/kernel/scale", ()),
    (r"experts/(gate_proj|up_proj)/kernel/scale",
     (None, AXIS_EXPERT, AXIS_MODEL)),                 # [L, E, F]
    (r"experts/down_proj/kernel/scale", (None, AXIS_EXPERT, None)),
    (r"(shared|dense_mlp)/(gate_proj|up_proj)/kernel/scale",
     (None, AXIS_MODEL)),
    (r"(shared|dense_mlp)/down_proj/kernel/scale", ()),
    (r"(q_proj|k_proj|v_proj)/kernel/scale", (None, AXIS_MODEL)),
    (r"o_proj/kernel/scale", ()),
    (r"lm_head/kernel/scale", (AXIS_MODEL,)),
    # MLA: heads on the model axis; the shared latent projections
    # replicated.
    (r"(k_up|v_up)/kernel", (None, AXIS_MODEL, None, None)),  # [L, H, ., .]
    (r"(kv_down|k_rope)/kernel", ()),
    (r"kv_norm/scale", ()),
    (r"experts/(gate_proj|up_proj)/kernel",
     (None, AXIS_EXPERT, None, AXIS_MODEL)),           # [L, E, D, F]
    (r"experts/down_proj/kernel",
     (None, AXIS_EXPERT, AXIS_MODEL, None)),           # [L, E, F, D]
    (r"shared/(gate_proj|up_proj)/kernel", (None, None, AXIS_MODEL)),
    (r"shared/down_proj/kernel", (None, AXIS_MODEL, None)),
    (r"dense_mlp/(gate_proj|up_proj)/kernel", (None, None, AXIS_MODEL)),
    (r"dense_mlp/down_proj/kernel", (None, AXIS_MODEL, None)),
    (r"router/kernel", ()),
    (r"embed/embedding", (AXIS_MODEL, None)),
    (r"(q_proj|k_proj|v_proj)/kernel", (None, None, AXIS_MODEL)),
    (r"o_proj/kernel", (None, AXIS_MODEL, None)),
    (r"lm_head/kernel", (None, AXIS_MODEL)),
])


def deepseek_v2_lite_config() -> ModelConfig:
    """DeepSeek-V2-Lite with MLA: the pool stores one compressed latent
    (kv_lora_rank 512 + rope 64 = 576 dims) a token, advertised to the
    engine as num_kv_heads=1, head_dim=576."""
    return ModelConfig(name="deepseek_moe", vocab_size=102400,
                       hidden_size=2048, num_layers=27, num_heads=16,
                       num_kv_heads=1, head_dim=576, ffn_size=10944,
                       rope_theta=10000.0, max_context_len=32768,
                       kv_lora_rank=512, qk_nope_head_dim=128,
                       qk_rope_head_dim=64, v_head_dim=128,
                       num_experts=64, num_experts_per_token=6,
                       num_shared_experts=2, moe_ffn_size=1408,
                       first_dense_layers=1)


def bench_moe_config() -> ModelConfig:
    """The reference's MLA+MoE bench shape: V2-Lite's layer geometry cut to
    12 layers, 32 experts and a 32k vocabulary."""
    return dataclasses.replace(deepseek_v2_lite_config(),
                               vocab_size=32768, num_layers=12,
                               max_context_len=4096, num_experts=32)


def tiny_moe_config(**kw) -> ModelConfig:
    defaults = dict(name="deepseek_moe", vocab_size=512, hidden_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                    ffn_size=256, max_context_len=512, num_experts=4,
                    num_experts_per_token=2, num_shared_experts=1,
                    moe_ffn_size=64, first_dense_layers=0)
    defaults.update(kw)
    return ModelConfig(**defaults)


def tiny_mla_config(**kw) -> ModelConfig:
    """Tiny MLA+MoE config: pool entry = 32 latent + 16 rope = 48 dims."""
    defaults = dict(name="deepseek_moe", vocab_size=512, hidden_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=1, head_dim=48,
                    ffn_size=256, max_context_len=512,
                    kv_lora_rank=32, qk_nope_head_dim=32,
                    qk_rope_head_dim=16, v_head_dim=32,
                    num_experts=4, num_experts_per_token=2,
                    num_shared_experts=1, moe_ffn_size=64,
                    first_dense_layers=0)
    defaults.update(kw)
    return ModelConfig(**defaults)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random init (scaled normal in the model dtype, as the reference's
    ``init_params``; the router cast to f32 after) drawn from
    ``generator``, on ``device`` (``cuda`` unless named; the generator must
    live there too). Without a generator, seed 0. Norm scales are ones.

    Leaves are drawn one after another in a fixed order, a stacked leaf
    one layer at a time. Under ``cfg.quant == "int8"`` each drawn layer of
    a ``QUANT_KERNELS`` leaf is quantized at once into the leaf's
    ``{"q8", "scale"}`` (the draw does not depend on the mode), so the
    model dtype's peak is one layer of one leaf: an expert stack
    ``[E, D, F]``."""
    if cfg.quant not in ("", "int8"):
        raise ValueError(f"unknown quant mode {cfg.quant!r}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    D, L, E = cfg.hidden_size, cfg.num_layers, cfg.num_experts
    Fe = cfg.moe_ffn_size
    Fs = cfg.moe_ffn_size * cfg.num_shared_experts
    quant = cfg.quant == "int8"

    def draw(shape) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    def dense(name: str, shape: tuple, fan_in: int,
              dtype: Optional[torch.dtype] = None):
        n = shape[0] if len(shape) >= 3 else 1
        part = shape[1:] if len(shape) >= 3 else shape
        if quant and name in QUANT_KERNELS:
            out = {"q8": torch.empty(shape, dtype=torch.int8, device=dev),
                   "scale": torch.empty((*shape[:-2], shape[-1]),
                                        dtype=torch.float32, device=dev)}
        else:
            out = torch.empty(shape, dtype=dtype or cfg.dtype, device=dev)
        for i in range(n):
            w = (draw(part) * (fan_in ** -0.5)).to(cfg.dtype)
            if isinstance(out, dict):
                q = quantize_kernel(w)
                dst_q, dst_s = ((out["q8"][i], out["scale"][i])
                                if len(shape) >= 3
                                else (out["q8"], out["scale"]))
                dst_q.copy_(q["q8"])
                dst_s.copy_(q["scale"])
            else:
                (out[i] if len(shape) >= 3 else out).copy_(w)
            del w
        return {"kernel": out}

    def ones(shape) -> dict:
        return {"scale": torch.ones(shape, dtype=cfg.dtype, device=dev)}

    if cfg.kv_lora_rank > 0:
        H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dc, dv = cfg.kv_lora_rank, cfg.v_head_dim
        attn = {
            "q_proj": dense("q_proj", (L, D, H * (dn + dr)), D),
            "kv_down": dense("kv_down", (L, D, dc), D),
            "k_rope": dense("k_rope", (L, D, dr), D),
            "kv_norm": ones((L, dc)),
            "k_up": dense("k_up", (L, H, dn, dc), dc),
            "v_up": dense("v_up", (L, H, dc, dv), dc),
            "o_proj": dense("o_proj", (L, H * dv, D), H * dv),
        }
    else:
        Hq, Hkv = cfg.q_size, cfg.kv_size
        attn = {
            "q_proj": dense("q_proj", (L, D, Hq), D),
            "k_proj": dense("k_proj", (L, D, Hkv), D),
            "v_proj": dense("v_proj", (L, D, Hkv), D),
            "o_proj": dense("o_proj", (L, Hq, D), Hq),
        }

    Ld = cfg.first_dense_layers
    Lm = L - Ld
    params: Params = {
        "embed": {"embedding": dense("embed", (cfg.vocab_size, D),
                                     D)["kernel"]},
        "layers": {"input_norm": ones((L, D)), **attn,
                   "post_attn_norm": ones((L, D))},
        "moe": {
            "router": dense("router", (Lm, D, E), D, torch.float32),
            "experts": {
                "gate_proj": dense("gate_proj", (Lm, E, D, Fe), D),
                "up_proj": dense("up_proj", (Lm, E, D, Fe), D),
                "down_proj": dense("down_proj", (Lm, E, Fe, D), Fe),
            },
        },
        "final_norm": ones((D,)),
    }
    if cfg.num_shared_experts > 0:
        params["moe"]["shared"] = {
            "gate_proj": dense("gate_proj", (Lm, D, Fs), D),
            "up_proj": dense("up_proj", (Lm, D, Fs), D),
            "down_proj": dense("down_proj", (Lm, Fs, D), Fs),
        }
    params["lm_head"] = dense("lm_head", (D, cfg.vocab_size), D)
    if Ld > 0:
        F_ = cfg.ffn_size
        params["dense_mlp"] = {
            "gate_proj": dense("gate_proj", (Ld, D, F_), D),
            "up_proj": dense("up_proj", (Ld, D, F_), D),
            "down_proj": dense("down_proj", (Ld, F_, D), F_),
        }
    return params


def _at(node, l: int):
    """Layer ``l``'s leaves of a stacked subtree (an int8 kernel's q8 and
    scale included)."""
    if isinstance(node, dict):
        return {k: _at(v, l) for k, v in node.items()}
    return node[l]


def _gate_map(router: torch.Tensor, x2: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The dense [T, E] gate map: f32 router logits (a loaded router is in
    the model dtype, as the reference's loader casts it, and is promoted),
    the top-k, a softmax over the selected logits scattered into place."""
    logits = x2.float() @ router.float()                         # [T, E]
    topv, topi = torch.topk(logits, cfg.num_experts_per_token, dim=-1)
    return torch.zeros_like(logits).scatter_(
        1, topi, torch.softmax(topv, dim=-1))


def _experts(ex: Params, x2: torch.Tensor, gates: torch.Tensor
             ) -> torch.Tensor:
    """Every expert of the stack ``ex`` over every token ([E, T, F]; the
    products ``td,edf->etf`` and ``etf,efd->etd`` as one batched product
    each, the int8 scale aligned per expert) and the combine with
    ``gates`` [T, E] contracting E in f32 -> [T, D] f32."""
    g = quantized_matmul(x2, ex["gate_proj"]["kernel"])          # [E, T, F]
    u = quantized_matmul(x2, ex["up_proj"]["kernel"])
    eo = quantized_matmul(F.silu(g) * u, ex["down_proj"]["kernel"])
    return torch.einsum("etd,te->td", eo.float(), gates)


def _moe_mlp(mp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [..., D] -> [..., D], the reference's dense dispatch: the gate
    map (``_gate_map``), every expert over every token and the f32
    combine (``_experts``), then the shared experts."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])                                # [T, D]
    gates = _gate_map(mp["router"]["kernel"], x2, cfg)
    routed = _experts(mp["experts"], x2, gates).to(x.dtype)
    if "shared" in mp:
        routed = routed + _dense_mlp(mp["shared"], x2).to(routed.dtype)
    return routed.reshape(shape)


def _moe_mlp_sharded(params: ShardedParams, l: int, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """``_moe_mlp`` of MoE layer ``l`` over the (expert, model) shards:
    the gate map once on the first device; each shard's experts (its ffn
    columns) combined with its columns of the map in f32, the combines
    summed over every shard; the shared experts' partials summed over the
    model shards."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    first = replicated_tree(params)["moe"]
    gates = _gate_map(first["router"]["kernel"][l], x2, cfg)
    E_loc = cfg.num_experts // params.expert
    xs = broadcast(x2, params.devices)
    parts = []
    for (e, _), tree, xi in zip(params.coords, params.trees, xs):
        g = gates[:, e * E_loc:(e + 1) * E_loc].to(xi.device)
        parts.append(_experts(_at(tree["moe"]["experts"], l), xi, g))
    routed = all_reduce(parts, x.device,
                        params.group(AXIS_EXPERT, AXIS_MODEL)).to(x.dtype)
    if "shared" in first:
        shared = all_reduce(
            [_dense_mlp(_at(t["moe"]["shared"], l), xi) for t, xi in
             zip(params.model_trees,
                 broadcast(x2, params.model_devices))],
            x.device, params.group(AXIS_MODEL))
        routed = routed + shared.to(routed.dtype)
    return routed.reshape(shape)


def _dense_mlp(mp: Params, x: torch.Tensor) -> torch.Tensor:
    g = quantized_matmul(x, mp["gate_proj"]["kernel"])
    u = quantized_matmul(x, mp["up_proj"]["kernel"])
    return quantized_matmul(F.silu(g) * u, mp["down_proj"]["kernel"])


def _mla_attention(lp: dict, cfg: ModelConfig, h: torch.Tensor, mode: str,
                   k_pages, v_pages, page_table, prefix_lens, seq_lens,
                   cos_sin, context_lens, positions,
                   has_prefix: Optional[bool], ring: bool = False
                   ) -> torch.Tensor:
    """MLA (DeepSeek-V2). ``mode``: "prefill", "decode" or "dense" (the
    embeddings path: no pool, nothing written). The latent ``[c ‖
    k_rope]`` is written as both K and V of the one-head pool; the nope
    query goes through the K up-projection, the scale is
    ``1 / sqrt(dn + dr)`` (the uncompressed per-head key width), and the V
    up-projection runs on the latent part of the attention's output.
    ``cos_sin`` is rope's of the forward's positions at ``dr`` dims.
    ``ring``: the prefill's self-attention over the sharded pool's seq
    axis (the latent is K and V alike, at its explicit scale). Returns the
    attention output flattened [..., H * dv]."""
    H, dn = cfg.num_heads, cfg.qk_nope_head_dim
    dc = cfg.kv_lora_rank

    c = rms_norm(quantized_matmul(h, lp["kv_down"]["kernel"]),
                 lp["kv_norm"]["scale"], cfg.rms_eps)
    k_r = quantized_matmul(h, lp["k_rope"]["kernel"])
    k_r = rope_rotate(k_r[..., None, :], cos_sin)[..., 0, :]
    entry = torch.cat([c, k_r], dim=-1)[..., None, :]      # [..., 1, dc+dr]

    q = quantized_matmul(h, lp["q_proj"]["kernel"])
    q = q.reshape(*q.shape[:-1], H, dn + cfg.qk_rope_head_dim)
    q_rope = rope_rotate(q[..., dn:], cos_sin)
    q_c = quantized_einsum("...hd,hdc->...hc", q[..., :dn],
                           lp["k_up"]["kernel"])
    q_lat = torch.cat([q_c, q_rope], dim=-1)                # [..., H, dc+dr]
    scale = 1.0 / ((dn + cfg.qk_rope_head_dim) ** 0.5)

    if mode == "dense":
        attn = prefill_attention(q_lat, entry, entry, None, None, None,
                                 prefix_lens, seq_lens, scale=scale)
    elif mode == "prefill":
        write_prefill_kv(k_pages, v_pages, entry, entry, page_table,
                         prefix_lens, seq_lens)
        attn = prefill_attention(q_lat, entry, entry, k_pages, v_pages,
                                 page_table, prefix_lens, seq_lens,
                                 scale=scale, has_prefix=has_prefix,
                                 ring=ring)
    else:
        write_decode_kv(k_pages, v_pages, entry, entry, page_table,
                        positions)
        attn = paged_attention_xla(q_lat, k_pages, v_pages, page_table,
                                   context_lens, scale=scale)
    out = quantized_einsum("...hc,hcv->...hv", attn[..., :dc],
                           lp["v_up"]["kernel"])
    return out.reshape(*out.shape[:-2], H * cfg.v_head_dim)


def _run_layers(params: Params, cfg: ModelConfig, x: torch.Tensor,
                kv_pages: Optional[torch.Tensor], mode: str,
                page_table, prefix_lens, seq_lens, positions: torch.Tensor,
                context_lens, has_prefix: Optional[bool] = None,
                ring: bool = False) -> torch.Tensor:
    """The layer loop, each layer's K/V written into ``kv_pages`` in place
    (None: the embeddings path, no pool, ``prefix_lens`` zeros). ``mode``
    is "prefill" or "decode"; ``ring`` takes the prefill's attention over
    the sharded pool's seq axis. A GQA decode step over a pool sharded by
    page range compacts its tables once for every layer (``cp_tables``).
    Attention and the dense MLP run per model shard, their partial output
    products summed; the MoE MLP per (expert, model) shard."""
    use_mla = cfg.kv_lora_rank > 0
    Ld = cfg.first_dense_layers
    dense = kv_pages is None
    if use_mla:
        cos_sin = rope_cos_sin(positions, cfg.qk_rope_head_dim,
                               cfg.rope_theta)
    else:
        cos_sin = _rope(cfg, positions, x[..., 0])
    shards = forward_shards(params, cfg, kv_pages)
    tables = (shard_cp_tables(shards, page_table, context_lens)
              if mode == "decode" and not use_mla else [None] * len(shards))
    cos, sin = (on_shards(shards, t) for t in cos_sin)
    pts, pls, sls, pos, cls = (on_shards(shards, t) for t in (
        page_table, prefix_lens, seq_lens, positions, context_lens))
    for l in range(cfg.num_layers):
        lps = [_at(s.tree["layers"], l) for s in shards]
        h = rms_norm(x, lps[0]["input_norm"]["scale"], cfg.rms_eps)
        parts = []
        for i, (s, lp, hi) in enumerate(zip(shards, lps,
                                            on_shards(shards, h))):
            c = s.cfg
            k_pages, v_pages = ((None, None) if dense
                                else (s.pool[l, 0], s.pool[l, 1]))
            if use_mla:
                attn = _mla_attention(lp, c, hi, "dense" if dense else mode,
                                      k_pages, v_pages, pts[i], pls[i],
                                      sls[i], (cos[i], sin[i]), cls[i],
                                      pos[i], has_prefix, ring)
            else:
                q, k, v = _project_qkv(lp, hi, c, (cos[i], sin[i]))
                if dense:
                    attn = prefill_attention(q, k, v, None, None, None,
                                             pls[i], sls[i])
                elif mode == "prefill":
                    write_prefill_kv(k_pages, v_pages, k, v, pts[i], pls[i],
                                     sls[i])
                    attn = prefill_attention(q, k, v, k_pages, v_pages,
                                             pts[i], pls[i], sls[i],
                                             has_prefix=has_prefix,
                                             ring=ring)
                else:
                    attn, _, _ = decode_attention_step(
                        q, k, v, k_pages, v_pages, pts[i], cls[i],
                        cp_tables=tables[i])
                attn = attn.reshape(*attn.shape[:-2], c.q_size)
            parts.append(quantized_matmul(attn, lp["o_proj"]["kernel"]))
        x = x + all_reduce(parts, x.device, shards[0].group)
        h2 = rms_norm(x, lps[0]["post_attn_norm"]["scale"], cfg.rms_eps)
        if l < Ld:
            x = x + all_reduce(
                [_dense_mlp(_at(s.tree["dense_mlp"], l), hi) for s, hi in
                 zip(shards, on_shards(shards, h2))], x.device,
                shards[0].group)
        elif isinstance(params, ShardedParams):
            x = x + _moe_mlp_sharded(params, l - Ld, h2, cfg)
        else:
            x = x + _moe_mlp(_at(params["moe"], l - Ld), h2, cfg)
    return x


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
    """Returns (last-valid-token logits [B, V] f32, kv_pages); the suffix's
    K/V (MLA: its latents) are written into ``kv_pages`` in place.
    ``has_prefix`` and ``ring`` as in ``models/llama.py::prefill_forward``
    (MLA's ring runs over the one latent head at MLA's scale)."""
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), kv_pages,
                    "prefill", page_table, prefix_lens, seq_lens, positions,
                    None, has_prefix, ring)
    idx = torch.clamp(seq_lens.long() - 1, min=0)
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    return _unembed(params, cfg, last), kv_pages


def decode_forward(params: Params, cfg: ModelConfig,
                   tokens: torch.Tensor,        # [B] last sampled tokens
                   positions: torch.Tensor,     # [B] their absolute positions
                   kv_pages: torch.Tensor,      # [L, 2, P, n_kv, ps, hd]
                   page_table: torch.Tensor,    # [B, max_pages] int32
                   context_lens: torch.Tensor,  # [B] lens INCLUDING new token
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. Returns (logits [B, V] f32, kv_pages), the new
    tokens' K/V written in place: GQA through ``decode_attention_step``
    (kernel 1 on the card, kernel 3 under ``XLLM_KV_WRITEBACK=fused``;
    kernel 6 per shard over a sharded pool), MLA through
    ``paged_attention_xla``."""
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), kv_pages,
                    "decode", page_table, None, None, positions,
                    context_lens)
    return _unembed(params, cfg, x), kv_pages


def verify_forward(params: Params, cfg: ModelConfig,
                   tokens: torch.Tensor,       # [B, S] block to verify
                   positions: torch.Tensor,    # [B, S]
                   kv_pages: torch.Tensor,
                   page_table: torch.Tensor,
                   prefix_lens: torch.Tensor,  # [B] K/V already in the pool
                   seq_lens: torch.Tensor,     # [B] valid block lengths
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify: the prefill body over a short block per
    sequence, always on the prefix route (kernel 2 on the card for GQA; the
    dense route for MLA's explicit scale), returning the logits at EVERY
    block position [B, S, V] f32."""
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), kv_pages,
                    "prefill", page_table, prefix_lens, seq_lens, positions,
                    None, True)
    return _unembed(params, cfg, x), kv_pages


def embed_forward(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor,     # [B, S] padded token ids
                  seq_lens: torch.Tensor,   # [B] valid lengths
                  ) -> torch.Tensor:
    """Text embeddings: a dense causal forward (no pool), the final norm
    and a mean-pool over the valid positions -> [B, D] f32."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), None,
                    "prefill", None, zeros, seq_lens, positions, None)
    x = rms_norm(x, replicated_tree(params)["final_norm"]["scale"],
                 cfg.rms_eps)
    mask = (torch.arange(S, device=x.device)[None, :]
            < seq_lens.long()[:, None])[..., None]
    summed = torch.where(mask, x.float(), 0.0).sum(dim=1)
    return summed / torch.clamp(seq_lens.float()[:, None], min=1.0)


register_model_family(ModelFamily(
    name="deepseek_moe",
    init_params=init_params,
    prefill_forward=prefill_forward,
    decode_forward=decode_forward,
    verify_forward=verify_forward,
    embed_forward=embed_forward,
    supports_int8=True,
    sharding_rules=MOE_STACKED_RULES,
))
