"""Qwen2-VL family (port of ``xllm_service_tpu/models/qwen2_vl.py``):
the multimodal model of the EPD path, which splits an image request into
three stages (encode, prefill, decode).

- **Vision encoder** (``encode_images``): a patch-embedding ViT with
  bidirectional attention, projected to the LM width. It is the ENCODE
  stage, which an EPD fleet pins to a dedicated ``InstanceType.ENCODE``
  agent (its ``/rpc/encode``). Its attention is plain PyTorch in f32, as
  the reference computes it; the reference has no Pallas kernel there.
- **LM**: the qwen2 text stack (``models/llama.py``'s body).
  ``prefill_forward`` takes optional ``mm_embeds``, spliced into the
  positions whose token id is ``cfg.image_token_id``, and M-RoPE positions
  ``[B, S, 3]`` (``mrope_positions``, computed on the host).

Decode is the llama step with its rope rotated at the sequence index plus
a per-slot delta (``decode_forward``'s ``rope_positions``): visual content
only changes the prefill. The family has no verify and no mixed forward,
so speculation and Sarathi rides are off for it, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..common.device import resolve_device
from ..parallel.sharding import ShardingRules, replicated_tree
from . import llama as _llama
from .base import ModelConfig, ModelFamily, VisionConfig, register_model_family

Params = dict

# The vision tower is replicated (each model shard's tree holds it whole);
# the text body takes the llama rules.
QWEN2_VL_RULES = ShardingRules(rules=[
    (r"vision/", ()),
    *_llama.LLAMA_STACKED_RULES.rules,
])

IMAGE_TOKEN_ID = 151655   # Qwen2-VL's <|image_pad|> id (the splice's marker)


def tiny_vl_config(**kw) -> ModelConfig:
    defaults = dict(
        name="qwen2_vl", vocab_size=512, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, ffn_size=256,
        qkv_bias=True, max_context_len=512,
        mrope_section=(4, 6, 6),       # t/h/w half-dims (sum = hd/2)
        vision=VisionConfig(image_size=28, patch_size=14, hidden_size=64,
                            num_layers=2, num_heads=4, out_tokens=4,
                            temporal_patch_size=1, spatial_merge_size=1))
    defaults.update(kw)
    return ModelConfig(**defaults)


def qwen2_vl_2b_config(**kw) -> ModelConfig:
    """Qwen2-VL-2B-Instruct's shapes (its config.json: 1536 hidden, 28
    layers, 12 heads over 2 KV heads, 8960 ffn, rope_theta 1e6,
    rope_scaling.mrope_section [16, 24, 24]; the visual tower 1280 wide
    and 32 deep, patch 14, a 2x2 spatial merge, temporal patch 2). A 224
    px image gives (224 / 14 / 2)^2 = 64 visual tokens."""
    defaults = dict(
        name="qwen2_vl", vocab_size=151936, hidden_size=1536,
        num_layers=28, num_heads=12, num_kv_heads=2, head_dim=128,
        ffn_size=8960, qkv_bias=True, rope_theta=1_000_000.0,
        tie_embeddings=True, max_context_len=32768,
        mrope_section=(16, 24, 24),
        vision=VisionConfig(image_size=224, patch_size=14,
                            hidden_size=1280, num_layers=32, num_heads=16,
                            out_tokens=64, temporal_patch_size=2,
                            spatial_merge_size=2))
    defaults.update(kw)
    return ModelConfig(**defaults)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """The llama body's random weights, then ``params["vision"]``, drawn
    from ``generator`` after them (scaled normal kernels, zero biases,
    unit LayerNorm scales, as the reference draws them) on ``device``
    (``cuda`` unless named)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = _llama.init_params(cfg, generator, dev)
    v = cfg.vision
    assert v is not None, "qwen2_vl requires a VisionConfig"
    want = (v.image_size // v.patch_size // v.spatial_merge_size) ** 2
    assert v.out_tokens == want, (
        f"out_tokens={v.out_tokens} inconsistent with the patch grid / "
        f"merge size (expected {want}) — the engine pads mm uploads in "
        "out_tokens units")
    Dv, Lv = v.hidden_size, v.num_layers
    patch_dim = 3 * v.temporal_patch_size * v.patch_size * v.patch_size
    Dm = Dv * v.spatial_merge_size ** 2   # the merger's merged width

    def dense(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = out[i] if len(shape) == 3 else out
            dst.copy_(torch.randn(dst.shape, generator=generator, device=dev,
                                  dtype=torch.float32) * (fan_in ** -0.5))
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    params["vision"] = {
        # Conv3d(3, Dv, kernel=(tps, p, p)) is a linear map of the
        # flattened (c, t, ph, pw) patch vector (the loader reshapes the
        # conv weight so).
        "patch_embed": {"kernel": dense((patch_dim, Dv), patch_dim)},
        "layers": {
            "norm1": {"scale": ones(Lv, Dv), "bias": zeros(Lv, Dv)},
            "qkv": {"kernel": dense((Lv, Dv, 3 * Dv), Dv),
                    "bias": zeros(Lv, 3 * Dv)},
            "proj": {"kernel": dense((Lv, Dv, Dv), Dv),
                     "bias": zeros(Lv, Dv)},
            "norm2": {"scale": ones(Lv, Dv), "bias": zeros(Lv, Dv)},
            "fc1": {"kernel": dense((Lv, Dv, 4 * Dv), Dv),
                    "bias": zeros(Lv, 4 * Dv)},
            "fc2": {"kernel": dense((Lv, 4 * Dv, Dv), 4 * Dv),
                    "bias": zeros(Lv, Dv)},
        },
        # PatchMerger: LayerNorm(Dv), [merge^2 * Dv], a GELU MLP, D_lm.
        "merger": {
            "ln_q": {"scale": ones(Dv), "bias": zeros(Dv)},
            "fc1": {"kernel": dense((Dm, Dm), Dm), "bias": zeros(Dm)},
            "fc2": {"kernel": dense((Dm, cfg.hidden_size), Dm),
                    "bias": zeros(cfg.hidden_size)},
        },
    }
    return params


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _vision_rope(grid: int, hd: int, theta: float,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """2-D rotary angles of a grid x grid patch map: the first hd/4
    frequencies rotate with the patch's row, the next hd/4 with its column
    (HF's VisionRotaryEmbedding: the per-axis tables concatenated, then the
    pair repeated to cover hd). Returns [T, hd] f32 angles."""
    dim = hd // 2
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    pos = torch.arange(grid, dtype=torch.float32, device=device)
    f = pos[:, None] * inv[None, :]                      # [grid, hd/4]
    fh = f[:, None, :].expand(grid, grid, -1)            # rows
    fw = f[None, :, :].expand(grid, grid, -1)            # columns
    emb = torch.cat([fh, fw], dim=-1).reshape(grid * grid, dim)
    return torch.cat([emb, emb], dim=-1)                 # [T, hd]


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _window_index(grid: int, win: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """The window id of each patch for win x win non-overlapping windows
    (Qwen2.5-VL pads; inputs here come at multiples)."""
    assert grid % win == 0, (
        f"window_size={win} must divide the {grid}-patch grid (window "
        "ids would silently collide across windows otherwise)")
    rows = torch.arange(grid, device=device) // win
    cols = torch.arange(grid, device=device) // win
    return (rows[:, None] * (grid // win) + cols[None, :]).reshape(-1)


def encode_images(params: Params, cfg: ModelConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, H, W, 3] -> visual embeddings [N, out_tokens, D_lm] in
    ``cfg.dtype``, on the weights' device.

    The ENCODE stage at Qwen2-VL's layout (``Qwen2VisionTransformer``): the
    Conv3d-equivalent patch embedding (a still image tiled over the
    temporal patch); blocks of LayerNorm, fused-qkv attention with 2-D
    rotary over the (row, col) grid, and a QuickGELU MLP; then the spatial
    PatchMerger down to out_tokens an image. Scores, softmax and the value
    sum are f32; rope rotates q and k in f32. ``window_size`` > 0 masks
    attention to non-overlapping windows except in the blocks listed in
    ``fullatt_block_indexes`` (Qwen2.5-VL). A sharded tree's tower is
    replicated: the first shard's is whole."""
    v = cfg.vision
    vp = replicated_tree(params)["vision"]
    dev = vp["patch_embed"]["kernel"].device
    N = pixels.shape[0]
    p = v.patch_size
    grid = v.image_size // p
    # Patchify to (c, t, ph, pw)-ordered vectors, the Conv3d weight's
    # flattening; a still image repeats over the temporal patch.
    x = pixels.to(dev).reshape(N, grid, p, grid, p, 3)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(N, grid * grid, 3, 1, p, p)
    x = x.expand(N, grid * grid, 3, v.temporal_patch_size, p, p) \
        .reshape(N, grid * grid, -1)
    x = x.to(cfg.dtype) @ vp["patch_embed"]["kernel"]

    lw = vp["layers"]
    n_heads = v.num_heads
    hd = v.hidden_size // n_heads
    rope = _vision_rope(grid, hd, v.rope_theta, dev)      # [T, hd]
    cos = torch.cos(rope)[None, :, None, :]
    sin = torch.sin(rope)[None, :, None, :]

    win_mask = None
    if v.window_size > 0:
        wid = _window_index(grid, v.window_size, dev)
        win_mask = wid[:, None] == wid[None, :]          # [T, T]

    def layer(x, l: int, local: bool):
        def w(name, leaf):
            return lw[name][leaf][l]
        h = _layer_norm(x, w("norm1", "scale"), w("norm1", "bias"))
        qkv = h @ w("qkv", "kernel") + w("qkv", "bias")
        q, k, vv = torch.chunk(qkv, 3, dim=-1)
        q = q.reshape(*q.shape[:-1], n_heads, hd).float()
        k = k.reshape(*k.shape[:-1], n_heads, hd).float()
        vv = vv.reshape(*vv.shape[:-1], n_heads, hd).float()
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        s = torch.einsum("nqhd,nkhd->nhqk", q, k) / (hd ** 0.5)
        if local and win_mask is not None:
            s = torch.where(win_mask[None, None], s, -1e30)
        a = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(s, dim=-1),
                         vv).to(x.dtype)
        a = a.reshape(*a.shape[:-2], v.hidden_size)
        x = x + (a @ w("proj", "kernel") + w("proj", "bias"))
        h2 = _layer_norm(x, w("norm2", "scale"), w("norm2", "bias"))
        m = h2 @ w("fc1", "kernel") + w("fc1", "bias")
        m = m * torch.sigmoid(1.702 * m)                 # QuickGELU
        return x + (m @ w("fc2", "kernel") + w("fc2", "bias"))

    for l in range(v.num_layers):
        x = layer(x, l, local=(v.window_size > 0
                               and l not in v.fullatt_block_indexes))

    # PatchMerger: ln_q per patch, m x m spatial neighbours grouped, a
    # two-layer MLP with the exact (erf) GELU, HF's nn.GELU.
    mg = vp["merger"]
    m_ = v.spatial_merge_size
    x = _layer_norm(x, mg["ln_q"]["scale"], mg["ln_q"]["bias"])
    g2 = grid // m_
    x = x.reshape(N, g2, m_, g2, m_, v.hidden_size)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(N, g2 * g2, -1)
    x = x @ mg["fc1"]["kernel"] + mg["fc1"]["bias"]
    x = F.gelu(x, approximate="none")
    return x @ mg["fc2"]["kernel"] + mg["fc2"]["bias"]


def splice_mm_embeds(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                     mm_embeds: Optional[torch.Tensor],
                     image_token_id: Optional[int] = None) -> torch.Tensor:
    """The token embeddings with the placeholder positions replaced by
    visual embeddings. tokens [B, S]; mm_embeds [B, n_mm, D] (each row's
    visual tokens, taken in order by the row's placeholders)."""
    x = _llama._embed(params, cfg, tokens)
    if mm_embeds is None:
        return x
    if image_token_id is None:
        image_token_id = cfg.image_token_id
    is_img = tokens == image_token_id
    # A row's k-th placeholder takes the row's k-th visual token.
    order = torch.cumsum(is_img.long(), dim=1) - 1
    order = order.clamp(0, mm_embeds.shape[1] - 1)
    gathered = torch.gather(
        mm_embeds.to(cfg.dtype), 1,
        order[..., None].expand(*order.shape, mm_embeds.shape[-1]))
    return torch.where(is_img[..., None], gathered, x)


def mrope_positions(tokens, image_token_id: int) -> tuple[np.ndarray, int]:
    """A prompt's M-RoPE position ids on the host (HF's
    ``Qwen2VLForConditionalGeneration.get_rope_index`` for single-frame
    images).

    A text run advances all three axes (t, h, w) together from the running
    offset. A run of n image placeholders is a (sqrt(n), sqrt(n)) merged
    grid: t stays at the offset, h and w sweep the grid's rows and columns;
    the offset then advances by the grid's side (the largest position plus
    one). Returns (pos [S, 3] int32, delta), delta = next_position -
    len(tokens), the constant the decode step adds to the sequence
    index."""
    toks = np.asarray(tokens)
    S = len(toks)
    pos = np.zeros((S, 3), np.int32)
    st = 0
    i = 0
    is_img = toks == image_token_id
    while i < S:
        j = i
        if is_img[i]:
            while j < S and is_img[j]:
                j += 1
            n = j - i
            g = max(1, int(round(math.sqrt(n))))   # the grid's width
            h = np.arange(n, dtype=np.int32) // g  # row-major sweep, which
            w = np.arange(n, dtype=np.int32) % g   # takes ragged runs too
            pos[i:j, 0] = st
            pos[i:j, 1] = st + h
            pos[i:j, 2] = st + w
            st += int(max(h[-1], w.max())) + 1
        else:
            while j < S and not is_img[j]:
                j += 1
            n = j - i
            pos[i:j, :] = (st + np.arange(n, dtype=np.int32))[:, None]
            st += n
        i = j
    return pos, int(st - S)


def prefill_forward(params: Params, cfg: ModelConfig,
                    tokens: torch.Tensor, positions: torch.Tensor,
                    kv_pages: torch.Tensor, page_table: torch.Tensor,
                    prefix_lens: torch.Tensor, seq_lens: torch.Tensor,
                    mm_embeds: Optional[torch.Tensor] = None,
                    has_prefix: Optional[bool] = None, ring: bool = False,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The text prefill with the visual embeddings spliced in: the llama
    body over the spliced input embeddings. ``positions`` is [B, S, 3]
    (M-RoPE) or [B, S]."""
    if mm_embeds is None:
        return _llama.prefill_forward(params, cfg, tokens, positions,
                                      kv_pages, page_table, prefix_lens,
                                      seq_lens, has_prefix=has_prefix,
                                      ring=ring)
    x = splice_mm_embeds(params, cfg, tokens, mm_embeds)
    return _llama.prefill_from_embeddings(params, cfg, x, positions,
                                          kv_pages, page_table, prefix_lens,
                                          seq_lens, has_prefix=has_prefix,
                                          ring=ring)


register_model_family(ModelFamily(
    name="qwen2_vl",
    init_params=init_params,
    prefill_forward=prefill_forward,
    decode_forward=_llama.decode_forward,
    sharding_rules=QWEN2_VL_RULES,
))
