"""Model contract shared by all families (port of
``xllm_service_tpu/models/base.py``: the dense llama, qwen2 and gemma
configurations, the MLA and MoE fields of the deepseek_moe and mixtral
families, the vision tower and M-RoPE of the qwen2_vl family, weight-only
int8).

Engine-facing surface per family:
- ``init_params(cfg, generator, device) -> params``: random init from an
  explicit ``torch.Generator``; weights are stored ``[in, out]`` with a
  leading layer dim, the reference's layout.
- ``prefill_forward(params, cfg, tokens, positions, kv_pages, page_table,
  prefix_lens, seq_lens) -> (logits_last, kv_pages)``.
- ``decode_forward(params, cfg, tokens, positions, kv_pages, page_table,
  context_lens) -> (logits, kv_pages)``.
- ``embed_forward(params, cfg, tokens, seq_lens) -> [B, D] f32`` (None for
  a family without one).

Both forwards update the paged pool ``kv_pages`` in place and return it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    ffn_size: int = 5632
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    qkv_bias: bool = False          # Qwen2 family
    dtype: torch.dtype = torch.bfloat16
    max_context_len: int = 8192
    # MLA, multi-head latent attention (deepseek family): kv_lora_rank > 0
    # turns it on. The paged pool then stores one [kv_lora_rank +
    # qk_rope_head_dim] latent a token, so the config sets num_kv_heads=1
    # and head_dim=kv_lora_rank + qk_rope_head_dim for the pool's layout.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE (deepseek_moe and mixtral families).
    num_experts: int = 0
    num_experts_per_token: int = 2
    num_shared_experts: int = 0
    moe_ffn_size: int = 0           # per-expert ffn width
    first_dense_layers: int = 1     # leading dense layers before MoE blocks
    # Multimodal (qwen2_vl family).
    vision: Optional["VisionConfig"] = None
    image_token_id: int = 151655    # <|image_pad|> placeholder id
    # M-RoPE (the Qwen2-VL LM stack): per-axis (temporal, h, w) half-dim
    # rope sections summing to head_dim // 2. Empty = 1-D rope.
    mrope_section: tuple = ()
    # Weight-only quantization ("" = off, "int8" = per-output-channel int8
    # projections, models/quant.py).
    quant: str = ""
    # Gemma switches, honored by the shared body of models/llama.py: GeGLU,
    # embeddings scaled by sqrt(hidden), RMSNorm computing (1 + w), a tanh
    # cap on the final logits (0 = off).
    act: str = "silu"
    embed_scale: bool = False
    rms_unit_offset: bool = False
    final_logit_softcap: float = 0.0
    # Gemma-2 attention extras: a tanh cap on the attention scores; layer l
    # attends to the trailing ``sliding_window`` positions unless
    # l % sliding_window_pattern == pattern - 1 (a global layer); the query
    # scale query_pre_attn_scalar ** -0.5 in place of head_dim ** -0.5; and
    # norms on the attention and MLP outputs (sandwich_norms).
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0
    sliding_window_pattern: int = 0
    query_pre_attn_scalar: float = 0.0
    sandwich_norms: bool = False

    def layer_is_local(self, layer: int) -> bool:
        """True if ``layer`` uses sliding-window (local) attention."""
        n = self.sliding_window_pattern
        return (self.sliding_window > 0 and n > 0
                and (layer % n) != n - 1)

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    # ---- roofline accounting (bench.py twin: pct_roofline) ----------------
    @property
    def dtype_bytes(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def decode_weight_stream_bytes(self) -> int:
        """Bytes of weights streamed from device memory per decode
        token-step: every layer projection and the lm_head once (the
        embedding is a gather of B rows and is left out; a tied head
        streams the table all the same), plus the RMSNorm scales. The
        reference's accounting, with the width of the port's weight dtype
        (bf16: 2 bytes, as the reference's); under int8 a projection
        weight is 1 byte, while the norms and a tied head (the embedding
        table) keep the model dtype. MLA streams its latent projections in
        place of the GQA ones; an MoE layer streams the routed experts'
        and the shared experts' FFNs only (``num_experts_per_token +
        num_shared_experts`` of them), what a sparse dispatch reads."""
        h, L, db = self.hidden_size, self.num_layers, self.dtype_bytes
        wb = 1 if self.quant == "int8" else db
        if self.kv_lora_rank > 0:
            dn, dr = self.qk_nope_head_dim, self.qk_rope_head_dim
            dc, dv = self.kv_lora_rank, self.v_head_dim
            attn = (h * self.num_heads * (dn + dr)      # q_proj
                    + h * dc + h * dr                   # kv_down, k_rope
                    + self.num_heads * dn * dc          # k_up
                    + self.num_heads * dc * dv          # v_up
                    + self.num_heads * dv * h)          # o_proj
        else:
            attn = h * self.q_size + 2 * h * self.kv_size + self.q_size * h
        if self.num_experts:
            n_moe = max(0, L - self.first_dense_layers)
            n_dense = L - n_moe
            active = self.num_experts_per_token + self.num_shared_experts
            moe_mlp = 3 * h * (self.moe_ffn_size or self.ffn_size) * active
            mlp_total = n_dense * 3 * h * self.ffn_size + n_moe * moe_mlp
        else:
            mlp_total = L * 3 * h * self.ffn_size
        n_norms = 4 if self.sandwich_norms else 2
        norms = (L * n_norms * h + h) * db
        head = self.vocab_size * h * (db if self.tie_embeddings else wb)
        return (L * attn + mlp_total) * wb + norms + head

    def kv_bytes_per_token(self, context_len: int) -> int:
        """Bytes of KV cache read per sequence per decode token-step: K and
        V over the live context, every layer, in the pool's dtype."""
        return self.num_layers * 2 * context_len * self.kv_size * \
            self.dtype_bytes


@dataclass(frozen=True)
class VisionConfig:
    """The Qwen2-VL vision tower (``models/qwen2_vl.py``; checkpoint
    layout ``visual.*``, HF's Qwen2VisionTransformer): a Conv3d-equivalent
    patch embedding with a temporal patch, 2-D rotary positions over the
    (row, col) patch grid, LayerNorm blocks with a fused qkv, a QuickGELU
    MLP, and the spatial-merge PatchMerger to the LM width.
    ``window_size``/``fullatt_block_indexes`` add Qwen2.5-VL's windowed
    attention (non-overlapping local windows except the listed global
    blocks); 0 keeps every block global (Qwen2-VL). The vision tower is
    not in ``decode_weight_stream_bytes``: a decode step never reads it,
    and the reference does not count it."""

    # Consistent with qwen2_vl.init_params' invariant:
    # out_tokens == (image_size / patch_size / spatial_merge_size) ** 2.
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 4
    num_heads: int = 16
    out_tokens: int = 64            # visual tokens emitted per image
    temporal_patch_size: int = 2    # Qwen2-VL: 2 (an image tiled over t)
    spatial_merge_size: int = 2     # Qwen2-VL: 2 (2x2 patch merge)
    rope_theta: float = 10000.0
    window_size: int = 0            # patches per window side (2.5-VL: 8)
    fullatt_block_indexes: tuple = ()


@dataclass
class ModelFamily:
    name: str
    init_params: Callable[..., Any]
    prefill_forward: Callable[..., Any]
    decode_forward: Callable[..., Any]
    embed_forward: Optional[Callable[..., Any]] = None
    # The Sarathi mixed step (decode rows and one prefill chunk in one
    # forward); a family without it never rides.
    mixed_decode_chunk_forward: Optional[Callable[..., Any]] = None
    # Speculative verify (logits at every position of a short block per
    # sequence); a family without it never speculates.
    verify_forward: Optional[Callable[..., Any]] = None
    # Whether every projection of the family's forwards goes through
    # models/quant.py (quantized_matmul, quantized_einsum: weight-only
    # int8).
    supports_int8: bool = False


_REGISTRY: dict[str, ModelFamily] = {}


def register_model_family(family: ModelFamily) -> None:
    _REGISTRY[family.name] = family


def get_model_family(name: str) -> ModelFamily:
    # Lazy imports so importing the registry doesn't pull in every family.
    if name not in _REGISTRY:
        if name in ("llama", "llama3"):
            from . import llama  # noqa: F401
        elif name in ("qwen2", "qwen2.5", "qwen"):
            from . import qwen2  # noqa: F401
        elif name in ("deepseek_moe", "deepseek"):
            from . import deepseek_moe  # noqa: F401
        elif name == "gemma":
            from . import gemma  # noqa: F401
        elif name == "mixtral":
            from . import mixtral  # noqa: F401
        elif name == "qwen2_vl":
            from . import qwen2_vl  # noqa: F401
    fam = _REGISTRY.get(name)
    if fam is None:
        raise ValueError(f"unknown model family: {name}")
    return fam


# ---- tiny/test/bench configs ------------------------------------------------
def tiny_config(**kw) -> ModelConfig:
    """CPU-test scale."""
    defaults = dict(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=32, ffn_size=256,
                    max_context_len=512)
    defaults.update(kw)
    return ModelConfig(**defaults)


def llama3_8b_config() -> ModelConfig:
    return ModelConfig(name="llama", vocab_size=128256, hidden_size=4096,
                       num_layers=32, num_heads=32, num_kv_heads=8,
                       head_dim=128, ffn_size=14336, rope_theta=500000.0,
                       max_context_len=8192)


def bench_1b_config() -> ModelConfig:
    """~1.2B params: the reference's single-chip bench model."""
    return ModelConfig(name="llama", vocab_size=32768, hidden_size=2048,
                       num_layers=16, num_heads=16, num_kv_heads=8,
                       head_dim=128, ffn_size=8192, max_context_len=4096)
