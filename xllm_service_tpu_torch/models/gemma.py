"""Gemma family, Gemma-1 and Gemma-2 (port of
``xllm_service_tpu/models/gemma.py``).

The llama family's paged-KV body with config switches that
``models/llama.py`` honors: GeGLU (``act="gelu"``), embeddings scaled by
sqrt(hidden) (``embed_scale``), RMSNorm computing ``(1 + w)``
(``rms_unit_offset``), tied embeddings, rope theta 10000, head dim 256 and
a final-logit tanh softcap (``final_logit_softcap``).

Gemma-2 adds alternating sliding-window and global layers
(``sliding_window`` with ``sliding_window_pattern=2``: even layers local),
an attention-score softcap (``attn_logit_softcap=50``), an explicit query
scale (``query_pre_attn_scalar``) and sandwich norms. On the card its
decode runs kernel 1 with the scale, the softcap and, on local layers, the
window; its prefills take the dense route (``ops/attention.py``), as the
reference's take XLA; the engine refuses a seq mesh for it (the ring and
kernel 6 take neither option).
"""

from __future__ import annotations

from .base import ModelConfig, ModelFamily, register_model_family
from .llama import (
    decode_forward,
    embed_forward,
    init_params,
    mixed_decode_chunk_forward,
    prefill_forward,
    verify_forward,
)


def gemma_tiny_config(**kw) -> ModelConfig:
    """CPU-test scale with every gemma switch on."""
    defaults = dict(name="gemma", vocab_size=512, hidden_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                    ffn_size=256, rope_theta=10000.0, tie_embeddings=True,
                    act="gelu", embed_scale=True, rms_unit_offset=True,
                    final_logit_softcap=30.0, max_context_len=512)
    defaults.update(kw)
    return ModelConfig(**defaults)


def gemma2_tiny_config(**kw) -> ModelConfig:
    """CPU-test scale with every gemma-2 switch on (a window small enough
    that tests see both the inside- and the outside-window regimes)."""
    defaults = dict(name="gemma", vocab_size=512, hidden_size=128,
                    num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
                    ffn_size=256, rope_theta=10000.0, tie_embeddings=True,
                    act="gelu", embed_scale=True, rms_unit_offset=True,
                    final_logit_softcap=30.0, attn_logit_softcap=50.0,
                    sliding_window=8, sliding_window_pattern=2,
                    query_pre_attn_scalar=24.0, sandwich_norms=True,
                    max_context_len=512)
    defaults.update(kw)
    return ModelConfig(**defaults)


def gemma2_9b_config() -> ModelConfig:
    return ModelConfig(name="gemma", vocab_size=256000, hidden_size=3584,
                       num_layers=42, num_heads=16, num_kv_heads=8,
                       head_dim=256, ffn_size=14336, rope_theta=10000.0,
                       tie_embeddings=True, act="gelu", embed_scale=True,
                       rms_unit_offset=True, final_logit_softcap=30.0,
                       attn_logit_softcap=50.0, sliding_window=4096,
                       sliding_window_pattern=2,
                       query_pre_attn_scalar=256.0, sandwich_norms=True,
                       max_context_len=8192)


def gemma_2b_config() -> ModelConfig:
    return ModelConfig(name="gemma", vocab_size=256000, hidden_size=2048,
                       num_layers=18, num_heads=8, num_kv_heads=1,
                       head_dim=256, ffn_size=16384, rope_theta=10000.0,
                       tie_embeddings=True, act="gelu", embed_scale=True,
                       rms_unit_offset=True, max_context_len=8192)


register_model_family(ModelFamily(
    name="gemma",
    init_params=init_params,
    prefill_forward=prefill_forward,
    decode_forward=decode_forward,
    embed_forward=embed_forward,
    mixed_decode_chunk_forward=mixed_decode_chunk_forward,
    verify_forward=verify_forward,
    supports_int8=True,
))
