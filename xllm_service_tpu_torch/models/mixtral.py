"""Mixtral family (port of ``xllm_service_tpu/models/mixtral.py``).

The deepseek_moe machinery with its switches set to the Mixtral shape:
GQA attention (``kv_lora_rank=0``), every layer MoE
(``first_dense_layers=0``), no shared expert (``num_shared_experts=0``),
top-2 routing with a softmax over the selected experts' logits. Its
attention runs the port's kernels: kernel 1 a layer per decode step,
kernel 2 behind a cached prefix and in the verify, kernel 3 under
``XLLM_KV_WRITEBACK=fused``.
"""

from __future__ import annotations

from .base import ModelConfig, ModelFamily, register_model_family
from .deepseek_moe import (
    decode_forward,
    embed_forward,
    init_params,
    prefill_forward,
    verify_forward,
)


def mixtral_8x7b_config() -> ModelConfig:
    return ModelConfig(name="mixtral", vocab_size=32000, hidden_size=4096,
                       num_layers=32, num_heads=32, num_kv_heads=8,
                       head_dim=128, ffn_size=14336, rope_theta=1e6,
                       num_experts=8, num_experts_per_token=2,
                       num_shared_experts=0, moe_ffn_size=14336,
                       first_dense_layers=0, max_context_len=32768)


def mixtral_tiny_config(**kw) -> ModelConfig:
    defaults = dict(name="mixtral", vocab_size=512, hidden_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                    ffn_size=256, num_experts=4, num_experts_per_token=2,
                    num_shared_experts=0, moe_ffn_size=64,
                    first_dense_layers=0, max_context_len=512)
    defaults.update(kw)
    return ModelConfig(**defaults)


register_model_family(ModelFamily(
    name="mixtral",
    init_params=init_params,
    prefill_forward=prefill_forward,
    decode_forward=decode_forward,
    verify_forward=verify_forward,
    embed_forward=embed_forward,
    supports_int8=True,
))
