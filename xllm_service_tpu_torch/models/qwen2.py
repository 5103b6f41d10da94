"""Qwen2/2.5 family (port of ``xllm_service_tpu/models/qwen2.py``).

The llama family with per-projection qkv biases (``qkv_bias=True``) and its
own dimensions; every forward is the shared body of ``models/llama.py``,
which adds the bias inside ``_project_qkv`` when the tree has one.
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


def qwen2_7b_config() -> ModelConfig:
    return ModelConfig(name="qwen2", vocab_size=152064, hidden_size=3584,
                       num_layers=28, num_heads=28, num_kv_heads=4,
                       head_dim=128, ffn_size=18944, rope_theta=1000000.0,
                       qkv_bias=True, max_context_len=32768)


def qwen2_72b_config() -> ModelConfig:
    return ModelConfig(name="qwen2", vocab_size=152064, hidden_size=8192,
                       num_layers=80, num_heads=64, num_kv_heads=8,
                       head_dim=128, ffn_size=29568, rope_theta=1000000.0,
                       qkv_bias=True, max_context_len=32768)


register_model_family(ModelFamily(
    name="qwen2",
    init_params=init_params,
    prefill_forward=prefill_forward,
    decode_forward=decode_forward,
    embed_forward=embed_forward,
    mixed_decode_chunk_forward=mixed_decode_chunk_forward,
    verify_forward=verify_forward,
    supports_int8=True,
))
