"""Map a Hugging Face model directory (``config.json``) onto a
``ModelConfig`` and its loader (port of
``xllm_service_tpu/models/hf_config.py``, the llama body's families):

    cfg = model_config_from_hf(model_dir)
    params = load_checkpoint(model_dir, cfg)

``llama``, ``qwen2``, ``gemma2``, ``mixtral``, ``deepseek_v2``/
``deepseek_v3`` and ``qwen2_vl`` map field for field as in the reference;
any other type raises as the reference's does.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Optional, Union

import torch

from .base import ModelConfig, VisionConfig

def _read_config(ckpt_dir: Union[str, Path]) -> dict:
    p = Path(ckpt_dir) / "config.json"
    if not p.exists():
        raise FileNotFoundError(f"no config.json under {ckpt_dir}")
    return json.loads(p.read_text())


def _common(hf: dict) -> dict[str, Any]:
    heads = hf["num_attention_heads"]
    return dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        ffn_size=hf["intermediate_size"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        max_context_len=int(hf.get("max_position_embeddings", 8192)),
    )


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def checkpoint_dtype(ckpt_dir: Union[str, Path]) -> torch.dtype:
    """The dtype a checkpoint directory's config.json publishes
    (``torch_dtype``), bf16 when it names none."""
    name = _read_config(ckpt_dir).get("torch_dtype") or "bfloat16"
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"config.json under {ckpt_dir}: torch_dtype "
                         f"{name!r} is not one of {sorted(_TORCH_DTYPES)}"
                         ) from None


def model_config_from_hf(ckpt_dir: Union[str, Path], *,
                         dtype: Optional[torch.dtype] = None,
                         max_context_len: Optional[int] = None
                         ) -> ModelConfig:
    """A ModelConfig from an HF checkpoint directory's config.json.
    ``dtype`` and ``max_context_len`` override the checkpoint's."""
    hf = _read_config(ckpt_dir)
    mt = hf.get("model_type", "")

    if mt in ("llama", "qwen2"):
        kw = _common(hf)
        kw.update(name="llama" if mt == "llama" else "qwen2",
                  qkv_bias=(mt == "qwen2"))
    elif mt == "gemma2":
        kw = _common(hf)
        kw.update(
            name="gemma", act="gelu", embed_scale=True,
            rms_unit_offset=True, sandwich_norms=True,
            final_logit_softcap=float(
                hf.get("final_logit_softcapping") or 0.0),
            attn_logit_softcap=float(
                hf.get("attn_logit_softcapping") or 0.0),
            sliding_window=int(hf.get("sliding_window") or 0),
            # HF gemma-2 alternates local/global every other layer.
            sliding_window_pattern=2 if hf.get("sliding_window") else 0,
            query_pre_attn_scalar=float(
                hf.get("query_pre_attn_scalar") or 0.0))
    elif mt == "mixtral":
        kw = _common(hf)
        # HF's intermediate_size is the per-expert width; the MoE forward
        # reads moe_ffn_size (first_dense_layers=0: every layer sparse).
        kw.update(name="mixtral",
                  num_experts=hf["num_local_experts"],
                  num_experts_per_token=hf["num_experts_per_tok"],
                  moe_ffn_size=hf["intermediate_size"],
                  num_shared_experts=0, first_dense_layers=0)
    elif mt in ("deepseek_v2", "deepseek_v3"):
        kw = _common(hf)
        # MLA: the pool stores one [kv_lora_rank + rope] latent a token,
        # advertised as a single wide KV head.
        kw.update(
            name="deepseek_moe",
            num_kv_heads=1,
            head_dim=hf["kv_lora_rank"] + hf["qk_rope_head_dim"],
            kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"],
            qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"],
            num_experts=hf.get("n_routed_experts", 0),
            num_experts_per_token=hf.get("num_experts_per_tok", 2),
            num_shared_experts=hf.get("n_shared_experts", 0),
            moe_ffn_size=hf.get("moe_intermediate_size", 0),
            first_dense_layers=hf.get("first_k_dense_replace", 1))
    elif mt == "qwen2_vl":
        kw = _common(hf)
        sec = (hf.get("rope_scaling") or {}).get("mrope_section") or ()
        vc = hf.get("vision_config") or {}
        merge = int(vc.get("spatial_merge_size", 2))
        patch = int(vc.get("patch_size", 14))
        # HF's vision_config has no fixed image size (dynamic resolution);
        # the tower here runs the canonical 224 px grid.
        image = 224
        kw.update(
            name="qwen2_vl", qkv_bias=True, mrope_section=tuple(sec),
            image_token_id=hf.get("image_token_id", 151655),
            vision=VisionConfig(
                image_size=image, patch_size=patch,
                hidden_size=int(vc.get("embed_dim",
                                       vc.get("hidden_size", 1280))),
                num_layers=int(vc.get("depth", vc.get("num_layers", 32))),
                num_heads=int(vc.get("num_heads", 16)),
                out_tokens=(image // patch // merge) ** 2,
                temporal_patch_size=int(vc.get("temporal_patch_size", 2)),
                spatial_merge_size=merge))
    else:
        raise ValueError(
            f"unsupported HF model_type {mt!r} under {ckpt_dir} — "
            f"supported: llama, qwen2, gemma2, mixtral, deepseek_v2/3, "
            f"qwen2_vl")

    if dtype is not None:
        kw["dtype"] = dtype
    cfg = ModelConfig(**kw)
    if max_context_len is not None:
        cfg = dataclasses.replace(
            cfg, max_context_len=min(cfg.max_context_len, max_context_len))
    return cfg


def loader_for(cfg: ModelConfig) -> Callable:
    """The safetensors loader matching a config built above."""
    from . import loader as L

    if cfg.name in ("llama", "qwen2", "gemma"):
        return L.load_hf_llama_safetensors
    if cfg.name == "mixtral":
        return L.load_hf_mixtral_safetensors
    if cfg.name == "deepseek_moe":
        return L.load_hf_deepseek_safetensors
    if cfg.name == "qwen2_vl":
        return L.load_hf_qwen2_vl_safetensors
    raise ValueError(f"no checkpoint loader for family {cfg.name!r}")


def load_checkpoint(ckpt_dir: Union[str, Path], cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> dict:
    """One-call load: the family's loader onto ``device`` (``cuda`` unless
    named). With ``cfg.quant`` set the tree comes back in its int8 form
    (``models/quant.py::quantize_tree``, as the engine would make it; the
    loaders quantize the stacked projections as they assemble them)."""
    params = loader_for(cfg)(ckpt_dir, cfg, device=device)
    if cfg.quant:
        from .quant import quantize_tree

        if cfg.quant != "int8":
            raise ValueError(f"unknown quant mode {cfg.quant!r}")
        params = quantize_tree(params)
    return params
