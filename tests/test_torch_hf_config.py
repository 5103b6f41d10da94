"""The port's ``models/hf_config.py`` against the reference's, on the CPU,
on the model directories that ``test_hf_parity.make_model_dir`` writes:
``model_config_from_hf`` field by field for llama, qwen2, gemma2, mixtral
and deepseek_v2/v3 (the checkpoint's dtype, an override, a bounded
context), qwen2_vl with its vision tower, the refusal of an unknown
``model_type``, and ``load_checkpoint`` through ``loader_for``."""

import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.models import hf_config as ref_hf
from xllm_service_tpu_torch.models import hf_config, loader
from xllm_service_tpu_torch.models.base import ModelConfig

from test_hf_parity import make_model_dir
from test_torch_loader import assert_trees_equal


def _fields_equal(port: ModelConfig, ref) -> None:
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if f.name == "dtype":
            assert str(got).rsplit(".", 1)[-1] == jnp.dtype(want).name
        else:
            assert got == want, (f.name, got, want)


def _model_dir(tmp_path, model_type):
    """``make_model_dir``'s directory; deepseek_v3 is deepseek_v2's with
    its model_type renamed (both map alike in the reference)."""
    if model_type != "deepseek_v3":
        return make_model_dir(tmp_path, model_type)
    d = make_model_dir(tmp_path, "deepseek_v2")
    conf = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps(
        {**conf, "model_type": "deepseek_v3"}))
    return d


@pytest.mark.parametrize("model_type", ["llama", "qwen2", "gemma2",
                                        "mixtral", "deepseek_v2",
                                        "deepseek_v3"])
def test_model_config_from_hf_matches_the_reference(tmp_path, model_type):
    d = _model_dir(tmp_path, model_type)
    _fields_equal(hf_config.model_config_from_hf(d),
                  ref_hf.model_config_from_hf(d))
    _fields_equal(hf_config.model_config_from_hf(
        d, dtype=torch.float32, max_context_len=128),
        ref_hf.model_config_from_hf(d, dtype=jnp.float32,
                                    max_context_len=128))
    cfg = hf_config.model_config_from_hf(d)
    assert cfg.name == {"gemma2": "gemma", "deepseek_v2": "deepseek_moe",
                        "deepseek_v3": "deepseek_moe"}.get(model_type,
                                                           model_type)
    assert cfg.qkv_bias == (model_type == "qwen2")
    if model_type == "mixtral":
        assert cfg.num_experts == 4 and cfg.moe_ffn_size == cfg.ffn_size
    if model_type.startswith("deepseek"):
        assert cfg.num_kv_heads == 1 and cfg.first_dense_layers == 1 and \
            cfg.head_dim == cfg.kv_lora_rank + cfg.qk_rope_head_dim
    if model_type == "gemma2":
        assert cfg.tie_embeddings and cfg.sandwich_norms and \
            cfg.sliding_window_pattern == 2 and cfg.layer_is_local(0)


@pytest.mark.parametrize("model_type", ["qwen2_vl"])
def test_vision_family_maps_as_the_reference(tmp_path, model_type):
    """A qwen2_vl config.json (vision_config, mrope_section, the image
    token) maps field for field as the reference's, its vision tower
    included, and loader_for names the vision loader."""
    from test_torch_vl_loader import HF_CONFIG

    (tmp_path / "config.json").write_text(json.dumps(
        {**HF_CONFIG, "model_type": model_type}))
    cfg = hf_config.model_config_from_hf(tmp_path)
    ref = ref_hf.model_config_from_hf(tmp_path)
    _fields_equal(dataclasses.replace(cfg, vision=None),
                  dataclasses.replace(ref, vision=None))
    assert dataclasses.asdict(cfg.vision) == dataclasses.asdict(ref.vision)
    assert hf_config.loader_for(cfg) is loader.load_hf_qwen2_vl_safetensors
    with pytest.raises(ValueError, match="no checkpoint loader"):
        hf_config.loader_for(dataclasses.replace(ModelConfig(),
                                                 name="mamba"))


def test_unknown_model_type_raises_as_the_reference(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "mamba"}))
    with pytest.raises(ValueError, match="model_type 'mamba'"):
        ref_hf.model_config_from_hf(tmp_path)
    with pytest.raises(ValueError, match="model_type 'mamba'"):
        hf_config.model_config_from_hf(tmp_path)
    with pytest.raises(FileNotFoundError, match="config.json"):
        hf_config.model_config_from_hf(tmp_path / "none")


@pytest.mark.parametrize("model_type,load", [
    ("llama", loader.load_hf_llama_safetensors),
    ("gemma2", loader.load_hf_llama_safetensors),
    ("mixtral", loader.load_hf_mixtral_safetensors),
    ("deepseek_v2", loader.load_hf_deepseek_safetensors)])
def test_load_checkpoint_picks_the_family_loader(tmp_path, model_type,
                                                 load):
    d = make_model_dir(tmp_path, model_type)
    rcfg = ref_hf.model_config_from_hf(d, dtype=jnp.float32)
    cfg = hf_config.model_config_from_hf(d, dtype=torch.float32)
    assert hf_config.loader_for(cfg) is load
    assert_trees_equal(hf_config.load_checkpoint(d, cfg, device="cpu"),
                       ref_hf.load_checkpoint(d, rcfg))
