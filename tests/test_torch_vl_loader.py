"""The port's qwen2_vl checkpoint path against the reference's, on the
CPU: a Qwen2-VL HF directory written here (``config.json`` with its
``vision_config`` and ``rope_scaling.mrope_section``, and
tests/test_loader.py's ``visual.*`` and ``model.*`` tensors). ``hf_config``
gives the reference's configuration field for field, ``loader_for`` maps
the family to ``load_hf_qwen2_vl_safetensors``, and the loaded tree equals
the reference loader's leaf for leaf (f32, bit for bit: a transpose and a
reshape); a missing vision block raises the reference's error; the loaded
tree encodes as the reference's (1e-5 of the largest magnitude)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import hf_config as ref_hf
from xllm_service_tpu.models import loader as ref_loader
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu_torch.models import hf_config, loader, qwen2_vl

from test_loader import make_hf_qwen2_vl_checkpoint
from test_torch_loader import assert_trees_equal
from test_torch_qwen2_vl import assert_configs_equal

HF_CONFIG = {
    "model_type": "qwen2_vl", "architectures":
        ["Qwen2VLForConditionalGeneration"],
    "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 256, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "max_position_embeddings": 512, "torch_dtype": "float32",
    "image_token_id": 500,
    "rope_scaling": {"type": "mrope", "mrope_section": [4, 6, 6]},
    "vision_config": {"depth": 2, "embed_dim": 64, "num_heads": 4,
                      "patch_size": 14, "spatial_merge_size": 2,
                      "temporal_patch_size": 2, "hidden_size": 128},
}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen2_vl")
    (d / "config.json").write_text(json.dumps(HF_CONFIG))
    rcfg = ref_hf.model_config_from_hf(d, dtype=jnp.float32)
    hf = make_hf_qwen2_vl_checkpoint(d, rcfg)
    return d, rcfg, hf


def test_config_is_the_references(model_dir):
    d, rcfg, _ = model_dir
    cfg = hf_config.model_config_from_hf(d)
    assert_configs_equal(cfg, ref_hf.model_config_from_hf(d))
    assert hf_config.checkpoint_dtype(d) == torch.float32
    small = hf_config.model_config_from_hf(d, dtype=torch.bfloat16,
                                           max_context_len=128)
    assert_configs_equal(small, ref_hf.model_config_from_hf(
        d, dtype=jnp.bfloat16, max_context_len=128))
    assert (cfg.name, cfg.mrope_section, cfg.image_token_id,
            cfg.vision.out_tokens) == ("qwen2_vl", (4, 6, 6), 500, 64)
    assert hf_config.loader_for(cfg) is loader.load_hf_qwen2_vl_safetensors


def test_loaded_tree_is_the_references(model_dir):
    d, rcfg, hf = model_dir
    cfg = hf_config.model_config_from_hf(d, dtype=torch.float32)
    want = ref_loader.load_hf_qwen2_vl_safetensors(d, rcfg)
    got = hf_config.load_checkpoint(d, cfg, device="cpu")
    assert_trees_equal(got, want)
    conv = hf["visual.patch_embed.proj.weight"]
    np.testing.assert_array_equal(
        got["vision"]["patch_embed"]["kernel"].numpy(),
        conv.reshape(conv.shape[0], -1).T)
    # The loaded tree encodes as the reference's (its 224 px grid).
    pixels = np.random.default_rng(0).uniform(
        size=(1, 224, 224, 3)).astype(np.float32)
    enc = qwen2_vl.encode_images(got, cfg, torch.from_numpy(pixels))
    ref = jax.jit(ref_vl.encode_images, static_argnums=1)(
        want, rcfg, jnp.asarray(pixels))
    # The checkpoint's unit-variance weights make embeddings of ~1e3: the
    # tolerance is 1e-5 of their largest magnitude.
    ref = np.asarray(ref)
    np.testing.assert_allclose(enc.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_a_missing_vision_block_raises_as_the_reference(tmp_path,
                                                       model_dir):
    from xllm_service_tpu_torch.models.safetensors_io import save_file

    d, rcfg, hf = model_dir
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIG))
    kept = {k: torch.from_numpy(v) for k, v in hf.items()
            if not k.startswith("visual.blocks.1.")}
    save_file(kept, tmp_path / "model.safetensors")
    cfg = hf_config.model_config_from_hf(tmp_path, dtype=torch.float32)
    with pytest.raises(ValueError) as ref_err:
        ref_loader.load_hf_qwen2_vl_safetensors(tmp_path, rcfg)
    with pytest.raises(ValueError) as err:
        loader.load_hf_qwen2_vl_safetensors(tmp_path, cfg, device="cpu")
    assert "[1]" in str(err.value)
    assert str(err.value).split(" for ")[0] == \
        str(ref_err.value).split(" for ")[0]
