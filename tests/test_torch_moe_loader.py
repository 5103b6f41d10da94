"""The port's MoE checkpoint loaders and serving from their directories, on
the CPU, against the reference's (tests/test_loader.py's DeepSeek and
Mixtral cases, tests/test_hf_parity.py's full-stack parity for mixtral
and deepseek_v2).

- ``load_hf_mixtral_safetensors`` / ``load_hf_deepseek_safetensors`` on
  the directories the reference tests' writers make
  (``test_loader.make_hf_mixtral_checkpoint``, one shard;
  ``make_hf_deepseek_checkpoint``, two, MLA with a leading dense layer):
  every leaf equals the JAX loader's exactly, in f32 and cast to bf16.
- Under int8 every stacked projection is quantized as it is assembled:
  the leaves equal ``quantize_tree`` of the plain load and the
  reference's ``quantize_tree`` of its load (q8 bit for bit, scales to
  one f32 ulp, as tests/test_torch_loader.py).
- The missing-expert and missing-layer errors, and the warnings.
- The native checkpoint round trip of MoE trees, int8 included.
- Served from the directory by the port's agent through the unchanged
  reference ``Master``: the greedy tokens equal the JAX agent's on the
  same directory, and ``transformers``' as far as the reference's drill
  holds them (Mixtral's ids; DeepSeek-V2's served text).
- ``--model-config mixtral_tiny --quant int8`` behind the reference
  ``Master`` gives the JAX agent's tokens on the same weights.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from xllm_service_tpu.coordination.memory import InMemoryCoordination
from xllm_service_tpu.engine.agent import AgentConfig as RefAgentConfig
from xllm_service_tpu.engine.agent import EngineAgent as RefAgent
from xllm_service_tpu.engine.config import EngineConfig as RefEngineConfig
from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu.models import hf_config as ref_hf
from xllm_service_tpu.models import loader as ref_loader
from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu.models import quant as ref_quant
from xllm_service_tpu.tokenizer import TokenizerFactory as RefFactory
from xllm_service_tpu_torch.engine.agent import (
    AgentConfig,
    EngineAgent,
    _parser,
    build_agent,
    engine_config,
)
from xllm_service_tpu_torch.models import hf_config, loader, quant
from xllm_service_tpu_torch.models.weights import params_from_jax

from test_hf_parity import drill, make_model_dir
from test_loader import (
    make_hf_deepseek_checkpoint,
    make_hf_mixtral_checkpoint,
)
from test_torch_agent_e2e import _Cluster
from test_torch_checkpoint_serving import (
    MAX_NEW,
    PROMPT,
    _port_args,
    _ref_agent,
    _serve,
)
from test_torch_gemma import port_config
from test_torch_loader import _as_np, _leaves, assert_trees_equal

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

# family -> (reference config factory, directory writer, JAX loader,
#            port loader)
CASES = {
    "mixtral": (lambda: ref_mixtral.mixtral_tiny_config(dtype=jnp.float32),
                make_hf_mixtral_checkpoint,
                ref_loader.load_hf_mixtral_safetensors,
                loader.load_hf_mixtral_safetensors),
    "deepseek": (lambda: ref_ds.tiny_mla_config(dtype=jnp.float32,
                                                first_dense_layers=1),
                 make_hf_deepseek_checkpoint,
                 ref_loader.load_hf_deepseek_safetensors,
                 loader.load_hf_deepseek_safetensors),
}


def _write(tmp_path, case):
    make, build, ref_load, port_load = CASES[case]
    rcfg = make()
    hf = build(tmp_path, rcfg)
    return rcfg, port_config(rcfg), hf, ref_load, port_load


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_leaves_equal_the_jax_loader(tmp_path, case, dtype):
    rcfg, cfg, hf, ref_load, port_load = _write(tmp_path, case)
    if dtype == "bf16":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    want = ref_load(tmp_path, rcfg)
    got = port_load(tmp_path, cfg, device="cpu")
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    # Every leaf in the model dtype, the router included (the
    # reference's cast).
    assert all(t.dtype == cfg.dtype for t in _leaves(got).values())
    # Experts stack [L(m), E, in, out] from HF's [out, in].
    ex = got["moe"]["experts"]["down_proj"]["kernel"]
    li = rcfg.first_dense_layers
    name = ("model.layers.{}.block_sparse_moe.experts.2.w2.weight"
            if case == "mixtral" else
            "model.layers.{}.mlp.experts.2.down_proj.weight").format(li)
    assert torch.equal(ex[0, 2], torch.from_numpy(hf[name].T.copy())
                       .to(cfg.dtype))


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_quantizes_as_assembled(tmp_path, case):
    rcfg, cfg, _, ref_load, port_load = _write(tmp_path, case)
    cfg8 = dataclasses.replace(cfg, quant="int8")
    streamed = port_load(tmp_path, cfg8, device="cpu")
    assert quant.is_quantized(
        streamed["moe"]["experts"]["gate_proj"]["kernel"])
    assert not quant.is_quantized(streamed["moe"]["router"]["kernel"])
    # The loader leaves the unstacked lm_head to quantize_tree.
    assert not quant.is_quantized(streamed["lm_head"]["kernel"])
    plain = quant.quantize_tree(port_load(tmp_path, cfg, device="cpu"))
    got = hf_config.load_checkpoint(tmp_path, cfg8, device="cpu")
    g, p = _leaves(got), _leaves(plain)
    assert sorted(g) == sorted(p)
    for path in p:
        assert torch.equal(g[path], p[path]), path
    want = _leaves(jax.tree.map(np.asarray, ref_quant.quantize_tree(
        ref_load(tmp_path, rcfg))))
    assert sorted(g) == sorted(want)
    for path in want:
        if path.endswith("/q8"):
            np.testing.assert_array_equal(g[path].numpy(), want[path], path)
        else:
            np.testing.assert_allclose(_as_np(g[path]), want[path],
                                       rtol=2e-7, err_msg=path)


def test_missing_expert_and_layer_raise(tmp_path):
    rcfg, cfg, hf, _, port_load = _write(tmp_path, "mixtral")
    from safetensors.numpy import save_file

    for f in tmp_path.glob("*.safetensors"):
        f.unlink()
    gone = {k: v for k, v in hf.items()
            if k != "model.layers.1.block_sparse_moe.experts.3.w1.weight"}
    save_file(gone, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match=r"moe layer 1 missing experts \[3\]"):
        port_load(tmp_path, cfg, device="cpu")
    gone = {k: v for k, v in hf.items()
            if k != "model.layers.0.input_layernorm.weight"}
    save_file(gone, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match=r"missing entries \[0\]"):
        port_load(tmp_path, cfg, device="cpu")
    save_file({**hf, "model.layers.5.input_layernorm.weight":
               hf["model.norm.weight"]}, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="past the config's 2 layers"):
        port_load(tmp_path, cfg, device="cpu")


def test_unmapped_tensors_warn_and_are_skipped(tmp_path, caplog):
    rcfg, cfg, hf, ref_load, port_load = _write(tmp_path, "mixtral")
    from safetensors.numpy import save_file

    extra = {"vision.proj": hf["model.norm.weight"],
             "model.layers.0.block_sparse_moe.experts.0.w9.weight":
                 hf["model.norm.weight"],
             "model.layers.0.odd.weight": hf["model.norm.weight"]}
    save_file(extra, str(tmp_path / "zz-extra.safetensors"))
    with caplog.at_level(logging.WARNING):
        got = port_load(tmp_path, cfg, device="cpu")
    text = caplog.text
    assert "unmapped checkpoint tensor: vision.proj" in text
    assert "unmapped expert tensor" in text and "unmapped layer tensor" in text
    assert_trees_equal(got, jax.tree.map(np.asarray,
                                         ref_load(tmp_path, rcfg)))


def test_lm_head_defaults_to_the_embedding(tmp_path):
    rcfg, cfg, hf, ref_load, port_load = _write(tmp_path, "deepseek")
    from safetensors.numpy import save_file

    for f in tmp_path.glob("*.safetensors"):
        f.unlink()
    save_file({k: v for k, v in hf.items() if k != "lm_head.weight"},
              str(tmp_path / "model.safetensors"))
    got = port_load(tmp_path, cfg, device="cpu")
    np.testing.assert_array_equal(got["lm_head"]["kernel"].numpy(),
                                  hf["model.embed_tokens.weight"].T)
    assert_trees_equal(got, jax.tree.map(np.asarray,
                                         ref_load(tmp_path, rcfg)))


@pytest.mark.parametrize("case,quant_mode", [("mixtral", "int8"),
                                             ("deepseek", "")])
def test_native_checkpoint_round_trip(tmp_path, case, quant_mode):
    """MoE trees through save_params / load_params: int8 leaves and the
    f32 router of a random init kept as written."""
    from xllm_service_tpu_torch.models.base import get_model_family

    _, cfg, _, _, _ = _write(tmp_path, case)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, quant=quant_mode)
    params = get_model_family(cfg.name).init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["moe"]["router"]["kernel"].dtype == torch.float32
    loader.save_params(params, tmp_path / "native")
    back = loader.load_params(tmp_path / "native", cfg, device="cpu")
    g, w = _leaves(back), _leaves(params)
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].dtype == w[path].dtype and torch.equal(
            g[path], w[path]), path


@pytest.mark.parametrize("model_type", ["mixtral", "deepseek_v2"])
def test_greedy_tokens_match_transformers_and_the_jax_agent(tmp_path,
                                                            model_type):
    """tests/test_hf_parity.py's drill for the MoE families, through the
    port's agent started from its command line (``--model-config hf``):
    the port's ids equal the JAX agent's, and the served text equals the
    text of ``transformers``' ids, the drill's comparison. For Mixtral the
    ids equal ``transformers``' too. For DeepSeek-V2 they do not, for the
    reference as for the port: the reference's gate (a softmax over the
    top-k logits) is not HF's (a softmax over every expert, then the
    top-k, unnormalised under ``norm_topk_prob: false``); the drill passes
    on text, which the directory's 14-word tokenizer decodes to "" for
    every id past its vocabulary (ROADMAP, "Failures that are not the
    port's")."""
    d = make_model_dir(tmp_path, model_type)
    tok = RefFactory.create_tokenizer(str(d))
    want = drill.hf_greedy_ids(str(d), tok.encode(PROMPT), MAX_NEW)
    port_ids, port_text, agent = _serve(
        d, lambda store: build_agent(_port_args(d),
                                     coord=InMemoryCoordination(store)))
    assert agent.engine.cfg.model_family == \
        {"deepseek_v2": "deepseek_moe"}.get(model_type, model_type)
    ref_ids, ref_text, _ = _serve(d, _ref_agent(d))
    assert len(want) == MAX_NEW == len(port_ids)
    assert port_ids == ref_ids
    assert port_text == ref_text == tok.decode(want)
    if model_type == "mixtral":
        assert port_ids == want


def test_mixtral_tiny_behind_the_master_matches_the_jax_agent():
    """``--model-config mixtral_tiny --quant int8`` (in f32, on the JAX
    engine's random weights) and the JAX agent on the same config and
    weights, each behind an unchanged reference Master: the same greedy
    tokens for the same requests."""
    args = _parser().parse_args(["--model-config", "mixtral_tiny",
                                 "--quant", "int8", "--device", "cpu",
                                 "--num-pages", "64", "--max-batch-size",
                                 "2", "--max-seq-len", "256"])
    ecfg = engine_config(args)
    assert ecfg.model.name == "mixtral" and ecfg.model.quant == "int8"
    ecfg = dataclasses.replace(ecfg, model=dataclasses.replace(
        ecfg.model, dtype=torch.float32, max_context_len=256))
    rcfg = ref_mixtral.mixtral_tiny_config(dtype=jnp.float32, quant="int8",
                                           max_context_len=256)
    tree = jax.tree.map(np.asarray, ref_mixtral.init_params(
        dataclasses.replace(rcfg, quant=""), jax.random.PRNGKey(0)))
    kw = dict(num_pages=64, page_size=16, max_batch_size=2, max_seq_len=256)
    clusters = [
        _Cluster(lambda store: RefAgent(
            RefEngineConfig(model_id="mixtral", model=rcfg,
                            model_family="mixtral", hash_block_size=32,
                            prefill_buckets=(32, 64, 256), **kw),
            RefAgentConfig(host="127.0.0.1", model_id="mixtral",
                           heartbeat_interval_s=0.3, lease_ttl_s=1.0),
            coord=InMemoryCoordination(store), params=tree)),
        _Cluster(lambda store: EngineAgent(
            ecfg, AgentConfig(host="127.0.0.1", model_id="mixtral",
                              heartbeat_interval_s=0.3, lease_ttl_s=1.0),
            coord=InMemoryCoordination(store), device="cpu",
            params=params_from_jax(tree, device="cpu")))]
    try:
        got = []
        for c in clusters:
            ids = []
            for i, prompt in enumerate(([5, 7, 9, 11, 13], [40, 41] * 9)):
                r = requests.post(f"{c.base}/v1/completions", json={
                    "model": "mixtral", "prompt": prompt, "max_tokens": 8,
                    "temperature": 0, "ignore_eos": True}, timeout=120)
                assert r.status_code == 200, r.text
                ids.append(c.tokens[(r.headers["X-Request-Id"], 0)])
            got.append(ids)
        assert quant.is_quantized(
            clusters[1].agent.engine.params["moe"]["experts"]["up_proj"]
            ["kernel"])
        assert all(len(t) == 8 for t in got[1])
        assert got[1] == got[0]
    finally:
        for c in clusters:
            c.stop()


def test_hf_directory_config_json_round_trip(tmp_path):
    """A deepseek_v3 directory maps as deepseek_v2 does, in the
    reference as here."""
    d = make_model_dir(tmp_path, "deepseek_v2")
    conf = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**conf,
                                               "model_type": "deepseek_v3"}))
    port = hf_config.model_config_from_hf(d, dtype=torch.float32)
    ref = ref_hf.model_config_from_hf(d, dtype=jnp.float32)
    assert port.name == ref.name == "deepseek_moe"
    assert hf_config.loader_for(port) is loader.load_hf_deepseek_safetensors
