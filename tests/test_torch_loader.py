"""The port's checkpoint loading (``models/loader.py``,
``models/hf_config.py::load_checkpoint``) against the reference's
(the counterpart of tests/test_loader.py's ``TestHFLoader`` and
``TestOrbaxRoundtrip``), on the CPU, on the synthetic HF checkpoints that
``test_loader.make_hf_checkpoint`` writes (two shards, N(0, 1) weights).

- Every leaf equals the JAX loader's exactly (F32 files, an F32 model):
  llama, qwen2's qkv biases, a checkpoint without ``lm_head`` (untied: the
  embedding's transpose), gemma2's sandwich norms (tied: no ``lm_head``),
  and the JAX loader's mesh-sharded load; an F16 file too.
- The missing-layer error, and the warnings for unmapped tensors.
- Forwards on the loaded trees: prefill and decode logits within 1e-5 of
  max |logit| (the weights are N(0, 1), so logits run to the hundreds;
  both sides compute in f32 in another order), the KV pool within 1e-5
  of its scale; the engines' greedy tokens identical, int8 included.
- A BF16 file: the reference cannot read it (numpy has no bfloat16, pinned
  below); the port loads leaves equal to the F32 file rounded to bf16.
- The native ``save_params`` / ``load_params`` round trip, int8 trees
  included.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import loader as ref_loader
from xllm_service_tpu.models.base import get_model_family as ref_family
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu.models.gemma import gemma2_tiny_config as ref_gemma2
from xllm_service_tpu_torch.models import hf_config, loader, quant
from xllm_service_tpu_torch.models.base import get_model_family
from xllm_service_tpu_torch.models.safetensors_io import (
    SafeTensorsFile,
    save_file,
    shard_files,
)

from test_loader import make_hf_checkpoint
from test_torch_gemma import port_config

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

# name -> (reference config factory, make_hf_checkpoint keywords)
CASES = {
    "llama": (lambda: ref_tiny(dtype=jnp.float32), {}),
    "qwen2": (lambda: ref_tiny(dtype=jnp.float32, name="qwen2",
                               qkv_bias=True), {"qkv_bias": True}),
    "untied_without_lm_head": (lambda: ref_tiny(dtype=jnp.float32),
                               {"lm_head": False}),
    "gemma2": (lambda: ref_gemma2(dtype=jnp.float32), {"lm_head": False}),
}
REL = 1e-5


def _write(tmp_path, case, seed=0):
    make, kw = CASES[case]
    rcfg = make()
    hf = make_hf_checkpoint(tmp_path, rcfg, seed=seed, **kw)
    return rcfg, port_config(rcfg), hf


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def assert_trees_equal(got: dict, want: dict):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in w:
        want_np = np.asarray(w[path])
        assert tuple(g[path].shape) == want_np.shape, path
        np.testing.assert_array_equal(_as_np(g[path]),
                                      want_np.astype(np.float32), path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_leaves_equal_the_jax_loader(tmp_path, case):
    rcfg, cfg, hf = _write(tmp_path, case)
    want = ref_loader.load_hf_llama_safetensors(tmp_path, rcfg)
    got = loader.load_hf_llama_safetensors(tmp_path, cfg, device="cpu")
    assert_trees_equal(got, want)
    assert all(t.dtype == torch.float32 for t in _leaves(got).values())
    assert ("lm_head" in got) == (case != "gemma2")
    if case == "untied_without_lm_head":
        np.testing.assert_array_equal(got["lm_head"]["kernel"].numpy(),
                                      hf["model.embed_tokens.weight"].T)
    # The layers stack along dim 0 and the projections are [in, out].
    np.testing.assert_array_equal(
        got["layers"]["q_proj"]["kernel"][1].numpy(),
        hf["model.layers.1.self_attn.q_proj.weight"].T)
    assert len(shard_files(tmp_path)) == 2


def test_leaves_equal_the_jax_loaders_sharded_load(tmp_path):
    from xllm_service_tpu.models.llama import LLAMA_STACKED_RULES
    from xllm_service_tpu.parallel.mesh import MeshConfig, build_mesh

    rcfg, cfg, _ = _write(tmp_path, "llama")
    mesh = build_mesh(MeshConfig(model=2), devices=jax.devices()[:2])
    want = ref_loader.load_hf_llama_safetensors(
        tmp_path, rcfg, mesh=mesh, rules=LLAMA_STACKED_RULES)
    assert want["layers"]["q_proj"]["kernel"].addressable_shards[0] \
        .data.shape[-1] == rcfg.q_size // 2
    assert_trees_equal(loader.load_hf_llama_safetensors(
        tmp_path, cfg, device="cpu"), jax.tree.map(np.asarray, want))


def test_f16_files_load_as_the_reference(tmp_path):
    """Both sides read F16; an f32 model casts the same halves."""
    rcfg, cfg, hf = _write(tmp_path, "qwen2")
    for f in shard_files(tmp_path):
        with SafeTensorsFile(f) as sf:
            half = {k: sf.get_tensor(k).half() for k in sf.keys()}
        save_file(half, f)
    want = ref_loader.load_hf_llama_safetensors(tmp_path, rcfg)
    got = loader.load_hf_llama_safetensors(tmp_path, cfg, device="cpu")
    assert_trees_equal(got, want)
    np.testing.assert_array_equal(
        got["embed"]["embedding"].numpy(),
        hf["model.embed_tokens.weight"].astype(np.float16).astype(
            np.float32))


def test_bf16_files_load_as_the_reference(tmp_path):
    """BF16 shards: every leaf equals the F32 file's rounded to bf16, and
    the JAX loader's. The reference reads shards with
    ``framework="numpy"``; numpy alone has no bfloat16, but the reference's
    loader imports JAX, whose ``ml_dtypes`` registers it (see the next
    test), so both sides read BF16."""
    import safetensors.torch

    rcfg, cfg, _ = _write(tmp_path, "qwen2")
    want = loader.load_hf_llama_safetensors(tmp_path, cfg, device="cpu")
    for f in shard_files(tmp_path):
        ts = safetensors.torch.load_file(str(f))
        safetensors.torch.save_file(
            {k: v.bfloat16() for k, v in ts.items()}, str(f))
    got = loader.load_hf_llama_safetensors(
        tmp_path, dataclasses.replace(cfg, dtype=torch.bfloat16),
        device="cpu")
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].dtype == torch.bfloat16
        assert torch.equal(g[path], w[path].bfloat16()), path
    ref = ref_loader.load_hf_llama_safetensors(
        tmp_path, dataclasses.replace(rcfg, dtype=jnp.bfloat16))
    assert_trees_equal(got, jax.tree.map(
        lambda a: np.asarray(a, np.float32), ref))


def test_numpy_alone_cannot_read_bf16(tmp_path):
    """Pinned: ``safe_open(..., framework="numpy")`` on a BF16 tensor
    raises ``TypeError`` in a process where nothing registered bfloat16
    with numpy (no JAX, no ``ml_dtypes``); the port's reader needs neither."""
    import subprocess
    import sys

    import safetensors.torch

    path = tmp_path / "bf16.safetensors"
    safetensors.torch.save_file({"w": torch.ones(3, dtype=torch.bfloat16)},
                                str(path))
    code = ("import sys\nfrom safetensors import safe_open\n"
            "try:\n"
            f"    with safe_open({str(path)!r}, framework='numpy') as f:\n"
            "        f.get_tensor('w')\n"
            "except TypeError as e:\n"
            "    print('TypeError', e)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ml_dtypes', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.splitlines() == [
        "TypeError data type 'bfloat16' not understood", "[]"], out
    with SafeTensorsFile(path) as sf:
        assert torch.equal(sf.get_tensor("w"),
                           torch.ones(3, dtype=torch.bfloat16))


def test_missing_layer_raises(tmp_path):
    cfg = port_config(ref_tiny(dtype=jnp.float32))
    D = cfg.hidden_size
    save_file({"model.embed_tokens.weight": torch.zeros(cfg.vocab_size, D),
               "model.norm.weight": torch.zeros(D),
               "model.layers.0.self_attn.q_proj.weight":
               torch.zeros(cfg.q_size, D)}, tmp_path / "model.safetensors")
    with pytest.raises(ValueError, match="missing layers") as ref_err:
        ref_loader.load_hf_llama_safetensors(
            tmp_path, ref_tiny(dtype=jnp.float32))
    with pytest.raises(ValueError, match="missing layers") as err:
        loader.load_hf_llama_safetensors(tmp_path, cfg, device="cpu")
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(FileNotFoundError):
        loader.load_hf_llama_safetensors(tmp_path / "none", cfg,
                                         device="cpu")


def test_unmapped_tensors_warn_and_are_skipped(tmp_path, caplog):
    rcfg, cfg, _ = _write(tmp_path, "llama")
    save_file({"model.rotary_emb.inv_freq": torch.ones(4),
               "model.layers.0.self_attn.rotary_emb.inv_freq":
               torch.ones(4)}, tmp_path / "model-extra.safetensors")
    with caplog.at_level(logging.WARNING, logger=loader.__name__):
        got = loader.load_hf_llama_safetensors(tmp_path, cfg, device="cpu")
    msgs = [r.getMessage() for r in caplog.records]
    assert "unmapped checkpoint tensor: model.rotary_emb.inv_freq" in msgs
    assert ("unmapped layer tensor: "
            "model.layers.0.self_attn.rotary_emb.inv_freq") in msgs
    assert_trees_equal(got, ref_loader.load_hf_llama_safetensors(
        tmp_path, rcfg))


# ------------------------------------------------------------ forwards
def _forwards(rcfg, tree, cfg, params, n_decode=3):
    """One cold prefill of two rows, then decode steps: (ref, port)
    logits per call and the final pools."""
    rng = np.random.default_rng(0)
    P, PS = 16, 16
    tokens = rng.integers(3, rcfg.vocab_size, size=(2, 19)).astype(np.int32)
    pt = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    lens = np.asarray([19, 11], np.int32)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19)).copy()
    zero = np.zeros((2,), np.int32)
    kv = np.zeros((rcfg.num_layers, 2, P, rcfg.num_kv_heads, PS,
                   rcfg.head_dim), np.float32)
    fam, rfam = get_model_family(cfg.name), ref_family(rcfg.name)
    want, jkv = jax.jit(rfam.prefill_forward, static_argnums=1)(
        tree, rcfg, *(jnp.asarray(a) for a in (tokens, pos, kv, pt, zero,
                                               lens)))
    tkv = torch.from_numpy(kv.copy())
    got, _ = fam.prefill_forward(params, cfg, torch.from_numpy(tokens),
                                 torch.from_numpy(pos), tkv,
                                 *(torch.from_numpy(a) for a in (pt, zero,
                                                                 lens)))
    out = [(np.asarray(want), got.numpy())]
    last, clens = np.array(jnp.argmax(want, -1), np.int32), lens + 1
    dec = jax.jit(rfam.decode_forward, static_argnums=1)
    for _ in range(n_decode):
        want, jkv = dec(tree, rcfg, jnp.asarray(last),
                        jnp.asarray(clens - 1), jkv, jnp.asarray(pt),
                        jnp.asarray(clens))
        got, _ = fam.decode_forward(
            params, cfg, torch.from_numpy(last), torch.from_numpy(clens - 1),
            tkv, torch.from_numpy(pt), torch.from_numpy(clens))
        out.append((np.asarray(want), got.numpy()))
        last, clens = np.array(jnp.argmax(want, -1), np.int32), clens + 1
    return out, np.asarray(jkv), tkv.numpy()


@pytest.mark.parametrize("case", ["llama", "qwen2", "gemma2"])
def test_forwards_on_loaded_trees(tmp_path, case):
    rcfg, cfg, _ = _write(tmp_path, case)
    tree = jax.tree.map(np.asarray,
                        ref_loader.load_hf_llama_safetensors(tmp_path, rcfg))
    params = hf_config.load_checkpoint(tmp_path, cfg, device="cpu")
    calls, jkv, tkv = _forwards(rcfg, tree, cfg, params)
    for want, got in calls:
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(tkv[:, :, 1:] - jkv[:, :, 1:]).max() <= \
        REL * np.abs(jkv).max()


def _serve(eng, req_cls, sp_cls, prompts, n_new=8):
    from test_torch_chunked_prefill import Collector, step_until

    cols = []
    for i, p in enumerate(prompts):
        col = Collector()
        eng.submit(req_cls(f"r{i}", token_ids=list(p), sampling=sp_cls(
            max_tokens=n_new, temperature=0.0, ignore_eos=True),
            on_output=col))
        cols.append(col)
    step_until(eng, cols)
    return [c.tokens for c in cols]


ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=128)


@pytest.mark.parametrize("case,quant_mode", [
    ("llama", ""), ("qwen2", ""), ("gemma2", ""), ("llama", "int8"),
    ("gemma2", "int8")])
def test_engines_on_loaded_trees(tmp_path, case, quant_mode):
    """The JAX engine on the JAX loader's tree and the port's engine on the
    port's: greedy tokens identical; under int8 both engines quantize the
    loaded tree at start, and the port's int8 leaves equal its
    ``load_checkpoint`` with ``quant="int8"``."""
    from xllm_service_tpu.common.request import SamplingParams as RefSP
    from xllm_service_tpu.engine.config import EngineConfig as RefConfig
    from xllm_service_tpu.engine.engine import EngineRequest as RefReq
    from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )

    rcfg, cfg, _ = _write(tmp_path, case)
    rcfg = dataclasses.replace(rcfg, quant=quant_mode, max_context_len=256)
    cfg = dataclasses.replace(cfg, quant=quant_mode, max_context_len=256)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, rcfg.vocab_size, size=n).tolist()
               for n in (21, 9, 40)]
    ref = RefEngine(RefConfig(model=rcfg, model_family=rcfg.name,
                              prefill_buckets=(32, 64, 128), **ENGINE_KW),
                    params=ref_loader.load_hf_llama_safetensors(tmp_path,
                                                                rcfg))
    try:
        want = _serve(ref, RefReq, RefSP, prompts)
    finally:
        ref.stop()
    params = loader.load_hf_llama_safetensors(tmp_path, cfg, device="cpu")
    eng = InferenceEngine(EngineConfig(model=cfg, model_family=cfg.name,
                                       **ENGINE_KW),
                          device="cpu", params=params)
    try:
        got = _serve(eng, EngineRequest, SamplingParams, prompts)
        if quant_mode:
            assert quant.is_quantized(eng.params["layers"]["q_proj"]
                                      ["kernel"])
            assert_trees_equal(
                eng.params, hf_config.load_checkpoint(tmp_path, cfg,
                                                      device="cpu"))
    finally:
        eng.stop()
    assert got == want


def test_int8_leaves_quantize_as_the_reference(tmp_path):
    from xllm_service_tpu.models import quant as ref_quant

    rcfg, cfg, _ = _write(tmp_path, "qwen2")
    want = ref_quant.quantize_tree(
        ref_loader.load_hf_llama_safetensors(tmp_path, rcfg))
    got = hf_config.load_checkpoint(
        tmp_path, dataclasses.replace(cfg, quant="int8"), device="cpu")
    g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for path in w:
        if path.endswith("/q8"):
            np.testing.assert_array_equal(g[path].numpy(), w[path], path)
        else:   # scales: both divide in f32 (one ulp, as test_torch_quant)
            np.testing.assert_allclose(_as_np(g[path]), w[path],
                                       rtol=2e-7, err_msg=path)


# ------------------------------------------------------ native round trip
@pytest.mark.parametrize("case,quant_mode", [("gemma2", ""),
                                             ("qwen2", "int8")])
def test_native_checkpoint_round_trip(tmp_path, case, quant_mode):
    (tmp_path / "hf").mkdir()
    rcfg, cfg, _ = _write(tmp_path / "hf", case)
    cfg = dataclasses.replace(cfg, quant=quant_mode)
    params = hf_config.load_checkpoint(tmp_path / "hf", cfg, device="cpu")
    loader.save_params(params, tmp_path / "native")
    assert not shard_files(tmp_path / "native")   # never taken for HF
    back = loader.load_params(tmp_path / "native", cfg, device="cpu")
    g, w = _leaves(back), _leaves(params)
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].dtype == w[path].dtype and torch.equal(
            g[path], w[path]), path
    if quant_mode:
        k = back["layers"]["down_proj"]["kernel"]
        assert k["q8"].dtype == torch.int8 and k["scale"].dtype == \
            torch.float32
    # An f32 tree read back into a bf16 model casts its floating leaves.
    if not quant_mode:
        bf = loader.load_params(tmp_path / "native", dataclasses.replace(
            cfg, dtype=torch.bfloat16), device="cpu")
        assert torch.equal(bf["embed"]["embedding"],
                           params["embed"]["embedding"].bfloat16())
    with pytest.raises(FileNotFoundError):
        loader.load_params(tmp_path / "hf", cfg, device="cpu")
