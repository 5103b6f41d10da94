"""The port's agent serving a Hugging Face model directory, on the CPU: the
counterpart of tests/test_checkpoint_serving.py and
tests/test_hf_parity.py::test_greedy_parity_full_stack for llama, qwen2
and gemma2.

A synthetic model directory (``test_hf_parity.make_model_dir``: two
safetensors shards with their index, ``config.json``, a ``WordLevel``
``tokenizer.json`` and ``tokenizer_config.json``) is served twice through
the unchanged reference ``Master`` (its tokenizer read from the same
directory): by the port's agent, built from its command line
(``--model-config hf --checkpoint-path D --tokenizer-path D``), and by the
JAX agent on the JAX loader's tree, as the reference's drill serves it.
The greedy tokens (recorded at each agent's streamer) equal
``transformers``' greedy generation on the same directory and each other,
and so does the served text.

Also: the agent's tokenizer is the directory's; ``--checkpoint-path ''``
and ``--tokenizer-path ''`` keep random weights from the seed and the byte
tokenizer; a native checkpoint serves through the same flag; a failed
load ends the process non-zero.
"""

import subprocess
import sys

import jax.numpy as jnp
import pytest
import requests
import torch

from xllm_service_tpu.common.config import ServiceOptions
from xllm_service_tpu.coordination.memory import (
    InMemoryCoordination,
    MemoryStore,
)
from xllm_service_tpu.engine.agent import AgentConfig as RefAgentConfig
from xllm_service_tpu.engine.agent import EngineAgent as RefAgent
from xllm_service_tpu.engine.config import EngineConfig as RefEngineConfig
from xllm_service_tpu.master import Master
from xllm_service_tpu.models import hf_config as ref_hf
from xllm_service_tpu.tokenizer import TokenizerFactory as RefFactory
from xllm_service_tpu_torch.engine.agent import _parser, build_agent
from xllm_service_tpu_torch.models import llama, loader
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.tokenizer import HFTokenizer, SimpleTokenizer

from fakes import wait_until
from test_hf_parity import drill, make_model_dir
from test_torch_agent_e2e import _record

PROMPT = "the capital of france is"
MAX_NEW = 12
ENGINE_ARGS = ["--num-pages", "64", "--page-size", "16",
               "--max-batch-size", "2", "--max-seq-len", "256"]


def _cluster(model_dir, make_agent):
    """A reference master reading ``model_dir``'s tokenizer, and the agent
    ``make_agent(store)`` registered with it."""
    store = MemoryStore(expiry_tick_s=0.05)
    master = Master(ServiceOptions(
        host="127.0.0.1", http_port=0, rpc_port=0, lease_ttl_s=2.0,
        sync_interval_s=0.3, reconcile_interval_s=0.1,
        tokenizer_path=str(model_dir)), coord=InMemoryCoordination(store))
    master.start()
    agent = make_agent(store)
    agent.cfg.heartbeat_interval_s = 0.3
    agent.start()
    tokens = _record(agent)
    assert wait_until(lambda: master.scheduler.instance_mgr.get_instance_meta(
        agent.name) is not None, timeout=30)
    return store, master, agent, tokens


def _port_args(model_dir, *extra):
    return _parser().parse_args([
        "--model-config", "hf", "--model-id", "ckpt",
        "--checkpoint-path", str(model_dir),
        "--tokenizer-path", str(model_dir), "--device", "cpu",
        "--host", "127.0.0.1", *ENGINE_ARGS, *extra])


def _ref_agent(model_dir):
    cfg = ref_hf.model_config_from_hf(model_dir, dtype=jnp.float32,
                                      max_context_len=256)

    def make(store):
        return RefAgent(
            RefEngineConfig(model_id="ckpt", model=cfg,
                            model_family=cfg.name, num_pages=64,
                            page_size=16, hash_block_size=32,
                            max_batch_size=2, max_seq_len=256,
                            prefill_buckets=(32, 256)),
            RefAgentConfig(host="127.0.0.1", model_id="ckpt",
                           instance_type=RefAgentConfig().instance_type,
                           tokenizer_path=str(model_dir),
                           heartbeat_interval_s=0.3, lease_ttl_s=2.0),
            coord=InMemoryCoordination(store),
            params=ref_hf.load_checkpoint(model_dir, cfg))
    return make


def _serve(model_dir, make_agent):
    """(token ids streamed, text served) for the prompt, greedy."""
    store, master, agent, tokens = _cluster(model_dir, make_agent)
    try:
        r = requests.post(
            f"http://127.0.0.1:{master.http_port}/v1/completions",
            json={"model": "ckpt", "prompt": PROMPT, "max_tokens": MAX_NEW,
                  "temperature": 0, "ignore_eos": True}, timeout=300)
        assert r.status_code == 200, r.text
        sid = r.headers["X-Request-Id"]
        return tokens[(sid, 0)], r.json()["choices"][0]["text"], agent
    finally:
        agent.stop()
        master.stop()
        store.close()


@pytest.mark.parametrize("model_type", ["llama", "qwen2", "gemma2"])
def test_greedy_tokens_match_transformers_and_the_jax_agent(tmp_path,
                                                            model_type):
    d = make_model_dir(tmp_path, model_type)
    tok = RefFactory.create_tokenizer(str(d))
    want = drill.hf_greedy_ids(str(d), tok.encode(PROMPT), MAX_NEW)
    port_ids, port_text, agent = _serve(
        d, lambda store: build_agent(_port_args(d),
                                     coord=InMemoryCoordination(store)))
    assert isinstance(agent.engine.tokenizer, HFTokenizer)
    assert agent.engine.params["embed"]["embedding"].dtype == torch.float32
    ref_ids, ref_text, _ = _serve(d, _ref_agent(d))
    assert len(want) == MAX_NEW
    assert port_ids == want
    assert ref_ids == want
    assert port_text == ref_text == tok.decode(want)


def test_agent_tokenizes_standalone_text_as_the_directory(tmp_path):
    """A request without token ids is tokenized by the agent with the
    directory's tokenizer (the reference's, here through the port's)."""
    d = make_model_dir(tmp_path, "llama")
    agent = build_agent(_port_args(d),
                        coord=InMemoryCoordination(MemoryStore()))
    try:
        ref = RefFactory.create_tokenizer(str(d))
        for text in (PROMPT, "hello world what is up", "paris is a city"):
            assert agent.engine.tokenizer.encode(text) == ref.encode(text)
        assert agent.engine.eos_token_id is None   # as the reference's
    finally:
        agent.stop()


def test_empty_paths_keep_todays_behaviour():
    args = _parser().parse_args(["--model-config", "tiny", "--device", "cpu",
                                 "--checkpoint-path", "",
                                 "--tokenizer-path", ""])
    agent = build_agent(args, coord=InMemoryCoordination(MemoryStore()))
    try:
        assert isinstance(agent.engine.tokenizer, SimpleTokenizer)
        cfg = agent.engine.cfg
        want = llama.init_params(cfg.model, torch.Generator().manual_seed(
            cfg.seed), "cpu")
        assert torch.equal(agent.engine.params["embed"]["embedding"],
                           want["embed"]["embedding"])
    finally:
        agent.stop()


def test_native_checkpoint_through_the_flag(tmp_path):
    cfg = tiny_config()
    tree = llama.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    loader.save_params(tree, tmp_path)
    args = _parser().parse_args(["--model-config", "tiny", "--device", "cpu",
                                 "--checkpoint-path", str(tmp_path)])
    agent = build_agent(args, coord=InMemoryCoordination(MemoryStore()))
    try:
        got = agent.engine.params
        for group in ("embed", "final_norm", "lm_head"):
            for k, v in tree[group].items():
                assert torch.equal(got[group][k], v)
        assert torch.equal(got["layers"]["q_proj"]["kernel"],
                           tree["layers"]["q_proj"]["kernel"])
    finally:
        agent.stop()


def _run_agent(*argv):
    return subprocess.run(
        [sys.executable, "-m", "xllm_service_tpu_torch.engine.agent",
         "--coordination-addr", "", "--device", "cpu", *argv],
        capture_output=True, text=True, timeout=300)


def test_failed_load_exits_non_zero(tmp_path):
    """No fallback to random weights: a missing directory, a truncated
    shard and a directory without config.json under ``--model-config hf``
    all end the process before it serves."""
    out = _run_agent("--model-config", "tiny", "--checkpoint-path",
                     str(tmp_path / "missing"))
    assert out.returncode == 1 and "FileNotFoundError" in out.stderr
    (tmp_path / "hf").mkdir()
    d = make_model_dir(tmp_path / "hf", "llama")
    shard = sorted(d.glob("*.safetensors"))[0]
    shard.write_bytes(shard.read_bytes()[:-100])
    out = _run_agent("--model-config", "hf", "--checkpoint-path", str(d))
    assert out.returncode == 1 and "runs past the file" in out.stderr
    out = _run_agent("--model-config", "hf")
    assert out.returncode == 2 and "config.json" in out.stderr


# ------------------------------------- chip_smoke.py phase 4k's helpers
@pytest.mark.parametrize("model_type", ["llama", "qwen2", "gemma2"])
def test_phase_4k_writer_gives_an_hf_directory(tmp_path, model_type):
    """``chip_smoke.py``'s HF writer at a tiny width: ``transformers``
    loads the directory with no missing or unexpected tensor, its
    ``config.json`` maps back to the same config, the port loads every
    leaf bit for bit, and a rollout on the loaded tree equals the tree in
    memory's (the checks phase 4k makes on the card)."""
    import dataclasses

    import chip_smoke
    from transformers import AutoModelForCausalLM

    from xllm_service_tpu_torch.models import gemma, hf_config

    cfg = {"llama": tiny_config(),
           "qwen2": tiny_config(name="qwen2", qkv_bias=True),
           "gemma2": gemma.gemma2_tiny_config()}[model_type]
    cfg = dataclasses.replace(cfg, max_context_len=256)
    params = llama.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for name, leaf in params["layers"].items():    # norms and biases drawn
        for k, v in leaf.items():
            if k in ("scale", "bias"):
                v.copy_(torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(len(name))) * 0.1
                        + (0 if k == "bias" or cfg.rms_unit_offset else 1))
    chip_smoke.write_hf_dir(str(tmp_path), params, cfg, model_type, 2)
    assert hf_config.model_config_from_hf(tmp_path) == cfg
    model, info = AutoModelForCausalLM.from_pretrained(
        str(tmp_path), output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"], info
    loaded = hf_config.load_checkpoint(tmp_path, cfg, device="cpu")
    assert chip_smoke.assert_trees_bit_equal(loaded, params, model_type)
    prompt = torch.randint(3, cfg.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(2))
    got = chip_smoke.rollout(llama, cfg, loaded, prompt.tolist(), 32)
    want = chip_smoke.rollout(llama, cfg, params, prompt.tolist(), 32)
    assert got[0] == want[0] and torch.equal(got[1], want[1])


def test_phase_4k_tokenizer_matches_tokenizers(tmp_path):
    """``chip_smoke.py``'s Llama-3-shaped tokenizer (2000 ranks here, 128000
    on the card) read by the port and by the ``tokenizers`` library: the
    same ids for its sample text, the special tokens, and the same text."""
    import chip_smoke
    from tokenizers import Tokenizer as LibTokenizer

    chip_smoke.llama3_tokenizer_files(str(tmp_path), seed=0, n_ranks=2000)
    lib = LibTokenizer.from_file(str(tmp_path / "tokenizer.json"))
    port = HFTokenizer(tmp_path / "tokenizer.json")
    text = chip_smoke.sample_text(1, 20000) + "<|eot_id|>x<|begin_of_text|>"
    ids = port.encode(text)
    assert ids == lib.encode(text, add_special_tokens=False).ids
    assert port.decode(ids) == lib.decode(ids)
    assert port.decode(ids, skip_special_tokens=False) == text
    assert port.vocab_size() == lib.get_vocab_size() == 2003
    assert {i: s for i, s in chip_smoke.llama3_specials().items()
            if "reserved" not in s} == {
        128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
        128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
        128009: "<|eot_id|>"}
    assert chip_smoke.llama3_specials()[128255] == \
        "<|reserved_special_token_250|>"


def test_streamed_text_is_the_decode_of_the_streamed_ids(tmp_path):
    """The engine's incremental detokenisation through a byte-level BPE
    whose merges cut UTF-8 sequences anywhere (phase 4k's tokenizer, 509
    ranks and its 3 special tokens: the tiny model's 512 ids): for every
    request the concatenated delta texts equal one decode of all its ids,
    which phase 4k requires of the agent on the card."""
    import chip_smoke
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )

    from test_torch_chunked_prefill import Collector, step_until

    chip_smoke.llama3_tokenizer_files(str(tmp_path), seed=3, n_ranks=509)
    tok = HFTokenizer(tmp_path / "tokenizer.json")
    assert tok.vocab_size() == 512
    eng = InferenceEngine(
        EngineConfig(model=tiny_config(dtype=torch.float32), num_pages=64,
                     max_batch_size=4, max_seq_len=256, decode_horizon=4),
        device="cpu", tokenizer=tok)
    cols = []
    for i in range(4):
        prompt = tok.encode(chip_smoke.sample_text(i, 120))
        assert len(prompt) < 200
        cols.append(Collector())
        eng.submit(EngineRequest(
            f"r{i}", token_ids=prompt,
            sampling=SamplingParams(max_tokens=40, temperature=1.0, seed=i,
                                    ignore_eos=True),
            on_output=cols[-1]))
    try:
        step_until(eng, cols)
    finally:
        eng.stop()
    for col in cols:
        ids = col.tokens
        text = "".join(s.text for o in col.outputs for s in o.outputs)
        assert len(ids) == 40 and text == tok.decode(ids)
