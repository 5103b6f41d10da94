"""The port's MLA (multi-head latent attention, the deepseek_moe family with
``kv_lora_rank > 0``) against the reference's, on the CPU (mirrors
tests/test_models_extra.py's TestMLA and
``test_moe_speculative_greedy_identical``).

``tiny_mla_config`` (a 32-wide latent and 16 rope dims: one 48-wide KV
head a token) on the reference's weights, norm scales drawn non-zero:
prefill, decode, verify and embed logits within 1e-4 and the latent pool
within 1e-5 in f32, plain and int8 (the latent projections and the per-head
up-projections quantized); greedy engine tokens identical to the JAX
engine's, plain, with ``speculate_k=4`` and in int8. Also the routes: the
decode's ``paged_attention_xla`` counted once a layer a step, a prefill
behind a cached prefix with its explicit scale on the dense route (the
reference's kernel gate), and no family that reaches kernel 2 passing a
scale.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu_torch.models import base, deepseek_moe, gemma
from xllm_service_tpu_torch.models import llama, mixtral, qwen2
from xllm_service_tpu_torch.models.base import get_model_family
from xllm_service_tpu_torch.ops import attention

from test_torch_gemma import (
    _pool,
    _prefill,
    check_decode,
    check_embed,
    check_prefill,
    check_verify,
)
from test_torch_moe import (
    check_quantize_tree,
    check_streamed_int8_build,
    engine_checks,
    moe_models,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores


def tiny_mla(**kw):
    return ref_ds.tiny_mla_config(dtype=jnp.float32, **kw)


@pytest.fixture(scope="module", params=["mla", "mla_dense1"])
def models(request):
    if request.param == "mla":
        return moe_models(tiny_mla())
    return moe_models(tiny_mla(num_layers=3, first_dense_layers=1))


def test_cache_entry_is_compressed(models):
    rcfg, _, cfg, params = models
    assert cfg.num_kv_heads == 1
    assert cfg.head_dim == cfg.kv_lora_rank + cfg.qk_rope_head_dim
    layers = params["layers"]
    assert "k_up" in layers and "kv_down" in layers
    assert "k_proj" not in layers
    assert tuple(layers["k_up"]["kernel"].shape) == (
        cfg.num_layers, cfg.num_heads, cfg.qk_nope_head_dim,
        cfg.kv_lora_rank)


def test_prefill_cold_and_behind_a_cached_prefix(models):
    check_prefill(models)


def test_decode_steps(models):
    check_decode(models)


def test_verify_forward(models):
    check_verify(models)


def test_embed_forward(models):
    check_embed(models)


def test_int8_forwards():
    m = moe_models(tiny_mla(), quantized=True)
    for name in ("kv_down", "k_rope", "k_up", "v_up", "q_proj"):
        assert m[3]["layers"][name]["kernel"]["q8"].dtype == torch.int8
    assert not isinstance(m[3]["layers"]["kv_norm"]["scale"], dict)
    check_prefill(m)
    check_decode(m)
    check_verify(m)


def test_quantize_tree_and_scale_shapes():
    """tests/test_quant.py::test_expert_scale_shapes, and the tree against
    the reference's bit for bit."""
    rcfg = tiny_mla()
    got = check_quantize_tree(rcfg)
    Lm, H = rcfg.num_layers - rcfg.first_dense_layers, rcfg.num_heads
    ex = got["moe"]["experts"]
    assert tuple(ex["gate_proj"]["kernel"]["scale"].shape) == \
        (Lm, rcfg.num_experts, rcfg.moe_ffn_size)
    assert tuple(ex["down_proj"]["kernel"]["scale"].shape) == \
        (Lm, rcfg.num_experts, rcfg.hidden_size)
    assert tuple(got["layers"]["k_up"]["kernel"]["scale"].shape) == \
        (rcfg.num_layers, H, rcfg.kv_lora_rank)
    assert tuple(got["layers"]["v_up"]["kernel"]["scale"].shape) == \
        (rcfg.num_layers, H, rcfg.v_head_dim)


def test_streamed_int8_build_equals_build_then_quantize():
    check_streamed_int8_build(deepseek_moe.tiny_mla_config(
        dtype=torch.bfloat16, num_layers=3, first_dense_layers=1))


@pytest.mark.parametrize("variant", ["plain", "spec", "int8"])
def test_engine_tokens_match_the_jax_engine(variant):
    engine_checks(tiny_mla(max_context_len=512), variant)


def test_decode_route_is_counted(models):
    """Every layer of an MLA decode step calls ``paged_attention_xla``
    once; a GQA family's decode does not."""
    rcfg, _, cfg, params = models
    fam = get_model_family(cfg.name)
    pool = torch.from_numpy(_pool(rcfg))
    pt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    before = attention.paged_attention_xla.launches
    fam.decode_forward(params, cfg, torch.tensor([5, 6], dtype=torch.int32),
                       torch.tensor([3, 0], dtype=torch.int32), pool, pt,
                       torch.tensor([4, 1], dtype=torch.int32))
    assert attention.paged_attention_xla.launches - before == cfg.num_layers
    m = moe_models(ref_ds.tiny_moe_config(dtype=jnp.float32))
    before = attention.paged_attention_xla.launches
    check_decode(m)
    assert attention.paged_attention_xla.launches == before


def test_explicit_scale_behind_a_prefix_takes_the_dense_route(
        models, monkeypatch):
    """The reference's kernel gate (``scale is None``): an MLA prefill
    behind a cached prefix goes to ``dense_prefill_route`` in every
    layer, never to kernel 2's wrapper; a prefix-free one does not take
    the dense route. Kernel 2's wrapper is replaced by one that fails, so
    a wrong route would show on the CPU too."""
    rcfg = models[0]

    def refuse(*a, **k):
        raise AssertionError("kernel 2 reached with an explicit scale")

    monkeypatch.setattr(attention, "mq_paged_attention", refuse)
    tokens = np.random.default_rng(8).integers(3, 500, size=(1, 9)).astype(
        np.int32)
    pt = np.arange(1, 7, dtype=np.int32)[None]
    lens = np.asarray([9], np.int32)
    before = attention.dense_prefill_route.launches
    _, _, _, kv = _prefill(models, _pool(rcfg), tokens,
                           np.zeros((1,), np.int32), lens, pt)
    assert attention.dense_prefill_route.launches == before
    got, want, _, _ = _prefill(models, kv, tokens[:, :4],
                               np.asarray([9], np.int32),
                               np.asarray([4], np.int32), pt)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert attention.dense_prefill_route.launches - before == \
        rcfg.num_layers


def _shipped_configs():
    yield from (base.tiny_config(), base.bench_1b_config(),
                base.llama3_8b_config(), gemma.gemma_tiny_config(),
                gemma.gemma2_tiny_config(), gemma.gemma_2b_config(),
                gemma.gemma2_9b_config(), qwen2.qwen2_7b_config(),
                qwen2.qwen2_72b_config(), mixtral.mixtral_tiny_config(),
                mixtral.mixtral_8x7b_config())


def test_no_family_on_kernel_2_passes_a_scale():
    """Before the gate: every layer of every config the port ships whose
    attention options carry an explicit scale also carries a softcap or
    a window (Gemma-2), so its prefills were on the dense route already;
    the gate moves no existing family off kernel 2."""
    for cfg in _shipped_configs():
        for l in range(cfg.num_layers):
            opts = llama._attn_opts(cfg, l)
            if "scale" in opts:
                assert "softcap" in opts or "window" in opts, (cfg.name, l)


def test_moe_speculative_greedy_identical():
    """tests/test_models_extra.py::test_moe_speculative_greedy_identical
    on the port alone (random weights from its seed): with and without
    speculation the greedy tokens are the same."""
    from test_torch_chunked_prefill import Collector, step_until
    from xllm_service_tpu_torch.common.request import SamplingParams
    from xllm_service_tpu_torch.engine import (
        EngineConfig,
        EngineRequest,
        InferenceEngine,
    )

    cfg = deepseek_moe.tiny_mla_config(dtype=torch.float32,
                                       max_context_len=256)
    out = []
    for k in (4, 0):
        eng = InferenceEngine(EngineConfig(
            model=cfg, model_family=cfg.name, num_pages=64, page_size=16,
            hash_block_size=32, max_batch_size=2, max_seq_len=256,
            speculate_k=k), device="cpu")
        try:
            col = Collector()
            eng.submit(EngineRequest("m", token_ids=[5, 6, 7, 8] * 8,
                                     sampling=SamplingParams(
                                         max_tokens=16, temperature=0.0,
                                         ignore_eos=True), on_output=col))
            step_until(eng, [col])
            out.append(col.tokens)
        finally:
            eng.stop()
    assert len(out[0]) == 16 and out[0] == out[1]


def test_bf16_prefill_logits():
    """bf16 on both sides: the two frameworks round at different points
    of the same bf16 program, so the logits agree within 5% of max
    |logit| (tests/test_torch_gemma.py's bound); a masking or latent
    fault moves them by their whole scale."""
    rcfg = ref_ds.tiny_mla_config(dtype=jnp.bfloat16)
    models_ = moe_models(rcfg)
    cfg = dataclasses.replace(models_[2], dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    tokens = rng.integers(3, 500, size=(2, 21)).astype(np.int32)
    pt = np.arange(1, 13, dtype=np.int32).reshape(2, 6)
    lens = np.asarray([21, 13], np.int32)
    from test_torch_gemma import ref_fn
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21)).copy()
    kv = np.zeros((rcfg.num_layers, 2, 13, 1, 4, rcfg.head_dim), np.float32)
    want, _ = ref_fn(rcfg, "prefill_forward")(
        models_[1], rcfg, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(kv, jnp.bfloat16), jnp.asarray(pt),
        jnp.zeros((2,), jnp.int32), jnp.asarray(lens))
    got, _ = get_model_family(cfg.name).prefill_forward(
        models_[3], cfg, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.zeros(kv.shape, dtype=torch.bfloat16), torch.from_numpy(pt),
        torch.zeros((2,), dtype=torch.int32), torch.from_numpy(lens))
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 0.05 * np.abs(want).max()
