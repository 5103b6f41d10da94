"""The port's engine on the qwen2_vl family against the JAX engine, on the
CPU.

Both engines get the same tiny f32 weights (the reference's
``init_params`` with biases and norm scales drawn non-zero, carried over
by ``params_from_jax``) and the visual embeddings as the same numpy rows.
Greedy tokens must be identical, and after a scenario the KV pools agree
within 1e-4 (f32 programs in another summation order, over up to 60
prompt tokens), for: image prompts (one and two grids, two at once), a
text-only prompt on a VL engine with a prefix hit, a chunked image prompt
whose placeholder runs straddle the chunk boundary against the unchunked
one, two images that give different tokens, no prefix cache for image
prompts, the M-RoPE delta after a slot is reused by a text request, and a
PD pair of port engines (prefill-only, then the injected install) against
the JAX MIX engine. Logprobs agree within 1e-4. The captured step's use of
the delta needs a card: tests/test_torch_cuda_graph.py holds it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models.qwen2_vl import mrope_positions
from xllm_service_tpu_torch.models.weights import params_from_jax

from test_torch_chunked_prefill import Collector, step_until
from test_torch_gemma import drawn_tree
from test_torch_qwen2_vl import port_config

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

IMG = 100
KV_TOL = dict(rtol=1e-4, atol=1e-4)
GREEDY = dict(temperature=0.0, ignore_eos=True)
ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=256)


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_vl.tiny_vl_config(dtype=jnp.float32, max_context_len=256,
                                 image_token_id=IMG)
    tree = drawn_tree(rcfg)
    return rcfg, tree, params_from_jax(tree, device="cpu")


def make_engine(weights, ref: bool, **kw):
    rcfg, tree, params = weights
    kw = {**ENGINE_KW, **kw}
    if ref:
        return RefEngine(RefConfig(model=rcfg, model_family="qwen2_vl",
                                   prefill_buckets=(16, 32, 64, 256), **kw),
                         params=tree)
    return InferenceEngine(EngineConfig(model=port_config(rcfg),
                                        model_family="qwen2_vl", **kw),
                           device="cpu", params=params)


def submitter(eng, ref: bool):
    req_cls, sp_cls = ((RefRequest, RefSampling) if ref
                       else (EngineRequest, SamplingParams))

    def submit(name, prompt, n, mm=None, sampling=None, **fields):
        col = Collector()
        eng.submit(req_cls(name, token_ids=list(prompt),
                           sampling=sp_cls(max_tokens=n,
                                           **(sampling or GREEDY)),
                           mm_embeds=mm, on_output=col, **fields))
        return col
    return submit


def pool(eng) -> np.ndarray:
    kv = eng.kv_pages
    return kv.numpy() if isinstance(kv, torch.Tensor) else np.asarray(kv)


def both(weights, scenario, **kw):
    """``scenario(engine, submit)`` on a fresh JAX engine, then on a fresh
    port engine; returns ((ref result, ref pool), (port result, port
    pool))."""
    out = []
    for ref in (True, False):
        eng = make_engine(weights, ref, **kw)
        try:
            out.append((scenario(eng, submitter(eng, ref)), pool(eng)))
        finally:
            eng.stop()
    return out


def rows(seed, n, d=128):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


ONE = list(range(10, 22)) + [IMG] * 4 + list(range(30, 45))       # 31
TWO = [5, 6] + [IMG] * 4 + list(range(40, 60)) + [IMG] * 4 + [7, 8, 9]


def test_image_prompts(weights):
    """Two image requests in one batch (one grid, two grids); each slot
    holds its prompt's delta while it decodes."""
    deltas = []

    def scenario(eng, submit):
        cols = [submit("a", ONE, 8, rows(1, 4)),
                submit("b", TWO, 8, rows(2, 8))]
        if isinstance(eng, InferenceEngine):
            eng.step()
            deltas.append(sorted(eng._mrope_delta.tolist()))
        step_until(eng, cols)
        return [c.tokens for c in cols]

    (want, ref_kv), (got, kv) = both(weights, scenario)
    assert got == want
    np.testing.assert_allclose(kv[:, :, 1:], ref_kv[:, :, 1:], **KV_TOL)
    assert deltas == [sorted([mrope_positions(ONE, IMG)[1],
                              mrope_positions(TWO, IMG)[1]])]
    assert all(d < 0 for d in deltas[0])


def test_text_only_prompts_with_a_prefix_hit(weights):
    base = list(range(3, 70))

    def scenario(eng, submit):
        first = submit("a", base, 6)
        step_until(eng, [first])
        second = submit("b", base[:64] + [9, 8, 7], 6)
        step_until(eng, [second])
        return [first.tokens, second.tokens, eng.stats()["cached_blocks"]]

    (want, ref_kv), (got, kv) = both(weights, scenario)
    assert got == want and got[2] > 0
    np.testing.assert_allclose(kv[:, :, 1:], ref_kv[:, :, 1:], **KV_TOL)


def chunked_prompt():
    """About 60 tokens, two placeholder runs, the first straddling the
    16-token chunk boundary (tests/test_chunked_multimodal.py's)."""
    prompt = (list(range(10, 22)) + [IMG] * 3 + list(range(30, 55))
              + [IMG] * 3 + list(range(60, 77)))
    return prompt, rows(0, 6)


def test_chunked_matches_unchunked(weights):
    prompt, mm = chunked_prompt()

    def run(eng, submit):
        col = submit("c", prompt, 6, mm)
        step_until(eng, [col])
        return col.tokens

    (want, ref_kv), (whole, _) = both(weights, run)
    eng = make_engine(weights, False, prefill_chunk_tokens=16)
    chunks = [0]
    real = eng._prefill_chunk

    def counted(*args):
        chunks[0] += 1
        return real(*args)

    eng._prefill_chunk = counted
    try:
        got = run(eng, submitter(eng, False))
        kv = pool(eng)
    finally:
        eng.stop()
    assert chunks[0] >= 2, "the prompt was not chunked"
    assert got == whole == want
    np.testing.assert_allclose(kv[:, :, 1:], ref_kv[:, :, 1:], **KV_TOL)


def test_different_images_give_different_tokens(weights):
    def scenario(eng, submit):
        out = []
        for seed in (1, 2, 1):
            col = submit(f"i{seed}-{len(out)}", ONE, 8, rows(seed, 4),
                         sampling=dict(GREEDY, logprobs=True, top_logprobs=1))
            step_until(eng, [col])
            out.append((col.tokens, [o.logprob for x in col.outputs
                                     for s in x.outputs
                                     for o in s.logprobs]))
        return out

    (want, _), (got, _) = both(weights, scenario)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([lp for _, lp in got], [lp for _, lp in want],
                               atol=1e-4)
    assert got[0] == got[2]
    assert got[0] != got[1]


def test_no_prefix_cache_for_image_prompts(weights):
    """The same ids with two images: nothing is donated or matched, and
    the second request is not poisoned by the first's KV."""
    prompt = list(range(3, 70)) + [IMG] * 4 + [9]

    def scenario(eng, submit):
        out = []
        for seed in (3, 4):
            col = submit(f"n{seed}", prompt, 6, rows(seed, 4))
            step_until(eng, [col])
            out.append(col.tokens)
        st = eng.stats()
        return out, st["cached_blocks"], getattr(eng, "prefix_hits", 0)

    (want, _), (got, _) = both(weights, scenario)
    assert got == want
    tokens, cached, hits = got
    assert cached == 0 and hits == 0 and tokens[0] != tokens[1]


def test_delta_is_cleared_when_a_text_request_reuses_the_slot(weights):
    """One slot: an image request, then a text request on the same slot.
    The delta is zero after the release and the text request's tokens
    are those of an engine that never saw an image."""
    text = list(range(50, 80))

    def scenario(eng, submit):
        img = submit("i", TWO, 5, rows(5, 8))
        step_until(eng, [img])
        if isinstance(eng, InferenceEngine):
            assert eng._mrope_delta.tolist() == [0]
        col = submit("t", text, 8)
        step_until(eng, [col])
        return img.tokens, col.tokens

    (want, _), (got, _) = both(weights, scenario, max_batch_size=1)
    assert got == want
    fresh = make_engine(weights, False, max_batch_size=1)
    try:
        col = submitter(fresh, False)("t", text, 8)
        step_until(fresh, [col])
    finally:
        fresh.stop()
    assert col.tokens == got[1]


def test_pd_pair_against_the_jax_mix_engine(weights):
    """Port prefill-only with the image rows, its pages handed to a port
    decode engine, which recomputes the delta from the prompt's ids."""
    mm = rows(6, 8)
    ref = make_engine(weights, True)
    try:
        col = submitter(ref, True)("m", TWO, 8, mm)
        step_until(ref, [col])
        want = col.tokens
    finally:
        ref.stop()

    pre = make_engine(weights, False)
    got = []
    try:
        submitter(pre, False)("p", TWO, 8, mm, prefill_only=True,
                              on_prefill_done=got.append)
        for _ in range(20):
            if got:
                break
            pre.step()
        assert len(got) == 1 and pre.stats()["cached_blocks"] == 0
    finally:
        pre.stop()
    h = got[0]
    dec = make_engine(weights, False)
    try:
        col = submitter(dec, False)(
            "p", h.token_ids, 8, injected_first_token=h.first_token,
            injected_kv=h.kv_blob.clone())
        dec._admit()
        assert dec._mrope_delta.tolist()[dec._running[
            next(iter(dec._running))].slot] == mrope_positions(TWO, IMG)[1]
        step_until(dec, [col])
        assert dec.stats()["cached_blocks"] == 0
    finally:
        dec.stop()
    assert col.tokens == want


def test_a_preempted_image_request_resumes_with_its_images(weights):
    """6 usable pages: an offline image request (31 prompt + 12 new
    tokens, 3 pages) is preempted by an online one needing 4; its
    continuation re-prefills the prompt with the same visual rows, so its
    stream equals an uninterrupted run's. (The reference's continuation
    drops ``mm_embeds``; the port keeps them.)"""
    mm = rows(8, 4)

    def run(preempt):
        eng = make_engine(weights, False, num_pages=7, page_size=16,
                          hash_block_size=16, decode_horizon=1)
        submit = submitter(eng, False)
        try:
            off = submit("off", ONE, 12, mm, offline=True)
            if preempt:
                for _ in range(4):
                    eng.step()
                assert 2 <= len(off.tokens) < 12
            on = submit("on", range(100, 160), 4)
            step_until(eng, [off, on])
            return off.tokens, eng.preemption_count
        finally:
            eng.stop()

    (want, _), (got, n) = run(False), run(True)
    assert n >= 1 and got == want
