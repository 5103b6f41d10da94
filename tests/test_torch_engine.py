"""The port's engine against the reference engine on shared tiny weights
(f32, CPU): identical greedy tokens, mirroring tests/test_engine.py's
greedy-vs-naive-loop, batched-equals-solo, queueing, prefix-cache reuse,
stop-token and cancellation cases, plus seeded-sampling determinism.

Both engines share one set of weights (``llama_params_from_jax``) and run
with two batch slots, so three or more requests queue. Greedy tokens are
compared exactly: the logits agree to ~1e-5 (tests/test_torch_llama.py),
far inside the gaps between a random model's top logits.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models import llama
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=256, decode_horizon=4)


class Collector:
    def __init__(self):
        self.outputs = []
        self.done = threading.Event()

    def __call__(self, out) -> None:
        self.outputs.append(out)
        if out.finished:
            self.done.set()

    @property
    def tokens(self):
        return [t for o in self.outputs for s in o.outputs for t in s.token_ids]

    @property
    def finish_reason(self):
        for o in self.outputs:
            for s in o.outputs:
                if s.finish_reason:
                    return s.finish_reason
        return ""


@pytest.fixture(scope="module")
def engines():
    tree = ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))
    ref = RefEngine(RefConfig(model=ref_tiny(dtype=jnp.float32,
                                             max_context_len=256),
                              prefill_buckets=(32, 64, 256), **ENGINE_KW),
                    params=tree)
    port = InferenceEngine(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256), **ENGINE_KW),
        device="cpu",
        params=llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu"))
    return ref, port


_ids = iter(range(10**6))


def run(engine, prompts, timeout=120, **sp):
    """Submit one request per prompt and step the engine until all finish;
    returns the collectors."""
    is_ref = isinstance(engine, RefEngine)
    req_cls, sp_cls = ((RefRequest, RefSampling) if is_ref
                       else (EngineRequest, SamplingParams))
    cols = [Collector() for _ in prompts]
    for p, c in zip(prompts, cols):
        engine.submit(req_cls(f"r{next(_ids)}", token_ids=list(p),
                              sampling=sp_cls(**sp), on_output=c))
    t0 = time.monotonic()
    while any(not c.done.is_set() for c in cols):
        assert time.monotonic() - t0 < timeout
        if not engine.step():
            time.sleep(0.001)
    return cols


def both(engines, prompts, **sp):
    ref, port = engines
    want = run(ref, prompts, **sp)
    got = run(port, prompts, **sp)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.finish_reason == w.finish_reason
    return got


GREEDY = dict(temperature=0.0, ignore_eos=True)


def test_greedy_matches_reference_and_naive_loop(engines):
    prompt = list(range(10, 30))
    col = both(engines, [prompt], max_tokens=8, **GREEDY)[0]
    assert col.finish_reason == "length"
    usage = [o.usage for o in col.outputs if o.usage][0]
    assert (usage.num_prompt_tokens, usage.num_generated_tokens) == (20, 8)
    # Naive loop on the port: a full dense prefill per token, argmax.
    port = engines[1]
    toks, want = list(prompt), []
    for _ in range(8):
        kv = torch.zeros_like(port.kv_pages)
        pt = torch.arange(1, port.cfg.pages_per_seq + 1,
                          dtype=torch.int32)[None]
        logits, _ = llama.prefill_forward(
            port.params, port.cfg.model, torch.tensor([toks]),
            torch.arange(len(toks))[None], kv, pt,
            torch.zeros((1,), dtype=torch.int32),
            torch.tensor([len(toks)], dtype=torch.int32))
        want.append(int(torch.argmax(logits[0])))
        toks.append(want[-1])
    assert col.tokens == want


def test_batched_and_queued_equal_reference(engines):
    prompts = [list(range(5, 20)), list(range(40, 70)),
               list(range(100, 140)), list(range(3, 21)),
               list(range(200, 233))]
    cols = both(engines, prompts, max_tokens=6, **GREEDY)
    assert all(len(c.tokens) == 6 and c.finish_reason == "length"
               for c in cols)
    port = engines[1]
    assert not port._running and port.stats()["waiting"] == 0


def test_prefix_cache_reuse_same_output(engines):
    port = engines[1]
    prompt = list(range(300, 364))   # 64 tokens = 2 hash blocks of 32
    first = both(engines, [prompt], max_tokens=5, **GREEDY)[0]
    assert port.drain_kv_events().stored
    hits = port.stats()["prefix_hits"]
    second = both(engines, [prompt], max_tokens=5, **GREEDY)[0]
    # The second run prefilled only the suffix behind the cached block.
    assert port.stats()["prefix_hits"] == hits + 1
    assert second.tokens == first.tokens


def test_stop_token_ids(engines):
    prompt = list(range(10, 26))
    first = run(engines[1], [prompt], max_tokens=1, **GREEDY)[0].tokens[0]
    col = both(engines, [prompt], max_tokens=10, stop_token_ids=[first],
               **GREEDY)[0]
    assert col.finish_reason == "stop" and col.tokens == [first]


def test_cancellation(engines):
    for engine in engines:
        col = Collector()
        req_cls, sp_cls = ((RefRequest, RefSampling)
                           if isinstance(engine, RefEngine)
                           else (EngineRequest, SamplingParams))
        engine.submit(req_cls("cancel-me", token_ids=list(range(20)),
                              sampling=sp_cls(max_tokens=200, **GREEDY),
                              on_output=col))
        for _ in range(3):
            engine.step()
        engine.cancel("cancel-me")
        for _ in range(5):
            engine.step()
        assert col.done.is_set()
        assert not engine._running


def test_logprobs_match_reference(engines):
    prompt = list(range(12, 40))
    cols = both(engines, [prompt], max_tokens=3, logprobs=True,
                top_logprobs=3, **GREEDY)
    want = run(engines[0], [prompt], max_tokens=3, logprobs=True,
               top_logprobs=3, **GREEDY)[0]
    got_lps = [lp for o in cols[0].outputs for s in o.outputs
               for lp in s.logprobs]
    want_lps = [lp for o in want.outputs for s in o.outputs
                for lp in s.logprobs]
    assert len(got_lps) == 3
    for g, w in zip(got_lps, want_lps):
        assert g.token_id == w.token_id == g.top_logprobs[0].token_id
        assert abs(g.logprob - w.logprob) < 1e-4
        assert [t.token_id for t in g.top_logprobs] == \
            [t.token_id for t in w.top_logprobs]


def test_seeded_sampling_deterministic(engines):
    port = engines[1]
    prompt = list(range(50, 80))
    sp = dict(max_tokens=6, temperature=0.8, top_k=20, top_p=0.9, seed=42,
              ignore_eos=True)
    a = run(port, [prompt], **sp)[0].tokens
    # Alone and beside other traffic: the same draws.
    b = run(port, [prompt, list(range(7, 30))], **sp)[0].tokens
    assert a == b and len(a) == 6


def test_background_loop_serves(engines):
    port = engines[1]
    port.start()
    try:
        col = Collector()
        port.submit(EngineRequest("bg", token_ids=list(range(9, 40)),
                                  sampling=SamplingParams(max_tokens=5,
                                                          **GREEDY),
                                  on_output=col))
        assert col.done.wait(60)
    finally:
        port.stop()
    assert not port._thread.is_alive()
    assert len(col.tokens) == 5
