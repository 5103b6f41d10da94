"""The port's chunked prefill against the reference engine's, on the CPU
(the scenarios of tests/test_engine.py's ``TestChunkedPrefill`` and
``TestConcurrentChunkedPrefills``).

Every scenario runs twice, on the JAX engine and on the port, with the
same tiny f32 weights (``llama_params_from_jax``), the same configuration
and the same steps; the greedy tokens must be identical, and the
scenario's own checks (chunks in flight, interleaving, deferral) must hold
on both. The logits of the two agree to ~1e-5, far inside the gaps
between a random model's top logits.

``both`` and ``Collector`` are shared with the other admission-path files
(test_torch_sarathi.py, test_torch_hybrid_scheduling.py,
test_torch_async_install.py).
"""

import itertools
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
from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models import base
from xllm_service_tpu_torch.models.weights import llama_params_from_jax

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

CONTEXT = 512
# tests/test_engine.py's make_engine.
ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)
GREEDY = dict(temperature=0.0, ignore_eos=True)


_finishes = itertools.count()


class Collector:
    def __init__(self):
        self.outputs = []
        self.done = threading.Event()
        self.finished_at = -1          # position in the order of finishes

    def __call__(self, out) -> None:
        self.outputs.append(out)
        if out.finished:
            self.finished_at = next(_finishes)
            self.done.set()

    @property
    def tokens(self):
        return [t for o in self.outputs for s in o.outputs
                for t in s.token_ids]

    @property
    def finish_reason(self):
        for o in self.outputs:
            for s in o.outputs:
                if s.finish_reason:
                    return s.finish_reason
        return ""


@pytest.fixture(scope="module")
def weights():
    """(the reference's tree, the same weights as the port's tensors)."""
    rcfg = ref_base.tiny_config(dtype=jnp.float32, max_context_len=CONTEXT)
    tree = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    return tree, llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                       device="cpu")


def make_engine(weights, ref: bool, **kw):
    """The JAX engine (``ref``) or the port's, on ``weights``, with
    ENGINE_KW updated by ``kw``."""
    kw = {**ENGINE_KW, **kw}
    if ref:
        return RefEngine(RefConfig(
            model=ref_base.tiny_config(dtype=jnp.float32,
                                       max_context_len=CONTEXT),
            prefill_buckets=(32, 64, kw["max_seq_len"]), **kw),
            params=weights[0])
    return InferenceEngine(EngineConfig(
        model=base.tiny_config(dtype=torch.float32, max_context_len=CONTEXT),
        **kw), device="cpu", params=weights[1])


def both(weights, scenario, **kw):
    """Run ``scenario(engine, submit)`` on the JAX engine, then on the
    port, each built by ``make_engine(weights, ..., **kw)``; ``submit(name,
    prompt, max_tokens, **request fields)`` submits a greedy request to
    that engine and returns its Collector. Returns (the reference's
    result, the port's)."""
    out = []
    for ref in (True, False):
        req_cls, sp_cls = ((RefRequest, RefSampling) if ref
                           else (EngineRequest, SamplingParams))
        eng = make_engine(weights, ref, **kw)

        def submit(name, prompt, max_tokens, sampling=None, _e=eng,
                   _r=req_cls, _s=sp_cls, **fields):
            col = Collector()
            sp = _s(max_tokens=max_tokens, **(sampling or GREEDY))
            _e.submit(_r(name, token_ids=list(prompt), sampling=sp,
                         on_output=col, **fields))
            return col

        try:
            out.append(scenario(eng, submit))
        finally:
            eng.stop()
    return out


def step_until(engine, cols, limit=400):
    for _ in range(limit):
        if all(c.done.is_set() for c in cols):
            return
        engine.step()
    raise AssertionError("requests did not finish")


def test_chunked_matches_unchunked(weights):
    prompt = list(range(3, 120))     # 117 tokens -> 3 chunks + final

    def scenario(eng, submit):
        col = submit("c", prompt, 5)
        step_until(eng, [col])
        return col.tokens

    ref, port = both(weights, scenario, prefill_chunk_tokens=32)
    plain = both(weights, scenario)[1]
    assert len(port) == 5
    assert port == ref == plain


def test_decode_interleaves_with_chunked_prefill(weights):
    def scenario(eng, submit):
        short = submit("short", range(10), 30)
        eng.step()                  # short admitted + first token
        long_ = submit("long", range(5, 200), 3)   # 195 tokens, 6 chunks
        interleaved = 0
        while eng._prefillings or not long_.done.is_set():
            before = len(short.tokens)
            eng.step()
            if eng._prefillings and len(short.tokens) > before:
                interleaved += 1
            if short.done.is_set() and long_.done.is_set():
                break
        step_until(eng, [short, long_])
        assert interleaved >= 2     # decode progressed during the chunks
        return short.tokens, long_.tokens

    ref, port = both(weights, scenario, prefill_chunk_tokens=32)
    assert len(port[0]) == 30 and len(port[1]) == 3
    assert port == ref


def test_chunked_prefill_cancellation(weights):
    def scenario(eng, submit):
        col = submit("cx", range(200), 5)
        eng.step()                  # starts the chunked admission
        assert eng._prefillings
        eng.cancel("cx")
        eng.step()
        assert not eng._prefillings
        assert col.done.is_set()
        assert not col.outputs[-1].status.ok()
        assert len(col.outputs) == 1
        assert len(eng._free_slots) == eng.cfg.max_batch_size
        assert eng.page_mgr.num_free == eng.cfg.num_pages - 1
        return col.tokens

    ref, port = both(weights, scenario, prefill_chunk_tokens=32)
    assert port == ref == []


def test_two_long_prompts_progress_together(weights):
    def scenario(eng, submit):
        c1 = submit("l1", range(3, 150), 3)
        c2 = submit("l2", range(7, 160), 3)
        eng.step()
        eng.step()
        assert len(eng._prefillings) == 2     # both in flight together
        # A short prompt admits at once despite two chunked prefills.
        c3 = submit("short", range(8), 2)
        eng.step()
        assert c3.tokens, "short prompt stalled behind chunked prefills"
        step_until(eng, [c1, c2, c3])
        return c1.tokens, c2.tokens, c3.tokens

    ref, port = both(weights, scenario, prefill_chunk_tokens=32)
    assert [len(t) for t in port] == [3, 3, 2]
    assert port == ref


def test_third_long_prompt_waits_for_capacity(weights):
    def scenario(eng, submit):
        cols = [submit(f"l{i}", range(5 + i, 150 + i), 2) for i in range(3)]
        eng.step()
        assert len(eng._prefillings) == 2
        assert len(eng._waiting) == 1        # the third is deferred
        step_until(eng, cols)
        return [c.tokens for c in cols]

    ref, port = both(weights, scenario, prefill_chunk_tokens=32)
    assert all(len(t) == 2 for t in port)
    assert port == ref


@pytest.mark.parametrize("concurrent", [1, 3])
def test_concurrent_prefill_cap(weights, concurrent):
    """``max_concurrent_prefills`` bounds the prefill set on both sides,
    and the tokens do not depend on it."""
    def scenario(eng, submit):
        cols = [submit(f"m{i}", range(9 + i, 160 + i), 2) for i in range(3)]
        eng.step()
        assert len(eng._prefillings) == concurrent
        step_until(eng, cols)
        return [c.tokens for c in cols]

    ref, port = both(weights, scenario, prefill_chunk_tokens=32,
                     max_concurrent_prefills=concurrent)
    assert port == ref


@pytest.mark.parametrize("chunk", [8, 24, 40])
def test_chunk_that_is_not_page_aligned_fails_validate(chunk):
    cfg = EngineConfig(model=base.tiny_config(dtype=torch.float32),
                       prefill_chunk_tokens=chunk, **ENGINE_KW)
    with pytest.raises(ValueError, match="page-aligned"):
        cfg.validate()
    with pytest.raises(ValueError, match="page-aligned"):
        InferenceEngine(cfg, device="cpu")


def test_queue_pressure_installs_a_moderate_suffix_whole(weights):
    """With arrivals waiting, a suffix of at most four chunks takes the
    whole install (no prefill set), as the reference's."""
    def scenario(eng, submit):
        cols = [submit(f"q{i}", range(20 + i, 120 + i), 3) for i in range(2)]
        eng._admit()
        # The first saw the second waiting: installed whole. The second
        # saw an empty queue: chunked.
        assert len(eng._prefillings) == 1
        assert cols[0].tokens and not cols[1].tokens
        step_until(eng, cols)
        return [c.tokens for c in cols]

    ref, port = both(weights, scenario, prefill_chunk_tokens=32)
    assert port == ref


def test_chunked_loop_serves_prompts_of_every_length(weights):
    """Through the background loop: prompts from one token to past eight
    chunks, all at once, give the reference's tokens."""
    lens = [1, 31, 32, 33, 64, 100, 257]

    def scenario(eng, submit):
        eng.start()
        cols = [submit(f"n{n}", range(2, 2 + n), 4) for n in lens]
        t0 = time.monotonic()
        for c in cols:
            assert c.done.wait(max(1.0, 120 - (time.monotonic() - t0)))
        return [c.tokens for c in cols]

    ref, port = both(weights, scenario, prefill_chunk_tokens=32,
                     max_seq_len=512, num_pages=128)
    assert all(len(t) == 4 for t in port)
    assert port == ref
