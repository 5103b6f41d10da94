"""Speculative decoding in the port against the reference engine's, on the
CPU (the nine scenarios of tests/test_speculative.py, plus the device
history, the verify forward, kernel 2 at the verify shapes, a seq mesh,
the agent's flag and the ``spec_bench`` twin).

Each greedy scenario runs on the JAX engine and on the port with the same
tiny f32 weights (``llama_params_from_jax``), the same configuration
(tests/test_speculative.py's) and the same steps, both with
``speculate_k=4``: the greedy tokens must be identical, and identical to
the port's own non-speculative run. The port's random draws come from
per-slot generators, not the reference's keys, so a sampled stream is
held against the port's own plain engine: a sampled slot draws once a
cycle as it draws once a step. The engines' logits agree to ~1e-5, far
inside the gaps between a random model's top logits.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chunked_prefill import (  # noqa: F401
    Collector,
    make_engine,
    step_until,
    weights,
)
from test_torch_mq_paged_attention import _setup
from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.ops.pallas_mq_paged_attention import (
    mq_paged_attention_pallas,
)
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import EngineRequest
from xllm_service_tpu_torch.engine import agent as port_agent
from xllm_service_tpu_torch.engine.speculative import (
    propose_drafts,
    spec_eligible,
    spec_ok,
)
from xllm_service_tpu_torch.models import base
from xllm_service_tpu_torch.models import llama
from xllm_service_tpu_torch.ops.mq_paged_attention import (
    mq_paged_attention_plain,
    mq_paged_attention_tiled_plain,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ROOT = Path(__file__).resolve().parents[1]
# tests/test_speculative.py's make_engine.
SPEC_KW = dict(num_pages=128, max_batch_size=2, max_seq_len=512)
REPETITIVE = [5, 6, 7, 8] * 10
VARIED = [(i * 13 + 2) % 400 + 10 for i in range(40)]
SAMPLED = dict(temperature=0.8, seed=11, ignore_eos=True)
LOGPROBS = dict(temperature=0.0, logprobs=True, top_logprobs=3,
                ignore_eos=True)


def serve(weights, scenario, ref, speculate_k=4, **kw):  # noqa: F811
    """Run ``scenario(engine, submit, spy)`` on the JAX engine (``ref``) or
    the port, built with tests/test_speculative.py's configuration updated
    by ``kw``. ``submit(name, prompt, max_tokens, fields=None,
    **sampling)`` submits a greedy request (``sampling`` replaces the
    greedy settings; ``fields`` are the request's other fields) and
    returns its Collector; ``spy`` counts the engine's spec calls."""
    req_cls, sp_cls = ((RefRequest, RefSampling) if ref
                       else (EngineRequest, SamplingParams))
    eng = make_engine(weights, ref, **{**SPEC_KW, "speculate_k": speculate_k,
                                       **kw})
    spy = {"calls": 0}
    if speculate_k:
        real = eng._spec_multi

        def counted(*a):
            spy["calls"] += 1
            return real(*a)

        eng._spec_multi = counted

    def submit(name, prompt, max_tokens, fields=None, **sampling):
        col = Collector()
        sp = sp_cls(max_tokens=max_tokens,
                    **(sampling or dict(temperature=0.0, ignore_eos=True)))
        eng.submit(req_cls(name, token_ids=list(prompt), sampling=sp,
                           on_output=col, **(fields or {})))
        return col

    try:
        return scenario(eng, submit, spy)
    finally:
        eng.stop()


def streams(*reqs):
    """A scenario serving ``reqs`` = (name, prompt, max_tokens, sampling)
    to the end; returns each request's tokens."""
    def scenario(eng, submit, spy):
        cols = [submit(n, p, m, **s) for n, p, m, s in reqs]
        step_until(eng, cols, limit=800)
        return [c.tokens for c in cols]
    return scenario


def test_greedy_identical_to_normal(weights):  # noqa: F811
    sc = streams(("a", REPETITIVE, 32, {}), ("b", VARIED, 32, {}))
    port = serve(weights, sc, ref=False)
    assert port == serve(weights, sc, ref=True)
    assert port == serve(weights, sc, ref=False, speculate_k=0)


def test_spec_path_actually_used_and_accepts(weights):  # noqa: F811
    """Each call runs speculate_cycles cycles; acceptance must beat even
    the cycle count (96 tokens over 4-cycle calls)."""
    def scenario(eng, submit, spy):
        col = submit("a", REPETITIVE, 96)
        step_until(eng, [col], limit=800)
        assert len(col.tokens) == 96
        assert 0 < spy["calls"] < 96 // eng.cfg.speculate_cycles
        return col.tokens

    assert serve(weights, scenario, ref=False) == \
        serve(weights, scenario, ref=True)


def test_stop_token_respected(weights):  # noqa: F811
    (base_toks,) = serve(weights, streams(("a", REPETITIVE, 8, {})),
                         ref=False, speculate_k=0)
    stop_tok = base_toks[3]

    def scenario(eng, submit, spy):
        col = submit("s", REPETITIVE, 32, temperature=0.0,
                     stop_token_ids=[stop_tok], ignore_eos=True)
        step_until(eng, [col])
        assert col.finish_reason == "stop"
        return col.tokens

    port = serve(weights, scenario, ref=False)
    assert port == serve(weights, scenario, ref=True)
    # Stop fires at the FIRST occurrence of the stop token in the
    # baseline stream.
    assert port == base_toks[:base_toks.index(stop_tok) + 1]


def test_sampling_request_uses_normal_path(weights):  # noqa: F811
    """With NO spec-eligible slot the plain decode horizon is used."""
    def scenario(eng, submit, spy):
        col = submit("s", VARIED, 8, temperature=0.8, seed=7,
                     ignore_eos=True)
        step_until(eng, [col])
        assert spy["calls"] == 0
        assert len(col.tokens) == 8
        return col.tokens

    port = serve(weights, scenario, ref=False)
    serve(weights, scenario, ref=True)
    assert port == serve(weights, streams(
        ("s", VARIED, 8, dict(temperature=0.8, seed=7, ignore_eos=True))),
        ref=False, speculate_k=0)[0]


def test_mixed_batch_keeps_speculating_and_matches_normal(
        weights):  # noqa: F811
    """One sampled request does NOT disable speculation for its greedy
    neighbour, and both streams equal the port's plain engine's (the
    sampled slot draws once a cycle from its generator, as once a step);
    the greedy stream equals the JAX engine's."""
    reqs = (("g", REPETITIVE, 24, {}), ("s", VARIED, 24, SAMPLED))

    def scenario(eng, submit, spy):
        toks = streams(*reqs)(eng, submit, spy)
        assert spy["calls"] > 0, "spec path unused despite a greedy slot"
        return toks

    port = serve(weights, scenario, ref=False)
    assert port == serve(weights, streams(*reqs), ref=False, speculate_k=0)
    assert port[0] == serve(weights, scenario, ref=True)[0]


def _lp_scenario(eng, submit, spy):
    cols = [submit("g", REPETITIVE, 16), submit("l", VARIED, 16, **LOGPROBS)]
    step_until(eng, cols)
    lps = [lp for o in cols[1].outputs for s in o.outputs
           for lp in (s.logprobs or [])]
    return [c.tokens for c in cols], [
        (lp.token_id, lp.logprob, [t.token_id for t in lp.top_logprobs])
        for lp in lps]


def test_logprobs_request_in_mixed_batch(weights):  # noqa: F811
    """A logprobs slot rides the spec cycle as a one-token-a-cycle slot
    with a full logprob pack, identical to the normal path's and to the
    JAX engine's."""
    port = serve(weights, _lp_scenario, ref=False)
    for other in (serve(weights, _lp_scenario, ref=False, speculate_k=0),
                  serve(weights, _lp_scenario, ref=True)):
        assert port[0] == other[0]
        assert len(port[1]) == len(other[1]) == 16
        for (tid, lp, top), (otid, olp, otop) in zip(port[1], other[1]):
            assert tid == otid and top == otop
            assert abs(lp - olp) < 1e-4


def test_chunked_prefill_history_feeds_drafts(weights):  # noqa: F811
    """A chunked long prompt still feeds the draft search: the history row
    is repaired after the install, so drafts match across the whole
    prompt, and the greedy output equals the unchunked engine's."""
    prompt = REPETITIVE * 3          # 120 tokens, chunks of 32

    def scenario(eng, submit, spy):
        (toks,) = streams(("a", prompt, 48, {}))(eng, submit, spy)
        assert len(toks) == 48
        # Acceptance: strictly fewer verify cycles than emitted tokens.
        assert 0 < spy["calls"] * eng.cfg.speculate_cycles < 48
        return toks

    whole = serve(weights, streams(("a", prompt, 48, {})), ref=False)
    port = serve(weights, scenario, ref=False, prefill_chunk_tokens=32)
    assert port == whole[0]
    assert port == serve(weights, scenario, ref=True,
                         prefill_chunk_tokens=32)


def test_budget_respected(weights):  # noqa: F811
    """Up to k+1 tokens a cycle, and the budget cut is still exact."""
    def scenario(eng, submit, spy):
        col = submit("a", REPETITIVE, 5)
        step_until(eng, [col])
        assert len(col.tokens) == 5 and col.finish_reason == "length"
        return col.tokens

    assert serve(weights, scenario, ref=False) == \
        serve(weights, scenario, ref=True)


def test_budget_edge_does_not_corrupt_neighbor(weights):  # noqa: F811
    """A sequence exhausting its budget mid-verify does not perturb its
    neighbour (overflow writes land on the garbage page or its own slack
    pages, and the block is bounded by the room left)."""
    sc = streams(("a", REPETITIVE, 3, {}), ("b", VARIED, 40, {}))
    port = serve(weights, sc, ref=False)
    assert port == serve(weights, sc, ref=False, speculate_k=0)
    assert port == serve(weights, sc, ref=True)


def test_budget_filling_the_context(weights):  # noqa: F811
    """A greedy slot whose budget runs to max_seq_len: the room uploaded
    with a call in flight lags one call, so its last verify blocks run
    past the end of the context. Their history writes go to the spare
    column and their K/V to the garbage page (``write_prefill_kv``), and
    both streams are the plain path's and the JAX engine's."""
    L = 128
    sc = streams(("a", REPETITIVE, L - len(REPETITIVE), {}),
                 ("b", VARIED, 40, {}))
    port = serve(weights, sc, ref=False, max_seq_len=L)
    assert len(port[0]) == L - len(REPETITIVE)
    assert port == serve(weights, sc, ref=False, max_seq_len=L,
                         speculate_k=0)
    assert port == serve(weights, sc, ref=True, max_seq_len=L)


# ------------------------------------------------------------ the history
def _history(eng):
    if hasattr(eng, "_dstate"):
        return (np.asarray(eng._dstate["hist"]),
                np.asarray(eng._dstate["hist_lo"]))
    return eng._hist.numpy().copy(), eng._hist_lo.numpy().copy()


def _whole(eng, submit, spy):
    cols = [submit("a", REPETITIVE, 12), submit("b", VARIED, 12)]
    eng._admit()
    seeded = _history(eng)
    step_until(eng, cols)
    return seeded, _history(eng), [c.tokens for c in cols]


def _chunked(eng, submit, spy):
    col = submit("a", REPETITIVE * 3, 12)
    step_until(eng, [col])
    return _history(eng), col.tokens


def _cache_matched(eng, submit, spy):
    first = submit("a", REPETITIVE + VARIED, 6)
    step_until(eng, [first])
    # The first 64 tokens (two hash blocks) are in the prefix cache.
    second = submit("b", REPETITIVE + VARIED[:30], 12)
    eng._admit()
    if not hasattr(eng, "_dstate"):          # the port counts its hits
        assert eng.prefix_hits == 1
    seeded = _history(eng)
    step_until(eng, [second])
    return seeded, _history(eng), first.tokens, second.tokens


def _plain_then_spec(eng, submit, spy):
    """A logprob request decodes alone on the plain path (its steps append
    to the history), then a greedy one joins and the spec path takes
    over."""
    lp = submit("l", VARIED, 24, **LOGPROBS)
    for _ in range(4):
        eng.step()
    assert spy["calls"] == 0 and len(lp.tokens) >= 2
    plain = _history(eng)
    g = submit("g", REPETITIVE, 24)
    step_until(eng, [lp, g])
    assert spy["calls"] > 0
    return plain, _history(eng), lp.tokens, g.tokens


def _preempted(eng, submit, spy):
    """tests/test_hybrid_scheduling.py's preemption: the offline request
    resumes as a continuation re-prefilling its prompt and emitted
    tokens."""
    off = submit("off", range(30, 60), 12, fields=dict(offline=True))
    for _ in range(2):
        eng.step()
    assert 2 <= len(off.tokens) < 12
    on = submit("on", range(100, 160), 4)
    step_until(eng, [off, on])
    assert eng.preemption_count >= 1
    return _history(eng), off.tokens, on.tokens


@pytest.mark.parametrize("scenario,kw", [
    (_whole, {}),
    (_chunked, dict(prefill_chunk_tokens=32)),
    (_cache_matched, {}),
    (_plain_then_spec, {}),
    (_preempted, dict(num_pages=7, max_seq_len=128)),
], ids=["whole", "chunked", "cache_matched", "plain_then_spec", "preempted"])
def test_history_equals_reference(weights, scenario, kw):  # noqa: F811
    """The device history rows and their search starts equal the JAX
    engine's after each kind of install, after plain steps and after the
    run."""
    ref = serve(weights, scenario, ref=True, **kw)
    port = serve(weights, scenario, ref=False, **kw)

    def flat(x):
        return [a for item in x for a in
                (item if isinstance(item, tuple) else (item,))]

    for a, b in zip(flat(port), flat(ref)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_host_and_device_eligibility_agree(weights):  # noqa: F811
    """The host's path choice (``spec_ok`` on a request's parameters) and
    the cycle's per-slot predicate (``spec_eligible`` on the installed
    sampling state) are one rule: only the plain greedy slot verifies."""
    cases = [dict(temperature=0.0), dict(temperature=0.8, seed=3),
             dict(temperature=0.0, logprobs=True, top_logprobs=2),
             dict(temperature=0.0, frequency_penalty=0.5),
             dict(temperature=0.0, presence_penalty=0.5),
             dict(temperature=0.0, repetition_penalty=1.1),
             dict(temperature=0.0, logit_bias={7: 1.0})]
    eng = make_engine(weights, False, **{**SPEC_KW, "speculate_k": 4,
                                         "max_batch_size": len(cases)})
    try:
        for i, sp in enumerate(cases):
            eng.submit(EngineRequest(f"r{i}", token_ids=VARIED,
                                     sampling=SamplingParams(max_tokens=4,
                                                             **sp),
                                     on_output=Collector()))
        eng._admit()
        assert len(eng._running) == len(cases)
        device = spec_eligible(eng._st, eng._want_lp).tolist()
        host = {seq.req.service_request_id: spec_ok(seq.req.sampling)
                for seq in eng._running.values()}
        assert [host[f"r{i}"] for i in range(len(cases))] == \
            [True] + [False] * (len(cases) - 1)
        for slot, seq in eng._running.items():
            assert device[slot] == host[seq.req.service_request_id]
    finally:
        eng.stop()


def test_propose_drafts_examples():
    """The latest earlier occurrence wins, the continuation stops at the
    context's end, nothing before ``hist_lo`` is searched, and a context
    no longer than the n-gram has no draft."""
    L = 16
    hist = torch.zeros((4, L), dtype=torch.int32)
    seq = [1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3]
    for b in range(4):
        hist[b, :len(seq)] = torch.tensor(seq)
    clens = torch.tensor([12, 12, 12, 3], dtype=torch.int32)
    lo = torch.tensor([0, 5, 0, 0], dtype=torch.int32)
    got = propose_drafts(hist, clens, lo, 3, 4).tolist()
    assert got[0] == [7, 8, 1, 2]      # the match at 4 beats the one at 0
    assert got[1] == [-1] * 4          # both matches start before 5
    assert got[2] == [7, 8, 1, 2]
    assert got[3] == [-1] * 4
    clens = torch.tensor([9, 9, 9, 9], dtype=torch.int32)
    hist[:, :9] = torch.tensor([4, 5, 6, 4, 5, 6, 4, 5, 6])
    assert propose_drafts(hist, clens, torch.zeros(4, dtype=torch.int32),
                          3, 4)[0].tolist() == [4, 5, 6, -1]


# --------------------------------------------------------- verify forward
def test_verify_forward_matches_reference(weights):  # noqa: F811
    """Logits at every block position and the pool, within 1e-5 of the
    reference's verify_forward, with block lengths 5, 1 and 0 behind
    prefixes of 37, 0 and 20 tokens."""
    tree, params = weights
    rcfg = base.tiny_config(dtype=torch.float32, max_context_len=512)
    from xllm_service_tpu.models.base import tiny_config as ref_tiny
    jcfg = ref_tiny(dtype=jnp.float32, max_context_len=512)
    rng = np.random.default_rng(3)
    B, S, ps, mp = 3, 5, 16, 4
    prefix = np.array([37, 0, 20], np.int32)
    blocks = np.array([5, 1, 0], np.int32)
    pt = (np.arange(B * mp, dtype=np.int32).reshape(B, mp) + 1)
    shape = (rcfg.num_layers, 2, B * mp + 1, rcfg.num_kv_heads, ps,
             rcfg.head_dim)
    kv = rng.normal(size=shape).astype(np.float32)
    toks = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    pos = prefix[:, None] + np.arange(S, dtype=np.int32)[None]
    want_logits, want_kv = ref_llama.verify_forward(
        tree, jcfg, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(kv),
        jnp.asarray(pt), jnp.asarray(prefix), jnp.asarray(blocks))
    kv_port = torch.from_numpy(kv.copy())
    got_logits, got_kv = llama.verify_forward(
        params, rcfg, torch.from_numpy(toks), torch.from_numpy(pos),
        kv_port, torch.from_numpy(pt), torch.from_numpy(prefix),
        torch.from_numpy(blocks))
    assert got_logits.shape == (B, S, rcfg.vocab_size)
    assert got_logits.dtype == torch.float32 and got_kv is kv_port
    want_logits = np.asarray(want_logits)
    for b in range(B):
        n = int(blocks[b])
        np.testing.assert_allclose(got_logits[b, :n].numpy(),
                                   want_logits[b, :n], rtol=1e-5, atol=1e-5)
    # Page 0 takes every row's padding; the reference's scatter picks one
    # of the colliding writes and the port another.
    np.testing.assert_allclose(got_kv.numpy()[:, :, 1:],
                               np.asarray(want_kv)[:, :, 1:],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel2_at_verify_shapes(seed):
    """Kernel 2's plain and tiled-plain versions against the reference's
    Pallas kernel (interpret mode) at a verify block: Sq 5, block lengths
    5, 1 and 0, a GQA group of 4. Tolerance 2e-5, as the kernel's own
    tests (f32 on both sides)."""
    q, bk, bv, kp, vp, pt, prefix, block = _setup(
        B=3, s_q=5, n_q=16, n_kv=4, hd=64, seed=seed, block=[5, 1, 0])
    pallas = np.asarray(mq_paged_attention_pallas(
        *[jnp.asarray(a) for a in (q, kp, vp, pt, prefix, block)],
        interpret=True))
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, prefix, block)]
    for got in (mq_paged_attention_plain(*t).numpy(),
                mq_paged_attention_tiled_plain(*t).numpy()):
        for b in range(3):
            n = int(block[b])
            np.testing.assert_allclose(got[b, :n], pallas[b, :n],
                                       rtol=2e-5, atol=2e-5)
            assert np.all(got[b, n:] == 0.0)


# ------------------------------------------------------------- seq mesh
def test_greedy_parity_under_a_seq_mesh(weights):  # noqa: F811
    """On a seq=4 mesh (the port's four CPU shards, the reference's four
    virtual CPU devices) the spec cycle runs eager and the verify reads
    the sharded pool gathered: greedy tokens equal the JAX engine's and
    the port's single-device run."""
    from xllm_service_tpu.engine.config import EngineConfig as RefConfig
    from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
    from xllm_service_tpu.models.base import tiny_config as ref_tiny
    from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
    from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
    from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    tree, params = weights
    kw = dict(num_pages=64, page_size=16, hash_block_size=32,
              max_batch_size=2, max_seq_len=512, speculate_k=4)
    ref = RefEngine(RefConfig(
        model=ref_tiny(dtype=jnp.float32, max_context_len=512),
        prefill_buckets=(32, 64, 512), mesh=RefMeshConfig(seq=4), **kw),
        params=tree)
    port = InferenceEngine(
        EngineConfig(model=base.tiny_config(dtype=torch.float32,
                                            max_context_len=512), **kw),
        device="cpu", params=params,
        mesh=build_mesh(MeshConfig(seq=4), ["cpu"] * 4))
    out = []
    for eng, req_cls, sp_cls in ((ref, RefRequest, RefSampling),
                                 (port, EngineRequest, SamplingParams)):
        cols = []
        for name, prompt in (("a", REPETITIVE), ("b", VARIED)):
            cols.append(Collector())
            eng.submit(req_cls(name, token_ids=prompt, on_output=cols[-1],
                               sampling=sp_cls(max_tokens=24,
                                               temperature=0.0,
                                               ignore_eos=True)))
        step_until(eng, cols)
        eng.stop()
        out.append([c.tokens for c in cols])
    assert out[1] == out[0]
    single = serve(weights, streams(("a", REPETITIVE, 24, {}),
                                    ("b", VARIED, 24, {})),
                   ref=False, num_pages=64)
    assert out[1] == single


# ---------------------------------------------------------------- agent
def test_agent_takes_speculate_k():
    args = port_agent._parser().parse_args(
        ["--model-config", "tiny", "--speculate-k", "4"])
    cfg = port_agent.engine_config(args)
    assert cfg.speculate_k == 4
    assert cfg.speculate_ngram == 3 and cfg.speculate_cycles == 4
    assert port_agent.engine_config(port_agent._parser().parse_args(
        ["--model-config", "tiny"])).speculate_k == 0


def test_family_without_verify_forward_turns_speculation_off(
        weights, caplog):  # noqa: F811
    """As the reference: a warning, and the plain path serves."""
    from dataclasses import replace

    from xllm_service_tpu_torch.models.base import _REGISTRY

    sc = streams(("a", REPETITIVE, 12, {}))

    def scenario(eng, submit, spy):
        assert not eng._spec_on
        toks = sc(eng, submit, spy)
        assert spy["calls"] == 0
        return toks

    fam = _REGISTRY["llama"]
    _REGISTRY["llama"] = replace(fam, verify_forward=None)
    try:
        with caplog.at_level("WARNING"):
            toks = serve(weights, scenario, ref=False)
    finally:
        _REGISTRY["llama"] = fam
    assert "speculative decoding disabled" in caplog.text
    assert toks == serve(weights, sc, ref=False, speculate_k=0)


# ----------------------------------------------------------------- twin
def test_spec_bench_twin_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "xllm_service_tpu_torch.benchmarks.spec_bench",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x.get("mode") for x in lines[:2]] == ["speculate_k=0",
                                                  "speculate_k=4"]
    assert all(x["tokens"] > 0 and x["tok_per_s"] > 0 for x in lines[:2])
    assert lines[2]["metric"] == "speculative_speedup"
    assert lines[2]["value"] > 0 and lines[2]["backend"] == "cpu"


def test_spec_bench_twin_raises_without_a_card():
    module = "xllm_service_tpu_torch.benchmarks.spec_bench"
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = [{module!r}]\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "device='cpu'" in out.stderr
