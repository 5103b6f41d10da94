"""The engine's captured decode step on the card (``engine/decode_graph.py``):
from the same state, one replay of the captured step and the same step run
op by op give bit-identical packed rows, KV pool and slot state (greedy,
seeded sampled and logprob rows); the kernels' launch counters advance per
replay; a capture that fails raises and reaches the requests; a step
captured before an image request arrives rotates that request's slot at
its M-RoPE delta (qwen2_vl).

Marked ``cuda``: they need a GPU and nvcc and skip elsewhere. Run them on
a machine with an H100 with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_graph.py``.
"""

import threading

import pytest
import torch

from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.engine.decode_graph import DecodeGraphs
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.ops.mq_paged_attention import mq_paged_attention
from xllm_service_tpu_torch.ops.fused_decode_attention import (
    fused_decode_attention,
)
from xllm_service_tpu_torch.ops.paged_attention import paged_attention

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

pytestmark = pytest.mark.cuda
B = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _engine(dev, horizon=4, **kw):
    mcfg = tiny_config(vocab_size=1024, hidden_size=512, num_heads=8,
                       num_kv_heads=2, head_dim=64, ffn_size=1024)
    cfg = EngineConfig(model=mcfg, num_pages=96, page_size=16,
                       hash_block_size=32, max_batch_size=B,
                       max_seq_len=256, decode_horizon=horizon, seed=0, **kw)
    return InferenceEngine(cfg, device=dev)


def _fill(eng, sampled=False, logprobs=False):
    """Every slot busy: two greedy rows and two seeded sampled rows (or
    greedy ones), optionally with logprobs."""
    for i in range(B):
        sp = (dict(temperature=0.9, top_p=0.9, seed=50 + i)
              if sampled and i % 2 else dict(temperature=0.0))
        eng.submit(EngineRequest(
            f"r{i}", token_ids=list(range(3 + 7 * i, 40 + 11 * i)),
            sampling=SamplingParams(max_tokens=100, ignore_eos=True,
                                    logprobs=logprobs, top_logprobs=3, **sp)))
    eng._admit()
    assert len(eng._running) == B


def _state(eng):
    st = eng._st
    return [eng._row, eng.kv_pages, eng._last, eng._clens, eng._active,
            st.token_counts]


def _snapshot(eng):
    return [t.clone() for t in _state(eng)]


def _restore(eng, snap):
    for t, s in zip(_state(eng), snap):
        t.copy_(s)
    for b, g in enumerate(eng._gens):
        g.manual_seed(1000 + b)


@pytest.mark.parametrize("route", ["default", "fused"])
@pytest.mark.parametrize("want_lp,sample", [(False, False), (False, True),
                                            (True, True)])
def test_replayed_step_equals_eager_step_bit_for_bit(dev, monkeypatch,
                                                     route, want_lp, sample):
    if route == "fused":
        monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    eng = _engine(dev)
    _fill(eng, sampled=sample, logprobs=want_lp)
    eng._graphs.run(want_lp, sample)          # capture, then a replay
    snap = _snapshot(eng)
    _restore(eng, snap)
    eng._decode_step(want_lp, sample)
    eager = _snapshot(eng)
    _restore(eng, snap)
    eng._graphs.run(want_lp, sample)          # a replay
    torch.cuda.synchronize()
    graphed = _snapshot(eng)
    assert eng._graphs.replays == 2 and eng._graphs.captures == 1
    for name, a, b in zip(["row", "kv_pages", "last", "clens", "active",
                           "token_counts"], eager, graphed):
        assert torch.equal(a.view(torch.uint8) if a.is_floating_point()
                           else a, b.view(torch.uint8)
                           if b.is_floating_point() else b), name
    assert torch.equal(graphed[3], snap[3] + 1)      # every row moved on


def test_seeded_tokens_graphed_equal_eager(dev):
    """A seeded sampled request beside greedy ones gives the same tokens
    through the captured step as through the step's ops on the card."""
    runs = []
    for graphed in (True, False):
        eng = _engine(dev, horizon=8)
        if not graphed:
            eng._graphs = None
        cols = {}
        for i, sp in enumerate([dict(temperature=0.0),
                                dict(temperature=0.8, top_k=50, seed=9)]):
            done = threading.Event()
            toks = []

            def on_output(out, toks=toks, done=done):
                for s in out.outputs:
                    toks.extend(s.token_ids)
                if out.finished:
                    done.set()
            cols[i] = (toks, done)
            eng.submit(EngineRequest(
                f"s{i}", token_ids=list(range(20 + i, 60)),
                sampling=SamplingParams(max_tokens=24, ignore_eos=True, **sp),
                on_output=on_output))
        while not all(d.is_set() for _, d in cols.values()):
            eng.step()
        if graphed:
            assert eng._graphs.replays > 0 and eng._graphs.captures >= 1
        runs.append([t for t, _ in cols.values()])
    assert runs[0] == runs[1]
    assert all(len(t) == 24 for t in runs[0])


@pytest.mark.parametrize("route", ["default", "fused"])
def test_launch_counters_advance_per_replay(dev, monkeypatch, route):
    if route == "fused":
        monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    counter = fused_decode_attention if route == "fused" else paged_attention
    other = paged_attention if route == "fused" else fused_decode_attention
    eng = _engine(dev)
    _fill(eng)
    L = eng.cfg.model.num_layers
    n0, m0 = counter.launches, other.launches
    eng._graphs.run(False, False)          # warm-up, capture, a replay
    assert counter.launches == n0 + 2 * L
    for k in range(1, 4):
        eng._graphs.run(False, False)
        assert counter.launches == n0 + L * (2 + k)
    assert other.launches == m0


def test_first_step_of_a_variant_is_a_replay(dev):
    """The warm-up before a capture is undone: the first step of a variant
    gives what the eager step gives from the same state."""
    eng = _engine(dev)
    _fill(eng, sampled=True)
    snap = _snapshot(eng)
    _restore(eng, snap)
    eng._decode_step(False, True)
    eager = _snapshot(eng)
    _restore(eng, snap)
    eng._graphs.run(False, True)           # warm-up, capture, a replay
    torch.cuda.synchronize()
    assert eng._graphs.replays == 1
    for a, b in zip(eager, _snapshot(eng)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("want_lp,sample", [(False, False), (False, True),
                                            (True, True)])
def test_replayed_spec_cycle_equals_eager_cycle_bit_for_bit(dev, want_lp,
                                                            sample):
    """The captured spec cycle against the same cycle op by op, from one
    state (repetitive prompts, so the drafts are real): the packed row,
    the pool, the slot state, the history and the room, bit for bit; the
    verify runs kernel 2 once a layer per replay."""
    eng = _engine(dev, speculate_k=4)
    for i in range(B):
        sp = (dict(temperature=0.9, top_p=0.9, seed=50 + i)
              if sample and i % 2 else dict(temperature=0.0))
        eng.submit(EngineRequest(
            f"r{i}", token_ids=[5 + i, 6, 7, 8] * (6 + i),
            sampling=SamplingParams(max_tokens=100, ignore_eos=True,
                                    logprobs=want_lp and i == 0,
                                    top_logprobs=3, **sp)))
    eng._admit()
    eng._room.fill_(60)

    def state():
        return [eng._srow, eng.kv_pages, eng._last, eng._clens, eng._active,
                eng._st.token_counts, eng._hist_buf, eng._room]

    n0 = mq_paged_attention.launches
    eng._graphs.run("spec", want_lp, sample)   # capture, then a replay
    snap = [t.clone() for t in state()]

    def restore():
        for t, v in zip(state(), snap):
            t.copy_(v)
        for b, g in enumerate(eng._gens):
            g.manual_seed(1000 + b)

    restore()
    eng._spec_cycle(want_lp, sample)
    eager = [t.clone() for t in state()]
    restore()
    n1 = mq_paged_attention.launches
    eng._graphs.run("spec", want_lp, sample)   # a replay
    torch.cuda.synchronize()
    L = eng.cfg.model.num_layers
    assert mq_paged_attention.launches == n1 + L
    assert n1 - n0 == 3 * L                    # warm-up, replay, eager
    assert eng._graphs.captures == 1
    for name, a, b in zip(["row", "kv_pages", "last", "clens", "active",
                           "token_counts", "hist", "room"], eager, state()):
        assert torch.equal(a.view(torch.uint8) if a.is_floating_point()
                           else a, b.view(torch.uint8)
                           if b.is_floating_point() else b), name
    assert (eager[3] > snap[3]).all()          # every slot emitted


def test_capture_failure_raises(dev):
    def step(want_lp, sample):
        # A host fetch inside the step: legal when run, illegal in capture.
        (torch.ones(1, device=dev) + 1).cpu()

    graphs = DecodeGraphs(step, [], [], dev)
    with pytest.raises(RuntimeError):
        graphs.run(False, False)
    assert graphs.captures == 0


def test_capture_failure_reaches_the_requests(dev):
    eng = _engine(dev)

    def bad_step(want_lp, sample):
        eng._decode_step(want_lp, sample)
        eng._clens.cpu()

    eng._graphs._step = bad_step
    done = threading.Event()
    outs = []

    def on_output(out):
        outs.append(out)
        if out.finished:
            done.set()

    eng.start()
    try:
        eng.submit(EngineRequest("x", token_ids=list(range(10, 30)),
                                 sampling=SamplingParams(max_tokens=20,
                                                         temperature=0.0),
                                 on_output=on_output))
        assert done.wait(120)
    finally:
        eng.stop()
    assert not outs[-1].status.ok()
    assert "engine failure" in outs[-1].status.message


def test_a_step_captured_before_an_image_request_uses_its_delta(dev):
    """A qwen2_vl engine captures its step while a text request runs; the
    image request after it replays that graph and must give the tokens of
    an engine whose first capture came with the image (the delta is read
    from its fixed buffer, not baked into the graph)."""
    from xllm_service_tpu_torch.models import qwen2_vl

    mcfg = qwen2_vl.tiny_vl_config(image_token_id=100)
    params = qwen2_vl.init_params(
        mcfg, torch.Generator(device=dev).manual_seed(0), dev)
    cfg = EngineConfig(model=mcfg, model_family="qwen2_vl", num_pages=96,
                       page_size=16, hash_block_size=32, max_batch_size=B,
                       max_seq_len=256, decode_horizon=4, seed=0)
    prompt = [5, 6] + [100] * 4 + list(range(40, 60)) + [100] * 4 + [7, 8]
    rows = torch.randn((8, mcfg.hidden_size),
                       generator=torch.Generator().manual_seed(7))

    def run(eng, reqs):
        out = []
        for name, toks, mm in reqs:
            done = threading.Event()
            got = []

            def cb(o, got=got, done=done):
                got.extend(t for s in o.outputs for t in s.token_ids)
                if o.finished:
                    done.set()
            eng.submit(EngineRequest(name, token_ids=toks, mm_embeds=mm,
                                     sampling=SamplingParams(
                                         max_tokens=12, temperature=0.0,
                                         ignore_eos=True), on_output=cb))
            assert done.wait(120)
            out.append(got)
        return out

    warm = InferenceEngine(cfg, device=dev, params=params).start()
    cold = InferenceEngine(cfg, device=dev, params=params).start()
    try:
        got = run(warm, [("t", list(range(50, 80)), None),
                         ("i", prompt, rows)])
        captures = warm.stats()["decode_graph"]["captures"]
        want = run(cold, [("i", prompt, rows)])
    finally:
        warm.stop()
        cold.stop()
    assert captures == 1 and got[1] == want[0]
