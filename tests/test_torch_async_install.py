"""The port's asynchronous install against the reference engine's, on the
CPU (tests/test_engine.py's ``TestBurstAdmission`` and the failure cases
of ``TestEngineResilience`` that concern admission).

An admission pass dispatches a burst of installs and waits once for all
of them. The waits are counted by wrapping the engine's one wait,
``_sync``, in the test (the engine keeps no such count). Identical prompts
in one burst still share prefix pages; a device failure in the burst fails
every entry still queued and leaks no slot or page; tokens, logprobs and
the TTFT spans come out as the reference's.
"""

import threading

import pytest

from test_torch_chunked_prefill import (  # noqa: F401
    CONTEXT,
    Collector,
    both,
    make_engine,
    step_until,
    weights,
)
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import EngineRequest

LP_TOL = 1e-4


def count_waits(eng, monkeypatch, fail_at=None):
    """Wrap ``eng._sync``: returns the list of waits (one entry per call);
    the call numbered ``fail_at`` raises as a device fault would."""
    calls = []
    real = eng._sync

    def wait(ready):
        calls.append(ready)
        if fail_at is not None and len(calls) == fail_at:
            raise RuntimeError("device fault during the burst")
        real(ready)

    monkeypatch.setattr(eng, "_sync", wait)
    return calls


def test_same_burst_identical_prompts_share_prefix_cache(weights):  # noqa: F811
    """Two identical prompts popped in one admission pass dedupe through
    the prefix cache (the n > 1 fan-out relies on it), so the burst is
    completed before the second matches."""
    prompt = list(range(10, 10 + 64))          # 2 hash blocks of 32

    def scenario(eng, submit):
        free0 = eng.page_mgr.num_free
        cols = [submit(f"burst-{i}", prompt, 4) for i in range(2)]
        eng.start()                            # both pop in one pass
        for c in cols:
            assert c.done.wait(60)
        eng.stop()
        assert cols[0].tokens == cols[1].tokens
        # Fewer pages than two unshared prefills (4 prompt pages, then one
        # page of decode growth each).
        used = free0 - eng.page_mgr.num_free
        assert used <= 4 + 2 * 1 + 1, used
        return [c.tokens for c in cols], used

    ref, port = both(weights, scenario)
    assert port == ref


def test_a_burst_of_distinct_prompts_waits_once(weights, monkeypatch):  # noqa: F811
    eng = make_engine(weights, ref=False)
    waits = count_waits(eng, monkeypatch)
    cols = [Collector() for _ in range(4)]
    for i, col in enumerate(cols):
        eng.submit(EngineRequest(
            f"d{i}", token_ids=list(range(40 * i + 1, 40 * i + 30 + i)),
            sampling=SamplingParams(max_tokens=3, temperature=0.0,
                                    ignore_eos=True), on_output=col))
    assert eng._admit()
    assert len(waits) == 1
    assert all(len(c.tokens) == 1 for c in cols)
    assert len(eng._running) == 4
    step_until(eng, cols)

    def scenario(ref_eng, submit):
        rcols = [submit(f"d{i}", range(40 * i + 1, 40 * i + 30 + i), 3)
                 for i in range(4)]
        step_until(ref_eng, rcols)
        return [c.tokens for c in rcols]

    assert [c.tokens for c in cols] == both(weights, scenario)[0]


def test_a_shared_first_block_completes_the_burst_first(weights,  # noqa: F811
                                                         monkeypatch):
    """Three prompts, the third sharing the first's first hash block: the
    pass waits twice (before the third, and at its end), and the third
    reuses the first's donated block."""
    eng = make_engine(weights, ref=False)
    waits = count_waits(eng, monkeypatch)
    head = list(range(200, 232))
    prompts = [head + [5, 6, 7], list(range(60, 100)), head + [9, 8]]
    cols = [Collector() for _ in prompts]
    for i, (p, col) in enumerate(zip(prompts, cols)):
        eng.submit(EngineRequest(
            f"h{i}", token_ids=p,
            sampling=SamplingParams(max_tokens=2, temperature=0.0,
                                    ignore_eos=True), on_output=col))
    eng._admit()
    assert len(waits) == 2
    assert eng.prefix_hits == 1 and eng.prefix_hit_tokens == 32
    step_until(eng, cols)


def test_device_failure_mid_burst_fails_every_entry(weights, monkeypatch):  # noqa: F811
    """The burst's one wait raises: every dispatched entry gets exactly
    one failure, no slot or page leaks, and the engine serves afterwards."""
    eng = make_engine(weights, ref=False)
    count_waits(eng, monkeypatch, fail_at=1)
    failed = threading.Event()
    fail_all = eng._fail_all

    def recorded_fail_all(message):
        fail_all(message)
        failed.set()

    monkeypatch.setattr(eng, "_fail_all", recorded_fail_all)
    free0 = eng.page_mgr.num_free
    cols = [Collector() for _ in range(3)]
    for i, col in enumerate(cols):
        eng.submit(EngineRequest(
            f"f{i}", token_ids=list(range(50 * i + 3, 50 * i + 40)),
            sampling=SamplingParams(max_tokens=4, temperature=0.0,
                                    ignore_eos=True), on_output=col))
    eng.start()
    try:
        # The loop's _fail_all runs after the entries' callbacks.
        assert failed.wait(30)
        for c in cols:
            assert c.done.is_set()
            assert len(c.outputs) == 1 and not c.outputs[0].status.ok()
            assert "prefill failure" in c.outputs[0].status.message
        assert len(eng._free_slots) == eng.cfg.max_batch_size
        assert eng.page_mgr.num_free == free0
        assert not eng._running and not eng._waiting
        after = Collector()
        eng.submit(EngineRequest(
            "after", token_ids=list(range(7, 27)),
            sampling=SamplingParams(max_tokens=3, temperature=0.0,
                                    ignore_eos=True), on_output=after))
        assert after.done.wait(30)
        assert len(after.tokens) == 3, after.outputs[-1].status.message
        assert after.finish_reason == "length"
    finally:
        eng.stop()


def test_install_failure_with_a_full_prefill_set_fails_deferred_entries(
        weights, monkeypatch):  # noqa: F811
    """A long prompt deferred because the prefill set is full, then an
    install dispatch that raises in the same pass: the deferred request
    still gets its failure (it goes back to the queue, which the loop's
    _fail_all answers), and no slot or page leaks."""
    eng = make_engine(weights, ref=False, prefill_chunk_tokens=32,
                      max_concurrent_prefills=1)
    free0 = eng.page_mgr.num_free
    cols = {name: Collector() for name in ("long0", "long1", "short")}
    prompts = {"long0": list(range(3, 203)), "long1": list(range(5, 205)),
               "short": list(range(7, 37))}

    def submit(name):
        eng.submit(EngineRequest(
            name, token_ids=prompts[name],
            sampling=SamplingParams(max_tokens=4, temperature=0.0,
                                    ignore_eos=True), on_output=cols[name]))

    submit("long0")
    eng._admit()
    assert len(eng._prefillings) == 1
    failed = threading.Event()
    fail_all = eng._fail_all

    def recorded_fail_all(message):
        fail_all(message)
        failed.set()

    def broken_dispatch(*args):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(eng, "_fail_all", recorded_fail_all)
    monkeypatch.setattr(eng, "_dispatch_prefill_install", broken_dispatch)
    submit("long1")                     # deferred: the prefill set is full
    submit("short")                     # its install dispatch raises
    eng.start()
    try:
        assert failed.wait(30)
        for name, c in cols.items():
            assert c.done.is_set(), name
            assert len(c.outputs) == 1 and not c.outputs[0].status.ok()
        assert "prefill failure" in cols["short"].outputs[0].status.message
        assert len(eng._free_slots) == eng.cfg.max_batch_size
        assert eng.page_mgr.num_free == free0
        assert not (eng._running or eng._waiting or eng._prefillings)
    finally:
        eng.stop()


@pytest.mark.parametrize("horizon", [1, 4])
def test_burst_behind_a_pending_horizon(weights, horizon):  # noqa: F811
    """A burst admitted while a horizon is in flight: the new slots' rows
    of that horizon are dropped at its drain, and every stream equals the
    reference's."""
    def scenario(eng, submit):
        first = submit("a", range(1, 21), 24)
        eng.step()
        eng.step()
        late = [submit(f"b{i}", range(30 + 9 * i, 60 + 9 * i), 6)
                for i in range(3)]
        step_until(eng, [first] + late)
        return [c.tokens for c in [first] + late]

    ref, port = both(weights, scenario, decode_horizon=horizon)
    assert port == ref


def test_logprobs_and_sampling_through_a_burst(weights):  # noqa: F811
    """A logprob request and a penalised one in one burst with plain
    ones: each slot's pack and controls are its own."""
    def scenario(eng, submit):
        cols = [
            submit("p0", range(3, 40), 4),
            submit("lp", range(40, 77), 4,
                   sampling=dict(temperature=0.0, ignore_eos=True,
                                 logprobs=True, top_logprobs=3)),
            submit("pen", range(80, 117), 4,
                   sampling=dict(temperature=0.0, ignore_eos=True,
                                 frequency_penalty=1.5,
                                 logit_bias={7: 3.0})),
            submit("p3", range(120, 157), 4),
        ]
        step_until(eng, cols)
        lps = [(lp.token_id, lp.logprob,
                [(t.token_id, t.logprob) for t in lp.top_logprobs])
               for o in cols[1].outputs for s in o.outputs
               for lp in s.logprobs]
        return [c.tokens for c in cols], lps

    ref, port = both(weights, scenario)
    assert port[0] == ref[0]
    assert len(port[1]) == len(ref[1]) == 4
    for (gt, glp, gtop), (wt, wlp, wtop) in zip(port[1], ref[1]):
        assert gt == wt and abs(glp - wlp) <= LP_TOL
        assert [t for t, _ in gtop] == [t for t, _ in wtop]
        for (_, g), (_, w) in zip(gtop, wtop):
            assert abs(g - w) <= LP_TOL


def test_ttft_spans_are_recorded(weights):  # noqa: F811
    """submit() stamps t_submit, and every completed install adds a span
    (queue wait, prefill, prompt length), chunked installs included."""
    def scenario(eng, submit):
        cols = [submit("s0", range(3, 23), 2), submit("s1", range(5, 105), 2)]
        step_until(eng, cols)
        spans = list(eng.span_samples)
        assert [s["prompt_len"] for s in spans] == [20.0, 100.0]
        assert all(s["queue_ms"] >= 0 and s["prefill_ms"] >= 0
                   for s in spans)
        return len(spans)

    ref, port = both(weights, scenario, prefill_chunk_tokens=32)
    assert port == ref == 2


def test_continuation_past_max_seq_len_is_cancelled(weights):  # noqa: F811
    """A continuation whose prompt plus emitted tokens reach max_seq_len
    is cancelled at admission, as the reference's."""
    def scenario(eng, submit):
        col = submit("long", range(1, CONTEXT // 2 - 4), 4,
                     resume_output_ids=list(range(8)))
        eng.step()
        assert col.done.is_set() and not col.outputs[-1].status.ok()
        return len(col.outputs)

    ref, port = both(weights, scenario)
    assert port == ref == 1


def test_kernel_operands_are_aligned(weights, monkeypatch):  # noqa: F811
    """The page row and lengths an install or a chunk hands to the prefill
    are contiguous and 16-byte aligned, as kernel 2 requires on the card
    (a packed upload slices them out of one buffer)."""
    eng = make_engine(weights, ref=False, prefill_chunk_tokens=32)
    seen = []
    forward = eng.family.prefill_forward

    def checked(params, mcfg, tokens, positions, kv, pt, prefix, lens,
                **kw):
        for t in (pt, prefix, lens):
            seen.append(t.is_contiguous() and t.data_ptr() % 16 == 0)
        return forward(params, mcfg, tokens, positions, kv, pt, prefix,
                       lens, **kw)

    monkeypatch.setattr(eng.family, "prefill_forward", checked)
    cols = [Collector() for _ in range(3)]
    for i, (n, col) in enumerate(zip((7, 45, 101), cols)):
        eng.submit(EngineRequest(
            f"a{i}", token_ids=list(range(3, 3 + n)),
            sampling=SamplingParams(max_tokens=2, temperature=0.0,
                                    ignore_eos=True), on_output=col))
    step_until(eng, cols)
    assert len(seen) >= 9 and all(seen)
