"""Online/offline hybrid scheduling in the port against the reference
engine's, on the CPU (the scenarios of tests/test_hybrid_scheduling.py):
online requests admit before offline ones, and an online request that
finds no pages preempts a running offline one, which resumes losslessly.

Each scenario runs on the JAX engine and on the port with the same tiny
f32 weights and steps (``both`` of test_torch_chunked_prefill.py); tokens,
finish order and the preemption count must be identical, and the port
must return every slot and page.
"""

import pytest

from test_torch_chunked_prefill import both, step_until, weights  # noqa: F401


def tight(num_pages=24, max_batch=2, **kw):
    """tests/test_hybrid_scheduling.py's tight_engine: scarce pages."""
    return dict(num_pages=num_pages, page_size=16, hash_block_size=32,
                max_batch_size=max_batch, max_seq_len=128, **kw)


def test_online_admitted_before_offline(weights):  # noqa: F811
    def scenario(eng, submit):
        # Two offline queued first, then an online one, on one slot.
        cols = {name: submit(name, range(lo, lo + 10), 2, offline=offline)
                for name, lo, offline in (("off1", 0, True),
                                          ("off2", 10, True),
                                          ("on1", 20, False))}
        step_until(eng, list(cols.values()))
        order = sorted(cols, key=lambda n: cols[n].finished_at)
        # off1 was already running; the online request jumps ahead of off2.
        assert order.index("on1") < order.index("off2")
        return order, {n: c.tokens for n, c in cols.items()}

    ref, port = both(weights, scenario, **tight(num_pages=64, max_batch=1))
    assert port == ref


def held_pages(eng) -> int:
    """Pages the prefix cache holds (out of the free list, evictable)."""
    return eng.page_mgr.cached_block_count() * (
        eng.cfg.hash_block_size // eng.cfg.page_size)


@pytest.mark.parametrize("horizon", [1, 4])
def test_preemption_resumes_losslessly(weights, horizon):  # noqa: F811
    """6 usable pages. The offline request reserves 3 (30 prompt + 12 new
    = 42 tokens); the online one needs 4 (60 prompt + 4 new) and must
    preempt it. The offline stream equals an uninterrupted run's (no
    token repeated or lost), on the port as on the reference. With a
    horizon of 4 the victim has rows in the pending horizon when it is
    preempted: they are dropped and decoded again."""
    off_prompt, on_prompt = range(30, 60), range(100, 160)

    def uninterrupted(eng, submit):
        off = submit("off", off_prompt, 12, offline=True)
        on = submit("on", on_prompt, 4)
        step_until(eng, [off, on])
        return off.tokens, on.tokens

    def scenario(eng, submit):
        free0 = eng.page_mgr.num_free
        off = submit("off", off_prompt, 12, offline=True)
        for _ in range(4 if horizon == 1 else 2):
            eng.step()
        assert 2 <= len(off.tokens) < 12
        on = submit("on", on_prompt, 4)
        step_until(eng, [off, on])
        assert off.finish_reason == "length"
        assert eng.preemption_count >= 1
        assert eng.stats()["running"] == 0
        assert eng.page_mgr.num_free + held_pages(eng) == free0
        assert len(eng._free_slots) == eng.cfg.max_batch_size
        return off.tokens, on.tokens, eng.preemption_count

    ref, port = both(weights, scenario,
                     **tight(num_pages=7, decode_horizon=horizon))
    assert port == ref
    # Against a run with room for both (no preemption) on the port.
    plain = both(weights, uninterrupted,
                 **tight(num_pages=64, decode_horizon=horizon))[1]
    assert port[:2] == plain


def test_preempted_slot_leaves_the_device_batch(weights):  # noqa: F811
    """The victim's slot is inactive on the device, its page-table row on
    the garbage page, from the preemption on (the port's device state;
    the reference clears the same slot with its clear_slot program)."""
    def scenario(eng, submit):
        off = submit("off", range(30, 60), 12, offline=True)
        for _ in range(3):
            eng.step()
        submit("on", range(100, 160), 4)
        eng._admit()
        assert eng.preemption_count == 1
        assert [s.req.service_request_id for s in eng._running.values()] \
            == ["on"]
        if hasattr(eng, "_active"):          # the port
            for s in set(range(eng.cfg.max_batch_size)) - set(eng._running):
                assert not bool(eng._active[s])
                assert (eng._pt[s] == 0).all()
        return off.tokens

    ref, port = both(weights, scenario, **tight(num_pages=7))
    assert port == ref
