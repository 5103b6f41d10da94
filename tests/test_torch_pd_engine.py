"""PD disaggregation in the port's engine against the reference engine's,
on the CPU: the prefill-only request and its handoff, the extract of the
prompt's pages, and the decode side's injected install.

Both engines get the same tiny f32 weights (``llama_params_from_jax``) and
tests/test_engine.py's configuration. The port's handoff must carry the
reference's first token and a KV blob within KV_TOL of the reference's
``extract_kv_pages``; the port's decode engine, fed the reference's blob,
must give greedy tokens identical to the reference's PD pair and to a MIX
run, with the installed pages within KV_TOL of the reference decode
engine's. The port's seeded sampled streams come from per-slot generators,
not the reference's keys, so a sampled PD stream is held against the
port's own MIX stream.

KV_TOL: the two engines' f32 K and V differ only in summation order:
about 1e-6 of values up to 4 for a whole install, growing to 1.25e-5
behind three chunks of 32 (the chunks attend through different kernels'
plain versions).
"""

import numpy as np
import pytest
import torch

from test_torch_chunked_prefill import (  # noqa: F401
    Collector,
    make_engine,
    step_until,
    weights,
)
from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import EngineConfig, EngineRequest
from xllm_service_tpu_torch.engine.engine import InferenceEngine
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

KV_TOL = 5e-5
GREEDY = dict(temperature=0.0, ignore_eos=True)
PROMPT = [(i * 7 + 3) % 400 + 5 for i in range(45)]
LONG = list(range(3, 120))          # 117 tokens: 3 chunks of 32 + final


def _classes(ref):
    return (RefRequest, RefSampling) if ref else (EngineRequest,
                                                  SamplingParams)


def prefill(weights, ref, prompt, max_tokens=6, sampling=None, before=(),
            **kw):  # noqa: F811
    """Run ``prompt`` as a prefill-only request (after serving ``before``
    whole, for a prefix-cache hit) on the reference (``ref``) or the port;
    returns (the handoff, the engine's stats)."""
    req_cls, sp_cls = _classes(ref)
    eng = make_engine(weights, ref, **kw)
    got = []
    try:
        for i, p in enumerate(before):
            col = Collector()
            eng.submit(req_cls(f"w{i}", token_ids=list(p),
                               sampling=sp_cls(max_tokens=2, **GREEDY),
                               on_output=col))
            step_until(eng, [col])
        col = Collector()
        eng.submit(req_cls("p", token_ids=list(prompt),
                           sampling=sp_cls(max_tokens=max_tokens,
                                           **(sampling or GREEDY)),
                           prefill_only=True, on_prefill_done=got.append,
                           on_output=col))
        for _ in range(50):
            if got:
                break
            eng.step()
        assert len(got) == 1 and not col.outputs, "no handoff, or it emitted"
        assert not eng._running and \
            len(eng._free_slots) == eng.cfg.max_batch_size
        return got[0], eng.stats()
    finally:
        eng.stop()


def blob_np(h):
    b = h.kv_blob
    return b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)


def decode(weights, ref, h, blob, probe=None, **kw):  # noqa: F811
    """Inject the handoff ``h`` with KV ``blob`` (numpy) into a fresh
    decode engine; ``probe(engine)`` runs right after the install. Returns
    (tokens, the probe's result, the first output)."""
    req_cls, sp_cls = _classes(ref)
    eng = make_engine(weights, ref, **kw)
    sp = h.sampling if isinstance(h.sampling, sp_cls) else \
        sp_cls.from_dict(h.sampling.to_dict())
    kv = blob if ref else torch.from_numpy(np.ascontiguousarray(blob))
    col = Collector()
    try:
        eng.submit(req_cls("p", token_ids=list(h.token_ids), sampling=sp,
                           injected_first_token=int(h.first_token),
                           injected_kv=kv,
                           injected_first_logprob=h.first_logprob,
                           on_output=col))
        eng._admit()
        seen = probe(eng) if probe is not None else None
        step_until(eng, [col])
        return col.tokens, seen, col.outputs[0]
    finally:
        eng.stop()


def mix(weights, ref, prompt, max_tokens=6, sampling=None,
        **kw):  # noqa: F811
    req_cls, sp_cls = _classes(ref)
    eng = make_engine(weights, ref, **kw)
    col = Collector()
    try:
        eng.submit(req_cls("m", token_ids=list(prompt),
                           sampling=sp_cls(max_tokens=max_tokens,
                                           **(sampling or GREEDY)),
                           on_output=col))
        step_until(eng, [col])
        return col.tokens
    finally:
        eng.stop()


def prompt_kv(eng, ref, n_tokens):
    """The running sequence's first ``n_tokens`` K/V rows [L, 2, T, n_kv,
    hd], read out of the engine's pool by its ``extract_kv_pages``."""
    (seq,) = eng._running.values()
    rows = np.asarray(eng.extract_kv_pages(seq.pages.all_pages))
    L, _, n, kv, ps, hd = rows.shape
    rows = rows.transpose(0, 1, 2, 4, 3, 5).reshape(L, 2, n * ps, kv, hd)
    return rows[:, :, :n_tokens]


def test_prefill_handoff_matches_reference(weights):  # noqa: F811
    ref, _ = prefill(weights, True, PROMPT)
    port, stats = prefill(weights, False, PROMPT)
    assert port.first_token == ref.first_token
    assert port.token_ids == PROMPT and port.first_logprob is None
    a, b = blob_np(port), blob_np(ref)
    assert a.shape == b.shape == (2, 2, 3, 2, 16, 32)
    assert np.abs(a - b).max() <= KV_TOL
    # The prompt's whole blocks stay in the prefill side's prefix cache.
    assert stats["cached_blocks"] == len(PROMPT) // 32


def test_injected_reference_blob_matches_pd_pair_and_mix(weights):  # noqa: F811
    h, _ = prefill(weights, True, PROMPT)
    want = mix(weights, False, PROMPT)
    assert want == mix(weights, True, PROMPT)
    n = len(PROMPT)
    ref_toks, ref_kv, _ = decode(weights, True, h, blob_np(h),
                                 probe=lambda e: prompt_kv(e, True, n))
    port_toks, port_kv, first = decode(weights, False, h, blob_np(h),
                                       probe=lambda e: prompt_kv(e, False, n))
    assert port_toks == ref_toks == want
    assert first.outputs[0].token_ids == [h.first_token]
    assert np.abs(port_kv - ref_kv).max() <= KV_TOL


def test_port_pair_matches_mix_and_logprobs(weights):  # noqa: F811
    lp = dict(temperature=0.0, logprobs=True, top_logprobs=3,
              ignore_eos=True)
    h, _ = prefill(weights, False, PROMPT, sampling=lp)
    assert h.first_logprob is not None and \
        h.first_logprob.token_id == h.first_token
    toks, _, first = decode(weights, False, h, blob_np(h))
    assert toks == mix(weights, False, PROMPT, sampling=lp)
    assert first.outputs[0].logprobs[0].logprob == h.first_logprob.logprob


@pytest.mark.parametrize("case", ["cache_matched", "chunked"])
def test_prefill_side_cache_hit_and_chunks(weights, case):  # noqa: F811
    if case == "cache_matched":
        prompt, kw = PROMPT + [9, 8, 7], dict(before=[PROMPT])
    else:
        prompt, kw = LONG, dict(prefill_chunk_tokens=32)
    hr, _ = prefill(weights, True, prompt, **kw)
    hp, stats = prefill(weights, False, prompt, **kw)
    if case == "cache_matched":
        assert stats["prefix_hits"] == 1
    assert hp.first_token == hr.first_token
    assert np.abs(blob_np(hp) - blob_np(hr)).max() <= KV_TOL
    toks, _, _ = decode(weights, False, hp, blob_np(hp))
    assert toks == mix(weights, False, prompt) == \
        decode(weights, True, hr, blob_np(hr))[0]


def test_penalty_histogram_row(weights):  # noqa: F811
    pen = dict(temperature=0.0, frequency_penalty=0.7, presence_penalty=0.3,
               ignore_eos=True)
    h, _ = prefill(weights, True, PROMPT, sampling=pen, max_tokens=8)

    def counts(ref):
        def probe(e):
            (seq,) = e._running.values()
            c = e._dstate["counts"] if ref else e._st.token_counts
            return np.array(c[seq.slot])          # a copy
        return probe

    ref_toks, ref_row, _ = decode(weights, True, h, blob_np(h),
                                  probe=counts(True))
    toks, row, _ = decode(weights, False, h, blob_np(h), probe=counts(False))
    want = np.bincount(PROMPT + [h.first_token], minlength=row.size)
    assert (row == ref_row).all() and (row == want).all()
    assert toks == ref_toks == mix(weights, False, PROMPT, max_tokens=8,
                                   sampling=pen)
    # Without a penalty the row is zeros.
    h.sampling.frequency_penalty = h.sampling.presence_penalty = 0.0
    _, row0, _ = decode(weights, False, h, blob_np(h), probe=counts(False))
    assert not row0.any()


def test_speculation_after_inject(weights):  # noqa: F811
    rep = [5, 6, 7, 8] * 10
    h, _ = prefill(weights, True, rep, max_tokens=32)

    def hist(ref):
        def probe(e):
            (seq,) = e._running.values()
            d = e._dstate if ref else {"hist": e._hist, "hist_lo": e._hist_lo}
            return (np.array(d["hist"][seq.slot]),
                    int(np.asarray(d["hist_lo"][seq.slot])))
        return probe

    spec = dict(speculate_k=4, num_pages=128, max_batch_size=2,
                max_seq_len=512)
    ref_toks, (ref_row, ref_lo), _ = decode(
        weights, True, h, blob_np(h), probe=hist(True), **spec)
    toks, (row, lo), _ = decode(weights, False, h, blob_np(h),
                                probe=hist(False), **spec)
    assert lo == ref_lo == len(rep)
    assert (row == ref_row).all() and row[len(rep)] == h.first_token
    assert len(toks) == 32
    assert toks == ref_toks == mix(weights, False, rep, max_tokens=32, **spec)


def test_seeded_sampled_pd_equals_mix(weights):  # noqa: F811
    samp = dict(temperature=0.8, top_p=0.9, seed=1234, ignore_eos=True)
    h, _ = prefill(weights, False, PROMPT, sampling=samp, max_tokens=12)
    toks, _, _ = decode(weights, False, h, blob_np(h))
    assert len(toks) == 12
    assert toks == mix(weights, False, PROMPT, max_tokens=12, sampling=samp)


def test_decode_side_stored_events(weights):  # noqa: F811
    h, _ = prefill(weights, True, PROMPT)

    def stored(e):
        return list(e.drain_kv_events().stored)

    _, ref_ev, _ = decode(weights, True, h, blob_np(h), probe=stored)
    _, ev, _ = decode(weights, False, h, blob_np(h), probe=stored)
    assert ev == [k.hex() if isinstance(k, bytes) else k for k in ref_ev]
    assert len(ev) == len(PROMPT) // 32


def test_bad_blob_fails_only_its_request(weights):  # noqa: F811
    h, _ = prefill(weights, False, PROMPT)
    eng = make_engine(weights, False)
    bad, good = Collector(), Collector()
    try:
        eng.submit(EngineRequest("bad", token_ids=list(PROMPT),
                                 sampling=h.sampling, injected_first_token=1,
                                 injected_kv=h.kv_blob[:, :, :1],
                                 on_output=bad))
        eng.submit(EngineRequest("good", token_ids=list(PROMPT),
                                 sampling=h.sampling,
                                 injected_first_token=h.first_token,
                                 injected_kv=h.kv_blob, on_output=good))
        step_until(eng, [bad, good])
        assert not bad.outputs[-1].status.ok() and not bad.tokens
        assert good.tokens == mix(weights, False, PROMPT)
        assert len(eng._free_slots) == eng.cfg.max_batch_size
    finally:
        eng.stop()


def test_pd_on_a_seq_mesh(weights):  # noqa: F811
    """Both sides on a seq=2 mesh (two CPU shards of eight pages each; the
    prompt's pages 1-8 lie on both): the movers take the sharded pool
    whole."""
    def engine():
        cfg = EngineConfig(model=tiny_config(dtype=torch.float32,
                                             max_context_len=512),
                           num_pages=16, page_size=16, hash_block_size=32,
                           max_batch_size=4, max_seq_len=256)
        return InferenceEngine(cfg, params=weights[1], mesh=build_mesh(
            MeshConfig(seq=2), ["cpu", "cpu"]))

    got = []
    pre = engine()
    pre.submit(EngineRequest("p", token_ids=list(LONG),
                             sampling=SamplingParams(max_tokens=6, **GREEDY),
                             prefill_only=True, on_prefill_done=got.append))
    for _ in range(20):
        if got:
            break
        pre.step()
    pre.stop()
    (h,) = got
    hr, _ = prefill(weights, True, LONG)
    assert h.first_token == hr.first_token
    assert np.abs(blob_np(h) - blob_np(hr)).max() <= KV_TOL
    dec, col = engine(), Collector()
    try:
        dec.submit(EngineRequest("p", token_ids=list(LONG),
                                 sampling=h.sampling,
                                 injected_first_token=h.first_token,
                                 injected_kv=h.kv_blob, on_output=col))
        step_until(dec, [col])
    finally:
        dec.stop()
    assert col.tokens == mix(weights, False, LONG) == \
        decode(weights, True, hr, blob_np(hr))[0]


@pytest.mark.cuda
def test_device_blob_on_the_card():
    """On a card: the prefill side's handoff carries a device blob (kernel
    4) and an event; injected as it is (no host trip) into a second engine
    (kernel 5), the greedy stream equals a MIX engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    from xllm_service_tpu_torch.ops import page_dma

    def engine():
        mcfg = tiny_config(vocab_size=1024, hidden_size=256, num_heads=4,
                           num_kv_heads=2, head_dim=64, ffn_size=512)
        return InferenceEngine(EngineConfig(
            model=mcfg, num_pages=64, page_size=16, hash_block_size=32,
            max_batch_size=4, max_seq_len=256, decode_horizon=4), device="cuda")

    sp = dict(max_tokens=12, **GREEDY)
    got = []
    pre = engine()
    g0 = page_dma.gather_kv_pages.launches
    pre.submit(EngineRequest("p", token_ids=list(LONG),
                             sampling=SamplingParams(**sp),
                             prefill_only=True, on_prefill_done=got.append))
    for _ in range(20):
        if got:
            break
        pre.step()
    (h,) = got
    assert h.kv_blob.is_cuda and h.kv_ready is not None
    assert page_dma.gather_kv_pages.launches == g0 + 1
    h.kv_ready.synchronize()
    outs = []
    for blob in (h.kv_blob, h.kv_blob.cpu()):
        dec, col = engine(), Collector()
        s0 = page_dma.scatter_kv_pages.launches
        dec.submit(EngineRequest("p", token_ids=list(LONG),
                                 sampling=SamplingParams(**sp),
                                 injected_first_token=h.first_token,
                                 injected_kv=blob, on_output=col))
        step_until(dec, [col])
        dec.stop()
        assert page_dma.scatter_kv_pages.launches == s0 + 1
        outs.append(col.tokens)
    mix, col = engine(), Collector()
    mix.submit(EngineRequest("m", token_ids=list(LONG),
                             sampling=SamplingParams(**sp), on_output=col))
    step_until(mix, [col])
    mix.stop()
    pre.stop()
    assert outs[0] == outs[1] == col.tokens and len(col.tokens) == 12
