"""The port's Sarathi mixed step against the reference's, on the CPU.

The engine half mirrors tests/test_sarathi.py: while a long prompt
chunk-prefills, its chunks ride the running decodes' steps; the tokens
must equal the JAX engine's on the same weights and steps (and the
unchunked port's), the ride must engage, ``XLLM_SARATHI=0`` must turn it
off, a ride never takes the final chunk, queue pressure rides four chunks
at once, and a ride's sequence can be cancelled without a leak; a Gemma-2
engine (score softcap, sliding window and query scale on every layer)
rides too, with the JAX engine's tokens.

The forward half mirrors tests/test_mixed_decode_chunk.py: the port's
``mixed_decode_chunk_forward`` against the JAX one on the same weights and
pool, decode-row logits and the whole KV pool within 1e-5 (f32), for
llama and, with drawn biases and norm scales, qwen2 and Gemma-2; and the
empty chunk as a pure decode step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu_torch.models import base, llama
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops.attention import dense_prefill_attention
from xllm_service_tpu_torch.ops.mq_paged_attention import (
    mq_paged_attention_plain,
)

from test_torch_chunked_prefill import both, step_until, weights  # noqa: F401
from test_torch_gemma import check_mixed, drawn_tree, make_models, serve_both

# tests/test_sarathi.py's make_engine.
SARATHI_KW = dict(num_pages=96, max_seq_len=512)
TOL = dict(rtol=1e-5, atol=1e-5)


def drive(eng, submit):
    """A short decode running, then a long prompt chunk-prefills: its
    chunks should ride decode steps. Returns (short, long, rides)."""
    short = submit("short", range(11, 21), 40)
    eng.step()                              # short admitted + decoding
    long_ = submit("long", range(5, 245), 4)   # 240 tokens
    rode = 0
    for _ in range(300):
        eng.step()
        rode += bool(eng._rode_chunk)
        if short.done.is_set() and long_.done.is_set():
            break
    assert short.done.is_set() and long_.done.is_set()
    return short.tokens, long_.tokens, rode


@pytest.fixture(scope="module")
def rides(weights):  # noqa: F811
    """drive() on the JAX engine and on the port, chunk 32, rides on."""
    return both(weights, drive, prefill_chunk_tokens=32, **SARATHI_KW)


def test_ride_engages_and_tokens_exact(weights, rides):  # noqa: F811
    ref, port = rides
    assert port[2] >= 2, "mixed decode+chunk path never engaged"
    assert port[2] == ref[2]
    assert port[:2] == ref[:2]
    plain = both(weights, drive, **SARATHI_KW)[1]
    assert plain[2] == 0 and port[:2] == plain[:2]


def test_kill_switch_disables_ride(weights, rides, monkeypatch):  # noqa: F811
    monkeypatch.setenv("XLLM_SARATHI", "0")
    ref, port = both(weights, drive, prefill_chunk_tokens=32, **SARATHI_KW)
    assert port[2] == ref[2] == 0
    assert len(port[0]) == 40 and len(port[1]) == 4
    assert port[:2] == ref[:2] == rides[1][:2]


def test_ride_respects_final_chunk_boundary(weights):  # noqa: F811
    """A ride consumes at most one chunk and never the final one, which
    goes through the install (it samples the first token)."""
    def scenario(eng, submit):
        submit("warm", range(3, 13), 60)
        eng.step()
        submit("long", range(7, 107), 2)        # 100 tokens
        eng._admit()
        assert eng._prefillings
        st = eng._prefillings[0]
        C = eng.cfg.prefill_chunk_tokens
        seen = []
        while True:
            before = st["written"]
            ride = (eng._ride_chunk_args(eng.cfg.decode_horizon)
                    if hasattr(eng, "_decode_chunk_multi")
                    else eng._ride_chunk_args())
            if ride is None:
                break
            seen.append(st["written"] - before)
            assert st["written"] - before <= C
            assert len(st["prompt"]) - st["written"] >= C
        assert seen
        # Exactly the final chunk is left.
        assert 0 < len(st["prompt"]) - st["written"] <= C
        return seen, st["written"]

    ref, port = both(weights, scenario, prefill_chunk_tokens=32,
                     **SARATHI_KW)
    assert port == ref


def test_pressure_rides_consume_four_chunk_spans(weights):  # noqa: F811
    """With arrivals waiting, a long prefill rides 4C per decode call
    instead of one chunk; the tokens are the reference's either way."""
    def scenario(eng, submit):
        warm = submit("warm", range(2, 12), 60)
        eng.step()
        cols = [submit(f"L{i}", range(7 + i, 207 + i), 3) for i in range(3)]
        big = 0
        for _ in range(400):
            if eng._prefillings:
                st = eng._prefillings[0]
                before = st["written"]
                eng.step()
                if (eng._rode_chunk and st["written"] - before
                        > eng.cfg.prefill_chunk_tokens):
                    big += 1
            else:
                eng.step()
            if all(c.done.is_set() for c in cols):
                break
        step_until(eng, cols + [warm])
        return [c.tokens for c in cols], warm.tokens, big

    ref, port = both(weights, scenario, prefill_chunk_tokens=16,
                     **SARATHI_KW)
    assert port[2] >= 1, "pressure span never engaged"
    assert port == ref


def test_n_fanout_and_cancel_under_ride(weights):  # noqa: F811
    """Cancelling a riding prefill returns its pages and slot; the decode
    it rode with keeps the reference's tokens."""
    def scenario(eng, submit):
        col = submit("k", range(4, 14), 50)
        eng.step()
        lcol = submit("lx", range(9, 250), 3)
        for _ in range(4):
            eng.step()
        assert eng._prefillings
        eng.cancel("lx")
        step_until(eng, [col])
        assert not eng._prefillings
        assert lcol.done.is_set() and not lcol.outputs[-1].status.ok()
        assert eng.page_mgr.num_free == eng.cfg.num_pages - 1
        assert len(eng._free_slots) == eng.cfg.max_batch_size
        return col.tokens

    ref, port = both(weights, scenario, prefill_chunk_tokens=32,
                     **SARATHI_KW)
    assert len(port) == 50 and port == ref


# ------------------------------------------------- the mixed forward alone
@pytest.fixture(scope="module")
def models():
    rcfg = ref_base.tiny_config(dtype=jnp.float32)
    tree = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                   device="cpu")
    cfg = base.tiny_config(dtype=torch.float32)
    pool = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1),
        (cfg.num_layers, 2, 32, cfg.num_kv_heads, 16, cfg.head_dim),
        jnp.float32)) * 0.1
    return rcfg, tree, cfg, params, pool


def _both_mixed(models, start, valid, c=16, dec_clens=(5, 20, 17),
                chunk_pages=(10, 11, 12, 13)):
    rcfg, tree, cfg, params, pool = models
    dec_pt = np.asarray([[1, 2], [3, 4], [5, 6]][:len(dec_clens)], np.int32)
    clens = np.asarray(dec_clens, np.int32)
    dec_tok = np.asarray([7, 8, 9][:len(dec_clens)], np.int32)
    chunk_pt = np.asarray([chunk_pages], np.int32)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, c).astype(
        np.int32)
    pos = start + np.arange(c, dtype=np.int32)
    want_logits, want_pool = jax.jit(
        ref_llama.mixed_decode_chunk_forward, static_argnums=1)(
        tree, rcfg, jnp.asarray(dec_tok), jnp.asarray(clens - 1),
        jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pool),
        jnp.asarray(dec_pt), jnp.asarray(chunk_pt), jnp.asarray(clens),
        jnp.asarray(start, jnp.int32), jnp.asarray(valid, jnp.int32))
    t = torch.from_numpy
    kv = t(pool.copy())
    got_logits, _ = llama.mixed_decode_chunk_forward(
        params, cfg, t(dec_tok), t(clens - 1), t(toks), t(pos), kv,
        t(dec_pt), t(chunk_pt), t(clens), torch.tensor(start,
                                                       dtype=torch.int32),
        torch.tensor(valid, dtype=torch.int32))
    return (np.asarray(want_logits), np.asarray(want_pool),
            got_logits.numpy(), kv.numpy())


@pytest.mark.parametrize("start,valid", [(24, 12), (0, 16), (16, 16),
                                         (40, 1)])
def test_mixed_step_matches_the_jax_one(models, start, valid):
    """Decode rows on pages 1..6, the chunk on pages 10..13 behind
    ``start`` written tokens, ``valid`` of its 16 rows live."""
    want_logits, want_pool, got_logits, got_pool = _both_mixed(
        models, start, valid)
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    np.testing.assert_allclose(got_pool, want_pool, **TOL)


def test_mixed_step_empty_chunk_is_pure_decode(models):
    rcfg, tree, cfg, params, pool = models
    t = torch.from_numpy
    dec_pt = t(np.asarray([[1, 2], [3, 4]], np.int32))
    clens = t(np.asarray([5, 9], np.int32))
    dec_tok = t(np.asarray([7, 8], np.int32))
    kv_dec = t(pool.copy())
    want, _ = llama.decode_forward(params, cfg, dec_tok, clens - 1, kv_dec,
                                   dec_pt, clens)
    kv_mix = t(pool.copy())
    got, _ = llama.mixed_decode_chunk_forward(
        params, cfg, dec_tok, clens - 1, torch.zeros(16, dtype=torch.int32),
        torch.arange(16, dtype=torch.int32), kv_mix, dec_pt,
        t(np.asarray([[31]], np.int32)), clens,
        torch.tensor(0, dtype=torch.int32), torch.tensor(0,
                                                         dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # valid = 0: nothing lands outside the garbage page.
    np.testing.assert_allclose(kv_mix[:, :, 1:].numpy(),
                               kv_dec[:, :, 1:].numpy(), **TOL)
    # ... and the JAX step agrees.
    want_logits, want_pool, got_logits, got_pool = _both_mixed(
        models, 0, 0, dec_clens=(5, 9), chunk_pages=(31,))
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    np.testing.assert_allclose(got_pool[:, :, 1:], want_pool[:, :, 1:],
                               **TOL)


@pytest.mark.parametrize("mode", ["", "fused"])
def test_mixed_step_decode_rows_on_either_writeback(models, mode,
                                                    monkeypatch):
    """The decode rows take the step's writeback route (kernel 1, or
    kernel 3 under ``XLLM_KV_WRITEBACK=fused``; their plain versions
    here) and give the same logits and pool."""
    monkeypatch.setenv("XLLM_KV_WRITEBACK", mode)
    want_logits, want_pool, got_logits, got_pool = _both_mixed(models, 24,
                                                               12)
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    np.testing.assert_allclose(got_pool, want_pool, **TOL)


@pytest.mark.parametrize("s_q", [1, 16, 33])
def test_kernel_2_at_prefix_zero_is_causal_attention(s_q):
    """Why the mixed step may call kernel 2 at any chunk start: with a
    prefix of 0 its plain version (the oracle the card holds the kernel
    to) is the chunk's causal self-attention, read from the pages its
    K/V were written to."""
    g = torch.Generator().manual_seed(s_q)
    n_q, n_kv, hd, ps = 4, 2, 32, 16
    q = torch.randn((1, s_q, n_q, hd), generator=g)
    k = torch.randn((1, s_q, n_kv, hd), generator=g)
    v = torch.randn((1, s_q, n_kv, hd), generator=g)
    n_pages = -(-s_q // ps)
    pt = torch.arange(1, n_pages + 1, dtype=torch.int32)[None]
    pos = torch.arange(s_q)
    k_pages = torch.full((n_pages + 1, n_kv, ps, hd), float("nan"))
    v_pages = torch.full((n_pages + 1, n_kv, ps, hd), float("nan"))
    k_pages[1 + pos // ps, :, pos % ps] = k[0]
    v_pages[1 + pos // ps, :, pos % ps] = v[0]
    zero = torch.zeros((1,), dtype=torch.int32)
    lens = torch.full((1,), s_q, dtype=torch.int32)
    got = mq_paged_attention_plain(q, k_pages, v_pages, pt, zero, lens)
    want = dense_prefill_attention(q, k, v, None, None, None, zero, lens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gemma2_rides_with_softcap():
    """tests/test_sarathi.py's gemma-2 case: the mixed step composes with
    the score softcap, the sliding window and the query scale; the tokens
    are the JAX engine's (chunked the same way) and the unchunked port's.
    """
    from xllm_service_tpu.models.gemma import gemma2_tiny_config

    rcfg = gemma2_tiny_config(dtype=jnp.float32, max_context_len=512)
    tree = drawn_tree(rcfg)
    ref, port = serve_both(rcfg, tree, drive, prefill_chunk_tokens=32,
                           **SARATHI_KW)
    assert port[2] >= 1, "gemma-2 never took the mixed path"
    assert port[:2] == ref[:2]
    plain = serve_both(rcfg, tree, drive, **SARATHI_KW)[1]
    assert plain[2] == 0 and port[:2] == plain[:2]


@pytest.mark.parametrize("family", ["qwen2", "gemma2"])
@pytest.mark.parametrize("start,valid", [(24, 12), (0, 16)])
def test_mixed_step_matches_the_jax_one_per_family(family, start, valid):
    """tests/test_mixed_decode_chunk.py's qwen2 and gemma-2 cases."""
    from xllm_service_tpu.models.gemma import gemma2_tiny_config

    rcfg = (gemma2_tiny_config(dtype=jnp.float32) if family == "gemma2"
            else ref_base.tiny_config(name="qwen2", dtype=jnp.float32,
                                      qkv_bias=True))
    check_mixed(make_models(rcfg), start, valid)
