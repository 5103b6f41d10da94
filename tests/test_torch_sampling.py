"""The port's batched sampling against the reference's: greedy picks,
penalties, logit bias and the top-k/top-p masks must agree exactly; seeded
draws must repeat under a per-request torch.Generator (they are not the
reference's random bits — jax.random and torch.Generator differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.engine import sampling as ref
from xllm_service_tpu_torch.engine import sampling as port

B, V = 4, 64


def _states(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    ctl = dict(
        temperature=np.asarray([0.0, 0.7, 1.3, 0.0], np.float32),
        top_k=np.asarray([0, 5, 0, 3], np.int32),
        top_p=np.asarray([1.0, 0.9, 0.5, 1.0], np.float32),
        frequency_penalty=np.asarray([0.5, 0.0, 0.2, 0.0], np.float32),
        presence_penalty=np.asarray([0.0, 0.4, 0.1, 0.0], np.float32),
        repetition_penalty=np.asarray([1.2, 1.0, 0.8, 1.0], np.float32),
        token_counts=rng.integers(0, 3, size=(B, V)).astype(np.int32),
        bias_ids=np.full((B, port.NUM_BIAS), -1, np.int32),
        bias_vals=np.zeros((B, port.NUM_BIAS), np.float32),
    )
    ctl["bias_ids"][0, :3] = [7, 9, 7]          # duplicate ids accumulate
    ctl["bias_vals"][0, :3] = [5.0, -2.0, 1.5]
    ctl["bias_ids"][2, 0] = 11
    ctl["bias_vals"][2, 0] = 100.0
    jst = ref.SamplingState(**{k: jnp.asarray(v) for k, v in ctl.items()})
    tst = port.SamplingState(**{k: torch.from_numpy(v.copy())
                                for k, v in ctl.items()})
    return logits, jst, tst


def test_penalties_and_bias_exact():
    logits, jst, tst = _states()
    want = np.asarray(ref.apply_penalties(jnp.asarray(logits), jst))
    got = port.apply_penalties(torch.from_numpy(logits), tst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_top_p_masks_exact(seed):
    logits, jst, tst = _states(seed)
    jl = ref.apply_penalties(jnp.asarray(logits), jst)
    scaled = jl / jnp.maximum(jst.temperature, 1e-6)[:, None]
    want_k = ref._mask_top_k(scaled, jst.top_k)
    want_p = np.asarray(ref._mask_top_p(want_k, jst.top_p))
    tl = port.apply_penalties(torch.from_numpy(logits), tst)
    got_k = port._mask_top_k(tl / torch.clamp(tst.temperature, min=1e-6)[:, None],
                             tst.top_k)
    np.testing.assert_array_equal(got_k.numpy() <= -1e29,
                                  np.asarray(want_k) <= -1e29)
    got_p = port.filtered_logits(tl, tst).numpy()
    np.testing.assert_array_equal(got_p <= -1e29, want_p <= -1e29)


def test_greedy_tokens_and_logprobs():
    logits, jst, tst = _states()
    jst.temperature = jnp.zeros((B,), jnp.float32)
    tst.temperature = torch.zeros((B,))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    want_t, want_lp = ref.sample_tokens(jnp.asarray(logits), jst, keys,
                                        jnp.zeros((B,), jnp.int32))
    got_t, got_lp = port.sample_tokens(torch.from_numpy(logits), tst,
                                       [None] * B)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=1e-6, atol=1e-5)
    _, zeros = port.sample_tokens(torch.from_numpy(logits), tst, [None] * B,
                                  want_logprobs=False)
    assert not zeros.any()


def test_seeded_draws_repeat_and_stay_in_the_filtered_set():
    logits, _, tst = _states()
    allowed = port.filtered_logits(
        port.apply_penalties(torch.from_numpy(logits), tst), tst) > -1e29
    runs = []
    for _ in range(2):
        gens = [torch.Generator().manual_seed(100 + b) for b in range(B)]
        runs.append([port.sample_tokens(torch.from_numpy(logits), tst,
                                        gens)[0].tolist() for _ in range(20)])
    assert runs[0] == runs[1]
    for toks in runs[0]:
        for b in (1, 2):                      # the sampled rows
            assert allowed[b, toks[b]]
    # Different draws across steps: the generator advances.
    assert len({tuple(t) for t in runs[0]}) > 1


def test_record_tokens_in_place():
    counts = np.zeros((B, V), np.int32)
    toks = np.asarray([3, 3, 5, 63], np.int32)
    active = np.asarray([True, False, True, True])
    want = np.asarray(ref.record_tokens(jnp.asarray(counts), jnp.asarray(toks),
                                        jnp.asarray(active)))
    tc = torch.from_numpy(counts.copy())
    out = port.record_tokens(tc, torch.from_numpy(toks),
                             torch.from_numpy(active))
    assert out is tc
    np.testing.assert_array_equal(tc.numpy(), want)
