"""``seq`` together with ``model`` or ``expert`` over processes: the
port's ranks (four processes joined in a gloo group over 127.0.0.1, each
holding one mesh coordinate's parameter shard and pool shard, driven in
lockstep by ``engine/multihost_driver.py``) against the reference engine
on the same mesh (the virtual CPU devices of tests/conftest.py) and the
port's one-process engine on that mesh, on the same f32 weights. The
ranks run tests/test_torch_multihost.py's worker.

Two cases, each serving a 35-token prompt, a 37-token one sharing its
first 32 (a prefix hit), a 100-token prefix-free one (the ring) and one
seeded sampled request, six tokens each:

- tiny llama on ``seq=2 x model=2``: rank r holds grid shard (seq r // 2,
  model r % 2) of the page-and-head grid pool;
- tiny mixtral on ``seq=2 x expert=2``: rank r holds seq shard r % 2 of
  the pool at expert coordinate r // 2.

Greedy tokens are identical to the reference's and to the one-process
engine's, the seeded sampled stream to the one-process engine's, and
every follower emits what the primary emits. Each rank took the ring
once. Each rank's pool shard after the greedy requests equals the
one-process engine's shard at its coordinate bit for bit and is within
1e-5 of the reference pool's pages and heads there, the garbage page 0
excluded.
"""

import pickle

import numpy as np
import pytest

import test_torch_multihost as mh

CASES = {
    "seq2_model2": dict(family="llama", axes=dict(seq=2, model=2),
                        engine=dict(num_pages=16),
                        requests=[("a", mh.A, mh.GREEDY),
                                  ("b", mh.B, mh.GREEDY),
                                  ("long", mh.LONG, mh.GREEDY),
                                  ("s", mh.SAMPLED, mh.SEEDED)]),
    "seq2_expert2": dict(family="mixtral", axes=dict(seq=2, expert=2),
                         engine=dict(num_pages=16),
                         requests=[("a", mh.A, mh.GREEDY),
                                   ("long", mh.LONG, mh.GREEDY),
                                   ("s", mh.SAMPLED, mh.SEEDED)]),
}


def coordinate(case, rank):
    """(seq index, index of the rank's shard in the one-process pool's
    ``pool_parts``, model index) of rank ``rank``'s coordinate."""
    if "model" in CASES[case]["axes"]:
        s, m = divmod(rank, 2)
        return s, m * 2 + s, m
    s = rank % 2
    return s, s, 0


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both cases' ranks, spawned together, then the one-process engines
    here while they run."""
    from test_torch_gemma import drawn_tree, port_config

    tmp = tmp_path_factory.mktemp("seq_model_multihost")
    cfgs = mh._configs()
    trees, running = {}, {}
    for case, spec in CASES.items():
        fam = spec["family"]
        if fam not in trees:
            trees[fam] = drawn_tree(cfgs[fam])
            np.savez(tmp / f"{fam}.npz", **mh._flat(trees[fam]))
        spec_path = str(tmp / f"{case}.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump({**spec, "cfg": port_config(cfgs[fam]),
                         "npz": str(tmp / f"{fam}.npz")}, f)
        running[case] = mh._spawn(case, spec_path, tmp, cases=CASES)
    out = {}
    for case, spec in CASES.items():
        fam = spec["family"]
        one = mh._one_process(case, cfgs[fam], trees[fam], cases=CASES)
        out[case] = (mh._collect(running[case]), *one)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_match_reference_and_one_process(served, case):
    ranks, toks, _, _, stats = served[case]
    spec = CASES[case]
    primary = ranks[0]
    want = {sid: toks["port"][sid] for sid, _, _ in spec["requests"]}
    got = {sid: primary["tokens"][sid] for sid, _, _ in spec["requests"]}
    assert got == want, case
    for sid, greedy in toks["ref"].items():
        assert got[sid] == greedy, (case, sid)
    assert all(len(t) == 6 for t in got.values())
    for r in ranks[1:]:
        assert r["tokens"] == primary["tokens"], (case, r["rank"])
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["stats"]["prefix_hits"] == stats["prefix_hits"]
        assert r["stats"]["mesh"] == stats["mesh"]
        # The long prompt took the ring on every rank, as in one process.
        assert r["stats"]["ring_prefills"] == stats["ring_prefills"] == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_pool_shards(served, case):
    ranks, _, ref_pool, port_shards, _ = served[case]
    axes = CASES[case]["axes"]
    P = ref_pool.shape[2] // axes["seq"]
    H = ref_pool.shape[3] // axes.get("model", 1)
    for r in ranks:
        assert len(r["pool"]) == 1, "a rank holds one grid shard"
        s, i, m = coordinate(case, r["rank"])
        got = r["pool"][0]
        want = ref_pool[:, :, s * P:(s + 1) * P, m * H:(m + 1) * H]
        assert got.shape == want.shape
        lo = 1 if s == 0 else 0                 # the garbage page
        np.testing.assert_array_equal(got, port_shards[i])
        assert np.abs(got[:, :, lo:]).max() > 0
        np.testing.assert_allclose(got[:, :, lo:], want[:, :, lo:],
                                   **mh.POOL_TOL)


def test_shards_are_the_ranks_own(served):
    ranks = served["seq2_model2"][0]
    # Each rank cut the model shard of its coordinate; both seq rows of
    # the mesh hold the same two.
    assert [tuple(r["local_shards"][0]) for r in ranks] == \
        [(0, 0), (0, 1), (0, 0), (0, 1)]
    assert [r["pool_index"] for r in ranks] == [[0], [1], [0], [1]]
    ranks = served["seq2_expert2"][0]
    assert [tuple(r["local_shards"][0]) for r in ranks] == \
        [(0, 0), (0, 0), (1, 0), (1, 0)]
    assert [r["pool_index"] for r in ranks] == [[0], [1], [0], [1]]
