"""KV tiers under a seq mesh: the port's engine on a ``seq=4`` mesh (four
CPU shards of the KV pool) against the reference engine on the same mesh
(four of the virtual CPU devices of tests/conftest.py), on shared tiny f32
weights (``llama_params_from_jax``).

The pool has 12 pages, three per shard, and a hash block is two pages of
16 tokens, so blocks straddle shards. Prompt A (96 tokens, three blocks)
is served, an unrelated 90-token prompt evicts two of its blocks into the
tiers, and A is served again from them. Two cases: a DRAM arena large
enough for every evicted block, and an arena of one block in front of an
SSD file, so that an eviction demotes to SSD and the re-send onloads from
both tiers. The onload allocates no page that evicts, so no tier install
races a fetch and both engines' stats are exact.

Checked against the reference: greedy tokens before and after the round
trip, the KvCacheEvent counts (stored / offloaded / removed) after each
request, and ``tier_store.stats()``. Checked on the port: A's restored
pages equal bit for bit to a gather taken before the eviction, and the
port's shards concatenated equal the reference's sharded pool within 1e-5
(f32 arithmetic in another order, as tests/test_torch_seq_parallel.py
states), the garbage page 0 excluded.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakes import wait_until
from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu_torch.common.hashing import prefix_block_hashes
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
from xllm_service_tpu_torch.ops.page_dma import gather_kv_pages
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

ENGINE_KW = dict(num_pages=12, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=256)
BLOCK_BYTES = 2 * 2 * 2 * 2 * 16 * 32 * 4      # [L, 2, ppb, n_kv, ps, hd] f32
CASES = {
    "dram": dict(kv_tier_dram_bytes=64 << 20),
    "dram_ssd": dict(kv_tier_dram_bytes=BLOCK_BYTES,
                     kv_tier_ssd_bytes=4 * BLOCK_BYTES, kv_tier_threads=1),
}


class Collector:
    def __init__(self):
        self.tokens = []
        self.done = threading.Event()

    def __call__(self, out) -> None:
        for s in out.outputs:
            self.tokens.extend(s.token_ids)
        if out.finished:
            self.done.set()


def _prompts():
    """A: 96 tokens of a seeded draw; U: 90 unrelated tokens."""
    rng = np.random.default_rng(5)
    return (rng.integers(3, 250, size=96).tolist(),
            rng.integers(250, 500, size=90).tolist())


def _run(engine, rid, prompt, n=6):
    is_ref = isinstance(engine, RefEngine)
    req_cls, sp_cls = ((RefRequest, RefSampling) if is_ref
                       else (EngineRequest, SamplingParams))
    col = Collector()
    engine.submit(req_cls(rid, token_ids=list(prompt), on_output=col,
                          sampling=sp_cls(max_tokens=n, temperature=0.0,
                                          ignore_eos=True)))
    t0 = time.monotonic()
    while not col.done.is_set():
        assert time.monotonic() - t0 < 120
        if not engine.step():
            time.sleep(0.001)
    return col.tokens


def _events(engine):
    """KvCacheEvent counts once the tier pump is idle."""
    assert wait_until(lambda: not engine.tier_store._pending, timeout=20)
    ev = engine.drain_kv_events()
    return len(ev.stored), len(ev.offloaded), len(ev.removed)


def _serve(engine, prompt_a, prompt_u):
    """A, then U (evicting A into the tiers), then A again. Returns the
    tokens, the event counts after each request, the tiers A's blocks sat
    in before the re-send and, for the port, A's pages before the
    eviction and after the onload (plain sharded gathers)."""
    hashes = [h.hex() for h in prefix_block_hashes(prompt_a, 32)]
    store = engine.tier_store
    # A first request of 16 + 17 tokens holds pages 1-3 and frees them all
    # (no full block), so A's first two blocks get pages [3, 2] and [1, 4]:
    # each straddles shards 0 and 1.
    _run(engine, "w", list(range(300, 316)), n=17)
    out = {"tokens": [_run(engine, "a1", prompt_a)]}
    out["events"] = [_events(engine)]
    port = isinstance(engine, InferenceEngine)
    if port:
        blocks = engine.page_mgr._blocks
        out["pages"] = [blocks[h].pages for h in hashes[:2]]
        out["before"] = [gather_kv_pages(engine.kv_pages, p)
                         for p in out["pages"]]
    # U's 90 + 24 tokens take 8 pages: A's two least recent blocks go.
    out["tokens"].append(_run(engine, "u1", prompt_u, n=24))
    assert wait_until(lambda: all(store.ready(h) for h in hashes[:2]),
                      timeout=20)
    out["events"].append(_events(engine))
    out["tiers"] = [store.tier_of(h) for h in hashes]
    out["tokens"].append(_run(engine, "a2", prompt_a))
    out["events"].append(_events(engine))
    out["stats"] = store.stats()
    if port:
        out["after"] = [gather_kv_pages(engine.kv_pages,
                                        engine.page_mgr._blocks[h].pages)
                        for h in hashes[:2]]
        out["pages"] += [engine.page_mgr._blocks[h].pages
                         for h in hashes[:2]]
    return out


@pytest.fixture(scope="module")
def weights():
    mcfg = ref_tiny(dtype=jnp.float32, max_context_len=256)
    tree = ref_llama.init_params(mcfg, jax.random.PRNGKey(0))
    return tree, llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                       device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def served(request, weights):
    """Both engines through the round trip of one case."""
    kw = {**ENGINE_KW, **CASES[request.param]}
    prompt_a, prompt_u = _prompts()
    ref = RefEngine(RefConfig(model=ref_tiny(dtype=jnp.float32,
                                             max_context_len=256),
                              prefill_buckets=(32, 64, 128, 256),
                              mesh=RefMeshConfig(seq=4), **kw),
                    params=weights[0])
    port = InferenceEngine(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256), **kw),
        device="cpu", params=weights[1],
        mesh=build_mesh(MeshConfig(seq=4), ["cpu"] * 4))
    try:
        yield (request.param, ref, port, _serve(ref, prompt_a, prompt_u),
               _serve(port, prompt_a, prompt_u))
    finally:
        port.stop()
        ref.stop()


def test_round_trip_matches_reference(served):
    """Same tokens before and after the round trip, on both engines and
    between them; the same event counts and tier stats."""
    case, _, port, ref_out, out = served
    assert isinstance(port.kv_pages, ShardedPages)
    assert out["tokens"] == ref_out["tokens"]
    assert out["tokens"][2] == out["tokens"][0]
    assert out["events"] == ref_out["events"]
    assert out["tiers"] == ref_out["tiers"]
    assert out["stats"] == ref_out["stats"]
    st = out["stats"]
    assert st["offload_total"] == 3 and st["onload_total"] == 2
    if case == "dram_ssd":
        assert st["demote_total"] == 1
        assert out["tiers"] == ["ssd", "dram", None]
    else:
        assert st["demote_total"] == 0
        assert out["tiers"] == ["dram", "dram", None]


def test_restored_pages_bit_identical(served):
    """A's two onloaded blocks, read back from their new pages, equal the
    bytes gathered before the eviction. Both evicted blocks straddled
    shards 0 and 1; the pages they are restored into lie on shards 3 and
    2."""
    _, _, port, _, out = served
    for want, got in zip(out["before"], out["after"]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    P_loc = port.kv_pages.pages_per_shard
    assert [sorted({p // P_loc for p in pages})
            for pages in out["pages"]] == [[0, 1], [0, 1], [3], [2]]


def test_pool_matches_reference_sharded_pool(served):
    _, ref, port, _, _ = served
    want = np.asarray(ref._dstate["kv"])
    got = port.kv_pages.full().numpy()
    assert got.shape == want.shape == (2, 2, 12, 2, 16, 32)
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], rtol=1e-5,
                               atol=1e-5)
