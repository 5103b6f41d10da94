"""``seq`` together with ``model`` or ``expert`` in one process: the
port's engine on ``seq=2 x model=2`` (the page-and-head grid pool) and on
``seq=2 x expert=2`` against the reference engine on the same mesh (four
of the virtual CPU devices of tests/conftest.py), on shared tiny f32
llama weights (``llama_params_from_jax``), with
tests/test_torch_seq_parallel.py's config and prompts.

- SHORT, LONG and LONG: greedy tokens identical to the reference's; LONG
  takes the ring once (the reference's ``_prefill_install_sp`` counted
  alike) and its re-send is a prefix hit; the grid's ``full()`` is within
  1e-5 of the reference's pool, page 0 excluded.
- Below the engine, on a grid: a decode step runs the context-parallel op
  once a model shard and layer at that shard's heads, on tables compacted
  once a step, and a ring prefill runs once a model shard and layer over
  its seq line; both equal the unsharded forwards, pools included. The
  movers (kernels 4 and 5 on the card, their plain versions here) put a
  block into every grid shard and take it back bit for bit.
- The KV tiers' round trip of tests/test_torch_tier_seq_parallel.py on
  ``seq=2 x model=2``, against the reference on that mesh: the same
  tokens, events and tier stats, and the restored pages bit for bit.
- A PD pair over the host path between two ``seq=2 x model=2`` engines:
  the prefill side (on the ring) hands off the reference prefill side's
  first token and a blob within KV_TOL of its blob, and the decode side
  streams the reference's tokens.
- The dry run's decode step over ``seq x model``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import EngineRequest, InferenceEngine
from xllm_service_tpu_torch.models import llama
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
from xllm_service_tpu_torch.ops.page_dma import (
    gather_kv_pages,
    gather_kv_shards,
    scatter_kv_pages,
)
from xllm_service_tpu_torch.parallel.dryrun import TOL, dryrun
from xllm_service_tpu_torch.parallel.sharding import (
    ModelShardedPages,
    shard_params,
)

import test_torch_tier_seq_parallel as tier
from test_torch_chunked_prefill import Collector, step_until
from test_torch_moe_seq_parallel import spy_ring
from test_torch_seq_parallel import (
    ENGINE_KW,
    LONG,
    SHORT,
    cpu_mesh,
    port_cfg,
    run_one,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

MESHES = {"seq2_model2": dict(seq=2, model=2),
          "seq2_expert2": dict(seq=2, expert=2)}
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
KV_TOL = 5e-5
GREEDY = dict(temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def weights():
    mcfg = ref_tiny(dtype=jnp.float32, max_context_len=512)
    tree = ref_llama.init_params(mcfg, jax.random.PRNGKey(0))
    return mcfg, tree, jax.tree.map(np.asarray, tree)


def ref_engine(weights, axes, **kw):
    mcfg, tree, _ = weights
    return RefEngine(RefConfig(model=mcfg,
                               prefill_buckets=(32, 64, 128, 512),
                               mesh=RefMeshConfig(**axes),
                               **{**ENGINE_KW, **kw}), params=tree)


def port_engine(weights, axes, **kw):
    return InferenceEngine(port_cfg(**kw), device="cpu",
                           params=llama_params_from_jax(weights[2],
                                                        device="cpu"),
                           mesh=cpu_mesh(**axes))


@pytest.fixture(scope="module", params=sorted(MESHES))
def served(request, weights):
    """The reference and the port on one mesh after SHORT, LONG and LONG
    again, with their tokens and ring counts after each request."""
    axes = MESHES[request.param]
    ref, port = ref_engine(weights, axes), port_engine(weights, axes)
    ring = spy_ring(ref)
    out = {"ref": [], "port": [], "ring": []}
    for prompt in (SHORT, LONG, LONG):
        out["ref"].append(run_one(ref, prompt))
        out["port"].append(run_one(port, prompt))
        out["ring"].append((ring["n"], port.ring_prefills))
    yield request.param, ref, port, out
    ref.stop()
    port.stop()


def test_greedy_tokens_match_reference(served):
    name, _, port, out = served
    assert out["port"] == out["ref"], name
    assert all(len(t) == 5 for t in out["port"])
    assert port.seq_parallel == 2
    if name == "seq2_model2":
        pool = port.kv_pages
        assert isinstance(pool, ModelShardedPages) and not pool.replicated
        assert pool.shape == (2, 2, 64, 2, 16, 32)
        for m, part in zip(pool.index, pool.shards):
            # Model shard m: its one KV head, its pages split over seq.
            assert isinstance(part, ShardedPages)
            assert part.index == [0, 1]
            assert [s.shape for s in part.shards] == \
                [(2, 2, 32, 1, 16, 32)] * 2
    else:
        assert isinstance(port.kv_pages, ShardedPages)
        assert port.kv_pages.shards[0].shape == (2, 2, 32, 2, 16, 32)


def test_ring_route_taken_once(served):
    """SHORT: the standard route; LONG: the ring, once; LONG again: a
    prefix hit on the standard route, on both engines."""
    _, _, port, out = served
    assert out["ring"] == [(0, 0), (1, 1), (1, 1)]
    assert port.stats()["prefix_hits"] == 1


def test_pool_matches_reference_pool(served):
    _, ref, port, _ = served
    want = np.asarray(ref._dstate["kv"])
    got = port.kv_pages.full().numpy()
    assert got.shape == want.shape == (2, 2, 64, 2, 16, 32)
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], **POOL_TOL)


# ------------------------------------------------------- below the engine
def _grid_model(seed=0):
    """Tiny f32 llama weights, unsharded and cut over ``seq=2 x model=2``,
    a random pool of 16 pages of 4 and the same pool as a grid."""
    cfg = tiny_config(dtype=torch.float32, num_layers=2)
    params = llama.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    mesh = cpu_mesh(seq=2, model=2)
    full = torch.randn((2, 2, 16, cfg.num_kv_heads, 4, cfg.head_dim),
                       generator=torch.Generator().manual_seed(seed + 1))
    grid = ModelShardedPages.zeros(full.shape, full.dtype, mesh)
    scatter_kv_pages(grid, range(16), full)
    sharded = shard_params(params, mesh, llama.LLAMA_STACKED_RULES)
    return cfg, params, sharded, full, grid


def test_grid_movers_round_trip():
    """Kernels 4 and 5 (plain here) at a grid shard's block: the scatter
    puts each model shard's heads of the block into its seq shards'
    pages; the gather takes them back whole and as one part a model shard
    (a model shard's heads of every page of the block)."""
    cfg, _, _, full, grid = _grid_model()
    assert torch.equal(grid.full(), full)
    ids = [13, 2, 9, 6]                    # on both seq shards
    block = torch.randn((2, 2, 4, cfg.num_kv_heads, 4, cfg.head_dim),
                        generator=torch.Generator().manual_seed(7))
    scatter_kv_pages(grid, ids, block)
    full[:, :, ids] = block
    assert torch.equal(grid.full(), full)
    assert torch.equal(gather_kv_pages(grid, ids), block)
    parts = gather_kv_shards(grid, ids)
    H = cfg.num_kv_heads // 2
    for m, part in enumerate(parts):
        assert torch.equal(part, block[:, :, :, m * H:(m + 1) * H])


def test_decode_runs_kernel_6_per_model_shard(monkeypatch):
    """A decode step over the grid: the context-parallel op (kernel 6 and
    the merge) once a model shard and layer, at that shard's query heads
    over its seq line, on one set of tables a step; logits and the new
    K/V equal the unsharded step's."""
    cfg, params, sharded, full, grid = _grid_model()
    calls, compactions = [], []
    real_cp, real_tables = attention.cp_paged_attention, llama.cp_tables

    def cp_op(q, k_shards, v_shards, *a, tables=None, **k):
        calls.append((q.shape[1], len(k_shards), tables is not None))
        return real_cp(q, k_shards, v_shards, *a, tables=tables, **k)

    def tables(*a, **k):
        compactions.append(1)
        return real_tables(*a, **k)

    monkeypatch.setattr(attention, "cp_paged_attention", cp_op)
    monkeypatch.setattr(llama, "cp_tables", tables)
    pt = torch.tensor([[1, 9, 3, 12], [10, 2, 0, 0]], dtype=torch.int32)
    clens = torch.tensor([14, 6], dtype=torch.int32)
    tokens = torch.tensor([5, 9])
    ref_pool = full.clone()
    want, _ = llama.decode_forward(params, cfg, tokens, clens - 1, ref_pool,
                                   pt, clens)
    got, _ = llama.decode_forward(sharded, cfg, tokens, clens - 1, grid, pt,
                                  clens)
    assert calls == [(cfg.num_heads // 2, 2, True)] * (2 * cfg.num_layers)
    # Both model shards' seq lines lie on the CPU: one compaction a step.
    assert len(compactions) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), **POOL_TOL)
    np.testing.assert_allclose(grid.full().numpy(), ref_pool.numpy(),
                               **POOL_TOL)


def test_ring_prefill_per_model_shard(monkeypatch):
    """A prefix-free prefill on the ring over the grid: one ring a model
    shard and layer, at the shard's heads over its seq line; the logits
    and the pool equal the unsharded prefill's."""
    cfg, params, sharded, full, grid = _grid_model(seed=3)
    seen = []
    real_ring = attention.ring_attention

    def ring(q, k, v, mesh, **kw):
        seen.append((q.shape[2], k.shape[2], tuple(kw["local"])))
        return real_ring(q, k, v, mesh, **kw)

    monkeypatch.setattr(attention, "ring_attention", ring)
    S = 12
    tokens = torch.arange(S)[None] * 5 + 3
    positions = torch.arange(S, dtype=torch.int32)[None]
    pt = torch.tensor([[4, 11, 7, 0]], dtype=torch.int32)
    zero = torch.zeros((1,), dtype=torch.int32)
    lens = torch.tensor([S - 2], dtype=torch.int32)   # two rows of padding
    ref_pool = full.clone()
    want, _ = llama.prefill_forward(params, cfg, tokens, positions, ref_pool,
                                    pt, zero, lens, has_prefix=False)
    got, _ = llama.prefill_forward(sharded, cfg, tokens, positions, grid, pt,
                                   zero, lens, has_prefix=False, ring=True)
    H, H_kv = cfg.num_heads // 2, cfg.num_kv_heads // 2
    cpu = torch.device("cpu")
    assert seen == [(H, H_kv, ((0, cpu), (1, cpu)))] * (2 * cfg.num_layers)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **POOL_TOL)
    # Page 0 is the garbage page, where the padding rows land.
    np.testing.assert_allclose(grid.full().numpy()[:, :, 1:],
                               ref_pool.numpy()[:, :, 1:], **POOL_TOL)


# ------------------------------------------------------------- the tiers
@pytest.fixture(scope="module")
def tiers_served():
    kw = {**tier.ENGINE_KW, **tier.CASES["dram"]}
    rcfg = ref_tiny(dtype=jnp.float32, max_context_len=256)
    tree = jax.tree.map(np.asarray, tier.ref_llama.init_params(
        rcfg, jax.random.PRNGKey(0)))
    prompt_a, prompt_u = tier._prompts()
    axes = MESHES["seq2_model2"]
    ref = RefEngine(RefConfig(model=rcfg, prefill_buckets=(32, 64, 128, 256),
                              mesh=RefMeshConfig(**axes), **kw),
                    params=tree)
    cfg = port_cfg(**kw)
    cfg.model = dataclasses.replace(cfg.model, max_context_len=256)
    port = InferenceEngine(cfg, device="cpu",
                           params=llama_params_from_jax(tree, device="cpu"),
                           mesh=cpu_mesh(**axes))
    try:
        yield (ref, port, tier._serve(ref, prompt_a, prompt_u),
               tier._serve(port, prompt_a, prompt_u))
    finally:
        port.stop()
        ref.stop()


def test_tier_round_trip_on_the_grid(tiers_served):
    """Evict a prompt's blocks into the DRAM tier and serve it again from
    there: the same tokens, events and tier stats as the reference's on
    ``seq=2 x model=2``; each block's pages gathered and scattered once a
    model shard, joined in the reference's layout; the restored pages
    equal the ones gathered before the eviction bit for bit."""
    ref, port, ref_out, out = tiers_served
    assert isinstance(port.kv_pages, ModelShardedPages)
    assert isinstance(port.kv_pages.shards[0], ShardedPages)
    assert out["tokens"] == ref_out["tokens"]
    assert out["tokens"][2] == out["tokens"][0]
    assert out["events"] == ref_out["events"]
    assert out["stats"] == ref_out["stats"]
    assert out["stats"]["onload_total"] == 2
    for want, got in zip(out["before"], out["after"]):
        assert got.shape == (2, 2, 2, 2, 16, 32)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    want = np.asarray(ref._dstate["kv"])
    np.testing.assert_allclose(port.kv_pages.full().numpy()[:, :, 1:],
                               want[:, :, 1:], **POOL_TOL)


# -------------------------------------------------------------------- PD
def _prefill_only(engine, req_cls, sp_cls, prompt):
    got = []
    engine.submit(req_cls("p", token_ids=list(prompt),
                          sampling=sp_cls(max_tokens=5, **GREEDY),
                          prefill_only=True, on_prefill_done=got.append))
    for _ in range(50):
        if got:
            break
        engine.step()
    assert len(got) == 1
    return got[0]


def test_pd_pair_on_the_grid(weights):
    """A prefill side and a decode side, both on ``seq=2 x model=2``, over
    the host path (the blob in the reference's layout): the prefill side
    takes the ring and hands off the reference prefill side's first token
    and KV within KV_TOL; the decode side streams the reference's tokens
    (its MIX run on the same mesh, behind the handoff's prefix)."""
    axes = MESHES["seq2_model2"]
    ref = ref_engine(weights, axes)
    try:
        hr = _prefill_only(ref, RefRequest, RefSampling, LONG)
        want = run_one(ref, LONG)
    finally:
        ref.stop()
    pre = port_engine(weights, axes)
    try:
        h = _prefill_only(pre, EngineRequest, SamplingParams, LONG)
        assert pre.ring_prefills == 1
    finally:
        pre.stop()
    blob = h.kv_blob.cpu() if not isinstance(h.kv_blob, torch.Tensor) \
        else h.kv_blob
    assert isinstance(blob, torch.Tensor) and blob.shape[3] == 2
    assert h.first_token == hr.first_token
    assert np.abs(blob.numpy() - np.asarray(hr.kv_blob)).max() <= KV_TOL
    dec, col = port_engine(weights, axes), Collector()
    try:
        dec.submit(EngineRequest("p", token_ids=list(LONG),
                                 sampling=h.sampling,
                                 injected_first_token=h.first_token,
                                 injected_kv=blob, on_output=col))
        step_until(dec, [col])
    finally:
        dec.stop()
    assert col.tokens == want


# ------------------------------------------------------------ the dry run
def test_dryrun_step_on_seq_model():
    out = dryrun(["cpu"] * 4)
    assert out["seq_model_mesh"]["seq"] == out["seq_model_mesh"]["model"] \
        == 2
    for part in ("seq_model_decode", "seq_model_decode_pool"):
        assert 0 <= out[part] <= TOL, part
