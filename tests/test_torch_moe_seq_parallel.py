"""The MoE families on a seq mesh: the port's engine at ``seq=2`` (two CPU
shards of the KV pool) against the reference engine on the same mesh (two
of the virtual CPU devices of tests/conftest.py) and against the port's
single-device engine, for ``tiny_moe_config`` (GQA, shared experts),
``tiny_mla_config`` (MLA's one latent head of 48) and
``mixtral_tiny_config``, on the same f32 weights (the reference's
``init_params`` with norm scales drawn non-zero, ``params_from_jax``).

Each engine serves a short prompt (the standard route), a long
prefix-free one (the ring: a spy on the reference's
``_prefill_install_sp`` / ``_prefill_install_sp_nc`` counts its ring
routes, ``ring_prefills`` the port's) and the long one again (a prefix
hit). Greedy tokens are identical on all three engines, the ring counts
equal, and the port's shards concatenated equal the reference's sharded
pool within 1e-5 (f32 arithmetic in another order), the garbage page 0
excluded. Below the engines, the pieces at these families' shapes: the
ring against the reference's ring at MLA's (16 query heads over one head
of 576, ``v`` the same tensor as ``k``, MLA's scale) and Mixtral's (32/8
heads), ``paged_attention_xla`` over a sharded pool against the
unsharded call, the sharded write at one head of 576, and the decode
step's compacted tables shared by every GQA layer.
"""

import jax
import numpy as np
import pytest
import torch

from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu.ops.ring_attention import (
    ring_attention as ref_ring_attention,
)
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu.parallel.mesh import build_mesh as ref_build_mesh
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models import deepseek_moe, llama
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops import cp_paged_attention as cp
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
from xllm_service_tpu_torch.ops.ring_attention import ring_attention
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

from test_torch_gemma import drawn_tree, port_config

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=512,
                 seq_parallel_min_tokens=64)
SHORT = list(range(40, 70))                          # 30 tokens < 64
LONG = [(i * 11 + 5) % 300 + 10 for i in range(100)]  # ring route
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=2e-5, atol=2e-5)
CONFIGS = {
    "moe": lambda: ref_ds.tiny_moe_config(dtype=jax.numpy.float32),
    "mla": lambda: ref_ds.tiny_mla_config(dtype=jax.numpy.float32),
    "mixtral": lambda: ref_mixtral.mixtral_tiny_config(
        dtype=jax.numpy.float32),
}


def cpu_mesh(n):
    return build_mesh(MeshConfig(seq=n), ["cpu"] * n)


def spy_ring(ref):
    """Count the reference engine's ring-route installs."""
    count = {"n": 0}
    for name in ("_prefill_install_sp", "_prefill_install_sp_nc"):
        real = getattr(ref, name)

        def spy(*a, _real=real, **k):
            count["n"] += 1
            return _real(*a, **k)

        setattr(ref, name, spy)
    return count


def run_one(engine, prompt, n=5):
    from test_torch_chunked_prefill import Collector, step_until

    is_ref = isinstance(engine, RefEngine)
    req_cls, sp_cls = ((RefRequest, RefSampling) if is_ref
                       else (EngineRequest, SamplingParams))
    col = Collector()
    engine.submit(req_cls(f"r{len(prompt)}", token_ids=list(prompt),
                          on_output=col,
                          sampling=sp_cls(max_tokens=n, temperature=0.0,
                                          ignore_eos=True)))
    step_until(engine, [col])
    return col.tokens


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def served(request):
    """The reference (seq=2), the port (seq=2) and the port's single-device
    engine after SHORT, LONG and LONG again: (ref, port, tokens, rings)."""
    rcfg = CONFIGS[request.param]()
    tree = drawn_tree(rcfg)
    ref = RefEngine(RefConfig(model=rcfg, model_family=rcfg.name,
                              prefill_buckets=(32, 64, 128, 512),
                              mesh=RefMeshConfig(seq=2), **ENGINE_KW),
                    params=tree)
    ring = spy_ring(ref)
    port_kw = dict(model=port_config(rcfg), model_family=rcfg.name,
                   **ENGINE_KW)
    port = InferenceEngine(EngineConfig(**port_kw), device="cpu",
                           params=params_from_jax(tree, device="cpu"),
                           mesh=cpu_mesh(2))
    single = InferenceEngine(EngineConfig(**port_kw), device="cpu",
                             params=params_from_jax(tree, device="cpu"))
    toks = {"ref": [], "port": [], "single": []}
    rings = []
    xla0 = attention.paged_attention_xla.launches
    for prompt in (SHORT, LONG, LONG):
        toks["ref"].append(run_one(ref, prompt))
        toks["port"].append(run_one(port, prompt))
        toks["single"].append(run_one(single, prompt))
        rings.append((ring["n"], port.ring_prefills, single.ring_prefills))
    xla = attention.paged_attention_xla.launches - xla0
    yield request.param, rcfg, ref, port, toks, rings, xla
    for eng in (ref, port, single):
        eng.stop()


def test_greedy_tokens_match_reference_and_single_device(served):
    name, rcfg, _, port, toks, _, xla = served
    assert port.seq_parallel == 2 and isinstance(port.kv_pages, ShardedPages)
    assert port.kv_pages.shards[0].shape == (
        rcfg.num_layers, 2, 32, rcfg.num_kv_heads, 16, rcfg.head_dim)
    assert toks["port"] == toks["ref"] == toks["single"], name
    assert all(len(t) == 5 for t in toks["port"])
    if name == "mla":
        # Every decode layer of both port engines took MLA's route.
        assert xla > 0 and xla % rcfg.num_layers == 0


def test_ring_counts_match(served):
    """SHORT: the standard route; LONG: the ring, once; LONG again: a
    prefix hit on the standard route, on both engines."""
    _, _, _, port, _, rings, _ = served
    assert rings == [(0, 0, 0), (1, 1, 0), (1, 1, 0)]
    assert port.stats()["prefix_hits"] == 1


def test_pool_matches_reference_pool(served):
    name, rcfg, ref, port, _, _, _ = served
    want = np.asarray(ref._dstate["kv"])
    got = port.kv_pages.full().numpy()
    assert got.shape == want.shape == (rcfg.num_layers, 2, 64,
                                       rcfg.num_kv_heads, 16, rcfg.head_dim)
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], **POOL_TOL)


# ------------------------------------------------------- below the engine
@pytest.mark.parametrize("shape", [
    (2, 1, 64, 16, 1, 576, 1.0 / 192 ** 0.5),   # MLA: 16 heads over 576
    (2, 1, 32, 32, 8, 128, None),               # Mixtral's 32/8 heads
])
def test_ring_at_the_moe_families_shapes(shape):
    """The port's ring against the reference's ring on two virtual
    devices, and against its own dense causal prefill. MLA: ``v`` is the
    latent itself, so the output takes q's (and the latent's) 576 dims."""
    sp, B, S, H, H_kv, hd, scale = shape
    rng = np.random.default_rng(H + hd)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, H_kv, hd)).astype(np.float32)
    v = k if H_kv == 1 else rng.normal(size=k.shape).astype(np.float32)
    mesh = ref_build_mesh(RefMeshConfig(seq=sp), devices=jax.devices()[:sp])
    with mesh:
        want = ref_ring_attention(q, k, v, mesh, seq_axis="seq",
                                  scale=scale)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tv = tk if v is k else torch.from_numpy(v)
    got = ring_attention(tq, tk, tv, cpu_mesh(sp), scale=scale)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING_TOL)
    dense = attention.prefill_attention(
        tq, tk, tv, None, None, None, torch.zeros((B,), dtype=torch.int32),
        torch.full((B,), S, dtype=torch.int32), scale=scale)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **RING_TOL)


def _mla_pool(n_shards, P=16, ps=4, D=576, seed=0):
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(rng.normal(size=(P, 1, ps, D)).astype(
        np.float32))
    if n_shards == 1:
        return full, full
    sharded = ShardedPages.zeros(full.shape, full.dtype, cpu_mesh(n_shards))
    Pl = P // n_shards
    for d, s in enumerate(sharded.shards):
        s.copy_(full[d * Pl:(d + 1) * Pl])
    return full, sharded


@pytest.mark.parametrize("n_shards", [2, 4])
def test_mla_decode_route_over_a_sharded_pool(n_shards):
    """``paged_attention_xla`` over a sharded pool of one 576-wide head
    gathers each row's pages from their shards: the same output as the
    call on the whole pool, bit for bit (the same body on the same
    rows), counted once a call."""
    full, sharded = _mla_pool(n_shards)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(3, 16, 576)).astype(np.float32))
    pt = torch.tensor([[1, 9, 14, 3], [15, 2, 0, 0], [4, 8, 12, 5]],
                      dtype=torch.int32)
    clens = torch.tensor([15, 6, 13], dtype=torch.int32)
    scale = 1.0 / 192 ** 0.5
    want = attention.paged_attention_xla(q, full, full, pt, clens,
                                         scale=scale)
    n0 = attention.paged_attention_xla.launches
    got = attention.paged_attention_xla(q, sharded, sharded, pt, clens,
                                        scale=scale)
    assert attention.paged_attention_xla.launches == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_latent_writes_into_a_sharded_pool(n_shards):
    """The prefill and decode writes of MLA's latent (one head of 576, as
    both K and V) land on the owning shards exactly where the
    single-device writes land on the whole pool."""
    full, sharded = _mla_pool(n_shards, seed=5)
    full = full.clone()
    rng = np.random.default_rng(6)
    entry = torch.from_numpy(rng.normal(size=(2, 9, 1, 576)).astype(
        np.float32))
    pt = torch.tensor([[3, 12, 7, 0], [9, 5, 14, 0]], dtype=torch.int32)
    prefix = torch.tensor([2, 0], dtype=torch.int32)
    lens = torch.tensor([9, 6], dtype=torch.int32)
    for pool in (full, sharded):
        attention.write_prefill_kv(pool, pool, entry, entry, pt, prefix,
                                   lens)
        attention.write_decode_kv(pool, pool, entry[:, 0], entry[:, 0], pt,
                                  torch.tensor([11, 6], dtype=torch.int32))
    assert torch.equal(sharded.full()[1:], full[1:])


def test_decode_step_compacts_tables_once(monkeypatch):
    """A GQA decode step over a sharded pool compacts its tables once for
    all its layers (``cp_tables``), as the llama family's does, and every
    layer's context-parallel op takes them."""
    cfg = deepseek_moe.tiny_moe_config(dtype=torch.float32, num_layers=3)
    params = deepseek_moe.init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    pool = ShardedPages.zeros((3, 2, 16, 2, 4, 32), torch.float32,
                              cpu_mesh(4))
    calls = {"tables": 0, "given": 0}
    real_tables, real_cp = cp.cp_tables, attention.cp_paged_attention

    def tables(*a, **k):
        calls["tables"] += 1
        return real_tables(*a, **k)

    def cp_op(*a, tables=None, **k):
        calls["given"] += tables is not None
        return real_cp(*a, tables=tables, **k)

    monkeypatch.setattr(llama, "cp_tables", tables)
    monkeypatch.setattr(attention, "cp_paged_attention", cp_op)
    pt = torch.tensor([[1, 6, 11, 0], [2, 7, 12, 13]], dtype=torch.int32)
    clens = torch.tensor([9, 14], dtype=torch.int32)
    logits, _ = deepseek_moe.decode_forward(
        params, cfg, torch.tensor([5, 9]), clens - 1, pool, pt, clens)
    assert logits.shape == (2, cfg.vocab_size)
    assert calls == {"tables": 1, "given": 3}
