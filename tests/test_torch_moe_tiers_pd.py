"""The KV tiers and the PD handoff over the MoE pools against the JAX
engine, on the CPU, on the same f32 weights (the reference's
``init_params`` with norm scales drawn non-zero, ``params_from_jax``):
the MLA pool (``tiny_mla_config``: one latent head of 32 + 16 = 48 dims)
and Mixtral's (``mixtral_tiny_config``: two heads of 32).

Tiers: tests/test_torch_tier_seq_parallel.py's round trip (prompt A
served, an unrelated prompt evicting two of its blocks into the tiers, A
again from them) on a 12-page pool of hash blocks of two pages, for each
pool without a mesh and on a ``seq=2`` mesh, with a one-block DRAM arena
in front of an SSD file (so the round trip demotes a block and onloads
from both tiers). Greedy tokens, KvCacheEvent
counts, the tiers each block sat in and ``tier_store.stats()`` equal the
reference engine's on the same mesh; A's restored blocks equal bit for bit the
bytes gathered before the eviction; the pool agrees with the reference's
within 1e-5 (page 0 excluded).

PD: a PREFILL and a DECODE port agent of the MLA model behind the
reference ``Master`` (no mesh, as the reference's plain PD pair) hand a
request off on each host path (streamed and inline) and on the device
path's control flow (tests/test_torch_pd_e2e.py's ``FakeDevicePath``:
the CPU has no CUDA IPC). The decode agent's greedy tokens equal a JAX
PD pair's and a JAX MIX agent's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.engine.agent import AgentConfig as RefAgentConfig
from xllm_service_tpu.engine.agent import EngineAgent as RefAgent
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import deepseek_moe as ref_ds
from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu.common.types import InstanceType as RefType
from xllm_service_tpu.coordination.memory import InMemoryCoordination
from xllm_service_tpu_torch.common.types import InstanceType
from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages

from test_torch_gemma import drawn_tree, port_config
from test_torch_moe_seq_parallel import cpu_mesh
from test_torch_pd_e2e import FakeDevicePath, _Cluster, _pair
from test_torch_tier_seq_parallel import _prompts, _serve

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

TIER_KW = dict(num_pages=12, page_size=16, hash_block_size=32,
               max_batch_size=2, max_seq_len=256)
# [L, 2, ppb, n_kv, ps, hd] in f32: MLA's one head of 48, Mixtral's two
# heads of 32.
BLOCK_BYTES = {"mla": 2 * 2 * 2 * 1 * 16 * 48 * 4,
               "mixtral": 2 * 2 * 2 * 2 * 16 * 32 * 4}
CONFIGS = {
    "mla": lambda: ref_ds.tiny_mla_config(dtype=jnp.float32,
                                          max_context_len=256),
    "mixtral": lambda: ref_mixtral.mixtral_tiny_config(
        dtype=jnp.float32, max_context_len=256),
}


PD_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
             max_batch_size=4, max_seq_len=256)


@pytest.fixture(scope="module")
def mla():
    rcfg = CONFIGS["mla"]()
    return rcfg, drawn_tree(rcfg)


# ------------------------------------------------------------------ tiers
@pytest.fixture(scope="module",
                params=[(name, seq) for name in CONFIGS for seq in (1, 2)],
                ids=lambda p: f"{p[0]}-seq{p[1]}")
def tiered(request):
    name, seq = request.param
    rcfg = CONFIGS[name]()
    tree = drawn_tree(rcfg)
    block = BLOCK_BYTES[name]
    kw = dict(TIER_KW, kv_tier_dram_bytes=block, kv_tier_ssd_bytes=4 * block,
              kv_tier_threads=1)
    prompt_a, prompt_u = _prompts()
    ref = RefEngine(RefConfig(model=rcfg, model_family=rcfg.name,
                              prefill_buckets=(32, 64, 128, 256),
                              mesh=RefMeshConfig(seq=seq), **kw),
                    params=tree)
    port = InferenceEngine(
        EngineConfig(model=port_config(rcfg), model_family=rcfg.name, **kw),
        device="cpu", params=params_from_jax(tree, device="cpu"),
        mesh=cpu_mesh(seq) if seq > 1 else None)
    try:
        yield (name, seq, ref, port, _serve(ref, prompt_a, prompt_u),
               _serve(port, prompt_a, prompt_u))
    finally:
        port.stop()
        ref.stop()


def test_tier_round_trip_matches_reference(tiered):
    name, seq, _, port, ref_out, out = tiered
    assert isinstance(port.kv_pages, ShardedPages) == (seq > 1)
    assert port.tier_store.block_nbytes == BLOCK_BYTES[name]
    assert out["tokens"] == ref_out["tokens"]
    assert out["tokens"][2] == out["tokens"][0]
    assert out["events"] == ref_out["events"]
    assert out["tiers"] == ref_out["tiers"]
    assert out["stats"] == ref_out["stats"]
    st = out["stats"]
    assert st["offload_total"] == 3 and st["onload_total"] == 2
    assert st["demote_total"] == 1
    assert out["tiers"] == ["ssd", "dram", None]


def test_restored_pages_bit_identical(tiered):
    """A's two onloaded blocks (MLA: of latents), read back from their
    new pages, equal the bytes gathered before the eviction."""
    name, *_, out = tiered
    assert out["before"][0].shape == {"mla": (2, 2, 2, 1, 16, 48),
                                      "mixtral": (2, 2, 2, 2, 16, 32)}[name]
    for want, got in zip(out["before"], out["after"]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert out["pages"][:2] != out["pages"][2:]      # restored elsewhere


def test_tier_pool_matches_reference_pool(tiered):
    _, seq, ref, port, _, _ = tiered
    want = np.asarray(ref._dstate["kv"])
    kv = port.kv_pages
    got = (kv.full() if seq > 1 else kv).numpy()
    assert got.shape == want.shape
    assert got.shape[2] == 12 and np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------- PD
def _port_agent(store, tree, rcfg, itype, **agent_kw):
    return EngineAgent(
        EngineConfig(model=port_config(rcfg), model_family=rcfg.name,
                     **PD_KW),
        AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                    instance_type=itype, heartbeat_interval_s=0.3,
                    lease_ttl_s=1.0, **agent_kw),
        coord=InMemoryCoordination(store), device="cpu",
        params=params_from_jax(tree, device="cpu"))


def _ref_agent(store, tree, rcfg, itype):
    return RefAgent(
        RefConfig(model_id="tiny-llama", model=rcfg, model_family=rcfg.name,
                  prefill_buckets=(32, 64, 256), **PD_KW),
        RefAgentConfig(host="127.0.0.1", model_id="tiny-llama",
                       instance_type=RefType(itype.value),
                       heartbeat_interval_s=0.3, lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), params=tree)


@pytest.fixture(scope="module")
def jax_reference(mla):
    """The JAX PD pair's and a JAX MIX agent's (text, tokens)."""
    rcfg, tree = mla
    out = {}
    for name, c in (
            ("jax_pd", _pair(lambda s, t: _ref_agent(s, tree, rcfg, t),
                             lambda s, t: _ref_agent(s, tree, rcfg, t))),
            ("jax_mix", _Cluster(lambda s: _ref_agent(s, tree, rcfg,
                                                      InstanceType.MIX)))):
        try:
            out[name] = c.serve()
        finally:
            c.stop()
    assert out["jax_mix"] == out["jax_pd"]
    assert len(out["jax_pd"][1]) == 6
    return out


@pytest.mark.parametrize("path", ["stream", "inline", "device"])
def test_mla_pd_pair_matches_the_jax_engine(mla, jax_reference, path):
    rcfg, tree = mla
    thresh = {"stream": 0, "inline": -1, "device": 0}[path]
    c = _pair(lambda s, t: _port_agent(s, tree, rcfg, t,
                                       kv_stream_threshold_bytes=thresh),
              lambda s, t: _port_agent(s, tree, rcfg, t))
    pre, dec = c.agents
    fake = None
    try:
        if path == "device":
            fake = FakeDevicePath()
            pre.kv_transfer = dec.kv_transfer = fake
            pre.linked_peers[dec.name].topology.kv_transfer_addr = \
                fake.address
        assert c.serve() == jax_reference["jax_pd"]
        if path == "device":
            assert (pre.kv_device_sent, dec.kv_device_received) == (1, 1)
            assert not fake.offers
        else:
            assert (pre.kv_host_sent, dec.kv_host_received) == (1, 1)
            assert pre.kv_stream_sent == (path == "stream")
        assert pre.engine.stats()["running"] == 0
        assert isinstance(dec.engine.kv_pages, torch.Tensor)
        assert tuple(dec.engine.kv_pages.shape[-2:]) == (16, 48)
    finally:
        if fake is not None:
            pre.kv_transfer = dec.kv_transfer = None
        c.stop()
