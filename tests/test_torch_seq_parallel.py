"""Context-parallel serving: the port's engine on a ``seq=4`` mesh (four
CPU shards of the KV pool) against the reference engine on the same mesh
(four of the virtual CPU devices of tests/conftest.py) and against the
port's single-device engine, on shared tiny f32 weights
(``llama_params_from_jax``), with tests/test_seq_parallel.py's config.

Greedy tokens are compared exactly: short prompts prefill into the sharded
pool by the standard route, a long prefix-free prompt by the ring (used
once), its re-send hits the prefix cache (ring not used), and every decode
step attends through the context-parallel op. After serving, the port's
shards concatenated equal the reference's sharded pool within 1e-5 (f32
arithmetic in another order), the garbage page 0 excluded.
"""

import threading

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
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=512,
                 seq_parallel_min_tokens=64)
SHORT = list(range(40, 70))                          # 30 tokens < 64
LONG = [(i * 11 + 5) % 300 + 10 for i in range(100)]  # ring route


def port_cfg(**kw) -> EngineConfig:
    return EngineConfig(model=tiny_config(dtype=torch.float32,
                                          max_context_len=512),
                        **{**ENGINE_KW, **kw})


def cpu_mesh(**axes):
    cfg = MeshConfig(**axes)
    return build_mesh(cfg, ["cpu"] * cfg.num_devices())


class Collector:
    def __init__(self):
        self.tokens = []
        self.done = threading.Event()

    def __call__(self, out) -> None:
        for s in out.outputs:
            self.tokens.extend(s.token_ids)
        if out.finished:
            self.done.set()


def run_one(engine, prompt, n=5):
    is_ref = isinstance(engine, RefEngine)
    req_cls, sp_cls = ((RefRequest, RefSampling) if is_ref
                       else (EngineRequest, SamplingParams))
    col = Collector()
    engine.submit(req_cls("sp1", token_ids=prompt, on_output=col,
                          sampling=sp_cls(max_tokens=n, temperature=0.0,
                                          ignore_eos=True)))
    for _ in range(400):
        if col.done.is_set():
            break
        engine.step()
    assert col.done.is_set()
    return col.tokens


@pytest.fixture(scope="module")
def served():
    """The three engines after serving SHORT, LONG and LONG again, with
    each one's tokens and the route counts after each request."""
    mcfg = ref_tiny(dtype=jnp.float32, max_context_len=512)
    tree = ref_llama.init_params(mcfg, jax.random.PRNGKey(0))
    ref = RefEngine(RefConfig(model=mcfg, prefill_buckets=(32, 64, 128, 512),
                              mesh=RefMeshConfig(seq=4), **ENGINE_KW),
                    params=tree)
    ref_ring = {"n": 0}
    for name in ("_prefill_install_sp", "_prefill_install_sp_nc"):
        real = getattr(ref, name)

        def spy(*a, _real=real, **k):
            ref_ring["n"] += 1
            return _real(*a, **k)

        setattr(ref, name, spy)

    def port_params():
        return llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu")

    port = InferenceEngine(port_cfg(), device="cpu", params=port_params(),
                           mesh=cpu_mesh(seq=4))
    single = InferenceEngine(port_cfg(), device="cpu", params=port_params())
    out = {"ref": [], "port": [], "single": [], "ring": []}
    for prompt in (SHORT, LONG, LONG):
        out["ref"].append(run_one(ref, prompt))
        out["port"].append(run_one(port, prompt))
        out["single"].append(run_one(single, prompt))
        out["ring"].append((ref_ring["n"], port.ring_prefills,
                            single.ring_prefills))
    return ref, port, single, out


def test_greedy_tokens_match_reference_and_single_device(served):
    _, port, _, out = served
    assert port.seq_parallel == 4
    assert isinstance(port.kv_pages, ShardedPages)
    assert len(port.kv_pages.shards) == 4
    assert port.kv_pages.shards[0].shape == (2, 2, 16, 2, 16, 32)
    assert out["port"] == out["ref"] == out["single"]
    assert all(len(t) == 5 for t in out["port"])


def test_ring_route_taken_once(served):
    """SHORT: standard route; LONG: the ring, once; LONG again: a prefix
    hit, standard route. The reference takes the same routes."""
    _, port, single, out = served
    assert out["ring"] == [(0, 0, 0), (1, 1, 0), (1, 1, 0)]
    assert port.stats()["prefix_hits"] == 1


def test_pool_matches_reference_pool(served):
    ref, port, _, _ = served
    want = np.asarray(ref._dstate["kv"])
    got = port.kv_pages.full().numpy()
    assert got.shape == want.shape == (2, 2, 64, 2, 16, 32)
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], rtol=1e-5,
                               atol=1e-5)


def test_num_pages_divisibility_enforced():
    with pytest.raises(ValueError, match="num_pages"):
        InferenceEngine(port_cfg(num_pages=63), device="cpu",
                        mesh=cpu_mesh(seq=4))


@pytest.mark.parametrize("axes", [dict(model=2), dict(data=2, seq=2),
                                  dict(expert=2), dict(pipe=2)])
def test_other_mesh_axes_not_ported(axes):
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        InferenceEngine(port_cfg(), device="cpu", mesh=cpu_mesh(**axes))


def test_config_mesh_needs_distinct_devices():
    """A mesh from the config takes distinct devices from
    mesh_device_offset and raises when the machine has fewer (the CPU is
    one device), as the reference does; repeated devices come only from a
    mesh the caller names."""
    with pytest.raises(ValueError, match="only 1 are attached"):
        InferenceEngine(port_cfg(mesh=MeshConfig(seq=4)), device="cpu")
    with pytest.raises(ValueError, match="only 1 are attached"):
        InferenceEngine(port_cfg(mesh=MeshConfig(), mesh_device_offset=1),
                        device="cpu")
    eng = InferenceEngine(port_cfg(mesh=MeshConfig()), device="cpu")
    assert eng.seq_parallel == 1 and isinstance(eng.kv_pages, torch.Tensor)


def test_mesh_device_count_must_match():
    with pytest.raises(ValueError, match="needs 4 devices"):
        build_mesh(MeshConfig(seq=4), ["cpu"] * 3)
