"""The qwen2_vl family on a seq mesh: the port's engine at ``seq=2`` against
the reference engine on the same mesh (two of the virtual CPU devices of
tests/conftest.py) and against the port's single-device engine, on the
same tiny f32 weights (the reference's ``init_params`` with biases and
norm scales drawn non-zero, ``params_from_jax``) and the same visual rows.

Each engine serves an image prompt (never the ring: its placeholders take
visual rows), a long text prompt of odd length (the ring, its suffix
padded by one token to a multiple of the axis, with its M-RoPE rows
zero-padded to the same length) and that prompt again (a prefix hit).
Every decode step rotates rope at the index plus the slot's M-RoPE delta
over the sharded pool. Greedy tokens are identical on the three engines,
the ring counts equal (a spy on the reference's ``_prefill_install_sp``
/ ``_prefill_install_sp_nc``), and the port's shards concatenated equal
the reference's sharded pool within 1e-5, the garbage page 0 excluded.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu_torch.engine import EngineConfig, InferenceEngine
from xllm_service_tpu_torch.models.qwen2_vl import mrope_positions
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops.cp_paged_attention import ShardedPages

from test_torch_chunked_prefill import step_until
from test_torch_gemma import drawn_tree
from test_torch_moe_seq_parallel import cpu_mesh, spy_ring
from test_torch_qwen2_vl import port_config
from test_torch_vl_engine import rows, submitter

IMG = 100
ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=512,
                 seq_parallel_min_tokens=64)
IMAGE = list(range(10, 22)) + [IMG] * 4 + list(range(30, 45))    # 31
LONG = [(i * 11 + 5) % 300 + 110 for i in range(101)]   # ring, padded
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def served():
    rcfg = ref_vl.tiny_vl_config(dtype=jnp.float32, max_context_len=512,
                                 image_token_id=IMG)
    tree = drawn_tree(rcfg)
    ref = RefEngine(RefConfig(model=rcfg, model_family="qwen2_vl",
                              prefill_buckets=(32, 64, 128, 512),
                              mesh=RefMeshConfig(seq=2), **ENGINE_KW),
                    params=tree)
    ring = spy_ring(ref)
    port_kw = dict(model=port_config(rcfg), model_family="qwen2_vl",
                   **ENGINE_KW)
    port = InferenceEngine(EngineConfig(**port_kw), device="cpu",
                           params=params_from_jax(tree, device="cpu"),
                           mesh=cpu_mesh(2))
    single = InferenceEngine(EngineConfig(**port_kw), device="cpu",
                             params=params_from_jax(tree, device="cpu"))
    engines = {"ref": ref, "port": port, "single": single}
    toks = {k: [] for k in engines}
    rings = []
    for i, (prompt, mm) in enumerate(((IMAGE, rows(1, 4)), (LONG, None),
                                      (LONG, None))):
        for name, eng in engines.items():
            col = submitter(eng, name == "ref")(f"r{i}", prompt, 6, mm)
            step_until(eng, [col])
            toks[name].append(col.tokens)
        rings.append((ring["n"], port.ring_prefills, single.ring_prefills))
    yield ref, port, toks, rings
    for eng in engines.values():
        eng.stop()


def test_greedy_tokens_match_reference_and_single_device(served):
    _, port, toks, _ = served
    assert isinstance(port.kv_pages, ShardedPages)
    assert len(port.kv_pages.shards) == 2
    assert toks["port"] == toks["ref"] == toks["single"]
    assert all(len(t) == 6 for t in toks["port"])
    # The image prompt's delta moved its decode positions; the text
    # prompts' is zero.
    assert mrope_positions(IMAGE, IMG)[1] < 0
    assert mrope_positions(LONG, IMG)[1] == 0


def test_ring_counts_match(served):
    """The image prompt: the standard route; the long text prompt: the
    ring, once, with one padding row; its re-send: a prefix hit."""
    _, port, _, rings = served
    assert len(LONG) % 2 == 1
    assert rings == [(0, 0, 0), (1, 1, 0), (1, 1, 0)]
    assert port.stats()["prefix_hits"] == 1


def test_pool_matches_reference_pool(served):
    ref, port, _, _ = served
    want = np.asarray(ref._dstate["kv"])
    got = port.kv_pages.full().numpy()
    assert got.shape == want.shape == (2, 2, 64, 2, 16, 32)
    assert np.abs(got[:, :, 1:]).max() > 0
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], **POOL_TOL)


def test_mrope_rows_padded_to_the_ring_length():
    """The install's M-RoPE rows take the padded suffix's length, the
    padding rows zero, as the reference's ``_mrope_chunk(..., S)``."""
    eng = InferenceEngine(EngineConfig(
        model=port_config(ref_vl.tiny_vl_config(dtype=jnp.float32,
                                                image_token_id=IMG)),
        model_family="qwen2_vl", **ENGINE_KW), device="cpu",
        mesh=cpu_mesh(2))
    try:
        pos, delta = eng._mrope_chunk(IMAGE, 0, len(IMAGE), 32)
        want, want_delta = mrope_positions(IMAGE, IMG)
        assert pos.shape == (32, 3) and delta == want_delta
        np.testing.assert_array_equal(pos[:len(IMAGE)], want)
        assert not pos[len(IMAGE):].any()
        assert eng._mrope_chunk(IMAGE, 4, 20)[0].shape == (16, 3)
    finally:
        eng.stop()
