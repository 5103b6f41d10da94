"""The port's ring attention against the reference's
(``xllm_service_tpu/ops/ring_attention.py``) on the virtual CPU devices of
tests/conftest.py, at seq 2 and 4, with and without GQA, and against the
port's own dense causal prefill; mirrors tests/test_models_extra.py's
TestRingAttention.

Tolerance rtol/atol 2e-5: both sides compute in f32 and differ only in
summation order (the reference's own ring tests hold it against dense
attention at 2e-4).
"""

import jax
import numpy as np
import pytest
import torch

from xllm_service_tpu.ops.ring_attention import (
    ring_attention as ref_ring_attention,
)
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu.parallel.mesh import build_mesh as ref_build_mesh
from xllm_service_tpu_torch.ops.attention import prefill_attention
from xllm_service_tpu_torch.ops.ring_attention import ring_attention
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(B, S, H, H_kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, H_kv, hd)).astype(np.float32),
            rng.normal(size=(B, S, H_kv, hd)).astype(np.float32))


@pytest.mark.parametrize("sp,B,S,H,H_kv", [
    (4, 2, 64, 4, 4),      # test_matches_dense_causal's shapes
    (2, 1, 32, 2, 2),      # test_ring_degree_2's shapes
    (4, 2, 64, 8, 2),      # GQA: K/V rotate at 2 heads
    (2, 1, 48, 4, 1),
])
def test_matches_reference_ring(sp, B, S, H, H_kv):
    q, k, v = _inputs(B, S, H, H_kv, 32, seed=sp * 10 + H)
    mesh = ref_build_mesh(RefMeshConfig(seq=sp), devices=jax.devices()[:sp])
    with mesh:
        want = ref_ring_attention(q, k, v, mesh, seq_axis="seq")
    port_mesh = build_mesh(MeshConfig(seq=sp), ["cpu"] * sp)
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         port_mesh, seq_axis="seq")
    assert got.shape == (B, S, H, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # And the port's own dense causal prefill (no pool).
    dense = prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              None, None, None,
                              torch.zeros((B,), dtype=torch.int32),
                              torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


def test_end_padding_leaves_valid_queries_exact():
    """The engine pads a ring prefill's suffix at the end: the valid
    queries' outputs do not depend on what the padding holds."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 40, 4, 2, 32, 9))
    mesh = build_mesh(MeshConfig(seq=4), ["cpu"] * 4)
    a = ring_attention(q, k, v, mesh)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    for t in (q2, k2, v2):
        t[:, 37:] = 1e3
    b = ring_attention(q2, k2, v2, mesh)
    assert torch.equal(a[:, :37], b[:, :37])


def test_sequence_must_divide_over_the_axis():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 30, 2, 2, 32, 0))
    with pytest.raises(ValueError, match="divide"):
        ring_attention(q, k, v, build_mesh(MeshConfig(seq=4), ["cpu"] * 4))
