"""Kernel 6's plain version and the port's context-parallel decode op
against the reference (``xllm_service_tpu/ops/cp_paged_attention.py``) on
the 8 virtual CPU devices of tests/conftest.py.

- the raw per-shard statistics ``(m, l, acc)`` of ``paged_partial`` (its
  plain version on the CPU) against the TPU kernel ``_paged_partial_pallas``
  in interpret mode on the same compacted shard inputs (column 0 of its
  lane-padded m and l), with NaN in every page the shard does not own and
  occupy, and rows the shard does not touch;
- ``compact_local_table`` against a numpy transcription of
  ``_local_partial_kernelized`` (cp_paged_attention.py:262-279);
- ``cp_paged_attention`` against the reference's at seq 2 and 4, through
  both reference bodies (XLA; Pallas in interpret mode), mirroring
  tests/test_cp_paged_attention.py;
- ``paged_partial_split_plain`` (the CUDA kernel's passes over the
  compacted slots) at splits 1/2/3/8 against the interpret-mode kernel's
  raw statistics, and, at page sizes 8, 16 and 32, against the plain
  version for a shard that owns only a row's last, partial page or none
  of it: the split units tile the owned slots and nothing past them is
  read.

Tolerance rtol/atol 2e-5 in f32, as tests/test_cp_paged_attention.py: both
sides attend in f32 and differ only in summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.ops.attention import paged_attention_xla
from xllm_service_tpu.ops.cp_paged_attention import (
    _paged_partial_pallas,
    cp_paged_attention as ref_cp_paged_attention,
)
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu.parallel.mesh import build_mesh as ref_build_mesh
from xllm_service_tpu_torch.ops.cp_paged_attention import (
    ShardedPages,
    compact_local_table,
    cp_paged_attention,
    cp_tables,
    merge_partials,
    paged_partial,
    paged_partial_plain,
    partial_split_count,
    paged_partial_split_plain,
)
from xllm_service_tpu_torch.ops.paged_attention import (
    NEG_INF,
    UNIT,
    paged_attention_plain,
    split_count,
    split_unit_range,
)
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

TOL = dict(rtol=2e-5, atol=2e-5)


def make_case(B=4, pages=32, n_kv=2, ps=16, hd=32, H=4, seed=0):
    """tests/test_cp_paged_attention.py's case: tables interleave pages
    from every shard's range."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(pages, n_kv, ps, hd)).astype(np.float32)
    v = rng.normal(size=(pages, n_kv, ps, hd)).astype(np.float32)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pt = rng.permutation(pages)[:B * 4].reshape(B, 4).astype(np.int32)
    clens = rng.integers(5, 4 * ps, B).astype(np.int32)
    return q, k, v, pt, clens


def compact_numpy(pt, clens, lo, P_loc, ps):
    """numpy transcription of _local_partial_kernelized:262-279."""
    local_idx = pt - lo
    owned = (local_idx >= 0) & (local_idx < P_loc)
    owned &= np.arange(pt.shape[1])[None, :] * ps < clens[:, None]
    order = np.argsort(~owned, axis=1, kind="stable")
    local_pt = np.take_along_axis(np.where(owned, local_idx, 0), order, 1)
    starts = np.where(np.take_along_axis(owned, order, 1), order * ps,
                      clens[:, None])
    return (local_pt.astype(np.int32), starts.astype(np.int32),
            owned.sum(1).astype(np.int32))


def _cpu_mesh(n):
    return build_mesh(MeshConfig(seq=n), ["cpu"] * n)


def _ref_mesh(n):
    return ref_build_mesh(RefMeshConfig(seq=n), devices=jax.devices()[:n])


def _shards(pages, n):
    return list(torch.from_numpy(pages).chunk(n))


def _nan_outside_owned(k, v, pt, clens, lo, P_loc, ps):
    """Copies of one shard's pages with NaN in every slot that is not on an
    owned, occupied page at a position below the row's context."""
    keep = np.zeros((P_loc, ps), bool)
    for b in range(pt.shape[0]):
        for j, page in enumerate(pt[b]):
            if lo <= page < lo + P_loc:
                for t in range(ps):
                    if j * ps + t < clens[b]:
                        keep[page - lo, t] = True
    keep = keep[:, None, :, None]
    return (np.where(keep, k[lo:lo + P_loc], np.nan).astype(np.float32),
            np.where(keep, v[lo:lo + P_loc], np.nan).astype(np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_compaction_matches_reference_transcription(n):
    q, k, v, pt, clens = make_case(B=6, seed=1)
    pt[0] = 0                                  # an inactive slot
    clens[0] = 1
    clens[1] = 0
    P_loc, ps = 32 // n, 16
    for d in range(n):
        want = compact_numpy(pt, clens, d * P_loc, P_loc, ps)
        got = compact_local_table(torch.from_numpy(pt),
                                  torch.from_numpy(clens), d * P_loc, P_loc,
                                  ps)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
        # cp_tables builds the same tables per shard.
        tabs = cp_tables(torch.from_numpy(pt), torch.from_numpy(clens),
                         ShardedPages(_shards(k, n), _cpu_mesh(n)))
        for g, w in zip(tabs[d][:3], want):
            np.testing.assert_array_equal(g.numpy(), w)


SHARD_CASES = [(2, 0), (2, 1), (4, 1), (4, 3)]


@functools.lru_cache(maxsize=None)
def _raw_stats_case(n: int, d: int) -> tuple:
    """Shard d of n: its compacted inputs (NaN in every slot it must not
    read) and the TPU kernel's raw (m, l, acc) in interpret mode, as numpy.
    Row 0 sits on the garbage page with ctx 1 (owned by shard 0 only); row
    3 keeps every page in shard 0's range, so shards d > 0 own none of
    it."""
    q, k, v, pt, clens = make_case(B=4, hd=128, H=8, n_kv=2, seed=5)
    P_loc, ps = 32 // n, 16
    pt[0] = 0
    clens[0] = 1
    pt[3] = np.array([1, 2, 3, 4]) % P_loc
    clens[3] = 50
    lo = d * P_loc
    local_pt, starts, n_local = compact_numpy(pt, clens, lo, P_loc, ps)
    ks, vs = _nan_outside_owned(k, v, pt, clens, lo, P_loc, ps)
    scale = float(1.0 / np.sqrt(128))
    m_ref, l_ref, acc_ref = _paged_partial_pallas(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(local_pt), jnp.asarray(starts), jnp.asarray(n_local),
        jnp.asarray(clens), scale=scale, interpret=True)
    inputs = (q, ks, vs, local_pt, starts, n_local, clens)
    want = (np.asarray(m_ref)[..., 0], np.asarray(l_ref)[..., 0],
            np.asarray(acc_ref))
    return inputs, want, scale


def _check_raw_stats(got, want, n_local):
    m, l, acc = got
    assert m.dtype == l.dtype == acc.dtype == torch.float32
    assert m.shape == l.shape == want[0].shape and acc.shape == want[2].shape
    np.testing.assert_allclose(m.numpy(), want[0], **TOL)
    np.testing.assert_allclose(l.numpy(), want[1], **TOL)
    np.testing.assert_allclose(acc.numpy(), want[2], **TOL)
    for b in range(m.shape[0]):
        if n_local[b] == 0:
            # A row the shard does not touch: the merge weighs it 0.
            assert (m[b] == NEG_INF).all() and (l[b] == 0).all()
            assert (acc[b] == 0).all()


@pytest.mark.parametrize("n,d", SHARD_CASES)
def test_partial_matches_pallas_kernel_raw_stats(n, d):
    """Raw (m, l, acc) of one shard: the plain version against the TPU
    kernel in interpret mode (see _raw_stats_case)."""
    inputs, want, scale = _raw_stats_case(n, d)
    got = paged_partial(*[torch.from_numpy(x) for x in inputs], scale=scale)
    _check_raw_stats(got, want, inputs[5])
    if d > 0:
        assert inputs[5][3] == 0


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("n,d", SHARD_CASES)
def test_split_plain_matches_pallas_kernel_raw_stats(n, d, splits):
    """The kernel's passes at several split counts (a row owns at most 4
    entries, 4 units: at 8 splits half are empty) against the TPU kernel's
    raw statistics; untouched rows exact."""
    inputs, want, scale = _raw_stats_case(n, d)
    got = paged_partial_split_plain(*[torch.from_numpy(x) for x in inputs],
                                    scale=scale, splits=splits)
    _check_raw_stats(got, want, inputs[5])


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("n_local", [0, 1])
def test_split_plain_tiles_the_compacted_slots(ps, n_local):
    """One row whose shard owns only its last, partial page (table entry 1,
    ctx ps + ps // 2 + 1), or none of it. The split units tile the owned
    slots [0, n_local * ps) in order; a unit that runs past them (ps 8: its
    second half is entry 1, past n_local, on local page 0) reads nothing
    there. NaN fills every slot but the visible ones, and the statistics
    match the plain version (exactly, for a row with nothing owned)."""
    rng = np.random.default_rng(ps + n_local)
    n_kv, G, hd, mp, P_loc = 2, 2, 32, 4, 4
    ctx = ps + ps // 2 + 1
    k = rng.normal(size=(P_loc, n_kv, ps, hd)).astype(np.float32)
    v = rng.normal(size=(P_loc, n_kv, ps, hd)).astype(np.float32)
    keep = np.zeros((P_loc, ps), bool)
    keep[2, :ctx - ps] = n_local == 1         # the owned page's live slots
    k = np.where(keep[:, None, :, None], k, np.nan).astype(np.float32)
    v = np.where(keep[:, None, :, None], v, np.nan).astype(np.float32)
    q = rng.normal(size=(1, n_kv * G, hd)).astype(np.float32)
    local_pt = np.array([[2 if n_local else 0, 0, 0, 0]], np.int32)
    starts = np.array([[ps if n_local else ctx, ctx, ctx, ctx]], np.int32)
    args = [torch.from_numpy(x) for x in (
        q, k, v, local_pt, starts, np.array([n_local], np.int32),
        np.array([ctx], np.int32))]
    want = paged_partial_plain(*args)
    owned = n_local * ps
    for splits in (1, 2, 3, 8):
        slots = []
        for sp in range(splits):
            u0, u1, lo = split_unit_range(owned, 0, splits, sp)
            assert lo == 0 and u0 * UNIT >= len(slots)
            slots += range(u0 * UNIT, max(u0, u1) * UNIT)
        assert slots == list(range(-(-owned // UNIT) * UNIT))
        got = paged_partial_split_plain(*args, splits=splits)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            if n_local:
                np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
            else:
                assert torch.equal(g, w)
    if n_local == 0:
        assert (want[0] == NEG_INF).all() and (want[1] == 0).all()


@pytest.mark.parametrize("batch,max_pages,shards,want", [
    (8, 64, 4, 1),     # the timing shape: 16 entries, 256 slots a row
    (8, 128, 4, 2),    # the serving table: 512 slots, two splits of 256
    (1, 128, 4, 2),    # one row: still no split below 256 slots
    (8, 128, 1, 4),    # one shard: kernel 1's count
    (8, 4, 4, 1),      # a table shorter than one split
])
def test_partial_split_count(batch, max_pages, shards, want):
    got = partial_split_count(batch, 8, max_pages, 16, 132, shards, 2)
    assert got == want
    assert got <= split_count(batch, 8, -(-max_pages // shards), 16, 132,
                             2)


@pytest.mark.parametrize("sp", [2, 4])
def test_matches_reference_xla_body(sp):
    q, k, v, pt, clens = make_case()
    mesh = _ref_mesh(sp)
    with mesh:
        want = jax.jit(lambda *a: ref_cp_paged_attention(
            *a, mesh=mesh))(q, k, v, pt, clens)
    got = cp_paged_attention(torch.from_numpy(q), _shards(k, sp),
                             _shards(v, sp), torch.from_numpy(pt),
                             torch.from_numpy(clens), _cpu_mesh(sp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    single = paged_attention_xla(q, k, v, pt, clens)
    np.testing.assert_allclose(got.numpy(), np.asarray(single), **TOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("H,n_kv", [(4, 4), (8, 2)])
def test_matches_reference_pallas_body(monkeypatch, sp, H, n_kv):
    """The reference's kernel path (interpret mode) against the port's CP
    op at hd 128."""
    monkeypatch.setenv("XLLM_PALLAS_INTERPRET", "1")
    q, k, v, pt, clens = make_case(hd=128, H=H, n_kv=n_kv, seed=5)
    mesh = _ref_mesh(sp)
    with mesh:
        want = ref_cp_paged_attention(q, k, v, pt, clens, mesh=mesh)
    got = cp_paged_attention(torch.from_numpy(q), _shards(k, sp),
                             _shards(v, sp), torch.from_numpy(pt),
                             torch.from_numpy(clens), _cpu_mesh(sp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gqa_and_garbage_pages_against_reference_and_single_device():
    """GQA grouping, a row on the garbage page (ctx 1) and an inactive row
    (ctx 0, attends nothing: zeros), at seq 4."""
    q, k, v, pt, clens = make_case(H=8, n_kv=2, seed=3)
    pt[0] = 0
    clens[0] = 1
    clens[2] = 0
    mesh = _ref_mesh(4)
    with mesh:
        want = ref_cp_paged_attention(q, k, v, pt, clens, mesh=mesh)
    qt, ptt, ct = (torch.from_numpy(x) for x in (q, pt, clens))
    got = cp_paged_attention(qt, _shards(k, 4), _shards(v, 4), ptt, ct,
                             _cpu_mesh(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    single = paged_attention_plain(qt, torch.from_numpy(k),
                                   torch.from_numpy(v), ptt, ct)
    np.testing.assert_allclose(got.numpy(), single.numpy(), **TOL)
    assert (got[2] == 0).all()


def test_nan_outside_owned_pages_does_not_leak():
    """Every shard's pool holds NaN except on the pages some row owns and
    occupies: the CP op stays finite and equal to single-device attention
    on a clean pool."""
    q, k, v, pt, clens = make_case(H=8, n_kv=2, seed=7)
    n, P_loc, ps = 4, 8, 16
    k_sh, v_sh = [], []
    for d in range(n):
        ks, vs = _nan_outside_owned(k, v, pt, clens, d * P_loc, P_loc, ps)
        k_sh.append(torch.from_numpy(ks))
        v_sh.append(torch.from_numpy(vs))
    qt, ptt, ct = (torch.from_numpy(x) for x in (q, pt, clens))
    got = cp_paged_attention(qt, k_sh, v_sh, ptt, ct, _cpu_mesh(n))
    assert torch.isfinite(got).all()
    want = paged_attention_plain(qt, torch.from_numpy(k),
                                 torch.from_numpy(v), ptt, ct)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_merge_weighs_an_empty_shard_zero():
    """One shard's partial over everything, the others empty: the merge is
    that shard's normalised output; all empty gives zeros."""
    rng = np.random.default_rng(2)
    m = torch.from_numpy(rng.normal(size=(2, 4)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 3, size=(2, 4)).astype(np.float32))
    acc = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    empty = (torch.full((2, 4), NEG_INF), torch.zeros((2, 4)),
             torch.zeros((2, 4, 8)))
    got = merge_partials([empty, (m, l, acc), empty])
    torch.testing.assert_close(got, acc / l[..., None])
    assert (merge_partials([empty, empty]) == 0).all()
