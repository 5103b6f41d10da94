"""The port's KV tiers against the reference's.

Store level: the port's ``TieredKVStore`` and the reference's run the same
scripted sequences, the seven cases of
tests/test_kv_tiering.py::TestTieredKVStore (round trip, DRAM overflow
demoting to SSD, SSD corruption failing one block, same-window event
cancel, saturated pump drops, discard superseding an in-flight offload,
disabled store), in f32 and bf16. Each script asserts what the reference's
test asserts and records what it saw: the bytes fetched back, every
``drain_events()`` and the final ``stats()``. Both stores must record the
same trace.

Engine level: the port's engine and the reference engine on shared weights
through evict -> offload -> onload (tests/test_kv_tiering.py::
TestEngineTierRoundTrip): identical greedy tokens before and after the
round trip, on both engines and between them, the same stored / offloaded /
removed event counts, and the port's pool pages after the onload equal bit
for bit to a gather taken before the eviction.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fakes import wait_until as _wait_until
from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine import kv_tier as ref_tier
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.common.hashing import prefix_block_hashes
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.engine import kv_tier as port_tier
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops.page_dma import gather_kv_pages

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

BLOCK_SHAPE = (2, 2, 2, 1, 4, 8)        # [L, 2, ppb, n_kv, ps, hd]


def wait_until(pred, timeout: float = 10.0) -> bool:
    """Generous: the suite runs beside other test workers."""
    return _wait_until(pred, timeout=timeout)


# ------------------------------------------------------------ store level
class Side:
    """One implementation under the shared scripts: makes stores and
    blocks, reads a fetched block's bytes."""

    def __init__(self, name: str, dtype: str):
        self.name, self.dtype = name, dtype
        self.itemsize = 4 if dtype == "f32" else 2

    def store(self, dram_blocks=4, ssd_blocks=0, **kw):
        nbytes = int(np.prod(BLOCK_SHAPE)) * self.itemsize
        if self.name == "ref":
            cls, dt = ref_tier.TieredKVStore, \
                (np.float32 if self.dtype == "f32" else jnp.bfloat16)
        else:
            cls, dt = port_tier.TieredKVStore, \
                (torch.float32 if self.dtype == "f32" else torch.bfloat16)
        return cls(BLOCK_SHAPE, dt, dram_bytes=dram_blocks * nbytes,
                   ssd_bytes=ssd_blocks * nbytes, **kw)

    def blk(self, seed: int):
        a = np.random.default_rng(seed).standard_normal(BLOCK_SHAPE) \
            .astype(np.float32)
        if self.dtype == "bf16":
            a = a.astype(ml_dtypes.bfloat16)
        if self.name == "ref":
            return a
        if self.dtype == "bf16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    def bytes(self, arr) -> bytes:
        if self.name == "ref":
            return np.asarray(arr).tobytes()
        return port_tier.block_bytes(arr)

    def host(self, blob):
        return np.asarray(blob) if self.name == "ref" else blob


def round_trip(side, trace):
    st = side.store()
    try:
        a = side.blk(1)
        assert st.offload("aa" * 16, a)
        assert wait_until(lambda: st.ready("aa" * 16))
        assert st.tier_of("aa" * 16) == "dram"
        off, rem = st.drain_events()
        assert off == ["aa" * 16] and rem == []
        trace.append((off, rem))
        got = st.fetch("aa" * 16)
        assert side.bytes(got) == side.bytes(a)
        trace.append(side.bytes(got))
        assert st.tier_of("aa" * 16) is None        # move semantics
        trace.append(st.stats())
    finally:
        st.close()


def overflow_demotes_to_ssd(side, trace):
    # One worker: installs land in offload order, so the first block is
    # the LRU victim on both sides (two workers may reorder them).
    st = side.store(dram_blocks=2, ssd_blocks=4, threads=1)
    try:
        blocks = {f"{i:02x}" * 16: side.blk(i) for i in range(3)}
        for h, arr in blocks.items():
            assert st.offload(h, arr)
        hashes = list(blocks)
        assert wait_until(lambda: st.tier_of(hashes[0]) == "ssd")
        assert st.tier_of(hashes[1]) == "dram"
        assert st.tier_of(hashes[2]) == "dram"
        assert st.demote_total == 1
        off, rem = st.drain_events()
        assert off.count(hashes[0]) == 2 and rem == []
        trace.append((sorted(off), rem))
        got = st.fetch(hashes[0])
        assert side.bytes(got) == side.bytes(blocks[hashes[0]])
        trace.append(side.bytes(got))
        trace.append(st.stats())
    finally:
        st.close()


def ssd_corruption_fails_one_block(side, trace):
    st = side.store(dram_blocks=1, ssd_blocks=4)
    try:
        h1, h2, h3 = ("11" * 16, "22" * 16, "33" * 16)
        b1, b2 = side.blk(11), side.blk(12)
        assert st.offload(h1, b1)
        assert wait_until(lambda: st.tier_of(h1) == "dram")
        assert st.offload(h2, b2)                   # demotes h1 -> SSD
        assert wait_until(lambda: st.tier_of(h1) == "ssd")
        assert st.offload(h3, side.blk(13))         # demotes h2 -> SSD
        assert wait_until(lambda: st.tier_of(h2) == "ssd")
        slot = st._ssd[h1]
        off = slot * st.block_nbytes
        st._ssd_map[off] = st._ssd_map[off] ^ 0xFF  # flip one byte
        assert st.fetch(h1) is None
        assert st.corrupt_total == 1
        trace.append(st.drain_events())
        got = st.fetch(h2)
        assert got is not None and side.bytes(got) == side.bytes(b2)
        trace.append(side.bytes(got))
        trace.append(st.stats())
    finally:
        st.close()


def same_window_onload_cancels_event(side, trace):
    st = side.store()
    try:
        assert st.offload("aa" * 16, side.blk(1))
        assert wait_until(lambda: st.ready("aa" * 16))
        assert st.fetch("aa" * 16) is not None
        off, rem = st.drain_events()
        assert off == [] and rem == []
        trace.append((off, rem))
        trace.append(st.stats())
    finally:
        st.close()


def saturated_pump_drops(side, trace):
    st = side.store(dram_blocks=8, threads=1, max_inflight=1)
    gate = threading.Event()

    def slow_fetch(blob):
        gate.wait(5)
        return side.host(blob)

    try:
        assert st.offload("aa" * 16, side.blk(1), fetch=slow_fetch)
        assert not st.ready("aa" * 16)              # fence: in flight
        assert not st.offload("bb" * 16, side.blk(2))
        assert st.offload_dropped == 1
        _, rem = st.drain_events()
        assert rem == ["bb" * 16]
        trace.append(rem)
        gate.set()
        assert wait_until(lambda: st.ready("aa" * 16))
        trace.append(st.stats())
    finally:
        gate.set()
        st.close()


def discard_supersedes_inflight(side, trace):
    st = side.store(threads=1)
    gate = threading.Event()

    def gated_fetch(blob):
        gate.wait(5)
        return side.host(blob)

    try:
        assert st.offload("aa" * 16, side.blk(1), fetch=gated_fetch)
        st.discard("aa" * 16)
        gate.set()
        assert wait_until(lambda: not st._pending)
        assert st.tier_of("aa" * 16) is None
        assert st.dram_blocks() == 0
        off, rem = st.drain_events()
        assert off == [] and rem == []
        trace.append((off, rem))
        gate.clear()
        assert st.offload("bb" * 16, side.blk(2), fetch=gated_fetch)
        st.discard("bb" * 16)
        assert st.offload("bb" * 16, side.blk(2), fetch=gated_fetch)
        gate.set()
        assert wait_until(lambda: st.ready("bb" * 16))
        off, _ = st.drain_events()
        assert off == ["bb" * 16]
        trace.append(off)
        trace.append(st.stats())
    finally:
        gate.set()
        st.close()


def disabled_store(side, trace):
    st = side.store(dram_blocks=0)
    try:
        assert not st.enabled
        assert not st.offload("aa" * 16, side.blk(1))
        trace.append(st.drain_events())
        trace.append(st.stats())
    finally:
        st.close()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("script", [
    round_trip, overflow_demotes_to_ssd, ssd_corruption_fails_one_block,
    same_window_onload_cancels_event, saturated_pump_drops,
    discard_supersedes_inflight, disabled_store,
], ids=lambda f: f.__name__)
def test_store_matches_reference(script, dtype):
    traces = {}
    for name in ("ref", "port"):
        traces[name] = []
        script(Side(name, dtype), traces[name])
    assert traces["port"] == traces["ref"]


def test_default_fetch_refuses_a_device_block():
    with pytest.raises(ValueError, match="device fetch"):
        port_tier.host_block(torch.zeros(2, device="meta"))


# ----------------------------------------------------------- engine level
ENGINE_KW = dict(page_size=16, hash_block_size=32, max_batch_size=4,
                 max_seq_len=256)


class _Collector:
    def __init__(self):
        self.tokens = []
        self.done = threading.Event()

    def __call__(self, out):
        for s in out.outputs:
            self.tokens.extend(s.token_ids)
        if out.finished:
            self.done.set()


@pytest.fixture(scope="module")
def weights():
    tree = ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))
    return tree, llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                       device="cpu")


def _port_engine(weights, **kw):
    return InferenceEngine(EngineConfig(model=tiny_config(
        dtype=torch.float32, max_context_len=256), **ENGINE_KW, **kw),
        device="cpu", params=weights[1])


def _engines(weights, **kw):
    ref = RefEngine(RefConfig(model=ref_tiny(dtype=jnp.float32,
                                             max_context_len=256),
                              prefill_buckets=(32, 64, 256), **ENGINE_KW,
                              **kw), params=weights[0])
    return ref, _port_engine(weights, **kw)


def _run(engine, rid, prompt, n):
    is_ref = isinstance(engine, RefEngine)
    req_cls, sp_cls = ((RefRequest, RefSampling) if is_ref
                       else (EngineRequest, SamplingParams))
    col = _Collector()
    engine.submit(req_cls(rid, token_ids=list(prompt),
                          sampling=sp_cls(max_tokens=n, temperature=0.0,
                                          ignore_eos=True),
                          on_output=col))
    t0 = time.monotonic()
    while not col.done.is_set():
        assert time.monotonic() - t0 < 120
        if not engine.step():
            time.sleep(0.001)
    return col.tokens


def _settled_events(engine):
    """Event counts once the tier pump is idle."""
    assert wait_until(lambda: not engine.tier_store._pending, timeout=10)
    ev = engine.drain_kv_events()
    return len(ev.stored), len(ev.offloaded), len(ev.removed)


def test_engine_round_trip_matches_reference(weights):
    prompt_a = list(range(100, 196))        # 96 tokens = 3 hash blocks
    hashes = [h.hex() for h in prefix_block_hashes(prompt_a, 32)]
    results = {}
    for engine in _engines(weights, num_pages=10,
                           kv_tier_dram_bytes=64 << 20):
        store = engine.tier_store
        assert store is not None and store.enabled
        first = _run(engine, "a1", prompt_a, 8)
        events = [_settled_events(engine)]
        assert events[0][0] == 3            # all full blocks donated
        if isinstance(engine, InferenceEngine):
            blocks = engine.page_mgr._blocks
            before = [gather_kv_pages(engine.kv_pages, blocks[h].pages)
                      for h in hashes[:2]]
        # An unrelated larger prompt evicts a's blocks into the DRAM tier.
        _run(engine, "b1", list(range(300, 428)), 8)
        assert wait_until(lambda: store.offload_total >= 3, timeout=10)
        events.append(_settled_events(engine))
        assert events[1][1] >= 3
        assert store.dram_blocks() >= 3
        # Re-admission of a: restored from DRAM ahead of the prefill.
        second = _run(engine, "a2", prompt_a, 8)
        assert second == first
        assert store.onload_total >= 2      # the last block keeps 1 token
        events.append(_settled_events(engine))
        assert events[2][0] >= 2
        results[type(engine).__module__] = (first, events, store.stats())
        if isinstance(engine, InferenceEngine):
            blocks = engine.page_mgr._blocks
            for h, want in zip(hashes[:2], before):
                got = gather_kv_pages(engine.kv_pages, blocks[h].pages)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
            engine.stop()
    (ref_first, ref_events, ref_stats), (first, events, stats) = \
        results.values()
    assert first == ref_first
    assert events == ref_events
    assert stats == ref_stats


def test_decode_not_blocked_by_saturated_pump(weights):
    tokens = []
    for engine in _engines(weights, num_pages=10,
                           kv_tier_dram_bytes=64 << 20, kv_tier_threads=1,
                           kv_tier_max_inflight=1):
        outs = []
        for i in range(6):                  # churn: every admission evicts
            out = _run(engine, f"r{i}", list(range(i * 97, i * 97 + 96)), 4)
            assert len(out) == 4
            outs.append(out)
        st = engine.tier_store.stats()
        assert st["offload_total"] + st["offload_dropped"] > 0
        tokens.append(outs)
    assert tokens[0] == tokens[1]


def test_tier_config_warnings_and_stop(weights, caplog):
    port = _port_engine(weights, num_pages=10, kv_tier_ssd_bytes=1 << 20)
    assert port.tier_store is None and not port.page_mgr._tiering
    assert "ignored" in caplog.text
    port = _port_engine(weights, num_pages=10, kv_tier_dram_bytes=100)
    assert port.tier_store is None and "below one block" in caplog.text
    port = _port_engine(weights, num_pages=10, kv_tier_dram_bytes=64 << 20,
                        kv_tier_ssd_bytes=64 << 20)
    path = port.tier_store._ssd_path
    assert os.path.exists(path) and "kv_tier" in port.stats()
    port.stop()
    assert not os.path.exists(path)         # the spill file is unlinked


def test_onload_walk_reads_a_block_before_its_evictions_land(weights):
    """The onload walk's own evictions must not demote the block it is
    about to read. Here the tier worker runs inline (the fastest a worker
    can be) and a demotion never completes, so a block fenced
    mid-demotion would stop the walk: every block of A must still be
    restored (found on the card, phase 4a: 2 of 7 onloads)."""
    prompt_a = list(range(100, 196))        # 96 tokens = 3 hash blocks
    blk = 2 * 2 * 2 * 2 * 16 * 32 * 4       # [L, 2, pages, kv, ps, hd] f32
    engine = _port_engine(weights, num_pages=10, kv_tier_dram_bytes=3 * blk,
                          kv_tier_ssd_bytes=8 * blk)
    store = engine.tier_store
    first = _run(engine, "a1", prompt_a, 8)
    _run(engine, "b1", list(range(300, 428)), 8)   # evicts A into DRAM
    assert wait_until(lambda: store.offload_total >= 3 and not store._pending)
    assert store.dram_blocks() == 3

    class Inline:
        def submit(self, fn, *args):
            fn(*args)

    spills = []
    store._executor, pool = Inline(), store._executor
    store._spill_to_ssd, spill = (lambda h, arr: spills.append((h, arr)),
                                  store._spill_to_ssd)
    try:
        assert _run(engine, "a2", prompt_a, 8) == first
        assert store.onload_total == 2     # the last block keeps 1 token
    finally:
        store._executor, store._spill_to_ssd = pool, spill
        for h, arr in spills:
            spill(h, arr)
        engine.stop()
