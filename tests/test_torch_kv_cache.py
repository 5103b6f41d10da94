"""The port's page manager and block hashing against the reference's: a
scripted alloc/match/store/free/evict sequence must give the same page
ids, matches, events and hashes (they are the keys the global prefix index
routes on)."""

import numpy as np
import pytest

from xllm_service_tpu.common import hashing as ref_hashing
from xllm_service_tpu.engine import kv_cache as ref_kv
from xllm_service_tpu_torch.common import hashing
from xllm_service_tpu_torch.engine import kv_cache


@pytest.mark.parametrize("block_size", [4, 16, 128])
def test_block_hashes_match_reference(block_size):
    rng = np.random.default_rng(block_size)
    tokens = rng.integers(0, 128256, size=4 * block_size - 1).tolist()
    want = ref_hashing.prefix_block_hashes(tokens, block_size)
    got = hashing.prefix_block_hashes(tokens, block_size)
    assert got == want and len(got) == 3
    assert hashing.prefix_block_hash_hexes(tokens, block_size) == \
        ref_hashing.prefix_block_hash_hexes(tokens, block_size)
    assert hashing.hash_block(b"", tokens[:block_size]) == \
        ref_hashing.hash_block(b"", tokens[:block_size])
    # Incremental extension continues the same chain.
    assert hashing.extend_prefix_block_hashes(got[:1], tokens, block_size) \
        == want
    assert hashing.as_key(want[0].hex()) == want[0]
    assert hashing.as_key("zz") is None


def _script(mod):
    """Drive one page manager through alloc/match/store/free/evict and
    record everything observable."""
    mgr = mod.KVPageManager(num_pages=13, page_size=4, hash_block_size=8)
    log = []
    a = list(range(100, 124))            # 3 blocks
    b = a[:16] + list(range(500, 508))   # shares 2 blocks with a
    c = list(range(900, 924))            # unrelated, forces eviction

    pages_a = mgr.allocate(6)
    log.append(("alloc a", pages_a, mgr.num_free))
    stored, donated = mgr.store_prefix(a, pages_a)
    log.append(("store a", stored, sorted(donated)))
    seq_a = mod.SequencePages(own_pages=pages_a, donated_hashes=stored,
                              donated_pages=donated)
    n, pages, hashes = mgr.match_prefix(b)
    log.append(("match b", n, pages, hashes))
    own_b = mgr.allocate(2)
    log.append(("alloc b", own_b))
    seq_b = mod.SequencePages(cached_hashes=hashes, cached_pages=pages,
                              own_pages=own_b)
    st_b, don_b = mgr.store_prefix(b, seq_b.all_pages, skip_blocks=2)
    seq_b.donated_hashes, seq_b.donated_pages = st_b, don_b
    log.append(("store b", st_b, sorted(don_b)))
    seq_a.release(mgr)
    seq_b.release(mgr)
    log.append(("free", mgr.num_free, mgr.cached_block_count(),
                round(mgr.usage_perc(), 6)))
    # Needs more pages than are free: evicts unreferenced blocks LRU-first.
    pages_c = mgr.allocate(8)
    log.append(("alloc c", pages_c, mgr.num_free, mgr.cached_block_count()))
    log.append(("too many", mgr.allocate(50)))
    ev = mgr.drain_events()
    log.append(("events", ev.stored, ev.removed, ev.offloaded, ev.empty()))
    log.append(("drained", mgr.drain_events().empty()))
    mgr.free(pages_c + [mod.GARBAGE_PAGE])
    log.append(("refree", mgr.num_free))
    return log


def _tier_script(mod):
    """The tier hand-off: with tiering on, evictions divert to
    drain_evicted (no `removed`), onloaded blocks install as `stored`, and
    match_block stitches single HBM blocks."""
    mgr = mod.KVPageManager(num_pages=9, page_size=4, hash_block_size=8)
    mgr.enable_tiering(True)
    log = []
    a = list(range(100, 124))            # 3 blocks = 6 pages
    pages_a = mgr.allocate(6)
    stored, donated = mgr.store_prefix(a, pages_a)
    mgr.release_prefix(stored)
    log.append(("store a", stored, sorted(donated)))
    pages_c = mgr.allocate(5)            # evicts a's two oldest blocks
    log.append(("alloc c", pages_c, mgr.drain_evicted(), mgr.drain_evicted()))
    log.append(("match_block", mgr.match_block(stored[2]),
                mgr.match_block(stored[0])))
    mgr.free(pages_c)
    fresh = mgr.allocate(2)
    log.append(("install", mgr.install_block(stored[0], fresh),
                mgr.install_block(stored[0], fresh)))
    n, pages, hashes = mgr.match_prefix(a)
    log.append(("match a", n, pages, hashes))
    ev = mgr.drain_events()
    log.append(("events", ev.stored, ev.removed, ev.offloaded))
    mgr.enable_tiering(False)
    mgr.release_prefix(hashes + [stored[2]])
    mgr.release_prefix([stored[0]])
    log.append(("plain evict", mgr.allocate(8), mgr.drain_evicted(),
                mgr.drain_events().removed))
    return log


def test_scripted_sequence_matches_reference():
    assert _script(kv_cache) == _script(ref_kv)


def test_tier_handoff_matches_reference():
    assert _tier_script(kv_cache) == _tier_script(ref_kv)


def test_tail_page_never_donated():
    mgr = kv_cache.KVPageManager(num_pages=16, page_size=4,
                                 hash_block_size=8)
    pages = mgr.allocate(3)
    stored, donated = mgr.store_prefix(list(range(12)), pages)
    assert len(stored) == 1 and donated == set(pages[:2])
    with pytest.raises(ValueError):
        kv_cache.KVPageManager(num_pages=16, page_size=4, hash_block_size=6)
