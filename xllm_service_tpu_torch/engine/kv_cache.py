"""Host-side KV page management: allocator + block-hash prefix cache.

A copy of ``xllm_service_tpu/engine/kv_cache.py``, tier hand-off included:
the same page ids, prefix matches, LRU eviction order and ``KvCacheEvent``
deltas, so the global prefix index sees the same identities from either
engine.

Page 0 is reserved as the garbage page: inactive batch slots in the decode
step write their K/V there, never corrupting live data.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..common.hashing import prefix_block_hashes
from ..common.types import KvCacheEvent
from ..devtools.locks import make_lock

GARBAGE_PAGE = 0


@dataclass
class CachedBlock:
    """One reusable hash block: `pages_per_block` pages of KV."""

    hash_hex: str
    pages: list[int]
    ref_count: int = 0


class KVPageManager:
    def __init__(self, num_pages: int, page_size: int,
                 hash_block_size: int):
        # Donation granularity is FULL hash blocks of whole pages: a
        # partially-filled tail page is never donated, so it stays private
        # to its sequence.
        if hash_block_size % page_size != 0:
            raise ValueError(
                "hash_block_size must be a whole number of pages")
        self.page_size = page_size
        self.hash_block_size = hash_block_size
        self.pages_per_block = hash_block_size // page_size
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, GARBAGE_PAGE, -1))
        self._lock = make_lock("kv_cache.pages", order=54)  # lock-order: 54
        # hash hex -> CachedBlock, LRU-ordered (oldest first).
        self._blocks: OrderedDict[str, CachedBlock] = OrderedDict()
        # Heartbeat delta accumulators.
        self._stored: list[str] = []
        self._removed: list[str] = []
        # Tiered eviction: with a cold-tier store attached (engine/
        # kv_tier.py), evicted blocks are handed to the engine for async
        # offload instead of being reported `removed` outright. The engine
        # drains this right after every allocate() and enqueues the device
        # gather BEFORE any kernel that reuses the pages (stream order
        # makes the capture exact). The tier store then reports
        # `offloaded` on completion (or `removed` on a drop).
        self._tiering = False
        self._evicted_pending: list[tuple[str, list[int]]] = []

    # ------------------------------------------------------------ alloc/free
    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    def usage_perc(self) -> float:
        usable = self.num_pages - 1
        with self._lock:
            return 1.0 - len(self._free) / usable if usable else 1.0

    def allocate(self, n: int) -> Optional[list[int]]:
        """Allocate n pages, evicting unreferenced cached blocks LRU-first
        if needed. Returns None if impossible."""
        if n <= 0:
            return []
        with self._lock:
            while len(self._free) < n and self._evict_one_locked():
                pass
            if len(self._free) < n:
                return None
            return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        with self._lock:
            self._free.extend(p for p in pages if p != GARBAGE_PAGE)

    def _evict_one_locked(self) -> bool:
        for h, blk in self._blocks.items():
            if blk.ref_count == 0:
                del self._blocks[h]
                self._free.extend(blk.pages)
                if self._tiering:
                    self._evicted_pending.append((h, list(blk.pages)))
                else:
                    self._removed.append(h)
                return True
        return False

    def enable_tiering(self, on: bool) -> None:
        """Divert evictions to :meth:`drain_evicted` (a tier store is
        attached) instead of reporting them `removed`."""
        with self._lock:
            self._tiering = on

    def drain_evicted(self) -> list[tuple[str, list[int]]]:
        """Tier-eviction hand-off: (hash, pages) of blocks evicted since the
        last drain. The pages are already back on the free list, so the
        caller must enqueue its device gather before any kernel that could
        reuse them (every engine allocate() is followed by a drain)."""
        with self._lock:
            out = self._evicted_pending
            self._evicted_pending = []
            return out

    def install_block(self, hash_hex: str, pages: list[int]) -> bool:
        """Register an ONLOADED block (tier -> HBM): the pages now hold the
        restored KV and belong to the cache; the caller gets a reference
        (release via release_prefix). Reports `stored`. Returns False (the
        caller frees the pages) if the hash is already cached."""
        with self._lock:
            if hash_hex in self._blocks:
                return False
            self._blocks[hash_hex] = CachedBlock(hash_hex, list(pages),
                                                 ref_count=1)
            self._stored.append(hash_hex)
            return True

    # ---------------------------------------------------------- prefix cache
    def match_prefix(self, token_ids: Sequence[int],
                     block_hashes: Optional[Sequence[bytes]] = None,
                     ) -> tuple[int, list[int], list[str]]:
        """Longest cached prefix: returns (num_tokens_matched, page_ids,
        block_hashes) and takes a reference on each matched block.
        Callers that already hashed the prompt pass ``block_hashes``."""
        hashes = (block_hashes if block_hashes is not None
                  else prefix_block_hashes(token_ids, self.hash_block_size))
        pages: list[int] = []
        matched_hashes: list[str] = []
        with self._lock:
            for h in hashes:
                hx = h.hex()
                blk = self._blocks.get(hx)
                if blk is None:
                    break
                blk.ref_count += 1
                self._blocks.move_to_end(hx)
                pages.extend(blk.pages)
                matched_hashes.append(hx)
        return len(matched_hashes) * self.hash_block_size, pages, matched_hashes

    def match_block(self, hash_hex: str) -> Optional[list[int]]:
        """Single-block HBM hit: take a reference on `hash_hex` if it is
        cached. The tier-onload walk uses this to stitch blocks still
        resident in HBM BEYOND a cold gap back into the prefix
        (match_prefix alone stops at the first HBM miss)."""
        with self._lock:
            blk = self._blocks.get(hash_hex)
            if blk is None:
                return None
            blk.ref_count += 1
            self._blocks.move_to_end(hash_hex)
            return list(blk.pages)

    def release_prefix(self, block_hashes: Sequence[str]) -> None:
        with self._lock:
            for hx in block_hashes:
                blk = self._blocks.get(hx)
                if blk is not None and blk.ref_count > 0:
                    blk.ref_count -= 1

    def store_prefix(self, token_ids: Sequence[int],
                     seq_pages: Sequence[int],
                     skip_blocks: int = 0,
                     block_hashes: Optional[Sequence[bytes]] = None,
                     ) -> tuple[list[str], set[int]]:
        """After prefill, donate the sequence's full blocks to the cache.

        `seq_pages` are ALL of the sequence's pages in order (shared prefix
        pages first, then private); blocks already matched from cache
        (skip_blocks) are not re-stored. Returns (stored_hashes,
        donated_page_ids): donated pages now belong to the cache — the
        sequence keeps using them under a reference and must not free them.
        """
        hashes = (block_hashes if block_hashes is not None
                  else prefix_block_hashes(token_ids, self.hash_block_size))
        stored: list[str] = []
        donated: set[int] = set()
        with self._lock:
            for i, h in enumerate(hashes):
                if i < skip_blocks:
                    continue
                hx = h.hex()
                if hx in self._blocks:
                    continue
                pages = list(seq_pages[i * self.pages_per_block:
                                       (i + 1) * self.pages_per_block])
                if len(pages) < self.pages_per_block:
                    break
                self._blocks[hx] = CachedBlock(hx, pages, ref_count=1)
                self._stored.append(hx)
                stored.append(hx)
                donated.update(pages)
        return stored, donated

    def cached_block_count(self) -> int:
        with self._lock:
            return len(self._blocks)

    # ------------------------------------------------------------ heartbeat
    def drain_events(self) -> KvCacheEvent:
        """Collect the stored/removed delta since the last drain."""
        with self._lock:
            ev = KvCacheEvent(stored=self._stored, removed=self._removed)
            self._stored = []
            self._removed = []
            return ev


@dataclass
class SequencePages:
    """Per-sequence page ownership: prefix-cache blocks (shared, referenced)
    + privately allocated tail pages."""

    cached_hashes: list[str] = field(default_factory=list)
    cached_pages: list[int] = field(default_factory=list)
    own_pages: list[int] = field(default_factory=list)
    donated_hashes: list[str] = field(default_factory=list)
    donated_pages: set[int] = field(default_factory=set)
    # Full chained hash list of the prompt, computed once at admission and
    # reused by the post-prefill store_prefix writeback (no re-hash).
    block_hashes: Optional[list] = None

    @property
    def all_pages(self) -> list[int]:
        return self.cached_pages + self.own_pages

    def release(self, mgr: KVPageManager) -> None:
        """Return resources at sequence end: drop refs on shared blocks
        (matched and self-donated); free private pages that were NOT donated
        to the cache (those now belong to the cache)."""
        mgr.release_prefix(self.cached_hashes)
        mgr.release_prefix(self.donated_hashes)
        mgr.free([p for p in self.own_pages if p not in self.donated_pages])
