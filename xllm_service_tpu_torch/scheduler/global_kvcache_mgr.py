"""Global prefix-KV-cache index.

Parity: reference `scheduler/managers/global_kvcache_mgr.{h,cpp}`
(SURVEY.md §2.5): a replicated map ``block-hash → CacheLocations{hbm,dram,
ssd instance sets}``. Heartbeat deltas feed it; `match()` walks a prompt's
chained block hashes until first miss and scores candidate instances; the
master batches deltas to coordination every sync tick and replicas mirror
via watch.

Hot-path design (the cache-aware-routing data plane):

- **Chained-hash radix index, read lock-free.** Because block hash *i* is
  keyed with hash *i−1* (common/hashing.py), a prompt's hash sequence IS a
  radix path — each 16-byte key identifies a unique token prefix, so the
  tree walk collapses to ordered dict probes. The index maps raw 16-byte
  keys to **immutable** :class:`_BlockLoc` records: writers (serialized by
  ``_lock``) never mutate a record in place — they build a replacement and
  swap the dict slot, which is atomic under the GIL (RCU at entry
  granularity, the per-entry analog of instance_mgr's
  ``RoutingSnapshot``). ``match()`` therefore takes **no lock**: it reads
  the published :class:`PrefixIndex` reference once and walks; a
  concurrent ingest can only make it see the old or the new record for a
  key, never a torn one. Wholesale rebuilds (replica bootstrap, full-frame
  apply, flip) build a fresh dict off to the side and publish a new
  :class:`PrefixIndex` wrapper with one reference assignment.
- **Per-entry precomputed scores.** Each record carries a
  ``((instance, tier_weight), ...)`` tuple baked at write time, so the
  match walk does no per-block tier/getattr work — it just accumulates.
  Weights come from ``ServiceOptions.tier_weight_{hbm,dram,ssd}``.
- **Per-instance reverse index.** ``_by_instance`` maps instance → set of
  owned block keys, so ``remove_instance()`` (eviction) touches only that
  instance's blocks — O(owned), not O(index).
- **Binary frame sync.** The master coalesces each sync tick's delta into
  ONE coordination key (``XLLM:CACHE:FRAME:<seq>``, rpc/wire.py
  ``encode_kv_frame``: msgpack with raw 16-byte keys, base64-wrapped)
  instead of one JSON-valued key per block. Replicas decode one blob per
  tick — outside the lock — and batch-apply. Every
  ``kvcache_frame_compact_every`` frames (and on promotion) the master
  writes a full-state frame and prunes the log, which is also how
  replicas bootstrap. Compaction is ONE coordination revision
  (``bulk_apply``: legacy-key prune + frame install in a single watch
  batch) and replicas apply such batches copy-on-write, so an active
  multi-master frontend's ``match()`` never observes the half-pruned
  intermediate. Legacy per-block ``XLLM:CACHE:<hex>`` JSON keys remain
  readable (bootstrap + watch) for mixed-version clusters.
- **No dirty/removed resurrection.** The frame log is ordered: a
  ``remove_instance`` racing an in-flight upload lands its removals in
  the *next* frame, which replicas apply after the current one — a
  deleted key can be transiently visible downstream for one tick but
  always converges to deleted, and the local index (what ``match`` reads)
  is never touched by upload at all.
"""

from __future__ import annotations

import threading

import json
from typing import Any, Iterable, Optional, Sequence

from ..common.config import ServiceOptions
from ..common.hashing import as_key, prefix_block_hashes
from ..common.types import CacheLocations, KvCacheEvent, OverlapScores
from ..coordination.base import CoordinationClient, KeyEvent, WatchEventType
from ..devtools import ownership as _ownership
from ..devtools import rcu
from ..devtools.locks import make_lock
from ..rpc import CACHE_FRAME_KEY_PREFIX, CACHE_KEY_PREFIX
from ..rpc.wire import decode_kv_frame, encode_kv_frame
from ..utils import get_logger

logger = get_logger(__name__)

# Default tier weights for scoring: an HBM hit is worth more than a
# DRAM/SSD hit (those require onload before reuse). The reference scores
# matched block counts per instance (`global_kvcache_mgr.cpp:73-131`);
# tiering the score is our refinement of the HBM→DRAM→SSD demotion chain
# it maintains (`global_kvcache_mgr.cpp:177-225`). Deployments tune via
# ServiceOptions.tier_weight_{hbm,dram,ssd}.
TIER_WEIGHTS = {"hbm": 1.0, "dram": 0.6, "ssd": 0.3}

_EMPTY: frozenset = frozenset()


class _BlockLoc:
    """One block's location record — IMMUTABLE once published. Writers
    build a replacement and swap the index slot; readers hold whichever
    version they grabbed. ``scored`` is the match-walk payload: per-holder
    (instance, tier weight), precomputed so the walk does no tier
    dispatch."""

    __slots__ = ("hbm", "dram", "ssd", "scored")

    def __init__(self, hbm: Iterable[str] = (), dram: Iterable[str] = (),
                 ssd: Iterable[str] = (),
                 weights: tuple[float, float, float] = (1.0, 0.6, 0.3)):
        # Intern empty tiers: at fleet scale most blocks live in exactly
        # one tier, and three per-entry frozenset allocations would
        # dominate the index's memory footprint.
        self.hbm = frozenset(hbm) if hbm else _EMPTY
        self.dram = frozenset(dram) if dram else _EMPTY
        self.ssd = frozenset(ssd) if ssd else _EMPTY
        w_hbm, w_dram, w_ssd = weights
        self.scored = tuple(
            [(i, w_hbm) for i in self.hbm]
            + [(i, w_dram) for i in self.dram]
            + [(i, w_ssd) for i in self.ssd])

    def empty(self) -> bool:
        return not self.scored

    def holders(self) -> Iterable[str]:
        return (i for i, _ in self.scored)

    def has(self, inst: str) -> bool:
        return inst in self.hbm or inst in self.dram or inst in self.ssd

    def to_row(self) -> list[list[str]]:
        return [sorted(self.hbm), sorted(self.dram), sorted(self.ssd)]


def _build_by_instance(blocks: "dict[bytes, _BlockLoc]") -> dict[str, set]:
    """Reverse index (instance → owned keys) for a freshly built blocks
    dict — bootstrap and full-frame apply share this."""
    by_instance: dict[str, set[bytes]] = {}
    for h, loc in blocks.items():
        for inst in loc.holders():
            by_instance.setdefault(inst, set()).add(h)
    return by_instance


class PrefixIndex:
    """Published read view (RCU). ``blocks`` maps raw 16-byte chained
    block hash → :class:`_BlockLoc`. Delta writers share this dict and
    swap immutable entries (atomic under the GIL); wholesale rebuilds
    publish a fresh wrapper. Readers must grab ``.blocks`` once and walk
    that local reference."""

    __slots__ = ("blocks",)

    def __init__(self, blocks: Optional[dict] = None):
        self.blocks: dict[bytes, _BlockLoc] = blocks if blocks is not None else {}


@_ownership.verify_state
class GlobalKVCacheMgr:
    def __init__(self, coord: CoordinationClient, block_size: int = 128,
                 is_master: bool = True,
                 options: Optional[ServiceOptions] = None):
        self._coord = coord
        self._block_size = block_size
        self._is_master = is_master
        if options is not None:
            self._weights = (options.tier_weight_hbm,
                             options.tier_weight_dram,
                             options.tier_weight_ssd)
            self._compact_every = max(1, options.kvcache_frame_compact_every)
        else:
            self._weights = (TIER_WEIGHTS["hbm"], TIER_WEIGHTS["dram"],
                             TIER_WEIGHTS["ssd"])
            self._compact_every = 64
        # Writer lock: serializes index WRITERS only (ingest, eviction,
        # frame apply, bootstrap). match() never takes it.
        self._lock = make_lock("global_kvcache_mgr.cache", order=26)  # lock-order: 26
        self._snapshot = rcu.publish(PrefixIndex(), "kvcache.index")
        # Reverse index: instance → keys it holds (any tier). Keeps
        # remove_instance / eviction O(blocks owned by that instance).
        self._by_instance: dict[str, set[bytes]] = {}
        # Master-side pending delta for the upload loop
        # (`global_kvcache_mgr.cpp:227-247`).
        self._dirty: set[bytes] = set()
        self._removed: set[bytes] = set()
        # Frame log cursor (next seq to write) + compaction countdown.
        self._frame_seq = 0
        self._frames_since_full = 0
        # While a wholesale rebuild (bootstrap / flip) is in flight, watch
        # deliveries park here (parsed, not yet applied) and are replayed
        # onto the fresh index inside the publishing lock hold — an event
        # that lands between the coordination dump and the publish would
        # otherwise be applied to the dict being thrown away. Replaying a
        # suffix of the ordered frame log is convergent (upserts carry
        # absolute per-key rows).
        self._bootstrap_buffer: Optional[list] = []
        self._watch_id: Optional[int] = None
        if not is_master:
            self._watch_id = coord.add_watch(CACHE_KEY_PREFIX, self._on_cache_event)
        self._load_existing()

    def frame_log_seq(self) -> int:
        """Next frame-log sequence number (lock-free read of an int —
        fleet-observability gauge; a replica lagging this has not applied
        the newest coordination frames)."""
        return self._frame_seq

    # ------------------------------------------------------------ bootstrap
    def _load_existing(self) -> None:
        """Rebuild the index from coordination: legacy per-block JSON keys
        first, then binary frames in seq order (a frame's view of a key
        wins). A corrupt value — legacy or frame — skips only itself. The
        fresh index is published wholesale; a concurrent watch/ingest
        writer serializes behind ``_lock``."""
        dump = self._coord.get_prefix(CACHE_KEY_PREFIX)
        frames: list[tuple[str, str]] = []
        legacy: list[tuple[str, str]] = []
        for key, val in dump.items():
            if key.startswith(CACHE_FRAME_KEY_PREFIX):
                frames.append((key, val))
            else:
                legacy.append((key, val))
        frames.sort()
        # Parse OUTSIDE the lock.
        blocks: dict[bytes, _BlockLoc] = {}
        for key, val in legacy:
            h = as_key(key[len(CACHE_KEY_PREFIX):])
            if h is None:
                continue
            try:
                loc = CacheLocations.from_dict(json.loads(val))
            except (json.JSONDecodeError, TypeError):
                continue
            blocks[h] = self._make_loc(loc.hbm, loc.dram, loc.ssd)
        max_seq = -1
        parsed_frames = []
        for key, val in frames:
            try:
                seq = int(key[len(CACHE_FRAME_KEY_PREFIX):])
            except ValueError:
                continue
            max_seq = max(max_seq, seq)
            try:
                parsed_frames.append(decode_kv_frame(val))
            except ValueError:
                logger.warning("skipping corrupt kv frame %s", key)
        with self._lock:
            for upserts, removals, full in parsed_frames:
                if full:
                    blocks = {}
                self._apply_frame_into(blocks, upserts, removals)
            self._by_instance = _build_by_instance(blocks)
            self._frame_seq = max(self._frame_seq, max_seq + 1)
            self._snapshot = rcu.publish(PrefixIndex(blocks), "kvcache.index")
            # Replay watch deliveries that raced the rebuild, then disarm.
            buffered = self._bootstrap_buffer or []
            self._bootstrap_buffer = None
            for ops in buffered:
                self._apply_parsed_locked(ops)

    def _make_loc(self, hbm=(), dram=(), ssd=()) -> _BlockLoc:
        return _BlockLoc(hbm, dram, ssd, self._weights)

    def _apply_frame_into(self, blocks: dict[bytes, _BlockLoc],
                          upserts: dict[bytes, Any],
                          removals: Sequence[bytes]) -> None:
        # Removals first: upserts carry ABSOLUTE per-key state, so on any
        # (malformed) overlap the upsert must win.
        for h in removals:
            k = as_key(h)
            if k is not None:
                blocks.pop(k, None)
        for h, row in upserts.items():
            k = as_key(h)
            if k is None:
                continue
            try:
                loc = self._make_loc(row[0], row[1], row[2])
            except (IndexError, TypeError):
                continue
            if loc.empty():
                blocks.pop(k, None)
            else:
                blocks[k] = loc

    # ---------------------------------------------------------------- match
    def match(self, token_ids: Sequence[int] = (),
              block_hashes: Optional[Sequence[bytes]] = None) -> OverlapScores:
        """Walk full blocks of the prompt; accumulate per-instance scores
        until the first block absent from the global index (reference
        `global_kvcache_mgr.cpp:73-131`). LOCK-FREE: reads the published
        index reference once and probes immutable entries. Callers with
        memoized hashes (Request.prefix_hashes) pass ``block_hashes`` and
        skip re-hashing."""
        if block_hashes is None:
            block_hashes = prefix_block_hashes(token_ids, self._block_size)
        blocks = self._snapshot.blocks
        scores: dict[str, float] = {}
        matched = 0
        get = blocks.get
        for h in block_hashes:
            loc = get(h)
            if loc is None:
                break
            matched += 1
            for inst, weight in loc.scored:
                scores[inst] = scores.get(inst, 0.0) + weight
        return OverlapScores(scores=scores, max_block_num=len(block_hashes),
                             matched_blocks=matched)

    # -------------------------------------------------------------- ingest
    def record_updated_kvcaches(self, instance: str, event: KvCacheEvent) -> None:
        """Heartbeat delta ingest (reference `global_kvcache_mgr.cpp:177-225`):
        stored → HBM set; offloaded → demote HBM→DRAM→SSD; removed → erase
        everywhere. Keys may be raw bytes (msgpack heartbeats) or hex
        strings (legacy JSON heartbeats); garbage keys are skipped."""
        if event.empty():
            return
        # Normalize outside the lock.
        stored = [k for k in map(as_key, event.stored) if k is not None]
        offloaded = [k for k in map(as_key, event.offloaded) if k is not None]
        removed = [k for k in map(as_key, event.removed) if k is not None]
        with self._lock:
            blocks = rcu.thaw(self._snapshot.blocks,
                              "entry-level RCU writer: immutable _BlockLoc "
                              "slot swaps are atomic under the GIL")
            owned = self._by_instance.setdefault(instance, set())
            for h in stored:
                loc = blocks.get(h)
                if loc is None:
                    blocks[h] = self._make_loc(hbm=(instance,))
                else:
                    blocks[h] = self._make_loc(
                        loc.hbm | {instance}, loc.dram - {instance},
                        loc.ssd - {instance})
                owned.add(h)
                self._dirty.add(h)
                # Invariant: a key is pending-removal XOR pending-upsert.
                # A re-store after a removal in the same sync window must
                # cancel the removal, or the frame would carry both and
                # replicas would apply the delete last (divergence).
                self._removed.discard(h)
            for h in offloaded:
                loc = blocks.get(h)
                if loc is None:
                    blocks[h] = self._make_loc(dram=(instance,))
                elif instance in loc.hbm:
                    blocks[h] = self._make_loc(
                        loc.hbm - {instance}, loc.dram | {instance}, loc.ssd)
                elif instance in loc.dram:
                    blocks[h] = self._make_loc(
                        loc.hbm, loc.dram - {instance}, loc.ssd | {instance})
                else:
                    blocks[h] = self._make_loc(
                        loc.hbm, loc.dram | {instance}, loc.ssd)
                owned.add(h)
                self._dirty.add(h)
                self._removed.discard(h)
            for h in removed:
                loc = blocks.get(h)
                owned.discard(h)
                if loc is None or not loc.has(instance):
                    continue
                nxt = self._make_loc(loc.hbm - {instance},
                                     loc.dram - {instance},
                                     loc.ssd - {instance})
                if nxt.empty():
                    del blocks[h]
                    self._removed.add(h)
                    self._dirty.discard(h)
                else:
                    blocks[h] = nxt
                    self._dirty.add(h)
            if not owned:
                self._by_instance.pop(instance, None)

    def remove_instance(self, instance: str) -> None:
        """Drop a dead instance from every block it holds — O(blocks owned
        by that instance) via the reverse index, not O(index)."""
        with self._lock:
            blocks = rcu.thaw(self._snapshot.blocks,
                              "entry-level RCU writer: immutable _BlockLoc "
                              "slot swaps are atomic under the GIL")
            removed, dirty = self._removed, self._dirty
            for h in self._by_instance.pop(instance, ()):
                loc = blocks.get(h)
                if loc is None:
                    continue
                if len(loc.scored) == 1 and loc.scored[0][0] == instance:
                    # Sole holder (the overwhelmingly common case for a
                    # dead instance's private blocks): plain delete, no
                    # record rebuild.
                    del blocks[h]
                    removed.add(h)
                    dirty.discard(h)
                    continue
                nxt = self._make_loc(loc.hbm - {instance},
                                     loc.dram - {instance},
                                     loc.ssd - {instance})
                if nxt.empty():
                    del blocks[h]
                    removed.add(h)
                    dirty.discard(h)
                else:
                    blocks[h] = nxt
                    dirty.add(h)

    # ------------------------------------------------------- sync (master)
    def upload_kvcache(self) -> None:
        """Master: batched delta upload (reference
        `global_kvcache_mgr.cpp:227-247`) as ONE binary frame per tick;
        every `kvcache_frame_compact_every` frames the full state is
        written instead and the older log pruned (also the replica
        bootstrap path). Frame encode + coordination I/O run outside the
        index lock."""
        if not self._is_master:
            # Write-lease discipline (multi-master): frame publishing is
            # master-only — a demoted master's straggler tick must not
            # interleave its stale view into the new master's log.
            return
        with self._lock:
            full = self._frames_since_full >= self._compact_every
            blocks = self._snapshot.blocks
            if full:
                # Consistent point-in-time capture; row building and
                # encoding run outside the lock (entries are immutable,
                # only the dict itself must not be iterated unlocked).
                items = list(blocks.items())
                removals: list[bytes] = []
            else:
                if not self._dirty and not self._removed:
                    return
                items = [(h, blocks[h]) for h in self._dirty if h in blocks]
                removals = list(self._removed)
            self._dirty.clear()
            self._removed.clear()
            seq = self._frame_seq
            self._frame_seq += 1
            self._frames_since_full = 0 if full else self._frames_since_full + 1
        upserts = {h: loc.to_row() for h, loc in items}
        frame = encode_kv_frame(upserts, removals, full=full)
        key = f"{CACHE_FRAME_KEY_PREFIX}{seq:020d}"
        if full:
            # Compaction is ONE coordination revision (`bulk_apply`):
            # prune the stale legacy per-block keys AND install the
            # full-state frame in a single watch batch, DELETEs first.
            # A replica applies the whole batch copy-on-write (see
            # `_apply_parsed_locked`), so its lock-free `match()` jumps
            # straight from the pre-compaction index to the complete
            # post-frame index — no half-pruned intermediate, and the
            # legacy-deletes-after-frame permanent-loss ordering bug
            # can't occur because there is no cross-revision ordering
            # left to get wrong. Old FRAME keys are pruned after (frame
            # DELETEs are ignored by replicas, and keeping them until
            # the new full frame is durable means a bootstrapping
            # replica always sees a complete log).
            stale = list(self._coord.get_prefix(CACHE_KEY_PREFIX))
            legacy_stale = [k for k in stale
                            if not k.startswith(CACHE_FRAME_KEY_PREFIX)]
            frame_stale = [k for k in stale
                           if k.startswith(CACHE_FRAME_KEY_PREFIX)
                           and k != key]
            self._coord.bulk_apply({key: frame}, legacy_stale)
            if frame_stale:
                self._coord.bulk_rm(frame_stale)
        else:
            self._coord.bulk_set({key: frame})

    def _on_cache_event(self, events: list[KeyEvent], _prefix: str) -> None:
        """Replica mirror (reference `global_kvcache_mgr.cpp:133-175`).
        Frames and legacy values are parsed OUTSIDE the lock; the batch is
        applied in one hold, in DELIVERY ORDER (a legacy delete before a
        full frame must not be reordered after it — compaction relies on
        it). A corrupt frame/value skips only itself."""
        ops: list[tuple] = []   # ("frame", upserts, removals, full) |
        #                         ("legacy", key, _BlockLoc-or-None)
        for ev in events:
            rest = ev.key[len(CACHE_KEY_PREFIX):]
            if rest.startswith("FRAME:"):
                if ev.type != WatchEventType.PUT:
                    continue   # compaction pruning its own log
                try:
                    upserts, removals, full = decode_kv_frame(ev.value)
                except ValueError:
                    logger.warning("skipping corrupt kv frame event %s", ev.key)
                    continue
                ops.append(("frame", upserts, removals, full))
                continue
            h = as_key(rest)
            if h is None:
                continue
            if ev.type == WatchEventType.PUT:
                try:
                    loc = CacheLocations.from_dict(json.loads(ev.value))
                except (json.JSONDecodeError, TypeError):
                    continue
                ops.append(("legacy", h, self._make_loc(loc.hbm, loc.dram,
                                                        loc.ssd)))
            else:
                ops.append(("legacy", h, None))
        if not ops:
            return
        with self._lock:
            if self._bootstrap_buffer is not None:
                # A wholesale rebuild is in flight: park the parsed batch;
                # the rebuild replays it onto the fresh index.
                self._bootstrap_buffer.append(ops)
                return
            self._apply_parsed_locked(ops)

    def _apply_parsed_locked(self, ops: list) -> None:
        # Delta batches (frame ticks, legacy per-block sync from an old
        # master) take the in-place path: entry-level RCU swaps into the
        # shared dict, O(batch) with incremental reverse-index upkeep —
        # each op is an independent block, so per-entry swaps never
        # expose an incoherent index. Only a batch carrying a FULL-state
        # frame (compaction, promotion) applies COPY-ON-WRITE: the whole
        # batch lands in a side dict published with ONE reference swap,
        # so a lock-free match() walking the superseded index sees a
        # complete pre-batch generation — never the half-applied state
        # (compaction's legacy prune without its full frame).
        cow = any(op[0] != "legacy" and op[3] for op in ops)
        if cow:
            blocks = dict(self._snapshot.blocks)
            for op in ops:
                if op[0] == "legacy":
                    _, h, loc = op
                    if loc is None or loc.empty():
                        blocks.pop(h, None)
                    else:
                        blocks[h] = loc
                    continue
                _, upserts, removals, full = op
                if full:
                    blocks = {}
                self._apply_frame_into(blocks, upserts, removals)
            self._by_instance = _build_by_instance(blocks)
            self._snapshot = rcu.publish(PrefixIndex(blocks), "kvcache.index")
            return
        for op in ops:
            if op[0] == "legacy":
                _, h, loc = op
                if loc is None or loc.empty():
                    self._drop_key_locked(h)
                else:
                    self._put_key_locked(h, loc)
                continue
            _, upserts, removals, _full = op
            for h in removals:
                k = as_key(h)
                if k is not None:
                    self._drop_key_locked(k)
            for h, row in upserts.items():
                k = as_key(h)
                if k is None:
                    continue
                try:
                    loc = self._make_loc(row[0], row[1], row[2])
                except (IndexError, TypeError):
                    continue
                if loc.empty():
                    self._drop_key_locked(k)
                else:
                    self._put_key_locked(k, loc)

    def _unindex_locked(self, inst: str, h: bytes) -> None:
        s = self._by_instance.get(inst)
        if s is not None:
            s.discard(h)
            if not s:
                del self._by_instance[inst]

    def _put_key_locked(self, h: bytes, loc: _BlockLoc) -> None:
        blocks = rcu.thaw(self._snapshot.blocks,
                          "entry-level RCU writer: immutable _BlockLoc "
                          "slot swaps are atomic under the GIL")
        old = blocks.get(h)
        if old is not None:
            for inst in old.holders():
                if not loc.has(inst):
                    self._unindex_locked(inst, h)
        for inst in loc.holders():
            self._by_instance.setdefault(inst, set()).add(h)
        blocks[h] = loc

    def _drop_key_locked(self, h: bytes) -> None:
        old = rcu.thaw(self._snapshot.blocks,
                       "entry-level RCU writer: immutable _BlockLoc "
                       "slot swaps are atomic under the GIL").pop(h, None)
        if old is not None:
            for inst in old.holders():
                self._unindex_locked(inst, h)

    # ---------------------------------------------------------- mastership
    def set_as_master(self) -> None:
        if self._is_master:
            return
        self._is_master = True
        if self._watch_id is not None:
            self._coord.remove_watch(self._watch_id)
            self._watch_id = None
        # Frame seqs must keep increasing past the old master's
        # (coordination read stays outside the index lock).
        tail = self._coord_frame_tail()
        with self._lock:
            # Converge the log to THIS node's view: the next upload
            # writes a full-state frame (and prunes what the old master
            # left behind).
            self._frames_since_full = self._compact_every
            self._frame_seq = max(self._frame_seq, tail + 1)

    def _coord_frame_tail(self) -> int:
        tail = -1
        for k in self._coord.get_prefix(CACHE_FRAME_KEY_PREFIX):
            try:
                tail = max(tail, int(k[len(CACHE_FRAME_KEY_PREFIX):]))
            except ValueError:
                continue
        return tail

    def set_as_replica(self) -> None:
        if not self._is_master:
            return
        self._is_master = False
        # Arm the bootstrap buffer BEFORE the watch starts delivering, so
        # nothing lands on the index that _load_existing is replacing.
        with self._lock:
            if self._bootstrap_buffer is None:
                self._bootstrap_buffer = []
        if self._watch_id is None:
            self._watch_id = self._coord.add_watch(CACHE_KEY_PREFIX,
                                                   self._on_cache_event)
        self._load_existing()

    def num_blocks(self) -> int:
        return len(self._snapshot.blocks)

    def stop(self) -> None:
        if self._watch_id is not None:
            self._coord.remove_watch(self._watch_id)
            self._watch_id = None
