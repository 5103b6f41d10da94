"""Tiered KV-cache store: DRAM (host RAM) and SSD (disk spill) tiers behind
the engine's page manager.

A copy of ``xllm_service_tpu/engine/kv_tier.py`` with the same semantics,
holding torch tensors instead of numpy arrays:

- **DRAM tier = one host arena.** A preallocated block-slot tensor of the
  pool's dtype (``capacity_bytes // block_nbytes`` slots) with explicit
  free-list accounting; pinned when the engine runs on CUDA, so the
  device->host download and the host->device upload are asynchronous
  copies.
- **SSD tier = mmap'd spill file** of the same slot layout, with a
  per-block BLAKE2b checksum of the block's bytes recorded at write time
  and verified on read: a corrupt slot fails only itself (the block is
  dropped and reported `removed`; the prefix walk stops there).
- **Bounded transfer executor.** Offload (download + arena write) and
  DRAM->SSD demotion run on a small thread pool with a hard in-flight cap;
  when the pump is saturated new offloads are DROPPED (reported as plain
  evictions) rather than queued without bound, so the engine thread never
  waits on tier I/O.
- **Completion fences.** A block is `ready()` only after its tier write
  completed; admission checks the fence, so a half-written block is a
  cache miss.
- **Move semantics.** A block lives in exactly ONE tier: offload HBM->DRAM,
  demote DRAM->SSD, onload removes the cold copy (the page manager's
  `stored` event reports the HBM promotion).
- **Tier-transition events.** HBM->DRAM and DRAM->SSD are reported as
  `offloaded`, capacity and corruption drops as `removed`.

The reference wraps this class in development-time verifiers (lock-order,
ownership, lifecycle and RCU checks from its ``devtools`` package); the
port takes none of them and guards its state with one plain lock.
"""

from __future__ import annotations

import hashlib
import logging
import math
import mmap
import os
import tempfile
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import torch

from ..devtools import lifecycle as _lifecycle
from ..devtools import ownership as _ownership
from ..devtools import rcu
from ..devtools.locks import make_lock

logger = logging.getLogger(__name__)


def host_block(blob: Any) -> torch.Tensor:
    """Default fetch: the block is already a host tensor (or array). A
    device block must come with the engine's own fetch, which downloads it
    on a side stream."""
    t = torch.as_tensor(blob)
    if t.device.type != "cpu":
        raise ValueError(f"kv tier: a {t.device} block needs the engine's "
                         "device fetch")
    return t


def block_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a host block (what the SSD tier writes and
    checksums; for bf16 the same bytes the reference's arrays hold)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@_ownership.verify_state
class TieredKVStore:
    """Host-side cold tiers for evicted prefix-cache blocks.

    One per engine. All public methods are non-blocking for the engine
    thread except :meth:`fetch` (a host memcpy / mmap read of one block).
    Thread-safe; the lock is never held across device work, file I/O
    beyond one mmap slice copy, or another lock.
    """

    def __init__(self, block_shape: tuple, dtype: torch.dtype,
                 dram_bytes: int = 0, ssd_bytes: int = 0,
                 ssd_path: str = "", threads: int = 2,
                 max_inflight: int = 8, pin_memory: bool = False):
        self.block_shape = tuple(block_shape)
        self.dtype = dtype
        self.block_nbytes = math.prod(self.block_shape) * \
            torch.empty((), dtype=dtype).element_size()
        self.dram_capacity_blocks = max(0, dram_bytes // self.block_nbytes)
        self.ssd_capacity_blocks = max(0, ssd_bytes // self.block_nbytes)
        self._pin = pin_memory
        # Host arena: one contiguous slab, slot-addressed.
        self._arena = torch.zeros(
            (self.dram_capacity_blocks, *self.block_shape), dtype=dtype,
            pin_memory=pin_memory)
        self._free_dram = list(range(self.dram_capacity_blocks - 1, -1, -1))
        self._dram: "OrderedDict[str, int]" = OrderedDict()   # LRU: old first
        # SSD spill file (sparse until written).
        self._ssd_path = ssd_path
        self._ssd_file = None
        self._ssd_map: Optional[mmap.mmap] = None
        self._owns_ssd_file = False
        if self.ssd_capacity_blocks > 0:
            if not ssd_path:
                fd, ssd_path = tempfile.mkstemp(prefix="xllm-kv-spill-",
                                                suffix=".bin")
                os.close(fd)
                self._ssd_path = ssd_path
                self._owns_ssd_file = True
            self._ssd_file = open(ssd_path, "w+b")
            self._ssd_file.truncate(
                self.ssd_capacity_blocks * self.block_nbytes)
            self._ssd_map = mmap.mmap(self._ssd_file.fileno(),
                                      self.ssd_capacity_blocks
                                      * self.block_nbytes)
        self._free_ssd = list(range(self.ssd_capacity_blocks - 1, -1, -1))
        self._ssd: "OrderedDict[str, int]" = OrderedDict()
        self._sums: dict[str, bytes] = {}        # SSD per-block checksums
        self._lock = make_lock("kv_tier.store", order=55)  # lock-order: 55
        # Completion fences: hashes whose tier write is in flight.
        self._pending: set[str] = set()
        # In-flight offloads superseded by a discard() (the block was
        # re-donated to HBM before the worker ran): the worker drops the
        # install instead of landing a duplicate cold copy whose
        # `offloaded` event would demote an HBM-resident block.
        self._superseded: set[str] = set()
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, threads), thread_name_prefix="kv-tier")
        self._inflight = threading.Semaphore(max(1, max_inflight))
        self._closed = False
        # Heartbeat delta accumulators (hex hashes).
        self._offloaded: list[str] = []
        self._removed: list[str] = []
        # Telemetry.
        self.offload_total = 0
        self.offload_dropped = 0
        self.onload_total = 0
        self.demote_total = 0
        self.corrupt_total = 0
        self.bytes_offloaded = 0
        self.bytes_onloaded = 0

    # ------------------------------------------------------------- capacity
    @property
    def enabled(self) -> bool:
        return self.dram_capacity_blocks > 0

    def dram_blocks(self) -> int:
        with self._lock:
            return len(self._dram)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "dram_blocks": len(self._dram),
                "ssd_blocks": len(self._ssd),
                "dram_capacity_blocks": self.dram_capacity_blocks,
                "ssd_capacity_blocks": self.ssd_capacity_blocks,
                "block_nbytes": self.block_nbytes,
                "offload_total": self.offload_total,
                "offload_dropped": self.offload_dropped,
                "onload_total": self.onload_total,
                "demote_total": self.demote_total,
                "corrupt_total": self.corrupt_total,
                "bytes_offloaded": self.bytes_offloaded,
                "bytes_onloaded": self.bytes_onloaded,
            }

    def _host_copy(self, src: torch.Tensor) -> torch.Tensor:
        """A new host tensor holding ``src`` (pinned when the arena is)."""
        out = torch.empty(self.block_shape, dtype=self.dtype,
                          pin_memory=self._pin)
        out.copy_(src.reshape(self.block_shape))
        return out

    # -------------------------------------------------------------- offload
    def offload(self, hash_hex: str, blob: Any,
                fetch: Callable[[Any], torch.Tensor] = host_block) -> bool:
        """Accept an evicted block for asynchronous offload. `blob` is the
        gathered block — or a zero-arg callable producing it, invoked HERE
        on the caller's thread only once the pump has accepted the block
        (enqueued BEFORE any kernel that overwrites the pages; the lazy
        form means a saturated pump never pays for the gather it would
        drop); `fetch` turns it into a host tensor in the worker thread.
        Returns False when the block is dropped instead (pump saturated /
        store closed): the caller reports a plain eviction."""
        if not self.enabled or self._closed:
            # Still surface the drop: a swallowed eviction would leave the
            # global index believing this instance holds the block.
            with self._lock:
                self._removed.append(hash_hex)
            return False
        if self._inflight.acquire(blocking=False):
            _lifecycle.note_acquire("tier-inflight")
        else:
            # Pump saturated: dropping is the backpressure (queueing device
            # buffers without bound would pin HBM and stall the loop).
            with self._lock:
                self.offload_dropped += 1
                self._removed.append(hash_hex)
            return False
        with self._lock:
            if hash_hex in self._pending or hash_hex in self._dram \
                    or hash_hex in self._ssd:
                # A re-eviction legitimizes a superseded in-flight install
                # (same hash = same bytes — let the pending worker land).
                self._superseded.discard(hash_hex)
                self._inflight.release()
                _lifecycle.note_release("tier-inflight")
                return True     # already resident / in flight
            self._pending.add(hash_hex)
        if callable(blob):
            blob = blob()
        try:
            self._executor.submit(self._offload_worker, hash_hex, blob,
                                  fetch)
        except RuntimeError:    # shutdown race
            with self._lock:
                self._pending.discard(hash_hex)
                self._removed.append(hash_hex)
            self._inflight.release()
            _lifecycle.note_release("tier-inflight")
            return False
        return True

    def _offload_worker(self, hash_hex: str, blob: Any,
                        fetch: Callable[[Any], torch.Tensor]) -> None:
        try:
            arr = fetch(blob).to(self.dtype).reshape(self.block_shape)
            self._install_dram(hash_hex, arr)
        except Exception:  # noqa: BLE001 — worker must not die silently
            logger.exception("KV tier offload of %s failed", hash_hex[:16])
            with self._lock:
                self._pending.discard(hash_hex)
                self._removed.append(hash_hex)
        finally:
            self._inflight.release()
            _lifecycle.note_release("tier-inflight")

    def _install_dram(self, hash_hex: str, arr: torch.Tensor) -> None:
        """Land a fetched block in the arena, demoting the LRU DRAM block
        to SSD when full (the demotion write runs in THIS worker, outside
        the lock)."""
        spill: Optional[tuple[str, torch.Tensor]] = None
        with self._lock:
            if self._closed or hash_hex in self._superseded:
                # Superseded: a fresh prefill re-donated the block to HBM
                # while this offload was in flight.
                self._superseded.discard(hash_hex)
                self._pending.discard(hash_hex)
                return
            if self._free_dram:
                slot = self._free_dram.pop()
            else:
                victim_h, victim_slot = self._dram.popitem(last=False)
                # Copy the victim's bytes out under the lock (one block) so
                # its slot can be reused at once; the SSD write happens
                # outside the lock. Until it completes the victim is fenced.
                spill = (victim_h, self._arena[victim_slot].clone())
                self._pending.add(victim_h)
                slot = victim_slot
            self._arena[slot].copy_(arr)
            self._dram[hash_hex] = slot
            self._pending.discard(hash_hex)
            self._offloaded.append(hash_hex)
            self.offload_total += 1
            self.bytes_offloaded += self.block_nbytes
        if spill is not None:
            self._spill_to_ssd(*spill)

    def _spill_to_ssd(self, hash_hex: str, arr: torch.Tensor) -> None:
        """DRAM->SSD demotion (or plain drop when there is no SSD tier)."""
        if self.ssd_capacity_blocks == 0 or self._ssd_map is None:
            with self._lock:
                self._pending.discard(hash_hex)
                self._removed.append(hash_hex)
            return
        data = block_bytes(arr)
        digest = hashlib.blake2b(data, digest_size=8).digest()
        with self._lock:
            if self._closed or hash_hex in self._superseded:
                self._superseded.discard(hash_hex)
                self._pending.discard(hash_hex)
                return
            if self._free_ssd:
                slot = self._free_ssd.pop()
            else:
                # SSD full: evict the LRU SSD block entirely.
                old_h, slot = self._ssd.popitem(last=False)
                self._sums.pop(old_h, None)
                self._removed.append(old_h)
        off = slot * self.block_nbytes
        self._ssd_map[off:off + self.block_nbytes] = data
        with self._lock:
            if self._closed:
                return
            self._ssd[hash_hex] = slot
            self._sums[hash_hex] = digest
            self._pending.discard(hash_hex)
            self._offloaded.append(hash_hex)
            self.demote_total += 1

    # --------------------------------------------------------------- onload
    def ready(self, hash_hex: str) -> bool:
        """Completion fence: True only when the block's tier write fully
        completed (admission checks this before counting on an onload)."""
        with self._lock:
            return (hash_hex not in self._pending
                    and (hash_hex in self._dram or hash_hex in self._ssd))

    def tier_of(self, hash_hex: str) -> Optional[str]:
        with self._lock:
            if hash_hex in self._pending:
                return None
            if hash_hex in self._dram:
                return "dram"
            if hash_hex in self._ssd:
                return "ssd"
            return None

    def fetch(self, hash_hex: str) -> Optional[torch.Tensor]:
        """Read a block back for onload and DROP the cold copy (move
        semantics). Returns a host tensor (pinned when the arena is), or
        None on a miss or an SSD checksum mismatch — the corrupt block
        fails only itself (reported `removed`)."""
        with self._lock:
            slot = self._dram.pop(hash_hex, None) \
                if hash_hex not in self._pending else None
            if slot is not None:
                arr = self._host_copy(self._arena[slot])
                self._free_dram.append(slot)
                self.onload_total += 1
                self.bytes_onloaded += self.block_nbytes
                self._cancel_offload_events(hash_hex)
                return arr
            slot = self._ssd.pop(hash_hex, None) \
                if hash_hex not in self._pending else None
            if slot is None:
                return None
            digest = self._sums.pop(hash_hex, None)
        # The slot stays OFF the free list until its bytes are out — a
        # concurrent spill grabbing it mid-read would hand us torn data.
        off = slot * self.block_nbytes
        data = bytearray(self._ssd_map[off:off + self.block_nbytes])
        with self._lock:
            self._free_ssd.append(slot)
        if digest != hashlib.blake2b(data, digest_size=8).digest():
            logger.warning("KV tier: SSD checksum mismatch for block %s; "
                           "dropping it", hash_hex[:16])
            with self._lock:
                self.corrupt_total += 1
                self._removed.append(hash_hex)
            return None
        with self._lock:
            self.onload_total += 1
            self.bytes_onloaded += self.block_nbytes
            self._cancel_offload_events(hash_hex)
        raw = torch.frombuffer(data, dtype=torch.uint8).view(self.dtype)
        return self._host_copy(raw) if self._pin else \
            raw.reshape(self.block_shape)

    def _cancel_offload_events(self, hash_hex: str) -> None:
        """Drop un-shipped `offloaded` deltas for a block leaving the cold
        tiers (onload/discard): heartbeat event lists carry no
        intra-window order and the global index applies `stored` before
        `offloaded`, so an offload->onload inside ONE window must ship
        only the `stored`. Called under self._lock."""
        if hash_hex in self._offloaded:
            self._offloaded = [h for h in self._offloaded if h != hash_hex]

    def discard(self, hash_hex: str, report: bool = False) -> None:
        """Drop a cold copy (e.g. the block was re-donated to HBM by a
        fresh prefill). With report=True the drop is surfaced as
        `removed`."""
        with self._lock:
            slot = self._dram.pop(hash_hex, None)
            if slot is not None:
                self._free_dram.append(slot)
            slot = self._ssd.pop(hash_hex, None)
            if slot is not None:
                self._free_ssd.append(slot)
                self._sums.pop(hash_hex, None)
            if hash_hex in self._pending:
                # Offload still in flight: the worker aborts the install
                # instead of resurrecting a cold copy of a hot block.
                self._superseded.add(hash_hex)
            self._cancel_offload_events(hash_hex)
            if report:
                self._removed.append(hash_hex)

    # --------------------------------------------------------------- events
    def drain_events(self) -> tuple[list[str], list[str]]:
        """(offloaded, removed) hex hashes since the last heartbeat.

        The drained lists are PUBLISHED on handoff (``rcu.publish``): once
        a delta batch leaves the store it belongs to the heartbeat it
        ships in, and appending to (or cancelling from) an already drained
        batch is the intra-window ordering bug class; under
        XLLM_RCU_DEBUG the freezer turns any such late mutation into a
        raise."""
        with self._lock:
            off, rem = self._offloaded, self._removed
            self._offloaded = []
            self._removed = []
            return (rcu.publish(off, "kv_tier.drained"),
                    rcu.publish(rem, "kv_tier.drained"))

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._closed = True
        self._executor.shutdown(wait=True)
        with self._lock:
            self._dram.clear()
            self._ssd.clear()
            self._sums.clear()
        if self._ssd_map is not None:
            self._ssd_map.close()
            self._ssd_map = None
        if self._ssd_file is not None:
            self._ssd_file.close()
            self._ssd_file = None
        if self._owns_ssd_file and self._ssd_path:
            try:
                os.unlink(self._ssd_path)
            except OSError:
                pass
