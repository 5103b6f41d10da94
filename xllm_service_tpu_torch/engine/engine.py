"""Continuous-batching inference engine (port of
``xllm_service_tpu/engine/engine.py``, the single-device serving loop).

- **Fixed decode batch**: every decode step runs all ``max_batch_size``
  slots; per-request variability (lengths, sampling settings, active slots)
  is data on the device. Inactive slots write their K/V to the garbage page
  0 and attend nothing.
- **Device-resident decode state**: the KV pool, penalty histograms,
  sampling controls, last tokens, context lengths, page tables, stop ids
  and budgets live on the device and are updated in place; the decode
  horizon is a Python loop of steps with sampling on the device and ONE
  host fetch per horizon.
- **Admission control**: pages for prompt + max_new_tokens are reserved at
  admission, so decode never runs out of pages mid-flight; requests beyond
  the batch queue.
- **Prefix cache**: the longest block-aligned cached prefix is reused
  (pages shared, suffix-only prefill through the multi-query paged kernel);
  completed blocks are donated back and reported as KvCacheEvents.
- **Per-slot stops and budgets on the device**: a slot freezes the moment
  it samples one of its stop ids or reaches its token budget, so the batch
  horizon follows the LONGEST remaining budget; while requests wait, calls
  shrink to ``admission_horizon``.
- A dead slot's page-table row is cleared before its pages are recycled.
- **KV tiers** (``kv_tier_dram_bytes`` > 0): evicted prefix blocks are
  gathered out of the pool (kernel ``gather_kv_pages``) on the engine's
  stream before any later kernel can reuse their pages, downloaded to a
  host arena off-thread, spilled to an SSD file when the arena is full,
  and restored (kernel ``scatter_kv_pages``) ahead of the prefill of a
  prefix-matching admission. Under a seq mesh a block's pages may lie on
  several shards; the movers take the sharded pool whole (one launch per
  device) and the block lives on the mesh's first device.
- **Context parallelism** (a mesh whose ``seq`` axis is n > 1): the KV
  pool is n shard tensors ``[L, 2, P/n, n_kv, ps, hd]``, one per device of
  the axis (``ShardedPages``); the dense model computes on the mesh's first
  device (the reference replicates the parameters over ``seq`` and computes
  them redundantly, with the same result). Every decode step attends
  through the context-parallel op (kernel 6 per shard, then the merge);
  a long prefix-free prompt prefills with ring attention over the axis.

Not in this port yet: speculation, chunked prefill, the mixed
decode+chunk step, PD injection/handoff, multimodal input, mesh axes other
than ``seq``, offline preemption and the pipelined dispatch-before-fetch.
"""

from __future__ import annotations

import logging
import random
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.hashing import prefix_block_hashes
from ..common.request import (
    LogProb,
    LogProbData,
    RequestOutput,
    SamplingParams,
    SequenceOutput,
    Status,
    StatusCode,
    Usage,
)
from ..common.types import KvCacheEvent
from ..models.base import get_model_family
from ..ops.cp_paged_attention import ShardedPages
from ..ops.page_dma import gather_kv_pages, scatter_kv_pages
from ..parallel.mesh import AXIS_SEQ, DeviceMesh, mesh_from_config
from ..tokenizer.base import Tokenizer
from ..tokenizer.simple import SimpleTokenizer
from .config import EngineConfig
from .kv_cache import GARBAGE_PAGE, KVPageManager, SequencePages
from .kv_tier import TieredKVStore, host_block
from .sampling import NUM_BIAS, SamplingState, record_tokens, sample_tokens

logger = logging.getLogger(__name__)

# How many stop tokens (eos + stop_token_ids) each batch slot carries on the
# device for mid-horizon deactivation. Longer lists still work — the host
# stop check covers the rest; the device just can't freeze the slot early.
NUM_STOP_IDS = 4


@dataclass
class EngineRequest:
    service_request_id: str
    request_id: str = ""
    token_ids: list[int] = field(default_factory=list)
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # Called from the engine thread with each RequestOutput delta.
    on_output: Callable[[RequestOutput], None] = lambda out: None


@dataclass
class _Sequence:
    req: EngineRequest
    pages: SequencePages
    slot: int = -1
    context_len: int = 0          # tokens whose KV is in the cache
    prompt_len: int = 0
    output_ids: list[int] = field(default_factory=list)
    emitted_chars: int = 0
    max_total_len: int = 0
    finished: bool = False
    cancelled: bool = False
    logprobs: list[LogProb] = field(default_factory=list)
    # Incremental detokenization: text finalized so far + how many output
    # tokens it covers (tokens past it are the pending multi-byte tail).
    decoded_text: str = ""
    decoded_ok: int = 0


class InferenceEngine:
    def __init__(self, cfg: EngineConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 eos_token_id: Optional[int] = None,
                 params: Optional[dict] = None,
                 mesh: Optional[DeviceMesh] = None):
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh = self._resolve_mesh(cfg, device, mesh)
        self.device = dev = (mesh.devices[0] if mesh is not None
                             else resolve_device(device))
        # Context parallelism: size of the mesh's seq axis (1 = off).
        self.seq_parallel = mesh.shape[AXIS_SEQ] if mesh is not None else 1
        if self.seq_parallel > 1 and cfg.num_pages % self.seq_parallel:
            raise ValueError("num_pages must divide by the seq-axis size for "
                             "context-parallel decode")
        self.ring_prefills = 0          # prefills that took the ring route
        self.tokenizer = tokenizer or SimpleTokenizer()
        self.eos_token_id = eos_token_id if eos_token_id is not None else \
            getattr(self.tokenizer, "eos_id", None)
        self.family = get_model_family(cfg.model_family)
        mcfg = cfg.model
        if params is None:
            # Random weights from the config's seed (benchmarks, the smoke).
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            params = self.family.init_params(mcfg, gen, dev)
        self.params = params
        self.page_mgr = KVPageManager(cfg.num_pages, cfg.page_size,
                                      cfg.hash_block_size)
        shape = (mcfg.num_layers, 2, cfg.num_pages, mcfg.num_kv_heads,
                 cfg.page_size, mcfg.head_dim)
        if self.seq_parallel > 1:
            self.kv_pages = ShardedPages.zeros(shape, mcfg.dtype, mesh,
                                               AXIS_SEQ)
        else:
            self.kv_pages = torch.zeros(shape, dtype=mcfg.dtype, device=dev)
        self._init_tiers()
        self._reset_slot_state()
        # Seeds of unseeded sampled requests.
        self._rng = random.Random(cfg.seed + 1)

        B = cfg.max_batch_size
        self._waiting: deque[EngineRequest] = deque()
        self._running: dict[int, _Sequence] = {}
        self._free_slots = list(range(B - 1, -1, -1))
        self._lock = threading.Condition()
        self._cancelled: set[str] = set()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self.total_generated = 0
        self.prefix_hits = 0            # admissions that reused cached KV
        self.prefix_hit_tokens = 0      # prompt tokens they did not prefill

    @staticmethod
    def _resolve_mesh(cfg: EngineConfig, device, mesh: Optional[DeviceMesh]
                      ) -> Optional[DeviceMesh]:
        """The engine's mesh: the caller's, else one built from
        ``cfg.mesh`` over distinct devices from ``mesh_device_offset``
        (raising when the machine has fewer), else None. Only the ``seq``
        axis may exceed 1; a named ``device`` must be the mesh's first."""
        if mesh is None and cfg.mesh is not None:
            mesh = mesh_from_config(cfg.mesh, resolve_device(device),
                                    cfg.mesh_device_offset)
        if mesh is None:
            return None
        wide = [a for a, n in mesh.shape.items() if a != AXIS_SEQ and n > 1]
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} > 1: tensor, expert, data and pipe "
                "parallelism are not ported yet (ROADMAP queue 1 item 11)")
        if device is not None:
            want, first = torch.device(device), mesh.devices[0]
            if want.type != first.type or want.index not in (None,
                                                             first.index):
                raise ValueError(f"device {want} is not the mesh's first "
                                 f"device {first}")
        return mesh

    def _init_tiers(self) -> None:
        """Tiered KV store (DRAM arena + SSD spill): populated by
        evictions, drained by prefix-matching admissions. None = off."""
        cfg, mcfg = self.cfg, self.cfg.model
        self.tier_store: Optional[TieredKVStore] = None
        # Side stream of the tier workers' downloads (CUDA engines).
        self._tier_stream: Optional[torch.cuda.Stream] = None
        if cfg.kv_tier_dram_bytes <= 0 < cfg.kv_tier_ssd_bytes:
            # SSD-only is not a mode: offloads land in the DRAM arena
            # first and SSD is its overflow.
            logger.warning(
                "kv_tier_ssd_bytes=%d ignored: tiering is DRAM-fronted "
                "(SSD holds DRAM overflow) — set kv_tier_dram_bytes > 0 "
                "to enable the tiers", cfg.kv_tier_ssd_bytes)
        elif cfg.kv_tier_dram_bytes > 0:
            on_cuda = self.device.type == "cuda"
            store = TieredKVStore(
                block_shape=(mcfg.num_layers, 2, self.page_mgr.pages_per_block,
                             mcfg.num_kv_heads, cfg.page_size,
                             mcfg.head_dim),
                dtype=mcfg.dtype,
                dram_bytes=cfg.kv_tier_dram_bytes,
                ssd_bytes=cfg.kv_tier_ssd_bytes,
                ssd_path=cfg.kv_tier_ssd_path,
                threads=cfg.kv_tier_threads,
                max_inflight=cfg.kv_tier_max_inflight,
                pin_memory=on_cuda)
            if store.enabled:
                self.tier_store = store
                if on_cuda:
                    self._tier_stream = torch.cuda.Stream(self.device)
            else:
                # A store that can hold nothing must not swallow evictions
                # (they would vanish from the global index).
                logger.warning(
                    "KV tiering disabled: kv_tier_dram_bytes=%d is below "
                    "one block (%d bytes)", cfg.kv_tier_dram_bytes,
                    store.block_nbytes)
                store.close()
        # Evictions divert to the tier pump only with a usable store.
        self.page_mgr.enable_tiering(self.tier_store is not None)

    def _reset_slot_state(self) -> None:
        """Fresh per-slot device state: every slot inactive, its page-table
        row on the garbage page."""
        cfg, dev = self.cfg, self.device
        B, i32 = cfg.max_batch_size, torch.int32
        self._st = SamplingState.init(B, cfg.model.vocab_size, dev)
        self._last = torch.zeros((B,), dtype=i32, device=dev)
        self._clens = torch.zeros((B,), dtype=i32, device=dev)
        self._pt = torch.full((B, cfg.pages_per_seq), GARBAGE_PAGE, dtype=i32,
                              device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        # Per-slot stop tokens (eos + first stop_token_ids, -1 padded): the
        # decode loop deactivates a slot the moment it samples one. Host
        # stop handling stays authoritative (stop strings, longer lists).
        self._stop_ids = torch.full((B, NUM_STOP_IDS), -1, dtype=i32,
                                    device=dev)
        # Per-slot token budget (max_total_len; 0 = none): a slot freezes AT
        # its budget, so one nearly-done sequence never shrinks the horizon.
        self._budget = torch.zeros((B,), dtype=i32, device=dev)
        # Per-slot sampling generator (None for greedy slots).
        self._gens: list[Optional[torch.Generator]] = [None] * B

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceEngine":
        self._thread = threading.Thread(target=self._loop, name="engine-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self.tier_store is not None:
            self.tier_store.close()

    # ---------------------------------------------------------------- API
    def submit(self, req: EngineRequest) -> None:
        if not req.token_ids:
            req.on_output(RequestOutput(
                service_request_id=req.service_request_id,
                request_id=req.request_id,
                status=Status(StatusCode.INVALID_ARGUMENT, "empty prompt"),
                finished=True))
            return
        if len(req.token_ids) >= self.cfg.max_seq_len:
            req.on_output(RequestOutput(
                service_request_id=req.service_request_id,
                request_id=req.request_id,
                status=Status(StatusCode.INVALID_ARGUMENT,
                              f"prompt length {len(req.token_ids)} exceeds "
                              f"max_seq_len {self.cfg.max_seq_len}"),
                finished=True))
            return
        with self._lock:
            self._waiting.append(req)
            self._lock.notify_all()

    def cancel(self, service_request_id: str) -> None:
        if not service_request_id:
            return
        with self._lock:
            self._cancelled.add(service_request_id)
            self._lock.notify_all()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out = {
                "waiting": len(self._waiting),
                "running": len(self._running),
                "kv_usage_perc": self.page_mgr.usage_perc(),
                "cached_blocks": self.page_mgr.cached_block_count(),
                "total_generated": self.total_generated,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
            }
        if self.tier_store is not None:
            out["kv_tier"] = self.tier_store.stats()
        return out

    def drain_kv_events(self) -> KvCacheEvent:
        """Heartbeat delta: page-manager stored/removed plus the tier
        store's completed transitions (HBM->DRAM and DRAM->SSD as
        `offloaded`; capacity and corruption drops as `removed`)."""
        ev = self.page_mgr.drain_events()
        if self.tier_store is not None:
            off, rem = self.tier_store.drain_events()
            ev.offloaded.extend(off)
            ev.removed.extend(rem)
        return ev

    # ------------------------------------------------------------- the loop
    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                did_work = self.step()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.exception("engine step failed; failing in-flight "
                                 "requests")
                self._fail_all(str(e))
                did_work = True
            if not did_work:
                with self._lock:
                    if not self._waiting and not self._running:
                        self._lock.wait(timeout=0.05)

    def _fail_all(self, message: str) -> None:
        """A step-level failure poisons the batch: surface it to every
        in-flight request instead of hanging them, and start the slots
        afresh."""
        with self._lock:
            waiting = list(self._waiting)
            self._waiting.clear()
        running = list(self._running.values())
        self._running.clear()
        for seq in running:
            seq.finished = True
            with self._lock:
                self._free_slots.append(seq.slot)
            seq.pages.release(self.page_mgr)
        self._reset_slot_state()
        for req in [seq.req for seq in running] + waiting:
            try:
                req.on_output(RequestOutput(
                    service_request_id=req.service_request_id,
                    request_id=req.request_id,
                    status=Status(StatusCode.UNKNOWN,
                                  f"engine failure: {message[:300]}"),
                    finished=True))
            except Exception:  # noqa: BLE001
                logger.exception("failure callback")

    def step(self) -> bool:
        """One engine iteration: process cancellations, admit waiting
        requests into free slots, decode one horizon."""
        self._process_cancellations()
        admitted = self._admit()
        decoded = self._decode()
        return admitted or decoded

    def _process_cancellations(self) -> None:
        with self._lock:
            cancelled = self._cancelled
            self._cancelled = set()
            if not cancelled:
                return
            kept: deque[EngineRequest] = deque()
            victims: list[EngineRequest] = []
            for r in self._waiting:
                (victims if r.service_request_id in cancelled else kept).append(r)
            self._waiting = kept
        # Callbacks run outside the lock (they may do slow I/O).
        for r in victims:
            self._emit_cancelled(r)
        for seq in list(self._running.values()):
            if seq.req.service_request_id in cancelled:
                seq.cancelled = True
                self._finish_sequence(seq, "abort", emit=True)

    def _emit_cancelled(self, req: EngineRequest) -> None:
        req.on_output(RequestOutput(
            service_request_id=req.service_request_id,
            request_id=req.request_id,
            status=Status(StatusCode.CANCELLED, "cancelled"), finished=True))

    # ------------------------------------------------------------ admission
    def _admit(self) -> bool:
        """Admit waiting requests FIFO while slots and pages last. Each
        admission prefills and installs before the next one starts, so a
        request sharing a prefix with an earlier one in the same burst sees
        its donated blocks."""
        admitted = False
        while True:
            with self._lock:
                if not self._free_slots or not self._waiting:
                    return admitted
                req = self._waiting.popleft()
            if not self._start_sequence(req):
                # Not enough KV pages: wait for running sequences to finish.
                with self._lock:
                    self._waiting.appendleft(req)
                return admitted
            admitted = True

    # ------------------------------------------------------------ KV tiers
    def _tier_gather(self, pages: list[int]):
        """Gather one hash block's pages into a NEW tensor for offload, on
        the engine's stream (so before any later kernel that reuses the
        pages; under a seq mesh the block is on the mesh's first device and
        a remote shard's pages reach it on that device's stream). On CUDA
        it returns (block, event recorded after the gather) for
        :meth:`_tier_download`."""
        block = gather_kv_pages(self.kv_pages, pages)
        if self._tier_stream is None:
            return block
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return block, ready

    def _tier_download(self, blob) -> torch.Tensor:
        """Tier worker (CUDA): copy a gathered block into pinned host
        memory on the side stream once the gather's event has passed. Only
        this worker waits for the copy; the engine thread never does. The
        block stays referenced here until the copy has completed."""
        block, ready = blob
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        stream = self._tier_stream
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host.copy_(block, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host

    def _pump_tier_offloads(self) -> None:
        """Hand freshly evicted blocks to the tier store. Called right
        after EVERY page allocation: the gather is enqueued here, before
        any kernel that could overwrite the recycled pages; the download
        and arena write then run on the store's bounded executor, never
        this thread."""
        if self.tier_store is None:
            return
        fetch = (host_block if self._tier_stream is None
                 else self._tier_download)
        for h, pages in self.page_mgr.drain_evicted():
            # Lazy gather: enqueued (on THIS thread, keeping stream order)
            # only if the pump accepts the block; a drop is reported by the
            # store itself as a plain `removed` eviction.
            self.tier_store.offload(
                h, lambda p=pages: self._tier_gather(p), fetch=fetch)

    def _onload_cold_prefix(self, prompt_hashes: list, matched: int,
                            cached_pages: list[int],
                            cached_hashes: list[str], P0: int) -> int:
        """Extend an HBM prefix match from the cold tiers: contiguous next
        blocks that are fence-complete in DRAM/SSD are restored into
        freshly allocated pages (upload and scatter enqueued ahead of the
        prefill that reads them) and re-donated to the HBM cache. Blocks
        still resident in HBM beyond a cold gap are stitched in directly.
        Mutates cached_pages/cached_hashes in place; returns the new
        matched token count. Stops at the first miss, corruption, or page
        shortage — the prefix must stay contiguous."""
        hbs = self.cfg.hash_block_size
        ppb = self.page_mgr.pages_per_block
        i = matched // hbs
        while i < len(prompt_hashes) and matched + hbs < P0:
            hx = prompt_hashes[i].hex()
            hbm_pages = self.page_mgr.match_block(hx)
            if hbm_pages is not None:
                cached_hashes.append(hx)
                cached_pages.extend(hbm_pages)
                matched += hbs
                i += 1
                continue
            if not self.tier_store.ready(hx):
                break
            pages = self.page_mgr.allocate(ppb)
            self._pump_tier_offloads()
            if pages is None:
                break
            arr = self.tier_store.fetch(hx)
            if arr is None:
                # Miss (raced an eviction) or SSD checksum corruption:
                # fails only this block; the walk stops here.
                self.page_mgr.free(pages)
                break
            if not self.page_mgr.install_block(hx, pages):
                self.page_mgr.free(pages)
                break
            # Upload and scatter on the first device's stream; a remote
            # shard's slots follow the upload onto its own device's stream.
            scatter_kv_pages(self.kv_pages, pages,
                             arr.to(self.device, non_blocking=True))
            cached_hashes.append(hx)
            cached_pages.extend(pages)
            matched += hbs
            i += 1
        return matched

    def _start_sequence(self, req: EngineRequest) -> bool:
        cfg = self.cfg
        prompt = req.token_ids
        P0 = len(prompt)
        max_new = max(1, min(req.sampling.max_tokens, cfg.max_seq_len - P0))
        max_total = min(P0 + max_new, cfg.max_seq_len)

        # Prefix-cache match (block-aligned; keep at least 1 suffix token so
        # prefill produces the next-token logits). The prompt's hash chain
        # is computed once and reused by the post-prefill donation.
        prompt_hashes = prefix_block_hashes(prompt, cfg.hash_block_size)
        matched, cached_pages, cached_hashes = \
            self.page_mgr.match_prefix(prompt, block_hashes=prompt_hashes)
        if matched >= P0:
            drop = (matched - P0) // cfg.hash_block_size + 1
            self.page_mgr.release_prefix(cached_hashes[-drop:])
            cached_hashes = cached_hashes[:-drop]
            matched = len(cached_hashes) * cfg.hash_block_size
            cached_pages = cached_pages[:matched // cfg.page_size]

        # Cold-tier onload: extend the HBM match with fence-complete
        # DRAM/SSD blocks restored ahead of prefill (suffix-only prefill
        # then starts past them, exactly like an HBM hit).
        if self.tier_store is not None:
            matched = self._onload_cold_prefix(
                prompt_hashes, matched, cached_pages, cached_hashes, P0)

        total_pages = -(-max_total // cfg.page_size)   # ceil
        own_pages = self.page_mgr.allocate(total_pages - len(cached_pages))
        self._pump_tier_offloads()
        if own_pages is None:
            self.page_mgr.release_prefix(cached_hashes)
            return False

        seq = _Sequence(
            req=req,
            pages=SequencePages(cached_hashes=cached_hashes,
                                cached_pages=cached_pages,
                                own_pages=own_pages,
                                block_hashes=prompt_hashes),
            prompt_len=P0, context_len=P0, max_total_len=max_total)
        with self._lock:
            seq.slot = self._free_slots.pop()
        try:
            first_token, lp = self._prefill_install(seq, prompt, matched)
        except Exception as e:  # noqa: BLE001 — e.g. a kernel launch error
            self._fail_admission(seq, req, e)
            raise

        if matched:
            self.prefix_hits += 1
            self.prefix_hit_tokens += matched
        # Donate completed prompt blocks to the prefix cache (skipping the
        # blocks matched FROM the cache).
        stored, donated = self.page_mgr.store_prefix(
            prompt, seq.pages.all_pages,
            skip_blocks=matched // cfg.hash_block_size,
            block_hashes=prompt_hashes)
        seq.pages.donated_hashes = stored
        seq.pages.donated_pages = donated
        if self.tier_store is not None:
            # A re-prefilled block supersedes any cold-tier copy (its
            # `stored` event moves the instance to HBM).
            for hx in stored:
                self.tier_store.discard(hx)
        self._running[seq.slot] = seq
        self._emit_token(seq, first_token, lp)
        return True

    def _fail_admission(self, seq: _Sequence, req: EngineRequest,
                        e: Exception) -> None:
        """Return a mid-admission sequence's resources and surface the
        failure to its client."""
        with self._lock:
            self._free_slots.append(seq.slot)
        seq.pages.release(self.page_mgr)
        seq.finished = True
        try:
            req.on_output(RequestOutput(
                service_request_id=req.service_request_id,
                request_id=req.request_id,
                status=Status(StatusCode.UNKNOWN,
                              f"engine prefill failure: {str(e)[:300]}"),
                finished=True))
        except Exception:  # noqa: BLE001
            logger.exception("prefill failure callback")

    def _device_bias(self, sp: SamplingParams) -> tuple[np.ndarray, np.ndarray]:
        """Sparse logit_bias rows for the device (-1 padded; entries beyond
        NUM_BIAS are dropped)."""
        ids = np.full((NUM_BIAS,), -1, np.int32)
        vals = np.zeros((NUM_BIAS,), np.float32)
        V = self.cfg.model.vocab_size
        for i, (t, v) in enumerate(list(sp.logit_bias.items())[:NUM_BIAS]):
            if 0 <= int(t) < V:
                ids[i] = int(t)
                vals[i] = float(v)
        return ids, vals

    def _device_stop_ids(self, sp: SamplingParams) -> np.ndarray:
        """The first NUM_STOP_IDS stop tokens for device-side slot
        deactivation (-1 padded)."""
        ids: list[int] = []
        if not sp.ignore_eos and self.eos_token_id is not None:
            ids.append(int(self.eos_token_id))
        for t in sp.stop_token_ids:
            if len(ids) >= NUM_STOP_IDS:
                break
            if int(t) not in ids:
                ids.append(int(t))
        ids += [-1] * (NUM_STOP_IDS - len(ids))
        return np.asarray(ids, np.int32)

    def _slot_state(self, slot: int) -> SamplingState:
        """One slot's rows of the sampling state (views: writes land in
        the batch state)."""
        st, s = self._st, slice(slot, slot + 1)
        return SamplingState(st.temperature[s], st.top_k[s], st.top_p[s],
                             st.frequency_penalty[s], st.presence_penalty[s],
                             st.repetition_penalty[s], st.token_counts[s],
                             st.bias_ids[s], st.bias_vals[s])

    def _sp_applicable(self, suffix_len: int, matched: int) -> bool:
        """Route to the ring-attention prefill? As the reference: a seq
        mesh axis, a prefix-free prompt (the ring has no paged-prefix term)
        and enough tokens to be worth the ring. The port has no prefill
        buckets: the suffix is padded to a multiple of the axis instead."""
        return (self.seq_parallel > 1 and matched == 0
                and suffix_len >= self.cfg.seq_parallel_min_tokens)

    def _prefill_install(self, seq: _Sequence, prompt: list[int],
                         matched: int) -> tuple[int, Optional[LogProb]]:
        """Prefill the suffix past the cached prefix, install the sequence
        into its batch slot and sample its first token (one host fetch)."""
        cfg, dev, slot = self.cfg, self.device, seq.slot
        sp = seq.req.sampling
        suffix = prompt[matched:]
        S = len(suffix)
        ring = self._sp_applicable(S, matched)
        if ring:
            # End padding, masked by seq_lens: the causal ring keeps it out
            # of every valid query's window, and its K/V go to page 0.
            suffix = suffix + [0] * (-S % self.seq_parallel)
            self.ring_prefills += 1
        row = np.full((cfg.pages_per_seq,), GARBAGE_PAGE, np.int32)
        pages = seq.pages.all_pages
        row[:len(pages)] = pages
        pt_row = torch.from_numpy(row).to(dev)
        i32 = torch.int32
        logits, _ = self.family.prefill_forward(
            self.params, cfg.model,
            torch.tensor([suffix], dtype=i32, device=dev),
            torch.arange(matched, matched + len(suffix), dtype=i32,
                         device=dev)[None],
            self.kv_pages, pt_row[None],
            torch.tensor([matched], dtype=i32, device=dev),
            torch.tensor([S], dtype=i32, device=dev),
            has_prefix=matched > 0, ring=ring)

        # Install the slot's sampling controls, then sample with them.
        st = self._slot_state(slot)
        rep = sp.repetition_penalty if sp.repetition_penalty > 0 else 1.0
        st.temperature.fill_(sp.temperature)
        st.top_k.fill_(int(sp.top_k))
        st.top_p.fill_(sp.top_p)
        st.frequency_penalty.fill_(sp.frequency_penalty)
        st.presence_penalty.fill_(sp.presence_penalty)
        st.repetition_penalty.fill_(rep)
        bias_ids, bias_vals = self._device_bias(sp)
        st.bias_ids.copy_(torch.from_numpy(bias_ids)[None])
        st.bias_vals.copy_(torch.from_numpy(bias_vals)[None])
        # The dense [V] prompt histogram feeds only the penalty terms;
        # penalty-free requests install a zeroed row (which clears the
        # previous occupant's counts).
        if (sp.frequency_penalty != 0.0 or sp.presence_penalty != 0.0
                or rep != 1.0):
            counts = np.bincount(np.asarray(prompt, np.int64),
                                 minlength=cfg.model.vocab_size)
            st.token_counts.copy_(torch.from_numpy(
                counts[:cfg.model.vocab_size].astype(np.int32))[None])
        else:
            st.token_counts.zero_()
        gen = None
        if sp.temperature > 0:
            seed = sp.seed if sp.seed is not None else self._rng.getrandbits(63)
            gen = torch.Generator(device=dev).manual_seed(seed)
        self._gens[slot] = gen

        toks, logprobs = sample_tokens(logits, st, [gen],
                                       want_logprobs=sp.logprobs)
        record_tokens(st.token_counts, toks,
                      torch.ones((1,), dtype=torch.bool, device=dev))
        self._pt[slot] = pt_row
        self._last[slot] = toks[0]
        self._clens[slot] = matched + S + 1
        self._active[slot] = True
        self._stop_ids[slot] = torch.from_numpy(self._device_stop_ids(sp))
        self._budget[slot] = seq.max_total_len

        K = cfg.max_top_logprobs
        if sp.logprobs:
            tv, ti = torch.topk(logprobs, K, dim=-1)
            chosen = torch.gather(logprobs, 1, toks.long()[:, None])[:, 0]
            packed = torch.cat([toks.float(), chosen, tv[0], ti[0].float()])
            out = packed.cpu().numpy()
            token = int(out[0])
            return token, self._make_logprob(token, float(out[1]),
                                             out[2:2 + K],
                                             out[2 + K:].astype(np.int64), sp)
        return int(toks.cpu()[0]), None

    # -------------------------------------------------------------- decode
    def _decode(self) -> bool:
        if not self._running:
            return False
        # Bound the horizon by the LONGEST remaining token budget among
        # running sequences (pow2 ceiling); per-sequence budgets are
        # enforced on the device, so one nearly-done sequence never clamps
        # the whole batch.
        horizon = self.cfg.decode_horizon
        # TTFT guard: with arrivals waiting, keep decode calls short.
        ah = self.cfg.admission_horizon
        if ah > 0 and self._waiting:
            horizon = min(horizon, ah)
        rem = max((s.max_total_len - s.prompt_len - len(s.output_ids)
                   for s in self._running.values() if not s.finished),
                  default=horizon)
        if 0 < rem < horizon:
            horizon = min(1 << (rem - 1).bit_length(), horizon)
        snapshot = dict(self._running)
        packed = self._decode_multi(horizon, snapshot)    # [H, B, 2+2K]
        K = self.cfg.max_top_logprobs
        H = packed.shape[0]
        for slot, seq in snapshot.items():
            if seq.finished or self._running.get(slot) is not seq:
                continue
            tokens = packed[:, slot, 0].astype(np.int64).tolist()
            if seq.req.sampling.logprobs:
                lps: list[Optional[LogProb]] = [
                    self._make_logprob(
                        tokens[h], float(packed[h, slot, 1]),
                        packed[h, slot, 2:2 + K],
                        packed[h, slot, 2 + K:].astype(np.int64),
                        seq.req.sampling)
                    for h in range(H)]
            else:
                lps = [None] * H
            seq.context_len += H
            # ONE delta per sequence per horizon (tokens past a stop are
            # discarded inside _emit_tokens).
            self._emit_tokens(seq, tokens, lps)
        return True

    def _decode_multi(self, horizon: int,
                      running: dict[int, _Sequence]) -> np.ndarray:
        """``horizon`` decode steps of the whole batch on the device, then
        one fetch. Returns [H, B, 2 + 2K] f32 rows of (token, chosen
        logprob, top-K logprobs, top-K ids)."""
        cfg, mcfg = self.cfg, self.cfg.model
        K = cfg.max_top_logprobs
        B = cfg.max_batch_size
        gens = [self._gens[s] if s in running else None for s in range(B)]
        want_lp = any(s.req.sampling.logprobs for s in running.values())
        rows = []
        for _ in range(horizon):
            logits, _ = self.family.decode_forward(
                self.params, mcfg, self._last, self._clens - 1,
                self.kv_pages, self._pt, self._clens)
            toks, logprobs = sample_tokens(logits, self._st, gens,
                                           want_logprobs=want_lp)
            record_tokens(self._st.token_counts, toks, self._active)
            if want_lp:
                chosen = torch.gather(logprobs, 1, toks.long()[:, None])
                tv, ti = torch.topk(logprobs, K, dim=-1)
            else:
                chosen = torch.zeros((B, 1), device=self.device)
                tv = torch.zeros((B, K), device=self.device)
                ti = tv
            # Device-side stop: a slot that sampled one of its stop ids, or
            # reached its token budget, freezes (no clens growth, its KV
            # writes repeat in place) for the rest of the horizon. The stop
            # token itself is still emitted by the host.
            hit = (toks[:, None] == self._stop_ids).any(dim=-1)
            hit |= (self._budget > 0) & (self._clens + 1 >= self._budget)
            advance = self._active & ~hit
            self._last = torch.where(advance, toks, self._last)
            self._clens = torch.where(advance, self._clens + 1, self._clens)
            self._active = advance
            rows.append(torch.cat([toks.float()[:, None], chosen, tv,
                                   ti.float()], dim=1))
        return torch.stack(rows).cpu().numpy()

    # ----------------------------------------------------------- emission
    # Finalized-context window for the incremental diff: the tail is always
    # decoded TOGETHER with the last few finalized tokens, because
    # decode(A)+decode(B) != decode(A+B) for tokenizers with boundary rules.
    DETOK_WINDOW = 8

    def _incremental_text(self, seq: _Sequence,
                          exclude_last: bool = False) -> str:
        """Visible text so far, decoding only a bounded window per token. A
        tail whose decode ends in U+FFFD (partial UTF-8 sequence) stays
        pending until later tokens resolve it (or a cap is hit)."""
        end = len(seq.output_ids) - (1 if exclude_last else 0)
        if end <= seq.decoded_ok:
            return seq.decoded_text
        start = max(0, seq.decoded_ok - self.DETOK_WINDOW)
        prev = self.tokenizer.decode(seq.output_ids[start:seq.decoded_ok]) \
            if seq.decoded_ok > start else ""
        cur = self.tokenizer.decode(seq.output_ids[start:end])
        if cur.startswith(prev):
            piece = cur[len(prev):]
        else:
            # Rare (window-boundary normalization): the exact full decode.
            seq.decoded_text = self.tokenizer.decode(seq.output_ids[:end])
            seq.decoded_ok = end
            return seq.decoded_text
        if not piece.endswith("�") or (end - seq.decoded_ok) > 16:
            seq.decoded_text += piece
            seq.decoded_ok = end
            return seq.decoded_text
        return seq.decoded_text + piece

    def _make_logprob(self, token: int, chosen_lp: float,
                      top_vals: np.ndarray, top_ids: np.ndarray,
                      sp: SamplingParams) -> Optional[LogProb]:
        if not sp.logprobs:
            return None
        tok_str = self.tokenizer.decode([token]) or ""
        k = min(sp.top_logprobs, len(top_ids)) if sp.top_logprobs else 0
        return LogProb(
            token=tok_str, token_id=token, logprob=chosen_lp,
            top_logprobs=[
                LogProbData(self.tokenizer.decode([int(t)]) or "",
                            int(t), float(v))
                for t, v in zip(top_ids[:k], top_vals[:k])
            ])

    def _emit_token(self, seq: _Sequence, token: int,
                    lp: Optional[LogProb]) -> None:
        self._emit_tokens(seq, [token], [lp])

    def _emit_tokens(self, seq: _Sequence, tokens: list[int],
                     lps: list[Optional[LogProb]]) -> None:
        """Append + detokenize + stream ONE delta covering all `tokens` (a
        decode horizon). Stops/budget are checked per token; tokens past a
        finish are discarded."""
        sp = seq.req.sampling
        out_tokens: list[int] = []
        out_lps: list[LogProb] = []
        pieces: list[str] = []
        finish_reason = ""
        for token, lp in zip(tokens, lps):
            seq.output_ids.append(token)
            if lp is not None:
                seq.logprobs.append(lp)
            self.total_generated += 1

            if (not sp.ignore_eos and self.eos_token_id is not None
                    and token == self.eos_token_id):
                finish_reason = "stop"
            elif token in sp.stop_token_ids:
                finish_reason = "stop"
            elif len(seq.output_ids) >= seq.max_total_len - seq.prompt_len:
                finish_reason = "length"
            elif seq.prompt_len + len(seq.output_ids) >= self.cfg.max_seq_len:
                finish_reason = "length"

            # On "stop" the matched token is excluded from visible text
            # (OpenAI/vLLM semantics).
            text = self._incremental_text(
                seq, exclude_last=finish_reason == "stop")
            if not finish_reason and sp.stop:
                for s in sp.stop:
                    pos = text.find(s, max(0, seq.emitted_chars - len(s)))
                    if pos != -1:
                        text = text[:pos]
                        finish_reason = "stop"
                        break
            new_text = text[seq.emitted_chars:]
            # Hold back a trailing replacement char (partial UTF-8).
            if new_text.endswith("�") and not finish_reason:
                new_text = new_text[:-1]
            seq.emitted_chars += len(new_text)
            pieces.append(new_text)
            out_tokens.append(token)
            if lp is not None:
                out_lps.append(lp)
            if finish_reason:
                break

        if not out_tokens:
            return
        out = RequestOutput(
            service_request_id=seq.req.service_request_id,
            request_id=seq.req.request_id,
            outputs=[SequenceOutput(
                index=0, text="".join(pieces), token_ids=out_tokens,
                finish_reason=finish_reason, logprobs=out_lps)],
            finished=bool(finish_reason),
        )
        if finish_reason:
            out.usage = Usage(num_prompt_tokens=seq.prompt_len,
                              num_generated_tokens=len(seq.output_ids))
            out.finished_on_prefill = len(seq.output_ids) == 1
            seq.finished = True
        try:
            seq.req.on_output(out)
        except Exception:  # noqa: BLE001
            logger.exception("engine output callback failed; cancelling %s",
                             seq.req.service_request_id)
            seq.cancelled = True
        if seq.finished or seq.cancelled:
            self._finish_sequence(seq, finish_reason or "abort", emit=False)

    def _finish_sequence(self, seq: _Sequence, reason: str,
                         emit: bool = True) -> None:
        if seq.slot >= 0 and seq.slot in self._running:
            del self._running[seq.slot]
            # Clear the device page-table row BEFORE recycling pages — a
            # stale row would let a dead slot scribble K/V into pages that a
            # new sequence now owns.
            s = seq.slot
            self._pt[s] = GARBAGE_PAGE
            self._active[s] = False
            self._clens[s] = 0
            self._budget[s] = 0
            self._gens[s] = None
            with self._lock:
                self._free_slots.append(s)
        seq.pages.release(self.page_mgr)
        if emit and not seq.finished:
            seq.req.on_output(RequestOutput(
                service_request_id=seq.req.service_request_id,
                request_id=seq.req.request_id,
                status=Status(StatusCode.CANCELLED, reason), finished=True))
        seq.finished = True
