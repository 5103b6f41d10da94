"""Engine runtime configuration (the fields of
``xllm_service_tpu/engine/config.py`` this port implements)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..models.base import ModelConfig, tiny_config
from ..parallel.mesh import MeshConfig


@dataclass
class EngineConfig:
    model_family: str = "llama"
    model: ModelConfig = field(default_factory=tiny_config)
    # Device mesh. None = one device (the reference's None means all local
    # devices on its TP axis; the port's means one, as the agent's
    # --tp 0). A config mesh takes distinct cards cuda:offset..; pass
    # InferenceEngine(mesh=...) to name the devices, which may repeat.
    mesh: Optional[MeshConfig] = None
    # First device index for this engine's mesh (co-hosted instances on
    # disjoint device groups).
    mesh_device_offset: int = 0
    # KV pool. Page 0 is reserved as the garbage page (inactive batch slots
    # write there), so usable pages = num_pages - 1.
    num_pages: int = 256
    page_size: int = 16
    # Prefix-cache block size for global-index hashing (must match the
    # service's block_size).
    hash_block_size: int = 128
    # Batching.
    max_batch_size: int = 8
    max_seq_len: int = 2048
    # Sampling.
    max_top_logprobs: int = 5
    seed: int = 0
    # Chunked prefill: prompts longer than this are written to the KV pool
    # in chunks of this many tokens across engine iterations, so running
    # decodes keep streaming while a long prompt prefills. 0 disables
    # (whole-suffix prefill in one call). Must be page-aligned.
    prefill_chunk_tokens: int = 0
    # How many chunked prefills may be in flight at once (advanced
    # round-robin, one chunk per engine step): >1 keeps several long
    # prompts progressing fairly; short prompts always admit past them.
    max_concurrent_prefills: int = 2
    # Decode horizon: tokens generated per host fetch (a Python loop of
    # decode steps with sampling on the device). 1 = lowest streaming
    # latency; larger values amortize the per-fetch synchronisation.
    decode_horizon: int = 1
    # TTFT guard: while requests are waiting (or a chunked prefill is in
    # flight), decode calls shrink to this many tokens so admission isn't
    # blocked behind a long horizon. 0 disables.
    admission_horizon: int = 8
    # Speculative decoding (prompt-lookup / n-gram drafts, verified in a
    # batched multi-token forward; greedy-exact). 0 disables. Eligibility
    # is PER SLOT, decided on the device: plain-greedy slots (no
    # penalties, logprobs or bias) verify drafts; every other slot takes a
    # normal sampled single-token step inside the SAME cycle, so one
    # sampled request does not disable speculation for its greedy
    # neighbours. Drafts are proposed on the device (an n-gram match over
    # the device-resident token history), and `speculate_cycles`
    # propose+verify cycles run per host round trip, the spec analog of
    # decode_horizon. The engine takes the speculative path whenever at
    # least one running slot is eligible; with none, the plain horizon.
    speculate_k: int = 0
    speculate_ngram: int = 3
    speculate_cycles: int = 4
    # --- Tiered KV cache (engine/kv_tier.py) ---
    # Host-RAM (DRAM) tier capacity in bytes: evicted prefix blocks are
    # offloaded here asynchronously instead of being dropped, and a
    # prefix-matching admission onloads them back ahead of prefill. 0
    # disables tiering (evictions report `removed` as before).
    kv_tier_dram_bytes: int = 0
    # SSD spill tier capacity in bytes (DRAM overflow, LRU-demoted, BLAKE2b
    # checksummed). Requires kv_tier_dram_bytes > 0: offloads land in the
    # DRAM arena first and SSD is its overflow.
    kv_tier_ssd_bytes: int = 0
    # Spill file path ("" = a temp file, unlinked when the engine stops).
    kv_tier_ssd_path: str = ""
    # Transfer-pump worker threads and the hard in-flight cap: offloads
    # past the cap are DROPPED (reported as plain evictions), never queued
    # behind decode.
    kv_tier_threads: int = 2
    kv_tier_max_inflight: int = 8
    # Sequence/context parallelism: when the engine's mesh has a `seq` axis
    # of size > 1, the KV pool shards by page range over it (decode merges
    # per-shard flash statistics), and uncached prompts whose suffix is at
    # least this many tokens prefill with ring attention over that axis.
    # Shorter or prefix-cached prompts use the standard path.
    seq_parallel_min_tokens: int = 1024

    @property
    def pages_per_seq(self) -> int:
        return self.max_seq_len // self.page_size

    def validate(self) -> None:
        if self.max_seq_len % self.page_size:
            raise ValueError("max_seq_len must be a multiple of page_size")
        if self.hash_block_size % self.page_size:
            raise ValueError("hash_block_size must be a multiple of page_size")
        if self.max_seq_len > self.model.max_context_len:
            raise ValueError("max_seq_len exceeds model max_context_len")
        if self.decode_horizon < 1:
            raise ValueError("decode_horizon must be at least 1")
        if self.prefill_chunk_tokens % self.page_size:
            raise ValueError("prefill_chunk_tokens must be page-aligned")
