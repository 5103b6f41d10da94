"""Continuous-batching inference engine (port of
``xllm_service_tpu/engine/engine.py``, the single-device serving loop).

- **Fixed decode batch**: every decode step runs all ``max_batch_size``
  slots; per-request variability (lengths, sampling settings, active slots)
  is data on the device. Inactive slots write their K/V to the garbage page
  0 and attend nothing.
- **Device-resident decode state**: the KV pool, penalty histograms,
  sampling controls, per-slot generators, last tokens, context lengths,
  page tables, stop ids and budgets live on the device, are allocated once
  and are updated in place; a decode horizon is H steps with sampling on
  the device and ONE host fetch.
- **The step as a CUDA graph** (``engine/decode_graph.py``): on a card
  without a mesh axis above 1 each step of a horizon is a replay of one
  captured step (the reference's horizon is one jit); on the CPU, and
  under any mesh axis above 1, the step's ops run one by one (``stats()``
  names the route: ``decode_route`` "captured" or "eager").
- **Dispatch before fetch**: a horizon's rows are copied into a pinned
  host buffer behind it on the stream; the engine dispatches horizon N+1
  before it waits for and emits horizon N, so the host's emission overlaps
  the device's work. Rows of a slot finished, cancelled or reused since
  the dispatch are dropped. The drain records the reference's decode
  telemetry (``tpot_samples``, ``recent_max_tbt_ms``; TTFT at the prefill
  install), which ``drain_recent_latency`` hands to a heartbeat.
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
- **Tensor and expert parallelism** (a mesh whose ``model`` or ``expert``
  axis is above 1): the parameters go through
  ``parallel/sharding.py::shard_params`` with the family's rules, drawn
  or given alike (quantized first under int8; a loader's tree on the mesh
  is taken as it is), so each (expert, model) coordinate holds its shard
  on its device (views of the tree on a repeated device). The KV pool is
  a ``ModelShardedPages``: ``[L, 2, P, n_kv / n, ps, hd]`` a model shard
  (the reference's ``KV_PAGES_SPEC``), or replicated where ``n_kv`` does
  not divide (MLA's one latent head). Each layer runs once a model shard
  (``models/llama.py::forward_shards``; the experts once an (expert,
  model) shard) and the partials are summed on the mesh's first device,
  where the residual stream, the logits and sampling stay. The tiers and
  PD gather and scatter each shard with kernels 4–5; the host-side block
  keeps the reference's layout ``[L, 2, n, n_kv, ps, hd]``, and a PD
  handoff between identical meshes goes one CUDA IPC handle a shard
  (``ShardedBlock``). The ``data`` and ``pipe`` axes replicate: the port
  computes once where the reference computes the same values on each
  replica, as for ``seq``. The captured step stays off; a chunk rides
  a decode step in the eager mixed step, once a model shard.
- **``seq`` together with ``model`` or ``expert``**: with a model axis
  the pool is a grid of pages and heads (``ModelShardedPages`` whose
  model shards are each a ``ShardedPages`` over their seq line): every
  model shard decodes through kernel 6 on its seq line at its heads and
  merges over that line, and a long prefix-free prompt takes the ring
  per model shard. The reference replicates the heads over ``model``
  there; the tokens and the pool's contents are the same. With an expert
  axis and no model axis the pool is split over ``seq`` and held once
  (by each rank over processes, at its expert coordinate), as on
  ``expert`` alone.

- **Admission order** as the reference's: online before offline, then
  higher priority first, FIFO otherwise.
- **Asynchronous install**: an admission pass dispatches a burst of
  prefill installs, each leaving its first token (and logprob pack) in its
  slot's row of a host buffer (pinned on a card), then waits ONCE for the
  whole burst and completes the installs in order (TTFT telemetry,
  ``span_samples``, prefix donation, the first emission). A request whose
  first hash block equals one already in the burst completes the burst
  first, so the prefix cache sees the donation (the ``n > 1`` fan-out).
- **Chunked prefill** (``prefill_chunk_tokens`` > 0): a suffix longer than
  a chunk joins up to ``max_concurrent_prefills`` in-flight prefills and is
  written chunk by chunk across steps, round-robin (every chunk behind the
  first attends its written prefix through kernel 2 on the card); the
  final chunk samples the first token through the install. Under queue
  pressure a suffix of at most four chunks installs whole instead; a long
  prompt that finds the prefill set full is deferred, not blocking the
  short ones behind it.
- **The Sarathi mixed step** (``models/llama.py::mixed_decode_chunk_forward``):
  a decode horizon with a prefill in flight carries the front sequence's
  next chunk (four under queue pressure, never the final one) inside its
  first step, one forward over the decode rows and the chunk's rows; on a
  card that step is a replay of its own captured graph.
  ``XLLM_SARATHI=0`` (the reference's switch) turns rides off; under a seq
  mesh there are none.
- **Offline preemption**: an online request that finds no pages preempts
  the most recently admitted running offline sequence, which re-queues as
  a continuation re-prefilling its prompt and the tokens it had emitted
  (its stream never repeats a token).
- **Speculative decoding** (``speculate_k`` > 0): the token history of
  every slot lives on the device (seeded at the install, repaired whole
  after a chunked or cache-matched one, appended by every step), drafts
  are the continuation of the trailing ``speculate_ngram`` tokens' latest
  earlier occurrence (``engine/speculative.py``), and a spec call runs
  ``speculate_cycles`` propose+verify cycles per host round trip, each
  one ``verify_forward`` over [last ‖ k drafts] for the whole batch (kernel
  2 in every layer on the card; on a card each cycle is a replay of its
  captured variant). Eligibility is per slot and decided on the device:
  plain greedy slots accept the longest draft prefix equal to the
  model's argmax plus one token; sampled and logprob slots take a normal
  step from the same forward. The path runs while one running slot is
  eligible; greedy output equals the plain path's.
- **Embeddings** (``embed``, for the agent's ``/v1/embeddings``): the
  family's dense forward, run on the engine thread between steps.

- **PD disaggregation**: a ``prefill_only`` request runs its prefill
  (whole, cache-matched or chunked) and, once its first token is in hand
  after the burst's wait, its prompt pages are gathered into one buffer
  ``[L, 2, n, n_kv, ps, hd]`` (kernel ``gather_kv_pages``) on the engine's
  stream before its slot's row is cleared and its pages recycled; the
  ``PrefillHandoff`` goes to ``on_prefill_done`` and nothing is emitted.
  A request with ``injected_kv`` (the decode side) reserves pages for
  prompt + max_new and a slot, scatters the buffer into its pages (kernel
  ``scatter_kv_pages``; a host buffer goes up through the pinned cache, a
  device one never touches the host), installs the slot with the prefill
  side's first token in one packed upload, donates the prompt's blocks to
  the prefix cache and emits the first token; the next decode dispatch
  follows it in stream order. A seeded sampled request's generator skips
  the prefill side's one draw, so its stream is the one a MIX engine
  gives it. Under a seq mesh both movers take the sharded pool.

Its entry point for a fleet is the agent (``engine/agent.py``), which
serves the reference master's wire contract.

The model is any registered family (``llama``, ``qwen2``, ``gemma``,
``deepseek_moe``, ``mixtral``, ``qwen2_vl``, ``models/base.py``). With ``model.quant ==
"int8"`` the weights, random or given, are quantized one layer at a time
before serving (weight-only int8, ``models/quant.py``); the MoE families
draw random weights in their int8 form directly, one layer of one leaf at
a time, so Mixtral-8x7B's bf16 tree never exists whole. The MoE families
have no mixed step, so their chunks never ride a decode step. A config
with Gemma-2's score softcap or sliding window refuses a seq mesh, as the
reference does. Every other family serves on one: a long prefix-free
install takes the ring in the MoE families' GQA (mixtral) and MLA layers
alike, MLA's decode reads the row's pages gathered from their shards
(``paged_attention_xla``), and a qwen2_vl text prompt takes the ring with
its M-RoPE rows zero-padded to the ring's length.

- **Multimodal** (the ``qwen2_vl`` family): a request's ``mm_embeds``
  (the encoder's visual tokens, ``[n, D]``) are spliced into its
  placeholder positions at prefill; each chunk of a chunked prompt takes
  the rows of its own placeholders. Prefill positions are M-RoPE's
  ``[S, 3]`` rows, computed on the host (``models/qwen2_vl.py::
  mrope_positions``), and the slot keeps the prompt's decode delta in
  ``_mrope_delta`` (zeroed on release): every decode step rotates rope at
  ``clens - 1 + delta`` while the K/V write stays at ``clens - 1``, and a
  captured step reads the delta from that fixed buffer, so a graph
  captured before an image request arrives uses the request's delta. An
  image prompt never matches nor donates prefix-cache blocks (its token
  ids do not see the image), never rides a decode step and never takes
  the ring. A PD decode side recomputes the delta from the prompt's ids.

- **A mesh over processes** (``parallel/mesh.py::process_mesh``, after
  ``parallel/multihost.py::initialize``): one engine per process, each
  holding only its coordinates' shards and pool shards; the collectives
  cross the processes. The lockstep driver (``engine/multihost_driver.py``)
  mirrors the primary's submits and cancels and calls ``step`` on every
  rank; the engine's own loop thread does not run. Every scheduling
  decision is a function of the event order and the step count, and every
  value the host reads (sampled rows, first tokens, logprobs) is computed
  from logits that the model axis's gather made the same on every rank,
  so the ranks read the same values, as the reference's ``_fetch``
  arranges. The KV tiers are off there, with the reference's warning.

Not in this port yet: the captured and mixed steps under a mesh.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import Future
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
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..models.base import get_model_family, shard_config
from ..models.quant import quantize_tree
from ..ops.cp_paged_attention import ShardedPages
from ..ops.page_dma import (
    gather_kv_pages,
    gather_kv_shards,
    scatter_kv_pages,
)
from ..parallel.mesh import (
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_SEQ,
    DeviceMesh,
    mesh_from_config,
)
from ..parallel.sharding import (
    ModelShardedPages,
    ShardedBlock,
    ShardedParams,
    shard_params,
)
from ..tokenizer.base import Tokenizer
from ..tokenizer.simple import SimpleTokenizer
from .config import EngineConfig
from .decode_graph import DecodeGraphs
from .kv_cache import GARBAGE_PAGE, KVPageManager, SequencePages
from .kv_tier import TieredKVStore, host_block
from .sampling import NUM_BIAS, SamplingState, record_tokens, sample_tokens
from .speculative import propose_drafts, spec_eligible, spec_ok

logger = logging.getLogger(__name__)

# How many stop tokens (eos + stop_token_ids) each batch slot carries on the
# device for mid-horizon deactivation. Longer lists still work — the host
# stop check covers the rest; the device just can't freeze the slot early.
NUM_STOP_IDS = 4
# Chunks one ride carries under queue pressure (the mixed step's second
# span, beside one chunk).
PRESSURE_SPAN_CHUNKS = 4


def _repetition(sp: SamplingParams) -> float:
    """The repetition penalty the device applies (1.0, none, when unset)."""
    return sp.repetition_penalty if sp.repetition_penalty > 0 else 1.0


@dataclass
class EngineRequest:
    service_request_id: str
    request_id: str = ""
    token_ids: list[int] = field(default_factory=list)
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # Called from the engine thread with each RequestOutput delta.
    on_output: Callable[[RequestOutput], None] = lambda out: None
    # Online/offline hybrid scheduling: offline requests yield admission to
    # online traffic; within a class a higher priority goes first.
    offline: bool = False
    priority: int = 0
    # Continuation state installed by offline preemption: the tokens
    # already emitted, re-prefilled after the prompt and never re-sent.
    resume_output_ids: list[int] = field(default_factory=list)
    resume_emitted_chars: int = 0
    resume_logprobs: list[LogProb] = field(default_factory=list)
    # PD disaggregation: a prefill-only request runs its prefill, then
    # hands the sequence (first token + KV pages) to ``on_prefill_done``
    # instead of joining the local decode batch.
    prefill_only: bool = False
    on_prefill_done: Optional[Callable[["PrefillHandoff"], None]] = None
    # Set by submit(): splits the engine's TTFT into queue wait and
    # prefill (``span_samples``).
    t_submit: float = 0.0
    # Decode-side injection: the sequence arrives with its prompt's KV
    # computed, a tensor [L, 2, n, n_kv, ps, hd] on the host (host paths)
    # or on this engine's device (the device path).
    injected_first_token: Optional[int] = None
    injected_kv: Optional[torch.Tensor] = None
    injected_first_logprob: Optional[LogProb] = None
    # Multimodal (qwen2_vl family): the visual embeddings [n_mm, D] (a host
    # array or a tensor), spliced into the placeholder positions in order.
    mm_embeds: Optional[Any] = None


@dataclass
class PrefillHandoff:
    """Everything the decode peer needs to continue a prefilled sequence:
    the prompt's token ids, the first sampled token (and logprob) and the
    prompt's KV pages as one tensor [L, 2, n_pages, n_kv, ps, hd] on the
    engine's device (the agent downloads it only for a host path)."""

    service_request_id: str
    request_id: str
    token_ids: list[int]
    first_token: int
    first_logprob: Optional[LogProb]
    sampling: SamplingParams
    kv_blob: Any
    # On a card: an event recorded right after the gather that wrote
    # ``kv_blob`` (None on the CPU). A reader on another stream or in
    # another process waits for it first.
    kv_ready: Optional[Any] = None


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


@_ownership.verify_state
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
        self.device = dev = (mesh.first_device if mesh is not None
                             else resolve_device(device))
        # Context parallelism: size of the mesh's seq axis (1 = off).
        self.seq_parallel = mesh.shape[AXIS_SEQ] if mesh is not None else 1
        if self.seq_parallel > 1 and cfg.num_pages % self.seq_parallel:
            raise ValueError("num_pages must divide by the seq-axis size for "
                             "context-parallel decode")
        if self.seq_parallel > 1 and (cfg.model.attn_logit_softcap > 0
                                      or cfg.model.sliding_window > 0):
            # The ring prefill and kernel 6 take neither gemma-2's score
            # softcap nor its sliding window, as in the reference.
            raise ValueError(
                "seq-axis parallelism is not supported for models with "
                "attn_logit_softcap/sliding_window (gemma-2); use a mesh "
                "without a seq axis")
        # The qwen2_vl family: M-RoPE prefill positions and a decode delta.
        self._is_vl = cfg.model_family == "qwen2_vl"
        self.ring_prefills = 0          # prefills that took the ring route
        self.tokenizer = tokenizer or SimpleTokenizer()
        self.eos_token_id = eos_token_id if eos_token_id is not None else \
            getattr(self.tokenizer, "eos_id", None)
        self.family = get_model_family(cfg.model_family)
        # Speculation needs the family's verify forward; without one it is
        # turned off with a warning, as in the reference.
        self._spec_on = (cfg.speculate_k > 0
                         and self.family.verify_forward is not None)
        if cfg.speculate_k > 0 and not self._spec_on:
            logger.warning("model family %s has no verify_forward; "
                           "speculative decoding disabled", cfg.model_family)
        mcfg = cfg.model
        # Tensor and expert parallelism: the sizes of the mesh's model and
        # expert axes (1 = off); any axis above 1 keeps the eager step.
        self.tensor_parallel = mesh.shape[AXIS_MODEL] if mesh else 1
        self.expert_parallel = mesh.shape[AXIS_EXPERT] if mesh else 1
        self._meshed = mesh is not None and max(mesh.sizes) > 1
        sharded = self.tensor_parallel * self.expert_parallel > 1
        if sharded:
            if self.family.sharding_rules is None:
                raise NotImplementedError(
                    f"family {cfg.model_family} has no sharding rules")
            shard_config(mcfg, self.tensor_parallel, self.expert_parallel)
        if params is None:
            # Random weights from the config's seed (benchmarks, the smoke;
            # under quant every family draws its projections in int8
            # directly).
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            params = self.family.init_params(mcfg, gen, dev)
        if isinstance(params, ShardedParams):
            # A loader's tree on a mesh (models/loader.py: quantized, then
            # sharded) is taken as it is.
            if not sharded or params.mesh.shape != mesh.shape:
                raise ValueError(f"weights sharded on {params.mesh.shape} "
                                 f"for an engine mesh of "
                                 f"{mesh.shape if mesh else None}")
        else:
            if mcfg.quant:
                # Random or given weights alike, as the reference:
                # quantized one layer at a time where they lie, then
                # sharded.
                params = self._quantize(params, mcfg)
            if sharded:
                # Each (expert, model) shard on its device; on a repeated
                # device the shards are views of the drawn or loaded tree.
                params = shard_params(params, mesh,
                                      self.family.sharding_rules)
        self.params = params
        self.page_mgr = KVPageManager(cfg.num_pages, cfg.page_size,
                                      cfg.hash_block_size)
        shape = (mcfg.num_layers, 2, cfg.num_pages, mcfg.num_kv_heads,
                 cfg.page_size, mcfg.head_dim)
        if self.tensor_parallel > 1:
            # Heads over the model axis; under a seq axis too, each model
            # shard's pages over its seq line (the page-and-head grid).
            self.kv_pages = ModelShardedPages.zeros(shape, mcfg.dtype, mesh)
        elif self.seq_parallel > 1:
            self.kv_pages = ShardedPages.zeros(shape, mcfg.dtype, mesh,
                                               AXIS_SEQ)
        else:
            self.kv_pages = torch.zeros(shape, dtype=mcfg.dtype, device=dev)
        self._init_tiers()
        self._alloc_slot_state()
        # Seeds of unseeded sampled requests.
        self._rng = random.Random(cfg.seed + 1)
        # The captured step: on a card, without a mesh axis above 1 (a
        # mesh keeps the eager step).
        self._graphs: Optional[DecodeGraphs] = None
        if dev.type == "cuda" and not self._meshed:
            state = [self._last, self._clens, self._active,
                     self._st.token_counts]
            if self._spec_on:
                state += [self._hist_buf, self._room]
            self._graphs = DecodeGraphs(self._graph_step, state, self._gens,
                                        dev)
        # Dispatch before fetch: the last dispatched horizon whose rows
        # are not read yet, as (host rows, ready event, t_dispatch,
        # horizon, {slot: seq} snapshot). The speculative path keeps its
        # own pending call with the same discipline; switching paths
        # drains the other one first.
        self._pending_decode: Optional[tuple] = None
        self._pending_spec: Optional[tuple] = None

        B = cfg.max_batch_size
        self._waiting: deque[EngineRequest] = deque()
        self._running: dict[int, _Sequence] = {}
        # In-flight chunked prefills (at most max_concurrent_prefills), as
        # {seq, req, prompt, cache_matched, written, t0}: one chunk advances
        # per step, round-robin, standalone or riding a decode step.
        self._prefillings: deque[dict[str, Any]] = deque()
        self._free_slots = list(range(B - 1, -1, -1))
        self._lock = threading.Condition()  # lock-order: 50
        self._cancelled: set[str] = set()
        # Calls run on the engine thread between steps (``embed``), with
        # the future their caller waits on.
        self._calls: deque[tuple[Callable[[], Any], Future]] = deque()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self.total_generated = 0
        self.prefix_hits = 0            # admissions that reused cached KV
        self.prefix_hit_tokens = 0      # prompt tokens they did not prefill
        # Decode telemetry, as the reference's: the heartbeat takes and
        # resets the recent maxima through drain_recent_latency (under the
        # leaf lock, so a sample landing between read and reset is never
        # lost); ttft: (prompt_len, ms); tpot: (batch, total_ctx, ms/tok).
        self._telemetry_lock = make_lock("engine.telemetry", order=822)  # lock-order: 822
        self.recent_max_ttft_ms = 0.0
        self.recent_max_tbt_ms = 0.0
        self.ttft_samples: deque[tuple[int, float]] = deque(maxlen=512)
        self.tpot_samples: deque[tuple[int, int, float]] = deque(maxlen=512)
        # Per-admission spans of the engine's TTFT: queue wait, prefill
        # (dispatch to first token, chunks included), prompt length.
        self.span_samples: deque[dict[str, float]] = deque(maxlen=512)
        self.preemption_count = 0
        # Mixed decode+chunk calls dispatched (proof that rides happened).
        self.sarathi_rides = 0
        # XLLM_SARATHI=0 turns the mixed step off (the reference's switch).
        self._sarathi = os.environ.get("XLLM_SARATHI", "1") != "0"
        self._rode_chunk = False        # this step's decode carried a chunk

    def _quantize(self, params: dict, mcfg) -> dict:
        """``params`` with their projections in weight-only int8
        (``models/quant.py``); raises for another mode or a family whose
        forwards do not take int8 leaves."""
        if mcfg.quant != "int8":
            raise ValueError(f"unknown quant mode {mcfg.quant!r}")
        if not self.family.supports_int8:
            raise NotImplementedError(
                f"family {self.cfg.model_family} does not route its "
                "matmuls through quantized_einsum (ModelFamily."
                "supports_int8)")
        return quantize_tree(params)

    @staticmethod
    def _resolve_mesh(cfg: EngineConfig, device, mesh: Optional[DeviceMesh]
                      ) -> Optional[DeviceMesh]:
        """The engine's mesh: the caller's, else one built from
        ``cfg.mesh`` over distinct devices from ``mesh_device_offset``
        (raising when the machine has fewer), else None. A named
        ``device`` must be the mesh's first."""
        if mesh is None and cfg.mesh is not None:
            mesh = mesh_from_config(cfg.mesh, resolve_device(device),
                                    cfg.mesh_device_offset)
        if mesh is None:
            return None
        if device is not None:
            want, first = torch.device(device), mesh.first_device
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
        elif (cfg.kv_tier_dram_bytes > 0 and self.mesh is not None
              and self.mesh.process_count > 1):
            # The lockstep step runs every collective in one order on
            # every rank; the tier pump's off-thread downloads would break
            # that order. As in the reference, the tiers are a
            # one-process feature.
            logger.warning("KV tiering disabled: multi-host mesh")
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

    def _alloc_slot_state(self) -> None:
        """The per-slot device state, allocated once: a captured step reads
        and writes these tensors at fixed addresses, so every later write
        is in place. Every slot starts inactive, its page-table row on the
        garbage page."""
        cfg, dev = self.cfg, self.device
        B, i32 = cfg.max_batch_size, torch.int32
        K = cfg.max_top_logprobs
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
        # Per-slot M-RoPE decode offset (qwen2_vl: the image grids of the
        # slot's prompt), added to the rope positions of every step.
        self._mrope_delta = torch.zeros((B,), dtype=i32, device=dev)
        # Per-slot sampling generators, re-seeded when a sampled request
        # takes the slot; a sampling step draws from all B.
        self._gens = [torch.Generator(device=dev) for _ in range(B)]
        # A step's packed row [B, 2 + 2K] (token, chosen logprob, top-K
        # logprobs, top-K ids), the horizon's rows on the device, and two
        # host buffers (pinned on a card) for the fetch: horizon N+1 is
        # dispatched before horizon N is read.
        H = cfg.decode_horizon
        self._row = torch.zeros((B, 2 + 2 * K), dtype=torch.float32,
                                device=dev)
        self._hrows = torch.zeros((H, B, 2 + 2 * K), dtype=torch.float32,
                                  device=dev)
        self._host_rows = [torch.zeros((H, B, 2 + 2 * K),
                                       dtype=torch.float32,
                                       pin_memory=dev.type == "cuda")
                           for _ in range(2)]
        self._host_next = 0
        # An install's first token and logprob pack, one row per slot on
        # the device and in a host buffer (pinned on a card): a burst of
        # installs is read after one wait.
        self._inst_rows = torch.zeros((B, 2 + 2 * K), dtype=torch.float32,
                                      device=dev)
        self._inst_host = torch.zeros((B, 2 + 2 * K), dtype=torch.float32,
                                      pin_memory=dev.type == "cuda")
        # The mixed step's chunk, written in place before a ride (a
        # captured mixed step reads it at these addresses): tokens for the
        # larger span (a one-chunk span reads their head), the chunk
        # sequence's page-table row, its start and its valid length.
        span = PRESSURE_SPAN_CHUNKS * cfg.prefill_chunk_tokens
        self._chunk_toks = torch.zeros((span,), dtype=i32, device=dev)
        self._chunk_pt = torch.full((1, cfg.pages_per_seq), GARBAGE_PAGE,
                                    dtype=i32, device=dev)
        self._chunk_start = torch.zeros((1,), dtype=i32, device=dev)
        self._chunk_valid = torch.zeros((1,), dtype=i32, device=dev)
        if not self._spec_on:
            return
        # Speculation. The device-resident token history (prompt suffix and
        # generated tokens), valid in [hist_lo, clens): drafts are proposed
        # from it on the device, so a propose+verify cycle costs no host
        # round trip. hist_lo > 0 when a cache-matched prefix was never
        # uploaded to this engine. The buffer's extra last column takes the
        # writes at positions >= max_seq_len, which the reference drops.
        L, Kd = cfg.max_seq_len, cfg.speculate_k
        self._hist_buf = torch.zeros((B, L + 1), dtype=i32, device=dev)
        self._hist = self._hist_buf[:, :L]
        self._hist_lo = torch.zeros((B,), dtype=i32, device=dev)
        # Per slot: logprobs asked for (an eligibility input), and the
        # token budget left, uploaded before each spec call and counted
        # down on the device by the cycles.
        self._want_lp = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._room = torch.zeros((B,), dtype=i32, device=dev)
        # A cycle's packed row [B, 1 + (k+1) + 1 + 2K] (tokens emitted,
        # the block's predictions, position 0's chosen logprob, top-K
        # logprobs and ids), a call's rows on the device, and two host
        # buffers (pinned on a card), as the plain horizon's.
        C, W = cfg.speculate_cycles, 1 + (Kd + 1) + 1 + 2 * K
        self._srow = torch.zeros((B, W), dtype=torch.float32, device=dev)
        self._spec_rows = torch.zeros((C, B, W), dtype=torch.float32,
                                      device=dev)
        self._spec_host = [torch.zeros((C, B, W), dtype=torch.float32,
                                       pin_memory=dev.type == "cuda")
                           for _ in range(2)]
        self._spec_next = 0

    def _reset_slot_state(self) -> None:
        """Every slot back to inactive on the garbage page, in place."""
        self._st.reset_()
        self._last.zero_()
        self._clens.zero_()
        self._pt.fill_(GARBAGE_PAGE)
        self._active.zero_()
        self._stop_ids.fill_(-1)
        self._budget.zero_()
        self._mrope_delta.zero_()
        if self._spec_on:
            self._hist_buf.zero_()
            self._hist_lo.zero_()
            self._want_lp.zero_()
            self._room.zero_()

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
        with self._lock:
            calls, self._calls = self._calls, deque()
        for _, fut in calls:
            fut.set_exception(RuntimeError("engine stopped"))
        # A pending horizon whose sequences have all finished carries
        # nothing deliverable: drop it without fetching.
        self._pending_decode = None
        self._pending_spec = None
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
        req.t_submit = time.monotonic()
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
        if self._graphs is not None:
            out["decode_graph"] = {"captures": self._graphs.captures,
                                   "replays": self._graphs.replays}
        # Which step route ran: the captured step, or the eager one op by
        # op (on the CPU, and under any mesh axis above 1).
        out["decode_route"] = ("captured" if self._graphs is not None
                               else "eager")
        if self.mesh is not None:
            out["mesh"] = dict(self.mesh.shape)
        return out

    def drain_recent_latency(self) -> tuple[float, float]:
        """Heartbeat drain: take and reset the window's
        (recent_max_ttft_ms, recent_max_tbt_ms) atomically."""
        with self._telemetry_lock:
            out = (self.recent_max_ttft_ms, self.recent_max_tbt_ms)
            self.recent_max_ttft_ms = 0.0
            self.recent_max_tbt_ms = 0.0
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

    def embed(self, token_id_lists: list[list[int]]) -> np.ndarray:
        """Text embeddings for a batch of token lists -> [n, D] f32
        (mean-pooled final hidden states). At most ``max_batch_size`` rows
        go in one forward, padded to the group's longest row: the
        reference's length buckets and power-of-two row padding bound its
        recompiles, which eager PyTorch does not have, so here they would
        only add work. Raises if the family has no embed_forward.

        With the loop running, the forward runs on the engine thread
        between steps and the caller waits for it: the loop captures and
        replays the decode step as a CUDA graph, and work that another
        thread puts on the card during a capture can invalidate the
        capture or the replay."""
        if self.family.embed_forward is None:
            raise NotImplementedError(
                f"model family {self.cfg.model_family} has no "
                "embedding forward")
        return self._on_loop(lambda: self._embed(token_id_lists))

    def _embed(self, token_id_lists: list[list[int]]) -> np.ndarray:
        cfg, dev = self.cfg, self.device
        clipped = [ids[:cfg.max_seq_len] or [0] for ids in token_id_lists]
        out = []
        for start in range(0, len(clipped), cfg.max_batch_size):
            group = clipped[start:start + cfg.max_batch_size]
            toks = np.zeros((len(group), max(map(len, group))), np.int32)
            for row, ids in enumerate(group):
                toks[row, :len(ids)] = ids
            lens = np.array([len(ids) for ids in group], np.int32)
            out.append(self.family.embed_forward(
                self.params, cfg.model, torch.from_numpy(toks).to(dev),
                torch.from_numpy(lens).to(dev)).cpu().numpy())
        return np.concatenate(out)

    def _on_loop(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the engine thread between steps and return its
        result; in place when called from that thread or when the loop is
        not running (nothing else then works on the card)."""
        t = self._thread
        if t is None or not t.is_alive() or t is threading.current_thread():
            return fn()
        fut: Future = Future()
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("engine stopped")
            self._calls.append((fn, fut))
            self._lock.notify_all()
        return fut.result()

    def _run_calls(self) -> bool:
        with self._lock:
            calls, self._calls = self._calls, deque()
        for fn, fut in calls:
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — handed to the caller
                logger.debug("engine call raised; its caller re-raises",
                             exc_info=True)
                fut.set_exception(e)
        return bool(calls)

    # ------------------------------------------------------------- the loop
    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                did_work = self._run_calls() | self.step()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.exception("engine step failed; failing in-flight "
                                 "requests")
                self._fail_all(str(e))
                did_work = True
            if not did_work:
                with self._lock:
                    if not (self._waiting or self._running or self._calls):
                        self._lock.wait(timeout=0.05)

    def _fail_all(self, message: str) -> None:
        """A step-level failure poisons the batch: surface it to every
        in-flight request instead of hanging them, and start the slots
        afresh. A pending horizon is dropped without fetching."""
        self._pending_decode = None
        self._pending_spec = None
        with self._lock:
            waiting = list(self._waiting)
            self._waiting.clear()
        running = list(self._running.values())
        self._running.clear()
        prefilling = [st["seq"] for st in self._prefillings]
        self._prefillings.clear()
        for seq in running + prefilling:
            seq.finished = True
            with self._lock:
                self._free_slots.append(seq.slot)
            seq.pages.release(self.page_mgr)
        self._reset_slot_state()
        for req in [seq.req for seq in running + prefilling] + waiting:
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
        """One engine iteration, in the reference's order: cancellations,
        admission (short prompts never wait behind a chunked prefill), one
        decode horizon (which may carry the next chunk of a prefill in
        flight), then one standalone chunk when none rode."""
        self._process_cancellations()
        worked = self._admit()
        self._rode_chunk = False
        decoded = self._decode()
        if self._prefillings and not self._rode_chunk:
            worked = self._advance_prefill() or worked
        return worked or decoded

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
        for st in [st for st in self._prefillings
                   if st["seq"].req.service_request_id in cancelled]:
            self._prefillings.remove(st)
            seq = st["seq"]
            with self._lock:
                self._free_slots.append(seq.slot)
            seq.pages.release(self.page_mgr)
            seq.finished = True
            victims.append(seq.req)
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
    def _pop_next_waiting(self) -> EngineRequest:
        """Admission order: online before offline; higher priority first
        within a class; FIFO otherwise. Must hold the lock; the queue is
        not empty."""
        best_i = min(range(len(self._waiting)), key=lambda i: (
            self._waiting[i].offline, -self._waiting[i].priority, i))
        self._waiting.rotate(-best_i)
        req = self._waiting.popleft()
        self._waiting.rotate(best_i)
        return req

    def _admit(self) -> bool:
        """Admit waiting requests in admission order while slots and pages
        last. The installs are dispatched as a burst and completed in order
        after one wait (in ``finally``). A long prompt that would chunk
        while ``max_concurrent_prefills`` are in flight is deferred, and
        the requests behind it still admit. A request sharing its first
        hash block with one in the burst completes the burst first, so it
        matches the donated blocks. An online request that finds no pages
        may preempt a running offline sequence."""
        admitted = False
        C = self.cfg.prefill_chunk_tokens
        hb = self.cfg.hash_block_size
        deferred: list[EngineRequest] = []
        batch: list[tuple] = []

        def requeue(*reqs: EngineRequest) -> None:
            # Back to the queue's head in the order they were popped.
            with self._lock:
                for r in reversed([*deferred, *reqs]):
                    self._waiting.appendleft(r)
            deferred.clear()

        try:
            while True:
                with self._lock:
                    if not self._free_slots or not self._waiting:
                        break
                    req = self._pop_next_waiting()
                if (C > 0 and len(req.token_ids)
                        + len(req.resume_output_ids) > C
                        and req.injected_kv is None
                        and len(self._prefillings)
                        >= self.cfg.max_concurrent_prefills):
                    deferred.append(req)
                    continue
                head = req.token_ids[:hb]
                if batch and len(head) == hb and any(
                        e[2][:hb] == head for e in batch):
                    try:
                        self._complete_batch(batch)
                    except Exception:
                        requeue(req)
                        raise
                # Not enough KV pages: an online request may preempt a
                # running offline sequence to make room.
                if not self._start_sequence(req, batch) and (
                        req.offline or not self._preempt_one_offline()
                        or not self._start_sequence(req, batch)):
                    requeue(req)
                    break
                admitted = True
            requeue()
            return admitted
        except BaseException:
            # Deferred requests go back to the queue, where the loop's
            # _fail_all answers them.
            requeue()
            raise
        finally:
            self._complete_batch(batch)

    def _preempt_one_offline(self) -> bool:
        """Evict the most recently admitted running offline sequence. It
        re-queues as a continuation: its prompt and the tokens emitted so
        far are prefilled again at readmission (rows of a pending horizon
        are dropped with the sequence and decoded again)."""
        victim: Optional[_Sequence] = None
        for seq in self._running.values():
            if seq.req.offline and not seq.finished:
                victim = seq    # insertion order: the last one wins
        if victim is None:
            return False
        req = victim.req
        cont = EngineRequest(
            service_request_id=req.service_request_id,
            request_id=req.request_id, token_ids=list(req.token_ids),
            sampling=req.sampling, on_output=req.on_output, offline=True,
            priority=req.priority,
            resume_output_ids=list(victim.output_ids),
            resume_emitted_chars=victim.emitted_chars,
            resume_logprobs=list(victim.logprobs), mm_embeds=req.mm_embeds)
        logger.info("preempting offline request %s after %d tokens",
                    req.service_request_id, len(victim.output_ids))
        self.preemption_count += 1
        self._release_slot_and_pages(victim)
        victim.finished = True
        with self._lock:
            self._waiting.append(cont)
        return True

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
            # Read the block BEFORE pumping the allocation's evictions: an
            # offload the pump starts may demote the arena's LRU block, and
            # a block fenced mid-demotion cannot be read, so the walk would
            # stop early. The pump still runs before any kernel that
            # reuses the evicted pages (the fetch enqueues none).
            arr = self.tier_store.fetch(hx) if pages is not None else None
            self._pump_tier_offloads()
            if pages is None:
                break
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

    def _start_sequence(self, req: EngineRequest,
                        batch: Optional[list] = None) -> bool:
        """Match the prompt's cached prefix, reserve its pages and a slot,
        then install it (dispatched into ``batch`` when given) or, for a
        long suffix, start its chunked prefill. False when the pages do not
        suffice. A request carrying KV (PD decode side) is installed from
        it instead."""
        if req.injected_kv is not None:
            return self._start_injected(req)
        cfg = self.cfg
        # A continuation (offline preemption) re-prefills prompt + emitted.
        prompt = req.token_ids + req.resume_output_ids
        P0 = len(req.token_ids)
        if req.prefill_only:
            # PD prefill side: exactly the first token, then the handoff.
            max_new = 1
        else:
            max_new = max(1, min(req.sampling.max_tokens,
                                 cfg.max_seq_len - P0))
        max_total = min(P0 + max_new, cfg.max_seq_len)
        if len(prompt) >= cfg.max_seq_len:
            self._emit_cancelled(req)
            return True

        # Prefix-cache match (block-aligned; keep at least 1 suffix token so
        # prefill produces the next-token logits). The prompt's hash chain
        # is computed once and reused by the post-prefill donation. An image
        # prompt neither matches nor donates: its token ids are the same
        # placeholder runs for different images.
        if req.mm_embeds is not None:
            prompt_hashes = None
            matched, cached_pages, cached_hashes = 0, [], []
        else:
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
        if self.tier_store is not None and prompt_hashes is not None:
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
            prompt_len=P0, context_len=len(prompt), max_total_len=max_total,
            output_ids=list(req.resume_output_ids),
            emitted_chars=req.resume_emitted_chars,
            logprobs=list(req.resume_logprobs))
        with self._lock:
            seq.slot = self._free_slots.pop()

        # The ring takes precedence over chunking: it spreads a long suffix
        # over the seq axis in one call. Under queue pressure a suffix of
        # at most four chunks installs whole (a burst admits in one pass);
        # a longer one always chunks.
        C = cfg.prefill_chunk_tokens
        suffix = len(prompt) - matched
        if (not self._sp_applicable(suffix, matched, req) and C > 0
                and suffix > C
                and not (self._waiting and suffix <= 4 * C)):
            self._prefillings.append(
                {"seq": seq, "req": req, "prompt": prompt,
                 "cache_matched": matched, "written": matched,
                 "t0": time.monotonic()})
            return True
        return self._finish_admission(seq, req, prompt, matched, matched,
                                      time.monotonic(), batch)

    def _advance_prefill(self) -> bool:
        """One chunk of ONE in-flight chunked prefill, round-robin over the
        set (every long prompt progresses, none owns the engine). The final
        chunk goes through the install."""
        if not self._prefillings:
            return False
        st = self._prefillings.popleft()
        seq, req, prompt = st["seq"], st["req"], st["prompt"]
        C, written = self.cfg.prefill_chunk_tokens, st["written"]
        if len(prompt) - written <= C:
            return self._finish_admission(seq, req, prompt,
                                          st["cache_matched"], written,
                                          st["t0"])
        try:
            self._prefill_chunk(seq, prompt, written, C)
        except Exception as e:  # noqa: BLE001 — e.g. a kernel launch error
            self._fail_admission(seq, req, e)
            raise
        st["written"] = written + C
        self._prefillings.append(st)   # back of the round-robin
        return True

    def _prefill_chunk(self, seq: _Sequence, prompt: list[int], start: int,
                       n: int) -> None:
        """Write the non-final chunk ``prompt[start:start + n]``'s K/V
        behind the ``start`` tokens already in the sequence's pages,
        attending to them (kernel 2 on the card once ``start`` > 0); its
        logits are dropped. A VL chunk takes its M-RoPE rows and the
        visual rows of its own placeholders."""
        dev, i32 = self.device, torch.int32
        P = self.cfg.pages_per_seq
        chunk = np.asarray(prompt[start:start + n], np.int32)
        # The page row first: kernel 2 takes it 16-byte aligned.
        parts = [self._page_row(seq), chunk]
        if self._is_vl:
            parts.append(self._mrope_chunk(prompt, start, start + n)[0]
                         .reshape(-1))
        packed = self._upload(np.concatenate(parts))
        toks = packed[None, P:P + n]
        kw: dict[str, Any] = dict(has_prefix=start > 0)
        if self._is_vl:
            positions = packed[P + n:].reshape(1, n, 3)
            kw["mm_embeds"] = self._mm_chunk_array(seq.req, prompt, start,
                                                   start + n)
        else:
            positions = torch.arange(start, start + n, dtype=i32,
                                     device=dev)[None]
        self.family.prefill_forward(
            self.params, self.cfg.model, toks, positions, self.kv_pages,
            packed[None, :P], torch.full((1,), start, dtype=i32, device=dev),
            torch.full((1,), n, dtype=i32, device=dev), **kw)

    def _ride_chunk_args(self) -> Optional[int]:
        """Write the next chunk of the FRONT prefilling sequence into the
        mixed step's inputs and return its span (C, or 4C under queue
        pressure), or None when nothing can ride: no mixed forward, no
        prefill in flight, a seq mesh (as the reference), rides turned
        off, or only the final chunk left (it samples the first token
        through the install). On any other mesh the mixed step runs
        eager, once a model shard. The host's ``written`` advances here;
        the device work follows in stream order."""
        if (self.family.mixed_decode_chunk_forward is None
                or not self._prefillings or self.seq_parallel > 1
                or not self._sarathi):
            return None
        st = self._prefillings[0]
        if st["req"].mm_embeds is not None:
            return None       # visual rows take the standalone chunk
        prompt, written = st["prompt"], st["written"]
        C = self.cfg.prefill_chunk_tokens
        rideable = len(prompt) - written - C
        if rideable <= 0:
            return None
        span = C
        if rideable >= PRESSURE_SPAN_CHUNKS * C and (
                self._waiting or len(self._prefillings) > 1):
            span = PRESSURE_SPAN_CHUNKS * C
        consume = min(span, rideable)
        toks = np.zeros((span,), np.int32)
        toks[:consume] = prompt[written:written + consume]
        packed = self._upload(np.concatenate([
            toks, self._page_row(st["seq"]),
            np.asarray([written, consume], np.int32)]))
        self._chunk_toks[:span].copy_(packed[:span])
        self._chunk_pt.copy_(packed[None, span:-2])
        self._chunk_start.copy_(packed[-2:-1])
        self._chunk_valid.copy_(packed[-1:])
        st["written"] = written + consume
        # Round-robin, as the standalone chunks.
        self._prefillings.rotate(-1)
        return span

    def _finish_admission(self, seq: _Sequence, req: EngineRequest,
                          prompt: list[int], cache_matched: int,
                          prefix_written: int, t0: float,
                          batch: Optional[list] = None) -> bool:
        """Dispatch the install (the last chunk and the first token); with
        ``batch`` the caller completes it with the burst, else it is
        completed here."""
        try:
            self._dispatch_prefill_install(seq, prompt, prefix_written)
        except Exception as e:  # noqa: BLE001 — e.g. a kernel launch error
            self._fail_admission(seq, req, e)
            raise
        entry = (seq, req, prompt, cache_matched, prefix_written, t0)
        if batch is None:
            self._complete_batch([entry])
        else:
            batch.append(entry)
        return True

    def _complete_batch(self, batch: list) -> None:
        """Complete the dispatched installs of ``batch`` in order after ONE
        wait for all of them. On a failure the entries not completed yet
        (they hold slots and pages ``_fail_all`` cannot see) are failed
        before it re-raises."""
        if not batch:
            return
        try:
            self._sync(self._ready_event())
            while batch:
                self._complete_admission(batch.pop(0))
        except Exception as e:  # noqa: BLE001 — re-raised below
            for seq, req, *_ in batch:
                self._fail_admission(seq, req, e)
            batch.clear()
            raise

    def _complete_admission(self, entry: tuple) -> None:
        """After the burst's wait: TTFT telemetry and spans, prefix
        donation, the slot joins the batch, the first token goes out."""
        seq, req, prompt, cache_matched, prefix_written, t0 = entry
        cfg = self.cfg
        first_token, lp = self._complete_prefill_install(seq)
        handoff = req.prefill_only and req.on_prefill_done is not None
        if self._spec_on and prefix_written > 0 and not handoff:
            # A chunked install (its earlier chunks went up with no slot)
            # or a cache-matched one seeded only the last suffix into the
            # history: one row overwrite repairs it with the whole prompt
            # (a continuation's emitted tokens included), and the draft
            # search opens from 0. Stream order puts it after the
            # install's writes and before the next decode dispatch.
            row = np.zeros((cfg.max_seq_len,), np.int32)
            row[:len(prompt)] = prompt
            row[len(prompt)] = first_token
            self._hist[seq.slot].copy_(self._upload(row))
            self._hist_lo[seq.slot] = 0
        now = time.monotonic()
        ttft_ms = (now - t0) * 1000
        with self._telemetry_lock:
            self.recent_max_ttft_ms = max(self.recent_max_ttft_ms, ttft_ms)
        self.ttft_samples.append((len(prompt), ttft_ms))
        if req.t_submit:
            self.span_samples.append({
                "queue_ms": (t0 - req.t_submit) * 1000,
                "prefill_ms": ttft_ms,
                "prompt_len": float(len(prompt))})
        if cache_matched:
            self.prefix_hits += 1
            self.prefix_hit_tokens += cache_matched
        # Donate completed prompt blocks to the prefix cache (skipping only
        # the blocks matched FROM the cache: chunks written here donate).
        # An image prompt's blocks are never donated.
        if req.mm_embeds is None:
            self._donate(seq, prompt, cache_matched // cfg.hash_block_size,
                         seq.pages.block_hashes)
        if handoff:
            self._hand_off(seq, first_token, lp)
            return
        self._running[seq.slot] = seq
        self._emit_token(seq, first_token, lp)

    # ------------------------------------------------- PD disaggregation
    def extract_kv_pages_device(self, pages: list[int]
                                ) -> Union[torch.Tensor, ShardedBlock]:
        """Gather a sequence's KV pages into a new tensor [L, 2, n, n_kv,
        ps, hd] on the engine's device (kernel ``gather_kv_pages`` on a
        card, the plain gather on the CPU), enqueued on the engine's
        stream; from a head-sharded pool, each shard's part on its device
        (one launch a shard, a ``ShardedBlock``). The device path offers
        it untouched (one buffer a shard); the host paths download it in
        the reference's layout."""
        if (isinstance(self.kv_pages, ModelShardedPages)
                and not self.kv_pages.replicated):
            return ShardedBlock(gather_kv_shards(self.kv_pages, pages))
        return gather_kv_pages(self.kv_pages, pages)

    def extract_kv_pages(self, pages: list[int]) -> torch.Tensor:
        """A sequence's KV pages on the host (a CPU tensor in the
        reference's layout), for the host paths."""
        return self.extract_kv_pages_device(pages).cpu()

    def _hand_off(self, seq: _Sequence, first_token: int,
                  lp: Optional[LogProb]) -> None:
        """PD prefill side, after the install's wait: gather the prompt's
        pages, then clear the slot's row and recycle the slot and pages (a
        later kernel that reuses them follows the gather in stream order),
        and give the handoff to the request's callback. Nothing is
        emitted: the decode peer owns the stream."""
        req = seq.req
        n_pages = -(-len(req.token_ids) // self.cfg.page_size)
        blob = self.extract_kv_pages_device(seq.pages.all_pages[:n_pages])
        handoff = PrefillHandoff(
            service_request_id=req.service_request_id,
            request_id=req.request_id, token_ids=list(req.token_ids),
            first_token=first_token, first_logprob=lp,
            sampling=req.sampling, kv_blob=blob,
            kv_ready=self._ready_event())
        self._clear_slot(seq.slot)
        with self._lock:
            self._free_slots.append(seq.slot)
        seq.pages.release(self.page_mgr)
        seq.finished = True
        try:
            req.on_prefill_done(handoff)
        except Exception:  # noqa: BLE001
            logger.exception("prefill handoff callback failed for %s",
                             req.service_request_id)

    def _start_injected(self, req: EngineRequest) -> bool:
        """PD decode side: admit a sequence whose prompt KV arrives from
        the prefill peer. Reserves pages for prompt + max_new and a slot,
        installs the sequence from the KV and the first token (no wait:
        the next decode dispatch follows it in stream order), donates the
        prompt's blocks to the prefix cache and emits the first token.
        False when the pages do not suffice."""
        cfg = self.cfg
        prompt = req.token_ids
        P0 = len(prompt)
        max_new = max(1, min(req.sampling.max_tokens, cfg.max_seq_len - P0))
        max_total = min(P0 + max_new, cfg.max_seq_len)
        own_pages = self.page_mgr.allocate(-(-max_total // cfg.page_size))
        self._pump_tier_offloads()
        if own_pages is None:
            return False
        seq = _Sequence(req=req, pages=SequencePages(own_pages=own_pages),
                        prompt_len=P0, context_len=P0,
                        max_total_len=max_total)
        with self._lock:
            seq.slot = self._free_slots.pop()
        mcfg, blob = cfg.model, req.injected_kv
        want = (mcfg.num_layers, 2, -(-P0 // cfg.page_size),
                mcfg.num_kv_heads, cfg.page_size, mcfg.head_dim)
        if tuple(blob.shape) != want:
            # A peer's layout this engine cannot take: fail the request.
            self._fail_admission(seq, req, ValueError(
                f"injected KV of shape {tuple(blob.shape)}, expected "
                f"{want}"))
            return True
        first_token = int(req.injected_first_token)
        try:
            self._dispatch_injected_install(seq, blob, first_token)
        except Exception as e:  # noqa: BLE001 — e.g. a kernel launch error
            self._fail_admission(seq, req, e)
            raise
        # The scatter is enqueued: the buffer can go (stream order keeps
        # its memory until the scatter has read it).
        req.injected_kv = None
        # An image prompt (placeholders in its ids) is not donated here
        # either: the prefill side's images are not in its hash.
        if not (self._is_vl and self._count_placeholders(prompt)):
            self._donate(seq, prompt, 0, None)
        self._running[seq.slot] = seq
        # The decode side emits everything, starting with the prefill
        # side's first token.
        self._emit_token(seq, first_token, req.injected_first_logprob)
        return True

    def _donate(self, seq: _Sequence, prompt: list[int], skip_blocks: int,
                block_hashes: Optional[list]) -> None:
        """Donate the prompt's completed blocks past ``skip_blocks`` to the
        prefix cache; a re-prefilled block supersedes any cold-tier copy
        (its ``stored`` event moves the instance to HBM)."""
        stored, donated = self.page_mgr.store_prefix(
            prompt, seq.pages.all_pages, skip_blocks=skip_blocks,
            block_hashes=block_hashes)
        seq.pages.donated_hashes = stored
        seq.pages.donated_pages = donated
        if self.tier_store is not None:
            for hx in stored:
                self.tier_store.discard(hx)

    def _dispatch_injected_install(self, seq: _Sequence, blob: torch.Tensor,
                                   first_token: int) -> None:
        """Scatter the prompt's KV into the sequence's pages (kernel
        ``scatter_kv_pages`` on a card) and install its slot with the
        first token, the sampling controls, stop ids, bias, budget and
        generator, in one packed upload, without waiting. A host blob goes
        up through the pinned-memory cache; a device blob stays where it
        is."""
        dev, sp, prompt = self.device, seq.req.sampling, seq.req.token_ids
        if blob.device.type == "cpu" and dev.type == "cuda":
            blob = blob.pin_memory().to(dev, non_blocking=True)
        scatter_kv_pages(self.kv_pages, seq.pages.all_pages[:blob.shape[2]],
                         blob)
        # The penalty histogram covers prompt + first token.
        pt_row, tok, stop_ids, b_ids, b_vals, counts, _ = \
            self._upload_install(seq, [first_token], prompt + [first_token])
        _, gen = self._install_controls(seq.slot, sp, b_ids, b_vals, counts)
        if gen is not None and sp.seed is not None:
            # The prefill side drew the first token from this seed (one
            # draw of V uniforms, as sample_tokens draws): skip it, so the
            # stream goes on as one engine's would.
            torch.rand(self.cfg.model.vocab_size, generator=gen, device=dev)
        # Only the first token is on this engine (the prompt stayed with
        # the prefill side): the draft search starts there. A VL slot's
        # M-RoPE delta is recomputed from the prompt's ids, where its image
        # grids are.
        self._install_registers(seq, pt_row, stop_ids, tok, len(prompt),
                                tok[:0])
        if self._is_vl:
            self._mrope_delta[seq.slot] = self._mrope_chunk(prompt, 0, 0)[1]

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

    def _sp_applicable(self, suffix_len: int, matched: int,
                       req: EngineRequest) -> bool:
        """Route to the ring-attention prefill? As the reference: a seq
        mesh axis, a prefix-free prompt (the ring has no paged-prefix term),
        no visual splice and enough tokens to be worth the ring. The port
        has no prefill buckets: the suffix is padded to a multiple of the
        axis instead."""
        return (self.seq_parallel > 1 and matched == 0
                and req.mm_embeds is None
                and suffix_len >= self.cfg.seq_parallel_min_tokens)

    def _count_placeholders(self, tokens: list[int]) -> int:
        tid = self.cfg.model.image_token_id
        return sum(1 for t in tokens if t == tid)

    def _mrope_chunk(self, prompt: list[int], start: int, end: int,
                     S: int = 0) -> tuple[np.ndarray, int]:
        """The M-RoPE position rows of prompt[start:end], zero-padded to
        ``S`` rows when ``S`` is larger (the ring's end padding, masked by
        ``seq_lens``), and the prompt's decode delta (``models/qwen2_vl.py::
        mrope_positions``)."""
        from ..models.qwen2_vl import mrope_positions

        pos, delta = mrope_positions(prompt, self.cfg.model.image_token_id)
        out = np.zeros((max(S, end - start), 3), np.int32)
        out[:end - start] = pos[start:end]
        return out, delta

    def _mm_chunk_array(self, req: EngineRequest, prompt: list[int],
                        start: int, end: int) -> torch.Tensor:
        """The visual rows that prompt[start:end]'s placeholders take, [1,
        M, D] on the device in the model's dtype: chunk k's placeholders
        take the rows after those of the earlier chunks. Padded with zero
        rows to a multiple of four images' tokens, as the reference pads
        it (a padding row is never read); a request without images gets
        one zero row, the reference's dummy."""
        mcfg = self.cfg.model
        D = mcfg.hidden_size
        if req.mm_embeds is None:
            return torch.zeros((1, 1, D), dtype=mcfg.dtype,
                               device=self.device)
        offset = self._count_placeholders(prompt[:start])
        n = self._count_placeholders(prompt[start:end])
        mm = req.mm_embeds[offset:offset + n]
        vis = mcfg.vision
        unit = max(1, (vis.out_tokens if vis else 1) * 4)
        M = max(unit, -(-max(1, mm.shape[0]) // unit) * unit)
        if not isinstance(mm, torch.Tensor) or mm.device.type == "cpu":
            host = np.zeros((M, D), np.float32)
            host[:mm.shape[0]] = (mm.float().numpy()
                                  if isinstance(mm, torch.Tensor)
                                  else np.asarray(mm, np.float32))
            return self._upload(host).to(mcfg.dtype)[None]
        out = torch.zeros((M, D), dtype=mcfg.dtype, device=self.device)
        out[:mm.shape[0]] = mm.to(self.device, mcfg.dtype)
        return out[None]

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device without a host wait. On a card the
        bytes pass through a block of PyTorch's pinned-memory cache, which
        is not handed out again before the copy has run (a copy from
        pageable memory would wait for the stream, the pending horizon
        included)."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _page_row(self, seq: _Sequence) -> np.ndarray:
        """The sequence's page-table row [pages_per_seq], garbage-padded."""
        row = np.full((self.cfg.pages_per_seq,), GARBAGE_PAGE, np.int32)
        pages = seq.pages.all_pages
        row[:len(pages)] = pages
        return row

    def _ready_event(self) -> Optional[torch.cuda.Event]:
        """An event behind everything enqueued so far (None on the CPU,
        where work has completed when its call returns)."""
        if self.device.type != "cuda":
            return None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return ready

    def _sync(self, ready: Optional[torch.cuda.Event]) -> None:
        """The engine's one kind of host wait on the card: at a horizon's
        drain, and once per burst of installs."""
        if ready is not None:
            ready.synchronize()

    def _upload_install(self, seq: _Sequence, toks: list[int],
                        hist: list[int], extra: Optional[np.ndarray] = None
                        ) -> tuple:
        """A slot install's inputs in ONE packed upload: the page-table row
        first (kernel 2 takes it 16-byte aligned), ``toks``, the stop ids,
        the bias, ``extra`` int32s (a VL install's M-RoPE rows and delta;
        returned last, None without), and the [V] histogram of ``hist``,
        which feeds only the penalty terms: without a penalty ``counts`` is
        None and the install zeroes the row (clearing the previous
        occupant's counts)."""
        sp, V = seq.req.sampling, self.cfg.model.vocab_size
        bias_ids, bias_vals = self._device_bias(sp)
        parts = [self._page_row(seq), np.asarray(toks, np.int32),
                 self._device_stop_ids(sp), bias_ids, bias_vals.view(np.int32),
                 extra if extra is not None else np.zeros((0,), np.int32)]
        if (sp.frequency_penalty != 0.0 or sp.presence_penalty != 0.0
                or _repetition(sp) != 1.0):
            parts.append(np.bincount(np.asarray(hist, np.int64),
                                     minlength=V)[:V].astype(np.int32))
        packed = self._upload(np.concatenate(parts))
        pt_row, toks_t, stop_ids, b_ids, b_vals, extra_t, *counts = \
            torch.split(packed, [p.size for p in parts])
        return (pt_row, toks_t, stop_ids, b_ids, b_vals,
                counts[0] if counts else None,
                extra_t if extra is not None else None)

    def _install_controls(self, slot: int, sp: SamplingParams,
                          b_ids: torch.Tensor, b_vals: torch.Tensor,
                          counts: Optional[torch.Tensor]
                          ) -> tuple[SamplingState, Optional[torch.Generator]]:
        """Write a slot's sampling controls, bias and penalty histogram, and
        seed its generator (None when greedy)."""
        st = self._slot_state(slot)
        st.temperature.fill_(sp.temperature)
        st.top_k.fill_(int(sp.top_k))
        st.top_p.fill_(sp.top_p)
        st.frequency_penalty.fill_(sp.frequency_penalty)
        st.presence_penalty.fill_(sp.presence_penalty)
        st.repetition_penalty.fill_(_repetition(sp))
        st.bias_ids.copy_(b_ids[None])
        st.bias_vals.copy_(b_vals.view(torch.float32)[None])
        if counts is not None:
            st.token_counts.copy_(counts[None])
        else:
            st.token_counts.zero_()
        if sp.temperature <= 0:
            return st, None
        seed = sp.seed if sp.seed is not None else self._rng.getrandbits(63)
        return st, self._gens[slot].manual_seed(seed)

    def _install_registers(self, seq: _Sequence, pt_row: torch.Tensor,
                           stop_ids: torch.Tensor, tok: torch.Tensor,
                           hist_lo: int, hist_toks: torch.Tensor) -> None:
        """Make a slot live with its first token ``tok``: page row, last
        token, context length, stop ids and budget. Under speculation the
        history holds ``hist_toks`` from ``hist_lo`` on, then the token,
        and the draft search starts at ``hist_lo``."""
        slot, clen = seq.slot, hist_lo + hist_toks.numel()
        self._pt[slot] = pt_row
        self._last[slot] = tok[0]
        self._clens[slot] = clen + 1
        self._active[slot] = True
        self._stop_ids[slot] = stop_ids
        self._budget[slot] = seq.max_total_len
        if self._spec_on:
            self._hist_buf[slot, hist_lo:clen].copy_(hist_toks)
            self._hist_buf[slot, clen] = tok[0]
            self._hist_lo[slot] = hist_lo
            self._want_lp[slot] = seq.req.sampling.logprobs

    def _dispatch_prefill_install(self, seq: _Sequence, prompt: list[int],
                                  matched: int) -> None:
        """Prefill the suffix past the first ``matched`` tokens, install the
        sequence into its batch slot and sample its first token, without
        waiting: its inputs go up in ONE packed upload, and the token (with
        its logprob pack when asked for) lands in the slot's row of the
        install buffer on the host behind the stream, read by
        ``_complete_prefill_install`` after the burst's wait. Every buffer
        it writes is its slot's, so a later install of the burst touches
        none that an earlier one still reads."""
        cfg, dev, slot = self.cfg, self.device, seq.slot
        sp = seq.req.sampling
        suffix = prompt[matched:]
        S = len(suffix)
        ring = self._sp_applicable(S, matched, seq.req)
        if ring:
            # End padding, masked by seq_lens: the causal ring keeps it out
            # of every valid query's window, and its K/V go to page 0.
            suffix = suffix + [0] * (-S % self.seq_parallel)
            self.ring_prefills += 1
        vl = None
        if self._is_vl:
            # [pos3 (3 a row, padded as the suffix) | delta]: M-RoPE's
            # rows depend on the image grids, which only the host sees.
            pos3, delta = self._mrope_chunk(prompt, matched, len(prompt),
                                            len(suffix))
            vl = np.concatenate([pos3.reshape(-1),
                                 np.asarray([delta], np.int32)])
        pt_row, toks, stop_ids, b_ids, b_vals, counts, vl_t = \
            self._upload_install(seq, suffix, prompt, vl)
        i32 = torch.int32
        kw: dict[str, Any] = dict(has_prefix=matched > 0, ring=ring)
        if vl_t is not None:
            positions = vl_t[:-1].reshape(1, len(suffix), 3)
            kw["mm_embeds"] = self._mm_chunk_array(seq.req, prompt, matched,
                                                   len(prompt))
        else:
            positions = torch.arange(matched, matched + len(suffix),
                                     dtype=i32, device=dev)[None]
        logits, _ = self.family.prefill_forward(
            self.params, cfg.model, toks[None], positions,
            self.kv_pages, pt_row[None],
            torch.full((1,), matched, dtype=i32, device=dev),
            torch.full((1,), S, dtype=i32, device=dev), **kw)

        # Install the slot's sampling controls, then sample with them.
        st, gen = self._install_controls(slot, sp, b_ids, b_vals, counts)
        tok, logprobs = sample_tokens(logits, st, [gen],
                                      want_logprobs=sp.logprobs)
        record_tokens(st.token_counts, tok,
                      torch.ones((1,), dtype=torch.bool, device=dev))
        # The tokens before ``matched`` were never uploaded: the draft
        # search starts there.
        self._install_registers(seq, pt_row, stop_ids, tok, matched,
                                toks[:S])
        if vl_t is not None:
            self._mrope_delta[slot] = vl_t[-1]

        K = cfg.max_top_logprobs
        row = self._inst_rows[slot]
        row[:1].copy_(tok)
        if sp.logprobs:
            tv, ti = torch.topk(logprobs, K, dim=-1)
            row[1:2].copy_(torch.gather(logprobs, 1, tok.long()[:, None])[0])
            row[2:2 + K].copy_(tv[0])
            row[2 + K:].copy_(ti[0])
        self._inst_host[slot].copy_(row, non_blocking=dev.type == "cuda")

    def _complete_prefill_install(self, seq: _Sequence
                                  ) -> tuple[int, Optional[LogProb]]:
        """A dispatched install's first token (and logprob), read from its
        slot's row of the host buffer after the burst's wait."""
        row = self._inst_host[seq.slot].numpy()
        K = self.cfg.max_top_logprobs
        token = int(row[0])
        return token, self._make_logprob(token, float(row[1]), row[2:2 + K],
                                         row[2 + K:].astype(np.int64),
                                         seq.req.sampling)

    # -------------------------------------------------------------- decode
    def _decode(self) -> bool:
        if not self._running:
            # No live batch: flush the tail of either pipeline.
            drained = self._drain_pending_decode()
            return self._drain_pending_spec() or drained
        if self._spec_on and self._spec_worthwhile():
            # Switching paths costs one wait: a pending plain horizon is
            # drained before a spec call dispatches (and the other way
            # round), so the two pipelines never interleave on stale state.
            # The spec call carries no chunk: step() advances a chunked
            # prefill by a standalone chunk meanwhile.
            self._drain_pending_decode()
            return self._decode_speculative()
        self._drain_pending_spec()
        # Bound the horizon by the LONGEST remaining token budget among
        # running sequences (pow2 ceiling); per-sequence budgets are
        # enforced on the device, so one nearly-done sequence never clamps
        # the whole batch. (With a horizon in flight, output_ids lags by
        # its length; the device budget freezes any overshoot.)
        horizon = self.cfg.decode_horizon
        # TTFT guard: with arrivals waiting or a chunked prefill in flight,
        # keep decode calls short.
        ah = self.cfg.admission_horizon
        if ah > 0 and (self._waiting or self._prefillings):
            horizon = min(horizon, ah)
        rem = max((s.max_total_len - s.prompt_len - len(s.output_ids)
                   for s in self._running.values() if not s.finished),
                  default=horizon)
        if 0 < rem < horizon:
            horizon = min(1 << (rem - 1).bit_length(), horizon)
        t0 = time.monotonic()
        snapshot = {slot: seq for slot, seq in self._running.items()
                    if not seq.finished}
        span = self._ride_chunk_args()
        rows, ready = self._decode_multi(horizon, snapshot, span or 0)
        if span:
            self._rode_chunk = True
            self.sarathi_rides += 1
        # Pipeline: this horizon is enqueued; process the PREVIOUS one's
        # rows while the device runs it.
        prev, self._pending_decode = (self._pending_decode,
                                      (rows, ready, t0, horizon, snapshot))
        if prev is not None:
            self._drain_one_decode(prev)
        return True

    def _drain_pending_decode(self) -> bool:
        pend, self._pending_decode = self._pending_decode, None
        if pend is None:
            return False
        self._drain_one_decode(pend)
        return True

    def _drain_one_decode(self, pend: tuple) -> None:
        """Wait for a dispatched horizon's rows and emit them, one delta
        per live sequence, recording the step's latency."""
        rows, ready, t0, horizon, snapshot = pend
        self._sync(ready)
        packed = rows.numpy()                         # [H, B, 2 + 2K]
        ms_per_tok = (time.monotonic() - t0) * 1000 / max(1, horizon)
        with self._telemetry_lock:
            self.recent_max_tbt_ms = max(self.recent_max_tbt_ms, ms_per_tok)
        live = [s for s in snapshot.values() if not s.finished]
        if live:
            self.tpot_samples.append(
                (len(live), sum(s.context_len for s in live), ms_per_tok))
        K = self.cfg.max_top_logprobs
        H = packed.shape[0]
        for slot, seq in snapshot.items():
            # The slot may have been finished, cancelled or reused by a new
            # sequence since the dispatch: emit only to the sequence the
            # horizon decoded, and only while it owns the slot.
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

    def _decode_multi(self, horizon: int, running: dict[int, _Sequence],
                      span: int = 0
                      ) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Dispatch ``horizon`` decode steps of the whole batch (the first a
        mixed step carrying ``span`` chunk rows when ``span`` > 0) and the
        copy of their rows to the host. Returns (host rows [H, B, 2 + 2K]
        f32, the event after the copy; None on the CPU, where the copy has
        completed)."""
        want_lp = any(s.req.sampling.logprobs for s in running.values())
        sample = any(s.req.sampling.temperature > 0 for s in running.values())
        for h in range(horizon):
            self._step(want_lp, sample, span if h == 0 else 0)
            self._hrows[h].copy_(self._row)
        rows = self._host_rows[self._host_next][:horizon]
        self._host_next ^= 1
        rows.copy_(self._hrows[:horizon],
                   non_blocking=self.device.type == "cuda")
        return rows, self._ready_event()

    def _step(self, want_lp: bool, sample: bool, span: int = 0) -> None:
        """One decode step (a mixed one with ``span`` chunk rows): a replay
        of its captured variant on a card with a single-device pool, the
        eager step otherwise."""
        key = (want_lp, sample, span) if span else (want_lp, sample)
        if self._graphs is not None:
            self._graphs.run(*key)
        else:
            self._decode_step(*key)

    def _graph_step(self, *key) -> None:
        """The step a captured variant records: ``("spec", want_lp,
        sample)`` is one spec cycle, any other key a decode step."""
        if key[0] == "spec":
            self._spec_cycle(*key[1:])
        else:
            self._decode_step(*key)

    def _decode_step(self, want_lp: bool, sample: bool,
                     span: int = 0) -> None:
        """One decode step of the whole batch, in place on the device
        state: forward, sampling (``sample``: every slot draws from its
        generator; greedy slots ignore the draw), the penalty histogram,
        the device-side stop and budget update, and the packed row into
        ``self._row`` (top-K logprobs with ``want_lp``, else zeros). With
        ``span`` > 0 the forward is the mixed step over the batch and the
        first ``span`` rows of the chunk buffers (``_ride_chunk_args``).
        Allocates nothing that outlives the call and reads nothing from
        the host, so it can be captured (``engine/decode_graph.py``)."""
        cfg, mcfg = self.cfg, self.cfg.model
        K = cfg.max_top_logprobs
        if span:
            logits, _ = self.family.mixed_decode_chunk_forward(
                self.params, mcfg, self._last, self._clens - 1,
                self._chunk_toks[:span],
                self._chunk_start + torch.arange(span, dtype=torch.int32,
                                                 device=self.device),
                self.kv_pages, self._pt, self._chunk_pt, self._clens,
                self._chunk_start, self._chunk_valid)
        elif self._is_vl:
            # M-RoPE: rope at the index plus the slot's delta, read from
            # its fixed buffer; the K/V write stays at the index.
            pos = self._clens - 1
            logits, _ = self.family.decode_forward(
                self.params, mcfg, self._last, pos, self.kv_pages, self._pt,
                self._clens, rope_positions=pos + self._mrope_delta)
        else:
            logits, _ = self.family.decode_forward(
                self.params, mcfg, self._last, self._clens - 1,
                self.kv_pages, self._pt, self._clens)
        gens = self._gens if sample else [None] * cfg.max_batch_size
        toks, logprobs = sample_tokens(logits, self._st, gens,
                                       want_logprobs=want_lp)
        record_tokens(self._st.token_counts, toks, self._active)
        row = self._row
        row[:, 0].copy_(toks)
        if want_lp:
            row[:, 1:2].copy_(torch.gather(logprobs, 1, toks.long()[:, None]))
            tv, ti = torch.topk(logprobs, K, dim=-1)
            row[:, 2:2 + K].copy_(tv)
            row[:, 2 + K:].copy_(ti)
        else:
            row[:, 1:].zero_()
        if self._spec_on:
            # Append to the history (drafts come from it): the token lands
            # at clens, becoming hist[new clens - 1] == last.
            L = self.cfg.max_seq_len
            wpos = torch.where(self._active, self._clens.clamp(max=L), L)
            self._hist_buf.scatter_(1, wpos.long()[:, None], toks[:, None])
        # Device-side stop: a slot that sampled one of its stop ids, or
        # reached its token budget, freezes (no clens growth, its KV
        # writes repeat in place) for the rest of the horizon. The stop
        # token itself is still emitted by the host.
        hit = (toks[:, None] == self._stop_ids).any(dim=-1)
        hit |= (self._budget > 0) & (self._clens + 1 >= self._budget)
        advance = self._active & ~hit
        self._last.copy_(torch.where(advance, toks, self._last))
        self._clens.copy_(torch.where(advance, self._clens + 1, self._clens))
        self._active.copy_(advance)

    # ------------------------------------------------ speculative decoding
    def _spec_worthwhile(self) -> bool:
        """Take the speculative path when at least one running slot can
        verify drafts; with none, the plain horizon gives the same tokens
        per round trip without k dead verify positions a forward."""
        return any(not s.finished and spec_ok(s.req.sampling)
                   for s in self._running.values())

    def _decode_speculative(self) -> bool:
        """``speculate_cycles`` propose+verify cycles per host round trip,
        dispatched before the previous call's rows are read. Greedy slots
        emit up to ``speculate_k`` + 1 tokens a cycle; sampled and logprob
        slots exactly one, the rate of a plain horizon of that length."""
        B, C = self.cfg.max_batch_size, self.cfg.speculate_cycles
        room = np.zeros((B,), np.int32)
        for slot, seq in self._running.items():
            if not seq.finished:
                # With a call in flight, output_ids lags one call: the
                # overshoot this allows is discarded by _emit_tokens at
                # the budget. Its K/V lands in the row's slack pages or on
                # the garbage page, and its history writes past the
                # context in the spare column.
                room[slot] = max(0, seq.max_total_len - seq.prompt_len
                                 - len(seq.output_ids))
        snapshot = {slot: seq for slot, seq in self._running.items()
                    if not seq.finished}
        t0 = time.monotonic()
        self._room.copy_(self._upload(room))
        rows, ready = self._spec_multi(C, snapshot)
        prev, self._pending_spec = (self._pending_spec,
                                    (rows, ready, t0, snapshot))
        if prev is not None:
            self._drain_one_spec(prev)
        return True

    def _spec_multi(self, cycles: int, running: dict[int, _Sequence]
                    ) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Dispatch ``cycles`` spec cycles of the whole batch and the copy
        of their rows to the host. Returns (host rows [cycles, B, 1 + (k+1)
        + 1 + 2K] f32, the event after the copy; None on the CPU)."""
        want_lp = any(s.req.sampling.logprobs for s in running.values())
        sample = any(s.req.sampling.temperature > 0 for s in running.values())
        for c in range(cycles):
            if self._graphs is not None:
                self._graphs.run("spec", want_lp, sample)
            else:
                self._spec_cycle(want_lp, sample)
            self._spec_rows[c].copy_(self._srow)
        rows = self._spec_host[self._spec_next][:cycles]
        self._spec_next ^= 1
        rows.copy_(self._spec_rows[:cycles],
                   non_blocking=self.device.type == "cuda")
        return rows, self._ready_event()

    def _spec_cycle(self, want_lp: bool, sample: bool) -> None:
        """One propose+verify cycle of the whole batch, in place on the
        device state (the reference's ``spec_multi`` cycle). Eligible
        slots verify drafts proposed from their history: one forward over
        [last ‖ drafts] accepts the longest draft prefix equal to the
        model's own argmax, plus one correction or bonus token. Every other
        live slot takes a normal step from position 0's logits (the
        forward of ``last``, exactly the decode step's), drawing once from
        its generator when ``sample``, as a plain step does. The block is
        bounded by ``_room``, which counts down; acceptance is cut at the
        first stop id. Writes the packed row into ``self._srow``.
        Allocates nothing that outlives the call and reads nothing from
        the host, so it can be captured."""
        cfg, mcfg, dev = self.cfg, self.cfg.model, self.device
        Kd, K, B = cfg.speculate_k, cfg.max_top_logprobs, cfg.max_batch_size
        st, clens, room = self._st, self._clens, self._room
        steps = torch.arange(Kd + 1, dtype=torch.int32, device=dev)[None, :]
        live = self._active
        ok = spec_eligible(st, self._want_lp)
        drafts = propose_drafts(self._hist, clens, self._hist_lo,
                                cfg.speculate_ngram, Kd)
        drafts = torch.where((ok & live)[:, None], drafts, -1)
        blk = torch.where(ok, room.clamp(max=Kd + 1), room.clamp(max=1))
        seq_lens = torch.where(live, blk.clamp(min=0), 0)
        tokens = torch.cat([self._last[:, None], drafts], dim=1)
        prefix = (clens - 1).clamp(min=0)
        logits, _ = self.family.verify_forward(
            self.params, mcfg, tokens, prefix[:, None] + steps,
            self.kv_pages, self._pt, prefix, seq_lens)      # [B, k+1, V]
        preds = logits.argmax(dim=-1).to(torch.int32)
        gens = self._gens if sample else [None] * B
        toks0, logprobs0 = sample_tokens(logits[:, 0], st, gens,
                                         want_logprobs=want_lp)
        record_tokens(st.token_counts, toks0, live & ~ok)
        emit0 = torch.where(ok, preds[:, 0], toks0)
        preds = torch.cat([emit0[:, None], preds[:, 1:]], dim=1)
        row = self._srow
        if want_lp:
            row[:, 2 + Kd].copy_(
                torch.gather(logprobs0, 1, emit0.long()[:, None])[:, 0])
            tv, ti = torch.topk(logprobs0, K, dim=-1)
            row[:, 3 + Kd:3 + Kd + K].copy_(tv)
            row[:, 3 + Kd + K:].copy_(ti)
        else:
            row[:, 2 + Kd:].zero_()
        match = (drafts == preds[:, :Kd]).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        # Acceptance bounded by the block (a slot never emits past room).
        acc = torch.minimum(acc, (seq_lens - 1).clamp(min=0))
        emit_mask = (steps <= acc[:, None]) & live[:, None]
        # Device-side stop: acceptance is cut at the first stop id.
        is_stop = (preds[:, :, None] == self._stop_ids[:, None, :]).any(-1)
        stop_hit = emit_mask & is_stop
        any_stop = stop_hit.any(dim=1)
        first_stop = stop_hit.to(torch.int32).argmax(dim=1)
        acc = torch.where(any_stop,
                          torch.minimum(acc, first_stop.to(torch.int32)), acc)
        emitting = live & (room > 0)
        n_emit = torch.where(emitting, acc + 1, 0)
        # Append the emitted tokens to the history. A block that overshoots
        # the context (room lags one call) sends its writes past the table
        # to the spare column, as the reference's writes there are dropped.
        L = cfg.max_seq_len
        wpos = torch.where(steps < n_emit[:, None],
                           (clens[:, None] + steps).clamp(max=L), L)
        self._hist_buf.scatter_(1, wpos.long(), preds)
        last_tok = torch.gather(preds, 1, acc.long()[:, None])[:, 0]
        advance = emitting & ~any_stop
        self._last.copy_(torch.where(advance, last_tok, self._last))
        clens.copy_(torch.where(emitting, clens + n_emit, clens))
        self._active.copy_(advance)
        room.sub_(n_emit)
        row[:, 0].copy_(n_emit)
        row[:, 1:2 + Kd].copy_(preds)

    def _drain_pending_spec(self) -> bool:
        pend, self._pending_spec = self._pending_spec, None
        if pend is None:
            return False
        self._drain_one_spec(pend)
        return True

    def _drain_one_spec(self, pend: tuple) -> None:
        """Wait for a dispatched spec call's rows and emit them: per live
        sequence one delta per cycle that emitted, with the decode
        telemetry per emitted token."""
        rows, ready, t0, snapshot = pend
        self._sync(ready)
        out = rows.numpy()                    # [C, B, 1 + (k+1) + 1 + 2K]
        elapsed = time.monotonic() - t0
        Kd, K = self.cfg.speculate_k, self.cfg.max_top_logprobs
        base = 1 + (Kd + 1)
        emitted = 0
        for slot, seq in snapshot.items():
            # As the plain pipeline: the slot may have finished, been
            # cancelled or been reused since the dispatch.
            if seq.finished or self._running.get(slot) is not seq:
                continue
            for c in range(out.shape[0]):
                if seq.finished:
                    break       # a host-side stop (e.g. a stop string)
                n = int(out[c, slot, 0])
                if n <= 0:
                    continue
                tokens = out[c, slot, 1:1 + n].astype(np.int64).tolist()
                lps: list[Optional[LogProb]] = [None] * n
                if seq.req.sampling.logprobs:
                    # A logprob slot emits one token a cycle; the row's
                    # tail is its logprob pack.
                    lps[0] = self._make_logprob(
                        tokens[0], float(out[c, slot, base]),
                        out[c, slot, base + 1:base + 1 + K],
                        out[c, slot, base + 1 + K:].astype(np.int64),
                        seq.req.sampling)
                seq.context_len += n
                emitted += n
                self._emit_tokens(seq, tokens, lps)
        per_seq = emitted / max(1, len(snapshot))
        ms_per_tok = elapsed * 1000 / max(1.0, per_seq)
        with self._telemetry_lock:
            self.recent_max_tbt_ms = max(self.recent_max_tbt_ms, ms_per_tok)
        live = [s for s in snapshot.values() if not s.finished]
        if live:
            self.tpot_samples.append(
                (len(live), sum(s.context_len for s in live), ms_per_tok))

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

    def _release_slot_and_pages(self, seq: _Sequence) -> None:
        if seq.slot >= 0 and seq.slot in self._running:
            del self._running[seq.slot]
            self._clear_slot(seq.slot)
            with self._lock:
                self._free_slots.append(seq.slot)
        seq.pages.release(self.page_mgr)

    def _clear_slot(self, s: int) -> None:
        """Clear a dead slot's device row BEFORE its pages are recycled: a
        stale row would let it scribble K/V into pages that a new sequence
        now owns."""
        self._pt[s] = GARBAGE_PAGE
        self._active[s] = False
        self._clens[s] = 0
        self._budget[s] = 0
        self._mrope_delta[s] = 0

    def _finish_sequence(self, seq: _Sequence, reason: str,
                         emit: bool = True) -> None:
        self._release_slot_and_pages(seq)
        if emit and not seq.finished:
            seq.req.on_output(RequestOutput(
                service_request_id=seq.req.service_request_id,
                request_id=seq.req.request_id,
                status=Status(StatusCode.CANCELLED, reason), finished=True))
        seq.finished = True
