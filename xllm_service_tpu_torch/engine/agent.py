"""Engine instance agent: the process that owns the port's engines and
speaks the orchestration wire contract (port of ``xllm_service_tpu/engine/
agent.py``).

It registers in coordination under ``XLLM:INSTANCE:<TYPE>:<name>`` with a
TTL lease and an incarnation id, beats every 3 s with KvCacheEvents and
load/latency metrics, accepts enriched completions and chat dispatches,
streams batched Generations back, serves ``/health`` probes, and honours
cancel, drain, link/unlink and role flips. The unchanged reference master
serves it in the reference's defaults:

- **Telemetry** (``telemetry_mode``). ``"mux"`` (the default): beats and
  delta pushes ride tagged msgpack frames on one kept-alive pool to the
  master that owns this instance under the rendezvous shard map
  (``multimaster/ownership.py``) on ``/rpc/telemetry``; a master without
  the route (404/405) demotes the agent to the elected-master funnel, an
  owner that fails is skipped for its rendezvous successor, and a beat's
  ``owner`` hint re-routes the next one. ``"owner"``: beats to the owner,
  pushes direct. ``"master"``: the legacy funnel.
- **Wire.** It advertises ``wire_formats=["msgpack", "json"]``; dispatch
  bodies are decoded by content type (``rpc/wire.py``), heartbeats and
  Generations go out as msgpack (a master answering 400/415 demotes the
  beats to JSON until the master changes).
- **Observability.** ``/metrics`` (the reference's families and labels),
  engine-side spans under the master's trace (``engine.prefill`` at
  accept, ``engine.decode`` from the first token; ``/admin/trace`` and
  ``/admin/trace/recent``), the flight recorder
  (``/admin/flightrecorder/recent``, with this agent's ``engine``
  context) and the sampling profiler (``/admin/profile``).
- **Replicas** (``dp_size``): independent engines behind one
  registration, replica ``i`` on the ``i``-th device from the agent's
  (the same card for every replica on a one-card machine, sharing replica
  0's weight tensors), dispatched prefix-affine with a load guard.
- **One instance over processes** (``XLLM_MH_COORDINATOR``,
  ``XLLM_MH_NUM_HOSTS``, ``XLLM_MH_HOST_ID``): ``main`` joins the process
  group before it touches a device, and every rank builds the same engine
  and tokenizer over a mesh that spans the ranks. The primary (rank 0)
  serves as above, its engine wrapped in
  ``engine/multihost_driver.py::MultihostEngineProxy``; a follower runs
  the lockstep loop and never serves HTTP. ``--dp-size`` above 1 is an
  error there.

PD disaggregation: a PREFILL agent given a ``routing.decode_name`` runs
the request prefill-only and ships the ``PrefillHandoff`` to that peer on
``/rpc/kv_transfer`` in the reference's msgpack frame: over CUDA IPC when
the peer's ``kv_transfer_addr`` names this same card
(``engine/kv_transfer.py``), else streamed back over
``/rpc/kv_stream_pull`` at or above ``kv_stream_threshold_bytes``, else
inline; a streamed handoff that falls back to inline leaves a
``kv_stream_fallback`` flight record, and a failed handoff reaches the
service as UNAVAILABLE. A DECODE agent takes handoffs only from linked
peers and injects them into the replica ``_pick_engine`` chooses.

EPD (encode, prefill, decode) for the qwen2_vl family: a chat whose
messages carry image parts (PNG data URIs decoded with PIL, or raw
``image_data`` float32 arrays) is encoded by the vision tower on the
ENCODE instance the master routes in ``routing.encode_name`` (its
``/rpc/encode``, a msgpack body ``{"bytes", "shape", "dtype"}`` both
ways), or here without one; the chat template renders each image part as
one marker, which expands to ``out_tokens`` placeholder ids, and the
engine splices the visual rows there. A bad image part answers 400, a
failed encode 502. An ENCODE agent registers as ``--type ENCODE`` and
counts its encodes (``encode_count`` in ``/stats``). The encoder runs on
the engine's thread between steps, as ``/v1/embeddings`` does.

Written on the standard library: ``http.server`` for the routes (HTTP/1.1,
kept-alive connections, a ``Content-Length`` on every reply) and
``http.client`` for its own posts; ``jinja2`` renders the chat template
and PIL decodes images, as in the reference (PyTorch's own requirements
bring ``jinja2``).

Run: ``python -m xllm_service_tpu_torch.engine.agent --coordination-addr
host:port --model-config llama3_8b [--dp-size N] [--telemetry-mode
mux|owner|master]`` (the card unless ``--device cpu``), with random
weights from the engine's seed; with ``--checkpoint-path D
--tokenizer-path D`` it serves a Hugging Face model directory D (its
``*.safetensors`` read straight onto the card, its ``tokenizer.json`` read
on the standard library), or a native checkpoint
(``models/loader.py::save_params``). ``--model-config hf`` takes the model
from D's ``config.json`` (llama, qwen2, gemma2, mixtral, deepseek_v2/3,
qwen2_vl) in its ``torch_dtype``.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import logging
import queue
import socket
import statistics
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional, Union
from urllib.parse import parse_qsl, urlsplit

import numpy as np
import torch

from ..chat_template import MM_PLACEHOLDER, JinjaChatTemplate
from ..common import topology as topo
from ..common.device import resolve_device
from ..common.flightrecorder import RECORDER, admin_flightrecorder_recent
from ..common.metrics import (
    ENGINE_HEARTBEATS_TOTAL,
    ENGINE_PEER_LINKED,
    evict_series,
)
from ..common.net import pick_free_port
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
from ..common.tracing import (
    NOOP_SPAN,
    TRACER,
    TraceContext,
    admin_trace,
    admin_trace_recent,
)
from ..common.types import (
    InstanceMetaInfo,
    InstanceType,
    KvCacheEvent,
    TpuTopology,
    now_ms,
)
from ..coordination import CoordinationClient, connect
from ..devtools import lifecycle as _lifecycle
from ..devtools import ownership as _ownership
from ..devtools.locks import make_lock
from ..models.base import get_model_family
from ..multimaster.ownership import TelemetryOwnerResolver
from ..parallel import multihost
from ..parallel.mesh import DeviceMesh, MeshConfig, mesh_from_config
from ..profiling.sampler import PROFILER, admin_profile
from ..rpc import MASTER_KEY, instance_key, msgpack_lite
from ..rpc import wire
from ..tokenizer.factory import TokenizerFactory
from .config import EngineConfig
from .engine import EngineRequest, InferenceEngine, PrefillHandoff
from .kv_transfer import (
    BandwidthAccountant,
    KvTransferManager,
    StreamOfferTable,
    dtype_name,
    pull_stream,
    tensor_bytes,
    tensor_from_bytes,
)

logger = logging.getLogger(__name__)


def pack_handoff(h: PrefillHandoff, source_service_addr: str,
                 kv_ref: Optional[dict] = None,
                 source_instance: str = "",
                 trace_context: Optional[dict] = None,
                 kv_stream: Optional[dict] = None) -> bytes:
    """Serialize a PD handoff control message (the reference's frame).
    With `kv_ref` (device path) only the pull descriptor is sent; with
    `kv_stream` the host bytes are pulled back in chunked frames;
    otherwise the blob is downloaded and carried inline (raw bytes, bf16
    as its 16-bit patterns under the dtype string "bfloat16").
    `source_instance` identifies the sending prefill instance: the decode
    side only accepts handoffs from linked peers."""
    lp = h.first_logprob
    msg: dict[str, Any] = {
        "service_request_id": h.service_request_id,
        "request_id": h.request_id,
        "source_service_addr": source_service_addr,
        "source_instance": source_instance,
        "token_ids": [int(t) for t in h.token_ids],
        "first_token": int(h.first_token),
        "first_logprob": None if lp is None else {
            "token": lp.token, "token_id": int(lp.token_id),
            "logprob": float(lp.logprob),
            "top": [(t.token, int(t.token_id), float(t.logprob))
                    for t in lp.top_logprobs]},
        "sampling": h.sampling.to_dict(),
    }
    if trace_context is not None:
        msg["trace_context"] = trace_context
    if kv_ref is not None:
        msg["kv_ref"] = kv_ref
    elif kv_stream is not None:
        msg["kv_stream"] = kv_stream
    else:
        blob = h.kv_blob
        msg["kv"] = {"bytes": tensor_bytes(blob),
                     "shape": list(blob.shape),
                     "dtype": dtype_name(blob.dtype)}
    return msgpack_lite.packb(msg)


def unpack_handoff(data: bytes) -> dict:
    """Inverse of :func:`pack_handoff`; an inline ``kv`` entry becomes
    ``kv_blob``, a CPU tensor over the frame's bytes."""
    obj = msgpack_lite.unpackb(data)
    kv = obj.get("kv")
    if kv is not None:
        obj["kv_blob"] = tensor_from_bytes(kv["bytes"], kv["shape"],
                                           kv["dtype"])
    return obj



# The agent's telemetry wirings (see the module docstring).
TELEMETRY_MODES = ("mux", "owner", "master")


@dataclass
class AgentConfig:
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral
    coordination_addr: str = ""
    instance_type: InstanceType = InstanceType.MIX
    model_id: str = "tiny-llama"
    heartbeat_interval_s: float = 3.0
    lease_ttl_s: float = 3.0
    generation_flush_ms: float = 5.0   # batching window for Generations
    # "mux": one multiplexed session to the owning master (tagged hb and
    # gens frames on /rpc/telemetry); "owner": beats to the owner, deltas
    # direct per destination; "master": beats to the elected master.
    telemetry_mode: str = "mux"
    # Coordination-plane static stability: "on" keeps beats flowing to the
    # last owner (or master) that resolved while the plane is unreachable,
    # so the masters' degraded-mode liveness fallback sees this engine
    # alive; "off": no resolvable target, no beats.
    degraded_mode: str = "on"
    slice_id: str = "slice-0"
    # Topology placement coordinate (common/topology.py): a non-empty
    # topo_host marks this instance as placed; its PD links are then
    # classed by coordinates for the bandwidth budgets.
    topo_host: str = ""
    topo_chip: int = -1
    # Engine replicas behind this one registration: replica i runs on the
    # i-th device from the agent's (round robin over the cards).
    dp_size: int = 1
    # Host-path streaming transfer: payloads at or above the threshold are
    # pulled back in chunked msgpack frames instead of one inline POST. 0
    # streams everything; a negative threshold disables streaming.
    kv_stream_threshold_bytes: int = 256 * 1024
    # Per-link-class bandwidth budgets, bytes/s (0 = unthrottled): links
    # to a peer on the same slice are ICI-shaped, others DCN-shaped. The
    # pull side paces to the budget; throughput reports in /stats.
    ici_bytes_per_s: float = 0.0
    dcn_bytes_per_s: float = 0.0
    # A model directory (tokenizer.json, tiktoken or SentencePiece) or a
    # tokenizer file; "" = the hermetic byte tokenizer.
    tokenizer_path: str = ""


class _ChoiceAggregator:
    """Merges n engine sequences into one OpenAI request: re-indexes each
    choice's outputs and defers `finished`/usage until the last choice
    completes."""

    def __init__(self, n: int, push: Callable[[RequestOutput], None]):
        self._remaining = n
        self._push = push
        self._prompt_tokens = 0
        self._generated = 0
        self._lock = make_lock("agent.choice_aggregator", order=60)  # lock-order: 60

    def callback_for(self, index: int) -> Callable[[RequestOutput], None]:
        def cb(out: RequestOutput) -> None:
            for seq_out in out.outputs:
                seq_out.index = index
            if out.finished:
                with self._lock:
                    self._remaining -= 1
                    last = self._remaining == 0
                    if out.usage is not None:
                        self._prompt_tokens = out.usage.num_prompt_tokens
                        self._generated += out.usage.num_generated_tokens
                    if last:
                        out.usage = Usage(
                            num_prompt_tokens=self._prompt_tokens,
                            num_generated_tokens=self._generated)
                    else:
                        out.finished = False
                        out.usage = None
            self._push(out)
        return cb


class _Connections:
    """A bounded pool of kept-alive HTTP/1.1 connections shared by the
    agent's telemetry threads (the heartbeat and the streamer), as the
    reference's one keep-alive session: at most ``MAX_HOSTS`` destinations
    ("host:port", least recently used dropped first), each with at most
    ``MAX_PER_HOST`` idle connections (the reference session's bounds).
    A post that finds its reused connection closed by the peer (an idle
    keep-alive timeout) is sent once more on a fresh one; the receivers
    are idempotent (Generations dedupe on ``delta_seq``, heartbeats apply
    absolute state). ``stats()`` counts the destinations held and the
    connections they have made."""

    _STALE = (http.client.RemoteDisconnected, BrokenPipeError,
              ConnectionResetError, ConnectionAbortedError)

    MAX_HOSTS = 4
    MAX_PER_HOST = 4

    def __init__(self, timeout_s: float):
        self._timeout_s = timeout_s
        self._lock = make_lock("agent.connections", order=63)  # lock-order: 63
        # dest -> [idle connections, connections made], LRU order.
        self._pools: OrderedDict[str, list] = OrderedDict()

    def _take(self, dest: str) -> tuple[http.client.HTTPConnection, bool]:
        dropped: list = []
        with self._lock:
            pool = self._pools.get(dest)
            if pool is None:
                pool = self._pools[dest] = [[], 0]
                while len(self._pools) > self.MAX_HOSTS:
                    dropped += self._pools.popitem(last=False)[1][0]
            self._pools.move_to_end(dest)
            conn = pool[0].pop() if pool[0] else None
            if conn is None:
                pool[1] += 1
        for c in dropped:
            c.close()
        if conn is not None:
            return conn, True
        host, _, port = dest.rpartition(":")
        return http.client.HTTPConnection(host, int(port),
                                          timeout=self._timeout_s), False

    def _give(self, dest: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            pool = self._pools.get(dest)
            if pool is not None and len(pool[0]) < self.MAX_PER_HOST:
                pool[0].append(conn)
                return
        conn.close()

    def post(self, dest: str, path: str, body: bytes, ctype: str,
             timeout_s: Optional[float] = None) -> tuple[int, bytes]:
        timeout_s = timeout_s or self._timeout_s
        while True:
            conn, reused = self._take(dest)
            conn.timeout = timeout_s
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)
            try:
                conn.request("POST", path, body=body,
                             headers={"Content-Type": ctype})
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                if reused and isinstance(e, self._STALE):
                    continue
                raise
            if resp.will_close:
                conn.close()
            else:
                self._give(dest, conn)
            return resp.status, data

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"hosts": len(self._pools),
                    "connections_created": sum(p[1]
                                               for p in self._pools.values())}

    def close(self) -> None:
        with self._lock:
            pools, self._pools = self._pools, OrderedDict()
        for idle, _ in pools.values():
            for c in idle:
                c.close()


_NOTHING = object()   # queue-timeout marker distinct from the stop sentinel


class GenerationStreamer:
    """Batches RequestOutput deltas per destination service and POSTs
    `{"gens": [...]}` as msgpack (the reference's batched Generations).
    ``engine`` is anything with a ``cancel(service_request_id)``: the
    agent passes itself, which fans a cancel across its replicas.

    Delivery semantics: each delta carries a per-request monotonic
    `delta_seq` (the service dedupes on it, so retries are safe even when
    the original POST was processed but its response lost). A failed dest
    keeps its gens queued and is retried after a backoff without blocking
    flushes to healthy dests; only after `FLUSH_RETRIES` consecutive
    failures are that dest's requests cancelled. Requests the service
    reports not alive are cancelled.

    With an ``owner_fn`` (the telemetry-owner resolver), every ready
    dest's batch rides one tagged-frame POST to the owning master's
    ``/rpc/telemetry``, which ingests its own dests and relays the rest
    master to master; its reply carries per-dest verdicts, so the retry
    and cancel machinery is unchanged. An owner that fails is reported to
    the resolver (the next flush goes to its rendezvous successor); an
    owner without the route (404/405) demotes the streamer to the direct
    per-dest wire for the process's life."""

    FLUSH_RETRIES = 2
    RETRY_BACKOFF_S = 0.25

    def __init__(self, engine: Any, flush_ms: float,
                 conns: Optional[_Connections] = None,
                 owner_fn: Optional[Callable[[], str]] = None):
        self._engine = engine
        self._q: "queue.Queue[Optional[tuple[str, dict]]]" = queue.Queue()
        self._flush_s = flush_ms / 1000.0
        self._seq_lock = make_lock("agent.streamer_seq", order=62)  # lock-order: 62
        self._seqs: dict[str, int] = {}
        # Sender identity stamped on every delta (set by the agent).
        self.instance_name = ""
        self.incarnation = ""
        self._own_conns = conns is None
        self._conns = conns or _Connections(timeout_s=10.0)
        self._owner_fn = owner_fn
        self._mux_ok = owner_fn is not None
        self.mux_sends = 0
        self.direct_sends = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gen-streamer")
        self._thread.start()

    def push(self, dest_addr: str, output: RequestOutput) -> None:
        sid = output.service_request_id
        # seq assignment AND enqueue under one lock: the service's dedup
        # relies on queue order == seq order per request.
        with self._seq_lock:
            seq = self._seqs.get(sid, 0) + 1
            if output.finished:
                self._seqs.pop(sid, None)
            else:
                self._seqs[sid] = seq
            output.delta_seq = seq
            output.instance = self.instance_name
            output.incarnation = self.incarnation
            self._q.put((dest_addr, output.to_dict()))

    def _loop(self) -> None:
        # Per-dest unsent gens (order preserved) + failure bookkeeping.
        pending: dict[str, list[dict]] = {}
        attempts: dict[str, int] = {}
        next_try: dict[str, float] = {}
        stopping = False
        while True:
            now = time.monotonic()
            if stopping and not pending:
                if self._own_conns:
                    self._conns.close()
                return
            if pending:
                wait = max(0.0, min(next_try.get(d, now)
                                    for d in pending) - now)
            else:
                wait = None   # idle: block until the next delta
            try:
                item = self._q.get(timeout=wait)
            except queue.Empty:
                item = _NOTHING
            if item is None:
                stopping = True
            elif item is not _NOTHING:
                # Batch for one flush interval, preserving per-dest order.
                pending.setdefault(item[0], []).append(item[1])
                deadline = time.monotonic() + self._flush_s
                while True:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if nxt is None:
                        stopping = True
                        break
                    pending.setdefault(nxt[0], []).append(nxt[1])

            now = time.monotonic()
            ready = [d for d in list(pending)
                     if stopping or next_try.get(d, 0.0) <= now]
            outcomes = self._flush_ready(ready, pending)
            for dest in ready:
                if outcomes.get(dest, False):
                    del pending[dest]
                    attempts.pop(dest, None)
                    next_try.pop(dest, None)
                    continue
                n = attempts.get(dest, 0) + 1
                if stopping or n > self.FLUSH_RETRIES:
                    # Repeatedly unreachable: cancel these requests so the
                    # engine doesn't burn the card on a dead stream (only
                    # where the request still streams to this dest: a
                    # successor master may have re-dispatched it).
                    cancel = getattr(self._engine, "cancel_stream", None)
                    for g in pending.pop(dest):
                        sid = g.get("service_request_id", "")
                        if cancel is not None:
                            cancel(sid, dest)
                        else:
                            self._engine.cancel(sid)
                    attempts.pop(dest, None)
                    next_try.pop(dest, None)
                else:
                    attempts[dest] = n
                    next_try[dest] = now + self.RETRY_BACKOFF_S * n

    def _flush_ready(self, dests: list, pending: dict) -> dict:
        """One flush pass over the ready dests: per-dest delivery verdicts.
        The multiplexed wire while an owner resolves, direct per-dest POSTs
        otherwise (or after a demotion)."""
        if not dests:
            return {}
        if self._mux_ok:
            owner = self._owner_fn()
            if owner:
                out = self._send_mux(owner, {d: pending[d] for d in dests})
                if out is not None:
                    return out
        self.direct_sends += len(dests)
        return {d: self._send(d, pending[d]) for d in dests}

    def _send_mux(self, owner: str, batches: dict) -> Optional[dict]:
        """Every ready batch as tagged frames in one POST to the owning
        master. Per-dest verdicts, or None after a demotion (the caller
        sends this pass on the direct wire)."""
        frames = [{"t": wire.TELEMETRY_GENS, "dest": d, "d": {"gens": gens}}
                  for d, gens in batches.items()]
        body, ctype = wire.encode_telemetry(frames)
        try:
            status, data = self._conns.post(owner, "/rpc/telemetry", body,
                                            ctype, timeout_s=10.0)
            if status in (404, 405):
                logger.warning("telemetry owner %s lacks /rpc/telemetry; "
                               "demoting the streamer to the direct "
                               "per-dest wire", owner)
                self._mux_ok = False
                return None
            if status != 200:
                raise ValueError(f"HTTP {status}: {data[:200]!r}")
            payload = json.loads(data)
        except (http.client.HTTPException, OSError, ValueError) as e:
            logger.warning("multiplexed gens push via %s failed: %s",
                           owner, e)
            note = getattr(self._owner_fn, "note_failure", None)
            if note is not None:
                # The next flush targets the rendezvous successor.
                note(owner)
            return {d: False for d in batches}
        self.mux_sends += 1
        for sid, ok in (payload.get("alive") or {}).items():
            if not ok:
                self._engine.cancel(sid)
        dest_ok = payload.get("dest_ok") or {}
        return {d: bool(dest_ok.get(d, False)) for d in batches}

    def _send(self, dest: str, gens: list[dict]) -> bool:
        body, ctype = wire.encode_dispatch({"gens": gens}, wire.WIRE_MSGPACK)
        try:
            status, data = self._conns.post(dest, "/rpc/generations", body,
                                            ctype, timeout_s=10.0)
            # An error page must route through retry/cancel, not count as
            # delivery.
            if status != 200:
                raise ValueError(f"HTTP {status}: {data[:200]!r}")
            alive = json.loads(data).get("alive", {})
        except (http.client.HTTPException, OSError, ValueError) as e:
            logger.warning("generations push to %s failed: %s", dest, e)
            return False
        for sid, ok in alive.items():
            if not ok:
                self._engine.cancel(sid)
        return True

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=15)


@dataclass
class _Request:
    """One request to the agent, as its route handlers take it."""

    body: bytes
    ctype: str
    query: dict[str, str]
    headers: Any


class _Handler(BaseHTTPRequestHandler):
    """One kept-alive HTTP/1.1 connection to the agent; every reply has a
    Content-Length (the master's clients keep connections)."""

    protocol_version = "HTTP/1.1"
    # A reply goes out as two writes (headers, then body). On a kept-alive
    # connection Nagle holds the body until the client ACKs the headers,
    # which a client waiting for the body delays by the delayed-ACK timer
    # (about 40 ms on Linux) on every request after the first.
    disable_nagle_algorithm = True
    agent: "EngineAgent"

    def setup(self) -> None:
        super().setup()
        # Named for the profiler's "http" role.
        threading.current_thread().name = "agent-handler"
        self.agent._note_conn(self.connection, True)

    def finish(self) -> None:
        try:
            super().finish()
        finally:
            self.agent._note_conn(self.connection, False)

    def do_GET(self) -> None:
        self._serve("GET")

    def do_POST(self) -> None:
        self._serve("POST")

    def _serve(self, method: str) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        url = urlsplit(self.path)
        req = _Request(body, self.headers.get("Content-Type", ""),
                       dict(parse_qsl(url.query)), self.headers)
        try:
            status, obj = self.agent._route(method, url.path, req)
        except Exception as e:  # noqa: BLE001 — surfaced as a 500
            logger.exception("%s %s failed", method, url.path)
            status, obj = 500, {"error": str(e)}
        if isinstance(obj, bytes):          # a msgpack frame
            data, ctype = obj, msgpack_lite.CONTENT_TYPE
        elif isinstance(obj, str):          # Prometheus or folded text
            data, ctype = obj.encode(), "text/plain; charset=utf-8"
        else:
            data, ctype = json.dumps(obj).encode(), wire.JSON_CONTENT_TYPE
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)


class _Server(ThreadingHTTPServer):
    request_queue_size = 128


class _BadRequest(ValueError):
    """A request body the agent cannot parse (HTTP 400)."""


# (status, a JSON object, the bytes of a msgpack frame, or plain text).
Reply = tuple[int, Union[dict, bytes, str]]


def _params_on(tree: Any, device: torch.device) -> Any:
    """A weight tree on ``device``: the same tensors where they already
    lie there (no copy), else copies."""
    if isinstance(tree, dict):
        return {k: _params_on(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@_ownership.verify_state
class EngineAgent:
    def __init__(self, engine_cfg: EngineConfig, agent_cfg: AgentConfig,
                 coord: Optional[CoordinationClient] = None,
                 params: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[DeviceMesh] = None):
        if agent_cfg.telemetry_mode not in TELEMETRY_MODES:
            raise ValueError(f"telemetry_mode {agent_cfg.telemetry_mode!r} "
                             f"is not one of {TELEMETRY_MODES}")
        self.cfg = agent_cfg
        tokenizer = TokenizerFactory.create_tokenizer(
            agent_cfg.tokenizer_path)
        self.chat_template = JinjaChatTemplate(
            TokenizerFactory.load_chat_template(agent_cfg.tokenizer_path))
        # The engines first: without a card (and no device named) the
        # first raises before anything else is opened.
        self.engines = self._build_engines(engine_cfg, tokenizer, params,
                                           device, mesh)
        self.engine = self.engines[0]   # config and metadata accessor
        self._rr_replica = 0
        self.coord = coord or connect(agent_cfg.coordination_addr)
        self.port = agent_cfg.port or pick_free_port(agent_cfg.host)
        self.name = f"{agent_cfg.host}:{self.port}"
        self.incarnation_id = uuid.uuid4().hex[:12]
        self.instance_type = agent_cfg.instance_type
        # Heartbeat wire: msgpack (KV-event keys as raw 16 bytes) until a
        # master rejects it, then JSON for the rest of that master's life
        # (a new master may take msgpack again).
        self._hb_wire = wire.WIRE_MSGPACK
        self._hb_master = ""
        # One kept-alive pool for every telemetry hop (beats and pushes)
        # and the owner resolver over the mirrored service membership.
        self.telemetry_conns = _Connections(timeout_s=10.0)
        self.telemetry_owner = TelemetryOwnerResolver(
            self.coord, self.name,
            hold_last_owner=agent_cfg.degraded_mode != "off")
        self._telemetry_mode = agent_cfg.telemetry_mode
        # Last master address that resolved (the funnel mode): the
        # degraded-mode target while the plane is unreachable.
        self._last_master = ""
        # Pass the agent itself: cancel() fans out across replicas.
        self.streamer = GenerationStreamer(
            self, agent_cfg.generation_flush_ms, conns=self.telemetry_conns,
            owner_fn=self.telemetry_owner
            if self._telemetry_mode == "mux" else None)
        # Stamp sender identity on every delta: after a transparent
        # failover the service drops deltas from incarnations the request
        # is no longer bound to.
        self.streamer.instance_name = self.name
        self.streamer.incarnation = self.incarnation_id
        # Agent-observed TTFT per request (ms, accept -> first delta).
        self.ttft_spans: deque = deque(maxlen=512)
        # The device path (CUDA IPC between two processes on one card): on
        # a card it must start (a failure raises); None under --device cpu.
        self.kv_transfer: Optional[KvTransferManager] = None
        if self.engine.device.type == "cuda":
            self.kv_transfer = KvTransferManager.create(self.engine.device)
            logger.info("device KV transfer on %s", self.kv_transfer.address)
        # The streamed host path's offers (served on /rpc/kv_stream_pull)
        # and per-link bandwidth accounting (ICI vs DCN by peer slice).
        self.kv_stream = StreamOfferTable()
        self.bandwidth = BandwidthAccountant(agent_cfg.ici_bytes_per_s,
                                             agent_cfg.dcn_bytes_per_s)
        # Pulls run here, off the HTTP handler's thread.
        self._pulls = ThreadPoolExecutor(max_workers=4,
                                         thread_name_prefix="kv-pull")
        # Handoff idempotency: sid -> receive time. A device-path control
        # POST whose response is lost makes the prefill side retry by a
        # host path; without this the sequence would inject twice.
        self._handoffs_seen: dict[str, float] = {}
        self._seen_lock = make_lock("agent.handoffs_seen", order=72)  # lock-order: 72
        # PD transfer-path counters (/stats), bumped through _count_kv
        # from the handoff and pull threads.
        self._kv_count_lock = make_lock("agent.kv_counts", order=73)  # lock-order: 73
        self.kv_device_sent = 0
        self.kv_host_sent = 0
        self.kv_stream_sent = 0
        self.kv_device_received = 0
        self.kv_host_received = 0
        self.kv_stream_received = 0
        self.linked_peers: dict[str, InstanceMetaInfo] = {}
        self._draining = False
        # /rpc/encode calls served (EPD's ENCODE stage), bumped by the
        # handler threads under their own lock.
        self.encode_count = 0
        self._encode_lock = make_lock("agent.encode_count", order=74)  # lock-order: 74
        # Registration and role flips: a heartbeat's re-registration must
        # not leave behind the key a flip just removed. The lock guards
        # only the role and its epoch; the coordination calls run outside
        # it, and a registration that raced a flip removes what it wrote.
        self._reg_lock = make_lock("agent.registration", order=68)  # lock-order: 68
        self._reg_epoch = 0
        # The destination of each request's running incarnation (MIX
        # path): a master whose owner died re-dispatches the request under
        # the same id, and cancels go by id.
        self._streams_lock = make_lock("agent.streams", order=67)  # lock-order: 67
        self._streams: dict[str, tuple[str, threading.Event]] = {}
        self._stop_lock = make_lock("agent.stop", order=69)  # lock-order: 69
        self._stopped = False
        self._profiler_started = False
        self._wake = threading.Event()
        self._server: Optional[_Server] = None
        self._conns: set = set()
        self._conns_lock = make_lock("agent.conns", order=71)  # lock-order: 71
        self._threads: list[threading.Thread] = []
        self._routes: dict[tuple[str, str], Callable[[_Request], Reply]] = {
            ("GET", "/health"): self._h_health,
            ("GET", "/v1/models"): self._h_models,
            ("GET", "/stats"): self._h_stats,
            ("GET", "/metrics"): self._h_metrics,
            ("GET", "/admin/trace"): lambda r: admin_trace(r.query),
            ("GET", "/admin/trace/recent"):
                lambda r: admin_trace_recent(r.query),
            ("GET", "/admin/flightrecorder/recent"):
                lambda r: admin_flightrecorder_recent(r.query),
            ("GET", "/admin/profile"): lambda r: admin_profile(r.query),
            ("POST", "/v1/completions"): self._h_completion,
            ("POST", "/v1/chat/completions"): self._h_chat,
            ("POST", "/v1/embeddings"): self._h_embeddings,
            ("POST", "/rpc/link"): self._h_link,
            ("POST", "/rpc/unlink"): self._h_unlink,
            ("POST", "/rpc/cancel"): self._h_cancel,
            ("POST", "/rpc/flip_role"): self._h_flip,
            ("POST", "/rpc/drain"): self._h_drain,
            ("POST", "/rpc/kv_transfer"): self._h_kv_transfer,
            ("POST", "/rpc/kv_stream_pull"): self._h_kv_stream_pull,
            ("POST", "/rpc/encode"): self._h_encode,
        }
        # Flight-recorder bundles carry this agent's state at anomaly time.
        RECORDER.add_context_provider("engine", self._anomaly_context)

    def _build_engines(self, engine_cfg: EngineConfig, tokenizer,
                       params: Optional[dict], device,
                       mesh: Optional[DeviceMesh] = None
                       ) -> list[InferenceEngine]:
        """The replicas: replica 0 on ``device``, replica i on the i-th
        CUDA device from it (every replica on the one card of a one-card
        machine; the CPU for all on the CPU), each with its own pool,
        pinned buffers and streams, sharing replica 0's weight tensors
        where the device is the same (copies elsewhere). A tier spill file
        is per replica (``<path>.<i>``): a shared one would be truncated
        under another replica's live mapping. ``mesh`` (the engine's
        ``mesh`` argument: devices the caller names, which may repeat)
        takes the place of ``engine_cfg.mesh``."""
        dp = max(1, self.cfg.dp_size)
        if multihost.process_count() > 1 and dp != 1:
            raise ValueError("multihost mode requires dp_size == 1")
        if dp > 1 and (engine_cfg.mesh is not None or mesh is not None):
            logger.warning("dp_size > 1 with an engine mesh is not "
                           "supported; forcing dp_size 1")
            dp = 1
        first = InferenceEngine(engine_cfg, device=device,
                                tokenizer=tokenizer, params=params,
                                mesh=mesh)
        engines = [first]
        for i in range(1, dp):
            dev = first.device
            if dev.type == "cuda":
                base = dev.index if dev.index is not None \
                    else torch.cuda.current_device()
                dev = torch.device("cuda",
                                   (base + i) % torch.cuda.device_count())
            cfg_i = engine_cfg
            if engine_cfg.kv_tier_ssd_path:
                cfg_i = dataclasses.replace(
                    engine_cfg,
                    kv_tier_ssd_path=f"{engine_cfg.kv_tier_ssd_path}.{i}")
            engines.append(InferenceEngine(
                cfg_i, device=dev, tokenizer=tokenizer,
                params=_params_on(first.params, dev)))
        if multihost.process_count() > 1:
            # One instance over processes: this agent runs on the primary
            # only; submits and cancels are mirrored to the followers and
            # the engine steps collectively in the proxy's tick loop.
            from .multihost_driver import (
                MultihostEngineDriver,
                MultihostEngineProxy,
            )

            return [MultihostEngineProxy(       # type: ignore[list-item]
                MultihostEngineDriver(first))]
        return engines

    def _anomaly_context(self) -> dict[str, Any]:
        return {
            "instance": self.name,
            "incarnation": self.incarnation_id,
            "stats": self.aggregate_stats(),
            "kv_tier": self._tier_stats(),
            "kv_transfer": {
                "device_sent": self.kv_device_sent,
                "host_sent": self.kv_host_sent,
                "stream_sent": self.kv_stream_sent,
                "stream_received": self.kv_stream_received,
            },
        }

    def _supersede(self, sid: str, dest: str) -> threading.Event:
        """Make ``dest``'s dispatch of ``sid`` its running incarnation.
        When another master's incarnation of the same request still runs
        here (its owner died and the relay re-owned the request), end it
        first: a cancel by id issued after the new submit would end both,
        and its last delta resets the request's delta sequence."""
        done = threading.Event()
        with self._streams_lock:
            prev = self._streams.get(sid)
            self._streams[sid] = (dest, done)
        if prev is not None and prev[0] != dest and not prev[1].is_set():
            logger.info("request %s re-dispatched by %s: ending its "
                        "incarnation for %s", sid, dest, prev[0])
            self.cancel(sid)
            prev[1].wait(timeout=10.0)
            deadline = time.monotonic() + 1.0
            while any(sid in e._cancelled for e in self.engines) \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
        return done

    def _stream_done(self, sid: str, done: threading.Event) -> None:
        done.set()
        with self._streams_lock:
            if self._streams.get(sid, (None, None))[1] is done:
                del self._streams[sid]

    def cancel_stream(self, service_request_id: str, dest: str) -> None:
        """Cancel a request whose deltas ``dest`` no longer takes, unless
        its running incarnation streams to another master."""
        with self._streams_lock:
            cur = self._streams.get(service_request_id)
        if cur is None or cur[0] == dest:
            self.cancel(service_request_id)

    # --------------------------------------------------------- dp dispatch
    def cancel(self, service_request_id: str) -> None:
        """Fan a cancel across the replicas (each ignores unknown ids)."""
        for eng in self.engines:
            eng.cancel(service_request_id)

    def _pick_engine(self, token_ids: list[int]) -> InferenceEngine:
        """Replica dispatch: prefix-affine (the same first hash block lands
        on the same replica, so its prefix cache hits), with a load guard
        (the least-loaded replica when the affine one is a full batch
        deeper)."""
        if len(self.engines) == 1:
            return self.engines[0]
        block = self.engine.cfg.hash_block_size
        key = hash(tuple(token_ids[:block])) if token_ids \
            else self._rr_replica
        self._rr_replica += 1
        affine = self.engines[key % len(self.engines)]

        def depth(e: InferenceEngine) -> int:
            s = e.stats()
            return s["waiting"] + s["running"]

        lightest = min(self.engines, key=depth)
        if depth(affine) > depth(lightest) + self.engine.cfg.max_batch_size:
            return lightest
        return affine

    # ------------------------------------------------------------ metadata
    # Conservative cold-start tables (used until the engines have measured
    # enough of their own traffic to fit real ones).
    DEFAULT_TTFT_TABLE = [[128, 30.0], [512, 80.0], [2048, 250.0],
                          [4096, 520.0]]
    DEFAULT_TPOT_TABLE = [[1, 128, 6.0], [4, 2048, 9.0],
                          [8, 8192, 14.0], [16, 32768, 25.0]]

    def profiling_tables(self) -> tuple[list, list]:
        """SLO profiling tables from every replica's live telemetry.
        Samples are bucketed (median per bucket, robust to stragglers);
        until >= 3 distinct buckets exist the conservative defaults are
        advertised so the predictor always has something to fit."""
        ttft: dict[int, list[float]] = {}
        tpot: dict[int, list[tuple[int, float]]] = {}
        for eng in self.engines:
            for plen, ms in list(eng.ttft_samples):
                bucket = 1 << max(5, (plen - 1).bit_length())
                ttft.setdefault(bucket, []).append(ms)
            for batch, toks, ms in list(eng.tpot_samples):
                tpot.setdefault(batch, []).append((toks, ms))
        ttft_table = [[b, statistics.median(v)]
                      for b, v in sorted(ttft.items())]
        tpot_table = [
            [b, statistics.median(t for t, _ in v),
             statistics.median(m for _, m in v)]
            for b, v in sorted(tpot.items())]
        if len(ttft_table) < 3:
            ttft_table = self.DEFAULT_TTFT_TABLE
        if len(tpot_table) < 3:
            tpot_table = self.DEFAULT_TPOT_TABLE
        return ttft_table, tpot_table

    def _mesh_shape(self) -> list[int]:
        mesh = self.engine.mesh
        return list(mesh.sizes) if mesh is not None else [1]

    def _mesh_axes(self) -> list[str]:
        mesh = self.engine.mesh
        return list(mesh.axis_names) if mesh is not None else ["data"]

    def meta(self) -> InstanceMetaInfo:
        ecfg = self.engine.cfg
        mcfg = ecfg.model
        ttft_table, tpot_table = self.profiling_tables()
        return InstanceMetaInfo(
            name=self.name, rpc_address=self.name, type=self.instance_type,
            dp_size=len(self.engines),
            topology=TpuTopology(
                slice_id=self.cfg.slice_id,
                host=self.cfg.topo_host,
                chip=self.cfg.topo_chip,
                # Describes THIS engine's mesh (mesh-less = one device):
                # the device-path gate compares these between peers.
                mesh_shape=self._mesh_shape(),
                axis_names=self._mesh_axes(),
                host_addrs=[self.name],
                kv_transfer_addr=self.kv_transfer.address
                if self.kv_transfer is not None else ""),
            kv_page_size=ecfg.page_size,
            kv_dtype=str(mcfg.dtype).removeprefix("torch."),
            num_layers=mcfg.num_layers, num_kv_heads=mcfg.num_kv_heads,
            head_dim=mcfg.head_dim,
            max_context_len=ecfg.max_seq_len,
            incarnation_id=self.incarnation_id,
            register_ts_ms=int(time.time() * 1000),
            models=[self.cfg.model_id],
            # The accept routes parse msgpack: the master dispatches it.
            wire_formats=[wire.WIRE_MSGPACK, wire.WIRE_JSON],
            ttft_profiling_data=ttft_table,
            tpot_profiling_data=tpot_table,
        )

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EngineAgent":
        # The sampling profiler is refcounted: agents sharing a process
        # share its one sampler.
        PROFILER.start()
        self._profiler_started = True
        for eng in self.engines:
            eng.start()
        handler = type("_AgentHandler", (_Handler,), {"agent": self})
        self._server = _Server((self.cfg.host, self.port), handler)
        t = threading.Thread(target=self._server.serve_forever,
                             kwargs={"poll_interval": 0.1}, daemon=True,
                             name=f"agent-http-{self.port}")
        t.start()
        self._threads.append(t)
        self.register()
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True,
                              name="agent-heartbeat")
        hb.start()
        self._threads.append(hb)
        logger.info("engine agent %s (%s, model=%s, dp_size=%d, telemetry "
                    "%s) up on %s", self.name, self.instance_type.value,
                    self.cfg.model_id, len(self.engines),
                    self._telemetry_mode, self.engine.device)
        return self

    def register(self) -> None:
        with self._reg_lock:
            epoch = self._reg_epoch
            meta = self.meta()
        meta.draining = self._draining
        key = instance_key(meta.type.value, self.name)
        self.coord.set(key, meta.to_json(), ttl_s=self.cfg.lease_ttl_s)
        with self._reg_lock:
            stale = self._reg_epoch != epoch
        if stale:
            # A flip moved the role while this registration was in
            # flight: the key written above is the old role's.
            self.coord.rm(key)

    def drain(self, timeout_s: float = 60.0) -> None:
        """Graceful shutdown: advertise draining (the scheduler stops
        routing here on the next registration refresh), let in-flight
        requests finish, then stop."""
        logger.info("agent %s draining (timeout %.0fs)", self.name,
                    timeout_s)
        self._draining = True
        self.register()
        # Grace window: requests the master routed just before the
        # draining flag landed may still be in HTTP flight.
        time.sleep(min(timeout_s / 4,
                       max(1.0, self.cfg.heartbeat_interval_s)))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            stats = self.aggregate_stats()
            if stats["running"] == 0 and stats["waiting"] == 0:
                break
            time.sleep(0.2)
        self.stop()

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._wake.set()
        # A beat may be in flight (its POST waits up to 3 s): it ends
        # before the series below are evicted and the registration
        # removed, or its late write would re-create both.
        me = threading.current_thread()
        for t in self._threads:
            if t.name == "agent-heartbeat" and t is not me:
                t.join(timeout=5.0)
        if self._profiler_started:
            self._profiler_started = False
            PROFILER.stop()
        RECORDER.remove_context_provider("engine", self._anomaly_context)
        # This agent's labeled series end with it (agents that share a
        # process share the families).
        for peer in list(self.linked_peers):
            evict_series(ENGINE_PEER_LINKED, peer=peer)
        if self._hb_master:
            evict_series(ENGINE_HEARTBEATS_TOTAL, master=self._hb_master)
        self.coord.rm(instance_key(self.instance_type.value, self.name))
        self.streamer.stop()
        for eng in self.engines:
            eng.stop()
        self._pulls.shutdown(wait=False, cancel_futures=True)
        if self.kv_transfer is not None:
            self.kv_transfer.close()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:     # kept-alive client connections
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.telemetry_conns.close()
        self.coord.close()

    def _note_conn(self, conn: Any, open_: bool) -> None:
        with self._conns_lock:
            (self._conns.add if open_ else self._conns.discard)(conn)

    # ----------------------------------------------------------- heartbeats
    def _heartbeat_loop(self) -> None:
        """Re-register (the lease refresh), pick the target by telemetry
        mode and beat to it; a target that fails hands this same beat to
        the rendezvous successor at once."""
        while not self._wake.wait(self.cfg.heartbeat_interval_s):
            try:
                self._beat_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("heartbeat failed")

    def _beat_once(self) -> None:
        self.register()
        if self.kv_transfer is not None:
            self.kv_transfer.gc()   # free never-pulled KV offers
        self.kv_stream.gc()         # ... and expired stream offers
        if self._telemetry_mode == "master":
            target = self.coord.get(MASTER_KEY) or ""
            if target:
                self._last_master = target
            elif self.cfg.degraded_mode != "off":
                # Static stability: an unreachable plane resolves no
                # master; keep beating at the last one that did (the
                # owner modes hold inside the resolver).
                target = self._last_master
        else:
            target = self.telemetry_owner()
        if not target:
            return
        stats = self.aggregate_stats()
        ev = self.engines[0].drain_kv_events()
        for eng in self.engines[1:]:
            ev.merge(eng.drain_kv_events())
        drained = [e.drain_recent_latency() for e in self.engines]
        payload = {
            "name": self.name,
            "incarnation_id": self.incarnation_id,
            "load_metrics": {
                "waiting_requests_num": stats["waiting"],
                "running_requests_num": stats["running"],
                "hbm_cache_usage_perc": stats["kv_usage_perc"],
            },
            "latency_metrics": {
                "recent_max_ttft": max(t for t, _ in drained),
                "recent_max_tbt": max(t for _, t in drained),
            },
        }
        if not self._post_heartbeat(target, payload, ev):
            # The owner is unreachable: the resolver skips it and its
            # rendezvous successor gets this same beat now, not an
            # interval later.
            self.telemetry_owner.note_failure(target)
            successor = self.telemetry_owner() \
                if self._telemetry_mode != "master" else ""
            if successor and successor != target:
                self._post_heartbeat(successor, payload, ev)

    def _post_heartbeat(self, target: str, payload: dict,
                        ev: KvCacheEvent) -> bool:
        """One beat. mode "mux": a tagged frame on the telemetry pool (a
        target without /rpc/telemetry demotes the agent to the elected-
        master funnel). The per-endpoint wire: msgpack with raw 16-byte
        KV-event keys, demoted to JSON on 400/415 and re-sent (a beat is
        idempotent: the index applies absolute moves)."""
        conns = self.telemetry_conns
        try:
            self._note_master(target)
            if self._telemetry_mode == "mux":
                frame = dict(payload, kv_cache_event=ev.to_wire_dict())
                body, ctype = wire.encode_telemetry(
                    [{"t": wire.TELEMETRY_HB, "d": frame}])
                status, data = conns.post(target, "/rpc/telemetry", body,
                                          ctype, timeout_s=3.0)
                ENGINE_HEARTBEATS_TOTAL.labels(master=target).inc()
                if status not in (404, 405):
                    if status == 200:
                        self._adopt_owner_hint(data, target)
                        return True
                    return False
                logger.warning("telemetry target %s lacks /rpc/telemetry; "
                               "demoting the agent to the elected-master "
                               "funnel", target)
                # A master without the route predates the sharded ingest:
                # there only the elected master takes beats.
                self._telemetry_mode = "master"
            fmt = self._hb_wire
            body, ctype = wire.encode_dispatch(dict(
                payload, kv_cache_event=ev.to_wire_dict()
                if fmt == wire.WIRE_MSGPACK else ev.to_dict()), fmt)
            status, data = conns.post(target, "/rpc/heartbeat", body, ctype,
                                      timeout_s=3.0)
            ENGINE_HEARTBEATS_TOTAL.labels(master=target).inc()
            if status in (400, 415) and fmt == wire.WIRE_MSGPACK:
                logger.warning("master rejected the msgpack heartbeat (%d); "
                               "demoting to the JSON wire", status)
                self._hb_wire = wire.WIRE_JSON
                body, ctype = wire.encode_dispatch(
                    dict(payload, kv_cache_event=ev.to_dict()))
                status, data = conns.post(target, "/rpc/heartbeat", body,
                                          ctype, timeout_s=3.0)
            if status == 200:
                self._adopt_owner_hint(data, target)
                return True
            return False
        except (http.client.HTTPException, OSError) as e:
            logger.warning("heartbeat to %s failed: %s", target, e)
            return False

    def _adopt_owner_hint(self, data: bytes, target: str) -> None:
        """A beat's reply names the receiving master's view of this
        instance's owner (`owner`); in a membership race the mirrored
        resolution can lag it, and adopting the hint re-routes the next
        beat instead of waiting a cache window out."""
        if self._telemetry_mode == "master":
            return
        try:
            owner = (json.loads(data) or {}).get("owner", "")
        except (ValueError, AttributeError):
            return
        if owner and owner != target:
            logger.info("telemetry owner hint: %s -> %s", target, owner)
            self.telemetry_owner.pin(owner)

    def _note_master(self, master: str) -> None:
        """Track the beat's destination. On a change: probe msgpack again
        (the new master may take it) and evict the old master's labeled
        heartbeat series (master addresses are ephemeral; a long-lived
        engine would otherwise grow one dead series per election)."""
        if master == self._hb_master:
            return
        if self._hb_master:
            evict_series(ENGINE_HEARTBEATS_TOTAL, master=self._hb_master)
        # A flap back to a previously-evicted master legitimately
        # re-creates its series (not the stale-writer resurrection bug).
        _lifecycle.note_series_revived(master)
        self._hb_master = master
        self._hb_wire = wire.WIRE_MSGPACK

    def telemetry_stats(self) -> dict[str, Any]:
        """The telemetry wiring and its pool: ``hosts`` = destinations the
        pool holds (the mux mode keeps it at 1), ``connections_created``
        = connections they have made."""
        return {
            "mode": self._telemetry_mode,
            "owner": self.telemetry_owner() or "",
            "mux_sends": self.streamer.mux_sends,
            "direct_sends": self.streamer.direct_sends,
            **self.telemetry_conns.stats(),
        }

    # ------------------------------------------------------------ handlers
    def aggregate_stats(self) -> dict[str, Any]:
        """Instance-level stats: the sum over replicas (kv usage: the max,
        a saturation signal)."""
        per = [e.stats() for e in self.engines]
        return {
            "waiting": sum(s["waiting"] for s in per),
            "running": sum(s["running"] for s in per),
            "kv_usage_perc": max(s["kv_usage_perc"] for s in per),
            "cached_blocks": sum(s["cached_blocks"] for s in per),
            "total_generated": sum(s["total_generated"] for s in per),
            "dp_size": len(self.engines),
            "sarathi_rides": sum(e.sarathi_rides for e in self.engines),
            "preemption_count": sum(e.preemption_count
                                    for e in self.engines),
        }

    def _route(self, method: str, path: str, req: _Request) -> Reply:
        fn = self._routes.get((method, path))
        if fn is not None:
            try:
                return fn(req)
            except _BadRequest as e:
                return 400, {"error": str(e)}
        return 404, {"error": f"no route {method} {path}"}

    @staticmethod
    def _json(body: bytes) -> dict:
        try:
            obj = json.loads(body or b"{}")
        except ValueError:
            raise _BadRequest("invalid JSON") from None
        if not isinstance(obj, dict):
            raise _BadRequest("body must be an object")
        return obj

    def _h_health(self, req: _Request) -> Reply:
        return 200, {"status": "ok"}

    def _h_models(self, req: _Request) -> Reply:
        return 200, {"object": "list", "data": [
            {"id": self.cfg.model_id, "object": "model"}]}

    def _h_stats(self, req: _Request) -> Reply:
        return 200, {
            **self.aggregate_stats(),
            "telemetry": self.telemetry_stats(),
            "kv_transfer": {
                "device_sent": self.kv_device_sent,
                "host_sent": self.kv_host_sent,
                "device_received": self.kv_device_received,
                "host_received": self.kv_host_received,
                "stream_sent": self.kv_stream_sent,
                "stream_received": self.kv_stream_received,
                "bandwidth": self.bandwidth.stats(),
            },
            "kv_tier": self._tier_stats(),
            "ttft_spans": self._span_summary(),
            "encode_count": self.encode_count,
        }

    def _tier_stats(self) -> dict[str, Any]:
        """Tier-store telemetry summed over replicas ({} = tiering off)."""
        out: dict[str, Any] = {}
        for eng in self.engines:
            store = eng.tier_store
            if store is None:
                continue
            for k, v in store.stats().items():
                out[k] = out.get(k, 0) + v if k != "block_nbytes" else v
        return out

    def _span_summary(self) -> dict[str, float]:
        """p50s of the TTFT span samples (agent accept -> first delta; the
        engines' queue wait; their prefill), so an external bench can split
        client TTFT across processes."""
        def p50(xs):
            xs = sorted(xs)
            return round(xs[len(xs) // 2], 1) if xs else 0.0

        eng = [s for e in self.engines for s in list(e.span_samples)]
        return {"n": len(self.ttft_spans),
                "agent_accept_to_first_delta_ms": p50(self.ttft_spans),
                "engine_queue_ms": p50(s["queue_ms"] for s in eng),
                "engine_prefill_ms": p50(s["prefill_ms"] for s in eng)}

    def _h_metrics(self, req: _Request) -> Reply:
        """Prometheus text of the engine's state: the reference agent's
        families, types and labels."""
        st = self.aggregate_stats()
        lines = [
            "# TYPE engine_waiting_requests gauge",
            f"engine_waiting_requests {st['waiting']}",
            "# TYPE engine_running_requests gauge",
            f"engine_running_requests {st['running']}",
            "# TYPE engine_kv_usage_perc gauge",
            f"engine_kv_usage_perc {st['kv_usage_perc']:.6f}",
            "# TYPE engine_cached_prefix_blocks gauge",
            f"engine_cached_prefix_blocks {st['cached_blocks']}",
            "# TYPE engine_generated_tokens_total counter",
            f"engine_generated_tokens_total {st['total_generated']}",
            "# TYPE engine_preemptions_total counter",
            f"engine_preemptions_total {st['preemption_count']}",
            "# TYPE engine_recent_max_ttft_milliseconds gauge",
            f"engine_recent_max_ttft_milliseconds "
            f"{max(e.recent_max_ttft_ms for e in self.engines):.3f}",
            "# TYPE engine_recent_max_tbt_milliseconds gauge",
            f"engine_recent_max_tbt_milliseconds "
            f"{max(e.recent_max_tbt_ms for e in self.engines):.3f}",
            "# TYPE engine_dp_size gauge",
            f"engine_dp_size {len(self.engines)}",
            "# TYPE engine_sarathi_rides_total counter",
            f"engine_sarathi_rides_total {st['sarathi_rides']}",
        ]
        tel = self.telemetry_stats()
        lines += [
            "# TYPE engine_telemetry_session_hosts gauge",
            f"engine_telemetry_session_hosts {tel['hosts']}",
            "# TYPE engine_telemetry_connections_created counter",
            f"engine_telemetry_connections_created "
            f"{tel['connections_created']}",
            "# TYPE engine_telemetry_mux_sends_total counter",
            f"engine_telemetry_mux_sends_total {tel['mux_sends']}",
            "# TYPE engine_telemetry_direct_sends_total counter",
            f"engine_telemetry_direct_sends_total {tel['direct_sends']}",
        ]
        tier = self._tier_stats()
        if tier:
            lines += [
                "# TYPE engine_kv_tier_blocks gauge",
                f'engine_kv_tier_blocks{{tier="dram"}} '
                f"{tier.get('dram_blocks', 0)}",
                f'engine_kv_tier_blocks{{tier="ssd"}} '
                f"{tier.get('ssd_blocks', 0)}",
                "# TYPE engine_kv_tier_offloads_total counter",
                f"engine_kv_tier_offloads_total "
                f"{tier.get('offload_total', 0)}",
                "# TYPE engine_kv_tier_onloads_total counter",
                f"engine_kv_tier_onloads_total "
                f"{tier.get('onload_total', 0)}",
                "# TYPE engine_kv_tier_bytes_total counter",
                f'engine_kv_tier_bytes_total{{direction="offload"}} '
                f"{tier.get('bytes_offloaded', 0)}",
                f'engine_kv_tier_bytes_total{{direction="onload"}} '
                f"{tier.get('bytes_onloaded', 0)}",
            ]
        for link, bw in self.bandwidth.stats().items():
            lines += [
                f'engine_kv_stream_bytes_total{{link="{link}"}} '
                f"{bw['bytes_total']:.0f}",
                f'engine_kv_stream_throughput_bytes_per_s{{link="{link}"}} '
                f"{bw['throughput_bytes_per_s']:.1f}",
            ]
        spans = self._span_summary()
        lines += [
            "# TYPE engine_ttft_span_p50_milliseconds gauge",
            'engine_ttft_span_p50_milliseconds{span="agent_total"} '
            f"{spans['agent_accept_to_first_delta_ms']:.3f}",
            'engine_ttft_span_p50_milliseconds{span="engine_queue"} '
            f"{spans['engine_queue_ms']:.3f}",
            'engine_ttft_span_p50_milliseconds{span="engine_prefill"} '
            f"{spans['engine_prefill_ms']:.3f}",
        ]
        # The agent's labeled families (evicted on unlink and on a master
        # change, so the exposition stays bounded).
        for inst in (ENGINE_PEER_LINKED, ENGINE_HEARTBEATS_TOTAL):
            rendered = inst.render()
            if rendered:
                lines.append(f"# TYPE {inst.name} {inst.kind}")
                lines.append(rendered.rstrip("\n"))
        return 200, "\n".join(lines) + "\n"

    def _stage_span(self, point: str, ctx: Optional[TraceContext],
                    sid: str, **attrs: Any):
        """An engine-side stage span under the orchestrator's carried
        context; a request without one is not traced (there is no tree to
        hang it on). Only started and ended, never entered: it may end on
        another thread than the one that opened it."""
        return TRACER.start_span(point, ctx=ctx, request_id=sid,  # xlint: allow-span-point(forwards literal point names from its call sites)
                                 require_ctx=True, instance=self.name,
                                 incarnation=self.incarnation_id, **attrs)

    def _h_link(self, req: _Request) -> Reply:
        peer = InstanceMetaInfo.from_json(
            json.dumps(self._json(req.body).get("peer", {})))
        # KV-layout compatibility gate.
        mine = self.meta()
        for f in ("kv_page_size", "num_layers", "num_kv_heads", "head_dim"):
            if getattr(peer, f) and getattr(peer, f) != getattr(mine, f):
                return 409, {"ok": False,
                             "error": f"kv layout mismatch on {f}"}
        self.linked_peers[peer.name] = peer
        # Unlink→relink of the same peer re-creates its series on purpose.
        _lifecycle.note_series_revived(peer.name)
        ENGINE_PEER_LINKED.labels(peer=peer.name).set(1)
        return 200, {"ok": True}

    def _h_unlink(self, req: _Request) -> Reply:
        peer_name = self._json(req.body).get("peer_name", "")
        if self.linked_peers.pop(peer_name, None) is not None:
            # A departed peer's series goes with it (ephemeral ports would
            # make the set unbounded).
            evict_series(ENGINE_PEER_LINKED, peer=peer_name)
        return 200, {"ok": True}

    def _h_cancel(self, req: _Request) -> Reply:
        self.cancel(self._json(req.body).get("service_request_id", ""))
        return 200, {"ok": True}

    def _h_drain(self, req: _Request) -> Reply:
        """Master-initiated graceful retirement: the drain sequence runs
        on a background thread; the RPC acks immediately."""
        if not self._draining:
            threading.Thread(target=self.drain, name="agent-drain",
                             daemon=True).start()
        return 200, {"ok": True, "draining": True}

    def _h_flip(self, req: _Request) -> Reply:
        """Dynamic PD-role switch: the engines keep their weights and KV
        pools; the registration moves to the new role's key."""
        new_type = InstanceType.parse(self._json(req.body).get("type"))
        with self._reg_lock:
            old_key = instance_key(self.instance_type.value, self.name)
            self.instance_type = new_type
            self._reg_epoch += 1
        self.coord.rm(old_key)
        self.register()
        return 200, {"ok": True}

    def _h_embeddings(self, req: _Request) -> Reply:
        """OpenAI embeddings over an engine's embed forward."""
        body = self._json(req.body)
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not inputs:
            return 400, {"error": "input must be a string or list of "
                                  "strings"}
        if self.engine.family.embed_forward is None:
            return 501, {"error": f"model family "
                                  f"{self.engine.cfg.model_family} has no "
                                  "embedding forward"}
        max_len = self.engine.cfg.max_seq_len
        tok = self.engine.tokenizer
        token_lists = [tok.encode(str(t))[:max_len] or [0] for t in inputs]
        vecs = self._pick_engine(token_lists[0]).embed(token_lists)
        n_tokens = sum(len(t) for t in token_lists)
        return 200, {
            "object": "list",
            "model": body.get("model", self.cfg.model_id),
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in v]}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }

    def _h_completion(self, req: _Request) -> Reply:
        return self._accept(req, chat=False)

    def _h_chat(self, req: _Request) -> Reply:
        return self._accept(req, chat=True)

    def _accept(self, req: _Request, chat: bool) -> Reply:
        t_recv = time.monotonic()
        try:
            # The negotiated dispatch wire: msgpack or JSON by content type.
            body = wire.decode_body(req.ctype, req.body)
        except ValueError:
            return 400, {"error": "invalid request body"}
        if not isinstance(body, dict):
            return 400, {"error": "body must be an object"}
        sid = body.get("service_request_id") or f"local-{uuid.uuid4().hex[:8]}"
        source = body.get("source_service_addr", "")
        token_ids = list(body.get("token_ids") or ())
        # End-to-end deadline: the enriched payload carries the ABSOLUTE
        # deadline; work that expired while queued upstream is refused.
        deadline_ms = int(body.get("deadline_ms") or 0)
        if deadline_ms and now_ms() > deadline_ms:
            return 504, {"error": "deadline exceeded"}
        # EPD: extract the images, encode them (on the routed ENCODE
        # instance, or here), and rebuild the token ids with the
        # placeholder runs the model splices the visual rows into.
        mm_embeds = None
        if chat and self.engine.cfg.model_family == "qwen2_vl":
            try:
                pixels = self._extract_images(body.get("messages") or [])
            except ValueError as e:
                return 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001  # xlint: allow-broad-except(bad base64/PIL data is surfaced as a 400 to the client)
                return 400, {"error": f"invalid image payload: {e}"}
            if pixels is not None:
                encode_name = (body.get("routing") or {}).get(
                    "encode_name", "")
                try:
                    mm_embeds = self._encode_pixels(pixels, encode_name)
                except Exception as e:  # noqa: BLE001  # xlint: allow-broad-except(encode failure is surfaced as a 502 to the client)
                    return 502, {"error": f"vision encode failed: {e}"}
                token_ids = self._build_mm_token_ids(
                    body.get("messages") or [])
        if not token_ids:
            # Standalone mode (no orchestrator enrichment): tokenize here.
            prompt = body.get("prompt", "")
            if chat and not prompt:
                msgs = body.get("messages") or []
                prompt = "\n".join(str(m.get("content", "")) for m in msgs)
            token_ids = self.engine.tokenizer.encode(str(prompt))
        sampling = self._sampling_from_body(body)
        # Failover resume: the service appended the tokens its client has
        # already received to ``token_ids`` (``resume_generated_token_ids``);
        # the engine generates only the rest of ``max_tokens``, and the
        # usage counts the replayed tokens as generated, not as prompt (the
        # wire contract of the service's failover layer, which the fake
        # engine keeps too).
        resumed = len(body.get("resume_generated_token_ids") or ())
        left = sampling.max_tokens - resumed

        if not source:
            return 400, {"error": "source_service_addr required (engine "
                                  "streams results to the service RPC "
                                  "endpoint)"}
        dest = source
        if resumed:
            if left <= 0:
                # Every token was delivered before the failover: only the
                # terminal delta is left to send.
                self.streamer.push(dest, RequestOutput(
                    service_request_id=sid,
                    request_id=body.get("request_id", sid),
                    outputs=[SequenceOutput(index=0, finish_reason="length")],
                    usage=Usage(num_prompt_tokens=len(token_ids) - resumed,
                                num_generated_tokens=resumed),
                    finished=True))
                return 200, {"ok": True, "service_request_id": sid}
            sampling.max_tokens = left
        first_delta = [True]
        # Stage spans under the orchestrator's carried context: prefill
        # from accept to the first delta (or the PD handoff), decode from
        # there to the finish.
        ctx = TraceContext.from_dict(body.get("trace_context")) \
            or TraceContext.from_headers(req.headers)
        stage = {"span": self._stage_span("engine.prefill", ctx, sid,
                                          prompt_tokens=len(token_ids))}

        def on_output(out: RequestOutput) -> None:
            if resumed and out.usage is not None:
                out.usage = Usage(
                    num_prompt_tokens=out.usage.num_prompt_tokens - resumed,
                    num_generated_tokens=(out.usage.num_generated_tokens
                                          + resumed))
            if deadline_ms and not out.finished and now_ms() > deadline_ms:
                # Mid-decode expiry: stop the request through the cancel
                # path; the delta in hand still ships.
                self.cancel(out.service_request_id)
            err = None if out.status.ok() else \
                f"ERROR: {out.status.message or out.status.code.name}"
            if first_delta[0]:
                first_delta[0] = False
                self.ttft_spans.append((time.monotonic() - t_recv) * 1000)
                stage["span"].end(err)
                # A prefill that failed before any token has no decode.
                stage["span"] = NOOP_SPAN if err else \
                    self._stage_span("engine.decode", ctx, sid)
            if out.finished:
                stage["span"].end(err)
            self.streamer.push(dest, out)

        request_id = body.get("request_id", sid)
        # PD disaggregation: a PREFILL instance with a routed decode peer
        # prefills, then ships KV + first token to the peer, which owns
        # the stream from there.
        decode_name = (body.get("routing") or {}).get("decode_name", "")
        if self.instance_type == InstanceType.PREFILL and decode_name \
                and decode_name != self.name:

            def on_prefill_done(h: PrefillHandoff) -> None:
                stage["span"].end()
                threading.Thread(
                    target=self._transfer_to_peer, daemon=True,
                    args=(h, decode_name, dest, ctx),
                    name=f"kv-transfer-{h.service_request_id}").start()

            self._pick_engine(token_ids).submit(EngineRequest(
                service_request_id=sid, request_id=request_id,
                token_ids=token_ids, sampling=sampling,
                prefill_only=True, on_prefill_done=on_prefill_done,
                on_output=on_output,     # surfaces prefill-side errors
                mm_embeds=mm_embeds))
            return 200, {"ok": True, "service_request_id": sid}

        # n > 1: fan out into n engine sequences sharing the prompt on one
        # replica (its prefix cache dedupes their prefill); choice k's
        # outputs are re-indexed, and `finished` is withheld until every
        # choice is done.
        n = max(1, sampling.n)
        offline = bool(body.get("offline", False))
        priority = int(body.get("priority") or 0)
        engine = self._pick_engine(token_ids)
        if n == 1:
            done = self._supersede(sid, dest)

            def tracked(out: RequestOutput) -> None:
                on_output(out)
                if out.finished:
                    self._stream_done(sid, done)
            engine.submit(EngineRequest(
                service_request_id=sid, request_id=request_id,
                token_ids=token_ids, sampling=sampling, on_output=tracked,
                offline=offline, priority=priority, mm_embeds=mm_embeds))
            return 200, {"ok": True, "service_request_id": sid}

        # The stage spans do not model the n-way fan-out: the prefill span
        # closes here, so the trace still records the admission.
        stage["span"].set(n=n).end()
        agg = _ChoiceAggregator(n, lambda out: self.streamer.push(dest, out))
        for k in range(n):
            sub_sampling = sampling
            if sampling.seed is not None:
                sub_sampling = SamplingParams.from_dict(sampling.to_dict())
                sub_sampling.seed = sampling.seed + k
            engine.submit(EngineRequest(
                service_request_id=sid, request_id=request_id,
                token_ids=list(token_ids), sampling=sub_sampling,
                on_output=agg.callback_for(k),
                offline=offline, priority=priority, mm_embeds=mm_embeds))
        return 200, {"ok": True, "service_request_id": sid}

    # -------------------------------------------------------- multimodal
    def _h_encode(self, req: _Request) -> Reply:
        """EPD's ENCODE stage: the vision tower on pixel arrays (a msgpack
        ``{"bytes", "shape", "dtype"}`` body), answered with the visual
        embeddings [N, out_tokens, D] as f32 in the same frame. The
        encoder runs on the engine's thread between steps (as the
        reference runs it off its event loop): a capture of the decode
        step must not see another thread's work on the card."""
        if self.engine.cfg.model_family != "qwen2_vl":
            return 400, {"error": f"model family "
                                  f"{self.engine.cfg.model_family} has no "
                                  "vision encoder"}
        try:
            obj = msgpack_lite.unpackb(req.body)
            pixels = np.frombuffer(obj["bytes"], dtype=np.dtype(
                obj["dtype"])).reshape(obj["shape"])
        except Exception as e:  # noqa: BLE001 — a malformed frame
            raise _BadRequest(f"invalid encode body: {e}") from None
        with self._encode_lock:
            self.encode_count += 1
        embeds = self._encode_local(pixels)
        return 200, msgpack_lite.packb({
            "bytes": embeds.tobytes(), "shape": list(embeds.shape),
            "dtype": "float32"})

    def _encode_local(self, pixels: np.ndarray) -> np.ndarray:
        """``encode_images`` on this agent's first engine -> [N, out_tokens,
        D] f32 on the host."""
        from ..models.qwen2_vl import encode_images

        eng = self.engine

        def run() -> np.ndarray:
            x = torch.from_numpy(np.array(pixels, np.float32))
            return encode_images(eng.params, eng.cfg.model,
                                 x.to(eng.device)).float().cpu().numpy()

        return eng._on_loop(run)

    @staticmethod
    def _is_image_part(part: Any) -> bool:
        """The one test of an image part, shared by the extraction and the
        token building (and the master's routing check): the two must
        agree, or the placeholder runs and the rows misalign."""
        return isinstance(part, dict) and \
            str(part.get("type", "")).startswith("image")

    def _extract_images(self, messages: list[dict]) -> Optional[np.ndarray]:
        """The image parts of the chat's messages as [N, S, S, 3] f32 in
        [0, 1] (S the encoder's input size): ``image_url`` data URIs
        decoded with PIL and resized with its default resampling, and raw
        ``image_data`` parts (base64 f32 and a shape). Any other image
        part, or a URL that is not a data URI, raises ValueError."""
        import base64
        import io

        vision = self.engine.cfg.model.vision
        if vision is None:
            return None
        size = vision.image_size
        out: list[np.ndarray] = []
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                continue
            for part in content:
                if not self._is_image_part(part):
                    continue
                ptype = str(part.get("type", ""))
                if ptype == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    if not url.startswith("data:"):
                        raise ValueError(
                            "only data: URIs are supported for images")
                    from PIL import Image

                    raw = base64.b64decode(url.split(",", 1)[1])
                    img = Image.open(io.BytesIO(raw)).convert("RGB") \
                        .resize((size, size))
                    out.append(np.asarray(img, np.float32) / 255.0)
                elif ptype == "image_data":
                    arr = np.frombuffer(
                        base64.b64decode(part["data"]),
                        np.float32).reshape(part["shape"])
                    out.append(arr.astype(np.float32))
                else:
                    # Must raise: _build_mm_token_ids makes a placeholder
                    # run for EVERY image part, so skipping one here would
                    # misalign the splice.
                    raise ValueError(
                        f"unsupported image part type: {ptype}")
        return np.stack(out) if out else None

    def _encode_pixels(self, pixels: np.ndarray,
                       encode_name: str) -> np.ndarray:
        """The ENCODE stage: on the routed instance, or here without one.
        Returns the flattened [n_images * out_tokens, D] f32 rows."""
        if encode_name and encode_name != self.name:
            host, _, port = encode_name.rpartition(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=60)
            try:
                conn.request("POST", "/rpc/encode", body=msgpack_lite.packb({
                    "bytes": pixels.tobytes(), "shape": list(pixels.shape),
                    "dtype": "float32"}), headers={
                        "Content-Type": msgpack_lite.CONTENT_TYPE})
                r = conn.getresponse()
                data = r.read()
            finally:
                conn.close()
            if r.status != 200:
                raise RuntimeError(f"{encode_name} returned {r.status}: "
                                   f"{data[:200]!r}")
            obj = msgpack_lite.unpackb(data)
            embeds = np.frombuffer(obj["bytes"], np.float32) \
                .reshape(obj["shape"])
        else:
            embeds = self._encode_local(pixels)
        return embeds.reshape(-1, embeds.shape[-1])

    def _build_mm_token_ids(self, messages: list[dict]) -> list[int]:
        """A multimodal prompt's token ids: the chat template renders the
        messages (each image part one MM_PLACEHOLDER), and each marker
        expands to ``out_tokens`` copies of the model's image placeholder
        id, so an image prompt keeps the role structure and system prompt
        of a text one. (The master's routing count, one marker an image,
        is short by out_tokens - 1 an image; the usage sent to clients is
        the engine's own count.)"""
        mcfg = self.engine.cfg.model
        out_tokens = mcfg.vision.out_tokens if mcfg.vision else 0
        tok = self.engine.tokenizer
        rendered = self.chat_template.apply(messages)
        ids: list[int] = []
        for i, segment in enumerate(rendered.split(MM_PLACEHOLDER)):
            if i > 0:
                ids.extend([mcfg.image_token_id] * out_tokens)
            if segment:
                ids.extend(tok.encode(segment))
        return ids

    # ------------------------------------------------- PD disaggregation
    def _transfer_to_peer(self, h: PrefillHandoff, peer: str, dest: str,
                          ctx: Optional[TraceContext] = None) -> None:
        """Ship a prefilled sequence to its decode peer: the device path
        first (a CUDA IPC pull by a peer on this card), then the streamed
        host path at or above ``kv_stream_threshold_bytes``, then the
        inline host path. A device offer that fails falls back to the host
        paths (counted in /stats: ``device_sent`` against ``host_sent``);
        a streamed one that fails falls back inline and leaves a
        ``kv_stream_fallback`` flight record; a handoff that fails on
        every path reaches the service as UNAVAILABLE."""
        trace_dict = ctx.to_dict() if ctx is not None else None
        peer_meta = self.linked_peers.get(peer)
        if (self.kv_transfer is not None and peer_meta is not None
                and peer_meta.topology.kv_transfer_addr
                == self.kv_transfer.address
                and self._same_mesh_topology(peer_meta)):
            desc = None
            try:
                desc = self.kv_transfer.offer(
                    h.service_request_id, h.kv_blob, self.incarnation_id,
                    ready=h.kv_ready, ctx=ctx)
                self._post_handoff(peer, pack_handoff(
                    h, dest, kv_ref=desc, source_instance=self.name,
                    trace_context=trace_dict))
                self.kv_transfer.release(desc["uuid"])
                self._count_kv("kv_device_sent")
                return
            except Exception as e:  # noqa: BLE001 — the host path follows
                if desc is not None:
                    self.kv_transfer.release(desc["uuid"])
                logger.warning(
                    "device KV transfer of %s to %s failed (%s); falling "
                    "back to the host path", h.service_request_id, peer, e)
        try:
            if h.kv_ready is not None:
                h.kv_ready.synchronize()
            host = PrefillHandoff(**{**h.__dict__,
                                     "kv_blob": h.kv_blob.cpu(),
                                     "kv_ready": None})
            nbytes = host.kv_blob.numel() * host.kv_blob.element_size()
            thresh = self.cfg.kv_stream_threshold_bytes
            if 0 <= thresh <= nbytes and self._stream_to_peer(
                    host, peer, dest, nbytes, ctx):
                return
            with TRACER.span("kv_transfer.offer", ctx=ctx, require_ctx=True,
                             request_id=h.service_request_id,
                             instance=self.name, path="host"):
                self._post_handoff(peer, pack_handoff(
                    host, dest, source_instance=self.name,
                    trace_context=trace_dict))
            self._count_kv("kv_host_sent")
        except Exception as e:  # noqa: BLE001 — reported to the service
            logger.warning("KV transfer of %s to %s failed: %s",
                           h.service_request_id, peer, e)
            self.streamer.push(dest, RequestOutput(
                service_request_id=h.service_request_id,
                request_id=h.request_id,
                status=Status(StatusCode.UNAVAILABLE,
                              f"KV transfer to decode peer failed: {e}"),
                finished=True))

    def _stream_to_peer(self, h: PrefillHandoff, peer: str, dest: str,
                        nbytes: int,
                        ctx: Optional[TraceContext] = None) -> bool:
        """The streamed host path: offer the bytes for chunked pulls and
        post the descriptor. False (the inline path follows) on failure,
        which is an anomaly worth a post-mortem: the handoff survives, but
        the chunked pull and its pacing were lost mid-request."""
        desc = None
        try:
            desc = self.kv_stream.offer(
                h.service_request_id, tensor_bytes(h.kv_blob),
                shape=list(h.kv_blob.shape),
                dtype=dtype_name(h.kv_blob.dtype),
                incarnation=self.incarnation_id,
                block_bytes=nbytes // max(1, h.kv_blob.shape[2]), ctx=ctx)
            self._post_handoff(peer, pack_handoff(
                h, dest, source_instance=self.name,
                trace_context=ctx.to_dict() if ctx is not None else None,
                kv_stream=desc))
            self.kv_stream.release(desc["stream_uuid"])
            self._count_kv("kv_stream_sent", "kv_host_sent")
            return True
        except Exception as e:  # noqa: BLE001 — the inline path follows
            if desc is not None:
                self.kv_stream.release(desc["stream_uuid"])
            logger.warning(
                "streamed KV transfer of %s to %s failed (%s); falling back "
                "to the inline host path", h.service_request_id, peer, e)
            trace_id = ctx.trace_id if ctx is not None else ""
            TRACER.keep_trace(trace_id)
            RECORDER.record(
                "kv_stream_fallback", request_id=h.service_request_id,
                trace_id=trace_id,
                detail={"peer": peer, "error": str(e), "bytes": nbytes})
            return False

    def _count_kv(self, *names: str) -> None:
        with self._kv_count_lock:
            for n in names:
                setattr(self, n, getattr(self, n) + 1)

    def _same_mesh_topology(self, peer_meta: InstanceMetaInfo) -> bool:
        """The device path needs an identical mesh topology on both ends
        (the shard layouts must line up); mismatched pairs take the host
        path, which re-materializes on the receiver."""
        theirs = peer_meta.topology
        return (self._mesh_shape() == theirs.mesh_shape
                and self._mesh_axes() == theirs.axis_names)

    @staticmethod
    def _post_handoff(peer: str, payload: bytes) -> None:
        host, _, port = peer.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        try:
            conn.request("POST", "/rpc/kv_transfer", body=payload,
                         headers={"Content-Type": msgpack_lite.CONTENT_TYPE})
            r = conn.getresponse()
            data = r.read()
        finally:
            conn.close()
        if r.status != 200:
            raise RuntimeError(f"peer returned {r.status}: {data[:200]!r}")

    def _h_kv_stream_pull(self, req: _Request) -> Reply:
        """Serve one chunk of a streamed KV offer (msgpack in and out)."""
        try:
            obj = msgpack_lite.unpackb(req.body)
            frame = self.kv_stream.read_chunk(
                int(obj["uuid"]), int(obj.get("offset", 0)),
                int(obj.get("max_bytes", self.kv_stream.default_chunk_bytes)))
        except (TypeError, ValueError, KeyError, AttributeError) as e:
            return 400, {"error": f"bad pull frame: {e}"}
        if frame is None:
            return 404, {"error": "unknown or expired offer"}
        return 200, msgpack_lite.packb(frame)

    def _link_class(self, peer_name: str) -> str:
        """ICI-shaped vs DCN-shaped for bandwidth budgeting, from the
        topology coordinates (``common/topology.py``); a same-host link
        rides the ICI bucket. Peers without placement coordinates keep the
        rule: same declared slice = ICI."""
        meta = self.linked_peers.get(peer_name)
        peer_topo = meta.topology if meta is not None else None
        if self.cfg.topo_host and getattr(peer_topo, "host", ""):
            mine = topo.Coord(self.cfg.slice_id, self.cfg.topo_host,
                              self.cfg.topo_chip, placed=True)
            link = topo.link_class(
                mine, topo.effective_coord(peer_topo, peer_name))
            return "ici" if link == topo.LINK_LOCAL else link
        if peer_topo is not None and peer_topo.slice_id \
                and peer_topo.slice_id == self.cfg.slice_id:
            return "ici"
        return "dcn"

    def _h_kv_transfer(self, req: _Request) -> Reply:
        """Decode side of the PD handoff: accept prompt KV + first token
        from a linked peer and inject it into the replica ``_pick_engine``
        chooses. The KV arrives inline, as a stream descriptor this side
        pulls in chunks, or as a device descriptor this side pulls over
        CUDA IPC (the pulls run on the agent's pull threads)."""
        try:
            obj = unpack_handoff(req.body)
            if not isinstance(obj, dict):
                raise ValueError("not a map")
        except (TypeError, ValueError, KeyError) as e:
            return 400, {"error": f"bad handoff: {e}"}
        # The P-D link is enforced on the transfer itself.
        src = obj.get("source_instance", "")
        if src not in self.linked_peers:
            return 403, {"error": f"instance {src or '<unknown>'} is not a "
                                  "linked peer; rejecting KV handoff"}
        sid = obj.get("service_request_id", "")
        ctx = TraceContext.from_dict(obj.get("trace_context"))
        now = time.monotonic()
        with self._seen_lock:
            for k, ts in list(self._handoffs_seen.items()):
                if now - ts > 600:
                    self._handoffs_seen.pop(k, None)
            if sid in self._handoffs_seen:
                # Duplicate delivery (the sender retried after a lost
                # response): the sequence is already injected.
                return 200, {"ok": True, "duplicate": True}
        # The sid is marked seen only once the payload is in hand: marking
        # before a pull would bounce the sender's inline retry as a
        # duplicate while the pull it raced can still fail.
        if "kv_blob" not in obj and obj.get("kv_stream") is not None:
            try:
                obj["kv_blob"] = self._pulls.submit(
                    pull_stream, src, obj["kv_stream"], self.bandwidth,
                    self._link_class(src), ctx=ctx).result()
                self._count_kv("kv_stream_received")
            except Exception as e:  # noqa: BLE001 — reported to the peer
                logger.warning("streamed KV pull for %s failed: %s", sid, e)
                return 502, {"error": f"streamed KV pull failed: {e}"}
        if "kv_blob" not in obj:
            ref = obj.get("kv_ref")
            if ref is None or self.kv_transfer is None:
                return 400, {"error": "no KV payload and no device-transfer "
                                      "capability"}
            try:
                obj["kv_blob"] = self._pulls.submit(
                    self.kv_transfer.pull, ref, ctx=ctx).result()
                self._count_kv("kv_device_received")
            except Exception as e:  # noqa: BLE001 — reported to the peer
                logger.warning("device KV pull for %s failed: %s", sid, e)
                return 502, {"error": f"device KV pull failed: {e}"}
        else:
            self._count_kv("kv_host_received")
        dest = obj.get("source_service_addr", "")
        lp_d = obj.get("first_logprob")
        lp = None
        if lp_d:
            lp = LogProb(token=lp_d["token"], token_id=lp_d["token_id"],
                         logprob=lp_d["logprob"],
                         top_logprobs=[LogProbData(t[0], t[1], t[2])
                                       for t in lp_d.get("top", ())])
        token_ids = list(obj["token_ids"])
        engine = self._pick_engine(token_ids)
        blob = obj["kv_blob"]
        if (isinstance(blob, torch.Tensor) and blob.device.type == "cuda"
                and blob.device != engine.device):
            blob = blob.to(engine.device)   # a replica on another card
        dspan = self._stage_span("engine.decode", ctx, sid, injected=True)

        def on_output(out: RequestOutput) -> None:
            if out.finished:
                dspan.end()
            self.streamer.push(dest, out)

        with self._seen_lock:
            if sid in self._handoffs_seen:
                # A retry raced this one and injected first.
                return 200, {"ok": True, "duplicate": True}
            self._handoffs_seen[sid] = time.monotonic()
            engine.submit(EngineRequest(
                service_request_id=sid,
                request_id=obj.get("request_id", ""),
                token_ids=token_ids,
                sampling=SamplingParams.from_dict(obj.get("sampling", {})),
                injected_first_token=int(obj["first_token"]),
                injected_kv=blob,
                injected_first_logprob=lp,
                on_output=on_output))
        return 200, {"ok": True}

    @staticmethod
    def _sampling_from_body(body: dict[str, Any]) -> SamplingParams:
        sp = SamplingParams()
        def num(key, default, cast):
            v = body.get(key)
            return cast(v) if v is not None else default
        sp.max_tokens = num("max_tokens", num("max_completion_tokens", 16, int), int)
        sp.n = num("n", 1, int)
        sp.temperature = num("temperature", 1.0, float)
        sp.top_p = num("top_p", 1.0, float)
        sp.top_k = num("top_k", -1, int)
        sp.frequency_penalty = num("frequency_penalty", 0.0, float)
        sp.presence_penalty = num("presence_penalty", 0.0, float)
        sp.repetition_penalty = num("repetition_penalty", 1.0, float)
        stop = body.get("stop")
        sp.stop = [stop] if isinstance(stop, str) else \
            [str(s) for s in stop] if isinstance(stop, list) else []
        sp.stop_token_ids = list(body.get("stop_token_ids", ()))
        if body.get("seed") is not None:
            sp.seed = int(body["seed"])
        lp = body.get("logprobs")
        if isinstance(lp, bool):
            sp.logprobs = lp
            sp.top_logprobs = int(body.get("top_logprobs") or 0)
        elif isinstance(lp, int):
            sp.logprobs = lp > 0
            sp.top_logprobs = lp
        sp.ignore_eos = bool(body.get("ignore_eos", False))
        lb = body.get("logit_bias")
        if isinstance(lb, dict):
            try:
                sp.logit_bias = {int(k): float(v) for k, v in lb.items()}
            except (TypeError, ValueError):
                pass
        return sp


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="xllm-service engine agent on the PyTorch/CUDA port")
    p.add_argument("--coordination-addr", default="127.0.0.1:12379",
                   help="coordination server host:port ('' = in-process)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--type", default="MIX",
                   choices=[t.value for t in InstanceType])
    p.add_argument("--model-id", default="bench-1b")
    p.add_argument("--model-config", default="bench_1b",
                   choices=["tiny", "tiny_f32", "bench_1b", "llama3_8b",
                            "llama3_70b", "gemma_2b", "gemma_tiny",
                            "mixtral_8x7b", "mixtral_tiny", "qwen2_vl_2b",
                            "qwen2_vl_tiny", "hf"],
                   help="config factory in models.base, models.gemma, "
                        "models.mixtral or models.qwen2_vl, or 'hf': "
                        "--checkpoint-path's config.json (models/"
                        "hf_config.py: llama, qwen2, gemma2, mixtral, "
                        "deepseek_v2/3, qwen2_vl) in its torch_dtype")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="weight-only quantization (models/quant.py)")
    p.add_argument("--checkpoint-path", default="",
                   help="weights to serve: an HF model directory "
                        "(*.safetensors, read with --model-config's "
                        "config) or a native checkpoint "
                        "(models/loader.py::save_params); '' = random "
                        "weights from the engine's seed")
    p.add_argument("--tokenizer-path", default="",
                   help="tokenizer directory or file (tokenizer.json, "
                        "tiktoken, SentencePiece); '' = the byte "
                        "tokenizer")
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--decode-horizon", type=int, default=0,
                   help="tokens per host fetch (0 = config default)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked-prefill tokens per engine iteration "
                        "(0 = whole-suffix installs); with a chunk set, "
                        "mid chunks ride decode steps (Sarathi mixed "
                        "steps) unless XLLM_SARATHI=0")
    p.add_argument("--speculate-k", type=int, default=0,
                   help="prompt-lookup speculative decoding: draft tokens "
                        "verified per cycle (0 disables)")
    p.add_argument("--generation-flush-ms", type=float, default=5.0,
                   help="batching window for Generations delta pushes")
    p.add_argument("--dp-size", type=int, default=1,
                   help="engine replicas behind this registration (replica "
                        "i on the i-th card from the agent's, round robin)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel mesh size (0 = single device): "
                        "that many distinct cards from --device-offset")
    p.add_argument("--device-offset", type=int, default=0,
                   help="first device index for this instance's mesh: "
                        "co-hosted instances (e.g. a PREFILL/DECODE "
                        "pair) own disjoint device groups instead of "
                        "stacking on device 0")
    p.add_argument("--telemetry-mode", default="mux",
                   choices=list(TELEMETRY_MODES),
                   help="mux = one multiplexed kept-alive session to the "
                        "owning master (tagged hb and gens frames); owner = "
                        "heartbeats to the rendezvous owner, deltas direct; "
                        "master = the elected-master funnel")
    p.add_argument("--kv-tier-dram-mb", type=int, default=0,
                   help="host-RAM tier for evicted prefix KV blocks, MiB "
                        "(0 disables tiering)")
    p.add_argument("--kv-tier-ssd-mb", type=int, default=0,
                   help="disk spill tier behind the DRAM arena, MiB "
                        "(requires --kv-tier-dram-mb > 0)")
    p.add_argument("--kv-tier-ssd-path", default="",
                   help="spill file path ('' = a temp file owned by the "
                        "store)")
    p.add_argument("--degraded-mode", default="on", choices=["on", "off"],
                   help="on = keep heartbeats flowing to the last-known-"
                        "good master while the coordination plane is "
                        "unreachable; off = no resolvable master, no beats")
    p.add_argument("--slice-id", default="slice-0",
                   help="slice this instance's devices live on; same-slice "
                        "PD handoffs are ICI-shaped links, cross-slice ones "
                        "DCN-shaped")
    p.add_argument("--topo-host", default="",
                   help="physical host coordinate; non-empty marks this "
                        "instance placed ('' = a synthetic per-host slice)")
    p.add_argument("--topo-chip", type=int, default=-1,
                   help="chip index within --topo-host (-1 = unpinned)")
    p.add_argument("--ici-bytes-per-s", type=float, default=0.0,
                   help="ICI-class KV pull bandwidth budget, bytes/s "
                        "(0 = account only, no pacing)")
    p.add_argument("--dcn-bytes-per-s", type=float, default=0.0,
                   help="DCN-class KV pull bandwidth budget, bytes/s "
                        "(0 = account only, no pacing)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a "
                        "card). 'cpu' runs on the CPU")
    return p


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The engine configuration of parsed command-line ``args``."""
    from ..models import base as model_base
    from ..models import gemma, hf_config, mixtral, qwen2_vl

    if args.model_config == "hf":
        mcfg = hf_config.model_config_from_hf(
            args.checkpoint_path,
            dtype=hf_config.checkpoint_dtype(args.checkpoint_path))
    else:
        mcfg = {"tiny": model_base.tiny_config,
                # The CPU bench shape: f32, the context of the in-process
                # serve bench.
                "tiny_f32": lambda: model_base.tiny_config(
                    dtype=torch.float32, max_context_len=1024),
                "bench_1b": model_base.bench_1b_config,
                "llama3_8b": model_base.llama3_8b_config,
                "llama3_70b": model_base.llama3_70b_config,
                "gemma_2b": gemma.gemma_2b_config,
                "gemma_tiny": gemma.gemma_tiny_config,
                "mixtral_8x7b": mixtral.mixtral_8x7b_config,
                "mixtral_tiny": mixtral.mixtral_tiny_config,
                "qwen2_vl_2b": qwen2_vl.qwen2_vl_2b_config,
                "qwen2_vl_tiny": qwen2_vl.tiny_vl_config,
                }[args.model_config]()
    if args.quant:
        mcfg = dataclasses.replace(mcfg, quant=args.quant)
    ecfg = EngineConfig(
        model_family=mcfg.name, model=mcfg,
        num_pages=args.num_pages, page_size=args.page_size,
        max_batch_size=args.max_batch_size,
        max_seq_len=min(args.max_seq_len, mcfg.max_context_len))
    if args.kv_tier_dram_mb > 0:
        ecfg.kv_tier_dram_bytes = args.kv_tier_dram_mb << 20
        ecfg.kv_tier_ssd_bytes = args.kv_tier_ssd_mb << 20
        ecfg.kv_tier_ssd_path = args.kv_tier_ssd_path
    if args.decode_horizon > 0:
        ecfg.decode_horizon = args.decode_horizon
    if args.prefill_chunk > 0:
        ecfg.prefill_chunk_tokens = args.prefill_chunk
    if args.speculate_k > 0:
        ecfg.speculate_k = args.speculate_k
    if args.tp and args.tp > 1:
        ecfg.mesh = MeshConfig(model=args.tp)
    if args.device_offset:
        ecfg.mesh_device_offset = args.device_offset
    return ecfg


def checkpoint_params(path: str, mcfg, device=None,
                      mesh: Optional[DeviceMesh] = None) -> dict:
    """The weights under ``path`` for model ``mcfg``: a directory holding
    ``*.safetensors`` is an HF model directory, read by the family's loader
    (``models/hf_config.py::loader_for``; the reference agent reads every
    such directory with its llama loader, which maps no MoE tensor),
    anything else a native checkpoint (``load_params``). A failed load
    raises: the agent never falls back to random weights. Under ``--quant
    int8`` the loaders quantize the stacked projections as they assemble
    them, and the engine quantizes the rest at start. With ``mesh`` the
    tree comes back sharded by the family's rules, each shard on its
    device."""
    from ..models import hf_config, loader

    kw = {}
    if mesh is not None:
        kw = dict(mesh=mesh,
                  rules=get_model_family(mcfg.name).sharding_rules)
    if loader.shard_files(path):
        return hf_config.loader_for(mcfg)(path, mcfg, device=device, **kw)
    return loader.load_params(path, mcfg, device=device, **kw)


def _engine_inputs(args: argparse.Namespace
                   ) -> tuple[EngineConfig, Optional[dict]]:
    """The engine configuration of ``args`` and its weights, loaded from
    ``--checkpoint-path`` when one is given (else None: the engine draws
    them). Loaded weights go onto the devices the engine's mesh takes
    (from --device-offset), so a co-hosted pair's never share a card; in
    a joined process group that mesh spans the ranks, each keeping only
    its shards."""
    ecfg = engine_config(args)
    params = None
    if args.checkpoint_path:
        mesh = (mesh_from_config(ecfg.mesh, resolve_device(args.device),
                                 ecfg.mesh_device_offset)
                if ecfg.mesh is not None else None)
        params = checkpoint_params(args.checkpoint_path, ecfg.model,
                                   args.device, mesh)
    return ecfg, params


def build_follower(args: argparse.Namespace) -> InferenceEngine:
    """A follower rank's engine: the primary's exactly, its tokenizer
    included (eos and stop ids feed the device state; another one would
    change the batch's composition and break the lockstep)."""
    ecfg, params = _engine_inputs(args)
    return InferenceEngine(
        ecfg, device=args.device, params=params,
        tokenizer=TokenizerFactory.create_tokenizer(args.tokenizer_path))


def build_agent(args: argparse.Namespace,
                coord: Optional[CoordinationClient] = None) -> EngineAgent:
    """The agent of parsed command-line ``args`` (not started), its
    weights loaded from ``--checkpoint-path`` when one is given."""
    ecfg, params = _engine_inputs(args)
    return EngineAgent(
        ecfg,
        AgentConfig(host=args.host, port=args.port,
                    coordination_addr=args.coordination_addr,
                    instance_type=InstanceType.parse(args.type),
                    model_id=args.model_id,
                    generation_flush_ms=args.generation_flush_ms,
                    dp_size=args.dp_size,
                    telemetry_mode=args.telemetry_mode,
                    degraded_mode=args.degraded_mode,
                    slice_id=args.slice_id, topo_host=args.topo_host,
                    topo_chip=args.topo_chip,
                    ici_bytes_per_s=args.ici_bytes_per_s,
                    dcn_bytes_per_s=args.dcn_bytes_per_s,
                    tokenizer_path=args.tokenizer_path),
        coord=coord, params=params, device=args.device)


def main(argv: Optional[list[str]] = None) -> None:
    p = _parser()
    args = p.parse_args(argv)
    if args.device_offset:
        if not (args.tp and args.tp > 1):
            p.error("--device-offset requires --tp > 1 (a mesh to place)")
        if args.device_offset < 0:
            p.error("--device-offset must be >= 0")
    if args.model_config == "hf" and not args.checkpoint_path:
        p.error("--model-config hf reads --checkpoint-path's config.json")
    if args.dp_size < 1:
        p.error("--dp-size must be >= 1")
    # One instance over processes: join the group (XLLM_MH_COORDINATOR,
    # XLLM_MH_NUM_HOSTS, XLLM_MH_HOST_ID) before any device is touched,
    # so that every mesh built below spans the ranks. A configuration
    # error is raised before the split, so that it cannot leave the
    # followers in a collective.
    multihost.initialize_from_env()
    if multihost.process_count() > 1 and args.dp_size != 1:
        p.error("multihost mode requires --dp-size 1")
    if not multihost.is_primary():
        from .multihost_driver import MultihostEngineDriver

        # A follower never serves HTTP nor registers: it mirrors the
        # primary's engine events until the shutdown event.
        engine = build_follower(args)
        MultihostEngineDriver(engine).follower_loop()
        engine.stop()
        return
    agent = build_agent(args)
    agent.start()
    import signal as _signal

    def _sigterm(_sig, _frm):
        # Planned restarts drain: stop taking traffic, finish streams.
        agent.drain(timeout_s=60.0)
        raise SystemExit(0)

    _signal.signal(_signal.SIGTERM, _sigterm)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        agent.stop()


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    main()
