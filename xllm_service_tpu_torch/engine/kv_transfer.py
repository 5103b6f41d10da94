"""KV transfer for PD disaggregation (port of
``xllm_service_tpu/engine/kv_transfer.py``).

The prefill engine hands a prefilled sequence's KV pages (one buffer
``[L, 2, n, n_kv, ps, hd]``, gathered by kernel 4) to its decode peer by
one of three transports, behind the same ``PrefillHandoff`` contract:

- **the device path** (:class:`KvTransferManager`): where the reference
  offers the buffer to a JAX transfer server, this port offers it over
  CUDA IPC. The offer exports the buffer's allocation
  (``cudaIpcGetMemHandle``) and keeps the buffer alive until the peer's
  release or the TTL; the descriptor ``{addr, uuid, shape, dtype}`` also
  carries the handle, the buffer's offset in its allocation and its byte
  count. The decode side opens the handle, copies the bytes into a buffer
  this engine owns, synchronizes (the prefill side releases its offer as
  soon as the handoff POST returns) and closes the handle. A block of a
  head-sharded pool (``ShardedBlock``, between identical meshes) goes one
  handle a shard, listed under the descriptor's ``shards``. The address
  names the card (``cuda-ipc:<GPU uuid>``): the path serves two processes
  on one card; a handle opened in the process that exported it fails.
- **the streamed host path** (:class:`StreamOfferTable`,
  :func:`pull_stream`): the payload's bytes are pulled back in chunked
  msgpack frames over ``/rpc/kv_stream_pull``, paced by
  :class:`BandwidthAccountant`.
- **the inline host path**: the bytes ride in the handoff POST itself
  (``engine/agent.py::pack_handoff``).

The framework-neutral parts (``transfer_uuid``, ``BandwidthAccountant``,
``StreamOfferTable``, ``pull_stream``) behave as the reference's;
``pull_stream`` speaks ``http.client`` and ``rpc/msgpack_lite.py`` where
the reference uses ``requests`` and ``msgpack``, and returns a CPU tensor
(bf16 read from its raw bits) where the reference returns a numpy array.
Each transport records the reference's spans under the request's carried
trace context (``kv_transfer.offer`` on the prefill side,
``kv_transfer.pull`` on the decode side, with ``path`` device or stream)
and checks the same fault points (``common/faults.py``): an injected
offer fault sends the handoff down the next path, an injected pull fault
fails the pull, and the sender retries inline.

No kernel moves the bytes here: the device path is one device-to-device
memory copy, which no TPU kernel did either.
"""

from __future__ import annotations

import ctypes
import hashlib
import http.client
import logging
import os
import threading
import time
import warnings
from typing import Any, Callable, Optional, Union

import torch

from ..common.faults import FAULTS
from ..common.tracing import TRACER, TraceContext
from ..devtools import lifecycle as _lifecycle
from ..devtools.locks import make_lock
from ..parallel.sharding import ShardedBlock
from ..rpc import msgpack_lite

logger = logging.getLogger(__name__)

# An offer the decode peer never pulled (transfer failed mid-flight) is
# dropped after this long so the KV buffers can be freed.
OFFER_TTL_S = 120.0


def transfer_uuid(service_request_id: str, incarnation: str = "") -> int:
    """Stable 63-bit id for one handoff."""
    digest = hashlib.blake2b(
        f"{service_request_id}|{incarnation}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") & 0x7FFF_FFFF_FFFF_FFFF


# ---------------------------------------------------------------- host bytes
def dtype_name(dtype: torch.dtype) -> str:
    """The wire's dtype string of a torch dtype (``"bfloat16"``,
    ``"float32"``, ...: numpy's names, and the reference's for bf16)."""
    return str(dtype).removeprefix("torch.")


def wire_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name`; raises ValueError on an unknown
    name."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of ``t`` in C order, as numpy's ``tobytes`` writes
    them (bf16 as its 16-bit patterns, which is what the reference writes
    through ``ml_dtypes``)."""
    t = t.detach().cpu().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def tensor_from_bytes(data: Union[bytes, bytearray], shape: list,
                      dtype: str) -> torch.Tensor:
    """A CPU tensor over ``data`` (no copy), of ``shape`` and the wire
    dtype ``dtype``. The tensor shares ``data``'s memory: callers only read
    it. Raises ValueError when the sizes disagree."""
    dt = wire_dtype(dtype)
    n = 1
    for d in shape:
        n *= int(d)
    itemsize = torch.empty((), dtype=dt).element_size()
    if len(data) != n * itemsize:
        raise ValueError(f"{len(data)} bytes for shape {list(shape)} of "
                         f"{dtype}")
    if not n:
        return torch.empty([int(d) for d in shape], dtype=dt)
    with warnings.catch_warnings():
        # bytes are read-only; the tensor is only read.
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.frombuffer(data, dtype=torch.uint8)
    return flat.view(dt).reshape([int(d) for d in shape])


# ------------------------------------------------------------- host path
class BandwidthAccountant:
    """Per-link bandwidth budget + throughput accounting for host-path
    KV streaming. Links are classed ICI-shaped (same slice) vs DCN-shaped
    (cross-slice); each class gets a configurable bytes/s budget (0 =
    unthrottled).

    Token-bucket pacing: :meth:`debit` records `nbytes` on the link and
    returns how long the caller should sleep to stay inside the budget
    (the PULL side paces). Accounting survives pacing-off, so throughput
    still reports in /stats."""

    def __init__(self, ici_bytes_per_s: float = 0.0,
                 dcn_bytes_per_s: float = 0.0):
        self._budget = {"ici": float(ici_bytes_per_s),
                        "dcn": float(dcn_bytes_per_s)}
        self._lock = make_lock("kv_transfer.bandwidth", order=57)  # lock-order: 57
        # link -> [bytes_total, busy_seconds, bucket_level, bucket_ts]
        self._links: dict[str, list[float]] = {}

    def debit(self, link: str, nbytes: int) -> float:
        """Record `nbytes` moved on `link`; returns pacing sleep
        seconds (0.0 when unthrottled or inside budget)."""
        budget = self._budget.get(link, 0.0)
        now = time.monotonic()
        with self._lock:
            st = self._links.setdefault(link, [0.0, 0.0, 0.0, now])
            st[0] += nbytes
            if budget <= 0.0:
                return 0.0
            # Leak the bucket, then pour this transfer in; the overflow
            # over one budget-second is the pacing debt (busy time arrives
            # once, through record_busy).
            st[2] = max(0.0, st[2] - (now - st[3]) * budget) + nbytes
            st[3] = now
            return max(0.0, (st[2] - budget) / budget)

    def record_busy(self, link: str, seconds: float) -> None:
        """Fold actual wire time into the throughput accounting."""
        with self._lock:
            st = self._links.setdefault(link, [0.0, 0.0, 0.0,
                                               time.monotonic()])
            st[1] += seconds

    def stats(self) -> dict[str, dict[str, float]]:
        with self._lock:
            out = {}
            for link, st in self._links.items():
                out[link] = {
                    "bytes_total": st[0],
                    "busy_seconds": round(st[1], 6),
                    "throughput_bytes_per_s": round(st[0] / st[1], 1)
                    if st[1] > 0 else 0.0,
                    "budget_bytes_per_s": self._budget.get(link, 0.0),
                }
            return out


class StreamOfferTable:
    """Offer side of the chunked streaming transfer: registered blobs are
    served to peers in msgpack frames via ``/rpc/kv_stream_pull``, many
    blocks per round trip instead of one monolithic POST. TTL-expired
    offers are dropped by :meth:`gc`."""

    def __init__(self, default_chunk_bytes: int = 1 << 20):
        self.default_chunk_bytes = max(1, int(default_chunk_bytes))
        self._lock = make_lock("kv_transfer.stream_offers", order=58)  # lock-order: 58
        # uuid -> (bytes, meta, deadline)
        self._offers: dict[int, tuple[bytes, dict, float]] = {}

    def offer(self, service_request_id: str, data: bytes,
              shape: list, dtype: str, incarnation: str = "",
              block_bytes: int = 0,
              ctx: Optional[TraceContext] = None) -> dict[str, Any]:
        """Register `data` for streaming; returns the wire descriptor the
        control message carries (everything the puller needs, including
        the whole-payload checksum). `ctx` parents the offer span."""
        uid = transfer_uuid(service_request_id, "stream:" + incarnation)
        with TRACER.span("kv_transfer.offer", ctx=ctx, require_ctx=True,
                         request_id=service_request_id, path="stream",
                         nbytes=len(data)):
            # An injected fault here sends the caller to the inline path.
            FAULTS.check("kv_transfer.offer", sid=service_request_id)
            self.gc()
            with self._lock:
                if uid not in self._offers:
                    _lifecycle.note_acquire("stream-offer", key=uid)
                self._offers[uid] = (data, {"shape": list(shape),
                                            "dtype": dtype},
                                     time.monotonic() + OFFER_TTL_S)
        return {
            "stream_uuid": uid,
            "total_bytes": len(data),
            "chunk_bytes": self.default_chunk_bytes,
            "block_bytes": int(block_bytes),
            "shape": list(shape),
            "dtype": dtype,
            "checksum": hashlib.blake2b(data, digest_size=8).hexdigest(),
        }

    def read_chunk(self, uuid: int, offset: int,
                   max_bytes: int) -> Optional[dict[str, Any]]:
        """One pull round trip's frame: None for an unknown or expired
        offer (the puller surfaces it and the sender falls back)."""
        with self._lock:
            entry = self._offers.get(int(uuid))
            if entry is None:
                return None
            data = entry[0]
        offset = max(0, int(offset))
        chunk = data[offset:offset + max(1, int(max_bytes))]
        return {
            "offset": offset,
            "data": chunk,
            "total_bytes": len(data),
            "last": offset + len(chunk) >= len(data),
        }

    def release(self, uuid: int) -> None:
        with self._lock:
            if self._offers.pop(int(uuid), None) is not None:
                _lifecycle.note_release("stream-offer", key=int(uuid))

    def gc(self) -> None:
        now = time.monotonic()
        with self._lock:
            dead = [u for u, (_, _, dl) in self._offers.items() if dl < now]
            for u in dead:
                self._offers.pop(u, None)
                _lifecycle.note_release("stream-offer", key=u)
        if dead:
            logger.warning("dropped %d expired KV stream offers", len(dead))

    def count(self) -> int:
        with self._lock:
            return len(self._offers)


def _msgpack_post() -> Callable[[str, dict], dict]:
    """The default transport of :func:`pull_stream`: msgpack POSTs on one
    kept-alive ``http.client`` connection per peer."""
    conns: dict[str, http.client.HTTPConnection] = {}

    def post(url: str, payload: dict) -> dict:
        rest = url.split("://", 1)[-1]
        hostport, _, path = rest.partition("/")
        conn = conns.get(hostport)
        if conn is None:
            host, _, port = hostport.rpartition(":")
            conn = conns[hostport] = http.client.HTTPConnection(
                host, int(port), timeout=30)
        try:
            conn.request("POST", "/" + path, body=msgpack_lite.packb(payload),
                         headers={"Content-Type":
                                  msgpack_lite.CONTENT_TYPE})
            r = conn.getresponse()
            data = r.read()
        except (http.client.HTTPException, OSError):
            conns.pop(hostport, None)
            conn.close()
            raise
        if r.status != 200:
            raise ValueError(f"stream pull HTTP {r.status}: {data[:200]!r}")
        return msgpack_lite.unpackb(data)

    return post


def pull_stream(peer_addr: str, desc: dict[str, Any],
                accountant: Optional[BandwidthAccountant] = None,
                link: str = "dcn",
                post: Optional[Callable[[str, dict], dict]] = None,
                deadline_s: float = 45.0,
                ctx: Optional[TraceContext] = None) -> torch.Tensor:
    """Pull a streamed KV payload from `peer_addr` in chunked round trips
    (run off the HTTP handler's thread: pacing sleeps are free there).
    Returns the reassembled CPU tensor; raises ValueError on a bad frame or
    checksum mismatch (the peer's retry then rides the inline path).

    `deadline_s` bounds the WHOLE pull, pacing included: it stays under
    the sender's handoff POST timeout (60 s), so a slow pull fails on THIS
    side first and the sender's inline retry finds the handoff unclaimed.

    `post(url, payload_dict) -> response_dict` is injectable for tests;
    the default POSTs msgpack to ``/rpc/kv_stream_pull``. `ctx` parents
    the pull span."""
    if post is None:
        post = _msgpack_post()
    url = f"http://{peer_addr}/rpc/kv_stream_pull"
    total = int(desc["total_bytes"])
    chunk_bytes = max(1, int(desc.get("chunk_bytes") or (1 << 20)))
    buf = bytearray(total)
    got = 0
    t0 = time.monotonic()
    with TRACER.span("kv_transfer.pull", ctx=ctx, require_ctx=True,
                     path="stream", nbytes=total, link=link) as span:
        while got < total:
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError(
                    f"stream pull exceeded {deadline_s:.0f}s deadline at "
                    f"{got}/{total} bytes (budget too tight for this "
                    "payload; the sender's retry rides the inline path)")
            # A pull fault aborts this transfer; the sender retries inline.
            FAULTS.check("kv_transfer.pull", uuid=desc.get("stream_uuid"))
            frame = post(url, {"uuid": desc["stream_uuid"], "offset": got,
                               "max_bytes": chunk_bytes})
            if not frame or frame.get("data") is None:
                raise ValueError("stream offer expired or unknown")
            data = frame["data"]
            if not data:
                raise ValueError("empty stream frame")
            buf[got:got + len(data)] = data
            got += len(data)
            if accountant is not None:
                sleep_s = accountant.debit(link, len(data))
                if sleep_s > 0:
                    time.sleep(sleep_s)
        elapsed = max(1e-9, time.monotonic() - t0)
        if accountant is not None:
            accountant.record_busy(link, elapsed)
        span.set(mbps=round(total / elapsed / 1e6, 3),
                 round_trips=-(-total // chunk_bytes))
    digest = hashlib.blake2b(buf, digest_size=8).hexdigest()
    if desc.get("checksum") and digest != desc["checksum"]:
        raise ValueError("stream checksum mismatch")
    return tensor_from_bytes(buf, desc["shape"], desc["dtype"])


# ------------------------------------------------------------ device path
class _IpcHandle(ctypes.Structure):
    """``cudaIpcMemHandle_t``: 64 opaque bytes, NULs included (so never
    read through a ``c_char`` array, which stops at the first NUL)."""
    _fields_ = [("reserved", ctypes.c_ubyte * 64)]

    def to_bytes(self) -> bytes:
        return ctypes.string_at(ctypes.addressof(self), 64)

    @classmethod
    def from_bytes(cls, data: bytes) -> "_IpcHandle":
        if len(data) != 64:
            raise ValueError(f"an IPC handle is 64 bytes, got {len(data)}")
        h = cls()
        ctypes.memmove(ctypes.addressof(h), data, 64)
        return h


class _DeviceBytes:
    """A view of ``nbytes`` device bytes at ``ptr`` that ``torch.as_tensor``
    takes through the CUDA array interface (no copy, no stream sync)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2, "strides": None}


class _CudaIpc:
    """The CUDA runtime's IPC calls and the driver's address-range query,
    through ctypes. The runtime is the one this process already loaded
    (PyTorch's) where one is mapped, else the toolkit's."""

    def __init__(self):
        self.rt = ctypes.CDLL(self._runtime_path())
        self.drv = ctypes.CDLL("libcuda.so.1")
        self.rt.cudaIpcGetMemHandle.argtypes = [ctypes.POINTER(_IpcHandle),
                                                ctypes.c_void_p]
        self.rt.cudaIpcOpenMemHandle.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), _IpcHandle, ctypes.c_uint]
        self.rt.cudaIpcCloseMemHandle.argtypes = [ctypes.c_void_p]
        self.rt.cudaGetErrorString.restype = ctypes.c_char_p
        self.rt.cudaSetDevice.argtypes = [ctypes.c_int]
        self.drv.cuMemGetAddressRange_v2.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_uint64]

    @staticmethod
    def _runtime_path() -> str:
        try:
            with open("/proc/self/maps") as f:
                for line in f:
                    path = line.split()[-1]
                    if "/libcudart.so" in path:
                        return path
        except OSError:
            pass
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        for cand in ("libcudart.so.12", os.path.join(home, "lib64",
                                                     "libcudart.so")):
            try:
                ctypes.CDLL(cand)
                return cand
            except OSError:
                continue
        raise RuntimeError("no CUDA runtime library to load for CUDA IPC")

    def _check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.rt.cudaGetErrorString(err)
            raise RuntimeError(f"{what} failed: error {err} "
                               f"({msg.decode() if msg else '?'})")

    def bind(self, index: int) -> None:
        """Make device ``index``'s primary context current on this thread
        (the driver call below needs one; a fresh thread has none)."""
        self._check(self.rt.cudaSetDevice(index), "cudaSetDevice")

    def export(self, ptr: int) -> tuple[bytes, int]:
        """(the IPC handle of the allocation holding ``ptr``, ``ptr``'s
        offset in it). The device of ``ptr`` must be bound."""
        base, size = ctypes.c_uint64(), ctypes.c_size_t()
        err = self.drv.cuMemGetAddressRange_v2(ctypes.byref(base),
                                               ctypes.byref(size), ptr)
        if err != 0:
            raise RuntimeError(f"cuMemGetAddressRange failed: error {err}")
        handle = _IpcHandle()
        self._check(self.rt.cudaIpcGetMemHandle(ctypes.byref(handle),
                                                base.value),
                    "cudaIpcGetMemHandle")
        return handle.to_bytes(), ptr - base.value

    def open(self, handle: bytes) -> int:
        h = _IpcHandle.from_bytes(handle)
        ptr = ctypes.c_void_p()
        # cudaIpcMemLazyEnablePeerAccess.
        self._check(self.rt.cudaIpcOpenMemHandle(ctypes.byref(ptr), h, 1),
                    "cudaIpcOpenMemHandle")
        return int(ptr.value)

    def close(self, ptr: int) -> None:
        self._check(self.rt.cudaIpcCloseMemHandle(ptr),
                    "cudaIpcCloseMemHandle")


class KvTransferManager:
    """One per engine agent on a card: offers gathered KV buffers to a
    peer process on the same card over CUDA IPC, and pulls a peer's offers
    into this engine's memory. The interface is the reference's
    (``create``, ``address``, ``offer``, ``release``, ``gc``, ``close``,
    ``pull``)."""

    def __init__(self, device: Union[str, torch.device]):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA IPC needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device
        self._ipc = _CudaIpc()
        self._address = "cuda-ipc:GPU-" + str(
            torch.cuda.get_device_properties(device).uuid)
        self._lock = make_lock("kv_transfer.pending", order=56)  # lock-order: 56
        # Opening a handle that another pull of this process holds open
        # can fail; pulls run one at a time.
        self._pull_lock = make_lock("kv_transfer.pull", order=59)  # lock-order: 59
        # uuid -> (buffers, deadline): keeps offered buffers alive until
        # the peer confirms the pull (release()) or the TTL lapses.
        self._pending: dict[int, tuple[list, float]] = {}
        # The last pull's split: opening the handle, the copy (ms).
        self.last_pull: dict[str, float] = {}

    @classmethod
    def create(cls, device: Union[str, torch.device]) -> "KvTransferManager":
        """The manager of ``device``. Unlike the reference's (None when its
        runtime lacks a transfer server), this raises: on a card the device
        path must exist."""
        return cls(device)

    @property
    def address(self) -> str:
        return self._address

    # ------------------------------------------------------------ prefill
    def offer(self, service_request_id: str,
              blob: Union[torch.Tensor, ShardedBlock],
              incarnation: str = "",
              ready: Optional[torch.cuda.Event] = None,
              ctx: Optional[TraceContext] = None) -> dict[str, Any]:
        """Export ``blob`` for a pull by the peer; returns the wire
        descriptor. ``ready`` is an event recorded after the work that
        wrote ``blob`` (the gather); the offer waits for it, so the peer
        never reads the buffer before it is written (without one, it waits
        for the work enqueued so far on the blob's device). ``ctx``
        parents the offer span. A ``ShardedBlock`` (a head-sharded pool's
        block, for a peer on an identical mesh) is exported one handle a
        shard, its parts under ``shards``."""
        uid = transfer_uuid(service_request_id, incarnation)
        parts = blob.parts if isinstance(blob, ShardedBlock) else [blob]
        if any(p.device.type != "cuda" or not p.is_contiguous()
               for p in parts):
            raise ValueError("offer needs contiguous CUDA tensors")
        with TRACER.span("kv_transfer.offer", ctx=ctx, require_ctx=True,
                         request_id=service_request_id, path="device",
                         shape=list(blob.shape)):
            # An injected fault here sends the agent down the host paths.
            FAULTS.check("kv_transfer.offer", sid=service_request_id)
            self.gc()
            if ready is not None:
                ready.synchronize()
            else:
                for p in parts:
                    torch.cuda.current_stream(p.device).synchronize()
            exported = []
            for p in parts:
                with torch.cuda.device(p.device):
                    self._ipc.bind(p.device.index)
                    handle, offset = self._ipc.export(p.data_ptr())
                exported.append({"ipc_handle": handle, "offset": offset,
                                 "shape": list(p.shape),
                                 "nbytes": p.numel() * p.element_size()})
            with self._lock:
                self._pending[uid] = (parts,
                                      time.monotonic() + OFFER_TTL_S)
        desc = {"addr": self.address, "uuid": uid,
                "shape": list(blob.shape), "dtype": dtype_name(blob.dtype)}
        if isinstance(blob, ShardedBlock):
            desc["shards"] = exported
        else:
            desc.update({k: exported[0][k]
                         for k in ("ipc_handle", "offset", "nbytes")})
        return desc

    def release(self, uuid: int) -> None:
        with self._lock:
            self._pending.pop(uuid, None)

    def gc(self) -> None:
        """Drop expired offers so their KV buffers can be freed. Called on
        every offer and from the agent's heartbeat loop: an idle agent
        must still release buffers whose peer died before pulling."""
        now = time.monotonic()
        with self._lock:
            dead = [u for u, (_, dl) in self._pending.items() if dl < now]
            for u in dead:
                self._pending.pop(u, None)
        if dead:
            logger.warning("dropped %d expired KV-transfer offers", len(dead))

    def close(self) -> None:
        """Drop every offered buffer."""
        with self._lock:
            self._pending.clear()

    # ------------------------------------------------------------- decode
    def pull(self, desc: dict[str, Any],
             ctx: Optional[TraceContext] = None) -> torch.Tensor:
        """Copy the offered KV pages into a new buffer of this engine's
        device and return it, once the copy has completed. ``ctx``
        parents the pull span."""
        with TRACER.span("kv_transfer.pull", ctx=ctx, require_ctx=True,
                         path="device", shape=list(desc.get("shape", ()))):
            # A pull fault is reported to the peer, which retries by the
            # host paths.
            FAULTS.check("kv_transfer.pull", uuid=desc.get("uuid"))
            return self._pull(desc)

    def _pull(self, desc: dict[str, Any]
              ) -> Union[torch.Tensor, ShardedBlock]:
        if desc.get("addr") != self.address:
            raise ValueError(f"offer at {desc.get('addr')!r} is not on this "
                             f"card ({self.address})")
        dtype = wire_dtype(desc["dtype"])
        if "shards" not in desc:
            return self._pull_one(desc, [int(d) for d in desc["shape"]],
                                  dtype)
        parts = [self._pull_one(sh, [int(d) for d in sh["shape"]], dtype)
                 for sh in desc["shards"]]
        block = ShardedBlock(parts)
        if list(block.shape) != [int(d) for d in desc["shape"]]:
            raise ValueError(f"shards of {list(block.shape)} for an offer "
                             f"of {desc['shape']}")
        return block

    def _pull_one(self, desc: dict[str, Any], shape: list[int],
                  dtype: torch.dtype) -> torch.Tensor:
        """One exported buffer (``ipc_handle``, ``offset``, ``nbytes``)
        copied into a new tensor of this engine's device."""
        out = torch.empty(shape, dtype=dtype, device=self._device)
        nbytes = int(desc["nbytes"])
        if nbytes != out.numel() * out.element_size():
            raise ValueError(f"offer of {nbytes} bytes for shape {shape} of "
                             f"{dtype_name(dtype)}")
        with self._pull_lock, torch.cuda.device(self._device):
            self._ipc.bind(self._device.index)
            t0 = time.perf_counter()
            base = self._ipc.open(bytes(desc["ipc_handle"]))
            t1 = time.perf_counter()
            try:
                src = torch.as_tensor(
                    _DeviceBytes(base + int(desc["offset"]), nbytes),
                    device=self._device)
                out.reshape(-1).view(torch.uint8).copy_(src)
                torch.cuda.current_stream(self._device).synchronize()
            finally:
                self._ipc.close(base)
            t2 = time.perf_counter()
        self.last_pull = {"open_ms": (t1 - t0) * 1e3,
                          "copy_ms": (t2 - t1) * 1e3}
        return out
