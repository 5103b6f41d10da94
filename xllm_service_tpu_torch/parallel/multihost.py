"""Process groups of the port: one engine instance over several processes
(port of ``xllm_service_tpu/parallel/multihost.py``).

The reference joins ``jax.distributed``, after which its devices are global
and every jitted program over a global mesh is a collective that XLA
routes. The port joins a ``torch.distributed`` group instead
(``initialize``): each process is a rank, holds only the shards of its own
mesh coordinates (``parallel/mesh.py::process_mesh``), and the forwards'
collectives (``parallel/sharding.py``) run over one process group per mesh
axis (``AxisGroup``).

Two planes:

- the control plane is host bytes: ``broadcast_bytes`` mirrors the
  primary's request events to every rank (the lockstep driver,
  ``engine/multihost_driver.py``). It runs on the default group, gloo over
  TCP, whatever carries the tensors;
- the data plane is the axes' groups. Their backend is chosen from the
  placement, once, when the first mesh over processes is built (only then
  is it known where each rank's shards lie): NCCL when every rank has cards
  of its own, gloo when ranks share a card or run on the CPU. NCCL refuses
  two ranks on one device.

Gloo takes CUDA tensors for some calls only (``GLOO_CUDA_CALLS``, found on
an H100 by ``benchmarks/gloo_probe.py``). For a call it does not take, the
group stages the tensor through host memory, explicitly, for that call on
that backend; nothing catches a failed call and tries another route.

``initialize`` gives the group a timeout, so a rank left in a collective
by a peer that died raises instead of hanging. ``STATS`` counts the calls
and wall seconds of ``broadcast_bytes`` and of the data-plane
collectives, for the per-tick and per-step figures.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time
from typing import Optional, Sequence

import torch

logger = logging.getLogger(__name__)

#: Seconds a rank waits in a collective before it raises.
DEFAULT_TIMEOUT_S = 600.0

#: Which of the data plane's gloo calls take CUDA tensors (True) and which
#: stage them through host memory (False), by call. On an H100 with
#: PyTorch 2.11 (``benchmarks/gloo_probe.py``) gloo's all_gather, all_reduce
#: and broadcast took CUDA tensors in f32 and bf16; its send of a CUDA
#: tensor aborted the process ("gloo::IoException ... writev: Bad
#: address").
GLOO_CUDA_CALLS = {"all_gather": True, "broadcast": True,
                   "send_recv": False}

#: Calls and wall seconds of the control plane (``broadcast``) and of the
#: data plane's collectives (``collective``, with the bytes this rank
#: contributed).
STATS = {"broadcast_calls": 0, "broadcast_s": 0.0, "collective_calls": 0,
         "collective_s": 0.0, "collective_bytes": 0}

_initialized = False
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
_backend: Optional[str] = None
_hosts: Optional[list[str]] = None


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes`` (idempotent). Rank 0 listens on the
    address; a collective that waits longer than ``timeout_s`` raises."""
    global _initialized, _timeout
    if _initialized:
        return
    import torch.distributed as dist

    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout)
    _initialized = True
    logger.info("joined the process group at %s as rank %d of %d",
                coordinator_address, process_id, num_processes)


def initialize_from_env() -> bool:
    """Join from ``XLLM_MH_COORDINATOR`` / ``XLLM_MH_NUM_HOSTS`` /
    ``XLLM_MH_HOST_ID`` (the agent calls this before it touches a device).
    True when a group was (or already is) joined."""
    coord = os.environ.get("XLLM_MH_COORDINATOR", "")
    if not coord:
        return _initialized
    initialize(coord, int(os.environ.get("XLLM_MH_NUM_HOSTS", "1")),
               int(os.environ.get("XLLM_MH_HOST_ID", "0")))
    return True


def process_count() -> int:
    if not _initialized:
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    if not _initialized:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def is_primary() -> bool:
    """The primary owns the request stream (agent registration, HTTP);
    followers mirror its engine events (``engine/multihost_driver.py``)."""
    return process_index() == 0


def broadcast_bytes(payload: Optional[bytes]) -> bytes:
    """The primary's ``payload`` on every rank.

    COLLECTIVE: every rank calls it the same number of times in the same
    order. The length goes first, then the body, which followers receive
    into a buffer of that length (the call needs the same shape on every
    rank). A single process returns the payload itself."""
    if process_count() == 1:
        return payload or b""
    import torch.distributed as dist

    t0 = time.perf_counter()
    primary = is_primary()
    data = (payload or b"") if primary else b""
    n = torch.tensor([len(data)], dtype=torch.int64)
    dist.broadcast(n, src=0)
    size = int(n[0])
    out = b""
    if size:
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
               if primary else torch.empty(size, dtype=torch.uint8))
        dist.broadcast(buf, src=0)
        out = data if primary else buf.numpy().tobytes()
    STATS["broadcast_calls"] += 1
    STATS["broadcast_s"] += time.perf_counter() - t0
    return out


def all_gather_object(obj) -> list:
    """``obj`` of every rank, in rank order, over the control plane."""
    import torch.distributed as dist

    out: list = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def host_slot() -> int:
    """This rank's index among the ranks on its host (ranks in order):
    which of the host's cards a mesh built from a config gives it."""
    global _hosts
    if _hosts is None:
        _hosts = all_gather_object(socket.gethostname())
    me = process_index()
    return sum(h == _hosts[me] for h in _hosts[:me])


def _device_id(d: torch.device) -> str:
    if d.type != "cuda":
        return d.type
    return str(torch.cuda.get_device_properties(d).uuid)


def placement_backend(devices: Sequence[torch.device]) -> str:
    """The data plane's backend for a mesh whose shards this rank places
    on ``devices`` (COLLECTIVE): NCCL when every rank's devices are cards
    and no card is named by two ranks or twice, else gloo. Chosen once, at
    the first mesh over processes, and logged; a later mesh with another
    placement raises."""
    global _backend
    mine = [(socket.gethostname(), _device_id(torch.device(d)))
            for d in devices]
    every = [x for rank in all_gather_object(mine) for x in rank]
    distinct = (all(dev not in ("cpu",) for _, dev in every)
                and len(set(every)) == len(every))
    backend = "nccl" if distinct else "gloo"
    if _backend is None:
        _backend = backend
        logger.info("data-plane backend %s (%d ranks; %s)", backend,
                    process_count(),
                    "every rank on cards of its own" if distinct
                    else "ranks share a device or run on the CPU")
    elif _backend != backend:
        raise ValueError(f"a mesh placed for {backend} after the data "
                         f"plane chose {_backend}")
    return _backend


def backend() -> Optional[str]:
    """The data plane's backend, once a mesh over processes chose it."""
    return _backend


def new_group(ranks: Sequence[int]):
    """A data-plane process group over ``ranks`` (COLLECTIVE: every rank
    creates every group, in the same order)."""
    import torch.distributed as dist

    return dist.new_group(list(ranks), backend=_backend, timeout=_timeout)


class AxisGroup:
    """The ranks along one mesh axis (or plane of axes) through this rank,
    in axis order: ``ranks[i]`` holds the i-th block of the axis's
    coordinates, and this rank is ``ranks[index]``."""

    def __init__(self, ranks: Sequence[int], index: int, group,
                 backend_name: str):
        self.ranks = list(ranks)
        self.index = index
        self.group = group
        self.backend = backend_name

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _staged(self, t: torch.Tensor, call: str) -> bool:
        return (t.is_cuda and self.backend == "gloo"
                and not GLOO_CUDA_CALLS[call])

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t`` of every rank of the group (the same shape and dtype on
        each), in group order, on ``t``'s device."""
        import torch.distributed as dist

        t0 = _start(t, self.backend)
        staged = self._staged(t, "all_gather")
        src = (t.cpu() if staged else t).contiguous()
        outs = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(outs, src, group=self.group)
        if staged:
            outs = [o.to(t.device) for o in outs]
        _count(t, t0)
        return outs

    def broadcast(self, t: torch.Tensor, index: int) -> torch.Tensor:
        """The ``t`` of the group's rank ``index`` on every rank of the
        group (the same shape and dtype on each), on ``t``'s device."""
        import torch.distributed as dist

        t0 = _start(t, self.backend)
        staged = self._staged(t, "broadcast")
        buf = (t.cpu() if staged else t).contiguous()
        dist.broadcast(buf, self.ranks[index], group=self.group)
        if staged:
            buf = buf.to(t.device)
        _count(t, t0)
        return buf

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ring's hop: ``t`` goes to the next rank of the group and
        the previous rank's comes back (same shape and dtype)."""
        import torch.distributed as dist

        t0 = _start(t, self.backend)
        staged = self._staged(t, "send_recv")
        src = (t.cpu() if staged else t).contiguous()
        got = torch.empty_like(src)
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, nxt, group=self.group),
            dist.P2POp(dist.irecv, got, prv, group=self.group)])
        for w in works:
            w.wait()
        if staged:
            got = got.to(t.device)
        _count(t, t0)
        return got


def _start(t: torch.Tensor, backend_name: str) -> float:
    """The clock at a collective's start. Gloo reads a CUDA tensor on the
    host's clock only once the work queued before it is done: that wait
    is the layer's compute, so it is taken first, outside the collective's
    time."""
    if t.is_cuda and backend_name == "gloo":
        torch.cuda.current_stream(t.device).synchronize()
    return time.perf_counter()


def _count(t: torch.Tensor, t0: float) -> None:
    STATS["collective_calls"] += 1
    STATS["collective_s"] += time.perf_counter() - t0
    STATS["collective_bytes"] += t.numel() * t.element_size()


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = type(STATS[k])(0)
