"""KV page movers of the tiered cache: kernels 4 and 5 of the port.

Replace the TPU kernels
``xllm_service_tpu/ops/pallas_page_dma.py::gather_kv_pages`` and
``::scatter_kv_pages`` with the hand-written CUDA kernel
``csrc/page_dma.cu`` (built by ``ops/_build.py``). The pool is
``[L, 2, P, n_kv, ps, hd]``, as one tensor, as a ``ShardedPages`` (the
pool of a seq mesh: shard ``d`` holds global pages ``[d * P_loc, (d + 1) *
P_loc)``) or as a ``ModelShardedPages`` (the pool of a model axis: shard
``m`` holds its KV heads of every page, or the whole pool where the heads
do not divide); a block buffer is ``[L, 2, n, n_kv, ps, hd]`` for ``n``
page ids. Over a head-sharded pool each mover launches once per shard,
on the shard's part of the block (``gather_kv_shards``); the block is the
shards' parts joined on the head axis on the first device, the
reference's layout, which the tiers and the host handoff paths keep. On
the page-and-head grid (a ``ModelShardedPages`` whose model shards are
``ShardedPages``, a mesh with ``seq`` and ``model`` above 1) a model
shard's part is moved over its seq shards by one launch a device, so a
grid shard's block is that model shard's heads of the block's pages.
Gather copies the pages out into a NEW block on the pool's first
device (the pool is untouched, so the engine can download the block
off-thread while later kernels recycle the pages); scatter writes a block
back into the pool.

Bound on the H100: the bytes moved. One Llama-3-8B hash block (8 pages,
``[32, 2, 8, 8, 16, 128]`` bf16) is 16 MiB each way, 33.6 MB in all, about
10 us at 3.35 TB/s. Times beside that bound are in PERF.md (measured by
``chip_smoke.py``).

Page ids are global and come from the host (the engine's page manager
built them), as a sequence of ints or a CPU tensor; the wrappers check them
against P there, with no device sync. ``launch_plan`` turns them into
launches: one per device that holds pages of the block (at most
``MAX_SHARDS`` shards and the kernel's slot limit each), its shards' base
pointers and a table of (shard, local page, block slot) passed to the
kernel by value. So on one card a call is one launch, sharded pool or not.
Shards on another device than the block's: the gather fills their pages
into a buffer there and copies it over; the scatter copies their slots of
the block there and launches there, on that device's current stream.

For a CPU pool the wrappers compute the plain versions; for a CUDA pool
they launch the kernel on the current stream, or raise.
``gather_kv_pages.launches`` and ``scatter_kv_pages.launches`` count the
launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Union

import torch

from . import _build
from ..parallel.sharding import HEAD_DIM, ModelShardedPages, ShardedBlock
from .cp_paged_attention import ShardedPages
from .paged_attention import sm_count

PageIds = Union[Sequence[int], torch.Tensor]
Pool = Union[torch.Tensor, ShardedPages, ModelShardedPages]

# The bulk route's shape: chunks of CHUNK_BYTES through a ring of STAGES
# stages, BLOCKS_PER_SM blocks on each SM (the fastest of chip_smoke.py's
# sweep; PERF.md).
STAGES = 8
CHUNK_BYTES = 16 << 10
BLOCKS_PER_SM = 1
MAX_SHARDS = 8            # shard base pointers a launch takes
MAX_SLOTS = 256           # table entries (pages) a launch takes

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + \
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _shards(kv: Pool) -> tuple[list[torch.Tensor], int]:
    """The pool's shard tensors and the pages each holds."""
    if isinstance(kv, ShardedPages):
        return kv.shards, kv.pages_per_shard
    return [kv], kv.shape[2]


# ------------------------------------------------------------- plain versions
def gather_kv_pages_plain(kv: Pool, page_ids: PageIds) -> torch.Tensor:
    """Plain version of the gather: ``kv[:, :, ids]`` (a new tensor; for a
    sharded pool each shard's pages, assembled on the first device)."""
    if isinstance(kv, ModelShardedPages):
        return kv.join([gather_kv_pages_plain(kv.shards[i], page_ids)
                        for i in (kv.distinct()[:1] if kv.replicated
                                  else range(len(kv.shards)))])
    if not isinstance(kv, ShardedPages):
        return kv[:, :, torch.as_tensor(page_ids, device=kv.device).long()]
    shards, P_loc = _shards(kv)
    ids = torch.as_tensor(page_ids).long().reshape(-1).cpu()
    first = shards[0]
    out = torch.empty((*first.shape[:2], ids.numel(), *first.shape[3:]),
                      dtype=first.dtype, device=first.device)
    for d, shard in enumerate(shards):
        pos = ((ids // P_loc) == d).nonzero().reshape(-1)
        if pos.numel():
            rows = shard[:, :, (ids[pos] - d * P_loc).to(shard.device)]
            out[:, :, pos.to(first.device)] = rows.to(first.device)
    return out


def scatter_kv_pages_plain(kv: Pool, page_ids: PageIds,
                           block: torch.Tensor) -> Pool:
    """Plain version of the scatter: ``kv[:, :, ids] = block`` in place,
    block cast to the pool's dtype (each shard takes the slots of the pages
    it owns). Returns ``kv``."""
    if not isinstance(kv, ShardedPages):
        kv[:, :, torch.as_tensor(page_ids, device=kv.device).long()] = \
            block.to(kv.dtype)
        return kv
    shards, P_loc = _shards(kv)
    ids = torch.as_tensor(page_ids).long().reshape(-1).cpu()
    for d, shard in enumerate(shards):
        pos = ((ids // P_loc) == d).nonzero().reshape(-1)
        if pos.numel():
            rows = block[:, :, pos.to(block.device)]
            shard[:, :, (ids[pos] - d * P_loc).to(shard.device)] = \
                rows.to(shard.device, shard.dtype)
    return kv


# --------------------------------------------------------------- the plan
@dataclass(frozen=True)
class Launch:
    """One kernel launch of a mover: on ``device``, over the pool shards
    ``shards`` (indices into the pool's shard list), with one table entry
    per page it moves: ``owner[j]`` the index in ``shards`` of the shard
    that holds the page, ``local[j]`` the page within that shard and
    ``slots[j]`` its slot in the block."""
    device: torch.device
    shards: tuple[int, ...]
    owner: tuple[int, ...]
    local: tuple[int, ...]
    slots: tuple[int, ...]


def launch_plan(ids: Sequence[int], pages_per_shard: int,
                devices: Sequence[torch.device], max_slots: int = MAX_SLOTS,
                max_shards: int = MAX_SHARDS) -> list[Launch]:
    """The launches that move the pages ``ids`` (global, in block slot
    order) of a pool whose shard ``d`` holds ``pages_per_shard`` pages on
    ``devices[d]``. The shards are grouped by device, the first device (the
    block's) first; each device with pages of the block gets one launch,
    split only where it would exceed ``max_slots`` entries or
    ``max_shards`` shards."""
    groups: dict[torch.device, list[tuple[int, int, int]]] = {}
    for dev in devices:
        groups.setdefault(torch.device(dev), [])
    for i, p in enumerate(ids):
        d, local = divmod(int(p), pages_per_shard)
        groups[torch.device(devices[d])].append((i, d, local))
    plan = []
    for dev, entries in groups.items():
        start = 0
        while start < len(entries):
            shards: list[int] = []
            end = start
            while end < len(entries) and end - start < max_slots:
                d = entries[end][1]
                if d not in shards:
                    if len(shards) == max_shards:
                        break
                    shards.append(d)
                end += 1
            part = entries[start:end]
            plan.append(Launch(dev, tuple(shards),
                               tuple(shards.index(d) for _, d, _ in part),
                               tuple(local for *_, local in part),
                               tuple(i for i, *_ in part)))
            start = end
    return plan


# --------------------------------------------------------------- wrappers
def _host_ids(name: str, page_ids: PageIds, P: int,
              unique: bool = False) -> torch.Tensor:
    """The ids as a CPU int64 tensor, each checked to lie in [0, P) (and,
    for a scatter, to be distinct). Raises on anything else."""
    if isinstance(page_ids, torch.Tensor) and page_ids.device.type != "cpu":
        raise ValueError(f"{name}: page ids must be on the host (got "
                         f"{page_ids.device})")
    ids = torch.as_tensor(page_ids, dtype=torch.int64).reshape(-1)
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= P):
        raise IndexError(f"{name}: page ids outside [0, {P})")
    if unique and ids.unique().numel() != ids.numel():
        raise ValueError(f"{name}: repeated page ids")
    return ids


def _check_pool(name: str, shards: list[torch.Tensor]) -> None:
    for kv in shards:
        if kv.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {kv.device}")
        if kv.dim() != 6 or kv.shape[1] != 2:
            raise ValueError(f"{name}: pool shape {tuple(kv.shape)} is not "
                             "[L, 2, P, n_kv, ps, hd]")
        if not kv.is_contiguous():
            raise ValueError(f"{name}: the pool must be contiguous")
        if kv.shape != shards[0].shape or kv.dtype != shards[0].dtype:
            raise ValueError(f"{name}: shards differ in shape or dtype")


def _launch(name: str, shards: list[torch.Tensor], launch: Launch,
            block: torch.Tensor, slots: Sequence[int], to_pool: int) -> None:
    """One launch of ``launch``'s table with block slots ``slots``, on the
    current stream of its device."""
    first = shards[launch.shards[0]]
    m = len(slots)
    ints = ctypes.c_int * m
    ptrs = (ctypes.c_void_p * len(launch.shards))(
        *(shards[d].data_ptr() for d in launch.shards))
    fn = _build.kernel_fn("page_dma", "page_dma_launch", _ARGTYPES)
    with torch.cuda.device(launch.device):
        err = fn(ptrs, len(launch.shards), block.data_ptr(),
                 ints(*launch.owner), ints(*launch.local), ints(*slots), m,
                 block.shape[2], first.shape[0] * 2, first.shape[2],
                 first[0, 0, 0].numel() * first.element_size(), to_pool,
                 STAGES, CHUNK_BYTES, BLOCKS_PER_SM, sm_count(launch.device),
                 torch.cuda.current_stream(launch.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def gather_kv_shards(kv: ModelShardedPages,
                     page_ids: PageIds) -> list[torch.Tensor]:
    """The gather of a head-sharded pool as each shard's part
    ``[L, 2, n, n_kv / n_shards, ps, hd]`` on its device (one launch a
    shard; one part, the whole block, for a replicated pool): what the
    device handoff path offers, one buffer a shard."""
    if kv.replicated:
        return [gather_kv_pages(kv.shards[0], page_ids)]
    return [gather_kv_pages(s, page_ids) for s in kv.shards]


def gather_kv_pages(kv: Pool, page_ids: PageIds) -> torch.Tensor:
    """kv: [L, 2, P, n_kv, ps, hd] (one tensor or sharded); page_ids: n
    global host ids -> [L, 2, n, n_kv, ps, hd], a new tensor on the pool's
    first device."""
    if isinstance(kv, ModelShardedPages):
        return kv.join(gather_kv_shards(kv, page_ids))
    ids = _host_ids("gather_kv_pages", page_ids, kv.shape[2])
    shards, P_loc = _shards(kv)
    if shards[0].device.type == "cpu":
        return gather_kv_pages_plain(kv, ids)
    _check_pool("gather_kv_pages", shards)
    home = shards[0].device
    shape = (shards[0].shape[0], 2, ids.numel(), *shards[0].shape[3:])
    out = torch.empty(shape, dtype=shards[0].dtype, device=home)
    if not out.numel():
        return out
    for launch in launch_plan(ids.tolist(), P_loc,
                              [s.device for s in shards]):
        if launch.device == home:
            _launch("gather_kv_pages", shards, launch, out, launch.slots, 0)
        else:
            m = len(launch.slots)
            buf = torch.empty((*shape[:2], m, *shape[3:]), dtype=out.dtype,
                              device=launch.device)
            _launch("gather_kv_pages", shards, launch, buf, range(m), 0)
            for j, i in enumerate(launch.slots):
                out[:, :, i].copy_(buf[:, :, j])
        _build.count_launch(gather_kv_pages)
    return out


def scatter_kv_pages(kv: Pool, page_ids: PageIds,
                     block: Union[torch.Tensor, ShardedBlock]) -> Pool:
    """Inverse of :func:`gather_kv_pages`: write ``block``
    [L, 2, n, n_kv, ps, hd] into the pool at ``page_ids``, IN PLACE (the
    reference returns a new pool that its engine donates; here the pool is
    updated where it lies), and return the pool. The block is cast to the
    pool's dtype first, as the reference does; on a CUDA pool it must
    already be on the pool's first device. The ids must be distinct.

    For a head-sharded pool ``block`` may also be a ``ShardedBlock`` of
    as many parts (``gather_kv_shards``' layout); a canonical block is
    split on the head axis (given whole to each copy of a replicated
    pool), and each shard takes its part, one launch a shard. A
    ``ShardedBlock`` for any other pool is joined first."""
    if isinstance(block, ShardedBlock) and not (
            isinstance(kv, ModelShardedPages) and not kv.replicated
            and len(block.parts) == len(kv.shards)):
        block = block.join()
    if isinstance(kv, ModelShardedPages):
        if isinstance(block, ShardedBlock):
            parts = block.parts
        else:
            if block.shape[HEAD_DIM] != kv.shape[HEAD_DIM]:
                raise ValueError(f"scatter_kv_pages: block shape "
                                 f"{tuple(block.shape)} for a pool of "
                                 f"{tuple(kv.shape)}")
            parts = kv.split(block)
        for i in kv.distinct():
            shard = kv.shards[i]
            scatter_kv_pages(shard, page_ids, parts[i].to(shard.device))
        return kv
    ids = _host_ids("scatter_kv_pages", page_ids, kv.shape[2], unique=True)
    shards, P_loc = _shards(kv)
    want = (shards[0].shape[0], 2, ids.numel(), *shards[0].shape[3:])
    if tuple(block.shape) != want:
        raise ValueError(f"scatter_kv_pages: block shape "
                         f"{tuple(block.shape)}, expected {want}")
    if shards[0].device.type == "cpu":
        return scatter_kv_pages_plain(kv, ids, block)
    _check_pool("scatter_kv_pages", shards)
    home = shards[0].device
    if block.device != home:
        raise ValueError(f"scatter_kv_pages: block on {block.device}, pool "
                         f"on {home}")
    if not block.numel():
        return kv
    block = block.to(shards[0].dtype).contiguous()
    for launch in launch_plan(ids.tolist(), P_loc,
                              [s.device for s in shards]):
        if launch.device == home:
            _launch("scatter_kv_pages", shards, launch, block, launch.slots,
                    1)
        else:
            part = block[:, :, list(launch.slots)].to(launch.device)
            _launch("scatter_kv_pages", shards, launch, part,
                    range(len(launch.slots)), 1)
        _build.count_launch(scatter_kv_pages)
    return kv


gather_kv_pages.launches = 0
scatter_kv_pages.launches = 0
