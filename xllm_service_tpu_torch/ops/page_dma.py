"""KV page movers of the tiered cache: kernels 4 and 5 of the port.

Replace the TPU kernels
``xllm_service_tpu/ops/pallas_page_dma.py::gather_kv_pages`` and
``::scatter_kv_pages`` with the hand-written CUDA kernel
``csrc/page_dma.cu`` (built by ``ops/_build.py``). The pool is
``[L, 2, P, n_kv, ps, hd]``; a block buffer is ``[L, 2, n, n_kv, ps, hd]``
for ``n`` page ids. Gather copies the pages out into a NEW block (the pool
is untouched, so the engine can download the block off-thread while later
kernels recycle the pages); scatter writes a block back into the pool.

Bound on the H100: the bytes moved. One Llama-3-8B hash block (8 pages,
``[32, 2, 8, 8, 16, 128]`` bf16) is 16 MiB each way, 33.6 MB in all, about
10 us at 3.35 TB/s. Times beside that bound are in PERF.md (measured by
``chip_smoke.py``).

Page ids come from the host (the engine's page manager built them), as a
sequence of ints or a CPU tensor; the wrappers check them against P there,
with no device sync, and upload them with the launch. For a CPU pool the
wrappers compute the plain versions; for a CUDA pool they launch the kernel
on the current stream, or raise. ``gather_kv_pages.launches`` and
``scatter_kv_pages.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from . import _build

PageIds = Union[Sequence[int], torch.Tensor]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def gather_kv_pages_plain(kv: torch.Tensor, page_ids: PageIds
                          ) -> torch.Tensor:
    """Plain version of the gather: ``kv[:, :, ids]`` (a new tensor)."""
    return kv[:, :, torch.as_tensor(page_ids, device=kv.device).long()]


def scatter_kv_pages_plain(kv: torch.Tensor, page_ids: PageIds,
                           block: torch.Tensor) -> torch.Tensor:
    """Plain version of the scatter: ``kv[:, :, ids] = block`` in place,
    block cast to the pool's dtype. Returns ``kv``."""
    kv[:, :, torch.as_tensor(page_ids, device=kv.device).long()] = \
        block.to(kv.dtype)
    return kv


def _host_ids(name: str, page_ids: PageIds, P: int,
              unique: bool = False) -> torch.Tensor:
    """The ids as a CPU int32 tensor, each checked to lie in [0, P) (and,
    for a scatter, to be distinct). Raises on anything else."""
    if isinstance(page_ids, torch.Tensor) and page_ids.device.type != "cpu":
        raise ValueError(f"{name}: page ids must be on the host (got "
                         f"{page_ids.device})")
    ids = torch.as_tensor(page_ids, dtype=torch.int64).reshape(-1)
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= P):
        raise IndexError(f"{name}: page ids outside [0, {P})")
    if unique and ids.unique().numel() != ids.numel():
        raise ValueError(f"{name}: repeated page ids")
    return ids.to(torch.int32)


def _check_pool(name: str, kv: torch.Tensor) -> None:
    if kv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {kv.device}")
    if kv.dim() != 6 or kv.shape[1] != 2:
        raise ValueError(f"{name}: pool shape {tuple(kv.shape)} is not "
                         "[L, 2, P, n_kv, ps, hd]")
    if not kv.is_contiguous():
        raise ValueError(f"{name}: the pool must be contiguous")


def _launch(name: str, kv: torch.Tensor, block: torch.Tensor,
            ids: torch.Tensor, to_pool: int) -> None:
    L, _, P = kv.shape[:3]
    n = ids.numel()
    ids_dev = ids.to(kv.device, non_blocking=True)
    row_bytes = kv[0, 0, 0].numel() * kv.element_size()
    launch = _build.kernel_fn("page_dma", "page_dma_launch", _ARGTYPES)
    err = launch(kv.data_ptr(), block.data_ptr(), ids_dev.data_ptr(),
                 L * 2, n, P, row_bytes, to_pool,
                 torch.cuda.current_stream(kv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def gather_kv_pages(kv: torch.Tensor, page_ids: PageIds) -> torch.Tensor:
    """kv: [L, 2, P, n_kv, ps, hd]; page_ids: n host ids ->
    [L, 2, n, n_kv, ps, hd], a new tensor."""
    ids = _host_ids("gather_kv_pages", page_ids, kv.shape[2])
    if kv.device.type == "cpu":
        return gather_kv_pages_plain(kv, ids)
    _check_pool("gather_kv_pages", kv)
    out = torch.empty((kv.shape[0], 2, ids.numel(), *kv.shape[3:]),
                      dtype=kv.dtype, device=kv.device)
    if out.numel():
        _launch("gather_kv_pages", kv, out, ids, 0)
        gather_kv_pages.launches += 1
    return out


def scatter_kv_pages(kv: torch.Tensor, page_ids: PageIds,
                     block: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`gather_kv_pages`: write ``block``
    [L, 2, n, n_kv, ps, hd] into the pool at ``page_ids``, IN PLACE (the
    reference returns a new pool that its engine donates; here the pool is
    updated where it lies), and return the pool. The block is cast to the
    pool's dtype first, as the reference does; on a CUDA pool it must
    already be on the pool's device. The ids must be distinct."""
    ids = _host_ids("scatter_kv_pages", page_ids, kv.shape[2], unique=True)
    want = (kv.shape[0], 2, ids.numel(), *kv.shape[3:])
    if tuple(block.shape) != want:
        raise ValueError(f"scatter_kv_pages: block shape "
                         f"{tuple(block.shape)}, expected {want}")
    if kv.device.type == "cpu":
        return scatter_kv_pages_plain(kv, ids, block)
    _check_pool("scatter_kv_pages", kv)
    if block.device != kv.device:
        raise ValueError(f"scatter_kv_pages: block on {block.device}, pool "
                         f"on {kv.device}")
    block = block.to(kv.dtype).contiguous()
    if block.numel():
        _launch("scatter_kv_pages", kv, block, ids, 1)
        scatter_kv_pages.launches += 1
    return kv


gather_kv_pages.launches = 0
scatter_kv_pages.launches = 0
