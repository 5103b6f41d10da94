"""Device mesh of the port (its own copy of ``xllm_service_tpu/parallel/
mesh.py``'s configuration and axis names).

Axis vocabulary, the reference's:
- ``data``   — data parallel (replica) axis;
- ``expert`` — expert parallel axis for MoE decode;
- ``pipe``   — pipeline stages;
- ``seq``    — sequence/context parallel axis (ring-attention prefill and
  the KV page pool sharded for decode);
- ``model``  — tensor parallel axis.

The reference runs a mesh from one controller process: ``shard_map`` over
a ``jax.sharding.Mesh`` of local devices. The port does the same with a
small ``DeviceMesh`` of ``torch.device``s: each shard of a sharded tensor
is its own tensor on its mesh device, and the collectives become copies
between devices and reductions on the mesh's first device.

A mesh's devices may repeat (``cuda:0`` four times on a one-card machine,
``cpu`` for the CPU tests): the shards are then separate tensors on one
device and every copy between them is a no-op. Repeated devices are only
ever what the caller named; nothing here makes them up.

A mesh may also span processes (``process_mesh``, after
``parallel/multihost.py::initialize``): process r holds the coordinates
``[r * k, (r + 1) * k)`` in row-major order (k = devices / processes), on
the devices it named for them, and only their shards. ``procs`` then says
which rank holds which coordinate and carries the process group of each
axis that crosses processes (``group``); the ``local_*`` accessors name
this rank's coordinates. On one process they name every coordinate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import torch

AXIS_DATA = "data"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
ALL_AXES = (AXIS_DATA, AXIS_EXPERT, AXIS_PIPE, AXIS_SEQ, AXIS_MODEL)


@dataclass
class MeshConfig:
    data: int = 1
    expert: int = 1
    pipe: int = 1
    seq: int = 1
    model: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.expert, self.pipe, self.seq, self.model)

    def num_devices(self) -> int:
        return math.prod(self.shape)

    @classmethod
    def for_devices(cls, n: int, tp: Optional[int] = None) -> "MeshConfig":
        """The reference's default layout: every device on the model (TP)
        axis unless ``tp`` says otherwise, the rest on ``data``."""
        tp = tp or n
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        return cls(data=n // tp, model=tp)


# The axes (and planes) whose collectives may cross processes: the model
# axis's sums and joins, the expert x model plane's MoE sum, the seq axis's
# merges, gathers and ring, and the pipe axis's hops and broadcast
# (``ops/pipeline.py``).
GROUP_AXES = ((AXIS_MODEL,), (AXIS_EXPERT, AXIS_MODEL), (AXIS_SEQ,),
              (AXIS_PIPE,))


@dataclass(frozen=True)
class ProcessLayout:
    """Which process holds which coordinates of a mesh over processes:
    rank ``rank`` of ``count`` holds ``per_process`` consecutive flat
    coordinates; ``groups`` maps each of ``GROUP_AXES`` to this rank's
    ``multihost.AxisGroup`` along it (None where the axis's line through
    this rank stays inside it)."""
    rank: int
    count: int
    per_process: int
    groups: dict


@dataclass(frozen=True)
class DeviceMesh:
    """``devices`` in row-major order over ``axis_names`` with sizes
    ``sizes`` (the reference's ``Mesh`` device array, flattened). Over
    processes, ``devices[i]`` is the device that coordinate i's owner
    named, and ``procs`` the layout."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    procs: Optional[ProcessLayout] = field(default=None, compare=False,
                                           repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def process_count(self) -> int:
        return self.procs.count if self.procs is not None else 1

    def _block(self) -> range:
        """This process's flat coordinates."""
        if self.procs is None:
            return range(len(self.devices))
        k = self.procs.per_process
        return range(self.procs.rank * k, (self.procs.rank + 1) * k)

    def coords(self, flat: int) -> dict[str, int]:
        """Every axis's index at flat coordinate ``flat``."""
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.sizes)):
            out[name] = flat % size
            flat //= size
        return out

    @property
    def first_device(self) -> torch.device:
        """This process's first device: where its residual stream, logits
        and sampling lie."""
        return self.devices[self._block()[0]]

    def _line(self, axes: Sequence[str], **at: int) -> list[int]:
        """Flat coordinates through this process's first one (with the
        axes named in ``at`` at those indices) that differ from it only
        along ``axes``, in row-major order."""
        base = {**self.coords(self._block()[0]), **at}
        out = []
        for f in range(len(self.devices)):
            c = self.coords(f)
            if all(c[a] == base[a] for a in self.axis_names
                   if a not in axes):
                out.append(f)
        return out

    def local_axis(self, axis: str, **at: int
                   ) -> list[tuple[int, torch.device]]:
        """``(index, device)`` of this process's coordinates along
        ``axis`` (every other axis at this process's first coordinate, or
        at the index ``at`` names): the shards of a tensor sharded over
        ``axis`` that it holds. ``local_axis(AXIS_SEQ, model=m)`` is the
        seq line of model shard m (the page-and-head grid pool)."""
        block = set(self._block())
        return [(self.coords(f)[axis], self.devices[f])
                for f in self._line((axis,), **at) if f in block]

    def local_shards(self) -> list[tuple[tuple[int, int], torch.device]]:
        """``((expert, model), device)`` of this process's coordinates on
        the expert x model plane, row-major: where the shards of a
        parameter tree it holds lie (``parallel/sharding.py``)."""
        block = set(self._block())
        return [((self.coords(f)[AXIS_EXPERT], self.coords(f)[AXIS_MODEL]),
                 self.devices[f])
                for f in self._line((AXIS_EXPERT, AXIS_MODEL))
                if f in block]

    def group(self, *axes: str):
        """This process's ``multihost.AxisGroup`` along ``axes`` (one of
        ``GROUP_AXES``), or None where the collective stays inside the
        process."""
        if self.procs is None:
            return None
        return self.procs.groups[tuple(axes)]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` with every other axis at index 0: the
        shard devices of a tensor sharded over ``axis`` alone."""
        i = self.axis_names.index(axis)
        stride = math.prod(self.sizes[i + 1:])
        return [self.devices[k * stride] for k in range(self.sizes[i])]

    def device_at(self, **coords: int) -> torch.device:
        """The device at the named axis indices, every other axis at 0."""
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            flat = flat * size + coords.get(name, 0)
        return self.devices[flat]

    def shard_devices(self) -> list[torch.device]:
        """The devices of the (expert, model) coordinates, row-major
        (``e * model + m``), every other axis at index 0: where the shards
        of a parameter tree lie (``parallel/sharding.py``)."""
        shape = self.shape
        return [self.device_at(expert=e, model=m)
                for e in range(shape[AXIS_EXPERT])
                for m in range(shape[AXIS_MODEL])]


def build_mesh(config: MeshConfig,
               devices: Sequence[Union[str, torch.device]]) -> DeviceMesh:
    """The mesh of ``config`` over ``devices`` (named by the caller; they
    may repeat). Raises when the count differs from the mesh's size."""
    devs = tuple(torch.device(d) for d in devices)
    if config.num_devices() != len(devs):
        raise ValueError(
            f"mesh {config.shape} needs {config.num_devices()} devices, "
            f"got {len(devs)}")
    return DeviceMesh(devs, ALL_AXES, config.shape)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[axis]


def process_mesh(config: MeshConfig,
                 devices: Sequence[Union[str, torch.device]]) -> DeviceMesh:
    """The mesh of ``config`` over every process of the joined group, this
    rank's coordinates on ``devices`` (named by the caller; they may
    repeat, and other ranks may name the same ones). COLLECTIVE: every rank
    calls it at the same point. It exchanges the ranks' device names,
    chooses the data plane's backend from the placement
    (``multihost.placement_backend``) and creates the process group of each
    of ``GROUP_AXES`` that crosses processes. Raises when the mesh does not
    divide over the processes, or when a rank's lines along an axis would
    need different groups."""
    from . import multihost

    n, rank = multihost.process_count(), multihost.process_index()
    local = [torch.device(d) for d in devices]
    if config.num_devices() != n * len(local):
        raise ValueError(f"mesh {config.shape} needs {config.num_devices()} "
                         f"devices; {n} processes name {len(local)} each")
    names = multihost.all_gather_object([str(d) for d in local])
    backend = multihost.placement_backend(local)
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    flat = DeviceMesh(tuple(torch.device(x) for r in names for x in r),
                      ALL_AXES, config.shape)
    k = len(local)
    groups = {}
    for axes in GROUP_AXES:
        lines: dict[tuple, list[int]] = {}
        for f in range(len(flat.devices)):
            c = flat.coords(f)
            key = tuple(c[a] for a in ALL_AXES if a not in axes)
            owners = lines.setdefault(key, [])
            if f // k not in owners:
                owners.append(f // k)
        mine = None
        for owners in dict.fromkeys(tuple(o) for o in lines.values()):
            if len(owners) < 2:
                continue
            pg = multihost.new_group(owners)
            if rank in owners:
                if mine is not None and mine.ranks != list(owners):
                    raise ValueError(f"rank {rank} lies on two {axes} "
                                     "groups; give each process whole "
                                     "lines of that axis")
                mine = multihost.AxisGroup(owners, owners.index(rank), pg,
                                           backend)
        groups[axes] = mine
    return DeviceMesh(flat.devices, ALL_AXES, config.shape,
                      ProcessLayout(rank, n, k, groups))


def mesh_from_config(config: MeshConfig, device: torch.device,
                     offset: int = 0) -> DeviceMesh:
    """The mesh an engine builds from ``EngineConfig.mesh``: distinct
    devices of ``device``'s type, ``config.num_devices()`` of them starting
    at index ``offset`` (the reference's ``mesh_device_offset``). Raises
    when the machine has fewer (the CPU counts as one device).

    In a joined group of several processes the mesh spans them
    (``process_mesh``): each rank takes its share of the coordinates on
    distinct cards of its host, from ``offset`` past the shares of the
    ranks before it on that host, and raises when the host has too few.
    On the CPU each rank names ``cpu`` for its coordinates."""
    from . import multihost

    need = config.num_devices()
    n = multihost.process_count()
    if n > 1:
        if need % n:
            raise ValueError(f"mesh {config.shape} of {need} devices does "
                             f"not divide over {n} processes")
        k = need // n
        if device.type != "cuda":
            return process_mesh(config, [device] * k)
        first = offset + multihost.host_slot() * k
        available = torch.cuda.device_count()
        if offset < 0 or first + k > available:
            raise ValueError(f"this rank's share of the mesh needs devices "
                             f"[{first}:{first + k}) but only {available} "
                             "are attached")
        return process_mesh(config, [torch.device("cuda", first + i)
                                     for i in range(k)])
    available = torch.cuda.device_count() if device.type == "cuda" else 1
    if offset < 0 or offset + need > available:
        raise ValueError(f"mesh needs devices [{offset}:{offset + need}) "
                         f"but only {available} are attached")
    if device.type == "cuda":
        return build_mesh(config, [torch.device("cuda", offset + i)
                                   for i in range(need)])
    return build_mesh(config, [device] * need)
