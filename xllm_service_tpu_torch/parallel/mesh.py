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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Union

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


@dataclass(frozen=True)
class DeviceMesh:
    """``devices`` in row-major order over ``axis_names`` with sizes
    ``sizes`` (the reference's ``Mesh`` device array, flattened)."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` with every other axis at index 0: the
        shard devices of a tensor sharded over ``axis`` alone."""
        i = self.axis_names.index(axis)
        stride = math.prod(self.sizes[i + 1:])
        return [self.devices[k * stride] for k in range(self.sizes[i])]


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


def mesh_from_config(config: MeshConfig, device: torch.device,
                     offset: int = 0) -> DeviceMesh:
    """The mesh an engine builds from ``EngineConfig.mesh``: distinct
    devices of ``device``'s type, ``config.num_devices()`` of them starting
    at index ``offset`` (the reference's ``mesh_device_offset``). Raises
    when the machine has fewer (the CPU counts as one device)."""
    need = config.num_devices()
    available = torch.cuda.device_count() if device.type == "cuda" else 1
    if offset < 0 or offset + need > available:
        raise ValueError(f"mesh needs devices [{offset}:{offset + need}) "
                         f"but only {available} are attached")
    if device.type == "cuda":
        return build_mesh(config, [torch.device("cuda", offset + i)
                                   for i in range(need)])
    return build_mesh(config, [device] * need)
