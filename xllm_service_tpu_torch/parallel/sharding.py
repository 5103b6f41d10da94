"""Parameter and KV-pool sharding over a mesh's ``expert`` and ``model``
axes (port of ``xllm_service_tpu/parallel/sharding.py``), and the
collectives of the one-process mesh.

Rules map parameter-path regexes to specs over the named mesh axes, the
first match winning, as the reference's. A spec is a tuple with one entry
per leading dim of the leaf: an axis name (the dim is split over that
axis), a tuple of axis names (split over their product) or ``None``
(whole); dims past its end are whole, and the empty spec replicates.

The reference annotates layouts and lets XLA insert the collectives. Here
``shard_params`` cuts every leaf into its shard for each (expert, model)
coordinate of the mesh, on that coordinate's device
(``DeviceMesh.local_shards``), and the forwards (``models/llama.py``,
``models/deepseek_moe.py``) run each shard's part and combine the parts
with the named collectives below: a sum (after a row-parallel product) or
a concatenation (the vocabulary-sharded logits) on the mesh's first
device, copied to a shard's device where the next part needs it. On a mesh
whose devices repeat (``cuda:0`` eight times on a one-card machine, ``cpu``
in the tests) the shards are views of the tree they were cut from, so
together they take that tree's memory, and every copy between them is a
no-op. The ``data`` and ``pipe`` axes replicate: the port computes once
where the reference computes the same values on each replica.

On a mesh over processes (``parallel/mesh.py::process_mesh``) each rank
cuts only its own coordinates' shards, as contiguous copies (the tree it
cut them from can be freed), and the collectives take the axis's process
group: the rank's parts, then every other rank's, gathered in shard order
(``AxisGroup.all_gather``), so a sum adds them in the one-process order
and every rank ends with the same bits.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import torch

from .mesh import AXIS_EXPERT, AXIS_MODEL, DeviceMesh

Spec = tuple


@dataclass
class ShardingRules:
    """Ordered (path regex, spec) table; the first match wins."""

    rules: list[tuple[str, Spec]]
    default: Spec = ()

    def spec_for(self, path: str) -> Spec:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return spec
        return self.default


# The KV pool [L, 2, P, n_kv, ps, hd]: KV heads on `model`, pages whole
# (the reference's spec; ``ModelShardedPages`` splits that dim).
KV_PAGES_SPEC = (None, None, None, AXIS_MODEL, None, None)
HEAD_DIM = KV_PAGES_SPEC.index(AXIS_MODEL)


# ------------------------------------------------------------ collectives
def broadcast(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> list[torch.Tensor]:
    """``x`` on each of ``devices``: ``x`` itself where it lies there, one
    copy per other device."""
    copies: dict[torch.device, torch.Tensor] = {x.device: x}
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d)
    return [copies[d] for d in devices]


def all_parts(parts: Sequence[torch.Tensor], device: torch.device,
              group=None) -> list[torch.Tensor]:
    """``parts`` on ``device``; with a process ``group``
    (``multihost.AxisGroup``) every rank's parts, in group order, each
    rank's in its own order: the parts of every shard of the axis, in
    shard order, on every rank (one gather of the stacked parts)."""
    parts = [p.to(device) for p in parts]
    if group is None:
        return parts
    return [q for r in group.all_gather(torch.stack(parts))
            for q in r.unbind(0)]


def all_reduce(parts: Sequence[torch.Tensor],
               device: Optional[torch.device] = None,
               group=None) -> torch.Tensor:
    """The sum of ``parts`` on ``device`` (the first part's by default),
    added in shard order in the parts' dtype, over every rank of
    ``group`` where one is given. One part is returned as it is."""
    device = parts[0].device if device is None else device
    parts = all_parts(parts, device, group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device: Optional[torch.device] = None,
               group=None) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device`` (the first
    part's by default), every rank's of ``group`` in shard order where one
    is given. One part is returned as it is."""
    device = parts[0].device if device is None else device
    parts = all_parts(parts, device, group)
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=dim)


# ------------------------------------------------------------ parameters
@dataclass
class ShardedParams:
    """A parameter tree over a mesh's expert and model axes: ``trees[i]``
    is the tree of coordinate ``coords[i]`` = (e, m), in the unsharded
    tree's layout with every leaf cut to its shard, on ``devices[i]``. On
    one process it holds every coordinate, row-major (``trees[e * model +
    m]``); over processes only this rank's. A leaf replicated over an axis
    is the same tensor in every tree on one device. ``expert`` and
    ``model`` are the axes' sizes. The forwards dispatch on this type; an
    unsharded tree stays a plain dict."""

    trees: list[dict]
    devices: list[torch.device]
    mesh: DeviceMesh
    coords: Optional[list[tuple[int, int]]] = None
    expert: int = field(init=False)
    model: int = field(init=False)

    def __post_init__(self) -> None:
        self.expert = self.mesh.shape[AXIS_EXPERT]
        self.model = self.mesh.shape[AXIS_MODEL]
        if self.coords is None:
            self.coords = [(e, m) for e in range(self.expert)
                           for m in range(self.model)]

    def tree(self, e: int = 0, m: int = 0) -> dict:
        return self.trees[self.coords.index((e, m))]

    def _model_line(self) -> list[int]:
        e0 = self.coords[0][0]
        return [i for i, (e, _) in enumerate(self.coords) if e == e0]

    @property
    def model_trees(self) -> list[dict]:
        """The trees of the model axis at this rank's first expert index
        (the attention, dense MLP and vocabulary shards; expert index 0 on
        one process)."""
        return [self.trees[i] for i in self._model_line()]

    @property
    def model_devices(self) -> list[torch.device]:
        return [self.devices[i] for i in self._model_line()]

    @property
    def model_indices(self) -> list[int]:
        """The model-axis index of each of ``model_trees``."""
        return [self.coords[i][1] for i in self._model_line()]

    def group(self, *axes: str):
        """The process group of ``axes`` (``DeviceMesh.group``)."""
        return self.mesh.group(*axes)


def _shard_index(spec: Spec, shape: Sequence[int], coord: dict[str, int],
                 sizes: dict[str, int], path: str
                 ) -> tuple[tuple, tuple[int, ...]]:
    """The index of ``coord``'s shard of a leaf of ``shape`` under
    ``spec``, and the shard's key (its index along every split dim)."""
    if len(spec) > len(shape):
        raise ValueError(f"{path}: spec {spec} has more dims than the leaf "
                         f"{tuple(shape)}")
    index, key = [], []
    for d, axes in enumerate(spec):
        if axes is None:
            index.append(slice(None))
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        n = math.prod(sizes.get(a, 1) for a in names)
        i = 0
        for a in names:
            i = i * sizes.get(a, 1) + coord.get(a, 0)
        if shape[d] % n:
            raise ValueError(f"{path}: dim {d} of {tuple(shape)} does not "
                             f"divide over {names} ({n} shards)")
        step = shape[d] // n
        index.append(slice(i * step, (i + 1) * step))
        key.append(i)
    return tuple(index), tuple(key)


def shard_params(params: dict, mesh: DeviceMesh,
                 rules: ShardingRules, convert=None) -> ShardedParams:
    """``params`` cut by ``rules`` over ``mesh``'s expert and model axes:
    each leaf's shard for each (expert, model) coordinate this process
    holds (every one on one process), on that coordinate's device. On one
    process, where every coordinate's device is the leaf's own (a repeated
    device), a shard is a view of the leaf, so the shards together take
    the leaf's memory; elsewhere, and always over processes, it is a
    contiguous copy on its device, and the leaf can be freed. A leaf
    replicated over an axis is held once per device. Raises where a split
    dim does not divide. ``convert`` (a leaf of ``params`` to its tensor)
    is applied to one leaf at a time, just before it is cut: a tree of
    host arrays then never exists whole as tensors."""
    local = mesh.local_shards()
    devices = [d for _, d in local]
    sizes = {AXIS_EXPERT: mesh.shape[AXIS_EXPERT],
             AXIS_MODEL: mesh.shape[AXIS_MODEL]}
    coords = [{AXIS_EXPERT: e, AXIS_MODEL: m} for (e, m), _ in local]
    one_process = mesh.process_count == 1

    def leaf_shards(leaf: torch.Tensor, path: str) -> list[torch.Tensor]:
        spec = rules.spec_for(path)
        views = one_process and all(d == leaf.device for d in devices)
        held: dict[tuple, torch.Tensor] = {}
        out = []
        for coord, dev in zip(coords, devices):
            index, key = _shard_index(spec, leaf.shape, coord, sizes, path)
            if (key, dev) not in held:
                piece = leaf[index] if key else leaf
                if not views:
                    piece = piece.to(dev, copy=True).contiguous()
                held[(key, dev)] = piece
            out.append(held[(key, dev)])
        return out

    def walk(node: dict, prefix: str) -> list[dict]:
        outs: list[dict] = [{} for _ in coords]
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            parts = walk(v, path) if isinstance(v, dict) \
                else leaf_shards(v if convert is None else convert(v), path)
            for o, p in zip(outs, parts):
                o[k] = p
        return outs

    return ShardedParams(walk(params, ""), devices, mesh,
                         [(e, m) for (e, m), _ in local])


def replicated_tree(params: Union[dict, ShardedParams]) -> dict:
    """This process's first tree (coordinate (0, 0) on one process):
    ``params`` itself when unsharded. Its replicated leaves (the vision
    tower, the norms, the router) are whole."""
    return params.trees[0] if isinstance(params, ShardedParams) else params


# ------------------------------------------------------------------ pool
class ModelShardedPages:
    """The KV pool ``[L, 2, P, n_kv, ps, hd]`` over a mesh's model axis
    (the reference's ``KV_PAGES_SPEC``): ``shards[i]`` is ``[L, 2, P,
    n_kv / n, ps, hd]``, the KV heads of model shard ``index[i]``, on that
    coordinate's device (every shard on one process, this rank's over
    processes). Where ``n_kv`` does not divide over the axis (MLA's one
    latent head) the pool is replicated: every shard is the whole pool,
    held once per distinct device (``replicated``), and a write goes to
    each copy. ``shape`` is the global shape."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: DeviceMesh,
                 replicated: bool, index: Optional[Sequence[int]] = None):
        self.shards = list(shards)
        self.mesh = mesh
        self.replicated = replicated
        self.index = (list(range(len(self.shards))) if index is None
                      else list(index))
        self.count = mesh.shape[AXIS_MODEL]
        self.group = mesh.group(AXIS_MODEL)

    @classmethod
    def zeros(cls, shape: Sequence[int], dtype: torch.dtype,
              mesh: DeviceMesh) -> "ModelShardedPages":
        local = mesh.local_axis(AXIS_MODEL)
        shape = list(shape)
        n = mesh.shape[AXIS_MODEL]
        replicated = shape[HEAD_DIM] % n != 0
        if replicated:
            held: dict[torch.device, torch.Tensor] = {}
            shards = [held.setdefault(d, torch.zeros(shape, dtype=dtype,
                                                     device=d))
                      for _, d in local]
        else:
            shape[HEAD_DIM] //= n
            shards = [torch.zeros(shape, dtype=dtype, device=d)
                      for _, d in local]
        return cls(shards, mesh, replicated, [i for i, _ in local])

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        if not self.replicated:
            s[HEAD_DIM] *= self.count
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """This process's first shard's device, where blocks are
        assembled."""
        return self.shards[0].device

    def distinct(self) -> list[int]:
        """Indices of the shards that are distinct tensors (every shard of
        a head-sharded pool; one per device of a replicated one)."""
        seen: set[int] = set()
        out = []
        for i, s in enumerate(self.shards):
            if id(s) not in seen:
                seen.add(id(s))
                out.append(i)
        return out

    def split(self, block: torch.Tensor) -> list[torch.Tensor]:
        """A canonical block ``[L, 2, n, n_kv, ps, hd]`` as each held
        shard's part (its KV heads; the whole block for a replicated
        pool)."""
        if self.replicated:
            return [block] * len(self.shards)
        parts = block.chunk(self.count, dim=HEAD_DIM)
        return [parts[i] for i in self.index]

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Inverse of :meth:`split`, on the first device (every rank's
        parts over processes)."""
        if self.replicated:
            return parts[0].to(self.device)
        return all_gather(parts, HEAD_DIM, self.device, self.group)

    def full(self) -> torch.Tensor:
        """The pool in the reference's layout on the first device (tests,
        checks)."""
        return self.join(self.shards)


class ShardedBlock:
    """A KV block ``[L, 2, n, n_kv, ps, hd]`` held as the parts of a
    head-sharded pool's shards (``[L, 2, n, n_kv / k, ps, hd]`` each, on
    its shard's device, as ``ops/page_dma.py::gather_kv_shards`` gives
    them): what a prefill engine on a model axis hands to a decode peer on
    an identical mesh, one buffer a shard. ``join`` gives the reference's
    layout, which the host paths carry."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[HEAD_DIM] *= len(self.parts)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def join(self) -> torch.Tensor:
        return all_gather(self.parts, HEAD_DIM, self.device)

    def cpu(self) -> torch.Tensor:
        return self.join().cpu()
