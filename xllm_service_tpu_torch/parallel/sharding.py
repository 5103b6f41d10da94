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
(``DeviceMesh.shard_devices``), and the forwards (``models/llama.py``,
``models/deepseek_moe.py``) run each shard's part and combine the parts
with the named collectives below: a sum (after a row-parallel product) or
a concatenation (the vocabulary-sharded logits) on the mesh's first
device, copied to a shard's device where the next part needs it. On a mesh
whose devices repeat (``cuda:0`` eight times on a one-card machine, ``cpu``
in the tests) the shards are views of the tree they were cut from, so
together they take that tree's memory, and every copy between them is a
no-op. The ``data`` and ``pipe`` axes replicate: the port computes once
where the reference computes the same values on each replica.
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


def all_reduce(parts: Sequence[torch.Tensor],
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum of ``parts`` on ``device`` (the first part's by default),
    added in shard order in the parts' dtype. One part is returned as it
    is."""
    device = parts[0].device if device is None else device
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device`` (the first
    part's by default). One part is returned as it is."""
    device = parts[0].device if device is None else device
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


# ------------------------------------------------------------ parameters
@dataclass
class ShardedParams:
    """A parameter tree over a mesh's expert and model axes: ``trees[e *
    model + m]`` is the tree of coordinate (e, m), in the unsharded tree's
    layout with every leaf cut to its shard, on ``devices[e * model + m]``.
    A leaf replicated over an axis is the same tensor in every tree on one
    device. The forwards dispatch on this type; an unsharded tree stays a
    plain dict."""

    trees: list[dict]
    devices: list[torch.device]
    mesh: DeviceMesh
    expert: int = field(init=False)
    model: int = field(init=False)

    def __post_init__(self) -> None:
        self.expert = self.mesh.shape[AXIS_EXPERT]
        self.model = self.mesh.shape[AXIS_MODEL]

    def tree(self, e: int = 0, m: int = 0) -> dict:
        return self.trees[e * self.model + m]

    @property
    def model_trees(self) -> list[dict]:
        """The trees of the model axis at expert index 0 (the attention,
        dense MLP and vocabulary shards)."""
        return self.trees[:self.model]

    @property
    def model_devices(self) -> list[torch.device]:
        return self.devices[:self.model]


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
                 rules: ShardingRules) -> ShardedParams:
    """``params`` cut by ``rules`` over ``mesh``'s expert and model axes:
    each leaf's shard for each (expert, model) coordinate, on that
    coordinate's device. Where every coordinate's device is the leaf's own
    (a repeated device), a shard is a view of the leaf, so the shards
    together take the leaf's memory; elsewhere it is a contiguous copy on
    its device, and the leaf can be freed. A leaf replicated over an axis
    is held once per device. Raises where a split dim does not divide."""
    devices = mesh.shard_devices()
    sizes = {AXIS_EXPERT: mesh.shape[AXIS_EXPERT],
             AXIS_MODEL: mesh.shape[AXIS_MODEL]}
    coords = [{AXIS_EXPERT: e, AXIS_MODEL: m}
              for e in range(sizes[AXIS_EXPERT])
              for m in range(sizes[AXIS_MODEL])]

    def leaf_shards(leaf: torch.Tensor, path: str) -> list[torch.Tensor]:
        spec = rules.spec_for(path)
        views = all(d == leaf.device for d in devices)
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
                else leaf_shards(v, path)
            for o, p in zip(outs, parts):
                o[k] = p
        return outs

    return ShardedParams(walk(params, ""), devices, mesh)


def replicated_tree(params: Union[dict, ShardedParams]) -> dict:
    """The tree of coordinate (0, 0): ``params`` itself when unsharded.
    Its replicated leaves (the vision tower, the norms, the router) are
    whole."""
    return params.tree() if isinstance(params, ShardedParams) else params


# ------------------------------------------------------------------ pool
class ModelShardedPages:
    """The KV pool ``[L, 2, P, n_kv, ps, hd]`` over a mesh's model axis
    (the reference's ``KV_PAGES_SPEC``): ``shards[m]`` is ``[L, 2, P,
    n_kv / n, ps, hd]``, the KV heads of model shard ``m``, on the axis's
    ``m``-th device. Where ``n_kv`` does not divide over the axis (MLA's
    one latent head) the pool is replicated: every shard is the whole pool,
    held once per distinct device (``replicated``), and a write goes to
    each copy. ``shape`` is the global shape."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: DeviceMesh,
                 replicated: bool):
        self.shards = list(shards)
        self.mesh = mesh
        self.replicated = replicated

    @classmethod
    def zeros(cls, shape: Sequence[int], dtype: torch.dtype,
              mesh: DeviceMesh) -> "ModelShardedPages":
        devs = mesh.axis_devices(AXIS_MODEL)
        shape = list(shape)
        replicated = shape[HEAD_DIM] % len(devs) != 0
        if replicated:
            held: dict[torch.device, torch.Tensor] = {}
            shards = [held.setdefault(d, torch.zeros(shape, dtype=dtype,
                                                     device=d))
                      for d in devs]
        else:
            shape[HEAD_DIM] //= len(devs)
            shards = [torch.zeros(shape, dtype=dtype, device=d)
                      for d in devs]
        return cls(shards, mesh, replicated)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        if not self.replicated:
            s[HEAD_DIM] *= len(self.shards)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where blocks are assembled."""
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
        """A canonical block ``[L, 2, n, n_kv, ps, hd]`` as each shard's
        part (its KV heads; the whole block for a replicated pool)."""
        if self.replicated:
            return [block] * len(self.shards)
        return list(block.chunk(len(self.shards), dim=HEAD_DIM))

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Inverse of :meth:`split`, on the first device."""
        if self.replicated:
            return parts[0].to(self.device)
        return all_gather(parts, HEAD_DIM, self.device)

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
