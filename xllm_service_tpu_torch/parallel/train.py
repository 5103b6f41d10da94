"""The dry run's train step (port of ``__graft_entry__.py::dryrun_multichip``'s
loss, gradients and ``optax.adamw(1e-4)`` update), unsharded or over the
``data x model`` shardings of ``shard_params``.

``loss_fn`` is the reference's loss over a llama tree: the embedding rows,
then per layer the input norm, q/k/v with rope at positions ``0..S-1``,
causal attention, the output projection and a residual, the post-attention
norm, the MLP and a residual; then the final norm, ``lm_head`` and the
f32 softmax cross entropy of next-token targets, as a mean over every
token. The attention is the plain ``ops/attention.py::
dense_prefill_attention``, which autograd differentiates (the reference's
call takes XLA's dense path too; no kernel has a backward).

The optimizer is ``torch.optim.AdamW`` with optax's ``adamw(1e-4)``
defaults spelled out (``ADAMW``; torch's own decay default is 0.01), and
the decay applies to every leaf, as optax's unmasked decay does. Both
decay the old parameter: ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd *
p)``.

``TrainState`` holds the parameters for training. Unsharded, one tree.
Over a mesh (one process), each ``(data, model)`` coordinate holds its
shard of every leaf, cut by the family's rules (``shard_params``), as a
tensor of its own on its device with its own optimizer moments (serving's
shards on a repeated device are views of one tree, which cannot be the
optimizer's leaves). A step splits the batch over ``data``; each data row
runs the loss over its model shards (``models/llama.py``'s shard loop:
the row-parallel partials summed, the vocabulary shards joined) and takes
its gradients; then each leaf's gradient is summed (``all_reduce``) over
the coordinates that hold the same slice of it: the data line for every
leaf, and the model line too for a leaf the rules replicate over
``model`` (the norm scales). Every copy of a slice then takes the same
update, so replicated copies stay equal.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.base import ModelConfig
from ..models.llama import (
    LLAMA_STACKED_RULES,
    _embed,
    _layers,
    _project_qkv,
    _rope,
    _unembed,
    forward_shards,
    on_shards,
)
from ..ops.attention import dense_prefill_attention
from .mesh import AXIS_DATA, AXIS_MODEL, DeviceMesh, MeshConfig, build_mesh
from .sharding import (
    ShardedParams,
    ShardingRules,
    _shard_index,
    all_reduce,
    shard_params,
)

#: optax's ``adamw(1e-4)``: its defaults, as ``torch.optim.AdamW`` takes
#: them.
ADAMW = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Causal self-attention of whole rows [B, S, H, hd], in dense f32."""
    B, S = q.shape[:2]
    zeros = torch.zeros((B,), dtype=torch.int32, device=q.device)
    lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
    return dense_prefill_attention(q, k, v, None, None, None, zeros, lens)


def _body(shards: list, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Every layer of ``cfg`` over ``x`` [B, S, D] at positions
    ``0..S-1``, on the model shards ``shards`` (``forward_shards``): the
    input norm, q/k/v with rope, causal attention, the output projection
    and a residual, the post-attention norm, the MLP and a residual."""
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
        B, S)
    cos, sin = (on_shards(shards, t) for t in _rope(cfg, pos, pos))

    def attend(i, l, lp, h):
        q, k, v = _project_qkv(lp, h, shards[i].cfg, (cos[i], sin[i]))
        return _attention(q, k, v)

    return _layers(shards, cfg, x, attend)


def layer(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The loss's body at one layer ``lp`` of a plain tree (the pipeline
    leg's ``layer_fn``)."""
    one = replace(cfg, num_layers=1)
    return _body(forward_shards({"layers": _tree_map(lambda a: a[None], lp)},
                                one), one, x)


def loss_fn(params, cfg: ModelConfig, batch: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch`` [B, S + 1] (int ids)
    under ``params``: a llama tree, or the ``ShardedParams`` of one data
    row's model shards. A scalar f32 tensor on the batch's device."""
    inp, tgt = batch[:, :-1], batch[:, 1:]
    x = _embed(params, cfg, inp)
    logits = _unembed(params, cfg, _body(forward_shards(params, cfg), cfg, x))
    return F.cross_entropy(logits.reshape(inp.numel(), -1),
                           tgt.reshape(-1).long().to(logits.device))


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _walk(tree: dict, prefix: str = ""):
    """(path, parent dict, key) of every leaf, in the tree's order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _walk(v, path)
        else:
            yield path, tree, k


class TrainState:
    """Parameters, optimizer and step of the train step: unsharded
    (``mesh`` None) or over a one-process mesh's ``data x model``
    coordinates. The leaves are copies of ``params``, which is left as it
    is."""

    def __init__(self, params: dict, cfg: ModelConfig,
                 mesh: Optional[DeviceMesh] = None,
                 rules: ShardingRules = LLAMA_STACKED_RULES):
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        self.shapes = {path: node[k].shape for path, node, k in _walk(params)}
        self.tp = 1
        if mesh is None:
            self.rows = [_own(params)]
            coords = [(0, 0)]
        else:
            if mesh.process_count > 1:
                raise NotImplementedError("the train step runs in one "
                                          "process")
            shape = mesh.shape
            if any(n > 1 for a, n in shape.items()
                   if a not in (AXIS_DATA, AXIS_MODEL)):
                raise ValueError(f"the train step shards over data x model "
                                 f"only, not {shape}")
            self.tp = tp = shape[AXIS_MODEL]
            self.rows = []
            for d in range(shape[AXIS_DATA]):
                row = build_mesh(MeshConfig(model=tp),
                                 [mesh.device_at(data=d, model=m)
                                  for m in range(tp)])
                cut = shard_params(params, row, rules)
                self.rows.append(ShardedParams(
                    [_own(t) for t in cut.trees], cut.devices, row))
            coords = [(d, m) for d in range(shape[AXIS_DATA])
                      for m in range(tp)]
        # The leaves that hold the same slice of a parameter: one group a
        # (path, shard key), in coordinate order.
        groups: dict[tuple, list[torch.Tensor]] = {}
        for (d, m), t in zip(coords, self.trees()):
            for path, node, k in _walk(t):
                leaf = node[k]
                key = ()
                if mesh is not None:
                    _, key = _shard_index(
                        rules.spec_for(path), self.shapes[path],
                        {AXIS_MODEL: m}, {AXIS_MODEL: mesh.shape[AXIS_MODEL]},
                        path)
                groups.setdefault((path, key), []).append(leaf)
        self.groups = list(groups.values())
        self.opt = torch.optim.AdamW([x for g in self.groups for x in g],
                                     **ADAMW)

    def trees(self) -> list[dict]:
        """Every coordinate's tree, row-major over (data, model)."""
        return [t for r in self.rows
                for t in (r.trees if isinstance(r, ShardedParams) else [r])]

    def full(self) -> dict[str, torch.Tensor]:
        """The unsharded parameters by leaf path (``layers/q_proj/kernel``),
        on the first coordinate's device: data row 0's shards, each put in
        its place."""
        trees = self.trees()[:self.tp]
        dev = _first(trees[0]).device
        out = {}
        for path, shape in self.shapes.items():
            first = _leaf(trees[0], path).detach()
            if self.mesh is None:
                out[path] = first.clone()
                continue
            out[path] = torch.empty(shape, dtype=first.dtype, device=dev)
            for m, t in enumerate(trees):
                index, _ = _shard_index(self.rules.spec_for(path), shape,
                                        {AXIS_MODEL: m},
                                        {AXIS_MODEL: self.tp}, path)
                out[path][index] = _leaf(t, path).detach().to(dev)
        return out

    def step(self, batch: torch.Tensor) -> torch.Tensor:
        """One train step on ``batch`` [B, S + 1] (B divisible by the data
        axis): the loss (the mean over the whole batch, on the first
        coordinate's device), after the update."""
        n = len(self.rows)
        if batch.shape[0] % n:
            raise ValueError(f"batch {batch.shape[0]} does not divide over "
                             f"{n} data rows")
        self.opt.zero_grad(set_to_none=True)
        losses = []
        for row, part in zip(self.rows, batch.chunk(n)):
            dev = (row.devices[0] if isinstance(row, ShardedParams)
                   else _first(row).device)
            loss = loss_fn(row, self.cfg, part.to(dev)) / n
            loss.backward()
            losses.append(loss.detach())
        for group in self.groups:
            grads = [torch.zeros_like(x) if x.grad is None else x.grad
                     for x in group]
            if len(group) > 1:
                total = all_reduce(grads)
                grads = [total.to(x.device, copy=True) for x in group]
            for x, g in zip(group, grads):
                x.grad = g
        self.opt.step()
        return all_reduce(losses)


def _own(tree: dict) -> dict:
    """``tree`` with every leaf a contiguous tensor of its own that
    autograd tracks."""
    return _tree_map(
        lambda v: v.detach().clone().contiguous().requires_grad_(True), tree)


def _first(tree: dict) -> torch.Tensor:
    v = next(iter(tree.values()))
    return _first(v) if isinstance(v, dict) else v


def _leaf(tree: dict, path: str) -> torch.Tensor:
    for k in path.split("/"):
        tree = tree[k]
    return tree
