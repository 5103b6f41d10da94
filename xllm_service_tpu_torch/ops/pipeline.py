"""Pipeline parallelism: GPipe layer staging over a mesh's ``pipe`` axis
(port of ``xllm_service_tpu/ops/pipeline.py``; plain PyTorch, as the
reference computes it in XLA with no TPU kernel).

The stacked layer parameters (a tree whose leaves share a leading ``L``
dim) are split over the axis: stage *s* holds layers ``[s*L/P,
(s+1)*L/P)`` on its device. The batch is split into ``M`` microbatches;
on tick *t* stage *s* runs microbatch ``t - s`` through its layers, and
the activations hop one stage down the line. After ``P + M - 1`` ticks
every microbatch has passed every stage; the last stage holds the
outputs, which are handed to every stage, as the reference's ``psum``
over the axis does (its other stages contribute zeros).

The reference runs every stage on every tick and masks the ticks in
which a stage has no microbatch (static shapes for XLA); here such a tick
is skipped, since its result is never read. A hop is a ``.to`` of the
activation to the next stage's device (a no-op on a repeated device). On
a mesh over processes a rank runs only the stages of its own coordinates;
the activation of its last stage goes to the next rank of the pipe axis's
process group while the previous rank's comes in (``AxisGroup.shift``:
a send and a receive, staged through host memory for a CUDA tensor over
gloo), on the ticks in which one crosses, and the last stage's rank
broadcasts the outputs over the group. Each microbatch's arithmetic is
the one process's, so the result is the same bits.

The reference's engine never calls this op, and neither does the port's:
its uses are the dry run's pipeline leg (``parallel/dryrun.py``) and its
tests.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel.mesh import AXIS_PIPE, DeviceMesh


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def pipeline_forward(layer_fn: Callable, stacked_layers, x: torch.Tensor,
                     mesh: DeviceMesh, n_microbatches: int,
                     pipe_axis: str = AXIS_PIPE) -> torch.Tensor:
    """``x`` [B, ...] through the stacked layers, pipelined over
    ``pipe_axis``; returns the result [B, ...] on ``x``'s device (on every
    rank over processes).

    ``layer_fn(x, layer_params) -> x`` is one layer (its output has its
    input's shape), ``stacked_layers`` a tree of tensors whose leading dim
    is the layer count. Raises where the microbatches do not divide the
    batch or the stages do not divide the layers, as the reference
    asserts."""
    B = x.shape[0]
    M = n_microbatches
    if M < 1 or B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    P = mesh.shape[pipe_axis]
    L = {a.shape[0] for a in _leaves(stacked_layers)}
    if len(L) != 1:
        raise ValueError(f"stacked layers disagree on the layer count: {L}")
    L = L.pop()
    if L % P:
        raise ValueError(f"{L} layers not divisible by {P} pipe stages")
    per = L // P
    local = mesh.local_axis(pipe_axis)
    group = mesh.group(pipe_axis)
    if group is not None and local[0][0] != group.index * len(local):
        raise ValueError("each rank must hold consecutive pipe stages")
    blocks = [_tree_map(lambda a, s=s, d=d: a[s * per:(s + 1) * per].to(d),
                        stacked_layers) for s, d in local]

    def run_block(block, h: torch.Tensor) -> torch.Tensor:
        for l in range(per):
            h = layer_fn(h, _tree_map(lambda a, l=l: a[l], block))
        return h

    x_mb = x.reshape(M, B // M, *x.shape[1:])
    # Stages whose output crosses to the next rank (over processes).
    crossing = ([(i + 1) * len(local) - 1 for i in range(group.size - 1)]
                if group is not None else [])
    first_stage, last_stage = local[0][0], local[-1][0]
    state: list = [None] * len(local)      # the activation each stage takes
    outputs: list = [None] * M
    for t in range(P + M - 1):
        ys: list = [None] * len(local)
        for j, (s, d) in enumerate(local):
            mb = t - s
            if not 0 <= mb < M:
                continue
            cur = x_mb[mb].to(d) if s == 0 else state[j]
            ys[j] = run_block(blocks[j], cur)
            if s == P - 1:
                outputs[mb] = ys[j]
        # The hops: within the process a copy to the next stage's device,
        # across processes the ring's shift on the ticks that carry one.
        state = [None] + [y if y is None else y.to(local[j + 1][1])
                          for j, y in enumerate(ys[:-1])]
        if any(0 <= t - b < M for b in crossing):
            last = ys[-1]
            if last is None:
                last = torch.zeros_like(x_mb[0], device=local[-1][1])
            got = group.shift(last)
            if first_stage > 0:
                state[0] = got.to(local[0][1])
    if last_stage == P - 1:
        out = torch.cat(outputs).to(x.device)
    else:
        out = torch.empty_like(x)
    if group is not None:
        out = group.broadcast(out, group.size - 1)
    return out
