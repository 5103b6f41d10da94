"""Weight bridge from the reference's parameter tree.

``params_from_jax`` turns a JAX package parameter tree of the llama body
(llama, qwen2 with its biases, gemma with its sandwich norms, and int8
trees with their ``{"q8", "scale"}`` leaves), given as numpy arrays
(``xllm_service_tpu/models/llama.py::init_params`` layout: stacked
``[L, ...]`` layers, projections ``[in, out]``), into the port's tensors
with the same layout and dtypes, so both engines compute from the same
weights. ``llama_params_from_jax`` is the same function under its first
name. The caller converts its arrays with ``numpy.asarray``; nothing here
imports JAX.

Given a mesh and the family's sharding rules, each leaf is converted and
cut at once (``parallel/sharding.py::shard_params``): on a mesh over
processes a rank keeps only its own shards, as contiguous tensors, and
the whole tree never exists on its device.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..common.device import resolve_device
from ..parallel.mesh import DeviceMesh
from ..parallel.sharding import ShardedParams, ShardingRules, shard_params


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.array(a)       # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a dtype torch.from_numpy takes: carry
        # the bits through a 16-bit integer view.
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(tree: dict,
                    device: Optional[Union[str, torch.device]] = None,
                    mesh: Optional[DeviceMesh] = None,
                    rules: Optional[ShardingRules] = None
                    ) -> Union[dict, ShardedParams]:
    """Nested dict of numpy arrays -> the same nested dict of tensors (same
    dtypes) on ``device`` (``cuda`` unless named). With ``mesh`` and
    ``rules``, the ``ShardedParams`` of this process's coordinates, each
    leaf converted on ``device`` and cut onto the mesh's devices one at a
    time (the tree in the form the engine serves: an int8 tree already
    quantized)."""
    dev = resolve_device(device)
    if mesh is not None:
        if rules is None:
            raise ValueError("a mesh needs the family's sharding rules")
        return shard_params(tree, mesh, rules,
                            convert=lambda a: _to_tensor(a, dev))

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return walk(tree)


llama_params_from_jax = params_from_jax
