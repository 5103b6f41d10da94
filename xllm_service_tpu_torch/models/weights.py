"""Weight bridge from the reference's parameter tree.

``llama_params_from_jax`` turns the JAX package's Llama parameter tree,
given as numpy arrays (``xllm_service_tpu/models/llama.py::init_params``
layout: stacked ``[L, ...]`` layers, projections ``[in, out]``), into the
port's tensors with the same layout, so both engines compute from the same
weights. The caller converts its arrays with ``numpy.asarray``; nothing
here imports JAX.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..common.device import resolve_device


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.array(a)       # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a dtype torch.from_numpy takes: carry
        # the bits through a 16-bit integer view.
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def llama_params_from_jax(tree: dict,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors (same
    dtypes) on ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return walk(tree)
