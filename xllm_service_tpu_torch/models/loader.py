"""Checkpoint loading: Hugging Face safetensors -> the port's stacked
parameter tree (port of ``xllm_service_tpu/models/loader.py``, the llama
body's families: llama, qwen2 and gemma2).

HF weight names map onto the stacked-layer tree of ``models/llama.py``
(a leading ``[L]`` dim, projections ``[in, out]``), exactly the layout of
``models/weights.py::params_from_jax``, so the engine cannot tell a
loaded tree from one carried across.

The load never stacks the model on the host (the reference's
``np.stack`` holds it twice there). The shards' headers are read first;
each stacked leaf is then allocated once on the device in the model's
dtype, and each checkpoint tensor is copied from its ``mmap`` view onto
the device and into its row, transposed from HF's ``[out, in]`` there.
Beyond the page cache the host holds nothing.

``save_params`` / ``load_params`` are the port's native checkpoint (the
reference's orbax pair, for engine restarts): one file in the safetensors
layout per top-level group, keyed by tree path (``layers/q_proj/kernel``),
int8 trees included (``.../q8`` as I8, ``.../scale`` as F32). The files
are named ``<group>.st``, so that a directory of them is never taken for
an HF directory (``*.safetensors``). Orbax directories are not read.

The MoE and vision loaders wait for their families (ROADMAP queue 1 items
12 and 13).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Union

import torch

from ..common.device import resolve_device
from .base import ModelConfig
from .safetensors_io import SafeTensorsFile, save_file, shard_files

logger = logging.getLogger(__name__)

Params = dict

# HF per-layer name -> (our path, transpose?) for the llama body's
# families. HF Linear stores [out, in]; our kernels are [in, out].
_HF_LAYER_MAP = {
    "input_layernorm.weight": ("input_norm/scale", False),
    "self_attn.q_proj.weight": ("q_proj/kernel", True),
    "self_attn.k_proj.weight": ("k_proj/kernel", True),
    "self_attn.v_proj.weight": ("v_proj/kernel", True),
    "self_attn.o_proj.weight": ("o_proj/kernel", True),
    "self_attn.q_proj.bias": ("q_proj/bias", False),
    "self_attn.k_proj.bias": ("k_proj/bias", False),
    "self_attn.v_proj.bias": ("v_proj/bias", False),
    "post_attention_layernorm.weight": ("post_attn_norm/scale", False),
    # gemma-2 sandwich norms (absent from other families' checkpoints).
    "pre_feedforward_layernorm.weight": ("pre_ffw_norm/scale", False),
    "post_feedforward_layernorm.weight": ("post_ffw_norm/scale", False),
    "mlp.gate_proj.weight": ("gate_proj/kernel", True),
    "mlp.up_proj.weight": ("up_proj/kernel", True),
    "mlp.down_proj.weight": ("down_proj/kernel", True),
}
_HF_TOP_MAP = {
    "model.embed_tokens.weight": ("embed/embedding", False),
    "model.norm.weight": ("final_norm/scale", False),
    "lm_head.weight": ("lm_head/kernel", True),
}
NATIVE_SUFFIX = ".st"


def _set_path(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _place(name: str, num_layers: int):
    """(tree path, layer or None, transpose) of checkpoint tensor ``name``,
    or None (with the reference's warning) for a tensor it does not map."""
    if name in _HF_TOP_MAP:
        path, transpose = _HF_TOP_MAP[name]
        return path, None, transpose
    if not name.startswith("model.layers."):
        logger.warning("unmapped checkpoint tensor: %s", name)
        return None
    idx_str, _, leaf = name[len("model.layers."):].partition(".")
    if leaf not in _HF_LAYER_MAP:
        logger.warning("unmapped layer tensor: %s", name)
        return None
    idx = int(idx_str)
    if not 0 <= idx < num_layers:
        raise ValueError(f"checkpoint tensor {name} is past the config's "
                         f"{num_layers} layers")
    path, transpose = _HF_LAYER_MAP[leaf]
    return f"layers/{path}", idx, transpose


def load_hf_llama_safetensors(ckpt_dir: Union[str, Path], cfg: ModelConfig,
                              device: Optional[Union[str, torch.device]]
                              = None) -> Params:
    """Load an HF llama/qwen2/gemma2 checkpoint directory (``*.safetensors``
    shards) into the stacked tree on ``device`` (``cuda`` unless named), in
    ``cfg.dtype``. A checkpoint without ``lm_head`` gets the embedding's
    transpose unless ``cfg.tie_embeddings`` (whose forwards unembed through
    the embedding), as in the reference."""
    dev = resolve_device(device)
    files = shard_files(ckpt_dir)
    if not files:
        raise FileNotFoundError(f"no .safetensors in {ckpt_dir}")
    L = cfg.num_layers

    # Pass 1: the headers. Every placed tensor's leaf, row and shape.
    plan: list[tuple[Path, list]] = []
    shapes: dict[str, tuple] = {}
    rows: dict[str, list[bool]] = {}
    for f in files:
        with SafeTensorsFile(f) as sf:
            placed = []
            for name in sf.keys():
                where = _place(name, L)
                if where is None:
                    continue
                path, idx, transpose = where
                shape = sf.shape(name)
                if transpose:
                    shape = shape[::-1]
                if idx is not None:
                    rows.setdefault(path, [False] * L)[idx] = True
                    shape = (L,) + shape
                if shapes.setdefault(path, shape) != shape:
                    raise ValueError(f"checkpoint tensor {name} has shape "
                                     f"{sf.shape(name)}, where {path} has "
                                     f"{shapes[path]}")
                placed.append((name, path, idx, transpose))
            plan.append((f, placed))
    for path, seen in rows.items():
        missing = [i for i, s in enumerate(seen) if not s]
        if missing:
            raise ValueError(f"checkpoint missing layers {missing} for "
                             f"{path[len('layers/'):]}")

    # Pass 2: each leaf allocated once on the device; each tensor copied
    # from its mapped bytes into its row.
    leaves = {path: torch.empty(shape, dtype=cfg.dtype, device=dev)
              for path, shape in shapes.items()}
    for f, placed in plan:
        with SafeTensorsFile(f) as sf:
            for name, path, idx, transpose in placed:
                src = sf.get_tensor(name).to(dev)
                dst = leaves[path] if idx is None else leaves[path][idx]
                dst.copy_(src.t() if transpose else src)
                del src
    tree: Params = {}
    for path, leaf in leaves.items():
        _set_path(tree, path, leaf)

    if "lm_head" not in tree and not cfg.tie_embeddings:
        # Tied checkpoints ship no lm_head; honor tying implicitly.
        logger.info("no lm_head in checkpoint; tying to embeddings")
        tree["lm_head"] = {"kernel": tree["embed"]["embedding"].t()
                           .contiguous()}
    return tree


# ------------------------------------------------------ native checkpoint
def _flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def save_params(params: Params, path: Union[str, Path]) -> None:
    """The port's native checkpoint: ``path/<group>.st`` per top-level
    group, each tensor keyed by its tree path, in its own dtype."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    for group, sub in params.items():
        flat = _flatten(sub, group + "/") if isinstance(sub, dict) \
            else {group: sub}
        save_file(flat, path / f"{group}{NATIVE_SUFFIX}",
                  metadata={"format": "xllm_service_tpu_torch"})


def load_params(path: Union[str, Path], cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None
                ) -> Params:
    """A tree written by ``save_params``, on ``device`` (``cuda`` unless
    named): floating leaves in ``cfg.dtype``, the leaves of an int8 kernel
    (``q8``, ``scale``) as written."""
    dev = resolve_device(device)
    files = sorted(Path(path).glob(f"*{NATIVE_SUFFIX}"))
    if not files:
        raise FileNotFoundError(f"no native checkpoint (*{NATIVE_SUFFIX}) "
                                f"under {path}")
    tree: Params = {}
    for f in files:
        with SafeTensorsFile(f) as sf:
            for name in sf.keys():
                src = sf.get_tensor(name)
                quant_leaf = name.rsplit("/", 1)[-1] in ("q8", "scale")
                leaf = torch.empty(src.shape, device=dev, dtype=src.dtype
                                   if quant_leaf else cfg.dtype)
                leaf.copy_(src.to(dev))
                _set_path(tree, name, leaf)
    return tree
