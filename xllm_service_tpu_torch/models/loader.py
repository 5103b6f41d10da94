"""Checkpoint loading: Hugging Face safetensors -> the port's stacked
parameter tree (port of ``xllm_service_tpu/models/loader.py``: the llama
body's families, llama, qwen2 and gemma2, and the MoE families, DeepSeek-V2
and Mixtral).

HF weight names map onto the stacked-layer tree of ``models/llama.py``
(a leading ``[L]`` dim, projections ``[in, out]``), exactly the layout of
``models/weights.py::params_from_jax``, so the engine cannot tell a
loaded tree from one carried across.

The load never stacks the model on the host (the reference's
``np.stack`` holds it twice there). The shards' headers are read first
(``_load_pieces``); each stacked leaf is then allocated once on the
device in the model's dtype and filled layer by layer, each checkpoint
tensor copied from its ``mmap`` view onto the device and into its row,
transposed from HF's ``[out, in]`` there. Beyond the page cache the host
holds nothing. Under ``cfg.quant == "int8"`` each layer of a stacked
projection is assembled in the model dtype and quantized at once
(``quantize_kernel``, as ``quantize_tree`` would), so a Mixtral
checkpoint never has its bf16 tree on the card: the peak is one layer of
one expert stack. The lm_head (absent: the embedding's transpose, unless
tied) is quantized with the rest of the tree afterwards.

``save_params`` / ``load_params`` are the port's native checkpoint (the
reference's orbax pair, for engine restarts): one file in the safetensors
layout per top-level group, keyed by tree path (``layers/q_proj/kernel``),
int8 trees included (``.../q8`` as I8, ``.../scale`` as F32). The files
are named ``<group>.st``, so that a directory of them is never taken for
an HF directory (``*.safetensors``). Orbax directories are not read.

The MoE loaders (``load_hf_deepseek_safetensors``,
``load_hf_mixtral_safetensors``) map HF names as the reference's do: the
MLA projections split and reshaped (``kv_a_proj_with_mqa`` -> kv_down and
k_rope, ``kv_b_proj`` -> k_up and v_up), the experts stacked ``[Lm, E,
...]``, the leading dense layers' MLP into ``dense_mlp``; every leaf in
the model's dtype, the router included, as the reference's cast.

Every loader takes the reference's ``mesh`` and ``rules``: the tree is
then read onto the mesh's first device and each (expert, model) shard
placed on its device (``_on_mesh``).

The vision loader (``load_hf_qwen2_vl_safetensors``) maps the LM as
qwen2's and the ``visual.*`` tower onto ``models/qwen2_vl.py``'s encoder,
as the reference's: the Conv3d patch embedding flattened to the (c, t, ph,
pw) linear the encoder applies, the blocks stacked ``[Lv, ...]`` under
``vision/layers``, the PatchMerger's ln_q and MLP under ``vision/merger``.
"""

from __future__ import annotations

import contextlib
import logging
import math
from pathlib import Path
from typing import Callable, Optional, Union

import torch

from ..common.device import resolve_device
from ..parallel.mesh import DeviceMesh
from ..parallel.sharding import ShardingRules, shard_params
from .base import ModelConfig
from .quant import QUANT_KERNELS, quantize_kernel, quantize_tree
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


# One destination of a checkpoint tensor: (tree path, index into the
# leaf's stack dims, transform of the tensor on the device, its shape).
_Piece = tuple[str, tuple, Callable[[torch.Tensor], torch.Tensor], tuple]


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t()


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _top_pieces(name: str, shape: tuple) -> Optional[list[_Piece]]:
    """The pieces of a top-level tensor, None for a per-layer one, [] (with
    the reference's warning) for one it does not map."""
    if name in _HF_TOP_MAP:
        path, transpose = _HF_TOP_MAP[name]
        return [(path, (), _t if transpose else _same,
                 shape[::-1] if transpose else shape)]
    if not name.startswith("model.layers."):
        logger.warning("unmapped checkpoint tensor: %s", name)
        return []
    return None


def _load_pieces(ckpt_dir: Union[str, Path], cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]],
                 place: Callable[[str, tuple], list],
                 stack_dims: Callable[[str], tuple],
                 missing_word: str = "entries") -> Params:
    """Every loader's two passes. ``place(name, shape)`` gives a tensor's
    pieces; ``stack_dims(path)`` a leaf's leading stack dims (``(L,)``,
    ``(Lm, E)``, ``()``). Pass 1 reads the headers, fixes every leaf's
    shape and checks that each index of every stacked leaf is filled (the
    reference's errors, which call a gap ``missing_word``); pass 2 fills
    each leaf on ``device``, one stack layer at a time, each tensor copied
    from its mapped bytes onto the device and transformed there. Under
    int8 a stacked ``QUANT_KERNELS`` leaf's layer is assembled in the
    model dtype and quantized into its q8 and scale. A checkpoint without
    ``lm_head`` gets the embedding's transpose unless
    ``cfg.tie_embeddings`` (whose forwards unembed through the
    embedding)."""
    dev = resolve_device(device)
    files = shard_files(ckpt_dir)
    if not files:
        raise FileNotFoundError(f"no .safetensors in {ckpt_dir}")
    quant = cfg.quant == "int8"

    shapes: dict[str, tuple] = {}
    # (path, stack layer or None) -> [(file, name, index in layer, fn)]
    groups: dict[tuple, list] = {}
    for f in files:
        with SafeTensorsFile(f) as sf:
            for name in sf.keys():
                for path, idx, fn, shape in place(name, sf.shape(name)):
                    stack = stack_dims(path)
                    if len(idx) != len(stack) or not all(
                            0 <= i < n for i, n in zip(idx, stack)):
                        raise ValueError(
                            f"checkpoint tensor {name} lands at {idx} of "
                            f"{path}, whose stack is {stack}")
                    full = stack + tuple(shape)
                    if shapes.setdefault(path, full) != full:
                        raise ValueError(
                            f"checkpoint tensor {name} makes {path} "
                            f"{full}, where it is {shapes[path]}")
                    key = (path, idx[0] if idx else None)
                    groups.setdefault(key, []).append(
                        (f, name, idx[1:], fn))
    for path, full in shapes.items():
        stack = stack_dims(path)
        have = {(i,) + tuple(x[2]) for (p, i), xs in groups.items()
                if p == path and i is not None for x in xs}
        # The reference's name for it, relative to its stack.
        rel = (path[len("vision/layers/"):]
               if path.startswith("vision/layers/")
               else path.split("/", 1)[1])
        if len(stack) == 2:
            for mi in range(stack[0]):
                missing = [e for e in range(stack[1]) if (mi, e) not in have]
                if missing:
                    raise ValueError(f"moe layer {mi} missing experts "
                                     f"{missing} for {rel}")
        elif stack:
            missing = [i for i in range(stack[0]) if (i,) not in have]
            if missing:
                raise ValueError(f"checkpoint missing {missing_word} "
                                 f"{missing} for {rel}")

    tree: Params = {}
    with contextlib.ExitStack() as opened:
        handles: dict[Path, SafeTensorsFile] = {}

        def fill(dst: torch.Tensor, entries: list) -> None:
            for f, name, sub, fn in entries:
                if f not in handles:
                    handles[f] = opened.enter_context(SafeTensorsFile(f))
                src = handles[f].get_tensor(name).to(dev)
                (dst[sub] if sub else dst).copy_(fn(src))
                del src

        for path, full in shapes.items():
            stack = stack_dims(path)
            if not stack:
                leaf = torch.empty(full, dtype=cfg.dtype, device=dev)
                fill(leaf, groups[(path, None)])
            elif (quant and path.endswith("/kernel")
                  and path.split("/")[-2] in QUANT_KERNELS):
                leaf = {"q8": torch.empty(full, dtype=torch.int8, device=dev),
                        "scale": torch.empty((*full[:-2], full[-1]),
                                             dtype=torch.float32,
                                             device=dev)}
                for i in range(stack[0]):
                    part = torch.empty(full[1:], dtype=cfg.dtype, device=dev)
                    fill(part, groups[(path, i)])
                    q = quantize_kernel(part)
                    leaf["q8"][i].copy_(q["q8"])
                    leaf["scale"][i].copy_(q["scale"])
                    del part, q
            else:
                leaf = torch.empty(full, dtype=cfg.dtype, device=dev)
                for i in range(stack[0]):
                    fill(leaf[i], groups[(path, i)])
            _set_path(tree, path, leaf)

    if "lm_head" not in tree and not cfg.tie_embeddings:
        # Tied checkpoints ship no lm_head; honor tying implicitly.
        logger.info("no lm_head in checkpoint; tying to embeddings")
        tree["lm_head"] = {"kernel": tree["embed"]["embedding"].t()
                           .contiguous()}
    return tree


def _device(device, mesh: Optional[DeviceMesh]):
    """Where a loader reads: the mesh's first device under a mesh."""
    return mesh.devices[0] if mesh is not None and device is None \
        else device


def _on_mesh(tree: Params, cfg: ModelConfig, mesh: Optional[DeviceMesh],
             rules: Optional[ShardingRules]) -> Params:
    """A loaded tree on ``mesh`` (the reference's ``mesh=``/``rules=``):
    under int8 its remaining projections quantized first (a row-parallel
    kernel's scale reduces over the whole contraction), then each (expert,
    model) shard on its device (``shard_params``: views of the tree on a
    repeated device, copies elsewhere). The engine takes such a tree as it
    is. Without a mesh the tree itself."""
    if mesh is None:
        return tree
    if rules is None:
        raise ValueError("a mesh needs the family's sharding rules")
    if cfg.quant:
        tree = quantize_tree(tree)
    return shard_params(tree, mesh, rules)


def _layer_index(name: str, num_layers: int) -> tuple[int, str]:
    idx_str, _, leaf = name[len("model.layers."):].partition(".")
    li = int(idx_str)
    if not 0 <= li < num_layers:
        raise ValueError(f"checkpoint tensor {name} is past the config's "
                         f"{num_layers} layers")
    return li, leaf


def load_hf_llama_safetensors(ckpt_dir: Union[str, Path], cfg: ModelConfig,
                              device: Optional[Union[str, torch.device]]
                              = None, mesh: Optional[DeviceMesh] = None,
                              rules: Optional[ShardingRules] = None
                              ) -> Params:
    """Load an HF llama/qwen2/gemma2 checkpoint directory (``*.safetensors``
    shards) into the stacked tree on ``device`` (``cuda`` unless named), in
    ``cfg.dtype``."""
    L = cfg.num_layers

    def place(name: str, shape: tuple) -> list[_Piece]:
        top = _top_pieces(name, shape)
        if top is not None:
            return top
        li, leaf = _layer_index(name, L)
        if leaf not in _HF_LAYER_MAP:
            logger.warning("unmapped layer tensor: %s", name)
            return []
        path, transpose = _HF_LAYER_MAP[leaf]
        return [(f"layers/{path}", (li,), _t if transpose else _same,
                 shape[::-1] if transpose else shape)]

    return _on_mesh(_load_pieces(
        ckpt_dir, cfg, _device(device, mesh), place,
        lambda path: (L,) if path.startswith("layers/") else (),
        missing_word="layers"), cfg, mesh, rules)


def load_hf_deepseek_safetensors(ckpt_dir: Union[str, Path],
                                 cfg: ModelConfig,
                                 device: Optional[Union[str, torch.device]]
                                 = None, mesh: Optional[DeviceMesh] = None,
                                 rules: Optional[ShardingRules] = None
                                 ) -> Params:
    """An HF DeepSeek-V2/V3 checkpoint directory -> the deepseek_moe tree
    on ``device`` (``cuda`` unless named): the MLA projections split and
    reshaped (``kv_a_proj_with_mqa`` rows -> kv_down ‖ k_rope, ``kv_b_proj``
    -> per-head k_up [H, dn, dc] and v_up [H, dc, dv]), the experts
    stacked [Lm, E, ...], the shared experts and the router stacked
    [Lm, ...], layer i < first_dense_layers's MLP in ``dense_mlp``."""
    L, Ld = cfg.num_layers, cfg.first_dense_layers
    Lm, E, H = L - Ld, cfg.num_experts, cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dc, dv = cfg.kv_lora_rank, cfg.v_head_dim
    mla = dc > 0

    def stack_dims(path: str) -> tuple:
        if path.startswith("layers/"):
            return (L,)
        if path.startswith("moe/experts/"):
            return (Lm, E)
        if path.startswith("moe/"):
            return (Lm,)
        if path.startswith("dense_mlp/"):
            return (Ld,)
        return ()

    def place(name: str, shape: tuple) -> list[_Piece]:
        top = _top_pieces(name, shape)
        if top is not None:
            return top
        li, leaf = _layer_index(name, L)
        mi = li - Ld
        t_shape = shape[::-1]

        def lay(path, fn=_t, out=t_shape):
            return [(f"layers/{path}", (li,), fn, out)]

        if leaf == "input_layernorm.weight":
            return lay("input_norm/scale", _same, shape)
        if leaf == "post_attention_layernorm.weight":
            return lay("post_attn_norm/scale", _same, shape)
        if leaf == "self_attn.o_proj.weight":
            return lay("o_proj/kernel")
        if leaf == "self_attn.q_proj.weight":
            return lay("q_proj/kernel")
        if mla and leaf == "self_attn.kv_a_proj_with_mqa.weight":
            return (lay("kv_down/kernel", lambda t: t[:dc].t(),
                        (shape[1], dc))
                    + lay("k_rope/kernel", lambda t: t[dc:dc + dr].t(),
                          (shape[1], dr)))
        if mla and leaf == "self_attn.kv_a_layernorm.weight":
            return lay("kv_norm/scale", _same, shape)
        if mla and leaf == "self_attn.kv_b_proj.weight":
            return (lay("k_up/kernel",
                        lambda t: t.reshape(H, dn + dv, dc)[:, :dn, :],
                        (H, dn, dc))
                    + lay("v_up/kernel",
                          lambda t: t.reshape(H, dn + dv, dc)[:, dn:, :]
                          .transpose(1, 2), (H, dc, dv)))
        if not mla and leaf == "self_attn.k_proj.weight":
            return lay("k_proj/kernel")
        if not mla and leaf == "self_attn.v_proj.weight":
            return lay("v_proj/kernel")
        if leaf == "mlp.gate.weight":
            return [("moe/router/kernel", (mi,), _t, t_shape)]
        if leaf.startswith("mlp.experts."):
            e_str, _, w = leaf[len("mlp.experts."):].partition(".")
            proj = w.split(".")[0]         # gate_proj|up_proj|down_proj
            return [(f"moe/experts/{proj}/kernel", (mi, int(e_str)), _t,
                     t_shape)]
        if leaf.startswith("mlp.shared_experts."):
            proj = leaf[len("mlp.shared_experts."):].split(".")[0]
            return [(f"moe/shared/{proj}/kernel", (mi,), _t, t_shape)]
        if li < Ld and leaf.startswith("mlp."):
            proj = leaf[len("mlp."):].split(".")[0]
            return [(f"dense_mlp/{proj}/kernel", (li,), _t, t_shape)]
        logger.warning("unmapped layer tensor: %s", name)
        return []

    return _on_mesh(_load_pieces(ckpt_dir, cfg, _device(device, mesh),
                                 place, stack_dims), cfg, mesh, rules)


_MIXTRAL_EXPERT = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}


def load_hf_mixtral_safetensors(ckpt_dir: Union[str, Path], cfg: ModelConfig,
                                device: Optional[Union[str, torch.device]]
                                = None, mesh: Optional[DeviceMesh] = None,
                                rules: Optional[ShardingRules] = None
                                ) -> Params:
    """An HF Mixtral checkpoint directory -> the mixtral tree on ``device``
    (``cuda`` unless named): attention and norms as llama's,
    ``block_sparse_moe`` gate/w1/w3/w2 as router/gate_proj/up_proj/
    down_proj stacked [L, E, ...] (no shared experts, no dense layers)."""
    L, E = cfg.num_layers, cfg.num_experts

    def stack_dims(path: str) -> tuple:
        if path.startswith("layers/"):
            return (L,)
        if path.startswith("moe/experts/"):
            return (L, E)
        if path.startswith("moe/"):
            return (L,)
        return ()

    def place(name: str, shape: tuple) -> list[_Piece]:
        top = _top_pieces(name, shape)
        if top is not None:
            return top
        li, leaf = _layer_index(name, L)
        if leaf in _HF_LAYER_MAP:          # attention and norms
            path, transpose = _HF_LAYER_MAP[leaf]
            return [(f"layers/{path}", (li,), _t if transpose else _same,
                     shape[::-1] if transpose else shape)]
        if leaf == "block_sparse_moe.gate.weight":
            return [("moe/router/kernel", (li,), _t, shape[::-1])]
        if leaf.startswith("block_sparse_moe.experts."):
            e_str, _, w = leaf[len("block_sparse_moe.experts."):] \
                .partition(".")
            proj = _MIXTRAL_EXPERT.get(w.split(".")[0])
            if proj is None:
                logger.warning("unmapped expert tensor: %s", name)
                return []
            return [(f"moe/experts/{proj}/kernel", (li, int(e_str)), _t,
                     shape[::-1])]
        logger.warning("unmapped layer tensor: %s", name)
        return []

    return _on_mesh(_load_pieces(ckpt_dir, cfg, _device(device, mesh),
                                 place, stack_dims), cfg, mesh, rules)


# visual.blocks.{i}.<leaf> -> (the vision/layers path, transpose?)
_HF_VISION_BLOCK_MAP = {
    "norm1.weight": ("norm1/scale", False),
    "norm1.bias": ("norm1/bias", False),
    "attn.qkv.weight": ("qkv/kernel", True),
    "attn.qkv.bias": ("qkv/bias", False),
    "attn.proj.weight": ("proj/kernel", True),
    "attn.proj.bias": ("proj/bias", False),
    "norm2.weight": ("norm2/scale", False),
    "norm2.bias": ("norm2/bias", False),
    "mlp.fc1.weight": ("fc1/kernel", True),
    "mlp.fc1.bias": ("fc1/bias", False),
    "mlp.fc2.weight": ("fc2/kernel", True),
    "mlp.fc2.bias": ("fc2/bias", False),
}
_HF_VISION_TOP_MAP = {
    "visual.merger.ln_q.weight": ("vision/merger/ln_q/scale", False),
    "visual.merger.ln_q.bias": ("vision/merger/ln_q/bias", False),
    "visual.merger.mlp.0.weight": ("vision/merger/fc1/kernel", True),
    "visual.merger.mlp.0.bias": ("vision/merger/fc1/bias", False),
    "visual.merger.mlp.2.weight": ("vision/merger/fc2/kernel", True),
    "visual.merger.mlp.2.bias": ("vision/merger/fc2/bias", False),
}


def _patch_kernel(t: torch.Tensor) -> torch.Tensor:
    """Conv3d [Dv, 3, tps, p, p] -> the [3 * tps * p * p, Dv] linear."""
    return t.reshape(t.shape[0], -1).t()


def load_hf_qwen2_vl_safetensors(ckpt_dir: Union[str, Path],
                                 cfg: ModelConfig,
                                 device: Optional[Union[str, torch.device]]
                                 = None, mesh: Optional[DeviceMesh] = None,
                                 rules: Optional[ShardingRules] = None
                                 ) -> Params:
    """An HF Qwen2-VL checkpoint directory -> the qwen2_vl tree on
    ``device`` (``cuda`` unless named), in ``cfg.dtype``: the LM as
    qwen2's (the qkv-bias llama), the ``visual.*`` tower onto the
    encoder's tree."""
    v = cfg.vision
    assert v is not None
    L, Lv = cfg.num_layers, v.num_layers

    def place(name: str, shape: tuple) -> list[_Piece]:
        if name in _HF_VISION_TOP_MAP:
            path, transpose = _HF_VISION_TOP_MAP[name]
            return [(path, (), _t if transpose else _same,
                     shape[::-1] if transpose else shape)]
        if name == "visual.patch_embed.proj.weight":
            return [("vision/patch_embed/kernel", (), _patch_kernel,
                     (math.prod(shape[1:]), shape[0]))]
        if name.startswith("visual.blocks."):
            idx_str, _, leaf = name[len("visual.blocks."):].partition(".")
            if leaf not in _HF_VISION_BLOCK_MAP:
                logger.warning("unmapped vision tensor: %s", name)
                return []
            li = int(idx_str)
            if not 0 <= li < Lv:
                raise ValueError(f"checkpoint tensor {name} is past the "
                                 f"config's {Lv} vision layers")
            path, transpose = _HF_VISION_BLOCK_MAP[leaf]
            return [(f"vision/layers/{path}", (li,),
                     _t if transpose else _same,
                     shape[::-1] if transpose else shape)]
        top = _top_pieces(name, shape)
        if top is not None:
            return top
        li, leaf = _layer_index(name, L)
        if leaf not in _HF_LAYER_MAP:
            logger.warning("unmapped layer tensor: %s", name)
            return []
        path, transpose = _HF_LAYER_MAP[leaf]
        return [(f"layers/{path}", (li,), _t if transpose else _same,
                 shape[::-1] if transpose else shape)]

    def stack_dims(path: str) -> tuple:
        if path.startswith("layers/"):
            return (L,)
        if path.startswith("vision/layers/"):
            return (Lv,)
        return ()

    return _on_mesh(_load_pieces(ckpt_dir, cfg, _device(device, mesh),
                                 place, stack_dims), cfg, mesh, rules)


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
                device: Optional[Union[str, torch.device]] = None,
                mesh: Optional[DeviceMesh] = None,
                rules: Optional[ShardingRules] = None) -> Params:
    """A tree written by ``save_params``, on ``device`` (``cuda`` unless
    named): floating leaves in ``cfg.dtype``, the leaves of an int8 kernel
    (``q8``, ``scale``) and an MoE router (f32 from ``init_params``) as
    written. With ``mesh`` and ``rules``, sharded as ``_on_mesh`` says."""
    dev = resolve_device(_device(device, mesh))
    files = sorted(Path(path).glob(f"*{NATIVE_SUFFIX}"))
    if not files:
        raise FileNotFoundError(f"no native checkpoint (*{NATIVE_SUFFIX}) "
                                f"under {path}")
    tree: Params = {}
    for f in files:
        with SafeTensorsFile(f) as sf:
            for name in sf.keys():
                src = sf.get_tensor(name)
                as_written = (name.rsplit("/", 1)[-1] in ("q8", "scale")
                              or name.endswith("router/kernel"))
                leaf = torch.empty(src.shape, device=dev, dtype=src.dtype
                                   if as_written else cfg.dtype)
                leaf.copy_(src.to(dev))
                _set_path(tree, name, leaf)
    return _on_mesh(tree, cfg, mesh, rules)
