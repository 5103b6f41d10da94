"""Weight-only int8 quantization (port of ``xllm_service_tpu/models/quant.py``:
the dense projections, the MoE expert stacks and the MLA projections).

A decode step streams every projection weight once, so storing them as int8
with one f32 scale per output channel halves the weight stream of bf16. The
forward never builds a dequantized weight: the int8 tensor is converted to
the activation's dtype inside the product, and the scale, constant per
output channel, multiplies the product's output:

    x @ W  ==  (x @ q8) * scale,    W = q8 * scale[None, :]

which is exact algebra, so the only error is int8 rounding. A quantized
leaf replaces a ``kernel`` tensor with a ``{"q8", "scale"}`` dict; the
embedding, the norms, the biases and the MoE routers keep their dtype.
``quantized_matmul`` takes an expert stack ``[E, in, out]`` as one
batched product; ``quantized_einsum`` takes any other einsum (the MLA
per-head up-projections ``[H, in, out]``), its scale aligned to the
product's output by einsum letter.

The product is plain PyTorch (``torch.matmul`` on the converted weight), as
the reference's is XLA's dot outside any Pallas kernel. It reads 1 byte a
weight, writes the converted copy and reads it again, so on the card it is
slower than the bf16 product until a fused int8 kernel exists (ROADMAP
queue 2).
"""

from __future__ import annotations

import torch

# Projection matrices whose ``kernel`` is quantized; the contraction is the
# kernel's axis -2 in every product of the families (the expert stacks
# [L, E, in, out] and the MLA up-projections [L, H, in, out] included), so
# the per-output-channel scale reduces over it. Routers and the MLA latent
# norm stay full precision.
QUANT_KERNELS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj", "lm_head",
                 "kv_down", "k_rope", "k_up", "v_up")


def quantize_kernel(w: torch.Tensor) -> dict:
    """[..., in, out] -> {"q8": int8 [..., in, out], "scale": f32
    [..., out]}: absmax per output channel over axis -2, / 127, floored at
    1e-8, rounded half to even (``torch.round``, as ``jnp.round``)."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2) / 127.0, min=1e-8)
    q8 = torch.round(wf / scale[..., None, :]).to(torch.int8)
    return {"q8": q8, "scale": scale}


def is_quantized(kern) -> bool:
    return isinstance(kern, dict) and "q8" in kern


def quantized_matmul(x: torch.Tensor, kern) -> torch.Tensor:
    """``x @ kern`` for a plain or quantized kernel [..., in, out]: for
    int8, ``(x @ q8.to(x.dtype)) * scale.to(x.dtype)``, in that order, as
    the reference's ``quantized_einsum`` for the dense specs. A stacked
    kernel [E, in, out] makes one batched product over the stack (the
    reference's ``td,edf->etf`` and ``etf,efd->etd``: x [T, in] or
    [E, T, in] -> [E, T, out]), its scale [E, out] applied per stack
    entry."""
    if not is_quantized(kern):
        return x @ kern
    y = x @ kern["q8"].to(x.dtype)
    scale = kern["scale"]
    if scale.dim() > 1:
        scale = scale.unsqueeze(-2)
    return y * scale.to(y.dtype)


def quantized_einsum(spec: str, x: torch.Tensor, kern) -> torch.Tensor:
    """``torch.einsum(spec, x, kern)`` for a plain or quantized kernel.
    For int8 the product runs against ``q8`` converted to ``x``'s dtype,
    then the scale (the kernel's dims minus the contraction, axis -2)
    multiplies it, aligned to the output by einsum letter, as the
    reference's ``quantized_einsum``: for ``td,edf->etf`` the scale
    [E, F] becomes [E, 1, F]; for ``...hd,hdc->...hc`` the scale [H, C]
    multiplies the trailing dims."""
    if not is_quantized(kern):
        return torch.einsum(spec, x, kern)
    y = torch.einsum(spec, x, kern["q8"].to(x.dtype))
    ins, out = spec.split("->")
    k_letters = ins.split(",")[1].replace("...", "")
    scale_letters = k_letters[:-2] + k_letters[-1]
    named_out = out.replace("...", "")      # y's trailing named dims
    if not set(scale_letters) <= set(named_out):
        raise ValueError(f"quantized_einsum: {spec!r} contracts a scaled "
                         "dim")
    present = [o for o in named_out if o in scale_letters]
    s = kern["scale"].permute([scale_letters.index(o) for o in present])
    s = s.reshape([s.shape[present.index(o)] if o in present else 1
                   for o in named_out])
    return y * s.to(y.dtype)


def quantize_tree(params: dict) -> dict:
    """``params`` with every ``QUANT_KERNELS`` kernel in its int8 form,
    one layer at a time for a stacked [L, ..., in, out] kernel (a whole
    [32, 4096, 14336] projection in f32 would be 7.5 GB). The input tree
    is left as it is; leaves already quantized pass through."""

    def quantize(w: torch.Tensor) -> dict:
        if w.dim() < 3:
            return quantize_kernel(w)
        q8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((*w.shape[:-2], w.shape[-1]),
                            dtype=torch.float32, device=w.device)
        for i in range(w.shape[0]):
            part = quantize_kernel(w[i])
            q8[i], scale[i] = part["q8"], part["scale"]
        return {"q8": q8, "scale": scale}

    def walk(node: dict, name: str = "") -> dict:
        out = {}
        for k in list(node):
            v = node[k]
            if (k == "kernel" and name in QUANT_KERNELS
                    and isinstance(v, torch.Tensor)):
                out[k] = quantize(v)
            elif isinstance(v, dict):
                out[k] = walk(v, k)
            else:
                out[k] = v
        return out

    return walk(params)
