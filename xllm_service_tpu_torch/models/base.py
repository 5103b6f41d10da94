"""Model contract shared by all families (port of
``xllm_service_tpu/models/base.py``, dense configurations only).

Engine-facing surface per family:
- ``init_params(cfg, generator, device) -> params``: random init from an
  explicit ``torch.Generator``; weights are stored ``[in, out]`` with a
  leading layer dim, the reference's layout.
- ``prefill_forward(params, cfg, tokens, positions, kv_pages, page_table,
  prefix_lens, seq_lens) -> (logits_last, kv_pages)``.
- ``decode_forward(params, cfg, tokens, positions, kv_pages, page_table,
  context_lens) -> (logits, kv_pages)``.
- ``embed_forward(params, cfg, tokens, seq_lens) -> [B, D] f32`` (None for
  a family without one).

Both forwards update the paged pool ``kv_pages`` in place and return it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    ffn_size: int = 5632
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    max_context_len: int = 8192

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    # ---- roofline accounting (bench.py twin: pct_roofline) ----------------
    @property
    def dtype_bytes(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def decode_weight_stream_bytes(self) -> int:
        """Bytes of weights streamed from device memory per decode
        token-step: every layer projection and the lm_head once (the
        embedding is a gather of B rows and is left out; a tied head
        streams the table all the same), plus the RMSNorm scales. The
        reference's accounting for its dense path, with the width of the
        port's weight dtype (bf16: 2 bytes, as the reference's)."""
        h, L, wb = self.hidden_size, self.num_layers, self.dtype_bytes
        attn = h * self.q_size + 2 * h * self.kv_size + self.q_size * h
        mlp_total = L * 3 * h * self.ffn_size
        norms = (L * 2 * h + h) * wb
        head = self.vocab_size * h * wb
        return (L * attn + mlp_total) * wb + norms + head

    def kv_bytes_per_token(self, context_len: int) -> int:
        """Bytes of KV cache read per sequence per decode token-step: K and
        V over the live context, every layer, in the pool's dtype."""
        return self.num_layers * 2 * context_len * self.kv_size * \
            self.dtype_bytes


@dataclass
class ModelFamily:
    name: str
    init_params: Callable[..., Any]
    prefill_forward: Callable[..., Any]
    decode_forward: Callable[..., Any]
    embed_forward: Optional[Callable[..., Any]] = None
    # The Sarathi mixed step (decode rows and one prefill chunk in one
    # forward); a family without it never rides.
    mixed_decode_chunk_forward: Optional[Callable[..., Any]] = None
    # Speculative verify (logits at every position of a short block per
    # sequence); a family without it never speculates.
    verify_forward: Optional[Callable[..., Any]] = None


_REGISTRY: dict[str, ModelFamily] = {}


def register_model_family(family: ModelFamily) -> None:
    _REGISTRY[family.name] = family


def get_model_family(name: str) -> ModelFamily:
    # Lazy import so importing the registry doesn't pull in every family.
    if name not in _REGISTRY and name in ("llama", "llama3"):
        from . import llama  # noqa: F401
    fam = _REGISTRY.get(name)
    if fam is None:
        raise ValueError(f"unknown model family: {name}")
    return fam


# ---- tiny/test/bench configs ------------------------------------------------
def tiny_config(**kw) -> ModelConfig:
    """CPU-test scale."""
    defaults = dict(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=32, ffn_size=256,
                    max_context_len=512)
    defaults.update(kw)
    return ModelConfig(**defaults)


def llama3_8b_config() -> ModelConfig:
    return ModelConfig(name="llama", vocab_size=128256, hidden_size=4096,
                       num_layers=32, num_heads=32, num_kv_heads=8,
                       head_dim=128, ffn_size=14336, rope_theta=500000.0,
                       max_context_len=8192)


def bench_1b_config() -> ModelConfig:
    """~1.2B params: the reference's single-chip bench model."""
    return ModelConfig(name="llama", vocab_size=32768, hidden_size=2048,
                       num_layers=16, num_heads=16, num_kv_heads=8,
                       head_dim=128, ffn_size=8192, max_context_len=4096)
