"""PyTorch/CUDA port of the xllm-service-tpu inference engine.

The JAX package ``xllm_service_tpu`` stays the reference; this package is a
second implementation beside it that runs on one NVIDIA H100. It imports
``torch`` and never ``jax``, and nothing of ``xllm_service_tpu``: the few
pure-Python pieces it shares with the reference (block hashing, request
types, the byte tokenizer, the page manager) are its own copies.

Layout mirrors the reference so each module's counterpart is easy to find:

- ``engine/``: ``InferenceEngine`` (continuous batching over a paged KV
  pool), ``EngineConfig``, the page manager and batched sampling;
- ``models/``: the dense Llama-3 forwards over the paged pool;
- ``ops/``: plain PyTorch attention ops, and the wrappers of the
  hand-written CUDA kernels (``csrc/``);
- ``bench.py`` and ``benchmarks/``: twins of the repository's ``bench.py``
  and ``benchmarks/decode_profile.py``, run with ``python -m``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
