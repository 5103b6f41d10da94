"""PyTorch/CUDA port of the xllm-service-tpu inference engine.

The JAX package ``xllm_service_tpu`` stays the reference; this package is a
second implementation beside it that runs on one NVIDIA H100. It imports
``torch`` and never ``jax``, and nothing of ``xllm_service_tpu``: the few
pure-Python pieces it shares with the reference (block hashing, request
types, the byte tokenizer, the page manager, the coordination clients)
are its own copies.

Layout mirrors the reference so each module's counterpart is easy to find:

- ``engine/``: ``InferenceEngine`` (continuous batching over a paged KV
  pool, embeddings), ``EngineConfig``, the page manager and batched
  sampling, and the engine agent (``engine/agent.py``), the entry point
  through which the reference master serves the port;
- ``coordination/``, ``rpc/``: the agent's copies of the service plane's
  coordination clients and of the wire contract's key scheme and JSON
  dispatch wire;
- ``models/``: the dense Llama-3 forwards over the paged pool;
- ``ops/``: plain PyTorch attention ops, and the wrappers of the
  hand-written CUDA kernels (``csrc/``);
- ``bench.py`` and ``benchmarks/``: twins of the repository's ``bench.py``
  and ``benchmarks/decode_profile.py``, run with ``python -m``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
