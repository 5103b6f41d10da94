"""Attention ops of the port: plain PyTorch ops (``attention.py``, and
``ring_attention.py`` for the context-parallel prefill) and the wrappers of
the hand-written CUDA kernels (``paged_attention.py``,
``mq_paged_attention.py``, ``fused_decode_attention.py``, ``page_dma.py``,
``cp_paged_attention.py``; sources in ``../csrc``, built by ``_build.py``).
"""
