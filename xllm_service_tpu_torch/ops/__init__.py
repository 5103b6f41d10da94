"""Attention ops of the port: plain PyTorch ops (``attention.py``) and the
wrappers of the two hand-written CUDA kernels (``paged_attention.py``,
``mq_paged_attention.py``; sources in ``../csrc``, built by ``_build.py``).
"""
