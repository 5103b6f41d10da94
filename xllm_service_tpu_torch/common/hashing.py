"""Chained block hashing for global prefix-KV-cache identity.

A copy of ``xllm_service_tpu/common/hashing.py``: 16-byte keys from a
chained keyed BLAKE2b-128 over ``[prev_hash ‖ block_token_ids]`` per
fixed-size token block. The keys must equal the reference's byte for
byte, because they are what the global prefix index routes on;
``tests/test_torch_kv_cache.py`` and
``tests/test_torch_native_hotcore.py`` check that.

The native path is the port's copy of ``csrc/blockhash.c``, built at first
use by :func:`xllm_service_tpu_torch.common.native.build_library` (with
the list-ingest entry point, which reads a Python token sequence under
the GIL) and loaded with ``ctypes``. ``XLLM_NO_NATIVE_HASH=1`` keeps the
pure path, as in the reference; a NumPy array always takes the buffer
entry point, and a library that does not build leaves the pure path on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Optional, Sequence

import numpy as np

DEFAULT_BLOCK_SIZE = 128
HASH_NBYTES = 16
_SEED = b"xllm-service-tpu"

_native_lock = threading.Lock()   # lock-order: 841
_NATIVE = None          # buffer entry point, once loaded
_NATIVE_LIST = None     # list-ingest entry point (GIL held), once loaded
_NATIVE_TRIED = False
_NATIVE_ERROR = ""


def _load_native() -> None:
    """Build and bind the block hash library once per process (the
    reference's ``_load_native`` over the port's own source)."""
    global _NATIVE, _NATIVE_LIST, _NATIVE_TRIED, _NATIVE_ERROR
    if _NATIVE_TRIED:
        return
    with _native_lock:
        if _NATIVE_TRIED:
            return
        if os.environ.get("XLLM_NO_NATIVE_HASH", "") not in ("", "0"):
            _NATIVE_TRIED = True
            return
        from . import native

        try:
            so = native.build_library("blockhash", ("BLOCKHASH_PYLIST",))
            buf_fn = ctypes.CDLL(str(so)).chained_block_hashes
            buf_fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_size_t, ctypes.c_char_p,
                               ctypes.c_size_t, ctypes.c_char_p]
            buf_fn.restype = None
            # PyDLL: keeps the GIL held across the call — the entry point
            # uses CPython APIs to read the token sequence.
            list_fn = ctypes.PyDLL(str(so)).chained_block_hashes_list
            list_fn.argtypes = [ctypes.py_object, ctypes.c_ssize_t,
                                ctypes.py_object]
            list_fn.restype = ctypes.py_object
        except (OSError, AttributeError) as e:
            _NATIVE_ERROR = str(e)
        else:
            _NATIVE, _NATIVE_LIST = buf_fn, list_fn
        _NATIVE_TRIED = True


def native_available() -> bool:
    """Whether the native block hash serves this process (built and
    loaded at first call)."""
    _load_native()
    return _NATIVE is not None


def native_error() -> str:
    """Why the native block hash does not serve ("" when it does, or when
    ``XLLM_NO_NATIVE_HASH`` turned it off)."""
    _load_native()
    return _NATIVE_ERROR


def hash_block(prev: bytes, token_ids: Sequence[int]) -> bytes:
    """Hash one token block chained onto ``prev`` (b"" for the first block)."""
    key = prev if prev else _SEED
    data = np.asarray(token_ids, dtype=np.int32).tobytes()
    return hashlib.blake2b(data, digest_size=HASH_NBYTES, key=key).digest()


def _chain(buf: bytes, n_blocks: int, block_bytes: int,
           seed: bytes) -> list[bytes]:
    """Chained keyed BLAKE2b-128 over ``n_blocks`` slices of ``buf``."""
    _load_native()
    if _NATIVE is not None:
        out = ctypes.create_string_buffer(n_blocks * HASH_NBYTES)
        _NATIVE(buf, n_blocks, block_bytes, seed, len(seed), out)
        raw = out.raw
        return [raw[i * HASH_NBYTES:(i + 1) * HASH_NBYTES]
                for i in range(n_blocks)]
    blake2b = hashlib.blake2b
    mv = memoryview(buf)
    prev = seed
    hashes: list[bytes] = []
    for i in range(n_blocks):
        prev = blake2b(mv[i * block_bytes:(i + 1) * block_bytes],
                       digest_size=HASH_NBYTES, key=prev).digest()
        hashes.append(prev)
    return hashes


def _hash_tokens(token_seq: Sequence[int], block_size: int,
                 seed: bytes) -> list[bytes]:
    _load_native()
    if _NATIVE_LIST is not None and not isinstance(token_seq, np.ndarray):
        # List path: the element-by-element int32 conversion runs in C
        # too (through np.asarray it costs far more than the chain).
        raw = _NATIVE_LIST(token_seq, block_size, seed)
        return [raw[i:i + HASH_NBYTES]
                for i in range(0, len(raw), HASH_NBYTES)]
    arr = np.asarray(token_seq, dtype=np.int32)
    n_blocks = len(arr) // block_size
    if n_blocks == 0:
        return []
    buf = arr[:n_blocks * block_size].tobytes()
    return _chain(buf, n_blocks, block_size * 4, seed)


def prefix_block_hashes(
    token_ids: Sequence[int], block_size: int = DEFAULT_BLOCK_SIZE
) -> list[bytes]:
    """Chained hashes for every *complete* block of ``token_ids``; the
    trailing partial block is ignored."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    return _hash_tokens(token_ids, block_size, _SEED)


def extend_prefix_block_hashes(
    prev_hashes: Sequence[bytes], token_ids: Sequence[int],
    block_size: int = DEFAULT_BLOCK_SIZE,
) -> list[bytes]:
    """Continue a memoized chain: ``prev_hashes`` are the hashes of the
    first ``len(prev_hashes)`` blocks of ``token_ids``; only the blocks
    beyond them are hashed."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    done = len(prev_hashes)
    n_blocks = len(token_ids) // block_size
    if done >= n_blocks:
        return list(prev_hashes[:n_blocks])
    seed = bytes(prev_hashes[-1]) if done else _SEED
    tail = token_ids[done * block_size:n_blocks * block_size]
    return list(prev_hashes) + _hash_tokens(tail, block_size, seed)


def prefix_block_hash_hexes(
    token_ids: Sequence[int], block_size: int = DEFAULT_BLOCK_SIZE
) -> list[str]:
    return [h.hex() for h in prefix_block_hashes(token_ids, block_size)]


def to_hex(h: bytes) -> str:
    return h.hex()


def from_hex(s: str) -> bytes:
    return bytes.fromhex(s)


def as_key(h: "bytes | str") -> Optional[bytes]:
    """Normalize a wire-carried block key (raw 16 bytes or hex) to bytes;
    None for garbage."""
    if isinstance(h, bytes):
        return h if len(h) == HASH_NBYTES else None
    try:
        b = bytes.fromhex(h)
    except (ValueError, TypeError):
        return None
    return b if len(b) == HASH_NBYTES else None
