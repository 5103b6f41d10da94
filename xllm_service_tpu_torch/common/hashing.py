"""Chained block hashing for global prefix-KV-cache identity.

A copy of the pure-Python path of ``xllm_service_tpu/common/hashing.py``:
16-byte keys from a chained keyed BLAKE2b-128 over ``[prev_hash ‖
block_token_ids]`` per fixed-size token block. The keys must equal the
reference's byte for byte, because they are what the global prefix index
routes on; ``tests/test_torch_kv_cache.py`` checks that.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np

DEFAULT_BLOCK_SIZE = 128
HASH_NBYTES = 16
_SEED = b"xllm-service-tpu"


def hash_block(prev: bytes, token_ids: Sequence[int]) -> bytes:
    """Hash one token block chained onto ``prev`` (b"" for the first block)."""
    key = prev if prev else _SEED
    data = np.asarray(token_ids, dtype=np.int32).tobytes()
    return hashlib.blake2b(data, digest_size=HASH_NBYTES, key=key).digest()


def _chain(buf: bytes, n_blocks: int, block_bytes: int,
           seed: bytes) -> list[bytes]:
    """Chained keyed BLAKE2b-128 over ``n_blocks`` slices of ``buf``."""
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
