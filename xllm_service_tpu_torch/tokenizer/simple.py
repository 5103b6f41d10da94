"""Hermetic byte tokenizer (the pure-Python path of
``xllm_service_tpu/tokenizer/simple.py``).

Deterministic reversible byte-level scheme: each UTF-8 byte maps to id
``byte + 256``; ids < 256 are reserved for special tokens.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..common import native as _native
from .base import Tokenizer

_BYTE_OFFSET = 256


class SimpleTokenizer(Tokenizer):
    def __init__(self, special_tokens: dict[str, int] | None = None):
        self._special = dict(special_tokens or {"<pad>": 0, "<bos>": 1, "<eos>": 2})
        self._special_by_id = {v: k for k, v in self._special.items()}

    def encode(self, text: str) -> list[int]:
        # Hottest route frame under fleet load (per-request prompt encode
        # inside Scheduler._schedule_inner) — libhotcore builds the id
        # list in C when available; identical output by construction.
        ids = _native.tok_encode(text)
        if ids is not _native.MISS:
            return ids
        return [b + _BYTE_OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytearray()
        for i in ids:
            if i >= _BYTE_OFFSET:
                # Ids beyond the byte range (random-weight vocabularies)
                # fold back into bytes: decode never throws.
                data.append((i - _BYTE_OFFSET) % 256)
            elif not skip_special_tokens and i in self._special_by_id:
                data.extend(self._special_by_id[i].encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    def vocab_size(self) -> int:
        return 512

    def id_to_token(self, token_id: int) -> Optional[str]:
        if token_id in self._special_by_id:
            return self._special_by_id[token_id]
        if _BYTE_OFFSET <= token_id < 512:
            return chr(token_id - _BYTE_OFFSET)
        return None

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._special:
            return self._special[token]
        if len(token) == 1 and ord(token) < 256:
            return ord(token) + _BYTE_OFFSET
        return None

    @property
    def eos_id(self) -> int:
        return self._special.get("<eos>", 2)
