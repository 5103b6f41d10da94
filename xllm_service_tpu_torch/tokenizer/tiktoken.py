"""Tiktoken-style byte-level BPE (port of
``xllm_service_tpu/tokenizer/tiktoken.py``).

Parity: reference `tiktoken_tokenizer.cpp` (470 LoC) — BPE over a vocab
file of `base64(token_bytes) rank` lines, with:

- regex pre-splitting (re2 in the reference, the `regex` package in the
  JAX package; here the standard library's `re`, the pattern compiled
  through `unicode_re.compile`, which spells `\\p{L}`-class properties as
  explicit ranges, on the CPU and on the card alike),
- special tokens (escaped alternation split, longest-first, so special
  strings embedded in user text encode to their single ids),
- prefix tokens prepended to every encode (reference
  `tiktoken_tokenizer.cpp:63-70`).
"""

from __future__ import annotations

import base64
import re
from pathlib import Path
from typing import Optional, Sequence

from . import unicode_re
from .base import Tokenizer


def _bpe_merge(piece: bytes, ranks: dict[bytes, int]) -> list[bytes]:
    """Standard greedy lowest-rank pair merging."""
    parts = [piece[i:i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_rank = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return parts


class TiktokenTokenizer(Tokenizer):
    def __init__(self, vocab_path: str | Path,
                 pattern: Optional[str] = None,
                 special_tokens: dict[str, int] | None = None,
                 prefix_tokens: Sequence[str] = ()):
        """vocab_path: the vocab file, or a model dir (first *.tiktoken
        inside; pass a TokenizerArgs-driven path from the factory)."""
        p = Path(vocab_path)
        if p.is_dir():
            cands = sorted(p.glob("*.tiktoken"))
            if not cands:
                raise FileNotFoundError(f"no *.tiktoken under {p}")
            p = cands[0]
        self._ranks: dict[bytes, int] = {}
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            tok_b64, _, rank = line.partition(" ")
            self._ranks[base64.b64decode(tok_b64)] = int(rank)
        self._id_to_bytes = {v: k for k, v in self._ranks.items()}

        # Special tokens not given explicit ids get sequential ids after
        # the vocab (reference `load_special_tokens`,
        # `tiktoken_tokenizer.cpp:79-96`).
        self._special: dict[str, int] = {}
        next_id = (max(self._ranks.values()) + 1) if self._ranks else 0
        for tok, tid in (special_tokens or {}).items():
            if tid is None or tid < 0:
                tid = next_id
                next_id += 1
            self._special[tok] = int(tid)
            next_id = max(next_id, int(tid) + 1)
        self._special_by_id = {v: k for k, v in self._special.items()}

        self._pattern = unicode_re.compile(pattern) if pattern else None
        if self._special:
            # Longest-first alternation: overlapping specials resolve to
            # the longest match (reference escapes + joins with "|").
            self._special_split = re.compile(
                "(" + "|".join(re.escape(t) for t in sorted(
                    self._special, key=len, reverse=True)) + ")")
        else:
            self._special_split = None
        # Prefix token ids prepended to every encode (reference
        # `tiktoken_tokenizer.cpp:63-70`).
        self._prefix_ids: list[int] = []
        for tok in prefix_tokens:
            tid = self.token_to_id(tok)
            if tid is not None:
                self._prefix_ids.append(tid)

    def _encode_ordinary(self, text: str) -> list[int]:
        out: list[int] = []
        chunks = (self._pattern.findall(text) if self._pattern else [text])
        for chunk in chunks:
            if not isinstance(chunk, str):   # groups in user patterns
                chunk = next((c for c in chunk if c), "")
            data = chunk.encode("utf-8")
            if not data:
                continue
            rank = self._ranks.get(data)
            if rank is not None:
                out.append(rank)
                continue
            out.extend(self._ranks[p] for p in _bpe_merge(data, self._ranks)
                       if p in self._ranks)
        return out

    def encode(self, text: str) -> list[int]:
        out: list[int] = list(self._prefix_ids)
        if not self._special_split:
            out.extend(self._encode_ordinary(text))
            return out
        for part in self._special_split.split(text):
            if not part:
                continue
            if part in self._special:
                out.append(self._special[part])
            else:
                out.extend(self._encode_ordinary(part))
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytearray()
        for i in ids:
            if i in self._special_by_id:
                if not skip_special_tokens:
                    data.extend(self._special_by_id[i].encode("utf-8"))
                continue
            b = self._id_to_bytes.get(i)
            if b is not None:
                data.extend(b)
        return data.decode("utf-8", errors="replace")

    def vocab_size(self) -> int:
        return len(self._ranks) + len(self._special)

    def id_to_token(self, token_id: int) -> Optional[str]:
        if token_id in self._special_by_id:
            return self._special_by_id[token_id]
        b = self._id_to_bytes.get(token_id)
        return b.decode("utf-8", errors="replace") if b is not None else None

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._special:
            return self._special[token]
        return self._ranks.get(token.encode("utf-8"))
