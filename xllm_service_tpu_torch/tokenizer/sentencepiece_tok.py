"""SentencePiece backend (copy of
``xllm_service_tpu/tokenizer/sentencepiece_tok.py``; reference
`sentencepiece_tokenizer.cpp`, 337 LoC): sp model + TokenizerArgs-driven
special tokens (escaped-alternation split, same machinery as tiktoken,
`sentencepiece_tokenizer.cpp:79-112`) and prefix tokens prepended to
every encode (:63-70).

Gated on the `sentencepiece` package (not present in every deployment
image); the factory falls back when missing.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Sequence

from .base import Tokenizer


class SentencePieceTokenizer(Tokenizer):
    def __init__(self, model_path: str | Path, args=None):
        import sentencepiece as spm

        self._sp = spm.SentencePieceProcessor(model_file=str(model_path))
        self._special: dict[str, int] = {}
        self._special_by_id: dict[int, str] = {}
        self._special_split = None
        self._prefix_ids: list[int] = []
        if args is not None:
            for tok, tid in args.special_tokens:
                if tok in self._special or tid in self._special_by_id:
                    continue
                self._special[tok] = int(tid)
                self._special_by_id[int(tid)] = tok
            if self._special:
                self._special_split = re.compile(
                    "(" + "|".join(re.escape(t) for t in sorted(
                        self._special, key=len, reverse=True)) + ")")
            prefix = list(args.prefix_tokens)
            if args.add_bos_token and args.bos_token:
                prefix.insert(0, args.bos_token)
            for tok in prefix:
                tid = self.token_to_id(tok)
                if tid is not None:
                    self._prefix_ids.append(tid)
                elif args.add_bos_token and tok == args.bos_token \
                        and self._sp.bos_id() >= 0:
                    self._prefix_ids.append(self._sp.bos_id())

    def encode(self, text: str) -> list[int]:
        out: list[int] = list(self._prefix_ids)
        if self._special_split is None:
            out.extend(self._sp.encode(text))
            return out
        for part in self._special_split.split(text):
            if not part:
                continue
            if part in self._special:
                out.append(self._special[part])
            else:
                out.extend(self._sp.encode(part))
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        if not self._special_by_id:
            return self._sp.decode(list(ids))
        pieces: list[str] = []
        run: list[int] = []
        for i in ids:
            if i in self._special_by_id:
                if run:
                    pieces.append(self._sp.decode(run))
                    run = []
                if not skip_special_tokens:
                    pieces.append(self._special_by_id[i])
            else:
                run.append(int(i))
        if run:
            pieces.append(self._sp.decode(run))
        return "".join(pieces)

    def vocab_size(self) -> int:
        # Only specials OUTSIDE the sp id space extend the vocab; standard
        # checkpoints re-declare <s>/</s>/<unk> (ids inside the model) in
        # added_tokens_decoder and must not inflate the count.
        base = self._sp.vocab_size()
        return base + sum(1 for i in self._special_by_id if i >= base)

    def id_to_token(self, token_id: int) -> Optional[str]:
        if token_id in self._special_by_id:
            return self._special_by_id[token_id]
        try:
            return self._sp.id_to_piece(token_id)
        except IndexError:
            return None

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._special:
            return self._special[token]
        tid = self._sp.piece_to_id(token)
        return tid if tid != self._sp.unk_id() or token == self._sp.id_to_piece(self._sp.unk_id()) else None
