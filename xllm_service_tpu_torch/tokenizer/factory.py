"""Tokenizer selection (port of ``xllm_service_tpu/tokenizer/factory.py``,
its hermetic branch)."""

from __future__ import annotations

from .base import Tokenizer
from .simple import SimpleTokenizer


class TokenizerFactory:
    @staticmethod
    def create_tokenizer(tokenizer_path: str = "") -> Tokenizer:
        """No path -> the byte tokenizer, as the reference's. A tokenizer
        directory (tokenizer.json, tiktoken or SentencePiece) needs the
        ``tokenizers`` package, which the port does not use: it comes with
        checkpoint loading."""
        if not tokenizer_path:
            return SimpleTokenizer()
        raise NotImplementedError(
            f"tokenizer path {tokenizer_path!r}: loading a tokenizer from "
            "disk is not ported yet (ROADMAP queue 1 item 8, checkpoint "
            "loading)")

