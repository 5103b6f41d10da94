"""Tokenizer backend selection (port of
``xllm_service_tpu/tokenizer/factory.py``).

The reference's selection order (``tokenizer_factory.cpp:9-32``, args
loaded first): ``tokenizer.json`` -> the Hugging Face format, read here on
the standard library (``hf_json.py``; the reference wraps the
``tokenizers`` library); tiktoken (``args`` say so or a ``*.tiktoken``
vocabulary exists) -> ``tiktoken.py``; a SentencePiece model ->
``sentencepiece_tok.py`` when the ``sentencepiece`` package is importable;
otherwise, and with no path, the hermetic ``SimpleTokenizer``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from .base import Tokenizer
from .hf_json import HFTokenizer
from .simple import SimpleTokenizer
from .tiktoken import TiktokenTokenizer

logger = logging.getLogger(__name__)


class TokenizerFactory:
    @staticmethod
    def load_args(tokenizer_path: str = ""):
        from .args import TokenizerArgs, load_tokenizer_args

        if not tokenizer_path:
            return TokenizerArgs()
        return load_tokenizer_args(tokenizer_path)

    @staticmethod
    def create_tokenizer(tokenizer_path: str = "",
                         args=None) -> Tokenizer:
        """Reference selection order: tokenizer.json -> HF; args say
        tiktoken (or a *.tiktoken vocab exists) -> Tiktoken with
        pattern/special/prefix tokens from args; else SentencePiece; no
        path or nothing recognized -> SimpleTokenizer."""
        if not tokenizer_path:
            return SimpleTokenizer()
        if args is None:
            args = TokenizerFactory.load_args(tokenizer_path)
        p = Path(tokenizer_path)
        tokenizer_json = p / "tokenizer.json" if p.is_dir() else (
            p if p.name == "tokenizer.json" else None)
        if tokenizer_json is not None and tokenizer_json.exists():
            return HFTokenizer(tokenizer_json)

        is_tiktoken = (args.tokenizer_type == "tiktoken"
                       or args.tokenizer_class == "TikTokenTokenizer"
                       or (p.is_dir() and any(p.glob("*.tiktoken")))
                       or p.suffix == ".tiktoken")
        if is_tiktoken:
            vocab = p
            if p.is_dir():
                named = p / args.vocab_file
                if named.exists() and named.suffix == ".tiktoken":
                    vocab = named
            try:
                return TiktokenTokenizer(
                    vocab, pattern=args.pattern or None,
                    special_tokens=dict(args.special_tokens),
                    prefix_tokens=args.prefix_tokens)
            except FileNotFoundError:
                logger.warning("tiktoken requested but no vocab at %s", p)

        # sentencepiece model.
        sp_model = p / args.vocab_file if p.is_dir() else (
            p if p.suffix == ".model" else None)
        if sp_model is not None and not sp_model.exists() and p.is_dir():
            sp_model = p / "tokenizer.model"
        if sp_model is not None and sp_model.exists():
            try:
                import sentencepiece  # noqa: F401

                from .sentencepiece_tok import SentencePieceTokenizer

                return SentencePieceTokenizer(sp_model, args=args)
            except ImportError:
                logger.warning("sentencepiece lib unavailable; "
                               "falling back to SimpleTokenizer")
        logger.warning("no recognizable tokenizer at %s; using SimpleTokenizer",
                       tokenizer_path)
        return SimpleTokenizer()

    @staticmethod
    def load_chat_template(tokenizer_path: str) -> Optional[str]:
        """The chat template string (chat_template.json /
        chat_template.jinja take priority over tokenizer_config.json); the
        agent renders it (``chat_template/``) for image messages, as the
        reference agent does."""
        if not tokenizer_path:
            return None
        return TokenizerFactory.load_args(tokenizer_path).chat_template \
            or None
