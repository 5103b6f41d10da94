"""Tokenizers the engine and its agent encode and decode with (port of
``xllm_service_tpu/tokenizer``): the hermetic byte tokenizer, and from a
model directory the Hugging Face ``tokenizer.json`` (read on the standard
library), tiktoken and SentencePiece, chosen by ``TokenizerFactory``."""

from .base import Tokenizer
from .factory import TokenizerFactory
from .hf_json import HFTokenizer
from .simple import SimpleTokenizer
from .tiktoken import TiktokenTokenizer

__all__ = ["Tokenizer", "TokenizerFactory", "HFTokenizer",
           "SimpleTokenizer", "TiktokenTokenizer"]
