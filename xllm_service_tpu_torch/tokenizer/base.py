"""Tokenizer interface (copy of ``xllm_service_tpu/tokenizer/base.py``)."""

from __future__ import annotations

import abc
from typing import Optional, Sequence


class Tokenizer(abc.ABC):
    @abc.abstractmethod
    def encode(self, text: str) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...

    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @abc.abstractmethod
    def id_to_token(self, token_id: int) -> Optional[str]: ...

    @abc.abstractmethod
    def token_to_id(self, token: str) -> Optional[int]: ...

    def clone(self) -> "Tokenizer":
        """Backends are thread-safe, so the default clone is self."""
        return self
