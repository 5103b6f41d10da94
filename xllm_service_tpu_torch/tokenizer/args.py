"""Tokenizer argument surface (copy of
``xllm_service_tpu/tokenizer/args.py``).

Parity: reference `tokenizer/tokenizer_args.{h,cpp}` (171 LoC) —
`TokenizerArgs` {tokenizer_type, vocab_file, special_tokens, pattern,
prefix_tokens, chat_template, add_bos_token, add_eos_token, bos_token,
eos_token, pad_token, tokenizer_class} loaded from the model directory:
chat_template.json / chat_template.jinja override tokenizer_config.json's
`chat_template`; bos/eos/pad accept either the HF dict form
(`{"content": ...}`) or a plain string. We additionally surface HF's
`added_tokens_decoder` as special tokens (the reference receives its
special-token list from engine model code the service repo doesn't ship).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class TokenizerArgs:
    tokenizer_type: str = "sentencepiece"     # "sentencepiece" | "tiktoken"
    vocab_file: str = "tokenizer.model"
    special_tokens: list[tuple[str, int]] = field(default_factory=list)
    pattern: str = ""                         # tiktoken regex pre-split
    prefix_tokens: list[str] = field(default_factory=list)
    chat_template: str = ""
    add_bos_token: bool = False
    add_eos_token: bool = False
    bos_token: str = ""
    eos_token: str = ""
    pad_token: str = ""
    tokenizer_class: str = ""


def _token_content(v) -> Optional[str]:
    """HF configs carry tokens as either "tok" or {"content": "tok", ...}
    (reference reads `bos_token.content` first, then the string form)."""
    if isinstance(v, str):
        return v
    if isinstance(v, dict):
        c = v.get("content")
        return c if isinstance(c, str) else None
    return None


def _load_chat_template_file(model_dir: Path) -> Optional[str]:
    """chat_template.json / chat_template.jinja take priority over the
    tokenizer_config.json field (reference `tokenizer_args.cpp:8-28`)."""
    ct_json = model_dir / "chat_template.json"
    if ct_json.exists():
        try:
            v = json.loads(ct_json.read_text()).get("chat_template")
            if isinstance(v, str):
                return v
        except (json.JSONDecodeError, OSError):
            pass
    ct_jinja = model_dir / "chat_template.jinja"
    if ct_jinja.exists():
        try:
            return ct_jinja.read_text()
        except OSError:
            pass
    return None


def load_tokenizer_args(model_dir: str | Path) -> TokenizerArgs:
    """Reference `load_tokenizer_args` (`tokenizer_args.cpp:30-72`)."""
    args = TokenizerArgs()
    model_dir = Path(model_dir)
    if not model_dir.is_dir():
        return args

    tmpl = _load_chat_template_file(model_dir)
    if tmpl is not None:
        args.chat_template = tmpl

    cfg_path = model_dir / "tokenizer_config.json"
    data: dict = {}
    if cfg_path.exists():
        try:
            data = json.loads(cfg_path.read_text())
        except (json.JSONDecodeError, OSError):
            data = {}
    if not args.chat_template:
        v = data.get("chat_template")
        if isinstance(v, list):   # multiple named templates
            default = next((i for i in v if i.get("name") == "default"),
                           v[0] if v else None)
            if default:
                args.chat_template = default.get("template") or ""
        elif isinstance(v, str):
            args.chat_template = v
    if isinstance(data.get("add_bos_token"), bool):
        args.add_bos_token = data["add_bos_token"]
    if isinstance(data.get("add_eos_token"), bool):
        args.add_eos_token = data["add_eos_token"]
    if isinstance(data.get("tokenizer_class"), str):
        args.tokenizer_class = data["tokenizer_class"]
    if isinstance(data.get("tokenizer_type"), str):
        args.tokenizer_type = data["tokenizer_type"]
    if isinstance(data.get("pattern"), str):
        args.pattern = data["pattern"]
    if isinstance(data.get("vocab_file"), str):
        args.vocab_file = data["vocab_file"]
    for name in ("bos_token", "eos_token", "pad_token"):
        c = _token_content(data.get(name))
        if c is not None:
            setattr(args, name, c)
    prefix = data.get("prefix_tokens")
    if isinstance(prefix, list):
        args.prefix_tokens = [str(t) for t in prefix]

    # HF added_tokens_decoder: {"id": {"content": "<tok>", ...}, ...}.
    added = data.get("added_tokens_decoder")
    if isinstance(added, dict):
        for tid, info in added.items():
            c = _token_content(info)
            try:
                tid_i = int(tid)
            except (TypeError, ValueError):
                continue
            if c is not None:
                args.special_tokens.append((c, tid_i))
    return args
