"""The Jinja2 chat-template renderer (port of
``xllm_service_tpu/chat_template/jinja_chat_template.py``), on the
``jinja2`` package, as the reference: PyTorch depends on it, so it is
installed wherever the port runs."""

from __future__ import annotations

import json
from typing import Any, Optional

import jinja2

# A generic ChatML template for models that ship none.
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
)

# The marker a non-text content part renders as.
MM_PLACEHOLDER = "<|multimodal_placeholder|>"


def _flatten_content(content: Any) -> str:
    """OpenAI content is a string or a list of typed parts; a non-text part
    becomes the placeholder."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        parts = []
        for item in content:
            if isinstance(item, dict):
                if item.get("type") == "text":
                    parts.append(item.get("text", ""))
                else:
                    parts.append(MM_PLACEHOLDER)
            else:
                parts.append(str(item))
        return "".join(parts)
    return str(content)


def _raise_exception(msg: str):
    raise jinja2.TemplateError(msg)


class JinjaChatTemplate:
    def __init__(self, template: Optional[str] = None,
                 bos_token: str = "", eos_token: str = ""):
        self._env = jinja2.Environment(
            loader=jinja2.BaseLoader(),
            trim_blocks=True, lstrip_blocks=True,
            extensions=["jinja2.ext.loopcontrols"],
        )
        # Helpers that HF templates use.
        self._env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
        self._env.globals["raise_exception"] = _raise_exception
        self._template = self._env.from_string(
            template or DEFAULT_CHAT_TEMPLATE)
        self._bos = bos_token
        self._eos = eos_token

    def apply(self, messages: list[dict[str, Any]],
              tools: Optional[list[dict[str, Any]]] = None,
              chat_template_kwargs: Optional[dict[str, Any]] = None,
              add_generation_prompt: bool = True) -> str:
        """The rendered prompt: the messages (content flattened), tools and
        extra kwargs, ``add_generation_prompt`` on by default."""
        norm_messages = [
            {**m, "content": _flatten_content(m.get("content"))}
            for m in messages
        ]
        ctx: dict[str, Any] = {
            "messages": norm_messages,
            "add_generation_prompt": add_generation_prompt,
            "bos_token": self._bos,
            "eos_token": self._eos,
        }
        if tools:
            ctx["tools"] = tools
        if chat_template_kwargs:
            ctx.update(chat_template_kwargs)
        return self._template.render(**ctx)
