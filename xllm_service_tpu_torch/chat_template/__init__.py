"""Jinja chat templating (port of ``xllm_service_tpu/chat_template``): the
model's ``chat_template`` rendered with the messages, a tools array and
extra ``chat_template_kwargs``, ``add_generation_prompt`` on; a non-text
content part becomes ``MM_PLACEHOLDER``, which the agent expands to the
model's image placeholder run."""

from .jinja_chat_template import (
    DEFAULT_CHAT_TEMPLATE,
    JinjaChatTemplate,
    MM_PLACEHOLDER,
)

__all__ = ["JinjaChatTemplate", "DEFAULT_CHAT_TEMPLATE", "MM_PLACEHOLDER"]
