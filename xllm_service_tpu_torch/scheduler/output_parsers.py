"""Reasoning + tool-call output parsing (full-text and streaming).

Parity: the reference routes parsing through engine libraries
(`scheduler/xllm_chat_parse_bridge.cpp`: model-id substring → parser
model_type for qwen2/qwen3/kimi_k2/deepseek_v3/v32/glm4_moe/step3;
"auto" resolution of tool-call/reasoning parser names; non-stream parse to
{text, reasoning_content, ToolCall[], finish_reason}; stream-parser factory)
and `response_handler.cpp:205-353` (incremental reasoning split + tool-call
parsing, finish_reason stop→tool_calls rewrite). Those engine libs are empty
submodules, so the mechanism here is self-contained: a tag-delimited
splitter driven by per-model-family tag tables.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class FamilyTags:
    reasoning_open: str = "<think>"
    reasoning_close: str = "</think>"
    tool_open: str = "<tool_call>"
    tool_close: str = "</tool_call>"
    # Some families emit reasoning from token 0 with no opening tag
    # (deepseek-r1 style); the parser then starts in REASONING state.
    implicit_reasoning_open: bool = False


# Model-id substring → family tags (reference
# `xllm_chat_parse_bridge.cpp:49-78` maps qwen2/qwen3/kimi_k2/deepseek_v3/
# v32/glm4_moe/step3).
_FAMILY_TABLE: list[tuple[str, FamilyTags]] = [
    ("deepseek-r1", FamilyTags(implicit_reasoning_open=True,
                               tool_open="<|tool▁call▁begin|>",
                               tool_close="<|tool▁call▁end|>")),
    ("deepseek", FamilyTags(tool_open="<|tool▁call▁begin|>",
                            tool_close="<|tool▁call▁end|>")),
    ("kimi", FamilyTags(tool_open="<|tool_call_begin|>",
                        tool_close="<|tool_call_end|>")),
    ("glm4", FamilyTags()),
    ("glm-4", FamilyTags()),
    ("step3", FamilyTags()),
    ("qwen3", FamilyTags()),
    ("qwen", FamilyTags()),
]
_DEFAULT_TAGS = FamilyTags()


def resolve_family_tags(model_id: str, tool_call_parser: str = "auto",
                        reasoning_parser: str = "auto") -> FamilyTags:
    """"auto" resolves by model-id substring (reference
    `xllm_chat_parse_bridge.cpp:80-119`); explicit parser names select a
    family directly."""
    if tool_call_parser not in ("", "auto"):
        model_id = tool_call_parser
    if reasoning_parser not in ("", "auto") and tool_call_parser in ("", "auto"):
        model_id = reasoning_parser
    low = (model_id or "").lower()
    for sub, tags in _FAMILY_TABLE:
        if sub in low:
            return tags
    return _DEFAULT_TAGS


@dataclass
class ToolCall:
    id: str = ""
    name: str = ""
    arguments: str = "{}"

    def to_openai(self, index: int) -> dict[str, Any]:
        return {"index": index, "id": self.id, "type": "function",
                "function": {"name": self.name, "arguments": self.arguments}}


def _new_tool_call_id() -> str:
    return "call_" + uuid.uuid4().hex[:24]


def _parse_tool_payload(raw: str) -> Optional[ToolCall]:
    """Parse one tool block body: JSON {"name":..., "arguments":{...}} (the
    hermes/qwen format) with fallbacks for name-prefixed variants."""
    raw = raw.strip()
    try:
        obj = json.loads(raw)
        if isinstance(obj, dict) and "name" in obj:
            args = obj.get("arguments", obj.get("parameters", {}))
            return ToolCall(id=_new_tool_call_id(), name=str(obj["name"]),
                            arguments=json.dumps(args) if not isinstance(args, str) else args)
    except json.JSONDecodeError:
        pass
    # "name\n{json}" variant (deepseek-style sections).
    m = re.match(r"\s*([\w.\-/]+)\s*\n(\{.*\})\s*$", raw, re.S)
    if m:
        try:
            args_obj = json.loads(m.group(2))
            return ToolCall(id=_new_tool_call_id(), name=m.group(1),
                            arguments=json.dumps(args_obj))
        except json.JSONDecodeError:
            return None
    return None


@dataclass
class ParsedChatOutput:
    content: str = ""
    reasoning_content: str = ""
    tool_calls: list[ToolCall] = field(default_factory=list)
    finish_reason: str = "stop"


def parse_chat_output(text: str, finish_reason: str,
                      tags: FamilyTags) -> ParsedChatOutput:
    """Full-text (non-stream) parse (reference
    `xllm_chat_parse_bridge.cpp:122-201` + finish_reason rewrite in
    `response_handler.cpp:437-525`)."""
    reasoning = ""
    rest = text
    if tags.implicit_reasoning_open and tags.reasoning_close in rest:
        reasoning, _, rest = rest.partition(tags.reasoning_close)
    elif tags.reasoning_open in rest:
        before, _, after = rest.partition(tags.reasoning_open)
        body, _, tail = after.partition(tags.reasoning_close)
        reasoning = body
        rest = before + tail
    tool_calls: list[ToolCall] = []
    content_parts: list[str] = []
    while tags.tool_open in rest:
        before, _, after = rest.partition(tags.tool_open)
        content_parts.append(before)
        body, closed, tail = after.partition(tags.tool_close)
        tc = _parse_tool_payload(body)
        if tc is not None:
            tool_calls.append(tc)
        elif not closed:
            content_parts.append(tags.tool_open + body)
        rest = tail
    content_parts.append(rest)
    if finish_reason == "stop" and tool_calls:
        finish_reason = "tool_calls"   # reference rewrite, response_handler.cpp:300-308
    return ParsedChatOutput(
        content="".join(content_parts).strip("\n"),
        reasoning_content=reasoning.strip("\n"),
        tool_calls=tool_calls,
        finish_reason=finish_reason,
    )


# ---------------------------------------------------------------- streaming
@dataclass
class StreamEvent:
    kind: str                      # "content" | "reasoning" | "tool_call"
    text: str = ""                 # for content/reasoning deltas
    tool_index: int = -1           # for tool_call events
    tool_id: str = ""              # set on the first delta of a call
    tool_name: str = ""            # set on the first delta of a call
    tool_args_delta: str = ""


class StreamChatParser:
    """Incremental splitter (reference engine `StreamOutputParser` used at
    `response_handler.cpp:243-308`). Feeds arbitrary chunk boundaries;
    buffers the longest suffix that could be a partial tag; emits reasoning /
    content / tool-call deltas. Tool-call bodies are accumulated until the
    closing tag, then emitted as one name + arguments delta (argument
    token-level streaming inside a JSON body is not attempted — the
    arguments string is still delivered incrementally per tool call)."""

    # Matches the hermes/qwen tool header up to the start of the arguments
    # value, enabling incremental argument streaming.
    _HEADER_RE = re.compile(
        r'\s*\{\s*"name"\s*:\s*"([^"]*)"\s*,\s*'
        r'"(?:arguments|parameters)"\s*:\s*', re.S)

    def __init__(self, tags: FamilyTags):
        self._tags = tags
        self._buf = ""
        self._state = "reasoning" if tags.implicit_reasoning_open else "normal"
        self._tool_count = 0
        self.saw_tool_call = False
        self._all_tags = [tags.reasoning_open, tags.reasoning_close,
                          tags.tool_open, tags.tool_close]
        # Incremental tool-argument scanner state.
        self._args_depth = 0
        self._args_in_str = False
        self._args_escape = False
        self._args_started = False

    def _holdback_len(self, s: str) -> int:
        """Longest suffix of s that is a proper prefix of any tag."""
        max_hold = 0
        for tag in self._all_tags:
            for k in range(min(len(tag) - 1, len(s)), 0, -1):
                if tag.startswith(s[-k:]):
                    max_hold = max(max_hold, k)
                    break
        return max_hold

    def feed(self, delta: str) -> list[StreamEvent]:
        self._buf += delta
        events: list[StreamEvent] = []
        while True:
            progressed = self._step(events)
            if not progressed:
                break
        # Flush safe text (keep potential partial tag).
        if self._state in ("normal", "reasoning") and self._buf:
            hold = self._holdback_len(self._buf)
            emit, self._buf = self._buf[:len(self._buf) - hold], self._buf[len(self._buf) - hold:]
            if emit:
                events.append(StreamEvent(
                    kind="reasoning" if self._state == "reasoning" else "content",
                    text=emit))
        return events

    def _step(self, events: list[StreamEvent]) -> bool:
        t = self._tags
        if self._state == "normal":
            io = self._buf.find(t.tool_open)
            ir = self._buf.find(t.reasoning_open)
            idx, tag, nxt = -1, "", ""
            if io != -1 and (ir == -1 or io < ir):
                idx, tag, nxt = io, t.tool_open, "tool"
            elif ir != -1:
                idx, tag, nxt = ir, t.reasoning_open, "reasoning"
            if idx == -1:
                return False
            if idx > 0:
                events.append(StreamEvent(kind="content", text=self._buf[:idx]))
            self._buf = self._buf[idx + len(tag):]
            self._state = nxt
            return True
        if self._state == "reasoning":
            idx = self._buf.find(t.reasoning_close)
            if idx == -1:
                return False
            if idx > 0:
                events.append(StreamEvent(kind="reasoning", text=self._buf[:idx]))
            self._buf = self._buf[idx + len(t.reasoning_close):]
            self._state = "normal"
            return True
        if self._state == "tool_tail":
            # Swallow the payload's closing brace/whitespace + close tag.
            idx = self._buf.find(t.tool_close)
            if idx == -1:
                hold = self._holdback_len(self._buf)
                keep = self._buf[len(self._buf) - hold:] if hold else ""
                self._buf = keep
                return False
            self._buf = self._buf[idx + len(t.tool_close):]
            self._state = "normal"
            return True
        if self._state == "tool":
            # Header phase: stream the name as soon as the hermes/qwen
            # header parses; arguments then stream incrementally (OpenAI
            # tool_calls delta behavior — the reference delegates this to
            # its engine StreamOutputParser).
            m = self._HEADER_RE.match(self._buf)
            idx = self._buf.find(t.tool_close)
            if m is not None and (idx == -1 or m.end() <= idx):
                self.saw_tool_call = True
                events.append(StreamEvent(
                    kind="tool_call", tool_index=self._tool_count,
                    tool_id=_new_tool_call_id(), tool_name=m.group(1)))
                self._buf = self._buf[m.end():]
                self._state = "tool_args"
                self._args_depth = 0
                self._args_in_str = False
                self._args_escape = False
                self._args_started = False
                return True
            if idx == -1:
                return False
            # No parseable header before the close tag: fall back to the
            # whole-body parse (name\njson variants etc.).
            body = self._buf[:idx]
            self._buf = self._buf[idx + len(t.tool_close):]
            self._state = "normal"
            tc = _parse_tool_payload(body)
            if tc is not None:
                self.saw_tool_call = True
                events.append(StreamEvent(
                    kind="tool_call", tool_index=self._tool_count,
                    tool_id=tc.id, tool_name=tc.name,
                    tool_args_delta=tc.arguments))
                self._tool_count += 1
            else:
                events.append(StreamEvent(
                    kind="content", text=t.tool_open + body + t.tool_close))
            return True
        # tool_args state: stream the JSON arguments value char-by-char,
        # tracking nesting so we stop exactly at the value's end.
        end = self._scan_args_value()
        if end is None:
            if self._buf:
                events.append(StreamEvent(kind="tool_call",
                                          tool_index=self._tool_count,
                                          tool_args_delta=self._buf))
                self._buf = ""
            return False
        if end > 0:
            events.append(StreamEvent(kind="tool_call",
                                      tool_index=self._tool_count,
                                      tool_args_delta=self._buf[:end]))
        self._buf = self._buf[end:]
        self._tool_count += 1
        self._state = "tool_tail"
        return True

    def _scan_args_value(self):
        """Advance the JSON scanner over the buffer; return the index one
        past the arguments value if it completes, else None (all buffered
        chars are safely emittable)."""
        for i, ch in enumerate(self._buf):
            if self._args_in_str:
                if self._args_escape:
                    self._args_escape = False
                elif ch == "\\":
                    self._args_escape = True
                elif ch == '"':
                    self._args_in_str = False
                    if self._args_depth == 0:
                        return i + 1          # bare string value
                continue
            if ch == '"':
                self._args_in_str = True
                self._args_started = True
            elif ch in "{[":
                self._args_depth += 1
                self._args_started = True
            elif ch in "}]":
                if self._args_depth == 0:
                    return i                  # enclosing payload's brace
                self._args_depth -= 1
                if self._args_depth == 0:
                    return i + 1
            elif not self._args_started and not ch.isspace():
                self._args_started = True     # number/bool/null scalar
            elif self._args_started and self._args_depth == 0 and \
                    (ch in ",}" or ch.isspace()):
                return i                      # scalar ended
        return None

    def finalize(self) -> list[StreamEvent]:
        """Flush whatever is buffered at stream end."""
        events: list[StreamEvent] = []
        if self._state == "tool" and self._buf:
            tc = _parse_tool_payload(self._buf)
            if tc is not None:
                self.saw_tool_call = True
                events.append(StreamEvent(
                    kind="tool_call", tool_index=self._tool_count,
                    tool_id=tc.id, tool_name=tc.name, tool_args_delta=tc.arguments))
            else:
                events.append(StreamEvent(kind="content",
                                          text=self._tags.tool_open + self._buf))
        elif self._state == "tool_args" and self._buf:
            # Truncated stream: flush what we have of the arguments.
            events.append(StreamEvent(kind="tool_call",
                                      tool_index=self._tool_count,
                                      tool_args_delta=self._buf))
        elif self._state not in ("tool_tail",) and self._buf:
            events.append(StreamEvent(
                kind="reasoning" if self._state == "reasoning" else "content",
                text=self._buf))
        self._buf = ""
        return events
