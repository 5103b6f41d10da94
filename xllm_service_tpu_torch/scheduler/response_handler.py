"""Engine output → OpenAI JSON formatting.

Parity: reference `scheduler/response_handler.{h,cpp}` (575 LoC,
SURVEY.md §2.4):

- streaming chat (`response_handler.cpp:205-353`): first-delta role message,
  reasoning split into `delta.reasoning_content`, incremental tool-call
  deltas, finish_reason stop→tool_calls rewrite, optional usage chunk,
  `[DONE]`.
- streaming completions (355-435).
- non-stream chat with full-text reasoning + tool-call parse (437-525).
- non-stream completions (527-573).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..common.call_data import ClientConnection
from ..common.request import LogProb, Request, RequestOutput, SequenceOutput
from .output_parsers import (
    FamilyTags,
    StreamChatParser,
    parse_chat_output,
    resolve_family_tags,
)


def _chat_logprobs(logprobs: list[LogProb]) -> Optional[dict[str, Any]]:
    if not logprobs:
        return None
    return {"content": [
        {
            "token": lp.token,
            "logprob": lp.logprob,
            "bytes": list(lp.token.encode("utf-8")),
            "top_logprobs": [
                {"token": t.token, "logprob": t.logprob,
                 "bytes": list(t.token.encode("utf-8"))}
                for t in lp.top_logprobs
            ],
        }
        for lp in logprobs
    ]}


def _completion_logprobs(logprobs: list[LogProb]) -> Optional[dict[str, Any]]:
    if not logprobs:
        return None
    return {
        "tokens": [lp.token for lp in logprobs],
        "token_logprobs": [lp.logprob for lp in logprobs],
        "top_logprobs": [
            {t.token: t.logprob for t in lp.top_logprobs} if lp.top_logprobs else {}
            for lp in logprobs
        ],
        "text_offset": [],
    }


def _usage_dict(output: RequestOutput) -> Optional[dict[str, Any]]:
    if output.usage is None:
        return None
    return {
        "prompt_tokens": output.usage.num_prompt_tokens,
        "completion_tokens": output.usage.num_generated_tokens,
        "total_tokens": output.usage.num_total_tokens,
    }


class AnthropicStreamState:
    """Per-request Anthropic Messages stream bookkeeping."""

    __slots__ = ("started", "block_open")

    def __init__(self):
        self.started = False
        self.block_open = False


@dataclass
class ChatStreamState:
    """Per-request streaming parse state (reference
    `create_chat_stream_parse_state`, `response_handler.cpp`)."""

    model: str
    request_id: str
    created: int = field(default_factory=lambda: int(time.time()))
    parsers: dict[int, StreamChatParser] = field(default_factory=dict)
    first_sent: set[int] = field(default_factory=set)
    tags: FamilyTags = field(default_factory=FamilyTags)

    def parser_for(self, index: int) -> StreamChatParser:
        p = self.parsers.get(index)
        if p is None:
            p = StreamChatParser(self.tags)
            self.parsers[index] = p
        return p


class ResponseHandler:
    def __init__(self, model_id: str = "", tool_call_parser: str = "auto",
                 reasoning_parser: str = "auto",
                 enable_parsing: bool = True):
        self._tags = resolve_family_tags(model_id, tool_call_parser,
                                         reasoning_parser)
        self._enable_parsing = enable_parsing

    # ----------------------------------------------- Anthropic Messages
    @staticmethod
    def _anthropic_stop_reason(finish: str) -> str:
        return "max_tokens" if finish == "length" else "end_turn"

    def send_anthropic_delta(self, conn: ClientConnection,
                             st: "AnthropicStreamState", request: Request,
                             output: RequestOutput) -> bool:
        """Anthropic Messages streaming: message_start →
        content_block_start → content_block_delta* → content_block_stop →
        message_delta → message_stop."""
        if not st.started:
            st.started = True
            if not conn.write_event("message_start", {
                    "type": "message_start",
                    "message": {
                        "id": request.request_id, "type": "message",
                        "role": "assistant", "model": request.model,
                        "content": [], "stop_reason": None,
                        "usage": {"input_tokens":
                                  request.metrics.prompt_tokens}}}):
                return False
        finish = ""
        for seq in output.outputs:
            if seq.finish_reason:
                finish = seq.finish_reason
            if not seq.text:
                continue
            if not st.block_open:
                st.block_open = True
                if not conn.write_event("content_block_start", {
                        "type": "content_block_start", "index": 0,
                        "content_block": {"type": "text", "text": ""}}):
                    return False
            if not conn.write_event("content_block_delta", {
                    "type": "content_block_delta", "index": 0,
                    "delta": {"type": "text_delta", "text": seq.text}}):
                return False
        if output.finished:
            if st.block_open:
                conn.write_event("content_block_stop",
                                 {"type": "content_block_stop", "index": 0})
            out_tokens = output.usage.num_generated_tokens \
                if output.usage else request.num_generated_tokens
            conn.write_event("message_delta", {
                "type": "message_delta",
                "delta": {"stop_reason":
                          self._anthropic_stop_reason(finish),
                          "stop_sequence": None},
                "usage": {"output_tokens": out_tokens}})
            conn.write_event("message_stop", {"type": "message_stop"})
            return conn.finish()
        return True

    def send_anthropic_result(self, conn: ClientConnection,
                              request: Request,
                              output: RequestOutput) -> bool:
        text = "".join(s.text for s in output.outputs)
        finish = next((s.finish_reason for s in output.outputs
                       if s.finish_reason), "")
        usage = output.usage
        return conn.write_and_finish({
            "id": request.request_id, "type": "message",
            "role": "assistant", "model": request.model,
            "content": [{"type": "text", "text": text}],
            "stop_reason": self._anthropic_stop_reason(finish),
            "stop_sequence": None,
            "usage": {
                "input_tokens": usage.num_prompt_tokens if usage
                else request.metrics.prompt_tokens,
                "output_tokens": usage.num_generated_tokens if usage
                else request.num_generated_tokens,
            },
        })

    def create_chat_stream_state(self, request: Request) -> ChatStreamState:
        return ChatStreamState(model=request.model,
                               request_id=request.request_id,
                               tags=self._tags)

    # ----------------------------------------------------- streaming: chat
    def send_chat_delta(self, conn: ClientConnection, state: ChatStreamState,
                        request: Request, output: RequestOutput) -> bool:
        """One Generations delta → zero or more SSE chunks. Returns False on
        client disconnect."""
        chunks: list[dict[str, Any]] = []

        def chunk(index: int, delta: dict[str, Any],
                  finish_reason: Optional[str] = None,
                  logprobs: Optional[dict[str, Any]] = None) -> dict[str, Any]:
            choice: dict[str, Any] = {"index": index, "delta": delta,
                                      "finish_reason": finish_reason}
            if logprobs is not None:
                choice["logprobs"] = logprobs
            return {"id": state.request_id, "object": "chat.completion.chunk",
                    "created": state.created, "model": state.model,
                    "choices": [choice]}

        for seq in output.outputs:
            parser = state.parser_for(seq.index)
            if seq.index not in state.first_sent:
                state.first_sent.add(seq.index)
                chunks.append(chunk(seq.index,
                                    {"role": "assistant", "content": ""}))
            lp = _chat_logprobs(seq.logprobs) if request.sampling.logprobs else None
            if self._enable_parsing:
                events = parser.feed(seq.text)
                if seq.finish_reason:
                    events += parser.finalize()
                for ev in events:
                    if ev.kind == "content" and ev.text:
                        chunks.append(chunk(seq.index, {"content": ev.text},
                                            logprobs=lp))
                        lp = None
                    elif ev.kind == "reasoning" and ev.text:
                        chunks.append(chunk(seq.index,
                                            {"reasoning_content": ev.text}))
                    elif ev.kind == "tool_call":
                        # OpenAI delta shape: first delta carries id/type/
                        # name; argument-only deltas carry just the index +
                        # arguments fragment.
                        tc_delta: dict[str, Any] = {"index": ev.tool_index}
                        fn: dict[str, Any] = {}
                        if ev.tool_id:
                            tc_delta["id"] = ev.tool_id
                            tc_delta["type"] = "function"
                        if ev.tool_name:
                            fn["name"] = ev.tool_name
                        fn["arguments"] = ev.tool_args_delta
                        tc_delta["function"] = fn
                        chunks.append(chunk(seq.index,
                                            {"tool_calls": [tc_delta]}))
            elif seq.text:
                chunks.append(chunk(seq.index, {"content": seq.text}, logprobs=lp))
            if seq.finish_reason:
                fr = seq.finish_reason
                if fr == "stop" and parser.saw_tool_call:
                    fr = "tool_calls"   # reference rewrite (response_handler.cpp:300-308)
                chunks.append(chunk(seq.index, {}, finish_reason=fr))

        if output.finished and request.include_usage:
            usage = _usage_dict(output)
            if usage is not None:
                chunks.append({"id": state.request_id,
                               "object": "chat.completion.chunk",
                               "created": state.created, "model": state.model,
                               "choices": [], "usage": usage})
        for c in chunks:
            if not conn.write(c):
                return False
        if output.finished:
            return conn.finish()
        return True

    # ---------------------------------------------- streaming: completions
    def send_completion_delta(self, conn: ClientConnection,
                              request: Request,
                              output: RequestOutput,
                              created: Optional[int] = None) -> bool:
        """Reference `response_handler.cpp:355-435`."""
        # Per-request constant (OpenAI semantics: `created` is the request
        # creation time) — also drops a time() syscall per delta.
        created = created or (request.created_time_ms // 1000) \
            or int(time.time())
        # OpenAI completions `echo`: the prompt text streams back as the
        # first chunk before any generated text.
        if request.sampling.echo and not request.echo_emitted and \
                request.prompt:
            request.echo_emitted = True
            if not conn.write({
                    "id": request.request_id, "object": "text_completion",
                    "created": created, "model": request.model,
                    "choices": [{"index": 0, "text": request.prompt,
                                 "finish_reason": None}]}):
                return False
        ok = True
        for seq in output.outputs:
            if not (seq.text or seq.finish_reason):
                continue
            choice: dict[str, Any] = {
                "index": seq.index, "text": seq.text,
                "finish_reason": seq.finish_reason or None,
            }
            if request.sampling.logprobs:
                choice["logprobs"] = _completion_logprobs(seq.logprobs)
            body: dict[str, Any] = {
                "id": request.request_id, "object": "text_completion",
                "created": created, "model": request.model,
                "choices": [choice],
            }
            if not conn.write(body):
                return False
        if output.finished:
            if request.include_usage:
                usage = _usage_dict(output)
                if usage is not None:
                    ok = conn.write({"id": request.request_id,
                                     "object": "text_completion",
                                     "created": created,
                                     "model": request.model,
                                     "choices": [], "usage": usage}) and ok
            return conn.finish() and ok
        return ok

    # ------------------------------------------------- non-stream results
    def send_chat_result(self, conn: ClientConnection, request: Request,
                         output: RequestOutput) -> bool:
        """Reference `response_handler.cpp:437-525`."""
        choices = []
        for seq in output.outputs:
            if self._enable_parsing:
                parsed = parse_chat_output(seq.text, seq.finish_reason or "stop",
                                           self._tags)
                message: dict[str, Any] = {"role": "assistant",
                                           "content": parsed.content}
                if parsed.reasoning_content:
                    message["reasoning_content"] = parsed.reasoning_content
                if parsed.tool_calls:
                    message["tool_calls"] = [
                        tc.to_openai(i) for i, tc in enumerate(parsed.tool_calls)]
                    message["content"] = parsed.content or None
                finish_reason = parsed.finish_reason
            else:
                message = {"role": "assistant", "content": seq.text}
                finish_reason = seq.finish_reason or "stop"
            choice: dict[str, Any] = {"index": seq.index, "message": message,
                                      "finish_reason": finish_reason}
            if request.sampling.logprobs:
                choice["logprobs"] = _chat_logprobs(seq.logprobs)
            choices.append(choice)
        body = {"id": request.request_id, "object": "chat.completion",
                "created": int(time.time()), "model": request.model,
                "choices": choices}
        usage = _usage_dict(output)
        if usage is not None:
            body["usage"] = usage
        return conn.write_and_finish(body)

    def send_completion_result(self, conn: ClientConnection, request: Request,
                               output: RequestOutput) -> bool:
        """Reference `response_handler.cpp:527-573`."""
        choices = []
        echo_prefix = request.prompt if request.sampling.echo else ""
        for seq in output.outputs:
            choice: dict[str, Any] = {
                "index": seq.index, "text": (echo_prefix or "") + seq.text,
                "finish_reason": seq.finish_reason or "stop",
            }
            if request.sampling.logprobs:
                choice["logprobs"] = _completion_logprobs(seq.logprobs)
            choices.append(choice)
        body = {"id": request.request_id, "object": "text_completion",
                "created": int(time.time()), "model": request.model,
                "choices": choices}
        usage = _usage_dict(output)
        if usage is not None:
            body["usage"] = usage
        return conn.write_and_finish(body)
