"""Request and engine-output types.

Parity: reference `xllm_service/request/request.h:28-85` (Request) and
`common/xllm/output.h:68-133` / `status.h` (llm::RequestOutput, Status).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .hashing import extend_prefix_block_hashes, prefix_block_hashes
from .types import Routing, RequestMetrics, now_ms


class StatusCode(enum.IntEnum):
    """Mirror of the reference's llm::StatusCode (`common/xllm/status.h`)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    RESOURCE_EXHAUSTED = 8
    UNAVAILABLE = 14


@dataclass
class Status:
    code: StatusCode = StatusCode.OK
    message: str = ""

    def ok(self) -> bool:
        return self.code == StatusCode.OK


@dataclass
class LogProbData:
    token: str = ""
    token_id: int = -1
    logprob: float = 0.0


@dataclass
class LogProb:
    """One generated token's logprob + top alternatives
    (reference `output.h` LogProb; proto `DisaggStreamGeneration.logprobs`)."""

    token: str = ""
    token_id: int = -1
    logprob: float = 0.0
    top_logprobs: list[LogProbData] = field(default_factory=list)


@dataclass
class SequenceOutput:
    """One choice's incremental output
    (reference proto `xllm_rpc_service.proto:126-142` SequenceOutput)."""

    index: int = 0
    text: str = ""
    token_ids: list[int] = field(default_factory=list)
    finish_reason: str = ""
    logprobs: list[LogProb] = field(default_factory=list)


@dataclass
class Usage:
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0

    @property
    def num_total_tokens(self) -> int:
        return self.num_prompt_tokens + self.num_generated_tokens


@dataclass
class RequestOutput:
    """Engine → service generation delta (reference `output.h:68-133`
    llm::RequestOutput / proto DisaggStreamGeneration)."""

    request_id: str = ""
    service_request_id: str = ""
    status: Status = field(default_factory=Status)
    outputs: list[SequenceOutput] = field(default_factory=list)
    usage: Optional[Usage] = None
    finished: bool = False
    # True when the request finished during the prefill stage (e.g. hit a stop
    # condition at first token) — lets the scheduler account FINISH_PREFILL
    # vs FINISH_DECODE (reference proto field `finished_on_prefill_instance`).
    finished_on_prefill: bool = False
    # Monotonic per-request delivery sequence number, assigned by the engine
    # agent's streamer. The Generations POST is retried on transient network
    # failure; the service dedupes on this so a retry whose original was in
    # fact processed (response lost) cannot double-deliver deltas.
    delta_seq: Optional[int] = None
    # Sender identity. After a transparent failover the request is bound to
    # new incarnations; deltas still in flight from the dead incarnation
    # must be dropped, which requires each delta to carry who produced it.
    instance: str = ""
    incarnation: str = ""

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "request_id": self.request_id,
            "service_request_id": self.service_request_id,
            "status": {"code": int(self.status.code), "message": self.status.message},
            "outputs": [
                {
                    "index": o.index,
                    "text": o.text,
                    "token_ids": list(o.token_ids),
                    "finish_reason": o.finish_reason,
                    "logprobs": [
                        {
                            "token": lp.token,
                            "token_id": lp.token_id,
                            "logprob": lp.logprob,
                            "top_logprobs": [
                                {"token": t.token, "token_id": t.token_id, "logprob": t.logprob}
                                for t in lp.top_logprobs
                            ],
                        }
                        for lp in o.logprobs
                    ],
                }
                for o in self.outputs
            ],
            "finished": self.finished,
            "finished_on_prefill": self.finished_on_prefill,
        }
        if self.delta_seq is not None:
            d["delta_seq"] = self.delta_seq
        if self.instance:
            d["instance"] = self.instance
        if self.incarnation:
            d["incarnation"] = self.incarnation
        if self.usage is not None:
            d["usage"] = {
                "num_prompt_tokens": self.usage.num_prompt_tokens,
                "num_generated_tokens": self.usage.num_generated_tokens,
            }
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RequestOutput":
        st = d.get("status") or {}
        usage = d.get("usage")
        return cls(
            request_id=d.get("request_id", ""),
            service_request_id=d.get("service_request_id", ""),
            status=Status(StatusCode(st.get("code", 0)), st.get("message", "")),
            outputs=[
                SequenceOutput(
                    index=o.get("index", 0),
                    text=o.get("text", ""),
                    token_ids=list(o.get("token_ids", ())),
                    finish_reason=o.get("finish_reason", "") or "",
                    logprobs=[
                        LogProb(
                            token=lp.get("token", ""),
                            token_id=lp.get("token_id", -1),
                            logprob=lp.get("logprob", 0.0),
                            top_logprobs=[
                                LogProbData(t.get("token", ""), t.get("token_id", -1), t.get("logprob", 0.0))
                                for t in lp.get("top_logprobs", ())
                            ],
                        )
                        for lp in o.get("logprobs", ())
                    ],
                )
                for o in d.get("outputs", ())
            ],
            usage=Usage(usage.get("num_prompt_tokens", 0), usage.get("num_generated_tokens", 0)) if usage else None,
            finished=bool(d.get("finished", False)),
            finished_on_prefill=bool(d.get("finished_on_prefill", False)),
            delta_seq=d.get("delta_seq"),
            instance=d.get("instance", ""),
            incarnation=d.get("incarnation", ""),
        )


# Called with each RequestOutput delta; returns False to request cancellation
# (mirrors reference OutputCallback semantics, `output.h`).
OutputCallback = Callable[[RequestOutput], bool]


@dataclass
class SamplingParams:
    """Generation controls parsed from the OpenAI request body."""

    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    n: int = 1
    logprobs: bool = False
    top_logprobs: int = 0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    seed: Optional[int] = None
    ignore_eos: bool = False
    echo: bool = False
    # OpenAI logit_bias: token id -> additive bias (first NUM_BIAS entries
    # applied device-side).
    logit_bias: dict[int, float] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        from dataclasses import asdict

        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SamplingParams":
        sp = cls(**{k: v for k, v in d.items()
                    if k in cls.__dataclass_fields__})
        # JSON round-trips dict keys as strings.
        sp.logit_bias = {int(k): float(v)
                         for k, v in (sp.logit_bias or {}).items()}
        return sp


@dataclass
class Request:
    """Per-request record held by the service while the request is in flight.

    Parity: reference `request/request.h:28-85` — model, ids, stream flags,
    `offline` (online/offline hybrid scheduling hook), prompt/messages/tools,
    token_ids, routing + bound incarnation ids, prefill_stage_finished,
    num_generated_tokens, estimated ttft, callbacks, latest_generate_time.
    """

    service_request_id: str = ""
    request_id: str = ""          # client-visible id (cmpl-... / chatcmpl-...)
    model: str = ""
    stream: bool = False
    include_usage: bool = False   # stream_options.include_usage
    offline: bool = False         # online/offline hybrid scheduling hook
    priority: int = 0             # higher = more urgent (offline default 0)
    # Overload plane (overload/): admission priority class
    # ("interactive" | "batch" — batch is shed first under overload and
    # max_tokens-clamped under brownout), the absolute end-to-end
    # deadline (epoch ms; 0 = none — carried in the enriched payload and
    # the handoff wire, enforced at every hop), and whether this request
    # holds an admission-gate slot (released exactly once at exit).
    priority_class: str = "interactive"
    deadline_ms: int = 0
    admitted: bool = False
    # Inputs.
    prompt: str = ""
    messages: list[dict[str, Any]] = field(default_factory=list)
    tools: list[dict[str, Any]] = field(default_factory=list)
    has_images: bool = False
    chat_template_kwargs: dict[str, Any] = field(default_factory=dict)
    token_ids: list[int] = field(default_factory=list)
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # Completions `echo`: prompt chunk already streamed back.
    echo_emitted: bool = False
    # Routing decision + bound incarnations (stale-output suppression).
    routing: Routing = field(default_factory=Routing)
    prefill_incarnation: str = ""
    decode_incarnation: str = ""
    # Progress.
    prefill_stage_finished: bool = False
    num_generated_tokens: int = 0
    metrics: RequestMetrics = field(default_factory=RequestMetrics)
    created_time_ms: int = field(default_factory=now_ms)
    latest_generate_time_ms: int = field(default_factory=now_ms)
    # Callbacks (installed by the HTTP layer / tests).
    output_callback: Optional[OutputCallback] = None
    trace_callback: Optional[Callable[[str, Any], None]] = None
    # Tracing (common/tracing.py): the root span owned by this request
    # (ended at exit accounting) and its portable context, carried in the
    # enriched engine payload / RPC headers so downstream hops parent
    # their spans correctly. `Any` to keep this module import-light.
    span: Optional[Any] = None
    trace: Optional[Any] = None
    # Memoized chained block hashes of token_ids (common/hashing.py):
    # computed once (scheduler.tokenize stage warms it for CAR) and reused
    # by the CAR match, failover re-selection and any writeback path —
    # token_ids only ever GROWS for a live request (failover prompt
    # extension), so the chain extends incrementally.
    _block_hashes: Optional[list] = field(default=None, init=False,
                                          repr=False)
    _hash_block_size: int = field(default=0, init=False, repr=False)

    def prefix_hashes(self, block_size: int) -> list:
        """Chained block hashes of ``token_ids``, memoized on the request.
        Safe because a request's token prefix is append-only; a different
        ``block_size`` (config reload between calls) recomputes."""
        n_blocks = len(self.token_ids) // block_size if block_size > 0 else 0
        cached = self._block_hashes
        if cached is not None and self._hash_block_size == block_size:
            if len(cached) == n_blocks:
                return cached
            if len(cached) < n_blocks:
                cached = extend_prefix_block_hashes(
                    cached, self.token_ids, block_size)
                self._block_hashes = cached
                return cached
        cached = prefix_block_hashes(self.token_ids, block_size)
        self._hash_block_size = block_size
        self._block_hashes = cached
        return cached

    def touch(self) -> None:
        self.latest_generate_time_ms = now_ms()
