"""Request and engine-output types (copy of the part of
``xllm_service_tpu/common/request.py`` the engine and its agent use,
with the wire forms of a delta and of the sampling controls)."""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass, field
from typing import Any, Optional


class StatusCode(enum.IntEnum):
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
    """One generated token's logprob + top alternatives."""

    token: str = ""
    token_id: int = -1
    logprob: float = 0.0
    top_logprobs: list[LogProbData] = field(default_factory=list)


@dataclass
class SequenceOutput:
    """One choice's incremental output."""

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
    """Engine → service generation delta."""

    request_id: str = ""
    service_request_id: str = ""
    status: Status = field(default_factory=Status)
    outputs: list[SequenceOutput] = field(default_factory=list)
    usage: Optional[Usage] = None
    finished: bool = False
    # True when the request finished at its first token.
    finished_on_prefill: bool = False
    # Monotonic per-request delivery sequence number, assigned by the agent's
    # streamer: the service dedupes on it, so a retried Generations POST
    # whose original was processed cannot deliver a delta twice.
    delta_seq: Optional[int] = None
    # Sender identity: after a failover the service drops deltas from an
    # incarnation the request is no longer bound to.
    instance: str = ""
    incarnation: str = ""

    def to_dict(self) -> dict[str, Any]:
        """The delta's wire form (one entry of a Generations batch)."""
        d: dict[str, Any] = {
            "request_id": self.request_id,
            "service_request_id": self.service_request_id,
            "status": {"code": int(self.status.code),
                       "message": self.status.message},
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
                                {"token": t.token, "token_id": t.token_id,
                                 "logprob": t.logprob}
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
    # applied on the device).
    logit_bias: dict[int, float] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SamplingParams":
        sp = cls(**{k: v for k, v in d.items()
                    if k in cls.__dataclass_fields__})
        # JSON round-trips dict keys as strings.
        sp.logit_bias = {int(k): float(v)
                         for k, v in (sp.logit_bias or {}).items()}
        return sp
