"""The port's OpenAI and Anthropic response bodies and its tool-call and
reasoning parsers against the JAX package's.

The same ``RequestOutput`` streams (texts cut into deltas by hypothesis)
go through ``scheduler/response_handler.py::ResponseHandler`` of each
package, for every parser family (by model id and by explicit
``tool_call_parser``/``reasoning_parser`` names): streamed chat, whole
chat, streamed and whole completions, and the Anthropic Messages frames.
The collected JSON bodies and SSE events must be equal, the random ids
(``id``) and timestamps (``created``) aside. The stream parser's events are
held to the reference's one by one.
"""

import dataclasses

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common import call_data as ref_call_data
from xllm_service_tpu.common import request as ref_request
from xllm_service_tpu.scheduler import output_parsers as ref_parsers
from xllm_service_tpu.scheduler import response_handler as ref_handler
from xllm_service_tpu_torch.common import call_data, request
from xllm_service_tpu_torch.scheduler import output_parsers, response_handler

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

REF = (ref_request, ref_call_data, ref_handler)
PORT = (request, call_data, response_handler)

# (model_id, tool_call_parser, reasoning_parser): every family of the
# parser table, by model id and by explicit parser name.
FAMILIES = [
    ("", "auto", "auto"),
    ("qwen3-8b", "auto", "auto"),
    ("Qwen2-7B", "auto", "auto"),
    ("deepseek-r1-distill", "auto", "auto"),
    ("deepseek-v3", "auto", "auto"),
    ("kimi-k2", "auto", "auto"),
    ("glm4-9b", "auto", "auto"),
    ("step3", "auto", "auto"),
    ("m", "deepseek", "auto"),
    ("m", "kimi", "auto"),
    ("m", "auto", "deepseek-r1"),
    ("m", "qwen", "qwen3"),
]


def _tags(model, tool, reasoning):
    return ref_parsers.resolve_family_tags(model, tool, reasoning)


def _texts(tags) -> list[str]:
    """Outputs that reach every parser state of a family."""
    o, c = tags.tool_open, tags.tool_close
    call = '{"name": "get_weather", "arguments": {"city": "Paris", "n": 2}}'
    return [
        "hello world",
        f"{tags.reasoning_open}step by step{tags.reasoning_close}the "
        f"answer is 4",
        "chain of thought</think>final",
        f"I will check.\n{o}\n{call}\n{c}",
        f'{o}{{"name": "a", "arguments": {{}}}}{c}'
        f'{o}{{"name": "b", "arguments": {{"y": [1, "x"]}}}}{c}',
        f"{o}oops no json",
        "unicode: héllo — 世界 ☃",
    ]


def _scrub(obj):
    """Drop the random ids and wall-clock timestamps."""
    if isinstance(obj, dict):
        return {k: (None if k in ("id", "created", "tool_id")
                    else _scrub(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    return obj


def _cuts(text: str, cuts: list[int]) -> list[str]:
    idx = sorted({min(max(0, c), len(text)) for c in cuts} | {0, len(text)})
    return [text[a:b] for a, b in zip(idx, idx[1:])] or [""]


def _outputs(mod_req, pieces, finish, usage=True):
    outs = []
    for i, piece in enumerate(pieces):
        last = i == len(pieces) - 1
        outs.append(mod_req.RequestOutput(
            service_request_id="s1",
            outputs=[mod_req.SequenceOutput(
                index=0, text=piece, token_ids=[i + 1],
                finish_reason=finish if last else "")],
            usage=mod_req.Usage(5, len(pieces)) if last and usage else None,
            finished=last))
    return outs


def _run(pkg, family, pieces, finish, logprobs=False):
    """Every handler entry point over one delta stream -> scrubbed bodies."""
    mod_req, mod_cd, mod_rh = pkg
    rh = mod_rh.ResponseHandler(*family)
    sp = mod_req.SamplingParams(logprobs=logprobs, top_logprobs=1)
    got = {}

    def lp(i):
        if not logprobs:
            return []
        return [mod_req.LogProb(token=f"t{i}", token_id=i, logprob=-0.5 * i,
                                top_logprobs=[mod_req.LogProbData(
                                    f"t{i}", i, -0.5 * i)])]

    def outs():
        o = _outputs(mod_req, pieces, finish)
        for i, x in enumerate(o):
            x.outputs[0].logprobs = lp(i)
        return o

    req = mod_req.Request(service_request_id="s1", request_id="chatcmpl-1",
                          model="m", stream=True, include_usage=True,
                          sampling=sp)
    state = rh.create_chat_stream_state(req)
    conn = mod_cd.CollectingConnection(stream=True)
    got["chat_stream_ok"] = [rh.send_chat_delta(conn, state, req, o)
                             for o in outs()]
    got["chat_stream"] = (conn.payloads, conn.finished)

    req = mod_req.Request(service_request_id="s1", request_id="chatcmpl-1",
                          model="m", stream=False, sampling=sp)
    conn = mod_cd.CollectingConnection()
    whole = outs()[-1]
    whole.outputs[0].text = "".join(pieces)
    rh.send_chat_result(conn, req, whole)
    got["chat_result"] = conn.payloads

    req = mod_req.Request(service_request_id="s1", request_id="cmpl-1",
                          model="m", stream=True, include_usage=True,
                          sampling=sp)
    conn = mod_cd.CollectingConnection(stream=True)
    for o in outs():
        rh.send_completion_delta(conn, req, o)
    got["completion_stream"] = (conn.payloads, conn.finished)
    req = mod_req.Request(service_request_id="s1", request_id="cmpl-1",
                          model="m", stream=False, sampling=sp)
    conn = mod_cd.CollectingConnection()
    rh.send_completion_result(conn, req, whole)
    got["completion_result"] = conn.payloads

    req = mod_req.Request(service_request_id="s1", request_id="msg_1",
                          model="m", stream=True)
    req.metrics.prompt_tokens = 5
    ast = mod_rh.AnthropicStreamState()
    conn = mod_cd.CollectingConnection(stream=True)
    for o in outs():
        rh.send_anthropic_delta(conn, ast, req, o)
    got["anthropic_stream"] = (conn.events, conn.finished)
    conn = mod_cd.CollectingConnection()
    rh.send_anthropic_result(conn, req, whole)
    got["anthropic_result"] = conn.payloads
    return _scrub(got)


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: "|".join(f))
@pytest.mark.parametrize("finish", ["stop", "length"])
def test_bodies_match_reference_per_family(family, finish):
    for text in _texts(_tags(*family)):
        for cuts in ([], [3], [1, 2, 3, 5, 8, 13, 21, 34, 55],
                     list(range(len(text)))):
            pieces = _cuts(text, cuts)
            assert _run(PORT, family, pieces, finish) == \
                _run(REF, family, pieces, finish), (family, pieces)


@pytest.mark.parametrize("family", FAMILIES[:4], ids=lambda f: "|".join(f))
def test_logprob_bodies_match_reference(family):
    text = _texts(_tags(*family))[1]
    pieces = _cuts(text, [4, 9, 17])
    assert _run(PORT, family, pieces, "stop", logprobs=True) == \
        _run(REF, family, pieces, "stop", logprobs=True)


@settings(max_examples=60, deadline=None)
@given(family=st.sampled_from(FAMILIES), which=st.integers(0, 6),
       cuts=st.lists(st.integers(0, 120), max_size=12),
       finish=st.sampled_from(["stop", "length"]))
def test_bodies_match_reference_drawn(family, which, cuts, finish):
    text = _texts(_tags(*family))[which]
    pieces = _cuts(text, cuts)
    assert _run(PORT, family, pieces, finish) == \
        _run(REF, family, pieces, finish)


def _events(mod, tags_args, pieces):
    p = mod.StreamChatParser(mod.resolve_family_tags(*tags_args))
    out = []
    for piece in pieces:
        out += [dataclasses.asdict(e) for e in p.feed(piece)]
    out += [dataclasses.asdict(e) for e in p.finalize()]
    return out, p.saw_tool_call


@settings(max_examples=80, deadline=None)
@given(family=st.sampled_from(FAMILIES), which=st.integers(0, 6),
       cuts=st.lists(st.integers(0, 120), max_size=16))
def test_stream_parser_events_match_reference(family, which, cuts):
    text = _texts(_tags(*family))[which]
    pieces = _cuts(text, cuts)
    assert _scrub(_events(output_parsers, family, pieces)) == \
        _scrub(_events(ref_parsers, family, pieces))


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: "|".join(f))
def test_full_parse_matches_reference(family):
    for text in _texts(_tags(*family)):
        for finish in ("stop", "length"):
            got = output_parsers.parse_chat_output(
                text, finish, output_parsers.resolve_family_tags(*family))
            want = ref_parsers.parse_chat_output(
                text, finish, ref_parsers.resolve_family_tags(*family))
            assert _scrub(dataclasses.asdict(got)) == \
                _scrub(dataclasses.asdict(want))
