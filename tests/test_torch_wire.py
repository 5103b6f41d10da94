"""The port's dispatch, heartbeat and telemetry wire (``rpc/wire.py`` over
``rpc/msgpack_lite.py``) against the reference's ``rpc/wire.py`` (its
native encoder where it is built, else the msgpack package), byte for
byte: ``encode_dispatch`` in both formats on hypothesis payloads of the
enriched dispatch's shape (``token_ids`` up to 8192, float64 sampling
fields, routing, the trace context), the Generations batch, the tagged
telemetry frames with a heartbeat's raw 16-byte KV-event keys
(``KvCacheEvent.to_wire_dict``), ``decode_body`` as their inverse on both
sides, ``negotiate``, and ``KvCacheEvent.merge`` of two replicas'
deltas."""

import json

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common.types import KvCacheEvent as RefEvent
from xllm_service_tpu.rpc import wire as ref_wire
from xllm_service_tpu_torch.common.hashing import prefix_block_hashes
from xllm_service_tpu_torch.common.types import KvCacheEvent
from xllm_service_tpu_torch.rpc import wire

FLOATS = st.floats(allow_nan=False, allow_infinity=False)
HEX = "0123456789abcdef"
TEXT = st.text(max_size=24)

DISPATCH = st.fixed_dictionaries({
    "model": TEXT,
    "service_request_id": TEXT,
    "request_id": TEXT,
    "source_service_addr": TEXT,
    "token_ids": st.lists(st.integers(0, 2**31 - 1), max_size=8192),
    "max_tokens": st.integers(1, 1 << 16),
    "temperature": FLOATS,
    "top_p": FLOATS,
    "top_k": st.integers(-1, 1 << 20),
    "frequency_penalty": FLOATS,
    "presence_penalty": FLOATS,
    "repetition_penalty": FLOATS,
    "seed": st.one_of(st.none(), st.integers(0, 2**64 - 1)),
    "stop": st.lists(TEXT, max_size=3),
    "stop_token_ids": st.lists(st.integers(0, 1 << 20), max_size=4),
    "logprobs": st.booleans(),
    "top_logprobs": st.integers(0, 20),
    "logit_bias": st.dictionaries(st.integers(0, 1 << 17).map(str), FLOATS,
                                  max_size=3),
    "ignore_eos": st.booleans(),
    "stream": st.booleans(),
    "offline": st.booleans(),
    "priority": st.integers(-(2**31), 2**31),
    "deadline_ms": st.integers(0, 2**53),
    "routing": st.fixed_dictionaries({"prefill_name": TEXT,
                                      "decode_name": TEXT}),
    "trace_context": st.fixed_dictionaries({
        "trace_id": st.text(HEX, min_size=32, max_size=32),
        "span_id": st.text(HEX, min_size=16, max_size=16)}),
})

GEN = st.fixed_dictionaries({
    "service_request_id": TEXT,
    "request_id": TEXT,
    "delta_seq": st.integers(1, 1 << 30),
    "instance": TEXT,
    "incarnation": st.text(HEX, max_size=12),
    "finished": st.booleans(),
    "status": st.fixed_dictionaries({"code": st.integers(0, 16),
                                     "message": TEXT}),
    "outputs": st.lists(st.fixed_dictionaries({
        "index": st.integers(0, 8),
        "text": TEXT,
        "token_ids": st.lists(st.integers(0, 2**31 - 1), max_size=16),
        "finish_reason": st.one_of(st.none(), st.sampled_from(
            ["stop", "length"])),
        "logprobs": st.lists(st.fixed_dictionaries({
            "token": TEXT, "token_id": st.integers(0, 1 << 20),
            "logprob": FLOATS}), max_size=2),
    }), max_size=2),
    "usage": st.one_of(st.none(), st.fixed_dictionaries({
        "num_prompt_tokens": st.integers(0, 1 << 20),
        "num_generated_tokens": st.integers(0, 1 << 20)})),
})

KEYS = st.lists(st.binary(min_size=16, max_size=16), max_size=6)


@settings(max_examples=40, deadline=None)
@given(DISPATCH)
def test_encode_dispatch_is_the_references_in_both_formats(payload):
    for fmt in (wire.WIRE_MSGPACK, wire.WIRE_JSON):
        got = wire.encode_dispatch(payload, fmt)
        assert got == ref_wire.encode_dispatch(payload, fmt)
        body, ctype = got
        assert wire.decode_body(ctype, body) == payload
        assert ref_wire.decode_body(ctype, body) == payload
    assert wire.pack_dispatch(payload) == msgpack.packb(payload,
                                                        use_bin_type=True)


def test_a_full_8192_token_dispatch():
    payload = {"service_request_id": "s", "token_ids": list(range(8192)),
               "temperature": 0.7, "top_p": 0.95, "seed": 2**63,
               "trace_context": {"trace_id": "a" * 32, "span_id": "b" * 16}}
    for fmt in (wire.WIRE_MSGPACK, wire.WIRE_JSON):
        body, ctype = wire.encode_dispatch(payload, fmt)
        assert (body, ctype) == ref_wire.encode_dispatch(payload, fmt)
        assert wire.decode_body(ctype, body) == payload


@settings(max_examples=40, deadline=None)
@given(st.lists(GEN, max_size=4), TEXT, KEYS, KEYS, KEYS)
def test_telemetry_frames_are_the_references(gens, dest, stored, removed,
                                             offloaded):
    lists = dict(stored=stored, removed=removed, offloaded=offloaded)
    beat = {"name": "127.0.0.1:9", "incarnation_id": "inc",
            "load_metrics": {"waiting_requests_num": 1,
                             "running_requests_num": 2,
                             "hbm_cache_usage_perc": 0.25},
            "latency_metrics": {"recent_max_ttft": 12.5,
                                "recent_max_tbt": 0.0}}
    frames = [
        {"t": wire.TELEMETRY_HB,
         "d": dict(beat, kv_cache_event=KvCacheEvent(**lists)
                   .to_wire_dict())},
        {"t": wire.TELEMETRY_GENS, "dest": dest, "d": {"gens": gens}}]
    ref_frames = [
        {"t": ref_wire.TELEMETRY_HB,
         "d": dict(beat, kv_cache_event=RefEvent(**lists).to_wire_dict())},
        {"t": ref_wire.TELEMETRY_GENS, "dest": dest, "d": {"gens": gens}}]
    got = wire.encode_telemetry(frames)
    assert got == ref_wire.encode_telemetry(ref_frames)
    body, ctype = got
    assert ctype == wire.MSGPACK_CONTENT_TYPE
    assert wire.decode_body(ctype, body) == ref_wire.decode_body(ctype,
                                                                 body)
    assert wire.decode_body(ctype, body) == {"frames": frames}
    # The Generations batch of the direct wire, both formats.
    for fmt in (wire.WIRE_MSGPACK, wire.WIRE_JSON):
        assert wire.encode_dispatch({"gens": gens}, fmt) == \
            ref_wire.encode_dispatch({"gens": gens}, fmt)


def test_to_wire_dict_takes_hex_and_raw_keys():
    hashes = prefix_block_hashes(list(range(400)), 32)
    lists = dict(stored=hashes[:4], removed=[h.hex() for h in hashes[4:8]],
                 offloaded=hashes[8:])
    got, want = KvCacheEvent(**lists), RefEvent(**lists)
    assert got.to_wire_dict() == want.to_wire_dict()
    assert all(len(k) == 16 for k in got.to_wire_dict()["removed"])
    assert wire.pack_dispatch(got.to_wire_dict()) == \
        ref_wire.pack_dispatch(want.to_wire_dict())
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("ctype,body", [
    (wire.MSGPACK_CONTENT_TYPE, b"\xc1"),          # a reserved type byte
    (wire.MSGPACK_CONTENT_TYPE, b"\x92\x01"),      # truncated
    (wire.MSGPACK_CONTENT_TYPE, b"\x01\x02"),      # trailing data
    (wire.MSGPACK_CONTENT_TYPE, b"\xa2\xff\xfe"),  # not UTF-8
    ("application/msgpack; charset=binary", b"\xd9"),
    (wire.JSON_CONTENT_TYPE, b"{"),
    ("", b"not json"),
])
def test_a_malformed_body_is_a_value_error_on_both_sides(ctype, body):
    for mod in (wire, ref_wire):
        with pytest.raises(ValueError):
            mod.decode_body(ctype, body)


@pytest.mark.parametrize("formats", [
    None, [], ["json"], ["msgpack"], ["msgpack", "json"], ["json", "x"],
    "msgpack", 7, {"msgpack": 1}, ("msgpack",)])
def test_negotiate_gives_the_references_answer(formats):
    assert wire.negotiate(formats) == ref_wire.negotiate(formats)


SMALL_KEYS = st.lists(st.sampled_from([bytes([i]) * 16 for i in range(8)]),
                      max_size=6, unique=True)


@settings(max_examples=200, deadline=None)
@given(SMALL_KEYS, SMALL_KEYS, SMALL_KEYS, SMALL_KEYS, SMALL_KEYS,
       SMALL_KEYS)
def test_merge_of_two_replicas_deltas_is_the_references(s1, r1, o1, s2, r2,
                                                        o2):
    got = KvCacheEvent(list(s1), list(r1), list(o1))
    got.merge(KvCacheEvent(list(s2), list(r2), list(o2)))
    want = RefEvent(list(s1), list(r1), list(o1))
    want.merge(RefEvent(list(s2), list(r2), list(o2)))
    assert (got.stored, got.removed, got.offloaded) == \
        (want.stored, want.removed, want.offloaded)
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
