"""The port's standard-library msgpack codec (``rpc/msgpack_lite.py``)
against the ``msgpack`` package, byte for byte both ways, on every frame
the PD slice sends (handoffs with inline ``kv``, ``kv_stream`` and
``kv_ref``; a first logprob with its ``top`` list and None; the stream
pull's request and reply), on the scalars of the subset, and on the
port's ``pack_handoff`` against the reference's for the same handoff (f32
and bf16 KV)."""

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common.request import LogProb as RefLogProb
from xllm_service_tpu.common.request import LogProbData as RefLogProbData
from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine import agent as ref_agent
from xllm_service_tpu.engine.engine import PrefillHandoff as RefHandoff
from xllm_service_tpu_torch.common.request import (
    LogProb,
    LogProbData,
    SamplingParams,
)
from xllm_service_tpu_torch.engine import agent as port_agent
from xllm_service_tpu_torch.engine.engine import PrefillHandoff
from xllm_service_tpu_torch.rpc.msgpack_lite import packb, unpackb

UUID = 2**63 - 1


def same(obj):
    """packb(obj) is msgpack's bytes, and each side reads the other's."""
    want = msgpack.packb(obj, use_bin_type=True)
    got = packb(obj)
    assert got == want
    assert unpackb(want) == msgpack.unpackb(got, raw=False)
    return got


def _lp(mod_lp, mod_data):
    return mod_lp(token="ab", token_id=17, logprob=-0.25,
                  top_logprobs=[mod_data("ab", 17, -0.25),
                                mod_data("c", 3, -1.5)])


SAMPLING = dict(max_tokens=6, temperature=0.7, top_p=0.9, seed=11,
                stop=["\n"], stop_token_ids=[2], ignore_eos=True)


def _handoffs(dtype):
    """The same handoff for the reference (numpy KV) and the port (torch
    KV), with a first logprob."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 2, 3, 2, 16, 32)).astype(np.float32)
    if dtype == "bfloat16":
        bits = x.astype(ml_dtypes.bfloat16)
        ref_kv = bits
        port_kv = torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        ref_kv, port_kv = x, torch.from_numpy(x.copy())
    common = dict(service_request_id="req-1", request_id="r1",
                  token_ids=list(range(40)), first_token=7)
    ref = RefHandoff(**common, first_logprob=_lp(RefLogProb, RefLogProbData),
                     sampling=RefSampling(**SAMPLING), kv_blob=ref_kv)
    port = PrefillHandoff(**common, first_logprob=_lp(LogProb, LogProbData),
                          sampling=SamplingParams(**SAMPLING),
                          kv_blob=port_kv)
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inline_handoff_equals_the_reference_frame(dtype):
    ref, port = _handoffs(dtype)
    want = ref_agent.pack_handoff(ref, "127.0.0.1:9", source_instance="p:1")
    got = port_agent.pack_handoff(port, "127.0.0.1:9", source_instance="p:1")
    assert got == want
    same(msgpack.unpackb(want, raw=False))
    obj = port_agent.unpack_handoff(want)
    assert obj["kv"]["dtype"] == dtype
    assert obj["kv_blob"].dtype == port.kv_blob.dtype
    assert torch.equal(obj["kv_blob"], port.kv_blob)
    back = ref_agent.unpack_handoff(got)
    assert back["kv_blob"].tobytes() == np.asarray(ref.kv_blob).tobytes()


def test_stream_and_device_descriptors_and_no_logprob():
    ref, port = _handoffs("float32")
    ref.first_logprob = port.first_logprob = None
    stream = {"stream_uuid": UUID, "total_bytes": 98304,
              "chunk_bytes": 1 << 20, "block_bytes": 32768,
              "shape": [2, 2, 3, 2, 16, 32], "dtype": "float32",
              "checksum": "0123456789abcdef"}
    kv_ref = {"addr": "cuda-ipc:GPU-00000000-1111-2222-3333-444444444444",
              "uuid": UUID, "shape": [2, 2, 3, 2, 16, 32],
              "dtype": "bfloat16", "ipc_handle": bytes(range(64)),
              "offset": 2 << 20, "nbytes": 49152}
    for kw in (dict(kv_stream=stream), dict(kv_ref=kv_ref)):
        want = ref_agent.pack_handoff(ref, "127.0.0.1:9",
                                      source_instance="p:1",
                                      trace_context={"trace_id": "t"}, **kw)
        got = port_agent.pack_handoff(port, "127.0.0.1:9",
                                      source_instance="p:1",
                                      trace_context={"trace_id": "t"}, **kw)
        assert got == want
        obj = same(msgpack.unpackb(want, raw=False))
        assert unpackb(obj)["first_logprob"] is None
        assert "kv" not in unpackb(obj)


def test_stream_pull_frames():
    same({"uuid": UUID, "offset": 0, "max_bytes": 1 << 20})
    same({"uuid": UUID, "offset": 3 << 20, "max_bytes": 1 << 20})
    same({"offset": 0, "data": bytes(range(256)) * 300,
          "total_bytes": 76800, "last": True})
    same({"offset": 70000, "data": b"\x00" * 70000,
          "total_bytes": 140000, "last": False})
    same({"error": "unknown or expired offer"})


def test_lengths_at_every_boundary():
    for n in (0, 15, 16, 31, 32, 255, 256, 65535, 65536):
        same("x" * n)
        same(b"y" * n)
        same(list(range(min(n, 70000))))
        same({f"k{i}": i for i in range(min(n, 70000))})


def test_outside_the_subset():
    for bad in (np.int64(3), np.float32(1.0), object(), {"a": {1, 2}},
                [1, 2j]):
        with pytest.raises(TypeError):
            packb(bad)
        with pytest.raises(TypeError):
            msgpack.packb(bad, use_bin_type=True)
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            packb(big)
        with pytest.raises(OverflowError):
            msgpack.packb(big)
    # Malformed, truncated and trailing data, and a type byte the subset
    # does not read (msgpack's ext).
    for data in (b"\xc1", b"\x92\x01", b"\xcd\x01", b"\x01\x02",
                 b"\xd4\x01\x02", msgpack.packb({1: 2})):
        with pytest.raises(ValueError):
            unpackb(data)
    # A float32 on the wire is read, as msgpack reads it.
    assert unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


def test_scalars_random():
    rng = np.random.default_rng(1)
    ints = [int(x) for x in rng.integers(-2**63, 2**63, size=200)] + \
        [int(x) for x in rng.integers(0, 2**16, size=200)] + \
        [int(x) - 40 for x in rng.integers(0, 80, size=50)] + [UUID, 2**64 - 1]
    floats = [float(x) for x in rng.standard_normal(100) * 1e6] + \
        [0.0, -0.0, float("inf"), -float("inf"), 5e-324]
    for v in ints + floats + [None, True, False, "é✓", b"\x00\xff"]:
        same(v)
        same([v, {"v": v}])


@settings(max_examples=300, deadline=None)
@given(st.recursive(
    st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
    | st.floats(allow_nan=False) | st.text() | st.binary(),
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(), inner, max_size=20), max_leaves=50))
def test_hypothesis_objects(obj):
    same(obj)


def test_int_keyed_logit_bias_is_refused_as_by_the_reference():
    """The reference packs ``sampling.logit_bias`` with int keys, which
    ``msgpack.unpackb`` refuses (strict_map_key): its decode side answers
    400 to such a handoff. The port keeps the same frame and the same
    refusal (ROADMAP queue 3)."""
    ref, port = _handoffs("float32")
    ref.sampling.logit_bias = {5: 1.0}
    port.sampling.logit_bias = {5: 1.0}
    want = ref_agent.pack_handoff(ref, "127.0.0.1:9")
    assert port_agent.pack_handoff(port, "127.0.0.1:9") == want
    with pytest.raises(ValueError):
        ref_agent.unpack_handoff(want)
    with pytest.raises(ValueError):
        port_agent.unpack_handoff(want)
