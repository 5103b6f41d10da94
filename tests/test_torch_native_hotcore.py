"""The port's native hot core (``xllm_service_tpu_torch/csrc/hotcore.c``
through ``common/native.py``) and native block hash
(``csrc/blockhash.c`` through ``common/hashing.py``), byte for byte.

Hypothesis draws payloads, SSE deltas, load and telemetry frames, member
sets and texts. For each component the port's library must give the bytes
of the reference's pure path (the ``msgpack`` library, ``json.dumps``,
the blake2b walk, the utf-8 id map) and of the port's own pure path
(``rpc/msgpack_lite.py``, the call sites with ``XLLM_NATIVE=0``); where the
repo-root ``csrc/libhotcore.so`` is built, the reference's native path
too. Inputs the C path cannot serve bit-exactly (ext types, non-canonical
base64, lone surrogates) must come back as ``MISS`` from the wrappers, as
in the reference. The library is built here from the port's sources; the
module skips only where there is no C compiler or no ``Python.h``.
"""

import base64
import hashlib
import json
import os
import shutil
import sysconfig
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xllm_service_tpu.common import hashing as ref_hashing
from xllm_service_tpu.common import native as ref_native
from xllm_service_tpu.multimaster import ownership as ref_own
from xllm_service_tpu_torch.common import hashing, native
from xllm_service_tpu_torch.multimaster import ownership as own
from xllm_service_tpu_torch.rpc import msgpack_lite, wire
from xllm_service_tpu_torch.tokenizer.simple import SimpleTokenizer

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

_HAVE_CC = any((os.environ.get("CC"), shutil.which("cc"),
                shutil.which("gcc")))
_HAVE_PYH = (Path(sysconfig.get_paths()["include"]) / "Python.h").exists()
pytestmark = pytest.mark.skipif(
    not (_HAVE_CC and _HAVE_PYH),
    reason="no C compiler or no Python.h: the native core cannot be built")

SETTINGS = settings(max_examples=150, deadline=None, database=None,
                    suppress_health_check=[HealthCheck.too_slow])
_COMPACT = (",", ":")

# ------------------------------------------------------------- strategies
_ints = st.integers(min_value=-2**63, max_value=2**64 - 1)
_floats = st.floats(allow_nan=True, allow_infinity=True)
_text = st.text(max_size=40)


def _tree(leaf):
    return st.recursive(
        leaf, lambda kids: st.lists(kids, max_size=5)
        | st.dictionaries(_text, kids, max_size=5), max_leaves=20)


wire_objs = _tree(_ints | _floats | _text | st.booleans() | st.none()
                  | st.binary(max_size=20))
json_objs = _tree(_ints | _floats | _text | st.booleans() | st.none())
load_frames = st.fixed_dictionaries({
    "i": st.dictionaries(
        st.from_regex(r"eng-[0-9]{1,4}:[0-9]{1,5}", fullmatch=True),
        st.fixed_dictionaries({
            "l": st.dictionaries(_text, _ints | _floats, max_size=3),
            "y": st.dictionaries(_text, _floats, max_size=3),
            "hb": st.integers(0, 2**41), "up": st.integers(0, 2**41),
            "st": st.sampled_from(["READY", "DRAINING", "DEAD"])}),
        max_size=6),
    "g": st.dictionaries(_text, st.sampled_from(["lease", "drain"]),
                         max_size=3),
    "s": st.integers(0, 2**31), "ms": st.integers(0, 2**41)})
telemetry = st.lists(
    st.fixed_dictionaries({"t": st.just("hb"), "d": load_frames})
    | st.fixed_dictionaries({"t": st.just("gens"), "dest": _text,
                             "d": st.fixed_dictionaries({
                                 "gens": st.lists(json_objs, max_size=3)})}),
    min_size=1, max_size=4)
deltas = st.fixed_dictionaries({
    "id": _text, "object": st.just("text_completion"),
    "created": st.integers(0, 2**31), "model": _text,
    "choices": st.lists(st.fixed_dictionaries({
        "index": st.integers(0, 8), "text": _text,
        "finish_reason": st.sampled_from([None, "stop", "length"])}),
        max_size=3),
    "usage": st.none() | st.fixed_dictionaries({
        "prompt_tokens": st.integers(0, 4096),
        "completion_tokens": st.integers(0, 4096)})})
members = st.lists(st.from_regex(r"10\.[0-9]{1,3}\.[0-9]{1,3}:[0-9]{1,5}",
                                 fullmatch=True), max_size=12)


def pure_sse_data(obj) -> bytes:
    return (b"data: " + json.dumps(obj, ensure_ascii=False,
                                   separators=_COMPACT).encode() + b"\n\n")


def pure_rendezvous(ms, key):
    best, best_score = "", -1
    for m in ms:
        s = ref_own._rendezvous_score(m, key)
        if s > best_score:
            best, best_score = m, s
    return best


@pytest.fixture(scope="module")
def core():
    """The port's library, built from its sources at first use."""
    c = native.load_core(force=True)
    assert c is not None, native.status()["error"]
    return c


@pytest.fixture(scope="module")
def ref_core():
    """The reference's library where the repo-root ``csrc`` has it built
    (None elsewhere)."""
    return ref_native.load_core(force=True)


@pytest.fixture
def native_off():
    old = os.environ.get("XLLM_NATIVE")
    os.environ["XLLM_NATIVE"] = "0"
    native.reload()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("XLLM_NATIVE", None)
        else:
            os.environ["XLLM_NATIVE"] = old
        native.reload()


def _off(fn):
    """``fn()`` with the port's kill switch thrown."""
    old = os.environ.get("XLLM_NATIVE")
    os.environ["XLLM_NATIVE"] = "0"
    native.reload()
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("XLLM_NATIVE", None)
        else:
            os.environ["XLLM_NATIVE"] = old
        native.reload()


# ------------------------------------------------------------------- build
def test_every_component_builds_and_passes_its_self_test(core):
    assert core is not None
    st_ = native.status()
    assert st_["loaded"] and st_["enabled"] and not st_["error"], st_
    assert st_["components"] == {c: True for c in native.COMPONENTS}
    assert "build/native/libhotcore-" in st_["so"]
    assert hashing.native_available(), hashing.native_error()


def test_status_has_the_reference_shape():
    ref, port = ref_native.status(), native.status()
    assert set(ref) <= set(port)
    assert {k: type(v) for k, v in ref.items()} == \
        {k: type(port[k]) for k in ref}
    assert set(port["components"]) == set(ref["components"])
    assert native.COMPONENTS == ref_native.COMPONENTS


def test_kill_switch_disables_every_component(native_off):
    st_ = native.status()
    assert st_["enabled"] is False and st_["loaded"] is False
    assert not any(st_["components"].values())
    assert native.packb({"a": 1}) is native.MISS
    assert native.unpack_b64("gA==") is native.MISS
    assert native.sse_data_frame({}) is native.MISS
    assert native.sse_event_frame("e", {}) is native.MISS
    assert native.rendezvous(("a",), "k") is native.MISS
    assert native.tok_encode("x") is native.MISS


# -------------------------------------------------------------------- wire
@SETTINGS
@given(wire_objs)
def test_msgpack_matches_both_pure_paths(core, ref_core, obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert core.packb(obj) == want
    assert msgpack_lite.packb(obj) == want
    # NaN != NaN: compare re-encodings, not objects.
    assert msgpack.packb(core.unpackb(want), use_bin_type=True) == want
    if ref_core is not None:
        assert ref_core.packb(obj) == want


@SETTINGS
@given(load_frames)
def test_load_frames_match(core, frame):
    ref_b64 = base64.b64encode(
        msgpack.packb(frame, use_bin_type=True)).decode("ascii")
    on = wire.encode_load_frame(frame["i"], frame["g"], frame["s"],
                                frame["ms"])
    assert on == ref_b64 == core.pack_b64(frame)
    assert _off(lambda: wire.encode_load_frame(
        frame["i"], frame["g"], frame["s"], frame["ms"])) == on
    # NaN != NaN: compare re-encodings, not objects.
    for back in (wire.decode_load_frame(on),
                 core.unpack_b64(on.encode("ascii"))):
        assert msgpack.packb(back, use_bin_type=True) == \
            msgpack.packb(frame, use_bin_type=True)


@SETTINGS
@given(telemetry)
def test_telemetry_batches_match(frames):
    body, ctype = wire.encode_telemetry(frames)
    assert body == msgpack.packb({"frames": frames}, use_bin_type=True)
    assert _off(lambda: wire.encode_telemetry(frames)) == (body, ctype)
    assert msgpack.packb(wire.decode_body(ctype, body),
                         use_bin_type=True) == body


@SETTINGS
@given(st.dictionaries(st.binary(min_size=16, max_size=16),
                       st.lists(st.lists(_text, max_size=2), min_size=3,
                                max_size=3), max_size=8),
       st.booleans())
def test_kv_frames_match(upserts, full):
    removals = list(upserts)[:2]
    on = wire.encode_kv_frame(upserts, removals, full=full)
    assert _off(lambda: wire.encode_kv_frame(upserts, removals,
                                             full=full)) == on
    assert wire.decode_kv_frame(on) == (upserts, removals, full)


@SETTINGS
@given(json_objs)
def test_dispatch_matches(payload):
    payload = {"p": payload}
    on = wire.pack_dispatch(payload)
    assert on == msgpack.packb(payload, use_bin_type=True)
    assert _off(lambda: wire.pack_dispatch(payload)) == on


def test_miss_where_the_reference_misses(core, ref_core):
    ext = msgpack.packb(msgpack.ExtType(4, b"x"))
    good = core.pack_b64({"i": {}, "g": {}, "s": 1, "ms": 2})
    for c in filter(None, (core, ref_core)):
        with pytest.raises(Exception):
            c.unpackb(ext)
        with pytest.raises(Exception):
            c.unpack_b64(good + "\n")
    assert native.unpackb(ext) is native.MISS
    assert native.unpack_b64(good + "\n") is native.MISS
    # The call site's pure path then answers as the reference's does.
    assert wire.decode_load_frame(good + "\n") == \
        {"i": {}, "g": {}, "s": 1, "ms": 2}
    for bad in (2**64, -2**63 - 1, object()):
        assert native.packb(bad) is native.MISS


# --------------------------------------------------------------------- sse
@SETTINGS
@given(deltas)
def test_sse_deltas_match(ref_core, delta):
    want = pure_sse_data(delta)
    assert native.sse_data_frame(delta) == want
    if ref_core is not None:
        assert ref_core.sse_data_frame(delta) == want


@SETTINGS
@given(json_objs, st.sampled_from(["telemetry", "usage", "x-keepalive"]))
def test_sse_objects_and_events_match(core, obj, name):
    assert core.sse_data_frame(obj) == pure_sse_data(obj)
    assert core.sse_event_frame(name, obj) == \
        f"event: {name}\n".encode() + pure_sse_data(obj)


def test_lone_surrogate_misses(core, ref_core):
    lone = {"text": "lone \ud800 surrogate"}
    with pytest.raises(Exception):
        core.sse_data_frame(lone)
    assert native.sse_data_frame(lone) is native.MISS
    assert native.tok_encode("bad \udc00") is native.MISS
    if ref_core is not None:
        with pytest.raises(Exception):
            ref_core.sse_data_frame(lone)


# -------------------------------------------------------------- rendezvous
@SETTINGS
@given(members, _text)
def test_rendezvous_matches(core, ref_core, ms, key):
    want = pure_rendezvous(ms, key)
    assert core.rendezvous(tuple(ms), key) == want
    assert own.rendezvous_owner(ms, key) == want
    assert _off(lambda: own.rendezvous_owner(ms, key)) == want
    if ref_core is not None:
        assert ref_core.rendezvous(tuple(ms), key) == want


# --------------------------------------------------------------- tokenizer
@SETTINGS
@given(st.text(max_size=200))
def test_tokenizer_matches(core, text):
    want = [b + 256 for b in text.encode("utf-8")]
    tok = SimpleTokenizer()
    assert core.tok_encode(text) == want
    assert tok.encode(text) == want
    assert _off(lambda: tok.encode(text)) == want
    assert tok.decode(want) == text


# -------------------------------------------------------------- block hash
@SETTINGS
@given(st.lists(st.integers(0, 2**31 - 1), max_size=300),
       st.sampled_from([1, 4, 16, 32]))
def test_block_hash_chain_matches_the_reference(tokens, block):
    assert hashing.native_available()
    # The reference's pure construction: keyed blake2b-128 chained from
    # the seed over each complete block's int32 bytes.
    want, prev = [], ref_hashing._SEED
    for i in range(len(tokens) // block):
        prev = hashlib.blake2b(
            np.asarray(tokens[i * block:(i + 1) * block],
                       dtype=np.int32).tobytes(),
            digest_size=16, key=prev).digest()
        want.append(prev)
    got = hashing.prefix_block_hashes(tokens, block)
    assert got == want
    assert got == ref_hashing.prefix_block_hashes(tokens, block)
    assert hashing.prefix_block_hashes(np.asarray(tokens, dtype=np.int32),
                                       block) == want
    half = got[:len(got) // 2]
    assert hashing.extend_prefix_block_hashes(half, tokens, block) == want
