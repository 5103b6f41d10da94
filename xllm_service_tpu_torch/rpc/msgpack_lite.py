"""A standard-library codec for the msgpack subset of the engine's wire:
the dispatch, heartbeat, Generations and telemetry frames
(``rpc/wire.py``), the PD handoff and the KV stream frames
(``engine/agent.py::pack_handoff``, ``engine/kv_transfer.py::pull_stream``
and the agent's ``/rpc/kv_stream_pull``).

The types: maps (str keys in every frame the port sends), str, bin (bytes,
bytearray, memoryview; a heartbeat's raw 16-byte KV-event keys), int
(-2**63 .. 2**64 - 1; the transfer uuid is a 63-bit int), float (packed
as float64), bool, None, and arrays (lists and tuples; a tuple packs as an
array, as ``msgpack.packb`` packs it).
``packb(obj)`` gives the bytes ``msgpack.packb(obj, use_bin_type=True)``
gives on these types: every int and length takes its smallest encoding, as
the msgpack package chooses it. ``unpackb(data)`` is
``msgpack.unpackb(data, raw=False)``: arrays come back as lists, str as
str, bin as bytes. Anything else raises ``TypeError`` (a value outside the
subset), ``OverflowError`` (an int past 64 bits, as msgpack) or
``ValueError`` (a malformed or truncated frame); nothing is stringified.
"""

from __future__ import annotations

import struct
from typing import Any

CONTENT_TYPE = "application/msgpack"

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _pack_int(x: int, out: bytearray) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(x)
        elif x <= 0xFF:
            out += b"\xcc" + _B.pack(x)
        elif x <= 0xFFFF:
            out += b"\xcd" + _H.pack(x)
        elif x <= 0xFFFFFFFF:
            out += b"\xce" + _I.pack(x)
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q.pack(x)
        else:
            raise OverflowError(f"int {x} does not fit msgpack's 64 bits")
    elif x >= -32:
        out.append(x & 0xFF)
    elif x >= -0x80:
        out += b"\xd0" + _b.pack(x)
    elif x >= -0x8000:
        out += b"\xd1" + _h.pack(x)
    elif x >= -0x80000000:
        out += b"\xd2" + _i.pack(x)
    elif x >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(x)
    else:
        raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: bytearray, what: str) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-bit
    (where ``codes`` has one), 16-bit or 32-bit form."""
    if n < fix_max:
        out.append(fix | n)
        return
    if len(codes) == 3 and n <= 0xFF:
        out += codes[0:1] + _B.pack(n)
    elif n <= 0xFFFF:
        out += codes[-2:-1] + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += codes[-1:] + _I.pack(n)
    else:
        raise ValueError(f"{what} of {n} entries is too long for msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + _d.pack(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out, "str")
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        n = data.nbytes
        if n <= 0xFF:
            out += b"\xc4" + _B.pack(n)
        elif n <= 0xFFFF:
            out += b"\xc5" + _H.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xc6" + _I.pack(n)
        else:
            raise ValueError(f"bin of {n} bytes is too long for msgpack")
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\xdc\xdd", out, "array")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\xde\xdf", out, "map")
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``
    on the subset)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, s: struct.Struct) -> Any:
        return s.unpack(self.take(s.size))[0]

    def str_(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                # msgpack.unpackb's strict_map_key default.
                raise ValueError(f"{type(key).__name__} is not allowed "
                                 "for map key")
            out[key] = self.obj()
        return out

    def obj(self) -> Any:
        c = self.unpack(_B)
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c < 0x90:
            return self.map_(c & 0x0F)
        if c < 0xA0:
            return self.array(c & 0x0F)
        if c < 0xC0:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fixed = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b,
                 0xD1: _h, 0xD2: _i, 0xD3: _q, 0xCA: _f, 0xCB: _d}
        if c in fixed:
            return self.unpack(fixed[c])
        sized = {0xC4: (_B, bytes), 0xC5: (_H, bytes), 0xC6: (_I, bytes),
                 0xD9: (_B, None), 0xDA: (_H, None), 0xDB: (_I, None),
                 0xDC: (_H, self.array), 0xDD: (_I, self.array),
                 0xDE: (_H, self.map_), 0xDF: (_I, self.map_)}
        if c in sized:
            s, read = sized[c]
            n = self.unpack(s)
            if read is bytes:
                return bytes(self.take(n))
            return self.str_(n) if read is None else read(n)
        raise ValueError(f"msgpack type byte 0x{c:02x} is not in the "
                         "subset this codec reads")


def unpackb(data: bytes) -> Any:
    """Inverse of :func:`packb` (``msgpack.unpackb(data, raw=False)`` on
    the subset). Raises ValueError on malformed, truncated or trailing
    data."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return obj
