"""Loader of the port's native hot-path core (``csrc/hotcore.c``).

A copy of ``xllm_service_tpu/common/native.py`` that builds its library
from the port's own sources. One loader, four components, one kill
switch:

==============  =========================================================
component       fast path (call sites keep a mandatory pure path)
==============  =========================================================
``wire``        msgpack pack/unpack + fused base64 form of the KV and
                load frames and the telemetry batch (rpc/wire.py)
``sse``         SSE ``data: ...\\n\\n`` frame assembly + compact JSON
                (http_service/service.py, the SSE drain)
``rendezvous``  blake2b-8 highest-random-weight walk over the member set
                (multimaster/ownership.py)
``tokenizer``   SimpleTokenizer's utf8-byte+offset encode
                (tokenizer/simple.py)
==============  =========================================================

Contract (the reference's):

- ``XLLM_NATIVE=0`` forces pure Python everywhere; a library that does
  not build or load, or a failed per-component parity self-test,
  disables just what failed, and :func:`status` says so.
- Every wrapper returns :data:`MISS` when the native path cannot serve
  the input **bit-exactly** (unsupported type, lone surrogate, ext
  msgpack, non-canonical base64, ...). The call site then runs the
  pure-Python code, which either handles the input or raises the
  canonical library error. Native never produces bytes Python wouldn't.
- ``tests/test_torch_native_hotcore.py`` pins byte-for-byte agreement
  with the port's and the reference's pure paths; a tiny parity
  self-test re-runs at load, so a stale or miscompiled library degrades
  to Python instead of corrupting a wire.

Build: at first use (the first wrapper call, :func:`status` or
:func:`reload`), :func:`build_library` compiles ``csrc/hotcore.c`` with
the host C compiler (``$CC``, else ``cc``/``gcc``) against the running
Python's headers (``sysconfig.get_paths()["include"]``) into
``build/native/`` at the repository root, named by a hash of the source,
the flags and the headers' path: an unchanged tree reuses the library.
It is loaded with ``ctypes.PyDLL``, so the GIL stays held across every
call (each entry point uses the CPython API). The block hash
(``csrc/blockhash.c``, ``common/hashing.py``) is built the same way.

``native_path_active{component}`` gauges (common/metrics.py) and the
``native`` flight-recorder context provider (both wired by the HTTP
service, which loads the core when it starts) show which processes of a
fleet run on the pure path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Any, Optional, Sequence

from ..utils import get_logger

logger = get_logger(__name__)

COMPONENTS = ("wire", "sse", "rendezvous", "tokenizer")

#: Sentinel for "native could not serve this input — run the pure path".
#: Distinct from None because decoders legitimately return None.
MISS: Any = object()

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O3", "-Wall", "-Wextra", "-shared", "-fPIC")

# Serializes first-use builds and (re)loads within a process; processes
# racing on one library each write a temporary file and rename it.
_build_lock = threading.Lock()   # lock-order: 840


def _switch_on() -> bool:
    return os.environ.get("XLLM_NATIVE", "") not in ("0", "false", "off")


def _compiler() -> str:
    for cand in (os.environ.get("CC"), shutil.which("cc"),
                 shutil.which("gcc")):
        if cand:
            return cand
    raise OSError("no C compiler (cc, gcc or $CC) to build the native core")


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.c`` built with ``defines`` lives: a name hashed
    from the source, the flags and the Python headers' path."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.c").read_bytes())
    h.update(" ".join((*CFLAGS, *defines,
                       sysconfig.get_paths()["include"])).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.c`` into ``build/native/`` unless an
    identical build is there already; returns the library's path. Raises
    OSError with the compiler's output when the build fails (a missing
    ``Python.h`` names the include directory it looked in)."""
    out = library_path(name, defines)
    if out.exists():
        return out
    inc = sysconfig.get_paths()["include"]
    if not (Path(inc) / "Python.h").exists():
        raise OSError(f"Python.h not found under {inc}: the native core "
                      f"needs the Python development headers")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CFLAGS, *[f"-D{d}" for d in defines], f"-I{inc}",
           "-o", str(tmp), str(CSRC / f"{name}.c")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"building {name}.c failed (exit {proc.returncode}): "
                      f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


class _Core:
    """Bound entry points of one loaded libhotcore."""

    _PYOBJ_FNS = ("hc_sse_data_frame", "hc_packb",
                  "hc_unpackb", "hc_pack_b64", "hc_unpack_b64",
                  "hc_tok_encode")

    def __init__(self, so_path: Path):
        # PyDLL: the GIL stays held — every entry point uses CPython APIs.
        lib = ctypes.PyDLL(str(so_path))
        lib.hc_abi_version.argtypes = []
        lib.hc_abi_version.restype = ctypes.c_int
        if lib.hc_abi_version() != 1:
            raise OSError(f"libhotcore ABI {lib.hc_abi_version()} != 1")
        for name in self._PYOBJ_FNS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.py_object]
            fn.restype = ctypes.py_object
            setattr(self, name[3:], fn)
        for name in ("hc_sse_event_frame", "hc_rendezvous"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.py_object, ctypes.py_object]
            fn.restype = ctypes.py_object
            setattr(self, name[3:], fn)


def _self_test(core: _Core) -> dict[str, bool]:
    """Per-component parity pins against known-good literals: a stale or
    miscompiled library must degrade to Python, never corrupt a wire."""
    ok = {}
    probe = {"s": "é\n", "i": [0, -33, 70000], "f": 1.5, "n": None}
    try:
        ok["wire"] = (
            core.packb(probe) ==
            b"\x84\xa1s\xa3\xc3\xa9\n\xa1i\x93\x00\xd0\xdf\xce\x00\x01"
            b"\x11p\xa1f\xcb?\xf8\x00\x00\x00\x00\x00\x00\xa1n\xc0"
            and core.unpackb(core.packb(probe)) == probe
            and core.unpack_b64(core.pack_b64(probe)) == probe)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(any self-test failure means "disable this component", whatever the exception)
        ok["wire"] = False
    try:
        ok["sse"] = (
            core.sse_data_frame(probe) ==
            b'data: {"s":"\xc3\xa9\\n","i":[0,-33,70000],"f":1.5,'
            b'"n":null}\n\n'
            and core.sse_event_frame("telemetry", {"a": 1}) ==
            b'event: telemetry\ndata: {"a":1}\n\n')
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see above)
        ok["sse"] = False
    try:
        # blake2b("a|k", digest_size=8) beats "b|k" for this key.
        ok["rendezvous"] = (core.rendezvous(("a", "b"), "k") == "a"
                            and core.rendezvous((), "k") == "")
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see above)
        ok["rendezvous"] = False
    try:
        ok["tokenizer"] = core.tok_encode("hé") == [360, 451, 425]
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see above)
        ok["tokenizer"] = False
    return ok


_CORE: Optional[_Core] = None
_ACTIVE: dict[str, bool] = {c: False for c in COMPONENTS}
_SO_PATH: Optional[Path] = None
_ERROR = ""
_LOADED = False


def _open_core() -> _Core:
    global _SO_PATH
    _SO_PATH = build_library("hotcore")
    return _Core(_SO_PATH)


def _load() -> None:
    global _CORE, _ACTIVE, _ERROR, _LOADED
    core = None
    error = ""
    active = {c: False for c in COMPONENTS}
    if _switch_on():
        try:
            core = _open_core()
        except OSError as e:
            error = str(e)
            logger.warning("libhotcore unavailable, every component stays "
                           "on the pure-Python path: %s", e)
        if core is not None:
            active = _self_test(core)
            if not all(active.values()):
                error = ("parity self-test failed for "
                         + ", ".join(c for c, v in active.items() if not v))
                logger.warning("libhotcore %s; those components stay on "
                               "the pure-Python path", error)
            if not any(active.values()):
                core = None
    _CORE = core
    _ACTIVE = active
    _ERROR = error
    _LOADED = True


def _ensure() -> None:
    if not _LOADED:
        with _build_lock:
            if not _LOADED:
                _load()


def reload() -> dict:
    """Re-evaluate ``XLLM_NATIVE`` and the library (tests flip the switch
    mid-process)."""
    with _build_lock:
        _load()
    return status()


def load_core(force: bool = False) -> Optional[_Core]:
    """The raw bound core, for the differential tests: ``force=True``
    loads the library even when ``XLLM_NATIVE=0`` so one process can
    compare both paths. Returns None when it cannot be built or loaded."""
    _ensure()
    if _CORE is not None and not force:
        return _CORE
    try:
        with _build_lock:
            return _open_core()
    except OSError:
        return None


def available(component: Optional[str] = None) -> bool:
    _ensure()
    if component is None:
        return _CORE is not None
    return _ACTIVE.get(component, False)


def status() -> dict:
    """Loader verdict (flight-recorder context, ``/admin/hotpath``):
    the reference's keys, and ``error`` (empty when all is well)."""
    _ensure()
    return {"enabled": _switch_on(),
            "loaded": _CORE is not None,
            "so": str(_SO_PATH or library_path("hotcore")),
            "components": dict(_ACTIVE),
            "error": _ERROR}


def export_gauges() -> None:
    """Refresh ``native_path_active{component}`` (scrape-time, like
    CPU_ATTR.export_counters)."""
    from .metrics import NATIVE_PATH_ACTIVE

    _ensure()
    for c in COMPONENTS:
        NATIVE_PATH_ACTIVE.labels(component=c).set(
            1.0 if _ACTIVE.get(c) else 0.0)


# ----------------------------------------------------------------- wrappers
# Shape note: every wrapper is `if not active: MISS; try native except
# Exception: MISS` — the call site owns the pure path, so fallback code
# lives exactly once, next to the logic it mirrors.

def sse_data_frame(obj: Any) -> Any:
    """b"data: <json>\\n\\n" (compact JSON, ensure_ascii=False) or
    MISS."""
    _ensure()
    if not _ACTIVE["sse"]:
        return MISS
    try:
        return _CORE.sse_data_frame(obj)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(any native refusal degrades to the pure path; the fallback re-raises canonically for truly bad input)
        return MISS


def sse_event_frame(name: str, obj: Any) -> Any:
    """b"event: <name>\\ndata: <json>\\n\\n" or MISS."""
    _ensure()
    if not _ACTIVE["sse"]:
        return MISS
    try:
        return _CORE.sse_event_frame(name, obj)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see sse_data_frame)
        return MISS


def packb(obj: Any) -> Any:
    """msgpack bytes (parity: msgpack.packb(use_bin_type=True)) or MISS."""
    _ensure()
    if not _ACTIVE["wire"]:
        return MISS
    try:
        return _CORE.packb(obj)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see sse_data_frame)
        return MISS


def unpackb(data: bytes) -> Any:
    """Decoded object (parity: msgpack.unpackb(raw=False)) or MISS."""
    _ensure()
    if not _ACTIVE["wire"]:
        return MISS
    try:
        return _CORE.unpackb(data)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see sse_data_frame)
        return MISS


def pack_b64(obj: Any) -> Any:
    """ascii str base64(msgpack(obj)) — the KV and load frame wire — or
    MISS."""
    _ensure()
    if not _ACTIVE["wire"]:
        return MISS
    try:
        return _CORE.pack_b64(obj)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see sse_data_frame)
        return MISS


def unpack_b64(value: Any) -> Any:
    """Decoded object from base64(msgpack) str/bytes, or MISS."""
    _ensure()
    if not _ACTIVE["wire"]:
        return MISS
    try:
        return _CORE.unpack_b64(value)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see sse_data_frame)
        return MISS


def rendezvous(members: Any, key: str) -> Any:
    """Highest-random-weight member ("" when empty) or MISS. ``members``
    must be a tuple/list of str (the RCU-published member tuple is)."""
    _ensure()
    if not _ACTIVE["rendezvous"]:
        return MISS
    try:
        return _CORE.rendezvous(members, key)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see sse_data_frame)
        return MISS


def tok_encode(text: str) -> Any:
    """[b + 256 for b in text.encode("utf-8")] or MISS."""
    _ensure()
    if not _ACTIVE["tokenizer"]:
        return MISS
    try:
        return _CORE.tok_encode(text)
    except Exception:  # noqa: BLE001  # xlint: allow-broad-except(see sse_data_frame)
        return MISS
