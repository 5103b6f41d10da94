"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``. Libraries land in
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources they are built from, at first use: a source
edit builds a new library, an unchanged tree reuses the old one. Nothing
outside the package's own sources is compiled.

``build()`` starts one ``nvcc`` per missing library, all at once, and waits
for them together.

Launch counts: each kernel wrapper adds one to its ``launches`` where it
launches its kernel, through :func:`count_launch`. Several engines of one
process (an agent's replicas) count from their own threads at once: the
adds take a lock, and :func:`launch_tally` collects the launches of the
calling thread alone, which is how a graph capture learns what one replay
of it launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("paged_attention", "mq_paged_attention",
           "fused_decode_attention", "page_dma", "cp_paged_partial")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()   # lock-order: 850
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_count_lock = threading.Lock()   # lock-order: 853
_tally = threading.local()


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` launches to wrapper ``fn``'s count (and to the calling
    thread's open :func:`launch_tally`)."""
    with _count_lock:
        fn.launches += n
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[fn] = counts.get(fn, 0) + n


@contextlib.contextmanager
def launch_tally():
    """The launches the calling thread counts inside the block, as
    ``{wrapper: n}``; other threads' launches are not in it."""
    prev = getattr(_tally, "counts", None)
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = prev


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(names: Iterable[str] = KERNELS, verbose: bool = False
          ) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, all started together. Returns ``{name: compiler output}``
    for the libraries built now (with ``verbose``, ptxas's register and
    shared-memory report). Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs: dict[str, str] = {}
    failed = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def kernel_fn(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of library ``name`` (built if needed),
    with its ``argtypes`` declared; every entry point returns an int."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
