"""The safetensors file layout on the standard library (the port's
counterpart of the ``safetensors`` package calls in
``xllm_service_tpu/models/loader.py``: ``safe_open`` and
``safetensors.numpy.save_file``).

A file is an 8-byte little-endian header length N, N bytes of a JSON
header, then the raw tensor bytes. The header maps each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}``, offsets counted from
the first byte after the header; an optional ``__metadata__`` entry maps
strings to strings.

- ``SafeTensorsFile`` reads a file through ``mmap``: ``get_tensor`` returns
  a ``torch.frombuffer`` view of the file's bytes (no copy), valid while
  the file is open.
- ``save_file`` writes the layout the package writes: tensors ordered by
  dtype (the package's order: F32, BF16, F16, I8) and then by name, the
  JSON compact with ``__metadata__`` first, the header padded with spaces
  to a multiple of 8 bytes. The bytes equal the package's for the same
  tensors.
- ``shard_files`` finds a directory's shards as the reference does: every
  ``*.safetensors`` in sorted order (an ``index.json`` is not read).

Only the dtypes that the llama, qwen2 and gemma2 checkpoints and the
port's own trees hold are taken: F32, F16, BF16 and I8.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Mapping, Optional, Union

import torch

DTYPES: dict[str, torch.dtype] = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# The package writes larger dtypes first (its Dtype enum, descending).
_WRITE_RANK = {"F32": 0, "BF16": 1, "F16": 2, "I8": 3}
_MAX_HEADER = 100_000_000       # the package's own limit on the header


def shard_files(ckpt_dir: Union[str, Path]) -> list[Path]:
    """A checkpoint directory's ``*.safetensors`` shards, sorted."""
    return sorted(Path(ckpt_dir).glob("*.safetensors"))


class SafeTensorsFile:
    """One safetensors file opened for reading (a context manager)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            size = self.path.stat().st_size
            if size < 8:
                raise ValueError(f"{self.path}: {size} bytes, shorter than "
                                 "the 8-byte header length")
            # Copy-on-write: the pages are the page cache's, and the views
            # are writable (torch.frombuffer warns on a read-only buffer);
            # nothing is ever written back to the file.
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        try:
            self._parse(size)
        except BaseException:
            self._mm.close()
            raise

    def _parse(self, size: int) -> None:
        (n,) = struct.unpack("<Q", self._mm[:8])
        if n > _MAX_HEADER or 8 + n > size:
            raise ValueError(f"{self.path}: header of {n} bytes runs past "
                             f"the file ({size} bytes)")
        try:
            header = json.loads(self._mm[8:8 + n].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{self.path}: header is not JSON: {e}") from e
        if not isinstance(header, dict):
            raise ValueError(f"{self.path}: header is not a JSON object")
        self._metadata = header.pop("__metadata__", None)
        self._base = 8 + n
        data_len = size - self._base
        self._entries: dict[str, tuple[torch.dtype, tuple, int, int]] = {}
        spans = []
        for name, info in header.items():
            dtype = DTYPES.get(info.get("dtype"))
            if dtype is None:
                raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                                 f"{info.get('dtype')!r}; only "
                                 f"{sorted(DTYPES)} are read")
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
            numel = 1
            for d in shape:
                numel *= d
            want = numel * torch.empty((), dtype=dtype).element_size()
            if not 0 <= begin <= end or end - begin != want:
                raise ValueError(f"{self.path}: tensor {name!r} has offsets "
                                 f"[{begin}, {end}] for {want} bytes")
            if end > data_len:
                raise ValueError(f"{self.path}: tensor {name!r} runs past "
                                 f"the file ({end} > {data_len} data bytes)")
            self._entries[name] = (dtype, shape, begin, end)
            spans.append((begin, end, name))
        spans.sort()
        for (_, e0, a), (b1, _, b) in zip(spans, spans[1:]):
            if b1 < e0:
                raise ValueError(f"{self.path}: tensors {a!r} and {b!r} "
                                 "overlap")

    def keys(self) -> list[str]:
        """Tensor names, sorted (as the package's ``safe_open.keys``)."""
        return sorted(self._entries)

    def metadata(self) -> Optional[dict]:
        return self._metadata

    def shape(self, name: str) -> tuple:
        return self._entries[name][1]

    def dtype(self, name: str) -> torch.dtype:
        return self._entries[name][0]

    def get_tensor(self, name: str) -> torch.Tensor:
        """A CPU view of the tensor's bytes in the file (valid while the
        file is open; ``.clone()`` or ``.to(device)`` to keep it)."""
        dtype, shape, begin, end = self._entries[name]
        if begin == end:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._mm, dtype=torch.uint8,
                                count=end - begin, offset=self._base + begin)
        return flat.view(dtype).view(shape)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # A view the caller kept still exports the buffer; the map
            # closes when the last view is collected.
            pass

    def __enter__(self) -> "SafeTensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _header(tensors: Mapping[str, torch.Tensor],
            metadata: Optional[Mapping[str, str]]) -> tuple[bytes, list]:
    order = sorted(tensors, key=lambda k: (_WRITE_RANK[_dtype_name(
        tensors[k], k)], k))
    head: dict = {}
    if metadata:
        head["__metadata__"] = {str(k): str(v)
                                for k, v in sorted(metadata.items())}
    offset = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        head[name] = {"dtype": _dtype_name(t, name), "shape": list(t.shape),
                      "data_offsets": [offset, offset + n]}
        offset += n
    buf = json.dumps(head, separators=(",", ":"),
                     ensure_ascii=False).encode("utf-8")
    buf += b" " * (-len(buf) % 8)
    return struct.pack("<Q", len(buf)) + buf, order


def _dtype_name(t: torch.Tensor, name: str) -> str:
    try:
        return _NAMES[t.dtype]
    except KeyError:
        raise ValueError(f"tensor {name!r} has dtype {t.dtype}; only "
                         f"{sorted(DTYPES)} are written") from None


def save_file(tensors: Mapping[str, torch.Tensor], path: Union[str, Path],
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as
    one safetensors file at ``path``."""
    header, order = _header(tensors, metadata)
    with open(path, "wb") as f:
        f.write(header)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                host = t.contiguous().reshape(-1).cpu()
                f.write(host.view(torch.uint8).numpy().data)
