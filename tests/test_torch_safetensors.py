"""The port's safetensors reader and writer (``models/safetensors_io.py``)
against the ``safetensors`` package, on the CPU.

- The reader on files the package wrote: F32, F16, BF16 and I8 tensors,
  empty and 0-d ones, ``__metadata__``, several shards in sorted order;
  every tensor equal bit for bit.
- The writer: the same bytes as the package's for the same tensors
  (hypothesis over names, shapes and the four dtypes, with and without
  metadata).
- The refusals: a dtype outside the four (named), overlapping offsets,
  offsets that do not fit the tensor, a truncated file, a header that runs
  past the file or is not JSON.
- No port source imports ``safetensors`` or ``regex``.
"""

import json
import struct
from pathlib import Path

import pytest
import safetensors.torch
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from safetensors import safe_open

from xllm_service_tpu_torch.models.safetensors_io import (
    DTYPES,
    SafeTensorsFile,
    save_file,
    shard_files,
)

from test_torch_isolation import ROOT, _imported_roots

DTYPE_LIST = [torch.float32, torch.float16, torch.bfloat16, torch.int8]


def _tensor(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    return torch.randn(shape, generator=g).to(dtype)


def _bits(t):
    return t.view(torch.int16) if t.dtype in (torch.float16,
                                              torch.bfloat16) else t


@pytest.mark.parametrize("dtype", DTYPE_LIST, ids=str)
def test_reader_matches_the_package(tmp_path, dtype):
    tensors = {"w": _tensor((5, 7), dtype), "b": _tensor((7,), dtype, 1),
               "scalar": _tensor((), dtype, 2),
               "empty": _tensor((0, 3), dtype, 3),
               "model.layers.0.x": _tensor((2, 3, 4), dtype, 4)}
    path = tmp_path / "m.safetensors"
    safetensors.torch.save_file(tensors, str(path), metadata={"format": "pt"})
    with SafeTensorsFile(path) as sf, safe_open(str(path), "pt") as ref:
        assert sf.keys() == sorted(ref.keys())
        assert sf.metadata() == ref.metadata() == {"format": "pt"}
        for name in ref.keys():
            want, got = ref.get_tensor(name), sf.get_tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert sf.shape(name) == tuple(want.shape)
            assert sf.dtype(name) == want.dtype
            assert torch.equal(_bits(got), _bits(want)), name


def test_mixed_dtypes_and_shards_in_sorted_order(tmp_path):
    shards = {}
    for i, name in enumerate(["model-00002-of-00003", "model-00001-of-00003",
                              "model-00003-of-00003"]):
        shards[name] = {f"t{i}.{j}": _tensor((3, 2 + j), d, 10 * i + j)
                        for j, d in enumerate(DTYPE_LIST)}
        safetensors.torch.save_file(shards[name], str(
            tmp_path / f"{name}.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    files = shard_files(tmp_path)
    assert [f.name for f in files] == sorted(f"{n}.safetensors"
                                             for n in shards)
    for f in files:
        want = shards[f.name[:-len(".safetensors")]]
        with SafeTensorsFile(f) as sf:
            assert sf.metadata() is None
            for k, v in want.items():
                assert torch.equal(_bits(sf.get_tensor(k)), _bits(v))


names = st.text(st.characters(categories=["L", "N"], include_characters="._"),
                min_size=1, max_size=12)
tensor_specs = st.dictionaries(
    names, st.tuples(st.lists(st.integers(0, 4), max_size=3),
                     st.sampled_from(range(len(DTYPE_LIST)))),
    min_size=1, max_size=6)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(tensor_specs, st.booleans())
def test_writer_bytes_equal_the_packages(specs, with_meta):
    tensors = {name: _tensor(tuple(shape), DTYPE_LIST[d], i)
               for i, (name, (shape, d)) in enumerate(specs.items())}
    meta = {"format": "pt"} if with_meta else None
    want = safetensors.torch.save(tensors, metadata=meta)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "m.safetensors"
        save_file(tensors, path, metadata=meta)
        assert path.read_bytes() == want
        with SafeTensorsFile(path) as sf:
            for k, v in tensors.items():
                assert torch.equal(_bits(sf.get_tensor(k)), _bits(v))


def test_writer_takes_tensors_of_any_layout(tmp_path):
    w = _tensor((6, 4), torch.bfloat16)
    save_file({"t": w.t()}, tmp_path / "m.safetensors")
    with SafeTensorsFile(tmp_path / "m.safetensors") as sf:
        assert torch.equal(sf.get_tensor("t"), w.t().contiguous())
    with pytest.raises(ValueError, match="float64"):
        save_file({"x": torch.zeros(2, dtype=torch.float64)},
                  tmp_path / "x.safetensors")


# ------------------------------------------------------------- refusals
def _raw(path, header: dict, data: bytes):
    h = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(h)) + h + data)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.bool,
                                   torch.int32, torch.uint8])
def test_other_dtypes_are_refused_by_name(tmp_path, dtype):
    path = tmp_path / "m.safetensors"
    safetensors.torch.save_file({"x": torch.zeros(3, dtype=dtype)},
                                str(path))
    name = json.loads(path.read_bytes()[8:].split(b"}}")[0] + b"}}")["x"][
        "dtype"]
    assert name not in DTYPES
    with pytest.raises(ValueError, match=f"dtype '{name}'"):
        SafeTensorsFile(path)


def test_overlapping_offsets_are_refused(tmp_path):
    path = tmp_path / "m.safetensors"
    _raw(path, {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}},
         bytes(12))
    with pytest.raises(ValueError, match="overlap"):
        SafeTensorsFile(path)


def test_offsets_that_do_not_fit_the_tensor_are_refused(tmp_path):
    path = tmp_path / "m.safetensors"
    _raw(path, {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
         bytes(8))
    with pytest.raises(ValueError, match="for 12 bytes"):
        SafeTensorsFile(path)


def test_truncated_files_are_refused(tmp_path):
    path = tmp_path / "m.safetensors"
    safetensors.torch.save_file({"a": torch.ones(4), "b": torch.ones(8)},
                                str(path))
    full = path.read_bytes()
    path.write_bytes(full[:-1])
    with pytest.raises(ValueError, match="runs past the file"):
        SafeTensorsFile(path)
    path.write_bytes(full[:20])                  # inside the header
    with pytest.raises(ValueError, match="header of .* runs past"):
        SafeTensorsFile(path)
    path.write_bytes(full[:5])
    with pytest.raises(ValueError, match="shorter than"):
        SafeTensorsFile(path)
    path.write_bytes(struct.pack("<Q", 4) + b"nope")
    with pytest.raises(ValueError, match="not JSON"):
        SafeTensorsFile(path)


def test_port_sources_import_neither_safetensors_nor_regex():
    for path in (ROOT / "xllm_service_tpu_torch").rglob("*.py"):
        assert not _imported_roots(path) & {"safetensors", "regex"}, path
    assert not _imported_roots(ROOT / "chip_smoke.py") & {"safetensors",
                                                         "regex"}
