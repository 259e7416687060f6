"""The port's safetensors reader and writer (localai_tfp_tpu_torch/models/
safetensors_io.py) against the ``safetensors`` package: files written by
one are read back bit-exactly by the other, for every dtype the loader
meets, with metadata, and malformed files raise."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from localai_tfp_tpu_torch.models.safetensors_io import (
    SafeTensorsFile, load_file, save_file, save_iter,
)


def tensors() -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(0)
    f32 = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    return {
        "model.embed_tokens.weight": f32.to(torch.bfloat16),
        "f32": f32,
        "f16": f32.to(torch.float16),
        "f64": f32.double(),
        "i8": torch.from_numpy(rng.integers(-128, 128, (4, 7), np.int8)),
        "i32": torch.arange(-6, 6, dtype=torch.int32).reshape(3, 4),
        "i64": torch.arange(5, dtype=torch.int64),
        "u8": torch.arange(9, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }


def assert_same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        # bit-exact: compare the raw bytes
        assert torch.equal(a[k].contiguous().view(-1).view(torch.uint8)
                           if a[k].numel() else a[k],
                           b[k].contiguous().view(-1).view(torch.uint8)
                           if b[k].numel() else b[k]), k


def test_port_writer_is_read_by_safetensors(tmp_path):
    path = str(tmp_path / "w.safetensors")
    save_file(tensors(), path, metadata={"format": "pt", "seed": 0})
    assert_same(st_load(path), tensors())
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt", "seed": "0"}


def test_safetensors_writer_is_read_by_port(tmp_path):
    path = str(tmp_path / "r.safetensors")
    st_save(tensors(), path, metadata={"format": "pt"})
    assert_same(load_file(path), tensors())
    f = SafeTensorsFile(path)
    assert f.metadata == {"format": "pt"}
    # the mapping is copy-on-write: writing a view never reaches the file
    t = f.get("f32")
    t.add_(1.0)
    assert_same(load_file(path), tensors())


def test_streamed_write_holds_one_tensor_and_checks_the_header(tmp_path):
    ts = tensors()
    shapes = [(k, torch.empty(v.shape, dtype=v.dtype, device="meta"))
              for k, v in ts.items()]
    path = str(tmp_path / "s.safetensors")
    save_iter(iter(ts.items()), path, shapes=shapes)
    assert_same(st_load(path), ts)
    bad = [(k, v.float() if k == "i8" else v) for k, v in ts.items()]
    with pytest.raises(ValueError, match="does not match the header"):
        save_iter(iter(bad), path, shapes=shapes)
    with pytest.raises(ValueError, match="tensors written"):
        save_iter(iter(list(ts.items())[:2]), path, shapes=shapes)


def test_malformed_files_raise(tmp_path):
    short = tmp_path / "short.safetensors"
    short.write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="not a safetensors file"):
        SafeTensorsFile(str(short))
    header = json.dumps({"x": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 8]}}).encode()
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 8)
    with pytest.raises(ValueError, match="bad offsets"):
        SafeTensorsFile(str(bad))
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [1],
                               "data_offsets": [0, 1]}}).encode()
    odd = tmp_path / "odd.safetensors"
    odd.write_bytes(struct.pack("<Q", len(header)) + header + b"\0")
    with pytest.raises(ValueError, match="unsupported dtype"):
        SafeTensorsFile(str(odd))
