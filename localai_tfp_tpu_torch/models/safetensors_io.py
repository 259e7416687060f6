"""Reader and writer for the safetensors file format, with no dependency
beyond torch and numpy.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` string map), then the raw little-endian tensor
bytes, offsets relative to the end of the header. bf16 is read as
``uint16`` and reinterpreted with ``.view(torch.bfloat16)``.
"""

from __future__ import annotations

import json
import struct
from typing import Iterator, Mapping, Optional

import numpy as np
import torch

# safetensors dtype tag -> (numpy storage dtype, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_TAGS = {tdt: tag for tag, (_, tdt) in _DTYPES.items()}
_MAX_HEADER = 100 << 20


class SafeTensorsFile:
    """One ``*.safetensors`` file, memory-mapped: ``get(name)`` returns a
    CPU tensor backed by the mapping (no copy until it is moved)."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{path}: header of {n} bytes is too large")
            header = json.loads(f.read(n))
        self.metadata: dict = header.pop("__metadata__", None) or {}
        self._entries: dict = header
        self._base = 8 + n
        self._map = np.memmap(path, dtype=np.uint8, mode="c")  # copy-on-write:
        # tensors are writable views; writes never reach the file
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported "
                                 f"dtype {e['dtype']}")
            b, end = e["data_offsets"]
            width = np.dtype(_DTYPES[e["dtype"]][0]).itemsize
            if (end - b != width * int(np.prod(e["shape"], dtype=np.int64))
                    or self._base + end > self._map.size):
                raise ValueError(f"{path}: tensor {name} has bad offsets")

    def keys(self) -> list[str]:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        np_dt, t_dt = _DTYPES[e["dtype"]]
        b, end = e["data_offsets"]
        raw = self._map[self._base + b: self._base + end]
        arr = raw.view(np_dt).reshape(e["shape"])
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the file as a CPU tensor (copied out of the map)."""
    f = SafeTensorsFile(path)
    return {k: f.get(k).clone() for k in f.keys()}


def _header(items: list[tuple[str, torch.Tensor]],
            metadata: Optional[Mapping[str, str]]) -> bytes:
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name, t in items:
        if t.dtype not in _TAGS:
            raise ValueError(f"tensor {name}: unsupported dtype {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # data starts 8-byte aligned
    return struct.pack("<Q", len(raw)) + raw


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device) to ``path``, one tensor at a time."""
    save_iter(((k, tensors[k]) for k in tensors), path, metadata,
              shapes=[(k, tensors[k]) for k in tensors])


def save_iter(items: Iterator[tuple[str, torch.Tensor]], path: str,
              metadata: Optional[Mapping[str, str]] = None, *,
              shapes: list[tuple[str, torch.Tensor]]) -> None:
    """Streamed write: ``shapes`` lists (name, tensor-like with the final
    dtype and shape, e.g. a meta tensor) in order, for the header; then
    ``items`` yields the real tensors in the same order, so a caller can
    produce each one just before it is written and hold one at a time."""
    written = 0
    with open(path, "wb") as f:
        f.write(_header(shapes, metadata))
        for (name, t), (want, proto) in zip(items, shapes):
            if name != want or t.dtype != proto.dtype or \
                    tuple(t.shape) != tuple(proto.shape):
                raise ValueError(f"tensor {name} does not match the header "
                                 f"entry {want}")
            cpu = t.detach().contiguous().cpu().reshape(-1)
            if cpu.numel():
                f.write(cpu.view(torch.uint8).numpy().data)
            written += 1
    if written != len(shapes):
        raise ValueError(f"{path}: {written} tensors written, the header "
                         f"lists {len(shapes)}")
