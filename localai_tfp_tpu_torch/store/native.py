"""ctypes binding for the native vector store (csrc/vecstore.cpp, the
port's own copy of localai_tfp_tpu/native/vecstore.cpp): the same
surface as ``store/backend.py::VectorStore``. Key storage, de-duplication,
deletion compaction and the similarity scan live in C++; values stay
here, by row id.

The library is built from the port's own source by ``utils/cxx.py`` at
first use into ``build/torch_kernels/libvecstore-<hash>.so``; a failed
build or load raises with the compiler's error.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..ops._build import CSRC
from ..utils import cxx

SRC = CSRC / "vecstore.cpp"

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def load_library() -> ctypes.CDLL:
    """The native store, built on first use; raises when it cannot be
    built or loaded."""
    with _lock:
        so = cxx.build(SRC, "native vector store")
        lib = _libs.get(so)
        if lib is None:
            try:
                lib = _bind(ctypes.CDLL(str(so)))
            except OSError as e:
                raise RuntimeError(f"native vector store load: {e}") from None
            _libs[so] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.vs_new.restype = c.c_void_p
    lib.vs_free.argtypes = [c.c_void_p]
    lib.vs_len.restype = c.c_int64
    lib.vs_len.argtypes = [c.c_void_p]
    lib.vs_set.restype = c.c_int64
    lib.vs_set.argtypes = [c.c_void_p, f32p, c.c_int64, c.c_int, i64p]
    lib.vs_get.argtypes = [c.c_void_p, f32p, c.c_int64, i64p]
    lib.vs_delete.restype = c.c_int64
    lib.vs_delete.argtypes = [c.c_void_p, f32p, c.c_int64, i64p]
    lib.vs_find.restype = c.c_int64
    lib.vs_find.argtypes = [c.c_void_p, f32p, c.c_int64, i64p, f32p]
    lib.vs_row_key.argtypes = [c.c_void_p, c.c_int64, f32p]
    lib.vs_dim.restype = c.c_int
    lib.vs_dim.argtypes = [c.c_void_p]
    return lib


class NativeVectorStore:
    """Keys and the cosine scan in C++, values in a list by row id."""

    def __init__(self) -> None:
        self._lib = load_library()
        self._h = self._lib.vs_new()
        self._values: list = []
        self._lock = threading.RLock()

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.vs_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.vs_len(self._h))

    def _check_dim(self, keys: np.ndarray) -> None:
        """The C side trusts the caller's width; hold it here (the Python
        store raises the same way)."""
        dim = self._lib.vs_dim(self._h)
        if dim and keys.shape[-1] != dim:
            raise ValueError(
                f"key width {keys.shape[-1]} != store width {dim}")

    def set(self, keys: np.ndarray, values: list) -> None:
        keys = np.ascontiguousarray(np.atleast_2d(keys), np.float32)
        if len(values) != keys.shape[0]:
            raise ValueError("keys and values length mismatch")
        with self._lock:
            rows = np.zeros(keys.shape[0], np.int64)
            total = self._lib.vs_set(
                self._h, keys, keys.shape[0], keys.shape[1], rows)
            if total < 0:
                raise ValueError(
                    f"key width {keys.shape[1]} != store width "
                    f"{self._lib.vs_dim(self._h)}")
            for r, v in zip(rows, values):
                if r < len(self._values):
                    self._values[r] = v
                else:
                    self._values.append(v)

    def get(self, keys: np.ndarray) -> tuple[np.ndarray, list]:
        keys = np.ascontiguousarray(np.atleast_2d(keys), np.float32)
        with self._lock:
            self._check_dim(keys)
            rows = np.zeros(keys.shape[0], np.int64)
            self._lib.vs_get(self._h, keys, keys.shape[0], rows)
            hit = rows >= 0
            return keys[hit], [self._values[r] for r in rows[hit]]

    def delete(self, keys: np.ndarray) -> int:
        keys = np.ascontiguousarray(np.atleast_2d(keys), np.float32)
        with self._lock:
            self._check_dim(keys)
            remap = np.zeros(max(len(self._values), 1), np.int64)
            dropped = self._lib.vs_delete(self._h, keys, keys.shape[0], remap)
            if dropped:
                self._values = [v for r, v in enumerate(self._values)
                                if remap[r] >= 0]
            return int(dropped)

    def find(self, key: np.ndarray, top_k: int
             ) -> tuple[np.ndarray, list, np.ndarray]:
        key = np.ascontiguousarray(np.asarray(key, np.float32).reshape(-1))
        with self._lock:
            self._check_dim(key[None])
            n = len(self._values)
            if not n:
                return (np.zeros((0, key.shape[0]), np.float32), [],
                        np.zeros((0,), np.float32))
            rows = np.zeros(min(top_k, n), np.int64)
            sims = np.zeros(min(top_k, n), np.float32)
            k = self._lib.vs_find(self._h, key, top_k, rows, sims)
            out_keys = np.zeros((k, key.shape[0]), np.float32)
            for j in range(k):
                self._lib.vs_row_key(self._h, rows[j], out_keys[j])
            return out_keys, [self._values[r] for r in rows[:k]], sims[:k]
