"""In-memory vector store backend (counterpart of localai_tfp_tpu/store/
backend.py; ref: backend/go/stores/store.go:39-511 — columnar f32 keys and
byte values, StoresSet :106 upserts on an equal key, StoresGet :266,
StoresFindNormalized :373 with its normalised-keys fast path, top-K :349).

Two stores with one surface: ``NativeVectorStore`` (``store/native.py``,
host C++) and ``VectorStore`` (a contiguous numpy key matrix and a list
of values), chosen by ``make_store`` from ``LOCALAI_NATIVE_STORE`` (on by
default; a failed native build then raises). ``VectorStore.find`` is one
matvec: numpy below ``_DEVICE_THRESHOLD`` rows, on the worker's device
with torch at and above it (``device_dots``), which copies the whole key
matrix to the device on every find, as the JAX package does with
``jnp``.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from ..config import knobs
from ..device import f32_products, resolve
from ..workers.base import Backend, ModelLoadOptions, Result
from .native import NativeVectorStore

_DEVICE_THRESHOLD = 50_000  # rows; at and above it the matvec runs on device


def device_dots(keys: np.ndarray, key: np.ndarray,
                device: torch.device) -> np.ndarray:
    """``keys @ key`` on ``device``: the keys copied there whole, the
    product in f32."""
    k = torch.from_numpy(keys).to(device)
    q = torch.from_numpy(key).to(device)
    with f32_products():
        return (k @ q).cpu().numpy()


class VectorStore:
    def __init__(self, device: Any = "cpu") -> None:
        self.device = torch.device(device)
        self._keys = np.zeros((0, 0), np.float32)
        self._norms = np.zeros((0,), np.float32)
        self._values: list = []
        self._index: dict[bytes, int] = {}
        self._normalized = True  # all keys unit-norm so far (ref :373)
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._values)

    @staticmethod
    def _kb(key: np.ndarray) -> bytes:
        return np.ascontiguousarray(key, np.float32).tobytes()

    def set(self, keys: np.ndarray, values: list) -> None:
        """Upsert rows: an equal key replaces its value."""
        keys = np.atleast_2d(np.asarray(keys, np.float32))
        if len(values) != keys.shape[0]:
            raise ValueError("keys and values length mismatch")
        with self._lock:
            if self._keys.size == 0 and keys.shape[0]:
                self._keys = np.zeros((0, keys.shape[1]), np.float32)
            if keys.shape[0] and keys.shape[1] != self._keys.shape[1]:
                raise ValueError(
                    f"key width {keys.shape[1]} != store width "
                    f"{self._keys.shape[1]}")
            new_rows, new_vals = [], []
            for k, v in zip(keys, values):
                kb = self._kb(k)
                i = self._index.get(kb)
                if i is not None:
                    self._values[i] = v
                else:
                    self._index[kb] = len(self._values) + len(new_rows)
                    new_rows.append(k)
                    new_vals.append(v)
            if new_rows:
                block = np.stack(new_rows)
                self._keys = np.concatenate([self._keys, block])
                norms = np.linalg.norm(block, axis=1)
                self._norms = np.concatenate([self._norms, norms])
                self._values.extend(new_vals)
                if not np.allclose(norms, 1.0, atol=1e-4):
                    self._normalized = False

    def get(self, keys: np.ndarray) -> tuple[np.ndarray, list]:
        keys = np.atleast_2d(np.asarray(keys, np.float32))
        out_k, out_v = [], []
        with self._lock:
            for k in keys:
                i = self._index.get(self._kb(k))
                if i is not None:
                    out_k.append(k)
                    out_v.append(self._values[i])
        return (np.stack(out_k) if out_k else
                np.zeros((0, keys.shape[1]), np.float32)), out_v

    def delete(self, keys: np.ndarray) -> int:
        keys = np.atleast_2d(np.asarray(keys, np.float32))
        with self._lock:
            drop = {self._index[self._kb(k)] for k in keys
                    if self._kb(k) in self._index}
            if not drop:
                return 0
            keep = [i for i in range(len(self._values)) if i not in drop]
            self._keys = self._keys[keep]
            self._norms = self._norms[keep]
            self._values = [self._values[i] for i in keep]
            self._index = {self._kb(k): i for i, k in enumerate(self._keys)}
            return len(drop)

    def find(self, key: np.ndarray, top_k: int
             ) -> tuple[np.ndarray, list, np.ndarray]:
        """Cosine top-K: the dot product when every key is unit-norm, the
        full cosine otherwise."""
        key = np.asarray(key, np.float32).reshape(-1)
        with self._lock:
            if not len(self._values):
                return (np.zeros((0, key.shape[0]), np.float32), [],
                        np.zeros((0,), np.float32))
            keys, norms = self._keys, self._norms
            values = list(self._values)
            normalized = self._normalized
        if keys.shape[0] >= _DEVICE_THRESHOLD:
            dots = device_dots(keys, key, self.device)
        else:
            dots = keys @ key
        if normalized:
            sims = dots
        else:
            qn = np.linalg.norm(key)
            sims = dots / np.maximum(norms * qn, 1e-12)
        k = min(top_k, sims.shape[0])
        top = np.argpartition(-sims, k - 1)[:k]
        top = top[np.argsort(-sims[top])]
        return keys[top], [values[i] for i in top], sims[top]


def make_store(device: Any = "cpu"):
    """The native store unless ``LOCALAI_NATIVE_STORE`` is off (then the
    Python store, its large finds on ``device``)."""
    if knobs.flag("LOCALAI_NATIVE_STORE"):
        return NativeVectorStore()
    return VectorStore(device)


class LocalStoreBackend(Backend):
    """The worker behind ``/stores/*`` (ref: backend.proto
    StoresSet/Delete/Get/Find); ``device`` is where the Python store's
    large finds run (the card unless the caller asks for the CPU)."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self.store = make_store(self.device)

    def load_model(self, opts: ModelLoadOptions) -> Result:
        return Result(True, "store ready")

    def stores_set(self, keys, values) -> Result:
        self.store.set(np.asarray(keys, np.float32), list(values))
        return Result(True)

    def stores_delete(self, keys) -> Result:
        self.store.delete(np.asarray(keys, np.float32))
        return Result(True)

    def stores_get(self, keys):
        got_k, got_v = self.store.get(np.asarray(keys, np.float32))
        return got_k.tolist(), got_v

    def stores_find(self, key, top_k: int):
        got_k, got_v, sims = self.store.find(np.asarray(key, np.float32),
                                             top_k)
        return got_k.tolist(), got_v, sims.tolist()
