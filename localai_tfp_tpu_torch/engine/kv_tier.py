"""The on-disk prompt-cache format: the port's copy of the cold-tier
format code of localai_tfp_tpu/engine/kv_tier.py (``write_cache_file``,
``read_cache_file``). The warm tier (``KVTierManager``: pinned host
pages, spill and prefetch) is not ported yet.

One ``np.savez`` per session with ``tokens`` (int32 ``[n]``) and
slot-contiguous rows ``k``/``v`` (``[L, n, F]``; int8 adds
``k_scale``/``v_scale`` ``[L, n]``). bf16 rows are widened to f32 (numpy
has no portable bf16); the restore casts back. A file written by either
package is readable through ``prompt_cache_path`` by the other.
"""

from __future__ import annotations

import os
import uuid
from typing import Optional

import numpy as np

__all__ = ["write_cache_file", "read_cache_file"]


def write_cache_file(path: str, tokens: np.ndarray, k: np.ndarray,
                     v: np.ndarray,
                     scales: Optional[tuple] = None) -> None:
    """Atomically persist one session in the prompt-cache format (host
    arrays: int8 and f32 rows are kept, any other float is widened to
    f32)."""

    def host(arr):
        out = np.asarray(arr)
        return out if out.dtype in (np.int8, np.float32) \
            else out.astype(np.float32)

    payload = {"tokens": np.asarray(tokens, np.int32),
               "k": host(k), "v": host(v)}
    if scales is not None:
        payload["k_scale"] = np.asarray(scales[0])
        payload["v_scale"] = np.asarray(scales[1])
    # unique temp name: concurrent saves to one path must not truncate
    # each other's half-written file before os.replace
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def read_cache_file(path: str):
    """Open a prompt-cache file (a lazy ``NpzFile`` mapping with keys
    tokens, k, v and, for int8 rows, k_scale, v_scale)."""
    return np.load(path)
