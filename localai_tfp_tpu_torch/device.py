"""Device resolution for the port's entry points.

Every entry point (engine, backend ``load_model``, server ``--device``)
takes ``device`` and defaults to ``"cuda"``. Without a CUDA device the
call raises unless the caller asked for ``"cpu"`` explicitly: nothing
carries on silently on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    d = torch.device(DEFAULT_DEVICE if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return d


def describe() -> dict:
    """The card's name and the device count, for logs and result lines."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = (False, False)


@contextlib.contextmanager
def f32_products():
    """TF32 off for f32 matrix products and convolutions inside the block,
    whatever the process's setting (the encoder, the vector store and the
    TTS models compute in f32, as the JAX package does). The flags are
    process-wide: the first block to enter saves them, the last to leave
    puts them back."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved
