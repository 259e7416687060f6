"""Device resolution for the port's entry points.

Every entry point (engine, backend ``load_model``, server ``--device``)
takes ``device`` and defaults to ``"cuda"``. Without a CUDA device the
call raises unless the caller asked for ``"cpu"`` explicitly: nothing
carries on silently on the CPU.
"""

from __future__ import annotations

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
