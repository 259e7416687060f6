"""Carry a parameter tree of the JAX package across to the port.

The JAX package's ``init_params`` (and its loader) yields a dict of arrays
with every per-layer weight stacked on a leading ``[L, ...]`` axis and
projections in ``[in, out]`` layout. The port keeps exactly that tree, so
conversion is a per-leaf copy: both packages then compute the same thing
on the same weights. Leaves arrive as numpy arrays (``np.asarray`` of a
JAX array); bfloat16 leaves (numpy's ``ml_dtypes`` extension type) are
reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .quant import QTensor
from .transformer import Params


def to_tensor(a: Any, device: Any = "cpu",
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy leaf -> torch tensor on ``device`` (cast to ``dtype``
    when given)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Mapping[str, Any], device: Any = "cpu",
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's params tree (numpy leaves) -> the port's tree. A
    quantized leaf (anything with ``.q`` and ``.scale`` planes, such as
    the JAX package's ``QTensor``) becomes the port's ``QTensor`` with its
    int8 and f32 planes as they are (``dtype`` casts neither)."""
    out: Params = {}
    for k, v in tree.items():
        if hasattr(v, "q") and hasattr(v, "scale"):
            out[k] = QTensor(to_tensor(v.q, device), to_tensor(v.scale, device))
        else:
            out[k] = to_tensor(v, device, dtype)
    return out
