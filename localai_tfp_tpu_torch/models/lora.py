"""LoRA adapters: read a PEFT adapter and merge it into the stacked
parameter leaves (counterpart of localai_tfp_tpu/models/lora.py).

An adapter is merged at load or applied to a running engine as
``W += scale * (alpha / r) * (B @ A).T`` on each ``[L, in, out]``
projection leaf it names, so serving keeps the same forward and, on a
card, the same captured CUDA graphs: ``merge_lora(..., inplace=True)``
writes the merged values into the tensors the graphs read. Removing an
adapter unmerges it (``sign=-1``) with the same scale.

The delta is computed as the JAX package computes it: the product in f64,
rounded to f32; the leaf is widened to f32, the delta added, and the sum
rounded to the leaf's dtype. The adapter's files are PEFT safetensors
(``adapter_model.safetensors``: ``...layers.{i}.self_attn.q_proj.
lora_A.weight`` A ``[r, in]`` and ``lora_B.weight`` B ``[out, r]``) with
``r`` and ``lora_alpha`` in ``adapter_config.json``, read by the port's
``safetensors_io``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch

from .llm_spec import LLMSpec
from .quant import QTensor
from .safetensors_io import SafeTensorsFile

# projection name -> stacked parameter leaf
_PROJ_TO_LEAF = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}


def load_adapter(adapter_dir: str) -> tuple[dict[str, torch.Tensor], float]:
    """Read a PEFT adapter dir -> (tensors by name, alpha / r)."""
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    scaling = 1.0
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        r = float(cfg.get("r") or cfg.get("lora_rank") or 1)
        alpha = float(cfg.get("lora_alpha") or r)
        scaling = alpha / max(r, 1.0)
    path = os.path.join(adapter_dir, "adapter_model.safetensors")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no adapter_model.safetensors in {adapter_dir}")
    st = SafeTensorsFile(path)
    tensors = {name: st.get(name) for name in st.keys()}
    if not tensors:
        raise FileNotFoundError(f"{path} holds no tensors")
    return tensors, scaling


def _layer_index(name: str) -> Optional[int]:
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p == "layers" and i + 1 < len(parts):
            try:
                return int(parts[i + 1])
            except ValueError:
                return None
    return None


def _proj_name(name: str) -> Optional[str]:
    for proj in _PROJ_TO_LEAF:
        if f".{proj}." in name:
            return proj
    return None


def merge_lora(spec: LLMSpec, params: dict[str, Any], adapter_dir: str,
               scale: float = 1.0, sign: float = 1.0,
               inplace: bool = False) -> tuple[dict[str, Any], int]:
    """Merge (``sign=+1``) or unmerge (``sign=-1``) an adapter into the
    stacked params. Returns (params, projection sites touched). With
    ``inplace`` the merged layers are written into the existing tensors
    (the engine's captured graphs keep reading them); otherwise the
    touched leaves are new tensors and the rest are shared. Quantized
    leaves are refused; an adapter that matches no leaf (another naming,
    or Phi-3's fused projections) raises."""
    tensors, scaling = load_adapter(adapter_dir)
    scaling *= scale * sign
    deltas: dict[str, dict[int, tuple]] = {}
    for name, a in tensors.items():
        if ".lora_A." not in name:
            continue
        b = tensors.get(name.replace(".lora_A.", ".lora_B."))
        layer, proj = _layer_index(name), _proj_name(name)
        if b is None or layer is None or proj is None:
            continue
        leaf = _PROJ_TO_LEAF[proj]
        if leaf not in params:
            continue
        deltas.setdefault(leaf, {})[layer] = (a, b)
    touched = sum(len(v) for v in deltas.values())
    if not touched:
        raise ValueError(
            f"adapter {adapter_dir} matched no parameters "
            "(unsupported naming or fused projections)")
    for leaf, by_layer in deltas.items():  # every check before a write
        w = params[leaf]
        if isinstance(w, QTensor):
            raise ValueError(f"LoRA merge needs full-precision weights; "
                             f"{leaf} is int8")
        for layer, (a, b) in by_layer.items():
            # torch linears: A [r, in], B [out, r]; leaves are [L, in, out]
            shape = (a.shape[1], b.shape[0])
            if layer >= w.shape[0] or shape != tuple(w.shape[1:]):
                raise ValueError(
                    f"adapter shape mismatch on {leaf}[{layer}]: "
                    f"{shape} vs {tuple(w.shape[1:])}")
    out = dict(params)
    for leaf, by_layer in deltas.items():
        w = params[leaf]
        target = w if inplace else w.clone()
        for layer, (a, b) in by_layer.items():
            delta = ((b.to(w.device, torch.float64)
                      @ a.to(w.device, torch.float64)).T
                     * scaling).float()
            target[layer].copy_((w[layer].float() + delta).to(w.dtype))
        out[leaf] = target
    return out, touched
