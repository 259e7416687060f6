"""Load a HuggingFace checkpoint directory into the port's parameter tree.

Counterpart of localai_tfp_tpu/models/hf_loader.py::load_params for the
families this slice serves (Llama, Mistral, Qwen2, Qwen3): ``config.json``
plus ``*.safetensors`` shards, bf16/f32/f16 on disk. Each weight is read
from the memory-mapped file, moved to the device and written into its
slot of a preallocated stacked ``[L, ...]`` tensor, transposed to the
``[in, out]`` layout the forward consumes, so the host never holds more
than one layer's tensor and the device never holds a transient stack.

``quantize="int8"`` (or ``"int8_full"``) quantizes on the device as it
loads, layer by layer, into preallocated int8 ``[L, in, out]`` and f32
``[L, out]`` stacks, so the full-precision stack of a quantized leaf
never exists whole (the counterpart of the JAX package's
``staging.commit_deferred``). Each raw tensor is rounded to the serving
dtype before it is quantized, so an f32 checkpoint served at bf16 yields
the JAX package's int8 codes. ``int8_full`` also quantizes the embedding
(per-row) and an untied LM head.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import torch

from .llm_spec import LLMSpec, spec_from_hf_config
from .quant import QUANTIZABLE, QTensor, quantize_embed, quantize_raw_tensor
from .safetensors_io import SafeTensorsFile
from .transformer import Params, check_supported

# the families whose HF key layout this loader maps (Llama-style names)
FAMILIES = ("llama", "mistral", "qwen2", "qwen3")


def load_hf_state(model_dir: str) -> tuple[dict, Callable[[str], torch.Tensor],
                                           list[str]]:
    """(config dict, tensor getter, tensor names) for a local HF dir."""
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    files = sorted(os.path.join(model_dir, n) for n in os.listdir(model_dir)
                   if n.endswith(".safetensors") and not n.startswith("."))
    if not files:
        raise FileNotFoundError(f"no *.safetensors file in {model_dir}")
    index: dict[str, SafeTensorsFile] = {}
    for p in files:
        h = SafeTensorsFile(p)
        for name in h.keys():
            index[name] = h

    def get(name: str) -> torch.Tensor:
        return index[name].get(name)

    return config, get, list(index)


def spec_from_config(config: dict) -> LLMSpec:
    """The spec of a served family's ``config.json``; raises for the
    rest."""
    mt = (config.get("model_type") or "").lower()
    if mt not in FAMILIES:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported yet (served: {FAMILIES})")
    spec = spec_from_hf_config(config)
    check_supported(spec)
    return spec


def load_params(model_dir: str, dtype: torch.dtype = torch.bfloat16,
                device: Any = "cpu",
                quantize: str = "") -> tuple[LLMSpec, Params]:
    """Load an HF checkpoint directory -> (spec, stacked params).
    ``quantize``: "" (none), "int8" or "int8_full"."""
    if quantize not in ("", "int8", "int8_full"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    config, get, names = load_hf_state(model_dir)
    spec = spec_from_config(config)
    L = spec.n_layers
    full = quantize == "int8_full"
    prefix = next((c for c in ("language_model.model.",
                               "model.language_model.", "model.")
                   if f"{c}embed_tokens.weight" in names), "")
    lp = f"{prefix}layers." + "{i}."

    def dev(name: str) -> torch.Tensor:
        return get(name).to(device=device).to(dtype)

    def stacked(suffix: str, transpose: bool) -> torch.Tensor:
        first = get(lp.format(i=0) + suffix)
        shape = first.shape[::-1] if transpose else first.shape
        out = torch.empty((L, *shape), dtype=dtype, device=device)
        for i in range(L):
            w = dev(lp.format(i=i) + suffix)
            out[i].copy_(w.T if transpose else w)
        return out

    def stacked_int8(suffix: str) -> QTensor:
        n_out, n_in = get(lp.format(i=0) + suffix).shape
        q = torch.empty((L, n_in, n_out), dtype=torch.int8, device=device)
        scale = torch.empty((L, n_out), dtype=torch.float32, device=device)
        for i in range(L):
            qt = quantize_raw_tensor(dev(lp.format(i=i) + suffix))
            q[i].copy_(qt.q)
            scale[i].copy_(qt.scale)
        return QTensor(q, scale)

    def projection(key: str, suffix: str):
        if quantize and key in QUANTIZABLE:
            return stacked_int8(suffix)
        return stacked(suffix, transpose=True)

    embed = dev(f"{prefix}embed_tokens.weight")
    p: Params = {"embed": quantize_embed(embed) if full else embed}
    del embed
    for key, suffix in (("wq", "self_attn.q_proj.weight"),
                        ("wk", "self_attn.k_proj.weight"),
                        ("wv", "self_attn.v_proj.weight"),
                        ("wo", "self_attn.o_proj.weight"),
                        ("w_up", "mlp.up_proj.weight"),
                        ("w_down", "mlp.down_proj.weight")):
        p[key] = projection(key, suffix)
    if spec.gated_mlp:
        p["w_gate"] = projection("w_gate", "mlp.gate_proj.weight")
    if spec.qkv_bias:
        for key, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                          ("bv", "v_proj")):
            p[key] = stacked(f"self_attn.{proj}.bias", transpose=False)
    if spec.qk_norm:  # qwen3 per-head q/k norms
        p["q_norm_w"] = stacked("self_attn.q_norm.weight", transpose=False)
        p["k_norm_w"] = stacked("self_attn.k_norm.weight", transpose=False)
    p["ln1_w"] = stacked("input_layernorm.weight", transpose=False)
    p["ln2_w"] = stacked("post_attention_layernorm.weight", transpose=False)
    p["final_norm_w"] = dev(f"{prefix}norm.weight")
    if not spec.tie_word_embeddings:
        for head in ("lm_head.weight", "language_model.lm_head.weight"):
            if head in names:
                p["lm_head"] = (quantize_raw_tensor(dev(head)) if full
                                else dev(head).T.contiguous())
                break
        else:  # checkpoint ties despite config
            object.__setattr__(spec, "tie_word_embeddings", True)
    return spec, p
