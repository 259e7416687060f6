"""Load a HuggingFace checkpoint directory into the port's parameter tree.

Counterpart of localai_tfp_tpu/models/hf_loader.py::load_params for the
families the JAX package serves: Llama, Mistral, Qwen2, Qwen3,
Gemma 1/2/3 (Gemma 3's multimodal checkpoints as their text tower, under
``language_model.model.`` or ``model.language_model.``, as LLaVA's
wrapped text model is), Phi (``dense``,
``fc1``/``fc2``, LayerNorm with biases, a biased head), Phi-3 (fused
``qkv_proj`` and ``gate_up_proj``, split at load), and the mixtures of
experts: Mixtral (``block_sparse_moe``: router ``gate``, experts
``w1``/``w3``/``w2``), Qwen2-MoE (``mlp.gate``, ``mlp.experts.{e}``, a
sigmoid-gated ``mlp.shared_expert``; its dense layers' plain MLP lands in
the shared slots with zeroed experts and router) and Qwen3-MoE. Expert
stacks are ``[L, E, in, out]``. ``config.json`` plus
``*.safetensors`` shards, bf16/f32/f16 on disk. Each weight is read from
the memory-mapped file, moved to the device and written into its slot of
a preallocated stacked ``[L, ...]`` tensor, transposed to the ``[in,
out]`` layout the forward consumes, so the host never holds more than
one layer's tensor and the device never holds a transient stack.

``quantize="int8"`` (or ``"int8_full"``) quantizes on the device as it
loads, layer by layer, into preallocated int8 ``[L, in, out]`` and f32
``[L, out]`` stacks, so the full-precision stack of a quantized leaf
never exists whole (the counterpart of the JAX package's
``staging.commit_deferred``). Each raw tensor is rounded to the serving
dtype before it is quantized, so an f32 checkpoint served at bf16 yields
the JAX package's int8 codes. Biases and norms stay in the serving
dtype. ``int8_full`` also quantizes the embedding (per-row) and an
untied LM head; a tied head (Gemma) stays the product over the
embedding. Expert and shared-expert stacks stay in the serving dtype
under int8, as in the JAX package (``quant.QUANTIZABLE``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional

import torch

from .llm_spec import LLMSpec, spec_from_hf_config
from .load_timing import phase
from .quant import QUANTIZABLE, QTensor, quantize_embed, quantize_raw_tensor
from .safetensors_io import SafeTensorsFile
from .transformer import _NON_LAYER_KEYS, Params, check_supported
from .vision import (VisionParams, VisionSpec, load_clip_vision_params,
                     load_vision_params, vision_spec_from_hf)

# the mixture-of-experts families
MOE_FAMILIES = ("mixtral", "qwen2_moe", "qwen3_moe")
# the families whose HF key layout this loader maps
FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "phi", "phi3", "gemma",
            "gemma2", "gemma3", "gemma3_text") + MOE_FAMILIES


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


def load_multimodal(model_dir: str, dtype: torch.dtype = torch.bfloat16,
                    device: Any = "cpu", state: Optional[tuple] = None
                    ) -> Optional[tuple[VisionSpec, VisionParams, dict]]:
    """The vision tower and projector of a multimodal checkpoint (the JAX
    package's ``load_multimodal``): (VisionSpec, VisionParams, mm_info),
    or None for a text-only checkpoint. A CLIP tower (it has
    ``embeddings.class_embedding``) is LLaVA's: one soft token per patch
    replacing the ``<image>`` placeholder, no boi/eoi tokens; otherwise
    SigLIP with Gemma 3's pooled ``mm_tokens_per_image``. ``mm_info``
    holds ``boi_token``, ``eoi_token``, ``image_token``, ``mm_tokens``,
    ``image_size`` and ``family``."""
    config, get, names = state or load_hf_state(model_dir)
    vcfg = config.get("vision_config")
    if not isinstance(vcfg, dict):
        return None
    tcfg = config.get("text_config") or {}
    text_d = int(tcfg.get("hidden_size") or config.get("hidden_size") or 0)
    if any(n.endswith("embeddings.class_embedding") for n in names):
        vspec = vision_spec_from_hf(vcfg, 0, text_d)
        vspec = dataclasses.replace(
            vspec, family="clip", mm_tokens=vspec.n_patches,
            eps=float(vcfg.get("layer_norm_eps") or 1e-5))
        vparams = load_clip_vision_params(get, names, dtype, vspec, device)
        if vparams is None:
            return None
        return vspec, vparams, {
            "boi_token": None, "eoi_token": None,
            "image_token": int(config.get("image_token_index") or 32000),
            "mm_tokens": vspec.mm_tokens, "image_size": vspec.image_size,
            "family": "clip"}
    mm_tokens = int(config.get("mm_tokens_per_image") or 256)
    vspec = vision_spec_from_hf(vcfg, mm_tokens, text_d)
    vparams = load_vision_params(get, names, dtype, vspec, device)
    if vparams is None:
        return None
    return vspec, vparams, {
        "boi_token": int(config.get("boi_token_index") or 255999),
        "eoi_token": int(config.get("eoi_token_index") or 256000),
        "image_token": int(config.get("image_token_index") or 262144),
        "mm_tokens": mm_tokens, "image_size": vspec.image_size,
        "family": "siglip"}


def spec_from_config(config: dict) -> LLMSpec:
    """The spec of a served family's ``config.json``; raises for the
    rest, naming the served list."""
    mt = (config.get("model_type") or "").lower()
    if mt == "llava" and isinstance(config.get("text_config"), dict):
        # a LLaVA wrapper serves its nested text model (the CLIP tower
        # loads through load_multimodal)
        mt = (config["text_config"].get("model_type") or "llama").lower()
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
        with phase("read_s"):
            host = get(name)
        with phase("transfer_s", device):
            return host.to(device=device).to(dtype)

    def quantized(w: torch.Tensor) -> QTensor:
        with phase("dequant_s", device):
            return quantize_raw_tensor(w)

    def per_layer(suffix: str) -> Callable[[int], torch.Tensor]:
        return lambda i: dev(lp.format(i=i) + suffix)

    def stacked(layer: Callable[[int], torch.Tensor],
                transpose: bool) -> torch.Tensor:
        first = layer(0)
        shape = first.shape[::-1] if transpose else first.shape
        out = torch.empty((L, *shape), dtype=dtype, device=device)
        for i in range(L):
            w = first if i == 0 else layer(i)
            out[i].copy_(w.T if transpose else w)
        return out

    def stacked_int8(layer: Callable[[int], torch.Tensor]) -> QTensor:
        qt = quantized(layer(0))
        q = torch.empty((L, *qt.q.shape), dtype=torch.int8, device=device)
        scale = torch.empty((L, *qt.scale.shape), dtype=torch.float32,
                            device=device)
        for i in range(L):
            if i:
                qt = quantized(layer(i))
            q[i].copy_(qt.q)
            scale[i].copy_(qt.scale)
        return QTensor(q, scale)

    def projection(key: str, layer: Callable[[int], torch.Tensor]):
        if quantize and key in QUANTIZABLE:
            return stacked_int8(layer)
        return stacked(layer, transpose=True)

    def fused(suffix: str, parts: dict[str, int]) -> None:
        """A fused ``[out, in]`` weight (phi3), read once per layer and
        split into ``parts`` (key: width, in row order) along the
        serving layout's columns. Its int8 scales are per output row, so
        quantizing the fused rows gives each part's own."""
        w = projection(next(iter(parts)), per_layer(suffix))
        lo = 0
        for key, width in parts.items():
            cols = slice(lo, lo + width)
            p[key] = (QTensor(w.q[..., cols].contiguous(),
                              w.scale[..., cols].contiguous())
                      if isinstance(w, QTensor)
                      else w[..., cols].contiguous())
            lo += width

    def vector(suffix: str) -> torch.Tensor:  # biases and norm weights
        return stacked(per_layer(suffix), transpose=False)

    def head(name: str):
        return (quantized(dev(name)) if full
                else dev(name).T.contiguous())

    embed = dev(f"{prefix}embed_tokens.weight")
    if full:
        with phase("dequant_s", device):
            embed = quantize_embed(embed)
    p: Params = {"embed": embed}
    del embed
    mt = spec.extra.get("model_type", "")
    if mt == "phi":
        for key, suffix in (("wq", "self_attn.q_proj"),
                            ("wk", "self_attn.k_proj"),
                            ("wv", "self_attn.v_proj"),
                            ("wo", "self_attn.dense"),
                            ("w_up", "mlp.fc1"), ("w_down", "mlp.fc2")):
            p[key] = projection(key, per_layer(suffix + ".weight"))
        for key, suffix in (("bq", "self_attn.q_proj"),
                            ("bk", "self_attn.k_proj"),
                            ("bv", "self_attn.v_proj"),
                            ("bo", "self_attn.dense"),
                            ("b_up", "mlp.fc1"), ("b_down", "mlp.fc2")):
            p[key] = vector(suffix + ".bias")
        p["ln1_w"] = vector("input_layernorm.weight")
        p["ln1_b"] = vector("input_layernorm.bias")
        p["final_norm_w"] = dev(f"{prefix}final_layernorm.weight")
        p["final_norm_b"] = dev(f"{prefix}final_layernorm.bias")
        p["lm_head"] = head("lm_head.weight")
        p["lm_head_b"] = dev("lm_head.bias")
        return spec, p

    if lp.format(i=0) + "self_attn.qkv_proj.weight" in names:  # phi3
        fused("self_attn.qkv_proj.weight",
              {"wq": spec.q_dim, "wk": spec.kv_dim, "wv": spec.kv_dim})
    else:
        for key, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                          ("wv", "v_proj")):
            p[key] = projection(key, per_layer(f"self_attn.{proj}.weight"))
        if spec.qkv_bias:
            for key, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                              ("bv", "v_proj")):
                p[key] = vector(f"self_attn.{proj}.bias")
    p["wo"] = projection("wo", per_layer("self_attn.o_proj.weight"))
    if spec.n_experts:
        _load_experts(spec, p, dev, lp, dtype, device)
    elif lp.format(i=0) + "mlp.gate_up_proj.weight" in names:  # phi3
        fused("mlp.gate_up_proj.weight",
              {"w_gate": spec.d_ff, "w_up": spec.d_ff})
    else:
        if spec.gated_mlp:
            p["w_gate"] = projection("w_gate",
                                     per_layer("mlp.gate_proj.weight"))
        p["w_up"] = projection("w_up", per_layer("mlp.up_proj.weight"))
    if not spec.n_experts:
        p["w_down"] = projection("w_down",
                                 per_layer("mlp.down_proj.weight"))
    if spec.qk_norm:  # qwen3 / gemma3 per-head q/k norms
        p["q_norm_w"] = vector("self_attn.q_norm.weight")
        p["k_norm_w"] = vector("self_attn.k_norm.weight")
    p["ln1_w"] = vector("input_layernorm.weight")
    if spec.sandwich_norms:
        # gemma 2/3: post_attention_layernorm is the post-attention
        # sandwich norm; the pre-MLP norm has its own name
        p["ln_post_attn_w"] = vector("post_attention_layernorm.weight")
        p["ln2_w"] = vector("pre_feedforward_layernorm.weight")
        p["ln_post_ffw_w"] = vector("post_feedforward_layernorm.weight")
    else:
        p["ln2_w"] = vector("post_attention_layernorm.weight")
    p["final_norm_w"] = dev(f"{prefix}norm.weight")
    if not spec.tie_word_embeddings:
        for name in ("lm_head.weight", "language_model.lm_head.weight"):
            if name in names:
                p["lm_head"] = head(name)
                break
        else:  # checkpoint ties despite config
            object.__setattr__(spec, "tie_word_embeddings", True)
    return spec, p


def _load_experts(spec: LLMSpec, p: Params, dev: Callable[[str], Any],
                  lp: str, dtype: torch.dtype, device: Any) -> None:
    """The router and expert stacks of a mixture of experts into ``p``:
    ``router [L, D, E]``, ``moe_gate``/``moe_up [L, E, D, Fm]``,
    ``moe_down [L, E, Fm, D]`` and, for Qwen2-MoE, ``shared_gate``/
    ``shared_up [L, D, Fs]``, ``shared_down [L, Fs, D]`` and
    ``shared_router [L, D]``. Each weight is read, moved to the device
    and written transposed into its slot; a Qwen2-MoE dense layer's
    experts and router stay zero and its plain MLP fills the shared
    slots."""
    L, E, D = spec.n_layers, spec.n_experts, spec.d_model
    Fm = spec.moe_d_ff or spec.d_ff
    mixtral = spec.extra.get("model_type") == "mixtral"
    dense = set(spec.moe_dense_layers)
    Fs = spec.moe_shared_d_ff or spec.d_ff
    if dense and Fs != spec.d_ff:
        raise NotImplementedError(
            "qwen2_moe with dense layers requires "
            "shared_expert_intermediate_size == intermediate_size")

    def zeros(*shape):
        return torch.zeros((L, *shape), dtype=dtype, device=device)

    base = "block_sparse_moe." if mixtral else "mlp."
    names = ({"moe_gate": "w1", "moe_up": "w3", "moe_down": "w2"}
             if mixtral else {"moe_gate": "gate_proj", "moe_up": "up_proj",
                              "moe_down": "down_proj"})
    p["router"] = zeros(D, E)
    for key in ("moe_gate", "moe_up"):
        p[key] = zeros(E, D, Fm)
    p["moe_down"] = zeros(E, Fm, D)
    for i in range(L):
        if i in dense:
            continue
        pre = lp.format(i=i) + base
        p["router"][i].copy_(dev(pre + "gate.weight").T)
        for key, proj in names.items():
            for e in range(E):
                p[key][i, e].copy_(
                    dev(pre + f"experts.{e}.{proj}.weight").T)
    if not spec.moe_shared_expert:
        return
    p["shared_gate"], p["shared_up"] = zeros(D, Fs), zeros(D, Fs)
    p["shared_down"], p["shared_router"] = zeros(Fs, D), zeros(D)
    for i in range(L):
        pre = lp.format(i=i) + ("mlp." if i in dense
                                else "mlp.shared_expert.")
        for key, proj in (("shared_gate", "gate_proj"),
                          ("shared_up", "up_proj"),
                          ("shared_down", "down_proj")):
            p[key][i].copy_(dev(pre + f"{proj}.weight").T)
        if i not in dense:
            p["shared_router"][i].copy_(
                dev(lp.format(i=i) + "mlp.shared_expert_gate.weight")[0])


def layer_pages(tree: dict, n_layers: int):
    """Partition a parameter tree into the weight pager's transfer units
    (the JAX package's ``layer_pages``). Every per-layer leaf is one
    stacked ``[L, ...]`` tensor (an expert stack ``[L, E, in, out]``
    too), so page ``li`` is row ``li`` of each stacked leaf: a contiguous
    byte range of a contiguous stack, moved by one ``copy_`` each way.
    Returns ``(layered, globals_, page)``:

    - ``layered``: the stacked leaves (keys outside ``_NON_LAYER_KEYS``);
    - ``globals_``: the embedding, final norm and LM head, which travel
      as one extra page;
    - ``page(li)``: layer ``li``'s rows by key, a ``QTensor`` leaf's
      ``q`` and ``scale`` rows together (so an int8 round trip is
      bit-exact).

    Works on host and device trees alike."""
    layered = {k: v for k, v in tree.items() if k not in _NON_LAYER_KEYS}
    globals_ = {k: v for k, v in tree.items() if k in _NON_LAYER_KEYS}

    def page(li: int) -> dict:
        if not 0 <= li < n_layers:
            raise IndexError(f"layer page {li} outside [0, {n_layers})")
        return {k: v.layer(li) if isinstance(v, QTensor) else v[li]
                for k, v in layered.items()}

    return layered, globals_, page
