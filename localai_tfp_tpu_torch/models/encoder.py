"""Bidirectional text encoder (BERT / MiniLM family) in PyTorch.

Counterpart of localai_tfp_tpu/models/encoder.py: the model behind the
embeddings worker (masked mean pool, sentence-transformers semantics)
and the rerank worker (the cross-encoder's pooler and classifier).
Parameters keep the JAX package's tree (``EncParams``: per-layer weights
stacked on a leading ``[L, ...]`` axis, projections ``[in, out]``), so
both packages compute the same thing on the same weights
(``models/convert.py::encoder_params_from_jax``).

Everything runs in f32, as the JAX package runs it with
``Precision.HIGHEST``: ``encode`` turns TF32 off for its products while
it runs (``device.f32_products``), whatever the process's global setting. The
attention is plain torch (no kernel: the JAX encoder has no Pallas
kernel either): f32 logits, an additive ``-1e30`` on masked keys, a
softmax in f32; padded query rows still attend, so their hidden states
are finite and pooling masks them out. GELU is exact; LayerNorm uses the
population variance and the config's ``eps``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..device import f32_products

EncParams = dict[str, torch.Tensor]
NEG_INF = -1e30


@dataclass(frozen=True)
class EncoderSpec:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    max_position: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    n_classes: int = 0  # >0: cross-encoder classification head

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def spec_from_hf_config(cfg: dict[str, Any]) -> EncoderSpec:
    return EncoderSpec(
        vocab_size=cfg.get("vocab_size", 30522),
        d_model=cfg.get("hidden_size", 384),
        n_layers=cfg.get("num_hidden_layers", 6),
        n_heads=cfg.get("num_attention_heads", 12),
        d_ff=cfg.get("intermediate_size", 1536),
        max_position=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        norm_eps=float(cfg.get("layer_norm_eps", 1e-12)),
    )


def tiny_encoder_spec(**over: Any) -> EncoderSpec:
    kw: dict[str, Any] = dict(
        vocab_size=256, d_model=32, n_layers=2, n_heads=4, d_ff=64,
        max_position=128,
    )
    kw.update(over)
    return EncoderSpec(**kw)


# --------------------------------------------------------------- forward


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def encode(spec: EncoderSpec, params: EncParams, tokens: torch.Tensor,
           attn_mask: torch.Tensor,
           type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-stack bidirectional encode of ``tokens`` [B, T] (``attn_mask``
    [B, T], 1 = real token; ``type_ids`` [B, T] segment ids of a pair);
    the hidden states [B, T, D]."""
    with f32_products():
        return _encode(spec, params, tokens, attn_mask, type_ids)


def _encode(spec: EncoderSpec, params: EncParams, tokens: torch.Tensor,
            attn_mask: torch.Tensor,
            type_ids: Optional[torch.Tensor]) -> torch.Tensor:
    B, T = tokens.shape
    H, Dh = spec.n_heads, spec.d_head
    if type_ids is None:
        type_emb = params["type_emb"][0][None, None, :]
    else:
        type_emb = params["type_emb"][
            type_ids.long().clamp(0, spec.type_vocab_size - 1)]
    x = (params["word_emb"][tokens.long()]
         + params["pos_emb"][:T][None, :, :] + type_emb)
    x = _ln(x, params["emb_ln_w"], params["emb_ln_b"], spec.norm_eps)
    bias = torch.where(attn_mask[:, None, None, :].bool(), 0.0, NEG_INF)
    scale = 1.0 / math.sqrt(Dh)
    for i in range(spec.n_layers):
        def lp(k: str) -> torch.Tensor:
            return params[k][i]

        q = (x @ lp("wq") + lp("bq")).view(B, T, H, Dh).transpose(1, 2)
        k = (x @ lp("wk") + lp("bk")).view(B, T, H, Dh).transpose(1, 2)
        v = (x @ lp("wv") + lp("bv")).view(B, T, H, Dh).transpose(1, 2)
        logits = (q.float() @ k.float().transpose(-1, -2)) * scale
        probs = torch.softmax(logits + bias, dim=-1)
        ctx = (probs.to(v.dtype) @ v).float()  # [B, H, T, Dh]
        ctx = ctx.transpose(1, 2).reshape(B, T, H * Dh).to(x.dtype)
        x = _ln(x + (ctx @ lp("wo") + lp("bo")), lp("attn_ln_w"),
                lp("attn_ln_b"), spec.norm_eps)
        h = F.gelu(x @ lp("w_up") + lp("b_up"), approximate="none")
        x = _ln(x + (h @ lp("w_down") + lp("b_down")), lp("out_ln_w"),
                lp("out_ln_b"), spec.norm_eps)
    return x


def mean_pool(hidden: torch.Tensor, attn_mask: torch.Tensor,
              normalize: bool = True) -> torch.Tensor:
    """Masked mean over tokens (sentence-transformers' convention), L2
    normalised unless ``normalize`` is off."""
    m = attn_mask[..., None].float()
    emb = (hidden.float() * m).sum(1) / m.sum(1).clamp_min(1e-9)
    if normalize:
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return emb


def classify(spec: EncoderSpec, params: EncParams,
             hidden: torch.Tensor) -> torch.Tensor:
    """The cross-encoder head: tanh pool over ``[CLS]`` (when the
    checkpoint has a pooler), then the classifier -> [B, C] f32."""
    with f32_products():
        cls = hidden[:, 0, :]
        if "pool_w" in params:
            cls = torch.tanh(cls @ params["pool_w"] + params["pool_b"])
        return (cls @ params["cls_w"] + params["cls_b"]).float()


# -------------------------------------------------- HF checkpoint loading


def load_encoder_params(model_dir: str, dtype: torch.dtype = torch.float32,
                        device: Any = "cpu") -> tuple[EncoderSpec, EncParams]:
    """A BERT-named HF checkpoint (``bert.`` / ``roberta.`` / bare
    prefixes; a cross-encoder's ``pooler`` and ``classifier``) ->
    (spec, params on ``device``)."""
    from .hf_loader import load_hf_state

    config, get, names = load_hf_state(model_dir)
    spec = spec_from_hf_config(config)
    prefix = ""
    for cand in ("bert.", "roberta.", ""):
        if f"{cand}embeddings.word_embeddings.weight" in names:
            prefix = cand
            break

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype)

    def t(name: str) -> torch.Tensor:
        return get(name).t().contiguous()

    def stack(fn: Callable[[int], torch.Tensor]) -> torch.Tensor:
        return cast(torch.stack([fn(i) for i in range(spec.n_layers)]))

    e = f"{prefix}embeddings."
    lp = f"{prefix}encoder.layer." + "{i}."
    # (params key, checkpoint suffix, transposed)
    layer = (("wq", "attention.self.query.weight", True),
             ("bq", "attention.self.query.bias", False),
             ("wk", "attention.self.key.weight", True),
             ("bk", "attention.self.key.bias", False),
             ("wv", "attention.self.value.weight", True),
             ("bv", "attention.self.value.bias", False),
             ("wo", "attention.output.dense.weight", True),
             ("bo", "attention.output.dense.bias", False),
             ("attn_ln_w", "attention.output.LayerNorm.weight", False),
             ("attn_ln_b", "attention.output.LayerNorm.bias", False),
             ("w_up", "intermediate.dense.weight", True),
             ("b_up", "intermediate.dense.bias", False),
             ("w_down", "output.dense.weight", True),
             ("b_down", "output.dense.bias", False),
             ("out_ln_w", "output.LayerNorm.weight", False),
             ("out_ln_b", "output.LayerNorm.bias", False))
    p: EncParams = {
        "word_emb": cast(get(e + "word_embeddings.weight")),
        "pos_emb": cast(get(e + "position_embeddings.weight")),
        "type_emb": cast(get(e + "token_type_embeddings.weight")),
        "emb_ln_w": cast(get(e + "LayerNorm.weight")),
        "emb_ln_b": cast(get(e + "LayerNorm.bias")),
    }
    for key, suffix, transposed in layer:
        read = t if transposed else get
        p[key] = stack(lambda i, s=suffix, r=read: r(lp.format(i=i) + s))
    if "classifier.weight" in names:  # a cross-encoder checkpoint
        if f"{prefix}pooler.dense.weight" in names:
            p["pool_w"] = cast(t(f"{prefix}pooler.dense.weight"))
            p["pool_b"] = cast(get(f"{prefix}pooler.dense.bias"))
        p["cls_w"] = cast(t("classifier.weight"))
        p["cls_b"] = cast(get("classifier.bias"))
        spec = replace(spec, n_classes=p["cls_w"].shape[-1])
    return spec, p
