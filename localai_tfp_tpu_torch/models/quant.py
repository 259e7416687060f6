"""Weight-only int8 quantization for serving (counterpart of
localai_tfp_tpu/models/quant.py; ``quantization: int8`` / ``int8_full`` in
a model config).

Per-output-channel symmetric int8 with an f32 scale: the projection
stacks live on the device at half their bf16 bytes, and every eligible
product goes through the hand-written kernel (ops/int8_matmul.py), which
reads the int8 weight once and upcasts it on the fly. Activations, norms
and (unless ``int8_full``) the embedding and LM head stay high precision.

Two switches of the JAX module are not ported. ``LOCALAI_INT8_KERNEL``
keeps the JAX package's Pallas kernel off by default because of its
per-grid-step overhead inside the TPU's decode scan; the port has no
scan, so ``mm`` takes the kernel for every eligible shape. The
meshed-serving switch guards a GSPMD limit; the port has no mesh yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.int8_matmul import eligible, int8_matmul


class QTensor(NamedTuple):
    """int8 weight + per-output-channel scale. Indexing a NamedTuple with
    an int returns a field, so per-layer slicing goes through ``layer``,
    which slices both planes together."""

    q: torch.Tensor  # int8 [..., in, out]
    scale: torch.Tensor  # f32 [..., out]

    def layer(self, i: int) -> "QTensor":
        return QTensor(self.q[i], self.scale[i])


# stacked projection leaves worth quantizing (the decode bandwidth hogs)
QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Symmetric per-output-channel int8: the scale reduces over the INPUT
    dim (axis -2), so dequantization is one multiply on the product."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / 127.0 + 1e-12  # [..., out]
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale)


def quantize_embed(w: torch.Tensor) -> QTensor:
    """Embedding-table int8 with PER-ROW scales [V]: the gather
    dequantizes the touched rows; used tied as the LM head, the scale
    applies per output logit."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1) / 127.0 + 1e-12  # [V]
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale)


def quantize_raw_tensor(w_raw: torch.Tensor) -> QTensor:
    """Quantize a checkpoint-layout weight ``[..., out, in]`` and
    transpose the int8 result into the serving layout ``[..., in, out]``:
    the same values as ``quantize_tensor`` on the transposed weight, with
    the transpose moving 1-byte codes."""
    wf = w_raw.float()
    scale = wf.abs().amax(dim=-1) / 127.0 + 1e-12  # [..., out]
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127)
    return QTensor(q=q.to(torch.int8).transpose(-1, -2).contiguous(),
                   scale=scale)


def quantize_params(params: dict[str, Any],
                    embeddings: bool = False) -> dict[str, Any]:
    """Quantize the projection stacks in place of their full-precision
    leaves; ``embeddings=True`` (``int8_full``) also quantizes embed and
    an untied lm_head. Everything else passes through."""
    out = dict(params)
    for name in QUANTIZABLE:
        if name in out and not isinstance(out[name], QTensor):
            out[name] = quantize_tensor(out[name])
    if embeddings:
        if not isinstance(out.get("embed"), QTensor):
            out["embed"] = quantize_embed(out["embed"])
        if "lm_head" in out and not isinstance(out["lm_head"], QTensor):
            out["lm_head"] = quantize_tensor(out["lm_head"])
    return out


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain tensor or a QTensor. A QTensor of eligible shape
    goes through the int8 kernel (its plain version on the CPU); other
    shapes take the upcast product, as the JAX package's XLA path does."""
    if not isinstance(w, QTensor):
        return x @ w
    lead = x.shape[:-1]
    m = x.numel() // x.shape[-1]
    if eligible(m, w.q.shape):
        y = int8_matmul(x.reshape(m, x.shape[-1]).contiguous(), w.q,
                        w.scale, out_dtype=x.dtype)
        return y.reshape(*lead, w.q.shape[-1])
    return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)


def dequantize(w: Any) -> torch.Tensor:
    if isinstance(w, QTensor):
        return w.q.float() * w.scale[..., None, :]
    return w


def leaves(v: Any) -> tuple[torch.Tensor, ...]:
    """The tensors of one parameter leaf (both planes of a QTensor)."""
    return tuple(v) if isinstance(v, QTensor) else (v,)
