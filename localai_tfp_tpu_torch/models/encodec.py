"""The EnCodec (SEANet) decoder in PyTorch: the decoder half of
localai_tfp_tpu/models/bark.py (its ``load_encodec_decoder``,
``_causal_conv1d``, ``_causal_convtr1d``, ``_lstm_stack`` and
``encodec_decode``), which bark (``models/bark.py``) and OuteTTS-class
models decode their audio codes with.

The decoder reads an HF ``EncodecModel`` state dict: the quantizer's
codebooks, then ``decoder.layers.*`` in order (a stem conv, an LSTM stack,
transposed-conv upsamplers each followed by residual blocks, a head
conv), weight-normed convolutions folded at load as the JAX loader folds
them. The tree is the JAX module's (``{"codebooks", "layers": [(kind,
params, pre_elu)]}``, conv weights in torch layout, LSTM weights
pre-transposed with summed biases), so ``from_jax_params`` is a per-leaf
copy. The convolutions run in [B, C, T] (the JAX module works in [B, T,
C]), with EnCodec's causal reflect padding and HF's zero extension of an
input shorter than the pad. Everything runs on the tree's device in f32,
TF32 off.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products, resolve
from .convert import params_from_numpy, to_tensor


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _wn_weight(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """weight-norm reconstruction: w = g * v / ||v|| (norm over all dims
    but the first)."""
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _convtr_indices(layers: dict) -> set:
    """Transposed convs are the in-between upsampling layers: everything
    that is a bare conv except the first (stem) and last (head)."""
    bare = sorted(i for i, d in layers.items()
                  if not any(k.startswith(("lstm.", "block.")) for k in d))
    return set(bare[1:-1])


def load_encodec_decoder(sd: dict, prefix: str = "codec_model.",
                         device: Any = None) -> dict:
    """{quantizer codebooks, ordered decoder layer list} on ``device`` from
    an HF EncodecModel state dict (numpy or torch values)."""
    dev = resolve(device)
    books = []
    i = 0
    while f"{prefix}quantizer.layers.{i}.codebook.embed" in sd:
        books.append(_np(sd[f"{prefix}quantizer.layers.{i}.codebook.embed"]))
        i += 1
    layers: dict[int, dict] = {}
    for key in sd:
        if not key.startswith(f"{prefix}decoder.layers."):
            continue
        rest = key[len(f"{prefix}decoder.layers."):]
        idx = int(rest.split(".")[0])
        layers.setdefault(idx, {})[rest.split(".", 1)[1]] = _np(sd[key])

    def conv_params(d: dict, sub: str = "conv") -> dict:
        w = _wn_weight(d[f"{sub}.parametrizations.weight.original0"],
                       d[f"{sub}.parametrizations.weight.original1"])
        out = {"w": to_tensor(w, dev)}
        if f"{sub}.bias" in d:
            out["b"] = to_tensor(d[f"{sub}.bias"], dev)
        return out

    convtr = _convtr_indices(layers)
    ordered = []
    prev_idx = -1
    for idx in sorted(layers):
        d = layers[idx]
        # gaps in the module list are nn.ELU() activations: a
        # pre-activation of the following layer
        pre_elu = idx - prev_idx > 1
        prev_idx = idx
        if any(k.startswith("lstm.") for k in d):
            n_l = len([k for k in d if k.startswith("lstm.weight_ih_l")])
            ordered.append(("lstm", [{
                "w_ih": to_tensor(d[f"lstm.weight_ih_l{li}"].T, dev),
                "w_hh": to_tensor(d[f"lstm.weight_hh_l{li}"].T, dev),
                "b": to_tensor(d[f"lstm.bias_ih_l{li}"]
                               + d[f"lstm.bias_hh_l{li}"], dev),
            } for li in range(n_l)], pre_elu))
        elif any(k.startswith("block.") for k in d):
            blk = {k: v for k, v in d.items() if k.startswith("block.")}
            subs = sorted({int(k.split(".")[1]) for k in blk})
            convs = [conv_params(
                {kk.split(".", 2)[2]: vv for kk, vv in blk.items()
                 if int(kk.split(".")[1]) == s}) for s in subs]
            short = (conv_params(
                {kk.split(".", 1)[1]: vv for kk, vv in d.items()
                 if kk.startswith("shortcut.")})
                if any(k.startswith("shortcut.") for k in d) else None)
            ordered.append(("resnet", {"convs": convs, "short": short},
                            pre_elu))
        else:
            ordered.append(("convtr" if idx in convtr else "conv",
                            conv_params(d), pre_elu))
    return {"codebooks": to_tensor(np.stack(books), dev), "layers": ordered}


def from_jax_params(dec: dict, device: Any = None) -> dict:
    """The JAX module's decoder tree (numpy leaves) -> the port's on
    ``device``: the same nesting, leaf by leaf."""
    return params_from_numpy(dec, resolve(device))


def _causal_conv1d(p: dict, x: torch.Tensor, stride: int = 1,
                   dilation: int = 1) -> torch.Tensor:
    """x [B, C, T]; torch conv weight [out, in, k]; causal left pad in
    EnCodec's reflect mode (with HF's zero-extension quirk for inputs
    shorter than the pad)."""
    w = p["w"]
    k = w.shape[-1]
    pad = (k - 1) * dilation + 1 - stride
    # extra right padding so every input frame is covered (HF
    # _get_extra_padding_for_conv1d)
    T = x.shape[-1]
    n_frames = (T - k * dilation + dilation - 1 + pad) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + k * dilation - \
        (dilation - 1) - pad
    extra = max(int(ideal) - T, 0)
    if pad or extra:
        ext = 0
        if T <= max(pad, extra):  # reflect needs length > pad
            ext = max(pad, extra) - T + 1
            x = F.pad(x, (0, ext))
        x = F.pad(x, (pad, extra), mode="reflect")
        if ext:
            x = x[..., : x.shape[-1] - ext]
    return F.conv1d(x, w, p.get("b"), stride=stride, dilation=dilation)


def _causal_convtr1d(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch ConvTranspose1d weight [in, out, k]; causal: trim the whole
    (k - stride) padding from the right (trim_right_ratio=1)."""
    k = p["w"].shape[-1]
    out = F.conv_transpose1d(x, p["w"], p.get("b"), stride=stride)
    trim = k - stride
    return out[..., : out.shape[-1] - trim] if trim else out


def _lstm_stack(layers: list, x: torch.Tensor) -> torch.Tensor:
    """torch multi-layer LSTM over time + residual (EncodecLSTM); x
    [B, C, T]."""
    h_in = x
    seq = x.transpose(1, 2).contiguous()  # [B, T, C]
    weights = []
    for lp in layers:
        weights += [lp["w_ih"].T.contiguous(), lp["w_hh"].T.contiguous(),
                    lp["b"], torch.zeros_like(lp["b"])]
    H = layers[0]["w_hh"].shape[0]
    h0 = seq.new_zeros(len(layers), seq.shape[0], H)
    out, _, _ = torch.lstm(seq, (h0, h0), weights, True, len(layers), 0.0,
                           False, False, True)
    return out.transpose(1, 2) + h_in


def encodec_decode(dec: dict, codes, ratios: list[int]) -> np.ndarray:
    """codes [nq, T] int -> waveform [samples] f32 in [-1, 1] (host)."""
    books = dec["codebooks"]  # [nq, K, dim]
    dev = books.device
    with torch.inference_mode(), f32_products():
        codes = torch.as_tensor(np.asarray(codes), dtype=torch.long,
                                device=dev)
        x = books.new_zeros((1, books.shape[-1], codes.shape[1]))
        for q in range(codes.shape[0]):
            x = x + books[q][codes[q]].T[None]
        ri = iter(ratios)
        for kind, lp, pre_elu in dec["layers"]:
            if pre_elu:
                x = F.elu(x)
            if kind == "conv":
                x = _causal_conv1d(lp, x)
            elif kind == "convtr":
                x = _causal_convtr1d(lp, x, next(ri))
            elif kind == "resnet":
                h = x
                for cp in lp["convs"]:
                    h = _causal_conv1d(cp, F.elu(h))
                x = h + (_causal_conv1d(lp["short"], x)
                         if lp["short"] is not None else x)
            else:  # lstm
                x = _lstm_stack(lp, x)
        return torch.clamp(x[0, 0], -1.0, 1.0).cpu().numpy()
