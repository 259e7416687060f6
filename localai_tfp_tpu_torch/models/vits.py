"""VITS text-to-speech in PyTorch: the port's counterpart of
localai_tfp_tpu/models/vits.py (HF ``VitsModel`` checkpoints: the
facebook/mms-tts-* family; piper voices load through ``models/piper.py``).

The inference graph is the JAX module's, op for op, in [B, C, T] layout so
the checkpoint's convolution weights load untransposed:

  text encoder (relative-window attention + conv FFN)
  -> stochastic duration predictor run in reverse (rational-quadratic
     spline flows, kept in f32 as the JAX code keeps them)
  -> length regulation on the host (numpy)
  -> residual-coupling flow in reverse (mean-only couplings over WaveNet)
  -> HiFi-GAN decoder (transposed-conv upsampling + dilated resblocks).

Noise comes from ``np.random.default_rng(seed)``, drawn in the JAX
module's order, so both packages see the same draws at the config's own
noise scales. The parameter tree is the JAX module's (nested dicts and
lists, the same keys); ``from_jax_params`` carries a JAX tree across.
Every entry point runs on its ``device`` (the card unless the caller asks
for the CPU), with TF32 off for its f32 convolutions and products.

No Pallas kernel: the JAX module is XLA convolutions, and so this one is
cuDNN's through ``torch.nn.functional``.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products, resolve
from .convert import params_from_numpy, to_tensor

VitsParams = dict[str, Any]


@dataclass(frozen=True, eq=False)
class VitsSpec:
    vocab_size: int
    hidden: int
    n_layers: int
    n_heads: int
    ffn_dim: int
    ffn_kernel: int = 3
    window: int = 4
    flow_size: int = 192
    spec_bins: int = 513
    # duration predictor
    dp_kernel: int = 3
    dp_layers: int = 3  # depth_separable_num_layers
    dp_flows: int = 4
    dp_bins: int = 10
    dp_tail: float = 5.0
    dds_channels: int = 2  # depth_separable_channels
    # prior flow
    flow_layers: int = 4  # prior_encoder_num_flows
    wn_layers: int = 4  # prior_encoder_num_wavenet_layers
    wn_kernel: int = 5
    wn_dilation: int = 1
    # hifigan
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernels: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial: int = 512
    resblock_kernels: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_slope: float = 0.1
    # sampling defaults (config noise_scale / noise_scale_duration /
    # speaking_rate)
    noise_scale: float = 0.667
    noise_scale_duration: float = 0.8
    speaking_rate: float = 1.0
    sampling_rate: int = 16000

    @property
    def upsample_factor(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def vits_spec_from_hf(cfg: dict[str, Any]) -> VitsSpec:
    def tup(x):
        return tuple(tuple(v) if isinstance(v, list) else v for v in x)

    return VitsSpec(
        vocab_size=int(cfg.get("vocab_size") or 38),
        hidden=int(cfg.get("hidden_size") or 192),
        n_layers=int(cfg.get("num_hidden_layers") or 6),
        n_heads=int(cfg.get("num_attention_heads") or 2),
        ffn_dim=int(cfg.get("ffn_dim") or 768),
        ffn_kernel=int(cfg.get("ffn_kernel_size") or 3),
        window=int(cfg.get("window_size") or 4),
        flow_size=int(cfg.get("flow_size") or 192),
        spec_bins=int(cfg.get("spectrogram_bins") or 513),
        dp_kernel=int(cfg.get("duration_predictor_kernel_size") or 3),
        dp_layers=int(cfg.get("depth_separable_num_layers") or 3),
        dp_flows=int(cfg.get("duration_predictor_num_flows") or 4),
        dp_bins=int(cfg.get("duration_predictor_flow_bins") or 10),
        dp_tail=float(cfg.get("duration_predictor_tail_bound") or 5.0),
        dds_channels=int(cfg.get("depth_separable_channels") or 2),
        flow_layers=int(cfg.get("prior_encoder_num_flows") or 4),
        wn_layers=int(cfg.get("prior_encoder_num_wavenet_layers") or 4),
        wn_kernel=int(cfg.get("wavenet_kernel_size") or 5),
        wn_dilation=int(cfg.get("wavenet_dilation_rate") or 1),
        upsample_rates=tuple(cfg.get("upsample_rates") or (8, 8, 2, 2)),
        upsample_kernels=tuple(
            cfg.get("upsample_kernel_sizes") or (16, 16, 4, 4)),
        upsample_initial=int(cfg.get("upsample_initial_channel") or 512),
        resblock_kernels=tuple(cfg.get("resblock_kernel_sizes") or (3, 7, 11)),
        resblock_dilations=tup(cfg.get("resblock_dilation_sizes")
                               or ((1, 3, 5),) * 3),
        leaky_slope=float(cfg.get("leaky_relu_slope") or 0.1),
        noise_scale=float(cfg.get("noise_scale", 0.667)),
        noise_scale_duration=float(cfg.get("noise_scale_duration", 0.8)),
        speaking_rate=float(cfg.get("speaking_rate", 1.0)),
        sampling_rate=int(cfg.get("sampling_rate") or 16000),
    )


# ------------------------------------------------------------------ ops


def _conv1d(x, w, b=None, pad=0, dilation=1, groups=1):
    """torch Conv1d: x [B,C,T], w [O,I/g,K], explicit symmetric padding."""
    return F.conv1d(x, w, b, padding=pad, dilation=dilation, groups=groups)


def _ln_cl(x, w, b, eps=1e-5):
    """LayerNorm over the channel dim of [B,C,T]."""
    mu = x.mean(1, keepdim=True)
    var = ((x - mu) ** 2).mean(1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w[None, :, None] \
        + b[None, :, None]


def _leaky(x, slope):
    return torch.where(x >= 0, x, x * slope)


# -------------------------------------------------------------- encoder


def _rel_shift_to_abs(x):
    """[H, T, 2T-1] relative logits -> [H, T, T] absolute."""
    h, t, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(h, t * 2 * t)
    x = F.pad(x, (0, t - 1)).reshape(h, t + 1, 2 * t - 1)
    return x[:, :t, t - 1:]


def _abs_to_rel(x):
    """[H, T, T] -> [H, T, 2T-1]."""
    h, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).reshape(h, t * (2 * t - 1))
    x = F.pad(x, (t, 0)).reshape(h, t, 2 * t)
    return x[:, :, 1:]


def _rel_embed(emb, window, t):
    """Slice/pad the [2w+1, d] table to [2t-1, d]."""
    pad = max(t - (window + 1), 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    start = max((window + 1) - t, 0)
    return emb[start:start + 2 * t - 1]


def _enc_attention(spec: VitsSpec, p, x, attn_bias):
    """Relative-window MHA on [B, T, C], one batch row at a time."""
    B, T, C = x.shape
    H = spec.n_heads
    Dh = C // H
    q = (x @ p["wq"].T + p["bq"]) * Dh ** -0.5
    k = x @ p["wk"].T + p["bk"]
    v = x @ p["wv"].T + p["bv"]
    rel_k = _rel_embed(p["emb_rel_k"][0], spec.window, T)  # [2T-1, Dh]
    rel_v = _rel_embed(p["emb_rel_v"][0], spec.window, T)
    outs = []
    for qb, kb, vb in zip(q, k, v):
        qh = qb.reshape(T, H, Dh).transpose(0, 1)  # [H, T, Dh]
        kh = kb.reshape(T, H, Dh).transpose(0, 1)
        vh = vb.reshape(T, H, Dh).transpose(0, 1)
        logits = qh @ kh.transpose(1, 2)  # [H, T, T]
        logits = logits + _rel_shift_to_abs(qh @ rel_k.T)
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, -1)
        out = probs @ vh + _abs_to_rel(probs) @ rel_v
        outs.append(out.transpose(0, 1).reshape(T, C))
    return torch.stack(outs) @ p["wo"].T + p["bo"]


def text_encoder(spec: VitsSpec, p: VitsParams, ids: torch.Tensor,
                 mask: torch.Tensor):
    """ids [B, T], mask [B, T] (1=valid) -> (hidden [B,C,T],
    prior_means [B,T,F], prior_log_var [B,T,F])."""
    x = p["embed"][ids] * math.sqrt(spec.hidden)  # [B, T, C]
    attn_bias = torch.where(mask[0][None, None, :] > 0, 0.0, -1e9)
    mb = mask[:, None, :]  # [B,1,T]
    kf = spec.ffn_kernel
    pad = ((kf - 1) // 2, kf // 2)
    for lp in p["layers"]:
        attn = _enc_attention(spec, lp, x, attn_bias)
        x = _ln_cl((x + attn).transpose(1, 2), lp["ln1_w"], lp["ln1_b"])
        h = x * mb
        h = F.pad(h, pad) if kf > 1 else h
        h = torch.relu(_conv1d(h, lp["ff1_w"], lp["ff1_b"]))
        h = h * mb
        h = F.pad(h, pad) if kf > 1 else h
        h = _conv1d(h, lp["ff2_w"], lp["ff2_b"]) * mb
        x = _ln_cl(x + h, lp["ln2_w"], lp["ln2_b"])
        x = x.transpose(1, 2)  # back to [B, T, C]
    hidden = x.transpose(1, 2)  # [B, C, T]
    stats = _conv1d(hidden, p["proj_w"], p["proj_b"]) * mb  # [B, 2F, T]
    means, log_var = torch.chunk(stats.transpose(1, 2), 2, dim=2)
    return hidden, means, log_var


# ---------------------------------------------- stochastic duration (rev)


def _dds(spec: VitsSpec, p, x, mask, cond=None):
    """VitsDilatedDepthSeparableConv (depthwise dilated + pointwise)."""
    if cond is not None:
        x = x + cond
    C = x.shape[1]
    k = spec.dp_kernel
    for i, lp in enumerate(p):
        d = k ** i
        pad = (k * d - d) // 2
        h = _conv1d(x * mask, lp["dw_w"], lp["dw_b"], pad=pad, dilation=d,
                    groups=C)
        h = F.gelu(_ln_cl(h, lp["n1_w"], lp["n1_b"]))
        h = _conv1d(h, lp["pw_w"], lp["pw_b"])
        h = F.gelu(_ln_cl(h, lp["n2_w"], lp["n2_b"]))
        x = x + h
    return x * mask


def _pinned_ends(cum, tail):
    """``cum`` with its first entry set to -tail and its last to tail."""
    cum = cum.clone()
    cum[..., 0] = -tail
    cum[..., -1] = tail
    return cum


def _rqs(inputs, uw, uh, ud, reverse, tail, bins):
    """Piecewise rational-quadratic spline (HF
    _unconstrained_rational_quadratic_spline) with the JAX module's
    where-instead-of-boolean-indexing formulation. inputs [...],
    u* [..., bins(/-1)]."""
    min_bin = 1e-3
    min_deriv = 1e-3
    inside = (inputs >= -tail) & (inputs <= tail)
    x = inputs.clamp(-tail, tail)

    const = math.log(math.exp(1 - min_deriv) - 1)
    ud = F.pad(ud, (1, 1), value=const)

    widths = torch.softmax(uw, -1)
    widths = min_bin + (1 - min_bin * bins) * widths
    cumw = F.pad(torch.cumsum(widths, -1), (1, 0))
    cumw = _pinned_ends(2 * tail * cumw - tail, tail)
    widths = cumw[..., 1:] - cumw[..., :-1]

    derivs = min_deriv + F.softplus(ud)

    heights = torch.softmax(uh, -1)
    heights = min_bin + (1 - min_bin * bins) * heights
    cumh = F.pad(torch.cumsum(heights, -1), (1, 0))
    cumh = _pinned_ends(2 * tail * cumh - tail, tail)
    heights = cumh[..., 1:] - cumh[..., :-1]

    locs = (cumh if reverse else cumw).clone()
    locs[..., -1] += 1e-6
    idx = (x[..., None] >= locs).sum(-1) - 1
    idx = idx.clamp(0, bins - 1)[..., None]

    def g(arr):
        return torch.gather(arr, -1, idx)[..., 0]

    in_cumw, in_w = g(cumw), g(widths)
    in_cumh = g(cumh)
    in_delta = g(heights / widths)
    in_d = g(derivs)
    in_d1 = g(derivs[..., 1:])
    in_h = g(heights)
    i1 = in_d + in_d1 - 2 * in_delta
    if not reverse:
        theta = (x - in_cumw) / in_w
        t1 = theta * (1 - theta)
        num = in_h * (in_delta * theta ** 2 + in_d * t1)
        den = in_delta + i1 * t1
        out = in_cumh + num / den
    else:
        i2 = x - in_cumh
        i3 = i2 * i1
        a = in_h * (in_delta - in_d) + i3
        b = in_h * in_d - i3
        c = -in_delta * i2
        disc = torch.clamp(b ** 2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(disc))
        out = root * in_w + in_cumw
    return torch.where(inside, out, inputs)


def _conv_flow_reverse(spec: VitsSpec, p, z, mask, cond):
    half = spec.dds_channels // 2
    first, second = z[:, :half], z[:, half:]
    h = _conv1d(first, p["pre_w"], p["pre_b"])
    h = _dds(spec, p["dds"], h, mask, cond)
    h = _conv1d(h, p["proj_w"], p["proj_b"]) * mask
    B, _, T = first.shape
    h = h.reshape(B, half, -1, T).permute(0, 1, 3, 2)  # [B,half,T,3b-1]
    nb = spec.dp_bins
    scale = math.sqrt(spec.hidden)
    second = _rqs(second, h[..., :nb] / scale, h[..., nb:2 * nb] / scale,
                  h[..., 2 * nb:], True, spec.dp_tail, nb)
    return torch.cat([first, second], 1) * mask


def duration_reverse(spec: VitsSpec, p: VitsParams, hidden, mask,
                     noise, cond=None):
    """Stochastic duration predictor in reverse: log durations [B,1,T].
    ``noise`` [B, 2, T] (zeros => deterministic mode)."""
    x = _conv1d(hidden, p["pre_w"], p["pre_b"])
    if cond is not None:
        x = x + _conv1d(cond, p["cond_w"], p["cond_b"])
    x = _dds(spec, p["dds"], x, mask)
    x = _conv1d(x, p["proj_w"], p["proj_b"]) * mask

    # flows = [affine, conv_flow x dp_flows]; reversed drops the last
    # conv flow before the affine ("remove a useless vflow" in HF)
    flows = [("affine", p["affine"])] + [("conv", f) for f in p["flows"]]
    rev = flows[::-1]
    rev = rev[:-2] + [rev[-1]]
    z = noise
    for kind, fp in rev:
        z = torch.flip(z, [1])
        if kind == "affine":
            z = (z - fp["translate"][None]) * torch.exp(-fp["log_scale"][None])
            z = z * mask
        else:
            z = _conv_flow_reverse(spec, fp, z, mask, x)
    return z[:, :1]


# ------------------------------------------------------- prior flow (rev)


def _wavenet(spec: VitsSpec, p, x, mask, cond=None):
    out = torch.zeros_like(x)
    C = x.shape[1]
    k = spec.wn_kernel
    gl = _conv1d(cond, p["cond_w"], p["cond_b"]) if cond is not None else None
    for i, lp in enumerate(p["layers"]):
        d = spec.wn_dilation ** i
        pad = (k * d - d) // 2
        h = _conv1d(x, lp["in_w"], lp["in_b"], pad=pad, dilation=d)
        if gl is not None:
            g = gl[:, i * 2 * C:(i + 1) * 2 * C]
        else:
            g = torch.zeros_like(h)
        ht = torch.tanh(h[:, :C] + g[:, :C]) * torch.sigmoid(
            h[:, C:] + g[:, C:])
        rs = _conv1d(ht, lp["rs_w"], lp["rs_b"])
        if i < len(p["layers"]) - 1:
            x = (x + rs[:, :C]) * mask
            out = out + rs[:, C:]
        else:
            out = out + rs
    return out * mask


def flow_reverse(spec: VitsSpec, p: VitsParams, z, mask, cond=None):
    """Residual coupling block reversed (mean-only couplings)."""
    half = spec.flow_size // 2
    for fp in reversed(p):
        z = torch.flip(z, [1])
        first, second = z[:, :half], z[:, half:]
        h = _conv1d(first, fp["pre_w"], fp["pre_b"]) * mask
        h = _wavenet(spec, fp["wn"], h, mask, cond)
        mean = _conv1d(h, fp["post_w"], fp["post_b"]) * mask
        second = (second - mean) * mask
        z = torch.cat([first, second], 1)
    return z


# ------------------------------------------------------------- hifigan


def hifigan(spec: VitsSpec, p: VitsParams, spectro, cond=None):
    """spectrogram [B, flow_size, T] -> waveform [B, T*upsample_factor]."""
    x = _conv1d(spectro, p["pre_w"], p["pre_b"], pad=3)
    if cond is not None:
        x = x + _conv1d(cond, p["cond_w"], p["cond_b"])
    nk = len(spec.resblock_kernels)
    for i, (r, k) in enumerate(zip(spec.upsample_rates,
                                   spec.upsample_kernels)):
        x = _leaky(x, spec.leaky_slope)
        up = p["ups"][i]
        x = F.conv_transpose1d(x, up["w"], up["b"], stride=r,
                               padding=(k - r) // 2)
        acc = None
        for j in range(nk):
            rb = p["resblocks"][i * nk + j]
            h = x
            kk = spec.resblock_kernels[j]
            for c1, c2, d in zip(rb["c1"], rb["c2"],
                                 spec.resblock_dilations[j]):
                t = _leaky(h, spec.leaky_slope)
                t = _conv1d(t, c1["w"], c1["b"], pad=d * (kk - 1) // 2,
                            dilation=d)
                t = _leaky(t, spec.leaky_slope)
                t = _conv1d(t, c2["w"], c2["b"], pad=(kk - 1) // 2)
                h = h + t
            acc = h if acc is None else acc + h
        x = acc / nk
    x = _leaky(x, 0.01)  # functional default slope
    x = _conv1d(x, p["post_w"], None, pad=3)
    return torch.tanh(x)[:, 0]


# ------------------------------------------------------------ synthesis


def _device_of(p: VitsParams) -> torch.device:
    return p["text_encoder"]["embed"].device


def synthesize(spec: VitsSpec, p: VitsParams, ids: np.ndarray,
               *, noise_scale: Optional[float] = None,
               noise_scale_duration: Optional[float] = None,
               speaking_rate: Optional[float] = None,
               seed: int = 0) -> np.ndarray:
    """Full VITS inference for one utterance on the params' device;
    returns waveform f32 [n] (host numpy).

    The length regulation runs on the host (numpy), as in the JAX module,
    and so do the noise draws, in its order: the duration noise
    [1, 2, T], then the prior noise [frames, F]."""
    wave, _ = synthesize_with_durations(
        spec, p, ids, noise_scale=noise_scale,
        noise_scale_duration=noise_scale_duration,
        speaking_rate=speaking_rate, seed=seed)
    return wave


def synthesize_with_durations(spec: VitsSpec, p: VitsParams,
                              ids: np.ndarray, *,
                              noise_scale: Optional[float] = None,
                              noise_scale_duration: Optional[float] = None,
                              speaking_rate: Optional[float] = None,
                              seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``synthesize`` and the per-token frame counts it regulated by."""
    ns = spec.noise_scale if noise_scale is None else noise_scale
    nsd = (spec.noise_scale_duration if noise_scale_duration is None
           else noise_scale_duration)
    rate = spec.speaking_rate if speaking_rate is None else speaking_rate
    rng = np.random.default_rng(seed)
    dev = _device_of(p)

    with torch.inference_mode(), f32_products():
        ids_t = torch.as_tensor(np.asarray(ids)[None], dtype=torch.long,
                                device=dev)
        T = ids_t.shape[1]
        mask = torch.ones((1, T), dtype=torch.float32, device=dev)
        hidden, means, log_var = text_encoder(spec, p["text_encoder"], ids_t,
                                              mask)
        dnoise = to_tensor(
            rng.standard_normal((1, 2, T)).astype(np.float32) * nsd, dev)
        log_dur = duration_reverse(spec, p["duration"], hidden,
                                   mask[:, None, :], dnoise)
        dur = np.ceil(np.exp(log_dur[0, 0].cpu().numpy()) * rate ** -1)
        dur = np.maximum(dur, 0).astype(np.int64)
        frames = int(max(dur.sum(), 1))

        # length regulation: repeat each phone's prior stats by its
        # duration
        idx = np.repeat(np.arange(T), dur)
        means_e = means[0].cpu().numpy()[idx]  # [frames, F]
        logv_e = log_var[0].cpu().numpy()[idx]
        z = means_e + rng.standard_normal(means_e.shape).astype(
            np.float32) * np.exp(logv_e) * ns
        z = to_tensor(z.T[None], dev)  # [1, F, frames]
        fmask = torch.ones((1, 1, frames), dtype=torch.float32, device=dev)
        latents = flow_reverse(spec, p["flow"], z, fmask)
        wave = hifigan(spec, p["decoder"], latents)
        return wave[0].float().cpu().numpy(), dur


# --------------------------------------------------------------- loader


def from_jax_params(tree: VitsParams, device: Any = None) -> VitsParams:
    """The JAX module's parameter tree (numpy leaves) -> the port's tree
    on ``device``: the same nesting and keys, leaf by leaf."""
    return params_from_numpy(tree, resolve(device))


def load_vits(model_dir: str, device: Any = None
              ) -> tuple[VitsSpec, VitsParams]:
    """Load an HF VitsModel checkpoint directory (config.json +
    safetensors) onto ``device``. Weight-normed convolutions
    (``parametrizations.weight.original0/1`` or ``weight_g``/``weight_v``)
    are folded into plain weights."""
    from .hf_loader import load_hf_state

    config, get, names = load_hf_state(model_dir)
    return build_vits_params(
        config, lambda n: get(n).float().numpy(), names, device)


def build_vits_params(config: dict, get, names, device: Any = None
                      ) -> tuple[VitsSpec, VitsParams]:
    """HF-name tensor view (``get`` returns numpy) -> (spec, params) on
    ``device``. Shared by the HF loader above and the piper .onnx
    importer (models/piper.py), which presents original-VITS
    initializers through an HF-name shim."""
    dev = resolve(device)
    spec = vits_spec_from_hf(config)
    nameset = set(names)

    def t(name):
        return np.asarray(get(name), np.float32)

    def wn_weight(prefix):
        # weight-norm: w = g * v / ||v|| (norm over dims 1..), in numpy
        # f32 as the JAX loader folds it
        for g_n, v_n in ((prefix + ".parametrizations.weight.original0",
                          prefix + ".parametrizations.weight.original1"),
                         (prefix + ".weight_g", prefix + ".weight_v")):
            if g_n in nameset:
                g, v = t(g_n), t(v_n)
                norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)),
                                            keepdims=True))
                return g * v / np.maximum(norm, 1e-12)
        return t(prefix + ".weight")

    def d(name):  # a tensor on the device
        return to_tensor(t(name), dev)

    def conv(prefix):
        out = {"w": d(prefix + ".weight")}
        out["b"] = d(prefix + ".bias") if prefix + ".bias" in nameset \
            else None
        return out

    p: VitsParams = {}
    enc = {"embed": d("text_encoder.embed_tokens.weight"),
           "proj_w": d("text_encoder.project.weight"),
           "proj_b": d("text_encoder.project.bias"),
           "layers": []}
    for i in range(spec.n_layers):
        lp = f"text_encoder.encoder.layers.{i}."
        enc["layers"].append({
            "wq": d(lp + "attention.q_proj.weight"),
            "bq": d(lp + "attention.q_proj.bias"),
            "wk": d(lp + "attention.k_proj.weight"),
            "bk": d(lp + "attention.k_proj.bias"),
            "wv": d(lp + "attention.v_proj.weight"),
            "bv": d(lp + "attention.v_proj.bias"),
            "wo": d(lp + "attention.out_proj.weight"),
            "bo": d(lp + "attention.out_proj.bias"),
            "emb_rel_k": d(lp + "attention.emb_rel_k"),
            "emb_rel_v": d(lp + "attention.emb_rel_v"),
            "ln1_w": d(lp + "layer_norm.weight"),
            "ln1_b": d(lp + "layer_norm.bias"),
            "ff1_w": d(lp + "feed_forward.conv_1.weight"),
            "ff1_b": d(lp + "feed_forward.conv_1.bias"),
            "ff2_w": d(lp + "feed_forward.conv_2.weight"),
            "ff2_b": d(lp + "feed_forward.conv_2.bias"),
            "ln2_w": d(lp + "final_layer_norm.weight"),
            "ln2_b": d(lp + "final_layer_norm.bias"),
        })
    p["text_encoder"] = enc

    def dds(prefix, n):
        return [{
            "dw_w": d(f"{prefix}.convs_dilated.{i}.weight"),
            "dw_b": d(f"{prefix}.convs_dilated.{i}.bias"),
            "pw_w": d(f"{prefix}.convs_pointwise.{i}.weight"),
            "pw_b": d(f"{prefix}.convs_pointwise.{i}.bias"),
            "n1_w": d(f"{prefix}.norms_1.{i}.weight"),
            "n1_b": d(f"{prefix}.norms_1.{i}.bias"),
            "n2_w": d(f"{prefix}.norms_2.{i}.weight"),
            "n2_b": d(f"{prefix}.norms_2.{i}.bias"),
        } for i in range(n)]

    dp = "duration_predictor"
    dur: VitsParams = {
        "pre_w": d(f"{dp}.conv_pre.weight"),
        "pre_b": d(f"{dp}.conv_pre.bias"),
        "proj_w": d(f"{dp}.conv_proj.weight"),
        "proj_b": d(f"{dp}.conv_proj.bias"),
        "dds": dds(f"{dp}.conv_dds", spec.dp_layers),
        "affine": {"translate": d(f"{dp}.flows.0.translate"),
                   "log_scale": d(f"{dp}.flows.0.log_scale")},
        "flows": [],
    }
    if f"{dp}.cond.weight" in nameset:
        dur["cond_w"] = d(f"{dp}.cond.weight")
        dur["cond_b"] = d(f"{dp}.cond.bias")
    for i in range(1, spec.dp_flows + 1):
        fp = f"{dp}.flows.{i}"
        dur["flows"].append({
            "pre_w": d(f"{fp}.conv_pre.weight"),
            "pre_b": d(f"{fp}.conv_pre.bias"),
            "proj_w": d(f"{fp}.conv_proj.weight"),
            "proj_b": d(f"{fp}.conv_proj.bias"),
            "dds": dds(f"{fp}.conv_dds", spec.dp_layers),
        })
    p["duration"] = dur

    def wavenet(prefix, n_layers):
        out = {"layers": []}
        if f"{prefix}.cond_layer.bias" in nameset or \
                f"{prefix}.cond_layer.parametrizations.weight.original0" \
                in nameset:
            out["cond_w"] = to_tensor(wn_weight(f"{prefix}.cond_layer"), dev)
            out["cond_b"] = d(f"{prefix}.cond_layer.bias")
        for i in range(n_layers):
            out["layers"].append({
                "in_w": to_tensor(wn_weight(f"{prefix}.in_layers.{i}"), dev),
                "in_b": d(f"{prefix}.in_layers.{i}.bias"),
                "rs_w": to_tensor(
                    wn_weight(f"{prefix}.res_skip_layers.{i}"), dev),
                "rs_b": d(f"{prefix}.res_skip_layers.{i}.bias"),
            })
        return out

    flows = []
    for i in range(spec.flow_layers):
        fp = f"flow.flows.{i}"
        flows.append({
            "pre_w": d(f"{fp}.conv_pre.weight"),
            "pre_b": d(f"{fp}.conv_pre.bias"),
            "post_w": d(f"{fp}.conv_post.weight"),
            "post_b": (d(f"{fp}.conv_post.bias")
                       if f"{fp}.conv_post.bias" in nameset else None),
            "wn": wavenet(f"{fp}.wavenet", spec.wn_layers),
        })
    p["flow"] = flows

    dec: VitsParams = {
        "pre_w": d("decoder.conv_pre.weight"),
        "pre_b": d("decoder.conv_pre.bias"),
        "post_w": d("decoder.conv_post.weight"),
        "ups": [], "resblocks": [],
    }
    if "decoder.cond.weight" in nameset:
        dec["cond_w"] = d("decoder.cond.weight")
        dec["cond_b"] = d("decoder.cond.bias")
    for i in range(len(spec.upsample_rates)):
        dec["ups"].append({"w": d(f"decoder.upsampler.{i}.weight"),
                           "b": d(f"decoder.upsampler.{i}.bias")})
    n_res = len(spec.upsample_rates) * len(spec.resblock_kernels)
    for i in range(n_res):
        rp = f"decoder.resblocks.{i}"
        n_d = len(spec.resblock_dilations[i % len(spec.resblock_kernels)])
        dec["resblocks"].append({
            "c1": [conv(f"{rp}.convs1.{j}") for j in range(n_d)],
            "c2": [conv(f"{rp}.convs2.{j}") for j in range(n_d)],
        })
    p["decoder"] = dec
    return spec, p


# ------------------------------------------------------------ tokenizer


class VitsCharTokenizer:
    """An MMS checkpoint's character tokenizer (``vocab.json`` and
    ``tokenizer_config.json``), read as transformers' ``VitsTokenizer``
    reads them, which the JAX worker loads through ``AutoTokenizer``:
    ``normalize`` lower-cases every character that does not start a
    vocabulary entry and then drops the characters outside the
    vocabulary; ``add_blank`` intersperses id 0's token; the special
    tokens (pad, unk) are split out whole and never interspersed."""

    def __init__(self, model_dir: str) -> None:
        with open(os.path.join(model_dir, "vocab.json"),
                  encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        cfg: dict = {}
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        self.add_blank = bool(cfg.get("add_blank", True))
        self.normalize = bool(cfg.get("normalize", True))
        self.phonemize = bool(cfg.get("phonemize", True))
        self.language = cfg.get("language")
        self.unk_token = _token_text(cfg.get("unk_token", "<unk>"))
        # the special tokens, as transformers registers them: the saved
        # table, else unk then pad at their vocabulary ids or after it
        self.added: dict[str, int] = {}
        table = cfg.get("added_tokens_decoder") or {}
        for tid, tok in table.items():
            self.added[_token_text(tok)] = int(tid)
        if not table:
            for tok in (self.unk_token,
                        _token_text(cfg.get("pad_token", "<pad>"))):
                if tok not in self.added:
                    self.added[tok] = self.encoder.get(
                        tok, len(self.encoder) + len(
                            [t for t in self.added
                             if t not in self.encoder]))

    def _normalize_text(self, text: str) -> str:
        words = list(self.encoder) + list(self.added)
        out = ""
        i = 0
        while i < len(text):
            for word in words:
                if text[i:i + len(word)] == word:
                    out += word
                    i += len(word)
                    break
            else:
                out += text[i].lower()
                i += 1
        return out

    def _split_added(self, text: str) -> list[str]:
        """Leftmost-longest split on the special tokens."""
        out, start, i = [], 0, 0
        while i < len(text):
            hit = max((t for t in self.added if text.startswith(t, i)),
                      key=len, default=None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append(text[start:i])
            out.append(hit)
            i += len(hit)
            start = i
        if start < len(text):
            out.append(text[start:])
        return out

    def encode(self, text: str) -> list[int]:
        if self.normalize:
            text = self._normalize_text(text)
        if self.language == "ron":
            text = text.replace("ț", "ţ")
        if self.phonemize:
            raise NotImplementedError(
                "this VITS tokenizer phonemizes its input (phonemize: "
                "true), which needs espeak through the phonemizer package")
        if self.normalize:
            text = "".join(c for c in text if c in self.encoder).strip()
        blank = self.decoder.get(0)
        unk = self.encoder.get(self.unk_token)
        ids: list[int] = []
        for piece in self._split_added(text):
            if piece in self.added:
                ids.append(self.added[piece])
                continue
            chars = list(piece)
            if self.add_blank:
                spaced = [blank] * (len(chars) * 2 + 1)
                spaced[1::2] = chars
                chars = spaced
            ids += [self.added[c] if c in self.added
                    else self.encoder.get(c, unk) for c in chars]
        return ids


def _token_text(tok: Any) -> str:
    return tok.get("content", "") if isinstance(tok, dict) else str(tok)


def load_vits_tokenizer(model_dir: str) -> Optional[VitsCharTokenizer]:
    """The directory's character tokenizer, or None where it has no
    ``vocab.json`` (the JAX worker's byte fallback then applies)."""
    if not os.path.exists(os.path.join(model_dir, "vocab.json")):
        return None
    return VitsCharTokenizer(model_dir)
