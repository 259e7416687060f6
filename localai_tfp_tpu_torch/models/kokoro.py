"""Kokoro (StyleTTS2-derived) TTS in PyTorch: the port's counterpart of
localai_tfp_tpu/models/kokoro.py (Kokoro v0.19 / Kokoro-82M layout).

    tokens -> PLBERT (ALBERT encoder) -> bert_encoder linear
           -> DurationEncoder (+ style)   -> per-token durations
           -> alignment expansion         -> prosody F0/N curves
    tokens -> TextEncoder (convs + biLSTM) -> aligned ASR features
    (asr, F0, N, style) -> Decoder (AdaIN residual stacks)
                        -> iSTFTNet Generator (harmonic source + snake
                           resblocks + inverse STFT head)

Parameters keep their torch state-dict names (weight-norm folded at
import), as in the JAX module, so ``from_jax_params`` is a per-leaf copy.
The LSTMs are ``torch.lstm`` (gate order i, f, g, o: the checkpoint's);
the STFT and inverse STFT are the JAX module's own framing (reflect pad,
Hann window, overlap-add normalized by the summed squared window) over
``torch.fft``; the harmonic source's phase is integrated in the order
XLA's CPU backend adds ``jnp.cumsum`` in, so both packages add alike on
any device. The STFT's first and last frames are palindromes, so their
bins are real and a negative one's phase is +pi or -pi by the sign of a
rounding-level imaginary part, which differs between FFT libraries: the
port reads every such angle as +pi (``PI_FOLD``).

The JAX module pins Kokoro to the host CPU; the port runs it on its
``device`` (the card unless the caller asks for the CPU), in f32 with TF32
off. The source noise is ``synthesize_kokoro``'s ``source_noise`` when
given (the tests inject the JAX run's sample), else drawn from a
``torch.Generator`` seeded with ``seed`` (``jax.random`` has no torch
counterpart).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products, resolve
from .convert import params_from_numpy, to_tensor

LRELU_GEN = 0.1  # generator leaky-relu slope (hifigan convention)
LRELU = 0.2  # everywhere else in StyleTTS2


@dataclass(frozen=True)
class KokoroSpec:
    n_token: int = 178
    hidden_dim: int = 512
    style_dim: int = 128
    max_dur: int = 50
    n_layer: int = 3  # text-encoder conv depth AND duration-encoder depth
    text_encoder_kernel_size: int = 5
    # plbert (ALBERT) dims
    plbert_vocab: int = 178
    plbert_hidden: int = 768
    plbert_embedding: int = 128
    plbert_heads: int = 12
    plbert_layers: int = 12
    plbert_intermediate: int = 2048
    plbert_max_position: int = 512
    # istftnet generator
    upsample_rates: tuple = (10, 6)
    upsample_kernel_sizes: tuple = (20, 12)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    gen_istft_n_fft: int = 20
    gen_istft_hop_size: int = 5
    decoder_hidden: int = 1024  # AdainResBlk width inside the decoder
    asr_res_dim: int = 64
    sampling_rate: int = 24000
    harmonic_num: int = 8
    sine_amp: float = 0.1
    noise_std: float = 0.003
    voiced_threshold: float = 10.0

    @property
    def total_upsample(self) -> int:
        r = self.gen_istft_hop_size
        for u in self.upsample_rates:
            r *= u
        return r


def spec_from_config(cfg: dict) -> KokoroSpec:
    """Map a Kokoro-82M-style config.json onto KokoroSpec."""
    ist = cfg.get("istftnet") or cfg.get("decoder") or {}
    pl = cfg.get("plbert") or {}
    kw = dict(
        n_token=cfg.get("n_token", 178),
        hidden_dim=cfg.get("hidden_dim", 512),
        style_dim=cfg.get("style_dim", 128),
        max_dur=cfg.get("max_dur", 50),
        n_layer=cfg.get("n_layer", 3),
        text_encoder_kernel_size=cfg.get("text_encoder_kernel_size", 5),
        plbert_vocab=pl.get("vocab_size", cfg.get("n_token", 178)),
        plbert_hidden=pl.get("hidden_size", 768),
        plbert_embedding=pl.get("embedding_size", 128),
        plbert_heads=pl.get("num_attention_heads", 12),
        plbert_layers=pl.get("num_hidden_layers", 12),
        plbert_intermediate=pl.get("intermediate_size", 2048),
        plbert_max_position=pl.get("max_position_embeddings", 512),
    )
    for k in ("upsample_rates", "upsample_kernel_sizes",
              "upsample_initial_channel", "resblock_kernel_sizes",
              "gen_istft_n_fft", "gen_istft_hop_size"):
        if k in ist:
            v = ist[k]
            kw[k] = tuple(v) if isinstance(v, list) else v
    if "resblock_dilation_sizes" in ist:
        kw["resblock_dilation_sizes"] = tuple(
            tuple(d) for d in ist["resblock_dilation_sizes"])
    for k in ("sampling_rate", "decoder_hidden", "asr_res_dim"):
        if k in cfg:
            kw[k] = cfg[k]
    return KokoroSpec(**kw)


# ---------------------------------------------------------------------------
# primitives (B=1, float32)
# ---------------------------------------------------------------------------


def _lin(p, prefix, x):
    """nn.Linear: weight [out, in]."""
    y = x @ p[f"{prefix}.weight"].T
    b = p.get(f"{prefix}.bias")
    return y if b is None else y + b


def _layer_norm(x, w, b, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, unbiased=False, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * w + b


def _conv1d(p, prefix, x, *, stride=1, padding=0, dilation=1, groups=1):
    """nn.Conv1d on [B, C, T]; weight [out, in/groups, k]."""
    return F.conv1d(x, p[f"{prefix}.weight"], p.get(f"{prefix}.bias"),
                    stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def _conv_transpose1d(p, prefix, x, *, stride, padding=0, output_padding=0,
                      groups=1):
    """nn.ConvTranspose1d on [B, C, T]; weight [in, out/groups, k]."""
    return F.conv_transpose1d(x, p[f"{prefix}.weight"],
                              p.get(f"{prefix}.bias"), stride=stride,
                              padding=padding, output_padding=output_padding,
                              groups=groups)


def _bilstm(p, prefix, x):
    """Bidirectional single-layer LSTM, batch_first, x [1, T, in]."""
    weights = [p[f"{prefix}.{n}{s}"] for s in ("_l0", "_l0_reverse")
               for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    h0 = x.new_zeros(2, x.shape[0], weights[1].shape[1])
    out, _, _ = torch.lstm(x.contiguous(), (h0, h0), weights, True, 1, 0.0,
                           False, True, True)
    return out


def _instance_norm(x, eps=1e-5):
    """nn.InstanceNorm1d(affine=False) over T per (B, C)."""
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, unbiased=False, keepdim=True)
    return (x - m) / torch.sqrt(v + eps)


def _adain(p, prefix, x, s):
    """AdaIN1d: instance-norm modulated by style: fc -> (gamma, beta)."""
    h = _lin(p, f"{prefix}.fc", s)  # [B, 2C]
    gamma, beta = torch.chunk(h[:, :, None], 2, dim=1)
    return (1 + gamma) * _instance_norm(x) + beta


def _ada_layer_norm(p, prefix, x, s):
    """AdaLayerNorm on [B, T, C]."""
    h = _lin(p, f"{prefix}.fc", s)  # [B, 2C]
    gamma, beta = torch.chunk(h[:, None, :], 2, dim=-1)
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, unbiased=False, keepdim=True)
    return (1 + gamma) * ((x - m) / torch.sqrt(v + 1e-5)) + beta


def _interp_linear(x, out_len):
    """F.interpolate(mode='linear', align_corners=False) on [B, C, T]."""
    t_in = x.shape[-1]
    pos = (torch.arange(out_len, dtype=torch.float32, device=x.device)
           + 0.5) * (t_in / out_len) - 0.5
    pos = pos.clamp(0.0, t_in - 1.0)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=t_in - 1)
    frac = pos - lo
    return x[..., lo] * (1 - frac) + x[..., hi] * frac


_SCAN_BLOCK = 16


def _scan_add(x):
    """Inclusive prefix sum over the last axis in the order XLA's CPU
    backend adds for ``jnp.cumsum`` (a reduce-window it rewrites into
    blocks of 16: a running sum inside each block, the block totals
    scanned the same way, each block then offset by the totals before
    it): the same f32 additions on any device."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK)
    inner = _scan_add(blocks)
    outer = _scan_add(inner[..., -1])
    before = F.pad(outer[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(
        *x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


# ---------------------------------------------------------------------------
# PLBERT (ALBERT encoder, transformers layout)
# ---------------------------------------------------------------------------


def _albert(spec: KokoroSpec, p, tokens):
    """AlbertModel.last_hidden_state for tokens [1, T] (full attention)."""
    T = tokens.shape[1]
    pre = "bert.embeddings"
    x = (p[f"{pre}.word_embeddings.weight"][tokens[0]]
         + p[f"{pre}.position_embeddings.weight"][:T]
         + p[f"{pre}.token_type_embeddings.weight"][0])
    x = _layer_norm(x, p[f"{pre}.LayerNorm.weight"],
                    p[f"{pre}.LayerNorm.bias"], eps=1e-12)[None]
    x = _lin(p, "bert.encoder.embedding_hidden_mapping_in", x)
    lp = "bert.encoder.albert_layer_groups.0.albert_layers.0"
    H, D = spec.plbert_heads, spec.plbert_hidden
    dh = D // H
    for _ in range(spec.plbert_layers):  # ALBERT shares one layer's params
        q = _lin(p, f"{lp}.attention.query", x).reshape(1, T, H, dh)
        k = _lin(p, f"{lp}.attention.key", x).reshape(1, T, H, dh)
        v = _lin(p, f"{lp}.attention.value", x).reshape(1, T, H, dh)
        a = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
        a = torch.softmax(a, -1)
        ctx = torch.einsum("bhts,bshd->bthd", a, v).reshape(1, T, D)
        attn = _lin(p, f"{lp}.attention.dense", ctx)
        x = _layer_norm(x + attn, p[f"{lp}.attention.LayerNorm.weight"],
                        p[f"{lp}.attention.LayerNorm.bias"], eps=1e-12)
        h = F.gelu(_lin(p, f"{lp}.ffn", x), approximate="tanh")
        h = _lin(p, f"{lp}.ffn_output", h)
        x = _layer_norm(x + h, p[f"{lp}.full_layer_layer_norm.weight"],
                        p[f"{lp}.full_layer_layer_norm.bias"], eps=1e-12)
    return x  # [1, T, hidden]


# ---------------------------------------------------------------------------
# TextEncoder / DurationEncoder / ProsodyPredictor
# ---------------------------------------------------------------------------


def _text_encoder(spec: KokoroSpec, p, tokens):
    """tokens [1, T] -> [1, hidden_dim, T]."""
    x = p["text_encoder.embedding.weight"][tokens[0]][None]  # [1, T, C]
    x = x.transpose(1, 2)  # [1, C, T]
    ks = spec.text_encoder_kernel_size
    for i in range(spec.n_layer):
        x = _conv1d(p, f"text_encoder.cnn.{i}.0", x, padding=ks // 2)
        x = _layer_norm(x.transpose(1, 2), p[f"text_encoder.cnn.{i}.1.gamma"],
                        p[f"text_encoder.cnn.{i}.1.beta"]).transpose(1, 2)
        x = torch.where(x >= 0, x, LRELU * x)
    x = _bilstm(p, "text_encoder.lstm", x.transpose(1, 2))
    return x.transpose(1, 2)  # [1, C, T]


def _duration_encoder(spec: KokoroSpec, p, d_en, s):
    """d_en [1, D, T], style s [1, sty] -> [1, T, D+sty] (the StyleTTS2
    DurationEncoder: [LSTM, AdaLayerNorm] * n_layer, the style
    re-concatenated after every AdaLayerNorm)."""
    T = d_en.shape[-1]
    sty = s[:, :, None].expand(1, s.shape[1], T)
    x = torch.cat([d_en, sty], 1)  # [1, D+sty, T]
    for i in range(spec.n_layer):
        x = _bilstm(p, f"predictor.text_encoder.lstms.{2 * i}",
                    x.transpose(1, 2))  # [1, T, D]
        x = _ada_layer_norm(p, f"predictor.text_encoder.lstms.{2 * i + 1}",
                            x, s)
        x = torch.cat([x.transpose(1, 2), sty], 1)
    return x.transpose(1, 2)  # [1, T, D+sty]


def _adain_resblk1d(p, prefix, x, s, *, upsample=False, learned_sc=False):
    """StyleTTS2 AdainResBlk1d: two AdaIN+lrelu+conv stages with a
    (possibly upsampled / 1x1-projected) shortcut, / sqrt(2)."""
    sc = torch.repeat_interleave(x, 2, dim=-1) if upsample else x
    if learned_sc:
        sc = _conv1d(p, f"{prefix}.conv1x1", sc)
    h = _adain(p, f"{prefix}.norm1", x, s)
    h = torch.where(h >= 0, h, LRELU * h)
    if upsample:  # grouped stride-2 transposed conv "pool"
        h = _conv_transpose1d(p, f"{prefix}.pool", h, stride=2, padding=1,
                              output_padding=1, groups=h.shape[1])
    h = _conv1d(p, f"{prefix}.conv1", h, padding=1)
    h = _adain(p, f"{prefix}.norm2", h, s)
    h = torch.where(h >= 0, h, LRELU * h)
    h = _conv1d(p, f"{prefix}.conv2", h, padding=1)
    return (h + sc) / math.sqrt(2)


def _prosody_f0n(spec: KokoroSpec, p, en, s):
    """en [1, D+sty, frames] -> (F0 [1, 2*frames], N [1, 2*frames])."""
    x = _bilstm(p, "predictor.shared", en.transpose(1, 2)).transpose(1, 2)

    def branch(name):
        h = _adain_resblk1d(p, f"predictor.{name}.0", x, s)
        h = _adain_resblk1d(p, f"predictor.{name}.1", h, s, upsample=True,
                            learned_sc=True)
        h = _adain_resblk1d(p, f"predictor.{name}.2", h, s)
        return _conv1d(p, f"predictor.{name}_proj", h)[:, 0]  # [1, 2f]

    return branch("F0"), branch("N")


# ---------------------------------------------------------------------------
# iSTFTNet decoder
# ---------------------------------------------------------------------------


def _hann(n, device):
    return 0.5 - 0.5 * torch.cos(
        2 * math.pi * torch.arange(n, dtype=torch.float32, device=device) / n)


def _frame_index(n_frames, n_fft, hop, device):
    return (torch.arange(n_frames, device=device)[:, None] * hop
            + torch.arange(n_fft, device=device)[None])


PI_FOLD = 1e-4  # radians: a phase this close to -pi is read as +pi


def _stft_mag_phase(spec: KokoroSpec, x):
    """torch.stft(center=True, hann) magnitude+phase of x [1, t]. A phase
    within ``PI_FOLD`` of -pi is +pi: the first and last frames are
    palindromes (the reflect padding), so their bins are real and a
    negative bin's angle is +-pi by the sign of an imaginary part that is
    zero up to the FFT's rounding; folded, it is the same on any device
    and FFT library (the JAX module keeps pocketfft's sign)."""
    n_fft, hop = spec.gen_istft_n_fft, spec.gen_istft_hop_size
    pad = n_fft // 2
    xp = F.pad(x, (pad, pad), mode="reflect")
    n_frames = (xp.shape[1] - n_fft) // hop + 1
    idx = _frame_index(n_frames, n_fft, hop, x.device)
    frames = xp[0][idx] * _hann(n_fft, x.device)[None]  # [F, n_fft]
    sp = torch.fft.rfft(frames, dim=-1)  # [F, n_fft/2+1]
    phase = torch.angle(sp)
    phase = torch.where(phase < -math.pi + PI_FOLD, phase + 2 * math.pi,
                        phase)
    return sp.abs().T[None], phase.T[None]  # [1, bins, F]


def _istft(spec: KokoroSpec, mag, phase):
    """torch.istft(mag * exp(i*phase), center=True, hann) -> [1, t]."""
    n_fft, hop = spec.gen_istft_n_fft, spec.gen_istft_hop_size
    sp = mag * torch.exp(1j * phase)  # [1, bins, F]
    frames = torch.fft.irfft(sp[0].T, n=n_fft, dim=-1)  # [F, n_fft]
    win = _hann(n_fft, mag.device)
    frames = frames * win[None]
    n = frames.shape[0]
    t_len = n_fft + hop * (n - 1)
    idx = _frame_index(n, n_fft, hop, mag.device).reshape(-1)
    sig = frames.new_zeros(t_len).index_add_(0, idx, frames.reshape(-1))
    norm = frames.new_zeros(t_len).index_add_(0, idx, (win * win).repeat(n))
    sig = sig / torch.clamp(norm, min=1e-11)
    pad = n_fft // 2
    return sig[None, pad:t_len - pad]


def _sine_source(spec: KokoroSpec, f0_up, seed: int, noise=None):
    """SineGen + SourceModuleHnNSF harmonic source. f0_up [1, t, 1]
    (already upsampled); returns sine_waves [1, t, h]. ``noise``
    overrides the dithering noise (parity tests inject a shared
    sample)."""
    h = spec.harmonic_num + 1
    scale = spec.total_upsample
    f0h = f0_up * torch.arange(1, h + 1, dtype=torch.float32,
                               device=f0_up.device)[None, None, :]
    rad = (f0h / spec.sampling_rate) % 1.0  # [1, t, h]
    # the SineGen upsample trick: integrate at frame rate, then linearly
    # re-upsample the phase (keeps harmonics coherent across frames)
    t_up = rad.shape[1]
    rad_f = _interp_linear(rad.transpose(1, 2), t_up // scale)
    phase = _scan_add(rad_f) * 2 * math.pi
    phase = _interp_linear(phase * scale, t_up)
    sines = torch.sin(phase.transpose(1, 2))  # [1, t, h]
    uv = (f0_up > spec.voiced_threshold).float()  # [1, t, 1]
    amp = spec.sine_amp
    # voiced rows dither at noise_std, unvoiced rows carry amp/3 noise
    # instead of the sine
    if noise is None:
        g = torch.Generator(device=f0_up.device).manual_seed(int(seed))
        noise = torch.randn(sines.shape, generator=g, device=f0_up.device)
    noise = (uv * spec.noise_std + (1 - uv) * (amp / 3.0)) * noise
    return amp * sines * uv + noise


def _adain_resblock1(spec: KokoroSpec, p, prefix, x, s, *, kernel,
                     dilations):
    """AdaINResBlock1 (hifigan resblock1 + AdaIN + snake activation)."""
    for j, d in enumerate(dilations):
        a1 = p[f"{prefix}.alpha1.{j}"]
        a2 = p[f"{prefix}.alpha2.{j}"]
        h = _adain(p, f"{prefix}.adain1.{j}", x, s)
        h = h + (1.0 / a1) * torch.sin(a1 * h) ** 2  # snake
        h = _conv1d(p, f"{prefix}.convs1.{j}", h, dilation=d,
                    padding=(kernel * d - d) // 2)
        h = _adain(p, f"{prefix}.adain2.{j}", h, s)
        h = h + (1.0 / a2) * torch.sin(a2 * h) ** 2
        h = _conv1d(p, f"{prefix}.convs2.{j}", h, padding=kernel // 2)
        x = x + h
    return x


def _generator(spec: KokoroSpec, p, x, s, f0, seed, noise=None):
    """istftnet Generator: x [1, C0, frames], f0 [1, frames] -> [1, t]."""
    g = "decoder.generator"
    # harmonic source; f0_upsamp is nn.Upsample(scale) = nearest = repeat
    f0_up = torch.repeat_interleave(f0[:, None, :], spec.total_upsample,
                                    dim=-1).transpose(1, 2)  # [1, t, 1]
    sine_waves = _sine_source(spec, f0_up, seed, noise)
    har = torch.tanh(_lin(p, f"{g}.m_source.l_linear", sine_waves))
    har_spec, har_phase = _stft_mag_phase(spec, har[:, :, 0])
    har_cat = torch.cat([har_spec, har_phase], 1)  # [1, n_fft+2, F]

    n_k = len(spec.resblock_kernel_sizes)
    n_up = len(spec.upsample_rates)
    for i, (u, k) in enumerate(zip(spec.upsample_rates,
                                   spec.upsample_kernel_sizes)):
        x = torch.where(x >= 0, x, LRELU_GEN * x)
        if i + 1 < n_up:
            stride_f0 = 1
            for r in spec.upsample_rates[i + 1:]:
                stride_f0 *= r
            xs_src = _conv1d(p, f"{g}.noise_convs.{i}", har_cat,
                             stride=stride_f0,
                             padding=(stride_f0 + 1) // 2)
        else:
            xs_src = _conv1d(p, f"{g}.noise_convs.{i}", har_cat)
        xs_src = _adain_resblock1(spec, p, f"{g}.noise_res.{i}", xs_src, s,
                                  kernel=7 if i + 1 < n_up else 11,
                                  dilations=(1, 3, 5))
        x = _conv_transpose1d(p, f"{g}.ups.{i}", x, stride=u,
                              padding=(k - u) // 2)
        if i == n_up - 1:
            x = F.pad(x, (1, 0), mode="reflect")
        x = x + xs_src
        acc = None
        for j, (rk, rd) in enumerate(zip(spec.resblock_kernel_sizes,
                                         spec.resblock_dilation_sizes)):
            h = _adain_resblock1(spec, p, f"{g}.resblocks.{i * n_k + j}",
                                 x, s, kernel=rk, dilations=rd)
            acc = h if acc is None else acc + h
        x = acc / n_k
    x = torch.where(x >= 0, x, 0.01 * x)  # F.leaky_relu default slope
    x = _conv1d(p, f"{g}.conv_post", x, padding=3)
    bins = spec.gen_istft_n_fft // 2 + 1
    return _istft(spec, torch.exp(x[:, :bins]), torch.sin(x[:, bins:]))


def _decoder(spec: KokoroSpec, p, asr, f0_curve, n_curve, s, seed,
             noise=None):
    """Decoder: asr [1, D, frames], F0/N [1, 2*frames], style ref
    [1, sty] -> audio [1, t]."""
    f0 = _conv1d(p, "decoder.F0_conv", f0_curve[:, None], stride=2,
                 padding=1)
    n = _conv1d(p, "decoder.N_conv", n_curve[:, None], stride=2, padding=1)
    x = torch.cat([asr, f0, n], 1)
    x = _adain_resblk1d(p, "decoder.encode", x, s, learned_sc=True)
    asr_res = _conv1d(p, "decoder.asr_res.0", asr)
    for i in range(4):
        # every decode block (the upsampling last one too) takes the
        # residual channels in front, so dim_in != dim_out always holds
        x = torch.cat([x, asr_res, f0, n], 1)
        x = _adain_resblk1d(p, f"decoder.decode.{i}", x, s,
                            upsample=i == 3, learned_sc=True)
    return _generator(spec, p, x, s, f0_curve, seed, noise)


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------


def durations(spec: KokoroSpec, p, tokens, s, speed=1.0):
    """Per-token frame counts [T] (int) plus the duration-encoder output
    d [1, T, D+sty] the alignment expands."""
    bert = _albert(spec, p, tokens)
    d_en = _lin(p, "bert_encoder", bert).transpose(1, 2)
    d = _duration_encoder(spec, p, d_en, s)
    x = _bilstm(p, "predictor.lstm", d)
    dur = _lin(p, "predictor.duration_proj.linear_layer", x)  # [1,T,max]
    dur = torch.sigmoid(dur).sum(-1) / speed  # [1, T]
    return torch.round(dur).clamp(min=1).long()[0], d


def _device_of(p) -> torch.device:
    return p["text_encoder.embedding.weight"].device


def synthesize_kokoro(spec: KokoroSpec, p, token_ids, ref_s,
                      speed: float = 1.0, seed: int = 0,
                      source_noise=None) -> np.ndarray:
    """token_ids: 1-D int array (the worker wraps with 0 pads); ref_s
    [1, 2*style_dim] voicepack row; ``source_noise`` [1, t, harmonics]
    (numpy or tensor) replaces the harmonic source's dither. Runs on the
    params' device; returns float32 audio on the host."""
    dev = _device_of(p)
    with torch.inference_mode(), f32_products():
        tokens = torch.as_tensor(np.asarray(token_ids, np.int64),
                                 device=dev)[None]
        ref = to_tensor(np.asarray(ref_s, np.float32).reshape(1, -1), dev)
        s_pros = ref[:, spec.style_dim:]
        s_ref = ref[:, :spec.style_dim]
        pred_dur, d = durations(spec, p, tokens, s_pros, speed)
        # alignment expansion (pred_aln_trg matmul == repeat_interleave)
        en = torch.repeat_interleave(d.transpose(1, 2), pred_dur, dim=-1)
        f0, n = _prosody_f0n(spec, p, en, s_pros)
        asr = torch.repeat_interleave(_text_encoder(spec, p, tokens),
                                      pred_dur, dim=-1)
        if source_noise is not None:
            source_noise = torch.as_tensor(np.asarray(source_noise),
                                           dtype=torch.float32, device=dev)
        audio = _decoder(spec, p, asr, f0, n, s_ref, seed, source_noise)
        return audio[0].cpu().numpy()


# ---------------------------------------------------------------------------
# checkpoint import
# ---------------------------------------------------------------------------


def _fold_weight_norm(flat: dict) -> dict:
    """Fold weight_norm (weight_g, weight_v) pairs into plain .weight:
    W = g * v / ||v|| with the norm over all-but-dim-0 (in f64, as the
    JAX importer folds it)."""
    out = {}
    for k, v in flat.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[: -len(".weight_v")]
            g = flat[base + ".weight_g"]
            norm = np.sqrt((v.astype(np.float64) ** 2).sum(
                axis=tuple(range(1, v.ndim)), keepdims=True))
            out[base + ".weight"] = (g * (v / np.maximum(norm, 1e-12))
                                     ).astype(np.float32)
        else:
            out[k] = v
    return out


def from_jax_params(params: dict, device: Any = None) -> dict:
    """The JAX module's flat parameter dict (numpy leaves) -> the port's
    on ``device``, key for key."""
    return params_from_numpy(params, resolve(device))


def load_kokoro(model_dir: str, device: Any = None):
    """Load a kokoro-layout checkpoint directory onto ``device``:
    - config.json with the model hyperparams (the Kokoro-82M layout),
    - a *.pth torch checkpoint ``{"net": {module: state_dict}}``
      (optional "net" wrapper, optional DataParallel "module." prefixes),
      read with ``torch.load(weights_only=True)``,
    - voices/*.pt voicepack tensors [N, 1, 2*style_dim].
    Returns (spec, params, voices: name -> np.ndarray)."""
    dev = resolve(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        spec = spec_from_config(json.load(f))
    ckpts = sorted(
        fn for fn in os.listdir(model_dir)
        if fn.endswith((".pth", ".pt")) and not fn.startswith("voice"))
    if not ckpts:
        raise FileNotFoundError(f"no .pth checkpoint in {model_dir}")
    raw = torch.load(os.path.join(model_dir, ckpts[0]),
                     map_location="cpu", weights_only=True)
    if "net" in raw:
        raw = raw["net"]
    flat: dict[str, np.ndarray] = {}
    for mod, sd in raw.items():
        for k, v in sd.items():
            if k.startswith("module."):
                k = k[len("module."):]
            flat[f"{mod}.{k}"] = v.float().numpy()
    params = params_from_numpy(_fold_weight_norm(flat), dev)
    voices = {}
    vdir = os.path.join(model_dir, "voices")
    if os.path.isdir(vdir):
        for fn in sorted(os.listdir(vdir)):
            if fn.endswith(".pt"):
                voices[fn[:-3]] = torch.load(
                    os.path.join(vdir, fn), map_location="cpu",
                    weights_only=True).float().numpy()
    return spec, params, voices


def pick_voice(voices: dict, name: str, n_tokens: int,
               style_dim: int) -> np.ndarray:
    """Reference voicepack semantics (kokoro backend.py:72-79): blend
    "a+b" as the mean of the packs; index the pack by token count."""
    if not voices:
        raise ValueError("kokoro model has no voicepacks")
    if name and "+" in name:
        parts = [v.strip() for v in name.split("+")]
        missing = [v for v in parts if v not in voices]
        if missing:
            # the reference backend fails the load on an unknown voice —
            # a typo must not silently produce a different voice
            raise ValueError(
                f"unknown voice(s) {missing}; available: "
                f"{sorted(voices)}")
        pack = np.mean(np.stack([voices[v] for v in parts]), axis=0)
    elif name:
        if name not in voices:
            raise ValueError(
                f"unknown voice {name!r}; available: {sorted(voices)}")
        pack = voices[name]
    else:
        pack = next(iter(voices.values()))
    idx = min(n_tokens, pack.shape[0] - 1)
    return pack[idx].reshape(1, -1)


_PUNCT = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_IPA = ("ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽ"
        "ʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩ᵻ")


def symbol_table() -> dict:
    """Kokoro symbol inventory: pad + punctuation + ASCII letters + IPA
    (the tokenizer the official pipeline feeds phonemized text into)."""
    symbols = ["$"] + list(_PUNCT) + list(_LETTERS) + list(_IPA)
    return {s: i for i, s in enumerate(symbols)}


def text_to_tokens(text: str, n_token: int) -> list:
    """Grapheme tokenization: ASCII letters and punctuation are symbols of
    the kokoro inventory, so raw text maps to valid ids directly (the
    official pipeline phonemizes with espeak first). Ids are folded into
    the model's vocabulary."""
    table = symbol_table()
    ids = [table[c] for c in text if c in table]
    return [i % max(n_token, 1) for i in ids] or [0]


def is_kokoro_dir(model_dir: str) -> bool:
    """Kokoro checkpoints carry no transformers model_type; detect by
    the config's own fields."""
    cfg_path = os.path.join(model_dir, "config.json")
    if not os.path.exists(cfg_path):
        return False
    try:
        with open(cfg_path) as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return False  # unreadable/non-JSON config: not a kokoro dir
    if (cfg.get("model_type") or "").lower() in ("kokoro", "styletts2"):
        return True
    return ("istftnet" in cfg or "plbert" in cfg) and "style_dim" in cfg

