"""XTTS-class (coqui) voice-cloning TTS in PyTorch: the port's counterpart
of localai_tfp_tpu/models/xtts.py (ref: backend/python/coqui/backend.py,
TTS.api over XTTS v2 checkpoints).

  text tokens ─┐
               ├─> GPT-2 acoustic model ──> latents ──> HiFiGAN ──> wav
  speaker ─────┘        (autoregressive         (speaker-conditioned
  conditioning           audio codes)            waveform decoder)

- GPT core (``gpt.gpt.h.*``): GPT-2 blocks in the HF layout (``Conv1D``
  weights stored ``[in, out]`` and used as they are), text and audio
  embeddings with their own learned positions, the ``mel_head``.
  ``gpt_generate`` decodes over a KV cache one token a step and stops at
  the stop token; the JAX module scans all ``max_new`` steps and trims at
  the first stop token, so the codes and latents up to it are the same.
  The latents HiFiGAN reads are the hidden states after ``ln_f`` at each
  audio position.
- Conditioning (``gpt.conditioning_encoder`` / ``_perceiver``): a conv
  stack, then the learned latents cross-attending its features;
  ``mel_spectrogram`` is the JAX module's host numpy, copied.
- HiFiGAN (``hifigan_decoder.waveform_decoder``): global speaker
  conditioning after ``conv_pre``, a per-stage conditioning projection
  after every upsample, resblock banks averaged.
- ``speakers_xtts.pth`` voices: ``{name: {gpt_cond_latent,
  speaker_embedding}}``.

The tree is the JAX module's (``load_xtts``; ``from_jax_params`` carries
a JAX tree across leaf by leaf, strides and dilations as ints). Files are
read with ``torch.load(weights_only=True)``; ``vocab.json`` through
``engine/bpe.py``. Everything runs in f32 on the tree's device, TF32 off.
"""

from __future__ import annotations

import json
import logging
import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products, resolve
from .convert import to_tensor

log = logging.getLogger(__name__)

Params = dict[str, Any]


@dataclass(frozen=True, eq=False)
class XttsSpec:
    gpt_layers: int = 30
    gpt_dim: int = 1024
    gpt_heads: int = 16
    n_text_tokens: int = 6681
    n_audio_tokens: int = 1026
    start_audio_token: int = 1024
    stop_audio_token: int = 1025
    start_text_token: int = 261
    stop_text_token: int = 0
    max_audio_tokens: int = 605
    max_text_tokens: int = 402
    # conditioning
    cond_latents: int = 32
    cond_mels: int = 80
    cond_heads: int = 2
    # decoder
    decoder_input_dim: int = 1024
    d_vector_dim: int = 512
    up_rates: tuple = (8, 8, 2, 2)
    up_kernels: tuple = (16, 16, 4, 4)
    up_initial: int = 512
    resblock_kernels: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    sample_rate: int = 24000

    @property
    def d_head(self) -> int:
        return self.gpt_dim // self.gpt_heads


def spec_from_config(cfg: dict) -> XttsSpec:
    a = cfg.get("model_args") or {}
    audio = cfg.get("audio") or {}
    return XttsSpec(
        gpt_layers=int(a.get("gpt_layers") or 30),
        gpt_dim=int(a.get("gpt_n_model_channels") or 1024),
        gpt_heads=int(a.get("gpt_n_heads") or 16),
        n_text_tokens=int(a.get("gpt_number_text_tokens") or 6681),
        n_audio_tokens=int(a.get("gpt_num_audio_tokens") or 1026),
        start_audio_token=int(a.get("gpt_start_audio_token") or 1024),
        stop_audio_token=int(a.get("gpt_stop_audio_token") or 1025),
        start_text_token=int(a.get("gpt_start_text_token") or 261),
        stop_text_token=int(a.get("gpt_stop_text_token") or 0),
        max_audio_tokens=int(a.get("gpt_max_audio_tokens") or 605),
        max_text_tokens=int(a.get("gpt_max_text_tokens") or 402),
        cond_mels=int(a.get("gpt_num_audio_channels") or 80),
        decoder_input_dim=int(a.get("decoder_input_dim") or 1024),
        d_vector_dim=int(a.get("d_vector_dim") or 512),
        sample_rate=int(audio.get("output_sample_rate") or 24000),
        # official checkpoints fix the HiFiGAN geometry in code; a config
        # may override it
        up_rates=tuple(a.get("hifigan_up_rates") or (8, 8, 2, 2)),
        up_kernels=tuple(a.get("hifigan_up_kernels") or (16, 16, 4, 4)),
        up_initial=int(a.get("hifigan_up_initial") or 512),
        resblock_kernels=tuple(
            a.get("hifigan_resblock_kernels") or (3, 7, 11)),
        resblock_dilations=tuple(
            tuple(d) for d in (a.get("hifigan_resblock_dilations")
                               or ((1, 3, 5),) * 3)),
        cond_heads=int(a.get("perceiver_heads") or 2),
        cond_latents=int(a.get("perceiver_latents") or 32),
    )


def is_xtts_dir(model_dir: str) -> bool:
    cfg = os.path.join(model_dir, "config.json")
    if not os.path.isfile(cfg):
        return False
    try:
        with open(cfg) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return False
    args = data.get("model_args") or {}
    return "gpt_number_text_tokens" in args or (
        data.get("model") == "xtts")


# ------------------------------------------------------------- GPT core


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def new_caches(spec: XttsSpec, p: Params, S: int) -> list:
    """Per-layer (K, V) buffers [1, heads, S, dh] for ``gpt_forward``."""
    shape = (1, spec.gpt_heads, S, spec.d_head)
    dev = p["ln_f_w"].device
    return [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
            for _ in range(spec.gpt_layers)]


def gpt_forward(spec: XttsSpec, p: Params, emb: torch.Tensor, caches: list,
                pos: int) -> torch.Tensor:
    """The GPT stack on input embeddings [1, T, D] at positions
    [pos, pos + T) of ``caches`` (written in place). Returns the hidden
    states after ``ln_f``: causal within the new span, full attention to
    every cached position before it."""
    _, T, D = emb.shape
    H, Dh = spec.gpt_heads, spec.d_head
    mask = None
    if T > 1:
        i = torch.arange(T, device=emb.device)
        mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e30)
    x = emb
    for lp, (kc, vc) in zip(p["blocks"], caches):
        h = _ln(x, lp["ln1_w"], lp["ln1_b"])
        qkv = h @ lp["attn_w"] + lp["attn_b"]  # [1, T, 3D]
        q, k, v = (t.reshape(1, T, H, Dh).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        kc[:, :, pos:pos + T] = k
        vc[:, :, pos:pos + T] = v
        logits = q @ kc[:, :, :pos + T].transpose(-1, -2) / math.sqrt(Dh)
        if mask is not None:
            logits[..., pos:] += mask
        attn = torch.softmax(logits, -1) @ vc[:, :, :pos + T]
        x = x + (attn.transpose(1, 2).reshape(1, T, D) @ lp["proj_w"]
                 + lp["proj_b"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"])
        h = F.gelu(h @ lp["fc_w"] + lp["fc_b"], approximate="tanh")
        x = x + (h @ lp["fc2_w"] + lp["fc2_b"])
    return _ln(x, p["ln_f_w"], p["ln_f_b"])


def gpt_prefix(spec: XttsSpec, p: Params, text_ids,
               cond_latents: torch.Tensor) -> torch.Tensor:
    """[cond_latents; text embeddings; start_audio] [1, P, D]."""
    dev = p["ln_f_w"].device
    ids = torch.tensor([spec.start_text_token, *[int(t) for t in text_ids],
                        spec.stop_text_token], device=dev)
    t_emb = p["text_emb"][ids] + p["text_pos"][:len(ids)]
    start = p["audio_emb"][spec.start_audio_token] + p["audio_pos"][0]
    return torch.cat([cond_latents.to(t_emb), t_emb, start[None]])[None]


def audio_logits(spec: XttsSpec, p: Params,
                 hidden: torch.Tensor) -> torch.Tensor:
    """mel_head over hidden states [..., D], the start token's logit at
    -1e30 (never picked)."""
    lg = hidden @ p["mel_head_w"] + p["mel_head_b"]
    lg[..., spec.start_audio_token] = -1e30
    return lg


def gpt_generate(spec: XttsSpec, p: Params, text_ids,
                 cond_latents: torch.Tensor, max_new: int = 0,
                 temperature: float = 0.0, seed: int = 0
                 ) -> tuple[np.ndarray, torch.Tensor]:
    """Audio codes [n] (host) and GPT latents [n, D] (device): one token
    a step over a KV cache, up to the first stop token or ``max_new``.
    ``temperature`` > 0 samples ``argmax(logits / t + g)`` with Gumbel
    draws from a generator seeded from ``seed``."""
    max_new = max_new or spec.max_audio_tokens
    prefix = gpt_prefix(spec, p, text_ids, cond_latents)
    P = prefix.shape[1]
    caches = new_caches(spec, p, P + max_new + 1)
    hidden = gpt_forward(spec, p, prefix, caches, 0)
    dev = prefix.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks: list[int] = []
    lats = []
    for i in range(max_new):
        lg = audio_logits(spec, p, hidden[0, -1])
        if temperature > 0:
            u = torch.rand(lg.shape, generator=gen, device=dev)
            lg = lg / temperature - torch.log(-torch.log(
                u.clamp(min=torch.finfo(torch.float32).tiny)))
        tok = int(torch.argmax(lg))
        if tok == spec.stop_audio_token:
            break
        emb = p["audio_emb"][tok] + p["audio_pos"][i + 1]
        hidden = gpt_forward(spec, p, emb[None, None], caches, P + i)
        toks.append(tok)
        lats.append(hidden[0, -1])
    lat = torch.stack(lats) if lats else prefix.new_zeros((0, spec.gpt_dim))
    return np.asarray(toks, np.int64), lat


# --------------------------------------- conditioning encoder + perceiver


def conditioning_latents(spec: XttsSpec, p: Params,
                         mel) -> torch.Tensor:
    """Reference-audio mel [n_mels, T] -> gpt_cond_latent [C, D]: the
    conv stack, then the perceiver's latents cross-attending it."""
    cp = p["cond"]
    x = torch.as_tensor(np.asarray(mel, np.float32),
                        device=cp["latents"].device)[None]
    for w, b, stride in cp["convs"]:
        x = F.relu(F.conv1d(x, w, b, stride=stride,
                            padding=w.shape[-1] // 2))
    feats = x[0].T  # [T', D]
    lat = cp["latents"]
    H = spec.cond_heads
    Dh = spec.gpt_dim // H
    q = (lat @ cp["wq"]).reshape(-1, H, Dh).transpose(0, 1)
    k = (feats @ cp["wk"]).reshape(-1, H, Dh).transpose(0, 1)
    v = (feats @ cp["wv"]).reshape(-1, H, Dh).transpose(0, 1)
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(Dh), -1)
    out = (probs @ v).transpose(0, 1).reshape(lat.shape[0], -1)
    return lat + out @ cp["wo"]


def mel_spectrogram(wav: np.ndarray, n_mels: int = 80,
                    sr: int = 22050) -> np.ndarray:
    """Log-mel of a reference wav (host numpy, the JAX module's own):
    1024-point STFT, hop 256, triangular mel filters."""
    n_fft, hop = 1024, 256
    pad = n_fft // 2
    wav = np.pad(wav.astype(np.float32), (pad, pad), mode="reflect")
    frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
    win = np.hanning(n_fft).astype(np.float32)
    spec = np.abs(np.fft.rfft(wav[idx] * win, axis=-1)) ** 2  # [F, K]

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz2mel(0.0), hz2mel(sr / 2), n_mels + 2)
    hz = mel2hz(mels)
    bins = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        if c > lo:
            fb[m - 1, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        if hi > c:
            fb[m - 1, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    mel = spec @ fb.T  # [K, M]
    return np.log(np.clip(mel, 1e-5, None)).T.astype(np.float32)


# -------------------------------------------------------------- decoder

_SLOPE = 0.1


def hifigan_decode(spec: XttsSpec, p: Params, latents: torch.Tensor,
                   d_vector) -> torch.Tensor:
    """GPT latents [T, decoder_input_dim] + speaker d-vector [dv] ->
    waveform [T * prod(up_rates)] on the device (coqui HifiganGenerator:
    the global conditioning after conv_pre and, XTTS's
    cond_in_each_up_layer, a per-stage one after every upsample)."""
    dp = p["decoder"]
    x = latents.T[None]  # [1, C_in, T]
    x = F.conv1d(x, dp["conv_pre_w"], dp["conv_pre_b"], padding=3)
    g = torch.as_tensor(d_vector, dtype=torch.float32,
                        device=x.device).reshape(1, -1, 1)
    x = x + F.conv1d(g, dp["cond_w"], dp["cond_b"])
    for i, (up_w, up_b, cond_i, blocks) in enumerate(dp["ups"]):
        x = F.leaky_relu(x, _SLOPE)
        stride = spec.up_rates[i]
        x = F.conv_transpose1d(x, up_w, up_b, stride=stride,
                               padding=(spec.up_kernels[i] - stride) // 2)
        if cond_i is not None:
            x = x + F.conv1d(g, cond_i[0], cond_i[1])
        acc = None
        for convs1, convs2 in blocks:  # the resblock bank, averaged
            h = x
            for (w1, b1, d1), (w2, b2, d2) in zip(convs1, convs2):
                y = F.conv1d(F.leaky_relu(h, _SLOPE), w1, b1,
                             padding=d1 * (w1.shape[-1] // 2), dilation=d1)
                y = F.conv1d(F.leaky_relu(y, _SLOPE), w2, b2,
                             padding=d2 * (w2.shape[-1] // 2), dilation=d2)
                h = h + y
            acc = h if acc is None else acc + h
        x = acc / len(blocks)
    x = F.conv1d(F.leaky_relu(x, _SLOPE), dp["conv_post_w"],
                 dp["conv_post_b"], padding=3)
    return torch.tanh(x)[0, 0]


# ------------------------------------------------------------ synthesis


def synthesize(spec: XttsSpec, p: Params, text_ids,
               gpt_cond_latent, speaker_embedding,
               temperature: float = 0.0, seed: int = 0,
               max_new: int = 0) -> np.ndarray:
    """text ids + voice latents -> waveform (float32 [-1, 1], host)."""
    dev = p["ln_f_w"].device
    with torch.inference_mode(), f32_products():
        cond = torch.as_tensor(np.asarray(gpt_cond_latent, np.float32),
                               device=dev)
        _, latents = gpt_generate(spec, p, text_ids, cond, max_new=max_new,
                                  temperature=temperature, seed=seed)
        if latents.shape[0] == 0:
            return np.zeros(0, np.float32)
        return hifigan_decode(spec, p, latents,
                              np.asarray(speaker_embedding).reshape(-1)
                              ).cpu().numpy()


# -------------------------------------------------------------- loading


def load_voices(model_dir: str) -> dict[str, tuple]:
    """speakers_xtts.pth: {name: {"gpt_cond_latent": [1, C, D]|[C, D],
    "speaker_embedding": [1, dv, 1]|[dv]}} -> (latent [C, D], d-vector
    [dv]) numpy pairs."""
    out = {}
    for fn in ("speakers_xtts.pth", "speakers.pth"):
        path = os.path.join(model_dir, fn)
        if not os.path.isfile(path):
            continue
        data = torch.load(path, map_location="cpu", weights_only=True)
        for name, d in data.items():
            try:
                lat = d["gpt_cond_latent"].float().numpy()
                emb = d["speaker_embedding"].float().numpy()
            except (KeyError, AttributeError, TypeError, ValueError) as e:
                log.warning("skipping malformed voice %r: %r", name, e)
                continue
            out[name] = (lat.reshape(lat.shape[-2], lat.shape[-1]),
                         emb.reshape(-1))
        break
    return out


def load_xtts(model_dir: str, device: Any = None):
    """An XTTS checkpoint dir (config.json + model.pth [+ vocab.json +
    speakers_xtts.pth]) -> (spec, params on ``device``, tokenizer or
    None, voices)."""
    dev = resolve(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    spec = spec_from_config(cfg)
    sd = torch.load(os.path.join(model_dir, "model.pth"), map_location="cpu",
                    weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]

    def t(name):
        return sd[name].float().numpy()

    def j(name):
        return to_tensor(t(name), dev)

    p: Params = {
        "text_emb": j("gpt.text_embedding.weight"),
        "text_pos": j("gpt.text_pos_embedding.emb.weight"),
        "audio_emb": j("gpt.mel_embedding.weight"),
        "audio_pos": j("gpt.mel_pos_embedding.emb.weight"),
        "ln_f_w": j("gpt.gpt.ln_f.weight"),
        "ln_f_b": j("gpt.gpt.ln_f.bias"),
        "mel_head_w": to_tensor(t("gpt.mel_head.weight").T, dev),
        "mel_head_b": j("gpt.mel_head.bias"),
    }
    p["blocks"] = []
    for i in range(spec.gpt_layers):
        pre = f"gpt.gpt.h.{i}."
        p["blocks"].append({
            "ln1_w": j(pre + "ln_1.weight"), "ln1_b": j(pre + "ln_1.bias"),
            # HF GPT2 Conv1D stores [in, out]: used as it is
            "attn_w": j(pre + "attn.c_attn.weight"),
            "attn_b": j(pre + "attn.c_attn.bias"),
            "proj_w": j(pre + "attn.c_proj.weight"),
            "proj_b": j(pre + "attn.c_proj.bias"),
            "ln2_w": j(pre + "ln_2.weight"), "ln2_b": j(pre + "ln_2.bias"),
            "fc_w": j(pre + "mlp.c_fc.weight"),
            "fc_b": j(pre + "mlp.c_fc.bias"),
            "fc2_w": j(pre + "mlp.c_proj.weight"),
            "fc2_b": j(pre + "mlp.c_proj.bias"),
        })

    convs = []
    i = 0
    while f"gpt.conditioning_encoder.convs.{i}.weight" in sd:
        convs.append((j(f"gpt.conditioning_encoder.convs.{i}.weight"),
                      j(f"gpt.conditioning_encoder.convs.{i}.bias"),
                      2 if i > 0 else 1))
        i += 1
    p["cond"] = {
        "convs": convs,
        **{k: j(f"gpt.conditioning_perceiver.{k}")
           for k in ("latents", "wq", "wk", "wv", "wo")},
    } if "gpt.conditioning_perceiver.latents" in sd else None

    def wn(prefix):
        """A weight-normed conv's weight folded (weight_g, weight_v)."""
        if prefix + ".weight" in sd:
            w = t(prefix + ".weight")
        else:
            g, v = t(prefix + ".weight_g"), t(prefix + ".weight_v")
            norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1)
            w = v * (g.reshape(-1) / np.maximum(norm, 1e-12)
                     ).reshape(-1, *([1] * (v.ndim - 1)))
        return to_tensor(w, dev)

    wd = "hifigan_decoder.waveform_decoder."
    dp: Params = {
        "conv_pre_w": wn(wd + "conv_pre"), "conv_pre_b": j(wd + "conv_pre.bias"),
        "conv_post_w": wn(wd + "conv_post"),
        "conv_post_b": j(wd + "conv_post.bias"),
        "cond_w": j(wd + "cond_layer.weight"),
        "cond_b": j(wd + "cond_layer.bias"),
    }
    n_k = len(spec.resblock_kernels)
    ups = []
    for u in range(len(spec.up_rates)):
        cond_i = None
        if wd + f"conds.{u}.weight" in sd:
            cond_i = (j(wd + f"conds.{u}.weight"), j(wd + f"conds.{u}.bias"))
        blocks = []
        for kk in range(n_k):
            r = wd + f"resblocks.{u * n_k + kk}"
            blocks.append((
                [(wn(f"{r}.convs1.{d}"), j(f"{r}.convs1.{d}.bias"), dil)
                 for d, dil in enumerate(spec.resblock_dilations[kk])],
                [(wn(f"{r}.convs2.{d}"), j(f"{r}.convs2.{d}.bias"), 1)
                 for d in range(len(spec.resblock_dilations[kk]))]))
        ups.append((wn(wd + f"ups.{u}"), j(wd + f"ups.{u}.bias"), cond_i,
                    blocks))
    dp["ups"] = ups
    p["decoder"] = dp
    return spec, p, load_vocab(model_dir), load_voices(model_dir)


def load_vocab(model_dir: str):
    """``vocab.json`` (a ``tokenizers`` JSON) through ``engine/bpe.py``,
    or None when there is none or it cannot be read (the byte
    fallback)."""
    from ..engine.bpe import BPETokenizer

    vocab = os.path.join(model_dir, "vocab.json")
    if not os.path.isfile(vocab):
        return None
    try:
        return BPETokenizer(vocab)
    except (OSError, ValueError, KeyError, NotImplementedError) as e:
        log.warning("xtts vocab.json unusable (%r); falling back to "
                    "byte-level text encoding", e)
        return None


def text_ids(spec: XttsSpec, tok, text: str, language: str = "") -> list:
    """``[{language or "en"}]{text}`` through the vocabulary, else the
    byte fallback ``b % max(n_text_tokens - 2, 1) + 1``."""
    if tok is not None:
        return tok.encode_special(f"[{language or 'en'}]{text}")
    return [b % max(spec.n_text_tokens - 2, 1) + 1 for b in text.encode()]


def from_jax_params(p: Params, device: Any = None) -> Params:
    """The JAX module's ``Params`` (numpy leaves; strides and dilations
    as they come) -> the port's on ``device``."""
    dev = resolve(device)

    def t(a):
        return to_tensor(np.asarray(a, np.float32), dev)

    out = {k: t(v) for k, v in p.items()
           if k not in ("blocks", "cond", "decoder")}
    out["blocks"] = [{k: t(v) for k, v in b.items()} for b in p["blocks"]]
    cond = p.get("cond")
    out["cond"] = None if cond is None else {
        "convs": [(t(w), t(b), int(s)) for w, b, s in cond["convs"]],
        **{k: t(cond[k]) for k in ("latents", "wq", "wk", "wv", "wo")}}
    dp = p["decoder"]
    dec = {k: t(v) for k, v in dp.items() if k != "ups"}
    dec["ups"] = [(t(w), t(b), None if c is None else (t(c[0]), t(c[1])),
                   [([(t(w1), t(b1), int(d1)) for w1, b1, d1 in c1],
                     [(t(w2), t(b2), int(d2)) for w2, b2, d2 in c2])
                    for c1, c2 in blocks])
                  for w, b, c, blocks in dp["ups"]]
    out["decoder"] = dec
    return out
