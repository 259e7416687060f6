"""MusicGen text-to-audio in PyTorch: the port's counterpart of
localai_tfp_tpu/models/musicgen.py (HF MusicgenForConditionalGeneration
checkpoints; ref: backend/python/transformers/backend.py SoundGeneration
:452, served behind /v1/sound-generation).

  T5 text encoder  ->  delay-pattern codebook decoder  ->  EnCodec decoder
  (relative-bias       (sinusoidal positions, summed       (RVQ codebook sum,
   attention)           codebook embeds, cross-attn,        SEANet: LSTM +
                        one lm_head per codebook)           transposed convs)

Generation follows MusicgenForCausalLM's delay pattern (codebook k offset
k steps, pad tokens on the staircase) with classifier-free guidance (the
batch doubled with zeroed encoder states, rows combined as ``lg[1] + g *
(lg[0] - lg[1])``). Each step feeds one frame over a KV cache of exactly
the positions so far (the JAX module masks a power-of-two cache at -1e9:
the same softmax); the cross-attention K/V are computed once a request.
The step's logits come to the host in f32 and the JAX module's numpy
sampling runs on them unchanged (top-k, ``np.random.default_rng(seed)``),
so seeded sampled codes equal the JAX module's.

The EnCodec decoder here is MusicGen's own (``EncodecSpec``: non-causal
asymmetric padding, reflect or constant, the LSTM's residual, the RVQ
codebook sum), not bark's causal 24 kHz one in ``models/encodec.py``.
The trees are the JAX module's (``load_musicgen``), so ``from_jax_params``
is a per-leaf copy. Everything runs in f32 on the trees' device, TF32 off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products, resolve
from .convert import params_from_numpy

Params = dict[str, Any]


# ------------------------------------------------------------- T5 encoder


@dataclass(frozen=True, eq=False)
class T5Spec:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    n_layers: int
    n_heads: int
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6


def _t5_ln(x, w, eps):
    # T5LayerNorm: RMS without mean subtraction, no bias
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _t5_rel_bucket(rel, num_buckets, max_distance):
    """Bidirectional relative position buckets (T5Attention's
    ``_relative_position_bucket`` with bidirectional=True), in f32 as the
    JAX module computes them."""
    nb = num_buckets // 2
    ret = torch.where(rel > 0, nb, 0)
    n = rel.abs()
    max_exact = nb // 2
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact) * (nb - max_exact)).int()
    large = large.clamp(max=nb - 1)
    return ret + torch.where(n < max_exact, n, large)


def t5_encode(spec: T5Spec, p: Params, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, S] -> encoder states [B, S, D]. No position embeddings:
    layer 0's relative attention bias table serves every layer."""
    x = p["embed"][ids]
    B, S = ids.shape
    pos = torch.arange(S, device=ids.device)
    bucket = _t5_rel_bucket(pos[None, :] - pos[:, None], spec.rel_buckets,
                            spec.rel_max_distance)
    bias = p["rel_bias"][bucket].permute(2, 0, 1)[None]  # [1, H, S, S]
    H, Dk = spec.n_heads, spec.d_kv
    for lp in p["layers"]:
        h = _t5_ln(x, lp["ln1"], spec.eps)
        # T5: no 1/sqrt(dk) scale
        q, k, v = ((h @ lp[w]).reshape(B, S, H, Dk).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        probs = torch.softmax(q @ k.transpose(-1, -2) + bias, -1)
        x = x + (probs @ v).transpose(1, 2).reshape(B, S, H * Dk) @ lp["wo"]
        h = _t5_ln(x, lp["ln2"], spec.eps)
        x = x + F.relu(h @ lp["wi"]) @ lp["wo_ff"]
    return _t5_ln(x, p["final_ln"], spec.eps)


# ------------------------------------------------- delay-pattern decoder


@dataclass(frozen=True, eq=False)
class MgDecSpec:
    vocab_size: int  # per-codebook audio vocab (2048)
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    n_codebooks: int
    pad_token: int  # == vocab_size (the extra embedding row)
    scale_embedding: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def _sin_pos(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """MusicGen's sinusoidal positions: [cos | sin] halves."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32,
                                  device=pos.device)
                     * (-math.log(10000.0) / (half - 1)))
    ang = pos[..., None].float() * freq
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def _attend(spec: MgDecSpec, q, k, v, mask=None):
    """q [B, T, D] (already scaled), k/v [B, S, D] -> [B, T, D]."""
    B, T, D = q.shape
    H, Dh = spec.n_heads, spec.d_head
    q, k, v = (t.reshape(B, -1, H, Dh).transpose(1, 2) for t in (q, k, v))
    logits = q @ k.transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    return (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(B, T, D)


def _embed(spec: MgDecSpec, p: Params, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, nb, T] -> summed codebook embeddings [B, T, D]."""
    x = sum(p["embed"][cb][codes[:, cb]] for cb in range(codes.shape[1]))
    return x * math.sqrt(spec.d_model) if spec.scale_embedding else x


def mg_hidden(spec: MgDecSpec, p: Params, codes: torch.Tensor,
              enc: torch.Tensor) -> torch.Tensor:
    """Full (non-cached) decoder pass up to the final norm: codes
    [B, nb, T] -> hidden [B, T, D]."""
    T = codes.shape[2]
    x = _embed(spec, p, codes) + _sin_pos(
        torch.arange(T, device=codes.device), spec.d_model)[None]
    i = torch.arange(T, device=codes.device)
    causal = torch.where(i[None, :] <= i[:, None], 0.0, -1e9)[None, None]
    scale = spec.d_head ** -0.5
    for lp in p["layers"]:
        h = _ln(x, lp["ln1_w"], lp["ln1_b"])
        x = x + _attend(spec, (h @ lp["self_wq"]) * scale, h @ lp["self_wk"],
                        h @ lp["self_wv"], causal) @ lp["self_wo"]
        h = _ln(x, lp["ln2_w"], lp["ln2_b"])
        x = x + _attend(spec, (h @ lp["cross_wq"]) * scale,
                        enc @ lp["cross_wk"], enc @ lp["cross_wv"]
                        ) @ lp["cross_wo"]
        h = _ln(x, lp["ln3_w"], lp["ln3_b"])
        x = x + F.gelu(h @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] \
            + lp["fc2_b"]
    return _ln(x, p["final_ln_w"], p["final_ln_b"])


def mg_decode_full(spec: MgDecSpec, p: Params, codes: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:
    """codes [B, nb, T] -> logits [B, nb, T, V] (every position)."""
    x = mg_hidden(spec, p, codes, enc)
    return torch.stack([x @ p["heads"][cb]
                        for cb in range(spec.n_codebooks)], 1)


def mg_cross_kv(p: Params, enc: torch.Tensor) -> list:
    """Each layer's cross-attention (K, V) [B, S, D] (the encoder states
    never change within a request)."""
    return [(enc @ lp["cross_wk"], enc @ lp["cross_wv"])
            for lp in p["layers"]]


def mg_step(spec: MgDecSpec, p: Params, frame: torch.Tensor, cross: list,
            cache_k: torch.Tensor, cache_v: torch.Tensor,
            pos: int) -> torch.Tensor:
    """One frame [B, nb] at position ``pos`` over the self-attention
    cache [L, B, >pos, D] (written in place) -> logits [B, nb, V]."""
    x = _embed(spec, p, frame[:, :, None]) + _sin_pos(
        torch.tensor([pos], device=frame.device), spec.d_model)[None]
    scale = spec.d_head ** -0.5
    for li, lp in enumerate(p["layers"]):
        h = _ln(x, lp["ln1_w"], lp["ln1_b"])
        cache_k[li, :, pos] = (h @ lp["self_wk"])[:, 0]
        cache_v[li, :, pos] = (h @ lp["self_wv"])[:, 0]
        x = x + _attend(spec, (h @ lp["self_wq"]) * scale,
                        cache_k[li, :, :pos + 1],
                        cache_v[li, :, :pos + 1]) @ lp["self_wo"]
        h = _ln(x, lp["ln2_w"], lp["ln2_b"])
        x = x + _attend(spec, (h @ lp["cross_wq"]) * scale,
                        *cross[li]) @ lp["cross_wo"]
        h = _ln(x, lp["ln3_w"], lp["ln3_b"])
        x = x + F.gelu(h @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] \
            + lp["fc2_b"]
    xt = _ln(x, p["final_ln_w"], p["final_ln_b"])[:, 0]  # [B, D]
    return torch.stack([xt @ p["heads"][cb]
                        for cb in range(spec.n_codebooks)], 1)


# --------------------------------------------------------- encodec decode


@dataclass(frozen=True, eq=False)
class EncodecSpec:
    n_filters: int
    hidden: int  # codebook/embedding dim at the bottleneck
    upsample_ratios: tuple[int, ...]
    n_residual: int = 1
    lstm_layers: int = 2
    kernel: int = 7
    last_kernel: int = 7
    residual_kernel: int = 3
    channels: int = 1
    causal: bool = True  # EncodecConfig.use_causal_conv
    trim_right_ratio: float = 1.0
    pad_mode: str = "reflect"


def _enc_conv(spec: EncodecSpec, x, w, b, stride=1, dilation=1):
    """EncodecConv1d: causal = all padding on the left; non-causal = an
    asymmetric split; reflect or constant per the config."""
    k = w.shape[-1]
    total = (k - 1) * dilation + 1 - stride
    L = x.shape[-1]
    nf = math.ceil((L - k + total) / stride + 1) - 1
    extra = nf * stride + k - total - L
    if spec.causal:
        left, right = total, extra
    else:
        right = total // 2
        left = total - right
        right += extra
    if spec.pad_mode != "reflect":
        x = F.pad(x, (left, right))
    elif max(left, right) < L:
        x = F.pad(x, (left, right), mode="reflect")
    else:
        x = x[..., _reflect_index(L, left, right, x.device)]
    return F.conv1d(x, w, b, stride=stride, dilation=dilation)


def _reflect_index(L: int, left: int, right: int, device) -> torch.Tensor:
    """numpy's (and jnp.pad's) reflect padding as an index map, for pads
    at least as long as the input (which ``F.pad`` refuses): the
    reflection repeats with period 2 (L - 1); one sample repeats."""
    i = torch.arange(-left, L + right, device=device)
    if L == 1:
        return torch.zeros_like(i)
    i = i.remainder(2 * (L - 1))
    return torch.where(i < L, i, 2 * (L - 1) - i)


def _enc_convtr(spec: EncodecSpec, x, w, b, stride):
    """EncodecConvTranspose1d: trim (k - stride); causal from the right
    per trim_right_ratio, non-causal split asymmetrically."""
    k = w.shape[-1]
    out = F.conv_transpose1d(x, w, b, stride=stride)
    total = k - stride
    right = (math.ceil(total * spec.trim_right_ratio) if spec.causal
             else total // 2)
    return out[..., total - right: out.shape[-1] - right]


def _lstm(x, lp: Params, n_layers: int):
    """torch LSTM over [B, C, T] plus EncodecLSTM's residual."""
    seq = x.permute(2, 0, 1).contiguous()  # [T, B, C]
    weights = []
    for i in range(n_layers):
        weights += [lp[f"wi{i}"], lp[f"wh{i}"], lp[f"bi{i}"], lp[f"bh{i}"]]
    H = lp["wh0"].shape[1]
    h0 = seq.new_zeros(n_layers, seq.shape[1], H)
    out, _, _ = torch.lstm(seq, (h0, h0), weights, True, n_layers, 0.0,
                           False, False, False)
    return (out + seq).permute(1, 2, 0)


def encodec_decode(spec: EncodecSpec, p: Params,
                   codes: torch.Tensor) -> torch.Tensor:
    """codes [nq, B, T] -> waveform [B, T * prod(ratios)]: the RVQ
    codebook sum, then the SEANet decoder."""
    quant = sum(p["codebooks"][qi][codes[qi]] for qi in range(codes.shape[0]))
    x = quant.transpose(1, 2)  # [B, D, T]
    x = _enc_conv(spec, x, p["conv_in_w"], p["conv_in_b"])
    x = _lstm(x, p["lstm"], spec.lstm_layers)
    for ratio, up in zip(spec.upsample_ratios, p["ups"]):
        x = _enc_convtr(spec, F.elu(x), up["w"], up["b"], ratio)
        for rb in up["res"]:
            y = _enc_conv(spec, F.elu(x), rb["c1_w"], rb["c1_b"])
            y = _enc_conv(spec, F.elu(y), rb["c2_w"], rb["c2_b"])
            x = _enc_conv(spec, x, rb["sc_w"], rb["sc_b"]) + y
    x = _enc_conv(spec, F.elu(x), p["conv_out_w"], p["conv_out_b"])
    return x[:, 0]


# ----------------------------------------------------------------- loader


def _wn(get, nameset, prefix):
    for g_n, v_n in ((prefix + ".parametrizations.weight.original0",
                      prefix + ".parametrizations.weight.original1"),
                     (prefix + ".weight_g", prefix + ".weight_v")):
        if g_n in nameset:
            g = get(g_n).float().numpy()
            v = get(v_n).float().numpy()
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)),
                                        keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    return get(prefix + ".weight").float().numpy()


def load_musicgen(model_dir: str, device: Any = None):
    """An HF MusicgenForConditionalGeneration checkpoint dir ->
    (t5_spec, t5_params, dec_spec, dec_params, enc_spec, enc_params,
    meta), the trees on ``device`` in f32. Every residual block's
    ``shortcut.conv`` is read, as the JAX loader reads it (ROADMAP §C
    18)."""
    from .hf_loader import load_hf_state

    dev = resolve(device)
    config, get, names = load_hf_state(model_dir)
    nameset = set(names)
    tcfg = config["text_encoder"]
    dcfg = config["decoder"]
    acfg = config["audio_encoder"]

    def a(n):
        return get(n).float().numpy()

    def t(n):
        return np.ascontiguousarray(a(n).T)

    t5 = T5Spec(
        vocab_size=int(tcfg["vocab_size"]),
        d_model=int(tcfg["d_model"]), d_kv=int(tcfg["d_kv"]),
        d_ff=int(tcfg["d_ff"]), n_layers=int(tcfg["num_layers"]),
        n_heads=int(tcfg["num_heads"]),
        rel_buckets=int(tcfg.get("relative_attention_num_buckets") or 32),
        rel_max_distance=int(
            tcfg.get("relative_attention_max_distance") or 128),
        eps=float(tcfg.get("layer_norm_epsilon") or 1e-6),
    )
    te = "text_encoder.encoder."
    embed_name = (te + "embed_tokens.weight"
                  if te + "embed_tokens.weight" in nameset
                  else "text_encoder.shared.weight")  # tied + deduped
    t5p: Params = {
        "embed": a(embed_name),
        "rel_bias": a(te + "block.0.layer.0.SelfAttention"
                      ".relative_attention_bias.weight"),
        "final_ln": a(te + "final_layer_norm.weight"),
        "layers": [],
    }
    for i in range(t5.n_layers):
        b = f"{te}block.{i}.layer."
        t5p["layers"].append({
            "ln1": a(b + "0.layer_norm.weight"),
            "wq": t(b + "0.SelfAttention.q.weight"),
            "wk": t(b + "0.SelfAttention.k.weight"),
            "wv": t(b + "0.SelfAttention.v.weight"),
            "wo": t(b + "0.SelfAttention.o.weight"),
            "ln2": a(b + "1.layer_norm.weight"),
            "wi": t(b + "1.DenseReluDense.wi.weight"),
            "wo_ff": t(b + "1.DenseReluDense.wo.weight"),
        })

    dec = MgDecSpec(
        vocab_size=int(dcfg["vocab_size"]),
        d_model=int(dcfg["hidden_size"]),
        n_layers=int(dcfg["num_hidden_layers"]),
        n_heads=int(dcfg["num_attention_heads"]),
        d_ff=int(dcfg["ffn_dim"]),
        n_codebooks=int(dcfg["num_codebooks"]),
        pad_token=int(dcfg.get("pad_token_id") or dcfg["vocab_size"]),
        scale_embedding=bool(dcfg.get("scale_embedding", False)),
    )
    dd = "decoder.model.decoder."
    dp: Params = {
        "embed": [a(f"{dd}embed_tokens.{cb}.weight")
                  for cb in range(dec.n_codebooks)],
        "final_ln_w": a(dd + "layer_norm.weight"),
        "final_ln_b": a(dd + "layer_norm.bias"),
        "heads": [t(f"decoder.lm_heads.{cb}.weight")
                  for cb in range(dec.n_codebooks)],
        "layers": [],
    }
    if "enc_to_dec_proj.weight" in nameset:
        dp["enc_proj_w"] = t("enc_to_dec_proj.weight")
        dp["enc_proj_b"] = a("enc_to_dec_proj.bias")
    for i in range(dec.n_layers):
        b = f"{dd}layers.{i}."
        layer = {}
        for key, name in (("ln1", "self_attn_layer_norm"),
                          ("ln2", "encoder_attn_layer_norm"),
                          ("ln3", "final_layer_norm")):
            layer[key + "_w"] = a(b + name + ".weight")
            layer[key + "_b"] = a(b + name + ".bias")
        for pre, mod in (("self_", "self_attn"), ("cross_", "encoder_attn")):
            for w, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                            ("wv", "v_proj"), ("wo", "out_proj")):
                layer[pre + w] = t(f"{b}{mod}.{proj}.weight")
        layer["fc1_w"] = t(b + "fc1.weight")
        layer["fc1_b"] = (a(b + "fc1.bias") if b + "fc1.bias" in nameset
                          else np.zeros((dec.d_ff,), np.float32))
        layer["fc2_w"] = t(b + "fc2.weight")
        layer["fc2_b"] = (a(b + "fc2.bias") if b + "fc2.bias" in nameset
                          else np.zeros((dec.d_model,), np.float32))
        dp["layers"].append(layer)

    ratios = tuple(acfg.get("upsampling_ratios") or (8, 5, 4, 2))
    enc = EncodecSpec(
        n_filters=int(acfg.get("num_filters") or 32),
        hidden=int(acfg.get("hidden_size") or 128),
        upsample_ratios=ratios,
        n_residual=int(acfg.get("num_residual_layers") or 1),
        lstm_layers=int(acfg.get("num_lstm_layers") or 2),
        kernel=int(acfg.get("kernel_size") or 7),
        last_kernel=int(acfg.get("last_kernel_size") or 7),
        residual_kernel=int(acfg.get("residual_kernel_size") or 3),
        causal=bool(acfg.get("use_causal_conv", True)),
        trim_right_ratio=float(acfg.get("trim_right_ratio", 1.0)),
        pad_mode=str(acfg.get("pad_mode") or "reflect"),
    )
    ad = "audio_encoder.decoder.layers."
    n_q = len([n for n in names
               if n.startswith("audio_encoder.quantizer.layers.")
               and n.endswith("codebook.embed")])
    ep: Params = {
        "codebooks": np.stack([
            a(f"audio_encoder.quantizer.layers.{i}.codebook.embed")
            for i in range(n_q)]),
        "conv_in_w": _wn(get, nameset, ad + "0.conv"),
        "conv_in_b": a(ad + "0.conv.bias"),
        "lstm": {}, "ups": [],
    }
    for i in range(enc.lstm_layers):
        for key, name in (("wi", "weight_ih"), ("wh", "weight_hh"),
                          ("bi", "bias_ih"), ("bh", "bias_hh")):
            ep["lstm"][f"{key}{i}"] = a(f"{ad}1.lstm.{name}_l{i}")
    # the decoder's module list: [conv, lstm, (elu, convtr, res...) per
    # ratio, elu, conv_out]
    li = 2
    for _ in ratios:
        li += 1  # the ELU
        up = {"w": _wn(get, nameset, f"{ad}{li}.conv"),
              "b": a(f"{ad}{li}.conv.bias"), "res": []}
        li += 1
        for _ in range(enc.n_residual):
            rb = f"{ad}{li}."
            up["res"].append({
                "c1_w": _wn(get, nameset, rb + "block.1.conv"),
                "c1_b": a(rb + "block.1.conv.bias"),
                "c2_w": _wn(get, nameset, rb + "block.3.conv"),
                "c2_b": a(rb + "block.3.conv.bias"),
                "sc_w": _wn(get, nameset, rb + "shortcut.conv"),
                "sc_b": a(rb + "shortcut.conv.bias"),
            })
            li += 1
        ep["ups"].append(up)
    li += 1  # the final ELU
    ep["conv_out_w"] = _wn(get, nameset, f"{ad}{li}.conv")
    ep["conv_out_b"] = a(f"{ad}{li}.conv.bias")

    meta = {
        "sampling_rate": int(acfg.get("sampling_rate") or 32000),
        "frame_rate": int(acfg.get("frame_rate")
                          or (acfg.get("sampling_rate") or 32000)
                          // int(np.prod(ratios))),
        "decoder_start": int(config.get("decoder_start_token_id")
                             or dec.pad_token),
    }
    return (t5, params_from_numpy(t5p, dev), dec, params_from_numpy(dp, dev),
            enc, params_from_numpy(ep, dev), meta)


def from_jax_params(bundle, device: Any = None):
    """The JAX module's seven-part bundle (numpy leaves in its trees) ->
    the port's on ``device``: the specs carried field for field, the
    trees leaf by leaf."""
    dev = resolve(device)
    t5, t5p, dec, dp, enc, ep, meta = bundle
    return (T5Spec(**vars(t5)), params_from_numpy(t5p, dev),
            MgDecSpec(**vars(dec)), params_from_numpy(dp, dev),
            EncodecSpec(**vars(enc)), params_from_numpy(ep, dev), dict(meta))


# ------------------------------------------------------------- generation


def delay_pattern(nb: int, max_new_tokens: int) -> np.ndarray:
    """Where each codebook's frames sit, [nb, T_total] bool: HF
    max_length = 1 (bos) + max_new_tokens; the staircase eats nb - 1 of
    those, leaving max_new_tokens + 1 - nb frames per codebook."""
    T_total = max_new_tokens + 1
    n_frames = T_total - nb
    valid = np.zeros((nb, T_total), bool)
    for k in range(nb):
        valid[k, k + 1: k + 1 + n_frames] = True
    return valid


def encode_text(bundle, text_ids, guidance_scale: float) -> torch.Tensor:
    """The T5 states (through ``enc_to_dec_proj`` when the checkpoint has
    it), doubled with zeroed rows under guidance."""
    t5, t5p, _, dp, _, _, _ = bundle
    ids = torch.as_tensor(np.asarray(text_ids, np.int64),
                          device=t5p["embed"].device)[None]
    enc = t5_encode(t5, t5p, ids)
    if "enc_proj_w" in dp:
        enc = enc @ dp["enc_proj_w"] + dp["enc_proj_b"]
    if guidance_scale != 1.0:
        enc = torch.cat([enc, torch.zeros_like(enc)], 0)
    return enc


def sample_codes(lg: np.ndarray, rng, do_sample: bool, temperature: float,
                 top_k: int) -> np.ndarray:
    """One step's next codes [nb] from its host logits [nb, V] (the JAX
    module's numpy sampling, unchanged)."""
    if not do_sample:
        return lg.argmax(-1).astype(np.int32)
    nxt = []
    for cb in range(lg.shape[0]):
        row = lg[cb] / max(temperature, 1e-5)
        k_eff = min(top_k, len(row)) if top_k > 0 else 0
        if 0 < k_eff < len(row):
            kth = np.partition(row, -k_eff)[-k_eff]
            row = np.where(row < kth, -1e30, row)
        prob = np.exp(row - row.max())
        prob /= prob.sum()
        nxt.append(rng.choice(len(row), p=prob))
    return np.asarray(nxt, np.int32)


def mg_codes(bundle, text_ids, max_new_tokens: int = 128,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 250, guidance_scale: float = 1.0,
             seed: int = 0) -> np.ndarray:
    """The decoder's frames [nb, n_frames] (the staircase stripped) for
    ``text_ids``: greedy follows HF generate; sampling takes top-k of each
    codebook's guided logits with ``np.random.default_rng(seed)``."""
    _, _, dec, dp, _, _, meta = bundle
    nb = dec.n_codebooks
    pad = dec.pad_token
    rng = np.random.default_rng(seed)
    with torch.inference_mode(), f32_products():
        enc = encode_text(bundle, text_ids, guidance_scale)
        B = enc.shape[0]
        valid = delay_pattern(nb, max_new_tokens)
        pattern_mask = np.where(valid, -1, pad)
        T_total = valid.shape[1]
        codes = np.full((nb, T_total), meta["decoder_start"], np.int32)
        cross = mg_cross_kv(dp, enc)
        shape = (len(dp["layers"]), B, T_total, dec.d_model)
        cache_k = enc.new_zeros(shape)
        cache_v = enc.new_zeros(shape)
        for step in range(1, T_total):
            cur = np.where(pattern_mask[:, step - 1] == -1,
                           codes[:, step - 1], pattern_mask[:, step - 1])
            frame = torch.as_tensor(np.repeat(cur[None], B, 0),
                                    dtype=torch.long, device=enc.device)
            lg = mg_step(dec, dp, frame, cross, cache_k, cache_v,
                         step - 1).float().cpu().numpy()
            lg = (lg[1] + guidance_scale * (lg[0] - lg[1])
                  if guidance_scale != 1.0 else lg[0])
            codes[:, step] = sample_codes(lg, rng, do_sample, temperature,
                                          top_k)
    out = np.where(pattern_mask == -1, codes, pattern_mask)
    return out[valid].reshape(nb, -1)


def decode_frames(bundle, frames: np.ndarray) -> np.ndarray:
    """Frames [nb, n] -> waveform [n * prod(ratios)] f32 on the host."""
    _, _, _, _, enc, ep, _ = bundle
    with torch.inference_mode(), f32_products():
        codes = torch.as_tensor(np.asarray(frames, np.int64),
                                device=ep["codebooks"].device)[:, None, :]
        return encodec_decode(enc, ep, codes)[0].cpu().numpy()


def mg_generate(bundle, text_ids, max_new_tokens: int = 128,
                do_sample: bool = False, temperature: float = 1.0,
                top_k: int = 250, guidance_scale: float = 1.0,
                seed: int = 0) -> np.ndarray:
    """Text ids -> waveform (``mg_codes`` then ``decode_frames``)."""
    return decode_frames(bundle, mg_codes(
        bundle, text_ids, max_new_tokens, do_sample, temperature, top_k,
        guidance_scale, seed))
