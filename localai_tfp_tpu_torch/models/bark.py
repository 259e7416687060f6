"""Bark-class text-to-audio in PyTorch: the port's counterpart of
localai_tfp_tpu/models/bark.py (suno/bark architecture, HF layout; ref:
backend/python/bark/backend.py).

Three GPT stages, then EnCodec: semantic (text tokens -> semantic
tokens), coarse (semantic -> the first two EnCodec codebooks,
interleaved), fine (non-causal infill of the remaining codebooks over one
window); the codes decode through ``models/encodec.py``'s causal 24 kHz
decoder (the JAX module's decoder half, already ported).

The trees are the JAX module's (``load_bark_gpt``: per-layer weights
stacked on a leading ``[L, ...]`` axis, projections ``[in, out]``), so
``from_jax_params`` is a per-leaf copy. Each JAX step recomputes the last
logits of ``ids[-block_size:]`` (right-padded to a bucket the causal mask
hides). The port computes the same function with a KV cache while the
sequence fits in the window; once it passes ``block_size`` every position
shifts, so each further step is a fresh forward over the new window.

Sampling is ``argmax(logits / t + g)`` with ``g`` Gumbel noise, which is
what ``jax.random.categorical`` computes: ``generate`` takes the draws of
each stage (``noise``) so that a caller can feed it the JAX key chain's,
and otherwise draws them from a ``torch.Generator`` seeded from ``seed``.
Everything runs in f32 on the tree's device, TF32 off.

As in the JAX module, ``generate`` byte-maps the text
(``b % 1000``): ``BarkTTS.load`` there builds a tokenizer from the
directory's ``tokenizer.json`` or ``vocab.txt`` and never passes it on,
so no directory's tokenizer is read here either (ROADMAP §C 17).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products, resolve
from .convert import params_from_numpy
from .encodec import encodec_decode, load_encodec_decoder

# bark generation constants (suno convention, also the HF generation
# config defaults)
TEXT_ENCODING_OFFSET = 10_048
TEXT_PAD_TOKEN = 129_595
SEMANTIC_PAD_TOKEN = 10_000
SEMANTIC_INFER_TOKEN = 129_599
SEMANTIC_VOCAB_SIZE = 10_000
SEMANTIC_RATE_HZ = 49.9
COARSE_RATE_HZ = 75.0
CODEBOOK_SIZE = 1024
N_COARSE_CODEBOOKS = 2
COARSE_SEMANTIC_PAD_TOKEN = 12_048
COARSE_INFER_TOKEN = 12_050


@dataclass(frozen=True)
class BarkGPTSpec:
    hidden_size: int
    n_layers: int
    n_heads: int
    block_size: int
    bias: bool = False
    n_codes_total: int = 0  # >0 => fine model (multi-embed, non-causal)
    n_codes_given: int = 1  # fine: heads[i] predicts codebook
    # i + n_codes_given (HF tying: lm_heads[i] == input_embeds[i+1])


def load_bark_gpt(sd: dict, prefix: str, spec: BarkGPTSpec,
                  device: Any = None) -> dict:
    """The JAX module's stacked tree on ``device`` from an HF Bark state
    dict (numpy or torch values), f32."""
    dev = resolve(device)

    def get(name):
        return torch.as_tensor(sd[prefix + name]).float()

    def put(t):
        return t.contiguous().to(dev)

    def stack(fmt, transpose=False):
        rows = [get(fmt.format(i=i)) for i in range(spec.n_layers)]
        return put(torch.stack([r.T if transpose else r for r in rows]))

    p: dict = {
        "pos": put(get("position_embeds_layer.weight")),
        "ln1_w": stack("layers.{i}.layernorm_1.weight"),
        "ln2_w": stack("layers.{i}.layernorm_2.weight"),
        "att_proj": stack("layers.{i}.attn.att_proj.weight", True),
        "att_out": stack("layers.{i}.attn.out_proj.weight", True),
        "mlp_in": stack("layers.{i}.mlp.in_proj.weight", True),
        "mlp_out": stack("layers.{i}.mlp.out_proj.weight", True),
        "lnf_w": put(get("layernorm_final.weight")),
    }
    if spec.bias:
        for name, key in (("ln1_b", "layers.{i}.layernorm_1.bias"),
                          ("ln2_b", "layers.{i}.layernorm_2.bias"),
                          ("att_proj_b", "layers.{i}.attn.att_proj.bias"),
                          ("att_out_b", "layers.{i}.attn.out_proj.bias"),
                          ("mlp_in_b", "layers.{i}.mlp.in_proj.bias"),
                          ("mlp_out_b", "layers.{i}.mlp.out_proj.bias")):
            p[name] = stack(key)
        p["lnf_b"] = put(get("layernorm_final.bias"))
    if spec.n_codes_total:
        p["embeds"] = put(torch.stack([
            get(f"input_embeds_layers.{i}.weight")
            for i in range(spec.n_codes_total)]))
        n_heads = spec.n_codes_total - spec.n_codes_given
        # checkpoints drop the tied heads: lm_heads[i].weight ==
        # input_embeds_layers[i + n_codes_given].weight (HF
        # BarkFineModel._tie_weights)
        name = ("lm_heads.{i}.weight" if prefix + "lm_heads.0.weight" in sd
                else "input_embeds_layers.{j}.weight")
        p["heads"] = put(torch.stack([
            get(name.format(i=i, j=i + spec.n_codes_given)).T
            for i in range(n_heads)]))
    else:
        p["embed"] = put(get("input_embeds_layer.weight"))
        p["head"] = put(get("lm_head.weight").T)
    return p


def from_jax_params(tree: dict, device: Any = None) -> dict:
    """One of the JAX module's GPT trees (numpy leaves) -> the port's on
    ``device``, key for key."""
    return params_from_numpy(tree, resolve(device))


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def new_cache(spec: BarkGPTSpec, p: dict) -> list:
    """Per-layer (K, V) buffers [1, heads, block_size, dh] for
    ``bark_gpt_hidden``."""
    dh = spec.hidden_size // spec.n_heads
    shape = (1, spec.n_heads, spec.block_size, dh)
    dev = p["pos"].device
    return [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
            for _ in range(spec.n_layers)]


def bark_gpt_hidden(spec: BarkGPTSpec, p: dict, x: torch.Tensor,
                    cache: Optional[list] = None,
                    start: int = 0) -> torch.Tensor:
    """Embedded input [B, T, H] at positions [start, start + T) -> final
    hidden [B, T, H] (pre-head). With ``cache`` (``new_cache``), the new
    keys and values are written at those positions and the queries attend
    to every position before theirs; without, the span attends to itself
    (causal for the causal stages, full for the fine stage)."""
    B, T, H = x.shape
    nh = spec.n_heads
    dh = H // nh
    x = x + p["pos"][start:start + T]
    causal = spec.n_codes_total == 0
    mask = None
    if causal and T > 1:
        i = torch.arange(T, device=x.device)
        mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e9)
    bias = spec.bias
    for li in range(spec.n_layers):
        h = _ln(x, p["ln1_w"][li], p["ln1_b"][li] if bias else None)
        qkv = h @ p["att_proj"][li]
        if bias:
            qkv = qkv + p["att_proj_b"][li]
        q, k, v = (t.reshape(B, T, nh, dh).transpose(1, 2)
                   for t in qkv.split(H, dim=-1))
        if cache is not None:
            kc, vc = cache[li]
            kc[:, :, start:start + T] = k
            vc[:, :, start:start + T] = v
            k, v = kc[:, :, :start + T], vc[:, :, :start + T]
        logits = q @ k.transpose(-1, -2) / math.sqrt(dh)
        if mask is not None:
            logits[..., start:] += mask
        attn = torch.softmax(logits, -1) @ v
        attn = attn.transpose(1, 2).reshape(B, T, H) @ p["att_out"][li]
        if bias:
            attn = attn + p["att_out_b"][li]
        x = x + attn
        h = _ln(x, p["ln2_w"][li], p["ln2_b"][li] if bias else None)
        h = h @ p["mlp_in"][li]
        if bias:
            h = h + p["mlp_in_b"][li]
        h = F.gelu(h) @ p["mlp_out"][li]
        if bias:
            h = h + p["mlp_out_b"][li]
        x = x + h
    return _ln(x, p["lnf_w"], p["lnf_b"] if bias else None)


def bark_causal_logits(spec: BarkGPTSpec, p: dict,
                       ids: torch.Tensor) -> torch.Tensor:
    """ids [B, T] -> logits [B, T, out_vocab] (semantic/coarse stages)."""
    return bark_gpt_hidden(spec, p, p["embed"][ids]) @ p["head"]


def bark_fine_logits(spec: BarkGPTSpec, p: dict, codes: torch.Tensor,
                     pred_idx: int) -> torch.Tensor:
    """codes [B, T, n_codes_total] -> logits [B, T, vocab] for codebook
    ``pred_idx`` (HF convention: sum the input embeds of codebooks
    [0, pred_idx], non-causal attention)."""
    B, T, _ = codes.shape
    x = codes.new_zeros((B, T, spec.hidden_size), dtype=p["embeds"].dtype)
    for c in range(pred_idx + 1):
        x = x + p["embeds"][c][codes[:, :, c]]
    h = bark_gpt_hidden(spec, p, x)
    return h @ p["heads"][pred_idx - spec.n_codes_given]


def causal_loop(spec: BarkGPTSpec, p: dict, prompt, steps: int,
                pick: Callable[[int, torch.Tensor], Optional[int]]
                ) -> list[int]:
    """Autoregressive loop over a causal stage: ``pick(step, logits)``
    maps the last position's logits [out_vocab] to the next id (None
    ends the loop). The window is ``ids[-block_size:]``: a KV cache
    while the sequence fits in it, a fresh forward once it slides."""
    ids = [int(t) for t in prompt]
    dev = p["pos"].device
    cache = None
    out: list[int] = []
    for step in range(steps):
        n = len(ids)
        if n > spec.block_size:
            window = torch.tensor([ids[-spec.block_size:]], device=dev)
            h = bark_gpt_hidden(spec, p, p["embed"][window])
        elif cache is None:
            cache = new_cache(spec, p)
            h = bark_gpt_hidden(spec, p, p["embed"][
                torch.tensor([ids], device=dev)], cache)
        else:
            h = bark_gpt_hidden(spec, p, p["embed"][
                torch.tensor([ids[-1:]], device=dev)], cache, n - 1)
        tok = pick(step, h[0, -1] @ p["head"])
        if tok is None:
            break
        out.append(tok)
        ids.append(tok)
    return out


def _gumbel(gen: torch.Generator, n: int, dev) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


@dataclass
class BarkTTS:
    """Loaded bark pipeline. ``load`` expects an HF BarkModel checkpoint
    directory (config.json + safetensors/bin)."""

    semantic_spec: BarkGPTSpec
    semantic: dict
    coarse_spec: BarkGPTSpec
    coarse: dict
    fine_spec: BarkGPTSpec
    fine: dict
    codec: dict
    ratios: list[int]
    sample_rate: int

    @classmethod
    def load(cls, model_dir: str, device: Any = None) -> "BarkTTS":
        from .safetensors_io import SafeTensorsFile

        dev = resolve(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = json.load(f)
        sd: dict = {}
        for fname in sorted(os.listdir(model_dir)):
            path = os.path.join(model_dir, fname)
            if fname.endswith(".safetensors"):
                st = SafeTensorsFile(path)
                for key in st.keys():
                    sd[key] = st.get(key)
            elif fname.endswith(".bin") and "training" not in fname:
                sd.update(torch.load(path, map_location="cpu",
                                     weights_only=True))

        def gpt_spec(sub: str, fine: bool = False) -> BarkGPTSpec:
            c = cfg[sub]
            return BarkGPTSpec(
                hidden_size=int(c["hidden_size"]),
                n_layers=int(c.get("num_layers", 2)),
                n_heads=int(c.get("num_heads", 2)),
                block_size=int(c.get("block_size", 1024)),
                bias=bool(c.get("bias", False)),
                n_codes_total=int(c.get("n_codes_total", 8)) if fine
                else 0,
                n_codes_given=int(c.get("n_codes_given", 1)),
            )

        sem = gpt_spec("semantic_config")
        coarse = gpt_spec("coarse_acoustics_config")
        fine = gpt_spec("fine_acoustics_config", fine=True)
        codec_cfg = cfg.get("codec_config", {})
        return cls(
            semantic_spec=sem,
            semantic=load_bark_gpt(sd, "semantic.", sem, dev),
            coarse_spec=coarse,
            coarse=load_bark_gpt(sd, "coarse_acoustics.", coarse, dev),
            fine_spec=fine,
            fine=load_bark_gpt(sd, "fine_acoustics.", fine, dev),
            codec=load_encodec_decoder(sd, "codec_model.", dev),
            ratios=list(codec_cfg.get("upsampling_ratios", [8, 5, 4, 2])),
            sample_rate=int(codec_cfg.get("sampling_rate", 24_000)),
        )

    # ------------------------------------------------------------ stages

    @property
    def device(self) -> torch.device:
        return self.semantic["pos"].device

    def _picker(self, temperature: float, noise, gen, lo: int, n: int,
                stop: Optional[int] = None):
        """``pick`` for ``causal_loop``: the band [lo, lo + n) (plus the
        stop token's logit as one more candidate), greedy or
        ``argmax(band / t + g)`` with ``g`` the step's row of ``noise``
        or a draw from ``gen``."""
        dev = self.device
        width = n + (stop is not None)
        if noise is not None:
            noise = torch.as_tensor(np.asarray(noise, np.float32),
                                    device=dev)

        def pick(step: int, full: torch.Tensor) -> Optional[int]:
            band = full[lo:lo + n]
            if stop is not None:
                # suno early-stop: the stop token's logit competes as an
                # extra candidate beyond the value band
                band = torch.cat([band, full[stop:stop + 1]])
            if temperature > 0:
                g = noise[step] if noise is not None else _gumbel(
                    gen, width, dev)
                band = band / temperature + g
            tok = int(torch.argmax(band))
            if stop is not None and tok == n:
                return None
            return tok + lo
        return pick

    def semantic_tokens(self, input_ids: list, *, temperature: float,
                        max_semantic: int, history: Optional[dict] = None,
                        noise=None, gen=None) -> list[int]:
        """The semantic stage in the suno prompt layout (text offset,
        pad, the history prompt, the infer token); never empty."""
        text = np.asarray([t + TEXT_ENCODING_OFFSET
                           for t in input_ids[:256]], np.int64)
        text = np.pad(text, (0, 256 - len(text)),
                      constant_values=TEXT_PAD_TOKEN)
        hist = (np.asarray(history["semantic_prompt"], np.int64)[-256:]
                if history else np.array([], np.int64))
        hist = np.pad(hist, (0, 256 - len(hist)),
                      constant_values=SEMANTIC_PAD_TOKEN)
        prompt = np.concatenate([text, hist, [SEMANTIC_INFER_TOKEN]])
        out = causal_loop(
            self.semantic_spec, self.semantic, prompt, max_semantic,
            self._picker(temperature, noise, gen, 0, SEMANTIC_VOCAB_SIZE,
                         stop=SEMANTIC_PAD_TOKEN))
        return out or [0]  # a degenerate immediate stop: one frame

    @staticmethod
    def n_coarse(n_semantic: int) -> int:
        """Coarse tokens for ``n_semantic`` semantic ones: 2 codebooks
        interleaved at the 75 / 49.9 rate ratio."""
        ratio = COARSE_RATE_HZ / SEMANTIC_RATE_HZ * N_COARSE_CODEBOOKS
        return int(round(n_semantic * ratio / N_COARSE_CODEBOOKS)
                   ) * N_COARSE_CODEBOOKS

    def coarse_tokens(self, semantic: list, *, temperature: float,
                      noise=None, gen=None) -> list[int]:
        """The coarse stage: even steps draw from codebook 0's band, odd
        ones from codebook 1's."""
        prompt = [*semantic, COARSE_SEMANTIC_PAD_TOKEN, COARSE_INFER_TOKEN]
        picks = [self._picker(temperature, noise, gen,
                              SEMANTIC_VOCAB_SIZE + cb * CODEBOOK_SIZE,
                              CODEBOOK_SIZE)
                 for cb in range(N_COARSE_CODEBOOKS)]
        return causal_loop(
            self.coarse_spec, self.coarse, prompt,
            self.n_coarse(len(semantic)),
            lambda step, full: picks[step % N_COARSE_CODEBOOKS](step, full))

    def fine_codes(self, coarse_flat: list) -> torch.Tensor:
        """Interleaved coarse tokens -> codes [T, n_codes_total] on the
        device: codebooks 2.. infilled greedily by the fine stage over one
        window."""
        n_total = self.fine_spec.n_codes_total
        T = max(len(coarse_flat) // N_COARSE_CODEBOOKS, 1)
        coarse = np.zeros((N_COARSE_CODEBOOKS, T), np.int64)
        for j, tok in enumerate(coarse_flat):
            cb = j % N_COARSE_CODEBOOKS
            coarse[cb, j // N_COARSE_CODEBOOKS] = \
                tok - SEMANTIC_VOCAB_SIZE - cb * CODEBOOK_SIZE
        codes = torch.zeros((1, T, n_total), dtype=torch.long,
                            device=self.device)
        codes[0, :, :N_COARSE_CODEBOOKS] = torch.from_numpy(coarse.T)
        for cb in range(N_COARSE_CODEBOOKS, n_total):
            logits = bark_fine_logits(self.fine_spec, self.fine, codes, cb)
            codes[0, :, cb] = logits[0, :, :CODEBOOK_SIZE].argmax(-1)
        return codes[0]

    def generate(self, text: str = "", input_ids: Optional[list] = None,
                 *, temperature: float = 0.7, max_semantic: int = 256,
                 seed: int = 0, history: Optional[dict] = None,
                 noise: Optional[dict] = None) -> np.ndarray:
        """text -> waveform [n] f32 on the host. ``history`` optionally
        carries a voice preset {semantic_prompt}; ``noise`` the Gumbel
        draws of each sampled stage ({"semantic": [steps, 10001],
        "coarse": [steps, 1024]}), else drawn from ``seed``."""
        if input_ids is None:
            input_ids = [b % 1000 for b in text.encode()]
        noise = noise or {}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode(), f32_products():
            semantic = self.semantic_tokens(
                input_ids, temperature=temperature,
                max_semantic=max_semantic, history=history,
                noise=noise.get("semantic"), gen=gen)
            flat = self.coarse_tokens(semantic, temperature=temperature,
                                      noise=noise.get("coarse"), gen=gen)
            codes = self.fine_codes(flat)
            return encodec_decode(self.codec, codes.T.cpu().numpy(),
                                  self.ratios)
