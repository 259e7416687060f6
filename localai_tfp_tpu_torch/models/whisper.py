"""Whisper (speech-to-text encoder-decoder) in PyTorch.

Counterpart of localai_tfp_tpu/models/whisper.py, the model behind
``POST /v1/audio/transcriptions`` (``workers/whisper.py``). The parameter
tree is the JAX package's (per-layer weights stacked on a leading
``[L, ...]`` axis, projections ``[in, out]``, convolutions ``[k, in,
out]``), so both packages compute the same thing on the same weights
(``models/convert.py::params_from_numpy``). The log-mel front end
is host numpy in both packages, copied as it is.

The JAX package's quirks are kept, not "fixed":

- GELU is the tanh approximation (``jax.nn.gelu``'s default), not HF's
  exact erf;
- both convolutions are ``"SAME"``-padded as XLA pads them: at 3000
  frames the stride-2 ``conv2`` pads 0 frames on the left and 1 on the
  right (``_same``); each convolution is one product over its windows,
  so TF32 is off for it as for every other product;
- attention logits and the tied head are f32 products; the worker
  serves f32 weights, and every forward here runs with TF32 off
  (``device.f32_products``);
- token ids outside the vocabulary are clamped into it, as a JAX gather
  clamps them (a checkpoint whose vocabulary is smaller than Whisper's
  special ids still decodes).

Two greedy decoders:

- ``greedy_transcribe`` is the JAX algorithm literally: the whole
  decoder re-run over the ``[P + max_new]`` buffer at every step, the
  argmax over the whole vocabulary (no suppressed tokens), eot after
  eot. It is the plain version the served decoder is held against.
- ``WhisperRunner`` serves: the cross-attention K/V computed once per
  30 s chunk with the encoder, a self-attention K/V cache in static
  buffers of ``max_target`` positions, one token a step. In exact
  arithmetic it gives the same logits. On a card the encoder (its input
  always ``[1, 80, 3000]``) is one CUDA-graph replay a chunk and each
  decode step one replay of another graph (captured at load, in a pool
  of their own, ``pool_bytes``); the picked tokens stay on the card and
  the host reads them every ``READ_EVERY`` tokens, as
  ``models/recurrent.py::StepRunner`` does. Run eagerly beside a busy
  engine, each of a step's ~1000 ops would wait for the interpreter
  lock the engine's thread holds.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products

# audio front-end constants (whisper convention)
SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_S = 30
N_FRAMES = CHUNK_S * SAMPLE_RATE // HOP  # 3000
READ_EVERY = 32  # tokens between two host reads of the picked tokens
NEG_INF = -1e30

WhisperParams = dict[str, Any]


@dataclass(frozen=True, eq=False)
class WhisperSpec:
    vocab_size: int = 51865
    d_model: int = 384
    n_audio_layers: int = 4
    n_text_layers: int = 4
    n_heads: int = 6
    d_ff: int = 1536
    max_source: int = N_FRAMES // 2  # after stride-2 conv
    max_target: int = 448
    norm_eps: float = 1e-5
    # special ids (HF whisper tokenizer defaults)
    sot: int = 50258
    eot: int = 50257
    no_timestamps: int = 50363
    timestamp_begin: int = 50364
    lang_base: int = 50259  # <|en|>
    task_transcribe: int = 50359
    task_translate: int = 50358

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def spec_from_hf_config(cfg: dict[str, Any]) -> WhisperSpec:
    """The JAX package's reading of an HF config: the heads and the MLP
    width are the encoder's, the special ids other than sot/eot the
    defaults."""
    return WhisperSpec(
        vocab_size=cfg.get("vocab_size", 51865),
        d_model=cfg.get("d_model", 384),
        n_audio_layers=cfg.get("encoder_layers", 4),
        n_text_layers=cfg.get("decoder_layers", 4),
        n_heads=cfg.get("encoder_attention_heads", 6),
        d_ff=cfg.get("encoder_ffn_dim", 1536),
        max_target=cfg.get("max_target_positions", 448),
        sot=cfg.get("decoder_start_token_id", 50258),
        eot=cfg.get("eos_token_id", 50257),
    )


def tiny_whisper_spec(**over: Any) -> WhisperSpec:
    kw: dict[str, Any] = dict(
        vocab_size=1000, d_model=64, n_audio_layers=2, n_text_layers=2,
        n_heads=4, d_ff=128, max_target=64,
        sot=997, eot=998, no_timestamps=999, timestamp_begin=999,
        lang_base=996, task_transcribe=995, task_translate=994,
    )
    kw.update(over)
    return WhisperSpec(**kw)


# ---------------------------------------------------------------------------
# audio front-end: log-mel spectrogram (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized mel filter matrix [n_mels, n_fft//2+1] (the
    librosa convention whisper's feature extractor uses)."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3.0 * f / 200.0
        log_region = f >= 1000.0
        mel = np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mel,
        )
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        weights[i] = np.maximum(0.0, np.minimum(up, down))
        weights[i] *= 2.0 / (hi - lo)  # slaney area norm
    return weights.astype(np.float32)


_MEL: Optional[np.ndarray] = None


def log_mel_spectrogram(audio: np.ndarray) -> np.ndarray:
    """float PCM [n] -> log-mel [N_MELS, N_FRAMES] for one 30s chunk
    (pad/trim), matching whisper's normalization."""
    global _MEL
    if _MEL is None:
        _MEL = mel_filterbank()
    n = CHUNK_S * SAMPLE_RATE
    a = np.zeros(n, np.float32)
    a[: min(len(audio), n)] = audio[:n]
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(
        np.pad(a, (N_FFT // 2, N_FFT // 2), mode="reflect"), N_FFT
    )[::HOP][:N_FRAMES]
    stft = np.fft.rfft(frames * window, axis=-1)
    power = np.abs(stft) ** 2
    mel = _MEL @ power.T  # [N_MELS, frames]
    logmel = np.log10(np.maximum(mel, 1e-10))
    logmel = np.maximum(logmel, logmel.max() - 8.0)
    return ((logmel + 4.0) / 4.0).astype(np.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    """LayerNorm in f32 over the population variance (one kernel)."""
    return F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(),
                        eps).to(x.dtype)


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """``x @ w + b`` as one product with the bias in its epilogue."""
    out = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x [B, T, C] -> the windows of a ``"SAME"`` convolution [B, T_out,
    k*C] in ``(k, C)`` order (the JAX ``[k, in, out]`` kernel reshaped to
    ``[k*in, out]`` multiplies them). XLA pads ``total // 2`` on the left
    and the rest on the right."""
    n = x.shape[1]
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    x = F.pad(x, (0, 0, total // 2, total - total // 2))
    win = x.unfold(1, k, stride)  # [B, T_out, C, k]
    return win.transpose(-1, -2).reshape(x.shape[0], out, -1)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int) -> torch.Tensor:
    k, cin, cout = w.shape
    return _affine(_same(x, k, stride), w.reshape(k * cin, cout), b)


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def _attend_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, H, Tq, Dh], k/v [B, H, Tk, Dh] -> [B, Tq, H*Dh]: f32
    logits, ``-1e30`` where ``mask`` is False, the probabilities cast to
    the values' dtype, an f32 product."""
    B, H, Tq, Dh = q.shape
    logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(Dh)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = probs.to(v.dtype).float() @ v.float()
    return out.transpose(1, 2).reshape(B, Tq, H * Dh).to(q.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, Tq, H, Dh], k/v [B, Tk, H, Dh] -> [B, Tq, H*Dh]."""
    return _attend_heads(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), mask)


def _mha(spec: WhisperSpec, lp: dict, q_in: torch.Tensor,
         kv_in: torch.Tensor, mask: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """The caller applies the pre-LN; whisper's k projection has no
    bias."""
    B, Tq, _ = q_in.shape
    Tk = kv_in.shape[1]
    H, Dh = spec.n_heads, spec.d_head
    q = _affine(q_in, lp["wq"], lp["bq"]).reshape(B, Tq, H, Dh)
    k = (kv_in @ lp["wk"]).reshape(B, Tk, H, Dh)
    v = _affine(kv_in, lp["wv"], lp["bv"]).reshape(B, Tk, H, Dh)
    return _affine(_attend(q, k, v, mask), lp["wo"], lp["bo"])


def _mlp(spec: WhisperSpec, m: dict, x: torch.Tensor) -> torch.Tensor:
    h = _ln(x, m["ln_w"], m["ln_b"], spec.norm_eps)
    return _affine(_gelu(_affine(h, m["w_up"], m["b_up"])), m["w_down"],
                   m["b_down"])


def _encode(spec: WhisperSpec, params: WhisperParams,
            mel: torch.Tensor) -> torch.Tensor:
    x = mel.transpose(1, 2).to(params["conv1_w"].dtype)  # [B, frames, mels]
    x = _gelu(_conv(x, params["conv1_w"], params["conv1_b"], 1))
    x = _gelu(_conv(x, params["conv2_w"], params["conv2_b"], 2))
    x = x + params["enc_pos"][None, : x.shape[1]]
    for i in range(spec.n_audio_layers):
        a = _layer(params["enc_attn"], i)
        h = _ln(x, a["ln_w"], a["ln_b"], spec.norm_eps)
        x = x + _mha(spec, a, h, h)
        x = x + _mlp(spec, _layer(params["enc_mlp"], i), x)
    return _ln(x, params["enc_ln_w"], params["enc_ln_b"], spec.norm_eps)


def encode_audio(spec: WhisperSpec, params: WhisperParams,
                 mel: torch.Tensor) -> torch.Tensor:
    """mel [B, N_MELS, N_FRAMES] -> encoder states [B, T_src, D]."""
    with f32_products():
        return _encode(spec, params, mel)


def _embed(spec: WhisperSpec, params: WhisperParams,
           tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings, ids clamped into the vocabulary (a JAX gather
    clamps an out-of-range index)."""
    return params["tok_emb"][tokens.clamp(0, spec.vocab_size - 1)]


def _head(params: WhisperParams, x: torch.Tensor) -> torch.Tensor:
    """The tied head, an f32 product."""
    return x.float() @ params["tok_emb"].float().T


def _decode_logits(spec: WhisperSpec, params: WhisperParams,
                   tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    B, T = tokens.shape
    x = _embed(spec, params, tokens) + params["dec_pos"][None, :T]
    pos = torch.arange(T, device=tokens.device)
    causal = (pos[:, None] >= pos[None, :])[None, None]
    for i in range(spec.n_text_layers):
        sa = _layer(params["dec_self"], i)
        ca = _layer(params["dec_cross"], i)
        h = _ln(x, sa["ln_w"], sa["ln_b"], spec.norm_eps)
        x = x + _mha(spec, sa, h, h, mask=causal)
        h = _ln(x, ca["ln_w"], ca["ln_b"], spec.norm_eps)
        x = x + _mha(spec, ca, h, enc)
        x = x + _mlp(spec, _layer(params["dec_mlp"], i), x)
    x = _ln(x, params["dec_ln_w"], params["dec_ln_b"], spec.norm_eps)
    return _head(params, x)


def decode_logits(spec: WhisperSpec, params: WhisperParams,
                  tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B, T] -> logits [B, T, V] (f32)."""
    with f32_products():
        return _decode_logits(spec, params, tokens, enc)


@torch.inference_mode()
def greedy_transcribe(spec: WhisperSpec, params: WhisperParams,
                      mel: torch.Tensor, max_new: int,
                      prompt: torch.Tensor) -> torch.Tensor:
    """The plain decoder, the JAX algorithm step for step: encode, then
    ``max_new`` greedy steps, each re-running the decoder over the whole
    ``[P + max_new]`` buffer and taking the argmax over the whole
    vocabulary at position ``P + i - 1``; eot after the first eot.
    prompt [P] -> [max_new] ids."""
    with f32_products():
        dev = mel.device
        prompt = prompt.to(dev, torch.long)
        P = prompt.shape[0]
        enc = _encode(spec, params, mel)
        buf = torch.full((1, P + max_new), spec.eot, dtype=torch.long,
                         device=dev)
        buf[0, :P] = prompt
        done = torch.zeros((), dtype=torch.bool, device=dev)
        eot = torch.tensor(spec.eot, device=dev)
        toks = []
        for i in range(max_new):
            logits = _decode_logits(spec, params, buf, enc)
            nxt = torch.argmax(logits[0, P + i - 1], -1)
            nxt = torch.where(done, eot, nxt)
            buf[0, P + i] = nxt
            done = done | (nxt == spec.eot)
            toks.append(nxt)
        return torch.stack(toks)


# ---------------------------------------------------------------------------
# served decoder
# ---------------------------------------------------------------------------


class WhisperRunner:
    """Static buffers and (on a card) the graphs of one model: ``encode``
    (the log-mel buffer to the encoder states and every decoder layer's
    cross-attention K/V), ``feed`` (the token at ``pos`` through the
    decoder with the self-attention cache, its logits) and ``decode``
    (the argmax of the logits, eot once eot was picked, written to output
    row ``at`` and fed). On the CPU, or with ``eager`` set, the bodies
    run as they are. One transcription at a time."""

    def __init__(self, spec: WhisperSpec, params: WhisperParams,
                 device: Any, eager: bool = False) -> None:
        self.spec, self.params = spec, params
        self.device = dev = torch.device(device)
        self.dtype = dt = params["tok_emb"].dtype
        S, T = spec.max_source, spec.max_target
        H, Dh, L = spec.n_heads, spec.d_head, spec.n_text_layers
        self.mel = torch.zeros((1, N_MELS, N_FRAMES), dtype=torch.float32,
                               device=dev)
        self.enc = torch.zeros((1, S, spec.d_model), dtype=dt, device=dev)
        # head-major K/V [L, 1, H, T, Dh]: a step's products read them
        # in place (no transpose copy)
        self.cross_k = torch.zeros((L, 1, H, S, Dh), dtype=dt, device=dev)
        self.cross_v = torch.zeros_like(self.cross_k)
        self.self_k = torch.zeros((L, 1, H, T, Dh), dtype=dt, device=dev)
        self.self_v = torch.zeros_like(self.self_k)
        self.key_pos = torch.arange(T, device=dev)
        self.tok = torch.zeros(1, dtype=torch.long, device=dev)
        self.pos = torch.zeros(1, dtype=torch.long, device=dev)
        self.logits = torch.zeros(spec.vocab_size, dtype=torch.float32,
                                  device=dev)
        self.done = torch.zeros(1, dtype=torch.bool, device=dev)
        self.eot = torch.full((1,), spec.eot, dtype=torch.long, device=dev)
        self.out = torch.zeros(READ_EVERY, dtype=torch.long, device=dev)
        self.at = torch.zeros(1, dtype=torch.long, device=dev)
        self._bodies = {"encode": self._encode_body,
                        "feed": self._feed_body,
                        "decode": self._decode_body}
        self.graphs: dict[str, Any] = {}
        self.pool_bytes = 0
        self.eager = eager or dev.type != "cuda"
        self.replays = 0
        self._stage: Optional[torch.Tensor] = None  # pinned mel staging
        self._lock = threading.Lock()

    # ---------------------------------------------------------- bodies

    def _encode_body(self) -> None:
        sp, p = self.spec, self.params
        enc = _encode(sp, p, self.mel)
        self.enc.copy_(enc)
        S, H, Dh = enc.shape[1], sp.n_heads, sp.d_head
        for i in range(sp.n_text_layers):
            ca = _layer(p["dec_cross"], i)
            self.cross_k[i].copy_((enc @ ca["wk"]).reshape(1, S, H, Dh)
                                  .transpose(1, 2))
            self.cross_v[i].copy_(_affine(enc, ca["wv"], ca["bv"])
                                  .reshape(1, S, H, Dh).transpose(1, 2))

    def _feed_body(self) -> None:
        sp, p = self.spec, self.params
        H, Dh = sp.n_heads, sp.d_head
        x = (_embed(sp, p, self.tok) + p["dec_pos"].index_select(
            0, self.pos))[None]  # [1, 1, D]
        mask = (self.key_pos <= self.pos)[None, None, None]  # [1,1,1,T]

        def heads(t: torch.Tensor) -> torch.Tensor:  # [1,1,D] -> [1,H,1,Dh]
            return t.reshape(1, 1, H, Dh).transpose(1, 2)

        for i in range(sp.n_text_layers):
            sa = _layer(p["dec_self"], i)
            ca = _layer(p["dec_cross"], i)
            h = _ln(x, sa["ln_w"], sa["ln_b"], sp.norm_eps)
            q = heads(_affine(h, sa["wq"], sa["bq"]))
            self.self_k[i].index_copy_(2, self.pos, heads(h @ sa["wk"]))
            self.self_v[i].index_copy_(
                2, self.pos, heads(_affine(h, sa["wv"], sa["bv"])))
            a = _attend_heads(q, self.self_k[i], self.self_v[i], mask)
            x = x + _affine(a, sa["wo"], sa["bo"])
            h = _ln(x, ca["ln_w"], ca["ln_b"], sp.norm_eps)
            q = heads(_affine(h, ca["wq"], ca["bq"]))
            a = _attend_heads(q, self.cross_k[i], self.cross_v[i], None)
            x = x + _affine(a, ca["wo"], ca["bo"])
            x = x + _mlp(sp, _layer(p["dec_mlp"], i), x)
        x = _ln(x, p["dec_ln_w"], p["dec_ln_b"], sp.norm_eps)
        self.logits.copy_(_head(p, x)[0, 0])
        self.pos.add_(1)

    def _decode_body(self) -> None:
        nxt = torch.argmax(self.logits).reshape(1)
        nxt = torch.where(self.done, self.eot, nxt)
        self.done.logical_or_(nxt == self.eot)
        self.tok.copy_(nxt)
        self.out.index_copy_(0, self.at, self.tok)
        self.at.add_(1)
        self._feed_body()

    def capture(self) -> None:
        """Capture the three bodies (a card, not ``eager``): each runs
        once on a side stream first, then is captured into a pool shared
        by the three; the buffers are reset after."""
        if self.eager or self.graphs:
            return
        dev = self.device
        s = torch.cuda.Stream(dev)
        pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode(), f32_products():
            for name, body in self._bodies.items():
                s.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(s):
                    body()
                torch.cuda.current_stream(dev).wait_stream(s)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool, stream=s,
                                      capture_error_mode="thread_local"):
                    body()
                self.graphs[name] = g
        torch.cuda.synchronize(dev)
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
        self._reset()

    def _run(self, name: str) -> None:
        g = None if self.eager else self.graphs.get(name)
        if g is None:
            with f32_products():
                self._bodies[name]()
        else:
            g.replay()
            self.replays += 1

    def _reset(self) -> None:
        self.pos.zero_()
        self.done.zero_()
        self.at.zero_()

    # ------------------------------------------------------- transcription

    @torch.inference_mode()
    def set_mel(self, mel: np.ndarray) -> None:
        """Copy one chunk's log-mel [N_MELS, N_FRAMES] into the static
        buffer (through pinned memory on a card)."""
        src = torch.from_numpy(np.ascontiguousarray(mel, np.float32))
        if self.device.type == "cuda":
            if self._stage is None:
                self._stage = torch.empty(src.shape, dtype=torch.float32,
                                          pin_memory=True)
            torch.cuda.current_stream(self.device).synchronize()
            self._stage.copy_(src)
            src = self._stage
        self.mel[0].copy_(src, non_blocking=True)

    @torch.inference_mode()
    def encode(self, mel: np.ndarray) -> torch.Tensor:
        """One chunk through the encoder: the states [1, T_src, D] (the
        static buffer; the cross-attention K/V are set too)."""
        with self._lock:
            self.capture()
            self.set_mel(mel)
            self._run("encode")
            return self.enc

    @torch.inference_mode()
    def transcribe(self, mel: np.ndarray, max_new: int,
                   prompt: list[int]) -> np.ndarray:
        """One chunk: encode, feed ``prompt``, pick up to ``max_new``
        tokens; [max_new] ids, eot after the first eot (the JAX
        ``greedy_transcribe``'s output)."""
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.spec.max_target:
            raise ValueError("prompt and max_new exceed max_target")
        with self._lock:
            self.capture()
            self.set_mel(mel)
            self._run("encode")
            self._reset()
            ids = torch.tensor(prompt, dtype=torch.long, device=self.device)
            for i in range(len(prompt)):
                self.tok.copy_(ids[i:i + 1])
                self._run("feed")
            toks: list[int] = []
            while len(toks) < max_new:
                n = min(READ_EVERY, max_new - len(toks))
                self.at.zero_()
                for _ in range(n):
                    self._run("decode")
                toks += self.out[:n].tolist()
                if self.spec.eot in toks:
                    break
        out = np.full(max_new, self.spec.eot, np.int64)
        out[: len(toks)] = toks[:max_new]
        return out


# ---------------------------------------------------------------------------
# HF checkpoint loading
# ---------------------------------------------------------------------------


def load_whisper_params(model_dir: str, dtype: torch.dtype = torch.float32,
                        device: Any = "cpu"
                        ) -> tuple[WhisperSpec, WhisperParams]:
    """An HF whisper checkpoint (``model.encoder.conv1...`` names, or the
    same without ``model.``) -> (spec, params on ``device``), each
    per-layer stack filled on the device one layer at a time."""
    from .hf_loader import load_hf_state

    config, get, names = load_hf_state(model_dir)
    spec = spec_from_hf_config(config)
    pre = "model." if "model.encoder.conv1.weight" in names else ""

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device).to(dtype).contiguous()

    def t(name: str) -> torch.Tensor:
        return get(name).T

    def stack(fmt: str, L: int, fn: Callable[[str], torch.Tensor]
              ) -> torch.Tensor:
        first = fn(fmt.format(i=0))
        out = torch.empty((L, *first.shape), dtype=dtype, device=device)
        for i in range(L):
            out[i].copy_(fn(fmt.format(i=i)) if i else first)
        return out

    La, Lt = spec.n_audio_layers, spec.n_text_layers

    def attn(base: str, L: int, kind: str) -> dict:
        ln = kind.replace("attn", "attn_layer_norm")
        f = base + "{i}." + kind
        return {
            "wq": stack(f + ".q_proj.weight", L, t),
            "bq": stack(f + ".q_proj.bias", L, get),
            "wk": stack(f + ".k_proj.weight", L, t),
            "wv": stack(f + ".v_proj.weight", L, t),
            "bv": stack(f + ".v_proj.bias", L, get),
            "wo": stack(f + ".out_proj.weight", L, t),
            "bo": stack(f + ".out_proj.bias", L, get),
            "ln_w": stack(base + "{i}." + ln + ".weight", L, get),
            "ln_b": stack(base + "{i}." + ln + ".bias", L, get),
        }

    def mlp(base: str, L: int) -> dict:
        return {
            "w_up": stack(base + "{i}.fc1.weight", L, t),
            "b_up": stack(base + "{i}.fc1.bias", L, get),
            "w_down": stack(base + "{i}.fc2.weight", L, t),
            "b_down": stack(base + "{i}.fc2.bias", L, get),
            "ln_w": stack(base + "{i}.final_layer_norm.weight", L, get),
            "ln_b": stack(base + "{i}.final_layer_norm.bias", L, get),
        }

    e = f"{pre}encoder.layers."
    d = f"{pre}decoder.layers."
    # conv weights: torch [out, in, k] -> [k, in, out]
    params: WhisperParams = {
        "conv1_w": cast(get(f"{pre}encoder.conv1.weight").permute(2, 1, 0)),
        "conv1_b": cast(get(f"{pre}encoder.conv1.bias")),
        "conv2_w": cast(get(f"{pre}encoder.conv2.weight").permute(2, 1, 0)),
        "conv2_b": cast(get(f"{pre}encoder.conv2.bias")),
        "enc_pos": cast(get(f"{pre}encoder.embed_positions.weight")),
        "enc_attn": attn(e, La, "self_attn"),
        "enc_mlp": mlp(e, La),
        "enc_ln_w": cast(get(f"{pre}encoder.layer_norm.weight")),
        "enc_ln_b": cast(get(f"{pre}encoder.layer_norm.bias")),
        "tok_emb": cast(get(f"{pre}decoder.embed_tokens.weight")),
        "dec_pos": cast(get(f"{pre}decoder.embed_positions.weight")),
        "dec_self": attn(d, Lt, "self_attn"),
        "dec_cross": attn(d, Lt, "encoder_attn"),
        "dec_mlp": mlp(d, Lt),
        "dec_ln_w": cast(get(f"{pre}decoder.layer_norm.weight")),
        "dec_ln_b": cast(get(f"{pre}decoder.layer_norm.bias")),
    }
    return spec, params


def param_bytes(params: WhisperParams) -> int:
    return sum(param_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in params.values())
