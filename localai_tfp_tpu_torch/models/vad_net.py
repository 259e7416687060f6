"""Learned voice-activity detection: the silero-class network in PyTorch.

Counterpart of localai_tfp_tpu/models/vad_net.py: a short-time-Fourier
front end (a fixed conv basis of sine/cosine filters over a reflect-padded
chunk), a small conv encoder with ReLU, an LSTM cell carrying the
streaming state across chunks, and a sigmoid head giving one speech
probability per chunk of ``CHUNK`` samples (``CONTEXT`` carried samples
prepended). Weights import from silero's torchscript archive
(``load_torchscript``) or any state dict with its key schema
(``load_state_dict``):

    _model.stft.forward_basis_buffer            [2*bins, 1, win]
    _model.encoder.{i}.reparam_conv.weight/bias [C_out, C_in, 3]
    _model.decoder.rnn.weight_ih/weight_hh      [4H, H]
    _model.decoder.rnn.bias_ih/bias_hh          [4H]
    _model.decoder.decoder.2.weight/bias        [1, H, 1]

Every convolution is one product over its windows (the STFT basis at
stride ``win // 2``; the encoder's k=3 ``"SAME"`` convs), in f32 with
TF32 off (``device.f32_products``). The LSTM gates are ordered i|f|g|o.

``speech_probs`` is the JAX algorithm: one chunk after another through
``vad_forward``. ``VADRunner`` serves: the per-chunk front end does not
depend on the LSTM state, so every chunk of an utterance goes through it
in one batched forward; only the LSTM cell and the head step in
sequence, ``BLOCK`` steps at a time, on a card one CUDA-graph replay a
block (captured at first use). The two give the same probabilities up to
the batched products' summation order. The DSP detector of
``workers/vad.py`` serves when no checkpoint is configured.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products

SAMPLE_RATE = 16000
CHUNK = 512  # samples per probability (silero 16k convention)
CONTEXT = 64  # carried samples prepended to each chunk
BLOCK = 64  # LSTM steps a replay


@dataclass
class VADParams:
    stft_basis: torch.Tensor  # [2*bins, win]
    enc_w: tuple  # per-layer [k, C_in, C_out]
    enc_b: tuple
    w_ih: torch.Tensor  # [H_in, 4H] (transposed for right-matmul)
    w_hh: torch.Tensor  # [H, 4H]
    b: torch.Tensor  # [4H] (bias_ih + bias_hh)
    head_w: torch.Tensor  # [H, 1]
    head_b: torch.Tensor  # [1]

    @property
    def hidden(self) -> int:
        return self.w_hh.shape[0]


def load_state_dict(sd: dict, device: Any = "cpu") -> VADParams:
    """Map a silero-schema state dict (torch tensors or numpy) to
    ``VADParams`` on ``device`` (f32)."""

    def t(x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.detach().to(device=device, dtype=torch.float32)

    pfx = "_model." if any(k.startswith("_model.") for k in sd) else ""
    basis = t(sd[f"{pfx}stft.forward_basis_buffer"])  # [2B, 1, win]
    enc_w, enc_b = [], []
    i = 0
    while f"{pfx}encoder.{i}.reparam_conv.weight" in sd:
        w = t(sd[f"{pfx}encoder.{i}.reparam_conv.weight"])  # [O, I, k]
        enc_w.append(w.permute(2, 1, 0).contiguous())  # [k, I, O]
        enc_b.append(t(sd[f"{pfx}encoder.{i}.reparam_conv.bias"]))
        i += 1
    if not enc_w:
        raise ValueError("no encoder conv layers found in state dict")
    return VADParams(
        stft_basis=basis[:, 0, :].contiguous(),
        enc_w=tuple(enc_w),
        enc_b=tuple(enc_b),
        w_ih=t(sd[f"{pfx}decoder.rnn.weight_ih"]).T.contiguous(),
        w_hh=t(sd[f"{pfx}decoder.rnn.weight_hh"]).T.contiguous(),
        b=(t(sd[f"{pfx}decoder.rnn.bias_ih"])
           + t(sd[f"{pfx}decoder.rnn.bias_hh"])),
        head_w=t(sd[f"{pfx}decoder.decoder.2.weight"])[0, :, 0][:, None]
        .contiguous(),
        head_b=t(sd[f"{pfx}decoder.decoder.2.bias"]),
    )


def load_torchscript(path: str, device: Any = "cpu") -> VADParams:
    """Import from silero's distributed ``.jit`` archive."""
    mod = torch.jit.load(path, map_location="cpu")
    return load_state_dict(dict(mod.state_dict()), device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _stft_mag(basis: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [B, n] -> magnitude [B, bins, T]: reflect-pad then the conv
    basis (sine/cosine filters) at stride win//2, as silero's STFT
    module does."""
    win = basis.shape[-1]
    hop = pad = win // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    out = x.unfold(-1, win, hop) @ basis.T  # [B, T, 2bins]
    out = out.transpose(1, 2)
    bins = out.shape[1] // 2
    return torch.sqrt(out[:, :bins] ** 2 + out[:, bins:] ** 2 + 1e-12)


def _encoder(params: VADParams, x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C', T]: stacked k=3 ``"SAME"`` convs + ReLU."""
    h = x.transpose(1, 2)  # [B, T, C]
    for w, b in zip(params.enc_w, params.enc_b):
        k, cin, cout = w.shape
        lo = (k - 1) // 2
        win = F.pad(h, (0, 0, lo, k - 1 - lo)).unfold(1, k, 1)  # [B,T,C,k]
        win = win.transpose(-1, -2).reshape(h.shape[0], h.shape[1], k * cin)
        h = torch.relu(win @ w.reshape(k * cin, cout) + b)
    return h.transpose(1, 2)


def features(params: VADParams, chunks: torch.Tensor) -> torch.Tensor:
    """chunks [B, CONTEXT+CHUNK] -> the LSTM's input [B, H_in]: the
    front end and the encoder, pooled over the chunk's frames."""
    return _encoder(params, _stft_mag(params.stft_basis, chunks)).mean(-1)


def _lstm_cell(params: VADParams, x: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """torch LSTMCell semantics: gates ordered i | f | g | o."""
    gates = x @ params.w_ih + h @ params.w_hh + params.b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _head(params: VADParams, h: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(torch.relu(h) @ params.head_w + params.head_b)[:, 0]


def vad_forward(params: VADParams, chunk: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming step. chunk [B, CONTEXT+CHUNK] f32 in [-1, 1];
    h/c [B, H] LSTM state. Returns (prob [B], h, c)."""
    with f32_products():
        h, c = _lstm_cell(params, features(params, chunk), h, c)
        return _head(params, h), h, c


def init_state(batch: int, hidden: int, device: Any = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros((batch, hidden), dtype=torch.float32, device=device)
    return z, z.clone()


def chunk_windows(audio: np.ndarray) -> np.ndarray:
    """audio [n] -> [ceil(n/CHUNK), CONTEXT+CHUNK]: each chunk with the
    ``CONTEXT`` samples before it (zeros before the first)."""
    n = len(audio)
    n_chunks = max((n + CHUNK - 1) // CHUNK, 1)
    padded = np.zeros(n_chunks * CHUNK + CONTEXT, np.float32)
    padded[CONTEXT:CONTEXT + n] = audio
    idx = (np.arange(n_chunks)[:, None] * CHUNK
           + np.arange(CHUNK + CONTEXT)[None, :])
    return padded[idx]


@torch.inference_mode()
def speech_probs(params: VADParams, audio: np.ndarray) -> np.ndarray:
    """The plain version: audio [n] f32 -> per-chunk probabilities
    [ceil(n/CHUNK)], one chunk after another with the streaming state."""
    dev = params.w_hh.device
    chunks = torch.from_numpy(chunk_windows(audio)).to(dev)
    h, c = init_state(1, params.hidden, dev)
    probs = []
    for i in range(chunks.shape[0]):
        p, h, c = vad_forward(params, chunks[i:i + 1], h, c)
        probs.append(p[0])
    return torch.stack(probs).cpu().numpy()


class VADRunner:
    """The served VAD of one model: the front end over every chunk at
    once, then the LSTM and head ``BLOCK`` steps a replay of one graph
    over static buffers (the block's inputs, the carried state, its
    probabilities). On the CPU, or with ``eager`` set, the block body
    runs as it is. One utterance at a time."""

    def __init__(self, params: VADParams, device: Any,
                 eager: bool = False) -> None:
        self.params = params
        self.device = dev = torch.device(device)
        H_in = params.w_ih.shape[0]
        self.x = torch.zeros((BLOCK, H_in), dtype=torch.float32, device=dev)
        self.h, self.c = init_state(1, params.hidden, dev)
        self.probs = torch.zeros(BLOCK, dtype=torch.float32, device=dev)
        self.graph: Any = None
        self.eager = eager or dev.type != "cuda"
        self.replays = 0
        self._lock = threading.Lock()

    def _block_body(self) -> None:
        p = self.params
        h, c = self.h, self.c
        for i in range(BLOCK):
            h, c = _lstm_cell(p, self.x[i:i + 1], h, c)
            self.probs[i:i + 1].copy_(_head(p, h))
        self.h.copy_(h)
        self.c.copy_(c)

    def capture(self) -> None:
        if self.eager or self.graph is not None:
            return
        dev = self.device
        s = torch.cuda.Stream(dev)
        with torch.inference_mode(), f32_products():
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                self._block_body()
            torch.cuda.current_stream(dev).wait_stream(s)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s,
                                  capture_error_mode="thread_local"):
                self._block_body()
        self.graph = g

    def _run_block(self) -> None:
        if self.eager or self.graph is None:
            with f32_products():
                self._block_body()
        else:
            self.graph.replay()
            self.replays += 1

    @torch.inference_mode()
    def probabilities(self, audio: np.ndarray) -> np.ndarray:
        """audio [n] f32 -> per-chunk probabilities [ceil(n/CHUNK)], the
        streaming state starting at zero."""
        with self._lock:
            self.capture()
            chunks = torch.from_numpy(chunk_windows(audio)).to(self.device)
            with f32_products():
                feats = features(self.params, chunks)
            n = feats.shape[0]
            out = torch.empty(n, dtype=torch.float32, device=self.device)
            self.h.zero_()
            self.c.zero_()
            for s in range(0, n, BLOCK):
                m = min(BLOCK, n - s)
                self.x[:m].copy_(feats[s:s + m])
                if m < BLOCK:
                    self.x[m:].zero_()
                self._run_block()
                out[s:s + m].copy_(self.probs[:m])
            return out.cpu().numpy()


def probs_to_segments(
    probs: np.ndarray,
    *,
    threshold: float = 0.5,
    neg_threshold: Optional[float] = None,
    min_speech_s: float = 0.25,
    min_silence_s: float = 0.1,
    pad_s: float = 0.03,
    chunk_s: float = CHUNK / SAMPLE_RATE,
) -> list[tuple[float, float]]:
    """Hysteresis segmentation over per-chunk probabilities (the silero
    utils_vad convention: enter at ``threshold``, leave only below
    ``neg_threshold``, drop short speech, bridge short silence, pad)."""
    # silero utils_vad convention: exit threshold floored so low entry
    # thresholds still allow segments to close
    neg = (neg_threshold if neg_threshold is not None
           else max(threshold - 0.15, 0.01))
    segs: list[list[float]] = []
    active = False
    start = 0.0
    silence = 0.0
    for i, p in enumerate(probs):
        t = i * chunk_s
        if not active and p >= threshold:
            active, start = True, t
            silence = 0.0
        elif active:
            if p < neg:
                silence += chunk_s
                if silence >= min_silence_s:
                    segs.append([start, t - silence + chunk_s])
                    active = False
            else:
                silence = 0.0
    if active:
        segs.append([start, len(probs) * chunk_s])
    out = []
    for s, e in segs:
        if e - s >= min_speech_s:
            out.append((max(0.0, s - pad_s), e + pad_s))
    return out
