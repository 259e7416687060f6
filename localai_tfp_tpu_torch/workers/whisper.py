"""Whisper speech-to-text worker: the port's counterpart of
localai_tfp_tpu/workers/whisper.py, served at
``POST /v1/audio/transcriptions`` (ref: backend/go/transcribe/whisper,
backend/python/faster-whisper/backend.py; core/backend/transcript.go).

Audio intake is the JAX worker's: WAV is decoded here (the ``wave``
module; 8-bit unsigned, 16-, 24- and 32-bit samples, channels averaged,
resampled to 16 kHz by linear interpolation); any other format goes
through ``ffmpeg`` to 16 kHz mono f32 (ref: pkg/utils/ffmpeg.go:55), and
fails as the JAX worker fails where ``ffmpeg`` is missing.

The checkpoint loads in f32 onto the worker's ``device`` (the card unless
the caller asks for the CPU), as the JAX worker loads it; its tokenizer
is ``tokenizer.json`` (``engine/tokenizer.py``), and a directory without
one gives the space-joined ids, as the JAX worker does where
transformers finds no tokenizer. Each 30 s chunk is one segment, decoded
greedily by ``models/whisper.py::WhisperRunner`` (on a card: one encoder
replay, then one replay a token; captured at load).
"""

from __future__ import annotations

import gc
import logging
import os
import subprocess
import threading
import time
import wave
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve
from ..engine.tokenizer import HFTokenizer
from ..models.whisper import (CHUNK_S, SAMPLE_RATE, WhisperRunner,
                              WhisperSpec, load_whisper_params,
                              log_mel_spectrogram, param_bytes)
from .base import (Backend, ModelLoadOptions, Result, StatusResponse,
                   TranscriptResult, TranscriptSegment)

log = logging.getLogger(__name__)


def load_pcm(path: str) -> np.ndarray:
    """Decode an audio file to float32 mono 16kHz PCM."""
    if path.lower().endswith(".wav"):
        with wave.open(path) as w:
            sr = w.getframerate()
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        if width == 1:  # 8-bit WAV is UNSIGNED, silence at 128
            pcm = (np.frombuffer(raw, np.uint8).astype(np.float32)
                   - 128.0) / 128.0
        elif width == 2:
            pcm = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 3:  # 24-bit packed little-endian
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            val = (b[:, 0].astype(np.int32)
                   | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            pcm = val.astype(np.float32) / float(1 << 23)
        elif width == 4:
            pcm = np.frombuffer(raw, np.int32).astype(np.float32) / float(
                1 << 31)
        else:
            raise ValueError(f"unsupported WAV sample width {width}")
        if n_ch > 1:
            pcm = pcm.reshape(-1, n_ch).mean(axis=1)
        if sr != SAMPLE_RATE:
            idx = np.linspace(0, len(pcm) - 1, int(len(pcm) * SAMPLE_RATE / sr))
            pcm = np.interp(idx, np.arange(len(pcm)), pcm).astype(np.float32)
        return pcm
    # non-wav: ffmpeg shell-out (ref: utils/ffmpeg.go audioToWav)
    out = subprocess.run(
        ["ffmpeg", "-i", path, "-f", "f32le", "-ac", "1",
         "-ar", str(SAMPLE_RATE), "-"],
        capture_output=True, check=True,
    )
    return np.frombuffer(out.stdout, np.float32)


class TorchWhisperBackend(Backend):
    MAX_NEW = 224  # tokens a chunk at most (the JAX worker's cap)

    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self.spec: Optional[WhisperSpec] = None
        self.params: Optional[dict] = None
        self.runner: Optional[WhisperRunner] = None
        self.tokenizer: Optional[HFTokenizer] = None
        self._state = "UNINITIALIZED"
        self._lock = threading.Lock()
        self.load_s = 0.0
        self.unload_stats: Optional[dict] = None

    def load_model(self, opts: ModelLoadOptions) -> Result:
        with self._lock:
            t0 = time.perf_counter()
            try:
                model_dir = opts.model
                if not os.path.isabs(model_dir):
                    model_dir = os.path.join(opts.model_path or "", model_dir)
                if not os.path.isdir(model_dir):
                    raise FileNotFoundError(
                        f"model directory not found: {model_dir}")
                self.spec, self.params = load_whisper_params(
                    model_dir, device=self.device)
                self.tokenizer = None
                if os.path.isfile(os.path.join(model_dir, "tokenizer.json")):
                    self.tokenizer = HFTokenizer(model_dir)
                else:
                    log.warning("whisper model %s has no tokenizer.json; "
                                "token ids will be space-joined", model_dir)
                self.runner = WhisperRunner(self.spec, self.params,
                                            self.device)
                self.runner.capture()
                self._state = "READY"
                self.load_s = time.perf_counter() - t0
                return Result(True, "whisper model loaded")
            except Exception as e:
                self.spec = self.params = self.runner = self.tokenizer = None
                self._state = "ERROR"
                return Result(False, f"load failed: {e}")

    def health(self) -> bool:
        return self._state == "READY"

    def status(self) -> StatusResponse:
        mem = {}
        if self.params is not None:
            mem["param_bytes"] = param_bytes(self.params)
        if self.runner is not None:
            mem["graph_pool_bytes"] = self.runner.pool_bytes
        return StatusResponse(state=self._state, memory=mem)

    def shutdown(self) -> None:
        with self._lock:
            self.spec = self.params = self.runner = self.tokenizer = None
            self._state = "UNINITIALIZED"
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                gc.collect()
                torch.cuda.empty_cache()
                self.unload_stats = {
                    "allocated_after": torch.cuda.memory_allocated(
                        self.device)}

    # ---------------------------------------------------------- transcribe

    def _prompt(self, language: str, translate: bool) -> list[int]:
        sp = self.spec
        lang_id = None
        tk = self.tokenizer
        if tk is not None and language:
            lid = tk.token_to_id(f"<|{language}|>")
            unk = tk.special_tokens.get("unk_token")
            if lid is not None and lid != (
                    tk.token_to_id(unk) if unk is not None else None):
                lang_id = lid
        ids = [sp.sot]
        ids.append(lang_id if lang_id is not None else sp.lang_base)
        ids.append(sp.task_translate if translate else sp.task_transcribe)
        ids.append(sp.no_timestamps)
        return ids

    def _decode_text(self, ids: list[int]) -> str:
        sp = self.spec
        clean = [i for i in ids if i < sp.eot or (
            sp.eot < sp.sot and i < sp.sot)]
        clean = [i for i in clean if i not in (sp.sot, sp.eot)
                 and not (sp.timestamp_begin <= i)]
        if self.tokenizer is not None:
            return self.tokenizer.decode(clean, skip_special_tokens=True)
        return " ".join(str(i) for i in clean)

    def audio_transcription(self, audio_path: str, language: str = "",
                            translate: bool = False) -> TranscriptResult:
        if self._state != "READY":
            raise RuntimeError("model not loaded")
        pcm = load_pcm(audio_path)
        duration = len(pcm) / SAMPLE_RATE
        prompt = self._prompt(language, translate)
        segments: list[TranscriptSegment] = []
        texts = []
        chunk = CHUNK_S * SAMPLE_RATE
        n_chunks = max(1, (len(pcm) + chunk - 1) // chunk)
        max_new = min(self.MAX_NEW, self.spec.max_target - len(prompt) - 1)
        for ci in range(n_chunks):
            mel = log_mel_spectrogram(pcm[ci * chunk: (ci + 1) * chunk])
            ids = [int(t) for t in self.runner.transcribe(mel, max_new,
                                                          prompt)]
            if self.spec.eot in ids:
                ids = ids[: ids.index(self.spec.eot)]
            text = self._decode_text(ids).strip()
            start = ci * CHUNK_S
            end = min((ci + 1) * CHUNK_S, duration)
            segments.append(TranscriptSegment(
                id=ci, start=float(start), end=float(end), text=text,
                tokens=ids,
            ))
            texts.append(text)
        return TranscriptResult(segments=segments, text=" ".join(
            t for t in texts if t).strip())
