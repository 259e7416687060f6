"""Text-to-speech worker: the port's counterpart of
localai_tfp_tpu/workers/tts.py, served at ``POST /v1/audio/speech``,
``/tts``, ``/v1/text-to-speech/{voice_id}`` and ``/v1/sound-generation``
(ref: backend/go/tts/piper.go, backend/python/coqui|kokoro, the
transformers backend's OuteTTS path).

``load_model`` dispatches on the model path as the JAX worker does: a
``.onnx`` file is a piper voice (``models/piper.py``); a directory with a
``codec/`` subdirectory or a config of ``type: OuteTTS`` is an OuteTTS
model (``models/outetts.py``, its LM through the paged engine); a Kokoro
config is Kokoro (``models/kokoro.py``); ``model_type: vits`` is an HF
VITS/MMS checkpoint (``models/vits.py``, its character tokenizer read
from ``vocab.json``). With no model files the worker is the formant
voice: grapheme-to-phoneme by rule and a 3-formant source-filter render,
numpy on the host in both packages, so its WAV bytes are the JAX
worker's. A model that was named and fails to load is an error
(``Result(False, "<family> load failed: ...")``), never the formant voice.
The families the JAX worker also serves and this port does not yet (bark,
xtts, musicgen) fail their load, naming the family.

``sound_generation`` without a MusicGen checkpoint is the JAX worker's
seeded noise-band texture (host numpy, the same bytes). The models run on
the worker's ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import threading
import wave
from typing import Any

import numpy as np
import torch

from ..device import resolve
from .base import Backend, ModelLoadOptions, Result, StatusResponse

SR = 16000

# (F1, F2, F3, voiced, duration_s) per phoneme — classic formant tables
PHONEMES: dict[str, tuple[float, float, float, bool, float]] = {
    "a": (730, 1090, 2440, True, 0.14),
    "e": (530, 1840, 2480, True, 0.12),
    "i": (270, 2290, 3010, True, 0.11),
    "o": (570, 840, 2410, True, 0.14),
    "u": (300, 870, 2240, True, 0.13),
    "m": (250, 1000, 2200, True, 0.08),
    "n": (250, 1700, 2600, True, 0.07),
    "l": (360, 1300, 2700, True, 0.07),
    "r": (490, 1350, 1690, True, 0.08),
    "w": (300, 610, 2200, True, 0.07),
    "y": (270, 2100, 3000, True, 0.06),
    "b": (200, 800, 2200, True, 0.04),
    "d": (200, 1700, 2600, True, 0.04),
    "g": (200, 1300, 2200, True, 0.05),
    "p": (400, 1100, 2300, False, 0.05),
    "t": (400, 1800, 2600, False, 0.04),
    "k": (400, 1400, 2300, False, 0.05),
    "s": (200, 5000, 7000, False, 0.09),
    "z": (200, 4500, 6500, True, 0.08),
    "f": (200, 4000, 6000, False, 0.08),
    "v": (200, 3500, 5500, True, 0.07),
    "h": (500, 1500, 2500, False, 0.05),
    " ": (0, 0, 0, False, 0.10),
}
ALIASES = {"c": "k", "q": "k", "x": "s", "j": "y"}

VOICES = {  # voice id -> (pitch_hz, speed)
    "": (120.0, 1.0),
    "alloy": (120.0, 1.0),
    "echo": (95.0, 0.95),
    "fable": (140.0, 1.05),
    "onyx": (85.0, 0.9),
    "nova": (175.0, 1.1),
    "shimmer": (200.0, 1.05),
}

# families of the JAX worker that this port does not serve yet
_NOT_PORTED = ("bark", "musicgen", "xtts")


def _g2p(text: str) -> list[str]:
    out = []
    for ch in text.lower():
        if ch in PHONEMES:
            out.append(ch)
        elif ch in ALIASES:
            out.append(ALIASES[ch])
        elif ch.isspace() or ch in ".,;:!?-":
            out.append(" ")
    return out or [" "]


def _render(phonemes: list[str], pitch_hz: float, speed: float) -> np.ndarray:
    """Source-filter render: per-phoneme formant sinusoid bank with pitch
    modulation; noise excitation for unvoiced phonemes."""
    rng = np.random.default_rng(0)
    chunks = []
    t_off = 0.0
    for ph in phonemes:
        f1, f2, f3, voiced, dur = PHONEMES[ph]
        dur /= speed
        n = max(int(dur * SR), 1)
        t = np.arange(n) / SR
        if f1 == 0:  # silence
            chunks.append(np.zeros(n, np.float32))
            t_off += dur
            continue
        env = np.minimum(1.0, np.minimum(t / 0.015, (dur - t) / 0.02))
        env = np.clip(env, 0.0, 1.0)
        if voiced:
            # pitch with gentle declination + vibrato
            f0 = pitch_hz * (1.0 - 0.05 * t_off) * (
                1.0 + 0.01 * np.sin(2 * np.pi * 5 * (t_off + t)))
            phase = 2 * np.pi * np.cumsum(f0) / SR
            src = np.zeros(n)
            for k, amp in ((1, 1.0), (2, 0.5), (3, 0.25), (4, 0.12)):
                src += amp * np.sin(k * phase)
            sig = np.zeros(n)
            for fc, amp in ((f1, 1.0), (f2, 0.7), (f3, 0.3)):
                sig += amp * src * np.sin(2 * np.pi * fc * t)
        else:
            noise = rng.standard_normal(n)
            sig = np.zeros(n)
            for fc, amp in ((f2, 1.0), (f3, 0.7)):
                sig += amp * noise * np.sin(2 * np.pi * fc * t)
        chunks.append((sig * env).astype(np.float32))
        t_off += dur
    audio = np.concatenate(chunks)
    peak = np.max(np.abs(audio)) or 1.0
    return (audio / peak * 0.8).astype(np.float32)


def write_wav(path: str, audio: np.ndarray, sr: int = SR) -> None:
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def noise_bands(text: str, duration: float) -> np.ndarray:
    """The procedural seeded noise-band texture ``sound_generation``
    answers with when no MusicGen checkpoint is loaded."""
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4],
                          "little")
    rng = np.random.default_rng(seed)
    n = int(duration * SR)
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for _ in range(4):
        fc = rng.uniform(100, 4000)
        bw = rng.uniform(0.5, 4.0)
        amp = rng.uniform(0.2, 1.0)
        env = np.exp(-bw * t) * np.sin(
            2 * np.pi * rng.uniform(0.2, 2) * t) ** 2
        sig += amp * env * np.sin(2 * np.pi * fc * t + rng.uniform(0, 6.28))
    sig += 0.3 * np.exp(-2.0 * t) * rng.standard_normal(n)
    peak = np.max(np.abs(sig)) or 1.0
    return (sig / peak * 0.8).astype(np.float32)


class TorchTTSBackend(Backend):
    """The TTS families behind one worker; exactly one (or none: the
    formant voice) is reachable after a load."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self._state = "UNINITIALIZED"
        self._lock = threading.Lock()
        self._clear()

    def _clear(self) -> None:
        self._vits = None  # (spec, params, tokenizer-or-None)
        self._kokoro = None  # (spec, params, voices)
        self._piper = None  # models/piper.py PiperVoice
        self._outetts = None  # models/outetts.py OuteTTSModel

    def load_model(self, opts: ModelLoadOptions) -> Result:
        with self._lock:
            # a reload must not leave an earlier family reachable (tts()
            # dispatches on whichever slot is set)
            self._release()
            res = self._load(opts)
            self._state = "READY" if res.success else "ERROR"
            return res

    def _load(self, opts: ModelLoadOptions) -> Result:
        model_dir = opts.model
        if model_dir and not os.path.isabs(model_dir):
            model_dir = os.path.join(opts.model_path or "", model_dir)
        if model_dir and model_dir.endswith(".onnx"):
            # piper voice: original-VITS onnx + sidecar json (the
            # gallery's piper YAMLs point parameters.model at the .onnx)
            from ..models.piper import PiperVoice

            try:
                self._piper = PiperVoice.load(model_dir, self.device)
            except Exception as e:  # any fault of the file is a load error
                return Result(False, f"piper load failed: {e}")
            return Result(True, "piper voice ready")
        cfg_path = os.path.join(model_dir or "", "config.json")
        if not (model_dir and os.path.exists(cfg_path)):
            return Result(True, "tts ready")
        mtype = ""
        try:
            if (opts.type or "").lower() == "outetts" or os.path.isdir(
                    os.path.join(model_dir, "codec")):
                # LLM-driven TTS: a causal LM with audio-code tokens and
                # an EnCodec-layout codec
                from ..models.artifact_cache import canonical_quant
                from ..models.outetts import OuteTTSModel

                mtype = "outetts"
                quant = (opts.quantization or "").lower()
                self._outetts = OuteTTSModel.load(
                    model_dir, device=self.device,
                    quantization=canonical_quant(quant)
                    if quant in ("int8", "q8", "q8_0", "w8", "int8_full")
                    else "")
                return Result(True, "outetts ready")
            from ..models.kokoro import is_kokoro_dir

            if is_kokoro_dir(model_dir):
                from ..models.kokoro import load_kokoro

                mtype = "kokoro"
                self._kokoro = load_kokoro(model_dir, self.device)
                return Result(True, "kokoro ready")
            with open(cfg_path) as f:
                config = json.load(f)
            mtype = (config.get("model_type") or "").lower()
            if _is_xtts(config):
                mtype = "xtts"
            if mtype in _NOT_PORTED:
                raise NotImplementedError(
                    f"the {mtype} family is not ported to this runtime yet")
            if mtype == "vits":
                from ..models.vits import load_vits, load_vits_tokenizer

                spec, params = load_vits(model_dir, self.device)
                self._vits = (spec, params, load_vits_tokenizer(model_dir))
        except Exception as e:  # a load must answer, not raise
            self._clear()
            return Result(False, f"{mtype or 'tts'} load failed: {e}")
        return Result(True, "tts ready")

    def health(self) -> bool:
        return self._state == "READY"

    def _release(self) -> None:
        # the OuteTTS family owns a live LLMEngine (scheduler thread,
        # device KV arena, graphs): unload must reclaim it
        if self._outetts is not None:
            self._outetts.close()
        self._clear()

    def shutdown(self) -> None:
        with self._lock:
            self._release()
            self._state = "UNINITIALIZED"
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                gc.collect()
                torch.cuda.empty_cache()

    def status(self) -> StatusResponse:
        return StatusResponse(state=self._state)

    def family(self) -> str:
        """The loaded family: piper, outetts, kokoro, vits or formant."""
        for name in ("piper", "outetts", "kokoro", "vits"):
            if getattr(self, f"_{name}") is not None:
                return name
        return "formant"

    def _vits_ids(self, text: str) -> np.ndarray:
        spec, _, tok = self._vits
        if tok is not None:
            ids = tok.encode(text)
            if ids:
                return np.asarray(ids, np.int32)
        return np.asarray(
            [b % spec.vocab_size for b in text.encode()] or [0], np.int32)

    def tts(self, text: str, voice: str = "", dst: str = "",
            language: str = "") -> Result:
        if self._piper is not None:
            audio = self._piper.synthesize(text)
            write_wav(dst, audio, sr=self._piper.spec.sampling_rate)
            return Result(True, dst)
        if self._outetts is not None:
            from ..models.outetts import load_speaker

            speaker = None
            if voice:
                vpath = voice if os.path.isabs(voice) else os.path.join(
                    self._outetts.model_dir, voice)
                if os.path.exists(vpath):
                    speaker = load_speaker(vpath)
                elif os.path.exists(voice):
                    speaker = load_speaker(voice)
                else:
                    return Result(
                        False, f"outetts speaker profile not found: "
                               f"{voice!r} (a json with text + codes)")
            try:
                audio = self._outetts.synthesize(text, speaker=speaker)
            except RuntimeError as e:
                return Result(False, str(e))
            write_wav(dst, audio, sr=self._outetts.sample_rate)
            return Result(True, dst)
        if self._kokoro is not None:
            from ..models.kokoro import (pick_voice, synthesize_kokoro,
                                         text_to_tokens)

            kspec, kparams, voices = self._kokoro
            ids = text_to_tokens(text, kspec.n_token)
            ref = pick_voice(voices, voice, len(ids), kspec.style_dim)
            # the official generate() pads the token stream with 0 on
            # both ends before the forward
            audio = synthesize_kokoro(kspec, kparams, [0, *ids, 0], ref)
            write_wav(dst, audio, sr=kspec.sampling_rate)
            return Result(True, dst)
        if self._vits is not None:
            from ..models.vits import synthesize

            spec, params, _ = self._vits
            _, speed = VOICES.get(voice.lower(), VOICES[""])
            audio = synthesize(spec, params, self._vits_ids(text),
                               speaking_rate=spec.speaking_rate * speed)
            write_wav(dst, audio, sr=spec.sampling_rate)
            return Result(True, dst)
        pitch, speed = VOICES.get(voice.lower(), VOICES[""])
        write_wav(dst, _render(_g2p(text), pitch, speed))
        return Result(True, dst)

    def sound_generation(self, text: str, dst: str = "", **kw) -> Result:
        """A procedural seeded noise-band texture (no MusicGen checkpoint
        is served by this port yet), so the endpoint works with zero
        model files."""
        write_wav(dst, noise_bands(text, float(kw.get("duration") or 3.0)))
        return Result(True, dst)


def _is_xtts(config: dict) -> bool:
    """The JAX package's coqui XTTS v2 detection (``models/xtts.py::
    is_xtts_dir``) on a parsed config.json."""
    return "gpt_number_text_tokens" in (config.get("model_args") or {}) \
        or config.get("model") == "xtts"
