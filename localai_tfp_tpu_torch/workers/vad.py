"""Voice-activity detection worker: the port's counterpart of
localai_tfp_tpu/workers/vad.py, served at ``POST /vad`` and
``/v1/vad`` (ref: backend/go/vad/silero/,
core/http/endpoints/localai/vad.go).

Two modes, as in the JAX worker:

- learned: a silero-class checkpoint (``.jit``/``.pt``/``.pth``/``.ts``
  torchscript or state dict, or ``.safetensors`` read by
  ``models/safetensors_io.py``) on the worker's device, served by
  ``models/vad_net.py::VADRunner``; a ``threshold`` above 1 (the DSP
  mode's) means the default probability threshold 0.5;
- DSP (no model configured): per-frame RMS energy and spectral flatness
  on the device (frames of 32 ms every 10 ms over the input padded to a
  power-of-two length), an adaptive noise floor (the quietest quarter of
  frames), then hysteresis and hangover smoothing on the host.

A configured model that is missing fails the load, as in the JAX worker.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve
from ..models import vad_net
from .base import (Backend, ModelLoadOptions, Result, StatusResponse,
                   VADResponse, VADSegment)

log = logging.getLogger(__name__)

SAMPLE_RATE = 16000
FRAME = 512  # 32 ms
HOP = 160  # 10 ms


def _frame_features(audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[n] f32 -> (rms energy [F], spectral flatness [F]) per frame."""
    frames = audio.unfold(0, FRAME, HOP)  # [F, FRAME]
    window = torch.hann_window(FRAME, periodic=False, dtype=torch.float32,
                               device=audio.device)
    rms = torch.sqrt(frames.square().mean(-1) + 1e-12)
    spec = torch.fft.rfft(frames * window, dim=-1).abs() + 1e-10
    # speech is spectrally peaky (low flatness); noise is flat (~1)
    flat = torch.exp(torch.log(spec).mean(-1)) / spec.mean(-1)
    return rms, flat


class TorchVADBackend(Backend):
    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self._state = "UNINITIALIZED"
        self.threshold = 2.5  # over noise floor (DSP mode); learned mode
        # reinterprets values <= 1 as the probability threshold
        self.min_speech_s = 0.25
        self.min_silence_s = 0.25
        self._net: Optional[vad_net.VADParams] = None
        self.runner: Optional[vad_net.VADRunner] = None

    def load_model(self, opts: ModelLoadOptions) -> Result:
        self._net = self.runner = None
        for kv in opts.options:
            k, _, v = kv.partition("=")
            if k == "threshold":
                self.threshold = float(v)
            elif k == "min_speech_s":
                self.min_speech_s = float(v)
            elif k == "min_silence_s":
                self.min_silence_s = float(v)
        model = opts.model
        if model and not os.path.isabs(model):
            cand = os.path.join(opts.model_path or "", model)
            model = cand if os.path.exists(cand) else model
        if model and not os.path.exists(model):
            # a configured-but-missing model must fail loudly, not
            # silently degrade to the DSP heuristic
            self._state = "ERROR"
            return Result(False, f"vad model not found: {opts.model!r}")
        if model:
            try:
                self._net = self._load_net(model)
            except Exception as e:
                self._state = "ERROR"
                return Result(False, f"vad model load failed: {e}")
            if self._net is None:
                self._state = "ERROR"
                return Result(False, (
                    f"unsupported VAD model format: {model!r} "
                    "(.jit/.pt/.pth/.safetensors)"))
            self.runner = vad_net.VADRunner(self._net, self.device)
        self._state = "READY"
        return Result(True, "vad ready (learned silero-class model)"
                      if self._net is not None
                      else "vad ready (DSP detector)")

    def _load_net(self, model: str) -> Optional[vad_net.VADParams]:
        dev = self.device
        if model.endswith((".jit", ".pt", ".pth", ".ts")):
            try:  # torchscript archive (the silero download)
                return vad_net.load_torchscript(model, dev)
            except Exception as e:
                log.warning("torchscript parse of %s failed (%r); retrying "
                            "as a state_dict checkpoint", model, e)
                return vad_net.load_state_dict(
                    torch.load(model, map_location="cpu", weights_only=True),
                    dev)
        if model.endswith(".safetensors"):
            from ..models.safetensors_io import load_file

            return vad_net.load_state_dict(load_file(model), dev)
        return None

    def health(self) -> bool:
        return self._state == "READY"

    def status(self) -> StatusResponse:
        return StatusResponse(state=self._state)

    def shutdown(self) -> None:
        self._net = self.runner = None
        self._state = "UNINITIALIZED"

    def vad(self, audio: list[float]) -> VADResponse:
        pcm = np.asarray(audio, np.float32)
        if self.runner is not None:
            if pcm.shape[0] < vad_net.CHUNK:
                return VADResponse()
            probs = self.runner.probabilities(pcm)
            thr = self.threshold if self.threshold <= 1.0 else 0.5
            segs = vad_net.probs_to_segments(
                probs, threshold=thr, min_speech_s=self.min_speech_s,
                min_silence_s=self.min_silence_s)
            return VADResponse(segments=[
                VADSegment(start=round(s, 3), end=round(e, 3))
                for s, e in segs
            ])
        if pcm.shape[0] < FRAME:
            return VADResponse()
        # padded to a power-of-two length, as the JAX worker pads its
        # jitted program's input; the frames past the input are dropped
        n_valid = (pcm.shape[0] - FRAME) // HOP + 1
        bucket = 1 << (pcm.shape[0] - 1).bit_length()
        padded = torch.zeros(bucket, dtype=torch.float32, device=self.device)
        padded[: pcm.shape[0]] = torch.from_numpy(pcm).to(self.device)
        with torch.inference_mode():
            rms, flat = _frame_features(padded)
            rms = rms[:n_valid].cpu().numpy()
            flat = flat[:n_valid].cpu().numpy()
        # adaptive noise floor: the quietest quarter of frames
        floor = max(float(np.percentile(rms, 25)), 1e-6)
        speech = (rms > floor * self.threshold) & (flat < 0.5)
        segs = _smooth(speech, self.min_speech_s, self.min_silence_s)
        return VADResponse(segments=[
            VADSegment(start=round(s * HOP / SAMPLE_RATE, 3),
                       end=round((e * HOP + FRAME) / SAMPLE_RATE, 3))
            for s, e in segs
        ])


def _smooth(speech: np.ndarray, min_speech_s: float,
            min_silence_s: float) -> list[tuple[int, int]]:
    """Merge gaps < min_silence, drop islands < min_speech (the hangover
    logic every practical VAD needs)."""
    frames_per_s = SAMPLE_RATE / HOP
    min_speech = int(min_speech_s * frames_per_s)
    min_silence = int(min_silence_s * frames_per_s)
    segs: list[tuple[int, int]] = []
    start: Optional[int] = None
    for i, on in enumerate(speech):
        if on and start is None:
            start = i
        elif not on and start is not None:
            segs.append((start, i - 1))
            start = None
    if start is not None:
        segs.append((start, len(speech) - 1))
    merged: list[tuple[int, int]] = []
    for s, e in segs:
        if merged and s - merged[-1][1] <= min_silence:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return [(s, e) for s, e in merged if e - s + 1 >= min_speech]
