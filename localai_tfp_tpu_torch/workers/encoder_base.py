"""Shared scaffolding of the encoder workers (embeddings, rerank): the
port's counterpart of localai_tfp_tpu/workers/encoder_base.py.

One place for checkpoint resolution, the lifecycle state and bucketed
batch padding. The checkpoint's parameters load in f32 onto the worker's
``device`` (the card unless the caller asks for the CPU), its tokenizer
from ``tokenizer.json`` (``engine/tokenizer.py``; the byte tokenizer for
a directory with no tokenizer files, as in the JAX package). ``shutdown``
drops every reference to the card tensors, so allocated memory is back at
its pre-load baseline when it returns.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve
from ..engine.tokenizer import Tokenizer, load_tokenizer
from ..models.encoder import EncoderSpec, EncParams, load_encoder_params
from .base import Backend, ModelLoadOptions, Result, StatusResponse


class EncoderWorkerBase(Backend):
    LEN_BUCKETS: tuple[int, ...] = (32, 128, 256, 512)

    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self.spec: Optional[EncoderSpec] = None
        self.params: Optional[EncParams] = None
        self.tokenizer: Optional[Tokenizer] = None
        self._state = "UNINITIALIZED"
        self._lock = threading.Lock()
        self.load_s = 0.0
        # the last shutdown's allocated bytes on the card (after
        # gc.collect and empty_cache)
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
                self.spec, self.params = load_encoder_params(
                    model_dir, device=self.device)
                self.tokenizer = load_tokenizer(model_dir)
                self._state = "READY"
                self.load_s = time.perf_counter() - t0
                return Result(True, "encoder model loaded")
            except Exception as e:
                self.spec = self.params = self.tokenizer = None
                self._state = "ERROR"
                return Result(False, f"load failed: {e}")

    def health(self) -> bool:
        return self._state == "READY"

    def status(self) -> StatusResponse:
        mem = {}
        if self.params is not None:
            mem["param_bytes"] = sum(t.numel() * t.element_size()
                                     for t in self.params.values())
        return StatusResponse(state=self._state, memory=mem)

    def shutdown(self) -> None:
        with self._lock:
            self.spec = self.params = self.tokenizer = None
            self._state = "UNINITIALIZED"
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                gc.collect()
                torch.cuda.empty_cache()
                self.unload_stats = {
                    "allocated_after": torch.cuda.memory_allocated(
                        self.device)}

    def _ready(self) -> None:
        if self._state != "READY":
            raise RuntimeError("model not loaded")

    # ---------------------------------------------------------- batching

    def _bucket(self, n: int) -> int:
        cap = self.spec.max_position
        for b in self.LEN_BUCKETS:
            if n <= b <= cap:
                return b
        return cap

    def _batch(self, seqs: list[list[int]],
               type_seqs: Optional[list[list[int]]] = None
               ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Pad to the next length bucket -> (tokens, mask, type_ids?)."""
        T = self._bucket(max(len(s) for s in seqs))
        toks = np.zeros((len(seqs), T), np.int32)
        mask = np.zeros((len(seqs), T), np.int32)
        types = np.zeros((len(seqs), T), np.int32) if type_seqs else None
        for r, s in enumerate(seqs):
            s = s[:T]
            toks[r, : len(s)] = s
            mask[r, : len(s)] = 1
            if types is not None:
                ts = type_seqs[r][:T]
                types[r, : len(ts)] = ts
        return toks, mask, types

    def _on_device(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return None if a is None else torch.from_numpy(a).to(self.device)
