"""LLM worker: one ``LLMEngine`` over one loaded checkpoint (counterpart
of localai_tfp_tpu/workers/llm.py::JaxLLMBackend, LLM path only)."""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Iterator, Optional

import torch

from ..device import resolve
from ..engine.engine import GenRequest, LLMEngine, StreamEvent
from ..engine.tokenizer import Tokenizer, load_tokenizer
from ..models import artifact_cache
from ..models.hf_loader import load_params, spec_from_config
from ..models.llm_spec import LLMSpec
from .base import Backend, ModelLoadOptions, PredictOptions, Reply, Result

_DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "f32": torch.float32,
    # fp16 serves as bf16, as in the JAX package
    "float16": torch.bfloat16, "f16": torch.bfloat16,
}
# KV-cache-only dtypes: int8 rows with per-row scales
_KV_DTYPES = {**_DTYPES, "int8": torch.int8, "i8": torch.int8,
              "q8": torch.int8, "q8_0": torch.int8}
# weight-only quantization values (the JAX worker's): int8 aliases, and
# the names that mean "none"
_INT8 = ("int8", "q8", "q8_0", "w8", "int8_full")
_NO_QUANT = ("none", "f16", "fp16", "bf16", "bfloat16")


class TorchLLMBackend(Backend):
    """Serves chat completions for a HF checkpoint directory."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self.engine: Optional[LLMEngine] = None
        self.tokenizer: Optional[Tokenizer] = None
        self.spec: Optional[LLMSpec] = None
        self._state = "UNINITIALIZED"
        self._lock = threading.Lock()
        # how the last load got its weights ("full", "quantized": int8 at
        # load, "artifact": the on-disk int8 tree) and its wall seconds
        self.load_mode = ""
        self.load_s = 0.0

    def load_model(self, opts: ModelLoadOptions) -> Result:
        with self._lock:
            quant = (opts.quantization or "").lower()
            if quant and quant not in _INT8 + _NO_QUANT:
                self._state = "ERROR"
                return Result(
                    False,
                    f"load failed: unsupported quantization "
                    f"'{opts.quantization}' (supported: int8, int8_full)")
            model_dir = opts.model
            if not os.path.isabs(model_dir):
                model_dir = os.path.join(opts.model_path or "", model_dir)
            if not os.path.isdir(model_dir):
                self._state = "ERROR"
                return Result(False, f"load failed: model not found: "
                                     f"{model_dir}")
            name = (opts.dtype or "bfloat16").lower()
            kv_name = (opts.kv_cache_dtype or opts.dtype or "bfloat16").lower()
            if name not in _DTYPES or kv_name not in _KV_DTYPES:
                self._state = "ERROR"
                return Result(False, f"load failed: unsupported dtype "
                                     f"{name!r} / kv_cache_dtype {kv_name!r}")
            try:
                self._state = "BUSY"
                if self.engine is not None:
                    self.engine.close()
                    self.engine = None
                t0 = time.perf_counter()
                self.spec, params = self._load_weights(
                    model_dir, _DTYPES[name],
                    quant if quant in _INT8 else "")
                self.tokenizer = load_tokenizer(model_dir)
                self.engine = LLMEngine(
                    self.spec, params, self.tokenizer,
                    n_slots=max(1, opts.batch_slots),
                    max_seq=opts.context_size,
                    cache_dtype=_KV_DTYPES[kv_name],
                    device=self.device)
            except (OSError, ValueError, NotImplementedError, KeyError,
                    RuntimeError) as e:
                self._state = "ERROR"
                return Result(False, f"load failed: {e}")
            self.load_s = time.perf_counter() - t0
            self._state = "READY"
            return Result(True, "model loaded")

    def _load_weights(self, model_dir: str, dtype: torch.dtype,
                      quant: str) -> tuple[LLMSpec, dict]:
        """(spec, params): full precision, or int8 from the on-disk
        artifact when there is one, else quantized while loading and then
        written as the artifact for the next load."""
        if not quant:
            self.load_mode = "full"
            return load_params(model_dir, dtype=dtype, device=self.device)
        mode = artifact_cache.canonical_quant(quant)
        path = artifact_cache.artifact_path(
            model_dir, mode, str(dtype).removeprefix("torch."))
        params = artifact_cache.try_load(path, self.device)
        if params is not None:
            with open(os.path.join(model_dir, "config.json")) as f:
                spec = spec_from_config(json.load(f))
            if "lm_head" not in params:  # the checkpoint tied its head
                object.__setattr__(spec, "tie_word_embeddings", True)
            self.load_mode = "artifact"
            return spec, params
        spec, params = load_params(model_dir, dtype=dtype,
                                   device=self.device, quantize=mode)
        artifact_cache.save(path, params)
        self.load_mode = "quantized"
        return spec, params

    def shutdown(self) -> None:
        if self.engine is not None:
            self.engine.close()
            self.engine = None
        self._state = "UNINITIALIZED"

    def health(self) -> bool:
        return self._state in ("READY", "BUSY")

    def _to_request(self, opts: PredictOptions) -> GenRequest:
        assert self.tokenizer is not None
        return GenRequest(
            prompt_ids=self.tokenizer.encode(opts.prompt, add_bos=True),
            max_tokens=opts.tokens or 2048,
            temperature=opts.temperature,
            top_k=opts.top_k,
            top_p=opts.top_p,
            min_p=opts.min_p,
            repeat_penalty=opts.repeat_penalty,
            repeat_last_n=opts.repeat_last_n,
            frequency_penalty=opts.frequency_penalty,
            presence_penalty=opts.presence_penalty,
            typical_p=opts.typical_p if opts.typical_p > 0 else 1.0,
            mirostat=opts.mirostat,
            mirostat_tau=opts.mirostat_tau if opts.mirostat_tau > 0 else 5.0,
            mirostat_eta=opts.mirostat_eta if opts.mirostat_eta > 0 else 0.1,
            seed=opts.seed,
            stop=list(opts.stop_prompts),
            ignore_eos=opts.ignore_eos,
            correlation_id=opts.correlation_id,
            **({"id": opts.request_id} if opts.request_id else {}),
        )

    def cancel(self, request_id: str) -> None:
        if self.engine is not None:
            self.engine.cancel(request_id)

    def predict(self, opts: PredictOptions) -> Reply:
        if self.engine is None:
            return Reply(error="model not loaded", finish_reason="error")
        return final_reply(self.engine.generate(self._to_request(opts)))

    def stream_queue(self, opts: PredictOptions) -> queue.SimpleQueue:
        """Submit and return the engine's raw event queue (the HTTP layer
        peeks at it for an immediate shed before it sends headers)."""
        if self.engine is None:
            raise RuntimeError("model not loaded")
        return self.engine.submit(self._to_request(opts))

    def predict_stream(self, opts: PredictOptions) -> Iterator[Reply]:
        if self.engine is None:
            yield Reply(error="model not loaded", finish_reason="error")
            return
        q = self.stream_queue(opts)
        while True:
            ev: StreamEvent = q.get()
            if ev.done:
                yield final_reply(ev)
                return
            if ev.text:
                yield Reply(message=ev.text, token_id=ev.token_id)


def final_reply(ev: StreamEvent) -> Reply:
    return Reply(
        message=ev.full_text,
        tokens=ev.completion_tokens,
        prompt_tokens=ev.prompt_tokens,
        timing_prompt_processing=ev.timing_prompt_processing_ms,
        timing_token_generation=ev.timing_token_generation_ms,
        timing_queue=ev.timing_queue_ms,
        timing_first_token=ev.timing_first_token_ms,
        finish_reason=ev.finish_reason,
        error=ev.error,
        retry_after_s=ev.retry_after_s,
    )
