"""Backend worker contract (the port's own copy of the parts of
localai_tfp_tpu/workers/base.py the LLM path uses).

Mirrors the reference's shared backend contract (ref:
backend/backend.proto; Go interface pkg/grpc/backend.go:34-59): workers
are in-process Python objects, one per loaded model. Field names and
defaults are the JAX package's, so the HTTP layer maps the same way.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Iterator, Optional


@dataclass
class PredictOptions:
    """ref: backend.proto PredictOptions (sampling + prompt surface)."""

    prompt: str = ""
    tokens: int = 0  # max new tokens (proto: Tokens)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    typical_p: float = 1.0
    seed: Optional[int] = None
    repeat_penalty: float = 0.0
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    stop_prompts: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    mirostat: int = 0
    mirostat_eta: float = 0.0
    mirostat_tau: float = 0.0
    correlation_id: str = ""
    request_id: str = ""  # caller-chosen id enabling cancel() on
    # client disconnect (ref: llama.cpp task cancel)


@dataclass
class Reply:
    """ref: backend.proto Reply (message + timing + usage)."""

    message: str = ""
    token_id: Optional[int] = None
    tokens: int = 0  # completion tokens so far / total
    prompt_tokens: int = 0
    timing_prompt_processing: float = 0.0  # ms
    timing_token_generation: float = 0.0  # ms
    timing_queue: float = 0.0  # ms queued before admission
    timing_first_token: float = 0.0  # ms submit-to-first-token
    finish_reason: str = ""
    error: str = ""
    # load-shed backoff hint (seconds); >0 only on finish_reason="shed"
    # replies — the HTTP layer turns it into 429 + Retry-After
    retry_after_s: float = 0.0


@dataclass
class ModelLoadOptions:
    """ref: backend.proto ModelOptions (the subset the LLM worker reads)."""

    model: str = ""  # checkpoint dir, absolute or under model_path
    model_path: str = ""  # models dir
    context_size: int = 4096
    batch_slots: int = 8
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""
    quantization: str = ""  # "int8" (q8, q8_0, w8): weight-only int8
    # projections; "int8_full": also embed / lm_head; "" or none/bf16: off


@dataclass
class Result:
    success: bool = True
    message: str = ""


class Backend(abc.ABC):
    """One loaded model serving the LLM calls of the contract."""

    def health(self) -> bool:
        return True

    def cancel(self, request_id: str) -> None:
        """Abandon an in-flight request (client disconnect)."""

    @abc.abstractmethod
    def load_model(self, opts: ModelLoadOptions) -> Result: ...

    @abc.abstractmethod
    def predict(self, opts: PredictOptions) -> Reply: ...

    @abc.abstractmethod
    def predict_stream(self, opts: PredictOptions) -> Iterator[Reply]: ...

    def shutdown(self) -> None:
        """Release the model and its device memory."""
