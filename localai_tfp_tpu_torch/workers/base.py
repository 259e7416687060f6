"""Backend worker contract (the port's own copy of the parts of
localai_tfp_tpu/workers/base.py the LLM, encoder, store and audio
workers use).

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
    embeddings: str = ""  # text to embed (proto: Embeddings)
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
    grammar: str = ""
    # lazy-grammar trigger words (ref: pb.GrammarTrigger, options.go:118;
    # grammar constrains only from the first trigger occurrence on)
    grammar_triggers: list[str] = field(default_factory=list)
    logit_bias: dict[int, float] = field(default_factory=dict)
    # encoded images of a chat's image parts, in [img-N] marker order
    images: list[bytes] = field(default_factory=list)
    mirostat: int = 0
    mirostat_eta: float = 0.0
    mirostat_tau: float = 0.0
    # on-disk prompt cache (ref: backend.proto PromptCachePath / All /
    # RO): restore the prompt's K/V rows from the file when it holds a
    # longer prefix; save them when the request finishes (``all``: the
    # generated rows too; ``ro``: never write)
    prompt_cache_path: str = ""
    prompt_cache_all: bool = False
    prompt_cache_ro: bool = False
    correlation_id: str = ""
    request_id: str = ""  # caller-chosen id enabling cancel() on
    # client disconnect (ref: llama.cpp task cancel)
    # per-request deadline budget in seconds (0 = engine default,
    # LOCALAI_REQUEST_DEADLINE_S; the engine enforces it while queued
    # and while decoding)
    timeout_s: float = 0.0


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
class TokenizationResponse:
    """ref: backend.proto TokenizationResponse."""

    length: int = 0
    tokens: list[int] = field(default_factory=list)


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
    draft_model: str = ""  # speculative decoding (proto DraftModel)
    n_draft: int = 0
    lora_adapters: list[str] = field(default_factory=list)  # merged at load
    lora_scales: list[float] = field(default_factory=list)  # missing: 1.0
    options: list[str] = field(default_factory=list)  # backend "k=v" pairs
    type: str = ""  # the config's ``type`` (the TTS worker: "OuteTTS")


@dataclass
class Result:
    success: bool = True
    message: str = ""


@dataclass
class EmbeddingResult:
    embeddings: list[float] = field(default_factory=list)


@dataclass
class TranscriptSegment:
    id: int = 0
    start: float = 0.0
    end: float = 0.0
    text: str = ""
    tokens: list[int] = field(default_factory=list)


@dataclass
class TranscriptResult:
    segments: list[TranscriptSegment] = field(default_factory=list)
    text: str = ""


@dataclass
class DocumentResult:
    index: int = 0
    text: str = ""
    relevance_score: float = 0.0


@dataclass
class RerankResult:
    results: list[DocumentResult] = field(default_factory=list)
    usage: dict[str, int] = field(default_factory=dict)


@dataclass
class VADSegment:
    start: float = 0.0
    end: float = 0.0


@dataclass
class VADResponse:
    segments: list[VADSegment] = field(default_factory=list)


@dataclass
class StatusResponse:
    state: str = "UNINITIALIZED"  # UNINITIALIZED|BUSY|READY|ERROR
    memory: dict[str, int] = field(default_factory=dict)


class Backend(abc.ABC):
    """One loaded model serving the calls of the contract it implements;
    the others raise ``NotImplementedError`` (a 501 at the HTTP layer)."""

    def health(self) -> bool:
        return True

    def cancel(self, request_id: str) -> None:
        """Abandon an in-flight request (client disconnect)."""

    @abc.abstractmethod
    def load_model(self, opts: ModelLoadOptions) -> Result: ...

    def predict(self, opts: PredictOptions) -> Reply:
        raise NotImplementedError

    def predict_stream(self, opts: PredictOptions) -> Iterator[Reply]:
        raise NotImplementedError

    def tokenize_string(self, opts: PredictOptions) -> TokenizationResponse:
        raise NotImplementedError

    def embedding(self, opts: PredictOptions) -> EmbeddingResult:
        raise NotImplementedError

    def stream_queue(self, opts: PredictOptions):
        """The engine's event queue for a streamed request (the HTTP
        routes stream from it)."""
        raise NotImplementedError("streaming through this backend")

    def rerank(self, query: str, documents: list[str],
               top_n: int = 0) -> RerankResult:
        raise NotImplementedError

    def stores_set(self, keys, values) -> Result:
        raise NotImplementedError

    def stores_delete(self, keys) -> Result:
        raise NotImplementedError

    def stores_get(self, keys):
        raise NotImplementedError

    def stores_find(self, key, top_k: int):
        raise NotImplementedError

    def audio_transcription(self, audio_path: str, language: str = "",
                            translate: bool = False) -> TranscriptResult:
        raise NotImplementedError

    def vad(self, audio: list[float]) -> VADResponse:
        raise NotImplementedError

    def tts(self, text: str, voice: str = "", dst: str = "",
            language: str = "") -> Result:
        raise NotImplementedError

    def sound_generation(self, text: str, dst: str = "", **kw) -> Result:
        raise NotImplementedError

    def status(self) -> StatusResponse:
        return StatusResponse(state="READY")

    def shutdown(self) -> None:
        """Release the model and its device memory."""
