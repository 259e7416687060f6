"""Per-model configuration files (the subset of
localai_tfp_tpu/config/model_config.py the text routes and the model
lifecycle read).

A model config is a document of a ``*.yaml`` file in the models
directory, read by ``config/loader.py`` through the port's own YAML
reader (``config/yaml_lite.py``). Field names and defaults are the JAX
package's (ref: core/config/backend_config.go SetDefaults).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields
from typing import Any, Optional

# backends that serve text-generation usecases by default (the JAX
# package's set, plus the port's own name)
LLM_BACKENDS = {"torch-llm", "jax-llm", "llama", "llama-cpp", "llama-grpc",
                "vllm", "transformers", "exllama2", ""}


class Usecase(enum.IntFlag):
    """Usecase flags for default-model filtering (ref:
    core/config/backend_config.go:430-580 BackendConfigUsecases)."""

    ANY = 0
    CHAT = 1 << 0
    COMPLETION = 1 << 1
    EDIT = 1 << 2
    EMBEDDINGS = 1 << 3
    RERANK = 1 << 4
    IMAGE = 1 << 5
    TRANSCRIPT = 1 << 6
    TTS = 1 << 7
    SOUND_GENERATION = 1 << 8
    TOKENIZE = 1 << 9
    VAD = 1 << 10
    VIDEO = 1 << 11

    @classmethod
    def from_string(cls, s: str) -> "Usecase":
        return cls[s.strip().upper().replace("-", "_")]


def _filter(cls, data: Any, what: str) -> dict:
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ValueError(f"'{what}' must be a mapping")
    names = {f.name for f in fields(cls)}
    return {k: v for k, v in data.items() if k in names}


@dataclass
class SamplingParams:
    """Per-request defaults a model config may pin; a request overrides
    any subset."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    typical_p: Optional[float] = None
    max_tokens: Optional[int] = None
    echo: bool = False  # prepend the templated prompt to each reply
    ignore_eos: bool = False
    repeat_penalty: float = 0.0
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    mirostat: Optional[int] = None
    mirostat_tau: Optional[float] = None
    mirostat_eta: Optional[float] = None
    seed: Optional[int] = None


@dataclass
class TemplateConfig:
    """Prompt templating block (Go-template sources; see
    engine/templating.py)."""

    chat: str = ""
    chat_message: str = ""
    completion: str = ""  # /v1/completions: wraps each prompt
    edit: str = ""  # /v1/edits: renders input and instruction
    function: str = ""  # chat template used when tools are requested
    use_tokenizer_template: bool = False
    join_chat_messages_by_character: Optional[str] = None


@dataclass
class FunctionsConfig:
    """Tool-calling / grammar config (ref: pkg/functions/parse.go:16-60
    FunctionsConfig)."""

    disable_no_action: bool = False
    no_action_function_name: str = ""
    no_action_description_name: str = ""
    function_name_key: str = ""
    function_arguments_key: str = ""
    response_regex: list[str] = field(default_factory=list)
    json_regex_match: list[str] = field(default_factory=list)
    argument_regex: list[str] = field(default_factory=list)
    argument_regex_key_name: str = ""
    argument_regex_value_name: str = ""
    capture_llm_results: list[str] = field(default_factory=list)
    replace_function_results: list[dict] = field(default_factory=list)
    replace_llm_results: list[dict] = field(default_factory=list)
    grammar: dict = field(default_factory=dict)

    def grammar_options(self) -> dict:
        return self.grammar or {}


@dataclass
class TTSConfig:
    """The ``tts:`` block (ref: core/config/backend_config.go TTSConfig):
    the default voice of the TTS routes."""

    voice: str = ""
    audio_path: str = ""


@dataclass
class ModelConfig:
    name: str = ""
    backend: str = ""
    model: str = ""  # checkpoint dir (parameters.model)
    parameters: SamplingParams = field(default_factory=SamplingParams)
    template: TemplateConfig = field(default_factory=TemplateConfig)
    function: FunctionsConfig = field(default_factory=FunctionsConfig)
    roles: dict[str, str] = field(default_factory=dict)
    system_prompt: str = ""
    grammar: str = ""  # a GBNF grammar every request of the model obeys
    stopwords: list[str] = field(default_factory=list)
    # reply post-processing, in this order after ``parameters.echo``
    # (grammars/parse.py::apply_finetune)
    cutstrings: list[str] = field(default_factory=list)
    extract_regex: list[str] = field(default_factory=list)
    trimspace: list[str] = field(default_factory=list)
    trimsuffix: list[str] = field(default_factory=list)
    context_size: Optional[int] = None
    max_batch_slots: int = 8
    dtype: str = ""
    kv_cache_dtype: str = ""  # "" = same as dtype; "int8" quantizes KV
    quantization: str = ""  # weight-only int8: "int8" / "int8_full"
    draft_model: str = ""  # speculative decoding: the draft checkpoint
    n_draft: int = 0  # draft tokens per round (0: the worker's 4)
    # LoRA adapters merged at load (PEFT directories under the models
    # path): ``lora_adapters`` with ``lora_scales``, or one
    # ``lora_adapter`` with ``lora_scale``; a scale of 0 skips its adapter
    lora_adapter: str = ""
    lora_adapters: list[str] = field(default_factory=list)
    lora_scales: list[float] = field(default_factory=list)
    lora_scale: float = 0.0
    embeddings: bool = False  # an LLM config that also serves embeddings
    known_usecases: Optional[list[str]] = None  # overrides the guess
    isolation: str = ""  # "subprocess": not served by this port yet
    options: list[str] = field(default_factory=list)  # backend "k=v" pairs
    type: str = ""  # the model's kind where a backend serves several
    # ("OuteTTS" for the TTS worker's LLM-driven family)
    tts: TTSConfig = field(default_factory=TTSConfig)

    @classmethod
    def from_dict(cls, data: Any) -> "ModelConfig":
        if not isinstance(data, dict):
            raise ValueError(
                f"model config must be a mapping, got {type(data).__name__}")
        data = dict(data)
        params = data.pop("parameters", None) or {}
        if isinstance(params, str):  # `parameters: <model dir>` shorthand
            params = {"model": params}
        params = dict(params) if isinstance(params, dict) else params
        model = params.pop("model", "") if isinstance(params, dict) else ""
        kw = _filter(cls, data, "config")
        kw.pop("parameters", None)
        cfg = cls(**{k: v for k, v in kw.items()
                     if k not in ("template", "function", "tts")})
        cfg.parameters = SamplingParams(**_filter(SamplingParams, params,
                                                  "parameters"))
        cfg.template = TemplateConfig(**_filter(TemplateConfig,
                                                data.get("template"),
                                                "template"))
        cfg.function = FunctionsConfig(**_filter(FunctionsConfig,
                                                 data.get("function"),
                                                 "function"))
        cfg.tts = TTSConfig(**_filter(TTSConfig, data.get("tts"), "tts"))
        cfg.model = cfg.model or model
        cfg.set_defaults()
        return cfg

    def set_defaults(self) -> None:
        p = self.parameters
        if p.top_k is None:
            p.top_k = 40
        if p.top_p is None:
            p.top_p = 0.95
        if p.temperature is None:
            p.temperature = 0.9
        if p.max_tokens is None:
            p.max_tokens = 2048
        if self.context_size is None:
            self.context_size = 4096
        if not self.name and self.model:
            self.name = self.model

    # -- usecase filtering (ref: backend_config.go:430-580) --

    def usecases(self) -> Usecase:
        if self.known_usecases is not None:
            flags = Usecase.ANY
            for s in self.known_usecases:
                try:
                    flags |= Usecase.from_string(s)
                except KeyError:
                    pass
            return flags
        return self._guess_usecases()

    def _guess_usecases(self) -> Usecase:
        flags = Usecase.ANY
        b = (self.backend or "").lower()
        if self.embeddings or b in ("sentencetransformers", "embeddings",
                                    "huggingface-embeddings",
                                    "jax-embeddings", "torch-embeddings"):
            flags |= Usecase.EMBEDDINGS
        if b in ("rerankers", "rerank", "jax-rerank", "torch-rerank"):
            flags |= Usecase.RERANK
        if b in ("diffusers", "stablediffusion", "flux", "jax-diffusion"):
            flags |= Usecase.IMAGE | Usecase.VIDEO
        if b in ("whisper", "faster-whisper", "jax-whisper"):
            flags |= Usecase.TRANSCRIPT
        if b in ("tts", "piper", "bark", "bark-cpp", "coqui", "kokoro",
                 "jax-tts"):
            flags |= Usecase.TTS | Usecase.SOUND_GENERATION
        if b in ("silero-vad", "vad", "jax-vad"):
            flags |= Usecase.VAD
        if b in LLM_BACKENDS:
            flags |= (Usecase.CHAT | Usecase.COMPLETION | Usecase.EDIT
                      | Usecase.TOKENIZE)
        return flags

    def has_usecase(self, u: Usecase) -> bool:
        if u == Usecase.ANY:
            return True
        return bool(self.usecases() & u)

    def validate(self) -> bool:
        """Reject path traversal in the file-ish fields."""
        for val in (self.model, self.backend, self.draft_model):
            if val and (val.startswith("/") or ".." in val):
                return False
        return True

