"""Per-model configuration files (the subset of
localai_tfp_tpu/config/model_config.py the chat route reads).

A model config is a ``*.yaml`` file in the models directory. This port
reads it with ``json``: the file must be written in JSON syntax, which is
also valid YAML, so the JAX server reads the very same file. A file that
is not JSON raises a clear error naming it. Field names and defaults are
the JAX package's (ref: core/config/backend_config.go SetDefaults).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Optional

# backends whose configs this port serves with its LLM worker (the JAX
# package's text-generation set, plus the port's own name)
LLM_BACKENDS = {"torch-llm", "jax-llm", "llama", "llama-cpp", "llama-grpc",
                "vllm", "transformers", "exllama2", ""}


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
    use_tokenizer_template: bool = False
    join_chat_messages_by_character: Optional[str] = None


@dataclass
class ModelConfig:
    name: str = ""
    backend: str = ""
    model: str = ""  # checkpoint dir (parameters.model)
    parameters: SamplingParams = field(default_factory=SamplingParams)
    template: TemplateConfig = field(default_factory=TemplateConfig)
    roles: dict[str, str] = field(default_factory=dict)
    system_prompt: str = ""
    stopwords: list[str] = field(default_factory=list)
    context_size: Optional[int] = None
    max_batch_slots: int = 8
    dtype: str = ""
    kv_cache_dtype: str = ""  # "" = same as dtype; "int8" quantizes KV
    quantization: str = ""  # weight-only int8: "int8" / "int8_full"

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
        cfg = cls(**{k: v for k, v in kw.items() if k != "template"})
        cfg.parameters = SamplingParams(**_filter(SamplingParams, params,
                                                  "parameters"))
        cfg.template = TemplateConfig(**_filter(TemplateConfig,
                                                data.get("template"),
                                                "template"))
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

    @property
    def serves_chat(self) -> bool:
        return (self.backend or "").lower() in LLM_BACKENDS

    def validate(self) -> bool:
        """Reject path traversal in the file-ish fields."""
        for val in (self.model, self.backend):
            if val and (val.startswith("/") or ".." in val):
                return False
        return True


def read_config_file(path: str) -> ModelConfig:
    """One JSON-syntax ``*.yaml`` model config."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{path}: model configs are read as JSON-syntax YAML by this "
            f"port and this file is not JSON ({e}); rewrite it in JSON "
            "syntax (a YAML reader is not ported yet)") from None
    return ModelConfig.from_dict(data)


def load_configs(models_path: str) -> dict[str, ModelConfig]:
    """Every ``*.yaml``/``*.yml`` config in the models directory, by name.
    Raises on a file that cannot be read, so a typo is never silent."""
    out: dict[str, ModelConfig] = {}
    for fname in sorted(os.listdir(models_path)):
        if not fname.endswith((".yaml", ".yml")):
            continue
        cfg = read_config_file(os.path.join(models_path, fname))
        if not cfg.validate():
            raise ValueError(f"{fname}: model path escapes the models dir")
        out[cfg.name] = cfg
    return out
