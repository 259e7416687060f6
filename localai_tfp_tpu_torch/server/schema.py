"""Typed request schema and validation (the port's own copy of
localai_tfp_tpu/server/schema.py; ref: core/schema — openai.go,
prediction.go, localai.go, jina.go).

Every text route, ``/v1/embeddings``, ``/v1/rerank`` and the speech
routes pass their body
through a schema here first: fields are type-checked, so a malformed
request fails with a 400 naming the field (the JAX server's text,
``field '<name>' must be <want>``) instead of being coerced or surfacing
as a 500 from deep inside an endpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .app import HTTPError


def _bad(name: str, want: str):
    raise HTTPError(400, f"field '{name}' must be {want}")


def _num(body: dict, name: str) -> Optional[float]:
    v = body.get(name)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _bad(name, "a number")
    return float(v)


def _int(body: dict, name: str) -> Optional[int]:
    v = body.get(name)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        _bad(name, "an integer")
    return int(v)


def _str(body: dict, name: str) -> Optional[str]:
    v = body.get(name)
    if v is None:
        return None
    if not isinstance(v, str):
        _bad(name, "a string")
    return v


def _bool(body: dict, name: str) -> Optional[bool]:
    v = body.get(name)
    if v is None:
        return None
    if not isinstance(v, bool):
        _bad(name, "a boolean")
    return v


# the sampling surface shared by chat, completion and edit (ref:
# schema/prediction.go PredictionOptions)
_SAMPLING_NUM = ("temperature", "top_p", "min_p", "typical_p",
                 "repeat_penalty", "frequency_penalty", "presence_penalty",
                 "mirostat_tau", "mirostat_eta")
_SAMPLING_INT = ("top_k", "max_tokens", "max_completion_tokens", "seed",
                 "repeat_last_n", "n", "mirostat")


def _check_sampling(body: dict) -> None:
    for name in _SAMPLING_NUM:
        _num(body, name)
    for name in _SAMPLING_INT:
        _int(body, name)
    # the per-request deadline in seconds (the X-Request-Timeout header
    # is the no-body-change alternative)
    t = _num(body, "timeout")
    if t is not None and t < 0:
        _bad("timeout", "a non-negative number of seconds")
    stop = body.get("stop")
    if stop is not None and not isinstance(stop, (str, list)):
        _bad("stop", "a string or list of strings")
    if isinstance(stop, list) and not all(isinstance(s, str) for s in stop):
        _bad("stop", "a string or list of strings")
    lb = body.get("logit_bias")
    if lb is not None and not isinstance(lb, dict):
        _bad("logit_bias", "an object of token-id -> bias")
    _bool(body, "stream")
    _bool(body, "ignore_eos")


@dataclass
class ChatCompletionRequest:
    """POST /v1/chat/completions (ref: schema/openai.go)."""

    messages: list[dict] = field(default_factory=list)
    model: str = ""

    @classmethod
    def validate(cls, body: dict) -> "ChatCompletionRequest":
        msgs = body.get("messages")
        if not isinstance(msgs, list) or not msgs:
            _bad("messages", "a non-empty list of message objects")
        for m in msgs:
            if not isinstance(m, dict):
                _bad("messages", "a list of message objects")
            role = m.get("role")
            if role is not None and not isinstance(role, str):
                _bad("messages[].role", "a string")
            content = m.get("content")
            if content is not None and not isinstance(content, (str, list)):
                _bad("messages[].content", "a string or part list")
        tools = body.get("tools")
        if tools is not None and not isinstance(tools, list):
            _bad("tools", "a list")
        functions = body.get("functions")
        if functions is not None and not isinstance(functions, list):
            _bad("functions", "a list")
        rf = body.get("response_format")
        if rf is not None and not isinstance(rf, (str, dict)):
            _bad("response_format", "a string or object")
        _check_sampling(body)
        return cls(messages=msgs, model=_str(body, "model") or "")


@dataclass
class CompletionRequest:
    """POST /v1/completions."""

    prompt: Any = ""
    model: str = ""

    @classmethod
    def validate(cls, body: dict) -> "CompletionRequest":
        prompt = body.get("prompt")
        if prompt is not None and not isinstance(prompt, (str, list)):
            _bad("prompt", "a string or list of strings")
        if isinstance(prompt, list) and not all(
                isinstance(p, str) for p in prompt):
            _bad("prompt", "a string or list of strings")
        _check_sampling(body)
        return cls(prompt=prompt or "", model=_str(body, "model") or "")


@dataclass
class EditRequest:
    """POST /v1/edits."""

    instruction: str = ""
    input: str = ""

    @classmethod
    def validate(cls, body: dict) -> "EditRequest":
        _check_sampling(body)
        return cls(instruction=_str(body, "instruction") or "",
                   input=_str(body, "input") or "")


@dataclass
class EmbeddingsRequest:
    """POST /v1/embeddings."""

    input: Any = ""

    @classmethod
    def validate(cls, body: dict) -> "EmbeddingsRequest":
        inp = None
        for name in ("input", "prompt"):  # the route reads both
            v = body.get(name)
            if v is None:
                continue
            if not isinstance(v, (str, list)):
                _bad(name, "a string or list of strings")
            if isinstance(v, list) and not all(
                    isinstance(s, (str, int)) for s in v):
                _bad(name, "a string or list of strings")
            if inp is None:
                inp = v
        return cls(input=inp or "")


@dataclass
class TTSRequest:
    """POST /tts, /v1/audio/speech and the ElevenLabs route (ref:
    schema/localai.go TTSRequest): the text as ``input`` or ``text``, the
    voice as ``voice`` or ``voice_id``; each a string when present."""

    input: str = ""
    voice: str = ""

    @classmethod
    def validate(cls, body: dict) -> "TTSRequest":
        return cls(input=_str(body, "input") or _str(body, "text") or "",
                   voice=_str(body, "voice") or _str(body, "voice_id") or "")


@dataclass
class SoundGenerationRequest:
    """POST /v1/sound-generation (ref: schema/elevenlabs.go): the
    duration as ``duration_seconds`` (ElevenLabs' name) or ``duration``."""

    text: str = ""
    duration: Optional[float] = None
    temperature: Optional[float] = None

    @classmethod
    def validate(cls, body: dict) -> "SoundGenerationRequest":
        _bool(body, "do_sample")
        return cls(
            text=_str(body, "text") or "",
            duration=_num(body, "duration_seconds")
            if body.get("duration_seconds") is not None
            else _num(body, "duration"),
            temperature=_num(body, "temperature"),
        )


@dataclass
class RerankRequest:
    """POST /v1/rerank (ref: schema/jina.go)."""

    query: str = ""
    documents: list[str] = field(default_factory=list)
    top_n: Optional[int] = None

    @classmethod
    def validate(cls, body: dict) -> "RerankRequest":
        docs = body.get("documents")
        if not isinstance(docs, list) or not all(
                isinstance(d, str) for d in docs):
            _bad("documents", "a list of strings")
        q = body.get("query")
        if not isinstance(q, str):
            _bad("query", "a string")
        return cls(query=q, documents=docs, top_n=_int(body, "top_n"))
