"""Remote OpenAI-compatible backend: a model served by another server
(counterpart of localai_tfp_tpu/workers/remote.py).

Registered by name from ``external_backends.json`` (the reference's
external backends): predict, stream and embedding calls are proxied to
the remote's ``/v1/completions`` and ``/v1/embeddings``.
"""

from __future__ import annotations

import json
import urllib.error
from typing import Iterator

from ..utils.http import json_request
from .base import (Backend, EmbeddingResult, ModelLoadOptions,
                   PredictOptions, Reply, Result, StatusResponse,
                   TokenizationResponse)


class RemoteOpenAIBackend(Backend):
    """Proxies predict/embedding calls to a remote OpenAI-compatible API."""

    def __init__(self, base_url: str = "", api_key: str = "") -> None:
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = ""
        self._state = "UNINITIALIZED"

    def _req(self, path: str, payload: dict):
        return json_request(self.base_url + path, payload,
                            api_key=self.api_key)

    def load_model(self, opts: ModelLoadOptions) -> Result:
        for kv in opts.options:
            k, _, v = kv.partition("=")
            if k == "base_url":
                self.base_url = v.rstrip("/")
            elif k == "api_key":
                self.api_key = v
        if not self.base_url:
            return Result(False, "remote backend needs base_url")
        self.model = opts.model
        self._state = "READY"
        return Result(True, f"remote backend -> {self.base_url}")

    def health(self) -> bool:
        return self._state == "READY"

    def status(self) -> StatusResponse:
        return StatusResponse(state=self._state)

    def _payload(self, opts: PredictOptions) -> dict:
        p: dict = {
            "model": self.model or None,
            "prompt": opts.prompt,
            "max_tokens": opts.tokens or None,
            "temperature": opts.temperature,
            "top_p": opts.top_p if opts.top_p < 1 else None,
            "stop": opts.stop_prompts or None,
            "seed": opts.seed,
        }
        return {k: v for k, v in p.items() if v is not None}

    def predict(self, opts: PredictOptions) -> Reply:
        try:
            with self._req("/v1/completions", self._payload(opts)) as r:
                data = json.load(r)
        except (urllib.error.URLError, OSError, ValueError) as e:
            return Reply(error=f"remote backend: {e}")
        choice = (data.get("choices") or [{}])[0]
        usage = data.get("usage") or {}
        return Reply(
            message=choice.get("text", ""),
            tokens=usage.get("completion_tokens", 0),
            prompt_tokens=usage.get("prompt_tokens", 0),
            finish_reason=choice.get("finish_reason", ""),
        )

    def predict_stream(self, opts: PredictOptions) -> Iterator[Reply]:
        payload = self._payload(opts)
        payload["stream"] = True
        try:
            with self._req("/v1/completions", payload) as r:
                for raw in r:
                    line = raw.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    if line == "data: [DONE]":
                        break
                    try:
                        d = json.loads(line[6:])
                    except ValueError:
                        continue
                    ch = (d.get("choices") or [{}])[0]
                    text = ch.get("text") or (
                        (ch.get("delta") or {}).get("content", ""))
                    if text:
                        yield Reply(message=text)
                    if ch.get("finish_reason"):
                        yield Reply(finish_reason=ch["finish_reason"])
                        return
            yield Reply(finish_reason="stop")
        except (urllib.error.URLError, OSError) as e:
            yield Reply(error=f"remote backend: {e}")

    def embedding(self, opts: PredictOptions) -> EmbeddingResult:
        try:
            with self._req("/v1/embeddings", {
                "model": self.model or None,
                "input": opts.embeddings or opts.prompt,
            }) as r:
                data = json.load(r)
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise RuntimeError(f"remote backend: {e}") from e
        emb = ((data.get("data") or [{}])[0]).get("embedding") or []
        return EmbeddingResult(embeddings=[float(x) for x in emb])

    def tokenize_string(self, opts: PredictOptions) -> TokenizationResponse:
        try:
            with self._req("/v1/tokenize", {"content": opts.prompt}) as r:
                data = json.load(r)
            toks = data.get("tokens") or []
            return TokenizationResponse(length=len(toks), tokens=toks)
        except (urllib.error.URLError, OSError, ValueError):
            return TokenizationResponse()
