"""OpenAI-compatible routes of the port (counterpart of
localai_tfp_tpu/server/openai_routes.py: ``/v1/chat/completions``
streaming and not, ``/v1/models``, plus ``/readyz``).

Response bodies and SSE framing match the JAX server field for field:
``chat.completion`` / ``chat.completion.chunk`` objects, ``finish_reason``,
``usage``, a leading ``{"role": "assistant", "content": ""}`` delta and a
final ``data: [DONE]``. Tool calls, grammars and ``response_format`` are
refused with a 400 (not ported yet) rather than ignored.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from typing import Any, Optional

from ..config.model_config import ModelConfig
from ..engine.engine import StreamEvent
from ..workers.base import PredictOptions, Reply
from ..workers.llm import final_reply
from .app import Application, Handler, HTTPError

# request fields whose features this slice does not serve
_UNSERVED = ("tools", "functions", "response_format", "grammar",
             "logit_bias")


def readyz(h: Handler, app: Application) -> None:
    h.send_json(200, {"status": "ok"})


def list_models(h: Handler, app: Application) -> None:
    h.send_json(200, {"object": "list", "data": [
        {"id": name, "object": "model", "owned_by": "localai_tfp_tpu"}
        for name in sorted(app.configs)]})


def _predict_options(cfg: ModelConfig, body: dict, prompt: str,
                     correlation_id: str = "") -> PredictOptions:
    """Merge request sampling over the config's defaults (same merge as
    the JAX server)."""
    p = cfg.parameters

    def pick(key: str, default, *aliases):
        for k in (key, *aliases):
            if body.get(k) is not None:
                return body[k]
        return default

    stop = pick("stop", None)
    if isinstance(stop, str):
        stop = [stop]
    stop = list(stop or []) + list(cfg.stopwords or [])
    return PredictOptions(
        prompt=prompt,
        tokens=int(pick("max_tokens", p.max_tokens or 2048,
                        "max_completion_tokens")),
        temperature=float(pick("temperature", p.temperature or 0.0)),
        top_p=float(pick("top_p", p.top_p if p.top_p is not None else 1.0)),
        top_k=int(pick("top_k", p.top_k or 0)),
        min_p=float(pick("min_p", p.min_p or 0.0)),
        seed=body.get("seed", p.seed),
        repeat_penalty=float(pick("repeat_penalty", p.repeat_penalty)),
        repeat_last_n=int(pick("repeat_last_n", p.repeat_last_n)),
        frequency_penalty=float(pick("frequency_penalty",
                                     p.frequency_penalty)),
        presence_penalty=float(pick("presence_penalty", p.presence_penalty)),
        typical_p=float(pick("typical_p", p.typical_p
                             if p.typical_p is not None else 1.0)),
        mirostat=int(pick("mirostat", p.mirostat or 0)),
        mirostat_tau=float(pick("mirostat_tau", p.mirostat_tau
                                if p.mirostat_tau is not None else 5.0)),
        mirostat_eta=float(pick("mirostat_eta", p.mirostat_eta
                                if p.mirostat_eta is not None else 0.1)),
        stop_prompts=stop,
        ignore_eos=bool(pick("ignore_eos", p.ignore_eos)),
        correlation_id=correlation_id,
    )


def _usage(reply: Reply, extra_usage: bool) -> dict:
    u = {
        "prompt_tokens": reply.prompt_tokens,
        "completion_tokens": reply.tokens,
        "total_tokens": reply.prompt_tokens + reply.tokens,
    }
    if extra_usage:
        u["timing_prompt_processing"] = reply.timing_prompt_processing
        u["timing_token_generation"] = reply.timing_token_generation
        u["timing_queue"] = reply.timing_queue
        u["timing_first_token"] = reply.timing_first_token
    return u


def _raise_if_refused(reply: Reply) -> None:
    """A shed request is backpressure: 429 with Retry-After."""
    if reply.finish_reason == "shed":
        raise HTTPError(429, reply.error or "server overloaded", {
            "Retry-After": str(max(1, round(reply.retry_after_s or 1.0)))})


def _n_choices(body: dict, streaming: bool) -> int:
    try:
        n = int(body.get("n") or 1)
    except (TypeError, ValueError):
        raise HTTPError(400, "'n' must be an integer") from None
    if n < 1 or n > 16:
        raise HTTPError(400, "'n' must be between 1 and 16")
    if streaming and n > 1:
        raise HTTPError(400, "'n' > 1 is not supported with streaming")
    return n


def chat_completions(h: Handler, app: Application) -> None:
    body = h.read_body()
    cfg = app.resolve_config(body.get("model") or h.headers.get("X-Model"))
    messages = body.get("messages") or []
    if not isinstance(messages, list) or not messages:
        raise HTTPError(400, "messages required")
    for key in _UNSERVED:
        if body.get(key):
            raise HTTPError(400, f"'{key}' is not supported by this port yet")
    streaming = bool(body.get("stream"))
    n = _n_choices(body, streaming)
    corr = h.headers.get("X-Correlation-ID", "")
    try:
        opts = _predict_options(cfg, body, "", corr)
    except (TypeError, ValueError) as e:
        raise HTTPError(400, f"invalid sampling parameter: {e}") from None
    backend = app.backend(cfg)
    opts.prompt = app.evaluator.template_messages(cfg, messages)
    extra_usage = ("Extra-Usage" in h.headers
                   or bool((body.get("stream_options") or {})
                           .get("include_usage")))
    created = int(time.time())
    cid = f"chatcmpl-{uuid.uuid4().hex[:28]}"
    if streaming:
        _stream_chat(h, backend, opts, cfg, cid, created, extra_usage)
        return
    replies: list[Optional[Reply]] = [None] * n

    def run(i: int) -> None:
        replies[i] = backend.predict(opts)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    choices = []
    total = Reply()
    for i, reply in enumerate(replies):
        assert reply is not None
        _raise_if_refused(reply)
        if reply.error:
            raise HTTPError(500, reply.error)
        choices.append({
            "index": i,
            "message": {"role": "assistant", "content": reply.message},
            "finish_reason": reply.finish_reason or "stop",
        })
        if i == 0:  # one shared prompt: count it once
            total.prompt_tokens = reply.prompt_tokens
        total.tokens += reply.tokens
        total.timing_prompt_processing += reply.timing_prompt_processing
        total.timing_token_generation += reply.timing_token_generation
    h.send_json(200, {
        "id": cid,
        "object": "chat.completion",
        "created": created,
        "model": cfg.name,
        "choices": choices,
        "usage": _usage(total, extra_usage),
    })


def _stream_chat(h: Handler, backend, opts: PredictOptions,
                 cfg: ModelConfig, cid: str, created: int,
                 extra_usage: bool) -> None:
    """SSE: a role delta, one content delta per engine text event, the
    finish chunk with usage, then ``data: [DONE]``."""
    opts.request_id = uuid.uuid4().hex
    q = backend.stream_queue(opts)
    # a bounded-queue shed lands synchronously inside submit: refuse it
    # with a real 429 before the headers go out
    first: Optional[StreamEvent] = None
    try:
        first = q.get_nowait()
    except queue.Empty:
        pass
    if first is not None and first.done and first.finish_reason == "shed":
        _raise_if_refused(final_reply(first))

    def chunk(delta: dict, finish: Optional[str] = None,
              usage: Optional[dict] = None) -> bytes:
        payload: dict[str, Any] = {
            "id": cid,
            "object": "chat.completion.chunk",
            "created": created,
            "model": cfg.name,
            "choices": [{"index": 0, "delta": delta,
                         "finish_reason": finish}],
        }
        if usage is not None:
            payload["usage"] = usage
        return f"data: {json.dumps(payload)}\n\n".encode()

    h.send_response(200)
    h.send_header("Content-Type", "text/event-stream")
    h.send_header("Cache-Control", "no-cache")
    h.send_header("Connection", "close")
    h.end_headers()
    try:
        h.wfile.write(chunk({"role": "assistant", "content": ""}))
        h.wfile.flush()
        ev = first if first is not None else q.get()
        while not ev.done:
            if ev.text:
                h.wfile.write(chunk({"content": ev.text}))
                h.wfile.flush()
            ev = q.get()
        final = final_reply(ev)
        h.wfile.write(chunk({}, finish=final.finish_reason or "stop",
                            usage=_usage(final, extra_usage)))
        h.wfile.write(b"data: [DONE]\n\n")
        h.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        # client went away: free the slot instead of decoding on
        backend.cancel(opts.request_id)
        raise
