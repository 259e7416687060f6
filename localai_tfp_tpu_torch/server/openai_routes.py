"""OpenAI-compatible routes of the port (counterpart of
localai_tfp_tpu/server/openai_routes.py: ``/v1/chat/completions``,
``/v1/completions`` and ``/v1/embeddings`` (also under
``/v1/engines/{model}/``), ``/v1/edits`` and ``/v1/tokenize``, each
streaming where the JAX route streams, plus ``/v1/models``).

A request's model is the path's, else the body's, else the ``X-Model``
header's: a config by that name whatever its usecase, else a bare
model directory of that name (served as ``{"name": n, "model": n}``),
else 404; with no name, the first config serving the route's usecase.
Every inference call runs inside the model's busy window, so the busy
watchdog sees it (streams too).

Response bodies and SSE framing match the JAX server field for field:
``chat.completion`` / ``chat.completion.chunk`` and ``text_completion``
objects, ``finish_reason``, ``usage``, a leading ``{"role": "assistant",
"content": ""}`` chat delta and a final ``data: [DONE]``. A config's
``echo``, ``cutstrings``, ``extract_regex``, ``trimspace`` and
``trimsuffix`` post-process every reply (``grammars/parse.py``), the
stream too.

Constrained output as in the JAX routes: ``tools`` / ``functions`` become
a functions grammar (``tool_calls`` in the reply, the streamed output
buffered and parsed at the end), ``response_format`` ``json_object`` /
``json_schema`` a schema grammar, the body's (or the config's)
``grammar`` is used as given, and ``logit_bias`` bans tokens. A deadline
(``timeout`` in the body, else the ``X-Request-Timeout`` header) that
expires before any output is a 504; one that expires mid-decode returns
the partial text with ``finish_reason: "deadline_exceeded"``.

Images: a chat to a model with a vision tower collects its ``image_url``
parts (``engine/templating.py``: ``[img-N]`` markers in the prompt) and
reads each one's bytes: a ``data:`` URL, bare base64, or an ``http(s)``
URL fetched with ``urllib`` (at most 32 MiB, else 413). An image the
decoder cannot read (``models/image_io.py``: not PNG, interlaced,
16-bit) is a 400 that names its format. To a text-only model image parts
are dropped, as in the JAX server.
"""

from __future__ import annotations

import base64
import binascii
import json
import queue
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any, Optional

from ..config.model_config import ModelConfig, Usecase
from ..engine.engine import StreamEvent
from ..grammars.json_schema import functions_grammar, schema_to_gbnf
from ..grammars.parse import (FinetuneStream, apply_finetune,
                              parse_function_call, parse_text_content)
from ..models import image_io
from ..telemetry.tracing import TRACER
from ..workers.base import PredictOptions, Reply
from ..workers.llm import final_reply
from . import schema
from .app import Handler, HTTPError
from .state import Application


def list_models(h: Handler, app: Application) -> None:
    h.send_json(200, {"object": "list", "data": [
        {"id": name, "object": "model", "owned_by": "localai_tfp_tpu"}
        for name in app.config_loader.names()]})


def _resolve(h: Handler, app: Application, body: dict,
             usecase: Usecase) -> ModelConfig:
    name = _model_name(h, body)
    cfg = app.config_loader.resolve(name, usecase)
    if cfg is None:
        raise HTTPError(404, f"model '{name}' not found" if name
                        else "no model available")
    return cfg


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
    logit_bias = {}
    for k, v in (body.get("logit_bias") or {}).items():
        try:
            logit_bias[int(k)] = float(v)
        except (ValueError, TypeError):
            pass
    # the body's fields are typed by the route's schema (server/schema.py)
    return PredictOptions(
        prompt=prompt,
        tokens=pick("max_tokens", p.max_tokens or 2048,
                    "max_completion_tokens"),
        temperature=pick("temperature", p.temperature or 0.0),
        top_p=pick("top_p", p.top_p if p.top_p is not None else 1.0),
        top_k=pick("top_k", p.top_k or 0),
        min_p=pick("min_p", p.min_p or 0.0),
        seed=body.get("seed", p.seed),
        repeat_penalty=pick("repeat_penalty", p.repeat_penalty),
        repeat_last_n=pick("repeat_last_n", p.repeat_last_n),
        frequency_penalty=pick("frequency_penalty", p.frequency_penalty),
        presence_penalty=pick("presence_penalty", p.presence_penalty),
        typical_p=pick("typical_p", p.typical_p
                       if p.typical_p is not None else 1.0),
        mirostat=pick("mirostat", p.mirostat or 0),
        mirostat_tau=pick("mirostat_tau", p.mirostat_tau
                          if p.mirostat_tau is not None else 5.0),
        mirostat_eta=pick("mirostat_eta", p.mirostat_eta
                          if p.mirostat_eta is not None else 0.1),
        stop_prompts=stop,
        ignore_eos=pick("ignore_eos", p.ignore_eos),
        grammar=body.get("grammar", "") or cfg.grammar or "",
        logit_bias=logit_bias,
        correlation_id=correlation_id,
        timeout_s=max(0.0, pick("timeout", 0.0) or 0.0),
    )


MEDIA_MAX_BYTES = 32 << 20  # cap per fetched image
MEDIA_FETCH_TIMEOUT_S = 30.0


def _media_url(part: dict) -> str:
    url = ""
    if isinstance(part.get("image_url"), dict):
        url = part["image_url"].get("url") or ""
    elif isinstance(part.get("image_url"), str):
        url = part["image_url"]
    return url or part.get("url") or part.get("data") or ""


def _media_bytes(part: dict) -> bytes:
    """One image part -> its encoded bytes (the JAX ``_fetch_media``'s
    sources and errors), checked to be an image the decoder reads."""
    url = _media_url(part)
    if not url:
        raise HTTPError(400, "image part has no url")
    if url.startswith("data:"):
        try:
            out = base64.b64decode(url.split(",", 1)[-1])
        except (binascii.Error, ValueError):
            raise HTTPError(400, "invalid data: URL base64") from None
        if not out:
            raise HTTPError(400, "empty data: URL")
    elif url.startswith(("http://", "https://")):
        try:
            with urllib.request.urlopen(
                    url, timeout=MEDIA_FETCH_TIMEOUT_S) as resp:
                out = resp.read(MEDIA_MAX_BYTES + 1)
        except (urllib.error.URLError, OSError, ValueError):
            raise HTTPError(400, f"could not fetch image: {url}") from None
        if len(out) > MEDIA_MAX_BYTES:
            raise HTTPError(413, f"image of more than {MEDIA_MAX_BYTES} "
                                 "bytes")
    else:
        try:
            out = base64.b64decode(url, validate=True)
        except (binascii.Error, ValueError):
            raise HTTPError(400, "unsupported image reference") from None
        if not out:
            raise HTTPError(400, "unsupported image reference")
    try:
        image_io.png_header(out)
    except image_io.UnsupportedImage as e:
        raise HTTPError(400, str(e)) from None
    return out


def _body(h: Handler) -> dict:
    """The JSON body, with the ``X-Request-Timeout`` header (seconds)
    as its ``timeout`` when the body sets none; a header that is not a
    number is a 400."""
    body = h.read_body()
    hdr = h.headers.get("X-Request-Timeout")
    if hdr and body.get("timeout") is None:
        try:
            body["timeout"] = float(hdr)
        except ValueError:
            raise HTTPError(400, "X-Request-Timeout must be a number of "
                                 "seconds") from None
    return body


def _grammar_for_request(cfg: ModelConfig, body: dict,
                         tools: list[dict]) -> str:
    """Grammar injection: tools → functions grammar; response_format
    json_schema/json_object → schema grammar (ref: chat.go:216-294)."""
    rf = body.get("response_format") or {}
    if isinstance(rf, str):
        rf = {"type": rf}
    if rf.get("type") == "json_schema":
        return schema_to_gbnf((rf.get("json_schema") or {}).get("schema"))
    if rf.get("type") == "json_object":
        return schema_to_gbnf(None)
    if tools:
        opts = cfg.function.grammar_options()
        if opts.get("disable"):
            return ""
        return functions_grammar(
            tools,
            parallel_calls=bool(opts.get("parallel_calls")),
            mixed_mode=bool(opts.get("mixed_mode")),
            prefix=opts.get("prefix", ""),
            expect_strings_after_json=bool(
                opts.get("expect_strings_after_json")),
            prop_order=(opts.get("properties_order") or "").split(",")
            if opts.get("properties_order") else None,
            name_key=cfg.function.function_name_key or "name",
            args_key=cfg.function.function_arguments_key or "arguments",
        )
    return ""


def _extract_tools(body: dict) -> tuple[list[dict], bool]:
    """Normalize tools[]/functions[] (ref: chat.go:250-294). Returns
    (function defs, tools_requested)."""
    tools = []
    if body.get("tools"):
        for t in body["tools"]:
            if (isinstance(t, dict) and t.get("type") == "function"
                    and isinstance(t.get("function"), dict)):
                tools.append(t["function"])
    elif body.get("functions"):
        tools = list(body["functions"])
    choice = body.get("tool_choice") or body.get("function_call")
    if choice == "none":
        return [], False
    if isinstance(choice, dict):
        want = (choice.get("function") or choice).get("name")
        tools = [t for t in tools if t.get("name") == want] or tools
    return tools, bool(tools)


def _tool_call_objects(calls) -> list[dict]:
    return [
        {
            "id": f"call_{uuid.uuid4().hex[:12]}",
            "type": "function",
            "index": i,
            "function": {"name": c.name, "arguments": c.arguments},
        }
        for i, c in enumerate(calls)
    ]


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
    """A shed request is backpressure: 429 with Retry-After. A deadline
    that expired before any output is a 504 (with partial output the
    reply is a 200 whose finish_reason is "deadline_exceeded")."""
    if reply.finish_reason == "shed":
        raise HTTPError(429, reply.error or "server overloaded", {
            "Retry-After": str(max(1, round(reply.retry_after_s or 1.0)))})
    if reply.finish_reason == "deadline_exceeded" and not reply.message:
        raise HTTPError(504, reply.error or "request deadline exceeded")


def _n_choices(body: dict, streaming: bool) -> int:
    n = body.get("n") or 1
    if n < 1 or n > 16:
        raise HTTPError(400, "'n' must be between 1 and 16")
    if streaming and n > 1:
        raise HTTPError(400, "'n' > 1 is not supported with streaming")
    return n


def _finetune_kw(cfg: ModelConfig, prompt: str) -> Optional[dict]:
    """apply_finetune's arguments for this config, or None when it
    post-processes nothing."""
    if not (cfg.parameters.echo or cfg.cutstrings or cfg.extract_regex
            or cfg.trimspace or cfg.trimsuffix):
        return None
    return dict(
        echo_prompt=prompt if cfg.parameters.echo else "",
        cutstrings=cfg.cutstrings, extract_regex=cfg.extract_regex,
        trimspace=cfg.trimspace, trimsuffix=cfg.trimsuffix,
    )


def _model_name(h: Handler, body: dict) -> Optional[str]:
    """The path's model, else the body's, else the X-Model header."""
    return (h.path_params.get("model") or body.get("model")
            or h.headers.get("X-Model"))


def _predict_all(backend, opts_list: list) -> list:
    """Every request at once (the engine batches them); their replies."""
    replies: list[Optional[Reply]] = [None] * len(opts_list)

    def run(i: int) -> None:
        replies[i] = backend.predict(opts_list[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(opts_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return replies


def chat_completions(h: Handler, app: Application) -> None:
    body = _body(h)
    schema.ChatCompletionRequest.validate(body)
    cfg = _resolve(h, app, body, Usecase.CHAT)
    messages = body["messages"]
    tools, tools_requested = _extract_tools(body)
    grammar = _grammar_for_request(cfg, body, tools)
    streaming = bool(body.get("stream"))
    n = _n_choices(body, streaming)
    corr = h.headers.get("X-Correlation-ID", "")
    opts = _predict_options(cfg, body, "", corr)
    backend = app.model_loader.load(cfg)
    # image parts: collected for a model with a vision tower, else dropped
    media: Optional[list] = ([] if getattr(backend, "vision", None)
                             is not None else None)
    opts.prompt = app.evaluator.template_messages(
        cfg, messages, tokenizer=getattr(backend, "tokenizer", None),
        functions=tools or None, use_function_template=tools_requested,
        media=media)
    if media:
        opts.images = [_media_bytes(p) for p in media]
    if grammar:
        opts.grammar = grammar
        # lazy-grammar triggers from the model config (function.grammar
        # .triggers: [{word: ...}])
        opts.grammar_triggers = [w for w in (
            t.get("word", "") if isinstance(t, dict) else str(t)
            for t in (cfg.function.grammar_options().get("triggers") or [])
        ) if w]
    extra_usage = ("Extra-Usage" in h.headers
                   or bool((body.get("stream_options") or {})
                           .get("include_usage")))
    created = int(time.time())
    cid = f"chatcmpl-{uuid.uuid4().hex[:28]}"
    if streaming:
        with app.busy(cfg.name):
            _stream_chat(h, backend, opts, cfg, cid, created,
                         tools_requested, extra_usage)
        return
    with app.busy(cfg.name):
        replies = _predict_all(backend, [opts] * n)
    ft_kw = _finetune_kw(cfg, opts.prompt)
    choices = []
    total = Reply()
    for i, reply in enumerate(replies):
        assert reply is not None
        _raise_if_refused(reply)
        if reply.error:
            raise HTTPError(500, reply.error)
        if ft_kw is not None:  # before the tool-call parse, as in JAX
            reply.message = apply_finetune(reply.message, **ft_kw)
        message: dict[str, Any] = {"role": "assistant"}
        finish = reply.finish_reason or "stop"
        calls = (parse_function_call(reply.message, cfg.function)
                 if tools_requested else None)
        if calls:
            message["tool_calls"] = _tool_call_objects(calls)
            message["content"] = (parse_text_content(reply.message,
                                                     cfg.function) or None)
            finish = "tool_calls"
        else:
            message["content"] = reply.message
        choices.append({"index": i, "message": message,
                        "finish_reason": finish})
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
                 tools_requested: bool, extra_usage: bool) -> None:
    """SSE: a role delta, one content delta per engine text event, the
    finish chunk with usage, then ``data: [DONE]``. With tools requested
    the output is buffered and parsed at the end: ``tool_calls`` deltas
    (finish_reason "tool_calls") when it holds calls, else one content
    delta."""
    opts.request_id = uuid.uuid4().hex
    # the request's trace opens before the engine can stamp it: the
    # HTTP milestones first, the engine's (queue ... done) after
    h.start_trace(opts.request_id, cfg.name)
    q = backend.stream_queue(opts)
    # a bounded-queue shed lands synchronously inside submit: refuse it
    # with a real 429 before the headers go out
    first: Optional[StreamEvent] = None
    try:
        first = q.get_nowait()
    except queue.Empty:
        pass
    if first is not None and first.done and first.finish_reason in (
            "shed", "deadline_exceeded"):
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
    ft_kw = _finetune_kw(cfg, opts.prompt)
    ft = FinetuneStream(**ft_kw) if ft_kw and not tools_requested else None
    try:
        h.wfile.write(chunk({"role": "assistant", "content": ""}))
        h.wfile.flush()
        ev = first if first is not None else q.get()
        buffered = ""
        while not ev.done:
            if tools_requested:
                buffered += ev.text
            elif ev.text:
                text = ft.feed(ev.text) if ft is not None else ev.text
                if text:
                    h.wfile.write(chunk({"content": text}))
                    h.wfile.flush()
            ev = q.get()
        if ft is not None:
            tail = ft.finish()
            if tail:
                h.wfile.write(chunk({"content": tail}))
        final = final_reply(ev)
        finish = final.finish_reason or "stop"
        if tools_requested:
            if ft_kw is not None:
                final.message = apply_finetune(final.message, **ft_kw)
                buffered = apply_finetune(buffered, **ft_kw)
            calls = parse_function_call(final.message, cfg.function)
            if calls:
                finish = "tool_calls"
                for tc in _tool_call_objects(calls):
                    h.wfile.write(chunk({"tool_calls": [tc]}))
            elif buffered:
                h.wfile.write(chunk({"content": buffered}))
        h.wfile.write(chunk({}, finish=finish,
                            usage=_usage(final, extra_usage)))
        h.wfile.write(b"data: [DONE]\n\n")
        h.wfile.flush()
        TRACER.event(opts.request_id, "stream_done")
    except (BrokenPipeError, ConnectionResetError):
        # client went away: free the slot instead of decoding on
        backend.cancel(opts.request_id)
        raise


# ------------------------------------------------------------- completion


def completions(h: Handler, app: Application) -> None:
    """``/v1/completions``: each prompt through ``template.completion``;
    ``n`` choices per prompt, all decoded at once; one prompt may
    stream."""
    body = _body(h)
    schema.CompletionRequest.validate(body)
    prompts = body.get("prompt", "")
    if isinstance(prompts, str):
        prompts = [prompts]
    cfg = _resolve(h, app, body, Usecase.COMPLETION)
    if not prompts:
        raise HTTPError(400, "prompt required")
    extra_usage = ("Extra-Usage" in h.headers
                   or bool((body.get("stream_options") or {})
                           .get("include_usage")))
    created = int(time.time())
    cid = f"cmpl-{uuid.uuid4().hex[:28]}"
    streaming = bool(body.get("stream"))
    n = _n_choices(body, streaming)
    if streaming and len(prompts) > 1:
        raise HTTPError(400, "multiple prompts are not supported with "
                             "streaming")
    corr = h.headers.get("X-Correlation-ID", "")
    backend = app.model_loader.load(cfg)
    if streaming:
        opts = _predict_options(cfg, body, app.evaluator.evaluate_completion(
            cfg, prompts[0]), corr)
        with app.busy(cfg.name):
            _stream_completion(h, backend, opts, cfg, cid, created,
                               extra_usage)
        return
    jobs = []
    for prompt in prompts:
        opts = _predict_options(cfg, body, app.evaluator.evaluate_completion(
            cfg, prompt), corr)
        jobs.extend((prompt, opts) for _ in range(n))
    with app.busy(cfg.name):
        replies = _predict_all(backend, [o for _, o in jobs])
    choices = []
    total = Reply()
    for i, ((prompt, o), reply) in enumerate(zip(jobs, replies)):
        _raise_if_refused(reply)
        if reply.error:
            raise HTTPError(500, reply.error)
        text = reply.message
        ft_kw = _finetune_kw(cfg, o.prompt)
        if ft_kw is not None:
            text = apply_finetune(text, **ft_kw)
        if body.get("echo"):
            text = prompt + text
        choices.append({"index": i, "text": text,
                        "finish_reason": reply.finish_reason or "stop"})
        if i % n == 0:  # each distinct prompt once, not n times
            total.prompt_tokens += reply.prompt_tokens
        total.tokens += reply.tokens
        total.timing_prompt_processing += reply.timing_prompt_processing
        total.timing_token_generation += reply.timing_token_generation
    h.send_json(200, {"id": cid, "object": "text_completion",
                      "created": created, "model": cfg.name,
                      "choices": choices,
                      "usage": _usage(total, extra_usage)})


def _stream_completion(h: Handler, backend, opts: PredictOptions,
                       cfg: ModelConfig, cid: str, created: int,
                       extra_usage: bool) -> None:
    """SSE: one ``text_completion`` chunk per engine text event
    (post-processed as the config says), the finish chunk with usage,
    then ``data: [DONE]``."""
    opts.request_id = uuid.uuid4().hex
    h.start_trace(opts.request_id, cfg.name)
    q = backend.stream_queue(opts)
    first: Optional[StreamEvent] = None
    try:
        first = q.get_nowait()
    except queue.Empty:
        pass
    if first is not None and first.done and first.finish_reason in (
            "shed", "deadline_exceeded"):
        _raise_if_refused(final_reply(first))

    def chunk(text: str, finish: Optional[str] = None,
              usage: Optional[dict] = None) -> bytes:
        payload: dict[str, Any] = {
            "id": cid, "object": "text_completion", "created": created,
            "model": cfg.name,
            "choices": [{"index": 0, "text": text, "finish_reason": finish}],
        }
        if usage is not None:
            payload["usage"] = usage
        return f"data: {json.dumps(payload)}\n\n".encode()

    ft_kw = _finetune_kw(cfg, opts.prompt)
    ft = FinetuneStream(**ft_kw) if ft_kw else None
    h.send_response(200)
    h.send_header("Content-Type", "text/event-stream")
    h.send_header("Cache-Control", "no-cache")
    h.send_header("Connection", "close")
    h.end_headers()
    try:
        ev = first if first is not None else q.get()
        while not ev.done:
            if ev.text:
                text = ft.feed(ev.text) if ft is not None else ev.text
                if text:
                    h.wfile.write(chunk(text))
                    h.wfile.flush()
            ev = q.get()
        if ft is not None:
            tail = ft.finish()
            if tail:
                h.wfile.write(chunk(tail))
        final = final_reply(ev)
        h.wfile.write(chunk("", finish=final.finish_reason or "stop",
                            usage=_usage(final, extra_usage)))
        h.wfile.write(b"data: [DONE]\n\n")
        h.wfile.flush()
        TRACER.event(opts.request_id, "stream_done")
    except (BrokenPipeError, ConnectionResetError):
        backend.cancel(opts.request_id)
        raise


# ------------------------------------------------------------------- edit


def edits(h: Handler, app: Application) -> None:
    """``/v1/edits``: each input with the instruction through
    ``template.edit``, one after another."""
    body = _body(h)
    schema.EditRequest.validate(body)
    cfg = _resolve(h, app, body, Usecase.EDIT)
    backend = app.model_loader.load(cfg)
    instruction = body.get("instruction", "")
    inputs = body.get("input", "")
    if isinstance(inputs, str):
        inputs = [inputs]
    corr = h.headers.get("X-Correlation-ID", "")
    choices = []
    total = Reply()
    for i, inp in enumerate(inputs):
        opts = _predict_options(cfg, body, app.evaluator.evaluate_edit(
            cfg, inp, instruction), corr)
        with app.busy(cfg.name):
            reply = backend.predict(opts)
        _raise_if_refused(reply)
        if reply.error:
            raise HTTPError(500, reply.error)
        text = reply.message
        ft_kw = _finetune_kw(cfg, opts.prompt)
        if ft_kw is not None:
            text = apply_finetune(text, **ft_kw)
        choices.append({"index": i, "text": text})
        total.prompt_tokens += reply.prompt_tokens
        total.tokens += reply.tokens
    h.send_json(200, {"object": "edit", "created": int(time.time()),
                      "choices": choices,
                      "usage": _usage(total, "Extra-Usage" in h.headers)})


# ------------------------------------------------------------------- misc


def tokenize(h: Handler, app: Application) -> None:
    """``/v1/tokenize``: the ids of ``content`` (or ``prompt``), no
    BOS."""
    body = h.read_body()
    cfg = _resolve(h, app, body, Usecase.TOKENIZE)
    backend = app.model_loader.load(cfg)
    res = backend.tokenize_string(PredictOptions(
        prompt=body.get("content", body.get("prompt", ""))))
    h.send_json(200, {"tokens": res.tokens})


def embeddings(h: Handler, app: Application) -> None:
    """``/v1/embeddings``: one vector per input (``input``, else
    ``prompt``; a string or a list of strings or ints), each the
    backend's ``embedding`` of its text, one after another."""
    body = _body(h)
    inputs = schema.EmbeddingsRequest.validate(body).input
    cfg = _resolve(h, app, body, Usecase.EMBEDDINGS)
    backend = app.model_loader.load(cfg)
    if isinstance(inputs, str):
        inputs = [inputs]
    data = []
    for i, text in enumerate(inputs):
        with app.busy(cfg.name):
            res = backend.embedding(PredictOptions(embeddings=str(text)))
        data.append({"object": "embedding", "index": i,
                     "embedding": res.embeddings})
    h.send_json(200, {"object": "list", "model": cfg.name, "data": data,
                      "usage": {"prompt_tokens": 0, "total_tokens": 0}})
