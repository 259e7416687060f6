"""Constrained output and deadlines over HTTP: the port's server
(localai_tfp_tpu_torch/server/) against the JAX server on the same tiny
Llama checkpoint and the same JSON-syntax model config.

Bodies must be equal apart from ids and timestamps for a raw GBNF
``grammar``, ``response_format`` (``json_schema`` and ``json_object``),
``tools`` (non-streaming and streaming, ``tool_calls`` chunks included)
and ``logit_bias``. ``X-Request-Timeout`` that has passed before the
request is served gives a 504 on both; a deadline that expires
mid-decode gives a 200 whose ``finish_reason`` is ``deadline_exceeded``
and whose text is a prefix of the undeadlined greedy text, on both.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from localai_tfp_tpu.config.app_config import ApplicationConfig
from localai_tfp_tpu.server.app import build_app
from localai_tfp_tpu.server.state import Application
from localai_tfp_tpu_torch.grammars.gbnf import GrammarMatcher, parse_gbnf
from localai_tfp_tpu_torch.grammars.json_schema import (
    functions_grammar,
    schema_to_gbnf,
)
from localai_tfp_tpu_torch.server.app import build_server

TINY = {
    "name": "tiny", "backend": "jax-llm",
    "parameters": {"model": "tiny-ckpt", "temperature": 0.0,
                   "max_tokens": 8},
    "context_size": 256, "max_batch_slots": 8, "dtype": "float32",
    "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                 "chat": "{{.Input}}\nassistant:",
                 "function": "tools: {{range .Functions}}{{.name}} "
                             "{{end}}\n{{.Input}}\nassistant:"},
}
YES_NO = 'root ::= "yes" | "no"'
PERSON = {"type": "object",
          "properties": {"name": {"type": "string"},
                         "age": {"type": "integer"}},
          "required": ["name", "age"]}
TOOLS = [{"type": "function", "function": {
    "name": "set_unit",
    "parameters": {"type": "object",
                   "properties": {"unit": {"enum": ["c", "f"]}},
                   "required": ["unit"]}}}]


def _msgs(text):
    return [{"role": "user", "content": text}]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srv_features")
    models = root / "models"
    models.mkdir()
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512,
    )).save_pretrained(models / "tiny-ckpt", safe_serialization=True)
    (models / "tiny.yaml").write_text(json.dumps(TINY, indent=1))
    return root


@pytest.fixture(scope="module")
def jax_client(workdir):
    loop = asyncio.new_event_loop()
    state = Application(ApplicationConfig(
        models_path=str(workdir / "models"),
        generated_content_dir=str(workdir / "generated"),
        upload_dir=str(workdir / "uploads"),
        config_dir=str(workdir / "configuration")))
    tc = TestClient(TestServer(build_app(state)), loop=loop)
    loop.run_until_complete(tc.start_server())

    def call(body, headers=None):
        async def go():
            r = await tc.request("POST", "/v1/chat/completions", json=body,
                                 headers=headers or {})
            return r.status, (await r.read()).decode()
        return loop.run_until_complete(go())

    yield call
    loop.run_until_complete(tc.close())
    loop.close()


@pytest.fixture(scope="module")
def torch_client(workdir):
    srv = build_server(str(workdir / "models"), port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def call(body, headers=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions", method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    yield call
    srv.close()
    th.join(timeout=30)


def _norm(obj):
    """Drop what differs by design: ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _sse(text):
    frames = text.split("\n\n")
    assert frames[-2:] == ["data: [DONE]", ""], frames[-3:]
    return [_norm(json.loads(f[len("data: "):])) for f in frames[:-2]]


def _both(jax_client, torch_client, body, headers=None):
    js, jb = jax_client(body, headers)
    ts, tb = torch_client(body, headers)
    assert js == ts == 200, (jb, tb)
    if body.get("stream"):
        return _sse(jb), _sse(tb)
    return _norm(json.loads(jb)), _norm(json.loads(tb))


def _content(obj):
    return obj["choices"][0]["message"]["content"]


def test_raw_grammar_matches_jax(jax_client, torch_client):
    body = {"model": "tiny", "grammar": YES_NO, "max_tokens": 8,
            "messages": _msgs("answer yes or no")}
    want, got = _both(jax_client, torch_client, body)
    assert got == want
    assert got["choices"][0]["finish_reason"] == "stop"
    assert _content(got) in ("yes", "no")


def test_logit_bias_bans_the_first_pick_matches_jax(jax_client,
                                                    torch_client):
    body = {"model": "tiny", "grammar": YES_NO, "max_tokens": 8,
            "messages": _msgs("answer yes or no")}
    _, first = _both(jax_client, torch_client, body)
    ban = {str(ord(_content(first)[0])): -100}
    want, got = _both(jax_client, torch_client, {**body, "logit_bias": ban})
    assert got == want
    assert got["choices"][0]["finish_reason"] == "stop"
    assert {_content(got), _content(first)} == {"yes", "no"}


@pytest.mark.parametrize("fmt", [
    {"type": "json_schema", "json_schema": {"schema": PERSON}},
    {"type": "json_object"},
])
def test_response_format_matches_jax(jax_client, torch_client, fmt):
    body = {"model": "tiny", "response_format": fmt, "max_tokens": 48,
            "messages": _msgs("describe a person as JSON")}
    want, got = _both(jax_client, torch_client, body)
    assert got == want
    schema = fmt.get("json_schema", {}).get("schema")
    m = GrammarMatcher(parse_gbnf(schema_to_gbnf(schema)))
    st = m.accept_string(m.initial_state(), _content(got))
    if got["choices"][0]["finish_reason"] == "stop":
        assert m.can_end(st)
    else:
        assert st  # a live prefix


def _tool_call_names(obj):
    return [c["function"]["name"]
            for c in obj["choices"][0]["message"].get("tool_calls") or []]


def test_tools_matches_jax(jax_client, torch_client):
    body = {"model": "tiny", "tools": TOOLS, "max_tokens": 64,
            "messages": _msgs("set the unit")}
    want, got = _both(jax_client, torch_client, body)
    assert got == want
    if got["choices"][0]["finish_reason"] == "tool_calls":
        assert _tool_call_names(got) == ["set_unit"]
    else:  # cut by max_tokens: a live prefix of the functions grammar
        m = GrammarMatcher(parse_gbnf(functions_grammar(
            [t["function"] for t in TOOLS])))
        assert m.accept_string(m.initial_state(), _content(got))


def test_streaming_tools_matches_jax(jax_client, torch_client):
    body = {"model": "tiny", "tools": TOOLS, "max_tokens": 64,
            "stream": True, "messages": _msgs("set the unit")}
    want, got = _both(jax_client, torch_client, body)
    assert got == want
    finish = got[-1]["choices"][0]["finish_reason"]
    calls = [c for ch in got for c in
             ch["choices"][0]["delta"].get("tool_calls", [])]
    assert (finish == "tool_calls") == bool(calls)


def test_expired_request_timeout_header_is_a_504(jax_client, torch_client):
    body = {"model": "tiny", "max_tokens": 8, "messages": _msgs("late")}
    hdr = {"X-Request-Timeout": "0.000001"}
    js, jb = jax_client(body, hdr)
    ts, tb = torch_client(body, hdr)
    assert js == ts == 504, (jb, tb)
    assert "deadline exceeded" in jb and "deadline exceeded" in tb
    ts, tb = torch_client(body, {"X-Request-Timeout": "soon"})
    assert ts == 400 and "X-Request-Timeout" in tb


def test_deadline_mid_decode_returns_partial_text(jax_client, torch_client):
    """A deadline searched for on each server until it expires mid-decode:
    each reply is a 504 (nothing produced yet, or a queued request's
    predicted prefill overruns its deadline: the deadline goes up), the
    whole text (the deadline came after the end: it goes down), or a 200
    with finish_reason deadline_exceeded and a non-empty prefix of the
    undeadlined greedy text; at least one partial 200 on both servers.
    The search starts at half a warm generation's time, and the host's
    load moves only where it ends."""
    body = {"model": "tiny", "max_tokens": 200, "ignore_eos": True,
            "messages": _msgs("count")}
    for client in (jax_client, torch_client):
        runs = []
        for _ in range(3):  # the first builds every step shape
            t0 = time.perf_counter()
            status, full = client(body)
            runs.append(time.perf_counter() - t0)
            assert status == 200
        full = _content(json.loads(full))
        lo, hi = 0.0, None  # deadlines known too short / too long
        deadline = min(runs[1:]) * 0.5
        partial = 0
        for _ in range(12):
            status, text = client(body, {
                "X-Request-Timeout": f"{deadline:.4f}"})
            if status == 504:
                # a queued request refused by the cost scheduler's
                # predicted prefill gets the engine's other deadline text
                # (both packages send it)
                assert ("deadline exceeded" in text
                        or "predicted completion exceeds deadline" in text)
                lo = deadline
            else:
                assert status == 200, text
                reply = json.loads(text)["choices"][0]
                got = reply["message"]["content"]
                if reply["finish_reason"] == "length":
                    assert got == full
                    hi = deadline
                else:
                    assert reply["finish_reason"] == "deadline_exceeded"
                    assert got and full.startswith(got)
                    partial += 1
                    break
            deadline = (lo + hi) / 2 if hi is not None else deadline * 2
        assert partial, client
