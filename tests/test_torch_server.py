"""The port's HTTP server (localai_tfp_tpu_torch/server/) against the JAX
server on the same tiny Llama checkpoint and the same JSON-syntax
``tiny.yaml`` (JSON is YAML, so both packages read the one file).

``/v1/chat/completions`` content text, ``finish_reason`` and ``usage``
must be identical, streaming and not; the SSE framing (role delta first,
``data: [DONE]`` last) and ``/v1/models`` match field for field.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from localai_tfp_tpu.config.app_config import ApplicationConfig
from localai_tfp_tpu.server.app import build_app
from localai_tfp_tpu.server.state import Application
from localai_tfp_tpu_torch.config.loader import load_config_file
from localai_tfp_tpu_torch.server.app import build_server

# max_batch_slots covers every request of the module, so each lands on a
# fresh slot: the JAX engine's greedy output changes when a request
# reuses a slot whose resident prefix belongs to another prompt (a
# reference-side fault recorded in ROADMAP.md), which the port never does
TINY = {
    "name": "tiny", "backend": "jax-llm",
    "parameters": {"model": "tiny-ckpt", "temperature": 0.0,
                   "max_tokens": 8},
    "context_size": 128, "max_batch_slots": 8, "dtype": "float32",
    "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                 "chat": "{{.Input}}\nassistant:"},
}
CHATS = [
    {"model": "tiny", "messages": [{"role": "user", "content": "hello"}]},
    {"model": "tiny", "max_tokens": 5, "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "count to three please"}]},
    {"model": "tiny", "stop": ["e"], "max_tokens": 12,
     "messages": [{"role": "user", "content": "stop early"}]},
]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srv")
    models = root / "models"
    models.mkdir()
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256,
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

    def call(method, path, body=None):
        async def go():
            r = await tc.request(method, path, json=body)
            return r.status, r.headers.get("Content-Type", ""), \
                (await r.read()).decode()
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

    def call(method, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers.get("Content-Type", ""), \
                    r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Content-Type", ""), \
                e.read().decode()

    yield call
    srv.close()
    th.join(timeout=30)


def _parse_sse(text: str):
    frames = text.split("\n\n")
    assert frames[-2:] == ["data: [DONE]", ""], frames[-3:]
    chunks = [json.loads(f[len("data: "):]) for f in frames[:-2]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant",
                                                "content": ""}
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    content = "".join(c["choices"][0]["delta"].get("content", "")
                      for c in chunks[1:])
    last = chunks[-1]
    return content, last["choices"][0]["finish_reason"], last["usage"]


@pytest.mark.parametrize("i", range(len(CHATS)))
def test_chat_matches_jax_server(jax_client, torch_client, i):
    body = CHATS[i]
    js, jt, jbody = jax_client("POST", "/v1/chat/completions", body)
    ts, tt, tbody = torch_client("POST", "/v1/chat/completions", body)
    assert js == ts == 200, (jbody, tbody)
    assert jt == tt
    jo, to = json.loads(jbody), json.loads(tbody)
    assert to["object"] == jo["object"] == "chat.completion"
    assert set(to) == set(jo) and to["model"] == jo["model"]
    assert to["choices"] == jo["choices"]
    assert to["usage"] == jo["usage"]
    assert to["usage"]["completion_tokens"] > 0


@pytest.mark.parametrize("i", range(len(CHATS)))
def test_streaming_chat_matches_jax_server(jax_client, torch_client, i):
    body = {**CHATS[i], "stream": True}
    js, jt, jbody = jax_client("POST", "/v1/chat/completions", body)
    ts, tt, tbody = torch_client("POST", "/v1/chat/completions", body)
    assert js == ts == 200
    assert jt.startswith("text/event-stream") and tt.startswith(
        "text/event-stream")
    assert _parse_sse(tbody) == _parse_sse(jbody)


def test_models_and_readyz_match(jax_client, torch_client):
    assert torch_client("GET", "/v1/models")[2] == \
        jax_client("GET", "/v1/models")[2]
    status, _, body = torch_client("GET", "/readyz")
    assert status == 200 and json.loads(body) == {"status": "ok"}


def test_errors(torch_client):
    status, _, body = torch_client("POST", "/v1/chat/completions",
                                   {"model": "nope", "messages": [
                                       {"role": "user", "content": "x"}]})
    assert status == 404 and json.loads(body)["error"]["code"] == 404
    status, _, body = torch_client("POST", "/v1/chat/completions", {
        "model": "tiny", "timeout": -1,
        "messages": [{"role": "user", "content": "x"}]})
    assert status == 400 and "timeout" in body
    status, _, _ = torch_client("POST", "/v1/chat/completions",
                                {"model": "tiny", "messages": []})
    assert status == 400


def test_non_json_config_is_a_clear_error(tmp_path):
    """A config in real YAML reads (the port has its own YAML reader); a
    construct the reader does not read is an error naming the file and
    the line."""
    p = tmp_path / "yamlish.yaml"
    p.write_text("name: tiny\nbackend: jax-llm\n")
    (cfg,) = load_config_file(str(p))
    assert cfg.backend == "jax-llm"
    p.write_text("name: tiny\nbackend: !custom jax-llm\n")
    with pytest.raises(ValueError, match=r"yamlish\.yaml:2: tags"):
        load_config_file(str(p))
