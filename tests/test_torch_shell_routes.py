"""The port's server shell (localai_tfp_tpu_torch/server/app.py's
middlewares, server/localai_routes.py, model resolution) against the JAX
aiohttp server, each built from the same application config over the
same models directory, on the same requests.

Statuses and JSON bodies must be equal; where the JAX server answers
with aiohttp's plain-text error (``web.HTTPNotFound(reason=...)``) the
port answers the same status with the reason in its JSON error.
Covered: API-key auth (Bearer, ``x-api-key``) and its exempt paths,
``Machine-Tag``, ``X-Correlation-ID`` adopted or minted, the CORS
preflight and allow headers, 413 over the upload limit, 501 for a
backend without the call, 500 for a failed load, opaque errors,
``/healthz``, ``/readyz``, ``/version``, the ``/system`` keys and its
device row, ``/backend/monitor`` 400/404/200, ``/backend/shutdown``,
``disable_metrics``, and a bare model directory served without a YAML
(``test_bare_model_directory_is_served_as_by_jax``).
"""

import asyncio
import http.client
import json
import re
import socket
import threading

import pytest
import torch

from localai_tfp_tpu.engine import loader as jl
from localai_tfp_tpu.workers import base as jb
from localai_tfp_tpu_torch.engine import loader as tl
from localai_tfp_tpu_torch.workers import base as tb

KEY = "sk-test"
TINY = {"name": "tiny", "backend": "jax-llm",
        "parameters": {"model": "tiny-ckpt", "temperature": 0.0,
                       "max_tokens": 4},
        "context_size": 128, "max_batch_slots": 2, "dtype": "float32"}
STUB = {"name": "stub", "backend": "fake-501",
        "parameters": {"model": "tiny-ckpt"}}
FAILING = {"name": "failing", "backend": "fake-fail",
           "parameters": {"model": "tiny-ckpt"}}
CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "hi"}]}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fakes(base):
    class Stub(base.Backend):
        def load_model(self, opts):
            return base.Result(True)

        def predict(self, opts):
            raise NotImplementedError("predict")

        def predict_stream(self, opts):
            raise NotImplementedError("predict_stream")

    class Failing(Stub):
        def load_model(self, opts):
            return base.Result(False, "weights unreadable")

    return Stub, Failing


@pytest.fixture(scope="module", autouse=True)
def fake_backends():
    for reg, base in ((jl.registry, jb), (tl.registry, tb)):
        stub, failing = _fakes(base)
        reg.register("fake-501", stub)
        reg.register("fake-fail", failing)
    yield
    for reg in (jl.registry, tl.registry):
        reg.unregister("fake-501")
        reg.unregister("fake-fail")


def _tiny_checkpoint(path) -> None:
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256,
    )).save_pretrained(path, safe_serialization=True)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("shell_models")
    _tiny_checkpoint(root / "tiny-ckpt")
    for cfg in (TINY, STUB, FAILING):
        (root / f"{cfg['name']}.yaml").write_text(json.dumps(cfg))
    return root


class Pair:
    """The JAX server (aiohttp test server) and the port's (stdlib server
    on a thread), built from the same config fields. ``call`` returns
    (status, headers, body bytes) of each."""

    def __init__(self, tmp, models, **fields) -> None:
        from aiohttp.test_utils import TestClient, TestServer

        from localai_tfp_tpu.config.app_config import \
            ApplicationConfig as JaxConfig
        from localai_tfp_tpu.server.app import build_app
        from localai_tfp_tpu.server.state import Application as JaxApp
        from localai_tfp_tpu_torch.config.app_config import \
            ApplicationConfig
        from localai_tfp_tpu_torch.server.app import Server
        from localai_tfp_tpu_torch.server.state import Application

        common = dict(models_path=str(models), config_dir=str(tmp / "conf"),
                      state_dir=str(tmp / "run"), **fields)
        self.loop = asyncio.new_event_loop()
        jstate = JaxApp(JaxConfig(
            generated_content_dir=str(tmp / "gen"),
            upload_dir=str(tmp / "up"), **common))
        self.tc = TestClient(TestServer(build_app(jstate)), loop=self.loop)
        self.loop.run_until_complete(self.tc.start_server())
        self.app = Application(ApplicationConfig(
            address="127.0.0.1", port=0, **common), device="cpu")
        self.srv = Server(self.app)
        self.th = threading.Thread(target=self.srv.serve_forever,
                                   daemon=True)
        self.th.start()
        self.port = self.srv.server_address[1]

    def jax(self, method, path, body=None, headers=None):
        async def go():
            r = await self.tc.request(
                method, path, headers=headers or {},
                data=None if body is None else json.dumps(body))
            return r.status, dict(r.headers), await r.read()
        return self.loop.run_until_complete(go())

    def torch(self, method, path, body=None, headers=None):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        data = None if body is None else json.dumps(body).encode()
        c.request(method, path, body=data, headers=headers or {})
        r = c.getresponse()
        out = r.status, dict(r.getheaders()), r.read()
        c.close()
        return out

    def both(self, method, path, body=None, headers=None):
        return (self.jax(method, path, body, headers),
                self.torch(method, path, body, headers))

    def close(self) -> None:
        self.srv.close()
        self.th.join(timeout=30)
        self.loop.run_until_complete(self.tc.close())
        self.loop.close()


@pytest.fixture(scope="module")
def keyed(tmp_path_factory, models):
    p = Pair(tmp_path_factory.mktemp("keyed"), models, api_keys=[KEY],
             machine_tag="node-a", cors=True,
             cors_allow_origins="http://ok.example", upload_limit_mb=1)
    yield p
    p.close()


@pytest.fixture(scope="module")
def opaque(tmp_path_factory, models):
    p = Pair(tmp_path_factory.mktemp("opaque"), models, opaque_errors=True,
             disable_metrics=True)
    yield p
    p.close()


@pytest.fixture(scope="module")
def plain(tmp_path_factory, models):
    p = Pair(tmp_path_factory.mktemp("plain"), models)
    yield p
    p.close()


def _json(raw: bytes):
    return json.loads(raw)


def _same_json(a, b) -> None:
    assert a[0] == b[0]
    assert _json(a[2]) == _json(b[2])


def _same_status_reason(jres, tres, reason: str) -> None:
    """aiohttp's text error against the port's JSON one."""
    assert jres[0] == tres[0]
    assert reason in jres[2].decode()
    assert reason in _json(tres[2])["error"]["message"]


# ------------------------------------------------------------------ auth

@pytest.mark.parametrize("headers,status", [
    ({}, 401),
    ({"Authorization": "Bearer wrong"}, 401),
    ({"Authorization": f"Bearer {KEY}"}, 200),
    ({"x-api-key": KEY}, 200),
    ({"Authorization": KEY}, 401),  # no Bearer prefix
])
def test_auth_on_a_keyed_route(keyed, headers, status):
    j, t = keyed.both("GET", "/v1/models", headers=headers)
    assert j[0] == t[0] == status
    _same_json(j, t)


def test_chat_without_a_key_is_401(keyed):
    j, t = keyed.both("POST", "/v1/chat/completions", CHAT)
    assert t[0] == 401
    _same_json(j, t)
    assert _json(t[2]) == {"error": {"code": 401, "message": "unauthorized",
                                     "type": ""}}


@pytest.mark.parametrize("path", ["/healthz", "/readyz", "/version",
                                  "/metrics"])
def test_exempt_paths_answer_without_a_key(keyed, path):
    j, t = keyed.both("GET", path)
    assert j[0] == t[0] == 200
    if path != "/metrics":
        _same_json(j, t)
    else:
        assert t[1]["Content-Type"] == j[1]["Content-Type"]


def test_version_is_the_jax_version(plain):
    j, t = plain.both("GET", "/version")
    _same_json(j, t)
    assert _json(t[2]) == {"version": "0.1.0"}


# ------------------------------------------------------- response headers

@pytest.mark.parametrize("path,headers", [
    ("/healthz", {}),
    ("/v1/models", {}),  # a 401
    ("/v1/models", {"Authorization": f"Bearer {KEY}"}),
])
def test_machine_tag_and_minted_correlation_id(keyed, path, headers):
    j, t = keyed.both("GET", path, headers=headers)
    assert j[0] == t[0]
    for res in (j, t):
        assert res[1]["Machine-Tag"] == "node-a"
        assert re.fullmatch(r"[0-9a-f]{32}", res[1]["X-Correlation-ID"])


def test_sent_correlation_id_comes_back(keyed):
    h = {"X-Correlation-ID": "corr-123", "Authorization": f"Bearer {KEY}"}
    j, t = keyed.both("GET", "/v1/models", headers=h)
    assert j[1]["X-Correlation-ID"] == t[1]["X-Correlation-ID"] == "corr-123"


@pytest.mark.parametrize("origin,granted", [("http://ok.example", True),
                                            ("http://evil.example", False)])
def test_cors_preflight_and_allow_headers(keyed, origin, granted):
    pre = {"Origin": origin, "Access-Control-Request-Method": "POST"}
    j, t = keyed.both("OPTIONS", "/v1/chat/completions", headers=pre)
    assert j[0] == t[0] == 204
    for res in (j, t):
        assert res[1]["Machine-Tag"] == "node-a"
        assert "X-Correlation-ID" not in res[1]  # answered before it
        assert res[1].get("Access-Control-Allow-Origin") == (
            origin if granted else None)
    keys = ("Access-Control-Allow-Origin", "Vary",
            "Access-Control-Allow-Methods", "Access-Control-Allow-Headers")
    assert {k: j[1].get(k) for k in keys} == {k: t[1].get(k) for k in keys}
    # and on an ordinary response
    j, t = keyed.both("GET", "/healthz", headers={"Origin": origin})
    assert {k: j[1].get(k) for k in keys} == {k: t[1].get(k) for k in keys}


def test_body_over_the_upload_limit_is_413(keyed):
    big = {"model": "tiny", "messages": [{"role": "user",
                                          "content": "x" * (1 << 20)}]}
    j = keyed.jax("POST", "/v1/chat/completions", big,
                  {"Authorization": f"Bearer {KEY}"})
    # the port refuses on Content-Length before reading: send only the
    # headers, so the connection closes with nothing unread
    with socket.create_connection(("127.0.0.1", keyed.port), 30) as s:
        s.sendall(("POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                   f"Authorization: Bearer {KEY}\r\n"
                   "Content-Type: application/json\r\n"
                   f"Content-Length: {(1 << 20) + 100}\r\n\r\n").encode())
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    status = int(raw.split(b" ", 2)[1])
    assert j[0] == status == 413
    assert b"Machine-Tag: node-a" in raw
    with socket.create_connection(("127.0.0.1", keyed.port), 30) as s:
        s.sendall(("POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                   f"Authorization: Bearer {KEY}\r\n"
                   "Content-Length: lots\r\n\r\n").encode())
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    assert int(raw.split(b" ", 2)[1]) == 400


# ---------------------------------------------------------------- errors

def test_backend_without_the_call_is_501(plain):
    j, t = plain.both("POST", "/v1/embeddings",
                      {"model": "stub", "input": "x"})
    assert t[0] == 501
    _same_json(j, t)


def test_failed_load_is_500(plain):
    j, t = plain.both("POST", "/v1/chat/completions",
                      {**CHAT, "model": "failing"})
    assert t[0] == 500
    _same_json(j, t)
    assert "weights unreadable" in _json(t[2])["error"]["message"]


@pytest.mark.parametrize("path,body,status", [
    ("/v1/embeddings", {"model": "stub", "input": "x"}, 501),
    ("/v1/chat/completions", {**CHAT, "model": "failing"}, 500),
])
def test_opaque_errors(opaque, path, body, status):
    j, t = opaque.both("POST", path, body)
    _same_json(j, t)
    assert _json(t[2]) == {"error": {"code": status}}


def test_disabled_metrics_is_404(opaque):
    j, t = opaque.both("GET", "/metrics")
    assert j[0] == t[0] == 404


def test_unknown_model_is_404(plain):
    j, t = plain.both("POST", "/v1/chat/completions",
                      {**CHAT, "model": "nowhere"})
    _same_status_reason(j, t, "model 'nowhere' not found")


# ------------------------------------------------ system, monitor, shutdown

def test_system_keys_and_device_row(plain):
    from localai_tfp_tpu.utils.sysinfo import device_memory

    j, t = plain.both("GET", "/system")
    assert j[0] == t[0] == 200
    jb_, tb_ = _json(j[2]), _json(t[2])
    assert set(jb_) == set(tb_) == {"backends", "loaded_models", "devices",
                                    "device_memory", "uptime_s"}
    assert tb_["loaded_models"] == jb_["loaded_models"]
    assert "torch-llm" in tb_["backends"] and "jax-llm" in jb_["backends"]
    # no accelerator: one CPU row, as the JAX function's first
    assert tb_["device_memory"] == [device_memory()[0]]
    assert tb_["devices"] == ["cpu"] and tb_["uptime_s"] >= 0


def test_monitor_and_shutdown_lifecycle(plain):
    j, t = plain.both("GET", "/backend/monitor")
    assert j[0] == t[0] == 400
    j, t = plain.both("GET", "/backend/monitor?model=tiny")
    _same_status_reason(j, t, "model 'tiny' not loaded")
    j, t = plain.both("POST", "/v1/chat/completions", CHAT)
    assert j[0] == t[0] == 200
    assert _json(t[2])["choices"][0]["message"]["content"] == \
        _json(j[2])["choices"][0]["message"]["content"]
    j, t = plain.both("GET", "/backend/monitor?model=tiny")
    assert j[0] == t[0] == 200
    jm, tm_ = _json(j[2]), _json(t[2])
    assert set(tm_) == set(jm)
    # both workers add their weight pager's split (weights_hot_bytes,
    # weights_warm_bytes)
    assert set(tm_["memory_info"]) == set(jm["memory_info"])
    assert tm_["memory_info"]["weights_hot_bytes"] == \
        jm["memory_info"]["weights_hot_bytes"] > 0
    assert (tm_["status"], tm_["busy"]) == (jm["status"], jm["busy"]) == (
        "READY", False)
    assert (jm["backend"], tm_["backend"]) == ("jax-llm", "torch-llm")
    assert tm_["memory_info"]["params_bytes"] == \
        jm["memory_info"]["params_bytes"]
    j, t = plain.both("GET", "/system")
    loaded = _json(t[2])["loaded_models"]
    assert loaded == _json(j[2])["loaded_models"] and "tiny" in loaded
    j, t = plain.both("POST", "/backend/shutdown", {"model": "tiny"})
    assert j[0] == t[0] == 200
    _same_json(j, t)
    assert "tiny" not in plain.app.model_loader.loaded_names()
    j, t = plain.both("POST", "/backend/shutdown", {"model": "tiny"})
    _same_status_reason(j, t, "model 'tiny' not loaded")
    j, t = plain.both("POST", "/backend/shutdown", {})
    assert j[0] == t[0] == 400


# ------------------------------------------------------------------- §C 7

def test_bare_model_directory_is_served_as_by_jax(tmp_path):
    """A models directory holding one checkpoint directory ``tiny/`` and
    no YAML: a chat naming ``tiny`` is served by both servers, and a name
    with neither a config nor a directory is 404 in both."""
    models = tmp_path / "models"
    _tiny_checkpoint(models / "tiny")
    pair = Pair(tmp_path, models)
    try:
        body = {"model": "tiny", "max_tokens": 3, "temperature": 0.0,
                "messages": [{"role": "user", "content": "hello"}]}
        j, t = pair.both("POST", "/v1/chat/completions", body)
        assert j[0] == t[0] == 200
        jr, tr = _json(j[2]), _json(t[2])
        assert tr["model"] == jr["model"] == "tiny"
        assert tr["object"] == jr["object"] == "chat.completion"
        assert tr["usage"]["completion_tokens"] == \
            jr["usage"]["completion_tokens"] == 3
        j, t = pair.both("GET", "/v1/models")
        _same_json(j, t)
        j, t = pair.both("POST", "/v1/chat/completions",
                         {**body, "model": "absent"})
        _same_status_reason(j, t, "model 'absent' not found")
    finally:
        pair.close()
