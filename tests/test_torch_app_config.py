"""The port's application config, config-file watcher and remote backend
(localai_tfp_tpu_torch/config/app_config.py, config/watcher.py,
workers/remote.py, and the hot-reload handlers of server/state.py)
against the JAX package's under the same inputs.

- ``ApplicationConfig.from_env`` under the same environment gives the
  JAX config's values for every field the port has, and the same
  defaults.
- The watcher cases of tests/test_dynamic_config.py (changes, removal,
  bad JSON) through both packages' ``ConfigWatcher``.
- ``api_keys.json``: file keys extend the startup keys, a file that does
  not parse changes nothing, and removing the file restores the startup
  keys — the JAX handler's key lists, step for step.
- ``external_backends.json``: a remote OpenAI backend is registered under
  its lowercased name, a name that is an alias or a builtin worker is
  refused, an entry dropped from the file is unregistered — the JAX
  handler's registry, step for step.
- ``RemoteOpenAIBackend`` predicts, streams and embeds through a
  standard-library upstream exactly as the JAX class does.
"""

import dataclasses
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from localai_tfp_tpu.config.app_config import \
    ApplicationConfig as JaxAppConfig
from localai_tfp_tpu.config.watcher import ConfigWatcher as JaxWatcher
from localai_tfp_tpu.engine import loader as jl
from localai_tfp_tpu.server.state import Application as JaxApplication
from localai_tfp_tpu.workers import base as jb
from localai_tfp_tpu.workers.remote import \
    RemoteOpenAIBackend as JaxRemote
from localai_tfp_tpu_torch.config.app_config import ApplicationConfig
from localai_tfp_tpu_torch.config.watcher import ConfigWatcher
from localai_tfp_tpu_torch.engine import loader as tl
from localai_tfp_tpu_torch.server.state import Application
from localai_tfp_tpu_torch.workers import base as tb
from localai_tfp_tpu_torch.workers.remote import RemoteOpenAIBackend

ENV_NAMES = ("MODELS_PATH", "STATE_DIR", "ADDRESS", "PORT", "API_KEY",
             "DEBUG", "SINGLE_ACTIVE_BACKEND", "WATCHDOG_IDLE",
             "WATCHDOG_BUSY", "CORS", "CORS_ALLOW_ORIGINS",
             "DISABLE_METRICS", "OPAQUE_ERRORS", "MACHINE_TAG",
             "UPLOAD_LIMIT", "CONTEXT_SIZE")
ENVS = {
    "empty": {},
    "prefixed": {
        "LOCALAI_MODELS_PATH": "/srv/models", "LOCALAI_STATE_DIR": "/srv/run",
        "LOCALAI_ADDRESS": "127.0.0.1", "LOCALAI_PORT": "9090",
        "LOCALAI_API_KEY": "k1, k2,,k3", "LOCALAI_DEBUG": "true",
        "LOCALAI_SINGLE_ACTIVE_BACKEND": "1", "LOCALAI_WATCHDOG_IDLE": "yes",
        "LOCALAI_WATCHDOG_BUSY": "on", "LOCALAI_CORS": "TRUE",
        "LOCALAI_CORS_ALLOW_ORIGINS": "http://a.example,http://b.example",
        "LOCALAI_DISABLE_METRICS": "1", "LOCALAI_OPAQUE_ERRORS": "true",
        "LOCALAI_MACHINE_TAG": "node-7", "LOCALAI_UPLOAD_LIMIT": "64",
        "LOCALAI_CONTEXT_SIZE": "8192"},
    "plain": {"MODELS_PATH": "m", "PORT": "1234", "API_KEY": "solo",
              "DEBUG": "no", "CORS": "0", "UPLOAD_LIMIT": "1",
              "MACHINE_TAG": "plain-tag", "WATCHDOG_BUSY": "false"},
    # the prefixed name wins over the plain one
    "both": {"LOCALAI_PORT": "1", "PORT": "2", "MACHINE_TAG": "plain",
             "LOCALAI_MACHINE_TAG": "prefixed", "SINGLE_ACTIVE_BACKEND": "1",
             "LOCALAI_SINGLE_ACTIVE_BACKEND": "0"},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_from_env_matches_jax(env, monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
        monkeypatch.delenv(f"LOCALAI_{name}", raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    got, want = ApplicationConfig.from_env(), JaxAppConfig.from_env()
    for f in dataclasses.fields(ApplicationConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if env == "prefixed":
        assert got.api_keys == ["k1", "k2", "k3"] and got.port == 9090


def test_fields_and_defaults_are_the_jax_ones():
    jax_fields = {f.name: f for f in dataclasses.fields(JaxAppConfig)}
    got, want = ApplicationConfig(), JaxAppConfig()
    for f in dataclasses.fields(ApplicationConfig):
        assert f.name in jax_fields
        assert getattr(got, f.name) == getattr(want, f.name), f.name


# -------------------------------------------------------------- watcher


def _bump(p, dt: float) -> None:
    t = time.time() + dt
    os.utime(p, (t, t))


def _watch_sequence(cls, d) -> list:
    """The handler's calls: start on a file, a rewrite, a bad rewrite, a
    good one again, removal; each step polled once by hand."""
    seen = []
    w = cls(str(d), interval=3600)
    w.watch("api_keys.json", seen.append)
    p = d / "api_keys.json"
    p.write_text('["k1"]')
    w.start()
    try:
        for i, text in enumerate(('["k1", "k2"]', "{not json",
                                  '{"a": 1}')):
            p.write_text(text)
            _bump(p, i + 2)
            w._check("api_keys.json")
        w._check("api_keys.json")  # unchanged: no call
        p.unlink()
        w._check("api_keys.json")
        w._check("api_keys.json")  # still gone: no second call
    finally:
        w.stop()
    return seen


def test_watcher_sequence_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _watch_sequence(JaxWatcher, tmp_path / "jax")
    got = _watch_sequence(ConfigWatcher, tmp_path / "torch")
    assert got == want == [["k1"], ["k1", "k2"], {"a": 1}, None]


def test_watcher_thread_detects_changes(tmp_path):
    """The polling thread itself (test_dynamic_config's case)."""
    seen = []
    w = ConfigWatcher(str(tmp_path), interval=0.05)
    w.watch("api_keys.json", seen.append)
    p = tmp_path / "api_keys.json"
    p.write_text('["k1"]')
    w.start()
    try:
        assert seen == [["k1"]]
        p.write_text('["k1", "k2"]')
        _bump(p, 2)
        deadline = time.time() + 5
        while time.time() < deadline and seen[-1] != ["k1", "k2"]:
            time.sleep(0.05)
        assert seen[-1] == ["k1", "k2"]
        p.unlink()
        deadline = time.time() + 5
        while time.time() < deadline and seen[-1] is not None:
            time.sleep(0.05)
        assert seen[-1] is None
    finally:
        w.stop()


def test_watcher_ignores_bad_json(tmp_path):
    for cls in (JaxWatcher, ConfigWatcher):
        seen = []
        w = cls(str(tmp_path), interval=0.05)
        w.watch("api_keys.json", seen.append)
        (tmp_path / "api_keys.json").write_text("{not json")
        w.start()
        time.sleep(0.2)
        w.stop()
        assert seen == []


# ------------------------------------------------- the hot-reload handlers


@pytest.fixture
def registries():
    saved = {m: dict(m.registry._factories) for m in (jl, tl)}
    jl.registry._factories.clear()
    jl.registry.register("jax-llm", object)
    tl.registry._factories.clear()
    tl.registry.register("torch-llm", object)
    yield
    for m, f in saved.items():
        m.registry._factories.clear()
        m.registry._factories.update(f)


def _handlers(which: str, d):
    """(config, watcher) with the package's hot-reload handlers armed on
    configuration directory ``d`` and startup key ``boot``."""
    if which == "jax":
        st = SimpleNamespace(config=JaxAppConfig(config_dir=str(d),
                                                 api_keys=["boot"]))
        JaxApplication._start_config_watcher(st)
    else:
        st = Application(ApplicationConfig(config_dir=str(d),
                                           api_keys=["boot"]), "cpu")
        st._start_config_watcher()
    st.config_watcher.stop()  # the steps below poll by hand
    return st.config, st.config_watcher


def _steps(which: str, d) -> list:
    cfg, w = _handlers(which, d)
    llm = "jax-llm" if which == "jax" else "torch-llm"
    reg = (jl if which == "jax" else tl).registry
    out = [list(cfg.api_keys)]
    keys, ext = d / "api_keys.json", d / "external_backends.json"
    files = [
        (keys, '["k1", "boot", "k2"]'),
        (keys, "{not json"),
        (ext, json.dumps({"My-Remote": "http://127.0.0.1:9/",
                          "other": {"base_url": "http://h:1",
                                    "api_key": "sk"},
                          "llama": "http://alias", llm: "http://builtin"})),
        (ext, json.dumps({"other": {"uri": "http://h:2"}})),
        (keys, '"not a list"'),
    ]
    for i, (p, text) in enumerate(files):
        p.write_text(text)
        _bump(p, i + 2)
        w._check(p.name)
        names = sorted(n.replace(llm, "LLM") for n in reg.known())
        out.append((list(cfg.api_keys), names))
        if "my-remote" in reg.known():
            b = reg.create("my-remote")
            out.append((type(b).__name__, b.base_url, b.api_key))
        if "other" in reg.known():
            b = reg.create("other")
            out.append((b.base_url, b.api_key))
    for p in (keys, ext):
        p.unlink()
        w._check(p.name)
        out.append((list(cfg.api_keys),
                    sorted(n.replace(llm, "LLM") for n in reg.known())))
    return out


def test_hot_reload_handlers_match_jax(tmp_path, registries):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _steps("jax", tmp_path / "jax")
    got = _steps("torch", tmp_path / "torch")
    assert got == want
    # the outcomes spelled out: keys extend and restore, the alias and
    # the builtin are refused, dropped entries go
    assert got[1][0] == ["boot", "k1", "k2"]
    assert got[2][0] == ["boot", "k1", "k2"]  # bad JSON: unchanged
    assert got[3][1] == ["LLM", "my-remote", "other"]
    assert got[4] == ("RemoteOpenAIBackend", "http://127.0.0.1:9", "")
    assert got[5] == ("http://h:1", "sk")
    assert got[6][1] == ["LLM", "other"]
    assert got[-2] == (["boot"], ["LLM", "other"])
    assert got[-1] == (["boot"], ["LLM"])


# ------------------------------------------------------- remote backend


@pytest.fixture
def upstream():
    """A minimal OpenAI-compatible upstream on the standard library."""

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            if self.path == "/v1/embeddings":
                out = {"data": [{"embedding": [0.1, 0.2, 0.3]}]}
            elif body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                for tok in ("he", "llo"):
                    self.wfile.write(b"data: " + json.dumps(
                        {"choices": [{"text": tok}]}).encode() + b"\n\n")
                self.wfile.write(b"data: " + json.dumps(
                    {"choices": [{"text": "", "finish_reason": "stop"}]}
                ).encode() + b"\n\ndata: [DONE]\n\n")
                return
            else:
                out = {"choices": [{"text": f"echo:{body.get('prompt')}",
                                    "finish_reason": "stop"}],
                       "usage": {"completion_tokens": 2,
                                 "prompt_tokens": 3}}
            raw = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    th.join(timeout=5)


def _remote_outcome(cls, base, url) -> dict:
    b = cls()
    res = b.load_model(base.ModelLoadOptions(model="m",
                                             options=[f"base_url={url}"]))
    out = b.predict(base.PredictOptions(prompt="hi", tokens=4))
    chunks = list(b.predict_stream(base.PredictOptions(prompt="x")))
    emb = b.embedding(base.PredictOptions(embeddings="v"))
    missing = cls().load_model(base.ModelLoadOptions(model="m"))
    return {"loaded": res.success, "health": b.health(),
            "state": b.status().state,
            "reply": (out.message, out.tokens, out.prompt_tokens,
                      out.finish_reason),
            "stream": [(c.message, c.finish_reason) for c in chunks],
            "embedding": emb.embeddings,
            "missing_url": (missing.success, missing.message)}


def test_remote_backend_matches_jax(upstream):
    want = _remote_outcome(JaxRemote, jb, upstream)
    got = _remote_outcome(RemoteOpenAIBackend, tb, upstream)
    assert got == want
    assert got["reply"][0] == "echo:hi"
    assert "".join(m for m, _ in got["stream"]) == "hello"
