"""The port's HTTP server: the standard library's ``ThreadingHTTPServer``
(one thread per connection, HTTP/1.0, server-sent events written by hand)
in place of the JAX package's aiohttp app.

``Application`` holds the model configs of the models directory and loads
each model's worker on first use; the route handlers live in
``openai_routes``. Error bodies have the JAX server's shape:
``{"error": {"code": N, "message": "...", "type": ""}}``.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlsplit

from ..config.model_config import ModelConfig, load_configs
from ..device import resolve
from ..engine.templating import Evaluator
from ..workers.base import ModelLoadOptions
from ..workers.llm import TorchLLMBackend

log = logging.getLogger(__name__)


class HTTPError(Exception):
    """An error response: status, message, extra headers."""

    def __init__(self, status: int, message: str,
                 headers: Optional[dict] = None) -> None:
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


class Application:
    """Server state: model configs, loaded workers, the prompt templater."""

    def __init__(self, models_path: str, device: Any = None) -> None:
        self.models_path = models_path
        self.device = resolve(device)
        self.configs: dict[str, ModelConfig] = load_configs(models_path)
        self.evaluator = Evaluator(models_path)
        self._backends: dict[str, TorchLLMBackend] = {}
        self._lock = threading.Lock()

    def resolve_config(self, name: Optional[str]) -> ModelConfig:
        """By name, else the first config (sorted by name) that serves
        chat."""
        if name:
            cfg = self.configs.get(name)
            if cfg is None or not cfg.serves_chat:
                raise HTTPError(404, f"model '{name}' not found")
            return cfg
        for n in sorted(self.configs):
            if self.configs[n].serves_chat:
                return self.configs[n]
        raise HTTPError(404, "no model available")

    def load_options(self, cfg: ModelConfig) -> ModelLoadOptions:
        return ModelLoadOptions(
            model=cfg.model, model_path=self.models_path,
            context_size=cfg.context_size or 4096,
            batch_slots=cfg.max_batch_slots,
            dtype=cfg.dtype or "bfloat16",
            kv_cache_dtype=cfg.kv_cache_dtype,
            quantization=cfg.quantization)

    def backend(self, cfg: ModelConfig) -> TorchLLMBackend:
        """The model's worker, loaded on first use (one load at a time)."""
        with self._lock:
            b = self._backends.get(cfg.name)
            if b is not None:
                return b
            b = TorchLLMBackend(self.device)
            res = b.load_model(self.load_options(cfg))
            if not res.success:
                raise HTTPError(500, res.message)
            self._backends[cfg.name] = b
            return b

    def loaded(self) -> dict[str, TorchLLMBackend]:
        with self._lock:
            return dict(self._backends)

    def close(self) -> None:
        with self._lock:
            backends, self._backends = self._backends, {}
        for b in backends.values():
            b.shutdown()


class Handler(BaseHTTPRequestHandler):
    server: "Server"
    server_version = "localai-tfp-torch"

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s " + fmt, self.address_string(), *args)

    # ---- plumbing used by the route handlers

    def send_json(self, status: int, obj: Any,
                  headers: Optional[dict] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def send_error_json(self, err: HTTPError) -> None:
        self.send_json(err.status, {"error": {
            "code": err.status, "message": err.message, "type": ""}},
            err.headers)

    def read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        try:
            data = json.loads(raw or b"{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise HTTPError(400, "invalid JSON body") from None
        if not isinstance(data, dict):
            raise HTTPError(400, "body must be a JSON object")
        return data

    # ---- dispatch

    def _route(self, method: str) -> None:
        from . import openai_routes as r

        path = urlsplit(self.path).path.rstrip("/") or "/"
        routes = {
            ("GET", "/v1/models"): r.list_models,
            ("GET", "/models"): r.list_models,
            ("GET", "/readyz"): r.readyz,
            ("POST", "/v1/chat/completions"): r.chat_completions,
            ("POST", "/chat/completions"): r.chat_completions,
        }
        fn = routes.get((method, path))
        try:
            if fn is None:
                raise HTTPError(404, f"no route {method} {path}")
            fn(self, self.server.app)
        except HTTPError as e:
            self.send_error_json(e)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; streaming handlers cancel their work
        except Exception as e:  # a boundary that must keep serving
            log.exception("request failed")
            self.send_error_json(HTTPError(500, repr(e)))

    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")


class Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, app: Application, host: str, port: int) -> None:
        super().__init__((host, port), Handler)
        self.app = app

    def close(self) -> None:
        """Stop serving (from another thread than serve_forever's) and
        release the models."""
        self.shutdown()
        self.server_close()
        self.app.close()


def build_server(models_path: str, host: str = "127.0.0.1", port: int = 0,
                 device: Any = None) -> Server:
    """A server bound to (host, port) — port 0 picks a free one, read it
    back from ``server.server_address``. Call ``serve_forever``."""
    return Server(Application(models_path, device), host, port)
