"""The port's HTTP server: the standard library's ``ThreadingHTTPServer``
(one thread per connection, HTTP/1.0, server-sent events written by hand)
in place of the JAX package's aiohttp app.

``Application`` holds the model configs of the models directory (read by
``config/loader.py``) and loads each model's worker on first use; the
route handlers live in ``openai_routes``, and ``GET /metrics`` here.
Error bodies have the JAX server's shape: ``{"error": {"code": N,
"message": "...", "type": ""}}``.
Every request's latency lands on ``api_call_seconds``, keyed by the
matched route template ("other" for no route), as in the JAX server.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlsplit

from ..config.loader import load_configs_from_path
from ..config.model_config import ModelConfig
from ..device import resolve
from ..engine.templating import Evaluator
from ..telemetry.metrics import API_CALL
from ..telemetry.registry import CONTENT_TYPE, REGISTRY
from ..workers.base import ModelLoadOptions
from ..workers.llm import TorchLLMBackend

log = logging.getLogger(__name__)

# /v1/engines/{model}/completions and /engines/{model}/completions
_ENGINE_ROUTE = re.compile(r"(/v1|)/engines/([^/]+)/completions")


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
        self.configs: dict[str, ModelConfig] = load_configs_from_path(
            models_path)
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
            quantization=cfg.quantization,
            draft_model=cfg.draft_model, n_draft=cfg.n_draft or 0)

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


def metrics(h: "Handler", app: Application) -> None:
    """Prometheus exposition 0.0.4 of the process's registry, the
    engines' gauges refreshed first from host-held values."""
    for b in app.loaded().values():
        if b.engine is not None:
            b.engine.update_gauges()
    body = REGISTRY.render().encode()
    h.send_response(200)
    h.send_header("Content-Type", CONTENT_TYPE)
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    h.wfile.write(body)


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

        t0 = time.perf_counter()
        path = urlsplit(self.path).path.rstrip("/") or "/"
        routes = {
            ("GET", "/v1/models"): r.list_models,
            ("GET", "/models"): r.list_models,
            ("GET", "/readyz"): r.readyz,
            ("GET", "/metrics"): metrics,
            ("POST", "/v1/tokenize"): r.tokenize,
        }
        for prefix in ("/v1", ""):
            routes[("POST", f"{prefix}/chat/completions")] = \
                r.chat_completions
            routes[("POST", f"{prefix}/completions")] = r.completions
            routes[("POST", f"{prefix}/edits")] = r.edits
        fn = routes.get((method, path))
        route = path
        self.path_params: dict[str, str] = {}
        m = _ENGINE_ROUTE.fullmatch(path)
        if fn is None and method == "POST" and m:
            fn = r.completions
            self.path_params = {"model": m.group(2)}
            route = f"{m.group(1)}/engines/{{model}}/completions"
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
        finally:
            API_CALL.labels(method=method,
                            path=route if fn is not None else "other"
                            ).observe(time.perf_counter() - t0)

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
