"""The port's HTTP server: the standard library's ``ThreadingHTTPServer``
(one thread per connection, HTTP/1.0, server-sent events written by hand)
in place of the JAX package's aiohttp app.

``Handler._route`` runs the JAX server's middlewares around every route
(ref: core/http/app.go:53-215):

- a CORS preflight (``OPTIONS``) is answered 204 when CORS is on;
- API-key auth: with keys configured, every path outside
  ``AUTH_EXEMPT`` needs ``Authorization: Bearer <key>`` or
  ``x-api-key: <key>``, else 401;
- a body whose ``Content-Length`` exceeds ``upload_limit_mb`` is
  refused with 413 before it is read;
- errors: a route's ``HTTPError`` goes out as given; a
  ``NotImplementedError`` is a 501 and any other exception a 500, both
  as ``{"error": {"code": N}}`` alone under ``opaque_errors``;
- every response, errors and streams included, carries ``Machine-Tag``
  (when set), ``X-Correlation-ID`` (the caller's, else a fresh one),
  ``traceparent`` (the request's trace id, see below) and, with CORS on,
  the allow headers for a permitted origin;
- W3C trace context: a caller's ``traceparent`` is adopted (its trace id
  joins this node's entries in ``/debug/traces?id=``, and an edge entry
  records the hop), else a trace id is minted here; the receive and
  auth milestones seed the request's trace (telemetry/tracing.py);
- each request's latency lands on ``api_call_seconds`` keyed by the
  matched route template ("other" for no route), unless metrics are off.

Error bodies have the JAX server's shape: ``{"error": {"code": N,
"message": "...", "type": ""}}``. Routes with a path parameter
(``/v1/text-to-speech/{voice_id}``, the generated-content mounts
``/generated-{images,audio,videos}/{file}``) are matched by pattern after
the exact paths; the parameters, percent-decoded, are in
``Handler.path_params``. The route handlers live in
``openai_routes``, ``media_routes`` and ``localai_routes``; the state
they read is ``server/state.py``'s ``Application``.
"""

from __future__ import annotations

import json
import logging
import mimetypes
import os
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, unquote, urlsplit

from ..config.app_config import ApplicationConfig
from ..telemetry.metrics import API_CALL
from ..telemetry.tracing import (TRACER, make_traceparent, mint_trace_id,
                                 new_span_id, parse_traceparent)
from ..utils import sysinfo
from .state import Application

log = logging.getLogger(__name__)

# paths that need no API key (ref: app.go:139-174 default filters)
AUTH_EXEMPT = {"/healthz", "/readyz", "/metrics", "/telemetry/digest",
               "/version", "/login"}
# /v1/engines/{model}/completions|embeddings and /engines/{model}/...
_ENGINE_ROUTE = re.compile(r"(/v1|)/engines/([^/]+)/(completions|embeddings)")
# routes with path parameters: (method, pattern, the route's template)
_PATTERN_ROUTES = (
    ("POST", re.compile(r"/v1/text-to-speech/(?P<voice_id>[^/]+)"),
     "/v1/text-to-speech/{voice_id}"),
    ("GET", re.compile(r"/generated-(?P<kind>images|audio|videos)/"
                       r"(?P<file>.+)"), "/generated-{kind}/{file}"),
)
# content types by extension, as aiohttp's FileResponse guesses them
# (the standard table, not the system's mime.types)
_CONTENT_TYPES = mimetypes.MimeTypes()
MEMORY_GAUGE_S = 10.0  # period of the device-memory and RSS gauge sync


class HTTPError(Exception):
    """An error response: status, message, extra headers."""

    def __init__(self, status: int, message: str,
                 headers: Optional[dict] = None) -> None:
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


def _routes() -> dict:
    from . import localai_routes as lr
    from . import media_routes as mr
    from . import openai_routes as r

    routes = {
        ("GET", "/v1/models"): r.list_models,
        ("GET", "/models"): r.list_models,
        ("POST", "/v1/tokenize"): r.tokenize,
        ("GET", "/healthz"): lr.health,
        ("GET", "/readyz"): lr.health,
        ("GET", "/version"): lr.version,
        ("GET", "/metrics"): lr.metrics,
        ("GET", "/system"): lr.system,
        ("GET", "/backend/monitor"): lr.backend_monitor,
        ("POST", "/backend/shutdown"): lr.backend_shutdown,
        ("POST", "/v1/rerank"): lr.rerank,
        ("GET", "/debug/traces"): lr.debug_traces,
        ("GET", "/debug/timeline"): lr.debug_timeline,
        ("GET", "/debug/profile"): lr.debug_profile,
        ("POST", "/tts"): lr.tts,
        ("POST", "/v1/text-to-speech/{voice_id}"): lr.tts_elevenlabs,
        ("POST", "/v1/sound-generation"): lr.sound_generation,
        ("GET", "/generated-{kind}/{file}"): mr.generated_file,
    }
    for p in ("/vad", "/v1/vad"):
        routes[("POST", p)] = lr.vad
    for op in ("set", "delete", "get", "find"):
        routes[("POST", f"/stores/{op}")] = lr.stores
    for prefix in ("/v1", ""):
        routes[("POST", f"{prefix}/chat/completions")] = r.chat_completions
        routes[("POST", f"{prefix}/completions")] = r.completions
        routes[("POST", f"{prefix}/edits")] = r.edits
        routes[("POST", f"{prefix}/embeddings")] = r.embeddings
        routes[("POST", f"{prefix}/audio/transcriptions")] = \
            mr.transcriptions
        routes[("POST", f"{prefix}/audio/speech")] = mr.speech
    return routes


class Handler(BaseHTTPRequestHandler):
    server: "Server"
    server_version = "localai-tfp-torch"

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s " + fmt, self.address_string(), *args)

    # ---- plumbing used by the route handlers

    def end_headers(self) -> None:
        """The headers every response carries (ref: app.go:94-100,
        176-190: Machine-Tag, X-Correlation-ID, matching-origin CORS)."""
        cfg = self.server.app.config
        if cfg.machine_tag:
            self.send_header("Machine-Tag", cfg.machine_tag)
        corr = getattr(self, "correlation_id", "")
        if corr:
            self.send_header("X-Correlation-ID", corr)
        tid = getattr(self, "trace_id", "")
        if tid:
            # the resolved trace id, so a caller can join its request to
            # /debug/traces?id=... (the span id is this hop's)
            self.send_header("traceparent", make_traceparent(tid))
        if cfg.cors:
            allowed = [o.strip() for o in
                       (cfg.cors_allow_origins or "*").split(",")]
            origin = self.headers.get("Origin", "")
            grant = ("*" if "*" in allowed
                     else origin if origin in allowed else "")
            if grant:
                self.send_header("Access-Control-Allow-Origin", grant)
                self.send_header("Vary", "Origin")
                self.send_header("Access-Control-Allow-Methods",
                                 "GET, POST, PUT, DELETE, OPTIONS")
                self.send_header(
                    "Access-Control-Allow-Headers",
                    "Authorization, Content-Type, X-Correlation-ID, "
                    "X-Model, x-api-key, Extra-Usage")
        super().end_headers()

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

    def send_file(self, path: str) -> None:
        """A file's bytes with its type guessed from its extension, as
        aiohttp's ``FileResponse`` answers."""
        with open(path, "rb") as f:
            body = f.read()
        self.send_response(200)
        self.send_header("Content-Type", _CONTENT_TYPES.guess_type(path)[0]
                         or "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def send_error_json(self, err: HTTPError, opaque: bool = False) -> None:
        body = ({"code": err.status} if opaque else
                {"code": err.status, "message": err.message, "type": ""})
        self.send_json(err.status, {"error": body}, err.headers)

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

    def query(self, key: str) -> Optional[str]:
        vals = parse_qs(urlsplit(self.path).query).get(key)
        return vals[0] if vals else None

    def trace_seed(self) -> list:
        """The receive and auth milestones, for ``TRACER.start``: a
        request's trace begins at receive, not at engine submit."""
        return [(p, t) for p, t in (("receive", self.t_receive),
                                    ("auth", self.t_auth)) if t]

    def start_trace(self, request_id: str, model: str) -> None:
        """Open the request's trace under this request's trace id."""
        TRACER.start(request_id, model=model,
                     correlation_id=self.correlation_id,
                     events=self.trace_seed(), trace_id=self.trace_id,
                     parent_span=self.parent_span)

    # ---- dispatch

    def _authorized(self, keys: list) -> bool:
        auth = self.headers.get("Authorization", "")
        token = (auth[7:] if auth.startswith("Bearer ")
                 else self.headers.get("x-api-key", ""))
        return token in keys

    def _route(self, method: str) -> None:
        app = self.server.app
        cfg = app.config
        t0 = time.perf_counter()
        if method == "OPTIONS" and cfg.cors:  # a CORS preflight
            self.send_response(204)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.correlation_id = (self.headers.get("X-Correlation-ID")
                               or uuid.uuid4().hex)
        self.t_receive, self.t_auth = t0, 0.0
        parsed = parse_traceparent(self.headers.get("traceparent", ""))
        edge = ""
        if parsed:
            self.trace_id, self.parent_span = parsed
            # a distributed caller: an edge entry under the shared trace
            # id makes this hop joinable even when the route opens no
            # trace of its own
            edge = "edge:" + new_span_id()
            TRACER.start(edge, model="edge",
                         correlation_id=self.correlation_id,
                         events=[("receive", t0)], trace_id=parsed[0],
                         parent_span=parsed[1])
            TRACER.annotate(edge, "http", method=method, path=self.path)
        else:
            self.trace_id, self.parent_span = mint_trace_id(), ""
        path = urlsplit(self.path).path.rstrip("/") or "/"
        fn = self.server.routes.get((method, path))
        route = path
        self.path_params: dict[str, str] = {}
        m = _ENGINE_ROUTE.fullmatch(path)
        if fn is None and method == "POST" and m:
            fn = self.server.routes[("POST", f"/v1/{m.group(3)}")]
            self.path_params = {"model": m.group(2)}
            route = f"{m.group(1)}/engines/{{model}}/{m.group(3)}"
        for meth, rx, template in _PATTERN_ROUTES:
            m = rx.fullmatch(path) if fn is None and method == meth else None
            if m:
                fn = self.server.routes[(meth, template)]
                self.path_params = {k: unquote(v)
                                    for k, v in m.groupdict().items()}
                route = template
        try:
            if cfg.api_keys and path not in AUTH_EXEMPT \
                    and not self._authorized(cfg.api_keys):
                raise HTTPError(401, "unauthorized")
            self.t_auth = time.perf_counter()
            if fn is None:
                raise HTTPError(404, f"no route {method} {path}")
            limit = cfg.upload_limit_mb * 1024 * 1024
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                raise HTTPError(400, "invalid Content-Length") from None
            if n > limit:
                raise HTTPError(413, f"request body of {n} bytes exceeds "
                                     f"the {limit}-byte upload limit")
            fn(self, app)
        except HTTPError as e:
            self.send_error_json(e)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; streaming handlers cancel their work
        except NotImplementedError as e:
            self.send_error_json(HTTPError(501, f"not implemented: {e}"),
                                 cfg.opaque_errors)
        except Exception as e:  # a boundary that must keep serving
            log.exception("request failed")
            self.send_error_json(HTTPError(500, str(e)), cfg.opaque_errors)
        finally:
            if edge:
                TRACER.event(edge, "done")
                TRACER.finish(edge)
            if not cfg.disable_metrics:
                API_CALL.labels(method=method,
                                path=route if fn is not None else "other"
                                ).observe(time.perf_counter() - t0)

    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")

    def do_OPTIONS(self) -> None:  # noqa: N802
        self._route("OPTIONS")


class Server(ThreadingHTTPServer):
    """Binds to the config's address and port (0 picks a free one: read
    it back from ``server_address``) and starts the application; call
    ``serve_forever``, and ``close`` from another thread."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, app: Application) -> None:
        super().__init__((app.config.address, app.config.port), Handler)
        self.app = app
        self.routes = _routes()
        app.startup()
        self._gauges_stop = threading.Event()
        self._gauges: Optional[threading.Thread] = None
        if not app.config.disable_metrics:
            # keep the device-memory and RSS gauges fresh even while no
            # engine is loaded (engines also set them at each scrape)
            self._gauges = threading.Thread(target=self._gauge_loop,
                                            name="memory-gauges",
                                            daemon=True)
            self._gauges.start()

    def _gauge_loop(self) -> None:
        while True:
            try:
                sysinfo.update_memory_gauges()
            except Exception:  # a gauge sync must never stop the loop
                log.debug("memory gauge sync failed", exc_info=True)
            if self._gauges_stop.wait(MEMORY_GAUGE_S):
                return

    def close(self) -> None:
        """Stop serving (from another thread than ``serve_forever``'s),
        then ``release``."""
        self.shutdown()
        self.release()

    def release(self) -> None:
        """Close the socket, stop the gauge loop and the application
        (its models unloaded), once ``serve_forever`` has returned."""
        self.server_close()
        self._gauges_stop.set()
        if self._gauges is not None:
            self._gauges.join(timeout=5)
        self.app.shutdown()


def build_server(models_path: str, host: str = "127.0.0.1", port: int = 0,
                 device: Any = None) -> Server:
    """A server over one models directory with every other setting at
    its default."""
    return Server(Application(ApplicationConfig(
        models_path=models_path, address=host, port=port), device))


def run(app: Application) -> None:
    """Serve until interrupted, with the pid file ``state_dir/server.pid``
    present while serving and removed on every exit path."""
    os.makedirs(app.config.state_dir, exist_ok=True)
    pidfile = os.path.join(app.config.state_dir, "server.pid")
    srv = Server(app)
    with open(pidfile, "w") as f:
        f.write(str(os.getpid()))
    log.info("serving %s on http://%s:%d", app.config.models_path,
             *srv.server_address[:2])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        try:
            os.unlink(pidfile)
        except OSError:
            pass
        srv.release()
