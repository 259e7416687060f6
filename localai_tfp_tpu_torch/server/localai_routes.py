"""LocalAI-native routes of the port (the subset of
localai_tfp_tpu/server/localai_routes.py the port serves): health,
``/version``, ``/metrics``, ``/system``, the backend monitor and
shutdown, Jina's ``/v1/rerank`` and the vector stores
(``/stores/{set,delete,get,find}``) (ref: core/http/routes/localai.go,
routes/health.go, routes/jina.go).
"""

from __future__ import annotations

import os
import resource
import time
from urllib.parse import urlsplit

import torch

from ..config.model_config import ModelConfig, Usecase
from ..engine.loader import registry
from ..telemetry.registry import CONTENT_TYPE, REGISTRY
from ..utils.sysinfo import device_memory
from ..version import __version__
from . import schema
from .app import Handler, HTTPError
from .state import Application


def health(h: Handler, app: Application) -> None:
    h.send_json(200, {"status": "ok"})


def version(h: Handler, app: Application) -> None:
    h.send_json(200, {"version": __version__})


def metrics(h: Handler, app: Application) -> None:
    """Prometheus exposition 0.0.4 of the process's registry, the
    engines' gauges refreshed first from host-held values; 404 when
    metrics are disabled."""
    if app.config.disable_metrics:
        raise HTTPError(404, "metrics are disabled")
    for b in app.loaded().values():
        eng = getattr(b, "engine", None)
        if eng is not None:
            eng.update_gauges()
    body = REGISTRY.render().encode()
    h.send_response(200)
    h.send_header("Content-Type", CONTENT_TYPE)
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    h.wfile.write(body)


def system(h: Handler, app: Application) -> None:
    """Backends known, models loaded, devices and their memory, uptime
    (ref: endpoints/localai/system.go)."""
    devices = ([str(torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
               if torch.cuda.is_available() else ["cpu"])
    h.send_json(200, {
        "backends": registry.known(),
        "loaded_models": app.model_loader.loaded_names(),
        "devices": devices,
        "device_memory": device_memory(),
        "uptime_s": time.time() - app.started_at,
    })


def _model_arg(h: Handler) -> str:
    body = h.read_body() if h.headers.get("Content-Length") else {}
    name = body.get("model") or h.query("model")
    if not name:
        raise HTTPError(400, "model required")
    return name


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _rss_now() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def backend_monitor(h: Handler, app: Application) -> None:
    """One loaded model's status, the process's memory and CPU share over
    0.1 s (workers are in-process, so the process is the backend), its
    load time and phases, and its engine's counters (ref:
    core/services/backend_monitor.go)."""
    name = _model_arg(h)
    lm = app.model_loader.get(name)
    if lm is None:
        raise HTTPError(404, f"model '{name}' not loaded")
    status = lm.backend.status()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0, c0 = time.monotonic(), _cpu_s()
    time.sleep(0.1)
    cpu_percent = 100.0 * (_cpu_s() - c0) / max(time.monotonic() - t0, 1e-6)
    stats = getattr(lm.backend, "engine_stats", None)
    h.send_json(200, {
        "memory_info": {"rss": _rss_now() or peak, "peak_rss": peak,
                        **status.memory},
        "cpu_percent": round(cpu_percent, 2),
        "pid": os.getpid(),
        "status": status.state,
        "backend": lm.backend_type,
        "busy": lm.busy_since is not None,
        "load_s": round(lm.load_s, 2),
        "load_breakdown": getattr(lm.backend, "load_breakdown", None) or None,
        "engine": stats() if stats is not None else None,
    })


def backend_shutdown(h: Handler, app: Application) -> None:
    """Unload one model; its device memory is free when this answers."""
    name = _model_arg(h)
    if not app.model_loader.shutdown_model(name):
        raise HTTPError(404, f"model '{name}' not loaded")
    h.send_json(200, {"success": True})


def rerank(h: Handler, app: Application) -> None:
    """Jina-compatible ``POST /v1/rerank`` (ref: jina/rerank.go): the
    documents by relevance to the query, cut to ``top_n``; 404 when no
    rerank model resolves."""
    body = h.read_body()
    req = schema.RerankRequest.validate(body)
    cfg = app.config_loader.resolve(body.get("model"), Usecase.RERANK)
    if cfg is None:
        raise HTTPError(404, "no rerank model available")
    backend = app.model_loader.load(cfg)
    with app.busy(cfg.name):
        res = backend.rerank(req.query, req.documents,
                             req.top_n or len(req.documents))
    h.send_json(200, {
        "model": cfg.name,
        "usage": res.usage,
        "results": [{"index": d.index, "relevance_score": d.relevance_score,
                     "document": {"text": d.text}} for d in res.results],
    })


def stores(h: Handler, app: Application) -> None:
    """``POST /stores/{set,delete,get,find}`` through the local-store
    worker of the body's ``store`` (default ``default-store``, whose
    config is registered at its first use; ref: endpoints/localai/
    stores.go)."""
    body = h.read_body()
    name = body.get("store") or "default-store"
    cfg = app.config_loader.resolve(name, Usecase.ANY)
    if cfg is None:
        cfg = ModelConfig.from_dict({"name": name, "backend": "local-store"})
        app.config_loader.register(cfg)
    backend = app.model_loader.load(cfg)
    op = urlsplit(h.path).path.rstrip("/").rsplit("/", 1)[-1]
    if op == "set":
        backend.stores_set(body.get("keys") or [], body.get("values") or [])
        h.send_json(200, {})
    elif op == "delete":
        backend.stores_delete(body.get("keys") or [])
        h.send_json(200, {})
    elif op == "get":
        keys, values = backend.stores_get(body.get("keys") or [])
        h.send_json(200, {"keys": keys, "values": values})
    else:
        keys, values, sims = backend.stores_find(body.get("key") or [],
                                                 int(body.get("topk") or 10))
        h.send_json(200, {"keys": keys, "values": values,
                          "similarities": sims})
