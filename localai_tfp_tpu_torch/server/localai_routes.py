"""LocalAI-native routes of the port (the subset of
localai_tfp_tpu/server/localai_routes.py the port serves): health,
``/version``, ``/metrics``, ``/system``, the backend monitor and
shutdown, Jina's ``/v1/rerank``, voice-activity detection (``/vad``,
``/v1/vad``), speech (``/tts``, ElevenLabs'
``/v1/text-to-speech/{voice_id}`` and ``/v1/sound-generation``), the
vector stores
(``/stores/{set,delete,get,find}``) and the debug routes
(``/debug/traces``, ``/debug/timeline``, ``/debug/profile``) (ref:
core/http/routes/localai.go, routes/health.go, routes/jina.go).
"""

from __future__ import annotations

import io
import os
import resource
import threading
import time
import uuid
import zipfile
from urllib.parse import urlsplit

import torch

from ..config import knobs
from ..config.model_config import ModelConfig, Usecase
from ..engine.loader import registry
from ..telemetry.flightrec import FLIGHT
from ..telemetry.registry import (CONTENT_TYPE, OPENMETRICS_CONTENT_TYPE,
                                  REGISTRY)
from ..telemetry.tracing import TRACER
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
    """Prometheus exposition 0.0.4 of the process's registry, or, when
    the scraper's ``Accept`` names ``application/openmetrics-text``,
    OpenMetrics with exemplars; the engines' gauges refreshed first from
    host-held values. 404 when metrics are disabled."""
    if app.config.disable_metrics:
        raise HTTPError(404, "metrics are disabled")
    for b in app.loaded().values():
        eng = getattr(b, "engine", None)
        if eng is not None:
            eng.update_gauges()
    om = "application/openmetrics-text" in h.headers.get("Accept", "")
    body = REGISTRY.render(openmetrics=om).encode()
    h.send_response(200)
    h.send_header("Content-Type",
                  OPENMETRICS_CONTENT_TYPE if om else CONTENT_TYPE)
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


def vad(h: Handler, app: Application) -> None:
    """``POST /vad`` and ``/v1/vad``: the speech segments of ``audio``
    (f32 PCM at 16 kHz) by the body's VAD model; 404 when none resolves
    (ref: routes/localai.go:46-52, endpoints/localai/vad.go)."""
    body = h.read_body()
    cfg = app.config_loader.resolve(body.get("model"), Usecase.VAD)
    if cfg is None:
        raise HTTPError(404, "no VAD model available")
    backend = app.model_loader.load(cfg)
    with app.busy(cfg.name):
        res = backend.vad(body.get("audio") or [])
    h.send_json(200, {"segments": [{"start": s.start, "end": s.end}
                                   for s in res.segments]})


def _tts(h: Handler, app: Application, text: str, model_name,
         voice: str, language: str = "") -> None:
    """The TTS worker's WAV for ``text`` (the voice, else the config's
    ``tts.voice``), written under ``generated_content_dir``; 404 when no
    TTS model resolves, 500 with the worker's message when it fails."""
    cfg = app.config_loader.resolve(model_name, Usecase.TTS)
    if cfg is None:
        raise HTTPError(404, "no TTS model available")
    backend = app.model_loader.load(cfg)
    dst = os.path.join(app.config.generated_content_dir,
                       f"tts-{uuid.uuid4().hex}.wav")
    with app.busy(cfg.name):
        res = backend.tts(text=text, voice=voice or cfg.tts.voice, dst=dst,
                          language=language)
    if not res.success:
        raise HTTPError(500, res.message)
    h.send_file(dst)


def tts(h: Handler, app: Application) -> None:
    """``POST /tts`` (ref: routes/localai.go:41): ``{model, input, voice,
    language}``; a non-string ``input``/``text``/``voice`` is a 400."""
    body = h.read_body()
    schema.TTSRequest.validate(body)
    _tts(h, app, body.get("input", ""), body.get("model"),
         body.get("voice", ""), body.get("language", ""))


def tts_elevenlabs(h: Handler, app: Application) -> None:
    """ElevenLabs' ``POST /v1/text-to-speech/{voice_id}`` (ref:
    elevenlabs/tts.go): the voice in the path, ``{text, model_id}`` in the
    body, the same typed 400 as ``/tts``."""
    body = h.read_body()
    schema.TTSRequest.validate(body)
    _tts(h, app, body.get("text", ""), body.get("model_id"),
         h.path_params["voice_id"])


def sound_generation(h: Handler, app: Application) -> None:
    """ElevenLabs' ``POST /v1/sound-generation``: ``{text, model_id,
    duration_seconds (or duration), temperature, do_sample}``; 404 when no
    sound-generation model resolves."""
    body = h.read_body()
    req = schema.SoundGenerationRequest.validate(body)
    cfg = app.config_loader.resolve(body.get("model_id"),
                                    Usecase.SOUND_GENERATION)
    if cfg is None:
        raise HTTPError(404, "no sound-generation model available")
    backend = app.model_loader.load(cfg)
    dst = os.path.join(app.config.generated_content_dir,
                       f"sound-{uuid.uuid4().hex}.wav")
    with app.busy(cfg.name):
        res = backend.sound_generation(
            text=req.text, dst=dst, duration=req.duration,
            temperature=1.0 if req.temperature is None else req.temperature,
            # an explicit temperature 0 means deterministic, not "unset"
            do_sample=body.get("do_sample", req.temperature is None
                               or req.temperature > 0))
    if not res.success:
        raise HTTPError(500, res.message)
    h.send_file(dst)


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


# ------------------------------------------------------------------ debug

_NO_STORE = {"Cache-Control": "no-store"}


def _int_query(h: Handler, key: str, default: int) -> int:
    try:
        return int(h.query(key) or default)
    except ValueError:
        raise HTTPError(400, f"'{key}' must be an integer") from None


def debug_traces(h: Handler, app: Application) -> None:
    """Request-lifecycle traces (telemetry/tracing.py), newest first:
    ``?model=`` filter, ``?limit=`` cap (default 50), ``?id=`` lookup by
    trace id, request id, correlation id or a whole traceparent."""
    limit = _int_query(h, "limit", 50)
    ident = h.query("id")
    traces = (TRACER.lookup(ident, limit=limit) if ident
              else TRACER.traces(model=h.query("model") or None,
                                 limit=limit))
    h.send_json(200, {"traces": traces}, _NO_STORE)


def debug_timeline(h: Handler, app: Application) -> None:
    """The flight recorder as Chrome-trace JSON (telemetry/flightrec.py),
    loadable in Perfetto or chrome://tracing; ``?limit=`` keeps the
    newest events."""
    trace = FLIGHT.export_chrome_trace()
    if h.query("limit"):
        limit = max(0, _int_query(h, "limit", 0))
        ev = trace["traceEvents"]
        if len(ev) > limit:
            trace = {**trace, "traceEvents": ev[-limit:] if limit else []}
    h.send_json(200, trace, _NO_STORE)


# one profile capture at a time: a second concurrent request gets 409
_PROFILE_LOCK = threading.Lock()


def debug_profile(h: Handler, app: Application) -> None:
    """An on-demand ``torch.profiler`` capture (CPU and, on a card, CUDA
    activities) of ``?duration=`` seconds (default 2, clamped to
    ``LOCALAI_PROFILER_MAX_S``), written as a Chrome trace under
    ``state_dir/profiles/<time>/``. Gated by ``LOCALAI_PROFILER`` (off:
    403). ``?download=1`` returns the capture directory as a zip; else
    the JSON names its path."""
    import torch.profiler as tp

    if not knobs.flag("LOCALAI_PROFILER"):
        raise HTTPError(403, "profiler disabled (set LOCALAI_PROFILER=on)")
    try:
        duration = float(h.query("duration") or 2.0)
    except ValueError:
        raise HTTPError(400, "'duration' must be a number") from None
    max_s = max(0.1, knobs.float_("LOCALAI_PROFILER_MAX_S"))
    duration = min(max(0.1, duration), max_s)
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise HTTPError(409, "a profile capture is already running")
    logdir = os.path.join(app.config.state_dir, "profiles",
                          time.strftime("%Y%m%d-%H%M%S"))
    try:
        os.makedirs(logdir, exist_ok=True)
        acts = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        with tp.profile(activities=acts) as prof:
            time.sleep(duration)
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
    except Exception as e:
        raise HTTPError(500, f"profiler capture failed: {e!r}") from e
    finally:
        _PROFILE_LOCK.release()
    if h.query("download"):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _dirs, files in os.walk(logdir):
                for fname in files:
                    full = os.path.join(root, fname)
                    zf.write(full, os.path.relpath(full, logdir))
        body = buf.getvalue()
        h.send_response(200)
        h.send_header("Content-Type", "application/zip")
        h.send_header("Content-Disposition", 'attachment; filename="%s.zip"'
                      % os.path.basename(logdir))
        h.send_header("Cache-Control", "no-store")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)
        return
    h.send_json(200, {"path": logdir, "duration_s": duration,
                      "bytes": os.path.getsize(path)}, _NO_STORE)
