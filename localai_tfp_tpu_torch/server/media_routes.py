"""OpenAI audio routes of the port (the audio routes of
localai_tfp_tpu/server/media_routes.py): ``POST /v1/audio/transcriptions``
and ``/audio/transcriptions`` (ref: core/http/routes/openai.go:104,
endpoints/openai/transcription.go:79), ``POST /v1/audio/speech`` and
``/audio/speech`` (openai.go:111), and the generated-content mounts
``GET /generated-{images,audio,videos}/{file}`` over the config's
``generated_content_dir`` (ref: core/http/app.go:158-171).

The body is ``multipart/form-data``, parsed with the standard library's
``email`` package: the ``file`` part (written under the config's
``upload_dir`` and removed when the request ends), and the fields
``model``, ``language``, ``translate`` (``"1"`` or ``"true"``) and
``response_format`` (``json``, ``verbose_json`` with the segments and the
duration, or ``text`` as ``text/plain``). The server's upload limit
applies before the body is read.

``/v1/audio/speech`` takes ``{model, input, voice}`` (the voice, else the
config's ``tts.voice``), writes the TTS worker's WAV under
``generated_content_dir`` and answers with it (``audio/x-wav``); 404 when
no TTS model resolves, 500 with the worker's message when it fails.
"""

from __future__ import annotations

import os
import uuid
from email.parser import BytesParser
from email.policy import HTTP

from ..config.model_config import Usecase
from .app import Handler, HTTPError
from .state import Application


def parse_multipart(content_type: str, body: bytes
                    ) -> dict[str, tuple[str, bytes]]:
    """A ``multipart/form-data`` body -> its parts by name, each as
    (filename, or "" for none; bytes)."""
    if not content_type.lower().startswith("multipart/form-data"):
        raise HTTPError(400, "expected a multipart/form-data body")
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n"
        + body)
    if not msg.is_multipart():
        raise HTTPError(400, "malformed multipart body")
    parts: dict[str, tuple[str, bytes]] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is not None:
            parts[name] = (part.get_filename() or "",
                           part.get_payload(decode=True) or b"")
    return parts


def transcriptions(h: Handler, app: Application) -> None:
    """multipart: file=<audio>, model, language, translate,
    response_format (json|verbose_json|text)."""
    n = int(h.headers.get("Content-Length") or 0)
    parts = parse_multipart(h.headers.get("Content-Type", ""),
                            h.rfile.read(n) if n else b"")
    if "file" not in parts:
        raise HTTPError(400, "missing audio 'file' part")
    fname, data = parts.pop("file")
    fields = {k: v.decode() for k, (_, v) in parts.items()}
    os.makedirs(app.config.upload_dir, exist_ok=True)
    audio_path = os.path.join(
        app.config.upload_dir,
        f"{uuid.uuid4().hex}-{os.path.basename(fname or 'audio.wav')}")
    with open(audio_path, "wb") as f:
        f.write(data)
    try:
        name = fields.get("model")
        cfg = app.config_loader.resolve(name, Usecase.TRANSCRIPT)
        if cfg is None:
            raise HTTPError(404, f"model '{name}' not found" if name
                            else "no model available")
        backend = app.model_loader.load(cfg)
        with app.busy(cfg.name):
            res = backend.audio_transcription(
                audio_path, language=fields.get("language", ""),
                translate=fields.get("translate", "") in ("1", "true"))
    finally:
        try:
            os.unlink(audio_path)
        except OSError:
            pass
    fmt = fields.get("response_format", "json")
    if fmt == "text":
        body = res.text.encode()
        h.send_response(200)
        h.send_header("Content-Type", "text/plain; charset=utf-8")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)
        return
    out: dict = {"text": res.text}
    if fmt == "verbose_json":
        out["segments"] = [
            {"id": s.id, "start": s.start, "end": s.end, "text": s.text,
             "tokens": s.tokens}
            for s in res.segments
        ]
        out["duration"] = res.segments[-1].end if res.segments else 0.0
    h.send_json(200, out)


def speech(h: Handler, app: Application) -> None:
    """OpenAI /v1/audio/speech: {model, input, voice} -> audio bytes."""
    body = h.read_body()
    name = body.get("model")
    cfg = app.config_loader.resolve(name, Usecase.TTS)
    if cfg is None:
        raise HTTPError(404, f"model '{name}' not found" if name
                        else "no model available")
    backend = app.model_loader.load(cfg)
    dst = os.path.join(app.config.generated_content_dir,
                       f"speech-{uuid.uuid4().hex}.wav")
    with app.busy(cfg.name):
        res = backend.tts(text=body.get("input", ""),
                          voice=body.get("voice", "") or cfg.tts.voice,
                          dst=dst)
    if not res.success:
        raise HTTPError(500, res.message)
    h.send_file(dst)


def generated_file(h: Handler, app: Application) -> None:
    """A file under ``generated_content_dir`` (any of the three mounts
    serves the one directory, as the JAX server's static routes do); 404
    for a missing file or a path that leaves the directory."""
    root = os.path.realpath(app.config.generated_content_dir)
    path = os.path.realpath(os.path.join(root, h.path_params["file"]))
    if os.path.commonpath([root, path]) != root or not os.path.isfile(path):
        raise HTTPError(404, "not found")
    h.send_file(path)

