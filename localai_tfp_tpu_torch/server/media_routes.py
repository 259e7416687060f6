"""OpenAI audio routes of the port (the transcription route of
localai_tfp_tpu/server/media_routes.py): ``POST /v1/audio/transcriptions``
and ``/audio/transcriptions`` (ref: core/http/routes/openai.go:104,
endpoints/openai/transcription.go:79).

The body is ``multipart/form-data``, parsed with the standard library's
``email`` package: the ``file`` part (written under the config's
``upload_dir`` and removed when the request ends), and the fields
``model``, ``language``, ``translate`` (``"1"`` or ``"true"``) and
``response_format`` (``json``, ``verbose_json`` with the segments and the
duration, or ``text`` as ``text/plain``). The server's upload limit
applies before the body is read.
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
