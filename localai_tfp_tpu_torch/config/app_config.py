"""Application-level configuration (counterpart of
localai_tfp_tpu/config/app_config.py, for the fields the port's server
uses).

One dataclass; ``from_env`` reads each field from ``LOCALAI_<NAME>``,
else ``<NAME>`` (ref: core/cli/run.go:22-72), with the JAX package's
names and parsing. The CLI (``server/__main__.py``) layers its flags
over it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path


def _env(name: str, default=None, cast=str):
    for key in (f"LOCALAI_{name}", name):
        v = os.environ.get(key)
        if v is not None:
            if cast is bool:
                return v.lower() in ("1", "true", "yes", "on")
            return cast(v)
    return default


@dataclass
class ApplicationConfig:
    models_path: str = "models"
    generated_content_dir: str = "generated_content"  # the speech routes'
    # WAV files, served at /generated-{images,audio,videos}/
    upload_dir: str = "uploads"  # transcription uploads, each removed
    # when its request ends
    config_dir: str = "configuration"  # api_keys.json,
    # external_backends.json (hot-reloaded by config/watcher.py)
    state_dir: str = "run"  # runtime state (server.pid)
    address: str = "0.0.0.0"
    port: int = 8080
    api_keys: list[str] = field(default_factory=list)
    cors: bool = False
    cors_allow_origins: str = ""
    upload_limit_mb: int = 15
    context_size: int = 0  # read as the JAX package reads it; neither
    # server applies it (a model config's own context_size does)
    debug: bool = False
    single_active_backend: bool = False
    enable_watchdog_idle: bool = False
    enable_watchdog_busy: bool = False
    watchdog_idle_timeout: float = 15 * 60.0
    watchdog_busy_timeout: float = 5 * 60.0
    disable_metrics: bool = False
    opaque_errors: bool = False
    machine_tag: str = ""

    @classmethod
    def from_env(cls) -> "ApplicationConfig":
        cfg = cls()
        cfg.models_path = _env("MODELS_PATH", cfg.models_path)
        cfg.state_dir = _env("STATE_DIR", cfg.state_dir)
        cfg.address = _env("ADDRESS", cfg.address)
        port = _env("PORT", None)
        if port is not None:
            cfg.port = int(port)
        keys = _env("API_KEY", None)
        if keys:
            cfg.api_keys = [k.strip() for k in keys.split(",") if k.strip()]
        cfg.debug = _env("DEBUG", cfg.debug, bool)
        cfg.single_active_backend = _env(
            "SINGLE_ACTIVE_BACKEND", cfg.single_active_backend, bool)
        cfg.enable_watchdog_idle = _env(
            "WATCHDOG_IDLE", cfg.enable_watchdog_idle, bool)
        cfg.enable_watchdog_busy = _env(
            "WATCHDOG_BUSY", cfg.enable_watchdog_busy, bool)
        cfg.cors = _env("CORS", cfg.cors, bool)
        cfg.cors_allow_origins = _env(
            "CORS_ALLOW_ORIGINS", cfg.cors_allow_origins)
        cfg.disable_metrics = _env("DISABLE_METRICS", cfg.disable_metrics,
                                   bool)
        cfg.opaque_errors = _env("OPAQUE_ERRORS", cfg.opaque_errors, bool)
        cfg.machine_tag = _env("MACHINE_TAG", cfg.machine_tag)
        cfg.upload_limit_mb = int(_env("UPLOAD_LIMIT", cfg.upload_limit_mb))
        ctx = _env("CONTEXT_SIZE", None)
        if ctx is not None:
            cfg.context_size = int(ctx)
        return cfg

    def ensure_dirs(self) -> None:
        for d in (self.models_path, self.generated_content_dir,
                  self.upload_dir, self.config_dir, self.state_dir):
            Path(d).mkdir(parents=True, exist_ok=True)
