"""Model-config discovery, loading and the config registry
(counterpart of localai_tfp_tpu/config/loader.py::ConfigLoader).

A file may hold several YAML documents, and a document may be a list of
configs (ref: backend_config_loader.go
LoadMultipleBackendConfigsSingleFile). Every document of a file is read
and validated before any is registered, so a bad document never leaves a
file half loaded. ``load_configs_from_path`` scans the top level of the
models directory for ``*.yaml``/``*.yml``, skipping dotfiles, and logs
and skips a file it cannot read (with the file and the reason), as the
JAX loader does: one bad file never stops the server from serving the
others. ``load_config_file`` raises with the file and the reason.

``ConfigLoader`` is the registry the server resolves a request's model
name through, under one lock: a config by name whatever its usecase,
else a bare ``models_path/<name>`` entry registered as
``{"name": name, "model": name}``, else (no name) the first config
serving the usecase.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from . import yaml_lite
from .model_config import ModelConfig, Usecase

log = logging.getLogger(__name__)


def validated(data) -> ModelConfig:
    cfg = ModelConfig.from_dict(data)
    if not cfg.name:
        raise ValueError("model config has neither 'name' nor 'model'")
    if not cfg.validate():
        raise ValueError(f"invalid model config (path traversal?): {cfg.name}")
    return cfg


def load_config_file(path: str) -> list[ModelConfig]:
    """Every config of one file, each validated."""
    with open(path) as f:
        text = f.read()
    docs: list = []
    for doc in yaml_lite.load_all(text, path):
        if doc is None:
            continue
        docs.extend(doc if isinstance(doc, list) else [doc])
    try:
        return [validated(d) for d in docs]
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def load_configs_from_path(models_path: str) -> dict[str, ModelConfig]:
    """Every config of the models directory's ``*.yaml``/``*.yml`` files
    (not recursive, dotfiles skipped), by name; a later file's config of
    the same name wins, as the JAX registry's does. A file that cannot be
    read is logged and skipped."""
    out: dict[str, ModelConfig] = {}
    if not os.path.isdir(models_path):
        return out
    for fname in sorted(os.listdir(models_path)):
        if fname.startswith(".") or os.path.splitext(fname)[1] not in (
                ".yaml", ".yml"):
            continue
        path = os.path.join(models_path, fname)
        try:
            cfgs = load_config_file(path)
        except Exception as e:  # a bad file must not stop the others
            log.warning("skipping config %s: %s", path, e)
            continue
        for cfg in cfgs:
            out[cfg.name] = cfg
    return out


class ConfigLoader:
    """The model configs the server knows, by name."""

    def __init__(self, models_path: str = "models") -> None:
        self.models_path = str(models_path)
        self._configs: dict[str, ModelConfig] = {}
        self._lock = threading.RLock()

    def load_configs_from_path(self, path: Optional[str] = None) -> int:
        """Register the models directory's configs; their count."""
        found = load_configs_from_path(path or self.models_path)
        for cfg in found.values():
            self.register(cfg)
        return len(found)

    def register(self, cfg: ModelConfig) -> None:
        with self._lock:
            self._configs[cfg.name] = cfg

    def remove(self, name: str) -> None:
        with self._lock:
            self._configs.pop(name, None)

    def get(self, name: str) -> Optional[ModelConfig]:
        with self._lock:
            return self._configs.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._configs)

    def all(self) -> list[ModelConfig]:
        with self._lock:
            return [self._configs[k] for k in sorted(self._configs)]

    def by_usecase(self, usecase: Usecase) -> list[ModelConfig]:
        return [c for c in self.all() if c.has_usecase(usecase)]

    def first_available(self, usecase: Usecase = Usecase.ANY
                        ) -> Optional[ModelConfig]:
        """Default-model selection (ref:
        core/http/middleware/request.go:84-111)."""
        matches = self.by_usecase(usecase)
        return matches[0] if matches else None

    def resolve(self, name: Optional[str], usecase: Usecase = Usecase.ANY
                ) -> Optional[ModelConfig]:
        """A request's model name to a config: by name, else a bare
        on-disk model entry (registered), else — no name given — the
        first config serving the usecase."""
        if name:
            with self._lock:
                cfg = self._configs.get(name)
                if cfg is not None:
                    return cfg
                cfg = ModelConfig.from_dict({"name": name, "model": name})
                if cfg.validate() and os.path.exists(
                        os.path.join(self.models_path, name)):
                    self._configs[name] = cfg
                    return cfg
            return None
        return self.first_available(usecase)
