"""Model-config discovery and loading (the loading half of
localai_tfp_tpu/config/loader.py::ConfigLoader).

A file may hold several YAML documents, and a document may be a list of
configs (ref: backend_config_loader.go
LoadMultipleBackendConfigsSingleFile). Every document of a file is read
and validated before any is registered, so a bad document never leaves a
file half loaded. ``load_configs_from_path`` scans the top level of the
models directory for ``*.yaml``/``*.yml``, skipping dotfiles, as the JAX
loader does; where the JAX loader logs and skips a file it cannot read,
this one raises with the file and the reason, so a broken config is never
served as if it were absent.
"""

from __future__ import annotations

import os

from . import yaml_lite
from .model_config import ModelConfig


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
    the same name wins, as the JAX registry's does."""
    out: dict[str, ModelConfig] = {}
    if not os.path.isdir(models_path):
        return out
    for fname in sorted(os.listdir(models_path)):
        if fname.startswith(".") or os.path.splitext(fname)[1] not in (
                ".yaml", ".yml"):
            continue
        for cfg in load_config_file(os.path.join(models_path, fname)):
            out[cfg.name] = cfg
    return out
