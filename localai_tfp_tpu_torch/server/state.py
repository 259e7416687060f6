"""Application wiring: the config registry, the model loader and its
watchdog, the config-file watcher and the templater, and the startup
sequence (counterpart of localai_tfp_tpu/server/state.py; ref:
core/application/application.go:9-14, startup.go:20-164).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Optional

from ..config.app_config import ApplicationConfig
from ..config.loader import ConfigLoader
from ..config.watcher import ConfigWatcher
from ..device import resolve
from ..engine.loader import (ALIASES, ModelLoader, WatchDog,
                             register_default_backends, registry)
from ..engine.templating import Evaluator
from ..workers.base import Backend
from ..workers.remote import RemoteOpenAIBackend

log = logging.getLogger(__name__)


class Application:
    """The state every route handler reads. ``device`` is where the LLM
    worker loads models: the card unless the caller asks for the CPU."""

    def __init__(self, config: Optional[ApplicationConfig] = None,
                 device: Any = None) -> None:
        self.config = config or ApplicationConfig.from_env()
        self.device = resolve(device)
        self.config_loader = ConfigLoader(self.config.models_path)
        self.model_loader = ModelLoader(
            self.config.models_path,
            single_active_backend=self.config.single_active_backend)
        self.evaluator = Evaluator(self.config.models_path)
        self.watchdog = WatchDog(
            self.model_loader,
            busy_timeout=self.config.watchdog_busy_timeout,
            idle_timeout=self.config.watchdog_idle_timeout,
            enable_busy=self.config.enable_watchdog_busy,
            enable_idle=self.config.enable_watchdog_idle)
        self.config_watcher = ConfigWatcher(self.config.config_dir)
        self.started_at = time.time()

    def startup(self) -> None:
        register_default_backends(self.device)
        n = self.config_loader.load_configs_from_path()
        log.info("loaded %d model configs from %s", n,
                 self.config.models_path)
        self.watchdog.start()
        self._start_config_watcher()

    def _start_config_watcher(self) -> None:
        """Hot reload of ``api_keys.json`` and ``external_backends.json``
        (ref: core/application/config_file_watcher.go)."""
        startup_keys = list(self.config.api_keys)

        def on_api_keys(data) -> None:
            # file keys extend the startup keys; removing the file
            # restores them (a dropped file never disables the auth
            # configured at boot)
            file_keys = ([str(k) for k in data] if isinstance(data, list)
                         else [])
            self.config.api_keys = startup_keys + [
                k for k in file_keys if k not in startup_keys]

        external_names: set[str] = set()  # names this handler registered

        def on_external_backends(data) -> None:
            wanted: set[str] = set()
            for name, spec in (data or {}).items():
                if isinstance(spec, str):
                    spec = {"base_url": spec}
                url = spec.get("base_url") or spec.get("uri") or ""
                key = spec.get("api_key", "")
                lname = name.strip().lower()
                # never shadow an alias or a builtin worker
                if lname in ALIASES or (lname in registry.known()
                                        and lname not in external_names):
                    log.warning("external backend name '%s' collides with "
                                "a builtin backend; skipping", name)
                    continue
                registry.register(
                    lname,
                    lambda url=url, key=key: RemoteOpenAIBackend(url, key))
                wanted.add(lname)
                log.info("registered external backend '%s' -> %s", name,
                         url)
            # entries dropped from the file (or the file removed) go
            for stale in external_names - wanted:
                registry.unregister(stale)
                log.info("removed external backend '%s'", stale)
            external_names.clear()
            external_names.update(wanted)

        self.config_watcher.watch("api_keys.json", on_api_keys)
        self.config_watcher.watch("external_backends.json",
                                  on_external_backends)
        self.config_watcher.start()

    def shutdown(self) -> None:
        self.config_watcher.stop()
        self.watchdog.stop()
        self.model_loader.stop_all()

    # ---- what the routes call

    def loaded(self) -> dict[str, Backend]:
        """The loaded workers by model name."""
        out = {}
        for name in self.model_loader.loaded_names():
            lm = self.model_loader.get(name)
            if lm is not None:
                out[name] = lm.backend
        return out

    @contextlib.contextmanager
    def busy(self, model: str):
        """The watchdog's busy window around one inference call (ref: the
        gRPC client's Mark/UnMark pairing, pkg/grpc/client.go)."""
        self.model_loader.mark_busy(model)
        try:
            yield
        finally:
            self.model_loader.mark_idle(model)
