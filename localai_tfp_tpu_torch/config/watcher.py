"""Dynamic-config hot reload (counterpart of
localai_tfp_tpu/config/watcher.py; ref:
core/application/config_file_watcher.go).

A polling watcher over the configuration directory: each watched file's
handler gets its parsed JSON at start and on every mtime change, and
``None`` when the file is removed. A file that does not parse is logged
and skipped (the last good contents stay in force).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Optional

log = logging.getLogger(__name__)

Handler = Callable[[object], None]  # receives parsed JSON


class ConfigWatcher:
    def __init__(self, config_dir: str, *, interval: float = 2.0) -> None:
        self.config_dir = config_dir
        self.interval = interval
        self._handlers: dict[str, Handler] = {}
        self._mtimes: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, filename: str, handler: Handler) -> None:
        self._handlers[filename] = handler

    def start(self) -> None:
        for fname in self._handlers:  # apply current contents at boot
            self._check(fname, first=True)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="config-watcher", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            for fname in self._handlers:
                self._check(fname)

    def _check(self, fname: str, first: bool = False) -> None:
        path = os.path.join(self.config_dir, fname)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            if self._mtimes.pop(fname, None) is not None:
                self._fire(fname, None)  # file removed
            return
        if not first and self._mtimes.get(fname) == mtime:
            return
        self._mtimes[fname] = mtime
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            log.warning("ignoring unparseable %s: %s", fname, e)
            return
        self._fire(fname, data)

    def _fire(self, fname: str, data) -> None:
        try:
            self._handlers[fname](data)
            log.info("reloaded %s", fname)
        except Exception as e:  # a bad handler must not stop the watcher
            log.warning("handler for %s failed: %s", fname, e)
