"""``python -m localai_tfp_tpu_torch.server [flags]``: serve a models
directory over HTTP.

The flags are the JAX server's (ref: core/cli/run.go RunCMD) plus
``--device``; each flag overrides ``ApplicationConfig.from_env()``,
which reads ``LOCALAI_<NAME>`` else ``<NAME>`` (``MODELS_PATH``,
``ADDRESS``, ``PORT``, ``API_KEY``, ``SINGLE_ACTIVE_BACKEND``,
``WATCHDOG_IDLE``, ``WATCHDOG_BUSY``, ``CORS``, ``UPLOAD_LIMIT``, ...).
"""

from __future__ import annotations

import argparse
import logging

from ..config.app_config import ApplicationConfig
from .app import run
from .state import Application


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m localai_tfp_tpu_torch.server")
    ap.add_argument("--models-path", default=None,
                    help="directory of model configs (*.yaml) and model "
                         "directories")
    ap.add_argument("--address", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--api-key", action="append", default=None)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--single-active-backend", action="store_true")
    ap.add_argument("--enable-watchdog-idle", action="store_true")
    ap.add_argument("--enable-watchdog-busy", action="store_true")
    ap.add_argument("--watchdog-idle-timeout", type=float, default=None)
    ap.add_argument("--watchdog-busy-timeout", type=float, default=None)
    ap.add_argument("--disable-metrics", action="store_true")
    ap.add_argument("--machine-tag", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) raises when no card is present")
    args = ap.parse_args(argv)

    cfg = ApplicationConfig.from_env()
    for key in ("models_path", "address", "port", "watchdog_idle_timeout",
                "watchdog_busy_timeout", "machine_tag"):
        if getattr(args, key) is not None:
            setattr(cfg, key, getattr(args, key))
    if args.api_key:
        cfg.api_keys = args.api_key
    for key in ("debug", "single_active_backend", "enable_watchdog_idle",
                "enable_watchdog_busy", "disable_metrics"):
        if getattr(args, key):
            setattr(cfg, key, True)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    run(Application(cfg, args.device))


if __name__ == "__main__":
    main()
