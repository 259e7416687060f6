"""``python -m localai_tfp_tpu_torch.server --models-path DIR --port N
[--device cuda|cpu]``: serve the models directory's configs over HTTP."""

from __future__ import annotations

import argparse
import logging

from .app import build_server


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m localai_tfp_tpu_torch.server")
    ap.add_argument("--models-path", required=True,
                    help="directory of JSON-syntax *.yaml model configs")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) raises when no card is present")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    srv = build_server(args.models_path, args.host, args.port, args.device)
    logging.info("serving %s on http://%s:%d", args.models_path,
                 *srv.server_address[:2])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        srv.app.close()


if __name__ == "__main__":
    main()
