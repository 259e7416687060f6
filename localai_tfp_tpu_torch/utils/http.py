"""Standard-library HTTP helpers for clients and remote workers
(counterpart of localai_tfp_tpu/utils/http.py)."""

from __future__ import annotations

import json
import urllib.request


def json_request(url: str, payload: dict, *, api_key: str = "",
                 timeout: float = 600.0):
    """POST JSON with optional bearer auth; returns the open response
    (the caller reads or streams it, and closes it)."""
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={
            "Content-Type": "application/json",
            **({"Authorization": f"Bearer {api_key}"} if api_key else {}),
        },
    )
    return urllib.request.urlopen(req, timeout=timeout)


def json_post(url: str, payload: dict, *, api_key: str = "",
              timeout: float = 600.0) -> dict:
    """POST JSON and parse the JSON reply."""
    with json_request(url, payload, api_key=api_key, timeout=timeout) as r:
        body = r.read()
    return json.loads(body) if body else {}
