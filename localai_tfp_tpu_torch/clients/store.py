"""Typed client for the vector-store REST API (counterpart of
localai_tfp_tpu/clients/store.py; ref: core/clients/store.go —
SetCols/GetCols/DeleteCols/Find over /stores/{set,get,delete,find}).
Standard library only, over ``utils/http.py``."""

from __future__ import annotations

from typing import Sequence

from ..utils.http import json_post


class StoreClient:
    def __init__(self, base_url: str, api_key: str = "",
                 store: str = "") -> None:
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.store = store

    def _post(self, path: str, payload: dict) -> dict:
        if self.store:
            payload.setdefault("store", self.store)
        return json_post(self.base_url + path, payload,
                         api_key=self.api_key, timeout=60)

    def set(self, keys: Sequence[Sequence[float]],
            values: Sequence[str]) -> None:
        self._post("/stores/set", {"keys": [list(k) for k in keys],
                                   "values": list(values)})

    def get(self, keys: Sequence[Sequence[float]]
            ) -> tuple[list[list[float]], list[str]]:
        out = self._post("/stores/get", {"keys": [list(k) for k in keys]})
        return out.get("keys") or [], out.get("values") or []

    def delete(self, keys: Sequence[Sequence[float]]) -> None:
        self._post("/stores/delete", {"keys": [list(k) for k in keys]})

    def find(self, key: Sequence[float], topk: int = 10
             ) -> tuple[list[list[float]], list[str], list[float]]:
        out = self._post("/stores/find", {"key": list(key), "topk": topk})
        return (out.get("keys") or [], out.get("values") or [],
                out.get("similarities") or [])
