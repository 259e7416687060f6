"""Environment knobs the port reads (own copy of the few entries of
localai_tfp_tpu/config/knobs.py this slice needs: same names, same
defaults)."""

from __future__ import annotations

import os

_DEFAULTS = {
    # KV page-size override: power of two >= 8 dividing max_seq (0 = auto,
    # largest <= 256)
    "LOCALAI_KV_PAGE": "0",
    # physical page-count override (0 = n_slots * pages_per_slot + 1)
    "LOCALAI_KV_PAGES": "0",
    # admission queue cap: submit_many sheds beyond it with a terminal
    # "shed" event (0 = unbounded)
    "LOCALAI_MAX_QUEUE": "0",
    # token budget per mixed prefill/decode dispatch
    "LOCALAI_PREFILL_GROUP_TOKENS": "8192",
    # persist/reuse int8 quantization artifacts on disk
    "LOCALAI_QUANT_ARTIFACTS": "on",
    # quant-artifact cache root ('' = $XDG_CACHE_HOME/localai_tpu/quant)
    "LOCALAI_QUANT_CACHE_DIR": "",
}
_TRUE = ("1", "true", "yes", "on")
_FALSE = ("", "0", "false", "no", "off")


def raw(name: str) -> str:
    """The env string, or the default when unset (KeyError on a typo)."""
    return os.environ.get(name, _DEFAULTS[name])


def int_(name: str) -> int:
    try:
        return int(raw(name) or _DEFAULTS[name])
    except ValueError:
        return int(_DEFAULTS[name])


def flag(name: str) -> bool:
    """On/off knob; a value that is neither reads as the default."""
    v = raw(name).strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return _DEFAULTS[name] in _TRUE
