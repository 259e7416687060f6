"""On-disk cache of quantized parameter trees (counterpart of
localai_tfp_tpu/models/artifact_cache.py, in the same format, so an
artifact written by either package loads in the other).

The first int8 load of a checkpoint pays read + cast + quantize; the tree
is then written once, and every later load of the same checkpoint reads
the int8 tree straight from disk. One safetensors file per
(checkpoint, quant config) fingerprint, with ``{"format":
FORMAT_VERSION}`` metadata; QTensor leaves flatten to ``<name>.q`` /
``<name>.scale``, plain leaves keep their name. The fingerprint hashes
the checkpoint's file stats (name, size, mtime_ns), the canonical quant
and the serving dtype, so an edited checkpoint or another quant config
misses cleanly. A write goes to a temp file and renames atomically; a
failed or disabled write (``LOCALAI_QUANT_ARTIFACTS=off``) costs only the
speed-up. The port writes synchronously at the end of the load (it has
no warmup to defer behind); the JAX package's LRU size budget is not
ported yet.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import Any, Optional

import torch

from ..config import knobs
from .load_timing import phase
from .quant import QTensor
from .safetensors_io import SafeTensorsFile, save_iter

log = logging.getLogger(__name__)

FORMAT_VERSION = "int8-artifact-v1"


def enabled() -> bool:
    return knobs.flag("LOCALAI_QUANT_ARTIFACTS")


def cache_dir() -> str:
    root = knobs.raw("LOCALAI_QUANT_CACHE_DIR")
    if not root:
        xdg = os.environ.get("XDG_CACHE_HOME",
                             os.path.expanduser("~/.cache"))
        root = os.path.join(xdg, "localai_tpu", "quant")
    return root


def canonical_quant(quant: str) -> str:
    """'int8', 'q8', 'q8_0', 'w8' all mean weight-only int8 (one
    artifact); 'int8_full' adds quantized embeddings."""
    return "int8_full" if quant == "int8_full" else "int8"


def fingerprint(model_dir: str, quant: str, dtype_name: str) -> str:
    """Hash of the source checkpoint's identity + quant config (the JAX
    package's recipe, byte for byte)."""
    entries = []
    for f in sorted(os.listdir(model_dir)):
        if f.endswith((".safetensors", ".bin", ".gguf")) or f in (
                "config.json",):
            st = os.stat(os.path.join(model_dir, f))
            entries.append((f, st.st_size, st.st_mtime_ns))
    blob = json.dumps({
        "version": FORMAT_VERSION,
        "files": entries,
        "quant": canonical_quant(quant),
        "dtype": dtype_name,
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def artifact_path(model_dir: str, quant: str, dtype_name: str) -> str:
    return os.path.join(
        cache_dir(), f"{fingerprint(model_dir, quant, dtype_name)}.safetensors")


def try_load(path: str, device: Any,
             keep_host: Optional[dict[str, Any]] = None
             ) -> Optional[dict[str, Any]]:
    """Read an artifact onto ``device``; None on a miss, a disabled cache,
    another format or an unreadable file (logged).

    ``keep_host`` (a dict the caller owns) is filled with the host side
    of every leaf as it streams past (``QTensor`` leaves as host
    ``QTensor``s): views of the file's mapping, so the weight pager
    (engine/weight_pager.py) gets a host mirror of the tree for free and
    the model's first demotion copies nothing off the device. It is
    emptied on a miss."""
    if not enabled() or not os.path.exists(path):
        return None
    host_leaves: dict[str, Any] = {}
    try:
        f = SafeTensorsFile(path)
        if f.metadata.get("format") != FORMAT_VERSION:
            return None
        params: dict[str, Any] = {}
        parts: dict[str, dict[str, torch.Tensor]] = {}
        host_parts: dict[str, dict[str, torch.Tensor]] = {}
        for name in f.keys():
            with phase("read_s"):
                host = f.get(name)
            with phase("transfer_s", device):
                t = host.to(device=device, copy=True)
            if name.endswith(".q"):
                parts.setdefault(name[:-2], {})["q"] = t
                host_parts.setdefault(name[:-2], {})["q"] = host
            elif name.endswith(".scale"):
                parts.setdefault(name[:-6], {})["scale"] = t
                host_parts.setdefault(name[:-6], {})["scale"] = host
            else:
                params[name] = t
                host_leaves[name] = host
        for name, pq in parts.items():
            if set(pq) != {"q", "scale"}:
                if keep_host is not None:
                    keep_host.clear()
                return None
            params[name] = QTensor(pq["q"], pq["scale"])
            host_leaves[name] = QTensor(host_parts[name]["q"],
                                        host_parts[name]["scale"])
    except (OSError, ValueError, KeyError) as e:
        log.warning("quant artifact %s unreadable (%r); full load", path, e)
        if keep_host is not None:
            keep_host.clear()
        return None
    if keep_host is not None:
        keep_host.update(host_leaves)
    try:
        os.utime(path, None)  # a hit marks the artifact as live
    except OSError:
        pass
    return params


def _flatten(params: dict[str, Any]) -> list[tuple[str, torch.Tensor]]:
    flat = []
    for name, leaf in params.items():
        if isinstance(leaf, QTensor):
            flat += [(name + ".q", leaf.q), (name + ".scale", leaf.scale)]
        else:
            flat.append((name, leaf))
    return flat


def save(path: str, params: dict[str, Any]) -> bool:
    """Write the tree (one tensor at a time through host memory) to a
    temp file and rename it into place. False when disabled or failed."""
    if not enabled():
        return False
    root = os.path.dirname(path)
    try:
        os.makedirs(root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
        os.close(fd)
        try:
            flat = _flatten(params)
            save_iter(iter(flat), tmp, {"format": FORMAT_VERSION},
                      shapes=flat)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, ValueError, RuntimeError) as e:
        log.warning("quant artifact write failed (%r): %s", e, path)
        return False
    log.info("quant artifact written: %s", path)
    return True
