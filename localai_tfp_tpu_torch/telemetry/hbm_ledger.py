"""Component-level device-memory ledger with OOM forensics (counterpart
of localai_tfp_tpu/telemetry/hbm_ledger.py).

Every long-lived device allocation the engine owns registers here at
its allocation site — the weights, the paged KV arena, its int8 scale
planes, the draft's arena, the sampler state, the CUDA-graph memory
pool — as a fixed byte count, a zero-argument callable (for components
whose footprint moves, like the graph pool as variants are captured),
or a tree of tensors measured at registration. ``reconcile`` reads the
caching allocator's own counters (``torch.cuda.memory_stats``: host-held
numbers, no device sync) and puts the difference between what the
allocator holds and what the ledger attributes on an explicit
``unattributed`` drift row: the allocator's cache of freed transients,
or an untracked buffer — a signal, not something to hide.

``bytes_in_use`` here is the allocator's *reserved* bytes: what the
process holds on the card (live tensors, the graph pool, the cache),
the number that runs out first, plus the components registered
``outside`` the allocator (the weight pager's slab, mapped with
``cuMemMap``). ``bytes_allocated`` (live tensors) and
``device_used`` (the card's total minus ``mem_get_info``'s free bytes,
other processes and the CUDA context included) sit beside it.

On ``torch.cuda.OutOfMemoryError`` in the engine's loop,
:func:`dump_post_mortem` writes a JSON forensics file (ledger snapshot,
page-pool stats, the allocator's counters, the error) under
``state_dir`` and returns its path.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Optional, Union

log = logging.getLogger(__name__)

__all__ = ["HBMLedger", "nbytes_of", "looks_like_oom",
           "default_state_dir", "dump_post_mortem", "device_memory_stats"]

Source = Union[int, float, Callable[[], int], Any]


def nbytes_of(tree: Any) -> int:
    """Total bytes of the tensors in a tree: a tensor, a dict / list /
    tuple of them (an int8 ``QTensor`` is a tuple of two planes), or a
    dataclass of them (``KVCache``, ``SamplingState``)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes_of(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(nbytes_of(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def looks_like_oom(e: BaseException) -> bool:
    """Is this exception a device allocation failure? A CUDA
    out-of-memory error, or the ``engine.hbm_alloc`` fault-injection
    point that stands in for one in tests."""
    import torch

    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or "engine.hbm_alloc" in repr(e))


def default_state_dir() -> str:
    """Where forensics land when the caller has no configured
    state_dir (STATE_DIR is the server's own env, not a LOCALAI_*
    knob)."""
    return os.environ.get("STATE_DIR") or "run"


def device_memory_stats(device: Any) -> Optional[dict]:
    """The caching allocator's counters for a CUDA device (host-held;
    ``mem_get_info`` is a runtime query, not a stream operation), or
    None on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    st = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return {"reserved_bytes.all.current":
            st.get("reserved_bytes.all.current", 0),
            "allocated_bytes.all.current":
            st.get("allocated_bytes.all.current", 0),
            "device_used": total - free}


class HBMLedger:
    """Byte attribution for one engine's device allocations.

    Sources are registered once per component and may be: a plain byte
    count, a zero-arg callable returning bytes (evaluated at read
    time), or a tree of tensors measured via ``nbytes_of`` at
    registration. Thread-safe: the engine registers while /metrics
    scrapes snapshot concurrently.
    """

    def __init__(self, model: str = "default",
                 memory_stats: Optional[Callable[[], Optional[dict]]]
                 = None) -> None:
        self.model = model
        self._memory_stats = memory_stats or (lambda: None)
        self._lock = threading.Lock()
        self._sources: dict[str, Source] = {}  # guarded by self._lock
        self._host: set[str] = set()  # guarded by self._lock
        self._outside: set[str] = set()  # guarded by self._lock
        self._last_reconcile: Optional[dict] = None  # guarded by self._lock

    def register(self, component: str, source: Source, host: bool = False,
                 outside: bool = False) -> None:
        """Attach/replace a component's byte source. Trees are measured
        once, now (re-register after reallocating). ``host=True`` marks a
        host-RAM component (the weight pager's warm mirror): it lands on
        its gauge but outside the device sum, since host bytes can never
        explain device bytes. ``outside=True`` marks device memory the
        caching allocator does not hold (the weight pager's slab, mapped
        with ``cuMemMap``): its bytes join the allocator's reserved
        bytes in ``bytes_in_use``."""
        if not (isinstance(source, (int, float)) or callable(source)):
            source = nbytes_of(source)
        with self._lock:
            self._sources[component] = source
            for kind, on in ((self._host, host), (self._outside, outside)):
                if on:
                    kind.add(component)
                else:
                    kind.discard(component)

    def attributed(self) -> dict[str, int]:
        """Current bytes per component (callables evaluated outside the
        lock)."""
        with self._lock:
            items = list(self._sources.items())
        return {name: int(src() if callable(src) else src)
                for name, src in items}

    def reconcile(self,
                  memory_stats: Optional[Callable[[], Optional[dict]]]
                  = None) -> dict:
        """Refresh the ``engine_hbm_bytes`` gauges and compute the
        drift row. ``memory_stats`` (default: the one given at
        construction) returns ``torch.cuda.memory_stats``-shaped
        counters, or None where there are none (the CPU): then the
        drift row is omitted."""
        from . import metrics as tm

        attr = self.attributed()
        st = (memory_stats or self._memory_stats)()
        for name, b in attr.items():
            tm.ENGINE_HBM_BYTES.labels(
                model=self.model, component=name).set(b)
        total = self._device_sum(attr)
        snap: dict[str, Any] = {"components": attr, "attributed": total,
                                "bytes_in_use": None}
        if st is not None:
            with self._lock:
                outside = sum(b for n, b in attr.items()
                              if n in self._outside)
            in_use = int(st.get("reserved_bytes.all.current", 0)) + outside
            drift = in_use - total
            tm.ENGINE_HBM_BYTES.labels(
                model=self.model, component="unattributed").set(drift)
            snap.update(
                bytes_in_use=in_use, unattributed=drift,
                drift_ratio=(drift / in_use) if in_use else 0.0,
                bytes_allocated=int(st.get("allocated_bytes.all.current",
                                           0)),
                device_used=st.get("device_used"))
        with self._lock:
            self._last_reconcile = snap
        return snap

    def snapshot(self) -> dict:
        """Last reconcile result (or a fresh attribution if none ran)."""
        with self._lock:
            last = self._last_reconcile
        if last is not None:
            return last
        attr = self.attributed()
        return {"components": attr, "attributed": self._device_sum(attr),
                "bytes_in_use": None}

    def _device_sum(self, attr: dict[str, int]) -> int:
        """The device components' bytes (host components left out)."""
        with self._lock:
            host = set(self._host)
        return sum(b for n, b in attr.items() if n not in host)

    def reset_gauges(self) -> None:
        """Zero this model's component gauges (engine close)."""
        from . import metrics as tm

        for name in list(self.attributed()) + ["unattributed"]:
            tm.ENGINE_HBM_BYTES.labels(
                model=self.model, component=name).set(0)


def dump_post_mortem(state_dir: str, model: str, error: BaseException,
                     ledger: Optional[HBMLedger] = None,
                     pool_stats: Any = None,
                     memory_stats: Optional[dict] = None,
                     tier_stats: Optional[dict] = None,
                     weight_stats: Optional[dict] = None) -> Optional[str]:
    """Write an OOM forensics JSON under ``state_dir``/post_mortem and
    return its path, or None when it could not be written: forensics
    must not mask the original failure. The report holds the ledger,
    the pool's, the KV tier's and the weight pager's stats, the allocator's counters and
    the flight recorder's last 256 events."""
    from .flightrec import FLIGHT

    report = {
        "kind": "hbm_post_mortem",
        "time": time.time(),
        "model": model,
        "error": repr(error),
        "ledger": ledger.snapshot() if ledger is not None else None,
        "kv_pool": (dataclasses.asdict(pool_stats)
                    if pool_stats is not None else None),
        "kv_tier": tier_stats,
        "weight_pager": weight_stats,
        "memory_stats": memory_stats,
        "flightrec_tail": FLIGHT.export_chrome_trace()["traceEvents"][-256:],
    }
    pm_dir = os.path.join(state_dir or default_state_dir(), "post_mortem")
    path = os.path.join(pm_dir, f"hbm-{int(time.time() * 1e3)}.json")
    try:
        os.makedirs(pm_dir, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, default=str)
    except OSError as e:
        log.warning("post-mortem dump failed: %r", e)
        return None
    log.error("HBM post-mortem written to %s (error: %r)", path, error)
    return path
