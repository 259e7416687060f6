"""Phase-timing breakdown of a model load (own copy of
localai_tfp_tpu/models/load_timing.py, with the port's meaning of each
phase):

    read_s      host IO: checkpoint/artifact bytes off disk
    dequant_s   GGUF dequantization and int8 quantization at load
    transfer_s  host->device placement (and the cast on the device)
    compile_s   engine construction, including the first-use nvcc
                build of the kernels (ops/_build.py)
    warmup_s    CUDA-graph capture of every dispatch variant

and the total. Phases are measured as blocking time of the loading
thread, so the breakdown answers "where did the wall time go";
``other_s`` is the unattributed remainder (tokenizer, config parse).
A checkpoint is memory-mapped: its pages fault in inside the
host->device copy, so file reads the page cache did not hold land in
``transfer_s``.

The loader binds a ``LoadPhases`` to its thread with ``bind``; the
loading functions bill into it through ``phase`` (into a throwaway
accumulator when none is bound). Surfaced on the loaded backend as
``load_breakdown`` and through ``/backend/monitor``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

PHASES = ("read_s", "dequant_s", "transfer_s", "compile_s", "warmup_s")


class LoadPhases:
    """Thread-safe accumulator of per-phase seconds for one load."""

    def __init__(self) -> None:
        self._t = {p: 0.0 for p in PHASES}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def add(self, phase: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        with self._lock:
            self._t[phase] = self._t.get(phase, 0.0) + seconds

    def as_dict(self, total_s: Optional[float] = None) -> dict:
        """Snapshot; ``other_s`` is the unattributed remainder (tokenizer
        load, config parse, ...) so the phases always reconcile against
        the total."""
        with self._lock:
            out = {p: round(v, 2) for p, v in self._t.items()}
        if total_s is None:
            total_s = time.perf_counter() - self._t0
        out["total_s"] = round(total_s, 2)
        out["other_s"] = round(
            max(0.0, total_s - sum(self._t.values())), 2)
        return out


_bound = threading.local()


@contextmanager
def bind(phases: LoadPhases):
    """Make ``phases`` this thread's ``current()`` for the block."""
    prev = getattr(_bound, "phases", None)
    _bound.phases = phases
    try:
        yield phases
    finally:
        _bound.phases = prev


def current() -> LoadPhases:
    """The accumulator bound to this thread, else a throwaway one."""
    return getattr(_bound, "phases", None) or LoadPhases()


@contextmanager
def phase(name: str, device: Any = None):
    """Bill the block to this thread's ``current()`` phase ``name``. With
    a CUDA ``device`` the block's device work completes inside it (a
    load-time synchronize), so kernels it queued are not billed to the
    next phase that waits."""
    ph = current()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and str(device).startswith("cuda"):
            import torch

            torch.cuda.synchronize(device)
        ph.add(name, time.perf_counter() - t0)
