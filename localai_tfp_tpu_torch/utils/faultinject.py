"""Deterministic fault injection for chaos testing the serving stack
(own copy of localai_tfp_tpu/utils/faultinject.py).

Named injection points sit in the failure-prone layers of the port: the
engine's KV growth (``engine.hbm_alloc``, the stand-in for a device
out-of-memory during page allocation), its device-step funnel
(``engine.device_step``), the model loader (``loader.load``) and the KV
tier's transfer lanes (``kv_tier.spill``, ``kv_tier.fetch``). They are
armed via

    LOCALAI_FAULTS="point:spec[,point:spec...]"

or programmatically with :func:`arm` (tests). Spec grammar, all
deterministic so chaos tests replay exactly:

    fail            fail every arrival at the point
    fail@N          fail exactly the Nth arrival (1-based, once)
    failafter@N     fail every arrival after the first N
    rate@P[@SEED]   fail fraction P of arrivals (counter-hash PRNG: the
                    same (point, seed, arrival#) always decides the same
                    way, so one spec fires the same sequence in both
                    packages; no global random state touched)
    delay@MS        sleep MS milliseconds on every arrival

Example: ``LOCALAI_FAULTS="engine.device_step:fail@3,loader.load:delay@50"``.

Cost: disarmed (the default) the only hot-path residue is one
module-attribute truthiness check (``if faultinject.ACTIVE``) at each
instrumented site. Every injected fault increments
``faults_injected_total{point}``.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Optional

from ..config import knobs

__all__ = ["InjectedFault", "arm", "disarm", "fire", "counts", "observe",
           "ACTIVE"]


class InjectedFault(RuntimeError):
    """Raised by an armed injection point. Deliberately a RuntimeError:
    the layers under test treat it exactly like a real device or IO
    failure, so chaos tests exercise the recovery path."""


class _Point:
    __slots__ = ("name", "mode", "arg", "seed", "hits", "injected")

    def __init__(self, name: str, mode: str, arg: float, seed: int) -> None:
        self.name = name
        self.mode = mode
        self.arg = arg
        self.seed = seed
        self.hits = 0  # arrivals seen
        self.injected = 0  # faults actually delivered

    def decide(self) -> Optional[str]:
        """Advance the arrival counter; return the action to take
        ("fail" / "delay") or None. Caller holds the registry lock."""
        self.hits += 1
        if self.mode == "fail":
            return "fail"
        if self.mode == "fail_nth":
            return "fail" if self.hits == int(self.arg) else None
        if self.mode == "fail_after":
            return "fail" if self.hits > int(self.arg) else None
        if self.mode == "rate":
            # counter-hash PRNG: uniform in [0,1) from (point, seed, n)
            h = zlib.crc32(
                f"{self.name}:{self.seed}:{self.hits}".encode())
            return "fail" if (h / 2**32) < self.arg else None
        if self.mode == "delay":
            return "delay"
        return None


_lock = threading.Lock()
_points: dict[str, _Point] = {}  # every access under _lock

# delivery observers: called OUTSIDE _lock with (point, action) for
# every fault actually delivered; telemetry/tracing.py registers one to
# annotate in-scope request traces
_observers: list = []


def observe(cb) -> None:
    """Register a delivery observer (idempotent per callback)."""
    if cb not in _observers:
        _observers.append(cb)

# module-level fast gate: instrumented sites check this BEFORE calling
# fire(), so the disarmed hot path pays one attribute read only
ACTIVE = False


def _parse_spec(name: str, spec: str) -> _Point:
    parts = spec.split("@")
    mode, args = parts[0].strip().lower(), parts[1:]
    if mode == "fail" and not args:
        return _Point(name, "fail", 0.0, 0)
    if mode == "fail" and len(args) == 1:
        return _Point(name, "fail_nth", float(int(args[0])), 0)
    if mode == "failafter" and len(args) == 1:
        return _Point(name, "fail_after", float(int(args[0])), 0)
    if mode == "rate" and args:
        p = float(args[0])
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"rate {p} outside [0, 1]")
        seed = int(args[1]) if len(args) > 1 else 0
        return _Point(name, "rate", p, seed)
    if mode == "delay" and len(args) == 1:
        return _Point(name, "delay", float(args[0]), 0)
    raise ValueError(f"unknown fault spec {spec!r} for point {name!r}")


def arm(config: str) -> None:
    """Parse and install ``point:spec[,point:spec...]``. Replaces any
    previous arming wholesale (counters restart), so a test's arm() is
    self-contained. An empty/blank config disarms."""
    global ACTIVE
    new: dict[str, _Point] = {}
    for entry in (config or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, sep, spec = entry.partition(":")
        if not sep:
            raise ValueError(
                f"fault entry {entry!r} is not 'point:spec'")
        new[point.strip()] = _parse_spec(point.strip(), spec)
    with _lock:
        _points.clear()
        _points.update(new)
        ACTIVE = bool(new)


def disarm() -> None:
    """Drop every armed point (tests call this in teardown)."""
    arm("")


def fire(point: str) -> None:
    """Arrival at a named injection point. No-op unless that point is
    armed; otherwise delays or raises :class:`InjectedFault` per the
    armed spec. Sites guard the call with ``if faultinject.ACTIVE`` so
    the disarmed cost stays one attribute read."""
    if not ACTIVE:
        return
    with _lock:
        p = _points.get(point)
        if p is None:
            return
        action = p.decide()
        if action is None:
            return
        p.injected += 1
        delay_s = p.arg / 1e3 if action == "delay" else 0.0
    from ..telemetry.metrics import FAULTS_INJECTED

    FAULTS_INJECTED.labels(point=point).inc()
    for cb in _observers:
        cb(point, action)
    if action == "delay":
        time.sleep(delay_s)
        return
    raise InjectedFault(f"injected fault at {point}")


def counts() -> dict[str, tuple[int, int]]:
    """{point: (arrivals, injected)} for armed points (chaos reports)."""
    with _lock:
        return {n: (p.hits, p.injected) for n, p in _points.items()}


# env arming: one parse at import so every layer sees the same set the
# moment the process starts
_env = knobs.str_("LOCALAI_FAULTS")
if _env:
    arm(_env)
