"""Scheduler/device flight recorder: a bounded, lock-cheap timeline ring
(own copy of localai_tfp_tpu/telemetry/flightrec.py).

Samples what the serving stack did over time: per-dispatch device
spans (``step:<kind>`` on the ``device`` track, with
``predicted_ms``/``measured_ms`` where the cost model priced the
dispatch), scheduler counters (queue depth, busy slots, KV pages in use,
host pages of the KV tier) and KV tier transfer spans (``kv:spill``,
``kv:fetch``, ``kv:save``, ``kv:load`` on the ``kv_tier`` track), and
exports them as Chrome-trace JSON (``GET /debug/timeline``) that loads
into Perfetto (https://ui.perfetto.dev) or chrome://tracing.

Every recorded value is a host-held scalar the caller already owns: a
step span is stamped from host clocks after the dispatch's tokens were
read back, a transfer span after its CUDA event reported complete, so a
sample never forces a device sync. A record is one short lock around a
list-slot store; the ring never grows and drops the oldest event on
overflow.

The recorder is process-global (``FLIGHT``); every engine writes to one
timeline under its tracks on a shared clock (perf_counter, microseconds
since process start). ``LOCALAI_TIMELINE=off`` disables recording;
``LOCALAI_TIMELINE_EVENTS`` sizes the ring (default 8192).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..config import knobs
from .metrics import TIMELINE_RING_EVENTS

# shared clock origin: every event's ts is perf_counter relative to this
_T0 = time.perf_counter()

# the timeline thread of KV tier transfers: spill/fetch spans interleave
# against the "device" track's step spans in Perfetto
KV_TIER_TRACK = "kv_tier"

# the timeline thread of disaggregated serving's KV page migration
# (engine/kv_migrate.py): its capture and stage spans interleave against
# both engines' "device" tracks
MIGRATE_TRACK = "migrate"

# the timeline thread of weight paging (engine/weight_pager.py): its
# demote and fetch spans interleave against the "device" track
WEIGHTS_TRACK = "weights"


def _env_capacity() -> int:
    return max(64, knobs.int_("LOCALAI_TIMELINE_EVENTS"))


class FlightRecorder:
    """Fixed-capacity ring of timeline events.

    Events are stored as compact tuples ``(ph, name, track, ts, dur,
    args)`` with perf_counter timestamps and formatted only at export —
    the recording path does no string formatting, no dict merging and
    no allocation beyond the tuple itself."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity or _env_capacity()
        self.enabled = knobs.flag("LOCALAI_TIMELINE")
        self._lock = threading.Lock()
        self._buf: list = [None] * self.capacity
        self._n = 0  # events ever recorded (ring head = _n % capacity)

    # ------------------------------------------------------- recording

    def record(self, ph: str, name: str, track: str, ts: float,
               dur: float = 0.0, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._buf[self._n % self.capacity] = (
                ph, name, track, ts, dur, args)
            self._n += 1

    def span(self, name: str, track: str, t0: float, dur_s: float,
             args: Optional[dict] = None) -> None:
        """A complete interval (Chrome-trace "X"): host-measured start
        and duration, e.g. a device flight from enqueue to ready.
        ``args`` is caller-owned scalars only — the harvest path adds
        ``predicted_ms``/``measured_ms`` to step spans it has a
        prediction for, never anything requiring device work."""
        self.record("X", name, track, t0, dur_s, args)

    def instant(self, name: str, track: str,
                args: Optional[dict] = None) -> None:
        self.record("i", name, track, time.perf_counter(), 0.0, args)

    def sample(self, name: str, track: str, value: float) -> None:
        """A sampled counter series (Chrome-trace "C" phase): queue
        depth, busy slots, KV pool pages — Perfetto renders these as
        stacked area charts above the track."""
        self.record("C", name, track, time.perf_counter(), 0.0,
                    {"value": value})

    def transfer(self, direction: str, t0: float, dur_s: float,
                 pages: int, nbytes: int, blocking: bool = False,
                 track: str = KV_TIER_TRACK, prefix: str = "kv") -> None:
        """A transfer span (KV spill/fetch/save/load, engine/kv_tier.py;
        KV migration on ``MIGRATE_TRACK``; weight demote/fetch/promote
        with ``prefix="w"`` on ``WEIGHTS_TRACK``): enqueue to observed
        completion, stamped when its owner saw it complete, so recording
        one never forces a sync. ``blocking`` marks a transfer the
        scheduler waited on; none of them records one."""
        self.record("X", prefix + ":" + direction, track, t0, dur_s,
                    {"pages": pages, "bytes": nbytes,
                     "blocking": blocking})

    # ------------------------------------------------------ inspection

    def occupancy(self) -> int:
        with self._lock:
            return min(self._n, self.capacity)

    def total_recorded(self) -> int:
        with self._lock:
            return self._n

    def dropped(self) -> int:
        with self._lock:
            return max(0, self._n - self.capacity)

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0

    def update_gauge(self) -> None:
        """Refresh timeline_ring_events_count (called from the engine's
        per-iteration gauge pass and at export — never per event)."""
        TIMELINE_RING_EVENTS.set(self.occupancy())

    # ---------------------------------------------------------- export

    def export_chrome_trace(self) -> dict:
        """The ring as a Chrome-trace JSON object (Perfetto-loadable):
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with one
        pid for the process and one tid per track. Timestamps are
        microseconds since process start, oldest event first."""
        with self._lock:
            n = min(self._n, self.capacity)
            start = self._n - n
            rows = [self._buf[(start + i) % self.capacity]
                    for i in range(n)]
        self.update_gauge()
        tids: dict[str, int] = {}
        events: list[dict] = []
        for ph, name, track, ts, dur, args in rows:
            tid = tids.setdefault(track, len(tids) + 1)
            ev: dict = {
                "name": name, "ph": ph, "pid": 1, "tid": tid,
                "ts": round((ts - _T0) * 1e6, 1),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 1)
            if ph == "i":
                ev["s"] = "t"  # thread-scoped instant marker
            if args:
                ev["args"] = args
            events.append(ev)
        meta: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1,
            "args": {"name": "localai-tfp-torch"},
        }]
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": track}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorded_total": self.total_recorded(),
                "ring_capacity": self.capacity,
                "dropped": self.dropped(),
            },
        }


FLIGHT = FlightRecorder()
