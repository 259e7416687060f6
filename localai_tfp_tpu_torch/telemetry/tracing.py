"""Request-lifecycle tracing: a lightweight span recorder keyed by
request id, carrying a W3C trace id end to end (own copy of
localai_tfp_tpu/telemetry/tracing.py).

A request flows receive -> queue -> admit -> prefill_dispatch ->
first_token -> done -> stream_done across server/app.py,
server/openai_routes.py and engine/engine.py; each layer stamps its
milestone with ``TRACER.event(request_id, phase)`` (perf_counter
timestamps, no locks held across anything slow). Finished traces live
in a bounded ring served by ``GET /debug/traces`` (newest first,
filterable by model, looked up by ``?id=``).

Spans are derived between consecutive milestones and named for what the
request was doing in that interval: "queue" is queue->admit, "prefill"
is admit->prefill_dispatch, "first_token" is dispatch->first sampled
token, "decode" is first_token->done. Their sum is the traced wall time.

Every trace carries a 32-hex ``trace_id``, minted at the HTTP edge from
an incoming ``traceparent`` header or locally when none arrived; armed
fault-injection deliveries land as span events on the traces in scope
(``fault_scope``). Span events (``annotate``) are point-in-time notes
(fault deliveries, terminal outcomes) kept apart from the milestones;
each trace holds at most ``NOTE_CAP`` of them, and overflow increments
``trace_spans_dropped_total{reason="note_cap"}``, as do evictions of
still-active traces ("active_overflow") and finished traces pushed out
of the ring ("ring_evict").
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from typing import Optional

from .metrics import TRACE_SPANS_DROPPED
from ..utils import faultinject

# milestone order (a layer may legitimately skip phases — e.g. an
# engine-level request has no receive/auth, a cancelled-in-queue
# request has no first_token)
PHASES = ("receive", "auth", "queue", "admit", "prefill_dispatch",
          "first_token", "done", "stream_done")

# span name keyed by the milestone that STARTS the interval
_SPAN_NAME = {
    "receive": "receive",
    "auth": "preprocess",
    "queue": "queue",
    "admit": "prefill",
    "prefill_dispatch": "first_token",
    "first_token": "decode",
    "done": "stream_flush",
}

# span events kept per trace before overflow counting starts
NOTE_CAP = 64


# --------------------------------------------------- W3C traceparent helpers
#
# The wire format is the W3C Trace Context header:
#     traceparent: 00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>
# Only the trace id joins entries across processes; span ids are minted
# fresh per hop so an upstream can tell hops apart.


def mint_trace_id() -> str:
    return uuid.uuid4().hex  # 32 lowercase hex chars


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def make_traceparent(trace_id: str, span_id: str = "") -> str:
    return f"00-{trace_id}-{span_id or new_span_id()}-01"


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """(trace_id, span_id) from a ``traceparent`` header, or None when
    the header is absent/malformed (the caller then mints fresh ids —
    a bad header must never fail a request)."""
    parts = (header or "").strip().lower().split("-")
    if len(parts) < 4:
        return None
    _, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace_id, span_id


class _Trace:
    __slots__ = ("request_id", "model", "correlation_id", "status",
                 "wall_start", "t0", "events", "trace_id", "parent_span",
                 "notes")

    def __init__(self, request_id: str, model: str = "",
                 correlation_id: str = "", trace_id: str = "",
                 parent_span: str = "") -> None:
        self.request_id = request_id
        self.model = model
        self.correlation_id = correlation_id
        self.trace_id = trace_id or mint_trace_id()
        self.parent_span = parent_span
        self.status = "active"
        self.wall_start = time.time()
        self.t0: Optional[float] = None  # perf_counter of first event
        self.events: list[tuple[str, float]] = []
        # span events: (name, perf_counter t, attrs dict) — bounded by
        # NOTE_CAP at the recorder layer
        self.notes: list[tuple[str, float, dict]] = []

    def add(self, phase: str, t: float) -> None:
        if self.t0 is None:
            self.t0 = t
        self.events.append((phase, t))

    def as_dict(self) -> dict:
        t0 = self.t0 if self.t0 is not None else 0.0
        events = [{"phase": p, "t_ms": round((t - t0) * 1e3, 3)}
                  for p, t in self.events]
        spans = []
        for (p_a, t_a), (_, t_b) in zip(self.events, self.events[1:]):
            spans.append({
                "name": _SPAN_NAME.get(p_a, p_a),
                "start_ms": round((t_a - t0) * 1e3, 3),
                "dur_ms": round((t_b - t_a) * 1e3, 3),
            })
        total = (self.events[-1][1] - t0) * 1e3 if self.events else 0.0
        return {
            "request_id": self.request_id,
            "model": self.model,
            "correlation_id": self.correlation_id,
            "trace_id": self.trace_id,
            "parent_span": self.parent_span,
            "status": self.status,
            "start_unix": round(self.wall_start, 3),
            "total_ms": round(total, 3),
            "events": events,
            "spans": spans,
            "span_events": [
                {"name": n, "t_ms": round((t - t0) * 1e3, 3), **a}
                for n, t, a in self.notes
            ],
        }


class TraceRecorder:
    """Bounded recorder: ``capacity`` finished traces in a ring,
    ``active_cap`` in-flight traces (oldest evicted — a handler that
    dies before its request reaches the engine cannot leak entries)."""

    def __init__(self, capacity: int = 256, active_cap: int = 1024) -> None:
        self.capacity = capacity
        self.active_cap = active_cap
        self._lock = threading.Lock()
        self._active: "OrderedDict[str, _Trace]" = OrderedDict()
        self._done: "OrderedDict[str, _Trace]" = OrderedDict()

    def start(self, request_id: str, model: str = "",
              correlation_id: str = "",
              events: Optional[list[tuple[str, float]]] = None,
              trace_id: str = "", parent_span: str = "") -> None:
        """Open a trace, optionally seeding milestones already measured
        by an outer layer (the HTTP middlewares' receive/auth stamps)
        and adopting a distributed ``trace_id`` parsed from the wire
        (``parent_span`` is the caller's span id from the same
        traceparent header, when there was one)."""
        if not request_id:
            return
        dropped = 0
        with self._lock:
            tr = self._active.get(request_id)
            if tr is None:
                tr = _Trace(request_id, model, correlation_id,
                            trace_id=trace_id, parent_span=parent_span)
                self._active[request_id] = tr
                while len(self._active) > self.active_cap:
                    self._active.popitem(last=False)
                    dropped += 1
            else:
                tr.model = model or tr.model
                tr.correlation_id = correlation_id or tr.correlation_id
                tr.trace_id = trace_id or tr.trace_id
                tr.parent_span = parent_span or tr.parent_span
            for phase, t in events or []:
                tr.add(phase, t)
        if dropped:
            TRACE_SPANS_DROPPED.labels(reason="active_overflow").inc(
                dropped)

    def event(self, request_id: str, phase: str,
              t: Optional[float] = None, model: str = "") -> None:
        """Stamp a milestone. Auto-opens the trace (engine-only callers
        have no HTTP layer to call start()); a late milestone landing
        after finish() — the bridge's stream_done — appends to the
        finished trace in the ring."""
        if not request_id:
            return
        t = time.perf_counter() if t is None else t
        dropped = 0
        with self._lock:
            tr = self._active.get(request_id)
            if tr is None:
                tr = self._done.get(request_id)
            if tr is None:
                tr = _Trace(request_id, model)
                self._active[request_id] = tr
                while len(self._active) > self.active_cap:
                    self._active.popitem(last=False)
                    dropped += 1
            tr.add(phase, t)
        if dropped:
            TRACE_SPANS_DROPPED.labels(reason="active_overflow").inc(
                dropped)

    def annotate(self, request_id: str, name: str,
                 t: Optional[float] = None, **attrs) -> None:
        """Attach a span event (fault delivery, retry/breaker decision,
        terminal detail) to an active or finished trace. Unknown ids
        are dropped silently — annotations are best-effort context, and
        auto-opening here would mint junk entries for engine-internal
        ids that never had a request."""
        if not request_id:
            return
        t = time.perf_counter() if t is None else t
        capped = False
        with self._lock:
            tr = self._active.get(request_id) or self._done.get(request_id)
            if tr is None:
                return
            if len(tr.notes) >= NOTE_CAP:
                capped = True
            else:
                tr.notes.append((name, t, attrs))
        if capped:
            TRACE_SPANS_DROPPED.labels(reason="note_cap").inc()

    def finish(self, request_id: str, status: str = "done") -> None:
        evicted = 0
        with self._lock:
            tr = self._active.pop(request_id, None)
            if tr is None:
                return
            tr.status = status
            self._done[request_id] = tr
            while len(self._done) > self.capacity:
                self._done.popitem(last=False)
                evicted += 1
        if evicted:
            TRACE_SPANS_DROPPED.labels(reason="ring_evict").inc(evicted)

    def trace_id_of(self, request_id: str) -> str:
        """The distributed trace id carried by a request's trace, or ""
        when no trace is open for it."""
        with self._lock:
            tr = self._active.get(request_id) or self._done.get(request_id)
            return tr.trace_id if tr is not None else ""

    def traces(self, model: Optional[str] = None, limit: int = 50,
               include_active: bool = True) -> list[dict]:
        """Timelines newest-first: in-flight traces (status "active")
        ahead of finished ones."""
        with self._lock:
            rows = []
            if include_active:
                rows.extend(reversed(self._active.values()))
            rows.extend(reversed(self._done.values()))
            out = []
            for tr in rows:
                if model and tr.model != model:
                    continue
                out.append(tr.as_dict())
                if len(out) >= max(1, limit):
                    break
        return out

    def lookup(self, ident: str, limit: int = 50) -> list[dict]:
        """Every entry joined by ``ident``: a 32-hex trace id (matches
        all hops/processes' entries sharing it), a request id, a
        correlation id, or a full traceparent header (its trace id is
        extracted). Newest-first, active entries ahead of finished."""
        parsed = parse_traceparent(ident)
        if parsed is not None:
            ident = parsed[0]
        with self._lock:
            rows = list(reversed(self._active.values()))
            rows.extend(reversed(self._done.values()))
            out = []
            for tr in rows:
                if ident in (tr.trace_id, tr.request_id,
                             tr.correlation_id):
                    out.append(tr.as_dict())
                    if len(out) >= max(1, limit):
                        break
        return out


TRACER = TraceRecorder()


# --------------------------------------------------- fault-delivery joining
#
# utils/faultinject.py knows WHICH point fired but not WHOSE request was
# in flight; the layers know their requests but must not special-case
# injected faults (chaos tests assert real recovery paths). The bridge:
# a layer that is about to cross an instrumented point binds the request
# ids in scope (only when faults are armed — the disarmed hot path never
# touches this), and the observer below annotates those traces whenever
# a delivery actually happens.

_fault_tls = threading.local()


@contextmanager
def fault_scope(request_ids):
    """Bind the request ids a fault delivery should be attributed to,
    for the duration of the block. Re-entrant (inner scopes shadow)."""
    prev = getattr(_fault_tls, "ids", ())
    _fault_tls.ids = tuple(request_ids)
    try:
        yield
    finally:
        _fault_tls.ids = prev


def _fault_observer(point: str, action: str) -> None:
    for rid in getattr(_fault_tls, "ids", ()):
        TRACER.annotate(rid, "fault", point=point, action=action)


faultinject.observe(_fault_observer)
