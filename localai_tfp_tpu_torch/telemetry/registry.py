"""Thread-safe, label-aware Prometheus registry (own copy of
localai_tfp_tpu/telemetry/registry.py).

The engine thread, the HTTP handler threads and the loader record
concurrently, so every mutation happens under a per-family lock.
Rendering follows the Prometheus text exposition format 0.0.4 —
HELP/TYPE per family, escaped label values, cumulative histogram
buckets with ``+Inf``/``_sum``/``_count`` — byte for byte as the JAX
package renders it.

Cardinality safety: each family takes a ``max_label_sets`` cap. Once a
family holds that many label sets, NEW label combinations collapse into
an overflow label set (``overflow`` names which labels get replaced by
``"other"``; with no overflow spec every label collapses) — a
path-scanning client cannot grow the registry without bound.

``render(openmetrics=True)`` is the OpenMetrics exposition a scraper
negotiates with ``Accept: application/openmetrics-text``: counters'
HELP/TYPE lines drop ``_total``, histogram buckets carry the newest
exemplar observed in them (``# {trace_id="..."} value timestamp``, the
trace id that joins ``/debug/traces?id=``), and the text ends with
``# EOF``.

Not ported: the fleet path's wholesale histogram ``load``, gauge
``inc``/``dec`` and the bench's ``snapshot``/``delta`` (nothing of the
port uses them).
"""

from __future__ import annotations

import re
import threading
import time
from bisect import bisect_left
from typing import Optional, Sequence

# the exposition content type scrapers negotiate on
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# the OpenMetrics exposition (the one that carries exemplars)
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def escape_label_value(v: str) -> str:
    """Escape per the exposition format: backslash, double-quote and
    newline (a model name like ``he"llo\\nworld`` must not corrupt the
    series line)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Family:
    """One metric family: name + help + label schema + children."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (), *,
                 max_label_sets: int = 64,
                 overflow: Optional[dict] = None) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_label_sets = max(1, max_label_sets)
        self._overflow = dict(overflow or {})
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}  # guarded by self._lock

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        """Child for this label set (created on first use; collapses to
        the overflow set once ``max_label_sets`` is reached)."""
        key = tuple(str(labelvalues.get(ln, "")) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_label_sets:
                    key = tuple(
                        self._overflow.get(ln, key[i])
                        if self._overflow else "other"
                        for i, ln in enumerate(self.labelnames)
                    )
                    child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
            return child

    # label-less convenience: family IS the single child
    def _solo(self):
        return self.labels()

    def _label_str(self, key: tuple) -> str:
        if not self.labelnames:
            return ""
        inner = ",".join(
            f'{ln}="{escape_label_value(v)}"'
            for ln, v in zip(self.labelnames, key)
        )
        return "{" + inner + "}"

    def collect(self) -> list[tuple[tuple, dict]]:
        """(label key, value snapshot) pairs, taken under the lock."""
        with self._lock:
            return [(k, c.snapshot()) for k, c in  # type: ignore[attr-defined]
                    sorted(self._children.items())]

    def _om_name(self) -> str:
        """OpenMetrics family name: counters drop the ``_total`` suffix
        on HELP/TYPE lines (samples keep it)."""
        if self.kind == "counter" and self.name.endswith("_total"):
            return self.name[: -len("_total")]
        return self.name

    def render_into(self, lines: list[str],
                    openmetrics: bool = False) -> None:
        fam = self._om_name() if openmetrics else self.name
        lines.append(f"# HELP {fam} {_escape_help(self.help)}")
        lines.append(f"# TYPE {fam} {self.kind}")
        for key, snap in self.collect():
            self._render_child(lines, self._label_str(key), snap,
                               openmetrics)

    def _render_child(self, lines, label_str, snap,
                      openmetrics: bool = False) -> None:
        lines.append(f"{self.name}{label_str} {_fmt(snap['value'])}")


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock  # the family's lock, shared by all children
        self.value = 0.0  # guarded by self._lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"value": self.value}


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self.value = 0.0  # guarded by self._lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def set(self, v: float) -> None:
        self._solo().set(v)


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "exemplars")

    def __init__(self, lock: threading.Lock,
                 buckets: tuple[float, ...]) -> None:
        self._lock = lock
        self.buckets = buckets
        # raw per-bucket + overflow
        self.counts = [0] * (len(buckets) + 1)  # guarded by self._lock
        self.sum = 0.0  # guarded by self._lock
        # newest exemplar per raw bucket: idx -> (labels, value, ts)
        self.exemplars: dict[int, tuple] = {}  # guarded by self._lock

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        v = float(v)
        with self._lock:
            i = bisect_left(self.buckets, v)
            self.counts[i] += 1
            self.sum += v
            if exemplar:
                self.exemplars[i] = (dict(exemplar), v, time.time())

    def snapshot(self) -> dict:
        return {"counts": list(self.counts), "sum": self.sum,
                "buckets": self.buckets,
                "exemplars": dict(self.exemplars)}


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), *,
                 buckets: Sequence[float] = DEFAULT_BUCKETS, **kw) -> None:
        super().__init__(name, help, labelnames, **kw)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b

    def _new_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        self._solo().observe(v, exemplar)

    @staticmethod
    def _exemplar_str(ex: tuple) -> str:
        labels, value, ts = ex
        inner = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in labels.items())
        return f" # {{{inner}}} {_fmt(value)} {ts:.3f}"

    def _render_child(self, lines, label_str, snap,
                      openmetrics: bool = False) -> None:
        inner = label_str[1:-1]  # "" or 'a="b",c="d"'
        exemplars = snap.get("exemplars") or {} if openmetrics else {}

        def with_le(le: str) -> str:
            parts = ([inner] if inner else []) + [f'le="{le}"']
            return "{" + ",".join(parts) + "}"

        cum = 0
        for i, (bound, c) in enumerate(zip(snap["buckets"],
                                           snap["counts"])):
            cum += c
            line = f"{self.name}_bucket{with_le(_fmt(bound))} {cum}"
            if i in exemplars:
                line += self._exemplar_str(exemplars[i])
            lines.append(line)
        cum += snap["counts"][-1]
        line = f"{self.name}_bucket{with_le('+Inf')} {cum}"
        i = len(snap["buckets"])
        if i in exemplars:
            line += self._exemplar_str(exemplars[i])
        lines.append(line)
        lines.append(f"{self.name}_sum{label_str} {_fmt(snap['sum'])}")
        lines.append(f"{self.name}_count{label_str} {cum}")


class Registry:
    """Named family collection + renderer. One process-wide instance
    (``REGISTRY``) backs the server; tests build private ones."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}  # guarded by self._lock

    def _register(self, fam: _Family) -> _Family:
        with self._lock:
            if fam.name in self._families:
                raise ValueError(f"metric {fam.name!r} already registered")
            self._families[fam.name] = fam
        return fam

    def counter(self, name: str, help: str,
                labels: Sequence[str] = (), **kw) -> Counter:
        return self._register(Counter(name, help, labels, **kw))

    def gauge(self, name: str, help: str,
              labels: Sequence[str] = (), **kw) -> Gauge:
        return self._register(Gauge(name, help, labels, **kw))

    def histogram(self, name: str, help: str,
                  labels: Sequence[str] = (), **kw) -> Histogram:
        return self._register(Histogram(name, help, labels, **kw))

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def render(self, openmetrics: bool = False) -> str:
        lines: list[str] = []
        for fam in self.families():
            fam.render_into(lines, openmetrics)
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()
