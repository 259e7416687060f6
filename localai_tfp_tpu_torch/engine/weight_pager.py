"""Layer-granular weight paging: device-hot weights, a host-RAM warm tier
(the port's copy of localai_tfp_tpu/engine/weight_pager.py).

A gallery deployment keeps many models registered but few in flight.
Every engine owns a :class:`WeightPager` that moves its parameter tree
between

- HOT: the tree on the device; the serving path is untouched;
- WARM: the tree mirrored in host RAM (int8 ``q`` planes and their f32
  scale planes both, so a round trip is bit-exact), its device memory
  given back. The engine, tokenizer, captured graphs and KV state all
  survive; only the weights left the card.

What differs from the JAX pager. XLA executables take the weights as
arguments, so the JAX pager drops the tree and installs a new one after
promotion. Here every dispatch is a CUDA-graph replay captured over the
weight tensors' addresses, so the tree lives in a fixed-address slab
(models/weight_slab.py): demotion unmaps the slab's memory, promotion maps
fresh memory at the same addresses and copies the weights back into the
same tensors. No graph is captured again.

- DEMOTION runs on its own thread, only while the engine is quiescent,
  and abandons itself the moment work arrives (``tick`` sets the abort
  flag from the scheduler's admission pass). It copies the layer pages
  (``models/hf_loader.layer_pages``: row ``li`` of every stacked leaf,
  plus one globals page) into a pinned host mirror on a side stream,
  through a ``TransferWindow`` of ``LOCALAI_WEIGHT_INFLIGHT_MB``. Only at
  the end, under the pager lock and after a last quiescence check, does
  it unmap the slab. When the mirror still matches the tree the
  demotion moves no device bytes ("seed"; an int8 artifact's mirror is
  pinned then, once, on the demotion's thread).
- PROMOTION maps the slab and streams the pages back host-to-device on a
  side stream, ``LOCALAI_WEIGHT_PREFETCH_AHEAD`` pages ahead of the
  commit cursor (a page commits when its copy's event completes; each is
  a non-blocking ``w:fetch`` span). It marks the tree hot, then wakes the
  engine's admission wait outside the pager lock.

While warm, ``eng.params`` is None and the slab is unmapped: every path
that reads weights goes through the gate first. The scheduler's
``_admit`` polls (``poll_admission``, never blocking); a granted poll
holds the gate until the wave's step ends (``end_admission``), since the
wave's requests are off the queue and not yet in a slot for part of that
time, and no demotion starts or lands while it is held; ``embed``,
``update_params`` (LoRA), ``warmup`` and the worker's ``status`` take
``use()``, which promotes and holds the tree hot while they run. (Engines
with a draft never page, so the speculative path needs no gate.)

Cross-engine policy lives in the process-global :data:`COORD`: every
pager registers weakly, and ``pressure()`` demotes least-recently-used
hot engines whenever hot bytes would exceed ``LOCALAI_WEIGHT_HBM_MB``.
The mirror is kept after promotion (and seeded by the int8 artifact's
``keep_host``), so a clean model's next demotion copies nothing off the
device.

Fault points (the JAX names, so one ``LOCALAI_FAULTS`` spec fires the
same sequence in both packages): ``weights.demote`` abandons a demotion
before any copy (the model stays hot); ``weights.fetch`` fails the
streamed promotion, which falls back to one blocking copy of the whole
mirror (outcome "cold").
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from collections import deque
from typing import Any, Optional

import torch

from ..config import knobs
from ..models.hf_loader import layer_pages
from ..models.quant import QTensor
from ..models.staging import TransferWindow
from ..models.weight_slab import WeightSlab
from ..telemetry import metrics as tm
from ..telemetry.flightrec import FLIGHT, WEIGHTS_TRACK
from ..utils import faultinject

log = logging.getLogger(__name__)

__all__ = ["WeightPager", "PagerCoordinator", "COORD"]


def _leaf_nbytes(leaf: Any) -> int:
    planes = tuple(leaf) if isinstance(leaf, QTensor) else (leaf,)
    return sum(t.numel() * t.element_size() for t in planes)


def _tree_nbytes(tree: Optional[dict]) -> int:
    if not tree:
        return 0
    return sum(_leaf_nbytes(v) for v in tree.values())


def _copy_rows(dst: dict, src: dict, non_blocking: bool) -> int:
    """Copy every leaf of ``src`` into the same key of ``dst`` (both
    planes of a QTensor); returns the bytes."""
    n = 0
    for k, s in src.items():
        d = dst[k]
        for dt, st in (zip(d, s) if isinstance(s, QTensor) else ((d, s),)):
            dt.copy_(st, non_blocking=non_blocking)
            n += st.numel() * st.element_size()
    return n


class PagerCoordinator:
    """Process-global LRU across every live pager.

    Holds WEAK references: a pager pins its engine's mirror, so the
    coordinator must never keep a closed engine's pager alive.
    ``pressure()`` reads ``LOCALAI_WEIGHT_HBM_MB`` at call time (0 =
    unlimited) and asks least-recently-used hot victims to demote until
    the hot set fits: demotion is asynchronous, so the budget is a target
    the fleet converges to, not an admission gate."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pagers: list = []  # weakrefs; guarded by self._lock
        self.counters = {"pressure_demotes": 0}

    def register(self, pager: "WeightPager") -> None:
        with self._lock:
            self._pagers.append(weakref.ref(pager))

    def unregister(self, pager: "WeightPager") -> None:
        with self._lock:
            self._pagers = [r for r in self._pagers
                            if r() is not None and r() is not pager]

    def _live(self) -> list:
        with self._lock:
            live = [p for p in (r() for r in self._pagers)
                    if p is not None and not p.closed]
            self._pagers = [weakref.ref(p) for p in live]
        return live

    def pressure(self, requester: Optional["WeightPager"] = None) -> int:
        """Demote LRU hot victims until hot bytes (plus the requester's
        incoming tree) fit the budget. Returns the victims asked."""
        budget = int(knobs.float_("LOCALAI_WEIGHT_HBM_MB") * (1 << 20))
        if budget <= 0:
            return 0
        live = self._live()
        need = requester.tree_bytes() if requester is not None else 0
        hot = [p for p in live if p.state == "hot" and p is not requester]
        total = need + sum(p.tree_bytes() for p in hot)
        asked = 0
        for victim in sorted(hot, key=lambda p: p.last_used):
            if total <= budget:
                break
            if victim.request_demote(reason="pressure"):
                total -= victim.tree_bytes()
                asked += 1
                with self._lock:
                    self.counters["pressure_demotes"] += 1
        self.update_residency()
        return asked

    def residency(self) -> dict:
        counts = {"hot": 0, "warm": 0, "transitioning": 0}
        for p in self._live():
            st = p.state
            counts["hot" if st == "hot" else
                   "warm" if st == "warm" else "transitioning"] += 1
        return counts

    def update_residency(self) -> None:
        for state, n in self.residency().items():
            tm.ENGINE_MODEL_RESIDENCY.labels(state=state).set(n)


COORD = PagerCoordinator()


class WeightPager:
    """Weight residency state machine for one engine.

    States: ``hot`` (slab mapped, ``eng.params`` the slab's views) ->
    ``demoting`` (background device-to-host copy) -> ``warm`` (host
    mirror only, slab unmapped, ``eng.params is None``) -> ``promoting``
    (page-streamed host-to-device copy) -> ``hot``. Every transition
    happens under ``self._plock``. The scheduler only calls ``tick``,
    ``poll_admission`` and ``end_admission``, which never wait on a
    transfer. ``self._plock`` is
    never held while taking ``eng._lock`` (the promote thread wakes the
    engine outside it); the scheduler never takes ``_plock`` while it
    holds ``eng._lock``."""

    def __init__(self, eng) -> None:
        self.eng = eng
        self._mlabel = eng._mlabel
        self.n_layers = int(eng.spec.n_layers)
        self.n_pages = self.n_layers + 1  # + the globals page
        self.ahead = max(1, knobs.int_("LOCALAI_WEIGHT_PREFETCH_AHEAD"))
        self._cuda = eng.device.type == "cuda"
        # the tree moves into the slab: the leaves of eng.params (the
        # dict the engine was given, which it owns) become views
        self.slab = WeightSlab(eng.params, eng.device)
        self._views: dict = eng.params  # the tree, hot or not
        self._side = torch.cuda.Stream(eng.device) if self._cuda else None
        self._plock = threading.RLock()
        self.state = "hot"  # guarded by self._plock
        self._host: Optional[dict] = None  # guarded by self._plock
        self._host_src: Optional[int] = None  # id() of the mirrored tree
        self._abort = False  # guarded by self._plock
        self._thread: Optional[threading.Thread] = None
        self._cursor = 0  # committed pages while promoting
        self._readers = 0  # use() holds; guarded by self._plock
        # the scheduler's wave from a granted poll_admission to the end of
        # its step (its requests are off the queue and not yet in a slot
        # for part of it); guarded by self._plock
        self._admitting = False
        self._device_bytes = _tree_nbytes(eng.params)
        self._hot_event = threading.Event()
        self._hot_event.set()
        self.last_used = time.monotonic()
        self.closed = False
        self.counters = {
            "demotes": 0, "promotes": 0, "seed_demotes": 0,
            "cold_fallbacks": 0, "aborted_demotes": 0,
            "faulted_demotes": 0, "faulted_fetches": 0,
        }
        # the last transitions' host-clock seconds and bytes (stats)
        self.timings: dict = {}
        COORD.register(self)
        # a model arriving hot is itself pressure: the fleet's LRU
        # members yield before this engine's first step
        COORD.pressure(self)
        COORD.update_residency()

    # ------------------------------------------------------ scheduler API

    def tick(self) -> None:
        """Scheduler hook (top of the admission pass): work arriving while
        a demotion is in flight aborts it. Never blocks."""
        with self._plock:
            if self.state == "demoting" and self.eng._has_work():
                self._abort = True

    def poll_admission(self) -> bool:
        """May the scheduler admit work now? Hot: yes (and the touch
        feeds the LRU), and the scheduler holds the gate until
        ``end_admission``: no demotion starts or lands meanwhile. Warm:
        start a promotion and say no; the caller requeues and waits on
        the engine's condition, which the promotion notifies.
        Transitioning: no."""
        self.last_used = time.monotonic()
        with self._plock:
            if self.state == "hot":
                self._admitting = True
                return True
            if self.state == "warm":
                self._start_promote_locked()
            return False

    def end_admission(self) -> None:
        """The admitted wave has run its step: from here the engine's own
        work (``_has_work``) keeps demotion off. Never blocks."""
        with self._plock:
            self._admitting = False

    @contextlib.contextmanager
    def use(self, timeout_s: float = 60.0):
        """Hold the tree hot for a caller off the scheduler thread (embed,
        a weight update, warmup, status): promotes it when warm, aborts a
        demotion in flight, and keeps any new demotion from unmapping the
        slab until the block ends. Raises when hot is not reached."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._plock:
                if self.state == "hot" and not self.closed:
                    self._readers += 1
                    break
            if time.monotonic() >= deadline or self.closed \
                    or not self.ensure_hot(deadline - time.monotonic()):
                raise RuntimeError(
                    f"{self._mlabel}: weights not on the device (state "
                    f"{self.state}); the promotion did not finish in "
                    f"{timeout_s:g} s")
        self.last_used = time.monotonic()
        try:
            yield self._views
        finally:
            with self._plock:
                self._readers -= 1

    # --------------------------------------------------------- demotion

    def request_demote(self, reason: str = "explicit") -> bool:
        """Begin an asynchronous demotion (hot, quiescent engines only).
        Returns whether a demote thread was started."""
        with self._plock:
            if (self.closed or self.state != "hot" or self._readers
                    or self._admitting):
                return False
            if self.eng._has_work():
                return False
            self.state = "demoting"
            self._abort = False
            self._hot_event.clear()
            t = threading.Thread(target=self._demote, daemon=True,
                                 name="weights-demote")
            self._thread = t
        log.info("weight demotion (%s): %s", reason, self._mlabel)
        t.start()
        COORD.update_residency()
        return True

    def _abandon_demote(self, outcome: str) -> None:
        with self._plock:
            self.state = "hot"
            self._hot_event.set()
        self.counters["aborted_demotes" if outcome == "aborted"
                      else "faulted_demotes"] += 1
        tm.ENGINE_WEIGHT_PAGE_MOVES.labels(
            model=self._mlabel, direction="demote", outcome=outcome).inc()
        COORD.update_residency()
        self._wake()

    def _wake(self) -> None:
        """Wake the scheduler's admission wait: the tree is hot again.
        Called OUTSIDE the pager lock."""
        with self.eng._lock:
            self.eng._lock.notify_all()

    def _new_mirror(self) -> dict:
        """Host tensors shaped as the tree (pinned on a card)."""

        def host(t: torch.Tensor) -> torch.Tensor:
            return torch.empty(tuple(t.shape), dtype=t.dtype,
                               pin_memory=self._cuda)

        return {k: (QTensor(host(v.q), host(v.scale))
                    if isinstance(v, QTensor) else host(v))
                for k, v in self._views.items()}

    def _pinned_copy(self, host: dict) -> Optional[dict]:
        """``host`` copied into pinned memory leaf by leaf; None when work
        arrived meanwhile."""
        out = {}
        for k, v in host.items():
            with self._plock:
                if self._abort:
                    return None
            out[k] = (QTensor(v.q.pin_memory(), v.scale.pin_memory())
                      if isinstance(v, QTensor) else v.pin_memory())
        return out

    @torch.inference_mode()
    def _copy_out(self, host: dict) -> Optional[int]:
        """Copy the tree's pages into ``host``, device to host, on the side
        stream through the in-flight window; returns the bytes, or None
        when work arrived (the copies land on their own)."""
        window = TransferWindow(int(
            knobs.float_("LOCALAI_WEIGHT_INFLIGHT_MB") * (1 << 20)))
        _, dglob, dpage = layer_pages(self._views, self.n_layers)
        _, hglob, hpage = layer_pages(host, self.n_layers)
        pages = [(dpage(li), hpage(li)) for li in range(self.n_layers)]
        pages.append((dglob, hglob))
        total = 0
        if self._cuda:
            self._side.wait_stream(torch.cuda.current_stream(self.eng.device))
        for dev_rows, host_rows in pages:
            with self._plock:
                if self._abort:
                    return None
            nbytes = _tree_nbytes(dev_rows)
            if window.over(nbytes):
                window.drain(nbytes)
            if self._cuda:
                with torch.cuda.stream(self._side):
                    _copy_rows(host_rows, dev_rows, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self._side)
            else:
                _copy_rows(host_rows, dev_rows, non_blocking=False)
                ev = None
            window.add(None, nbytes, ev, (dev_rows, host_rows))
            total += nbytes
        window.flush()
        return total

    def _demote(self) -> None:
        """Background device-to-host page-out. Blocking waits are fine on
        this thread. The slab is unmapped only at the very end, under the
        pager lock, after a last quiescence check; any abandonment leaves
        the engine exactly hot."""
        eng = self.eng
        t_all = time.perf_counter()
        self.timings.pop("demote_copy_s", None)
        self.timings.pop("mirror_pin_s", None)
        if eng._has_work():
            self._abandon_demote("aborted")
            return
        try:
            if faultinject.ACTIVE:
                faultinject.fire("weights.demote")
        except faultinject.InjectedFault:
            # abandoned before any copy or bookkeeping: the model stays
            # hot and serves
            self._abandon_demote("fault")
            return
        with self._plock:
            seeded = (self._host is not None
                      and self._host_src == id(self._views))
            host = self._host if seeded else None
        outcome = "seed" if seeded else "ok"
        if seeded and self._cuda and not all(
                t.is_pinned() for v in host.values()
                for t in (tuple(v) if isinstance(v, QTensor) else (v,))):
            # an int8 artifact's planes are views of its file's mapping
            # (pageable memory): pinned once, here off the scheduler, so
            # every promotion streams from pinned memory. No device byte
            # moves
            t_pin = time.perf_counter()
            host = self._pinned_copy(host)
            if host is None:
                self._abandon_demote("aborted")
                return
            self.timings["mirror_pin_s"] = time.perf_counter() - t_pin
        if not seeded:
            t_alloc = time.perf_counter()
            host = self._new_mirror()  # pinning is most of a first demote
            t0 = time.perf_counter()
            self.timings["mirror_alloc_s"] = t0 - t_alloc
            nbytes = self._copy_out(host)
            if nbytes is None:
                self._abandon_demote("aborted")
                return
            copy_s = time.perf_counter() - t0
            self.timings.update(demote_copy_s=copy_s, demote_bytes=nbytes)
            FLIGHT.transfer("demote", t0, copy_s, self.n_pages, nbytes,
                            blocking=False, track=WEIGHTS_TRACK, prefix="w")
        with self._plock:
            # the mirror just paid for is valid either way: if work
            # arrived, the next demotion is a free seed drop
            self._host = host
            self._host_src = id(self._views)
            if (self._abort or eng._has_work() or self._readers
                    or self._admitting):
                self.state = "hot"
                self._hot_event.set()
                aborted = True
            else:
                self.slab.unmap()
                eng.params = None
                self._device_bytes = 0
                self.state = "warm"
                aborted = False
        if aborted:
            self.counters["aborted_demotes"] += 1
            tm.ENGINE_WEIGHT_PAGE_MOVES.labels(
                model=self._mlabel, direction="demote",
                outcome="aborted").inc()
            self._wake()
        else:
            self.timings.update(demote_s=time.perf_counter() - t_all,
                                demote_outcome=outcome)
            self.counters["demotes"] += 1
            if seeded:
                self.counters["seed_demotes"] += 1
            tm.ENGINE_WEIGHT_PAGE_MOVES.labels(
                model=self._mlabel, direction="demote",
                outcome=outcome).inc(self.n_pages)
        COORD.update_residency()

    # -------------------------------------------------------- promotion

    def _start_promote_locked(self) -> None:
        # caller holds self._plock
        if self.state != "warm" or self._host is None or self.closed:
            return
        self.state = "promoting"
        self._cursor = 0
        t = threading.Thread(target=self._promote, daemon=True,
                             name="weights-promote")
        self._thread = t
        t.start()

    def ensure_hot(self, timeout_s: float = 60.0) -> bool:
        """Block (the caller's thread, never the scheduler's) until the
        tree is on the device: starts a promotion when warm, aborts a
        demotion in flight. Returns whether hot was reached."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._plock:
                if self.state == "hot":
                    return True
                if self.state == "warm":
                    self._start_promote_locked()
                elif self.state == "demoting":
                    self._abort = True
            if self._hot_event.wait(timeout=min(
                    0.1, max(0.0, deadline - time.monotonic()))):
                with self._plock:
                    if self.state == "hot":
                        return True
        return self.state == "hot"

    def _promote(self) -> None:
        """Map the slab and stream the pages back. Marks the tree hot
        itself: the engine is idle or waiting in its admission gate for
        exactly this."""
        eng = self.eng
        t_all = time.perf_counter()
        with self._plock:
            host = self._host
        if host is None:  # invalidated under us
            with self._plock:
                if self.state == "promoting":
                    self.state = "warm"
            return
        COORD.pressure(self)  # room before the bytes land
        try:
            t_map = time.perf_counter()
            self.slab.map()
            t_stream = time.perf_counter()
            self.timings["map_s"] = t_stream - t_map
            self._stream_in(host)
            self.timings["stream_s"] = time.perf_counter() - t_stream
            result = "warm"
        except faultinject.InjectedFault:
            # the streamed path failed: one plain blocking copy of the
            # whole mirror (no fault point on this leg: the request must
            # still be served)
            self.counters["faulted_fetches"] += 1
            self.counters["cold_fallbacks"] += 1
            tm.ENGINE_WEIGHT_PREFETCH.labels(
                model=self._mlabel, result="fault").inc()
            self._copy_all(host)
            result = "cold"
        except Exception:
            log.exception("weight promotion failed; the model stays warm")
            self.slab.unmap()
            with self._plock:
                if self.state == "promoting":
                    self.state = "warm"
            COORD.update_residency()
            return
        with self._plock:
            if self.state != "promoting":  # closed under us
                return
            eng.params = self._views
            self._device_bytes = _tree_nbytes(self._views)
            self._cursor = self.n_pages
            self.state = "hot"
            # the mirror still bit-matches the tree just built from it:
            # the next demotion is a zero-copy drop
            self._host_src = id(self._views)
            self._hot_event.set()
        self.counters["promotes"] += 1
        self.timings.update(promote_s=time.perf_counter() - t_all,
                            promote_bytes=self._device_bytes,
                            promote_result=result)
        tm.ENGINE_WEIGHT_PREFETCH.labels(
            model=self._mlabel, result=result).inc()
        tm.ENGINE_WEIGHT_PAGE_MOVES.labels(
            model=self._mlabel, direction="promote",
            outcome="ok").inc(self.n_pages)
        FLIGHT.transfer("promote", t_all, time.perf_counter() - t_all,
                        self.n_pages, self._device_bytes, blocking=False,
                        track=WEIGHTS_TRACK, prefix="w")
        COORD.update_residency()
        self._wake()

    @torch.inference_mode()
    def _copy_all(self, host: dict) -> None:
        """The cold fallback: every leaf in one blocking pass."""
        _copy_rows(self._views, host, non_blocking=False)
        if self._cuda:
            torch.cuda.synchronize(self.eng.device)

    @torch.inference_mode()
    def _stream_in(self, host: dict) -> None:
        """The streamed promotion: page ``li`` is enqueued on the side
        stream while up to ``ahead`` earlier pages are still in flight; a
        page commits (the cursor advances, a ``w:fetch`` span) when its
        event completes. Raises InjectedFault through to the fallback."""
        _, dglob, dpage = layer_pages(self._views, self.n_layers)
        _, hglob, hpage = layer_pages(host, self.n_layers)
        flight: deque = deque()  # (event, t0, nbytes)

        def commit() -> None:
            ev, t0, nbytes = flight.popleft()
            if ev is not None:
                ev.synchronize()
            with self._plock:
                self._cursor += 1
            FLIGHT.transfer("fetch", t0, time.perf_counter() - t0, 1,
                            nbytes, blocking=False, track=WEIGHTS_TRACK,
                            prefix="w")

        pages = [(dpage(li), hpage(li)) for li in range(self.n_layers)]
        pages.append((dglob, hglob))
        for dev_rows, host_rows in pages:
            if faultinject.ACTIVE:
                faultinject.fire("weights.fetch")
            t0 = time.perf_counter()
            if self._cuda:
                with torch.cuda.stream(self._side):
                    nbytes = _copy_rows(dev_rows, host_rows,
                                        non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self._side)
            else:
                nbytes = _copy_rows(dev_rows, host_rows, non_blocking=False)
                ev = None
            flight.append((ev, t0, nbytes))
            while len(flight) > self.ahead:
                commit()
        while flight:
            commit()

    # ------------------------------------------------------- host mirror

    def seed_host(self, host: dict, params_obj: Any) -> None:
        """Adopt a ready-made host mirror of ``params_obj`` (the int8
        artifact's ``keep_host`` capture): the model's first demotion
        copies nothing off the device. On a card it pins the mirror
        (the capture is views of the artifact's file mapping), on the
        demotion's thread, so the load pays nothing for it."""
        if not host:
            return
        with self._plock:
            self._host = dict(host)
            self._host_src = id(params_obj)

    def invalidate_host(self) -> None:
        """The tree was written in place (LoRA apply or remove): the
        mirror no longer matches, so the next demotion copies again."""
        with self._plock:
            self._host = None
            self._host_src = None
            if self.state in ("hot", "demoting"):
                self._device_bytes = _tree_nbytes(self._views)

    # ------------------------------------------------------ diagnostics

    def tree_bytes(self) -> int:
        """Bytes of the whole tree (hot or not)."""
        return self.slab.tree_bytes

    def device_bytes(self) -> int:
        """Ledger source of ``weights_hot``: the tree's bytes on the
        device now (the commit cursor's share while a promotion
        streams)."""
        with self._plock:
            if self.state in ("hot", "demoting"):
                return self._device_bytes
            if self.state == "promoting":
                return int(self.slab.tree_bytes * self._cursor
                           / max(1, self.n_pages))
            return 0

    def host_bytes(self) -> int:
        """Ledger source of ``weights_warm`` (host): bytes the mirror
        holds, also while it backs a hot tree."""
        with self._plock:
            return _tree_nbytes(self._host)

    def tier_pages(self) -> dict:
        """{"hot": pages, "warm": pages}: a promotion reports its
        committed cursor, so the hot count climbs page by page."""
        with self._plock:
            if self.state in ("hot", "demoting"):
                hot = self.n_pages
            elif self.state == "promoting":
                hot = self._cursor
            else:
                hot = 0
            warm = self.n_pages if self._host is not None else 0
        return {"hot": hot, "warm": warm}

    def stats(self) -> dict:
        with self._plock:
            return {
                "state": self.state,
                "pages": self.n_pages,
                "device_bytes": self.device_bytes(),
                "host_bytes": _tree_nbytes(self._host),
                "seeded": self._host is not None,
                "slab_bytes": self.slab.nbytes,
                "slab_mapped": self.slab.mapped,
                **self.counters,
                "timings": dict(self.timings),
            }

    def leak_check(self) -> None:
        """State-machine invariants; raises AssertionError."""
        with self._plock:
            st = self.state
            if st == "hot" and not self.closed:
                if self.eng.params is None:
                    raise AssertionError("hot pager with no device tree")
                if not self.slab.mapped:
                    raise AssertionError("hot pager with its slab unmapped")
            if st == "warm":
                if self.eng.params is not None:
                    raise AssertionError(
                        "warm pager but eng.params still set")
                if self._host is None:
                    raise AssertionError(
                        "warm pager with no host mirror (weights lost)")
                if self._device_bytes != 0 or self.slab.mapped:
                    raise AssertionError(
                        "warm pager still holding device memory")
            if self._host is not None and len(self._host) != len(
                    self._views):
                raise AssertionError(
                    "host mirror leaf count diverged from the tree")

    # -------------------------------------------------------- lifecycle

    def settle(self, timeout_s: float = 30.0) -> bool:
        """Wait for any transition in flight to land (tests and tools;
        the scheduler never calls it). Returns whether it settled."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._plock:
                t = self._thread
                if self.state in ("hot", "warm") and (
                        t is None or not t.is_alive()):
                    return True
            if t is not None:
                t.join(timeout=0.05)
            else:
                time.sleep(0.01)
        return False

    def close(self) -> None:
        """Engine teardown: abort anything in flight, wait for the worker
        thread, drop the mirror and deregister. The slab stays (its views
        may still be the engine's tree) until ``release``."""
        with self._plock:
            self.closed = True
            self._abort = True
            t = self._thread
        if t is not None:
            t.join(timeout=30.0)
        with self._plock:
            # a promotion that lost the race to close leaves "promoting"
            if self.state == "demoting":
                self.state = "hot"
            elif self.state == "promoting":
                self.state = "warm" if not self.slab.mapped else "hot"
            self._host = None
            self._host_src = None
            self._hot_event.set()
        COORD.unregister(self)
        COORD.update_residency()

    def release(self) -> None:
        """After ``close``: release the slab (memory and range)."""
        self.slab.release()
