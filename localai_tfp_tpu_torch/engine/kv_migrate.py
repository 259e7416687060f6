"""Disaggregated prefill/decode serving: KV page migration between two
engines on one card (the port's copy of
localai_tfp_tpu/engine/kv_migrate.py).

Long prompts and steady decode streams want opposite engine tunings: a
prefill flood fills the dispatch window with large compute-bound chunks,
and every token a decode stream emits while one runs waits behind it. The
single-host form of disaggregated serving (DistServe, Splitwise) runs two
``LLMEngine`` instances in one process over one set of weights: a
prefill engine with few slots and a decode engine, joined by this
module's page migration.

The relay, per disaggregated request:

1. ``DisaggRouter.submit_many`` routes it: prompts of at least
   ``LOCALAI_DISAGG_MIN_PROMPT`` tokens (and, with
   ``LOCALAI_DISAGG_MIN_MS``, a predicted prefill that long) take the
   relay; the rest go straight to the decode engine.
2. A prefill PROBE (the same request with ``max_tokens=1``, id +
   ":prefill", the same trace) runs on the prefill engine. Its final
   chunk samples the first token with the request's own sampler row, as
   the single engine would, and the slot finishes there, so its pages
   hold exactly the prompt.
3. In the probe's ``_finish`` the prefill side's ``Migrator`` gathers the
   slot's pages on the engine's stream (before the release can recycle
   them) and records an event, and takes the slot's sampler row after
   that first sample: its tensors (penalty counts, history window,
   mirostat state) and its ``torch.Generator``'s state.
4. The router's pump thread collects the capture: a side stream waits on
   the event and copies the GATHERED tensor (never the arena) into
   pinned host memory, and the pump waits for it (pump time, never a
   scheduler's). The pages land in a content-addressed interchange
   (keyed by the sha1 of the token prefix through each page's end,
   refcounted), and the original request is resubmitted to the decode
   engine with the ``KVHandoff`` attached and its arrival time and
   deadline intact.
5. The decode engine's ``_admit`` calls ``Migrator.assign_migrated``: a
   side stream copies the pages into a device staging tensor, the
   engine's stream waits on its event and scatters them into the pages
   of a staging pseudo-slot (``n_slots + 4 + i``: the KV tier's are
   ``n_slots + 0..3``), the slot adopts them by reference
   (``PagePool.share``), its sampler row and generator state are set,
   and it wakes in DECODE with the probe's first token emitted again. A
   migrated request re-prefills no prompt token, and seeded sampling
   draws what the single engine would.

Failure degrades to a re-prefill on the decode engine: a capture or
adoption fault (``disagg.migrate`` / ``disagg.handoff``), pool pressure,
a plane mismatch. Deadlines hold per stage (queued, prefill, migrate,
decode); an overrun of the migrate stage ends the request from the
router with the stage named. Both pools stay ``leak_check``-clean: host
pages are refcounted in the bus, pool pages move only by
ensure/share/drop. Nothing here blocks either scheduler thread: every
``kv:migrate_*`` span is non-blocking.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..config import knobs
from ..models.staging import TransferWindow
from ..telemetry import metrics as tm
from ..telemetry.flightrec import FLIGHT, MIGRATE_TRACK
from ..telemetry.tracing import TRACER
from ..utils import faultinject
from .engine import GenRequest, LLMEngine, SlotState, StreamEvent
from .kv_tier import KVTierManager
from .tokenizer import StreamDecoder

log = logging.getLogger(__name__)

__all__ = ["DisaggRouter", "MigrationBus", "Migrator", "KVHandoff",
           "build_prefill_engine", "PREFILL_SUFFIX"]

# the probe's request id: the prefill engine serves "<rid>:prefill", the
# decode engine "<rid>", on one trace
PREFILL_SUFFIX = ":prefill"

# decode-side staging pseudo-slots: the KV tier's are n_slots + 0..3,
# migration's start above them, so the two never share a pool table
_STAGE_BASE = KVTierManager.N_STAGE
_N_STAGE = 2


def _page_key(tokens, end: int) -> bytes:
    """Content address of a page-aligned token prefix (the KV tier's
    scheme, kept apart so the bus binds to no tier)."""
    return hashlib.sha1(
        np.asarray(tokens[:end], np.int64).tobytes()).digest()


def _planes(cache) -> dict[str, torch.Tensor]:
    """The arena's planes by name (int8 pages add their scale planes)."""
    out = {"k": cache.k, "v": cache.v}
    if cache.quantized:
        out.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    return out


def _index(ids: list[int], device: torch.device) -> torch.Tensor:
    """Page ids as a long index on the device, from pinned memory on a
    card (no host wait)."""
    cuda = device.type == "cuda"
    t = torch.tensor(ids, dtype=torch.long, pin_memory=cuda)
    return t.to(device, non_blocking=True)


# the sampler row's per-slot tensors (the generators go as their state)
def _row_fields(state) -> list[str]:
    return [f.name for f in dataclasses.fields(state)
            if f.name != "generators"]


@dataclass
class _HostBlock:
    """One migrated page in the interchange: each plane's ``[L, P, F]``
    (scales ``[L, P]``) host view, refcounted (pages shared by several
    migrations in flight hold one copy)."""

    arrays: dict
    nbytes: int
    ref: int = 1
    key: Optional[bytes] = None


@dataclass
class _Capture:
    """A finished probe's state, published by the prefill side: the
    gathered pages on the device (``[npg, L, P, F]`` per plane) and the
    event after their gather; the sampler row after the first sample."""

    rid: str  # the BASE request id (probe suffix stripped)
    tokens: list
    n: int
    first_token: int
    gathered: dict
    event: Any
    row: dict  # field -> the slot's row (device)
    gen_state: torch.Tensor  # the slot's generator state (host)
    npg: int
    prefill_ms: float
    queued_ms: float
    t0: float  # gather enqueue time (the migrate_out span's start)


@dataclass
class KVHandoff:
    """The decode side's view of a migrated prompt: its host pages (refs
    held until release), the probe's first token, the sampler row and
    generator state, and the times the request accrued before its
    resubmit."""

    rid: str
    tokens: list
    n: int
    first_token: int
    hpids: list
    sampler_row: dict  # field -> host tensor
    gen_state: torch.Tensor
    nbytes: int
    npg: int
    prefill_ms: float
    queued_ms: float
    migrate_ms: float = 0.0
    t_resubmit: float = 0.0
    _bus: Any = field(default=None, repr=False)
    _released: bool = False

    def release(self) -> None:
        """Drop this handoff's page refs (idempotent). The engine calls
        it when the request dies queued (shed, cancel, deadline), so an
        adopted-never request strands no interchange memory."""
        if self._released or self._bus is None:
            return
        self._released = True
        self._bus._deref(self.hpids, self.npg)


class MigrationBus:
    """The prefill-to-decode interchange: captures in flight on one side,
    refcounted content-addressed host pages on the other. It holds only
    migrations in flight (a handoff's pages free at its release); keeping
    sessions warm across requests is the KV tier's job. Thread-safe;
    ``collect`` does the blocking host copy on the router's pump thread,
    never on an engine's scheduler thread."""

    def __init__(self, page: int, device: torch.device) -> None:
        self.P = page
        self.device = device
        self._cuda = device.type == "cuda"
        self._side = torch.cuda.Stream(device) if self._cuda else None
        self._cv = threading.Condition()
        self._want: set = set()  # guarded by self._cv
        self._caps: dict = {}  # guarded by self._cv
        self._failed: dict = {}  # guarded by self._cv
        self._blocks: dict = {}  # guarded by self._cv
        self._dedup: dict = {}  # guarded by self._cv
        self._next_id = 1  # guarded by self._cv
        self._bytes = 0  # guarded by self._cv
        self._closed = False  # guarded by self._cv
        self.counters = {
            "published": 0, "collected": 0, "failed": 0, "timeouts": 0,
            "dedup_pages": 0, "released_pages": 0,
            "d2h_bytes": 0, "d2h_ms": 0.0,  # the pages' device-timed copy
        }

    # ------------------------------------------------- prefill side

    def register(self, rid: str) -> None:
        with self._cv:
            self._want.add(rid)

    def registered(self, rid: str) -> bool:
        with self._cv:
            return rid in self._want

    def publish(self, cap: _Capture) -> None:
        with self._cv:
            wanted = cap.rid in self._want
            if wanted:
                self._caps[cap.rid] = cap
                self.counters["published"] += 1
            self._cv.notify_all()
        if not wanted:
            # the collector gave up (deadline, cancel): the gathered
            # pages are dropped unread
            log.debug("migration capture for %s arrived late", cap.rid)

    def fail(self, rid: str, why: str) -> None:
        with self._cv:
            if rid in self._want:
                self._failed[rid] = why
                self.counters["failed"] += 1
            self._cv.notify_all()

    # -------------------------------------------------- router side

    @torch.inference_mode()
    def _to_host(self, cap: _Capture) -> tuple[dict, dict]:
        """The capture's pages and sampler row in host memory (pinned on
        a card): a side stream waits on the gather's event and copies the
        gathered tensors; this (pump) thread waits for the copy."""
        if not self._cuda:
            return cap.gathered, {k: v.clone() for k, v in cap.row.items()}
        pages = {name: torch.empty(tuple(g.shape), dtype=g.dtype,
                                   pin_memory=True)
                 for name, g in cap.gathered.items()}
        row = {name: torch.empty(tuple(r.shape), dtype=r.dtype,
                                 pin_memory=True)
               for name, r in cap.row.items()}
        timed = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
        with torch.cuda.stream(self._side):
            self._side.wait_event(cap.event)
            timed[0].record(self._side)
            for name, g in cap.gathered.items():
                pages[name].copy_(g, non_blocking=True)
            timed[1].record(self._side)  # the pages' copy, timed alone
            for name, r in cap.row.items():
                row[name].copy_(r, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        done.synchronize()
        with self._cv:
            self.counters["d2h_bytes"] += sum(
                p.numel() * p.element_size() for p in pages.values())
            self.counters["d2h_ms"] += timed[0].elapsed_time(timed[1])
        return pages, row

    def collect(self, rid: str,
                timeout: float) -> tuple[Optional[KVHandoff], str]:
        """Wait for the probe's capture and move it into host pages.
        Returns (handoff, "") or (None, why)."""
        deadline = time.perf_counter() + max(0.0, timeout)
        with self._cv:
            while (rid not in self._caps and rid not in self._failed
                   and not self._closed):
                left = deadline - time.perf_counter()
                if left <= 0:
                    self._want.discard(rid)
                    self.counters["timeouts"] += 1
                    return None, "timeout"
                self._cv.wait(timeout=min(left, 0.5))
            if rid in self._failed:
                self._want.discard(rid)
                return None, self._failed.pop(rid)
            if self._closed:
                return None, "closed"
            cap = self._caps.pop(rid)
            self._want.discard(rid)
        # off the lock: the copy to host memory is this thread's wait
        hostside, row = self._to_host(cap)
        cap.gathered = {}  # the device copies may go now
        hpids: list = []
        nbytes = 0
        with self._cv:
            for i in range(cap.npg):
                end = (i + 1) * self.P
                key = _page_key(cap.tokens, end) if end <= cap.n else None
                hit = self._dedup.get(key) if key is not None else None
                if hit is not None:
                    self._blocks[hit].ref += 1
                    self.counters["dedup_pages"] += 1
                    hpids.append(hit)
                    continue
                arrays = {nm: a[i] for nm, a in hostside.items()}
                bn = sum(a.numel() * a.element_size()
                         for a in arrays.values())
                bid = self._next_id
                self._next_id += 1
                self._blocks[bid] = _HostBlock(arrays, bn, ref=1, key=key)
                if key is not None:
                    self._dedup[key] = bid
                self._bytes += bn
                nbytes += bn
                hpids.append(bid)
            self.counters["collected"] += 1
        FLIGHT.transfer("migrate_out", cap.t0, time.perf_counter() - cap.t0,
                        cap.npg, nbytes, track=MIGRATE_TRACK)
        return KVHandoff(
            rid=rid, tokens=cap.tokens, n=cap.n,
            first_token=cap.first_token, hpids=hpids, sampler_row=row,
            gen_state=cap.gen_state, nbytes=nbytes, npg=cap.npg,
            prefill_ms=cap.prefill_ms, queued_ms=cap.queued_ms,
            _bus=self), ""

    def forget(self, rid: str) -> None:
        with self._cv:
            self._want.discard(rid)
            self._caps.pop(rid, None)
            self._failed.pop(rid, None)

    # --------------------------------------------------- decode side

    def blocks(self, hpids: list) -> list:
        """A handoff's host pages in table order (its refs keep them)."""
        with self._cv:
            return [self._blocks[h] for h in hpids]

    def _deref(self, hpids: list, npg: int) -> None:
        with self._cv:
            for h in hpids:
                blk = self._blocks.get(h)
                if blk is None:
                    continue
                blk.ref -= 1
                if blk.ref <= 0:
                    del self._blocks[h]
                    if blk.key is not None and self._dedup.get(blk.key) == h:
                        del self._dedup[blk.key]
                    self._bytes -= blk.nbytes
            self.counters["released_pages"] += npg

    # ------------------------------------------------------ lifecycle

    def host_bytes(self) -> int:
        with self._cv:
            return self._bytes

    def live_blocks(self) -> int:
        with self._cv:
            return len(self._blocks)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class Migrator:
    """One engine's side of the protocol, attached as ``eng._migrator``
    by the router. The prefill side captures finishing probes into the
    bus (``on_finish``); the decode side stages and adopts handoffs at
    admission (``assign_migrated``). Both run on their engine's scheduler
    thread and only enqueue device work."""

    def __init__(self, eng, bus: MigrationBus, side: str) -> None:
        self.eng = eng
        self.bus = bus
        self.side = side
        self._cuda = eng.device.type == "cuda"
        self._side = (torch.cuda.Stream(eng.device)
                      if self._cuda and side == "decode" else None)
        self._stage_free = [eng.n_slots + _STAGE_BASE + i
                            for i in range(_N_STAGE)]
        # staged copies in flight: their staging tensors and host pages
        # stay referenced until the scatter's event completes
        self._win = TransferWindow(1 << 62)
        self.counters = {
            "captures": 0, "capture_skips": 0, "capture_faults": 0,
            "adoptions": 0, "adopt_faults": 0, "reused_tokens": 0,
            "h2d_bytes": 0, "h2d_ms": 0.0,
        }

    def tick(self) -> None:
        """Harvest staged copies that have landed (event polls only):
        their host pages and staging go, their ``kv:migrate_in`` span is
        recorded."""
        now = time.perf_counter()
        for tag in self._win.reap():
            self._landed(tag, now)

    def _landed(self, tag: tuple, now: float) -> None:
        t0, npg, nbytes, timed = tag
        FLIGHT.transfer("migrate_in", t0, now - t0, npg, nbytes,
                        track=MIGRATE_TRACK)
        if timed is not None:  # the side stream's copy, device-timed
            self.counters["h2d_bytes"] += nbytes
            self.counters["h2d_ms"] += timed[0].elapsed_time(timed[1])

    # ---------------------------------------------------- prefill side

    @torch.inference_mode()
    def on_finish(self, slot, reason: str) -> None:
        """Capture a finishing probe's pages onto the bus. Called from the
        prefill engine's ``_finish`` BEFORE the release: the gather is
        enqueued ahead of any later overwrite of these pages."""
        if self.side != "prefill":
            return
        req = slot.request
        rid = req.id
        if not rid.endswith(PREFILL_SUFFIX):
            return
        base = rid[: -len(PREFILL_SUFFIX)]
        if not self.bus.registered(base):
            return
        eng = self.eng
        n = slot.n_past
        npg = eng._pool.pages_for(n)
        if (reason != "length" or not slot.generated
                or req.soft_embeds is not None or n <= 0 or npg <= 0):
            self.counters["capture_skips"] += 1
            self.bus.fail(base, reason if reason != "length"
                          else "not_migratable")
            return
        try:
            if faultinject.ACTIVE:
                faultinject.fire("disagg.migrate")
        except faultinject.InjectedFault:
            # abandoned with no bus or pool change: the collect fails
            # fast and the request re-prefills on the decode engine
            self.counters["capture_faults"] += 1
            tm.ENGINE_KV_MIGRATED_PAGES.labels(
                model=eng._mlabel, outcome="fault").inc(npg)
            self.bus.fail(base, "fault")
            return
        table = eng._pool.table(slot.idx)[:npg]
        if len(table) < npg:
            self.counters["capture_skips"] += 1
            self.bus.fail(base, "short_table")
            return
        t0 = time.perf_counter()
        tbl = _index(table, eng.device)
        gathered = {name: arena.transpose(0, 1).index_select(0, tbl)
                    for name, arena in _planes(eng.cache).items()}
        # the sampler row AFTER the probe's first sample: its generator
        # advanced, its penalty counts and history hold the prompt tail
        # and the first token; set into the decode engine's row, the
        # stream continues as the single engine's would
        st = eng.sampling
        row = {f: getattr(st, f)[slot.idx].clone() for f in _row_fields(st)}
        gen_state = st.generators[slot.idx].get_state()
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        queued = 0.0
        if req.t_submit:
            queued = max(0.0, (slot.t_start - req.t_submit) * 1e3)
        self.counters["captures"] += 1
        self.bus.publish(_Capture(
            rid=base, tokens=list(slot.cache_tokens), n=n,
            first_token=int(slot.generated[0]), gathered=gathered,
            event=event, row=row, gen_state=gen_state, npg=npg,
            prefill_ms=slot.t_prefill_ms, queued_ms=queued, t0=t0))

    # ----------------------------------------------------- decode side

    def _drop(self, h: KVHandoff) -> bool:
        tm.ENGINE_KV_MIGRATED_PAGES.labels(
            model=self.eng._mlabel, outcome="dropped").inc(h.npg)
        h.release()
        return False

    @torch.inference_mode()
    def _stage_in(self, blocks: list, pages: list[int], t0: float) -> int:
        """The host pages into arena ``pages``: on a card a side stream
        copies them into a device staging tensor, the engine's stream
        waits on its event and scatters in place (the captured graphs
        hold the arena's addresses); the copy's ``kv:migrate_in`` span
        is recorded when it has landed (``tick``). Returns the bytes."""
        eng = self.eng
        tbl = _index(pages, eng.device)
        planes = _planes(eng.cache)
        nbytes = 0
        if not self._cuda:
            for name, arena in planes.items():
                rows = torch.stack([b.arrays[name] for b in blocks], 1)
                arena.index_copy_(1, tbl, rows)
                nbytes += rows.numel() * rows.element_size()
            self._landed((t0, len(pages), nbytes, None), time.perf_counter())
            return nbytes
        timed = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
        with torch.cuda.stream(self._side):
            timed[0].record(self._side)
            staging = {}
            for name, arena in planes.items():
                st = torch.empty((len(blocks), arena.shape[0])
                                 + tuple(arena.shape[2:]),
                                 dtype=arena.dtype, device=eng.device)
                for j, b in enumerate(blocks):
                    st[j].copy_(b.arrays[name], non_blocking=True)
                staging[name] = st
                nbytes += st.numel() * st.element_size()
            landed = timed[1]
            landed.record(self._side)
        torch.cuda.current_stream(eng.device).wait_event(landed)
        for name, arena in planes.items():
            arena.index_copy_(1, tbl, staging[name].transpose(0, 1))
        done = torch.cuda.Event()
        done.record()
        self._win.add((t0, len(pages), nbytes, timed), nbytes, done,
                      (tbl, *staging.values(), *blocks))
        return nbytes

    def assign_migrated(self, slot, req: GenRequest, out) -> bool:
        """Stage a handoff's pages into ``slot`` and wake it in DECODE.
        Returns False (the handoff released; the caller re-prefills) on
        any staging failure: a fault, pool pressure, a plane mismatch. On
        success the slot holds the pages and the probe's first token has
        been emitted again."""
        h: KVHandoff = req.disagg
        eng = self.eng
        try:
            if faultinject.ACTIVE:
                faultinject.fire("disagg.handoff")
        except faultinject.InjectedFault:
            # abandoned with no pool or arena change: the caller admits
            # the request as a re-prefill
            self.counters["adopt_faults"] += 1
            return self._drop(h)
        if h.n <= 0 or h.n >= eng.max_seq or not self._stage_free:
            return self._drop(h)
        t0 = time.perf_counter()
        sid = self._stage_free.pop()
        # free slots' resident prefixes are reclaimed for the stage as for
        # a prefill (the admission counted them as room)
        if not eng._ensure_pages(sid, h.n, keep=slot):
            eng._pool.drop(sid)  # any partial allocation
            self._stage_free.append(sid)
            return self._drop(h)
        table = eng._pool.table(sid)
        npg = len(table)
        blocks = self.bus.blocks(h.hpids[:npg])
        if set(blocks[0].arrays) != set(_planes(eng.cache)):
            # the two engines' page types differ (a misconfigured cache
            # dtype): adopting would scatter the wrong planes
            eng._pool.drop(sid)
            self._stage_free.append(sid)
            return self._drop(h)
        nbytes = self._stage_in(blocks, table, t0)
        # the slot adopts the staged pages by REFERENCE; dropping the
        # stage leaves it their only owner, so its write frontier is
        # privately writable
        eng._pool.share(slot.idx, sid, npg)
        eng._pool.drop(sid)
        self._stage_free.append(sid)
        st = eng.sampling
        for f, v in h.sampler_row.items():
            getattr(st, f)[slot.idx].copy_(v, non_blocking=True)
        st.generators[slot.idx].set_state(h.gen_state)
        now = time.perf_counter()
        TRACER.event(req.id, "admit", t=now, model=eng._mlabel)
        TRACER.annotate(req.id, "migrate_adopt", t=now, pages=npg,
                        bytes=nbytes, reused_tokens=h.n)
        wait = max(0.0, now - (h.t_resubmit or req.t_submit or now))
        tm.ENGINE_QUEUE_WAIT.labels(model=eng._mlabel).observe(wait)
        eng._queue_waits.append(wait)
        slot.cache_loaded = None
        slot.stale_kv = False
        slot.request = req
        slot.out = out
        slot.state = SlotState.DECODE
        slot.n_past = h.n
        slot.n_prompt = len(req.prompt_ids)
        slot.cache_tokens = list(h.tokens[:h.n])
        slot.n_reused = h.n
        if eng._prefix_enabled:
            eng._prefix_index.set_tokens(slot.idx, slot.cache_tokens)
            eng._prefix_index.touch(slot.idx)
        slot.generated = []
        slot.decoder = StreamDecoder(eng.tokenizer)
        slot.pending_text = ""
        slot.emit_buf = []
        slot.emit_tok = None
        slot.t_start = now
        slot.t_first = slot.t_prefill_t0 = 0.0
        # a migrated request's prompt processing is the prefill engine's
        # time plus the migration; the decode engine did no prompt work
        slot.t_prefill_ms = h.prefill_ms + h.migrate_ms
        slot.t_decode_ms = 0.0
        slot.constraint_state = (req.constraint.initial_state()
                                 if req.constraint is not None else None)
        tm.ENGINE_KV_MIGRATED_PAGES.labels(
            model=eng._mlabel, outcome="migrated").inc(npg)
        self.counters["adoptions"] += 1
        self.counters["reused_tokens"] += h.n
        h.release()  # the staged copy holds its host pages until it lands
        # the probe's first token again, on the DECODE engine: TTFT
        # against the original arrival, and the EOS/stop/max_tokens
        # edges exactly as the single engine's first emit
        eng._emit_token(slot, h.first_token)
        return True


class DisaggRouter:
    """The front door of a disaggregated pair: each request goes to the
    decode engine directly (the local path) or through the prefill ->
    migrate -> decode relay. Whatever the worker calls on an engine and
    this class does not define is the decode engine's."""

    def __init__(self, prefill: LLMEngine, decode: LLMEngine) -> None:
        if decode._pager is not None or prefill._pager is not None:
            raise ValueError("a disaggregated pair shares one tree by "
                             "reference: build both engines with "
                             "weight_paging=False")
        self.prefill = prefill
        self.decode = decode
        self.bus = MigrationBus(prefill.page, decode.device)
        prefill._migrator = Migrator(prefill, self.bus, "prefill")
        decode._migrator = Migrator(decode, self.bus, "decode")
        # the prefill engine's active slots run prompts: an expiry there
        # is a prefill-stage overrun
        prefill._deadline_stage = "prefill"
        self.min_prompt = max(1, knobs.int_("LOCALAI_DISAGG_MIN_PROMPT"))
        self.min_ms = knobs.float_("LOCALAI_DISAGG_MIN_MS")
        self.migrate_deadline_s = max(
            0.1, knobs.float_("LOCALAI_DISAGG_MIGRATE_DEADLINE_S"))
        self._mlabel = decode._mlabel
        self._plock = threading.Lock()
        self._pumps: set = set()  # guarded by self._plock
        self._closed = False

    # ------------------------------------------------------- routing

    def _use_disagg(self, req: GenRequest) -> bool:
        if req.soft_embeds is not None or req.prompt_cache_path:
            return False  # the disk-cache path stays local
        if req.max_tokens <= 1:
            return False  # the probe would be the whole request
        n = len(req.prompt_ids)
        if n < self.min_prompt or n >= self.decode.max_seq:
            return False
        if self.min_ms > 0:
            cm = self.prefill._costmodel
            tok_ms = cm.prefill_token_ms() if cm is not None else None
            if tok_ms is not None and tok_ms * n < self.min_ms:
                return False  # predicted prefill too cheap to relay
        return True

    def submit(self, req: GenRequest) -> queue.SimpleQueue:
        return self.submit_many([req])[0]

    def submit_many(self, reqs: list[GenRequest]) -> list[queue.SimpleQueue]:
        outs: list = [None] * len(reqs)
        local_idx: list[int] = []
        for i, req in enumerate(reqs):
            if self._closed or not self._use_disagg(req):
                local_idx.append(i)
                continue
            out: queue.SimpleQueue = queue.SimpleQueue()
            outs[i] = out
            t = threading.Thread(target=self._pump, args=(req, out),
                                 daemon=True,
                                 name=f"disagg-pump-{req.id[:8]}")
            with self._plock:
                self._pumps.add(t)
            t.start()
        if local_idx:
            local_outs = self.decode.submit_many(
                [reqs[i] for i in local_idx])
            for i, out in zip(local_idx, local_outs):
                outs[i] = out
                tm.ENGINE_DISAGG_REQUESTS.labels(
                    model=self._mlabel, path="local").inc()
        return outs

    def generate(self, req: GenRequest) -> StreamEvent:
        q = self.submit(req)
        while True:
            ev = q.get()
            if ev.done:
                return ev

    def cancel(self, request_id: str) -> None:
        self.decode.cancel(request_id)
        self.prefill.cancel(request_id + PREFILL_SUFFIX)

    def pumps(self) -> int:
        """Relays in flight."""
        with self._plock:
            return len(self._pumps)

    # --------------------------------------------------------- relay

    def _terminal(self, rid: str, out, outcome: str, stage: str,
                  error: str) -> None:
        """End a request from the router (neither engine owns it)."""
        out.put(StreamEvent(done=True, finish_reason=outcome, error=error))
        tm.ENGINE_REQUESTS.labels(model=self._mlabel, reason=outcome).inc()
        TRACER.event(rid, "done")
        TRACER.annotate(rid, "terminal", outcome=outcome, stage=stage)
        TRACER.finish(rid, status=outcome)

    def _pump(self, req: GenRequest, out: queue.SimpleQueue) -> None:
        """One relay: the prefill probe, the migration's collect, the
        resubmit to the decode engine (the client's stream rides along).
        Exactly one terminal event reaches ``out`` on every path."""
        rid = req.id
        owned = True  # until the decode engine owns the client stream
        try:
            now0 = time.perf_counter()
            req.t_submit = now0
            budget = req.timeout_s or self.decode._default_deadline_s
            if budget > 0:
                req.deadline = now0 + budget
            TRACER.event(rid, "queue", t=now0, model=self._mlabel)
            if not req.trace_id:
                req.trace_id = TRACER.trace_id_of(rid)
            TRACER.annotate(rid, "disagg", t=now0,
                            prompt_tokens=len(req.prompt_ids))
            self.bus.register(rid)
            probe = dataclasses.replace(
                req, id=rid + PREFILL_SUFFIX, max_tokens=1, disagg=None,
                prompt_cache_path="", prompt_cache_all=False, t_submit=0.0,
                deadline=0.0, timeout_s=(max(0.05, req.deadline - now0)
                                         if req.deadline else 0.0))
            # the probe rides the same trace: one trace covers queue,
            # prefill, migrate and decode
            TRACER.start(probe.id, model=self._mlabel,
                         trace_id=req.trace_id)
            probe_q = self.prefill.submit(probe)
            term: Optional[StreamEvent] = None
            buffered: list[StreamEvent] = []
            while term is None:
                ev = probe_q.get()
                if ev.done:
                    term = ev
                else:
                    buffered.append(ev)
            migratable = (term.finish_reason == "length"
                          and term.completion_tokens == 1
                          and not term.error)
            if not migratable:
                if term.finish_reason in ("error", "shed"):
                    # the decode engine may still serve it the plain way
                    owned = self._fallback(req, out)
                    return
                # the request ended at its first token (stop, EOS, the
                # context's end, its deadline, a cancel): the probe's
                # stream is the answer
                for ev in buffered:
                    out.put(ev)
                out.put(term)
                owned = False
                tm.ENGINE_DISAGG_REQUESTS.labels(
                    model=self._mlabel, path="disagg").inc()
                TRACER.event(rid, "done")
                TRACER.annotate(rid, "terminal", outcome=term.finish_reason,
                                stage="prefill")
                TRACER.finish(rid, status=term.finish_reason)
                return
            tm.ENGINE_DISAGG_STAGE.labels(
                model=self._mlabel, stage="queued").observe(
                max(0.0, term.timing_queue_ms) / 1e3)
            tm.ENGINE_DISAGG_STAGE.labels(
                model=self._mlabel, stage="prefill").observe(
                max(0.0, term.timing_prompt_processing_ms) / 1e3)
            nowm = time.perf_counter()
            tmo = self.migrate_deadline_s
            if req.deadline:
                tmo = min(tmo, max(0.0, req.deadline - nowm))
            h, why = self.bus.collect(rid, timeout=tmo)
            nowr = time.perf_counter()
            mig_ms = (nowr - nowm) * 1e3
            if h is not None:
                TRACER.annotate(rid, "migrate", t=nowr, bytes=h.nbytes,
                                pages=h.npg, ms=round(mig_ms, 3))
            else:
                TRACER.annotate(rid, "migrate", t=nowr,
                                failed=why or "unknown", ms=round(mig_ms, 3))
            if h is None and req.deadline and nowr >= req.deadline:
                # the migrate stage overran the deadline: the terminal is
                # the router's, with the stage named
                owned = False
                tm.ENGINE_DEADLINE_EXCEEDED.labels(
                    model=self._mlabel, stage="migrate").inc()
                tm.ENGINE_DISAGG_REQUESTS.labels(
                    model=self._mlabel, path="fallback").inc()
                self._terminal(rid, out, "deadline_exceeded", "migrate",
                               "deadline exceeded during KV migration")
                return
            if h is None:
                owned = self._fallback(req, out)
                return
            h.migrate_ms = mig_ms
            h.t_resubmit = nowr
            tm.ENGINE_KV_MIGRATION.labels(model=self._mlabel).observe(
                mig_ms / 1e3)
            tm.ENGINE_DISAGG_STAGE.labels(
                model=self._mlabel, stage="migrate").observe(mig_ms / 1e3)
            req.disagg = h
            self.decode.submit_many([req], outs=[out])
            owned = False
            tm.ENGINE_DISAGG_REQUESTS.labels(
                model=self._mlabel, path="disagg").inc()
        except Exception:
            log.exception("disagg relay for %s failed", rid)
            if owned:
                owned = False
                self._terminal(rid, out, "error", "relay",
                               "disaggregated relay failed")
        finally:
            self.bus.forget(rid)
            with self._plock:
                self._pumps.discard(threading.current_thread())

    def _fallback(self, req: GenRequest, out) -> bool:
        """Re-prefill the request on the decode engine (the migration
        failed or was never viable). Returns the new ``owned`` flag."""
        req.disagg = None
        tm.ENGINE_DISAGG_REQUESTS.labels(
            model=self._mlabel, path="fallback").inc()
        self.decode.submit_many([req], outs=[out])
        return False

    # ----------------------------------------------------- lifecycle

    @property
    def params(self):
        return self.decode.params

    def update_params(self, fn: Any) -> Any:
        """A weight update (LoRA) lands on both engines: they share the
        tree, so ``fn`` runs once, on the decode engine; the prefill
        engine then drops its resident prefixes of the old weights too."""
        out = self.decode.update_params(fn)
        self.prefill.update_params(lambda params: None)
        return out

    def start(self) -> None:
        self.prefill.start()
        self.decode.start()

    def warmup(self) -> None:
        self.decode.warmup()
        self.prefill.warmup()

    def leak_check(self) -> None:
        """Both pools', and no interchange page outlives its relay."""
        self.decode.leak_check()
        self.prefill.leak_check()
        if not self.pumps() and self.bus.live_blocks():
            raise AssertionError(f"the interchange holds "
                                 f"{self.bus.live_blocks()} pages with no "
                                 "relay in flight")

    def close(self) -> None:
        self._closed = True
        self.bus.close()
        self.prefill.close()
        self.decode.close()

    def release(self) -> None:
        self.prefill.release()
        self.decode.release()

    def __getattr__(self, name: str):
        # everything else (tokenizer, embed, metrics, spec, max_seq, ...)
        # is the decode engine's
        return getattr(self.decode, name)


def build_prefill_engine(spec, params, tokenizer, *, decode: LLMEngine,
                         cache_dtype: Any = None, device: Any = None,
                         model: str = "") -> LLMEngine:
    """A prefill-tuned sibling of ``decode``: few slots
    (``LOCALAI_DISAGG_PREFILL_SLOTS``; a prefill flood is compute-bound),
    the same buckets and context, ``decode_steps=2`` (a probe decodes
    nothing past its first token), no KV tier (the bus is its
    interchange), no paging (it shares ``params`` by reference: one copy
    of the weights, both engines' graphs captured over the same tensors)
    and the same penalty window, so a captured sampler row fits the
    decode engine's state."""
    return LLMEngine(
        spec, params, tokenizer,
        n_slots=max(1, knobs.int_("LOCALAI_DISAGG_PREFILL_SLOTS")),
        max_seq=decode.max_seq,
        prefill_buckets=decode.prefill_buckets,
        cache_dtype=(cache_dtype if cache_dtype is not None
                     else decode.cache.k.dtype),
        penalty_window=decode.sampling.window,
        decode_steps=2,
        autostart=False,
        device=device if device is not None else decode.device,
        model=model or decode._mlabel + "-prefill",
        kv_tier=False,
        weight_paging=False)
