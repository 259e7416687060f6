"""Tiered KV memory: device pages, pinned host pages, on-disk cold
sessions (the port's copy of localai_tfp_tpu/engine/kv_tier.py).

The paged pool (kv_pool.py) makes device memory scale with live tokens,
but a returning session (a chat user who steps away and comes back)
still costs either resident pages held idle or a full re-prefill. This
module adds two tiers under the arena:

- HOT: pages in the device arena, owned by ``PagePool``.
- WARM: pages spilled to host memory in the arena's dtype (int8 scale
  planes included). The host pages are slots carved from ONE host
  allocation of ``LOCALAI_KV_TIER_HOST_MB`` made with the tier (pinned on
  a card: a pageable copy is synchronous), never one per spill.
- COLD: whole sessions in the on-disk prompt-cache format (one
  ``np.savez`` of tokens and slot-contiguous rows), written and read by
  background threads; a request whose session is cold waits in the
  admission queue, bounded by ``LOCALAI_KV_TIER_FETCH_DEADLINE_S``, while
  the load runs, and re-prefills past the deadline.

Ordering on a card. The JAX tier relies on one in-order device stream;
a CUDA side stream gives no such order, so a spill is four steps:

1. the gather of the slot's pages (``arena[:, tbl]`` for k and v and, on
   int8 pages, their scale planes) is enqueued on the engine's stream,
   before the reclaim drops the table and before any later replay can
   overwrite a page;
2. an event is recorded after the gather;
3. a side stream waits on that event and copies the GATHERED tensor
   (never the arena) into the pinned host slots with ``non_blocking``;
4. the gathered tensor stays referenced in the spill's ``TransferWindow``
   entry until the copy's event has completed.

A promotion runs the other way: the host-to-device copy goes on the side
stream into a device staging tensor, the engine's stream waits on its
event and then scatters the staging into the arena's pages in place (the
captured graphs hold the arena's addresses), outside any capture.

Nothing here waits on the scheduler thread: no ``synchronize``, no
``.item()``, no ``.cpu()`` of a device tensor; harvest polls
``event.query()`` and every ``kv:*`` timeline span is non-blocking. On
the CPU the same code runs with synchronous copies whose handles are
ready at once.

Content addressing: a KV page holding positions [0, (i+1)*page) is a
pure function of the token prefix through the page end (causal
attention), so warm pages dedup by token-prefix hash: a prefix shared by
N sessions spills once, refcounted.

All tier state is mutated on the engine's scheduler thread; background
threads touch only their own file I/O and hand results back through
queues. ``LOCALAI_KV_TIER=off`` (or ``kv_tier=False``, or a loaded draft,
whose arena would miss the restored pages) leaves the engine without a
tier object.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..config import knobs
from ..models.staging import TransferWindow
from ..telemetry import metrics as tm
from ..telemetry.flightrec import FLIGHT
from ..utils import faultinject
from .kv_pool import PagePoolExhausted

__all__ = ["KVTierManager", "write_cache_file", "read_cache_file"]


# ------------------------------------------------------------ cold format
#
# One np.savez with tokens (int32 [n]) and slot-contiguous rows k/v
# ([L, n, F]; int8 adds k_scale/v_scale [L, n]). bf16 rows are widened to
# f32 (numpy has no portable bf16); the restore casts back. A file written
# by either package is readable through prompt_cache_path by the other.


def write_cache_file(path: str, tokens: np.ndarray, k: np.ndarray,
                     v: np.ndarray,
                     scales: Optional[tuple] = None) -> None:
    """Atomically persist one session in the prompt-cache format (host
    arrays: int8 and f32 rows are kept, any other float is widened to
    f32)."""

    def host(arr):
        out = np.asarray(arr)
        return out if out.dtype in (np.int8, np.float32) \
            else out.astype(np.float32)

    payload = {"tokens": np.asarray(tokens, np.int32),
               "k": host(k), "v": host(v)}
    if scales is not None:
        payload["k_scale"] = np.asarray(scales[0])
        payload["v_scale"] = np.asarray(scales[1])
    # unique temp name: concurrent saves to one path must not truncate
    # each other's half-written file before os.replace
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def read_cache_file(path: str):
    """Open a prompt-cache file (a lazy ``NpzFile`` mapping with keys
    tokens, k, v and, for int8 rows, k_scale, v_scale)."""
    return np.load(path)


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bf16 widened to f32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ------------------------------------------------------------ host store


class HostSlab:
    """One host allocation carved into page slots. A slot holds one page
    of every plane of the arena (``k``/``v`` ``[L, P, F]`` in the arena's
    dtype, ``k_scale``/``v_scale`` ``[L, P]`` f32 on int8 pages). Pinned
    on a card; a failed pinned allocation raises."""

    def __init__(self, planes: dict[str, torch.Tensor], nbytes: int,
                 pinned: bool) -> None:
        # (name, per-page shape, dtype, byte offset in a slot)
        self.layout = []
        off = 0
        for name, arena in planes.items():
            shape = (arena.shape[0],) + tuple(arena.shape[2:])
            size = int(np.prod(shape)) * arena.element_size()
            self.layout.append((name, shape, arena.dtype, off, size))
            off += size
        self.page_bytes = off
        self.n_pages = max(0, nbytes // off)
        self.buf = torch.empty((self.n_pages * off,), dtype=torch.uint8,
                               pin_memory=pinned)
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._views: dict[int, dict[str, torch.Tensor]] = {}

    def alloc(self, n: int) -> Optional[list[int]]:
        """n free slots, or None (nothing taken) when fewer are free."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, slots) -> None:
        self._free.extend(slots)

    def n_free(self) -> int:
        return len(self._free)

    def views(self, slot: int) -> dict[str, torch.Tensor]:
        """The slot's page, plane by plane (views of the slab)."""
        v = self._views.get(slot)
        if v is None:
            base = slot * self.page_bytes
            v = {name: self.buf.narrow(0, base + off, size)
                 .view(dtype).view(shape)
                 for name, shape, dtype, off, size in self.layout}
            self._views[slot] = v
        return v


@dataclass
class _HostPage:
    """One spilled KV page in a host slot, refcounted across entries
    (content-addressed pages shared by several sessions hold one
    copy)."""
    slot: int
    nbytes: int
    ref: int = 0
    key: Optional[bytes] = None  # content hash; full pages only


@dataclass
class _Entry:
    """One demoted session: an exact token prefix and the host (or
    disk) pages holding its KV."""
    eid: int
    tokens: list
    n: int
    hpids: list  # warm/saving; emptied when cold
    state: str  # warm | saving | cold | loading
    path: Optional[str] = None
    last_used: float = 0.0


@dataclass
class _Spill:
    slot_idx: int
    tokens: list
    n: int
    plan: list  # ("dup", hpid) | ("copy", j, key-or-None) per page
    copies: list  # device page ids gathered (unpin set)
    slots: list  # host slots the copies land in, by j
    nbytes: int
    t0: float
    urgent: bool
    pinned: bool
    epoch: int


@dataclass
class _Fetch:
    entry: _Entry
    stage: int  # pseudo-slot id holding the staged table
    n: int
    t0: float


class KVTierManager:
    """Demotion/promotion policy and bookkeeping for the three tiers.

    Owned by one paged engine; every public method runs on its scheduler
    thread (tests may call ``tick``/``settle`` only while the scheduler
    is quiescent). ``self._lock`` guards the host store for cross-thread
    readers (stats); background save/load threads post to
    ``_done_saves``/``_done_loads`` and the next ``tick`` applies."""

    # pseudo-slot ids for staged promotions (bounded: a fetch holds one)
    N_STAGE = 4
    # staged pages not adopted within this window are abandoned (the
    # request was cancelled or its admission stalled behind a full pool)
    STAGE_TTL_S = 5.0
    _SCAN_EVERY_S = 0.05  # demotion/eviction policy cadence

    def __init__(self, eng) -> None:
        self.eng = eng
        self.P = eng.page
        self._mlabel = eng._mlabel
        self.host_budget = int(
            knobs.float_("LOCALAI_KV_TIER_HOST_MB") * (1 << 20))
        self.watermark = min(1.0, max(0.05, knobs.float_(
            "LOCALAI_KV_TIER_WATERMARK")))
        self.idle_s = max(0.0, knobs.float_("LOCALAI_KV_TIER_IDLE_S"))
        self.cold_s = max(0.0, knobs.float_("LOCALAI_KV_TIER_COLD_S"))
        self.fetch_deadline_s = max(0.05, knobs.float_(
            "LOCALAI_KV_TIER_FETCH_DEADLINE_S"))
        self.cold_dir = knobs.str_("LOCALAI_KV_TIER_DIR")
        self.device = eng.device
        self._cuda = eng.device.type == "cuda"
        self.slab = HostSlab(self._planes(), self.host_budget,
                             pinned=self._cuda)
        self._side = torch.cuda.Stream(eng.device) if self._cuda else None
        self._lock = threading.Lock()
        self._host: dict[int, _HostPage] = {}  # guarded by self._lock
        self._dedup: dict[bytes, int] = {}  # guarded by self._lock
        self._entries: dict[int, _Entry] = {}  # guarded by self._lock
        self._host_bytes = 0
        self._disk_pages = 0
        self._next_id = 1
        # a weight change (LoRA) makes every held page stale
        self._epoch = 0
        # in-flight transfers (scheduler-thread-owned)
        self._swin = TransferWindow(int(
            knobs.float_("LOCALAI_KV_TIER_INFLIGHT_MB") * (1 << 20)))
        self._fwin = TransferWindow(1 << 62)  # tracking only, no cap
        self._spilling: set[int] = set()  # slot idxs with a spill aloft
        self._fetches: dict[str, _Fetch] = {}  # req.id -> staged fetch
        self._stage_free = [eng.n_slots + i for i in range(self.N_STAGE)]
        self._waiting: dict[str, float] = {}  # req.id -> cold deadline
        self._late: set[str] = set()  # deadline passed: re-prefill
        self._done_loads: queue.SimpleQueue = queue.SimpleQueue()
        self._done_saves: queue.SimpleQueue = queue.SimpleQueue()
        self._io_threads: list[threading.Thread] = []
        self._last_active: dict[int, float] = {}
        self._t_scan = 0.0
        self._t_born = time.perf_counter()
        self.counters = {
            "spills": 0, "spilled_pages": 0, "dedup_pages": 0,
            "fetches": 0, "reused_tokens": 0, "prefetch_hit": 0,
            "prefetch_late": 0, "prefetch_miss": 0,
            "prefetch_expired": 0, "saves": 0, "loads": 0,
            "spill_faults": 0, "fetch_faults": 0,
        }

    def _planes(self) -> dict[str, torch.Tensor]:
        c = self.eng.cache
        out = {"k": c.k, "v": c.v}
        if c.quantized:
            out.update(k_scale=c.k_scale, v_scale=c.v_scale)
        return out

    def _index(self, ids: list[int]) -> torch.Tensor:
        """Page ids as a long index on the device, copied from pinned
        memory without a host wait on a card."""
        t = torch.tensor(ids, dtype=torch.long, pin_memory=self._cuda)
        return t.to(self.device, non_blocking=True)

    # ------------------------------------------------------------- policy

    def tick(self) -> None:
        """One policy step on the scheduler's admission pass: harvest
        completed transfers, apply background-thread results, expire
        stale stages, and (rate-limited) run the demotion and eviction
        watermarks. Never waits on the device."""
        now = time.perf_counter()
        for sp in self._swin.reap():
            self._finalize_spill(sp, now)
        for npg, nbytes, t0 in self._fwin.reap():
            self._fetch_landed(npg, nbytes, t0, now)
        self._apply_io_results(now)
        self._expire_stages(now)
        if now - self._t_scan >= self._SCAN_EVERY_S:
            self._t_scan = now
            self._scan(now)

    def _fetch_landed(self, npg: int, nbytes: int, t0: float,
                      now: float) -> None:
        FLIGHT.transfer("fetch", t0, now - t0, npg, nbytes)
        tm.ENGINE_KV_TIER_MOVES.labels(
            model=self._mlabel, direction="fetch", outcome="ok").inc()
        tm.ENGINE_KV_TIER_BYTES.labels(
            model=self._mlabel, direction="fetch").inc(nbytes)

    def _scan(self, now: float) -> None:
        eng = self.eng
        for s in eng.slots:
            if s.active:
                self._last_active[s.idx] = now
        st = eng._pool.stats()
        if st.total and st.in_use / st.total >= self.watermark:
            cands = [
                s for s in eng.slots
                if not s.active and s.cache_tokens
                and s.idx not in self._spilling
                and eng._pool.held(s.idx)
                and now - self._last_active.get(s.idx, self._t_born)
                >= self.idle_s]
            mono = time.monotonic()
            cands.sort(key=lambda s: eng._prefix_index.value(s.idx, mono))
            for s in cands[:2]:
                self._spill(s, urgent=False, now=now)
        if self.cold_s and self.cold_dir:
            with self._lock:
                stale = [e for e in self._entries.values()
                         if e.state == "warm"
                         and now - e.last_used >= self.cold_s]
            for e in stale[:2]:
                self._start_save(e)
        evicted = 0
        while self._host_bytes > self.host_budget and evicted < 4:
            if not self._evict_one():
                break
            evicted += 1

    def _evict_one(self) -> bool:
        """Push the least-recently-used warm entry down a tier: save to
        disk when a cold dir is configured, discard otherwise."""
        with self._lock:
            warm = [e for e in self._entries.values()
                    if e.state == "warm"]
        if not warm:
            return False
        victim = min(warm, key=lambda e: e.last_used)
        if self.cold_dir:
            self._start_save(victim)
            # saving frees host pages only at completion; stop the
            # eviction sweep here rather than queue every warm entry
            return False
        self._drop_entry(victim)
        tm.ENGINE_KV_TIER_MOVES.labels(
            model=self._mlabel, direction="save",
            outcome="aborted").inc()
        return True

    # -------------------------------------------------------------- spill

    def capture(self, slot, req) -> None:
        """Demote-on-reuse: the slot is about to be reassigned, and
        ``_assign``'s prepare_write will discard every resident page
        beyond the new request's common prefix. The spill is enqueued
        first (its gather precedes any overwrite on the engine's
        stream), so slot churn moves sessions down a tier instead of
        erasing them."""
        common = _common_prefix(slot.cache_tokens, req.prompt_ids)
        if len(slot.cache_tokens) - common >= self.P:
            self._spill(slot, urgent=True, now=time.perf_counter())

    def demote_urgent(self, slot) -> bool:
        """Pool-pressure demotion: called by the engine's reclaim right
        before it drops the victim's table. Enqueues the gather and the
        copy and returns; the caller's drop proceeds regardless, so the
        allocator behaves exactly as a plain reclaim."""
        return self._spill(slot, urgent=True, now=time.perf_counter())

    def _spill(self, slot, urgent: bool, now: float) -> bool:
        eng = self.eng
        if slot.idx in self._spilling:
            return True  # the in-flight spill already covers this state
        if getattr(slot, "stale_kv", False):
            return False  # pages of weights no longer served
        tokens = list(slot.cache_tokens)
        n = min(len(tokens), eng.max_seq)
        if n < self.P:
            return False  # under one page: re-prefill is cheaper
        if self._covered(tokens, n):
            self._touch_covering(tokens, n, now)
            tm.ENGINE_KV_TIER_MOVES.labels(
                model=self._mlabel, direction="spill",
                outcome="dedup").inc()
            return True
        if not urgent and self._swin.over(1):
            return False  # in-flight spill budget full: retry next scan
        try:
            if faultinject.ACTIVE:
                faultinject.fire("kv_tier.spill")
        except faultinject.InjectedFault:
            # abandoned before any bookkeeping: an urgent demote's caller
            # drops the table as a plain reclaim (the session re-prefills
            # on return)
            self.counters["spill_faults"] += 1
            tm.ENGINE_KV_TIER_MOVES.labels(
                model=self._mlabel, direction="spill",
                outcome="fault").inc()
            return False
        npg = eng._pool.pages_for(n)
        table = eng._pool.table(slot.idx)[:npg]
        if len(table) < npg:
            return False  # table shorter than the token run: skip
        plan: list = []
        copies: list[int] = []
        with self._lock:
            for i in range(npg):
                end = (i + 1) * self.P
                key = self._page_key(tokens, end) if end <= n else None
                hpid = self._dedup.get(key) if key is not None else None
                if hpid is not None:
                    # hold the shared page for the in-flight spill so
                    # eviction cannot free it before finalize
                    self._host[hpid].ref += 1
                    plan.append(("dup", hpid))
                else:
                    plan.append(("copy", len(copies), key))
                    copies.append(table[i])
        slots = self._reserve(len(copies))
        if slots is None:
            with self._lock:
                for step in plan:
                    if step[0] == "dup":
                        self._deref_locked(step[1])
            tm.ENGINE_KV_TIER_MOVES.labels(
                model=self._mlabel, direction="spill",
                outcome="aborted").inc()
            return False  # host pages full even after eviction
        if not copies:
            # every page dedup'd: the entry materializes with no transfer
            sp = _Spill(slot.idx, tokens, n, plan, [], [], 0, now,
                        urgent, False, self._epoch)
            self._finalize_spill(sp, now)
            return True
        event, guards, nbytes = self._copy_out(copies, slots)
        pinned = not urgent
        if pinned:
            # background spill: the slot stays resident until the copy
            # lands; pin the gathered pages so a concurrent reclaim's
            # drop cannot recycle their ids under the bookkeeping
            eng._pool.pin(copies)
            self._spilling.add(slot.idx)
        sp = _Spill(slot.idx, tokens, n, plan, copies, slots, nbytes, now,
                    urgent, pinned, self._epoch)
        self._swin.add(sp, nbytes, event, guards)
        return True

    def _reserve(self, n: int) -> Optional[list[int]]:
        """n host slots, evicting least-recently-used warm entries when
        the slab is short (None when eviction cannot make room)."""
        slots = self.slab.alloc(n)
        while slots is None:
            with self._lock:
                warm = [e for e in self._entries.values()
                        if e.state == "warm"]
            if not warm:
                return None
            self._drop_entry(min(warm, key=lambda e: e.last_used))
            tm.ENGINE_KV_TIER_MOVES.labels(
                model=self._mlabel, direction="save",
                outcome="aborted").inc()
            slots = self.slab.alloc(n)
        return slots

    @torch.inference_mode()
    def _copy_out(self, pages: list[int], slots: list[int]
                  ) -> tuple[Any, tuple, int]:
        """Gather ``pages`` of every plane on the engine's stream, then
        copy the gathered pages into host ``slots``: on a card on the
        side stream after an event, non-blocking into pinned memory.
        Returns (the copy's completion event or None, the tensors it
        guards, bytes moved)."""
        tbl = self._index(pages)
        gathered = {name: arena.transpose(0, 1).index_select(0, tbl)
                    for name, arena in self._planes().items()}
        nbytes = sum(g.numel() * g.element_size() for g in gathered.values())
        views = [self.slab.views(s) for s in slots]
        if not self._cuda:
            for j, v in enumerate(views):
                for name, g in gathered.items():
                    v[name].copy_(g[j])
            return None, (), nbytes
        ev = torch.cuda.Event()
        ev.record()
        with torch.cuda.stream(self._side):
            self._side.wait_event(ev)
            for j, v in enumerate(views):
                for name, g in gathered.items():
                    v[name].copy_(g[j], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        return done, (tbl, *gathered.values()), nbytes

    def _finalize_spill(self, sp: _Spill, now: float) -> None:
        """Turn a landed spill into warm host pages and an entry. Runs at
        harvest, once the copy's event completed."""
        eng = self.eng
        stale = sp.epoch != self._epoch
        hpids: list[int] = []
        page_bytes = self.slab.page_bytes
        with self._lock:
            if stale:
                # the weights changed while the copy flew: its pages are
                # of the old model
                for step in sp.plan:
                    if step[0] == "dup" and step[1] in self._host:
                        self._deref_locked(step[1])
                self.slab.free(sp.slots)
            else:
                for step in sp.plan:
                    if step[0] == "dup":
                        hpids.append(step[1])  # ref already held at plan
                        self.counters["dedup_pages"] += 1
                        continue
                    _, j, key = step
                    hpid = self._next_id
                    self._next_id += 1
                    if key is not None and key in self._dedup:
                        key = None  # racing spill published it first
                    self._host[hpid] = _HostPage(sp.slots[j], page_bytes,
                                                 ref=1, key=key)
                    if key is not None:
                        self._dedup[key] = hpid
                    self._host_bytes += page_bytes
                    hpids.append(hpid)
                ent = _Entry(self._next_id, sp.tokens, sp.n, hpids,
                             "warm", last_used=now)
                self._next_id += 1
                self._entries[ent.eid] = ent
                # an older entry that is a strict prefix of this one is
                # subsumed (its pages live on via the dedup refs)
                for old in [e for e in self._entries.values()
                            if e is not ent and e.state == "warm"
                            and e.n <= sp.n
                            and e.tokens[:e.n] == sp.tokens[:e.n]]:
                    self._drop_entry_locked(old)
        if sp.pinned:
            eng._pool.unpin(sp.copies)
            self._spilling.discard(sp.slot_idx)
            slot = eng.slots[sp.slot_idx]
            if not stale and not slot.active \
                    and slot.cache_tokens == sp.tokens:
                # the demotion's point: the resident copy moves DOWN —
                # release the device pages now that host memory holds them
                eng._pool.drop(slot.idx)
                slot.cache_tokens = []
                slot.n_past = 0
                eng._prefix_index.remove(slot.idx)
        if stale:
            return
        self.counters["spills"] += 1
        self.counters["spilled_pages"] += len(sp.copies)
        if sp.copies:
            FLIGHT.transfer("spill", sp.t0, now - sp.t0,
                            len(sp.copies), sp.nbytes)
            tm.ENGINE_KV_TIER_BYTES.labels(
                model=self._mlabel, direction="spill").inc(sp.nbytes)
        tm.ENGINE_KV_TIER_MOVES.labels(
            model=self._mlabel, direction="spill", outcome="ok").inc()

    # -------------------------------------------------------- promotion

    def plan(self, req, now: float) -> bool:
        """Admission-time prefetch: when a tier entry covers the
        request's prompt, stage its pages back into the arena. Returns
        True when the request should requeue: its session is cold and
        the disk load is still inside the deadline window."""
        rid = req.id
        if rid in self._fetches or rid in self._late:
            return False
        ent, n = self._lookup(req.prompt_ids)
        if ent is None or not self._worth(req, n):
            return False
        if ent.state in ("warm", "saving"):
            self._stage(req, ent, n, now)
            return False
        # cold / loading: hold the request while the background load
        # runs, but never past the deadline (a slow disk degrades to a
        # re-prefill; it cannot stall admission)
        deadline = self._waiting.get(rid)
        if deadline is None:
            self._waiting[rid] = now + self.fetch_deadline_s
            if ent.state == "cold":
                self._start_load(ent)
            return True
        if now > deadline:
            self._waiting.pop(rid, None)
            self._late.add(rid)
            return False
        return True

    def adopt(self, slot, req) -> int:
        """Attach a staged fetch to the slot the request was assigned:
        the stage table is shared in by reference and the slot's resident
        prefix becomes the promoted session, so ``_assign``'s prefix
        reuse skips the covered tokens. Returns the promoted tokens (0 =
        re-prefill)."""
        now = time.perf_counter()
        rid = req.id
        self._waiting.pop(rid, None)
        f = self._fetches.pop(rid, None)
        if f is None and rid not in self._late:
            ent, n = self._lookup(req.prompt_ids)
            if ent is not None and ent.state in ("warm", "saving") \
                    and self._worth(req, n):
                # not planned ahead: stage now (the scatter is enqueued
                # before the prefill that follows it on the stream)
                if self._stage(req, ent, n, now):
                    f = self._fetches.pop(rid, None)
        if f is None:
            result = "late" if rid in self._late else "miss"
            self._late.discard(rid)
            self.counters["prefetch_" + result] += 1
            tm.ENGINE_KV_TIER_PREFETCH.labels(
                model=self._mlabel, result=result).inc()
            return 0
        eng = self.eng
        if _common_prefix(slot.cache_tokens, req.prompt_ids) >= f.n:
            # the assigned slot already holds a better resident prefix;
            # the staged copy is redundant
            self._abandon_fetch(rid, f)
            return 0
        npg = eng._pool.held(f.stage)
        eng._pool.share(slot.idx, f.stage, npg)
        eng._pool.drop(f.stage)
        self._stage_free.append(f.stage)
        slot.cache_tokens = list(f.entry.tokens[:f.n])
        slot.n_past = f.n
        if eng._prefix_enabled:
            eng._prefix_index.set_tokens(slot.idx, slot.cache_tokens)
        f.entry.last_used = now
        self.counters["prefetch_hit"] += 1
        self.counters["reused_tokens"] += f.n
        tm.ENGINE_KV_TIER_PREFETCH.labels(
            model=self._mlabel, result="hit").inc()
        return f.n

    def _stage(self, req, ent: _Entry, n: int, now: float) -> bool:
        eng = self.eng
        try:
            if faultinject.ACTIVE:
                faultinject.fire("kv_tier.fetch")
        except faultinject.InjectedFault:
            # promotion abandoned with no pool or arena change: the
            # request admits normally and re-prefills (the warm entry
            # survives for the next attempt)
            self.counters["fetch_faults"] += 1
            self._late.add(req.id)
            tm.ENGINE_KV_TIER_MOVES.labels(
                model=self._mlabel, direction="fetch",
                outcome="fault").inc()
            return False
        if not self._stage_free:
            return False
        sid = self._stage_free.pop()
        try:
            eng._pool.ensure(sid, n)
        except PagePoolExhausted:
            eng._pool.drop(sid)  # release any partial allocation
            self._stage_free.append(sid)
            return False
        table = eng._pool.table(sid)
        with self._lock:
            slots = [self._host[h].slot for h in ent.hpids[:len(table)]]
        event, guards, nbytes = self._copy_in(slots, table)
        self._fwin.add((len(table), nbytes, now), nbytes, event, guards)
        self._fetches[req.id] = _Fetch(ent, sid, n, now)
        self.counters["fetches"] += 1
        ent.last_used = now
        return True

    @torch.inference_mode()
    def _copy_in(self, slots: list[int], pages: list[int]
                 ) -> tuple[Any, tuple, int]:
        """Host ``slots`` into arena ``pages``: on a card the copies go
        into a device staging tensor on the side stream, the engine's
        stream waits on their event and scatters the staging into the
        arena in place. Returns (an event after the scatter or None, the
        tensors it guards, bytes moved)."""
        views = [self.slab.views(s) for s in slots]
        planes = self._planes()
        tbl = self._index(pages)
        if not self._cuda:
            nbytes = 0
            for name, arena in planes.items():
                rows = torch.stack([v[name] for v in views], 1)
                arena.index_copy_(1, tbl, rows)
                nbytes += rows.numel() * rows.element_size()
            return None, (), nbytes
        with torch.cuda.stream(self._side):
            staging = {}
            for name, arena in planes.items():
                st = torch.empty((len(views), arena.shape[0])
                                 + tuple(arena.shape[2:]),
                                 dtype=arena.dtype, device=self.device)
                for j, v in enumerate(views):
                    st[j].copy_(v[name], non_blocking=True)
                staging[name] = st
            landed = torch.cuda.Event()
            landed.record(self._side)
        torch.cuda.current_stream(self.device).wait_event(landed)
        for name, arena in planes.items():
            arena.index_copy_(1, tbl, staging[name].transpose(0, 1))
        done = torch.cuda.Event()
        done.record()
        nbytes = sum(t.numel() * t.element_size() for t in staging.values())
        return done, (tbl, *staging.values()), nbytes

    def _abandon_fetch(self, rid: str, f: _Fetch) -> None:
        self.eng._pool.drop(f.stage)
        self._stage_free.append(f.stage)
        self.counters["prefetch_expired"] += 1
        tm.ENGINE_KV_TIER_PREFETCH.labels(
            model=self._mlabel, result="expired").inc()

    def _expire_stages(self, now: float) -> None:
        for rid, f in list(self._fetches.items()):
            if now - f.t0 > self.STAGE_TTL_S:
                del self._fetches[rid]
                self._abandon_fetch(rid, f)

    def _worth(self, req, n: int) -> bool:
        if n < self.P:
            return False
        eng = self.eng
        have = max((_common_prefix(s.cache_tokens, req.prompt_ids)
                    for s in eng.slots if not s.active), default=0)
        if eng._prefix_enabled:
            have = max(have, eng._prefix_index.match(req.prompt_ids)[0])
        # a resident or copyable prefix at least as long makes the host
        # fetch redundant; require one full page of net gain
        return n >= have + self.P

    def _lookup(self, prompt_ids) -> tuple[Optional[_Entry], int]:
        best, best_n = None, 0
        with self._lock:
            for e in self._entries.values():
                n = min(_common_prefix(e.tokens, prompt_ids), e.n,
                        self.eng.max_seq - 1)
                if n > best_n:
                    best, best_n = e, n
        return best, best_n

    # ------------------------------------------------------- cold tier IO

    def _cold_path(self, ent: _Entry) -> str:
        h = hashlib.sha1(np.asarray(ent.tokens[:ent.n],
                                    np.int64).tobytes()).hexdigest()[:24]
        label = self._mlabel.replace(os.sep, "_")
        return os.path.join(self.cold_dir, f"kvtier-{label}-{h}.npz")

    def _start_save(self, ent: _Entry) -> None:
        """Warm -> cold: a background thread assembles the contiguous rows
        and writes the prompt-cache file; host pages are released when
        the tick applies the completion."""
        if ent.state != "warm":
            return
        ent.state = "saving"
        with self._lock:
            pages = [self.slab.views(self._host[h].slot) for h in ent.hpids]
        tokens = np.asarray(ent.tokens[:ent.n], np.int32)
        n, path, q = ent.n, self._cold_path(ent), self._done_saves

        def rows(name: str) -> np.ndarray:
            return _numpy(torch.cat([p[name] for p in pages], 1)[:, :n])

        def save():
            try:
                scales = None
                if "k_scale" in pages[0]:
                    scales = (rows("k_scale"), rows("v_scale"))
                write_cache_file(path, tokens, rows("k"), rows("v"), scales)
                q.put((ent.eid, path, None))
            except Exception as e:  # reported to the tick, never lost
                q.put((ent.eid, path, e))

        t = threading.Thread(target=save, daemon=True,
                             name="kv-tier-save")
        t.start()
        self._io_threads.append(t)

    def _start_load(self, ent: _Entry) -> None:
        if ent.state != "cold":
            return
        try:
            if faultinject.ACTIVE:
                faultinject.fire("kv_tier.fetch")
        except faultinject.InjectedFault:
            # the cold copy is unreachable this round: drop the entry so
            # waiting requests fall through to re-prefill at deadline
            self.counters["fetch_faults"] += 1
            tm.ENGINE_KV_TIER_MOVES.labels(
                model=self._mlabel, direction="load",
                outcome="fault").inc()
            self._drop_entry(ent)
            return
        ent.state = "loading"
        path, q = ent.path, self._done_loads

        def load():
            try:
                with read_cache_file(path) as data:
                    arrs = {nm: np.array(data[nm]) for nm in data.files}
                q.put((ent.eid, arrs, None))
            except Exception as e:  # reported to the tick, never lost
                q.put((ent.eid, None, e))

        t = threading.Thread(target=load, daemon=True,
                             name="kv-tier-load")
        t.start()
        self._io_threads.append(t)

    def _apply_io_results(self, now: float) -> None:
        while True:
            try:
                eid, path, err = self._done_saves.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                ent = self._entries.get(eid)
            if ent is None or ent.state != "saving":
                continue
            if err is not None:
                ent.state = "warm"  # host pages still held: no loss
                tm.ENGINE_KV_TIER_MOVES.labels(
                    model=self._mlabel, direction="save",
                    outcome="fault").inc()
                continue
            ent.state = "cold"
            ent.path = path
            with self._lock:
                for hpid in ent.hpids:
                    self._deref_locked(hpid)
                ent.hpids = []
            self._disk_pages += -(-ent.n // self.P)
            self.counters["saves"] += 1
            FLIGHT.transfer("save", now, 0.0, -(-ent.n // self.P),
                            self._entry_bytes(ent))
            tm.ENGINE_KV_TIER_MOVES.labels(
                model=self._mlabel, direction="save", outcome="ok").inc()
            tm.ENGINE_KV_TIER_BYTES.labels(
                model=self._mlabel, direction="save").inc(
                self._entry_bytes(ent))
        while True:
            try:
                eid, arrs, err = self._done_loads.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                ent = self._entries.get(eid)
            if ent is None or ent.state != "loading":
                continue
            if err is not None or "k" not in (arrs or {}):
                tm.ENGINE_KV_TIER_MOVES.labels(
                    model=self._mlabel, direction="load",
                    outcome="fault").inc()
                self._drop_entry(ent)
                continue
            self._install_loaded(ent, arrs, now)

    @torch.inference_mode()
    def _install_loaded(self, ent: _Entry, arrs: dict,
                        now: float) -> None:
        """Disk rows -> warm host pages (chopped to page granularity, cast
        to the arena's dtype, full pages re-entering the dedup index)."""
        P = self.P
        n = min(ent.n, arrs["k"].shape[1])
        names = [nm for nm in ("k", "v", "k_scale", "v_scale")
                 if nm in arrs]
        if n < P or set(names) != set(self._planes()):
            self._drop_entry(ent)  # too short, or another cache dtype
            return
        ent.n = n
        npg = -(-n // P)
        page_bytes = self.slab.page_bytes
        hpids: list[int] = []
        nbytes_total = 0
        keys = [self._page_key(ent.tokens, (i + 1) * P)
                if (i + 1) * P <= n else None for i in range(npg)]
        with self._lock:
            need = sum(1 for k in keys
                       if k is None or k not in self._dedup)
        slots = self._reserve(need)
        if slots is None:
            self._drop_entry(ent)
            return
        with self._lock:
            for i, key in enumerate(keys):
                hpid = self._dedup.get(key) if key is not None else None
                if hpid is not None:
                    self._host[hpid].ref += 1
                    hpids.append(hpid)
                    continue
                # the reservation's eviction may have freed a page
                # counted as shared: take one more slot for it
                more = slots or self.slab.alloc(1)
                if not more:
                    for h in hpids:
                        self._deref_locked(h)
                    self._drop_entry_locked(ent)
                    return
                slots = more
                lo, hi = i * P, min((i + 1) * P, n)
                slot = slots.pop()
                views = self.slab.views(slot)
                for nm in names:
                    v = views[nm]
                    v.zero_()
                    v[:, : hi - lo].copy_(torch.from_numpy(
                        np.ascontiguousarray(arrs[nm][:, lo:hi])))
                hpid = self._next_id
                self._next_id += 1
                self._host[hpid] = _HostPage(slot, page_bytes, ref=1,
                                             key=key)
                if key is not None:
                    self._dedup[key] = hpid
                self._host_bytes += page_bytes
                nbytes_total += page_bytes
                hpids.append(hpid)
            self.slab.free(slots)  # reserved for keys deduped meanwhile
            ent.hpids = hpids
            ent.state = "warm"
            ent.last_used = now
        self._disk_pages = max(0, self._disk_pages - npg)
        self.counters["loads"] += 1
        FLIGHT.transfer("load", now, 0.0, npg, nbytes_total)
        tm.ENGINE_KV_TIER_MOVES.labels(
            model=self._mlabel, direction="load", outcome="ok").inc()
        tm.ENGINE_KV_TIER_BYTES.labels(
            model=self._mlabel, direction="load").inc(nbytes_total)

    # --------------------------------------------------------- host store

    def _page_key(self, tokens, end: int) -> bytes:
        # causal attention: KV rows for positions [0, end) are a pure
        # function of tokens[:end], so the prefix hash IS the content id
        return hashlib.sha1(
            np.asarray(tokens[:end], np.int64).tobytes()).digest()

    def _covered(self, tokens, n: int) -> bool:
        with self._lock:
            return any(e.n >= n and e.tokens[:n] == tokens[:n]
                       for e in self._entries.values()
                       if e.state != "loading")

    def _touch_covering(self, tokens, n: int, now: float) -> None:
        with self._lock:
            for e in self._entries.values():
                if e.n >= n and e.tokens[:n] == tokens[:n]:
                    e.last_used = now

    def _deref_locked(self, hpid: int) -> None:
        # caller holds self._lock
        hp = self._host[hpid]
        hp.ref -= 1
        if hp.ref > 0:
            return
        del self._host[hpid]
        self._host_bytes -= hp.nbytes
        self.slab.free([hp.slot])
        if hp.key is not None and self._dedup.get(hp.key) == hpid:
            del self._dedup[hp.key]

    def _drop_entry(self, ent: _Entry) -> None:
        with self._lock:
            self._drop_entry_locked(ent)

    def _drop_entry_locked(self, ent: _Entry) -> None:
        # caller holds self._lock
        if self._entries.pop(ent.eid, None) is None:
            return
        for hpid in ent.hpids:
            self._deref_locked(hpid)
        if ent.state == "cold":
            self._disk_pages = max(
                0, self._disk_pages - (-(-ent.n // self.P)))
        ent.hpids = []
        ent.state = "dropped"

    def invalidate(self) -> None:
        """The weights changed (a LoRA hot apply): every entry, staged
        fetch and in-flight spill holds the old model's K/V. Entries are
        dropped (a saving one lands and is ignored), stages abandoned,
        and spills landing later are discarded."""
        self._epoch += 1
        with self._lock:
            for e in list(self._entries.values()):
                self._drop_entry_locked(e)
        for rid, f in list(self._fetches.items()):
            del self._fetches[rid]
            self._abandon_fetch(rid, f)

    # ------------------------------------------------------- diagnostics

    def entries(self) -> list[_Entry]:
        with self._lock:
            return list(self._entries.values())

    def host_rows(self, ent: _Entry) -> dict[str, torch.Tensor]:
        """A warm entry's rows as held in host memory, ``[L, pages * P,
        ...]`` per plane (copies; diagnostics and tests)."""
        with self._lock:
            pages = [self.slab.views(self._host[h].slot)
                     for h in ent.hpids]
        return {nm: torch.cat([p[nm] for p in pages], 1)
                for nm in pages[0]} if pages else {}

    def tier_pages(self, hbm_in_use: int) -> dict:
        with self._lock:
            return {"hbm": hbm_in_use, "host": len(self._host),
                    "disk": self._disk_pages}

    def stats(self) -> dict:
        with self._lock:
            warm = sum(1 for e in self._entries.values()
                       if e.state in ("warm", "saving"))
            cold = sum(1 for e in self._entries.values()
                       if e.state in ("cold", "loading"))
            return {
                "entries_warm": warm, "entries_cold": cold,
                "host_pages": len(self._host),
                "host_bytes": self._host_bytes,
                "host_slots_free": self.slab.n_free(),
                "disk_pages": self._disk_pages,
                **self.counters,
            }

    def busy(self) -> bool:
        """Transfers or IO still in flight (settle/close use this)."""
        return bool(len(self._swin) or len(self._fwin)
                    or any(t.is_alive() for t in self._io_threads)
                    or any(e.state in ("saving", "loading")
                           for e in self.entries()))

    def _entry_bytes(self, ent: _Entry) -> int:
        return ent.n * sum(
            a.shape[0] * int(np.prod(a.shape[3:])) * a.element_size()
            for a in self._planes().values())

    def leak_check(self) -> None:
        """Cross-tier accounting invariants: host-page refcounts equal
        their referencing entries plus in-flight spill holds, the dedup
        index points at live pages carrying its keys, the byte tally and
        the slab's free slots match the store. Raises AssertionError."""
        expect: dict[int, int] = {}
        flying_slots = 0
        for sp in self._swin.tags():
            flying_slots += len(sp.slots)
            for step in sp.plan:
                if step[0] == "dup":
                    expect[step[1]] = expect.get(step[1], 0) + 1
        with self._lock:
            for e in self._entries.values():
                for hpid in e.hpids:
                    expect[hpid] = expect.get(hpid, 0) + 1
            for hpid, hp in self._host.items():
                if hp.ref != expect.get(hpid, 0):
                    raise AssertionError(
                        f"host page {hpid}: ref {hp.ref} != "
                        f"{expect.get(hpid, 0)} references")
                if hp.key is not None \
                        and self._dedup.get(hp.key) != hpid:
                    raise AssertionError(
                        f"host page {hpid} carries a dedup key the "
                        "index does not map to it")
            for key, hpid in self._dedup.items():
                if hpid not in self._host:
                    raise AssertionError("dedup key maps to a freed "
                                         f"host page {hpid}")
            orphans = set(expect) - set(self._host)
            if orphans:
                raise AssertionError(
                    f"entries reference freed host pages: {orphans}")
            if self._host_bytes != sum(h.nbytes
                                       for h in self._host.values()):
                raise AssertionError("host byte tally drifted")
            used = {h.slot for h in self._host.values()}
            if len(used) != len(self._host) or (
                    len(used) + flying_slots + self.slab.n_free()
                    != self.slab.n_pages):
                raise AssertionError("host slots leaked or double-used")
        staged = {f.stage for f in self._fetches.values()}
        if staged & set(self._stage_free):
            raise AssertionError("stage id both free and in use")

    # ---------------------------------------------------------- lifecycle

    def settle(self, timeout_s: float = 10.0) -> None:
        """Drive ticks until every in-flight transfer and IO thread lands.
        Only for tests and tools while the scheduler is quiescent."""
        self._t_scan = 0.0  # force one policy scan past the rate limit
        self.tick()
        deadline = time.perf_counter() + timeout_s
        while self.busy() and time.perf_counter() < deadline:
            self.tick()
            time.sleep(0.005)
        self.tick()

    def close(self) -> None:
        """Engine teardown (the scheduler is gone, so waiting is fine):
        complete and account every in-flight transfer, abandon staged
        fetches so the pool's leak_check stays clean."""
        now = time.perf_counter()
        for sp in self._swin.flush():
            self._finalize_spill(sp, now)
        for npg, nbytes, t0 in self._fwin.flush():
            self._fetch_landed(npg, nbytes, t0, now)
        for rid, f in list(self._fetches.items()):
            del self._fetches[rid]
            self._abandon_fetch(rid, f)
        for t in self._io_threads:
            t.join(timeout=2.0)
        self._apply_io_results(now)
        self._io_threads = [t for t in self._io_threads
                            if t.is_alive()]
