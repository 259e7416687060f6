"""Host-owned page allocator for the paged KV pool (the port's own copy
of localai_tfp_tpu/engine/kv_pool.py).

The dense KV cache pre-reserves ``max_seq`` positions of HBM per slot, so
slot count — the direct ceiling on batch size — is bound by WORST-CASE
context. The paged pool instead backs every slot with a table of
fixed-size pages drawn from one shared arena
(``[n_layers, n_pages, page, kv_dim]``, models/transformer.py), so HBM
scales with *live* tokens and a prefix resident in one slot can be
shared into another by reference (refcount bump) instead of by row copy
— the block-granular design paged serving converged on (Ragged Paged
Attention / RTP-LLM, PAPERS.md).

This module is the HOST side only: pure bookkeeping (free list,
refcounts, per-slot page tables), no device imports. The engine snapshots
tables into dispatch payloads as plain int32 index arrays, so multihost
followers replay paged dispatches like any other record and the device
never sees allocator state.

Invariants the engine relies on (asserted by ``leak_check``):

- page 0 is the reserved TRASH page: reads of unallocated table slots
  and discarded writebacks are pointed at it; it never carries data.
- a page's refcount equals the number of table entries referencing it.
- a page is WRITABLE only while exactly one table references it
  (``writable``); shared pages are full, immutable prefix pages.
- every free-list page has refcount 0 and appears in no table.
- a PINNED page (tier transfer in flight — engine/kv_tier.py) never
  enters the free list: dropping its last table reference parks it in
  limbo until ``unpin`` releases it, so an in-flight device->host DMA's
  source pages cannot be reallocated and rewritten under the copy's
  bookkeeping (device-order already protects the *content*; the pin
  protects the *accounting*).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

__all__ = ["PagePool", "PagePoolExhausted", "TRASH_PAGE"]

TRASH_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """No free page available (after any engine-side reclaim)."""


@dataclass
class PoolStats:
    total: int  # data pages (excludes the trash page)
    free: int
    in_use: int  # distinct allocated pages
    shared: int  # pages referenced by >1 table (zero-copy prefix shares)
    refs: int  # total table entries (>= in_use; the gap is sharing)
    pinned: int = 0  # pages held by an in-flight tier transfer


class PagePool:
    """Free-list page allocator with refcounted cross-slot sharing."""

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (1 is the trash "
                             f"page); got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1; got {page_size}")
        self.page = page_size
        self.n_pages = n_pages
        # the scheduler thread owns all allocation, but stats()/tables
        # are read from server threads (/backend/monitor, profilers), so
        # bookkeeping mutations take a lock — sub-microsecond host work
        # at admission granularity, invisible next to a device dispatch
        self._lock = threading.Lock()
        # pop() allocates ascending (1, 2, ...): keeps fresh arenas dense
        self._free: list[int] = list(range(n_pages - 1, 0, -1))  # lint: guarded-by self._lock
        self._ref = [0] * n_pages  # lint: guarded-by self._lock
        self._ref[TRASH_PAGE] = 1  # permanently reserved
        self._tables: dict[int, list[int]] = {}  # lint: guarded-by self._lock
        # allocation outcomes, exported as
        # engine_kv_page_alloc_total{outcome=...} by the engine
        self.allocs = {"fresh": 0, "shared": 0, "cow": 0}  # lint: guarded-by self._lock
        # pin counts per page (engine/kv_tier.py spill-in-flight holds):
        # a pinned page whose refcount drops to 0 parks in limbo instead
        # of re-entering the free list, until its last unpin
        self._pins: dict[int, int] = {}  # lint: guarded-by self._lock

    # ----------------------------------------------------------- queries

    def table(self, slot: int) -> list[int]:
        """The slot's physical page run (page i covers token positions
        [i*page, (i+1)*page)). Returns a snapshot copy: concurrent
        monitor reads must not alias a list the scheduler mutates."""
        with self._lock:
            return list(self._tables.get(slot, ()))

    def held(self, slot: int) -> int:
        """Pages currently referenced by the slot's table."""
        with self._lock:
            return len(self._tables.get(slot, ()))

    def writable(self, pg: int) -> bool:
        """Whether a dispatch may write this page (exactly one owner;
        never the trash page)."""
        with self._lock:
            return self._writable(pg)

    def _writable(self, pg: int) -> bool:
        # lint: holds self._lock
        return pg != TRASH_PAGE and self._ref[pg] == 1

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page)

    def pinned(self, pg: int) -> bool:
        """Whether the page is held by an in-flight tier transfer (a
        drop would park it in limbo, not free it — reclaim estimates
        must not count it)."""
        with self._lock:
            return pg in self._pins

    def pinned_in(self, slot: int) -> bool:
        """Whether any page in the slot's table is pinned (a tier spill
        of this slot is in flight — reclaim must not race its drop)."""
        with self._lock:
            return any(pg in self._pins
                       for pg in self._tables.get(slot, ()))

    def stats(self) -> PoolStats:
        with self._lock:
            in_use = (self.n_pages - 1) - len(self._free)
            shared = sum(1 for pg in range(1, self.n_pages)
                         if self._ref[pg] > 1)
            refs = sum(len(t) for t in self._tables.values())
            return PoolStats(total=self.n_pages - 1,
                             free=len(self._free),
                             in_use=in_use, shared=shared, refs=refs,
                             pinned=len(self._pins))

    # -------------------------------------------------------- allocation

    def _alloc(self) -> int:
        # lint: holds self._lock
        if not self._free:
            raise PagePoolExhausted(
                f"KV page pool exhausted ({self.n_pages - 1} pages of "
                f"{self.page} tokens)")
        pg = self._free.pop()
        self._ref[pg] = 1
        self.allocs["fresh"] += 1
        return pg

    def _unref(self, pg: int) -> None:
        # lint: holds self._lock
        if pg == TRASH_PAGE:
            return
        self._ref[pg] -= 1
        if self._ref[pg] < 0:
            raise AssertionError(f"page {pg} refcount went negative")
        if self._ref[pg] == 0 and pg not in self._pins:
            self._free.append(pg)

    # ----------------------------------------------------------- pinning

    def pin(self, pages) -> None:
        """Hold ``pages`` out of the free list while a tier transfer is
        in flight: an unreferenced pinned page parks in limbo instead of
        becoming allocatable, so the transfer's completion bookkeeping
        (engine/kv_tier.py) runs against stable page identities."""
        with self._lock:
            for pg in pages:
                if pg == TRASH_PAGE:
                    continue
                if self._ref[pg] == 0 and pg not in self._pins:
                    raise AssertionError(
                        f"pin of free page {pg}: pin while referenced")
                self._pins[pg] = self._pins.get(pg, 0) + 1

    def unpin(self, pages) -> None:
        """Release pins; a page whose last pin drops with refcount 0
        (its tables were dropped mid-transfer) re-enters the free
        list here."""
        with self._lock:
            for pg in pages:
                if pg == TRASH_PAGE:
                    continue
                n = self._pins.get(pg, 0) - 1
                if n < 0:
                    raise AssertionError(f"unpin of unpinned page {pg}")
                if n:
                    self._pins[pg] = n
                else:
                    del self._pins[pg]
                    if self._ref[pg] == 0:
                        self._free.append(pg)

    def ensure(self, slot: int, n_tokens: int) -> int:
        """Grow the slot's table to cover positions [0, n_tokens);
        returns the number of fresh pages appended. Raises
        PagePoolExhausted when the arena runs dry (the engine reclaims
        free-slot residents and retries)."""
        with self._lock:
            t = self._tables.setdefault(slot, [])
            need = self.pages_for(n_tokens)
            added = 0
            while len(t) < need:
                t.append(self._alloc())
                added += 1
            return added

    def append_fresh(self, slot: int) -> int:
        """Append one fresh private page; returns its physical id."""
        with self._lock:
            pg = self._alloc()
            self._tables.setdefault(slot, []).append(pg)
            return pg

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Drop table entries wholly beyond ``n_tokens`` positions."""
        with self._lock:
            t = self._tables.get(slot)
            if t is None:
                return
            keep = self.pages_for(n_tokens)
            while len(t) > keep:
                self._unref(t.pop())

    def drop(self, slot: int) -> None:
        """Release every page the slot references (shared pages survive
        while other tables still reference them)."""
        with self._lock:
            for pg in self._tables.pop(slot, []):
                self._unref(pg)

    # ----------------------------------------------------------- sharing

    def share(self, dst: int, src: int, n_full_pages: int) -> int:
        """Zero-copy prefix share: dst's table becomes the first
        ``n_full_pages`` of src's run by REFERENCE (refcount bump, no
        device work). dst's previous pages are released first. Returns
        the number of pages shared."""
        self.drop(dst)
        with self._lock:
            run = self._tables.get(src, [])[:n_full_pages]
            for pg in run:
                self._ref[pg] += 1
            self._tables[dst] = list(run)
            self.allocs["shared"] += len(run)
            return len(run)

    def prepare_write(self, slot: int, pos: int):
        """Make position ``pos`` (the slot's write frontier) privately
        writable: pages wholly beyond the frontier are dropped, and a
        SHARED boundary page holding committed rows [boundary, pos) is
        copy-on-write swapped for a fresh private page. Returns the
        (src_page, dst_page) pair the engine must row-copy on device, or
        None when no copy is needed."""
        with self._lock:
            t = self._tables.setdefault(slot, [])
            b = pos // self.page
            while len(t) > b + 1:
                self._unref(t.pop())
            if len(t) <= b:
                return None  # frontier page not allocated yet: ensure()
            if pos % self.page == 0:
                # the boundary page carries no committed rows — a shared
                # one is simply released (content lives on in the
                # donor's table)
                if not self._writable(t[b]):
                    self._unref(t.pop())
                return None
            if self._writable(t[b]):
                return None
            old = t[b]
            fresh = self._alloc()
            t[b] = fresh
            self._unref(old)
            self.allocs["cow"] += 1
        # the device copy the caller dispatches is enqueued before any
        # later write can recycle ``old``, so device-order serialization
        # keeps the read coherent even if old just hit the free list
        return old, fresh

    # ------------------------------------------------------- diagnostics

    def leak_check(self) -> None:
        """Assert the structural invariants; raises AssertionError on a
        leak or double-owner (used by the churn fuzz test and callable
        from debug endpoints)."""
        with self._lock:
            return self._leak_check()

    def _leak_check(self) -> None:
        # lint: holds self._lock
        counts = [0] * self.n_pages
        for t in self._tables.values():
            for pg in t:
                counts[pg] += 1
        if counts[TRASH_PAGE]:
            raise AssertionError("trash page referenced by a table")
        for pg in range(1, self.n_pages):
            if counts[pg] != self._ref[pg]:
                raise AssertionError(
                    f"page {pg}: refcount {self._ref[pg]} != "
                    f"{counts[pg]} table references")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        for pg in free:
            if self._ref[pg] != 0:
                raise AssertionError(f"free page {pg} has refcount "
                                     f"{self._ref[pg]}")
        live = {pg for t in self._tables.values() for pg in t}
        if live & free:
            raise AssertionError("page both free and table-referenced")
        # cross-tier accounting: pins are positive, never on the trash
        # page, and a pinned-but-unreferenced page sits in limbo —
        # excluded from the free list until unpin returns it
        limbo = set()
        for pg, n in self._pins.items():
            if n <= 0:
                raise AssertionError(f"page {pg} has pin count {n}")
            if pg == TRASH_PAGE:
                raise AssertionError("trash page pinned")
            if self._ref[pg] == 0:
                limbo.add(pg)
        if limbo & free:
            raise AssertionError("pinned unreferenced page on the free "
                                 "list")
        if len(live) + len(free) + len(limbo) != self.n_pages - 1:
            raise AssertionError("orphaned pages: neither free, "
                                 "referenced, nor pinned in limbo")
