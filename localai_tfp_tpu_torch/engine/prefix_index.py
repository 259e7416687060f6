"""Global cross-slot prefix index: a host-side radix trie over every
slot's KV-resident token prefix (the port's own copy of
localai_tfp_tpu/engine/prefix_index.py; the port shares whole pages by
reference and copies only a sub-page tail, engine/engine.py).

Each engine slot's pages hold the K/V of a committed token prefix
(``_Slot.cache_tokens``): free slots keep their last resident's prefix
for reuse, and an ACTIVE slot's committed prefix is immutable (prefill
and decode writes land at or beyond ``n_past``). This index makes those
prefixes searchable across slots: an admitted request asks "which slot
holds the longest prefix of MY prompt?", and the engine shares that
slot's full pages by reference instead of re-prefilling them.

Structure: an edge-compressed radix trie. Each node's ``edge`` is a
numpy token array; ``slots`` is the set of slot indices whose
registered sequence covers the full path through that node. Edge
comparisons are vectorized (``np.argmin(a == b)`` shape, no per-token
Python loop), so walk cost is O(depth) numpy ops, not O(tokens).

The engine syncs the index LAZILY once per admission wave
(``sync()``) plus eagerly at the admission-path points that truncate a
slot's prefix mid-wave (``set_tokens``); decode-harvest appends and
window clamps are picked up by the next sync, which diffs the
registered sequence against the live one and extends in place when the
old registration is still a prefix (the common case — appends only).
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np

__all__ = ["PrefixIndex", "common_prefix_len"]


def common_prefix_len(a, b) -> int:
    """Length of the shared token prefix of two sequences (lists or int
    arrays). Vectorized: elementwise compare + argmax instead of a
    per-token Python loop (this ran O(n_slots) per admission).
    ndarray inputs compare in ONE shot (~36x the loop at 4096 tokens);
    list inputs convert in 512-token blocks with early exit, so a long
    shared prefix pays block conversions (~4x the loop) while a
    first-token mismatch stays O(block) — see PR microbench."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        neq = a[:n] != b[:n]
        i = int(np.argmax(neq))  # first mismatch, or 0 when none
        return n if not neq[i] else i
    out = 0
    off, step = 0, 64  # geometric blocks: an early mismatch converts
    while off < n:     # O(64) elements, a deep match amortizes
        end = min(off + step, n)
        av = np.asarray(a[off:end], dtype=np.int64)
        bv = np.asarray(b[off:end], dtype=np.int64)
        neq = av != bv
        i = int(np.argmax(neq))
        if neq[i]:
            return off + i
        out = end
        off, step = end, min(step * 4, 4096)
    return out


class _Node:
    __slots__ = ("edge", "children", "slots")

    def __init__(self, edge: np.ndarray) -> None:
        self.edge = edge  # tokens on the edge INTO this node
        self.children: dict[int, _Node] = {}
        self.slots: set[int] = set()


class PrefixIndex:
    """Radix index over per-slot resident token prefixes.

    All methods are host-only and run on the scheduler thread; no
    internal locking. Registered sequences are snapshots (numpy
    copies), so callers may keep mutating their lists."""

    def __init__(self) -> None:
        self._root = _Node(np.empty(0, np.int64))
        self._seqs: dict[int, np.ndarray] = {}  # slot -> registered seq
        self._last_use: dict[int, float] = {}  # slot -> monotonic stamp

    # ------------------------------------------------------------ register

    def set_tokens(self, slot: int, tokens, now: Optional[float] = None
                   ) -> None:
        """(Re-)register ``slot`` as holding exactly ``tokens``. Cheap
        when the old registration is a prefix of the new one (pure
        extension — membership along the existing path stays valid)."""
        seq = np.asarray(tokens, dtype=np.int64)
        old = self._seqs.get(slot)
        if old is not None:
            if len(old) == len(seq) and common_prefix_len(old, seq) == len(
                    seq):
                return  # unchanged
            if len(old) < len(seq) and common_prefix_len(old, seq) == len(
                    old):
                pass  # extension: insert walks the covered path again
            else:
                self._remove_path(slot, old)
        self._seqs[slot] = seq
        self._last_use[slot] = time.monotonic() if now is None else now
        if len(seq):
            self._insert(slot, seq)

    def remove(self, slot: int) -> None:
        old = self._seqs.pop(slot, None)
        self._last_use.pop(slot, None)
        if old is not None:
            self._remove_path(slot, old)

    def sync(self, slot_tokens: Iterable[tuple[int, list]]) -> None:
        """Diff-and-reregister every (slot, live_tokens) pair. Called
        once per admission wave; appends (decode harvests) extend in
        place, truncations (window clamps, releases) re-insert."""
        now = time.monotonic()
        seen = set()
        for slot, tokens in slot_tokens:
            seen.add(slot)
            self.set_tokens(slot, tokens, now=self._last_use.get(slot, now))
        for slot in [s for s in self._seqs if s not in seen]:
            self.remove(slot)

    def touch(self, slot: int, now: Optional[float] = None) -> None:
        """Refresh a slot's LRU stamp (reused as a copy donor, or newly
        assigned)."""
        if slot in self._seqs:
            self._last_use[slot] = time.monotonic() if now is None else now

    # --------------------------------------------------------------- query

    def match(self, tokens, exclude: frozenset = frozenset()
              ) -> tuple[int, set[int]]:
        """Longest registered prefix of ``tokens`` held by any slot not
        in ``exclude``. Returns (length, candidate slots); (0, set())
        when nothing matches."""
        seq = np.asarray(tokens, dtype=np.int64)
        n = len(seq)
        node = self._root
        i = 0
        best_len, best_slots = 0, set()
        while i < n:
            child = node.children.get(int(seq[i]))
            if child is None:
                break
            e = child.edge
            m = min(len(e), n - i)
            cp = common_prefix_len(e[:m], seq[i:i + m])
            cand = child.slots - exclude
            if cp > 0 and cand:
                # every slot registered through this node shares the
                # full edge, hence at least i+cp tokens with ``tokens``
                best_len, best_slots = i + cp, cand
            if cp < len(e):
                break
            node = child
            i += cp
        return best_len, best_slots

    def registered_len(self, slot: int) -> int:
        seq = self._seqs.get(slot)
        return 0 if seq is None else len(seq)

    def value(self, slot: int, now: Optional[float] = None) -> float:
        """Reuse value of a slot's resident prefix: LRU x length
        (longer and more recently useful prefixes are worth keeping; an
        empty or stale row is the cheapest victim)."""
        n = self.registered_len(slot)
        if n == 0:
            return 0.0
        now = time.monotonic() if now is None else now
        age = max(0.0, now - self._last_use.get(slot, 0.0))
        return n / (1.0 + age)

    def resident_tokens(self) -> int:
        """Total KV-resident (reusable) prefix tokens across all
        registered slots — free AND active."""
        return sum(len(s) for s in self._seqs.values())

    # ----------------------------------------------------------- internals

    def _insert(self, slot: int, seq: np.ndarray) -> None:
        node = self._root
        i, n = 0, len(seq)
        while i < n:
            first = int(seq[i])
            child = node.children.get(first)
            if child is None:
                leaf = _Node(seq[i:])
                leaf.slots.add(slot)
                node.children[first] = leaf
                return
            e = child.edge
            m = min(len(e), n - i)
            cp = common_prefix_len(e[:m], seq[i:i + m])
            if cp == len(e):
                child.slots.add(slot)
                node = child
                i += cp
                continue
            # split the edge at cp: mid inherits child's coverage
            mid = _Node(e[:cp])
            mid.slots = set(child.slots)
            mid.slots.add(slot)
            child.edge = e[cp:]
            mid.children[int(e[cp])] = child
            node.children[first] = mid
            if i + cp < n:
                tail = _Node(seq[i + cp:])
                tail.slots.add(slot)
                mid.children[int(seq[i + cp])] = tail
            return

    def _remove_path(self, slot: int, seq: np.ndarray) -> None:
        node = self._root
        i, n = 0, len(seq)
        path: list[tuple[_Node, int, _Node]] = []
        while i < n:
            child = node.children.get(int(seq[i]))
            if child is None or slot not in child.slots:
                break  # registration drift: nothing beyond here
            child.slots.discard(slot)
            path.append((node, int(seq[i]), child))
            node = child
            i += len(child.edge)
        for parent, key, child in reversed(path):
            if not child.slots and not child.children:
                del parent.children[key]
            elif len(child.children) == 1:
                # merge a redundant single-child chain back into one
                # edge when coverage became identical (keeps the trie
                # compact across many register/remove cycles)
                (only,) = child.children.values()
                if only.slots == child.slots:
                    child.edge = np.concatenate([child.edge, only.edge])
                    child.children = only.children
