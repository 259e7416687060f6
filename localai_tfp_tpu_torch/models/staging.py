"""A bounded-byte window of in-flight host<->device transfers (the port's
copy of ``TransferWindow`` in localai_tfp_tpu/models/staging.py, in CUDA
terms).

A handle is a CUDA event recorded after the transfer was enqueued, with
the tensors it guards: the device buffer a copy reads or writes stays
referenced until the event has completed, so the caching allocator
cannot hand its memory to later work while the copy still runs. On the
CPU a transfer is done when it returns and its handle is ``None``
(ready at once).

Two completion modes:

- ``drain(need)``: blocking, pops from the head with
  ``event.synchronize()`` until ``need`` more bytes fit the budget;
- ``reap()``: non-blocking, pops every head entry whose event reports
  complete (``event.query()``) and returns their tags. The engine's
  scheduler polls it between steps, so a transfer never makes it wait.
"""

from __future__ import annotations

from collections import deque
from typing import Any


def _ready(event: Any) -> bool:
    return event is None or event.query()


def _wait(event: Any) -> None:
    if event is not None:
        event.synchronize()


class TransferWindow:
    """FIFO of (tag, bytes, event, guarded tensors) with a byte budget.
    ``flying`` is the bytes in flight (the engine's HBM ledger reads its
    KV tier's windows as the ``staging`` component)."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget = max(1, budget_bytes)
        self._q: deque[tuple[Any, int, Any, tuple]] = deque()
        self.flying = 0

    def __len__(self) -> int:
        return len(self._q)

    def tags(self) -> list:
        return [t for t, _, _, _ in self._q]

    def add(self, tag: Any, nbytes: int, event: Any,
            guards: tuple = ()) -> None:
        """Track an already-enqueued transfer completing at ``event``."""
        self._q.append((tag, nbytes, event, guards))
        self.flying += nbytes

    def over(self, need: int) -> bool:
        """Would ``need`` more in-flight bytes exceed the budget?"""
        return self.flying + need > self.budget

    def drain(self, need: int) -> None:
        """Blocking head-pop until ``need`` more bytes fit (an
        over-budget item waits for an empty window)."""
        while self._q and (self.flying + need > self.budget
                           or (need > self.budget and self.flying)):
            _, b, ev, _ = self._q.popleft()
            _wait(ev)
            self.flying -= b

    def reap(self) -> list:
        """Non-blocking: pop head entries whose event completed and
        return their tags (one stream completes in order, so a head
        that is not ready ends the sweep)."""
        done = []
        while self._q:
            tag, b, ev, _ = self._q[0]
            if not _ready(ev):
                break
            self._q.popleft()
            self.flying -= b
            done.append(tag)
        return done

    def flush(self) -> list:
        """Blocking: complete every tracked transfer; returns the tags."""
        done = []
        while self._q:
            tag, b, ev, _ = self._q.popleft()
            _wait(ev)
            self.flying -= b
            done.append(tag)
        return done
