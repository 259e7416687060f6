"""Continuous-batching LLM engine: the main-path subset of
localai_tfp_tpu/engine/engine.py::LLMEngine.

N slots share one paged KV arena (``[L, n_pages, page, F]``) through the
host-owned ``PagePool``. A scheduler thread admits queued requests into
free slots and then runs one device step per iteration:

- a **mixed step** whenever any slot is prefilling (the JAX package's
  ``_mixed_fn`` semantics): decode rows carry one token (``q_len`` 1),
  prefill rows a chunk of their prompt capped by the per-dispatch token
  budget; one forward over the ragged batch, one ragged paged attention
  call per layer. Rows whose chunk ends their prompt are the "final"
  rows: their sampler slot is reset, its penalty window seeded from the
  prompt tail, and their first token sampled, in that order, in the same
  step as the decode rows' next tokens;
- otherwise a **decode step**: up to ``decode_steps`` T == 1 forwards
  (the seeded decode contract of the attention kernel), each sampling
  the next token on the device, with one host read at the end — the
  Python loop that stands in for the JAX package's ``lax.scan``.

Tokens then go through ``_emit_token``: EOS, stop strings (with partial
match withholding), grammar advance, ``max_tokens`` and context
exhaustion end a request, exactly as in the JAX package.

- **Prefix sharing** (``LOCALAI_PREFIX_CACHE``): a finished slot keeps
  its pages and ``cache_tokens`` as a resident prefix. ``PrefixIndex``
  finds the longest committed prefix held by any slot (free or active);
  its full pages are shared by reference (``PagePool.share``) and only a
  sub-page tail is copied (``_kv_copy``). The write frontier is made
  private by ``PagePool.prepare_write`` (copy-on-write) before a prefill
  writes it. Same-wave sharers defer behind the wave-mate that prefills
  the prefix; under pool pressure free slots' residents are reclaimed,
  least valuable first.
- **Constrained decoding**: a request's grammar constraint and its
  ``logit_bias`` bans become one ``[B, V]`` bool mask per step, built on
  the host and copied to the device from pinned memory; while any row is
  masked a decode step runs one forward per host round trip.
- **Deadlines** (``timeout_s``, ``LOCALAI_REQUEST_DEADLINE_S``): a
  queued request past its deadline gets a terminal
  ``deadline_exceeded`` event; a running one finishes with its partial
  text.
- **Speculative decoding** (``draft=(spec, params)``, ``n_draft``): a
  second paged arena for the draft, with the main pool's page count,
  page size and page tables. Mixed steps also run the draft over their
  ragged batch and write its K/V where the target writes (the prompt
  chunks and the decode rows' tokens), so the draft arena holds every
  committed position; page copies copy both arenas. A decode iteration
  without prefill runs the eligible slots (no grammar, bias, penalty,
  mirostat or soft tokens) through one speculative dispatch: rounds of
  ``n_draft`` draft forwards and one verify forward of ``n_draft``
  tokens per row, accepted on the device (greedy: while the draft's
  token is the verify argmax; sampled: rejection sampling), with one
  host read per dispatch. The other slots take a normal decode step in
  the same iteration.

Out of scope (and refused at submit rather than ignored): prompt caches,
multimodal soft tokens, disaggregation, meshes.

Batch rows are the participating slots only (the JAX package dispatches
every slot at a static shape for jit; eager PyTorch needs no padding).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

import numpy as np
import torch

from ..config import knobs
from ..device import resolve
from ..models.llm_spec import LLMSpec
from ..models.quant import leaves
from ..models.transformer import KVCache, Params, _lm_head, forward_hidden
from ..ops import sampling as smp
from .kv_pool import TRASH_PAGE, PagePool, PagePoolExhausted
from .prefix_index import PrefixIndex, common_prefix_len
from .tokenizer import StreamDecoder, Tokenizer

log = logging.getLogger(__name__)

DEFAULT_PREFILL_BUCKETS = (4, 16, 128, 512, 2048)
# minimum token GAIN over the destination's own resident prefix before a
# share (and its tail copy) is worth doing
PREFIX_MIN_COPY = 8
# minimum SHARED-prefix length before a same-wave request defers behind a
# wave-mate's prefill
PREFIX_DEFER_MIN = 64


@dataclass
class GenRequest:
    """One generation request. Field names and defaults are the JAX
    package's; the fields of features this slice does not serve must
    keep their defaults (``submit`` refuses the request otherwise)."""

    prompt_ids: list[int]
    max_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repeat_penalty: float = 0.0
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    typical_p: float = 1.0  # locally typical sampling (>=1 disabled)
    mirostat: int = 0  # 0 off | 1 v1 | 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    seed: Optional[int] = None
    stop: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    logit_bias: Optional[dict[int, float]] = None
    constraint: Optional[Any] = None  # grammars/constrain.py contract
    prompt_cache_path: str = ""  # not served yet
    prompt_cache_all: bool = False
    prompt_cache_ro: bool = False
    correlation_id: str = ""
    soft_embeds: Optional[Any] = None  # multimodal: not served yet
    soft_positions: Optional[Any] = None
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    trace_id: str = ""
    t_submit: float = 0.0  # perf_counter at submit
    timeout_s: float = 0.0  # deadline budget (0: the engine default)
    deadline: float = 0.0  # perf_counter clock, set at submit
    prefix_chain: tuple = ()
    disagg: Optional[Any] = None  # disaggregated serving: not served yet


@dataclass
class StreamEvent:
    """Streamed to the caller per emitted text span; final carries stats."""

    text: str = ""
    token_id: Optional[int] = None
    done: bool = False
    finish_reason: str = ""  # stop | length | error | shed | cancelled
    # | deadline_exceeded
    error: str = ""
    full_text: str = ""
    prompt_tokens: int = 0
    completion_tokens: int = 0
    timing_prompt_processing_ms: float = 0.0
    timing_token_generation_ms: float = 0.0
    timing_queue_ms: float = 0.0
    timing_first_token_ms: float = 0.0
    timing_prefill_enqueue_ms: float = 0.0
    retry_after_s: float = 0.0


class SlotState(Enum):
    FREE = 0
    PREFILL = 1
    DECODE = 2


@dataclass
class _Slot:
    idx: int
    state: SlotState = SlotState.FREE
    request: Optional[GenRequest] = None
    out: Optional[queue.SimpleQueue] = None
    n_past: int = 0  # positions of this slot's KV written so far
    n_prompt: int = 0
    # the token ids whose KV this slot's pages hold, [0, n_past): kept
    # after the request finishes, as the slot's resident prefix
    cache_tokens: list[int] = field(default_factory=list)
    n_reused: int = 0  # prompt tokens served from a resident prefix
    constraint_state: Any = None
    generated: list[int] = field(default_factory=list)
    decoder: Optional[StreamDecoder] = None
    pending_text: str = ""  # withheld tail that may begin a stop string
    emit_buf: list[str] = field(default_factory=list)  # deferred spans
    emit_tok: Optional[int] = None  # first token id of the buffered span
    t_start: float = 0.0
    t_first: float = 0.0
    t_prefill_t0: float = 0.0
    t_prefill_ms: float = 0.0
    t_decode_ms: float = 0.0

    @property
    def active(self) -> bool:
        return self.state is not SlotState.FREE


@dataclass
class EngineMetrics:
    requests_completed: int = 0
    tokens_generated: int = 0
    prompt_tokens_processed: int = 0
    forward_steps: int = 0  # model forwards run (each one attention
    # call per layer)
    mixed_steps: int = 0
    decode_steps: int = 0
    # prefix sharing: prompt tokens served from resident prefixes vs
    # tokens actually pushed through prefill, and tail-page copies
    prefix_reused_tokens: int = 0
    prefill_tokens: int = 0
    prefix_copies: int = 0
    # speculative decoding: tokens emitted by spec dispatches, the
    # dispatches, draft-model forwards (draft steps and prompt mirrors),
    # and per (row, round) emitted: the rounds and their accepted draft
    # tokens (j - 1 of a round that emits j)
    spec_tokens: int = 0
    spec_dispatches: int = 0
    draft_forwards: int = 0
    spec_rounds: int = 0
    spec_accepted: int = 0


def _refusal(req: GenRequest, max_seq: int) -> str:
    """Why this slice cannot serve ``req`` ("" when it can)."""
    if len(req.prompt_ids) >= max_seq:
        return (f"prompt ({len(req.prompt_ids)} tokens) exceeds context "
                f"size {max_seq}")
    if not req.prompt_ids:
        return "empty prompt"
    for name in ("soft_embeds", "disagg"):
        if getattr(req, name) is not None:
            return f"{name} is not supported by this port yet"
    if req.prompt_cache_path:
        return "prompt caches are not supported by this port yet"
    return ""


class LLMEngine:
    """Continuous-batching engine over one model on one device."""

    def __init__(
        self,
        spec: LLMSpec,
        params: Params,
        tokenizer: Tokenizer,
        *,
        n_slots: int = 8,
        max_seq: int = 4096,
        prefill_buckets: tuple[int, ...] = DEFAULT_PREFILL_BUCKETS,
        cache_dtype: Any = torch.bfloat16,
        penalty_window: int = 256,
        decode_steps: int = 8,
        kv_pages: Optional[int] = None,
        draft: Optional[tuple[LLMSpec, Params]] = None,  # speculative
        # decoding's draft model
        n_draft: int = 4,
        autostart: bool = True,
        device: Any = None,
    ) -> None:
        self.device = resolve(device)
        for what, tree in (("param", params),
                           ("draft param", draft[1] if draft else {})):
            for k, v in tree.items():
                for t in leaves(v):  # both planes of an int8 QTensor leaf
                    if t.device != self.device:
                        raise ValueError(f"{what} {k} lives on {t.device}, "
                                         f"the engine on {self.device}")
        if draft is not None and draft[0].vocab_size != spec.vocab_size:
            raise ValueError(
                f"draft vocabulary {draft[0].vocab_size} != the model's "
                f"{spec.vocab_size}: a draft must propose the model's ids")
        self.draft = draft
        self.n_draft = max(2, n_draft)
        self.spec = spec
        self.params = params
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.decode_steps = max(1, decode_steps)
        self._autostart = autostart
        buckets = tuple(b for b in sorted(prefill_buckets) if b <= max_seq) \
            or (max_seq,)
        # prefill chunk cap: the largest bucket whose full-width dispatch
        # fits the per-dispatch token budget (the JAX _mixed_buckets rule)
        budget = max(1, knobs.int_("LOCALAI_PREFILL_GROUP_TOKENS"))
        fits = [b for b in buckets if b * n_slots <= budget]
        self._chunk = fits[-1] if fits else buckets[0]
        # page size: largest power of two <= min(256, max_seq) dividing
        # max_seq; LOCALAI_KV_PAGE overrides within the same constraints
        page_cap = min(256, max_seq)
        pg = 1
        while pg * 2 <= page_cap and max_seq % (pg * 2) == 0:
            pg *= 2
        want = knobs.int_("LOCALAI_KV_PAGE")
        if 8 <= want <= page_cap and max_seq % want == 0 \
                and want & (want - 1) == 0:
            pg = want
        if pg < 8:
            raise ValueError(
                f"max_seq {max_seq} has no power-of-two divisor >= 8: the "
                "paged KV arena needs one")
        self.page = pg
        self._max_pages = max_seq // pg
        self.kv_pages = max(2, int(kv_pages or knobs.int_("LOCALAI_KV_PAGES")
                                   or n_slots * self._max_pages + 1))
        self._pool = PagePool(self.kv_pages, pg)
        self.cache = KVCache.create(spec, self.kv_pages, pg, cache_dtype,
                                    device=self.device)
        # the draft's arena: the same pages under the same tables
        self.draft_cache = (
            KVCache.create(draft[0], self.kv_pages, pg, cache_dtype,
                           device=self.device)
            if draft is not None else None)
        self.sampling = smp.SamplingState.create(
            n_slots, spec.vocab_size, window=penalty_window,
            device=self.device)
        self.slots = [_Slot(i) for i in range(n_slots)]
        # cross-slot prefix sharing (engine/prefix_index.py);
        # LOCALAI_PREFIX_CACHE=off keeps only own-slot reuse
        self._prefix_enabled = knobs.flag("LOCALAI_PREFIX_CACHE")
        self._prefix_index = PrefixIndex()
        # same-wave prefix grouping: request id -> (deadline, want_len)
        self._deferred: dict[str, tuple[float, int]] = {}
        # default per-request deadline (a request's timeout_s overrides);
        # the sweep arms on the first request that carries a deadline
        self._default_deadline_s = max(
            0.0, knobs.float_("LOCALAI_REQUEST_DEADLINE_S"))
        self._deadlines_armed = self._default_deadline_s > 0
        # host staging of the per-step [B, V] sampling mask (pinned on a
        # card, so the copy to the device is one DMA), made at first use
        self._mask_host: Optional[torch.Tensor] = None
        self.max_queue = max(0, knobs.int_("LOCALAI_MAX_QUEUE"))
        self.metrics = EngineMetrics()
        self._lock = threading.Condition()
        self._pending: list[tuple[GenRequest, queue.SimpleQueue]] = []
        self._cancelled: set[str] = set()
        self._queue_waits: deque[float] = deque(maxlen=64)
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="llm-engine")
            self._thread.start()

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError("engine scheduler did not stop in 60 s")
            self._thread = None
        self._fail_all("engine closed")

    def leak_check(self) -> None:
        """Pool invariants (kv_pool.leak_check) plus: a free slot holds
        exactly the pages of its resident prefix."""
        self._pool.leak_check()
        for s in self.slots:
            want = self._pool.pages_for(len(s.cache_tokens))
            if not s.active and self._pool.held(s.idx) != want:
                raise AssertionError(
                    f"free slot {s.idx} holds {self._pool.held(s.idx)} "
                    f"pages for a {len(s.cache_tokens)}-token resident")

    # ------------------------------------------------------------ submission

    def submit(self, req: GenRequest) -> queue.SimpleQueue:
        """Queue a request; returns its event stream queue."""
        return self.submit_many([req])[0]

    def submit_many(self, reqs: list[GenRequest]) -> list[queue.SimpleQueue]:
        """Queue a burst under one lock acquisition (one admission wave).
        With ``LOCALAI_MAX_QUEUE`` set, arrivals beyond the cap are shed
        at once with a terminal "shed" event (newest first)."""
        outs = [queue.SimpleQueue() for _ in reqs]
        ok = []
        now = time.perf_counter()
        for req, out in zip(reqs, outs):
            why = _refusal(req, self.max_seq)
            if why:
                out.put(StreamEvent(done=True, finish_reason="error",
                                    error=why))
            else:
                req.t_submit = now
                budget = req.timeout_s or self._default_deadline_s
                if budget > 0:
                    req.deadline = now + budget
                    self._deadlines_armed = True
                ok.append((req, out))
        shed = []
        with self._lock:
            if self.max_queue > 0:
                room = max(0, self.max_queue - len(self._pending))
                ok, shed = ok[:room], ok[room:]
            self._pending.extend(ok)
            self._lock.notify_all()
            retry = self._retry_after_s() if shed else 0.0
        for _, out in shed:
            out.put(StreamEvent(
                done=True, finish_reason="shed",
                error=f"admission queue full ({self.max_queue} queued); "
                      "retry later", retry_after_s=retry))
        if ok and self._autostart:
            self.start()
        return outs

    def generate(self, req: GenRequest) -> StreamEvent:
        """Blocking helper: drain the stream, return the final event."""
        q = self.submit(req)
        while True:
            ev = q.get()
            if ev.done:
                return ev

    def cancel(self, request_id: str) -> None:
        """Release a queued or running request at the next iteration; its
        stream gets a final "cancelled" event."""
        with self._lock:
            self._cancelled.add(request_id)
            self._lock.notify_all()

    def _retry_after_s(self) -> float:
        """Backoff hint for shed requests: the p90 of recent admission
        queue waits, at least 0.5 s."""
        waits = sorted(self._queue_waits)
        p90 = waits[int(0.9 * (len(waits) - 1))] if waits else 1.0
        return max(0.5, p90)

    # ------------------------------------------------------------ scheduler

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not (self._stop or self._cancelled or self._pending
                           or any(s.active for s in self.slots)):
                    self._lock.wait()
                if self._stop:
                    return
            try:
                self._apply_cancellations()
                self._apply_deadlines()
                self._admit()
                self.step()
            except Exception as e:  # the loop must keep serving
                log.exception("engine step failed")
                self._fail_all(f"engine error: {e!r}")

    def step(self) -> None:
        """Run one device step for the current slot states: a mixed step
        while any slot prefills; else a speculative dispatch for the
        eligible slots (when every decoding slot has ``n_draft``
        positions of context left) and a decode step for the rest."""
        prefilling = [s for s in self.slots if s.state is SlotState.PREFILL]
        decoding = [s for s in self.slots if s.state is SlotState.DECODE]
        if prefilling:
            self._mixed_step(prefilling, decoding)
            return
        mode, elig = self._spec_mode(decoding)
        # near the context's end a verify forward's n_draft writes would
        # run past it: then every slot takes the normal step
        if mode and min(self.max_seq - 1 - s.n_past
                        for s in decoding) >= self.n_draft:
            self._spec_decode_step(elig, mode)
            decoding = [s for s in decoding if s.state is SlotState.DECODE
                        and s not in elig]
        if decoding:
            self._decode_step(decoding)

    def _fail_all(self, msg: str) -> None:
        for s in self.slots:
            if s.active and s.out is not None:
                s.out.put(StreamEvent(done=True, finish_reason="error",
                                      error=msg))
            if s.active:
                self._release(s)
        with self._lock:
            pending, self._pending = self._pending, []
        for _, out in pending:
            out.put(StreamEvent(done=True, finish_reason="error", error=msg))

    def _apply_cancellations(self) -> None:
        with self._lock:
            if not self._cancelled:
                return
            ids, self._cancelled = self._cancelled, set()
            keep = []
            for req, out in self._pending:
                if req.id in ids:
                    self._deferred.pop(req.id, None)
                    out.put(StreamEvent(done=True, finish_reason="cancelled"))
                else:
                    keep.append((req, out))
            self._pending = keep
        for s in self.slots:
            if s.active and s.request is not None and s.request.id in ids:
                self._finish(s, "cancelled")

    def _apply_deadlines(self) -> None:
        """Terminate requests whose deadline has passed: queued ones get
        a terminal event at once (no slot was ever held), running ones
        finish through the slot path with whatever partial text they
        produced. Skipped until some request carried a deadline."""
        if not self._deadlines_armed:
            return
        now = time.perf_counter()
        with self._lock:
            still = []
            for req, out in self._pending:
                if req.deadline and now >= req.deadline:
                    self._deferred.pop(req.id, None)
                    out.put(StreamEvent(
                        done=True, finish_reason="deadline_exceeded",
                        error="deadline exceeded while queued"))
                else:
                    still.append((req, out))
            self._pending = still
        for s in self.slots:
            if (s.active and s.request is not None and s.request.deadline
                    and now >= s.request.deadline):
                self._finish(s, "deadline_exceeded")

    def _admit(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        if self._prefix_enabled:
            # lazy re-register: decode appends since the last wave are
            # diffed in (extension is the common case)
            self._prefix_index.sync(
                (s.idx, s.cache_tokens) for s in self.slots)
        # prompts admitted but not yet prefilled: their KV is not
        # committed, so the index cannot serve them yet; same-wave
        # sharers defer one iteration behind them instead
        forming = [s.request.prompt_ids for s in self.slots
                   if s.state is SlotState.PREFILL and s.request is not None]
        requeue = []
        now = time.perf_counter()
        # soft admission gate over free + reclaimable pages (the step's
        # _pool_ensure is the backstop)
        budget = self._pool.stats().free + self._reclaimable()
        for req, out in pending:
            need = self._pool.pages_for(len(req.prompt_ids) + 1)
            if need > self.kv_pages - 1:
                out.put(StreamEvent(
                    done=True, finish_reason="error",
                    error=f"prompt needs {need} KV pages; the pool holds "
                          f"{self.kv_pages - 1}"))
                continue
            if self._defer_for_prefix(req, forming, now):
                requeue.append((req, out))
                continue
            slot = self._pick_slot(req)
            if slot is None or budget < need:
                requeue.append((req, out))  # wait for a slot / pages
                continue
            budget -= need
            self._deferred.pop(req.id, None)
            self._assign(slot, req, out, now)
            forming.append(req.prompt_ids)
        with self._lock:  # requeue keeps arrival order ahead of new ones
            self._pending[:0] = requeue

    def _reclaimable(self) -> int:
        """Pages that reclaiming every free slot's resident would free."""
        return sum(1 for s in self.slots if not s.active
                   for p in self._pool.table(s.idx)
                   if self._pool.writable(p))

    def _defer_for_prefix(self, req: GenRequest, forming: list,
                          now: float) -> bool:
        """Same-wave prefix grouping: when requests of one admission wave
        share a >= PREFIX_DEFER_MIN-token prefix the index cannot serve
        yet, the FIRST prefills it and the rest wait until that prefill
        commits, then admit as share + tail prefill. Bounded by a
        deadline so a stalled or cancelled donor never strands its
        sharers (they then admit normally and prefill in full)."""
        if not self._prefix_enabled:
            return False
        cap = min(len(req.prompt_ids) - 1, self.max_seq - 1)
        state = self._deferred.get(req.id)
        if state is not None:
            deadline, want = state
            if now > deadline:
                self._deferred.pop(req.id, None)
                return False  # donor stalled: admit normally
            have, _ = self._prefix_index.match(req.prompt_ids)
            if min(have, cap) >= want:
                self._deferred.pop(req.id, None)
                return False  # shared prefix committed: admit and share
            if not any(common_prefix_len(p, req.prompt_ids) >= want
                       for p in forming):
                self._deferred.pop(req.id, None)
                return False  # donor vanished: admit normally
            return True
        share = max((common_prefix_len(p, req.prompt_ids)
                     for p in forming), default=0)
        share = min(share, cap)
        have, _ = self._prefix_index.match(req.prompt_ids)
        have = min(have, cap)
        if share >= have + PREFIX_DEFER_MIN:
            self._deferred[req.id] = (now + 0.25, share)
            return True
        return False

    def _pick_slot(self, req: GenRequest) -> Optional[_Slot]:
        """The free slot to admit onto. Admitting overwrites the slot's
        resident prefix beyond the overlap, so the victim is the slot
        whose UNSHARED tail is worth the least (reuse value scaled by the
        fraction overwritten); ties prefer the larger overlap, whose
        in-place reuse skips a share. Without prefix sharing: the
        largest overlap."""
        free = [s for s in self.slots if not s.active]
        if not free:
            return None
        if not self._prefix_enabled:
            return max(free, key=lambda s: common_prefix_len(
                s.cache_tokens, req.prompt_ids))
        now = time.monotonic()

        def cost(s: _Slot) -> tuple:
            overlap = common_prefix_len(s.cache_tokens, req.prompt_ids)
            n = self._prefix_index.registered_len(s.idx)
            destroyed = 0.0
            if n:
                keep = min(overlap, n)
                destroyed = (self._prefix_index.value(s.idx, now)
                             * (n - keep) / n)
            return (destroyed, -overlap)

        return min(free, key=cost)

    def _maybe_prefix_copy(self, slot: _Slot, req: GenRequest,
                           common: int) -> tuple[int, int]:
        """Cross-slot prefix reuse: when another slot's committed prefix
        beats this slot's own by >= PREFIX_MIN_COPY tokens, its full
        pages become this slot's by reference and only the sub-page tail
        is copied into a fresh private page. The donor may be ACTIVE: its
        committed prefix [0, n_past) is never written again, and the copy
        is issued on the stream before any later write. Returns (new
        common, tokens gained)."""
        if not self._prefix_enabled:
            return common, 0
        best, donors = self._prefix_index.match(req.prompt_ids)
        best = min(best, len(req.prompt_ids) - 1, self.max_seq - 1)
        donors = (donors - {slot.idx}
                  if best >= common + PREFIX_MIN_COPY else set())
        if not donors:
            return common, 0
        now = time.monotonic()
        donor = max(donors, key=lambda i: self._prefix_index.value(i, now))
        P = self.page
        full = best // P
        self._pool.share(slot.idx, donor, full)
        tail = best - full * P
        if tail > 0:
            src = self._pool.table(donor)[full]
            if self._pool_ensure(slot, best):  # the tail page
                self._kv_copy(src, self._pool.table(slot.idx)[full])
                self.metrics.prefix_copies += 1
            else:
                best = full * P  # no page for the tail: share only
        self._prefix_index.touch(donor, now)
        slot.cache_tokens = list(req.prompt_ids[:best])
        slot.n_past = best
        return best, max(0, best - common)

    def _assign(self, slot: _Slot, req: GenRequest, out: queue.SimpleQueue,
                now: float) -> None:
        self._queue_waits.append(max(0.0, now - req.t_submit))
        common = common_prefix_len(slot.cache_tokens, req.prompt_ids)
        common, _ = self._maybe_prefix_copy(slot, req, common)
        if common == len(req.prompt_ids):
            common -= 1  # the last prompt token runs again for its logits
        # the write frontier must be privately writable: a SHARED
        # boundary page (this slot donated its full pages, or the step
        # back above landed in a shared page) is swapped for a private
        # copy before any prefill write can reach it
        cow = self._pool.prepare_write(slot.idx, common)
        if cow is not None:
            self._kv_copy(*cow)
        slot.request = req
        slot.out = out
        slot.state = SlotState.PREFILL
        slot.n_past = common
        slot.n_prompt = len(req.prompt_ids)
        slot.cache_tokens = list(req.prompt_ids[:common])
        slot.n_reused = common
        if self._prefix_enabled:
            # eager re-register: later admissions of this wave must not
            # match the slot's stale longer registration
            self._prefix_index.set_tokens(slot.idx, slot.cache_tokens)
            self._prefix_index.touch(slot.idx)
        self.metrics.prefix_reused_tokens += common
        slot.generated = []
        slot.decoder = StreamDecoder(self.tokenizer)
        slot.pending_text = ""
        slot.emit_buf = []
        slot.emit_tok = None
        slot.t_start = now
        slot.t_first = slot.t_prefill_t0 = 0.0
        slot.t_prefill_ms = slot.t_decode_ms = 0.0
        slot.constraint_state = (req.constraint.initial_state()
                                 if req.constraint is not None else None)

    # ------------------------------------------------------------ device steps

    @torch.inference_mode()
    def _kv_copy(self, src: int, dst: int) -> None:
        """Copy one physical page across every layer: K and V, and for
        int8 pages their per-row scales; in the draft's arena too."""
        for c in (self.cache, self.draft_cache):
            if c is None:
                continue
            for t in (c.k, c.v, c.k_scale, c.v_scale):
                if t is not None:
                    t[:, dst].copy_(t[:, src])

    def _pool_ensure(self, slot: _Slot, n_tokens: int) -> bool:
        """Grow the slot's pages to cover ``n_tokens`` positions,
        reclaiming free slots' resident prefixes (least valuable first)
        under pool pressure. False: the pool is full of active state."""
        try:
            self._pool.ensure(slot.idx, n_tokens)
            return True
        except PagePoolExhausted:
            pass
        now = time.monotonic()
        victims = sorted(
            (s for s in self.slots
             if not s.active and s is not slot and self._pool.held(s.idx)),
            key=lambda s: self._prefix_index.value(s.idx, now))
        for v in victims:
            self._pool.drop(v.idx)
            v.cache_tokens = []
            v.n_past = 0
            self._prefix_index.remove(v.idx)
            try:
                self._pool.ensure(slot.idx, n_tokens)
                return True
            except PagePoolExhausted:
                continue
        return False

    def _ensure(self, slot: _Slot, n_tokens: int) -> bool:
        """``_pool_ensure``; on an exhausted pool the request ends with
        "length"."""
        if self._pool_ensure(slot, n_tokens):
            return True
        log.warning("KV page pool exhausted: slot %d needs %d tokens",
                    slot.idx, n_tokens)
        self._finish(slot, "length")
        return False

    def _tables(self, rows: list[_Slot], spans: list[tuple[int, int]]
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Read tables (each row's pages, trash beyond) and write tables
        (the pages of each row's write span [start, end), trash
        elsewhere), [B, max_pages] int32 on the device."""
        P = self.page
        pt = np.full((len(rows), self._max_pages), TRASH_PAGE, np.int32)
        wt = np.full_like(pt, TRASH_PAGE)
        for r, (s, (start, end)) in enumerate(zip(rows, spans)):
            t = self._pool.table(s.idx)
            pt[r, :len(t)] = t
            for p in range(start // P, -(-end // P)):
                if not self._pool.writable(t[p]):
                    raise RuntimeError(
                        f"paged KV: slot {s.idx} page {p} is not privately "
                        "writable — allocator invariant broken")
                wt[r, p] = t[p]
        return (torch.from_numpy(pt).to(self.device),
                torch.from_numpy(wt).to(self.device))

    def _ints(self, xs) -> torch.Tensor:
        return torch.tensor(xs, dtype=torch.int32, device=self.device)

    def _noise(self, rows: list[_Slot]) -> Optional[torch.Tensor]:
        """Gumbel draws for the sampling rows (None when all are greedy)."""
        stochastic = [s.request.temperature > 0 for s in rows]
        if not any(stochastic):
            return None
        return smp.gumbel_noise(self.sampling, [s.idx for s in rows],
                                min(smp.CAND, self.spec.vocab_size),
                                stochastic)

    def _sample(self, rows: list[_Slot], logits: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        noise = self._noise(rows)
        if noise is None:
            noise = torch.zeros((len(rows), min(smp.CAND, logits.shape[-1])),
                                device=self.device)
        tok, _ = smp.sample(self.sampling, self._ints([s.idx for s in rows]),
                            logits, mask=mask, noise=noise)
        return tok

    @staticmethod
    def _masked(rows: list[_Slot]) -> bool:
        """Whether any row samples under a grammar or logit-bias mask."""
        return any(s.request is not None and (
            s.request.constraint is not None or s.request.logit_bias)
            for s in rows)

    def _constraint_mask_rows(self, rows: list[_Slot]
                              ) -> Optional[np.ndarray]:
        """[B, V] bool masks for the rows (None when no row is masked):
        the grammar's admissible next tokens (padded with False where the
        tokenizer's vocab is smaller than the model's) and the
        ``logit_bias`` bans (bias <= -100)."""
        if not self._masked(rows):
            return None
        V = self.spec.vocab_size
        out = np.ones((len(rows), V), bool)
        for r, s in enumerate(rows):
            req = s.request
            if req is None:
                continue
            if req.constraint is not None:
                raw = np.asarray(req.constraint.next_mask(s.constraint_state),
                                 dtype=bool)
                n = min(raw.shape[0], V)
                out[r, :n] = raw[:n]
                out[r, n:] = False
            for tid, bias in (req.logit_bias or {}).items():
                if 0 <= int(tid) < V and bias <= -100:
                    out[r, int(tid)] = False
        return out

    def _step_mask(self, rows: list[_Slot]) -> Optional[torch.Tensor]:
        """The step's sampling mask on the device: built on the host into
        one staging buffer (pinned on a card) and copied in one transfer.
        The buffer is reused only after the previous step's tokens were
        read back, so that copy has landed."""
        host = self._constraint_mask_rows(rows)
        if host is None:
            return None
        B, V = host.shape
        buf = self._mask_host
        if buf is None or buf.shape[0] < B:
            buf = torch.empty((max(B, self.n_slots), V), dtype=torch.bool,
                              pin_memory=self.device.type == "cuda")
            self._mask_host = buf
        buf.numpy()[:B] = host
        return buf[:B].to(self.device, non_blocking=True)

    def _reset_sampler(self, finals: list[_Slot]) -> None:
        """Sampler reset + prompt-tail penalty seed for slots whose first
        token is sampled in this step."""
        W = self.sampling.window
        cols: dict[str, list] = {k: [] for k in smp.RESET_FIELDS}
        tails = np.zeros((len(finals), W), np.int32)
        lens = []
        for r, s in enumerate(finals):
            req = s.request
            for name, val in (
                    ("temperature", req.temperature), ("top_k", req.top_k),
                    ("top_p", req.top_p), ("min_p", req.min_p),
                    ("repeat_penalty", req.repeat_penalty),
                    ("freq_penalty", req.frequency_penalty),
                    ("presence_penalty", req.presence_penalty),
                    ("repeat_last_n", min(req.repeat_last_n
                                          if req.repeat_last_n > 0 else 64,
                                          W)),
                    ("typical_p", req.typical_p),
                    ("mirostat", req.mirostat),
                    ("mirostat_tau", req.mirostat_tau),
                    ("mirostat_eta", req.mirostat_eta)):
                cols[name].append(val)
            tail = req.prompt_ids[-W:]
            tails[r, :len(tail)] = tail
            lens.append(len(tail))
        ids = [s.idx for s in finals]
        smp.reset_slots(self.sampling, ids, cols,
                        [s.request.seed for s in finals])
        smp.seed_windows(self.sampling, self._ints(ids),
                         torch.from_numpy(tails).to(self.device),
                         self._ints(lens))

    @torch.inference_mode()
    def _mixed_step(self, prefilling: list[_Slot],
                    decoding: list[_Slot]) -> None:
        """One forward over decode rows (one token each) and prefill
        chunks; samples the decode rows' next tokens and the final rows'
        first tokens."""
        t0 = time.perf_counter()
        decoding = [s for s in decoding if self._ensure(s, s.n_past + 1)]
        prefilling = [s for s in prefilling if self._ensure(
            s, s.n_past + min(s.n_prompt - s.n_past, self._chunk))]
        rows = sorted(decoding + prefilling, key=lambda s: s.idx)
        if not rows:
            return
        chunks = []
        for s in rows:
            if s.state is SlotState.DECODE:
                chunks.append([s.generated[-1]])
            else:
                chunks.append(s.request.prompt_ids[
                    s.n_past: s.n_past + min(s.n_prompt - s.n_past,
                                             self._chunk)])
        T = max(len(c) for c in chunks)
        toks = np.zeros((len(rows), T), np.int32)
        for r, c in enumerate(chunks):
            toks[r, :len(c)] = c
        q_lens = [len(c) for c in chunks]
        pos0 = [s.n_past for s in rows]
        pt, wt = self._tables(rows, [(p, p + n) for p, n in zip(pos0, q_lens)])
        finals = [s for s, n in zip(rows, q_lens) if s.state is
                  SlotState.PREFILL and s.n_past + n == s.n_prompt]
        samplers = [s for s in rows if s.state is SlotState.DECODE
                    or s in finals]
        mask = self._step_mask(samplers) if samplers else None
        ql = self._ints(q_lens)
        toks_d = torch.from_numpy(toks).to(self.device)
        pos_d = self._ints(pos0)
        hidden, _ = forward_hidden(
            self.spec, self.params, toks_d, pos_d, self.cache, None,
            page_table=pt, kv_page=self.page, q_lens=ql, write_table=wt)
        self.metrics.forward_steps += 1
        self.metrics.mixed_steps += 1
        if self.draft is not None:
            # the draft mirrors every row's K/V under the target's write
            # table: the prompt chunks, and a decode row's token, whose
            # position the next spec round (from n_past + 1) never writes
            forward_hidden(*self.draft, toks_d, pos_d, self.draft_cache,
                           None, page_table=pt, kv_page=self.page,
                           q_lens=ql, write_table=wt)
            self.metrics.draft_forwards += 1
        tok_host: list[int] = []
        if samplers:
            if finals:
                self._reset_sampler(finals)
            sel = self._ints([rows.index(s) for s in samplers]).long()
            last = hidden[sel, ql.long()[sel] - 1]  # each row's last token
            logits = _lm_head(self.spec, self.params, last[:, None])[:, 0]
            tok_host = self._sample(samplers, logits, mask).tolist()
        now = time.perf_counter()
        for s, n in zip(rows, q_lens):
            if s.state is SlotState.PREFILL:
                s.cache_tokens.extend(
                    s.request.prompt_ids[s.n_past: s.n_past + n])
                s.n_past += n
                s.t_prefill_t0 = s.t_prefill_t0 or t0
        for s, tok in zip(samplers, tok_host):
            if s in finals:
                s.state = SlotState.DECODE
                s.t_prefill_ms = (now - s.t_prefill_t0) * 1e3
                self.metrics.prompt_tokens_processed += s.n_prompt
                self.metrics.prefill_tokens += s.n_prompt - s.n_reused
                self._emit_token(s, tok)
            else:
                s.cache_tokens.append(s.generated[-1])  # its KV landed
                s.n_past += 1
                s.t_decode_ms += (now - t0) * 1e3
                self._emit_token(s, tok, defer=True)
                if s.state is SlotState.DECODE:
                    self._flush_emit(s)

    @torch.inference_mode()
    def _decode_step(self, decoding: list[_Slot]) -> None:
        """Up to ``decode_steps`` seeded T == 1 forwards over the decoding
        slots, sampling on the device; one host read at the end, tokens
        past a row's finish are discarded. One forward when any row is
        masked: its next mask needs the token just sampled."""
        t0 = time.perf_counter()
        k = min(self.decode_steps,
                max(s.request.max_tokens - len(s.generated) for s in decoding),
                min(self.max_seq - 1 - s.n_past for s in decoding))
        k = 1 if self._masked(decoding) else max(1, k)
        rows = [s for s in decoding if self._ensure(s, s.n_past + k)]
        if not rows:
            return
        mask = self._step_mask(rows)
        pt, wt = self._tables(rows, [(s.n_past, s.n_past + k) for s in rows])
        toks = self._ints([[s.generated[-1]] for s in rows])
        pos = self._ints([s.n_past for s in rows])
        ones = torch.ones_like(pos)
        out = []
        for _ in range(k):
            hidden, _ = forward_hidden(
                self.spec, self.params, toks, pos, self.cache, None,
                page_table=pt, kv_page=self.page, q_lens=ones,
                write_table=wt)
            logits = _lm_head(self.spec, self.params, hidden)[:, -1]
            tok = self._sample(rows, logits, mask)
            out.append(tok)
            toks = tok[:, None]
            pos = pos + 1
        self.metrics.forward_steps += k
        self.metrics.decode_steps += k
        host = torch.stack(out, 1).tolist()
        dt = (time.perf_counter() - t0) * 1e3
        for s, seq in zip(rows, host):
            s.t_decode_ms += dt
            for tok in seq:
                if s.state is not SlotState.DECODE:
                    break  # finished: discard overshoot tokens
                s.cache_tokens.append(s.generated[-1])  # the input token
                s.n_past += 1
                self._emit_token(s, tok, defer=True)
            if s.state is SlotState.DECODE:
                self._flush_emit(s)

    # ------------------------------------------------------- speculative

    @staticmethod
    def _spec_eligible(s: _Slot) -> bool:
        """Grammar, bias, penalty, soft-token and mirostat slots need
        per-token sampler state (or K/V the draft never saw) that a
        speculative round does not carry."""
        r = s.request
        return not (
            r is None or r.constraint is not None or r.logit_bias
            or r.repeat_penalty not in (0.0, 1.0)
            or r.frequency_penalty or r.presence_penalty
            or r.soft_embeds is not None or r.mirostat)

    def _spec_mode(self, decoding: list[_Slot]
                   ) -> tuple[Optional[str], list[_Slot]]:
        """Per-slot eligibility: (mode, eligible slots), the mode
        "greedy" when every eligible slot is temp <= 0 (exact argmax
        replay), "sampled" otherwise (rejection sampling; greedy rows
        ride along as one-hot distributions); (None, []) when no slot
        can run speculatively."""
        if self.draft is None:
            return None, []
        elig = [s for s in decoding if self._spec_eligible(s)]
        if not elig:
            return None, []
        sampled = any(s.request.temperature > 0 for s in elig)
        return ("sampled" if sampled else "greedy"), elig

    def _draft_logits(self, tok: torch.Tensor, pos: torch.Tensor,
                      pt: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        """One T == 1 draft forward (writes the draft K/V of ``tok`` at
        ``pos``); [B, V] f32 logits."""
        dspec, dparams = self.draft
        hidden, _ = forward_hidden(
            dspec, dparams, tok, pos, self.draft_cache, None, page_table=pt,
            kv_page=self.page, q_lens=torch.ones_like(pos), write_table=wt)
        self.metrics.draft_forwards += 1
        return _lm_head(dspec, dparams, hidden)[:, -1]

    def _verify_logits(self, xin: torch.Tensor, pos: torch.Tensor,
                       pt: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        """The verify forward: ``xin [B, kd]`` as ragged rows of q_len kd
        from ``pos``; [B, kd, V] f32 logits."""
        hidden, _ = forward_hidden(
            self.spec, self.params, xin, pos, self.cache, None,
            page_table=pt, kv_page=self.page,
            q_lens=torch.full_like(pos, xin.shape[1]), write_table=wt)
        self.metrics.forward_steps += 1
        return _lm_head(self.spec, self.params, hidden)

    def _spec_draws(self, rows: list[_Slot], rounds: int, kd: int,
                    k: int) -> smp.SpecDraws:
        """The sampled dispatch's random numbers, from the rows' slot
        generators (tests replace this to pin them)."""
        return smp.spec_draws(self.sampling, [s.idx for s in rows],
                              [s.request.temperature > 0 for s in rows],
                              rounds, kd, k)

    def _greedy_rounds(self, rows, tok, pos, pt, wt, rounds):
        """``rounds`` greedy rounds on the device: kd draft argmax steps
        (the kd-th writes d_{kd-1}'s draft K/V, so the draft arena covers
        a fully accepted round), one verify forward, and cumulative
        acceptance j = 1 + cumprod(match).sum(). Returns drafted [rounds,
        B, kd - 1], the verify argmax [rounds, B, kd] and j [rounds, B]."""
        kd = self.n_draft
        D, M, J = [], [], []
        for _ in range(rounds):
            t, p, drafted = tok, pos, []
            for _ in range(kd):
                t = torch.argmax(self._draft_logits(t, p, pt, wt), -1,
                                 keepdim=True).to(torch.int32)
                drafted.append(t)
                p = p + 1
            d = torch.cat(drafted[:kd - 1], 1)
            m = torch.argmax(self._verify_logits(
                torch.cat([tok, d], 1), pos, pt, wt), -1).to(torch.int32)
            ok = (m[:, :kd - 1] == d).to(torch.int32)
            j = (1 + torch.cumprod(ok, 1).sum(1)).to(torch.int32)
            tok = torch.gather(m, 1, (j - 1).long()[:, None])
            pos = pos + j
            D.append(d)
            M.append(m)
            J.append(j)
        return torch.stack(D), torch.stack(M), torch.stack(J)

    def _sampled_rounds(self, rows, tok, pos, pt, wt, rounds):
        """``rounds`` rejection-sampled rounds on the device: the draft
        samples kd tokens from its filtered q, the verify forward gives
        the filtered p at every position, and ``smp.spec_reject``
        accepts and replaces. Returns drafted [rounds, B, kd - 1], the
        replacement tokens [rounds, B, kd] and j [rounds, B]."""
        kd = self.n_draft
        B = len(rows)
        K = min(smp.CAND, self.spec.vocab_size)
        sids = self._ints([s.idx for s in rows])
        rep = sids.repeat_interleave(kd)
        draws = self._spec_draws(rows, rounds, kd, K)
        D, M, J = [], [], []
        for r in range(rounds):
            t, p = tok, pos
            d, q_sel, q_probs, q_idx = [], [], [], []
            for i in range(kd):
                qp, qi = smp.filtered_candidates(
                    self.sampling, sids, self._draft_logits(t, p, pt, wt))
                c = smp.gumbel_pick(qp, draws.draft[r, i])[:, None]
                t = torch.gather(qi, 1, c).to(torch.int32)
                d.append(t)
                q_sel.append(torch.gather(qp, 1, c))
                q_probs.append(qp)
                q_idx.append(qi)
                p = p + 1
            drafted = torch.cat(d, 1)  # [B, kd]
            logits = self._verify_logits(
                torch.cat([tok, drafted[:, :kd - 1]], 1), pos, pt, wt)
            pp, pidx = smp.filtered_candidates(
                self.sampling, rep, logits.reshape(B * kd, -1))
            fin, j = smp.spec_reject(
                pp.reshape(B, kd, K), pidx.reshape(B, kd, K),
                torch.stack(q_probs, 1), torch.stack(q_idx, 1), drafted,
                torch.cat(q_sel, 1), draws.accept[r], draws.replace[r])
            fin, j = fin.to(torch.int32), j.to(torch.int32)
            tok = torch.gather(fin, 1, (j - 1).long()[:, None])
            pos = pos + j
            D.append(drafted[:, :kd - 1])
            M.append(fin)
            J.append(j)
        return torch.stack(D), torch.stack(M), torch.stack(J)

    @torch.inference_mode()
    def _spec_decode_step(self, decoding: list[_Slot], mode: str) -> None:
        """One speculative dispatch over the eligible decoding slots:
        ``rounds`` rounds of ``n_draft`` tokens (no round that every row
        is sure to discard), on the device, one host read at the end;
        each round emits the accepted draft tokens and the verify's
        replacement (or bonus) token through ``_emit_token``. Only these
        rows are in the batch, so no other slot's pages are written."""
        t0 = time.perf_counter()
        kd = self.n_draft
        room = min(self.max_seq - 1 - s.n_past for s in self.slots
                   if s.state is SlotState.DECODE)
        need = max(s.request.max_tokens - len(s.generated)
                   for s in decoding)
        rounds = max(1, min(self.decode_steps // kd, max(room // kd, 1),
                            -(-need // kd)))
        span = rounds * kd
        rows = [s for s in decoding if self._ensure(s, s.n_past + span)]
        if not rows:
            return
        pt, wt = self._tables(rows, [(s.n_past, s.n_past + span)
                                     for s in rows])
        tok = self._ints([[s.generated[-1]] for s in rows])
        pos = self._ints([s.n_past for s in rows])
        run = (self._sampled_rounds if mode == "sampled"
               else self._greedy_rounds)
        D, M, J = run(rows, tok, pos, pt, wt, rounds)
        # the one host read: [rounds, B, (kd - 1) + kd + 1]
        host = torch.cat([D, M, J[..., None]], -1).tolist()
        dt = (time.perf_counter() - t0) * 1e3
        emitted = 0
        for b, s in enumerate(rows):
            s.t_decode_ms += dt
            for r in range(rounds):
                if s.state is not SlotState.DECODE:
                    break  # finished: later rounds are discarded
                row = host[r][b]
                j = row[-1]
                self.metrics.spec_rounds += 1
                self.metrics.spec_accepted += j - 1
                for tok_out in row[:j - 1] + [row[kd - 1 + j - 1]]:
                    if s.state is not SlotState.DECODE:
                        break
                    s.cache_tokens.append(s.generated[-1])  # input token
                    s.n_past += 1
                    emitted += 1
                    self._emit_token(s, tok_out, defer=True)
            if s.state is SlotState.DECODE:
                self._flush_emit(s)
        self.metrics.spec_tokens += emitted
        self.metrics.spec_dispatches += 1

    # ------------------------------------------------------------ emission

    def _emit_token(self, slot: _Slot, token_id: int,
                    defer: bool = False) -> None:
        """Per-token bookkeeping: EOS, stop strings, limits. ``defer``
        buffers the text span and flushes one event per step."""
        req = slot.request
        assert req is not None and slot.decoder is not None
        if req.constraint is not None:
            slot.constraint_state = req.constraint.advance(
                slot.constraint_state, token_id)
        if not slot.generated:
            slot.t_first = time.perf_counter()
        slot.generated.append(token_id)
        self.metrics.tokens_generated += 1
        if (not req.ignore_eos) and token_id in self.tokenizer.eos_ids:
            self._finish(slot, "stop")
            return
        slot.pending_text += slot.decoder.push(token_id)
        emit, stop_hit = _scan_stops(slot.pending_text, req.stop)
        if stop_hit:
            if slot.out is not None:
                self._flush_emit(slot)
                slot.out.put(StreamEvent(text=emit, token_id=token_id))
            slot.pending_text = ""
            self._finish(slot, "stop")
            return
        if defer:
            if emit:
                slot.emit_buf.append(emit)
            if slot.emit_tok is None:
                slot.emit_tok = token_id
        elif slot.out is not None:
            slot.out.put(StreamEvent(text=emit, token_id=token_id))
        if emit:
            slot.pending_text = slot.pending_text[len(emit):]
        if len(slot.generated) >= req.max_tokens:
            self._finish(slot, "length")
        elif slot.n_past + 1 >= self.max_seq:
            # context exhausted: end generation (no context shift)
            self._finish(slot, "length")

    def _flush_emit(self, slot: _Slot) -> None:
        if slot.emit_buf and slot.out is not None:
            slot.out.put(StreamEvent(text="".join(slot.emit_buf),
                                     token_id=slot.emit_tok))
        slot.emit_buf = []
        slot.emit_tok = None

    def _finish(self, slot: _Slot, reason: str) -> None:
        req = slot.request
        self._flush_emit(slot)  # buffered text precedes the done event
        full = slot.decoder.text if slot.decoder else ""
        if req is not None:
            for st in req.stop:
                i = full.find(st)
                if i >= 0:
                    full = full[:i]
        if slot.pending_text and reason != "stop" and slot.out is not None:
            slot.out.put(StreamEvent(text=slot.pending_text))
        queue_ms = ttft_ms = 0.0
        if req is not None and req.t_submit:
            queue_ms = max(0.0, (slot.t_start - req.t_submit) * 1e3)
            if slot.t_first:
                ttft_ms = (slot.t_first - req.t_submit) * 1e3
        if slot.out is not None:
            slot.out.put(StreamEvent(
                done=True, finish_reason=reason, full_text=full,
                prompt_tokens=slot.n_prompt,
                completion_tokens=len(slot.generated),
                timing_prompt_processing_ms=slot.t_prefill_ms,
                timing_token_generation_ms=slot.t_decode_ms,
                timing_queue_ms=queue_ms, timing_first_token_ms=ttft_ms))
        self.metrics.requests_completed += 1
        self._release(slot)

    def _release(self, slot: _Slot) -> None:
        # the pages of cache_tokens stay as the slot's resident prefix;
        # pages past them (a decode step's overshoot) go back
        self._pool.truncate(slot.idx, len(slot.cache_tokens))
        slot.state = SlotState.FREE
        slot.request = None
        slot.out = None
        slot.decoder = None
        slot.pending_text = ""
        slot.emit_buf = []
        slot.emit_tok = None
        slot.constraint_state = None
        slot.n_past = len(slot.cache_tokens)


def _scan_stops(pending: str, stops: list[str]) -> tuple[str, bool]:
    """Return (text safe to emit, hit). Withholds any tail that is a prefix
    of a stop string (ref: stop-word partial matching in process_token)."""
    if not stops:
        return pending, False
    for st in stops:
        i = pending.find(st)
        if i >= 0:
            return pending[:i], True
    hold = 0
    for st in stops:
        for k in range(min(len(st) - 1, len(pending)), 0, -1):
            if pending.endswith(st[:k]):
                hold = max(hold, k)
                break
    return pending[: len(pending) - hold] if hold else pending, False
