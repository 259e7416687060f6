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
match withholding), ``max_tokens`` and context exhaustion end a request,
exactly as in the JAX package. Out of scope for this slice (and refused
at submit rather than ignored): prefix sharing, speculative decoding,
grammars and logit bias, prompt caches, multimodal soft tokens,
deadlines, disaggregation and meshes.

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
from .tokenizer import StreamDecoder, Tokenizer

log = logging.getLogger(__name__)

DEFAULT_PREFILL_BUCKETS = (4, 16, 128, 512, 2048)


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
    logit_bias: Optional[dict[int, float]] = None  # not served yet
    constraint: Optional[Any] = None  # grammar: not served yet
    prompt_cache_path: str = ""  # not served yet
    prompt_cache_all: bool = False
    prompt_cache_ro: bool = False
    correlation_id: str = ""
    soft_embeds: Optional[Any] = None  # multimodal: not served yet
    soft_positions: Optional[Any] = None
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    trace_id: str = ""
    t_submit: float = 0.0  # perf_counter at submit
    timeout_s: float = 0.0  # deadlines: not served yet
    deadline: float = 0.0
    prefix_chain: tuple = ()
    disagg: Optional[Any] = None  # disaggregated serving: not served yet


@dataclass
class StreamEvent:
    """Streamed to the caller per emitted text span; final carries stats."""

    text: str = ""
    token_id: Optional[int] = None
    done: bool = False
    finish_reason: str = ""  # stop | length | error | shed | cancelled
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


def _refusal(req: GenRequest, max_seq: int) -> str:
    """Why this slice cannot serve ``req`` ("" when it can)."""
    if len(req.prompt_ids) >= max_seq:
        return (f"prompt ({len(req.prompt_ids)} tokens) exceeds context "
                f"size {max_seq}")
    if not req.prompt_ids:
        return "empty prompt"
    for name in ("logit_bias", "constraint", "soft_embeds", "disagg"):
        if getattr(req, name) is not None:
            return f"{name} is not supported by this port yet"
    if req.prompt_cache_path:
        return "prompt caches are not supported by this port yet"
    if req.timeout_s:
        return "request deadlines are not supported by this port yet"
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
        autostart: bool = True,
        device: Any = None,
    ) -> None:
        self.device = resolve(device)
        for k, v in params.items():
            for t in leaves(v):  # both planes of an int8 QTensor leaf
                if t.device != self.device:
                    raise ValueError(f"param {k} lives on {t.device}, the "
                                     f"engine on {self.device}")
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
        self.sampling = smp.SamplingState.create(
            n_slots, spec.vocab_size, window=penalty_window,
            device=self.device)
        self.slots = [_Slot(i) for i in range(n_slots)]
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
        """Pool invariants (kv_pool.leak_check) plus: no free slot holds
        pages."""
        self._pool.leak_check()
        for s in self.slots:
            if not s.active and self._pool.held(s.idx):
                raise AssertionError(f"free slot {s.idx} still holds pages")

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
                self._admit()
                self.step()
            except Exception as e:  # the loop must keep serving
                log.exception("engine step failed")
                self._fail_all(f"engine error: {e!r}")

    def step(self) -> None:
        """Run one device step for the current slot states."""
        prefilling = [s for s in self.slots if s.state is SlotState.PREFILL]
        decoding = [s for s in self.slots if s.state is SlotState.DECODE]
        if prefilling:
            self._mixed_step(prefilling, decoding)
        elif decoding:
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
                    out.put(StreamEvent(done=True, finish_reason="cancelled"))
                else:
                    keep.append((req, out))
            self._pending = keep
        for s in self.slots:
            if s.active and s.request is not None and s.request.id in ids:
                self._finish(s, "cancelled")

    def _admit(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        requeue, waits = [], []
        now = time.perf_counter()
        free = self._pool.stats().free  # soft admission gate: the step's
        # _ensure is the backstop
        for req, out in pending:
            slot = next((s for s in self.slots if not s.active), None)
            need = self._pool.pages_for(len(req.prompt_ids) + 1)
            if need > self.kv_pages - 1:
                out.put(StreamEvent(
                    done=True, finish_reason="error",
                    error=f"prompt needs {need} KV pages; the pool holds "
                          f"{self.kv_pages - 1}"))
                continue
            if slot is None or free < need:
                requeue.append((req, out))  # wait for a slot / pages
                continue
            free -= need
            waits.append(max(0.0, now - req.t_submit))
            slot.request = req
            slot.out = out
            slot.state = SlotState.PREFILL
            slot.n_past = 0
            slot.n_prompt = len(req.prompt_ids)
            slot.generated = []
            slot.decoder = StreamDecoder(self.tokenizer)
            slot.pending_text = ""
            slot.emit_buf = []
            slot.emit_tok = None
            slot.t_start = now
            slot.t_first = slot.t_prefill_t0 = 0.0
            slot.t_prefill_ms = slot.t_decode_ms = 0.0
        with self._lock:  # requeue keeps arrival order ahead of new ones
            self._pending[:0] = requeue
            self._queue_waits.extend(waits)

    # ------------------------------------------------------------ device steps

    def _ensure(self, slot: _Slot, n_tokens: int) -> bool:
        """Grow the slot's pages to cover ``n_tokens`` positions; on an
        exhausted pool the request ends with "length"."""
        try:
            self._pool.ensure(slot.idx, n_tokens)
            return True
        except PagePoolExhausted:
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

    def _sample(self, rows: list[_Slot], logits: torch.Tensor) -> torch.Tensor:
        noise = self._noise(rows)
        if noise is None:
            noise = torch.zeros((len(rows), min(smp.CAND, logits.shape[-1])),
                                device=self.device)
        tok, _ = smp.sample(self.sampling, self._ints([s.idx for s in rows]),
                            logits, noise=noise)
        return tok

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
        ql = self._ints(q_lens)
        hidden, _ = forward_hidden(
            self.spec, self.params, torch.from_numpy(toks).to(self.device),
            self._ints(pos0), self.cache, None, page_table=pt,
            kv_page=self.page, q_lens=ql, write_table=wt)
        self.metrics.forward_steps += 1
        self.metrics.mixed_steps += 1
        tok_host: list[int] = []
        if samplers:
            if finals:
                self._reset_sampler(finals)
            sel = self._ints([rows.index(s) for s in samplers]).long()
            last = hidden[sel, ql.long()[sel] - 1]  # each row's last token
            logits = _lm_head(self.spec, self.params, last[:, None])[:, 0]
            tok_host = self._sample(samplers, logits).tolist()
        now = time.perf_counter()
        for s, n in zip(rows, q_lens):
            if s.state is SlotState.PREFILL:
                s.n_past += n
                s.t_prefill_t0 = s.t_prefill_t0 or t0
        for s, tok in zip(samplers, tok_host):
            if s in finals:
                s.state = SlotState.DECODE
                s.t_prefill_ms = (now - s.t_prefill_t0) * 1e3
                self.metrics.prompt_tokens_processed += s.n_prompt
                self._emit_token(s, tok)
            else:
                s.n_past += 1
                s.t_decode_ms += (now - t0) * 1e3
                self._emit_token(s, tok, defer=True)
                if s.state is SlotState.DECODE:
                    self._flush_emit(s)

    @torch.inference_mode()
    def _decode_step(self, decoding: list[_Slot]) -> None:
        """Up to ``decode_steps`` seeded T == 1 forwards over the decoding
        slots, sampling on the device; one host read at the end, tokens
        past a row's finish are discarded."""
        t0 = time.perf_counter()
        k = min(self.decode_steps,
                max(s.request.max_tokens - len(s.generated) for s in decoding),
                min(self.max_seq - 1 - s.n_past for s in decoding))
        k = max(1, k)
        rows = [s for s in decoding if self._ensure(s, s.n_past + k)]
        if not rows:
            return
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
            tok = self._sample(rows, logits)
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
                s.n_past += 1
                self._emit_token(s, tok, defer=True)
            if s.state is SlotState.DECODE:
                self._flush_emit(s)

    # ------------------------------------------------------------ emission

    def _emit_token(self, slot: _Slot, token_id: int,
                    defer: bool = False) -> None:
        """Per-token bookkeeping: EOS, stop strings, limits. ``defer``
        buffers the text span and flushes one event per step."""
        req = slot.request
        assert req is not None and slot.decoder is not None
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
        # no prefix reuse in this slice: a finished slot frees its pages
        self._pool.drop(slot.idx)
        slot.state = SlotState.FREE
        slot.request = None
        slot.out = None
        slot.decoder = None
        slot.pending_text = ""
        slot.emit_buf = []
        slot.emit_tok = None
        slot.n_past = 0


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
