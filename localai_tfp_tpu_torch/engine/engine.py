"""Continuous-batching LLM engine: the main-path subset of
localai_tfp_tpu/engine/engine.py::LLMEngine.

N slots share one paged KV arena (``[L, n_pages, page, F]``) through the
host-owned ``PagePool``. A scheduler thread admits queued requests into
free slots and then runs one device step per iteration:

- a **mixed step** whenever any slot is prefilling (the JAX package's
  ``_mixed_fn`` semantics): decode rows carry one token (``q_len`` 1),
  prefill rows a chunk of their prompt: the token bucket is the
  smallest of ``_mixed_buckets`` covering the largest remainder (capped
  by the last), each chunk ``min(remainder, bucket)`` (the JAX
  ``_enqueue_mixed`` rule); under an ITL budget ``_cost_bucket``
  shrinks the bucket to the largest whose predicted device time fits.
  One forward over the ragged batch, one ragged paged attention call
  per layer. Rows whose chunk ends their prompt are the "final" rows:
  their sampler slot is reset, its penalty window seeded from the
  prompt tail, and their first token sampled, in that order, in the
  same step as the decode rows' next tokens;
- otherwise a **decode step**: up to ``decode_steps`` T == 1 forwards
  (the seeded decode contract of the attention kernel), each sampling
  the next token on the device, with one host read at the end — the
  counterpart of the JAX package's ``lax.scan`` (``_decode_k_fn``).
  Under an ITL budget k is clamped as the JAX engine clamps it
  (``_itl_k``). While any row is masked (grammar, ``logit_bias``) the
  step is one forward per host round trip: the next mask needs the
  token just sampled.

Every such dispatch is, on a card, a replay of a CUDA graph captured
by ``warmup()`` before serving (or at the variant's first use) over
static buffers, all in one graph memory pool:

- a decode variant per row bucket (powers of two up to ``n_slots``):
  the dispatch copies its tables, tokens, positions, slot ids and
  Gumbel noise into the variant's buffers in one transfer and replays
  k times; the graph chains its next input on the device (token into
  the token buffer, ``pos += 1``);
- a masked decode variant per row bucket: the same, k == 1, sampling
  under a static ``[n_slots, V]`` mask filled from pinned memory before
  the replay;
- a mixed variant per (row bucket, token bucket): tokens, positions,
  ``q_lens``, tables, sampler and reset slot ids, reset columns and
  penalty-window tails in static buffers; each row's last real token
  is gathered at a fixed size, the LM head and sampler run over every
  row under the static mask (all-True when no row is masked), and a
  loaded draft's mirror forward is in the same graph;
- with a draft, a speculative variant per (mode, row bucket, rounds):
  ``rounds`` x (``n_draft`` draft forwards and one verify forward) and
  the acceptance on the device, greedy (``spec``) or rejection-sampled
  (``spec_s``, its random draws copied into static buffers before the
  replay), writing one ``[rounds, R, 2 n_draft]`` buffer the host reads
  once.

Pad rows and pad positions read and write only the trash page (in the
draft's arena too), and rows that sample nothing (pad rows, non-final
chunks) sample and reset into the sampler's sentinel row (slot
``n_slots``), which nothing reads. On the CPU the same variant code
runs eagerly through the same buffers. A failed capture or replay
raises; nothing falls back to eager forwards.

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
  text. With cost scheduling on (``LOCALAI_COST_SCHED``) a queued
  request whose predicted prefill alone overruns its deadline is
  refused before it takes a slot, and a shed request's Retry-After is
  the predicted drain of the queue.
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

Telemetry (``telemetry/``): every dispatch records its analytic
FLOPs and bytes (``costmodel.ModelCost``) in the engine's ``CostModel``
and, where the engine reads its tokens back, its device span from a
pair of CUDA events — no extra host sync; the ``HBMLedger`` attributes
the device memory the engine owns (weights, arenas, sampler, graph
pool); the Prometheus families of ``telemetry/metrics.py`` are
recorded on the engine thread and the gauges refreshed at scrape time
(``update_gauges``) from host-held values.

- **Prompt cache** (``prompt_cache_path``, ``_all``, ``_ro``): a
  finishing request's prefix K/V is gathered on the device and written
  off the scheduler thread in the JAX package's npz format
  (``engine/kv_tier.py``); an admitted request whose file holds a
  longer prefix than the slot's resident or copied one gets those rows
  scattered into fresh private pages of the live arena, in place (the
  captured graphs hold the arena's addresses). No restore while a
  draft is loaded: the draft arena would miss those rows.
- **Cancellation**: a cancel id that matches no queued or running
  request yet is kept for ``_CANCEL_TTL_S`` (a cancel can race ahead of
  its submit) and then purged, also while the engine is idle.
- **KV tier** (``LOCALAI_KV_TIER``, ``kv_tier=``; off with a draft):
  ``engine/kv_tier.py`` spills a slot's resident prefix to pinned host
  pages when its slot is reassigned (``capture``) or a reclaim takes its
  pages (``demote_urgent``), and a returning prompt's pages are staged
  back and adopted by reference (``plan``, ``adopt``), so it re-prefills
  only the relogit token; ``tick`` rides each admission pass.
- **Traces and the timeline**: each request's milestones (queue, admit,
  prefill_dispatch, first_token, done) and terminal outcome go to
  ``TRACER`` (telemetry/tracing.py); each dispatch whose tokens are read
  back is a ``step:<kind>`` span in ``FLIGHT`` (telemetry/flightrec.py),
  and every iteration samples the scheduler's counters there. Fault
  injection points: ``engine.hbm_alloc`` (KV growth) and
  ``engine.device_step`` (every dispatch).

- **Weight paging** (``LOCALAI_WEIGHT_PAGING``, ``weight_paging=``; off
  with a draft): ``engine/weight_pager.py`` moves the tree into a
  fixed-address slab at construction, demotes it to a host mirror while
  the engine is idle (``request_demote``, the cross-engine LRU, the
  watchdog) and streams it back at the same addresses, so the captured
  graphs replay unchanged. ``_admit`` polls the pager and, while the
  weights are not on the device, requeues the wave and waits on the
  engine's condition, which the promotion notifies; a granted poll holds
  off every demotion until ``step`` ends; ``embed``,
  ``update_params`` and ``warmup`` hold the tree hot through
  ``WeightPager.use``.
- **Disaggregated serving** (``engine/kv_migrate.py``): a router in
  front of this engine and a prefill-tuned sibling attaches a
  ``Migrator`` to each. The prefill side captures a finishing probe's
  pages in ``_finish``; the decode side adopts a migrated request's
  pages at admission, and the slot wakes in DECODE with the whole prompt
  resident. A plain engine has no migrator.

- **Soft tokens** (``soft_embeds`` / ``soft_positions``: an image's
  projected rows, spliced by the worker over its image-token ids): the
  mixed step's variant carries the chunk's rows in static buffers
  (rows ``[R * T, D]``, as many as the step has tokens, and batch row
  and position ``[R * T]``; pad entries point at batch row ``R``, which
  the scatter drops), and the forward replaces those positions'
  embeddings after the embedding multiplier. On a multimodal engine
  (``multimodal``) every mixed variant carries them, so an image
  prefill replays a variant captured at warmup. An image request reuses
  no prefix
  (resident, shared, copied, on disk or in the KV tier), lends none,
  takes no speculative round, and its slot's pages and tokens are
  dropped when it ends: its image-token ids say nothing of its K/V.

Out of scope (and refused at submit rather than ignored): meshes.

Batch rows are the participating slots only (padded to a variant's row
bucket), so no other slot's pages or sampler row are touched.
"""

from __future__ import annotations

import contextlib
import logging
import os
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
from ..ops.int8_matmul import int8_matmul
from ..ops import ragged_paged_attention as rpa
from ..ops.ragged_paged_attention import ragged_paged_attention
from ..telemetry import costmodel, hbm_ledger
from ..telemetry import metrics as tm
from ..telemetry.flightrec import FLIGHT
from ..telemetry.tracing import TRACER, fault_scope
from ..utils import faultinject
from .kv_pool import TRASH_PAGE, PagePool, PagePoolExhausted
from .kv_tier import KVTierManager, read_cache_file, write_cache_file
from .prefix_index import PrefixIndex, common_prefix_len
from .tokenizer import StreamDecoder, Tokenizer
from .weight_pager import WeightPager

log = logging.getLogger(__name__)

DEFAULT_PREFILL_BUCKETS = (4, 16, 128, 512, 2048)
# minimum token GAIN over the destination's own resident prefix before a
# share (and its tail copy) is worth doing
PREFIX_MIN_COPY = 8
# minimum SHARED-prefix length before a same-wave request defers behind a
# wave-mate's prefill
PREFIX_DEFER_MIN = 64
# the kernel wrappers whose launch counts a graph replay adds to (the
# launches each recorded at capture)
COUNTED = (ragged_paged_attention, int8_matmul)

# the stream every engine on a device captures its graphs on, one for the
# process: cuBLAS keeps a workspace per (handle, stream) until the process
# exits, so a stream per engine would leave one behind at each unload.
# The lock keeps two engines' captures (and their warm-up runs) apart;
# each engine's own B1 merge counters keep its capture-stream work apart
# from another engine's replays on the current stream. Two engines that
# serve at once (a disaggregated pair) replay from two scheduler threads
# on the same default stream, which orders their kernels: B1's shared
# merge counters (eager launches only) are then used by one kernel at a
# time, and B2 takes its split-K workspace per call from the allocator.
_capture_streams: dict = {}
_capture_lock = threading.Lock()


def _capture_stream(device: torch.device) -> Any:
    s = _capture_streams.get(device.index)
    if s is None:
        s = _capture_streams[device.index] = torch.cuda.Stream(device)
    return s


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
    prompt_cache_path: str = ""  # on-disk prompt cache (kv_tier format)
    prompt_cache_all: bool = False
    prompt_cache_ro: bool = False
    correlation_id: str = ""
    # multimodal: [n, D] rows (a tensor, or a numpy array made one at
    # submit) replacing the embeddings at prompt positions [n]
    soft_embeds: Optional[Any] = None
    soft_positions: Optional[Any] = None
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    trace_id: str = ""
    t_submit: float = 0.0  # perf_counter at submit
    timeout_s: float = 0.0  # deadline budget (0: the engine default)
    deadline: float = 0.0  # perf_counter clock, set at submit
    prefix_chain: tuple = ()
    disagg: Optional[Any] = None  # kv_migrate.KVHandoff of a migrated
    # resubmit (set by the router only)


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
    # the weights changed under this slot's request (a LoRA hot apply):
    # its KV is not the new model's, so it leaves no resident prefix
    stale_kv: bool = False
    n_reused: int = 0  # prompt tokens served from a resident prefix
    # (prompt cache path, rows) this request's prefix was restored from
    cache_loaded: Optional[tuple] = None
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
    # decode forwards run as a CUDA-graph replay (masked ones included,
    # and counted again in masked_replays), mixed steps run as one, and
    # the wall seconds of the last warmup() (every variant captured)
    graph_replays: int = 0
    masked_replays: int = 0
    mixed_replays: int = 0
    spec_replays: int = 0
    # mixed steps that carried soft rows, and those run as a replay
    soft_steps: int = 0
    soft_replays: int = 0
    warmup_s: float = 0.0
    # mixed steps' real tokens and the pad tokens their variants add
    # (rows x token bucket - real)
    mixed_tokens: int = 0
    mixed_pad_tokens: int = 0


@dataclass
class _DecodeVariant:
    """One decode variant: the static buffers of a row bucket and, on a
    card, the CUDA graph of one forward and sample over them. ``ints``
    is one int32 device buffer (filled from ``host`` in one transfer)
    holding the read and write tables, tokens, positions and slot ids,
    which the other fields view. A ``masked`` variant (k == 1) samples
    under the engine's static mask."""

    bucket: int
    host: torch.Tensor  # int32 staging of ``ints`` (pinned on a card)
    ints: torch.Tensor
    pt: torch.Tensor  # [bucket, max_pages] read tables
    wt: torch.Tensor  # [bucket, max_pages] write tables
    toks: torch.Tensor  # [bucket, 1] input tokens (the graph writes the next)
    pos: torch.Tensor  # [bucket] positions (the graph adds 1)
    sids: torch.Tensor  # [bucket] sampler rows (pad rows: the sentinel)
    q_lens: torch.Tensor  # [bucket] ones
    noise: torch.Tensor  # [decode_steps, bucket, K] Gumbel draws per step
    step: torch.Tensor  # [1] int64: the step a launch reads and writes
    out: torch.Tensor  # [decode_steps, bucket] sampled tokens per step
    # the last launch's [bucket, V] logits (on a card the graph's output,
    # valid until the next launch of any variant), for diagnostics
    logits: Optional[torch.Tensor] = None
    graph: Any = None  # torch.cuda.CUDAGraph (card only)
    launches: dict = field(default_factory=dict)  # per replay, by kernel
    noisy: bool = False  # noise holds draws (else zeros)
    masked: bool = False
    copied: Any = None  # event after host's last copy (card only)


def _mixed_fields(R: int, T: int, P: int, W: int, soft: bool) -> tuple:
    """The int32 fields of a mixed variant of R rows and T tokens (P
    pages a table, penalty window W, R * T soft entries when ``soft``),
    in their order in its one buffer: (name, shape)."""
    Rp = R * T if soft else 0
    return (("sbrow", (Rp,)),  # soft entries' batch rows (pads: R)
            ("sbpos", (Rp,)),  # and their positions in the chunk
            ("pt", (R, P)),  # read tables
            ("wt", (R, P)),  # write tables (the chunk's pages only)
            ("toks", (R, T)),  # chunk tokens, 0-padded
            ("pos0", (R,)),  # each row's first position
            ("q_lens", (R,)),  # real tokens (pad rows: 1)
            ("sids", (R,)),  # sampler rows (else the sentinel)
            ("rsids", (R,)),  # rows reset (finals, else the sentinel)
            ("tail_lens", (R,)),  # finals' prompt-tail lengths
            ("tails", (R, W)))  # finals' prompt tails


@dataclass
class _MixedVariant:
    """One mixed variant: the static buffers of a [rows, T] step and, on
    a card, the CUDA graph of its forward (and the draft's mirror),
    sampler reset and sample. ``ints`` (viewed by ``_mixed_fields``) is
    filled from ``host`` in one transfer, the reset columns from
    ``fhost``."""

    rows: int
    T: int
    host: torch.Tensor  # int32 staging of ints (pinned on a card)
    h: dict  # name -> numpy view of host
    ints: torch.Tensor
    f: dict  # name -> device view of ints
    fhost: torch.Tensor  # f32 staging of cols
    cols: torch.Tensor  # [len(RESET_FIELDS), rows] reset columns
    noise: torch.Tensor  # [rows, K] Gumbel draws (zeros: greedy)
    at: torch.Tensor  # [rows] int64 arange: the fixed-size gather's rows
    out: torch.Tensor  # [rows] int32 sampled tokens
    # [R * T, D] f32 soft rows (None: a text-only engine's variant),
    # their batch rows and positions the ``sbrow`` / ``sbpos`` fields of
    # ``ints``, and how many entries the last fill wrote
    soft: Optional[torch.Tensor] = None
    n_soft: int = 0
    logits: Optional[torch.Tensor] = None  # the last launch's [rows, V]
    graph: Any = None
    launches: dict = field(default_factory=dict)
    noisy: bool = False
    copied: Any = None  # event after host's and fhost's last copies


def _spec_fields(R: int, P: int) -> tuple:
    """The int32 fields of a speculative variant of R rows (P pages a
    table), in their order in its one buffer: (name, shape)."""
    return (("pt", (R, P)),  # read tables
            ("wt", (R, P)),  # write tables (the dispatch's span)
            ("tok", (R, 1)),  # each row's last token
            ("pos", (R,)),  # its position
            ("sids", (R,)))  # sampler rows (pad rows: the sentinel)


@dataclass
class _SpecVariant:
    """One speculative variant: the static buffers of ``rounds`` rounds
    over ``rows`` rows and, on a card, the CUDA graph of its draft and
    verify forwards and acceptance. ``ints`` (viewed by ``_spec_fields``)
    is filled from ``host`` in one transfer. A ``spec_s``
    (rejection-sampled) variant's random draws (``smp.SpecDraws`` at
    ``rows`` rows) are copied into ``draws`` before each launch; a
    ``spec`` (greedy) variant has none."""

    rows: int
    rounds: int
    host: torch.Tensor  # int32 staging of ints (pinned on a card)
    h: dict  # name -> numpy view of host
    ints: torch.Tensor
    f: dict  # name -> device view of ints
    out: torch.Tensor  # [rounds, rows, 2 kd]: drafted, replacement, j
    draws: Optional[smp.SpecDraws] = None  # pad rows: zeros
    graph: Any = None
    launches: dict = field(default_factory=dict)
    copied: Any = None  # event after host's last copy (card only)


def _carve(flat: torch.Tensor, fields: tuple) -> dict[str, torch.Tensor]:
    """Views of a mixed variant's int32 buffer, by field."""
    out, at = {}, 0
    for name, shape in fields:
        n = int(np.prod(shape))
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


class _Span:
    """Device time of one dispatch: a pair of CUDA events on a card,
    read after the dispatch's host read of its tokens (so the read
    costs no sync of its own); the host clock on the CPU, which is the
    device there."""

    def __init__(self, device: torch.device) -> None:
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        self._t = [0.0, 0.0]

    def start(self) -> None:
        if self._cuda:
            self._ev[0].record()
        else:
            self._t[0] = time.perf_counter()

    def stop(self) -> None:
        if self._cuda:
            self._ev[1].record()
        else:
            self._t[1] = time.perf_counter()

    def seconds(self) -> float:
        if self._cuda:
            return self._ev[0].elapsed_time(self._ev[1]) / 1e3
        return self._t[1] - self._t[0]


def _refusal(req: GenRequest, max_seq: int) -> str:
    """Why this slice cannot serve ``req`` ("" when it can)."""
    if len(req.prompt_ids) >= max_seq:
        return (f"prompt ({len(req.prompt_ids)} tokens) exceeds context "
                f"size {max_seq}")
    if not req.prompt_ids:
        return "empty prompt"
    if req.soft_embeds is not None:
        pos = req.soft_positions
        if pos is None or len(pos) != len(req.soft_embeds):
            return "soft_embeds and soft_positions differ in length"
        if len(pos) and not (0 <= min(pos) and max(pos)
                             < len(req.prompt_ids)):
            return "soft_positions outside the prompt"
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
        model: str = "default",  # the metrics' model label
        kv_tier: Optional[bool] = None,  # the KV tier: None follows
        # LOCALAI_KV_TIER
        weight_paging: Optional[bool] = None,  # the weight pager: None
        # follows LOCALAI_WEIGHT_PAGING
        multimodal: bool = False,  # image requests (soft rows): every
        # mixed variant carries static soft buffers
    ) -> None:
        self.device = resolve(device)
        self._mlabel = model or "default"
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
        # layer-granular weight paging (engine/weight_pager.py): the tree
        # moves into the pager's fixed-address slab before anything is
        # captured over it. A paging engine owns the dict it is given:
        # its leaves become the slab's views in place, so the originals
        # free as they move. Not with a draft (its second tree would be
        # stranded) nor for a disaggregated pair, which shares one tree
        # by reference
        self._pager: Optional[WeightPager] = None
        if draft is None and (knobs.flag("LOCALAI_WEIGHT_PAGING")
                              if weight_paging is None else weight_paging):
            self._pager = WeightPager(self)
        # disaggregated serving's hooks (engine/kv_migrate.Migrator),
        # attached by the router; an engine's active slots past their
        # deadline are attributed to this stage (prefill rows to
        # "prefill")
        self._migrator: Any = None
        self._deadline_stage = "decode"
        self.n_slots = n_slots
        self.multimodal = multimodal
        self.max_seq = max_seq
        self.decode_steps = max(1, decode_steps)
        self._autostart = autostart
        buckets = tuple(b for b in sorted(prefill_buckets) if b <= max_seq) \
            or (max_seq,)
        self.prefill_buckets = buckets
        # a mixed step's token buckets: the prefill buckets whose
        # full-width dispatch fits the per-dispatch token budget (the JAX
        # _mixed_buckets rule; the smallest when none does)
        budget = max(1, knobs.int_("LOCALAI_PREFILL_GROUP_TOKENS"))
        self._mixed_buckets = tuple(
            b for b in buckets if b * n_slots <= budget) or buckets[:1]
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
        # one sampler row per slot and a sentinel, slot n_slots, that the
        # pad rows of a graph decode step sample into: nothing reads it
        self.sampling = smp.SamplingState.create(
            n_slots + 1, spec.vocab_size, window=penalty_window,
            device=self.device)
        self._pad_sid = n_slots
        self.slots = [_Slot(i) for i in range(n_slots)]
        # dispatch variants, a CUDA graph each on a card, all in one graph
        # memory pool: decode and masked decode variants per row bucket
        # (powers of two below n_slots, then n_slots), mixed variants per
        # (row bucket, token bucket)
        self._buckets = [1 << i for i in range(n_slots.bit_length())
                         if 1 << i < n_slots] + [n_slots]
        self._variants: dict[int, _DecodeVariant] = {}
        self._masked_variants: dict[int, _DecodeVariant] = {}
        self._mixed_variants: dict[tuple[int, int], _MixedVariant] = {}
        # a multimodal engine's soft rows, one [R * T, D] view of it per
        # mixed variant (a step's fill is ordered after the last replay
        # on the stream, so the variants share it)
        self._soft_rows = (
            torch.zeros((n_slots * self._mixed_buckets[-1], spec.d_model),
                        dtype=torch.float32, device=self.device)
            if multimodal else None)
        # speculative variants per (kind, row bucket, rounds)
        self._spec_variants: dict[tuple[str, int, int], _SpecVariant] = {}
        cuda = self.device.type == "cuda"
        # the static [n_slots, V] sampling mask of every masked step
        # (row r masks the step's row r), its pinned staging, the event
        # after the staging's last copy, and whether it holds anything
        # but True
        self._mask_dev = torch.ones((n_slots, spec.vocab_size),
                                    dtype=torch.bool, device=self.device)
        self._mask_stage: Optional[torch.Tensor] = None
        self._mask_copied: Any = None
        self._mask_set = False
        # EWMA of measured device ms per decode step (0: no sample yet),
        # and the token buckets cost packing chose
        self._step_ms = 0.0
        self.cost_buckets: dict[int, int] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self._graph_pool_bytes = 0
        # the B1 merge counters this engine's graphs bake in (on a card)
        self._merge_counters = (rpa.new_merge_counters(self.device)
                                if cuda else None)
        self._span = _Span(self.device)
        self.state_dir = hbm_ledger.default_state_dir()
        # per-dispatch FLOPs/bytes accounting, the MFU gauge and the
        # device-time predictor (telemetry/costmodel.py): host-held
        self._costmodel: Optional[costmodel.CostModel] = None
        if knobs.flag("LOCALAI_COSTMODEL"):
            self._costmodel = costmodel.CostModel(
                self._mlabel, (torch.cuda.get_device_name(self.device)
                               if cuda else "cpu"))
            self._mcost = costmodel.ModelCost.of(spec, params, self.cache,
                                                 pg)
            self._dcost = (costmodel.ModelCost.of(*draft, self.draft_cache,
                                                  pg)
                           if draft is not None else None)
        # the device memory the engine owns, by component
        # (telemetry/hbm_ledger.py), reconciled at each /metrics scrape
        self._ledger: Optional[hbm_ledger.HBMLedger] = None
        if knobs.flag("LOCALAI_HBM_LEDGER"):
            dev = self.device
            led = hbm_ledger.HBMLedger(
                self._mlabel, lambda: hbm_ledger.device_memory_stats(dev))
            pager = self._pager
            if pager is not None:
                # paged weights by tier: hot follows the bytes on the
                # device (mapped with cuMemMap, outside the caching
                # allocator), warm is the host mirror
                led.register("weights_hot", pager.device_bytes,
                             outside=cuda)
                led.register("weights_warm", pager.host_bytes, host=True)
            else:
                led.register("weights", params)
            led.register("kv_arena", (self.cache.k, self.cache.v))
            if self.cache.k_scale is not None:
                led.register("kv_scales",
                             (self.cache.k_scale, self.cache.v_scale))
            if draft is not None:
                led.register("draft_weights", draft[1])
                led.register("draft_cache", self.draft_cache)
            led.register("sampler", self.sampling)
            if self._soft_rows is not None:
                led.register("soft_rows", self._soft_rows)
            led.register("graph_pool", lambda: self._graph_pool_bytes)
            self._ledger = led
        self._tm_generated = tm.ENGINE_GENERATED_TOKENS.labels(
            model=self._mlabel)
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
        self.max_queue = max(0, knobs.int_("LOCALAI_MAX_QUEUE"))
        self.metrics = EngineMetrics()
        # tiered KV memory (engine/kv_tier.py): pinned host pages under
        # the arena, spilled on reclaim and on slot reuse, prefetched
        # when a session returns; cold sessions on disk. Off with a draft
        # loaded: spilled pages would strand the draft's arena
        self._tier: Optional[KVTierManager] = None
        if draft is None and (knobs.flag("LOCALAI_KV_TIER")
                              if kv_tier is None else kv_tier):
            self._tier = KVTierManager(self)
            if self._ledger is not None:
                # device buffers of in-flight spills and fetches
                tier = self._tier
                self._ledger.register(
                    "staging",
                    lambda: tier._swin.flying + tier._fwin.flying)
        self._lock = threading.Condition()
        # held by ``embed`` and ``release``: an embedding in flight keeps
        # the weights until it ends, and none starts after a release
        self._device_lock = threading.Lock()
        # held by the scheduler around each step and by ``update_params``:
        # a weight update lands between dispatches
        self._step_lock = threading.Lock()
        self._pending: list[tuple[GenRequest, queue.SimpleQueue]] = []
        # cancel ids not matched yet -> when cancel() was called
        self._cancelled: dict[str, float] = {}
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
        if self._tier is not None:
            # land every in-flight tier transfer (pins released, staged
            # fetches abandoned) so pool and tier leak checks stay clean
            self._tier.close()
            for tname in ("hbm", "host", "disk"):
                tm.ENGINE_KV_TIER_PAGES.labels(model=self._mlabel,
                                               tier=tname).set(0)
        if self._pager is not None:
            # abort any page move in flight, drop the host mirror, leave
            # the cross-engine LRU
            self._pager.close()
            for tname in ("hot", "warm"):
                tm.ENGINE_WEIGHT_PAGES.labels(model=self._mlabel,
                                              tier=tname).set(0)
        for d in (self._variants, self._masked_variants,
                  self._mixed_variants, self._spec_variants):
            d.clear()  # the graphs and their pool go with them
        m = self._mlabel
        for g in (tm.ENGINE_SLOTS_BUSY, tm.ENGINE_QUEUE_DEPTH,
                  tm.ENGINE_KV_UTIL, tm.ENGINE_KV_PAGES_IN_USE,
                  tm.ENGINE_MFU):
            g.labels(model=m).set(0)
        if self._ledger is not None:
            self._ledger.reset_gauges()

    def release(self) -> None:
        """After ``close``: drop every device buffer the engine holds —
        weights, KV arenas, sampler state, the mask and its staging, the
        graphs and their pool, and the HBM ledger that registered them
        (its graph-pool source is a closure over the engine). An engine
        object that something still reaches (a caller's local, a cycle)
        then keeps no device memory alive. The engine cannot serve
        again."""
        with self._device_lock:  # an embedding in flight finishes first
            self.params = self.draft = None
            if self._pager is not None:
                # the slab's memory and range released
                self._pager.release()
            self.cache = self.draft_cache = None
            self.sampling = None
            self._mask_dev = self._mask_stage = self._mask_copied = None
            self._graph_pool = self._merge_counters = None
            self._ledger = self._costmodel = None
            self._tier = None  # its host pages go with it

    def update_params(self, fn: Any) -> Any:
        """Run ``fn(params)`` between two dispatches and return its
        result. ``fn`` must write in place (``copy_`` into the existing
        tensors): every captured graph reads the tensors it was captured
        over, so a new tensor would leave the graphs on the old weights.
        On a card the writes are complete when this returns. With weight
        paging the tree is promoted first and held hot while ``fn`` runs,
        and the pager's host mirror is dropped after (it no longer
        matches the tree)."""
        with self._weights(), self._step_lock, self._device_lock:
            if self.params is None:
                raise RuntimeError("engine released")
            out = fn(self.params)
            if self._pager is not None:
                self._pager.invalidate_host()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            # every resident prefix holds the old model's K/V: free slots
            # drop theirs now, active ones when their request ends; the
            # tier drops its entries
            if self._tier is not None:
                self._tier.invalidate()
            for s in self.slots:
                self._prefix_index.remove(s.idx)
                if s.active:
                    s.stale_kv = True
                else:
                    self._pool.drop(s.idx)
                    s.cache_tokens = []
                    s.n_past = 0
            return out

    def _weights(self) -> Any:
        """The weight gate of a caller off the scheduler thread: with a
        pager, ``WeightPager.use`` (the tree promoted and held on the
        device while the block runs); else (or once the engine is closed:
        a warm closed engine has no tree to read) nothing to wait for."""
        if self._pager is None or self._pager.closed:
            return contextlib.nullcontext()
        return self._pager.use()

    def _has_work(self) -> bool:
        """Queued or running requests (the weight pager demotes only an
        engine without any)."""
        return bool(self._pending) or any(s.active for s in self.slots)

    def leak_check(self) -> None:
        """Pool invariants (kv_pool.leak_check) plus: a free slot holds
        exactly the pages of its resident prefix; and the weight pager's
        state machine (``WeightPager.leak_check``)."""
        self._pool.leak_check()
        if self._pager is not None:
            self._pager.leak_check()
        for s in self.slots:
            want = self._pool.pages_for(len(s.cache_tokens))
            if not s.active and self._pool.held(s.idx) != want:
                raise AssertionError(
                    f"free slot {s.idx} holds {self._pool.held(s.idx)} "
                    f"pages for a {len(s.cache_tokens)}-token resident")

    # ------------------------------------------------------------ embedding

    @torch.inference_mode()
    def embed(self, text: str) -> torch.Tensor:
        """The mean over the real tokens of the final hidden state, f32
        ``[D]`` on the host (the JAX engine's ``embed``): ``text``
        encoded with BOS (``[0]`` when empty), cut to ``max_seq``, padded
        to the smallest prefill bucket that holds it (past the largest,
        to whole pages), one forward.

        The forward is the paged ragged path over a scratch arena of the
        padded length: its own pages under its own page table, so B1
        runs it on a card and nothing of the serving arena, the slots'
        pages or the graphs' static buffers is read or written. It runs
        on the calling thread, on the current stream, which orders its
        kernels with the scheduler's (B1's shared merge counters are
        used by that stream only). A warm engine's weights are promoted
        first (``_weights``)."""
        ids = self.tokenizer.encode(text, add_bos=True) or [0]
        ids = ids[: self.max_seq]
        n = len(ids)
        pg = self.page
        T = next((b for b in self.prefill_buckets if b >= n),
                 -(-n // pg) * pg)
        n_pages = -(-T // pg)
        dev = self.device
        with self._weights(), self._device_lock:
            if self.params is None:
                raise RuntimeError("engine released")
            scratch = KVCache.create(self.spec, 1 + n_pages, pg,
                                     self.cache.k.dtype, device=dev)
            toks = torch.zeros((1, T), dtype=torch.int32)
            toks[0, :n] = torch.tensor(ids, dtype=torch.int32)
            # scratch page 0 is the trash page the pad positions write
            table = torch.arange(1, 1 + n_pages, dtype=torch.int32)[None]
            hidden, _ = forward_hidden(
                self.spec, self.params, toks.to(dev),
                torch.zeros(1, dtype=torch.int32, device=dev), scratch,
                page_table=table.to(dev), kv_page=pg,
                q_lens=torch.tensor([n], dtype=torch.int32, device=dev),
                write_table=table.to(dev))
            return hidden[0, :n].float().mean(0).cpu()

    # ------------------------------------------------------------ submission

    def submit(self, req: GenRequest) -> queue.SimpleQueue:
        """Queue a request; returns its event stream queue."""
        return self.submit_many([req])[0]

    def submit_many(self, reqs: list[GenRequest],
                    outs: Optional[list] = None) -> list[queue.SimpleQueue]:
        """Queue a burst under one lock acquisition (one admission wave).
        With ``LOCALAI_MAX_QUEUE`` set, arrivals beyond the cap are shed
        at once with a terminal "shed" event (newest first). ``outs``
        (the disaggregated router's resubmit) are the streams to use
        instead of new ones."""
        outs = outs or [queue.SimpleQueue() for _ in reqs]
        ok = []
        now = time.perf_counter()
        for req, out in zip(reqs, outs):
            why = _refusal(req, self.max_seq)
            if not why and req.soft_embeds is not None and \
                    not self.multimodal:
                why = "soft_embeds on an engine built without multimodal"
            if not why and req.soft_embeds is not None:
                req.soft_embeds = torch.as_tensor(
                    req.soft_embeds, dtype=torch.float32).to(self.device)
                req.soft_positions = np.asarray(req.soft_positions,
                                                np.int64)
                if req.soft_embeds.shape[-1] != self.spec.d_model:
                    why = (f"soft_embeds of width {req.soft_embeds.shape[-1]}"
                           f" for a model of width {self.spec.d_model}")
            if why:
                out.put(StreamEvent(done=True, finish_reason="error",
                                    error=why))
                # a request refused at submit still gets a complete
                # trace: the HTTP layer may have opened one at receive
                TRACER.event(req.id, "done", model=self._mlabel)
                TRACER.annotate(req.id, "terminal", outcome="error",
                                detail=why)
                TRACER.finish(req.id, status="error")
            elif req.disagg is not None and req.t_submit:
                # a migrated resubmit keeps the t_submit and deadline the
                # router stamped at its arrival: TTFT and the deadline
                # stay end to end across prefill, migrate and decode
                if req.deadline:
                    self._deadlines_armed = True
                ok.append((req, out))
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
            for req, _ in ok:
                # stamped before the scheduler can see the request, so
                # "queue" always precedes "admit"
                TRACER.event(req.id, "queue", t=now, model=self._mlabel)
                # the trace's distributed id (minted at the HTTP edge,
                # or just now by the auto-opened trace) rides the request
                if not req.trace_id:
                    req.trace_id = TRACER.trace_id_of(req.id)
            self._pending.extend(ok)
            self._lock.notify_all()
            retry = self._retry_after_s() if shed else 0.0
        for req, out in shed:
            _release_handoff(req)
            tm.ENGINE_REQUESTS.labels(model=self._mlabel,
                                      reason="shed").inc()
            tm.ENGINE_REQUESTS_SHED.labels(model=self._mlabel,
                                           reason="queue_full").inc()
            TRACER.event(req.id, "shed", t=now, model=self._mlabel)
            TRACER.annotate(req.id, "terminal", t=now, outcome="shed",
                            retry_after_s=round(retry, 3))
            TRACER.finish(req.id, status="shed")
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
        stream gets a final "cancelled" event. An id that matches no
        request yet (the cancel raced ahead of its submit) is kept for
        ``_CANCEL_TTL_S``, so the late request is still dropped."""
        with self._lock:
            self._cancelled[request_id] = time.perf_counter()
            self._lock.notify_all()

    _CANCEL_TTL_S = 300.0  # unmatched cancel ids expire (leak bound)

    def _purge_expired_cancels(self, now: float) -> int:
        """Drop cancel ids older than ``_CANCEL_TTL_S``; returns how many
        expired. Caller holds self._lock. Called from the sweep and from
        the idle wait in ``_loop`` (an idle engine runs no sweep)."""
        expired = [r for r, t in self._cancelled.items()
                   if now - t > self._CANCEL_TTL_S]
        for r in expired:
            del self._cancelled[r]
        return len(expired)

    def _count_cancels(self, reason: str, n: int) -> None:
        if n:
            tm.ENGINE_CANCELLATIONS.labels(model=self._mlabel,
                                           reason=reason).inc(n)

    def _retry_after_s(self) -> float:
        """Backoff hint for shed requests: with cost scheduling on, the
        predicted drain of the queue (``_predicted_drain_s``); else the
        p90 of recent admission queue waits (1 s with none), clamped to
        [0.5, 30] s. Caller holds self._lock."""
        drain = self._predicted_drain_s()
        if drain is not None:
            return drain
        ws = sorted(self._queue_waits)
        if not ws:
            return 1.0
        p90 = ws[min(len(ws) - 1, int(0.9 * len(ws)))]
        return min(30.0, max(0.5, p90))

    def _predicted_drain_s(self) -> Optional[float]:
        """Predicted seconds until the queue drains: per queued request
        its predicted prefill (per-token rate x prompt length) and
        decode (per-step rate x token budget), spread over the slots and
        clamped to [0.5, 30] s. None when cost scheduling is off or the
        cost model has no rate yet. Caller holds self._lock."""
        if not self._cost_sched_on():
            return None
        cm = self._costmodel
        tok_ms = cm.prefill_token_ms()
        step_ms = self._step_ms if self._step_ms > 0.0 \
            else cm.decode_step_ms()
        if tok_ms is None and step_ms is None:
            return None
        total_ms = 0.0
        for req, _ in self._pending:
            if tok_ms is not None:
                total_ms += tok_ms * len(req.prompt_ids)
            if step_ms is not None:
                total_ms += step_ms * max(0, req.max_tokens)
        return min(30.0, max(0.5, total_ms / 1e3 / max(1, self.n_slots)))

    # ------------------------------------------------------ cost scheduling

    def _cost_sched_on(self) -> bool:
        """Whether predicted device time drives admission and deadline
        decisions (independent of the ITL packing budget)."""
        return (self._costmodel is not None
                and knobs.flag("LOCALAI_COST_SCHED"))

    def _itl_budget_ms(self) -> float:
        """The ITL budget cost scheduling packs against, in ms; 0.0 (no
        packing) when cost scheduling is off, the cost model is absent
        or no budget is set."""
        if not self._cost_sched_on():
            return 0.0
        return max(0.0, knobs.float_("LOCALAI_ITL_BUDGET_MS"))

    @property
    def _half_k(self) -> int:
        """The largest power of two <= decode_steps // 2 (floor 4): the
        JAX engine's half-length scan, one of its warmed ks."""
        h = max(self.decode_steps // 2, 4)
        while h & (h - 1):
            h &= h - 1
        return h

    @property
    def _warm_ks(self) -> set:
        """The decode lengths an ITL clamp may pick (the JAX engine's
        warmed scan lengths)."""
        return {k for k in (1, 2, 4, 8, 16) if k <= self.decode_steps} | {
            self._half_k, self.decode_steps}

    def _itl_k(self, k: int) -> int:
        """Clamp a decode step's k under an ITL budget: the tokens of a
        k-step dispatch surface together, so k x step ms is the stream's
        inter-token gap. The largest of ``_warm_ks`` above 1 that fits,
        else the smallest above 1 (progress beats stalling). Step ms is
        the measured EWMA, else the cost model's prediction."""
        budget = self._itl_budget_ms()
        if budget <= 0.0:
            return k
        step = self._step_ms if self._step_ms > 0.0 \
            else (self._costmodel.decode_step_ms() or 0.0)
        if step <= 0.0:
            return k
        fits = [kk for kk in self._warm_ks if kk > 1 and kk * step <= budget]
        return min(k, max(fits) if fits
                   else min(kk for kk in self._warm_ks if kk > 1))

    def _note_step_ms(self, step: float) -> None:
        """Fold one measured device ms per decode step into the EWMA
        (0.8 / 0.2; a sample 8x the estimate or more is an outlier)."""
        if step > 0.0 and (self._step_ms == 0.0
                           or step < 8.0 * self._step_ms):
            self._step_ms = (step if self._step_ms == 0.0
                             else 0.8 * self._step_ms + 0.2 * step)

    def _cost_bucket(self, prefilling: list[_Slot], decoding: list[_Slot],
                     cover: int, budget_ms: float) -> int:
        """A mixed step's token bucket under an ITL budget: the largest
        candidate <= ``cover`` (the token-budget pick) whose predicted
        device time fits ``budget_ms``; else the smallest predicted
        candidate; else ``cover``. Each candidate's cost row is this
        composition's at that bucket, keyed by the variant's padded
        shape."""
        cm = self._costmodel
        R = self._bucket(len(prefilling) + len(decoding))
        fit = smallest = None
        for b in self._mixed_buckets:
            if b > cover:
                break
            key = costmodel.dispatch_key("mixed", {"shape": (R, b)})
            cm.capture(key, *self._mixed_cost(
                [(s.n_past, 1) for s in decoding]
                + [(s.n_past, min(s.n_prompt - s.n_past, b))
                   for s in prefilling], R, b))
            pred = cm.predict_ms("mixed", key)
            if pred is None:
                continue
            if smallest is None:
                smallest = b
            if pred <= budget_ms:
                fit = b
        return fit or smallest or cover

    def _mixed_cost(self, live: list[tuple[int, int]], R: int,
                    T: int) -> tuple[float, float]:
        """Analytic (FLOPs, bytes) of a mixed variant [R, T] over the
        real rows ``live`` ((position, tokens) each): the projections and
        the LM head run over every row, the draft's mirror too."""
        fl, by = self._mcost.forward(live, R, tokens=R * T)
        if self.draft is not None:
            dfl, dby = self._dcost.forward(live, 0, tokens=R * T)
            fl, by = fl + dfl, by + dby
        return fl, by

    # ------------------------------------------------------------ scheduler

    def _loop(self) -> None:
        while True:
            with self._lock:
                # a kept cancel id is not work: the wait times out to
                # age such ids out, and wakes on a submit or a stop
                while not (self._stop or self._pending
                           or any(s.active for s in self.slots)):
                    self._lock.wait(timeout=0.5)
                    if self._cancelled:
                        self._count_cancels("expired",
                                            self._purge_expired_cancels(
                                                time.perf_counter()))
                if self._stop:
                    return
            try:
                with self._step_lock:
                    self._apply_cancellations()
                    self._apply_deadlines()
                    self._admit()
                    self.step()
                    self._sample_timeline()
                    if self._pending and not any(s.active
                                                 for s in self.slots):
                        # queued work waits on something off this thread
                        # (a cold session's disk load): yield the
                        # interpreter to it instead of spinning
                        time.sleep(1e-3)
            except Exception as e:  # the loop must keep serving
                log.exception("engine step failed")
                if self._pager is not None:
                    # a wave that failed before its step lets go of the
                    # weight gate too
                    self._pager.end_admission()
                if hbm_ledger.looks_like_oom(e):
                    # the forensics first, while the state that ran out
                    # of memory is still there
                    hbm_ledger.dump_post_mortem(
                        self.state_dir, self._mlabel, e, self._ledger,
                        self._pool.stats(),
                        hbm_ledger.device_memory_stats(self.device),
                        tier_stats=(self._tier.stats()
                                    if self._tier is not None else None),
                        weight_stats=(self._pager.stats()
                                      if self._pager is not None else None))
                self._fail_all(f"engine error: {e!r}")

    def _sample_timeline(self) -> None:
        """The scheduler's counters into the flight recorder, once per
        iteration (host-held values; one ring slot each)."""
        with self._lock:
            depth = len(self._pending)
        FLIGHT.sample("queue_depth", "scheduler", depth)
        FLIGHT.sample("slots_busy", "scheduler",
                      sum(1 for s in self.slots if s.active))
        in_use = self._pool.stats().in_use
        FLIGHT.sample("kv_pages_in_use", "scheduler", in_use)
        if self._tier is not None:
            FLIGHT.sample("kv_host_pages", "scheduler",
                          self._tier.tier_pages(in_use)["host"])
        if self._pager is not None:
            # the weight tiers' pages (a promotion's hot count climbs
            # with its commit cursor)
            for tname, v in self._pager.tier_pages().items():
                FLIGHT.sample("weights_" + tname, "scheduler", v)
        FLIGHT.update_gauge()

    def step(self) -> None:
        """Run one device step for the current slot states: a mixed step
        while any slot prefills; else a speculative dispatch for the
        eligible slots (when every decoding slot has ``n_draft``
        positions of context left) and a decode step for the rest. It
        ends the weight gate's hold that ``_admit`` took: the wave's
        requests are in their slots (or finished) by now."""
        try:
            prefilling = [s for s in self.slots
                          if s.state is SlotState.PREFILL]
            decoding = [s for s in self.slots
                        if s.state is SlotState.DECODE]
            if prefilling:
                self._mixed_step(prefilling, decoding)
                return
            mode, elig = self._spec_mode(decoding)
            # near the context's end a verify forward's n_draft writes
            # would run past it: then every slot takes the normal step
            if mode and min(self.max_seq - 1 - s.n_past
                            for s in decoding) >= self.n_draft:
                self._spec_decode_step(elig, mode)
                decoding = [s for s in decoding
                            if s.state is SlotState.DECODE
                            and s not in elig]
            if decoding:
                self._decode_step(decoding)
        finally:
            if self._pager is not None:
                self._pager.end_admission()

    def _fail_all(self, msg: str) -> None:
        for s in self.slots:
            if s.active and s.request is not None:
                # the trace commits before the terminal stream event, so
                # a consumer woken by it sees the final status
                self._trace_terminal(s.request.id, "error", detail=msg)
            if s.active and s.out is not None:
                s.out.put(StreamEvent(done=True, finish_reason="error",
                                      error=msg))
            if s.active:
                self._release(s)
        with self._lock:
            pending, self._pending = self._pending, []
        for req, out in pending:
            _release_handoff(req)
            self._trace_terminal(req.id, "error", detail=msg)
            out.put(StreamEvent(done=True, finish_reason="error", error=msg))

    def _trace_terminal(self, rid: str, outcome: str, **attrs) -> None:
        """Close a request's trace: the "done" milestone, a "terminal"
        span event with the outcome, the entry into the ring."""
        TRACER.event(rid, "done", model=self._mlabel)
        TRACER.annotate(rid, "terminal", outcome=outcome, **attrs)
        TRACER.finish(rid, status=outcome)

    def _apply_cancellations(self) -> None:
        """Cancel the queued and running requests whose ids were
        cancelled, deleting only the ids that matched; ids past
        ``_CANCEL_TTL_S`` expire."""
        with self._lock:
            if not self._cancelled:
                return
            expired = self._purge_expired_cancels(time.perf_counter())
            ids = self._cancelled
            keep, dropped = [], 0
            for req, out in self._pending:
                if req.id in ids:
                    del ids[req.id]
                    self._deferred.pop(req.id, None)
                    _release_handoff(req)
                    self._trace_terminal(req.id, "cancelled",
                                         stage="queued")
                    out.put(StreamEvent(done=True, finish_reason="cancelled"))
                    dropped += 1
                else:
                    keep.append((req, out))
            self._pending = keep
        self._count_cancels("expired", expired)
        self._count_dropped(dropped)
        for s in self.slots:
            if s.active and s.request is not None and s.request.id in ids:
                with self._lock:
                    ids.pop(s.request.id, None)
                self._finish(s, "cancelled")

    def _count_dropped(self, n: int) -> None:
        """Queued requests cancelled before they took a slot."""
        if n:
            tm.ENGINE_REQUESTS.labels(model=self._mlabel,
                                      reason="cancelled").inc(n)
            self._count_cancels("client", n)

    def _apply_deadlines(self) -> None:
        """Terminate requests whose deadline has passed: queued ones get
        a terminal event at once (no slot was ever held), running ones
        finish through the slot path with whatever partial text they
        produced. With cost scheduling on, a queued request whose
        predicted prefill alone (as if a slot were free now) ends past
        its deadline is refused at once (stage ``queued_predicted``): it
        could not produce a token in time. Skipped until some request
        carried a deadline."""
        if not self._deadlines_armed:
            return
        now = time.perf_counter()
        tok_ms = (self._costmodel.prefill_token_ms()
                  if self._cost_sched_on() else None)
        with self._lock:
            still = []
            for req, out in self._pending:
                if req.deadline and now >= req.deadline:
                    stage, why = "queued", "deadline exceeded while queued"
                elif (req.deadline and tok_ms is not None
                      and req.disagg is None
                      and now + tok_ms * len(req.prompt_ids) / 1e3
                      >= req.deadline):
                    # (a migrated resubmit is exempt: its prompt is in
                    # pages already, it needs no prefill)
                    stage, why = ("queued_predicted",
                                  "predicted completion exceeds deadline "
                                  "(prefill alone overruns it)")
                else:
                    still.append((req, out))
                    continue
                self._deferred.pop(req.id, None)
                _release_handoff(req)
                self._trace_terminal(req.id, "deadline_exceeded",
                                     stage=stage)
                tm.ENGINE_REQUESTS.labels(
                    model=self._mlabel, reason="deadline_exceeded").inc()
                tm.ENGINE_DEADLINE_EXCEEDED.labels(
                    model=self._mlabel, stage=stage).inc()
                out.put(StreamEvent(done=True,
                                    finish_reason="deadline_exceeded",
                                    error=why))
            self._pending = still
        for s in self.slots:
            if (s.active and s.request is not None and s.request.deadline
                    and now >= s.request.deadline):
                tm.ENGINE_DEADLINE_EXCEEDED.labels(
                    model=self._mlabel, stage=(
                        "prefill" if s.state is SlotState.PREFILL
                        else self._deadline_stage)).inc()
                self._finish(s, "deadline_exceeded")

    def _admit(self) -> None:
        if self._pager is not None:
            # work arriving while a demotion's copies fly flips its abort
            # flag (never blocks)
            self._pager.tick()
        if self._migrator is not None:
            # landed migration copies release their host pages
            self._migrator.tick()
        if self._tier is not None:
            # the tier's policy step rides the admission pass: landed
            # spills and fetches harvested (event polls), background IO
            # results applied, stale stages expired, the watermark scan
            self._tier.tick()
        with self._lock:
            pending, self._pending = self._pending, []
            # a cancel that arrived since this iteration's sweep
            hit = [p for p in pending if p[0].id in self._cancelled]
            pending = [p for p in pending if p[0].id not in self._cancelled]
            for r, _ in hit:
                del self._cancelled[r.id]
                self._deferred.pop(r.id, None)
        for req, out in hit:
            _release_handoff(req)
            self._trace_terminal(req.id, "cancelled", stage="admit")
            out.put(StreamEvent(done=True, finish_reason="cancelled"))
        self._count_dropped(len(hit))
        if not pending:
            return
        # a granted poll holds the weight gate until the wave's step ends:
        # between this pop and _assign the engine has no visible work, and
        # a demotion landing then would unmap what the step replays over
        if self._pager is not None and not self._pager.poll_admission():
            # the weights are not on the device: the poll started their
            # promotion (on the pager's thread). Requeue the wave as it
            # is and wait on the engine's condition, which the promotion
            # notifies: no spinning while the pages stream in
            with self._lock:
                self._pending[:0] = pending
                if self._pager.state != "hot" and not self._stop:
                    self._lock.wait(timeout=0.1)
            return
        if self._prefix_enabled:
            # lazy re-register: decode appends since the last wave are
            # diffed in (extension is the common case)
            # (an image request's K/V is lent to no one)
            self._prefix_index.sync(
                (s.idx, [] if s.stale_kv or _soft(s.request)
                 else s.cache_tokens)
                for s in self.slots)
        # prompts admitted but not yet prefilled: their KV is not
        # committed, so the index cannot serve them yet; same-wave
        # sharers defer one iteration behind them instead
        forming = [s.request.prompt_ids for s in self.slots
                   if s.state is SlotState.PREFILL and s.request is not None
                   and not _soft(s.request)]
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
            if req.disagg is None and self._defer_for_prefix(req, forming,
                                                             now):
                requeue.append((req, out))
                continue
            soft = _soft(req)
            if (self._tier is not None and req.disagg is None and not soft
                    and self._tier.plan(req, now)):
                # the session is in the cold tier and its disk load is
                # inside the deadline: hold admission, not re-prefill
                requeue.append((req, out))
                continue
            slot = self._pick_slot(req)
            if slot is None or budget < need:
                requeue.append((req, out))  # wait for a slot / pages
                continue
            budget -= need
            self._deferred.pop(req.id, None)
            if req.disagg is not None and self._migrator is not None:
                # a migrated resubmit: the prefill engine's pages are
                # staged into this pool and adopted by reference, so the
                # slot wakes in DECODE and re-prefills nothing. The
                # slot's resident prefix is spilled first (its gather
                # precedes any overwrite on the stream). When staging
                # fails the handoff is dropped and the request is
                # admitted below as a plain re-prefill
                if self._tier is not None:
                    self._tier.capture(slot, req)
                if self._migrator.assign_migrated(slot, req, out):
                    continue
            if req.disagg is not None:
                _release_handoff(req)  # idempotent
                req.disagg = None
            if self._tier is not None and not soft:
                # demote-on-reuse: spill the resident prefix this
                # assignment is about to discard (its gather precedes any
                # overwrite on the stream), then adopt a staged fetch: the
                # slot's resident prefix becomes the returning session,
                # so _assign re-prefills none of it
                self._tier.capture(slot, req)
                self._tier.adopt(slot, req)
            self._assign(slot, req, out, now)
            if not soft:
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
        if not self._prefix_enabled or _soft(req):
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
                tm.ENGINE_PREFIX_COPIES.labels(model=self._mlabel).inc()
            else:
                best = full * P  # no page for the tail: share only
        self._prefix_index.touch(donor, now)
        slot.cache_tokens = list(req.prompt_ids[:best])
        slot.n_past = best
        return best, max(0, best - common)

    def _assign(self, slot: _Slot, req: GenRequest, out: queue.SimpleQueue,
                now: float) -> None:
        TRACER.event(req.id, "admit", t=now, model=self._mlabel)
        wait = max(0.0, now - req.t_submit)
        self._queue_waits.append(wait)
        tm.ENGINE_QUEUE_WAIT.labels(model=self._mlabel).observe(wait)
        slot.cache_loaded = None
        if _soft(req):
            # image-conditioned K/V: no token-id prefix is reused (the
            # image-token ids are the same for every image)
            common = gained = disk = 0
        else:
            common = common_prefix_len(slot.cache_tokens, req.prompt_ids)
            common, gained = self._maybe_prefix_copy(slot, req, common)
            # the on-disk cache can still beat a resident or copied
            # prefix: it is restored only when its prefix is longer (a
            # restore that fails past its drop leaves the slot empty:
            # common is re-read)
            disk = common
            self._try_load_prompt_cache(slot, req)
            common = common_prefix_len(slot.cache_tokens, req.prompt_ids)
            disk = max(0, common - disk)
            if common == len(req.prompt_ids):
                # the last prompt token runs again for its logits
                common -= 1
        # reuse by source, clamped so the three sum to common
        disk = min(disk, common)
        copied = min(gained, common - disk)
        for source, n in (("resident", common - disk - copied),
                          ("copy", copied), ("disk", disk)):
            if n:
                tm.ENGINE_PREFIX_REUSED_TOKENS.labels(
                    model=self._mlabel, source=source).inc(n)
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

    # ------------------------------------------------- on-disk prompt cache

    def _try_load_prompt_cache(self, slot: _Slot, req: GenRequest) -> str:
        """Restore a saved prompt's K/V rows into the slot when the file's
        token prefix beats the slot's current one (resident or copied).
        The rows go into fresh private pages of the live arena by an
        indexed copy, in place: every captured graph holds the arena's
        addresses, so the arena is never rebound. Every outcome is
        counted in ``engine_prompt_cache_restores_total{result}``; returns
        it ("unset" when the request names no file: not counted)."""
        path = req.prompt_cache_path
        if not path:
            return "unset"

        def done(result: str) -> str:
            tm.ENGINE_PROMPT_CACHE_RESTORES.labels(
                model=self._mlabel, result=result).inc()
            return result

        if self.draft is not None:
            return done("skipped_draft")  # the draft arena would be stale
        if not os.path.exists(path):
            return done("no_file")
        c = self.cache
        try:
            data = read_cache_file(path)
            cached = [int(t) for t in data["tokens"]]
            L, _, P, F = c.k.shape
            k_all, v_all = data["k"], data["v"]
            # a file of another model or cache dtype is ignored
            if (k_all.shape[0] != L or k_all.shape[2] != F
                    or v_all.shape != k_all.shape):
                return done("shape_mismatch")
            if c.quantized != (k_all.dtype == np.int8) or (
                    c.quantized and "k_scale" not in data):
                return done("dtype_mismatch")
            common = common_prefix_len(cached, req.prompt_ids)
            if common <= common_prefix_len(slot.cache_tokens,
                                           req.prompt_ids):
                return done("stale")
            n = min(common, len(cached), self.max_seq - 1, k_all.shape[1])
            # the slot's rows are replaced wholesale: its pages (shared
            # or pinned ones included) go back to the pool, which hands
            # out fresh private pages
            self._pool.drop(slot.idx)
            slot.cache_tokens = []
            slot.n_past = 0
            if not self._pool_ensure(slot, n):
                return done("error")
            table = self._pool.table(slot.idx)
            npg = len(table)
            idx = torch.tensor(table, dtype=torch.long, device=self.device)

            def paged(a, like: torch.Tensor) -> torch.Tensor:
                """File rows [L, n, ...] as the slot's pages [L, npg, P,
                ...] on the device in the arena's dtype (zero past n)."""
                out = torch.zeros((L, npg, P) + like.shape[3:],
                                  dtype=like.dtype, device=self.device)
                out.view((L, npg * P) + like.shape[3:])[:, :n].copy_(
                    torch.from_numpy(np.asarray(a[:, :n])))
                return out

            with torch.inference_mode():
                c.k.index_copy_(1, idx, paged(k_all, c.k))
                c.v.index_copy_(1, idx, paged(v_all, c.v))
                if c.quantized:
                    c.k_scale.index_copy_(1, idx,
                                          paged(data["k_scale"], c.k_scale))
                    c.v_scale.index_copy_(1, idx,
                                          paged(data["v_scale"], c.v_scale))
        except Exception as e:  # unreadable or incompatible: prefill
            log.warning("prompt cache %s unusable: %r", path, e)
            return done("error")
        slot.cache_tokens = cached[:n]
        slot.n_past = n
        slot.cache_loaded = (path, n)
        if self._prefix_enabled:
            self._prefix_index.set_tokens(slot.idx, slot.cache_tokens)
        return done("restored")

    @torch.inference_mode()
    def _maybe_save_prompt_cache(self, slot: _Slot) -> None:
        """Persist the finishing slot's prefix rows (the prompt's, or with
        ``prompt_cache_all`` every written position): gathered from its
        pages on the engine's stream now, before ``_release`` can hand
        them on, then moved to the host and written by a background
        thread, whose copy waits on an event recorded after the gather."""
        req = slot.request
        if (req is None or not req.prompt_cache_path or req.prompt_cache_ro
                or _soft(req)):
            return
        n = slot.n_past if req.prompt_cache_all else min(slot.n_past,
                                                        slot.n_prompt)
        if n <= 0 or slot.cache_loaded == (req.prompt_cache_path, n):
            return  # nothing to save, or the file holds exactly this
        c = self.cache
        L, _, P, F = c.k.shape
        tbl = torch.tensor(self._pool.table(slot.idx)[:-(-n // P)],
                           dtype=torch.long, device=self.device)
        rows = [c.k[:, tbl].reshape(L, -1, F)[:, :n],
                c.v[:, tbl].reshape(L, -1, F)[:, :n]]
        if c.quantized:
            rows += [t[:, tbl].reshape(L, -1)[:, :n]
                     for t in (c.k_scale, c.v_scale)]
        gathered = self._copy_event()
        tokens = np.asarray(slot.cache_tokens[:n], np.int32)
        path, dev = req.prompt_cache_path, self.device

        def persist() -> None:
            try:
                if gathered is not None:  # on a card: a side stream
                    side = torch.cuda.Stream(dev)
                    with torch.cuda.stream(side):
                        side.wait_event(gathered)
                        host = [t.to("cpu") for t in rows]
                else:
                    host = rows
                host = [t.float().numpy() if t.dtype not in (
                    torch.int8, torch.float32) else t.numpy() for t in host]
                write_cache_file(path, tokens, host[0], host[1],
                                 tuple(host[2:]) or None)
            except OSError as e:  # persistence is best-effort
                log.warning("prompt cache %s not written: %r", path, e)

        threading.Thread(target=persist, daemon=True,
                         name="prompt-cache-save").start()

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
        under pool pressure (demoted to the KV tier first, when there is
        one). False: the pool is full of active state."""
        if faultinject.ACTIVE:
            # the stand-in for a device out-of-memory during KV growth:
            # the scheduler's catch writes the post-mortem and fails the
            # active slots
            faultinject.fire("engine.hbm_alloc")
        return self._ensure_pages(slot.idx, n_tokens, slot)

    def _ensure_pages(self, pid: int, n_tokens: int,
                      keep: Optional[_Slot] = None) -> bool:
        """Grow pool table ``pid`` (a slot's, or a staging pseudo-slot's)
        to cover ``n_tokens`` positions, reclaiming free slots' resident
        prefixes other than ``keep``'s, least valuable first. False: the
        pool is full of active state."""
        try:
            self._pool.ensure(pid, n_tokens)
            return True
        except PagePoolExhausted:
            pass
        now = time.monotonic()
        victims = sorted(
            (s for s in self.slots
             if not s.active and s is not keep and self._pool.held(s.idx)),
            key=lambda s: self._prefix_index.value(s.idx, now))
        for v in victims:
            if self._tier is not None:
                # the gather is enqueued before the drop below: the
                # reclaim demotes the resident to host memory instead of
                # discarding it (a spill fault leaves a plain drop)
                self._tier.demote_urgent(v)
            self._pool.drop(v.idx)
            v.cache_tokens = []
            v.n_past = 0
            self._prefix_index.remove(v.idx)
            try:
                self._pool.ensure(pid, n_tokens)
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
        """``_table_rows`` on the device."""
        pt, wt = self._table_rows(rows, spans)
        return (torch.from_numpy(pt).to(self.device),
                torch.from_numpy(wt).to(self.device))

    def _table_rows(self, rows: list[_Slot], spans: list[tuple[int, int]]
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Read tables (each row's pages, trash beyond) and write tables
        (the pages of each row's write span [start, end), trash
        elsewhere), [B, max_pages] int32 on the host."""
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
        return pt, wt

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

    def _reset_cols(self, req: GenRequest) -> list:
        """A request's per-slot sampler values, in ``smp.RESET_FIELDS``
        order (``repeat_last_n`` clamped to the window)."""
        W = self.sampling.window
        return [req.temperature, req.top_k, req.top_p, req.min_p,
                req.repeat_penalty, req.frequency_penalty,
                req.presence_penalty,
                min(req.repeat_last_n if req.repeat_last_n > 0 else 64, W),
                req.typical_p, req.mirostat, req.mirostat_tau,
                req.mirostat_eta]

    def _reset_sampler(self, finals: list[_Slot]) -> None:
        """Sampler reset + prompt-tail penalty seed for slots whose first
        token is sampled in this step (the eager mixed step's), through
        the graph's ``reset_rows`` and its column layout."""
        W = self.sampling.window
        tails = np.zeros((len(finals), W), np.int32)
        lens = []
        for r, s in enumerate(finals):
            tail = s.request.prompt_ids[-W:]
            tails[r, :len(tail)] = tail
            lens.append(len(tail))
        ids = self._ints([s.idx for s in finals])
        smp.reset_rows(self.sampling, ids, torch.tensor(
            [self._reset_cols(s.request) for s in finals],
            dtype=torch.float32, device=self.device).T)
        smp.reseed(self.sampling, [s.idx for s in finals],
                   [s.request.seed for s in finals])
        smp.seed_windows(self.sampling, ids,
                         torch.from_numpy(tails).to(self.device),
                         self._ints(lens))

    @torch.inference_mode()
    def _mixed_step(self, prefilling: list[_Slot],
                    decoding: list[_Slot]) -> None:
        """One forward over decode rows (one token each) and prefill
        chunks at the step's token bucket (the JAX chunk rule, shrunk by
        ``_cost_bucket`` under an ITL budget while decode rows ride);
        samples the decode rows' next tokens and the final rows' first
        tokens. On a card it is one replay of its mixed variant's graph
        (``_mixed_graph``)."""
        t0 = time.perf_counter()
        last = self._mixed_buckets[-1]
        decoding = [s for s in decoding if self._ensure(s, s.n_past + 1)]
        prefilling = [s for s in prefilling if self._ensure(
            s, s.n_past + min(s.n_prompt - s.n_past, last))]
        if not prefilling:
            return  # the composition changed: the next iteration re-plans
        need = min(max(s.n_prompt - s.n_past for s in prefilling), last)
        T = next(b for b in self._mixed_buckets if b >= need)
        budget = self._itl_budget_ms()
        if budget > 0.0 and decoding:
            T = self._cost_bucket(prefilling, decoding, T, budget)
            self.cost_buckets[T] = self.cost_buckets.get(T, 0) + 1
        rows = sorted(decoding + prefilling, key=lambda s: s.idx)
        chunks = [[s.generated[-1]] if s.state is SlotState.DECODE
                  else s.request.prompt_ids[
                      s.n_past: s.n_past + min(s.n_prompt - s.n_past, T)]
                  for s in rows]
        q_lens = [len(c) for c in chunks]
        finals = [s for s, n in zip(rows, q_lens) if s.state is
                  SlotState.PREFILL and s.n_past + n == s.n_prompt]
        samplers = [s for s in rows if s.state is SlotState.DECODE
                    or s in finals]
        R = self._bucket(len(rows))
        self.metrics.mixed_tokens += sum(q_lens)
        self.metrics.mixed_pad_tokens += R * T - sum(q_lens)
        key = costmodel.dispatch_key("mixed", {"shape": (R, T)})
        pred = None
        if self._costmodel is not None:
            pred = self._cost_row("mixed", key, *self._mixed_cost(
                [(s.n_past, n) for s, n in zip(rows, q_lens)], R, T))
        self._device_fault()
        self._span.start()
        tok = self._mixed_graph(rows, chunks, finals, samplers, T)
        t_disp = time.perf_counter()
        for s in finals:
            TRACER.event(s.request.id, "prefill_dispatch", t=t_disp)
        self.metrics.forward_steps += 1
        self.metrics.mixed_steps += 1
        if self.draft is not None:
            self.metrics.draft_forwards += 1
        tok_host: list[int] = []
        if samplers:
            self._span.stop()
            tok_host = tok.tolist()
            self._harvest("mixed", key, pred, t0, {
                "decode": len(decoding),
                "prefill": len(prefilling) - len(finals),
                "finals": len(finals), "chunk_tokens": sum(q_lens)})
        elif self._costmodel is not None:  # no host read: no span
            self._costmodel.on_dispatch("mixed", key)
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
                tm.ENGINE_PREFILL.labels(model=self._mlabel).observe(
                    s.t_prefill_ms / 1e3)
                tm.ENGINE_PROMPT_TOKENS.labels(model=self._mlabel).inc(
                    s.n_prompt)
                self._emit_token(s, tok)
            else:
                s.cache_tokens.append(s.generated[-1])  # its KV landed
                s.n_past += 1
                s.t_decode_ms += (now - t0) * 1e3
                self._emit_token(s, tok, defer=True)
                if s.state is SlotState.DECODE:
                    self._flush_emit(s)

    def _mixed_eager(self, rows: list[_Slot], chunks: list[list[int]],
                     finals: list[_Slot], samplers: list[_Slot],
                     T: int) -> torch.Tensor:
        """The mixed step as eager forwards over exactly ``rows`` at their
        longest chunk (no padding to T; tests and the chip smoke plant it
        on an instance in place of ``_mixed_graph``); the samplers'
        tokens on the device."""
        width = max(len(c) for c in chunks)
        toks = np.zeros((len(rows), width), np.int32)
        for r, c in enumerate(chunks):
            toks[r, :len(c)] = c
        q_lens = [len(c) for c in chunks]
        pos0 = [s.n_past for s in rows]
        pt, wt = self._tables(rows, [(p, p + n) for p, n in zip(pos0, q_lens)])
        self._fill_mask(samplers)
        mask = self._mask_dev[:len(samplers)] if self._masked(samplers) \
            else None
        ql = self._ints(q_lens)
        toks_d = torch.from_numpy(toks).to(self.device)
        pos_d = self._ints(pos0)
        entries = self._soft_payload(rows, chunks)
        soft = None
        if entries:
            self.metrics.soft_steps += 1
            soft = (torch.cat([rows[r].request.soft_embeds[
                        torch.from_numpy(idx).to(self.device)]
                               for r, idx, _ in entries]),
                    self._ints([r for r, idx, _ in entries for _ in idx]),
                    self._ints(np.concatenate([p for _, _, p in entries])))
        hidden, _ = forward_hidden(
            self.spec, self.params, toks_d, pos_d, self.cache, None,
            page_table=pt, kv_page=self.page, q_lens=ql, write_table=wt,
            soft=soft)
        if self.draft is not None:
            forward_hidden(*self.draft, toks_d, pos_d, self.draft_cache,
                           None, page_table=pt, kv_page=self.page,
                           q_lens=ql, write_table=wt)
        if not samplers:
            return ql[:0]
        if finals:
            self._reset_sampler(finals)
        sel = self._ints([rows.index(s) for s in samplers]).long()
        last = hidden[sel, ql.long()[sel] - 1]  # each row's last token
        logits = _lm_head(self.spec, self.params, last[:, None])[:, 0]
        return self._sample(samplers, logits, mask)

    def _mixed_graph(self, rows: list[_Slot], chunks: list[list[int]],
                     finals: list[_Slot], samplers: list[_Slot],
                     T: int) -> torch.Tensor:
        """The mixed step through its variant [row bucket, T] (a CUDA-graph
        replay on a card); the samplers' tokens on the device."""
        v = self._mixed_variant(self._bucket(len(rows)), T)
        self._mixed_fill(v, rows, chunks, finals, samplers)
        self._mixed_launch(v)
        return v.out.index_select(0, torch.tensor(
            [rows.index(s) for s in samplers], dtype=torch.long,
            device=self.device))

    def _mixed_fill(self, v: _MixedVariant, rows: list[_Slot],
                    chunks: list[list[int]], finals: list[_Slot],
                    samplers: list[_Slot]) -> None:
        """A mixed step's inputs into v's static buffers: the int32 fields
        in one transfer (pad rows: trash page, q_len 1, the sentinel as
        sampler and reset row), the finals' reset columns in another.
        The finals' generators are reseeded before the samplers' Gumbel
        noise is drawn, as the eager step does; then the step's masks.
        The staging is rewritten only once its last copies have run
        (``_await_copy``): a step with no sampler reads nothing back, so
        the next may be filled while this one's copy still queues."""
        self._await_copy(v.copied)
        R, W = v.rows, self.sampling.window
        h, cols = v.h, v.fhost.numpy()
        pos0 = [s.n_past for s in rows]
        q_lens = [len(c) for c in chunks]
        pt, wt = self._table_rows(rows, [(p, p + n)
                                         for p, n in zip(pos0, q_lens)])
        B = len(rows)
        h["pt"][:], h["wt"][:] = TRASH_PAGE, TRASH_PAGE
        h["pt"][:B], h["wt"][:B] = pt, wt
        h["toks"][:] = 0
        h["pos0"][:] = 0
        h["q_lens"][:] = 1
        h["sids"][:] = h["rsids"][:] = self._pad_sid
        h["tail_lens"][:] = 0
        h["tails"][:] = 0
        h["pos0"][:B], h["q_lens"][:B] = pos0, q_lens
        for r, (s, c) in enumerate(zip(rows, chunks)):
            h["toks"][r, :len(c)] = c
            if s in samplers:
                h["sids"][r] = s.idx
            if s in finals:
                tail = s.request.prompt_ids[-W:]
                h["rsids"][r] = s.idx
                h["tails"][r, :len(tail)] = tail
                h["tail_lens"][r] = len(tail)
                cols[:, r] = self._reset_cols(s.request)
        if v.soft is not None:
            # the chunk's soft rows, copied on the device; pad entries
            # point at batch row R, which the scatter drops
            h["sbrow"][:v.n_soft], h["sbpos"][:v.n_soft] = R, 0
            off = 0
            for r, idx, pos in self._soft_payload(rows, chunks):
                k = len(idx)
                h["sbrow"][off:off + k], h["sbpos"][off:off + k] = r, pos
                v.soft[off:off + k].copy_(rows[r].request.soft_embeds[
                    torch.from_numpy(idx).to(self.device)])
                off += k
            v.n_soft = off
            if off:
                self.metrics.soft_steps += 1
        v.ints.copy_(v.host, non_blocking=True)
        v.cols.copy_(v.fhost, non_blocking=True)
        v.copied = self._copy_event()
        smp.reseed(self.sampling, [s.idx for s in finals],
                   [s.request.seed for s in finals])
        noise = self._noise(samplers) if samplers else None
        if noise is not None:
            v.noise.zero_()
            v.noise.index_copy_(0, torch.tensor(
                [rows.index(s) for s in samplers], dtype=torch.long,
                device=self.device), noise)
            v.noisy = True
        elif v.noisy:
            v.noise.zero_()
            v.noisy = False
        self._fill_mask([s if s in samplers else None for s in rows])

    def _mixed_body(self, v: _MixedVariant) -> None:
        """One mixed step over v's buffers, what a mixed graph holds: the
        forward (and the draft's mirror under the same tables), the
        finals' sampler reset and penalty-window seed, each row's last
        real token (a fixed-size gather) through the LM head, and a
        sample under the static mask. A multimodal variant's soft rows
        replace their positions' embeddings (the scatter is in the
        graph)."""
        f = v.f
        hidden, _ = forward_hidden(
            self.spec, self.params, f["toks"], f["pos0"], self.cache, None,
            page_table=f["pt"], kv_page=self.page, q_lens=f["q_lens"],
            write_table=f["wt"], soft=None if v.soft is None
            else (v.soft, f["sbrow"], f["sbpos"]))
        if self.draft is not None:
            # the draft mirrors every row's K/V under the target's write
            # table: the prompt chunks, and a decode row's token, whose
            # position the next spec round (from n_past + 1) never writes
            forward_hidden(*self.draft, f["toks"], f["pos0"],
                           self.draft_cache, None, page_table=f["pt"],
                           kv_page=self.page, q_lens=f["q_lens"],
                           write_table=f["wt"])
        smp.reset_rows(self.sampling, f["rsids"], v.cols)
        smp.seed_windows(self.sampling, f["rsids"], f["tails"],
                         f["tail_lens"])
        last = hidden[v.at, f["q_lens"].long() - 1]
        logits = _lm_head(self.spec, self.params, last[:, None])[:, 0]
        tok, _ = smp.sample(self.sampling, f["sids"], logits,
                            mask=self._mask_dev[:v.rows], noise=v.noise)
        v.out.copy_(tok)
        v.logits = logits

    def _mixed_launch(self, v: _MixedVariant) -> None:
        """One mixed step of variant v: a replay of its graph on a card
        (adding its capture's kernel launches to the counts), the body
        run eagerly on the CPU."""
        if v.graph is None:
            self._mixed_body(v)
            return
        v.graph.replay()
        self.metrics.mixed_replays += 1
        if v.n_soft:
            self.metrics.soft_replays += 1
        for f in COUNTED:
            f.launches += v.launches[f.__name__]

    def _mixed_variant(self, R: int, T: int) -> _MixedVariant:
        """The mixed variant [R, T], made and captured at its first use."""
        v = self._mixed_variants.get((R, T))
        if v is None:
            v = self._new_mixed(R, T)
            self._capture(v, self._mixed_body)
            self._mixed_variants[(R, T)] = v
        return v

    def _soft_payload(self, rows: list[_Slot], chunks: list[list[int]]
                      ) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """The soft rows of a mixed step: (batch row, the request's soft
        row indices, their positions in the chunk) for each prefill row
        whose chunk holds soft positions (the JAX ``_soft_payload``)."""
        out = []
        for r, (s, c) in enumerate(zip(rows, chunks)):
            if s.state is not SlotState.PREFILL or not _soft(s.request):
                continue
            sp = s.request.soft_positions
            sel = np.nonzero((sp >= s.n_past) & (sp < s.n_past + len(c)))[0]
            if len(sel):
                out.append((r, sel, sp[sel] - s.n_past))
        return out

    def _new_mixed(self, R: int, T: int) -> _MixedVariant:
        """Static buffers of a mixed variant [R, T] (on a multimodal
        engine with R * T soft entries), every row a pad row and every
        soft entry dropped."""
        dev = self.device
        cuda = dev.type == "cuda"
        fields = _mixed_fields(R, T, self._max_pages, self.sampling.window,
                               self.multimodal)
        n = sum(int(np.prod(shape)) for _, shape in fields)
        host = torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
        h = {k: t.numpy() for k, t in _carve(host, fields).items()}
        h["sbrow"][:] = R
        h["pt"][:], h["wt"][:] = TRASH_PAGE, TRASH_PAGE
        h["q_lens"][:] = 1
        h["sids"][:] = h["rsids"][:] = self._pad_sid
        fhost = torch.zeros((len(smp.RESET_FIELDS), R), dtype=torch.float32,
                            pin_memory=cuda)
        ints = torch.empty_like(host, device=dev).copy_(host)
        return _MixedVariant(
            rows=R, T=T, host=host, h=h, ints=ints,
            f=_carve(ints, fields), fhost=fhost,
            cols=torch.empty_like(fhost, device=dev).copy_(fhost),
            noise=torch.zeros((R, min(smp.CAND, self.spec.vocab_size)),
                              device=dev),
            at=torch.arange(R, device=dev),
            out=torch.zeros(R, dtype=torch.int32, device=dev),
            soft=(self._soft_rows[:R * T] if self.multimodal else None))

    def _fill_mask(self, rows: list[Optional[_Slot]]) -> None:
        """The step's sampling masks into the static device mask, row r
        for ``rows[r]`` (None, or a row with no grammar or bias: all
        True), in one transfer from pinned staging. An all-True mask is
        left as it is; a masked step's is reset when the next step has
        none. The staging is rewritten only once its last copy has run
        (``_await_copy``)."""
        live = [(r, s) for r, s in enumerate(rows) if s is not None]
        host = self._constraint_mask_rows([s for _, s in live])
        if host is None:
            if self._mask_set:
                self._mask_dev.fill_(True)
                self._mask_set = False
            return
        self._await_copy(self._mask_copied)
        if self._mask_stage is None:
            self._mask_stage = torch.empty(
                tuple(self._mask_dev.shape), dtype=torch.bool,
                pin_memory=self.device.type == "cuda")
        buf = self._mask_stage.numpy()
        buf[:] = True
        for (r, _), m in zip(live, host):
            buf[r] = m
        self._mask_dev.copy_(self._mask_stage, non_blocking=True)
        self._mask_copied = self._copy_event()
        self._mask_set = True

    def _await_copy(self, ev: Any) -> None:
        """Block the host until a pinned staging buffer's last copy to
        the card (``ev``, from ``_copy_event``) has run. A non-blocking
        copy reads the host memory only when its stream reaches it,
        which may be behind earlier replays: a staging rewritten before
        then would hand an earlier step the next step's inputs."""
        if ev is not None:
            ev.synchronize()

    def _copy_event(self) -> Any:
        """An event after the copies just queued on the current stream
        (None on the CPU, where a copy is done when it returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @torch.inference_mode()
    def _decode_step(self, decoding: list[_Slot]) -> None:
        """Up to ``decode_steps`` seeded T == 1 forwards over the decoding
        slots, sampling on the device; one host read at the end, tokens
        past a row's finish are discarded. Under an ITL budget k is
        clamped by ``_itl_k``; a masked step is one forward (its next
        mask needs the token just sampled). The rows run through their
        bucket's decode or masked decode variant (``_decode_graph``)."""
        t0 = time.perf_counter()
        k = min(self.decode_steps,
                max(s.request.max_tokens - len(s.generated) for s in decoding),
                min(self.max_seq - 1 - s.n_past for s in decoding))
        masked = self._masked(decoding)
        k = 1 if masked else self._itl_k(max(1, k))
        rows = [s for s in decoding if self._ensure(s, s.n_past + k)]
        if not rows:
            return
        B = len(rows)
        key = costmodel.dispatch_key("decodek", {
            "k": k, "bucket": self._bucket(B), "masked": masked})
        pred = None
        if self._costmodel is not None:
            fl = by = 0.0
            for i in range(k):
                f, b = self._mcost.forward([(s.n_past + i, 1) for s in rows],
                                           B)
                fl, by = fl + f, by + b
            pred = self._cost_row("decodek", key, fl, by)
        self._device_fault()
        self._span.start()
        toks = self._decode_graph(rows, k)
        self._span.stop()
        host = toks.tolist()
        span_s = self._harvest("decodek", key, pred, t0,
                               {"rows": B, "k": k})
        self._note_step_ms(span_s * 1e3 / k)
        self.metrics.forward_steps += k
        self.metrics.decode_steps += k
        dt = (time.perf_counter() - t0) * 1e3
        tm.ENGINE_INTER_TOKEN.labels(model=self._mlabel).observe(
            dt / 1e3 / k, exemplar=self._active_exemplar())
        tm.ENGINE_DECODE_STEP.labels(model=self._mlabel).observe(span_s / k)
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

    def _decode_eager(self, rows: list[_Slot], k: int) -> torch.Tensor:
        """k eager forwards over exactly ``rows`` under the step's mask
        (tests and the chip smoke plant it on an instance in place of
        ``_decode_graph``); [B, k] tokens on the device."""
        self._fill_mask(rows)
        mask = self._mask_dev[:len(rows)] if self._masked(rows) else None
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
        return torch.stack(out, 1)

    # ------------------------------------------------- compiled dispatch

    def _bucket(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    def _decode_graph(self, rows: list[_Slot], k: int) -> torch.Tensor:
        """k launches of the rows' decode variant (a CUDA-graph replay
        each on a card), or one of their masked decode variant when a
        row samples under a mask; [B, k] tokens on the device."""
        masked = self._masked(rows)
        v = self._variant(self._bucket(len(rows)), masked)
        if masked:
            self._fill_mask(rows)
        self._fill(v, rows, k)
        for _ in range(k):
            self._decode_launch(v)
        return v.out[:k, :len(rows)].T

    def _fill(self, v: _DecodeVariant, rows: list[_Slot], k: int) -> None:
        """A dispatch's inputs into v's static buffers: tables, tokens,
        positions and sampler rows in one transfer (pad rows: trash
        page, sentinel row), then the k steps' Gumbel noise, drawn as
        ``_sample`` draws it (step-major, each stochastic row from its
        slot's generator), so seeded output is the eager loop's. The
        staging is rewritten only once its last copy has run
        (``_await_copy``)."""
        self._await_copy(v.copied)
        n, B, P = v.bucket, len(rows), self._max_pages
        pt, wt = self._table_rows(rows, [(s.n_past, s.n_past + k)
                                         for s in rows])
        h = v.host.numpy()
        tables = h[:2 * n * P].reshape(2, n, P)
        tables[:] = TRASH_PAGE
        tables[0, :B], tables[1, :B] = pt, wt
        tail = h[2 * n * P:].reshape(3, n)
        tail[:2] = 0
        tail[2] = self._pad_sid
        tail[0, :B] = [s.generated[-1] for s in rows]
        tail[1, :B] = [s.n_past for s in rows]
        tail[2, :B] = [s.idx for s in rows]
        v.ints.copy_(v.host, non_blocking=True)
        v.copied = self._copy_event()
        v.step.zero_()
        if any(s.request.temperature > 0 for s in rows):
            v.noise[:k, :B] = torch.stack([self._noise(rows)
                                           for _ in range(k)])
            v.noisy = True
        elif v.noisy:
            v.noise.zero_()
            v.noisy = False

    def _decode_body(self, v: _DecodeVariant) -> None:
        """One forward and sample over v's buffers (a masked variant's
        under the static mask), chaining the next step's input on the
        device: what a decode graph holds."""
        hidden, _ = forward_hidden(
            self.spec, self.params, v.toks, v.pos, self.cache, None,
            page_table=v.pt, kv_page=self.page, q_lens=v.q_lens,
            write_table=v.wt)
        logits = _lm_head(self.spec, self.params, hidden)[:, -1]
        tok, _ = smp.sample(self.sampling, v.sids, logits,
                            mask=self._mask_dev[:v.bucket] if v.masked
                            else None,
                            noise=v.noise.index_select(0, v.step)[0])
        v.out.index_copy_(0, v.step, tok[None])
        v.toks.copy_(tok[:, None])
        v.pos.add_(1)
        v.step.add_(1)
        v.logits = logits

    def _decode_launch(self, v: _DecodeVariant) -> None:
        """One forward of variant v: a replay of its graph on a card
        (adding the kernel launches its capture recorded to the
        kernels' counts), the body run eagerly on the CPU."""
        if v.graph is None:
            self._decode_body(v)
            return
        v.graph.replay()
        self.metrics.graph_replays += 1
        self.metrics.masked_replays += v.masked
        for f in COUNTED:
            f.launches += v.launches[f.__name__]

    def _variant(self, bucket: int, masked: bool = False) -> _DecodeVariant:
        table = self._masked_variants if masked else self._variants
        v = table.get(bucket)
        if v is None:
            v = self._new_variant(bucket, masked)
            self._capture(v, self._decode_body)
            table[bucket] = v
        return v

    def _new_variant(self, n: int, masked: bool = False) -> _DecodeVariant:
        """Static buffers of a bucket of n rows, every row a pad row (a
        masked variant holds one step)."""
        P, dev = self._max_pages, self.device
        cuda = dev.type == "cuda"
        steps = 1 if masked else self.decode_steps
        host = torch.full((2 * n * P + 3 * n,), TRASH_PAGE,
                          dtype=torch.int32, pin_memory=cuda)
        host[2 * n * P:] = 0
        host[2 * n * P + 2 * n:] = self._pad_sid
        ints = torch.empty_like(host, device=dev).copy_(host)
        tables = ints[:2 * n * P].view(2, n, P)
        tail = ints[2 * n * P:].view(3, n)
        return _DecodeVariant(
            bucket=n, host=host, ints=ints, pt=tables[0], wt=tables[1],
            toks=tail[0].view(n, 1), pos=tail[1], sids=tail[2],
            q_lens=torch.ones(n, dtype=torch.int32, device=dev),
            noise=torch.zeros((steps, n,
                               min(smp.CAND, self.spec.vocab_size)),
                              device=dev),
            step=torch.zeros(1, dtype=torch.long, device=dev),
            out=torch.zeros((steps, n), dtype=torch.int32, device=dev),
            masked=masked)

    def _capture(self, v: Any, body: Any) -> None:
        """Ready variant v (decode, mixed or speculative) for ``body(v)``:
        one eager all-pad run (it writes only the trash pages and the
        sentinel sampler row); on a card that run is the warm-up of the capture
        stream (the kernels built, cuBLAS's workspace and B1's merge
        counters allocated) before the graph is captured on it into the
        engine's graph pool. A failed capture raises. The pad runs are
        not traffic: the kernels' launch counts are restored afterwards,
        and ``v.launches`` keeps what one replay launches."""
        counts = {f: f.launches for f in COUNTED}
        try:
            if self.device.type != "cuda":
                body(v)
                return
            s = _capture_stream(self.device)
            with _capture_lock, rpa.own_merge_counters(self._merge_counters):
                s.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(s):
                    body(v)
                torch.cuda.current_stream(self.device).wait_stream(s)
                mid = {f: f.launches for f in COUNTED}
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=self._graph_pool, stream=s,
                                      capture_error_mode="thread_local"):
                    body(v)
            v.launches = {f.__name__: f.launches - mid[f] for f in COUNTED}
            v.graph = g
            self._graph_pool_bytes = self._pool_bytes()
        finally:
            for f, n in counts.items():
                f.launches = n

    def variant_count(self) -> int:
        """Dispatch variants made so far (decode, masked decode, mixed,
        speculative)."""
        return (len(self._variants) + len(self._masked_variants)
                + len(self._mixed_variants) + len(self._spec_variants))

    def _pool_bytes(self) -> int:
        """Bytes of the segments the caching allocator holds for the
        graph pool (allocator state: no device sync)."""
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    @torch.inference_mode()
    def warmup(self) -> None:
        """Capture every dispatch variant before serving (call it before
        the first request), each from an all-pad dispatch — every row on
        the trash page and the sampler's sentinel row — so no capture
        lands mid-request: the mixed variants, largest first (later
        captures reuse the pool's segments), then with a draft the
        speculative variants (``spec_s`` and ``spec`` per row bucket and
        rounds, largest first), then per row bucket the decode and
        masked decode variants. Touches no slot. Each mixed variant's
        cost row is recorded at a nominal full composition (every row T
        tokens from position 0), a decode dispatch's (k = decode_steps,
        every row from position 0) per bucket and a speculative one's
        (every slot from position 0) per kind and rounds, so the
        predictor can cost a step before its first dispatch. Sets
        ``engine_dispatch_compile_variants_count`` and
        ``engine_warmup_seconds``. A warm engine's weights are promoted
        first and held on the device while it runs."""
        with self._weights():
            self._warmup()

    def _warmup(self) -> None:
        t0 = time.perf_counter()
        shapes = sorted(((R, T) for R in self._buckets
                         for T in self._mixed_buckets),
                        key=lambda rt: -rt[0] * rt[1])
        for R, T in shapes:
            self._mixed_variant(R, T)
            if self._costmodel is not None:
                self._costmodel.capture(
                    costmodel.dispatch_key("mixed", {"shape": (R, T)}),
                    *self._mixed_cost([(0, T)] * R, R, T))
        if self.draft is not None:
            rounds = range(self._spec_max_rounds, 0, -1)
            for R, n in sorted(((R, n) for R in self._buckets
                                for n in rounds),
                               key=lambda rn: -rn[0] * rn[1]):
                for kind in ("spec_s", "spec"):
                    self._spec_variant(kind, R, n)
            if self._costmodel is not None:
                R = self._buckets[-1]
                for kind in ("spec_s", "spec"):
                    for n in rounds:
                        self._costmodel.capture(costmodel.dispatch_key(
                            kind, {"kd": self.n_draft, "rounds": n}),
                            *self._spec_cost([0] * R, R, n))
        for b in self._buckets:
            self._variant(b)
            self._variant(b, masked=True)
            if self._costmodel is not None:
                fl, by = self._mcost.forward([(0, 1)] * b, b)
                self._costmodel.capture(costmodel.dispatch_key("decodek", {
                    "k": self.decode_steps, "bucket": b}),
                    fl * self.decode_steps, by * self.decode_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics.warmup_s = time.perf_counter() - t0
        tm.ENGINE_DISPATCH_VARIANTS.labels(model=self._mlabel).set(
            self.variant_count())
        tm.ENGINE_WARMUP_SECONDS.labels(model=self._mlabel,
                                        mode="cold").set(self.metrics.warmup_s)

    # ------------------------------------------------------- telemetry

    def _cost_row(self, kind: str, key: tuple, flops: float,
                  bytes_: float) -> Optional[float]:
        """Record the dispatch's analytic row; its predicted device ms."""
        self._costmodel.capture(key, flops, bytes_)
        return self._costmodel.predict_ms(kind, key)

    def _harvest(self, kind: str, key: tuple, pred: Optional[float],
                 t0: float, rec: dict) -> float:
        """After a dispatch's host read: its device span into the device
        step histogram and the cost model, and a ``step:<kind>`` span on
        the timeline from ``t0`` (the step's start on the host clock) to
        now, its args ``rec`` plus ``predicted_ms``/``measured_ms`` (the
        device span) where the cost model priced the dispatch; returns
        the device span (s)."""
        span_s = self._span.seconds()
        tm.ENGINE_DEVICE_STEP.labels(model=self._mlabel,
                                     kind=kind).observe(span_s)
        if pred is not None:
            rec = dict(rec, predicted_ms=round(pred, 3),
                       measured_ms=round(span_s * 1e3, 3))
        FLIGHT.span("step:" + kind, "device", t0,
                    time.perf_counter() - t0, rec)
        if self._costmodel is not None:
            self._costmodel.on_harvest(kind, key, span_s, pred)
        return span_s

    def _device_fault(self) -> None:
        """The ``engine.device_step`` injection point, ahead of every
        dispatch: a fault there takes the path of a failed dispatch (the
        scheduler's catch fails the active slots), and lands as a span
        event on the traces of the requests in the step."""
        if faultinject.ACTIVE:
            with fault_scope(s.request.id for s in self.slots
                             if s.request is not None):
                faultinject.fire("engine.device_step")

    def _active_exemplar(self) -> Optional[dict]:
        """Exemplar labels for a batch-level latency sample: the first
        active slot's trace id."""
        for s in self.slots:
            if s.active and s.request is not None and s.request.trace_id:
                return {"trace_id": s.request.trace_id}
        return None

    def update_gauges(self) -> None:
        """Refresh the scheduler and memory gauges from host-held values
        (a /metrics scrape calls it; it never syncs the device)."""
        m = self._mlabel
        with self._lock:
            depth = len(self._pending)
        active = [s for s in self.slots if s.active]
        tm.ENGINE_QUEUE_DEPTH.labels(model=m).set(depth)
        tm.ENGINE_SLOTS_BUSY.labels(model=m).set(len(active))
        tm.ENGINE_KV_UTIL.labels(model=m).set(
            sum(s.n_past for s in active) / float(self.n_slots * self.max_seq))
        in_use = self._pool.stats().in_use
        tm.ENGINE_KV_PAGES_IN_USE.labels(model=m).set(in_use)
        tier = self._tier
        if tier is not None:
            for tname, v in tier.tier_pages(in_use).items():
                tm.ENGINE_KV_TIER_PAGES.labels(model=m, tier=tname).set(v)
        pager = self._pager
        if pager is not None:
            for tname, v in pager.tier_pages().items():
                tm.ENGINE_WEIGHT_PAGES.labels(model=m, tier=tname).set(v)
        if self._ledger is not None:
            snap = self._ledger.reconcile()
            if snap["bytes_in_use"] is not None:
                tm.DEVICE_HBM_USED.labels(
                    device=str(self.device.index)).set(snap["bytes_in_use"])

    def cost_stats(self) -> Optional[dict]:
        """The cost model's summary (MFU, per-kind roofline); None when
        LOCALAI_COSTMODEL=off."""
        return (self._costmodel.stats()
                if self._costmodel is not None else None)

    def tier_stats(self) -> Optional[dict]:
        """The KV tier's counters and residency; None without a tier."""
        return self._tier.stats() if self._tier is not None else None

    def hbm_stats(self) -> Optional[dict]:
        """The HBM ledger's last snapshot; None when
        LOCALAI_HBM_LEDGER=off."""
        return (self._ledger.snapshot()
                if self._ledger is not None else None)

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
        return _lm_head(dspec, dparams, hidden)[:, -1]

    def _verify_logits(self, xin: torch.Tensor, pos: torch.Tensor,
                       pt: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        """The verify forward: ``xin [B, kd]`` as ragged rows of q_len kd
        from ``pos``; [B, kd, V] f32 logits."""
        hidden, _ = forward_hidden(
            self.spec, self.params, xin, pos, self.cache, None,
            page_table=pt, kv_page=self.page,
            q_lens=torch.full_like(pos, xin.shape[1]), write_table=wt)
        return _lm_head(self.spec, self.params, hidden)

    def _spec_draws(self, rows: list[_Slot], rounds: int, kd: int,
                    k: int) -> smp.SpecDraws:
        """The sampled dispatch's random numbers, from the rows' slot
        generators (tests replace this to pin them)."""
        return smp.spec_draws(self.sampling, [s.idx for s in rows],
                              [s.request.temperature > 0 for s in rows],
                              rounds, kd, k)

    def _greedy_rounds(self, tok, pos, pt, wt, rounds):
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

    def _sampled_rounds(self, tok, pos, pt, wt, sids, draws, rounds):
        """``rounds`` rejection-sampled rounds on the device: the draft
        samples kd tokens from its filtered q (``draws.draft``), the
        verify forward gives the filtered p at every position, and
        ``smp.spec_reject`` accepts and replaces. ``sids [B]`` are the
        rows' sampler rows. Returns drafted [rounds, B, kd - 1], the
        replacement tokens [rounds, B, kd] and j [rounds, B]."""
        kd = self.n_draft
        B = tok.shape[0]
        K = min(smp.CAND, self.spec.vocab_size)
        rep = sids[:, None].expand(B, kd).reshape(-1)  # a verify row each
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

    def _spec_eager(self, rows: list[_Slot], kind: str,
                    rounds: int) -> torch.Tensor:
        """The speculative dispatch as eager rounds over exactly ``rows``
        (tests and the chip smoke plant it on an instance in place of
        ``_spec_graph``); [rounds, B, 2 kd] on the device."""
        kd = self.n_draft
        pt, wt = self._tables(rows, [(s.n_past, s.n_past + rounds * kd)
                                     for s in rows])
        tok = self._ints([[s.generated[-1]] for s in rows])
        pos = self._ints([s.n_past for s in rows])
        if kind == "spec":
            D, M, J = self._greedy_rounds(tok, pos, pt, wt, rounds)
        else:
            D, M, J = self._sampled_rounds(
                tok, pos, pt, wt, self._ints([s.idx for s in rows]),
                self._spec_draws(rows, rounds, kd,
                                 min(smp.CAND, self.spec.vocab_size)),
                rounds)
        return torch.cat([D, M, J[..., None]], -1)

    def _spec_graph(self, rows: list[_Slot], kind: str,
                    rounds: int) -> torch.Tensor:
        """The speculative dispatch through its variant (kind, row bucket,
        rounds): a CUDA-graph replay on a card; [rounds, B, 2 kd] on the
        device."""
        v = self._spec_variant(kind, self._bucket(len(rows)), rounds)
        self._spec_fill(v, rows)
        self._spec_launch(v)
        return v.out[:, :len(rows)]

    def _spec_fill(self, v: _SpecVariant, rows: list[_Slot]) -> None:
        """A dispatch's inputs into v's static buffers: tables, tokens,
        positions and sampler rows in one transfer (pad rows: trash page
        in both tables, token 0, position 0, the sentinel sampler row),
        then for ``spec_s`` the dispatch's draws, drawn as the eager
        rounds draw them (``_spec_draws`` over the real rows; pad rows
        get zeros). The staging is rewritten only once its last copy has
        run (``_await_copy``)."""
        self._await_copy(v.copied)
        kd, B = self.n_draft, len(rows)
        pt, wt = self._table_rows(rows, [(s.n_past,
                                          s.n_past + v.rounds * kd)
                                         for s in rows])
        h = v.h
        h["pt"][:], h["wt"][:] = TRASH_PAGE, TRASH_PAGE
        h["pt"][:B], h["wt"][:B] = pt, wt
        h["tok"][:] = 0
        h["pos"][:] = 0
        h["sids"][:] = self._pad_sid
        h["tok"][:B, 0] = [s.generated[-1] for s in rows]
        h["pos"][:B] = [s.n_past for s in rows]
        h["sids"][:B] = [s.idx for s in rows]
        v.ints.copy_(v.host, non_blocking=True)
        v.copied = self._copy_event()
        if v.draws is not None:
            d = self._spec_draws(rows, v.rounds, kd,
                                 min(smp.CAND, self.spec.vocab_size))
            for buf, got, at in ((v.draws.draft, d.draft, 2),
                                 (v.draws.accept, d.accept, 1),
                                 (v.draws.replace, d.replace, 1)):
                buf.narrow(at, 0, B).copy_(got)
                buf.narrow(at, B, v.rows - B).zero_()

    def _spec_body(self, v: _SpecVariant) -> None:
        """One speculative dispatch over v's buffers, what a speculative
        graph holds: ``rounds`` x (kd draft forwards and a verify
        forward) and the acceptance, into ``v.out``."""
        f = v.f
        if v.draws is None:
            D, M, J = self._greedy_rounds(f["tok"], f["pos"], f["pt"],
                                          f["wt"], v.rounds)
        else:
            D, M, J = self._sampled_rounds(f["tok"], f["pos"], f["pt"],
                                           f["wt"], f["sids"], v.draws,
                                           v.rounds)
        v.out.copy_(torch.cat([D, M, J[..., None]], -1))

    def _spec_launch(self, v: _SpecVariant) -> None:
        """One speculative dispatch of variant v: a replay of its graph
        on a card (adding its capture's kernel launches to the counts),
        the body run eagerly on the CPU."""
        if v.graph is None:
            self._spec_body(v)
            return
        v.graph.replay()
        self.metrics.spec_replays += 1
        for f in COUNTED:
            f.launches += v.launches[f.__name__]

    def _spec_variant(self, kind: str, R: int, rounds: int) -> _SpecVariant:
        v = self._spec_variants.get((kind, R, rounds))
        if v is None:
            v = self._new_spec(kind, R, rounds)
            self._capture(v, self._spec_body)
            self._spec_variants[(kind, R, rounds)] = v
        return v

    def _new_spec(self, kind: str, R: int, rounds: int) -> _SpecVariant:
        """Static buffers of a speculative variant, every row a pad row."""
        dev = self.device
        cuda = dev.type == "cuda"
        kd, K = self.n_draft, min(smp.CAND, self.spec.vocab_size)
        fields = _spec_fields(R, self._max_pages)
        n = sum(int(np.prod(shape)) for _, shape in fields)
        host = torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
        h = {k: t.numpy() for k, t in _carve(host, fields).items()}
        h["pt"][:], h["wt"][:] = TRASH_PAGE, TRASH_PAGE
        h["sids"][:] = self._pad_sid
        ints = torch.empty_like(host, device=dev).copy_(host)
        draws = None
        if kind == "spec_s":
            draws = smp.SpecDraws(
                draft=torch.zeros((rounds, kd, R, K), device=dev),
                accept=torch.zeros((rounds, R, kd - 1), device=dev),
                replace=torch.zeros((rounds, R, kd, K), device=dev))
        return _SpecVariant(
            rows=R, rounds=rounds, host=host, h=h, ints=ints,
            f=_carve(ints, fields),
            out=torch.zeros((rounds, R, 2 * kd), dtype=torch.int32,
                            device=dev),
            draws=draws)

    def _spec_cost(self, pos: list[int], R: int,
                   rounds: int) -> tuple[float, float]:
        """Analytic (FLOPs, bytes) of a speculative variant of R rows over
        the real rows at positions ``pos``: contexts from each round's
        start (kd positions a round, an upper bound: a round advances a
        row by what it accepts); the projections and heads run over the
        padded rows."""
        kd, fl, by = self.n_draft, 0.0, 0.0
        for r in range(rounds):
            at = [c + r * kd for c in pos]
            for i in range(kd):
                f, b = self._dcost.forward([(c + i, 1) for c in at], R,
                                           tokens=R)
                fl, by = fl + f, by + b
            f, b = self._mcost.forward([(c, kd) for c in at], R * kd,
                                       tokens=R * kd)
            fl, by = fl + f, by + b
        return fl, by

    @property
    def _spec_max_rounds(self) -> int:
        """Rounds a speculative dispatch may take: 1 to this."""
        return max(1, self.decode_steps // self.n_draft)

    @torch.inference_mode()
    def _spec_decode_step(self, decoding: list[_Slot], mode: str) -> None:
        """One speculative dispatch over the eligible decoding slots:
        ``rounds`` rounds of ``n_draft`` tokens (no round that every row
        is sure to discard), one host read at the end; each round emits
        the accepted draft tokens and the verify's replacement (or bonus)
        token through ``_emit_token``. Only these rows (padded to a row
        bucket by pad rows on the trash page) are in the batch, so no
        other slot's pages are written. It runs through its variant
        (``_spec_graph``)."""
        t0 = time.perf_counter()
        kd = self.n_draft
        room = min(self.max_seq - 1 - s.n_past for s in self.slots
                   if s.state is SlotState.DECODE)
        need = max(s.request.max_tokens - len(s.generated)
                   for s in decoding)
        rounds = max(1, min(self._spec_max_rounds, max(room // kd, 1),
                            -(-need // kd)))
        span = rounds * kd
        rows = [s for s in decoding if self._ensure(s, s.n_past + span)]
        if not rows:
            return
        kind = "spec_s" if mode == "sampled" else "spec"
        key = costmodel.dispatch_key(kind, {"kd": kd, "rounds": rounds})
        pred = None
        if self._costmodel is not None:
            pred = self._cost_row(kind, key, *self._spec_cost(
                [s.n_past for s in rows], self._bucket(len(rows)), rounds))
        self._device_fault()
        self._span.start()
        # the one host read: [rounds, B, (kd - 1) + kd + 1]
        out = self._spec_graph(rows, kind, rounds)
        self._span.stop()
        host = out.tolist()
        self._harvest(kind, key, pred, t0,
                      {"rows": len(rows), "rounds": rounds})
        self.metrics.forward_steps += rounds
        self.metrics.draft_forwards += rounds * kd
        dt = (time.perf_counter() - t0) * 1e3
        # counted before any token is emitted: a request's final event
        # (sent from _emit_token) must find the counters settled
        self.metrics.spec_dispatches += 1
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
                    self.metrics.spec_tokens += 1
                    self._emit_token(s, tok_out, defer=True)
            if s.state is SlotState.DECODE:
                self._flush_emit(s)

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
            TRACER.event(req.id, "first_token", t=slot.t_first)
            if req.t_submit:
                # the exemplar links this bucket to /debug/traces?id=
                tm.ENGINE_TTFT.labels(model=self._mlabel).observe(
                    slot.t_first - req.t_submit,
                    exemplar=({"trace_id": req.trace_id}
                              if req.trace_id else None))
        slot.generated.append(token_id)
        self.metrics.tokens_generated += 1
        self._tm_generated.inc()
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
        self._maybe_save_prompt_cache(slot)
        if self._migrator is not None and req is not None:
            # the prefill side of a disaggregated pair: a finishing
            # probe's pages are gathered here, before the release below
            # can recycle them (the gather precedes any overwrite on the
            # stream); a no-op for any other request
            self._migrator.on_finish(slot, reason)
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
        if req is not None and req.disagg is not None:
            # a migrated request: its queue time is what it spent queued
            # on either engine, not the relay (the prefill engine's time
            # and the migration are its prompt processing)
            h = req.disagg
            queue_ms = h.queued_ms + max(
                0.0, (slot.t_start - h.t_resubmit) * 1e3)
            tm.ENGINE_DISAGG_STAGE.labels(
                model=self._mlabel, stage="decode").observe(
                max(0.0, time.perf_counter() - h.t_resubmit))
        if req is not None:
            # before the terminal event: a consumer woken by it (the SSE
            # writer's stream_done) finds the trace finished
            self._trace_terminal(req.id, reason)
        if slot.out is not None:
            slot.out.put(StreamEvent(
                done=True, finish_reason=reason, full_text=full,
                prompt_tokens=slot.n_prompt,
                completion_tokens=len(slot.generated),
                timing_prompt_processing_ms=slot.t_prefill_ms,
                timing_token_generation_ms=slot.t_decode_ms,
                timing_queue_ms=queue_ms, timing_first_token_ms=ttft_ms))
        self.metrics.requests_completed += 1
        tm.ENGINE_REQUESTS.labels(model=self._mlabel, reason=reason).inc()
        if reason == "cancelled":
            self._count_cancels("client", 1)
        self._release(slot)

    def _release(self, slot: _Slot) -> None:
        # the pages of cache_tokens stay as the slot's resident prefix;
        # pages past them (a decode step's overshoot) go back; K/V of
        # weights since replaced (``update_params``) all go back
        if slot.stale_kv or _soft(slot.request):
            # (an image request's pages too: its image-token ids would
            # match another image's prompt)
            self._prefix_index.remove(slot.idx)
            slot.cache_tokens = []
            slot.stale_kv = False
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


def _soft(req: Optional[GenRequest]) -> bool:
    """Whether ``req`` carries soft (image) rows."""
    return req is not None and req.soft_embeds is not None


def _release_handoff(req: GenRequest) -> None:
    """Free a migrated request's interchange pages when it dies queued
    (shed, cancelled, past its deadline, failed); idempotent."""
    if req.disagg is not None:
        req.disagg.release()


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
