"""The engine's mixed-step and masked-decode variants (one CUDA graph each
on a card) through their CPU path — the same variant code run eagerly
through the same static buffers, pad rows, pad positions and sentinel
sampler row — on ``tiny_spec`` weights in f32 (``LOCALAI_KV_PAGE=16``).

Held against the JAX engine on the same weights (token ids exactly):
- greedy ids through mixed variants (long prompts in non-final chunks,
  arrivals while others decode, so rows and tokens are padded);
- chunk boundaries and greedy ids under an ITL budget, with the same
  predictions injected into both cost models;
- greedy ids through masked decode variants: a GBNF grammar and a
  ``logit_bias`` ban beside an unmasked row.

Held against the port's own eager path (``_mixed_eager`` and
``_decode_eager`` planted on an instance):
- seeded sampled ids (penalties and mirostat included) exactly;
- pad rows and pad positions: every page outside the step's write
  spans, shared prefix pages included, and a free slot's sampler row
  are bitwise unchanged, and the pages the step writes agree with the
  eager step's within 1e-5;
- ``warmup()`` makes every variant and touches no slot, arena or
  sampler row (draft arena included) but the trash page and sentinel;
- a self-draft's arena stays within 1e-5 of the model's at every
  committed position through mixed variants;
- the variant bodies read no host value: every op input is engine
  state or an earlier op's output (a host scalar would be a copy that
  a CUDA graph capture refuses).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.grammars import constrain as jc
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.grammars import constrain as tc
from localai_tfp_tpu_torch.models import quant as tq
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec

KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))
SAMPLER_FIELDS = ("temperature", "top_k", "top_p", "min_p",
                  "repeat_penalty", "freq_penalty", "presence_penalty",
                  "token_counts", "history", "history_pos",
                  "repeat_last_n", "typical_p", "mirostat",
                  "mirostat_tau", "mirostat_eta", "mirostat_mu")
LONG = "a long prompt crosses the largest token bucket " * 4  # 192 bytes


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    for k in ("LOCALAI_COST_SCHED", "LOCALAI_ITL_BUDGET_MS"):
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=258, max_position=512)
    params = init_params(jax.random.PRNGKey(7), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _jax(weights, **kw):
    eng = je.LLMEngine(jax_tiny(vocab_size=258, max_position=512),
                       {k: jnp.asarray(v) for k, v in weights.items()},
                       JaxBytes(), cache_dtype=jnp.float32, **{**KW, **kw})
    eng._mixed = True
    eng._prefix_enabled = False  # one schedule in every engine
    return eng


def _port(weights, eager=False, prefix=False, draft=False, **kw):
    params = params_from_numpy(weights)
    spec = tiny_spec(vocab_size=258, max_position=512)
    eng = te.LLMEngine(spec, params, ByteTokenizer(), device="cpu",
                       draft=(spec, params) if draft else None,
                       **{**KW, "cache_dtype": torch.float32, **kw})
    eng._prefix_enabled = prefix
    if eager:  # the eager paths over exactly the rows, on this instance
        eng._mixed_graph = eng._mixed_eager
        eng._decode_graph = eng._decode_eager
    return eng


class Ids:
    """Each request's generated ids at finish, by prompt."""

    def __init__(self, eng):
        self.ids = {}
        orig = eng._finish

        def finish(slot, reason):
            if slot.request is not None:
                self.ids[tuple(slot.request.prompt_ids)] = list(
                    slot.generated)
            return orig(slot, reason)

        eng._finish = finish


def _drain(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        if ev.done:
            return ev


def _first_token(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        assert not ev.done, (ev.finish_reason, ev.error)
        if ev.token_id is not None:
            return


def _staggered(mod, eng, tk, extra=None, n_first=40) -> dict:
    """One request decoding, then a burst of three (one prompt in two
    chunks) while it decodes; every request runs to its length."""
    extra = extra or (lambda i: {})
    ids = Ids(eng)

    def req(text, n, i):
        return mod.GenRequest(prompt_ids=tk.encode(text), max_tokens=n,
                              ignore_eos=True, **extra(i))

    qs = [eng.submit(req("first stream decodes", n_first, 0))]
    _first_token(qs[0])
    qs += eng.submit_many([req(LONG, 6, 1), req("short one", 9, 2),
                           req("a middle sized prompt " * 2, 7, 3)])
    for q in qs:
        ev = _drain(q)
        assert ev.finish_reason == "length", ev.error
    return ids.ids


def test_greedy_ids_through_mixed_variants_match_jax(weights):
    jeng = _jax(weights)
    try:
        want = _staggered(je, jeng, JaxBytes())
    finally:
        jeng.close()
    eng = _port(weights)
    try:
        got = _staggered(te, eng, ByteTokenizer())
        m = eng.metrics
        assert m.mixed_steps > 0 and m.mixed_pad_tokens > 0
        # the first prompt alone at bucket 32; the burst beside the
        # decoding row (four rows) at 128, the long prompt's second
        # chunk (64 tokens) beside it too
        shapes = set(eng._mixed_variants)
        assert {(1, 32), (4, 128)} <= shapes
        eng.leak_check()
    finally:
        eng.close()
    assert got == want


def _chunk_spy_jax(eng, log: list):
    orig = eng._run
    S = eng.n_slots

    def run(kind, payload):
        if kind == "mixed":
            for i in range(S):
                if int(payload["prefill_sids"][i]) < S:
                    log.append((tuple(eng.slots[i].request.prompt_ids),
                                int(payload["n_chunk"][i])))
        return orig(kind, payload)

    eng._run = run


def _chunk_spy_port(eng, log: list):
    orig = eng._mixed_graph

    def graph(rows, chunks, finals, samplers, T):
        # the JAX engine's mixed dispatch carries decode rows (a prompt
        # alone takes its prefill path): compare those steps
        riding = any(s.state is te.SlotState.DECODE for s in rows)
        for s, c in zip(rows, chunks):
            if riding and s.state is te.SlotState.PREFILL:
                log.append((tuple(s.request.prompt_ids), len(c)))
        return orig(rows, chunks, finals, samplers, T)

    eng._mixed_graph = graph


PREDICT = {8: 4.0, 32: 30.0, 128: 90.0}  # mixed ms by token bucket


def _predict(eng):
    eng._costmodel.predict_ms = lambda kind, key: (
        PREDICT.get(key[1][1]) if kind == "mixed" else None)


def test_chunks_and_greedy_ids_under_an_itl_budget_match_jax(weights,
                                                             monkeypatch):
    """Budget 10 ms against predictions of 4 / 30 / 90 ms for buckets 8 /
    32 / 128: while the first stream decodes, every chunk is 8 tokens
    (the token budget alone would take 128), in both engines."""
    monkeypatch.setenv("LOCALAI_ITL_BUDGET_MS", "10")
    chunks, ids = {}, {}
    for name, make, mod, tk, spy in (
            ("jax", _jax, je, JaxBytes(), _chunk_spy_jax),
            ("port", _port, te, ByteTokenizer(), _chunk_spy_port)):
        eng = make(weights)
        _predict(eng)
        log = []
        spy(eng, log)
        try:
            ids[name] = _staggered(mod, eng, tk, n_first=60)
        finally:
            eng.close()
        per: dict = {}
        for prompt, n in log:
            per.setdefault(prompt, []).append(n)
        chunks[name] = per
        if name == "port":
            assert set(eng.cost_buckets) == {8}
    assert chunks["port"] == chunks["jax"]
    long = tuple(ByteTokenizer().encode(LONG))
    assert chunks["port"][long] == [8] * (len(long) // 8) + (
        [len(long) % 8] if len(long) % 8 else [])
    assert ids["port"] == ids["jax"]


GRAMMAR = 'root ::= [a-m]+ " " [n-z]+'
BAN = {i: -100.0 for i in range(60, 200)}


def _masked_wave(mod, eng, tk, cmod) -> dict:
    ids = Ids(eng)
    reqs = [mod.GenRequest(prompt_ids=tk.encode("grammar row"),
                           max_tokens=10, constraint=cmod.GrammarConstraint
                           .from_gbnf(GRAMMAR, tk)),
            mod.GenRequest(prompt_ids=tk.encode("banned ids row"),
                           max_tokens=9, ignore_eos=True, logit_bias=BAN),
            mod.GenRequest(prompt_ids=tk.encode("plain row beside them"),
                           max_tokens=12, ignore_eos=True)]
    for q in eng.submit_many(reqs):
        _drain(q)
    return ids.ids


def test_greedy_ids_through_masked_variants_match_jax(weights):
    jeng = _jax(weights)
    try:
        want = _masked_wave(je, jeng, JaxBytes(), jc)
    finally:
        jeng.close()
    eng = _port(weights)
    try:
        got = _masked_wave(te, eng, ByteTokenizer(), tc)
        # three masked rows (bucket 4), then two, then the plain row's
        # own unmasked decode variant
        assert {4, 2} <= set(eng._masked_variants)
        assert 1 in eng._variants
    finally:
        eng.close()
    assert got == want
    banned = got[tuple(ByteTokenizer().encode("banned ids row"))]
    assert len(banned) == 9 and not any(60 <= t < 200 for t in banned)


def test_seeded_sampled_ids_match_the_eager_paths(weights):
    def extra(i):
        return [dict(temperature=0.9, top_k=30, seed=11),
                dict(temperature=0.8, top_p=0.9, repeat_penalty=1.3,
                     seed=12),
                dict(temperature=1.0, mirostat=2, seed=13),
                dict(temperature=0.7, min_p=0.05, frequency_penalty=0.4,
                     seed=14)][i]

    got = {}
    for eager in (False, True):
        eng = _port(weights, eager=eager)
        try:
            got[eager] = _staggered(te, eng, ByteTokenizer(), extra)
            assert bool(eng._mixed_variants) != eager
        finally:
            eng.close()
    assert got[False] == got[True]
    assert len(got[False]) == 4


def _sampler_rows(eng) -> dict:
    st = eng.sampling
    return {f: getattr(st, f)[:eng.n_slots].clone() for f in SAMPLER_FIELDS}


def _arenas(eng) -> list:
    return [t.clone() for c in (eng.cache, eng.draft_cache) if c is not None
            for t in (c.k, c.v)]


def _run_until(eng, cond, limit=200):
    for _ in range(limit):
        if cond():
            return
        eng._admit()
        eng.step()
    raise AssertionError("schedule did not reach its state")


def _pad_step(weights, eager: bool):
    """A resident 40-token prefix (slot of request A, finished), C
    decoding, then B (A's prompt + 30 tokens: two shared pages and a
    copied tail) and D admitted: the next step is a mixed step of three
    rows (bucket 4: one pad row) at token bucket 32 (pad positions).
    Returns the pages and sampler rows before and after that step, the
    pages it writes and the free slot."""
    tk = ByteTokenizer()
    eng = _port(weights, eager=eager, prefix=True, autostart=False)
    a = tk.encode("x" * 39)
    eng.submit(te.GenRequest(prompt_ids=a, max_tokens=2, ignore_eos=True))
    _run_until(eng, lambda: not eng._pending and not any(
        s.active for s in eng.slots))
    eng.submit(te.GenRequest(prompt_ids=tk.encode("decoder"),
                             max_tokens=40, ignore_eos=True))
    _run_until(eng, lambda: any(s.state is te.SlotState.DECODE
                                for s in eng.slots))
    eng.submit_many([
        te.GenRequest(prompt_ids=a + tk.encode("y" * 30), max_tokens=4,
                      ignore_eos=True),
        te.GenRequest(prompt_ids=tk.encode("z" * 19), max_tokens=4,
                      ignore_eos=True)])
    eng._admit()
    assert eng.metrics.prefix_copies == 1
    free = [s.idx for s in eng.slots if not s.active]
    assert len(free) == 1 and eng.slots[free[0]].cache_tokens  # resident
    shared = set(eng._pool.table(free[0])[:2])
    spans = [(s.idx, s.n_past, s.n_past + (1 if s.state is
                                            te.SlotState.DECODE
                                            else s.n_prompt - s.n_past))
             for s in eng.slots if s.active]
    before, rows0 = _arenas(eng), _sampler_rows(eng)
    steps = eng.metrics.mixed_steps
    eng.step()
    assert eng.metrics.mixed_steps == steps + 1
    written = {eng._pool.table(i)[p] for i, lo, hi in spans
               for p in range(lo // eng.page, -(-hi // eng.page))}
    assert not written & shared
    out = (before, _arenas(eng), rows0, _sampler_rows(eng), written, free,
           shared, set(eng._mixed_variants))
    eng.close()
    return out


def test_pad_rows_and_positions_leave_other_pages_unchanged(weights):
    runs = {}
    for eager in (False, True):
        before, after, rows0, rows1, written, free, shared, shapes = \
            _pad_step(weights, eager)
        keep = [p for p in range(1, before[0].shape[1]) if p not in written]
        assert shared <= set(keep)
        for b, a in zip(before, after):
            assert torch.equal(b[:, keep], a[:, keep])
        for f in SAMPLER_FIELDS:
            assert torch.equal(rows0[f][free], rows1[f][free]), f
        runs[eager] = (after, sorted(written), shapes)
    assert (4, 32) in runs[False][2] and runs[True][2] == set()
    assert runs[False][1] == runs[True][1]
    w = runs[False][1]
    for a, b in zip(runs[False][0], runs[True][0]):
        assert float((a[:, w] - b[:, w]).abs().max()) < 1e-5


def test_warmup_makes_every_variant_and_touches_no_slot(weights):
    eng = _port(weights, prefix=True, draft=True, autostart=False)
    try:
        eng.submit(te.GenRequest(prompt_ids=ByteTokenizer().encode(
            "leave a resident prefix"), max_tokens=5, ignore_eos=True))
        _run_until(eng, lambda: not eng._pending and not any(
            s.active for s in eng.slots))
        rng = np.random.default_rng(0)
        for f in SAMPLER_FIELDS:  # distinct state in every real row
            t = getattr(eng.sampling, f)
            t.copy_(torch.from_numpy(rng.integers(1, 50, t.shape)).to(
                t.dtype))
        before, rows0 = _arenas(eng), _sampler_rows(eng)
        tokens = [list(s.cache_tokens) for s in eng.slots]
        t0 = time.perf_counter()
        eng.warmup()
        assert eng.metrics.warmup_s <= time.perf_counter() - t0
        assert sorted(eng._variants) == sorted(eng._masked_variants) == \
            [1, 2, 4]
        assert sorted(eng._mixed_variants) == [
            (r, t) for r in (1, 2, 4) for t in (8, 32, 128)]
        # with a draft: spec and spec_s per row bucket and rounds (1, 2)
        assert sorted(eng._spec_variants) == [
            (k, r, n) for k in ("spec", "spec_s") for r in (1, 2, 4)
            for n in (1, 2)]
        assert eng.variant_count() == 27
        # a nominal cost row per mixed variant, keyed by its shape
        rows = eng._costmodel.export_rows()
        assert all(repr(("mixed", rt)) in rows for rt in eng._mixed_variants)
        for b, a in zip(before, _arenas(eng)):
            assert torch.equal(b[:, 1:], a[:, 1:])
        after = _sampler_rows(eng)
        assert all(torch.equal(rows0[f], after[f]) for f in rows0)
        assert [list(s.cache_tokens) for s in eng.slots] == tokens
        eng.leak_check()
    finally:
        eng.close()


def test_self_draft_arena_tracks_the_model_through_mixed_variants(weights):
    eng = _port(weights, draft=True)
    try:
        _staggered(te, eng, ByteTokenizer())
        assert eng.metrics.mixed_steps > 0 and eng._mixed_variants
        assert eng.metrics.spec_dispatches > 0
        checked = 0
        for s in eng.slots:
            n = len(s.cache_tokens)
            if not n:
                continue
            pages = eng._pool.table(s.idx)[:-(-n // eng.page)]
            for a, b in ((eng.cache.k, eng.draft_cache.k),
                         (eng.cache.v, eng.draft_cache.v)):
                diff = (a[:, pages].flatten(1, 2)[:, :n]
                        - b[:, pages].flatten(1, 2)[:, :n]).abs().max()
                assert float(diff) < 1e-5, (s.idx, float(diff))
            checked += n
        assert checked > 190
    finally:
        eng.close()


class _Foreign(TorchDispatchMode):
    """Records every op input whose storage is neither the engine's state
    nor an earlier op's output: on a card such a tensor is a host value
    copied to the device, which a CUDA graph capture refuses."""

    def __init__(self, known: set):
        super().__init__()
        self.known = known
        self.found = []
        # every op output stays alive, so no later host tensor can be
        # allocated at a known address
        self.outputs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat, _ = tree_flatten((args, kwargs or {}))
        self.found += [str(func) for t in flat if isinstance(t, torch.Tensor)
                       and t.untyped_storage().data_ptr() not in self.known]
        out = func(*args, **(kwargs or {}))
        self.outputs.append(out)
        self.known.update(t.untyped_storage().data_ptr()
                          for t in tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor))
        return out


def _storages(obj, out: set) -> set:
    if isinstance(obj, torch.Tensor):
        out.add(obj.untyped_storage().data_ptr())
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _storages(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _storages(x, out)
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            _storages(getattr(obj, k), out)
    return out


@pytest.mark.parametrize("what", ["mixed", "decode", "masked"])
@pytest.mark.parametrize("model", ["f32", "draft", "int8"])
def test_variant_bodies_read_no_host_value(weights, what, model):
    """Every input of every op a variant body runs is the engine's own
    state (weights, arenas, sampler, static buffers and mask) or an
    earlier op's output: no host scalar or list becomes a tensor inside
    what a card captures."""
    kw = {"draft": model == "draft"}
    if model == "int8":
        kw["cache_dtype"] = torch.int8
    eng = _port(weights, autostart=False, **kw)
    if model == "int8":
        eng.params = tq.quantize_params(eng.params)
    v = {"mixed": lambda: eng._new_mixed(4, 32),
         "decode": lambda: eng._new_variant(4),
         "masked": lambda: eng._new_variant(4, masked=True)}[what]()
    body = eng._mixed_body if what == "mixed" else eng._decode_body
    known = _storages([eng.params, eng.cache, eng.draft_cache, eng.sampling,
                       v, eng._mask_dev, eng.draft], set())
    try:
        with torch.inference_mode(), _Foreign(known) as spy:
            body(v)
        assert spy.found == []
    finally:
        eng.close()
