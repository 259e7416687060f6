"""The engine's speculative variants (one CUDA graph per (mode, row
bucket, rounds) on a card) through their CPU path: the same variant
code run eagerly through the same static buffers, pad rows on the trash
page and the sentinel sampler row, on ``tiny_spec`` weights in f32 with
a 1-layer draft (or the model drafting for itself), 4 slots, decode
steps 8 and n_draft 4 (rounds 1 and 2).

- Greedy ids through the variant path equal the JAX engine's
  speculative greedy ids and its plain greedy ids on the same weights.
- Against the eager rounds planted on an instance (``eng._spec_graph =
  eng._spec_eager``), stepped by hand (one schedule): greedy ids and
  seeded sampled ids (the same draws, ``_spec_draws``) equal, and the
  counters per dispatch (target and draft forwards, rounds, accepted
  and emitted tokens) equal.
- A dispatch of 3 rows at bucket 4 (one pad row) leaves every sampler
  row, and every target and draft page outside the rows' write spans
  (the trash page aside), bitwise unchanged; the pages it writes are
  within 1e-5 of the eager rounds'.
- ``warmup()`` builds one variant per (mode, row bucket, rounds) with a
  draft and none without.
- Every op input of a variant body is engine state or an earlier op's
  output (the check of tests/test_torch_mixed_graphs.py): no host value
  becomes a tensor inside what a card captures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models import quant as tq
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec

VOCAB = 258
DRAFT = dict(d_model=32, n_layers=1, d_ff=64)
KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128),
          decode_steps=8, n_draft=4)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(spec, seed):
    params = init_params(jax.random.PRNGKey(seed), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def weights():
    return (_tree(jax_tiny(vocab_size=VOCAB), 0),
            _tree(jax_tiny(vocab_size=VOCAB, **DRAFT), 99))


def _port(weights, draft="tiny", eager=False, **kw):
    main, dw = weights
    spec = tiny_spec(vocab_size=VOCAB)
    params = params_from_numpy(main)
    d = {"tiny": (tiny_spec(vocab_size=VOCAB, **DRAFT),
                  params_from_numpy(dw)),
         "self": (spec, params), None: None}[draft]
    eng = te.LLMEngine(spec, params, ByteTokenizer(), device="cpu", draft=d,
                       kv_tier=False,
                       **{**KW, "cache_dtype": torch.float32, **kw})
    eng._prefix_enabled = False
    if eager:  # the eager rounds over exactly the rows, on this instance
        eng._spec_graph = eng._spec_eager
    return eng


def _jax(weights, draft: bool):
    main, dw = weights
    eng = je.LLMEngine(
        jax_tiny(vocab_size=VOCAB),
        {k: jnp.asarray(v) for k, v in main.items()}, JaxBytes(),
        cache_dtype=jnp.float32, kv_tier=False,
        draft=(jax_tiny(vocab_size=VOCAB, **DRAFT),
               {k: jnp.asarray(v) for k, v in dw.items()}) if draft
        else None, **KW)
    eng._prefix_enabled = False
    return eng


def _reqs(mod, sampled: bool = False) -> list:
    tk = ByteTokenizer()
    out = []
    for i, (text, n) in enumerate((("hello speculative world", 23),
                                   ("the draft proposes", 17),
                                   ("a", 30))):
        extra = ({"temperature": 0.9, "top_k": 40, "seed": 5 + i}
                 if sampled and i != 1 else {})  # row 1 stays greedy
        out.append(mod.GenRequest(prompt_ids=tk.encode(text, add_bos=True),
                                  max_tokens=n, ignore_eos=True, **extra))
    return out


def _spy(eng) -> dict:
    """Each request's generated ids at finish, by prompt."""
    ids = {}
    orig = eng._finish

    def finish(slot, reason):
        if slot.request is not None:
            ids[tuple(slot.request.prompt_ids)] = list(slot.generated)
        return orig(slot, reason)

    eng._finish = finish
    return ids


def _drain(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        if ev.done:
            return ev


def _serve(eng, reqs) -> dict:
    ids = _spy(eng)
    for q in eng.submit_many(reqs):
        assert _drain(q).finish_reason == "length"
    return ids


def _step_all(eng, reqs) -> dict:
    """Serve ``reqs`` on an engine made with autostart=False, stepping
    it by hand (one schedule whatever the host's timing)."""
    ids = _spy(eng)
    eng.submit_many(reqs)
    while eng._pending or any(s.active for s in eng.slots):
        eng._admit()
        eng.step()
    return ids


SAMPLER_FIELDS = ("temperature", "top_k", "top_p", "min_p",
                  "repeat_penalty", "freq_penalty", "presence_penalty",
                  "token_counts", "history", "history_pos",
                  "repeat_last_n", "typical_p", "mirostat",
                  "mirostat_tau", "mirostat_eta", "mirostat_mu")
COUNTERS = ("forward_steps", "draft_forwards", "spec_dispatches",
            "spec_rounds", "spec_accepted", "spec_tokens", "decode_steps",
            "mixed_steps", "tokens_generated")


def test_greedy_ids_match_jax_spec_and_plain(weights):
    got = {}
    for name, make in (("jax_spec", lambda: _jax(weights, True)),
                       ("jax_plain", lambda: _jax(weights, False)),
                       ("port", lambda: _port(weights))):
        eng = make()
        try:
            got[name] = _serve(eng, _reqs(je if "jax" in name else te))
            if name == "port":
                m = eng.metrics
                assert m.spec_dispatches > 0 and m.spec_tokens > 0
                # the dispatches ran through variants, some with pad rows
                assert eng._spec_variants
                assert any(R > 1 for _, R, _ in eng._spec_variants)
                eng.leak_check()
        finally:
            eng.close()
    assert got["port"] == got["jax_spec"] == got["jax_plain"]
    assert len(got["port"]) == 3


@pytest.mark.parametrize("draft", ["tiny", "self"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_variant_path_matches_the_eager_rounds(weights, draft, sampled):
    """Stepped by hand on the variant path and on the eager rounds: ids
    equal (seeded sampled rows draw the same numbers in the same order)
    and every counter equal, so each dispatch counts the forwards its
    rounds ran."""
    runs = {}
    for eager in (False, True):
        eng = _port(weights, draft=draft, eager=eager, autostart=False)
        draws = []
        orig = eng._spec_draws

        def spec_draws(rows, rounds, kd, k, orig=orig, draws=draws):
            d = orig(rows, rounds, kd, k)
            draws.append(d.accept.clone())
            return d

        eng._spec_draws = spec_draws
        try:
            ids = _step_all(eng, _reqs(te, sampled))
            runs[eager] = (ids, {c: getattr(eng.metrics, c)
                                 for c in COUNTERS}, draws,
                           set(eng._spec_variants))
        finally:
            eng.close()
    (gi, gc, gd, gv), (ei, ec, ed, ev) = runs[False], runs[True]
    assert gi == ei and len(gi) == 3
    assert gc == ec
    assert gc["spec_dispatches"] > 0
    assert gv and not ev  # variants on one path only
    assert len(gd) == len(ed)
    assert all(torch.equal(a, b) for a, b in zip(gd, ed))
    if draft == "self" and not sampled:  # the model accepts itself
        assert gc["spec_accepted"] == 3 * gc["spec_rounds"]


def _pages(eng) -> list:
    return [t.clone() for c in (eng.cache, eng.draft_cache)
            for t in (c.k, c.v)]


def _sampler(eng) -> dict:
    return {f: getattr(eng.sampling, f).clone() for f in SAMPLER_FIELDS}


def _one_dispatch(weights, eager: bool):
    """Three requests prefilled and decoding (one slot free), then one
    speculative dispatch of 3 rows (variant bucket 4: one pad row)."""
    eng = _port(weights, draft="self", eager=eager, autostart=False)
    eng.submit_many(_reqs(te, sampled=True))
    while eng._pending or any(s.state is te.SlotState.PREFILL
                              for s in eng.slots):
        eng._admit()
        eng.step()
    rows = [s for s in eng.slots if s.state is te.SlotState.DECODE]
    assert len(rows) == 3
    # the span a dispatch may write: rounds x n_draft from each n_past
    span = eng._spec_max_rounds * eng.n_draft
    written = set()
    for s in rows:
        eng._pool.ensure(s.idx, s.n_past + span)
        t = eng._pool.table(s.idx)
        written |= {t[p] for p in range(s.n_past // eng.page,
                                         -(-(s.n_past + span) // eng.page))}
    before, rows0 = _pages(eng), _sampler(eng)
    m0 = dict(vars(eng.metrics))
    eng.step()
    d = {k: v - m0[k] for k, v in vars(eng.metrics).items()
         if isinstance(v, int)}
    out = (before, _pages(eng), rows0, _sampler(eng), written, d,
           set(eng._spec_variants))
    eng.close()
    return out


def test_pad_rows_leave_other_state_unchanged(weights):
    runs = {}
    for eager in (False, True):
        before, after, rows0, rows1, written, d, shapes = \
            _one_dispatch(weights, eager)
        assert d["spec_dispatches"] == 1
        n_pages = before[0].shape[1]
        keep = [p for p in range(1, n_pages) if p not in written]
        for b, a in zip(before, after):  # target and draft arenas
            assert torch.equal(b[:, keep], a[:, keep])
        for f in SAMPLER_FIELDS:  # a spec dispatch writes no sampler row
            assert torch.equal(rows0[f], rows1[f]), f
        runs[eager] = (after, sorted(written), d, shapes)
    assert runs[False][3] and not runs[True][3]
    assert {k for _, k, _ in runs[False][3]} == {4}  # 3 rows + 1 pad row
    assert runs[False][1] == runs[True][1]
    assert runs[False][2] == runs[True][2]
    # two rounds (no row can finish in the first): a verify forward and
    # n_draft draft forwards each
    g = runs[False][2]
    assert (g["forward_steps"], g["draft_forwards"], g["spec_rounds"]) == (
        2, 2 * KW["n_draft"], 2 * 3)
    w = runs[False][1]
    for a, b in zip(runs[False][0], runs[True][0]):
        assert float((a[:, w] - b[:, w]).abs().max()) < 1e-5


@pytest.mark.parametrize("draft", ["tiny", None], ids=["draft", "no_draft"])
def test_warmup_builds_one_variant_per_mode_bucket_and_rounds(weights,
                                                              draft):
    eng = _port(weights, draft=draft, autostart=False)
    try:
        pages, rows0 = [t.clone() for t in (eng.cache.k, eng.cache.v)], \
            _sampler(eng)
        eng.warmup()
        want = [(k, r, n) for k in ("spec", "spec_s") for r in (1, 2, 4)
                for n in (1, 2)] if draft else []
        assert sorted(eng._spec_variants) == want
        assert eng.variant_count() == 15 + len(want)
        for b, a in zip(pages, (eng.cache.k, eng.cache.v)):
            assert torch.equal(b[:, 1:], a[:, 1:])  # the trash page aside
        n = eng.n_slots  # the sentinel row aside
        assert all(torch.equal(rows0[f][:n], getattr(eng.sampling, f)[:n])
                   for f in SAMPLER_FIELDS)
        if draft:
            assert all(v.draws is not None for (k, _, _), v in
                       eng._spec_variants.items() if k == "spec_s")
            # a nominal cost row per kind and rounds
            rows = eng._costmodel.export_rows()
            assert all(repr((k, 4, n)) in rows
                       for k in ("spec", "spec_s") for n in (1, 2))
    finally:
        eng.close()


class _Foreign(TorchDispatchMode):
    """Records every op input whose storage is neither the engine's state
    nor an earlier op's output (as in tests/test_torch_mixed_graphs.py):
    on a card such a tensor is a host value copied to the device, which
    a CUDA graph capture refuses."""

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


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("kind", ["spec", "spec_s"])
@pytest.mark.parametrize("model", ["f32", "int8"])
def test_spec_bodies_read_no_host_value(weights, model, kind, rounds):
    """Every input of every op a speculative variant body runs is the
    engine's own state (weights of both models, arenas, sampler, static
    buffers and draws) or an earlier op's output."""
    kw = {"cache_dtype": torch.int8} if model == "int8" else {}
    eng = _port(weights, autostart=False, **kw)
    if model == "int8":
        eng.params = tq.quantize_params(eng.params)
    try:
        for R in eng._buckets:  # every row bucket a warmup captures
            v = eng._new_spec(kind, R, rounds)
            known = _storages([eng.params, eng.cache, eng.draft_cache,
                               eng.sampling, v, eng.draft], set())
            with torch.inference_mode(), _Foreign(known) as spy:
                eng._spec_body(v)
            assert spy.found == [], R
    finally:
        eng.close()
