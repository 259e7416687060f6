"""Speculative decoding in the port (the ``spec`` / ``spec_s`` dispatch
of localai_tfp_tpu_torch/engine/engine.py, ``filtered_candidates`` and
``spec_reject`` in ops/sampling.py, the draft in the worker) against the
JAX package's LLMEngine on the same weights, in f32 on the CPU.

Tiny Llamas from ``init_params`` (the draft ``tiny_spec(d_model=32,
n_layers=1, d_ff=64)``, as in tests/test_spec_decode.py), carried across
by ``models/convert.py``:

- greedy text of the port's spec engine equals the JAX spec engine's and
  the port's plain engine's, byte for byte, with the JAX engine's
  dispatch and token counts;
- concurrent requests and prefix sharing with a draft: every page copy
  (the prefix tail and copy-on-write) copies the draft arena's page
  bitwise, and a sharer's draft K/V equals its donor's over the span;
- the model drafting for itself accepts every greedy token and its draft
  arena equals the model's arena at every committed position, also
  when a request decodes through another's prefill;
- a draft equal to the model accepts every sampled token; a greedy slot
  in a sampled batch, and a penalty slot beside a clean one, stay exact;
- ``filtered_candidates`` matches the JAX function within 1e-6, and the
  rejection step's first tokens follow p (chi-square, p-value > 1e-3);
- a config with ``draft_model`` loads its draft through the worker; a
  missing draft (directory or GGUF file) fails the load.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu.ops import sampling as js
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.ops import sampling as ts

VOCAB = ByteTokenizer().vocab_size  # BOS and EOS past the 256 bytes
DRAFT = dict(d_model=32, n_layers=1, d_ff=64)
ENGINE_KW = dict(n_slots=2, max_seq=256)


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


def _port(weights, draft=True, self_draft=False, **kw):
    main, dw = weights
    spec = tiny_spec(vocab_size=VOCAB)
    params = params_from_numpy(main)
    d = None
    if self_draft:
        d = (spec, params)
    elif draft:
        d = (tiny_spec(vocab_size=VOCAB, **DRAFT), params_from_numpy(dw))
    return te.LLMEngine(spec, params, ByteTokenizer(),
                        cache_dtype=torch.float32, device="cpu", draft=d,
                        kv_tier=False,
                        **{**ENGINE_KW, "decode_steps": 16, **kw})


def _jax(weights, **kw):
    main, dw = weights
    return je.LLMEngine(
        jax_tiny(vocab_size=VOCAB),
        {k: jnp.asarray(v) for k, v in main.items()}, JaxBytes(),
        cache_dtype=jnp.float32, kv_tier=False,
        draft=(jax_tiny(vocab_size=VOCAB, **DRAFT),
               {k: jnp.asarray(v) for k, v in dw.items()}),
        **{**ENGINE_KW, "decode_steps": 16, **kw})


def _req(mod, text, n=24, **kw):
    tk = ByteTokenizer()
    return mod.GenRequest(prompt_ids=tk.encode(text, add_bos=True),
                          max_tokens=n, ignore_eos=True, **kw)


def _drain(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        if ev.done:
            return ev


def _generate(eng, req):
    ev = eng.generate(req)
    assert ev.finish_reason == "length", ev.error
    return ev.full_text


class SpecSpy:
    """The slots of every spec dispatch (by request id) and, after every
    page copy, whether the draft arena's destination page equals its
    source bitwise."""

    def __init__(self, eng):
        self.spec_rows = []
        self.draft_copies = []
        step, copy = eng._spec_decode_step, eng._kv_copy

        def spec_step(decoding, mode):
            self.spec_rows.append([s.request.id for s in decoding])
            return step(decoding, mode)

        def kv_copy(src, dst):
            copy(src, dst)
            c = eng.draft_cache
            self.draft_copies.append(all(
                torch.equal(t[:, dst], t[:, src])
                for t in (c.k, c.v, c.k_scale, c.v_scale)
                if t is not None))

        eng._spec_decode_step, eng._kv_copy = spec_step, kv_copy


# ------------------------------------------------------------- engine level


def test_greedy_spec_matches_jax_spec_and_plain(weights):
    prompts = ("hello world", "the quick brown fox", "a")
    jeng, teng = _jax(weights), _port(weights)
    plain = _port(weights, draft=False)
    try:
        for p in prompts:
            want = _generate(jeng, _req(je, p))
            assert _generate(teng, _req(te, p)) == want, p
            assert _generate(plain, _req(te, p)) == want, p
        assert teng.metrics.spec_dispatches > 0
        assert teng.metrics.spec_tokens > 0
        assert (teng.metrics.spec_dispatches, teng.metrics.spec_tokens) == (
            jeng.metrics.spec_dispatches, jeng.metrics.spec_tokens)
        assert plain.metrics.spec_dispatches == 0
        teng.leak_check()
    finally:
        for e in (jeng, teng, plain):
            e.close()


def _active_donor(eng, donor, sharer, n_donor=24, n_sharer=8):
    """The sharer arrives while the donor decodes, so it shares the
    donor's pages instead of taking over its slot."""
    a, b = _req(te, donor, n_donor), _req(te, sharer, n_sharer)
    qa = eng.submit(a)
    while True:
        ev = qa.get(timeout=120)
        assert not ev.done, ev.error
        if ev.token_id is not None:
            break
    qb = eng.submit(b)
    return [_drain(qb).full_text, _drain(qa).full_text]


def _draft_rows(eng, ids, n):
    """The draft arena's K and V rows [L, n, F] of the slot holding
    ``ids``, read through its own page table."""
    s = next(s for s in eng.slots if s.cache_tokens[:len(ids)] == ids)
    pages = eng._pool.table(s.idx)[:-(-n // eng.page)]
    c = eng.draft_cache
    return s, [t[:, pages].flatten(1, 2)[:, :n] for t in (c.k, c.v)]


@pytest.mark.parametrize("case", ["concurrent", "tail_copy", "cow"])
def test_concurrent_and_prefix_sharing_with_draft(weights, monkeypatch,
                                                  case):
    """With 16-token pages, on a spec engine and a plain one: three
    concurrent requests on two slots; an active donor whose unaligned
    40-token prefix a sharer reuses (two pages by reference, the tail
    page copied); a resident prompt of two full pages re-admitted after
    a sharer took them (copy-on-write at the relogit step). Every text
    equals the plain engine's, every page copy carries the draft page
    bitwise, and the sharer's draft K/V equals its donor's over the
    shared span."""
    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    tk = ByteTokenizer()
    teng = _port(weights, n_draft=3)
    plain = _port(weights, draft=False)
    spy = SpecSpy(teng)
    try:
        texts = {}
        for eng in (plain, teng):
            if case == "concurrent":
                reqs = [_req(te, f"prompt {i}", 10) for i in range(3)]
                texts[id(eng)] = [_drain(q).full_text
                                  for q in eng.submit_many(reqs)]
            elif case == "tail_copy":
                prefix = "".join(chr(65 + i % 26) for i in range(39))
                texts[id(eng)] = _active_donor(eng, prefix + "xy",
                                               prefix + "uv")
            else:
                x = "".join(chr(97 + i % 26) for i in range(31))
                texts[id(eng)] = _active_donor(eng, x, x + "abc") + [
                    _generate(eng, _req(te, x, 8))]
        assert texts[id(teng)] == texts[id(plain)]
        assert teng.metrics.spec_dispatches > 0
        assert all(spy.draft_copies)
        if case == "tail_copy":
            assert teng.metrics.prefix_copies == 1
            assert len(spy.draft_copies) == 1
            ids = [tk.encode(prefix + t, add_bos=True) for t in ("xy", "uv")]
            (sa, donor), (sb, sharer) = (_draft_rows(teng, i, 40)
                                         for i in ids)
            assert sa is not sb
            assert all(torch.equal(a, b) for a, b in zip(donor, sharer))
        if case == "cow":
            assert teng._pool.allocs["cow"] == 1
            assert len(spy.draft_copies) == 1
        teng.leak_check()
    finally:
        teng.close()
        plain.close()


def test_sampled_draft_equal_to_model_accepts_everything(weights):
    """p == q at every position, so min(1, p/q) = 1: 24 tokens (1 from
    the prefill, 23 decoded) arrive in exactly 2 spec dispatches (4 + 2
    rounds of 4)."""
    eng = _port(weights, self_draft=True)
    try:
        ev = eng.generate(_req(te, "accept all", temperature=1.0, seed=5))
        assert ev.finish_reason == "length", ev.error
        assert ev.completion_tokens == 24
        m = eng.metrics
        assert m.spec_dispatches == 2, (m.spec_dispatches, m.spec_tokens)
        assert m.spec_accepted == 3 * m.spec_rounds
    finally:
        eng.close()


@pytest.mark.parametrize("case", ["one", "staggered"])
def test_self_draft_arena_tracks_the_model(weights, case):
    """The model drafting for itself, greedy: every draft token is
    accepted, the text equals the plain engine's, and the draft arena
    holds the model's own K/V (within 1e-5: T == 1 draft rows against
    the mirror's and verify's T > 1 rows) at every committed position,
    so no position is left unwritten: the prompt mirror covers the
    prompt, each round's n_draft-th draft step writes the last drafted
    token's row, and ("staggered": a second request arrives while the
    first decodes) a mixed step writes its decode rows' draft K/V."""
    prompts = ["the draft arena tracks the model", "a second request"]
    plain, eng = _port(weights, draft=False), _port(weights, self_draft=True)
    try:
        if case == "one":
            texts = [_generate(eng, _req(te, prompts[0], 40))]
        else:
            beside, mixed = [], eng._mixed_step
            eng._mixed_step = lambda p, d: (beside.append(len(d)),
                                            mixed(p, d))
            texts = _active_donor(eng, prompts[0], prompts[1], 40, 24)[::-1]
            assert any(beside)  # a decode row in a mixed step
        assert texts == [_generate(plain, _req(te, p, n))
                         for p, n in zip(prompts, (40, 24))][:len(texts)]
        m = eng.metrics
        assert m.spec_rounds > 0 and m.spec_accepted == 3 * m.spec_rounds
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
    finally:
        plain.close()
        eng.close()


def test_greedy_slot_in_sampled_batch_stays_exact(weights):
    plain, eng = _port(weights, draft=False), _port(weights)
    try:
        want = _generate(plain, _req(te, "mixed batch probe", 16))
        greedy = _req(te, "mixed batch probe", 16)
        sampled = _req(te, "noise", 16, temperature=0.9, seed=3)
        spy = SpecSpy(eng)
        qs = eng.submit_many([greedy, sampled])
        evs = [_drain(q) for q in qs]
        assert evs[0].full_text == want
        assert evs[1].finish_reason == "length"
        assert any(greedy.id in r and sampled.id in r
                   for r in spy.spec_rows)
    finally:
        plain.close()
        eng.close()


def test_penalty_slot_advances_outside_the_spec_dispatch(weights):
    plain, eng = _port(weights, draft=False), _port(weights)
    try:
        want_clean = _generate(plain, _req(te, "hello world"))
        want_pen = _generate(plain, _req(te, "abcabc",
                                         repeat_penalty=1.5))
        spy = SpecSpy(eng)
        clean = _req(te, "hello world")
        pen = _req(te, "abcabc", repeat_penalty=1.5)
        evs = [_drain(q) for q in eng.submit_many([clean, pen])]
        assert [e.full_text for e in evs] == [want_clean, want_pen]
        assert any(clean.id in r for r in spy.spec_rows)
        assert not any(pen.id in r for r in spy.spec_rows)
    finally:
        plain.close()
        eng.close()


def test_sampled_draws_are_injectable(weights):
    """The dispatch's draws come through ``_spec_draws``: draws whose
    acceptance uniforms are all 1 reject every draft token, even a draft
    equal to the model, so each round emits one token."""
    eng = _port(weights, self_draft=True)
    calls = []

    def draws(rows, rounds, kd, k):
        calls.append((len(rows), rounds, kd, k))
        d = ts.spec_draws(eng.sampling, [s.idx for s in rows],
                          [True] * len(rows), rounds, kd, k)
        d.accept.fill_(1.0)
        return d

    eng._spec_draws = draws
    try:
        ev = eng.generate(_req(te, "reject all", temperature=1.0, seed=5))
        assert ev.finish_reason == "length", ev.error
        m = eng.metrics
        assert calls and all(c[1:] == (4, 4, 128) for c in calls[:1])
        assert m.spec_dispatches == len(calls)
        assert m.spec_accepted == 0 and m.spec_tokens == m.spec_rounds == 23
    finally:
        eng.close()


# --------------------------------------------------------------- sampler


V = 200
ROWS = [dict(temperature=0.0), dict(temperature=0.8, top_k=20),
        dict(temperature=1.0, top_p=0.9), dict(temperature=0.7, min_p=0.1),
        dict(temperature=1.1, typical_p=0.7),
        dict(temperature=0.9, top_k=50, top_p=0.8, min_p=0.02)]


def _states(rows):
    fields = dict(temperature=(0.0, np.float32), top_k=(0, np.int32),
                  top_p=(1.0, np.float32), min_p=(0.0, np.float32),
                  repeat_penalty=(0.0, np.float32),
                  freq_penalty=(0.0, np.float32),
                  presence_penalty=(0.0, np.float32),
                  repeat_last_n=(8, np.int32), typical_p=(1.0, np.float32),
                  mirostat=(0, np.int32), mirostat_tau=(5.0, np.float32),
                  mirostat_eta=(0.1, np.float32))
    cols = {f: [r.get(f, d) for r in rows] for f, (d, _) in fields.items()}
    ids = list(range(len(rows)))
    jst = js.SamplingState.create(len(rows), V, window=16)
    arr = {f: jnp.asarray(cols[f], dt) for f, (_, dt) in fields.items()}
    jst = js.reset_slots(
        jst, jnp.asarray(ids, np.int32),
        *(arr[f] for f in ("temperature", "top_k", "top_p", "min_p",
                           "repeat_penalty", "freq_penalty",
                           "presence_penalty", "repeat_last_n")),
        jnp.asarray([7] * len(rows), np.int32), jnp.ones(len(rows), bool),
        *(arr[f] for f in ("typical_p", "mirostat", "mirostat_tau",
                           "mirostat_eta")))
    tst = ts.SamplingState.create(len(rows), V, window=16)
    ts.reset_slots(tst, ids, cols, [7] * len(rows))
    return jst, tst


@pytest.mark.parametrize("seed", range(3))
def test_filtered_candidates_matches_jax(seed):
    jst, tst = _states(ROWS)
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((len(ROWS), V)) * 3.0).astype(np.float32)
    # rows in a shuffled order, one slot twice (the verify forward's
    # repeated slot ids)
    ids = np.asarray([3, 0, 5, 1, 1, 4, 2], np.int32)
    lg = np.concatenate([logits, logits[:1]])
    jp, ji = jax.jit(js.filtered_candidates)(jst, jnp.asarray(ids),
                                             jnp.asarray(lg))
    tp, ti = ts.filtered_candidates(tst, torch.from_numpy(ids),
                                    torch.from_numpy(lg))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    greedy = ids == 0
    assert (tp.numpy()[greedy, 0] == 1.0).all()


def test_rejection_step_emits_tokens_distributed_as_p():
    """20 000 rounds of kd = 2 over a 6-token vocabulary, fed fixed p
    and q (candidate orders differing) and driven from one seeded
    generator: the first emitted token (the draft's, if accepted, else
    the residual draw) follows p by a chi-square test, and so does the
    bonus token of the rounds that accepted."""
    from scipy.stats import chisquare

    n, C = 20000, 6
    p = torch.tensor([0.05, 0.30, 0.10, 0.25, 0.20, 0.10])
    q = torch.tensor([0.30, 0.05, 0.25, 0.10, 0.10, 0.20])
    p_idx = torch.argsort(p, descending=True)
    q_idx = torch.argsort(q, descending=True)
    g = torch.Generator().manual_seed(1234)

    def gumbel(shape):
        u = torch.rand(shape, generator=g)
        return -torch.log(-torch.log(u.clamp(1e-20, 1 - 1e-7)))

    qp = q[q_idx].expand(n, 2, C)
    qi = q_idx.expand(n, 2, C)
    pp = p[p_idx].expand(n, 2, C)
    pi = p_idx.expand(n, 2, C)
    pick = ts.gumbel_pick(qp, gumbel((n, 2, C)))
    drafted = torch.gather(qi, -1, pick[..., None])[..., 0]
    q_drafted = torch.gather(qp, -1, pick[..., None])[..., 0]
    fin, j = ts.spec_reject(pp, pi, qp, qi, drafted, q_drafted,
                            torch.rand((n, 1), generator=g),
                            gumbel((n, 2, C)))
    first = torch.where(j >= 2, drafted[:, 0], fin[:, 0])
    counts = torch.bincount(first, minlength=C).numpy()
    stat = chisquare(counts, p.numpy() * n)
    assert stat.pvalue > 1e-3, (counts, stat)
    # after an accepted draft the bonus position draws from p itself
    bonus = fin[j >= 2, 1]
    counts = torch.bincount(bonus, minlength=C).numpy()
    stat = chisquare(counts, p.numpy() * len(bonus))
    assert stat.pvalue > 1e-3, (counts, stat)
    # acceptance is sum(min(p, q)) = 0.5
    assert abs(float((j >= 2).float().mean()) - 0.5) < 0.02


# ---------------------------------------------------------------- worker


def _save_tiny_hf(path, layers, width):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=width, intermediate_size=2 * width,
        num_hidden_layers=layers, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256,
        tie_word_embeddings=layers == 1)).save_pretrained(
            path, safe_serialization=True)


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("spec_models")
    _save_tiny_hf(root / "main", 2, 64)
    _save_tiny_hf(root / "draft", 1, 32)
    return root


def test_config_with_draft_loads_it_through_the_worker(models_dir):
    from localai_tfp_tpu.config.model_config import ModelConfig as JaxConfig
    from localai_tfp_tpu_torch.config.model_config import ModelConfig
    from localai_tfp_tpu_torch.config.app_config import ApplicationConfig
    from localai_tfp_tpu_torch.server.state import Application
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    raw = {"name": "m", "backend": "torch-llm", "context_size": 128,
           "max_batch_slots": 2, "dtype": "float32",
           "parameters": {"model": "main"}, "draft_model": "draft",
           "n_draft": 3}
    cfg = ModelConfig.from_dict(raw)
    jcfg = JaxConfig.from_dict(json.loads(json.dumps(raw)))  # it pops
    assert (cfg.draft_model, cfg.n_draft) == ("draft", 3)
    assert (jcfg.draft_model, jcfg.n_draft) == ("draft", 3)
    assert (ModelConfig().draft_model, ModelConfig().n_draft) == (
        JaxConfig().draft_model, JaxConfig().n_draft)
    for bad in ("../draft", "/abs/draft"):
        assert not ModelConfig.from_dict({**raw, "draft_model": bad}
                                         ).validate()
    (models_dir / "m.yaml").write_text(json.dumps(raw))
    app = Application(ApplicationConfig(models_path=str(models_dir)),
                      device="cpu")
    app.config_loader.load_configs_from_path()
    opts = app.model_loader.load_options(app.config_loader.get("m"))
    assert (opts.draft_model, opts.n_draft) == ("draft", 3)
    b = TorchLLMBackend("cpu")
    res = b.load_model(opts)
    try:
        assert res.success, res.message
        eng = b.engine
        assert eng.draft is not None and eng.n_draft == 3
        assert eng.draft[0].n_layers == 1 and eng.draft[0].d_model == 32
        assert eng.draft_cache is not None
        assert eng.draft[1]["embed"].dtype == torch.float32
        from localai_tfp_tpu_torch.workers.base import PredictOptions

        rep = b.predict(PredictOptions(prompt="hi", tokens=12,
                                       ignore_eos=True))
        assert rep.finish_reason == "length", rep.error
        stats = b.engine_stats()
        assert stats["spec_dispatches"] > 0 and stats["spec_tokens"] > 0
    finally:
        b.shutdown()


@pytest.mark.parametrize("draft", ["draft.gguf", "missing"])
def test_unloadable_draft_fails_the_load(models_dir, draft):
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    b = TorchLLMBackend("cpu")
    res = b.load_model(ModelLoadOptions(
        model="main", model_path=str(models_dir), context_size=128,
        batch_slots=2, dtype="float32", draft_model=draft))
    assert not res.success and b.engine is None
    # a GGUF draft loads when the file exists (tests/test_torch_gguf.py);
    # a missing one, like a missing directory, fails the load
    assert "draft model not found" in res.message
    assert not b.health()
