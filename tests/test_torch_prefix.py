"""Prefix page sharing in the port (localai_tfp_tpu_torch/engine/
prefix_index.py and the prefix part of engine/engine.py) against the JAX
package on the same inputs.

- ``PrefixIndex`` and ``common_prefix_len`` give the JAX copies' outputs
  under the same seeded operation sequence.
- On a tiny Llama (``init_params`` on ``tiny_spec`` in f32, carried across
  by ``models/convert.py``, ``LOCALAI_KV_PAGE=16``) the port's engine and
  the JAX engine on the CPU (its XLA gather path) serve the same request
  schedule; greedy token ids must be EQUAL, request by request, for: a
  whole-page shared prefix (zero page copies), an unaligned prefix (only
  the tail page copied), an active donor, a same-wave group (the prefix
  prefilled once), copy-on-write at the relogit -1 step, reclaim under
  pool pressure, and int8 KV pages. The copy, share and COW counts match
  the JAX engine's too.
- No page leaks after churn; ``LOCALAI_PREFIX_CACHE=off`` gives the same
  token ids as on.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine import prefix_index as jax_prefix_index
from localai_tfp_tpu.engine.prefix_index import PrefixIndex as JaxIndex
from localai_tfp_tpu.engine.prefix_index import (
    common_prefix_len as jax_common,
)
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine import prefix_index as port_prefix_index
from localai_tfp_tpu_torch.engine.prefix_index import (
    PrefixIndex,
    common_prefix_len,
)
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec

VOCAB = ByteTokenizer().vocab_size
ENGINE_KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=VOCAB, max_position=512)
    params = init_params(jax.random.PRNGKey(0), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _port(weights):
    return te.LLMEngine(tiny_spec(vocab_size=VOCAB, max_position=512),
                        params_from_numpy(weights), ByteTokenizer(),
                        cache_dtype=torch.float32, device="cpu",
                        kv_tier=False, **ENGINE_KW)


def _engines(weights, int8=False, **kw):
    """(JAX engine, port engine) on the same weights and settings, both
    with the KV tier off: the tier demotes a resident idle past
    ``LOCALAI_KV_TIER_IDLE_S``, so on a loaded host its reclaims would
    depend on the clock, and its prefetches move the page copy and share
    counts compared here (tests/test_torch_kv_tier.py holds the tier)."""
    kw = {**ENGINE_KW, **kw}
    jeng = je.LLMEngine(
        jax_tiny(vocab_size=VOCAB, max_position=512),
        {k: jnp.asarray(v) for k, v in weights.items()}, JaxBytes(),
        cache_dtype="int8" if int8 else jnp.float32, kv_tier=False, **kw)
    teng = te.LLMEngine(
        tiny_spec(vocab_size=VOCAB, max_position=512),
        params_from_numpy(weights), ByteTokenizer(),
        cache_dtype=torch.int8 if int8 else torch.float32, device="cpu",
        kv_tier=False, **kw)
    return jeng, teng


class Spy:
    """Each request's generated ids at finish, and the page copies (the
    JAX engine's kvcopy dispatches, the port's ``_kv_copy`` calls)."""

    def __init__(self, eng):
        self.ids = {}
        self.copies = 0
        fin = eng._finish

        def finish(slot, reason):
            if slot.request is not None:
                self.ids[slot.request.id] = list(slot.generated)
            return fin(slot, reason)

        eng._finish = finish
        if isinstance(eng, te.LLMEngine):
            copy = eng._kv_copy

            def kv_copy(src, dst):
                self.copies += 1
                return copy(src, dst)

            eng._kv_copy = kv_copy
        else:
            run = eng._run

            def run_(kind, payload):
                if kind == "kvcopy":
                    self.copies += 1
                return run(kind, payload)

            eng._run = run_


def _drain(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        if ev.done:
            return ev


def _first_token(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        assert not ev.done, f"finished early: {ev.finish_reason} {ev.error}"
        if ev.token_id is not None:
            return ev


def _wait_idle(eng, timeout=30):
    """Until no slot is active (a finished request's slot is released
    just after its final event)."""
    t0 = time.time()
    while any(s.active for s in eng.slots):
        assert time.time() - t0 < timeout
        time.sleep(0.005)


def _req(mod, ids, n):
    return mod.GenRequest(prompt_ids=list(ids), max_tokens=n,
                          ignore_eos=True)


def _donor_then_sharer(mod, eng, donor, sharer, n_donor=24, n_sharer=8):
    """An active donor: the sharer arrives while the donor decodes."""
    a, b = _req(mod, donor, n_donor), _req(mod, sharer, n_sharer)
    qa = eng.submit(a)
    _first_token(qa)
    qb = eng.submit(b)
    evs = [_drain(qb), _drain(qa)]
    return [a, b], evs


def _run_both(weights, script, **kw):
    """Run ``script(mod, eng)`` -> (requests, final events) on both
    engines; returns per engine (ids per request, events, spy, engine)."""
    out = []
    jeng, teng = _engines(weights, **kw)
    try:
        for mod, eng in ((je, jeng), (te, teng)):
            spy = Spy(eng)
            reqs, evs = script(mod, eng)
            _wait_idle(eng)
            for ev in evs:
                assert ev.finish_reason == "length", ev.error
            out.append(([spy.ids[r.id] for r in reqs], evs, spy, eng))
    finally:
        jeng.close()
        teng.close()
    return out


# ------------------------------------------------------------- unit level


def test_common_prefix_len_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = rng.integers(0, 4, int(rng.integers(0, 60))).tolist()
        b = rng.integers(0, 4, int(rng.integers(0, 60))).tolist()
        if rng.random() < 0.5:
            b = a[:int(rng.integers(0, len(a) + 1))] + b
        assert common_prefix_len(a, b) == jax_common(a, b)


class _Clock:
    """A ``time`` stand-in whose ``monotonic`` reads a value the test
    sets: ``sync`` stamps new slots with the clock, and two real reads
    microseconds apart would make the two indexes' ``value`` differ."""

    def __init__(self, now: float) -> None:
        self.now = now

    def monotonic(self) -> float:
        return self.now


@pytest.mark.parametrize("seed", range(4))
def test_prefix_index_matches_jax_under_seeded_ops(seed, monkeypatch):
    """The same random sequence of set_tokens / remove / sync / touch on
    both indexes, under one fake clock the test advances; every query
    agrees."""
    clock = _Clock(1000.0)
    monkeypatch.setattr(port_prefix_index, "time", clock)
    monkeypatch.setattr(jax_prefix_index, "time", clock)
    rng = np.random.default_rng(seed)
    ours, ref = PrefixIndex(), JaxIndex()
    base = rng.integers(0, 6, 80).tolist()

    def seq():
        n = int(rng.integers(0, 80))
        head = base[:int(rng.integers(0, n + 1))]
        return head + rng.integers(0, 6, n - len(head)).tolist()

    for step in range(300):
        op = rng.integers(0, 5)
        slot = int(rng.integers(0, 6))
        now = clock.now = 1000.0 + step
        if op == 0:
            s = seq()
            ours.set_tokens(slot, s, now=now)
            ref.set_tokens(slot, s, now=now)
        elif op == 1:
            ours.remove(slot)
            ref.remove(slot)
        elif op == 2:
            pairs = [(i, seq()) for i in range(6) if rng.random() < 0.6]
            ours.sync(pairs)
            ref.sync(pairs)
        elif op == 3:
            ours.touch(slot, now)
            ref.touch(slot, now)
        q = seq()
        ex = frozenset(int(x) for x in rng.integers(0, 6, 2))
        assert ours.match(q) == ref.match(q)
        assert ours.match(q, exclude=ex) == ref.match(q, exclude=ex)
        for i in range(6):
            assert ours.registered_len(i) == ref.registered_len(i)
            assert ours.value(i, now) == ref.value(i, now)
        assert ours.resident_tokens() == ref.resident_tokens()


# ----------------------------------------------------------- engine level


def test_whole_page_shared_prefix_zero_copies_matches_jax(weights):
    prefix = list(range(1, 33))  # 2 full 16-token pages

    def script(mod, eng):
        return _donor_then_sharer(mod, eng, prefix + [40, 41, 42, 43],
                                  prefix + [50, 51, 52, 53])

    (jids, _, jspy, jeng), (tids, _, tspy, teng) = _run_both(weights, script)
    assert tids == jids
    assert tspy.copies == jspy.copies == 0
    assert teng._pool.allocs["shared"] == jeng._pool.allocs["shared"] == 2
    assert teng.metrics.prefix_reused_tokens >= len(prefix)
    teng.leak_check()


def test_unaligned_prefix_copies_only_the_tail_page_matches_jax(weights):
    prefix = list(range(1, 41))  # 2 full pages + an 8-row tail

    def script(mod, eng):
        return _donor_then_sharer(mod, eng, prefix + [60, 61],
                                  prefix + [70, 71])

    (jids, _, jspy, jeng), (tids, _, tspy, teng) = _run_both(weights, script)
    assert tids == jids
    assert tspy.copies == jspy.copies == 1
    assert teng.metrics.prefix_copies == jeng.metrics.prefix_copies == 1
    assert teng._pool.allocs["shared"] == jeng._pool.allocs["shared"] == 2
    teng.leak_check()


def test_active_donor_output_untouched_matches_jax(weights):
    """The sharer's prefill covers only its tail; donor and sharer give
    the JAX engine's ids, and the ids of a port engine with sharing off."""
    tk = ByteTokenizer()
    prefix = tk.encode("shared system prompt: you are helpful. " * 3)
    a = prefix + tk.encode("user alpha", add_bos=False)
    b = prefix + tk.encode("user beta?", add_bos=False)

    def script(mod, eng):
        return _donor_then_sharer(mod, eng, a, b, n_donor=40)

    (jids, _, _, jeng), (tids, _, tspy, teng) = _run_both(weights, script)
    assert tids == jids
    assert tspy.copies == 1
    assert teng.metrics.prefill_tokens == jeng.metrics.prefill_tokens
    assert teng.metrics.prefill_tokens <= len(a) + len(b) - len(prefix) + 1
    off = _port(weights)
    off._prefix_enabled = False
    try:
        spy = Spy(off)
        want = []
        for ids, n in ((a, 40), (b, 8)):
            r = _req(te, ids, n)
            assert off.generate(r).finish_reason == "length"
            want.append(spy.ids[r.id])
    finally:
        off.close()
    assert tids == want


def _wave(prompts):
    def script(mod, eng):
        reqs = [_req(mod, p, 4) for p in prompts]
        return reqs, [_drain(q) for q in eng.submit_many(reqs)]
    return script


def test_same_wave_group_prefills_the_prefix_once_matches_jax(weights):
    tk = ByteTokenizer()
    prefix = tk.encode("common preamble for every request " * 3)
    tails = [tk.encode(t, add_bos=False) for t in ("A0", "B1", "C2", "D3")]
    prompts = [prefix + t for t in tails]
    (jids, _, jspy, jeng), (tids, _, tspy, teng) = _run_both(
        weights, _wave(prompts))
    assert tids == jids
    want = len(prompts[0]) + sum(len(t) for t in tails[1:])
    assert teng.metrics.prefill_tokens == jeng.metrics.prefill_tokens == want
    assert tspy.copies == jspy.copies == 3
    assert teng.metrics.prefix_reused_tokens == 3 * len(prefix)
    teng.leak_check()


def test_cow_at_the_relogit_step_matches_jax(weights):
    """A prompt resident in full in a slot whose pages another slot
    shares: re-admitting it steps back one position into a shared page,
    which is copied before the write."""
    x = list(range(1, 33))  # 2 full pages

    def script(mod, eng):
        reqs, evs = _donor_then_sharer(mod, eng, x, x + [60, 61, 62])
        _wait_idle(eng)
        again = _req(mod, x, 8)
        return reqs + [again], evs + [eng.generate(again)]

    (jids, _, jspy, jeng), (tids, _, tspy, teng) = _run_both(
        weights, script, n_slots=2)
    assert tids == jids
    assert teng._pool.allocs["cow"] == jeng._pool.allocs["cow"] == 1
    assert tspy.copies == jspy.copies == 1
    teng.leak_check()


def test_reclaim_under_pool_pressure_matches_jax(weights):
    """Eleven data pages: the third 60-token prompt finds the pool held
    by two free residents and reclaims the least valuable."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 250, 60).tolist() for _ in range(3)]

    def script(mod, eng):
        reqs = [_req(mod, p, 6) for p in prompts]
        evs = []
        for r in reqs:
            evs.append(eng.generate(r))
            _wait_idle(eng)
        return reqs, evs

    (jids, _, _, jeng), (tids, _, _, teng) = _run_both(
        weights, script, kv_pages=12)
    assert tids == jids
    held = [len(s.cache_tokens) for s in teng.slots]
    assert held == [len(s.cache_tokens) for s in jeng.slots]
    assert held.count(0) >= 2  # one resident reclaimed, one slot unused
    teng.leak_check()


def test_int8_pages_unaligned_prefix_matches_jax(weights):
    prefix = list(range(3, 43))

    def script(mod, eng):
        return _donor_then_sharer(mod, eng, prefix + [90, 91],
                                  prefix + [95, 96], n_donor=12)

    (jids, _, jspy, _), (tids, _, tspy, teng) = _run_both(
        weights, script, int8=True)
    assert tids == jids
    assert tspy.copies == jspy.copies == 1
    teng.leak_check()


def test_churn_leaves_no_page_leaks(weights):
    """Waves beyond slot capacity, a cancel in each, slot reuse: the
    pool's invariants hold, and dropping the residents frees every page."""
    eng = _port(weights)
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 200, 40).tolist()
    try:
        for _ in range(3):
            reqs = [te.GenRequest(
                prompt_ids=(shared if rng.random() < 0.5 else [])
                + [int(x) for x in rng.integers(1, 200,
                                                int(rng.integers(4, 60)))],
                max_tokens=int(rng.integers(2, 12)), ignore_eos=True)
                for _ in range(eng.n_slots + 2)]
            qs = eng.submit_many(reqs)
            eng.cancel(reqs[0].id)
            for q in qs:
                _drain(q)
        _wait_idle(eng)
        eng.leak_check()
        for s in eng.slots:
            eng._pool.drop(s.idx)
        st = eng._pool.stats()
        assert st.in_use == 0 and st.refs == 0 and st.free == st.total
    finally:
        eng.close()


@pytest.mark.parametrize("case", ["wave", "donor"])
def test_prefix_cache_off_gives_the_same_ids(weights, monkeypatch, case):
    tk = ByteTokenizer()
    prefix = tk.encode("a shared opening that every request carries " * 2)
    tails = [tk.encode(t, add_bos=False) for t in ("x1", "y2", "z3")]

    def run():
        eng = _port(weights)
        spy = Spy(eng)
        try:
            if case == "wave":
                reqs, _ = _wave([prefix + t for t in tails])(te, eng)
            else:
                reqs, _ = _donor_then_sharer(te, eng, prefix + tails[0],
                                             prefix + tails[1])
            _wait_idle(eng)
            eng.leak_check()
            return [spy.ids[r.id] for r in reqs], eng.metrics
        finally:
            eng.close()

    on, m_on = run()
    monkeypatch.setenv("LOCALAI_PREFIX_CACHE", "off")
    off, m_off = run()
    assert on == off
    assert m_on.prefill_tokens < m_off.prefill_tokens
    assert m_off.prefix_copies == 0
