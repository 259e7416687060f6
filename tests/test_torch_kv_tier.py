"""The port's KV tier (localai_tfp_tpu_torch/engine/kv_tier.py and its
hooks in engine/engine.py) against the JAX package's on the same inputs.

Both engines serve a tiny Llama (``init_params`` on ``tiny_spec`` in f32,
carried across by ``models/convert.py``) with the tier on,
``LOCALAI_KV_PAGE=16`` and ``LOCALAI_KV_TIER_IDLE_S=0``, through the
scenarios of ``tests/test_kv_tier.py``. Ids are compared exactly; counts
exactly:

- churn then return: 4 prefetch hits in both, equal
  ``prefix_reused_tokens`` and equal greedy ids (f32 and int8 pages);
- a shared prefix spills once: equal ``dedup_pages`` and host pages;
- a cold file written by either package loads in the other and serves
  the same greedy ids as a fresh prefill;
- the faults ``kv_tier.spill`` and ``kv_tier.fetch`` fall back to a
  re-prefill with equal ids and equal fault counts;
- ``leak_check`` is clean for tier and pool after every scenario;
- ``kv_tier=False`` (or ``LOCALAI_KV_TIER=off``) leaves no tier object;
- seeded sampling (the port's Gumbel noise) is byte-identical with the
  tier on and off;
- every ``kv:*`` timeline span is non-blocking, beside ``step:*`` spans.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine import kv_tier as jax_kv_tier
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu.utils import faultinject as jax_faults
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine import kv_tier as port_kv_tier
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.telemetry.flightrec import FLIGHT
from localai_tfp_tpu_torch.utils import faultinject as port_faults

VOCAB = ByteTokenizer().vocab_size
KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))
USERS = [f"user {i:02d} " + "context " * 5 + f"tail{i}" for i in range(8)]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    monkeypatch.setenv("LOCALAI_KV_TIER", "on")
    monkeypatch.setenv("LOCALAI_KV_TIER_IDLE_S", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax_faults.disarm()
    port_faults.disarm()


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=VOCAB, max_position=512)
    params = init_params(jax.random.PRNGKey(0), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _jax(weights, int8=False, **kw):
    return je.LLMEngine(jax_tiny(vocab_size=VOCAB, max_position=512),
                        {k: jnp.asarray(v) for k, v in weights.items()},
                        JaxBytes(),
                        cache_dtype="int8" if int8 else jnp.float32,
                        **{**KW, **kw})


def _port(weights, int8=False, **kw):
    return te.LLMEngine(tiny_spec(vocab_size=VOCAB, max_position=512),
                        params_from_numpy(weights), ByteTokenizer(),
                        cache_dtype=torch.int8 if int8 else torch.float32,
                        device="cpu", **{**KW, **kw})


def _ids(text):
    return ByteTokenizer().encode(text)


def _serve(eng, prompts, max_tokens=6, **req):
    """One admission wave; the generated ids of each request in order."""
    reqs = [type_(eng)(prompt_ids=_ids(p), max_tokens=max_tokens,
                       ignore_eos=True, **req) for p in prompts]
    out = []
    for q in eng.submit_many(reqs):
        ids = []
        while True:
            ev = q.get(timeout=120)
            if ev.token_id is not None:
                ids.append(ev.token_id)
            if ev.done:
                assert ev.finish_reason == "length", ev.error
                break
        out.append(ids)
    return out


def type_(eng):
    return te.GenRequest if isinstance(eng, te.LLMEngine) else je.GenRequest


def _settle(eng, timeout_s=30.0):
    """Wait for the scheduler to go quiet, then drive tier ticks from
    this thread until every in-flight transfer lands."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        with eng._lock:
            idle = (not eng._pending
                    and not getattr(eng, "_flights", None)
                    and not any(s.active for s in eng.slots))
        if idle:
            break
        time.sleep(0.02)
    time.sleep(0.05)
    eng._tier.settle()


def _leak_checks(eng):
    eng._tier.leak_check()
    eng._pool.leak_check()


class Finished:
    """Each request's generated ids at finish (every token, not only the
    ones the stream's coalesced events name)."""

    def __init__(self, eng):
        self.ids = []
        fin = eng._finish

        def finish(slot, reason):
            if slot.request is not None:
                self.ids.append((slot.request.prompt_ids,
                                 list(slot.generated)))
            return fin(slot, reason)

        eng._finish = finish

    def by_prompt(self):
        return sorted((tuple(p), g) for p, g in self.ids)


@pytest.fixture
def pair(weights):
    engines = []

    def make(int8=False):
        j, t = _jax(weights, int8), _port(weights, int8)
        assert j._tier is not None and t._tier is not None
        engines.extend((j, t))
        return j, t

    yield make
    for e in engines:
        e.close()


def _churn_and_return(eng):
    """Two waves of distinct sessions (the second reassigns every slot,
    so capture-on-reuse spills the first), then the first returns.
    Returns (hits, reused tokens, spills) of the return wave."""
    tier = eng._tier
    _serve(eng, USERS[:4])
    _serve(eng, USERS[4:])
    _settle(eng)
    spills = tier.counters["spills"]
    hits0 = tier.counters["prefetch_hit"]
    reused0 = eng.metrics.prefix_reused_tokens
    _serve(eng, USERS[:4])
    _settle(eng)
    _leak_checks(eng)
    return (tier.counters["prefetch_hit"] - hits0,
            eng.metrics.prefix_reused_tokens - reused0, spills)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_churn_then_return_matches_jax(pair, int8):
    j, t = pair(int8)
    fj, ft = Finished(j), Finished(t)
    got = [_churn_and_return(e) for e in (j, t)]
    assert got[0] == got[1], got
    hits, reused, spills = got[1]
    assert hits == 4 and spills >= 4
    # each hit re-prefills only the relogit token
    assert reused == sum(len(_ids(u)) for u in USERS[:4]) - 4
    assert ft.by_prompt() == fj.by_prompt()
    assert len(ft.ids) == 12
    assert t._tier.stats()["host_pages"] == j._tier.stats()["host_pages"]
    t.leak_check()


def test_shared_prefix_spills_once_as_jax(pair):
    shared = "shared system preamble " * 3  # 4 full pages of prefix
    out = []
    for eng in pair():
        tier = eng._tier
        _serve(eng, [shared + "alpha", shared + "beta"])
        _settle(eng)
        sa, sb = (s for s in eng.slots
                  if s.cache_tokens[:8] == _ids(shared)[:8])
        dedup0 = tier.counters["dedup_pages"]
        pages0 = tier.stats()["host_pages"]
        now = time.perf_counter()
        tier._spill(sa, urgent=True, now=now)
        _settle(eng)
        tier._spill(sb, urgent=True, now=now)
        _settle(eng)
        _leak_checks(eng)
        out.append((tier.counters["dedup_pages"] - dedup0,
                    tier.stats()["host_pages"] - pages0))
    assert out[0] == out[1]
    assert out[1][0] >= len(_ids(shared)) // 16


def _save_cold(eng, prompt, cold_dir):
    """Serve ``prompt``, spill its slot and save the entry to disk;
    returns (entry, generated ids)."""
    fin = Finished(eng)
    _serve(eng, [prompt])
    _settle(eng)
    tier = eng._tier
    slot = next(s for s in eng.slots if s.cache_tokens[:8] == _ids(prompt)[:8])
    tier._spill(slot, urgent=True, now=time.perf_counter())
    _settle(eng)
    ent = next(e for e in tier._entries.values()
               if e.tokens[:8] == _ids(prompt)[:8])
    tier.cold_dir = str(cold_dir)
    tier._start_save(ent)
    _settle(eng)
    assert ent.state == "cold" and ent.path and ent.hpids == []
    return ent, fin.ids[0][1]


def _load_cold(eng, entry_cls, ent, prompt):
    """Hand a cold entry (another package's file) to ``eng``'s tier, serve
    ``prompt`` on it; returns (loads, hits, generated ids)."""
    tier = eng._tier
    eid = tier._next_id
    tier._next_id += 1
    tier._entries[eid] = entry_cls(eid, list(ent.tokens), ent.n, [], "cold",
                                   path=ent.path)
    tier._disk_pages += -(-ent.n // tier.P)
    fin = Finished(eng)
    _serve(eng, [prompt])
    _settle(eng)
    _leak_checks(eng)
    return tier.counters["loads"], tier.counters["prefetch_hit"], fin.ids[0][1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cold_file_crosses_packages(pair, tmp_path, writer):
    j, t = pair()
    prompt = "cold storage session " + "x " * 20 + "end"
    src, dst = (j, t) if writer == "jax" else (t, j)
    ent, ids = _save_cold(src, prompt, tmp_path)
    with np.load(ent.path) as data:
        assert set(data.files) >= {"tokens", "k", "v"}
        assert data["k"].shape[1] == ent.n
    entry_cls = (port_kv_tier._Entry if dst is t else jax_kv_tier._Entry)
    loads, hits, got = _load_cold(dst, entry_cls, ent, prompt)
    assert (loads, hits) == (1, 1)
    assert got == ids


@pytest.mark.parametrize("point", ["kv_tier.spill", "kv_tier.fetch"])
def test_tier_faults_fall_back_to_reprefill_as_jax(pair, point):
    j, t = pair()
    fj, ft = Finished(j), Finished(t)
    jax_faults.arm(f"{point}:fail")
    port_faults.arm(f"{point}:fail")
    got = [_churn_and_return(e) for e in (j, t)]
    # no hit: only the residents' short common prefixes are reused
    assert got[0][:2] == got[1][:2] and got[1][0] == 0
    keys = ("spill_faults", "fetch_faults", "prefetch_late", "spills")
    assert ([j._tier.counters[k] for k in keys]
            == [t._tier.counters[k] for k in keys])
    assert t._tier.counters[point.split(".")[1] + "_faults"] >= 4
    assert port_faults.counts()[point] == jax_faults.counts()[point]
    assert ft.by_prompt() == fj.by_prompt()


def test_tier_off_has_no_tier_object(weights, monkeypatch):
    eng = _port(weights, kv_tier=False)
    try:
        assert eng._tier is None
        assert _serve(eng, ["plain"], max_tokens=3)[0]
        eng._pool.leak_check()
    finally:
        eng.close()
    monkeypatch.setenv("LOCALAI_KV_TIER", "off")
    eng = _port(weights)
    try:
        assert eng._tier is None and eng.tier_stats() is None
    finally:
        eng.close()


def test_seeded_sampling_is_identical_with_the_tier_on_and_off(weights):
    waves = [USERS[:4], USERS[4:], USERS[:4]]  # the third returns

    def run(eng):
        try:
            return [_serve(eng, w, max_tokens=10, temperature=0.8,
                           top_k=40, seed=7) for w in waves]
        finally:
            eng.close()

    on = _port(weights)
    hits = on._tier.counters
    got_on = run(on)
    assert hits["prefetch_hit"] >= 1
    assert got_on == run(_port(weights, kv_tier=False))


def test_kv_spans_never_block(weights):
    eng = _port(weights)
    try:
        FLIGHT.clear()
        _serve(eng, [f"overlap probe {i} " + "y " * 24 for i in range(6)])
        _settle(eng)
        trace = FLIGHT.export_chrome_trace()
        tracks = {ev["tid"]: ev["args"]["name"]
                  for ev in trace["traceEvents"]
                  if ev.get("ph") == "M" and ev["name"] == "thread_name"}
        spans = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
        kv = [ev for ev in spans if tracks.get(ev["tid"]) == "kv_tier"
              and ev["name"].startswith("kv:")]
        steps = [ev for ev in spans if tracks.get(ev["tid"]) == "device"
                 and ev["name"].startswith("step:")]
        assert kv, "traffic recorded no tier transfer spans"
        assert steps, "traffic recorded no device step spans"
        assert all(ev["args"]["blocking"] is False for ev in kv)
        for b in [ev for ev in kv if ev["args"]["blocking"]]:
            for s in steps:
                assert (s["ts"] + s["dur"] <= b["ts"]
                        or s["ts"] >= b["ts"] + b["dur"])
        _leak_checks(eng)
    finally:
        eng.close()


def test_weight_update_drops_the_tier(weights):
    """A LoRA hot apply changes the weights: every tier entry (old K/V)
    is dropped, so a returning session re-prefills."""
    eng = _port(weights)
    try:
        _serve(eng, USERS[:4])
        _serve(eng, USERS[4:])
        _settle(eng)
        assert eng._tier.stats()["entries_warm"] >= 4
        eng.update_params(lambda p: None)
        st = eng._tier.stats()
        assert st["entries_warm"] == 0 and st["host_pages"] == 0
        hits0 = eng._tier.counters["prefetch_hit"]
        _serve(eng, USERS[:4])
        _settle(eng)
        assert eng._tier.counters["prefetch_hit"] == hits0
        _leak_checks(eng)
    finally:
        eng.close()
