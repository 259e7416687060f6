"""The port's weight paging (localai_tfp_tpu_torch/engine/weight_pager.py,
models/weight_slab.py) against the JAX package's
(tests/test_weight_paging.py), on the CPU in f32.

The contract, as the JAX tests hold it, plus the port's own:
``LOCALAI_WEIGHT_PAGING=off`` is structural (no pager at all) and serves
what paging on serves; greedy ids are the JAX engine's hot and after a
demote -> promote round trip (the tree comes back into the same tensors,
so nothing is captured again), and seeded sampling is the paging-off
engine's; an int8 round trip is bitwise on ``q`` and ``scale``;
promotion reseeds the host mirror (the next demotion moves nothing); the
promotion streams per-layer ``w:fetch`` spans, none blocking; HBM
pressure demotes the least recently used engine; the HBM ledger splits
``weights_hot`` / ``weights_warm`` and keeps host bytes out of the
device sum; the two fault points fire under the same ``LOCALAI_FAULTS``
spec in both packages with the same outcome; the watchdog's demote mode
pages an idle model out before it unloads it; and a LoRA update on a
warm engine promotes it first and drops the stale mirror.

Tolerances: none. Ids and weight bits are compared exactly (both
packages in f32 on the CPU, the same numpy weights)."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu.utils import faultinject as jfi
from localai_tfp_tpu_torch.config.model_config import ModelConfig
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.loader import (ModelLoader, WatchDog,
                                                 registry)
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.engine.weight_pager import COORD
from localai_tfp_tpu_torch.models import lora as tl
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.models.quant import QTensor, quantize_params
from localai_tfp_tpu_torch.telemetry import metrics as tm
from localai_tfp_tpu_torch.telemetry.flightrec import FLIGHT
from localai_tfp_tpu_torch.utils import faultinject as fi
from localai_tfp_tpu_torch.workers.base import (Backend, ModelLoadOptions,
                                                Result)
from tests.test_torch_lora import save_adapter

_KNOBS = ("LOCALAI_WEIGHT_PAGING", "LOCALAI_WEIGHT_HBM_MB",
          "LOCALAI_WEIGHT_PREFETCH_AHEAD", "LOCALAI_WEIGHT_INFLIGHT_MB",
          "LOCALAI_WATCHDOG_DEMOTE")
KW = dict(n_slots=2, max_seq=128, prefill_buckets=(8, 32))
PROMPT = "the quick brown fox"


@pytest.fixture(autouse=True)
def _knob_guard():
    saved = {k: os.environ.get(k) for k in _KNOBS}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    fi.disarm()
    jfi.disarm()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _numpy_weights(seed: int) -> dict:
    spec = jax_tiny(vocab_size=258, max_position=256)
    params = init_params(jax.random.PRNGKey(seed), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def weights():
    return _numpy_weights(0)


def _spied(eng):
    """Record each request's exact generated ids as it finishes (the
    stream's events group a dispatch's tokens)."""
    eng.generated_ids = {}
    finish = eng._finish

    def spy(slot, reason):
        if slot.request is not None:
            eng.generated_ids[slot.request.id] = list(slot.generated)
        return finish(slot, reason)

    eng._finish = spy
    return eng


def _engine(weights, paging, tree=None, **kw):
    os.environ["LOCALAI_WEIGHT_PAGING"] = paging
    return _spied(te.LLMEngine(tiny_spec(vocab_size=258, max_position=256),
                               tree if tree is not None
                               else params_from_numpy(weights),
                               ByteTokenizer(), cache_dtype=torch.float32,
                               device="cpu", **KW, **kw))


def _jax_engine(weights, paging="off"):
    os.environ["LOCALAI_WEIGHT_PAGING"] = paging
    return _spied(je.LLMEngine(
        jax_tiny(vocab_size=258, max_position=256),
        {k: jnp.asarray(v) for k, v in weights.items()}, JaxBytes(),
        cache_dtype=jnp.float32, **KW))


def _run(eng, prompt=PROMPT, max_tokens=12, temperature=0.0, seed=7):
    """(generated ids, finish reason, terminal events) of one request."""
    req = (te.GenRequest if isinstance(eng, te.LLMEngine)
           else je.GenRequest)(prompt_ids=eng.tokenizer.encode(prompt),
                               max_tokens=max_tokens,
                               temperature=temperature, seed=seed,
                               ignore_eos=True)
    q = eng.submit(req)
    finals = 0
    while True:
        ev = q.get(timeout=120)
        if ev.done:
            finals += 1
            break
    time.sleep(0.05)
    while not q.empty():  # exactly one terminal
        if q.get_nowait().done:
            finals += 1
    return eng.generated_ids[req.id], ev.finish_reason, finals


def _demote_now(pager, timeout=30.0):
    """A demotion needs a quiescent engine: retry until it takes."""
    deadline = time.monotonic() + timeout
    while not pager.request_demote():
        assert time.monotonic() < deadline, "engine never went quiet"
        time.sleep(0.01)
    assert pager.settle(timeout)


@pytest.fixture(scope="module")
def jax_greedy(weights):
    """The JAX engine's greedy ids for PROMPT (12 tokens) and 4 tokens."""
    eng = _jax_engine(weights)
    try:
        return {n: _run(eng, max_tokens=n)[0] for n in (12, 4)}
    finally:
        eng.close()
        os.environ.pop("LOCALAI_WEIGHT_PAGING", None)


# ---------------------------------------------------------------------------
# the off knob: structural, the same output


def test_off_knob_is_structural(weights):
    off = _engine(weights, "off")
    on = _engine(weights, "on")
    forced = _engine(weights, "on", weight_paging=False)
    try:
        assert off._pager is None
        assert on._pager is not None
        assert forced._pager is None  # the constructor beats the knob
        # the JAX engine builds its pager under the same conditions
        jon = _jax_engine(weights, "on")
        try:
            assert jon._pager is not None
        finally:
            jon.close()
    finally:
        for e in (off, on, forced):
            e.close()


def test_a_paging_engine_owns_the_dict_it_is_given(weights):
    """The slab replaces the given dict's leaves in place (no second copy
    of the tree). A second engine given a dict of its own over those
    leaves (a fresh engine swapped in for the first) copies them into a
    slab of its own and leaves the first engine's dict as it was."""
    tree = params_from_numpy(weights)
    eng = _engine(weights, "on", tree=tree)

    def in_slab(d, e):
        buf = e._pager.slab._buf.untyped_storage().data_ptr()
        return all(t.untyped_storage().data_ptr() == buf
                   for v in d.values()
                   for t in (tuple(v) if isinstance(v, QTensor) else (v,)))

    try:
        assert eng.params is tree and in_slab(tree, eng)
        other = _engine(weights, "on", tree=dict(tree))
        try:
            assert in_slab(other.params, other) and in_slab(tree, eng)
            assert not in_slab(tree, other)
            assert _run(other)[0] == _run(eng)[0]
        finally:
            other.close()
    finally:
        eng.close()


def test_greedy_ids_hot_and_after_round_trip_are_jax(weights, jax_greedy):
    off = _engine(weights, "off")
    try:
        assert _run(off)[0] == jax_greedy[12]
    finally:
        off.close()
    eng = _engine(weights, "on")
    try:
        pager = eng._pager
        eng.warmup()  # every variant made while hot
        variants = eng.variant_count()
        assert _run(eng)[0] == jax_greedy[12], "hot paged engine diverged"
        _demote_now(pager)
        assert pager.state == "warm" and not pager.slab.mapped
        toks, fin, finals = _run(eng)
        assert finals == 1 and fin == "length"
        assert toks == jax_greedy[12], "round trip changed the ids"
        assert pager.counters["promotes"] == 1
        # the weights came back into the same tensors: nothing new to make
        assert eng.variant_count() == variants
        pager.leak_check()
    finally:
        eng.close()


def test_seeded_sampling_is_the_paging_off_engine_s(weights):
    def sampled(paging, round_trip):
        eng = _engine(weights, paging)
        try:
            if round_trip:
                _demote_now(eng._pager)
            return _run(eng, temperature=0.9, seed=1234)[:2]
        finally:
            eng.close()

    want = sampled("off", False)
    assert sampled("on", False) == want
    assert sampled("on", True) == want, "seeded sampling diverged"


def test_demote_between_pop_and_assign_waits_for_the_step(weights,
                                                         jax_greedy):
    """A demotion asked for after the admission pass took the wave off the
    queue, but before its request reached a slot (the engine shows no work
    then), is refused: the scheduler holds the weight gate from a granted
    poll until the wave's step ends. The slab stays mapped, the request
    is served with the JAX engine's ids, and once the engine is idle the
    demotion takes."""
    eng = _engine(weights, "on")
    try:
        pager = eng._pager
        pick = eng._pick_slot
        seen = []

        def racing_pick(req):
            if not seen:  # the scheduler's thread, between pop and _assign
                idle = not eng._has_work()
                started = pager.request_demote(reason="race")
                if started:
                    pager.settle(30)  # let it land, as a seed drop would
                seen.append((idle, started, pager.slab.mapped))
            return pick(req)

        eng._pick_slot = racing_pick
        toks, fin, finals = _run(eng, max_tokens=4)
        del eng._pick_slot
        assert seen == [(True, False, True)], seen
        assert finals == 1 and fin == "length" and toks == jax_greedy[4]
        assert pager.state == "hot" and pager.slab.mapped
        assert pager.counters["demotes"] == 0
        _demote_now(pager)  # idle now: the demotion takes
        assert pager.state == "warm" and not pager.slab.mapped
        pager.leak_check()
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# demote -> promote: bit-exact, int8 planes included


def test_round_trip_bit_exact_quantized(weights):
    qtree = quantize_params(params_from_numpy(weights))
    assert any(isinstance(v, QTensor) for v in qtree.values())
    before = {k: (tuple(t.clone() for t in v) if isinstance(v, QTensor)
                  else v.clone()) for k, v in qtree.items()}
    eng = _engine(weights, "on", tree=qtree)
    try:
        pager = eng._pager
        _demote_now(pager)
        assert pager.state == "warm" and eng.params is None
        assert pager.counters["demotes"] == 1
        toks, fin, finals = _run(eng, max_tokens=4)
        assert finals == 1 and toks
        assert pager.state == "hot" and pager.counters["promotes"] == 1
        assert set(eng.params) == set(before)
        for k, want in before.items():
            got = eng.params[k]
            got = tuple(got) if isinstance(got, QTensor) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert torch.equal(g, w), f"{k}: bits changed in transit"
        pager.leak_check()
    finally:
        eng.close()


def test_promote_reseeds_host_mirror(weights):
    """After a promotion the mirror still matches the tree: the next
    demotion is a zero-copy seed drop."""
    eng = _engine(weights, "on")
    try:
        pager = eng._pager
        _demote_now(pager)
        _run(eng, max_tokens=2)  # warm -> promote -> serve
        assert pager.state == "hot"
        FLIGHT.clear()
        _demote_now(pager)
        assert pager.counters["demotes"] == 2
        assert pager.counters["seed_demotes"] == 1
        names = [e[1] for e in FLIGHT._buf if e is not None]
        assert "w:demote" not in names, "a seed drop copied the tree"
        pager.leak_check()
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the promotion's stream: per-layer spans, none blocking


def test_prefetch_never_records_blocking_transfer(weights):
    was = FLIGHT.enabled
    FLIGHT.enabled = True
    eng = _engine(weights, "on")
    try:
        pager = eng._pager
        _demote_now(pager)
        FLIGHT.clear()
        _run(eng, max_tokens=4)  # the promotion streams the pages back
        assert pager.state == "hot"
        trace = FLIGHT.export_chrome_trace()
        tracks = {ev["tid"]: ev["args"]["name"]
                  for ev in trace["traceEvents"]
                  if ev.get("ph") == "M" and ev["name"] == "thread_name"}
        spans = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
        w = [ev for ev in spans if tracks.get(ev["tid"]) == "weights"]
        fetches = [ev for ev in w if ev["name"] == "w:fetch"]
        assert len(fetches) >= tiny_spec().n_layers, \
            "the promotion did not stream per-layer fetches"
        assert any(ev["name"] == "w:promote" for ev in w)
        assert all(ev["args"]["blocking"] is False for ev in w), \
            "a weight transfer blocked the scheduler"
        steps = [ev for ev in spans if ev["name"].startswith("step:")]
        assert steps, "no device step spans recorded"
        for b in (ev for ev in w if ev["args"]["blocking"]):
            for s in steps:  # empty by construction: the real check
                assert (s["ts"] + s["dur"] <= b["ts"]
                        or s["ts"] >= b["ts"] + b["dur"])
    finally:
        FLIGHT.enabled = was
        eng.close()


# ---------------------------------------------------------------------------
# the cross-engine LRU under HBM pressure


def test_pressure_demotes_lru_engine(weights):
    ea = _engine(weights, "on", tree=params_from_numpy(_numpy_weights(1)))
    eb = _engine(weights, "on", tree=params_from_numpy(_numpy_weights(2)))
    try:
        a, b = ea._pager, eb._pager
        _run(ea, max_tokens=2)  # A touched first: the LRU victim
        _run(eb, max_tokens=2)
        # a budget of ~1.5 trees: promoting B must evict exactly A
        budget_mb = (a.tree_bytes() * 1.5) / (1 << 20)
        os.environ["LOCALAI_WEIGHT_HBM_MB"] = f"{budget_mb:.6f}"
        _demote_now(b)
        before = COORD.counters["pressure_demotes"]
        _run(eb, max_tokens=2)  # promote -> pressure -> demote A
        assert b.state == "hot"
        assert COORD.counters["pressure_demotes"] > before
        deadline = time.monotonic() + 30
        while a.state != "warm":
            assert time.monotonic() < deadline, \
                f"the LRU victim never went warm (state={a.state})"
            time.sleep(0.01)
        assert ea.params is None and not a.slab.mapped
        a.leak_check()
        b.leak_check()
    finally:
        os.environ["LOCALAI_WEIGHT_HBM_MB"] = "0"
        ea.close()
        eb.close()


# ---------------------------------------------------------------------------
# the HBM ledger: hot and warm, host bytes out of the device sum


def test_ledger_hot_warm_reconcile(weights):
    eng = _engine(weights, "on")
    try:
        pager, led = eng._pager, eng._ledger
        assert led is not None
        attr = led.attributed()
        assert attr["weights_hot"] == pager.tree_bytes() > 0
        assert attr["weights_warm"] == 0
        assert "weights" not in attr  # replaced by the tiered pair
        _demote_now(pager)
        attr = led.attributed()
        assert attr["weights_hot"] == 0
        assert attr["weights_warm"] == pager.host_bytes() > 0
        snap = led.reconcile(lambda: None)
        # warm bytes live in host RAM: never counted as device bytes
        assert snap["attributed"] == sum(
            b for n, b in snap["components"].items() if n != "weights_warm")
        assert pager.tier_pages() == {"hot": 0, "warm": pager.n_pages}
        eng.update_gauges()
        assert tm.ENGINE_WEIGHT_PAGES.labels(
            model="default", tier="warm").snapshot()["value"] \
            == pager.n_pages
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# chaos: one LOCALAI_FAULTS spec, both packages, the same outcome


def _fault_on_demote(eng, arm):
    pager = eng._pager
    arm("weights.demote:fail@1")
    deadline = time.monotonic() + 30
    while not pager.request_demote():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert pager.settle(30)
    return pager.state, pager.counters["faulted_demotes"]


def test_fault_on_demote_stays_hot_and_serves(weights, jax_greedy):
    jeng = _jax_engine(weights, "on")
    try:
        want = _fault_on_demote(jeng, jfi.arm)
    finally:
        jfi.disarm()
        jeng.close()
    eng = _engine(weights, "on")
    try:
        assert _fault_on_demote(eng, fi.arm) == want == ("hot", 1)
        assert eng.params is not None and eng._pager.slab.mapped
        fi.disarm()
        toks, fin, finals = _run(eng, max_tokens=4)
        assert finals == 1 and toks == jax_greedy[4]
        eng._pager.leak_check()
    finally:
        eng.close()


def _fault_on_fetch(eng, arm, disarm):
    pager = eng._pager
    _demote_now(pager)
    arm("weights.fetch:fail@1")
    try:
        toks, fin, finals = _run(eng, max_tokens=4)
    finally:
        disarm()
    return (toks, finals, pager.state, pager.counters["cold_fallbacks"],
            pager.counters["faulted_fetches"])


def test_fault_on_fetch_falls_back_cold(weights, jax_greedy):
    jeng = _jax_engine(weights, "on")
    try:
        want = _fault_on_fetch(jeng, jfi.arm, jfi.disarm)
    finally:
        jeng.close()
    assert want == (jax_greedy[4], 1, "hot", 1, 1)
    eng = _engine(weights, "on")
    try:
        assert _fault_on_fetch(eng, fi.arm, fi.disarm) == want, \
            "the cold fallback diverged from the JAX engine's"
        eng._pager.leak_check()
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# a LoRA update on a warm engine


def test_lora_update_on_a_warm_engine_promotes_first(weights, tmp_path):
    spec = tiny_spec(vocab_size=258, max_position=256)
    save_adapter(tmp_path / "a", spec)
    eng = _engine(weights, "on")
    fresh = _engine(weights, "off")
    try:
        pager = eng._pager
        _demote_now(pager)
        assert pager.state == "warm"
        n = eng.update_params(lambda p: tl.merge_lora(
            spec, p, str(tmp_path / "a"), inplace=True)[1])
        assert n > 0 and pager.state == "hot"
        assert pager.counters["promotes"] == 1
        # the mirror no longer matches the merged tree: dropped
        assert pager.stats()["seeded"] is False
        fresh.update_params(lambda p: tl.merge_lora(
            spec, p, str(tmp_path / "a"), inplace=True)[1])
        assert _run(eng)[0] == _run(fresh)[0]
        _demote_now(pager)
        assert pager.counters["seed_demotes"] == 0  # it copied again
        assert _run(eng)[0] == _run(fresh)[0]
        pager.leak_check()
    finally:
        eng.close()
        fresh.close()


# ---------------------------------------------------------------------------
# the watchdog's demote mode


class _PagedBackend(Backend):
    """Scripted demote_weights: the first idle tick demotes, later ticks
    report the model already warm."""

    def __init__(self, device=None):
        self.script = ["demoted", "warm"]

    def load_model(self, opts: ModelLoadOptions) -> Result:
        return Result(True)

    def health(self):
        return True

    def shutdown(self):
        pass

    def demote_weights(self):
        return self.script.pop(0) if self.script else "warm"


def _loader_with(backend_cls):
    saved = dict(registry._factories)
    registry._factories.clear()
    registry.register("torch-llm", backend_cls)
    ml = ModelLoader()
    ml.load(ModelConfig.from_dict({"name": "m", "backend": "torch-llm",
                                   "parameters": {"model": "dir"}}))
    return ml, saved


def _restore(ml, saved):
    registry._factories.clear()
    registry._factories.update(saved)
    ml.stop_all()


def test_watchdog_demote_mode():
    os.environ["LOCALAI_WATCHDOG_DEMOTE"] = "on"
    ml, saved = _loader_with(_PagedBackend)
    try:
        ml.mark_idle("m")
        wd = WatchDog(ml, idle_timeout=100, enable_idle=True)
        child = tm.MODEL_EVICTIONS.labels(reason="watchdog_demote")
        before = child.snapshot()["value"]
        # first expiry: demoted, not unloaded; the idle clock restarts
        assert wd.check(time.monotonic() + 101) == []
        assert ml.loaded_names() == ["m"]
        assert child.snapshot()["value"] == before + 1
        # idle through another full timeout while warm: unloaded
        assert wd.check(time.monotonic() + 300) == ["m"]
        assert ml.loaded_names() == []
    finally:
        _restore(ml, saved)


def test_watchdog_demote_busy_transfer_skips_tick():
    os.environ["LOCALAI_WATCHDOG_DEMOTE"] = "on"

    class Busy(_PagedBackend):
        def __init__(self, device=None):
            super().__init__()
            self.script = ["busy", "busy"]

    ml, saved = _loader_with(Busy)
    try:
        ml.mark_idle("m")
        wd = WatchDog(ml, idle_timeout=10, enable_idle=True)
        # a demotion in flight: neither a demote count nor an unload
        assert wd.check(time.monotonic() + 11) == []
        assert ml.loaded_names() == ["m"]
    finally:
        _restore(ml, saved)


def test_watchdog_demote_off_keeps_kill_path():
    os.environ["LOCALAI_WATCHDOG_DEMOTE"] = "off"
    ml, saved = _loader_with(_PagedBackend)
    try:
        ml.mark_idle("m")
        wd = WatchDog(ml, idle_timeout=10, enable_idle=True)
        assert wd.check(time.monotonic() + 11) == ["m"]
        assert ml.loaded_names() == []
    finally:
        _restore(ml, saved)
