"""The port's disaggregated prefill/decode serving
(localai_tfp_tpu_torch/engine/kv_migrate.py) against the JAX package's
(tests/test_disagg.py), on the CPU in f32.

The contract, as the JAX tests hold it: a long prompt relays prefill ->
migrate -> decode across two engines and re-prefills no prompt token on
the decode side (its pages adopted by reference from the host
interchange, its sampler row and generator state with them, so seeded
output is the single engine's); its greedy ids are the JAX
``DisaggRouter``'s and the port's single engine's; short prompts stay
local; every failure (capture fault, adoption fault, a migrate-stage
deadline, device-step chaos, a cancel) ends in a re-prefill or one
attributed terminal with both pools ``leak_check``-clean; and no device
step of either engine overlaps a blocking migration transfer.

Tolerances: none. Ids and texts are compared exactly (f32 on the CPU,
the same numpy weights in both packages)."""

import os
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine import kv_migrate as jkm
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.kv_migrate import (DisaggRouter,
                                                     build_prefill_engine)
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.telemetry.flightrec import FLIGHT
from localai_tfp_tpu_torch.telemetry.metrics import REGISTRY
from localai_tfp_tpu_torch.utils import faultinject as fi

_KNOBS = ("LOCALAI_KV_PAGE", "LOCALAI_DISAGG", "LOCALAI_DISAGG_MIN_PROMPT",
          "LOCALAI_DISAGG_MIN_MS", "LOCALAI_DISAGG_MIGRATE_DEADLINE_S",
          "LOCALAI_DISAGG_PREFILL_SLOTS", "LOCALAI_WEIGHT_PAGING")
LONG = "disaggregated migration probe " + "w " * 24  # > 4 pages
SHORT = "hi"
KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=258, max_position=512)
    params = init_params(jax.random.PRNGKey(0), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _spec():
    return tiny_spec(vocab_size=258, max_position=512)


def _plain(weights, **kw):
    """A plain port engine (no router, no migrator: LOCALAI_DISAGG=off)."""
    return te.LLMEngine(_spec(), params_from_numpy(weights), ByteTokenizer(),
                        cache_dtype=torch.float32, device="cpu", **KW, **kw)


@pytest.fixture(scope="module")
def pair(weights):
    """One port pair for the module: a 4-slot decode engine and a 2-slot
    prefill sibling behind the router, 16-token pages."""
    saved = {k: os.environ.get(k) for k in _KNOBS}
    os.environ["LOCALAI_KV_PAGE"] = "16"
    os.environ["LOCALAI_DISAGG_MIN_PROMPT"] = "16"
    os.environ["LOCALAI_DISAGG_MIGRATE_DEADLINE_S"] = "10"
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        params = params_from_numpy(weights)
        # a pair shares one tree by reference: no paging (as the worker
        # builds it under LOCALAI_DISAGG)
        decode = te.LLMEngine(_spec(), params, ByteTokenizer(),
                              cache_dtype=torch.float32, device="cpu",
                              weight_paging=False, **KW)
        prefill = build_prefill_engine(_spec(), params, ByteTokenizer(),
                                       decode=decode)
        router = DisaggRouter(prefill, decode)
        router.start()
        yield router
        router.close()
    finally:
        torch.set_num_threads(n)
        fi.disarm()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _metrics() -> dict:
    """Every sample of the port's registry: line -> value."""
    out = {}
    for line in REGISTRY.render().splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def _delta(before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in _metrics().items()
            if v != before.get(k, 0.0)}


def _drain(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        if ev.done:
            return ev


def _drain_exactly_one_terminal(q, timeout=120):
    final = _drain(q, timeout)
    # a second done event would complete an HTTP response twice
    time.sleep(0.2)
    extra = []
    try:
        while True:
            ev = q.get_nowait()
            if ev.done:
                extra.append(ev)
    except queue.Empty:
        pass
    assert not extra, f"stream carried {1 + len(extra)} terminals"
    return final


def _settle(router, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        busy = bool(router.pumps())
        for eng in (router.prefill, router.decode):
            with eng._lock:
                busy = busy or eng._has_work()
        if not busy:
            break
        time.sleep(0.02)
    time.sleep(0.05)


def _leak_checks(router):
    router.decode.leak_check()
    router.prefill.leak_check()
    assert router.bus.live_blocks() == 0, (
        f"interchange holds {router.bus.live_blocks()} pages after settle")


def _seeded(prompt_ids, **over):
    kw = dict(prompt_ids=prompt_ids, max_tokens=8, temperature=0.8,
              top_k=40, seed=7, ignore_eos=True)
    kw.update(over)
    return te.GenRequest(**kw)


def _ids(router, text):
    return router.tokenizer.encode(text)


# ---------------------------------------------------------------------------
# the off switch: structural


def test_default_engine_has_no_disagg_hooks(weights):
    e = _plain(weights)
    try:
        assert e._migrator is None
        assert e._deadline_stage == "decode"
        assert te.GenRequest(prompt_ids=[1]).disagg is None
    finally:
        e.close()


def test_router_refuses_a_paged_engine(weights):
    decode = _plain(weights, weight_paging=True)
    prefill = build_prefill_engine(_spec(), decode.params, ByteTokenizer(),
                                   decode=decode)
    try:
        with pytest.raises(ValueError, match="weight_paging=False"):
            DisaggRouter(prefill, decode)
    finally:
        prefill.close()
        decode.close()


# ---------------------------------------------------------------------------
# routing: short prompts never relay


def test_short_prompt_stays_local(pair):
    captures0 = pair.prefill._migrator.counters["captures"]
    pub0 = pair.bus.counters["published"]
    final = pair.generate(_seeded(_ids(pair, SHORT), max_tokens=4))
    assert final.finish_reason == "length", final.error
    assert pair.prefill._migrator.counters["captures"] == captures0
    assert pair.bus.counters["published"] == pub0
    _settle(pair)
    _leak_checks(pair)


# ---------------------------------------------------------------------------
# the tentpole: zero re-prefill, the single engine's output


def test_long_prompt_migrates_zero_reprefill_byte_identical(pair, weights):
    ids = _ids(pair, LONG)
    ref_eng = _plain(weights)
    try:
        ref = _drain(ref_eng.submit(_seeded(list(ids))))
    finally:
        ref_eng.close()
    assert ref.finish_reason == "length", ref.error

    before = _metrics()
    prompt0 = pair.decode.metrics.prompt_tokens_processed
    adopt0 = pair.decode._migrator.counters["adoptions"]
    reused0 = pair.decode._migrator.counters["reused_tokens"]
    final = _drain_exactly_one_terminal(pair.submit(_seeded(list(ids))))
    _settle(pair)

    assert final.finish_reason == "length", final.error
    # the sampler row and generator state migrated with the pages: the
    # relay continues the seeded stream the single engine produced
    assert final.full_text == ref.full_text
    assert final.completion_tokens == ref.completion_tokens
    # zero re-prefill, three ways
    assert pair.decode.metrics.prompt_tokens_processed == prompt0
    assert pair.decode._migrator.counters["adoptions"] == adopt0 + 1
    assert (pair.decode._migrator.counters["reused_tokens"] - reused0
            == len(ids))
    d = _delta(before)
    assert any(k.startswith("engine_kv_migrated_pages_total")
               and 'outcome="migrated"' in k for k in d)
    assert any(k.startswith("engine_kv_migration_seconds_count") for k in d)
    assert any(k.startswith("engine_disagg_requests_total")
               and 'path="disagg"' in k for k in d)
    for stage in ("queued", "prefill", "migrate", "decode"):
        assert any(k.startswith("engine_disagg_stage_seconds_count")
                   and f'stage="{stage}"' in k for k in d), (stage, d)
    # prompt processing is the prefill engine's time plus the migration,
    # and TTFT spans the whole relay
    assert final.timing_prompt_processing_ms > 0.0
    assert final.timing_first_token_ms > 0.0
    assert final.timing_queue_ms >= 0.0
    _leak_checks(pair)


@pytest.fixture(scope="module")
def jax_greedy_relay(weights):
    """Greedy ids of LONG through the JAX package's DisaggRouter."""
    saved = {k: os.environ.get(k) for k in _KNOBS}
    os.environ.update(LOCALAI_KV_PAGE="16", LOCALAI_DISAGG_MIN_PROMPT="16",
                      LOCALAI_DISAGG_MIGRATE_DEADLINE_S="10")
    spec = jax_tiny(vocab_size=258, max_position=512)
    params = {k: jnp.asarray(v) for k, v in weights.items()}
    try:
        decode = je.LLMEngine(spec, params, JaxBytes(),
                              cache_dtype=jnp.float32, **KW)
        prefill = jkm.build_prefill_engine(spec, params, JaxBytes(),
                                           decode=decode,
                                           cache_dtype=jnp.float32)
        router = jkm.DisaggRouter(prefill, decode)
        router.start()
        try:
            q = router.submit(je.GenRequest(
                prompt_ids=router.tokenize(LONG), max_tokens=12,
                ignore_eos=True))
            ids = []
            while True:
                ev = q.get(timeout=120)
                if ev.token_id is not None:
                    ids.append(ev.token_id)
                if ev.done:
                    break
            return ids, router.decode._migrator.counters["adoptions"]
        finally:
            router.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_greedy_relay_matches_jax_router_and_single_engine(
        pair, weights, jax_greedy_relay):
    want, jax_adoptions = jax_greedy_relay
    assert jax_adoptions == 1  # the JAX request migrated too
    req = te.GenRequest(prompt_ids=_ids(pair, LONG), max_tokens=12,
                        ignore_eos=True)
    adopt0 = pair.decode._migrator.counters["adoptions"]
    q = pair.submit(req)
    got = []
    while True:
        ev = q.get(timeout=120)
        if ev.token_id is not None:
            got.append(ev.token_id)
        if ev.done:
            break
    assert pair.decode._migrator.counters["adoptions"] == adopt0 + 1
    assert got == want, "the port's relay diverged from the JAX relay"
    single = _plain(weights)
    try:
        q = single.submit(te.GenRequest(prompt_ids=_ids(pair, LONG),
                                        max_tokens=12, ignore_eos=True))
        ids = []
        while True:
            ev = q.get(timeout=120)
            if ev.token_id is not None:
                ids.append(ev.token_id)
            if ev.done:
                break
    finally:
        single.close()
    assert ids == want
    _settle(pair)
    _leak_checks(pair)


def test_disagg_on_off_seeded_identity_under_load(pair, weights):
    """A mixed wave (2 long, 2 short) streams the same seeded bytes
    through the router as through a plain engine."""
    prompts = [LONG + "a", SHORT + " x", LONG + "b", SHORT + " y"]

    def run(target):
        reqs = [_seeded(_ids(pair, p)) for p in prompts]
        return [_drain(q).full_text for q in target.submit_many(reqs)]

    got = run(pair)
    _settle(pair)
    ref_eng = _plain(weights)
    try:
        want = run(ref_eng)
    finally:
        ref_eng.close()
    assert got == want
    _leak_checks(pair)


# ---------------------------------------------------------------------------
# chaos: each failure re-prefills or ends once, nothing leaks


def test_migrate_fault_falls_back_to_reprefill(pair):
    prompt0 = pair.decode.metrics.prompt_tokens_processed
    faults0 = pair.prefill._migrator.counters["capture_faults"]
    before = _metrics()
    fi.arm("disagg.migrate:fail@1")
    try:
        final = _drain_exactly_one_terminal(
            pair.submit(_seeded(_ids(pair, LONG + " mfault"))))
    finally:
        fi.disarm()
    _settle(pair)
    assert final.finish_reason == "length", final.error
    assert pair.prefill._migrator.counters["capture_faults"] == faults0 + 1
    # the fallback re-prefilled on the decode engine
    assert pair.decode.metrics.prompt_tokens_processed > prompt0
    assert any(k.startswith("engine_disagg_requests_total")
               and 'path="fallback"' in k for k in _delta(before))
    _leak_checks(pair)


def test_handoff_fault_falls_back_to_reprefill(pair):
    """The decode side's adoption fails: the handoff's pages release and
    the request re-prefills in place, with one terminal."""
    prompt0 = pair.decode.metrics.prompt_tokens_processed
    faults0 = pair.decode._migrator.counters["adopt_faults"]
    fi.arm("disagg.handoff:fail@1")
    try:
        final = _drain_exactly_one_terminal(
            pair.submit(_seeded(_ids(pair, LONG + " hfault"))))
    finally:
        fi.disarm()
    _settle(pair)
    assert final.finish_reason == "length", final.error
    assert pair.decode._migrator.counters["adopt_faults"] == faults0 + 1
    assert pair.decode.metrics.prompt_tokens_processed > prompt0
    _leak_checks(pair)


def test_deadline_overrun_during_migrate_attributed(pair, monkeypatch):
    """When the migrate stage eats the deadline, the router itself ends
    the request (neither engine owns it then), stage=migrate."""
    before = _metrics()

    def stalled_collect(rid, timeout):
        # a wedged transport: the whole window, nothing delivered
        time.sleep(min(timeout + 0.1, 30.0))
        return None, "timeout"

    monkeypatch.setattr(pair.bus, "collect", stalled_collect)
    final = _drain_exactly_one_terminal(
        pair.submit(_seeded(_ids(pair, LONG + " ddl"), timeout_s=3.0)))
    monkeypatch.undo()
    _settle(pair)
    assert final.finish_reason == "deadline_exceeded", (
        final.finish_reason, final.error)
    assert any(k.startswith("engine_deadline_exceeded_total")
               and 'stage="migrate"' in k for k in _delta(before))
    _leak_checks(pair)


def test_device_step_chaos_one_terminal_both_pools_clean(pair):
    """Device-step faults land on both engines mid-relay: every stream
    still ends once, and both pools come back clean."""
    fi.arm("engine.device_step:rate@0.25@13")
    try:
        qs = pair.submit_many(
            [_seeded(_ids(pair, f"{LONG} storm {i}"), max_tokens=4)
             for i in range(4)])
        finals = [_drain_exactly_one_terminal(q) for q in qs]
    finally:
        fi.disarm()
    _settle(pair)
    for f in finals:
        assert f.finish_reason in ("length", "error", "stop"), f
    _leak_checks(pair)


def test_cancel_covers_both_engines(pair):
    req = _seeded(_ids(pair, LONG + " cancel me"), max_tokens=64)
    q = pair.submit(req)
    pair.cancel(req.id)
    final = _drain_exactly_one_terminal(q)
    # whatever stage the cancel caught, one terminal and nothing leaks
    assert final.done
    _settle(pair)
    _leak_checks(pair)


# ---------------------------------------------------------------------------
# the asynchronous guarantee: migration never blocks a device step


def test_no_device_step_overlaps_blocking_migration(pair):
    FLIGHT.clear()
    qs = pair.submit_many(
        [_seeded(_ids(pair, f"{LONG} overlap {i}")) for i in range(3)])
    for q in qs:
        assert _drain(q).finish_reason == "length"
    _settle(pair)
    trace = FLIGHT.export_chrome_trace()
    tracks = {ev["tid"]: ev["args"]["name"] for ev in trace["traceEvents"]
              if ev.get("ph") == "M" and ev["name"] == "thread_name"}
    spans = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
    mig = [ev for ev in spans if tracks.get(ev["tid"]) == "migrate"
           and ev["name"].startswith("kv:migrate")]
    steps = [ev for ev in spans if tracks.get(ev["tid"]) == "device"
             and ev["name"].startswith("step:")]
    assert {ev["name"] for ev in mig} >= {"kv:migrate_out",
                                          "kv:migrate_in"}, mig
    assert steps, "no device step spans recorded"
    assert all(ev["args"]["blocking"] is False for ev in mig)
    for b in (ev for ev in mig if ev["args"]["blocking"]):
        for s in steps:  # empty by construction: the real check
            assert (s["ts"] + s["dur"] <= b["ts"]
                    or s["ts"] >= b["ts"] + b["dur"]), (s, b)
    _leak_checks(pair)
