"""Cancellation in the port's engine (localai_tfp_tpu_torch/engine/
engine.py ``cancel``) against the JAX package's LLMEngine, in f32 on the
CPU, at the smallest input of the race-ahead cancel: ``tiny_spec(
vocab_size=258, max_position=256)`` weights from ``init_params(
PRNGKey(1))``, 2 slots, context 128, prefill buckets (8, 32).

- A cancel that arrives before its request (immediately, or 0.5 s
  before the submit) still drops it: both engines end it "cancelled"
  with 0 tokens, and the port counts it under
  ``engine_cancellations_total{reason="client"}``.
- A cancel id that matches nothing is kept, and an id past
  ``_CANCEL_TTL_S`` is purged by the idle engine and counted as
  ``expired`` (as tests/test_chaos.py holds the JAX engine to it).
- While idle with a kept id the engine thread does not spin: no
  scheduler iteration runs, and the idle wait wakes about twice a
  second.
- A sweep deletes only the ids that matched: cancelling a running
  request ends it "cancelled" and leaves an unmatched id in place.
"""

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
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.telemetry import metrics as tm

KW = dict(n_slots=2, max_seq=128, prefill_buckets=(8, 32))
PROMPT = list(b"hello there")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=258, max_position=256)
    params = init_params(jax.random.PRNGKey(1), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _jax(weights):
    return je.LLMEngine(jax_tiny(vocab_size=258, max_position=256),
                        {k: jnp.asarray(v) for k, v in weights.items()},
                        JaxBytes(), cache_dtype=jnp.float32, **KW)


def _port(weights, **kw):
    return te.LLMEngine(tiny_spec(vocab_size=258, max_position=256),
                        params_from_numpy(weights), ByteTokenizer(),
                        cache_dtype=torch.float32, device="cpu",
                        **{**KW, **kw})


def _count(eng, reason: str) -> float:
    return tm.ENGINE_CANCELLATIONS.labels(model=eng._mlabel,
                                          reason=reason).value


@pytest.mark.parametrize("gap_s", [0.0, 0.5], ids=["immediate", "late"])
def test_race_ahead_cancel_matches_jax(weights, gap_s):
    finals = {}
    for name, mod, make in (("jax", je, _jax), ("port", te, _port)):
        eng = make(weights)
        try:
            eng.start()  # started and idle
            client = _count(eng, "client") if mod is te else 0.0
            eng.cancel("late-1")
            time.sleep(gap_s)
            ev = eng.generate(mod.GenRequest(
                id="late-1", prompt_ids=PROMPT, max_tokens=8,
                ignore_eos=True))
            finals[name] = (ev.finish_reason, ev.completion_tokens)
            if mod is te:
                assert _count(eng, "client") == client + 1
                with eng._lock:
                    assert "late-1" not in eng._cancelled
                # the engine serves on: a later request runs to its end
                ev = eng.generate(te.GenRequest(prompt_ids=PROMPT,
                                                max_tokens=3,
                                                ignore_eos=True))
                assert (ev.finish_reason, ev.completion_tokens) == \
                    ("length", 3)
                eng.leak_check()
        finally:
            eng.close()
    assert finals["port"] == finals["jax"] == ("cancelled", 0)


def test_expired_cancel_is_purged_while_idle_and_counted(weights):
    eng = _port(weights)
    try:
        before = _count(eng, "expired")
        with eng._lock:
            # a cancel that raced ahead of a submit that never came, and
            # one that is still young
            eng._cancelled["ghost-request"] = (
                time.perf_counter() - 2 * eng._CANCEL_TTL_S)
        eng.cancel("young-request")
        eng.start()
        deadline = time.perf_counter() + 5
        while time.perf_counter() < deadline:
            with eng._lock:
                if "ghost-request" not in eng._cancelled:
                    break
            time.sleep(0.05)
        with eng._lock:
            assert "ghost-request" not in eng._cancelled
            assert "young-request" in eng._cancelled
        assert _count(eng, "expired") == before + 1
        assert not eng._pending and not any(s.active for s in eng.slots)
    finally:
        eng.close()


def test_idle_engine_with_a_kept_id_does_not_spin(weights):
    eng = _port(weights)
    calls = {"sweep": 0, "purge": 0}
    sweep, purge = eng._apply_cancellations, eng._purge_expired_cancels

    def sweep_():
        calls["sweep"] += 1
        return sweep()

    def purge_(now):
        calls["purge"] += 1
        return purge(now)

    eng._apply_cancellations, eng._purge_expired_cancels = sweep_, purge_
    try:
        eng.start()
        eng.cancel("nobody")
        time.sleep(1.0)
        # no scheduler iteration while idle; the wait times out every
        # 0.5 s (a spin would run thousands of wakes a second)
        assert calls["sweep"] == 0
        assert 1 <= calls["purge"] <= 4, calls
        with eng._lock:
            assert "nobody" in eng._cancelled
        th = eng._thread
        assert th is not None and th.is_alive()
    finally:
        eng.close()


def _step_until(eng, cond, limit=50):
    for _ in range(limit):
        if cond():
            return
        eng._apply_cancellations()
        eng._admit()
        eng.step()
    raise AssertionError("schedule did not reach its state")


def test_sweep_deletes_only_the_ids_it_matched(weights):
    """Stepped by hand (one schedule): a running request cancelled
    mid-decode ends "cancelled" with the tokens it had, the unmatched id
    stays, and then drops the request that arrives under it."""
    eng = _port(weights, autostart=False)
    try:
        client = _count(eng, "client")
        eng.cancel("unmatched")
        req = te.GenRequest(prompt_ids=PROMPT, max_tokens=100,
                            ignore_eos=True)
        q = eng.submit(req)
        _step_until(eng, lambda: any(len(s.generated) > 1
                                     for s in eng.slots))
        eng.cancel(req.id)
        eng._apply_cancellations()
        evs = [q.get(timeout=5) for _ in range(q.qsize())]
        assert evs[-1].done and evs[-1].finish_reason == "cancelled"
        assert 1 < evs[-1].completion_tokens < 100
        with eng._lock:
            assert set(eng._cancelled) == {"unmatched"}
        assert _count(eng, "client") == client + 1
        # the kept id still drops the request that arrives under it
        q = eng.submit(te.GenRequest(id="unmatched", prompt_ids=PROMPT,
                                     max_tokens=4, ignore_eos=True))
        eng._apply_cancellations()
        ev = q.get(timeout=5)
        assert (ev.done, ev.finish_reason, ev.completion_tokens) == (
            True, "cancelled", 0)
        with eng._lock:
            assert not eng._cancelled
        assert _count(eng, "client") == client + 2
        eng.leak_check()
    finally:
        eng.close()
