"""The port's engine (localai_tfp_tpu_torch/engine/engine.py) against the
JAX package's LLMEngine on the same weights, in f32 on the CPU.

- Greedy token streams under staggered mixed traffic (two streams
  decoding while a burst of three admits, one prompt long enough to need
  non-final chunks — the schedule of tests/test_mixed_dispatch.py) are
  identical: generated ids, full text, finish reason, token counts.
- Stop strings end both engines at the same place.
- The page pool is leak-free afterwards.
- ``GenRequest`` and ``StreamEvent`` keep the JAX package's field names
  and defaults; ``LOCALAI_MAX_QUEUE`` sheds with a retry hint.
"""

import dataclasses

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

ENGINE_KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=258, max_position=512)
    params = init_params(jax.random.PRNGKey(1), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_engine(weights):
    spec = jax_tiny(vocab_size=258, max_position=512)
    eng = je.LLMEngine(spec, {k: jnp.asarray(v) for k, v in weights.items()},
                       JaxBytes(), cache_dtype=jnp.float32, **ENGINE_KW)
    eng._prefix_enabled = False  # prefix reuse is not in the port's slice
    yield eng
    eng.close()


@pytest.fixture
def torch_engine(weights):
    eng = te.LLMEngine(tiny_spec(vocab_size=258, max_position=512),
                       params_from_numpy(weights), ByteTokenizer(),
                       cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
    yield eng
    eng.close()


class FinishSpy:
    """Each request's exact generated ids at finish time."""

    def __init__(self, eng):
        self.generated = {}
        self._orig = eng._finish
        eng._finish = self._finish

    def _finish(self, slot, reason):
        if slot.request is not None:
            self.generated[slot.request.id] = list(slot.generated)
        return self._orig(slot, reason)


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


def _schedule(mod, eng, tk):
    """Two streams decode, then a burst of three admits mid-stream (one
    prompt needs non-final chunks: it is longer than the 128 bucket)."""
    fin = FinishSpy(eng)
    ra = mod.GenRequest(prompt_ids=tk.encode("stream alpha stays live"),
                        max_tokens=30, ignore_eos=True)
    rb = mod.GenRequest(prompt_ids=tk.encode("stream beta stays live too"),
                        max_tokens=30, ignore_eos=True)
    qa, qb = eng.submit(ra), eng.submit(rb)
    _first_token(qa)
    _first_token(qb)
    burst = [
        mod.GenRequest(prompt_ids=tk.encode("one burst request " * 9),
                       max_tokens=6, ignore_eos=True),
        mod.GenRequest(prompt_ids=tk.encode("two burst request"),
                       max_tokens=12),
        mod.GenRequest(prompt_ids=tk.encode("three burst request " * 10),
                       max_tokens=6, ignore_eos=True),
    ]
    qs = eng.submit_many(burst)
    out = {}
    for name, r, q in zip("cde", burst, qs):
        out[name] = (r, _drain(q))
    out["a"] = (ra, _drain(qa))
    out["b"] = (rb, _drain(qb))
    return {n: (fin.generated[r.id], ev.full_text, ev.finish_reason,
                ev.completion_tokens, ev.prompt_tokens)
            for n, (r, ev) in out.items()}


def test_greedy_streams_match_jax_under_mixed_traffic(jax_engine,
                                                      torch_engine):
    want = _schedule(je, jax_engine, JaxBytes())
    got = _schedule(te, torch_engine, ByteTokenizer())
    for name in want:
        assert got[name] == want[name], f"stream {name} diverged"
    m = torch_engine.metrics
    assert m.mixed_steps > 0 and m.decode_steps > 0
    torch_engine.leak_check()
    for s in torch_engine.slots:
        assert not s.active


def test_stop_strings_match_jax(jax_engine, torch_engine):
    tk = ByteTokenizer()
    prompt = tk.encode("where does it stop")
    free = jax_engine.generate(je.GenRequest(prompt_ids=prompt,
                                             max_tokens=24, ignore_eos=True))
    stop = free.full_text[8:10]
    assert stop, "the greedy continuation is too short to pick a stop"
    want = jax_engine.generate(je.GenRequest(
        prompt_ids=prompt, max_tokens=24, ignore_eos=True, stop=[stop]))
    got = torch_engine.generate(te.GenRequest(
        prompt_ids=prompt, max_tokens=24, ignore_eos=True, stop=[stop]))
    assert (got.full_text, got.finish_reason, got.completion_tokens) == (
        want.full_text, want.finish_reason, want.completion_tokens)
    assert got.finish_reason == "stop"
    torch_engine.leak_check()


@pytest.mark.parametrize("cls", ["GenRequest", "StreamEvent"])
def test_request_and_event_fields_match_jax(cls):
    def shape(c):
        out = {}
        for f in dataclasses.fields(c):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                v = f.default_factory()
                out[f.name] = type(v) if f.name == "id" else v
            else:
                out[f.name] = "required"
        return out

    assert shape(getattr(te, cls)) == shape(getattr(je, cls))


def test_max_queue_sheds_with_retry_hint(weights, monkeypatch):
    monkeypatch.setenv("LOCALAI_MAX_QUEUE", "1")
    eng = te.LLMEngine(tiny_spec(vocab_size=258, max_position=512),
                       params_from_numpy(weights), ByteTokenizer(),
                       cache_dtype=torch.float32, device="cpu",
                       autostart=False, **ENGINE_KW)
    try:
        reqs = [te.GenRequest(prompt_ids=[1, 2, 3], max_tokens=2)
                for _ in range(3)]
        qs = eng.submit_many(reqs)
        shed = [q.get(timeout=5) for q in qs[1:]]
        assert all(e.done and e.finish_reason == "shed"
                   and e.retry_after_s >= 0.5 for e in shed)
        eng.start()
        ev = _drain(qs[0])
        assert ev.finish_reason == "length" and ev.completion_tokens == 2
    finally:
        eng.close()


def test_unserved_features_are_refused_not_ignored(torch_engine):
    ev = torch_engine.generate(te.GenRequest(prompt_ids=[1, 2],
                                             logit_bias={3: -100.0}))
    assert ev.finish_reason == "error" and "logit_bias" in ev.error
    ev = torch_engine.generate(te.GenRequest(prompt_ids=list(range(256))))
    assert ev.finish_reason == "error" and "context size" in ev.error
