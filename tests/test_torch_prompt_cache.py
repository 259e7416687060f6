"""The on-disk prompt cache in the port (``prompt_cache_path``, ``_all``,
``_ro``: localai_tfp_tpu_torch/engine/engine.py ``_try_load_prompt_cache``
and ``_maybe_save_prompt_cache``, the format in engine/kv_tier.py)
against the JAX package's LLMEngine, in f32 on the CPU with 16-token
pages (``LOCALAI_KV_PAGE=16``), on ``tiny_spec(vocab_size=258)`` weights
from ``init_params``.

Each test of tests/test_prompt_cache.py, on the port: save and restore
(the restored engine's text equal to the cold one's, one prompt token
computed, the rows scattered in place into private pages), ``ro``
writes nothing, ``all`` saves the generation too, a corrupt file is
counted as ``error``, int8 rows and scales round-trip, a dtype or shape
mismatch is refused and counted. Then, against the JAX engine:

- a file written by either package restores in both, with greedy ids
  equal to the cold run's and ``prefill_tokens`` equal across the two
  packages (f32 and int8 KV);
- a sequence of requests moves ``engine_prompt_cache_restores_total``
  by the same result labels in both engines (``no_file``, ``restored``,
  ``stale``);
- ``skipped_draft`` is counted when a draft is loaded, and the request
  is served from a full prefill.
"""

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
from localai_tfp_tpu.telemetry import metrics as jm
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.kv_tier import read_cache_file
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.telemetry import metrics as tm

PROMPT = "the quick brown fox jumps over the lazy dog " * 3
N_PROMPT = len(ByteTokenizer().encode(PROMPT, add_bos=True))
KW = dict(n_slots=2, max_seq=256)
RESULTS = ("restored", "stale", "no_file", "error", "shape_mismatch",
           "dtype_mismatch", "skipped_draft")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=258)
    params = init_params(jax.random.PRNGKey(0), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _port(weights, kv="f32", **kw):
    spec = tiny_spec(vocab_size=258)
    return te.LLMEngine(spec, params_from_numpy(weights), ByteTokenizer(),
                        cache_dtype=torch.int8 if kv == "int8"
                        else torch.float32, device="cpu", kv_tier=False,
                        **{**KW, **kw})


def _jax(weights, kv="f32", **kw):
    # no warm KV tier in either engine: its background spills would make
    # the reuse counted here depend on timing
    return je.LLMEngine(jax_tiny(vocab_size=258),
                        {k: jnp.asarray(v) for k, v in weights.items()},
                        JaxBytes(), cache_dtype="int8" if kv == "int8"
                        else jnp.float32, kv_tier=False, **{**KW, **kw})


def _wait_for(path, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            return
        time.sleep(0.05)
    raise AssertionError(f"prompt cache {path} never appeared")


def _counts(eng) -> dict:
    fam = (tm if isinstance(eng, te.LLMEngine) else jm)\
        .ENGINE_PROMPT_CACHE_RESTORES
    return {r: fam.labels(model=eng._mlabel, result=r).value
            for r in RESULTS}


def _delta(after: dict, before: dict) -> dict:
    return {r: after[r] - before[r] for r in RESULTS if after[r] != before[r]}


def _gen(eng, path="", all_=False, ro=False, max_tokens=8, prompt=PROMPT):
    mod = te if isinstance(eng, te.LLMEngine) else je
    ev = eng.generate(mod.GenRequest(
        prompt_ids=eng.tokenizer.encode(prompt, add_bos=True),
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True,
        prompt_cache_path=path, prompt_cache_all=all_, prompt_cache_ro=ro))
    assert ev.finish_reason == "length", ev.error
    return ev


def _ids(eng) -> list:
    """Capture each finishing request's generated ids."""
    got = []
    orig = eng._finish

    def finish(slot, reason):
        got.append(list(slot.generated))
        return orig(slot, reason)

    eng._finish = finish
    return got


def _slot_rows(eng, n: int) -> list:
    """The K and V rows [L, n, F] of the slot holding the prompt."""
    s = next(s for s in eng.slots if len(s.cache_tokens) >= n)
    pages = eng._pool.table(s.idx)[:-(-n // eng.page)]
    return s, [t[:, pages].flatten(1, 2)[:, :n] for t in (eng.cache.k,
                                                           eng.cache.v)]


def test_prompt_cache_save_and_restore(weights, tmp_path):
    path = str(tmp_path / "prompt.cache")
    eng1 = _port(weights)
    try:
        ev1 = _gen(eng1, path)
    finally:
        eng1.close()
    _wait_for(path)  # persistence runs on a background thread
    data = read_cache_file(path)
    assert data["k"].shape[1] <= N_PROMPT  # prompt-only rows saved
    assert data["k"].dtype == np.float32
    assert list(data["tokens"]) == ByteTokenizer().encode(
        PROMPT, add_bos=True)[:data["k"].shape[1]]
    eng2 = _port(weights)
    try:
        ptr = (eng2.cache.k.data_ptr(), eng2.cache.v.data_ptr())
        before = _counts(eng2)
        ev2 = _gen(eng2, path)
        assert ev2.full_text == ev1.full_text
        assert _delta(_counts(eng2), before) == {"restored": 1}
        # the relogit token is the one prompt token computed
        assert eng2.metrics.prefill_tokens == 1
        assert eng2.metrics.prompt_tokens_processed == N_PROMPT
        # restored in place, into private pages holding the file's rows
        assert (eng2.cache.k.data_ptr(), eng2.cache.v.data_ptr()) == ptr
        n = data["k"].shape[1]
        s, rows = _slot_rows(eng2, n)
        assert all(eng2._pool.writable(p)
                   for p in eng2._pool.table(s.idx))
        for got, want in zip(rows, (data["k"], data["v"])):
            assert torch.equal(got, torch.from_numpy(want[:, :n]))
        eng2.leak_check()
    finally:
        eng2.close()


def test_prompt_cache_ro_does_not_write(weights, tmp_path):
    path = str(tmp_path / "ro.cache")
    eng = _port(weights)
    try:
        _gen(eng, path, ro=True)
    finally:
        eng.close()
    time.sleep(0.2)
    assert not os.path.exists(path)


def test_prompt_cache_all_includes_generation(weights, tmp_path):
    path = str(tmp_path / "all.cache")
    eng = _port(weights)
    try:
        _gen(eng, path, all_=True, max_tokens=6)
    finally:
        eng.close()
    _wait_for(path)
    data = read_cache_file(path)
    assert data["tokens"].shape[0] > N_PROMPT  # generation rows included
    assert data["k"].shape[1] == data["tokens"].shape[0]


def test_corrupt_cache_ignored_and_counted(weights, tmp_path):
    path = str(tmp_path / "bad.cache")
    with open(path, "wb") as f:
        f.write(b"not-an-npz")
    eng = _port(weights)
    try:
        before = _counts(eng)
        ev = _gen(eng, path)  # must not crash: a normal prefill
        assert ev.completion_tokens == 8
        assert _delta(_counts(eng), before) == {"error": 1}
        assert eng.metrics.prefill_tokens == N_PROMPT
    finally:
        eng.close()


def test_prompt_cache_quantized_round_trip(weights, tmp_path):
    """int8 K/V rows and their per-row scales survive the disk round
    trip; the restored engine reproduces the cold text."""
    path = str(tmp_path / "q8.cache")
    eng1 = _port(weights, kv="int8")
    try:
        ev1 = _gen(eng1, path)
    finally:
        eng1.close()
    _wait_for(path)
    data = read_cache_file(path)
    assert data["k"].dtype == np.int8
    assert data["k_scale"].dtype == np.float32
    assert data["k_scale"].shape == data["k"].shape[:2]
    eng2 = _port(weights, kv="int8")
    try:
        before = _counts(eng2)
        ev2 = _gen(eng2, path)
        assert ev2.full_text == ev1.full_text
        assert _delta(_counts(eng2), before) == {"restored": 1}
        assert eng2.metrics.prefill_tokens < N_PROMPT
        n = data["k"].shape[1]
        s = next(s for s in eng2.slots if len(s.cache_tokens) >= n)
        pages = eng2._pool.table(s.idx)[:-(-n // eng2.page)]
        got = eng2.cache.k_scale[:, pages].flatten(1, 2)[:, :n]
        assert torch.equal(got, torch.from_numpy(data["k_scale"][:, :n]))
    finally:
        eng2.close()


def test_prompt_cache_dtype_mismatch_rejected(weights, tmp_path):
    """A file of int8 rows is refused (and counted) by an f32 engine."""
    path = str(tmp_path / "mix.cache")
    eng1 = _port(weights, kv="int8")
    try:
        _gen(eng1, path)
    finally:
        eng1.close()
    _wait_for(path)
    eng2 = _port(weights)
    try:
        before = _counts(eng2)
        ev = _gen(eng2, path)
        assert ev.completion_tokens == 8
        assert _delta(_counts(eng2), before) == {"dtype_mismatch": 1}
        assert eng2.metrics.prefill_tokens == N_PROMPT  # nothing restored
    finally:
        eng2.close()


def test_prompt_cache_shape_mismatch_rejected(weights, tmp_path):
    """A file of another model geometry is ignored and counted."""
    path = str(tmp_path / "shape.cache")
    tokens = np.asarray(ByteTokenizer().encode(PROMPT, add_bos=True),
                        np.int32)
    n = len(tokens)
    with open(path, "wb") as f:
        np.savez(f, tokens=tokens, k=np.zeros((7, n, 24), np.float32),
                 v=np.zeros((7, n, 24), np.float32))
    eng = _port(weights)
    try:
        before = _counts(eng)
        ev = _gen(eng, path)
        assert ev.completion_tokens == 8
        assert _delta(_counts(eng), before) == {"shape_mismatch": 1}
    finally:
        eng.close()


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_of_either_package_restores_in_both(weights, tmp_path,
                                                   writer, kv):
    path = str(tmp_path / f"{writer}.cache")
    cold = (_jax if writer == "jax" else _port)(weights, kv)
    ids_cold = _ids(cold)
    try:
        _gen(cold, path)
    finally:
        cold.close()
    _wait_for(path)
    got = {}
    for name, make in (("jax", _jax), ("port", _port)):
        eng = make(weights, kv)
        ids = _ids(eng)
        try:
            before = _counts(eng)
            _gen(eng, path)
            assert _delta(_counts(eng), before) == {"restored": 1}, name
            got[name] = (ids[-1], eng.metrics.prefill_tokens)
        finally:
            eng.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == ids_cold[-1]
    assert got["port"][1] < N_PROMPT


def test_restore_outcomes_are_counted_as_the_jax_engine_counts(weights,
                                                               tmp_path):
    """One single-slot engine per package, the same requests: a missing
    file, a save (its file not written yet), then read-only: another
    prompt sharing only BOS with the file (stale), the saved prompt over
    that resident (restored), and the saved prompt again over its own
    resident (stale)."""
    other = "zzzz " * 40
    moved = {}
    for name, make in (("jax", _jax), ("port", _port)):
        path = str(tmp_path / f"seq-{name}.cache")
        eng = make(weights, n_slots=1)
        ids = _ids(eng)
        try:
            before = _counts(eng)
            _gen(eng, str(tmp_path / f"missing-{name}.cache"), ro=True)
            _gen(eng, path, max_tokens=4)
            _wait_for(path)
            # read-only from here: no later save rewrites the file
            _gen(eng, path, prompt=other, ro=True)
            _gen(eng, path, ro=True)
            _gen(eng, path, ro=True)
            moved[name] = (_delta(_counts(eng), before), ids[:],
                           eng.metrics.prefill_tokens)
        finally:
            eng.close()
    assert moved["port"] == moved["jax"]
    assert moved["port"][0] == {"no_file": 2, "stale": 2, "restored": 1}


def test_no_restore_while_a_draft_is_loaded(weights, tmp_path):
    path = str(tmp_path / "draft.cache")
    eng1 = _port(weights)
    try:
        ev1 = _gen(eng1, path)
    finally:
        eng1.close()
    _wait_for(path)
    spec = tiny_spec(vocab_size=258)
    eng = _port(weights, draft=(spec, params_from_numpy(weights)))
    try:
        before = _counts(eng)
        ev = _gen(eng, path)
        assert _delta(_counts(eng), before) == {"skipped_draft": 1}
        assert eng.metrics.prefill_tokens == N_PROMPT
        assert ev.full_text == ev1.full_text
    finally:
        eng.close()
