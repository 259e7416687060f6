"""The port's sampler (localai_tfp_tpu_torch/ops/sampling.py) against the
JAX package's ops/sampling.py on the same logits and slot parameters.

- greedy rows pick exactly the JAX token;
- the filtered candidate distributions (top_k -> typical_p -> top_p ->
  min_p, and mirostat v1/v2) match within 1e-6;
- seeded draws match token for token when the port is fed JAX's own
  Gumbel noise, and so do the penalty window and the mirostat mu update
  that follow the draw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.ops import sampling as js
from localai_tfp_tpu_torch.ops import sampling as ts

S, V = 4, 200
# per-slot request parameters: greedy + penalties, top-k/top-p/min-p,
# typical, mirostat v2, mirostat v1
ROWS = [
    dict(temperature=0.0, repeat_penalty=1.3, freq_penalty=0.2,
         presence_penalty=0.1),
    dict(temperature=0.8, top_k=20, top_p=0.9, min_p=0.05),
    dict(temperature=1.1, typical_p=0.7),
    dict(temperature=0.9, mirostat=2, mirostat_tau=3.0, mirostat_eta=0.2),
]
MIRO_V1 = dict(temperature=0.9, mirostat=1, mirostat_tau=4.0,
               mirostat_eta=0.1)
# the JAX reference, jitted once per shape (eager op-by-op is slow on CPU)
_jsample = jax.jit(js.sample)
_jseed = jax.jit(js.seed_windows)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cols(rows):
    fields = ("temperature", "top_k", "top_p", "min_p", "repeat_penalty",
              "freq_penalty", "presence_penalty", "repeat_last_n",
              "typical_p", "mirostat", "mirostat_tau", "mirostat_eta")
    defaults = dict(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0,
                    repeat_penalty=0.0, freq_penalty=0.0,
                    presence_penalty=0.0, repeat_last_n=8, typical_p=1.0,
                    mirostat=0, mirostat_tau=5.0, mirostat_eta=0.1)
    return {f: [r.get(f, defaults[f]) for r in rows] for f in fields}


def _states(rows, window=16):
    """Both samplers reset identically, penalty windows seeded from the
    same prompt tails."""
    cols = _cols(rows)
    ids = list(range(len(rows)))
    jst = js.SamplingState.create(len(rows), V, window=window)
    i32, f32 = np.int32, np.float32
    jst = js.reset_slots(
        jst, jnp.asarray(ids, i32), *(jnp.asarray(cols[f], dt) for f, dt in (
            ("temperature", f32), ("top_k", i32), ("top_p", f32),
            ("min_p", f32), ("repeat_penalty", f32), ("freq_penalty", f32),
            ("presence_penalty", f32), ("repeat_last_n", i32))),
        jnp.asarray([7] * len(rows), i32), jnp.ones(len(rows), bool),
        *(jnp.asarray(cols[f], dt) for f, dt in (
            ("typical_p", f32), ("mirostat", i32), ("mirostat_tau", f32),
            ("mirostat_eta", f32))))
    tst = ts.SamplingState.create(len(rows), V, window=window)
    ts.reset_slots(tst, ids, cols, [7] * len(rows))
    rng = np.random.default_rng(0)
    tails = rng.integers(0, V, (len(rows), window)).astype(np.int32)
    lens = np.asarray([window, 5, 0, 12, 3][:len(rows)], np.int32)
    jst = _jseed(jst, jnp.asarray(ids, i32), jnp.asarray(tails),
                          jnp.asarray(lens))
    ts.seed_windows(tst, torch.tensor(ids, dtype=torch.int32),
                    torch.from_numpy(tails), torch.from_numpy(lens))
    return jst, tst


def _logits(seed: int, rows: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((rows, V)) * 3.0
            ).astype(np.float32)


def _assert_state_equal(jst, tst):
    for f in ("token_counts", "history", "history_pos", "mirostat_mu",
              "temperature", "top_k", "repeat_last_n"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_reset_and_seed_windows_match():
    jst, tst = _states(ROWS)
    _assert_state_equal(jst, tst)


def _jax_noise(jst, ids):
    """The Gumbel draws JAX's ``sample`` makes for these slots."""
    keys = jst.rng[jnp.asarray(ids)]
    split = jax.vmap(jax.random.split)(keys)
    k = min(js.CAND, V)
    return np.asarray(jax.vmap(
        lambda key: jax.random.gumbel(key, (k,), jnp.float32))(split[:, 1]))


@pytest.mark.parametrize("rows", [ROWS, [MIRO_V1, ROWS[1]]],
                         ids=["chain+miro2", "miro1"])
def test_seeded_draws_and_state_match_with_jax_noise(rows):
    jst, tst = _states(rows)
    ids = list(range(len(rows)))
    for step in range(4):
        logits = _logits(step + 1, len(rows))
        noise = _jax_noise(jst, ids)
        jtok, jst = _jsample(jst, jnp.asarray(ids, np.int32),
                              jnp.asarray(logits))
        ttok, _ = ts.sample(tst, torch.tensor(ids, dtype=torch.int32),
                            torch.from_numpy(logits),
                            noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        _assert_state_equal(jst, tst)


def test_filtered_distributions_match():
    rows = ROWS + [MIRO_V1]
    jst, tst = _states(rows)
    ids = list(range(len(rows)))
    logits = _logits(9, len(rows))
    jsid = jnp.asarray(ids, np.int32)
    scaled, idx = js._topk_scaled(jst, jsid, jnp.asarray(logits))
    jchain = np.asarray(js._chain_probs(jst, jsid, scaled))
    jmiro = np.asarray(js._mirostat_probs(jst, jsid, scaled, V))
    tsid = torch.tensor(ids, dtype=torch.int32)
    tscaled, tidx = ts._topk_scaled(tst, tsid, torch.from_numpy(logits))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(ts._chain_probs(tst, tsid, tscaled).numpy(),
                               jchain, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        ts._mirostat_probs(tst, tsid, tscaled, V).numpy(), jmiro, rtol=0,
        atol=1e-6)


def test_greedy_is_exact_with_penalties_and_mask():
    rows = [dict(temperature=0.0, repeat_penalty=1.5, presence_penalty=0.5)
            ] * 3
    jst, tst = _states(rows)
    ids = list(range(3))
    mask = np.random.default_rng(2).random((3, V)) > 0.3
    for step in range(3):
        logits = _logits(20 + step, 3)
        jtok, jst = _jsample(jst, jnp.asarray(ids, np.int32),
                              jnp.asarray(logits), mask=jnp.asarray(mask))
        ttok, _ = ts.sample(tst, torch.tensor(ids, dtype=torch.int32),
                            torch.from_numpy(logits),
                            mask=torch.from_numpy(mask))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_state_equal(jst, tst)


def test_generator_draws_are_reproducible_per_seed():
    """Without injected noise the draws come from per-slot generators:
    the same request seed gives the same tokens."""
    def run():
        _, tst = _states(ROWS)
        toks = []
        for step in range(3):
            t, _ = ts.sample(tst, torch.arange(S, dtype=torch.int32),
                             torch.from_numpy(_logits(40 + step, S)))
            toks.append(t.tolist())
        return toks

    assert run() == run()


def test_state_fields_cover_jax_state():
    """Every JAX sampler field has its counterpart (the PRNG key becomes a
    per-slot torch.Generator)."""
    jf = {f.name for f in dataclasses.fields(js.SamplingState)} - {"rng"}
    tf = {f.name for f in dataclasses.fields(ts.SamplingState)}
    assert jf <= tf and "generators" in tf
