"""The port's telemetry (localai_tfp_tpu_torch/telemetry/) against the JAX
package's, on the CPU.

- The registry renders byte-identical exposition text to the JAX
  package's for the same families and the same seeded sequence of
  observations: label escaping, histogram buckets, and the label-set cap
  with its overflow to "other".
- Every family the port registers has the JAX family's name, kind,
  label names, buckets and cap (and help, but for the families whose
  help names a mechanism the port does not have).
- ``CostModel``: after ``import_rows`` of the same rows and the same
  seeded ``on_harvest`` sequence (spans with outliers, so the 4x clip
  bites, and kinds below and above the three-sample floor), the port's
  and the JAX package's ``predict_ms`` / ``decode_step_ms`` /
  ``prefill_token_ms`` / ``mfu`` / ``stats`` agree within 1e-12
  relative.
- ``analytic_flops_per_token`` is the JAX one on the same ``tiny_spec``
  parameters, f32 and int8.
- ``ModelCost`` counts what its docstring says, on hand-counted cases;
  the HBM ledger's ``attributed`` / ``reconcile`` hold on a fake stats
  source; ``looks_like_oom`` recognises ``torch.cuda.OutOfMemoryError``
  and the post-mortem is readable JSON.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import quant as jquant
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu.telemetry import costmodel as jcm
from localai_tfp_tpu.telemetry import metrics as jmetrics
from localai_tfp_tpu.telemetry import registry as jreg
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.models.transformer import KVCache
from localai_tfp_tpu_torch.telemetry import costmodel as tcm
from localai_tfp_tpu_torch.telemetry import hbm_ledger
from localai_tfp_tpu_torch.telemetry import metrics as tmetrics
from localai_tfp_tpu_torch.telemetry import registry as treg

REL = 1e-12
LABEL_VALUES = ("a", 'he"llo\nworld', "back\\slash", "", "x" * 40)


def _observe(reg_mod, seed: int) -> str:
    """One seeded sequence of registrations and observations on a fresh
    registry of ``reg_mod``; returns its exposition text."""
    rng = np.random.default_rng(seed)
    r = reg_mod.Registry()
    c = r.counter("req_total", "Requests by code", labels=("code", "model"))
    g = r.gauge("depth_count", "Queue depth")
    h = r.histogram("lat_seconds", "Latency\nwith a newline \\ and slash",
                    labels=("path",), buckets=(0.01, 0.1, 1.0),
                    max_label_sets=3, overflow={"path": "other"})
    capped = r.counter("capped_total", "Every label collapses",
                       labels=("a", "b"), max_label_sets=2)
    for _ in range(200):
        op = int(rng.integers(0, 4))
        lv = LABEL_VALUES[int(rng.integers(0, len(LABEL_VALUES)))]
        if op == 0:
            c.labels(code=str(int(rng.integers(200, 205))),
                     model=lv).inc(float(rng.integers(1, 4)))
        elif op == 1:
            g.set(float(rng.normal()) * 10)
        elif op == 2:
            h.labels(path=f"/p{int(rng.integers(0, 6))}").observe(
                float(rng.exponential(0.3)))
        else:
            capped.labels(a=lv, b=str(int(rng.integers(0, 3)))).inc()
    return r.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_renders_byte_identical_text(seed):
    got_text = _observe(treg, seed)
    assert got_text == _observe(jreg, seed)
    # the caps bit: overflow label sets exist in the text
    assert 'lat_seconds_bucket{path="other",le="0.01"}' in got_text
    assert 'capped_total{a="other",b="other"}' in got_text
    assert 'he\\"llo\\nworld' in got_text


def _families(mod) -> dict:
    return {name: fam for name, fam in vars(mod).items()
            if isinstance(fam, (treg._Family, jreg._Family))}


@pytest.mark.parametrize("name", sorted(_families(tmetrics)))
def test_port_family_is_the_reference_family(name):
    got, want = _families(tmetrics)[name], getattr(jmetrics, name)
    assert (got.name, got.kind, got.labelnames, got.max_label_sets,
            got._overflow) == (want.name, want.kind, want.labelnames,
                               want.max_label_sets, want._overflow)
    assert getattr(got, "buckets", None) == getattr(want, "buckets", None)
    if got.name not in tmetrics.REWORDED:
        assert got.help == want.help


def test_reworded_families_exist():
    names = {f.name for f in _families(tmetrics).values()}
    assert tmetrics.REWORDED <= names


ROWS = {
    ("decodek", 8, 8): (2.0e9, 1.6e9),
    ("decodek", 4, 1): (3.0e8, 9.0e8),
    ("mixed", (4, 128)): (9.0e10, 2.0e9),
    ("mixed", (8, 512)): (6.0e11, 3.0e9),
    ("spec", 4, 2): (5.0e9, 4.0e9),
    ("spec_s", 4, 1): (2.5e9, 2.0e9),
}


def _harvest_sequence(cm, seed: int) -> list:
    """A seeded on_harvest sequence; returns the predictions read after
    each harvest (so the EWMA's path is compared, not only its end)."""
    rng = np.random.default_rng(seed)
    keys = list(ROWS)
    seen = []
    for i in range(60):
        key = keys[int(rng.integers(0, len(keys)))]
        span = float(rng.uniform(0.002, 0.05))
        if rng.random() < 0.15:
            span *= 20.0  # an outlier the clip must absorb
        pred = cm.predict_ms(key[0], key)
        cm.on_harvest(key[0], key, span,
                      pred if i % 3 else None)
        seen.append([cm.predict_ms(k[0], k) for k in keys]
                    + [cm.decode_step_ms(), cm.prefill_token_ms(), cm.mfu])
    return seen


def _close(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)
    return a == b


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cost_model_matches_jax(seed, monkeypatch):
    monkeypatch.delenv("LOCALAI_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("LOCALAI_PEAK_HBM_GBS", raising=False)
    rows = {repr(k): v for k, v in ROWS.items()}
    got_cm = tcm.CostModel("telemetry-test", "cpu")
    want_cm = jcm.CostModel("telemetry-test", "cpu")
    assert got_cm.import_rows(rows) == want_cm.import_rows(rows) == len(ROWS)
    assert got_cm.import_rows(rows) == 0  # existing rows win
    got = _harvest_sequence(got_cm, seed)
    want = _harvest_sequence(want_cm, seed)
    assert _close(got, want)
    assert _close(got_cm.stats(), want_cm.stats())
    assert got_cm.export_rows() == want_cm.export_rows()


def test_calibration_floor_and_clip_match_jax():
    """A kind predicts from the bare bound until three harvests, a
    variant from its own EWMA after two; a 20x spike moves the EWMA by
    at most the clip."""
    key, other = ("decodek", 8, 8), ("decodek", 4, 1)
    out = []
    for mod in (tcm, jcm):
        cm = mod.CostModel("telemetry-test", "cpu")
        cm.import_rows({repr(k): ROWS[k] for k in (key, other)})
        bare = cm.predict_ms("decodek", other)
        trace = [bare]
        for span in (0.08, 0.08, 0.08, 1.6):  # the last a 20x outlier
            cm.on_harvest("decodek", key, span)
            trace.append((cm.predict_ms("decodek", other),
                          cm.predict_ms("decodek", key)))
        out.append(trace)
        assert trace[1][0] == trace[2][0] == bare  # below the floor
        assert trace[3][0] != bare  # the kind's EWMA after three
        # the spike was clipped to 4x the variant's own EWMA
        assert trace[4][1] < trace[3][1] * (1 + 0.2 * 3) + 1e-9
    assert _close(out[0], out[1])


def test_peak_rates_by_device_name(monkeypatch):
    monkeypatch.delenv("LOCALAI_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("LOCALAI_PEAK_HBM_GBS", raising=False)
    assert tcm.peak_rates("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert tcm.peak_rates("cpu") == jcm.peak_rates("cpu")
    monkeypatch.setenv("LOCALAI_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("LOCALAI_PEAK_HBM_GBS", "2000")
    assert tcm.peak_rates("NVIDIA H100 80GB HBM3") == (1e15, 2e12)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_analytic_flops_per_token_matches_jax(int8):
    spec = jax_tiny(vocab_size=300)
    params = init_params(jax.random.PRNGKey(0), spec, dtype=jnp.float32)
    if int8:
        params = jquant.quantize_params(params)
    want = jcm.analytic_flops_per_token(params)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    assert tcm.analytic_flops_per_token(tparams) == want


@pytest.mark.parametrize("ctx,q,window", [
    (0, 1, 0), (17, 1, 0), (0, 9, 0), (30, 12, 0), (3, 5, 8), (5, 10, 8),
    (20, 4, 8), (7, 1, 8), (0, 16, 8)])
def test_attended_keys_match_a_loop(ctx, q, window):
    want = sum(min(p + 1, window) if window else p + 1
               for p in range(ctx, ctx + q))
    assert tcm._attended(ctx, q, window) == want


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_model_cost_counts_by_hand(kv):
    spec = tiny_spec(vocab_size=300)
    jparams = init_params(jax.random.PRNGKey(0), jax_tiny(vocab_size=300),
                          dtype=jnp.float32)
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jparams.items()})
    page = 8
    cache = KVCache.create(spec, 9, page, torch.int8 if kv == "int8"
                           else torch.float32)
    mc = tcm.ModelCost.of(spec, params, cache, page)
    d, L, V = spec.d_model, spec.n_layers, spec.vocab_size
    per_layer = (d * spec.q_dim + 2 * d * spec.kv_dim + spec.q_dim * d
                 + 3 * d * spec.d_ff)
    rows = [(10, 1), (0, 5)]  # 11 and 1+..+5 = 15 keys
    flops, by = mc.forward(rows, head_rows=2)
    assert flops == (2.0 * 6 * per_layer * L + 4.0 * spec.q_dim * 26 * L
                     + 2.0 * 2 * d * V)
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    tok = 2 * spec.kv_dim * cache.k.element_size() + (
        8 if kv == "int8" else 0)
    pages = 2 + 1  # positions [0, 11) and [0, 5) in pages of 8
    head = params["lm_head"] if "lm_head" in params else params["embed"]
    want = (nbytes - params["embed"].numel() * 4
            - (params["lm_head"].numel() * 4 if "lm_head" in params else 0)
            + 6 * d * 4 + L * tok * (pages * page + 6)
            + head.numel() * 4 + 4 * 2 * V)
    assert by == want
    # no head rows: no head bytes, no logits
    f0, b0 = mc.forward(rows, head_rows=0)
    assert f0 == flops - 2.0 * 2 * d * V
    assert b0 == by - head.numel() * 4 - 4 * 2 * V - d * 4


def test_dispatch_keys():
    assert tcm.dispatch_key("mixed", {"shape": (4, 128)}) == (
        "mixed", (4, 128))
    assert tcm.dispatch_key("decodek", {"k": 8, "bucket": 4}) == (
        "decodek", 8, 4)
    assert tcm.dispatch_key("spec_s", {"kd": 4, "rounds": 2}) == (
        "spec_s", 4, 2)
    assert tcm.FLIGHT_KINDS == {"mixed", "decodek", "spec", "spec_s"}


def _gauge(model: str, component: str) -> float:
    child = tmetrics.ENGINE_HBM_BYTES.labels(model=model,
                                             component=component)
    return child.snapshot()["value"]


def test_hbm_ledger_attributes_and_reconciles():
    spec = tiny_spec(vocab_size=300)
    cache = KVCache.create(spec, 5, 8, torch.int8)
    moving = [100]
    led = hbm_ledger.HBMLedger("ledger-test")
    led.register("weights", {"a": torch.zeros(10, 4),
                             "b": (torch.zeros(3, dtype=torch.int8),
                                   torch.zeros(3))})
    led.register("kv_arena", cache)
    led.register("fixed", 4096)
    led.register("graph_pool", lambda: moving[0])
    want = {"weights": 160 + 3 + 12, "kv_arena": cache.nbytes(),
            "fixed": 4096, "graph_pool": 100}
    assert led.attributed() == want
    moving[0] = 300  # a callable source is read at read time
    want["graph_pool"] = 300
    total = sum(want.values())
    assert led.snapshot()["attributed"] == total
    snap = led.reconcile(lambda: {"reserved_bytes.all.current": total + 777,
                                  "allocated_bytes.all.current": total,
                                  "device_used": total + 10**6})
    assert snap["components"] == want and snap["attributed"] == total
    assert snap["bytes_in_use"] == total + 777
    assert snap["unattributed"] == 777
    assert snap["bytes_allocated"] == total
    assert math.isclose(snap["drift_ratio"], 777 / (total + 777))
    assert _gauge("ledger-test", "kv_arena") == cache.nbytes()
    assert _gauge("ledger-test", "unattributed") == 777
    assert led.snapshot() is snap
    # no stats (the CPU): no drift row
    cpu = led.reconcile(lambda: None)
    assert cpu["bytes_in_use"] is None and "unattributed" not in cpu
    led.reset_gauges()
    assert _gauge("ledger-test", "weights") == 0
    assert _gauge("ledger-test", "unattributed") == 0


def test_oom_is_recognised_and_dumped(tmp_path):
    assert hbm_ledger.looks_like_oom(torch.cuda.OutOfMemoryError("x"))
    assert not hbm_ledger.looks_like_oom(RuntimeError("out of memory"))
    led = hbm_ledger.HBMLedger("ledger-test")
    led.register("weights", 123)
    path = hbm_ledger.dump_post_mortem(
        str(tmp_path), "ledger-test", torch.cuda.OutOfMemoryError("boom"),
        led, None, {"reserved_bytes.all.current": 5})
    assert path is not None and path.startswith(str(tmp_path /
                                                    "post_mortem"))
    with open(path) as f:
        report = json.load(f)
    assert report["kind"] == "hbm_post_mortem"
    assert "boom" in report["error"]
    assert report["ledger"]["components"] == {"weights": 123}
    assert report["memory_stats"] == {"reserved_bytes.all.current": 5}
    assert hbm_ledger.device_memory_stats("cpu") is None
