"""The engine's compiled decode dispatch (one CUDA graph per row bucket
on a card) through its CPU path — the same variant code run eagerly
through the same static buffers, padding and sentinel sampler row —
against the port's eager loop over exactly the decoding rows and
against the JAX engine, on the same ``tiny_spec`` weights in f32; and
``GET /metrics`` of the port's server against the JAX families.

- Greedy ids through the padded variant path equal the JAX engine's and
  the eager loop's (staggered traffic, so buckets 1, 2 and 4 run with
  pad rows).
- Seeded sampled ids equal the eager loop's: the Gumbel noise is drawn
  before the launches, step-major, as the loop draws it.
- Pad rows leave every real slot's sampler state (history,
  token_counts, mirostat_mu, ...) and every page but the trash page
  bitwise unchanged.
- ``warmup()`` makes one decode and one masked decode variant per
  bucket and one mixed variant per (row bucket, token bucket), and
  touches no slot.
- ``/metrics`` renders exposition 0.0.4 with the reference's family
  names and label sets, and its counters agree with ``engine_stats``.
"""

import json
import re
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu.telemetry import metrics as jmetrics
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.server.app import build_server
from localai_tfp_tpu_torch.telemetry import metrics as tmetrics
from localai_tfp_tpu_torch.telemetry.registry import CONTENT_TYPE

ENGINE_KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))
SAMPLER_FIELDS = ("temperature", "top_k", "top_p", "min_p",
                  "repeat_penalty", "freq_penalty", "presence_penalty",
                  "token_counts", "history", "history_pos",
                  "repeat_last_n", "typical_p", "mirostat",
                  "mirostat_tau", "mirostat_eta", "mirostat_mu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=258, max_position=512)
    params = init_params(jax.random.PRNGKey(3), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _engine(weights, **kw):
    return te.LLMEngine(tiny_spec(vocab_size=258, max_position=512),
                        params_from_numpy(weights), ByteTokenizer(),
                        cache_dtype=torch.float32, device="cpu",
                        **{**ENGINE_KW, **kw})


def _eager(eng):
    """The eager loop over exactly the decoding rows in place of the
    variant path, on this engine instance only."""
    eng._decode_graph = eng._decode_eager
    return eng


class FinishSpy:
    def __init__(self, eng):
        self.ids = {}
        orig = eng._finish

        def finish(slot, reason):
            if slot.request is not None:
                self.ids[tuple(slot.request.prompt_ids)] = list(
                    slot.generated)
            return orig(slot, reason)

        eng._finish = finish


def _drain(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        if ev.done:
            return ev


def _wave(mod, eng, tk, sampled: bool = False) -> dict:
    """Three requests at once (bucket 4: one pad row), then two more
    while the first decode, each finishing at its own length (buckets
    2 and 1 with pad rows as they finish)."""
    spy = FinishSpy(eng)
    extra = dict(temperature=0.8, top_k=40, top_p=0.9) if sampled else {}

    def req(text, n, seed):
        return mod.GenRequest(prompt_ids=tk.encode(text), max_tokens=n,
                              ignore_eos=True,
                              **({**extra, "seed": seed} if extra else {}))

    first = [req("alpha decodes first", 23, 1),
             req("beta decodes too", 9, 2),
             req("gamma " * 6, 17, 3)]
    qs = eng.submit_many(first)
    ev = qs[0].get(timeout=120)
    while ev.token_id is None and not ev.done:
        ev = qs[0].get(timeout=120)
    later = [req("delta joins later", 12, 4), req("epsilon " * 3, 5, 5)]
    qs += eng.submit_many(later)
    for q in qs:
        assert _drain(q).finish_reason == "length"
    return spy.ids


def test_greedy_ids_match_jax_and_the_eager_loop(weights):
    jspec = jax_tiny(vocab_size=258, max_position=512)
    jeng = je.LLMEngine(jspec, {k: jnp.asarray(v) for k, v in
                                weights.items()},
                        JaxBytes(), cache_dtype=jnp.float32, **ENGINE_KW)
    jeng._prefix_enabled = False  # off in all three: one schedule
    want = _wave(je, jeng, JaxBytes())
    jeng.close()
    got = {}
    for name, make in (("variant", _engine), ("eager", lambda w, **kw:
                                             _eager(_engine(w, **kw)))):
        eng = make(weights)
        eng._prefix_enabled = False
        try:
            got[name] = _wave(te, eng, ByteTokenizer())
            m = eng.metrics
            assert m.decode_steps > 0
            # the variant path ran bucket 4 (three rows and a pad row
            # first); the eager loop made no variant
            assert (4 in eng._variants) if name == "variant" \
                else not eng._variants
            assert m.graph_replays == 0  # no graphs on the CPU
            eng.leak_check()
        finally:
            eng.close()
    assert got["variant"] == want
    assert got["eager"] == want


def test_seeded_sampled_ids_match_the_eager_loop(weights):
    got = {}
    for name in ("variant", "eager"):
        eng = _engine(weights)
        if name == "eager":
            _eager(eng)
        try:
            got[name] = _wave(te, eng, ByteTokenizer(), sampled=True)
        finally:
            eng.close()
    assert got["variant"] == got["eager"]
    assert len(got["variant"]) == 5


def _sampler_rows(eng) -> dict:
    st = eng.sampling
    return {f: getattr(st, f)[:eng.n_slots].clone() for f in SAMPLER_FIELDS}


def _pages(eng) -> torch.Tensor:
    return torch.stack([eng.cache.k, eng.cache.v]).clone()


def _pages_equal_but_trash(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a[:, :, 1:], b[:, :, 1:])


def test_warmup_makes_one_variant_per_bucket_and_touches_no_slot(weights):
    eng = _engine(weights, autostart=False)
    try:
        # give every real sampler row distinct state to watch
        rng = np.random.default_rng(0)
        st = eng.sampling
        for f in SAMPLER_FIELDS:
            t = getattr(st, f)
            vals = torch.from_numpy(rng.integers(1, 50, t.shape)).to(t.dtype)
            t.copy_(vals)
        before, pages = _sampler_rows(eng), _pages(eng)
        sentinel = st.history[eng._pad_sid].clone()
        eng.warmup()
        assert sorted(eng._variants) == eng._buckets == [1, 2, 4]
        # and since mixed and masked steps became variants too: one
        # masked decode variant per bucket, one mixed variant per (row
        # bucket, token bucket)
        assert sorted(eng._masked_variants) == [1, 2, 4]
        assert sorted(eng._mixed_variants) == [
            (r, t) for r in (1, 2, 4) for t in (8, 32, 128)]
        assert eng.metrics.warmup_s > 0
        assert tmetrics.ENGINE_DISPATCH_VARIANTS.labels(
            model="default").snapshot()["value"] == 3 + 3 + 9
        after = _sampler_rows(eng)
        assert all(torch.equal(before[f], after[f]) for f in before)
        assert _pages_equal_but_trash(pages, _pages(eng))
        assert not torch.equal(sentinel, st.history[eng._pad_sid])
        assert all(not s.active and not s.cache_tokens for s in eng.slots)
        eng.leak_check()
    finally:
        eng.close()


def test_pad_rows_leave_real_slots_unchanged(weights):
    """Three decoding rows in bucket 4: the pad row samples into the
    sentinel and writes the trash page; the free slot's sampler row and
    every page outside the three rows' tables stay bitwise as they
    were, and the three rows' state is the eager loop's."""
    def run(eager: bool):
        eng = _engine(weights, autostart=False)
        if eager:
            _eager(eng)
        tk = ByteTokenizer()
        reqs = [te.GenRequest(prompt_ids=tk.encode(t), max_tokens=20,
                              ignore_eos=True, **kw)
                for t, kw in (("one pad row", {}),
                              ("mirostat row", dict(
                                  temperature=0.9, mirostat=2, seed=3)),
                              ("penalised row", dict(
                                  repeat_penalty=1.3, temperature=0.7,
                                  top_k=20, seed=4)))]
        eng.submit_many(reqs)
        eng._admit()
        while any(s.state is te.SlotState.PREFILL for s in eng.slots):
            eng.step()
        free = [s.idx for s in eng.slots if not s.active]
        assert len(free) == 1
        before, pages = _sampler_rows(eng), _pages(eng)
        held = {p for s in eng.slots if s.active
                for p in eng._pool.table(s.idx)}
        decode0 = eng.metrics.decode_steps
        eng.step()  # one decode dispatch: 3 rows, k steps
        assert eng.metrics.decode_steps - decode0 == eng.decode_steps
        after = _sampler_rows(eng)
        for f in SAMPLER_FIELDS:
            assert torch.equal(before[f][free], after[f][free]), f
        untouched = [p for p in range(1, eng.kv_pages) if p not in held]
        now = _pages(eng)
        assert torch.equal(pages[:, :, untouched], now[:, :, untouched])
        state = {f: getattr(eng.sampling, f)[:eng.n_slots].clone()
                 for f in SAMPLER_FIELDS}
        eng.close()
        return state, now[:, :, 1:]

    got, got_pages = run(eager=False)
    want, want_pages = run(eager=True)
    for f in SAMPLER_FIELDS:
        assert torch.equal(got[f], want[f]), f
    assert torch.equal(got_pages, want_pages)


# ---------------------------------------------------------------- metrics

TINY = {
    "name": "tiny-metrics", "backend": "torch-llm",
    "parameters": {"model": "graphs-metrics-ckpt", "temperature": 0.0,
                   "max_tokens": 8},
    "context_size": 128, "max_batch_slots": 4, "dtype": "float32",
    "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                 "chat": "{{.Input}}\nassistant:"},
}
SERIES = re.compile(r'^([a-z_]+)(\{(.*)\})? (\S+)$')


def _parse(text: str) -> dict:
    """{(name, frozenset(label items)): value} of every sample line."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = SERIES.match(line)
        assert m, line
        labels = dict(re.findall(r'([a-z_]+)="((?:[^"\\]|\\.)*)"',
                                 m.group(3) or ""))
        out[(m.group(1), frozenset(labels.items()))] = float(m.group(4))
    return out


def _family_of(sample: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if sample.endswith(suffix) and sample[:-len(suffix)] in FAMILIES:
            return sample[:-len(suffix)]
    return sample


FAMILIES = {f.name: f for f in vars(jmetrics).values()
            if hasattr(f, "labelnames") and hasattr(f, "kind")}
PORTED = {f.name for f in vars(tmetrics).values()
          if hasattr(f, "labelnames") and hasattr(f, "kind")}


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("graphs_srv")
    models = root / "models"
    models.mkdir()
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256,
    )).save_pretrained(models / "graphs-metrics-ckpt",
                       safe_serialization=True)
    (models / "tiny.yaml").write_text(json.dumps(TINY, indent=1))
    srv = build_server(str(models), port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    with pytest.MonkeyPatch.context() as mp:
        # the worker's default (tests/conftest.py turns it off for the
        # JAX package): warmup at load, before the first request
        mp.setenv("LOCALAI_WARMUP", "on")
        yield srv
    srv.close()
    th.join(timeout=30)


def _get(port: int, path: str, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def _await_idle(backend, completed: int, timeout_s: float = 10.0) -> None:
    """Wait until the engine has counted ``completed`` requests and every
    slot is free again."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if (backend.engine_stats()["requests_completed"] >= completed
                and not any(s.active for s in backend.engine.slots)):
            return
        time.sleep(0.01)


def test_metrics_route_shows_the_reference_families(server, tmp_path):
    port = server.server_address[1]
    for text in ("hello", "count to three"):
        status, _, _ = _get(port, "/v1/chat/completions", {
            "model": "tiny-metrics", "max_tokens": 6,
            "messages": [{"role": "user", "content": text}]})
        assert status == 200
    # the engine puts a request's done event on its reply queue before it
    # counts the request and frees the slot (the JAX engine's order), so
    # the reply can come first: wait for both before the scrape
    _await_idle(server.app.loaded()["tiny-metrics"], completed=2)
    status, ctype, text = _get(port, "/metrics")
    assert status == 200 and ctype == CONTENT_TYPE
    assert "# EOF" not in text
    for name in PORTED:  # every family HELP/TYPE'd, the reference's kind
        assert f"# TYPE {name} {FAMILIES[name].kind}" in text
    samples = _parse(text)
    for (sample, labels) in samples:
        fam = _family_of(sample)
        assert fam in PORTED, sample
        keys = {k for k, _ in labels} - {"le"}
        assert keys == set(FAMILIES[fam].labelnames), sample
    model = "graphs-metrics-ckpt"
    backend = server.app.loaded()["tiny-metrics"]
    stats = backend.engine_stats()
    # decode and masked decode variants per row bucket (1, 2, 4), mixed
    # variants per row bucket and token bucket (4, 16, 128)
    assert stats["graph_variants"] == 15 and stats["warmup_s"] > 0
    assert stats["costmodel"]["mfu_samples"] > 0
    # the weights by tier (the engine pages them, as the JAX engine does
    # with LOCALAI_WEIGHT_PAGING on): hot on the device, none warm
    assert stats["hbm"]["components"]["weights_hot"] > 0
    assert stats["hbm"]["components"]["weights_warm"] == 0

    def value(name, **labels):
        return samples.get((name, frozenset(labels.items())), 0.0)

    assert value("engine_generated_tokens_total", model=model) == \
        stats["tokens_generated"]
    assert value("engine_prompt_tokens_total", model=model) == \
        stats["prompt_tokens_processed"]
    assert value("engine_requests_total", model=model, reason="length") + \
        value("engine_requests_total", model=model, reason="stop") == \
        stats["requests_completed"] == 2
    assert value("engine_dispatch_compile_variants_count", model=model) == 15
    assert 0 < value("engine_mfu_ratio", model=model) <= 1
    assert value("engine_hbm_bytes", model=model,
                 component="weights_hot") == \
        stats["hbm"]["components"]["weights_hot"]
    assert value("engine_slots_busy_count", model=model) == 0
    assert value("api_call_seconds_count", method="POST",
                 path="/v1/chat/completions") >= 2
    flops = sum(v for (n, ls), v in samples.items()
                if n == "engine_device_flops_total"
                and ("model", model) in ls)
    assert flops > 0
    # an unmatched path buckets as "other"
    try:
        _get(port, "/no/such/path")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    _, _, text = _get(port, "/metrics")
    assert value_in(text, "api_call_seconds_count", method="GET",
                    path="other") >= 1
    # the cancellation and prompt-cache families: an expired race-ahead
    # cancel id, and a prompt cache file that does not exist
    for fam in (tmetrics.ENGINE_CANCELLATIONS,
                tmetrics.ENGINE_PROMPT_CACHE_RESTORES):
        assert fam.name in PORTED
        assert fam.labelnames == FAMILIES[fam.name].labelnames
    eng = backend.engine
    with eng._lock:
        eng._cancelled["ghost"] = time.perf_counter() - 2 * eng._CANCEL_TTL_S
    deadline = time.perf_counter() + 5
    while "ghost" in eng._cancelled and time.perf_counter() < deadline:
        time.sleep(0.05)
    from localai_tfp_tpu_torch.workers.base import PredictOptions

    rep = backend.predict(PredictOptions(
        prompt="hi", tokens=2, ignore_eos=True,
        prompt_cache_path=str(tmp_path / "none.cache"),
        prompt_cache_ro=True))
    assert rep.finish_reason == "length", rep.error
    _, _, text = _get(port, "/metrics")
    samples = _parse(text)
    for (sample, labels) in samples:
        keys = {k for k, _ in labels} - {"le"}
        assert keys == set(FAMILIES[_family_of(sample)].labelnames), sample
    assert value_in(text, "engine_cancellations_total", model=model,
                    reason="expired") >= 1
    assert value_in(text, "engine_prompt_cache_restores_total",
                    model=model, result="no_file") >= 1


def value_in(text: str, name: str, **labels) -> float:
    return _parse(text).get((name, frozenset(labels.items())), 0.0)
