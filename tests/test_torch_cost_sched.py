"""Cost-driven scheduling in the port's engine against the JAX engine on
the same ``tiny_spec`` weights (f32, ``LOCALAI_KV_PAGE=16``), with the
same predictions injected into both engines' cost models. Every
comparison is exact (equal ints, equal floats, equal strings): both
engines compute the same host arithmetic on the same numbers.

- Knobs: ``LOCALAI_COST_SCHED`` (on) and ``LOCALAI_ITL_BUDGET_MS`` (0)
  with the reference's defaults; the gates ``_cost_sched_on`` and
  ``_itl_budget_ms`` under each setting.
- ``_cost_bucket``: the token bucket a mixed step packs to, over tables
  of predicted device ms per bucket.
- The decode-k clamp under an ITL budget, for a range of measured step
  ms and for the cost model's prediction before any sample.
- ``_predicted_drain_s`` and Retry-After for the same queue and rates.
- The p90 and clamp of the fallback Retry-After (ROADMAP §C 3: the port
  took ``waits[int(0.9 * (n - 1))]`` and had no upper clamp).
- The predicted-deadline refusal: finish reason, error text and stage
  counter, through each engine and through both HTTP servers.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.config import knobs as jknobs
from localai_tfp_tpu.engine import engine as je
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu.telemetry import metrics as jmetrics
from localai_tfp_tpu_torch.config import knobs as tknobs
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.telemetry import metrics as tmetrics

KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))
PREDICTED = "predicted completion exceeds deadline (prefill alone overruns it)"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    for k in ("LOCALAI_COST_SCHED", "LOCALAI_ITL_BUDGET_MS",
              "LOCALAI_PEAK_FLOPS", "LOCALAI_PEAK_HBM_GBS"):
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    spec = jax_tiny(vocab_size=258, max_position=512)
    params = init_params(jax.random.PRNGKey(5), spec, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _pair(weights, **kw):
    """(JAX engine, port engine) on the same weights, not started."""
    jeng = je.LLMEngine(jax_tiny(vocab_size=258, max_position=512),
                        {k: jnp.asarray(v) for k, v in weights.items()},
                        JaxBytes(), cache_dtype=jnp.float32,
                        autostart=False, **{**KW, **kw})
    teng = te.LLMEngine(tiny_spec(vocab_size=258, max_position=512),
                        params_from_numpy(weights), ByteTokenizer(),
                        cache_dtype=torch.float32, device="cpu",
                        autostart=False, **{**KW, **kw})
    return jeng, teng


@pytest.fixture(scope="module")
def pair(weights):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LOCALAI_KV_PAGE", "16")
        jeng, teng = _pair(weights)
    yield jeng, teng
    jeng.close()
    teng.close()


def _inject(eng, table=None, tok_ms=None, step_ms=None):
    """Predictions into an engine's cost model: ``table`` maps a mixed
    step's token bucket to its predicted ms (missing: no prediction),
    ``tok_ms`` / ``step_ms`` the per-token prefill and per-step decode
    rates."""
    cm = eng._costmodel
    if table is not None:
        cm.predict_ms = lambda kind, key: (table.get(key[1][1])
                                           if kind == "mixed" else None)
    cm.prefill_token_ms = lambda: tok_ms
    cm.decode_step_ms = lambda: step_ms


# ---------------------------------------------------------------- knobs


@pytest.mark.parametrize("name", ["LOCALAI_COST_SCHED",
                                  "LOCALAI_ITL_BUDGET_MS"])
def test_knob_defaults_are_the_reference_s(name):
    assert tknobs._DEFAULTS[name] == jknobs.REGISTRY[name].default


@pytest.mark.parametrize("sched,budget", [
    (None, None), (None, "5"), ("off", "5"), ("on", "-5"), ("on", "2.5"),
    ("on", "nope"), ("yes", "40")])
def test_gates_match_jax(pair, monkeypatch, sched, budget):
    for k, v in (("LOCALAI_COST_SCHED", sched),
                 ("LOCALAI_ITL_BUDGET_MS", budget)):
        if v is not None:
            monkeypatch.setenv(k, v)
    jeng, teng = pair
    assert teng._cost_sched_on() == jeng._cost_sched_on()
    assert teng._itl_budget_ms() == jeng._itl_budget_ms()


# ----------------------------------------------------------- cost bucket

TABLES = {
    "rising": {8: 1.0, 32: 3.0, 128: 9.0},
    "flat": {8: 2.0, 32: 2.0, 128: 2.0},
    "cold_small": {32: 3.0, 128: 9.0},  # bucket 8 never predicted
    "none": {},
}


def _compose(eng, decode_rows: int, prompts: list[int]):
    """Slots of ``eng`` as ``decode_rows`` decoding rows and prefilling
    rows with ``prompts`` tokens left (contexts from 20); returns
    (prefilling, decoding)."""
    slots = eng.slots
    dec, pre = slots[:decode_rows], slots[decode_rows:decode_rows
                                          + len(prompts)]
    for i, s in enumerate(dec):
        s.n_past, s.n_prompt = 20 + i, 10
    for i, (s, rem) in enumerate(zip(pre, prompts)):
        s.n_past, s.n_prompt = 20 + i, 20 + i + rem
    return list(pre), list(dec)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("budget", [0.5, 1.0, 2.9, 3.0, 100.0])
def test_cost_bucket_choices_match_jax(pair, table, budget):
    jeng, teng = pair
    for cover in (8, 32, 128):
        got = []
        for eng in (jeng, teng):
            _inject(eng, TABLES[table])
            try:
                got.append(eng._cost_bucket(*_compose(eng, 2, [200, 40]),
                                            cover, budget))
            finally:
                del eng._costmodel.predict_ms
        assert got[0] == got[1], (cover, got)


# ------------------------------------------------------- decode k clamp


class _Dispatched(Exception):
    pass


def _jax_k(jeng, k0: int) -> int:
    """The k the JAX engine's decode dispatch sends for an uncapped
    ``k0`` with every slot decoding, no arrival and nothing in flight,
    where only the ITL clamp can change it."""
    for s in jeng.slots:
        s.state = je.SlotState.DECODE
        s.request = je.GenRequest(prompt_ids=[1, 2, 3], max_tokens=200)
        s.n_past, s.n_prompt, s.generated = 10, 3, [5]
    jeng._last_arrival = 0.0
    jeng._multi_step_k = lambda decoding: (k0, 200, 1000)

    def run(kind, payload):
        raise _Dispatched(payload["k"])

    jeng._run = run
    try:
        jeng._dispatch_decode(list(jeng.slots))
    except _Dispatched as e:
        return e.args[0]
    finally:
        for name in ("_multi_step_k", "_run"):
            jeng.__dict__.pop(name, None)
        for s in jeng.slots:
            jeng._pool.drop(s.idx)
            s.state, s.request, s.n_past, s.generated = \
                je.SlotState.FREE, None, 0, []
    raise AssertionError("no decode dispatch")


@pytest.mark.parametrize("decode_steps", [8, 16])
@pytest.mark.parametrize("step_ms", [0.0, 0.5, 1.0, 2.4, 2.5, 3.0, 4.0,
                                     6.0, 20.0])
def test_decode_k_clamp_matches_jax(weights, monkeypatch, decode_steps,
                                    step_ms):
    """Budget 10 ms: measured step ms (0: none yet, the cost model's
    prediction of 1.25 ms stands in) against the JAX clamp."""
    monkeypatch.setenv("LOCALAI_ITL_BUDGET_MS", "10")
    jeng, teng = _pair(weights, decode_steps=decode_steps)
    try:
        for eng in (jeng, teng):
            eng._step_ms = step_ms
            _inject(eng, step_ms=1.25)
        for k0 in (decode_steps, 4):
            assert teng._itl_k(k0) == _jax_k(jeng, k0), k0
    finally:
        jeng.close()
        teng.close()


def test_step_ms_ewma_is_the_reference_s(pair):
    """0.8 / 0.2 EWMA, a first sample taken as is, samples 8x the
    estimate or more dropped."""
    _, teng = pair
    teng._step_ms = 0.0
    want = 0.0
    for s in (10.0, 12.0, 95.0, 80.0, 79.0, 0.0, 9.0):
        teng._note_step_ms(s)
        if s > 0 and (want == 0 or s < 8 * want):
            want = s if want == 0 else 0.8 * want + 0.2 * s
        assert teng._step_ms == want
    teng._step_ms = 0.0


# ------------------------------------------------- drain and Retry-After

QUEUE = [(30, 16), (120, 64), (7, 0), (250, 4)]  # (prompt, max_tokens)


def _queue(eng, mod, reqs):
    with eng._lock:
        eng._pending = [(mod.GenRequest(prompt_ids=list(range(1, p + 1)),
                                        max_tokens=n), None)
                        for p, n in reqs]


@pytest.mark.parametrize("rates", [(0.01, 2.0, 0.0), (0.01, None, 0.0),
                                   (None, 2.0, 0.0), (None, None, 0.0),
                                   (0.5, 40.0, 3.0), (1e-5, 1e-4, 0.0),
                                   (None, None, 7.0), (2.0, 100.0, 0.0),
                                   (2.0, None, 55.0), (50.0, 500.0, 0.0)])
@pytest.mark.parametrize("sched", ["on", "off"])
def test_predicted_drain_and_retry_after_match_jax(pair, monkeypatch,
                                                   rates, sched):
    monkeypatch.setenv("LOCALAI_COST_SCHED", sched)
    tok_ms, step_ms, measured = rates
    got = []
    for eng, mod in zip(pair, (je, te)):
        _queue(eng, mod, QUEUE)
        _inject(eng, tok_ms=tok_ms, step_ms=step_ms)
        eng._step_ms = measured
        with eng._lock:
            eng._queue_waits.clear()
            eng._queue_waits.extend([0.2, 3.0, 0.7])
            got.append((eng._predicted_drain_s(), eng._retry_after_s()))
            eng._pending = []
            eng._queue_waits.clear()
        eng._step_ms = 0.0
    assert got[0] == got[1]


@pytest.mark.parametrize("waits,want", [
    ([0.6, 2.0], 2.0), ([40.0], 30.0), ([], 1.0), ([0.1], 0.5),
    ([float(i) for i in range(1, 11)], 10.0),
    ([0.3, 0.9, 1.4, 2.2, 8.0], 8.0)])
def test_retry_after_takes_the_reference_p90_and_clamp(pair, monkeypatch,
                                                       waits, want):
    """ROADMAP §C 3: the fallback Retry-After (no predicted drain) is
    ``ws[min(n - 1, int(0.9 * n))]`` clamped to [0.5, 30] s, as the JAX
    engine's; the port took ``ws[int(0.9 * (n - 1))]`` with no upper
    clamp (0.6 for [0.6, 2.0], 40 for [40])."""
    monkeypatch.setenv("LOCALAI_COST_SCHED", "off")
    got = []
    for eng in pair:
        with eng._lock:
            eng._queue_waits.clear()
            eng._queue_waits.extend(waits)
            got.append(eng._retry_after_s())
            eng._queue_waits.clear()
    assert got == [want, want]


# ------------------------------------------------- predicted deadlines


def _stage(registry_metric, model, stage) -> float:
    return registry_metric.labels(model=model, stage=stage).snapshot()[
        "value"]


@pytest.mark.parametrize("tok_ms,timeout,refused", [
    (100.0, 1.0, True),  # 19 prompt tokens: 1.9 s of prefill > 1 s
    (10.0, 1.0, False),  # 0.19 s fits
    (None, 1.0, False),  # no rate: nothing predicted
])
def test_predicted_deadline_refusal_matches_jax(weights, tok_ms, timeout,
                                                refused):
    jeng, teng = _pair(weights)
    try:
        got = []
        for eng, mod, tok, reg in ((jeng, je, JaxBytes(), jmetrics),
                                   (teng, te, ByteTokenizer(), tmetrics)):
            _inject(eng, tok_ms=tok_ms)
            before = _stage(reg.ENGINE_DEADLINE_EXCEEDED, eng._mlabel,
                            "queued_predicted")
            q = eng.submit(mod.GenRequest(
                prompt_ids=tok.encode("predicted overrun"), max_tokens=3,
                timeout_s=timeout, ignore_eos=True))
            eng._apply_deadlines()
            if refused:
                ev = q.get(timeout=5)
            else:
                assert q.empty() and len(eng._pending) == 1
                with eng._lock:
                    eng._pending = []
                ev = None
            got.append((ev and (ev.done, ev.finish_reason, ev.error),
                        _stage(reg.ENGINE_DEADLINE_EXCEEDED, eng._mlabel,
                               "queued_predicted") - before))
        assert got[0] == got[1]
        if refused:
            assert got[1] == ((True, "deadline_exceeded", PREDICTED), 1.0)
    finally:
        jeng.close()
        teng.close()


TINY = {
    "name": "tiny", "backend": "jax-llm",
    "parameters": {"model": "tiny-ckpt", "temperature": 0.0,
                   "max_tokens": 4},
    "context_size": 256, "max_batch_slots": 4, "dtype": "float32",
    "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                 "chat": "{{.Input}}\nassistant:"},
}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX server (aiohttp test client) and the port's server on one
    tiny checkpoint; yields (call, engine) per server."""
    from aiohttp.test_utils import TestClient, TestServer
    from transformers import LlamaConfig, LlamaForCausalLM

    from localai_tfp_tpu.config.app_config import ApplicationConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application
    from localai_tfp_tpu_torch.server.app import build_server

    root = tmp_path_factory.mktemp("cost_sched_srv")
    models = root / "models"
    models.mkdir()
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512,
    )).save_pretrained(models / "tiny-ckpt", safe_serialization=True)
    (models / "tiny.yaml").write_text(json.dumps(TINY, indent=1))
    loop = asyncio.new_event_loop()
    state = Application(ApplicationConfig(
        models_path=str(models), generated_content_dir=str(root / "gen"),
        upload_dir=str(root / "up"), config_dir=str(root / "conf")))
    tc = TestClient(TestServer(build_app(state)), loop=loop)
    loop.run_until_complete(tc.start_server())

    def jcall(body):
        async def go():
            r = await tc.request("POST", "/v1/chat/completions", json=body)
            return r.status, (await r.read()).decode()
        return loop.run_until_complete(go())

    srv = build_server(str(models), port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def tcall(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions", method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    warm = {"model": "tiny", "messages": [{"role": "user",
                                            "content": "hi"}]}
    assert jcall(warm)[0] == tcall(warm)[0] == 200
    yield ((jcall, state.model_loader.get("tiny").backend.engine, jmetrics),
           (tcall, srv.app.loaded()["tiny"].engine, tmetrics))
    srv.close()
    th.join(timeout=30)
    loop.run_until_complete(tc.close())
    loop.close()


def test_predicted_deadline_refusal_over_http(servers):
    """A 5 s timeout on a prompt whose predicted prefill takes 1 s a
    token: both servers answer 504 with the reference's text and count
    one ``queued_predicted`` deadline."""
    got = []
    for call, eng, reg in servers:
        cm = eng._costmodel
        cm.prefill_token_ms = lambda: 1000.0
        before = _stage(reg.ENGINE_DEADLINE_EXCEEDED, eng._mlabel,
                        "queued_predicted")
        try:
            status, text = call({
                "model": "tiny", "timeout": 5, "messages": [
                    {"role": "user", "content": "too long to prefill"}]})
        finally:
            del cm.prefill_token_ms
        got.append((status, PREDICTED in text, _stage(
            reg.ENGINE_DEADLINE_EXCEEDED, eng._mlabel,
            "queued_predicted") - before))
    assert got == [(504, True, 1.0)] * 2
