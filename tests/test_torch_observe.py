"""The port's telemetry against the JAX package's on the same inputs:
fault injection (utils/faultinject.py), W3C trace context and request
traces (telemetry/tracing.py), the OpenMetrics exposition
(telemetry/registry.py), the debug routes and the load breakdown.

- Faults: for each spec mode, the same spec and seed give equal
  ``counts()`` and the same fire sequence in both packages.
- Traceparent: ``parse_traceparent`` and ``make_traceparent`` give the JAX
  results over hypothesis-drawn headers.
- OpenMetrics: the render with exemplars is byte-identical to the JAX
  registry's under a fixed ``time.time``.
- Both servers on one tiny Llama: a streamed chat carrying a
  ``traceparent`` gets it echoed back, and ``/debug/traces?id=`` returns
  the same phase names in the same order; ``/debug/profile`` off gives the
  JAX status and reason, on it writes a trace on the CPU; the
  ``load_breakdown`` keys of ``/backend/monitor`` are the JAX keys;
  ``/metrics`` negotiates OpenMetrics with a TTFT exemplar whose trace id
  joins ``/debug/traces``.
"""

import asyncio
import io
import json
import threading
import time
import urllib.error
import urllib.request
import zipfile

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from localai_tfp_tpu.telemetry import registry as jreg
from localai_tfp_tpu.telemetry import tracing as jtr
from localai_tfp_tpu.utils import faultinject as jfi
from localai_tfp_tpu_torch.telemetry import registry as treg
from localai_tfp_tpu_torch.telemetry import tracing as ttr
from localai_tfp_tpu_torch.telemetry.flightrec import FLIGHT
from localai_tfp_tpu_torch.utils import faultinject as tfi

TINY = {
    "name": "tiny", "backend": "jax-llm",
    "parameters": {"model": "tiny-ckpt", "temperature": 0.0,
                   "max_tokens": 6},
    "context_size": 128, "max_batch_slots": 4, "dtype": "float32",
    "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                 "chat": "{{.Input}}\nassistant:"},
}
CHAT = {"model": "tiny", "stream": True,
        "messages": [{"role": "user", "content": "trace me"}]}


# ------------------------------------------------------------------ faults

@pytest.mark.parametrize("spec", ["fail", "fail@3", "failafter@4",
                                  "rate@0.3@7", "rate@0.5", "delay@1"])
def test_fault_specs_fire_the_same_sequence(spec):
    def run(mod):
        mod.arm(f"p.x:{spec},other.y:fail@2")
        fired = []
        try:
            for _ in range(40):
                try:
                    mod.fire("p.x")
                    fired.append(False)
                except mod.InjectedFault:
                    fired.append(True)
            mod.fire("unarmed.z")
            return fired, mod.counts()
        finally:
            mod.disarm()

    assert run(tfi) == run(jfi)
    assert not tfi.ACTIVE


def test_fault_delivery_annotates_the_traces_in_scope():
    ttr.TRACER.start("fault-scope-req", model="m")
    tfi.arm("engine.device_step:fail@1")
    try:
        with ttr.fault_scope(["fault-scope-req"]):
            with pytest.raises(tfi.InjectedFault):
                tfi.fire("engine.device_step")
    finally:
        tfi.disarm()
    tr = ttr.TRACER.lookup("fault-scope-req")[0]
    assert tr["span_events"][0]["name"] == "fault"
    assert tr["span_events"][0]["point"] == "engine.device_step"


# -------------------------------------------------------------- traceparent

_HEX = "0123456789abcdefABCDEF"


@st.composite
def _headers(draw):
    part = st.text(alphabet=_HEX + "xz", max_size=34)
    shaped = st.builds(lambda a, b, c, d: f"{a}-{b}-{c}-{d}",
                       st.text(alphabet=_HEX, min_size=2, max_size=2),
                       st.text(alphabet=_HEX, min_size=31, max_size=33),
                       st.text(alphabet=_HEX, min_size=15, max_size=17),
                       part)
    zeros = st.sampled_from([f"00-{'0' * 32}-{'1' * 16}-01",
                             f"00-{'a' * 32}-{'0' * 16}-01",
                             f" 00-{'A' * 32}-{'b' * 16}-01 "])
    return draw(st.one_of(st.text(max_size=60), shaped, zeros,
                          st.lists(part, max_size=6).map("-".join)))


@settings(max_examples=300, deadline=None)
@given(_headers())
def test_parse_traceparent_matches_jax(header):
    assert ttr.parse_traceparent(header) == jtr.parse_traceparent(header)


@settings(max_examples=100, deadline=None)
@given(st.text(alphabet="0123456789abcdef", min_size=32, max_size=32),
       st.text(alphabet="0123456789abcdef", min_size=16, max_size=16))
def test_make_traceparent_matches_jax(trace_id, span_id):
    got = ttr.make_traceparent(trace_id, span_id)
    assert got == jtr.make_traceparent(trace_id, span_id)
    assert ttr.parse_traceparent(got) == jtr.parse_traceparent(got)


# -------------------------------------------------------------- openmetrics

def _observe(mod) -> str:
    r = mod.Registry()
    c = r.counter("reqs_total", "Requests", labels=("code",))
    h = r.histogram("ttft_seconds", "Time to first token",
                    labels=("model",), buckets=(0.01, 0.1, 1.0))
    g = r.gauge("depth_count", "Queue depth")
    for i, v in enumerate((0.005, 0.05, 0.07, 0.5, 3.0, 0.002)):
        h.labels(model="m").observe(
            v, exemplar={"trace_id": f"{i:032x}"} if i % 2 == 0 else None)
    c.labels(code="200").inc(3)
    g.set(2.5)
    return r.render(openmetrics=True) + r.render()


def test_openmetrics_with_exemplars_is_byte_identical(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.125)
    got = _observe(treg)
    assert got == _observe(jreg)
    assert '# {trace_id="' in got and "# EOF\n" in got
    assert "# TYPE reqs counter" in got


# --------------------------------------------------------- the two servers

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("observe")
    models = root / "models"
    models.mkdir()
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256,
    )).save_pretrained(models / "tiny-ckpt", safe_serialization=True)
    (models / "tiny.yaml").write_text(json.dumps(TINY, indent=1))
    return root


@pytest.fixture(scope="module")
def servers(workdir):
    """(jax call, port call): each ``call(method, path, body, headers)``
    returns (status, headers, body bytes, reason)."""
    from aiohttp.test_utils import TestClient, TestServer

    from localai_tfp_tpu.config.app_config import \
        ApplicationConfig as JaxConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application as JaxApp
    from localai_tfp_tpu_torch.config.app_config import ApplicationConfig
    from localai_tfp_tpu_torch.server.app import Server
    from localai_tfp_tpu_torch.server.state import Application

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    common = dict(models_path=str(workdir / "models"),
                  config_dir=str(workdir / "conf"),
                  state_dir=str(workdir / "run"))
    loop = asyncio.new_event_loop()
    tc = TestClient(TestServer(build_app(JaxApp(JaxConfig(
        generated_content_dir=str(workdir / "gen"),
        upload_dir=str(workdir / "up"), **common)))), loop=loop)
    loop.run_until_complete(tc.start_server())
    srv = Server(Application(ApplicationConfig(
        address="127.0.0.1", port=0, **common), device="cpu"))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def jax(method, path, body=None, headers=None):
        async def go():
            r = await tc.request(method, path, json=body,
                                 headers=headers or {})
            return r.status, dict(r.headers), await r.read(), r.reason
        return loop.run_until_complete(go())

    def port_(method, path, body=None, headers=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, dict(r.headers), r.read(), r.reason
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read(), e.reason

    yield jax, port_
    srv.close()
    th.join(timeout=30)
    loop.run_until_complete(tc.close())
    loop.close()
    torch.set_num_threads(n)


def _traces(call, ident):
    status, _, body, _ = call("GET", f"/debug/traces?id={ident}")
    assert status == 200
    return json.loads(body)["traces"]


def test_streamed_request_traces_match_jax(servers):
    got = []
    for call in servers:
        tid = ttr.mint_trace_id()
        hdr = ttr.make_traceparent(tid)
        status, headers, body, _ = call("POST", "/v1/chat/completions",
                                        CHAT, {"traceparent": hdr})
        assert status == 200 and b"data: [DONE]" in body
        echoed = ttr.parse_traceparent(headers["traceparent"])
        assert echoed is not None and echoed[0] == tid
        # the stream_done milestone lands once the writer finished
        deadline = time.time() + 10
        while True:
            traces = _traces(call, tid)
            req = [t for t in traces if t["model"] == "tiny"]
            if req and req[0]["events"][-1]["phase"] == "stream_done":
                break
            assert time.time() < deadline, traces
            time.sleep(0.05)
        got.append(sorted(
            ([e["phase"] for e in t["events"]], [s["name"] for s in t["spans"]],
             t["model"], t["trace_id"] == tid, t["status"])
            for t in traces))
    assert got[0] == got[1]
    phases = [g[0] for g in got[1] if g[2] == "tiny"][0]
    assert phases == ["receive", "auth", "queue", "admit",
                      "prefill_dispatch", "first_token", "done",
                      "stream_done"]


def test_debug_route_arguments_match_jax(servers):
    for path in ("/debug/traces?limit=bogus", "/debug/timeline?limit=x"):
        statuses = [call("GET", path)[0] for call in servers]
        assert statuses == [400, 400]
    jax, port = servers
    status, headers, body, _ = port("GET", "/debug/timeline?limit=5")
    assert status == 200 and headers["Cache-Control"] == "no-store"
    trace = json.loads(body)
    assert len(trace["traceEvents"]) <= 5
    assert trace["otherData"]["ring_capacity"] == FLIGHT.capacity


def test_profile_route_off_matches_jax(servers, monkeypatch):
    monkeypatch.delenv("LOCALAI_PROFILER", raising=False)
    (js, _, _, jreason), (ts, _, tbody, _) = [
        call("GET", "/debug/profile?duration=0.1") for call in servers]
    assert js == ts == 403
    assert json.loads(tbody)["error"]["message"] == jreason


def test_profile_route_writes_a_trace_on_the_cpu(servers, monkeypatch):
    monkeypatch.setenv("LOCALAI_PROFILER", "on")
    monkeypatch.setenv("LOCALAI_PROFILER_MAX_S", "0.5")
    port = servers[1]
    first = {}
    th = threading.Thread(target=lambda: first.update(
        r=port("GET", "/debug/profile?duration=99")))
    th.start()
    time.sleep(0.15)
    assert port("GET", "/debug/profile?duration=0.1")[0] == 409
    th.join(timeout=30)
    status, _, body, _ = first["r"]
    assert status == 200
    out = json.loads(body)
    assert out["duration_s"] == 0.5 and out["bytes"] > 0
    status, headers, body, _ = port(
        "GET", "/debug/profile?duration=0.1&download=1")
    assert status == 200 and headers["Content-Type"] == "application/zip"
    assert "trace.json" in zipfile.ZipFile(io.BytesIO(body)).namelist()


def test_load_breakdown_keys_match_jax(servers):
    keys = []
    for call in servers:
        status, _, body, _ = call("POST", "/v1/chat/completions",
                                  {**CHAT, "stream": False})
        assert status == 200
        status, _, body, _ = call("GET", "/backend/monitor?model=tiny")
        assert status == 200, body
        bd = json.loads(body)["load_breakdown"]
        keys.append(sorted(bd))
        assert bd["total_s"] >= bd["read_s"] + bd["transfer_s"]
    assert keys[0] == keys[1]


def test_metrics_negotiate_openmetrics_with_a_trace_exemplar(servers):
    port = servers[1]
    status, headers, body, _ = port("POST", "/v1/chat/completions", CHAT)
    assert status == 200
    status, headers, body, _ = port(
        "GET", "/metrics", headers={"Accept": "application/openmetrics-text"})
    text = body.decode()
    assert status == 200
    assert headers["Content-Type"].startswith("application/openmetrics-text")
    assert text.endswith("# EOF\n")
    line = next(ln for ln in text.splitlines()
                if ln.startswith("engine_ttft_seconds_bucket")
                and '# {trace_id="' in ln)
    tid = line.split('trace_id="')[1].split('"')[0]
    assert _traces(port, tid)
    status, headers, body, _ = port("GET", "/metrics")
    assert headers["Content-Type"].startswith("text/plain")
    assert "# EOF" not in body.decode() and "trace_id" not in body.decode()
