"""The int8 serving slice of the port against the JAX package, on the CPU.

- forward: the JAX ``forward`` and the port's on the same quantized f32
  tree (``int8`` and ``int8_full``, tied and untied head), carried across
  by models/convert.py, on the dense and the paged path, a ragged prefill
  then a decode step: logits within 1e-4 (f32, another summation order).
  One case at a 512-wide spec (every projection eligible) sets
  ``LOCALAI_INT8_KERNEL=1`` so the JAX side runs its Pallas kernel in
  interpret mode, and the port's kernel wrapper (its plain version here)
  serves every projection.
- ``_lm_head`` of a bf16 model returns the product's unrounded f32 sum, as
  the JAX package's does: within 1e-6 (the port used to round the logits
  to bf16 first, 9.7e-4 off).
- loader: the port's ``load_params(quantize=...)`` against the JAX
  package's ``load_params`` + ``quantize_params`` on an f32 and a bf16 tiny
  HF checkpoint served at bf16 (test_staging's tolerance).
- artifacts: a file written by either package loads in the other.
- worker and server: the ``quantization`` knob's values and messages are
  the JAX worker's, a second load reads the artifact, and a
  ``quantization: int8`` config streams the JAX server's greedy text.
"""

import asyncio
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import artifact_cache as jac
from localai_tfp_tpu.models import llm_spec as jspec
from localai_tfp_tpu.models import quant as jq
from localai_tfp_tpu.models import transformer as jt
from localai_tfp_tpu.ops import int8_matmul as jmm
from localai_tfp_tpu_torch.models import artifact_cache as tac
from localai_tfp_tpu_torch.models import llm_spec as tspec
from localai_tfp_tpu_torch.models import quant as tq
from localai_tfp_tpu_torch.models import transformer as tt
from localai_tfp_tpu_torch.models.convert import params_from_numpy, to_tensor
from localai_tfp_tpu_torch.models.hf_loader import load_params

from .test_torch_quant import assert_qtensor_close

B, T, PAGE, MAX_PAGES = 2, 6, 8, 4
LENS = np.asarray([6, 4], np.int32)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _tables():
    pt = np.random.default_rng(5).permutation(
        np.arange(1, B * MAX_PAGES + 1)).reshape(B, MAX_PAGES).astype(np.int32)
    return pt, B * MAX_PAGES + 1


def _run_jax(spec, params, paged):
    toks, nxt = jnp.asarray(_tokens(0, (B, T))), jnp.asarray(_tokens(1, (B, 1)))
    lens = jnp.asarray(LENS)
    zero = jnp.zeros(B, jnp.int32)
    if not paged:
        cache = jt.KVCache.create(spec, B, 32, jnp.float32)
        lg1, cache = jt.forward(spec, params, toks, zero, cache, None)
        lg2, _ = jt.forward(spec, params, nxt, lens, cache, None)
        return np.asarray(lg1), np.asarray(lg2)
    pt, n_pages = _tables()
    kw = dict(page_table=jnp.asarray(pt), kv_page=PAGE,
              write_table=jnp.asarray(pt))
    cache = jt.KVCache.create(spec, n_pages, PAGE, jnp.float32)
    lg1, cache = jt.forward(spec, params, toks, zero, cache, None,
                            q_lens=lens, **kw)
    lg2, _ = jt.forward(spec, params, nxt, lens, cache, None,
                        q_lens=jnp.ones(B, jnp.int32), **kw)
    return np.asarray(lg1), np.asarray(lg2)


def _run_torch(spec, params, paged):
    toks = torch.from_numpy(_tokens(0, (B, T)))
    nxt = torch.from_numpy(_tokens(1, (B, 1)))
    lens = torch.from_numpy(LENS)
    zero = torch.zeros(B, dtype=torch.int32)
    if not paged:
        cache = tt.KVCache.create(spec, B, 32, torch.float32)
        lg1, cache = tt.forward(spec, params, toks, zero, cache)
        lg2, _ = tt.forward(spec, params, nxt, lens, cache)
        return lg1.numpy(), lg2.numpy()
    pt, n_pages = _tables()
    kw = dict(page_table=torch.from_numpy(pt), kv_page=PAGE,
              write_table=torch.from_numpy(pt))
    cache = tt.KVCache.create(spec, n_pages, PAGE, torch.float32)
    lg1, cache = tt.forward(spec, params, toks, zero, cache, q_lens=lens, **kw)
    lg2, _ = tt.forward(spec, params, nxt, lens, cache,
                        q_lens=torch.ones(B, dtype=torch.int32), **kw)
    return lg1.numpy(), lg2.numpy()


def _assert_logits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
    for b, n in enumerate(LENS):  # prefill: each row's valid positions
        np.testing.assert_allclose(got[0][b, :n], want[0][b, :n], rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)


def _quantized(spec_kw, full, seed=3):
    spec_j = jspec.tiny_spec(vocab_size=64, **spec_kw)
    spec_t = tspec.tiny_spec(vocab_size=64, **spec_kw)
    params = jt.init_params(jax.random.PRNGKey(seed), spec_j,
                            dtype=jnp.float32)
    jtree = jq.quantize_params(params, embeddings=full)
    return spec_j, spec_t, jtree, params_from_numpy(jtree)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("full", [False, True], ids=["int8", "int8_full"])
def test_quantized_forward_matches_jax(full, tied, paged):
    spec_j, spec_t, jtree, ttree = _quantized(
        dict(tie_word_embeddings=tied), full)
    assert isinstance(ttree["wq"], tq.QTensor)
    assert isinstance(ttree["embed"], tq.QTensor) == full
    _assert_logits(_run_torch(spec_t, ttree, paged),
                   _run_jax(spec_j, jtree, paged))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_wide_model_runs_every_projection_through_the_kernels(
        monkeypatch, paged):
    """d 512, 4 x 128 heads, 4 kv heads, ffn 1024: every projection is
    eligible. The JAX side runs its Pallas kernel (interpret mode), the
    port its kernel wrapper, for each of the 7 projections of each layer
    and forward."""
    monkeypatch.setenv("LOCALAI_INT8_KERNEL", "1")
    spec_kw = dict(d_model=512, n_heads=4, n_kv_heads=4, d_head=128,
                   d_ff=1024, n_layers=2)
    spec_j, spec_t, jtree, ttree = _quantized(spec_kw, full=False, seed=7)
    counts = {"jax": 0, "torch": 0}
    real_j, real_t = jmm.int8_matmul, tq.int8_matmul

    def spy_j(*a, **kw):
        counts["jax"] += 1
        return real_j(*a, **kw)

    def spy_t(*a, **kw):
        counts["torch"] += 1
        return real_t(*a, **kw)

    monkeypatch.setattr(jmm, "int8_matmul", spy_j)
    monkeypatch.setattr(tq, "int8_matmul", spy_t)
    want = _run_jax(spec_j, jtree, paged)
    got = _run_torch(spec_t, ttree, paged)
    assert counts["jax"] > 0  # traced through the Pallas kernel
    assert counts["torch"] == 7 * spec_t.n_layers * 2  # 2 forwards
    _assert_logits(got, want)


@pytest.mark.parametrize("head", ["untied", "tied", "int8_untied",
                                  "int8_tied"])
def test_lm_head_bf16_returns_unrounded_f32_logits(head):
    """The JAX package multiplies bf16 values with f32 accumulation and
    returns the f32 sum; so must the port (the same bf16 hidden state and
    weights on both sides)."""
    tied = head in ("tied", "int8_tied")
    spec_j = jspec.tiny_spec(vocab_size=512, tie_word_embeddings=tied)
    spec_t = tspec.tiny_spec(vocab_size=512, tie_word_embeddings=tied)
    params = jt.init_params(jax.random.PRNGKey(0), spec_j, dtype=jnp.bfloat16)
    if head.startswith("int8"):
        params = jq.quantize_params(params, embeddings=True)
    x = (np.random.default_rng(0).standard_normal((2, 3, spec_j.d_model))
         ).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jt._lm_head(spec_j, params, xj))
    got = tt._lm_head(spec_t, params_from_numpy(params), to_tensor(
        np.asarray(xj)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- loading


def _save_tiny_hf(path, torch_dtype):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256))
    model.to(torch_dtype).save_pretrained(path, safe_serialization=True)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant_ckpts")
    return {"f32": _save_tiny_hf(root / "f32", torch.float32),
            "bf16": _save_tiny_hf(root / "bf16", torch.bfloat16)}


def assert_trees_close(got: dict, want: dict):
    """The port's tree against a JAX tree: QTensor leaves by
    ``assert_qtensor_close``, plain leaves exactly."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        if isinstance(w, jq.QTensor):
            assert_qtensor_close(got[k], w, k)
        else:
            assert not isinstance(got[k], tq.QTensor), k
            np.testing.assert_array_equal(
                got[k].float().numpy(),
                np.asarray(w).astype(np.float32), err_msg=k)


@pytest.mark.parametrize("mode", ["int8", "int8_full"])
@pytest.mark.parametrize("ckpt", ["f32", "bf16"])
def test_loader_quantizes_as_jax(ckpts, ckpt, mode):
    """Served at bf16: an f32 checkpoint is rounded to bf16 before it is
    quantized, so both packages see the same values."""
    from localai_tfp_tpu.models.hf_loader import load_params as jload

    _, jp = jload(ckpts[ckpt], dtype=jnp.bfloat16)
    want = jq.quantize_params(jp, embeddings=mode == "int8_full")
    spec, got = load_params(ckpts[ckpt], torch.bfloat16, "cpu",
                            quantize=mode)
    assert got["wq"].q.shape == (spec.n_layers, spec.d_model, spec.q_dim)
    assert_trees_close(got, want)


def test_loader_refuses_an_unknown_mode(ckpts):
    with pytest.raises(ValueError, match="quantize mode"):
        load_params(ckpts["f32"], torch.bfloat16, "cpu", quantize="int4")


def _assert_same_tree(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert isinstance(a[k], tq.QTensor) == isinstance(b[k], tq.QTensor)
        for x, y in zip(tq.leaves(a[k]), tq.leaves(b[k])):
            assert x.dtype == y.dtype and torch.equal(x, y), k


def test_artifact_written_by_the_port_loads_in_jax(ckpts, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("LOCALAI_QUANT_CACHE_DIR", str(tmp_path / "qc"))
    monkeypatch.setenv("LOCALAI_QUANT_ARTIFACTS", "on")
    d = ckpts["f32"]
    for quant in ("int8", "q8", "int8_full"):
        assert tac.artifact_path(d, quant, "bfloat16") == \
            jac.artifact_path(d, quant, "bfloat16")
    path = tac.artifact_path(d, "int8_full", "bfloat16")
    _, tree = load_params(d, torch.bfloat16, "cpu", quantize="int8_full")
    assert tac.save(path, tree)
    assert not [f for f in os.listdir(tmp_path / "qc") if f.endswith(".tmp")]
    loaded = jac.try_load(path, jax.devices("cpu")[0])
    assert loaded is not None and isinstance(loaded["embed"], jq.QTensor)
    assert set(loaded) == set(tree)
    for k, v in tree.items():
        for x, y in zip(tq.leaves(v), (loaded[k] if isinstance(
                loaded[k], jq.QTensor) else (loaded[k],))):
            np.testing.assert_array_equal(
                x.float().numpy(), np.asarray(y).astype(np.float32),
                err_msg=k)
    # and back in the port
    _assert_same_tree(tac.try_load(path, "cpu"), tree)
    # disabled: no read, no write
    monkeypatch.setenv("LOCALAI_QUANT_ARTIFACTS", "off")
    assert tac.try_load(path, "cpu") is None
    assert not tac.save(path + ".x", tree)


def test_artifact_written_by_jax_loads_in_the_port(ckpts, tmp_path,
                                                   monkeypatch):
    from localai_tfp_tpu.models.hf_loader import load_params as jload

    monkeypatch.setenv("LOCALAI_QUANT_CACHE_DIR", str(tmp_path / "qc"))
    monkeypatch.setenv("LOCALAI_QUANT_ARTIFACTS", "on")
    d = ckpts["bf16"]
    _, jp = jload(d, dtype=jnp.bfloat16)
    jtree = jq.quantize_params(jp)
    path = jac.artifact_path(d, "int8", "bfloat16")
    th = jac.save_async(path, jtree)
    th.join(timeout=120)
    got = tac.try_load(path, "cpu")
    assert got is not None
    assert_trees_close(got, jtree)
    for k in jtree:  # bit for bit, not only within the tolerance
        if isinstance(jtree[k], jq.QTensor):
            np.testing.assert_array_equal(got[k].q.numpy(),
                                          np.asarray(jtree[k].q))
    # another format version is a miss, not an error
    with open(path, "r+b") as f:
        raw = f.read()
        f.seek(0)
        f.write(raw.replace(b"int8-artifact-v1", b"int8-artifact-v0"))
    assert tac.try_load(path, "cpu") is None


# ---------------------------------------------------------- worker, server


def test_worker_quantization_values_and_artifact_reload(ckpts, tmp_path,
                                                        monkeypatch):
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
    from localai_tfp_tpu.workers.llm import JaxLLMBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions, \
        PredictOptions
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    monkeypatch.setenv("LOCALAI_QUANT_CACHE_DIR", str(tmp_path / "qc"))
    monkeypatch.setenv("LOCALAI_QUANT_ARTIFACTS", "on")

    def load(quant, **kw):
        b = TorchLLMBackend("cpu")
        res = b.load_model(ModelLoadOptions(
            model=ckpts["f32"], context_size=64, batch_slots=2,
            dtype="float32", quantization=quant, **kw))
        return b, res

    bad, res = load("exl2")
    jres = JaxLLMBackend().load_model(JOpts(
        model=ckpts["f32"], context_size=64, batch_slots=2,
        quantization="exl2"))
    assert not res.success and not jres.success
    assert res.message == jres.message == (
        "load failed: unsupported quantization 'exl2' (supported: int8, "
        "int8_full)")
    first, res = load("int8")
    assert res.success, res.message
    assert first.load_mode == "quantized"
    assert isinstance(first.engine.params["wq"], tq.QTensor)
    assert not isinstance(first.engine.params["embed"], tq.QTensor)
    assert len(os.listdir(tmp_path / "qc")) == 1
    second, res = load("q8")  # an alias: the same artifact
    assert res.success and second.load_mode == "artifact"
    _assert_same_tree(second.engine.params, first.engine.params)
    try:
        outs = [b.predict(PredictOptions(prompt="ab", tokens=4,
                                         ignore_eos=True)).message
                for b in (first, second)]
        assert outs[0] == outs[1]
        for quant in ("none", "bf16", ""):
            plain, res = load(quant)
            assert res.success and plain.load_mode == "full"
            assert not isinstance(plain.engine.params["wq"], tq.QTensor)
            plain.shutdown()
    finally:
        first.shutdown()
        second.shutdown()


QCFG = {
    "name": "tiny-q8", "backend": "jax-llm",
    "parameters": {"model": "tiny-ckpt", "temperature": 0.0,
                   "max_tokens": 10},
    "context_size": 128, "max_batch_slots": 4, "dtype": "float32",
    "quantization": "int8",
    "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                 "chat": "{{.Input}}\nassistant:"},
}
CHATS = [
    {"model": "tiny-q8", "stream": True,
     "messages": [{"role": "user", "content": "hello there"}]},
    {"model": "tiny-q8", "stream": True, "max_tokens": 6, "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "count to three"}]},
]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX server and the port's over one models dir holding an int8
    config and one with an unsupported quantization."""
    from aiohttp.test_utils import TestClient, TestServer
    from transformers import LlamaConfig, LlamaForCausalLM

    from localai_tfp_tpu.config.app_config import ApplicationConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application
    from localai_tfp_tpu_torch.server.app import build_server

    root = tmp_path_factory.mktemp("quant_srv")
    models = root / "models"
    models.mkdir()
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)).save_pretrained(
            models / "tiny-ckpt", safe_serialization=True)
    (models / "tiny-q8.yaml").write_text(json.dumps(QCFG))
    (models / "tiny-bad.yaml").write_text(json.dumps(
        {**QCFG, "name": "tiny-bad", "quantization": "exl2"}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LOCALAI_QUANT_CACHE_DIR", str(root / "qc"))
        loop = asyncio.new_event_loop()
        state = Application(ApplicationConfig(
            models_path=str(models),
            generated_content_dir=str(root / "generated"),
            upload_dir=str(root / "uploads"),
            config_dir=str(root / "configuration")))
        tc = TestClient(TestServer(build_app(state)), loop=loop)
        loop.run_until_complete(tc.start_server())

        def jax_call(body):
            async def go():
                r = await tc.request("POST", "/v1/chat/completions",
                                     json=body)
                return r.status, (await r.read()).decode()
            return loop.run_until_complete(go())

        srv = build_server(str(models), port=0, device="cpu")
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        port = srv.server_address[1]

        def torch_call(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        yield jax_call, torch_call, srv
        srv.close()
        th.join(timeout=30)
        loop.run_until_complete(tc.close())
        loop.close()


def _sse_content(text):
    frames = text.split("\n\n")
    assert frames[-2:] == ["data: [DONE]", ""]
    chunks = [json.loads(f[len("data: "):]) for f in frames[:-2]]
    return ("".join(c["choices"][0]["delta"].get("content", "")
                    for c in chunks[1:]),
            chunks[-1]["choices"][0]["finish_reason"], chunks[-1]["usage"])


@pytest.mark.parametrize("i", range(len(CHATS)))
def test_int8_config_streams_the_jax_servers_greedy_text(servers, i):
    jax_call, torch_call, srv = servers
    js, jbody = jax_call(CHATS[i])
    ts, tbody = torch_call(CHATS[i])
    assert js == ts == 200, (jbody, tbody)
    want, got = _sse_content(jbody), _sse_content(tbody)
    assert got == want and got[2]["completion_tokens"] > 0
    backend = srv.app.loaded()["tiny-q8"]
    assert isinstance(backend.engine.params["w_down"], tq.QTensor)


def test_unsupported_quantization_returns_the_jax_error_text(servers):
    jax_call, torch_call, _ = servers
    body = {"model": "tiny-bad", "messages": [{"role": "user",
                                               "content": "x"}]}
    (js, jbody), (ts, tbody) = jax_call(body), torch_call(body)
    text = "unsupported quantization 'exl2' (supported: int8, int8_full)"
    assert ts == 500 and text in json.loads(tbody)["error"]["message"]
    assert js >= 400 and text in jbody
