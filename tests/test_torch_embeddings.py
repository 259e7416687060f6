"""LLM embeddings of the port (``LLMEngine.embed``,
``TorchLLMBackend.embedding``, ``/v1/embeddings``) against the JAX
package's on the same weights, in f32 on the CPU.

- ``LLMEngine.embed`` equals the JAX engine's ``embed`` (the mean over the
  real tokens of the final hidden state) within 1e-4 absolute, for
  texts that pad to each prefill bucket, an empty text, and one cut at
  ``max_seq``; past the largest bucket (where the JAX engine cannot pad)
  it equals the port's own dense forward.
- The embedding runs over a scratch arena: the serving arena, the page
  pool and every slot are bitwise as before, and while the engine thread
  serves greedy requests an embedding changes neither their ids nor its
  own vector.
- ``/v1/embeddings`` (and ``/embeddings``, ``/v1/engines/{model}/...``)
  answers the JAX server's body field for field on the same config and
  checkpoint, vectors within 1e-4.
"""

import asyncio
import json
import threading
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
from localai_tfp_tpu_torch.engine import engine as te
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.models.transformer import KVCache, forward_hidden

TOL = 1e-4  # absolute, f32 on both sides
ENGINE_KW = dict(n_slots=4, max_seq=256, prefill_buckets=(8, 32, 128))
TEXTS = ["", "hi", "hello world", "the quick brown fox jumps over it",
         "x" * 100, "y" * 127]


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


@pytest.fixture(scope="module")
def jax_engine(weights):
    spec = jax_tiny(vocab_size=258, max_position=512)
    eng = je.LLMEngine(spec, {k: jnp.asarray(v) for k, v in weights.items()},
                       JaxBytes(), cache_dtype=jnp.float32, **ENGINE_KW)
    yield eng
    eng.close()


@pytest.fixture
def torch_engine(weights):
    eng = te.LLMEngine(tiny_spec(vocab_size=258, max_position=512),
                       params_from_numpy(weights), ByteTokenizer(),
                       cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
    yield eng
    eng.close()


@pytest.mark.parametrize("text", TEXTS)
def test_embed_matches_jax_engine(text, jax_engine, torch_engine):
    want = np.asarray(jax_engine.embed(text), dtype=np.float32)
    got = torch_engine.embed(text)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL


def _dense_mean(eng, ids: list) -> torch.Tensor:
    """The port's dense forward over ``ids`` alone, mean-pooled."""
    cache = KVCache.create(eng.spec, 1, len(ids), torch.float32)
    h, _ = forward_hidden(eng.spec, eng.params,
                          torch.tensor([ids], dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), cache)
    return h[0].float().mean(0)


def test_embed_past_the_largest_bucket_and_cut_at_max_seq(torch_engine):
    eng = torch_engine
    for text in ("z" * 200, "w" * 400):
        ids = eng.tokenizer.encode(text, add_bos=True)[: eng.max_seq]
        got = eng.embed(text)
        assert (got - _dense_mean(eng, ids)).abs().max().item() <= TOL


def test_embed_touches_no_serving_state(torch_engine):
    eng = torch_engine
    eng.generate(te.GenRequest(prompt_ids=eng.tokenizer.encode(
        "resident", add_bos=True), max_tokens=4, temperature=0.0))
    before = (eng.cache.k.clone(), eng.cache.v.clone(), eng._pool.stats(),
              [(s.state, list(s.cache_tokens)) for s in eng.slots])
    eng.embed("a text to embed")
    after = (eng.cache.k, eng.cache.v, eng._pool.stats(),
             [(s.state, list(s.cache_tokens)) for s in eng.slots])
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])
    assert before[2:] == after[2:]
    eng.leak_check()


def test_embed_while_the_engine_serves(torch_engine, weights):
    eng = torch_engine
    prompts = ["first stream", "second one", "and a third"]

    def reqs():
        return [te.GenRequest(prompt_ids=eng.tokenizer.encode(
            p, add_bos=True), max_tokens=12, temperature=0.0,
            ignore_eos=True) for p in prompts]

    alone = [eng.generate(r).full_text for r in reqs()]
    want = eng.embed("concurrent embedding")
    qs = eng.submit_many(reqs())
    vecs = [eng.embed("concurrent embedding") for _ in range(4)]
    got = []
    for q in qs:
        ev = q.get()
        while not ev.done:
            ev = q.get()
        got.append(ev.full_text)
    assert got == alone
    assert all(torch.equal(v, want) for v in vecs)


def test_released_engine_refuses_to_embed(weights):
    eng = te.LLMEngine(tiny_spec(vocab_size=258, max_position=512),
                       params_from_numpy(weights), ByteTokenizer(),
                       cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
    eng.close()
    eng.release()
    assert eng.params is None and eng.cache is None
    with pytest.raises(RuntimeError, match="released"):
        eng.embed("x")


# ------------------------------------------------------------------ HTTP

TINY = {
    "name": "tiny", "backend": "jax-llm", "embeddings": True,
    "parameters": {"model": "tiny-ckpt", "temperature": 0.0},
    "context_size": 128, "max_batch_slots": 2, "dtype": "float32",
}
BODIES = [
    ("/v1/embeddings", {"model": "tiny", "input": ["hello", "a longer "
                                                   "input text"]}),
    ("/embeddings", {"model": "tiny", "input": "one string"}),
    ("/v1/engines/tiny/embeddings", {"prompt": ["via the path", 42]}),
    ("/engines/tiny/embeddings", {"input": ""}),
]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    root = tmp_path_factory.mktemp("torch_emb")
    models = root / "models"
    models.mkdir()
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256,
    )).save_pretrained(models / "tiny-ckpt", safe_serialization=True)
    (models / "tiny.yaml").write_text(json.dumps(TINY))
    return root


@pytest.fixture(scope="module")
def jax_post(workdir):
    from aiohttp.test_utils import TestClient, TestServer

    from localai_tfp_tpu.config.app_config import ApplicationConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application

    loop = asyncio.new_event_loop()
    state = Application(ApplicationConfig(
        models_path=str(workdir / "models"),
        generated_content_dir=str(workdir / "generated"),
        upload_dir=str(workdir / "uploads"),
        config_dir=str(workdir / "configuration"),
        state_dir=str(workdir / "run")))
    tc = TestClient(TestServer(build_app(state)), loop=loop)
    loop.run_until_complete(tc.start_server())

    def post(path, body):
        async def go():
            r = await tc.post(path, json=body)
            return r.status, await r.json()
        return loop.run_until_complete(go())

    yield post
    loop.run_until_complete(tc.close())
    loop.close()


@pytest.fixture(scope="module")
def torch_post(workdir):
    from localai_tfp_tpu_torch.server.app import build_server

    srv = build_server(str(workdir / "models"), port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    yield post
    srv.close()
    th.join(timeout=30)


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_embeddings_route_matches_jax_server(i, jax_post, torch_post):
    path, body = BODIES[i]
    ws, want = jax_post(path, body)
    ts, got = torch_post(path, body)
    assert ts == ws == 200
    vec_w = [d.pop("embedding") for d in want["data"]]
    vec_g = [d.pop("embedding") for d in got["data"]]
    assert got == want  # object, model, index, usage
    assert len(vec_g) == len(vec_w) >= 1
    for g, w in zip(vec_g, vec_w):
        assert len(g) == len(w) == 64
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= TOL
