"""The port's encoder workers and retrieval routes against the JAX
server on one models directory, in f32 on the CPU.

The directory holds tiny BERTs from transformers ``save_pretrained``
(``BertModel``; ``BertForSequenceClassification`` with 1 and 3 labels),
each with a WordPiece ``tokenizer.json`` trained by ``tokenizers``, and
YAMLs with ``backend: sentencetransformers`` and ``backend: rerankers``
(the JAX aliases, which the port maps to ``torch-embeddings`` and
``torch-rerank``). Both servers answer:

- ``/v1/embeddings`` (a list input whose texts pad to every bucket, one
  cut at the checkpoint's positions; also ``/v1/engines/{model}/...``):
  vectors within 1e-5, unit norm;
- ``/v1/rerank`` on the cross-encoders (1 and 3 classes) and on the
  bi-encoder (cosine): equal indices, scores within 1e-5, equal usage,
  ``top_n`` honoured;
- a missing rerank model: 404 on both; a model whose worker has no
  rerank: 501 on both.

The workers are also held to each other directly (``embed_batch``,
``rerank``), and an unload drops the worker's tensors.
"""

import asyncio
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_wordpiece import write_bert_tokenizer

TOL = 1e-5
TEXTS = [
    "The quick brown fox.",
    "Embeddings are pooled; rerankers score a query against documents!",
    " ".join(["paged attention reads the keys of every slot"] * 6),
    " ".join(["Café naïve résumé 北京是中国的首都"] * 12),  # past 64 positions
    "",
]
QUERY = "which fox jumps over the dog?"
DOCS = ["The quick brown fox jumps over the lazy dog.",
        "Paged attention reads the keys of every slot.",
        "北京是中国的首都。", "", "a fox, a dog, a jump",
        "Embeddings are pooled; rerankers score a query."]
YAMLS = {
    "emb": {"backend": "sentencetransformers", "model": "minilm"},
    "rr": {"backend": "rerankers", "model": "cross1"},
    "rr3": {"backend": "rerank", "model": "cross3"},
    "rr-bi": {"backend": "rerankers", "model": "minilm"},
}


def write_models(root) -> None:
    from transformers import (BertConfig, BertForSequenceClassification,
                              BertModel)

    write_bert_tokenizer(root / "minilm")
    vocab = len(json.loads((root / "minilm" / "tokenizer.json").read_text())
                ["model"]["vocab"])
    kw = dict(vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64)
    torch.manual_seed(0)
    BertModel(BertConfig(**kw)).save_pretrained(root / "minilm",
                                                safe_serialization=True)
    for labels in (1, 3):
        d = root / f"cross{labels}"
        torch.manual_seed(labels)
        BertForSequenceClassification(BertConfig(num_labels=labels, **kw)
                                      ).save_pretrained(
            d, safe_serialization=True)
        for f in ("tokenizer.json", "tokenizer_config.json"):
            (d / f).write_text((root / "minilm" / f).read_text())
    for name, y in YAMLS.items():
        (root / f"{name}.yaml").write_text(
            f"name: {name}\nbackend: {y['backend']}\n"
            f"parameters:\n  model: {y['model']}\n")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Pair:
    """The JAX server (aiohttp test server) and the port's (stdlib server
    on a thread) over one models directory; ``both`` returns each one's
    (status, body bytes)."""

    def __init__(self, tmp, models) -> None:
        from aiohttp.test_utils import TestClient, TestServer

        from localai_tfp_tpu.config.app_config import \
            ApplicationConfig as JaxConfig
        from localai_tfp_tpu.server.app import build_app
        from localai_tfp_tpu.server.state import Application as JaxApp
        from localai_tfp_tpu_torch.config.app_config import \
            ApplicationConfig
        from localai_tfp_tpu_torch.server.app import Server
        from localai_tfp_tpu_torch.server.state import Application

        common = dict(models_path=str(models), config_dir=str(tmp / "conf"),
                      state_dir=str(tmp / "run"))
        self.loop = asyncio.new_event_loop()
        self.jstate = JaxApp(JaxConfig(generated_content_dir=str(tmp / "gen"),
                                       upload_dir=str(tmp / "up"), **common))
        self.tc = TestClient(TestServer(build_app(self.jstate)),
                             loop=self.loop)
        self.loop.run_until_complete(self.tc.start_server())
        self.app = Application(ApplicationConfig(
            address="127.0.0.1", port=0, **common), device="cpu")
        self.srv = Server(self.app)
        self.th = threading.Thread(target=self.srv.serve_forever,
                                   daemon=True)
        self.th.start()
        self.port = self.srv.server_address[1]

    def jax(self, path, body):
        async def go():
            r = await self.tc.request("POST", path, data=json.dumps(body))
            return r.status, await r.read()
        return self.loop.run_until_complete(go())

    def torch(self, path, body):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        c.request("POST", path, body=json.dumps(body).encode())
        r = c.getresponse()
        out = r.status, r.read()
        c.close()
        return out

    def both(self, path, body):
        return self.jax(path, body), self.torch(path, body)

    def close(self) -> None:
        self.srv.close()
        self.th.join(timeout=30)
        self.loop.run_until_complete(self.tc.close())
        self.loop.close()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("retrieval_models")
    write_models(root)
    return root


@pytest.fixture(scope="module")
def pair(tmp_path_factory, models):
    p = Pair(tmp_path_factory.mktemp("retrieval_srv"), models)
    yield p
    p.close()


def _ok(res) -> dict:
    (js, jb), (ts, tb) = res
    assert js == ts == 200, (jb[:300], tb[:300])
    return json.loads(jb), json.loads(tb)


@pytest.mark.parametrize("path", ["/v1/embeddings", "/embeddings",
                                  "/v1/engines/emb/embeddings"])
def test_embeddings_route_matches_jax_server(pair, path):
    body = {"input": TEXTS}
    if "engines" not in path:
        body["model"] = "emb"
    want, got = _ok(pair.both(path, body))
    assert got["model"] == want["model"] == "emb"
    assert got["usage"] == want["usage"]
    assert len(got["data"]) == len(want["data"]) == len(TEXTS)
    for w, g in zip(want["data"], got["data"]):
        assert (g["object"], g["index"]) == (w["object"], w["index"])
        v, u = np.asarray(g["embedding"]), np.asarray(w["embedding"])
        assert v.shape == u.shape == (32,)
        np.testing.assert_allclose(v, u, rtol=0, atol=TOL)
        assert abs(np.linalg.norm(v) - 1.0) < 1e-5


@pytest.mark.parametrize("model", ["rr", "rr3", "rr-bi"])
@pytest.mark.parametrize("top_n", [None, 3])
def test_rerank_route_matches_jax_server(pair, model, top_n):
    body = {"model": model, "query": QUERY, "documents": DOCS}
    if top_n:
        body["top_n"] = top_n
    want, got = _ok(pair.both("/v1/rerank", body))
    assert got["model"] == want["model"] == model
    assert got["usage"] == want["usage"]
    assert got["usage"]["total_tokens"] > 0
    assert len(got["results"]) == len(want["results"]) == (top_n or len(DOCS))
    for w, g in zip(want["results"], got["results"]):
        assert g["index"] == w["index"]
        assert g["document"] == w["document"] == {"text": DOCS[g["index"]]}
        assert abs(g["relevance_score"] - w["relevance_score"]) <= TOL


def test_rerank_without_a_model_is_404_and_without_the_call_501(pair):
    (js, jb), (ts, tb) = pair.both("/v1/rerank", {
        "model": "nowhere", "query": "q", "documents": ["d"]})
    assert js == ts == 404
    assert "no rerank model available" in jb.decode()
    assert json.loads(tb)["error"]["message"] == "no rerank model available"
    (js, _), (ts, tb) = pair.both("/v1/rerank", {
        "model": "emb", "query": "q", "documents": ["d"]})
    assert js == ts == 501


def test_empty_documents_rerank_to_nothing(pair):
    want, got = _ok(pair.both("/v1/rerank", {"model": "rr", "query": "q",
                                             "documents": []}))
    assert got == want == {"model": "rr", "usage": {}, "results": []}


@pytest.fixture(scope="module")
def workers(models):
    from localai_tfp_tpu.workers.embeddings import JaxEmbeddingsBackend
    from localai_tfp_tpu.workers.rerank import JaxRerankBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.embeddings import \
        TorchEmbeddingsBackend
    from localai_tfp_tpu_torch.workers.rerank import TorchRerankBackend
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JaxOpts

    out = {}
    for name, (jcls, tcls, ckpt) in {
            "emb": (JaxEmbeddingsBackend, TorchEmbeddingsBackend, "minilm"),
            "rr3": (JaxRerankBackend, TorchRerankBackend, "cross3")}.items():
        j, t = jcls(), tcls("cpu")
        assert j.load_model(JaxOpts(model=ckpt, model_path=str(models))
                            ).success
        assert t.load_model(ModelLoadOptions(model=ckpt,
                                             model_path=str(models))).success
        out[name] = (j, t)
    return out


def test_embed_batch_pads_to_the_jax_buckets(workers):
    j, t = workers["emb"]
    assert t.LEN_BUCKETS == j.LEN_BUCKETS == (16, 64, 128, 256, 512)
    for texts in (TEXTS, TEXTS[:1], TEXTS[2:4]):
        np.testing.assert_allclose(t.embed_batch(texts), j.embed_batch(texts),
                                   rtol=0, atol=TOL)
    for n in (1, 16, 17, 64, 65, 600):
        assert t._bucket(n) == j._bucket(n)


def test_rerank_worker_matches_jax_worker(workers):
    j, t = workers["rr3"]
    want, got = j.rerank(QUERY, DOCS, 4), t.rerank(QUERY, DOCS, 4)
    assert [d.index for d in got.results] == [d.index for d in want.results]
    assert got.usage == want.usage
    for a, b in zip(got.results, want.results):
        assert abs(a.relevance_score - b.relevance_score) <= TOL


def test_unload_drops_the_tensors_and_refuses(models):
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.embeddings import \
        TorchEmbeddingsBackend

    t = TorchEmbeddingsBackend("cpu")
    assert not t.load_model(ModelLoadOptions(model="absent",
                                             model_path=str(models))).success
    assert not t.health()
    assert t.load_model(ModelLoadOptions(model="minilm",
                                         model_path=str(models))).success
    assert t.health() and t.status().memory["param_bytes"] > 0
    t.shutdown()
    assert t.params is None and t.spec is None and t.tokenizer is None
    with pytest.raises(RuntimeError, match="not loaded"):
        t.embed_batch(["x"])


def test_encoder_workers_default_to_the_card(monkeypatch):
    from localai_tfp_tpu_torch.store.backend import LocalStoreBackend
    from localai_tfp_tpu_torch.workers.embeddings import \
        TorchEmbeddingsBackend
    from localai_tfp_tpu_torch.workers.rerank import TorchRerankBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TorchEmbeddingsBackend, TorchRerankBackend,
                LocalStoreBackend):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
        assert cls("cpu").device == torch.device("cpu")
