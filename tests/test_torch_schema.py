"""Request validation (localai_tfp_tpu_torch/server/schema.py) against the
JAX server's (localai_tfp_tpu/server/schema.py): every malformed body
below is refused by both servers with the same status and message,
before any model is resolved or loaded (the models directory is empty).

The JAX server answers with aiohttp's plain-text error (``400: <reason>``);
the port with its JSON error whose message is the reason. Bodies cover
the chat, completion, edit, embeddings and rerank routes: wrong types of
the sampling fields (``"stream": "no"``, ``"max_tokens": "16"`` or
``16.7``, ``"seed": "7"``, ``"stop": [1, 2]``, ``"temperature": true``,
...), messages, prompts, documents and queries.
"""

import json

import pytest

from tests.test_torch_retrieval import Pair

CHAT = {"messages": [{"role": "user", "content": "hi"}]}
RERANK = {"query": "q", "documents": ["a", "b"]}

CASES = [
    # (route, body, reason)
    ("/v1/chat/completions", {**CHAT, "stream": "no"},
     "field 'stream' must be a boolean"),
    ("/v1/chat/completions", {**CHAT, "max_tokens": "16"},
     "field 'max_tokens' must be an integer"),
    ("/v1/chat/completions", {**CHAT, "max_tokens": 16.7},
     "field 'max_tokens' must be an integer"),
    ("/v1/chat/completions", {**CHAT, "seed": "7"},
     "field 'seed' must be an integer"),
    ("/v1/chat/completions", {**CHAT, "stop": [1, 2]},
     "field 'stop' must be a string or list of strings"),
    ("/v1/chat/completions", {**CHAT, "temperature": True},
     "field 'temperature' must be a number"),
    ("/v1/chat/completions", {**CHAT, "top_k": True},
     "field 'top_k' must be an integer"),
    ("/v1/chat/completions", {**CHAT, "n": "2"},
     "field 'n' must be an integer"),
    ("/v1/chat/completions", {**CHAT, "timeout": -1},
     "field 'timeout' must be a non-negative number of seconds"),
    ("/v1/chat/completions", {**CHAT, "timeout": "soon"},
     "field 'timeout' must be a number"),
    ("/v1/chat/completions", {**CHAT, "logit_bias": [1]},
     "field 'logit_bias' must be an object of token-id -> bias"),
    ("/v1/chat/completions", {**CHAT, "ignore_eos": 1},
     "field 'ignore_eos' must be a boolean"),
    ("/v1/chat/completions", {**CHAT, "tools": {}},
     "field 'tools' must be a list"),
    ("/v1/chat/completions", {**CHAT, "response_format": 1},
     "field 'response_format' must be a string or object"),
    ("/v1/chat/completions", {},
     "field 'messages' must be a non-empty list of message objects"),
    ("/v1/chat/completions", {"messages": ["hi"]},
     "field 'messages' must be a list of message objects"),
    ("/v1/chat/completions", {"messages": [{"role": 1}]},
     "field 'messages[].role' must be a string"),
    ("/v1/chat/completions", {"messages": [{"content": 5}]},
     "field 'messages[].content' must be a string or part list"),
    ("/v1/completions", {"prompt": [1, 2]},
     "field 'prompt' must be a string or list of strings"),
    ("/v1/completions", {"prompt": "x", "temperature": "hot"},
     "field 'temperature' must be a number"),
    ("/v1/edits", {"instruction": 5},
     "field 'instruction' must be a string"),
    ("/v1/edits", {"input": "x", "top_p": "1"},
     "field 'top_p' must be a number"),
    ("/v1/embeddings", {"input": 5},
     "field 'input' must be a string or list of strings"),
    ("/v1/embeddings", {"input": [["x"]]},
     "field 'input' must be a string or list of strings"),
    ("/v1/embeddings", {"prompt": {"x": 1}},
     "field 'prompt' must be a string or list of strings"),
    ("/v1/rerank", {**RERANK, "documents": "a"},
     "field 'documents' must be a list of strings"),
    ("/v1/rerank", {**RERANK, "documents": ["a", 2]},
     "field 'documents' must be a list of strings"),
    ("/v1/rerank", {"query": "q"},
     "field 'documents' must be a list of strings"),
    ("/v1/rerank", {**RERANK, "query": 5},
     "field 'query' must be a string"),
    ("/v1/rerank", {"documents": ["a"]},
     "field 'query' must be a string"),
    ("/v1/rerank", {**RERANK, "top_n": "3"},
     "field 'top_n' must be an integer"),
]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("schema_srv"),
             tmp_path_factory.mktemp("schema_models"))
    yield p
    p.close()


@pytest.mark.parametrize("route,body,reason", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_malformed_body_is_refused_as_by_jax(pair, route, body, reason):
    (js, jb), (ts, tb) = pair.both(route, body)
    assert js == ts == 400
    assert jb.decode() == f"400: {reason}"
    assert json.loads(tb)["error"]["message"] == reason


def test_bad_timeout_header_is_refused_as_by_jax(pair):
    async def go():
        r = await pair.tc.request("POST", "/v1/chat/completions",
                                  data=json.dumps(CHAT),
                                  headers={"X-Request-Timeout": "soon"})
        return r.status, await r.read()

    js, jb = pair.loop.run_until_complete(go())
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", pair.port, timeout=60)
    c.request("POST", "/v1/chat/completions", body=json.dumps(CHAT),
              headers={"X-Request-Timeout": "soon"})
    r = c.getresponse()
    ts, tb = r.status, r.read()
    c.close()
    reason = "X-Request-Timeout must be a number of seconds"
    assert js == ts == 400
    assert jb.decode() == f"400: {reason}"
    assert json.loads(tb)["error"]["message"] == reason
