"""The port's text path against the JAX package's on the CPU: tokenizers
read from ``tokenizer.json`` directories, chat templates, model configs
in real YAML, and the text routes (``/v1/chat/completions`` through the
tokenizer's template and through a Go template, ``/v1/completions``,
``/v1/engines/{model}/completions``, ``/v1/edits``, ``/v1/tokenize``).

- Tokenizer: the port's ``load_tokenizer(d)`` against the JAX package's
  on directories saved with ``PreTrainedTokenizerFast.save_pretrained``,
  with and without ``clean_up_tokenization_spaces``: ``encode(add_bos)``,
  ``decode``, ``bos_id``, ``eos_ids``, ``vocab_size``, ``chat_template``
  and ``apply_chat_template``. The cleanup probe (ROADMAP §C 5) decodes
  to the JAX package's ``"<s>Hello, world. It's a test! Don't do
  that?"``.
- Serving: one tiny random-weight Llama (``LlamaForCausalLM(...)
  .save_pretrained``) whose vocabulary is the BPE's, served greedy by the
  JAX server and the port's server from the same YAML files. The prompt
  ids each engine received, the whole replies and the streamed text must
  be byte-identical, and a config's ``cutstrings``/``trimsuffix``/
  ``echo``/``trimspace`` must take effect in both.
- No fallback: an unsupported ``tokenizer.json`` component, a YAML the
  reader cannot read and a template that does not parse each fail the
  load or the request with the reason.
"""

import asyncio
import json
import re
import threading
import urllib.error
import urllib.request

import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
from tokenizers import Regex, Tokenizer, decoders, pre_tokenizers  # noqa: E402
from tokenizers.models import BPE  # noqa: E402
from tokenizers.trainers import BpeTrainer  # noqa: E402

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|"
                r"\s+")
CHAT_TEMPLATE = """{{- bos_token }}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content'] | trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{%- set ns = namespace(turns=0) %}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if tools is not none %}
    {{- "Tools:\\n" }}
    {%- for t in tools %}
        {{- t | tojson }}
        {{- "\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message + "<|eot_id|>" }}
{%- for message in messages %}
    {%- if message.role not in ['user', 'assistant', 'tool'] %}
        {{- raise_exception("unknown role " ~ message.role) }}
    {%- endif %}
    {%- set ns.turns = ns.turns + 1 %}
    {{- "<|start_header_id|>" + message.role + "<|end_header_id|>\\n\\n" + message.content | trim + "<|eot_id|>" }}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- "<|start_header_id|>assistant<|end_header_id|>\\n\\n" }}
{%- endif %}
"""
CORPUS = ["Hello, world! It's a test. Don't do that?",
          "The paged arena holds every slot's keys and values.",
          "Describe ragged attention in one line, please.",
          "Über café: naïve 中文 and 🎉 too.",
          "Translate: the cat sat on the mat.",
          "assistant user system tools weather city Paris"] * 4
SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
            "<|end_header_id|>", "<|eot_id|>"]


def _bpe(vocab_size: int) -> Tokenizer:
    pre = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tk = Tokenizer(BPE())
    tk.pre_tokenizer = pre
    tk.train_from_iterator(CORPUS, trainer=BpeTrainer(
        vocab_size=vocab_size - len(SPECIALS), show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    spec = json.loads(tk.to_str())["model"]
    out = Tokenizer(BPE(vocab=spec["vocab"],
                        merges=[tuple(m) for m in spec["merges"]],
                        ignore_merges=True))
    out.pre_tokenizer = pre
    out.decoder = decoders.ByteLevel()
    out.add_special_tokens(SPECIALS)
    return out


def _save_tokenizer(path, cleanup: bool, template: str = CHAT_TEMPLATE,
                    vocab_size: int = 384) -> int:
    from transformers import PreTrainedTokenizerFast

    tk = _bpe(vocab_size)
    PreTrainedTokenizerFast(
        tokenizer_object=tk, bos_token="<|begin_of_text|>",
        eos_token="<|end_of_text|>", clean_up_tokenization_spaces=cleanup,
        chat_template=template).save_pretrained(str(path))
    (path / "generation_config.json").write_text(json.dumps(
        {"eos_token_id": [tk.token_to_id("<|end_of_text|>"),
                          tk.token_to_id("<|eot_id|>")]}))
    return tk.get_vocab_size(with_added_tokens=True)


def _both(path):
    from localai_tfp_tpu.engine.tokenizer import load_tokenizer as jax_load
    from localai_tfp_tpu_torch.engine.tokenizer import load_tokenizer

    return jax_load(str(path)), load_tokenizer(str(path))


# ------------------------------------------------------------- tokenizer


def test_cleanup_probe_decodes_as_the_jax_package(tmp_path):
    """ROADMAP §C 5: clean_up_tokenization_spaces is applied."""
    from transformers import PreTrainedTokenizerFast

    text = "Hello , world . It 's a test ! Don't do that ?"
    tk = Tokenizer(BPE())
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.train_from_iterator([text] * 10, trainer=BpeTrainer(
        vocab_size=256 + 400, show_progress=False, special_tokens=["<s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tk.decoder = decoders.ByteLevel()
    PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>",
                            eos_token="<s>",
                            clean_up_tokenization_spaces=True
                            ).save_pretrained(str(tmp_path))
    jax_tk, port_tk = _both(tmp_path)
    ids = jax_tk.encode(text, add_bos=True)
    assert port_tk.encode(text, add_bos=True) == ids
    assert jax_tk.decode(ids) == \
        "<s>Hello, world. It's a test! Don't do that?"
    assert port_tk.decode(ids) == jax_tk.decode(ids)


@pytest.mark.parametrize("cleanup", [False, True])
def test_tokenizer_matches_the_jax_package(tmp_path, cleanup):
    import numpy as np

    _save_tokenizer(tmp_path, cleanup)
    jax_tk, port_tk = _both(tmp_path)
    assert port_tk.bos_id == jax_tk.bos_id
    assert port_tk.eos_ids == jax_tk.eos_ids
    assert port_tk.vocab_size == jax_tk.vocab_size
    assert port_tk.chat_template == jax_tk.chat_template
    texts = CORPUS[:6] + ["a , b . c 's d 've e n't", "", " x  y ",
                          "<|eot_id|>hi<|start_header_id|>"]
    for text in texts:
        for bos in (False, True):
            ids = jax_tk.encode(text, add_bos=bos)
            assert port_tk.encode(text, add_bos=bos) == ids
            assert port_tk.decode(ids) == jax_tk.decode(ids)
    rng = np.random.default_rng(0)
    for _ in range(100):
        ids = rng.integers(0, jax_tk.vocab_size, size=10).tolist()
        assert port_tk.decode(ids) == jax_tk.decode(ids)
    for msgs, tools in (
            ([{"role": "user", "content": "hi"}], None),
            ([{"role": "system", "content": " sys "},
              {"role": "user", "content": "a"},
              {"role": "assistant", "content": "b"},
              {"role": "user", "content": "c"}],
             [{"name": "f", "parameters": {"type": "object"}}])):
        for gen in (False, True):
            assert port_tk.apply_chat_template(
                msgs, add_generation_prompt=gen, tools=tools) == \
                jax_tk.apply_chat_template(msgs, add_generation_prompt=gen,
                                           tools=tools)


def test_named_templates_and_template_file(tmp_path):
    """A list of named templates picks "tool_use" with tools and
    "default" without; a chat_template.jinja file is read as
    transformers reads it."""
    _save_tokenizer(tmp_path, False)
    cfg_path = tmp_path / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.pop("chat_template", None)
    cfg["chat_template"] = [{"name": "default", "template": "D{{ messages|length }}"},
                            {"name": "tool_use", "template": "T{{ tools|length }}"}]
    cfg_path.write_text(json.dumps(cfg))
    (tmp_path / "chat_template.jinja").unlink(missing_ok=True)
    jax_tk, port_tk = _both(tmp_path)
    msgs = [{"role": "user", "content": "x"}]
    for tools in (None, [{"name": "f"}]):
        assert port_tk.apply_chat_template(msgs, tools=tools) == \
            jax_tk.apply_chat_template(msgs, tools=tools)
    (tmp_path / "chat_template.jinja").write_text("F{{ bos_token }}")
    jax_tk, port_tk = _both(tmp_path)
    assert port_tk.chat_template == jax_tk.chat_template == \
        "F{{ bos_token }}"
    assert port_tk.apply_chat_template(msgs) == \
        jax_tk.apply_chat_template(msgs)


def test_unreadable_tokenizer_or_template_fails_the_load(tmp_path):
    from localai_tfp_tpu_torch.engine.tokenizer import load_tokenizer

    _save_tokenizer(tmp_path, False)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec["normalizer"] = {"type": "Lowercase"}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match="Lowercase"):
        load_tokenizer(str(tmp_path))
    _save_tokenizer(tmp_path, False, template="{% if x %}never closed")
    (tmp_path / "chat_template.jinja").write_text("{% if x %}never closed")
    from localai_tfp_tpu_torch.engine.jinja_lite import TemplateSyntaxError

    with pytest.raises(TemplateSyntaxError, match="endif"):
        load_tokenizer(str(tmp_path))
    (tmp_path / "tokenizer.json").unlink()
    with pytest.raises(NotImplementedError, match="tokenizer.json"):
        load_tokenizer(str(tmp_path))


# --------------------------------------------------------------- serving

GO_CHAT = {"chat_message": "{{.RoleName}}: {{.Content}}",
           "chat": "{{.Input}}\nassistant:"}
MODELS_YAML = {
    # no chat template in the config: the tokenizer's serves the chat
    "tok.yaml": """\
name: tok
backend: jax-llm
parameters:
  model: tiny-ckpt
  temperature: 0.0
  max_tokens: 8
context_size: 256
max_batch_slots: 16
dtype: float32
system_prompt: You answer briefly.
""",
    # Go templates in block scalars, the gallery's style
    "go.yaml": """\
# a gallery-style config: Go templates in block scalars
name: go
backend: jax-llm
parameters:
  model: tiny-ckpt
  temperature: 0.0
  max_tokens: 8
context_size: 256
max_batch_slots: 16
dtype: float32
template:
  chat_message: |-
    <|start_header_id|>{{.RoleName}}<|end_header_id|>

    {{.Content}}<|eot_id|>
  chat: >-
    {{.Input}}<|start_header_id|>assistant<|end_header_id|>
  completion: |
    Complete: {{.Input}}
  edit: |-
    {{.Instruction}}
    ---
    {{.Input}}
""",
    # post-processing: cutstrings and trimsuffix
    "ft.yaml": """\
name: ft
backend: jax-llm
parameters: {model: tiny-ckpt, temperature: 0.0, max_tokens: 8}
context_size: 256
max_batch_slots: 16
dtype: float32
cutstrings: ['[ae]', "\\\\s+$"]
trimsuffix:
  - zz
  - "."
template:
  chat_message: "{{.RoleName}}: {{.Content}}"
  chat: "{{.Input}}\\nassistant:"
""",
    # echo and trimspace: the stream takes the incremental path
    "ft2.yaml": """\
name: ft2
backend: jax-llm
parameters:
  model: tiny-ckpt
  temperature: 0.0
  max_tokens: 8
  echo: yes
context_size: 256
max_batch_slots: 16
dtype: float32
trimspace: [nosuchprefix]
template:
  use_tokenizer_template: true
""",
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    root = tmp_path_factory.mktemp("text_routes")
    models = root / "models"
    ckpt = models / "tiny-ckpt"
    ckpt.mkdir(parents=True)
    vocab = _save_tokenizer(ckpt, cleanup=True)
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512,
    )).save_pretrained(ckpt, safe_serialization=True)
    for name, text in MODELS_YAML.items():
        (models / name).write_text(text)
    return root


def _spy(backend, seen: list) -> None:
    """Record the prompt ids each request hands the engine."""
    orig = backend._to_request

    def to_request(opts):
        req = orig(opts)
        seen.append(list(req.prompt_ids))
        return req
    backend._to_request = to_request


@pytest.fixture(scope="module")
def jax_server(workdir):
    from aiohttp.test_utils import TestClient, TestServer

    from localai_tfp_tpu.config.app_config import ApplicationConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application

    loop = asyncio.new_event_loop()
    state = Application(ApplicationConfig(
        models_path=str(workdir / "models"),
        generated_content_dir=str(workdir / "generated"),
        upload_dir=str(workdir / "uploads"),
        config_dir=str(workdir / "configuration")))
    tc = TestClient(TestServer(build_app(state)), loop=loop)
    loop.run_until_complete(tc.start_server())  # reads the configs
    seen: dict[str, list] = {}
    for name in ("tok", "go", "ft", "ft2"):
        backend = state.model_loader.load(state.config_loader.get(name))
        seen[name] = []
        _spy(backend, seen[name])

    def call(path, body, headers=None):
        async def go():
            r = await tc.request("POST", path, json=body,
                                 headers=headers or {})
            return r.status, (await r.read()).decode()
        return loop.run_until_complete(go())

    yield call, seen
    loop.run_until_complete(tc.close())
    loop.close()


@pytest.fixture(scope="module")
def port_server(workdir):
    from localai_tfp_tpu_torch.server.app import build_server

    srv = build_server(str(workdir / "models"), port=0, device="cpu")
    seen: dict[str, list] = {}
    for name in ("tok", "go", "ft", "ft2"):
        backend = srv.app.model_loader.load(
            srv.app.config_loader.get(name))
        seen[name] = []
        _spy(backend, seen[name])
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def call(path, body, headers=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    yield call, seen
    srv.close()
    th.join(timeout=30)


def _stable(obj):
    """A response without its per-request id, clock and timings."""
    obj = dict(obj)
    obj.pop("id", None)
    obj.pop("created", None)
    if isinstance(obj.get("usage"), dict):
        obj["usage"] = {k: (None if k.startswith("timing_") else v)
                        for k, v in obj["usage"].items()}
    for c in obj.get("choices", []):
        for tc in (c.get("message") or {}).get("tool_calls") or []:
            tc.pop("id", None)
    return obj


def _sse(text: str) -> list:
    frames = text.split("\n\n")
    assert frames[-2:] == ["data: [DONE]", ""], frames[-3:]
    assert all(f.startswith("data: ") for f in frames[:-2])
    return [_stable(json.loads(f[len("data: "):])) for f in frames[:-2]]


def _streamed_text(chunks: list) -> str:
    out = []
    for c in chunks:
        ch = c["choices"][0]
        out.append(ch.get("text") or (ch.get("delta") or {}).get("content")
                   or "")
    return "".join(out)


def _same(jax_server, port_server, path, body, model, headers=None):
    """Both servers answer alike: status, body (streamed: the chunks'
    text and their final chunk) and the prompt ids their engines got."""
    jcall, jseen = jax_server
    pcall, pseen = port_server
    nj, np_ = len(jseen[model]), len(pseen[model])
    js, jbody = jcall(path, body, headers)
    ps, pbody = pcall(path, body, headers)
    assert js == ps == 200, (jbody, pbody)
    # concurrent choices reach the engine in either order
    assert sorted(pseen[model][np_:]) == sorted(jseen[model][nj:])
    assert pseen[model][np_:], "no request reached the engine"
    if body.get("stream"):
        jc, pc = _sse(jbody), _sse(pbody)
        assert _streamed_text(pc) == _streamed_text(jc)
        assert pc[-1] == jc[-1]
        return _streamed_text(pc), pc
    jo, po = _stable(json.loads(jbody)), _stable(json.loads(pbody))
    assert po == jo
    return po, pseen[model][np_:]


CHAT_BODIES = [
    {"messages": [{"role": "user", "content": "Hello, world!"}]},
    {"messages": [{"role": "system", "content": " Be terse. "},
                  {"role": "user", "content": "The cat sat?"},
                  {"role": "assistant", "content": "On the mat."},
                  {"role": "user", "content": "Why?"}], "max_tokens": 6},
    {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "parts "}, {"type": "text", "text": "join"}]}],
     "stop": ["e"]},
]


@pytest.mark.parametrize("model", ["tok", "go"])
@pytest.mark.parametrize("i", range(len(CHAT_BODIES)))
def test_chat_matches_jax_server(jax_server, port_server, model, i):
    body = {"model": model, "ignore_eos": True, **CHAT_BODIES[i]}
    whole, ids = _same(jax_server, port_server, "/v1/chat/completions",
                       body, model)
    text, chunks = _same(jax_server, port_server, "/v1/chat/completions",
                         {**body, "stream": True,
                          "stream_options": {"include_usage": True}},
                         model)
    assert text == whole["choices"][0]["message"]["content"]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant",
                                                "content": ""}
    if model == "tok":
        # the tokenizer's template with the config's system prompt; the
        # worker adds BOS before the template's own (a kept reference
        # quirk, ROADMAP §C)
        assert ids[0][:2] == [ids[0][0]] * 2


def test_chat_with_tools_matches_jax_server(jax_server, port_server):
    body = {"model": "tok", "max_tokens": 24, "messages": [
        {"role": "user", "content": "weather in Paris?"}],
        "tools": [{"type": "function", "function": {
            "name": "get_weather", "description": "weather of a city",
            "parameters": {"type": "object", "properties": {
                "city": {"type": "string"}}, "required": ["city"]}}}]}
    _same(jax_server, port_server, "/v1/chat/completions", body, "tok")


@pytest.mark.parametrize("model", ["tok", "go"])
def test_completions_match_jax_server(jax_server, port_server, model):
    one = {"model": model, "prompt": "The paged arena", "max_tokens": 6,
           "ignore_eos": True}
    whole, _ = _same(jax_server, port_server, "/v1/completions", one, model)
    assert whole["object"] == "text_completion"
    text, chunks = _same(jax_server, port_server, "/v1/completions",
                         {**one, "stream": True}, model,
                         headers={"Extra-Usage": "1"})
    assert text == whole["choices"][0]["text"]
    assert "timing_prompt_processing" in chunks[-1]["usage"]
    many = {**one, "prompt": ["Hello", "Über café"], "n": 2, "echo": True}
    whole, ids = _same(jax_server, port_server, "/v1/completions", many,
                       model)
    assert [c["index"] for c in whole["choices"]] == [0, 1, 2, 3]
    assert whole["choices"][2]["text"].startswith("Über café")
    _same(jax_server, port_server, f"/v1/engines/{model}/completions",
          {k: v for k, v in one.items() if k != "model"}, model)


def test_edits_and_tokenize_match_jax_server(jax_server, port_server):
    body = {"model": "go", "instruction": "Fix the spelling",
            "input": "teh cat", "max_tokens": 5, "ignore_eos": True}
    whole, ids = _same(jax_server, port_server, "/v1/edits", body, "go")
    assert whole["object"] == "edit" and len(whole["choices"]) == 1
    for content in ("Hello, world! It's 2024 <|eot_id|>", "", "🎉 中文"):
        tb = {"model": "tok", "content": content}
        js, jbody = jax_server[0]("/v1/tokenize", tb)
        ps, pbody = port_server[0]("/v1/tokenize", tb)
        assert js == ps == 200 and json.loads(pbody) == json.loads(jbody)


def test_finetune_fields_take_effect_in_both(jax_server, port_server):
    from localai_tfp_tpu_torch.grammars.parse import apply_finetune

    chat = {"messages": [{"role": "user", "content": "Hello, world!"}],
            "max_tokens": 8, "ignore_eos": True}
    base, _ = _same(jax_server, port_server, "/v1/chat/completions",
                    {"model": "go", **chat}, "go")
    # ft renders its own Go template; its raw reply is another text, so
    # the transform is checked on the ft server's own whole/streamed pair
    whole, _ = _same(jax_server, port_server, "/v1/chat/completions",
                     {"model": "ft", **chat}, "ft")
    text, _ = _same(jax_server, port_server, "/v1/chat/completions",
                    {"model": "ft", "stream": True, **chat}, "ft")
    content = whole["choices"][0]["message"]["content"]
    assert text == content
    assert not any(c in content for c in "ae")
    assert not content.endswith(("zz", "."))
    # echo prepends the templated prompt, in both modes
    whole, ids = _same(jax_server, port_server, "/v1/chat/completions",
                       {"model": "ft2", **chat}, "ft2")
    text, _ = _same(jax_server, port_server, "/v1/chat/completions",
                    {"model": "ft2", "stream": True, **chat}, "ft2")
    content = whole["choices"][0]["message"]["content"]
    assert text == content
    assert content.startswith("<|begin_of_text|><|start_header_id|>system")
    comp = {"model": "ft", "prompt": "abc", "max_tokens": 6,
            "ignore_eos": True}
    whole, _ = _same(jax_server, port_server, "/v1/completions", comp, "ft")
    text, _ = _same(jax_server, port_server, "/v1/completions",
                    {**comp, "stream": True}, "ft")
    assert text == whole["choices"][0]["text"]
    assert apply_finetune(whole["choices"][0]["text"],
                          cutstrings=["[ae]", r"\s+$"],
                          trimsuffix=["zz", "."]) == \
        whole["choices"][0]["text"]


def test_text_route_errors_match(jax_server, port_server):
    for path, body in (
            ("/v1/completions", {"model": "go", "prompt": 5}),
            ("/v1/completions", {"model": "go", "prompt": ["a", "b"],
                                 "stream": True}),
            ("/v1/completions", {"model": "go", "prompt": "a", "n": 17}),
            ("/v1/completions", {"model": "nope", "prompt": "a"}),
            ("/v1/edits", {"model": "go", "input": ["a", "b"]})):
        js, _ = jax_server[0](path, body)
        ps, pbody = port_server[0](path, body)
        assert ps == js and ps in (400, 404), (path, body, pbody)


def test_yaml_configs_read_as_pyyaml(workdir):
    import yaml

    from localai_tfp_tpu_torch.config.loader import load_config_file

    for name in MODELS_YAML:
        path = workdir / "models" / name
        (cfg,) = load_config_file(str(path))
        want = yaml.safe_load(path.read_text())
        assert cfg.name == want["name"]
        assert cfg.cutstrings == want.get("cutstrings", [])
        assert cfg.trimsuffix == want.get("trimsuffix", [])
        assert cfg.template.chat == (want.get("template") or {}).get(
            "chat", "")
        assert cfg.template.edit == (want.get("template") or {}).get(
            "edit", "")
        assert cfg.parameters.echo == bool(want["parameters"].get("echo"))


def test_unreadable_yaml_or_template_fails_with_the_reason(tmp_path, caplog):
    from localai_tfp_tpu_torch.server.app import build_server

    models = tmp_path / "models"
    models.mkdir()
    # a YAML the reader refuses is logged with the reason and skipped: the
    # server starts and serves the other configs, as the JAX server does
    (models / "bad.yaml").write_text("name: bad\nbackend: !custom llama\n")
    (models / "good.yaml").write_text("name: good\nbackend: jax-llm\n")
    with caplog.at_level("WARNING"):
        srv = build_server(str(models), device="cpu")
    srv.server_close()
    assert srv.app.config_loader.names() == ["good"]
    assert re.search(r"bad\.yaml:2: tags", caplog.text)
    (models / "good.yaml").unlink()
    (models / "bad.yaml").write_text(
        "name: bad\nbackend: jax-llm\ntemplate:\n  chat: '{% if x %}'\n"
        "  chat_message: m\n")
    srv = build_server(str(models), device="cpu")
    try:
        from localai_tfp_tpu_torch.engine.jinja_lite import TemplateError

        with pytest.raises(TemplateError, match="endif"):
            srv.app.evaluator.template_messages(
                srv.app.config_loader.get("bad"), [{"role": "user", "content": "x"}])
    finally:
        srv.server_close()
