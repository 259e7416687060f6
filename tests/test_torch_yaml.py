"""The port's YAML reader (localai_tfp_tpu_torch/config/yaml_lite.py)
against PyYAML's ``safe_load_all``, and the config loader built on it
(localai_tfp_tpu_torch/config/loader.py) against the JAX ConfigLoader.

- Every YAML text embedded in the JAX package's tests, copied here (the
  LocalAI-style configs of tests/test_config.py, tests/test_server.py and
  tests/test_ui.py), and gallery-style configs that carry the Go templates
  of tests/test_templating.py (``LLAMA3_GO``, ``CHATML_GO``) in block
  scalars of every chomping and indentation form.
- A hypothesis round trip: ``yaml_lite`` reads back what
  ``yaml.safe_dump`` writes of nested config-like objects, block and flow
  style, as ``yaml.safe_load`` does (fixed ``derandomize`` profile).
- The YAML 1.1 resolver cases (yes/no/on/off, ``1e-5`` a string, octal,
  hex, ``~``, dates) and each construct the reader refuses (tags, complex
  keys, directives, tabs, unknown aliases), which must raise with the
  file and line.
"""

import datetime
import json
import math
import textwrap

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

yaml = pytest.importorskip("yaml")

from localai_tfp_tpu_torch.config import yaml_lite  # noqa: E402

# tests/test_templating.py
CHATML_GO = """<|im_start|>{{if eq .RoleName "assistant"}}assistant\
{{else if eq .RoleName "system"}}system{{else if eq .RoleName "tool"}}tool\
{{else if eq .RoleName "user"}}user{{end}}
{{- if .FunctionCall }}
<tool_call>
{{- else if eq .RoleName "tool" }}
<tool_response>
{{- end }}
{{- if .Content}}
{{.Content }}
{{- end }}
{{- if .FunctionCall}}
{{toJson .FunctionCall}}
{{- end }}
{{- if .FunctionCall }}
</tool_call>
{{- else if eq .RoleName "tool" }}
</tool_response>
{{- end }}<|im_end|>"""

LLAMA3_GO = """<|start_header_id|>{{if eq .RoleName "assistant"}}assistant\
{{else if eq .RoleName "system"}}system{{else if eq .RoleName "tool"}}tool\
{{else if eq .RoleName "user"}}user{{end}}<|end_header_id|>

{{ if .FunctionCall -}}
Function call:
{{ else if eq .RoleName "tool" -}}
Function response:
{{ end -}}
{{ if .Content -}}
{{.Content -}}
{{ else if .FunctionCall -}}
{{ toJson .FunctionCall -}}
{{ end -}}
<|eot_id|>"""


def _block(text: str, indent: int) -> str:
    pad = " " * indent
    return "\n".join(pad + line if line else "" for line in
                     text.split("\n"))


# the YAML texts of the JAX package's tests, copied
JAX_TEST_TEXTS = [
    # tests/test_config.py::test_reference_yaml_compat
    textwrap.dedent("""
        name: gpt-4
        backend: llama
        parameters:
          model: testmodel.ggml
          temperature: 0.2
          top_p: 0.8
        context_size: 2048
        stopwords: ["<|im_end|>"]
        gpu_layers: 99      # CUDA-only knob: accepted, ignored
        mmap: true
        template:
          chat: chat_tmpl
        """),
    # tests/test_config.py::test_multidoc_yaml
    "name: a\n---\nname: b\n",
    # tests/test_server.py (the tiny, tinyft and tinyft2 models)
    """
name: tiny
backend: jax-llm
parameters:
  model: tiny-ckpt
  temperature: 0.0
  max_tokens: 8
context_size: 128
max_batch_slots: 2
dtype: float32
template:
  completion: "{{.Input}}"
  chat_message: "{{.RoleName}}: {{.Content}}"
  chat: "{{.Input}}\\nassistant:"
""",
    """
name: tinyft
backend: jax-llm
parameters:
  model: tiny-ckpt
  temperature: 0.0
  max_tokens: 8
context_size: 128
max_batch_slots: 2
dtype: float32
cutstrings: ["[ae]"]
trimsuffix: ["zz"]
template:
  completion: "{{.Input}}"
  chat_message: "{{.RoleName}}: {{.Content}}"
  chat: "{{.Input}}\\nassistant:"
""",
    """
name: tinyft2
backend: jax-llm
parameters:
  model: tiny-ckpt
  temperature: 0.0
  max_tokens: 8
  echo: true
context_size: 128
max_batch_slots: 2
dtype: float32
trimspace: ["nosuchprefix"]
template:
  completion: "{{.Input}}"
  chat_message: "{{.RoleName}}: {{.Content}}"
  chat: "{{.Input}}\\nassistant:"
""",
    # tests/test_ui.py
    "name: voice\nbackend: jax-tts\n",
]

# gallery-style configs: the Go templates above in block scalars
GALLERY_TEXTS = [
    f"""---
name: llama3-8b-instruct
backend: llama-cpp
context_size: 8192
f16: true
stopwords:
- <|im_end|>
- <dummy32000>
- "<|eot_id|>"
- <|end_of_text|>
parameters:
  model: Meta-Llama-3-8B-Instruct.Q4_K_M.gguf
  temperature: 0.7
  top_k: 40
  top_p: 0.9
template:
  chat_message: |
{_block(LLAMA3_GO, 4)}
  chat: |
    {{{{.Input }}}}
    <|start_header_id|>assistant<|end_header_id|>
  completion: |
    {{{{.Input}}}}
  function: |-
    <|start_header_id|>system<|end_header_id|>

    You have access to the following functions:
    {{{{range .Functions}}}}
    Use the function '{{{{.Name}}}}' to '{{{{.Description}}}}'
    {{{{toJson .Parameters}}}}
    {{{{end}}}}<|eot_id|>{{{{.Input}}}}
function:
  disable_no_action: true
  grammar:
    disable: true
  response_regex:
  - \\w+\\s*\\(\\)
""",
    f"""# a ChatML model in every block-scalar form
name: hermes
backend: llama-cpp
parameters: {{model: hermes.gguf, temperature: 0.2, seed: -1}}
roles: {{user: "user", assistant: assistant, system: 'system'}}
template:
  chat_message: |+
{_block(CHATML_GO, 4)}

  chat: >-
    {{{{.Input}}}}
    <|im_start|>assistant
  folded: >
    one
    two

    three
      indented
    back
  indented: |2
      two more spaces
    base
  stripped: |-
    no trailing newline
  kept: |+
    trailing newlines


...
---
- name: a
  backend: llama
- name: b
  parameters:
    model: b.gguf
""",
    """base: &base
  backend: llama-cpp
  context_size: 4096
  parameters: &params
    temperature: 0.2
    top_p: 0.9
---
name: merged
<<: {backend: vllm, f16: yes}
parameters:
  model: x
""",
    """defaults: &d {backend: llama, mmap: on, threads: 4}
models:
  - <<: *d
    name: one
    parameters: {model: one.gguf}
  - <<: [*d, {threads: 8, gpu_layers: 0x10}]
    name: two
    context_size: 017
  - name: three
    options: ["a:b", 'it''s', "tab\\tand \\u00e9"]
    alias: *d
""",
    """# flow and quoted forms, over several lines
name: "flow \\"quoted\\" name"
stopwords: ['</s>', "<|im_end|>",
            plain words, 'multi
  line']
roles: {
  user: "User:",
  assistant: Assistant,
}
description: plain text
  continued on the next line

  and after a blank one
url: http://example.com:8080/path#frag
comment: value # a comment
hash: value#not-a-comment
empty:
tilde: ~
nulls: [null, Null, NULL, ~, ]
""",
]

RESOLVER_CASES = {
    "bools": "a: yes\nb: No\nc: ON\nd: off\ne: true\nf: False\ng: y\nh: n\n",
    "floats": "a: 1e-5\nb: 1.0e-5\nc: 1.5\nd: .5\ne: -.inf\nf: .NaN\n"
              "g: 6.8523015e+5\nh: 1_000.5\ni: 190:20:30.15\nj: 1e5\n",
    "ints": "a: 0x1F\nb: 017\nc: 0b101\nd: -12\ne: 1_000\nf: 190:20:30\n"
            "g: 0\nh: +7\ni: 0o17\nj: 08\n",
    "nulls": "a: ~\nb:\nc: null\nd: ''\ne: \"\"\n",
    "dates": "a: 2001-12-14\nb: 2002-12-14 21:59:43.10 -5\n"
             "c: 2001-12-14t21:59:43.10-05:00\nd: 2001-12-14T21:59:43Z\n",
    "strings": "a: '1e-5'\nb: \"yes\"\nc: 1.2.3\nd: 12:30\ne: -x\n"
               "f: '#not a comment'\ng: x:y\n",
}

REFUSED = {
    "tag": ("a: 1\nb: !!binary aGk=\n", 2, "tags"),
    "local tag": ("a: !custom x\n", 1, "tags"),
    "complex key": ("? a\n: b\n", 1, "complex"),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1, "directives"),
    "tab indent": ("a:\n\t- 1\n", 2, "tab"),
    "tab value": ("a:\tb\n", 1, "tab"),
    "unknown alias": ("a: *nope\n", 1, "alias"),
    "anchored key": ("- &x b: 1\n", 1, "mapping values"),
    "nested value": ("a: b: c\n", 1, "mapping values"),
    "bad indent": ("a:\n  b: 1\n   c: 2\n", 3, "mapping values"),
    "bad dedent": ("a:\n    b: 1\n  c: 2\n", 3, "indentation"),
    "flow pair": ("[a: b]\n", 1, "single-pair"),
    "unterminated": ("a: 'open\n", 2, "unterminated"),
    "value key": ("a: =\n", 1, "'='"),
    "nel": ("a: x\x85y\n", 1, "unacceptable"),
}


def _equal(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def _check(text: str) -> list:
    want = list(yaml.safe_load_all(text))
    got = yaml_lite.load_all(text, "t.yaml")
    assert _equal(got, want), (text, got, want)
    return got


@pytest.mark.parametrize("i", range(len(JAX_TEST_TEXTS)))
def test_jax_test_texts_read_as_pyyaml(i):
    _check(JAX_TEST_TEXTS[i])


@pytest.mark.parametrize("i", range(len(GALLERY_TEXTS)))
def test_gallery_configs_read_as_pyyaml(i):
    docs = _check(GALLERY_TEXTS[i])
    assert docs


def test_go_templates_survive_block_scalars():
    (doc,) = _check(GALLERY_TEXTS[0])
    assert doc["template"]["chat_message"] == LLAMA3_GO + "\n"
    docs = _check(GALLERY_TEXTS[1])
    assert docs[0]["template"]["chat_message"] == CHATML_GO + "\n\n"


@pytest.mark.parametrize("name", sorted(RESOLVER_CASES))
def test_yaml_11_resolver(name):
    (doc,) = _check(RESOLVER_CASES[name])
    if name == "floats":
        assert doc["a"] == "1e-5" and doc["b"] == 1e-5 and doc["j"] == "1e5"
    if name == "ints":
        assert doc["a"] == 31 and doc["b"] == 15 and doc["i"] == "0o17"
    if name == "bools":
        assert doc["a"] is True and doc["d"] is False and doc["g"] == "y"
    if name == "dates":
        assert doc["a"] == datetime.date(2001, 12, 14)


TAGGED = {
    "str": "a: !!str 5\nb: !!str yes\nc: !!str\nd: !!str 'q'\n",
    "int": "a: !!int '0x1F'\nb: !!int \"12\"\nc: !!int 1_000\n",
    "float": "a: !!float 1\nb: !!float 1e5\nc: !!float .inf\n",
    "bool": "a: !!bool Yes\nb: !!bool off\nc: !!bool 'TRUE'\n",
    "null": "a: !!null x\nb: !!null\nc: !!null ''\n",
    "block": "a: !!str |\n  two\n  lines\nb: !!str >-\n  folded\n  text\n",
    "flow": "a: [!!str 1, !!int \"2\", !!float 3]\nb: {k: !!str on}\n",
    "sequence": "- !!str on\n- !!bool off\n- !!null ~\n",
    "model": "name: tagged\nparameters: {model: !!str tagged}\n",
}


@pytest.mark.parametrize("name", sorted(TAGGED))
def test_standard_scalar_tags_read_as_pyyaml(name):
    _check(TAGGED[name])


@pytest.mark.parametrize("text", ["a: !!int abc\n", "a: !!bool maybe\n",
                                  "a: !!str [1]\n", "a: !!str\n  b: 1\n"])
def test_tags_pyyaml_refuses_are_refused(text):
    with pytest.raises(Exception):
        list(yaml.safe_load_all(text))
    with pytest.raises(ValueError, match="t.yaml:1: "):
        yaml_lite.load_all(text, "t.yaml")


def test_both_servers_start_on_a_directory_with_a_refused_file(tmp_path):
    """C11: ``good.yaml``, ``tagged.yaml`` (``!!str``) and a file both
    readers refuse (a local tag): both servers start, skip the refused
    file and list the same models."""
    from tests.test_torch_retrieval import Pair

    models = tmp_path / "models"
    models.mkdir()
    (models / "good.yaml").write_text("name: good\nparameters: {model: good}\n")
    (models / "tagged.yaml").write_text(
        "name: tagged\nparameters: {model: !!str tagged}\n")
    (models / "refused.yaml").write_text(
        "name: refused\nparameters: {model: !custom refused}\n")
    p = Pair(tmp_path / "srv", models)
    try:
        assert p.jstate.config_loader.names() == \
            p.app.config_loader.names() == ["good", "tagged"]
        assert p.app.config_loader.get("tagged").model == "tagged"
    finally:
        p.close()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unread_constructs_raise_with_file_and_line(name):
    text, line, what = REFUSED[name]
    with pytest.raises(ValueError, match=f"t.yaml:{line}: .*{what}"):
        yaml_lite.load_all(text, "t.yaml")


def test_json_configs_still_read():
    cfg = {"name": "x", "parameters": {"model": "ckpt", "max_tokens": 32,
                                       "temperature": 0.0},
           "template": {"chat": "{{.Input}}\nassistant:"},
           "stopwords": ["</s>", "\u00e9"], "f16": True, "n": None}
    for text in (json.dumps(cfg), json.dumps(cfg, indent=1),
                 json.dumps(cfg, ensure_ascii=False)):
        assert _check(text) == [cfg]


_KEY = st.text(alphabet=st.characters(
    min_codepoint=32, max_codepoint=0x2FFF,
    blacklist_categories=("Cs", "Zl", "Zp", "Cc"),
    blacklist_characters="\x85"), min_size=1, max_size=10)
_TEXT = st.text(alphabet=st.characters(
    blacklist_categories=("Cs",),
    blacklist_characters="\x85\u2028\u2029"), max_size=40)
_SCALAR = st.one_of(
    st.none(), st.booleans(), st.integers(-10**9, 10**9),
    st.floats(allow_nan=False, width=32), _TEXT,
    st.sampled_from(["yes", "off", "1e-5", "0x1F", "017", "~", "", " x ",
                     "a: b", "- x", "#x", "x #y", "{{.Input}}\n",
                     "<|im_end|>", "line\n\nbreaks\n", "\ttab", "'q'",
                     "2001-12-14", "é 中文 🎉"]))
_OBJ = st.recursive(_SCALAR, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_KEY, inner, max_size=5)),
    max_leaves=16)


@settings(derandomize=True, max_examples=400, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(_OBJ, st.sampled_from([False, True, None]), st.sampled_from([80, 24]))
def test_safe_dump_round_trip(obj, flow, width):
    text = yaml.safe_dump(obj, default_flow_style=flow, width=width,
                          allow_unicode=True)
    _check(text)


def test_loader_reads_multidoc_lists_and_skips_dotfiles(tmp_path):
    from localai_tfp_tpu.config.loader import ConfigLoader

    from localai_tfp_tpu_torch.config.loader import load_configs_from_path

    (tmp_path / "a.yaml").write_text(GALLERY_TEXTS[1])
    (tmp_path / "b.yml").write_text(JAX_TEST_TEXTS[0])
    (tmp_path / ".hidden.yaml").write_text("name: hidden\n")
    (tmp_path / "notes.txt").write_text("name: nope\n")
    jax = ConfigLoader(tmp_path)
    jax.load_configs_from_path()
    port = load_configs_from_path(str(tmp_path))
    assert sorted(port) == jax.names() == ["a", "b", "gpt-4", "hermes"]
    for name in port:
        want, got = jax.get(name), port[name]
        assert got.model == want.model
        assert got.parameters.temperature == want.parameters.temperature
        assert got.template.chat == want.template.chat
        assert got.template.chat_message == want.template.chat_message
        assert got.stopwords == want.stopwords


def test_loader_validates_every_document_before_any(tmp_path):
    from localai_tfp_tpu_torch.config.loader import (load_config_file,
                                                     load_configs_from_path)

    (tmp_path / "m.yaml").write_text(
        "name: ok\n---\nparameters: {model: ../escape}\n")
    with pytest.raises(ValueError, match=r"m\.yaml: invalid model config"):
        load_config_file(str(tmp_path / "m.yaml"))
    # the server's scan logs the file and skips it whole, as the JAX
    # loader does
    from localai_tfp_tpu.config.loader import ConfigLoader

    jax = ConfigLoader(tmp_path)
    assert jax.load_configs_from_path() == 0
    assert load_configs_from_path(str(tmp_path)) == {}
    (tmp_path / "m.yaml").write_text("backend: llama\n")
    with pytest.raises(ValueError, match="neither 'name' nor 'model'"):
        load_config_file(str(tmp_path / "m.yaml"))


def test_model_config_reads_the_finetune_and_text_fields():
    from localai_tfp_tpu.config.model_config import ModelConfig as JaxConfig

    from localai_tfp_tpu_torch.config.model_config import ModelConfig

    (doc,) = yaml.safe_load_all(JAX_TEST_TEXTS[4])
    doc = {**doc, "cutstrings": ["x"], "extract_regex": ["y+"],
           "trimsuffix": ["z"],
           "template": {**doc["template"], "edit": "{{.Instruction}}"}}
    want, got = JaxConfig.from_dict(dict(doc)), ModelConfig.from_dict(doc)
    for field in ("cutstrings", "extract_regex", "trimspace", "trimsuffix"):
        assert getattr(got, field) == getattr(want, field)
    assert got.parameters.echo is want.parameters.echo is True
    assert got.template.completion == want.template.completion
    assert got.template.edit == want.template.edit
    assert ModelConfig.from_dict({"name": "d"}).parameters.echo is False
