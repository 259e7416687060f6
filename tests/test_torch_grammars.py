"""The port's grammar engine (localai_tfp_tpu_torch/grammars/: the GBNF
parser and matcher, the token constraints, JSON-schema and functions
grammars, function-call parsing, and the native C++ mask engine built
from csrc/gbnf_mask.cpp) against the JAX package's on the same inputs.

- GBNF parse and match agree on the grammars of tests/test_grammars.py.
- ``schema_to_gbnf`` / ``functions_grammar`` / ``llama31_functions_grammar``
  text is identical; ``parse_function_call`` results are equal.
- ``next_mask`` arrays of the port's Python engine, its native engine and
  the JAX package's are bitwise equal along seeded token walks, over the
  byte tokenizer and over a tiny BPE built in-process with ``tokenizers``.
- ``make_constraint`` serves through the native engine, falls back to the
  Python engine only for a grammar the native parser rejects, and raises
  when the native build is broken.
"""

import dataclasses
import json

import numpy as np
import pytest

from localai_tfp_tpu.config.model_config import FunctionsConfig as JaxFC
from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
from localai_tfp_tpu.grammars import constrain as jc
from localai_tfp_tpu.grammars import gbnf as jg
from localai_tfp_tpu.grammars import json_schema as js
from localai_tfp_tpu.grammars import parse as jp
from localai_tfp_tpu_torch.config.model_config import FunctionsConfig
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.grammars import constrain as tc
from localai_tfp_tpu_torch.grammars import gbnf as tg
from localai_tfp_tpu_torch.grammars import json_schema as ts
from localai_tfp_tpu_torch.grammars import native
from localai_tfp_tpu_torch.grammars import parse as tp

# (grammar, strings to match) from tests/test_grammars.py
GBNF_CASES = [
    ('root ::= "yes" | "no"', ["yes", "no", "maybe", "ye", ""]),
    ("root ::= [a-z]+", ["abc", "", "aB"]),
    ('root ::= "a" [0-9]* "b"', ["ab", "a123b", "a12"]),
    ("\nroot ::= expr\nexpr ::= term (\"+\" term)*\n"
     "term ::= [0-9]+ | \"(\" expr \")\"\n",
     ["1+2+33", "(1+(2+3))+4", "1+", "(1+2"]),
    (r'root ::= "\"" [^"]* "\""', ['"hello"', '"a"b"']),
    ("root ::= [0-9]{2,4}", ["1", "12", "1234", "12345"]),
    ('root ::= "-"? [0-9]+', ["-5", "5", "--5"]),
]
SCHEMAS = [
    {"type": "object",
     "properties": {"a": {"type": "integer"}, "b": {"type": "string"}},
     "required": ["a", "b"]},
    {"type": "object",
     "properties": {"a": {"type": "integer"}, "b": {"type": "integer"},
                    "c": {"type": "integer"}},
     "required": ["a"]},
    {"enum": ["red", "green", 3]},
    {"const": "fixed"},
    {"type": "array",
     "items": {"type": "object", "properties": {"x": {"type": "number"}},
               "required": ["x"]}},
    {"anyOf": [{"type": "integer"}, {"type": "null"}]},
    {"type": ["boolean", "integer"]},
    {"$defs": {"pt": {"type": "object",
                      "properties": {"x": {"type": "integer"}},
                      "required": ["x"]}},
     "type": "array", "items": {"$ref": "#/$defs/pt"}},
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"}},
     "required": ["name", "age"]},
    {},
    None,
]
DOCS = ['{"a": 1, "b": "x"}', '{"a": 1}', '{"a": "no", "b": "x"}',
        '{"a": 1, "c": 3}', '"red"', "3", '"blue"', '"fixed"', "[]",
        '[{"x": 1.5}, {"x": -2e3}]', '[{"y": 1}]', "42", "null", "true",
        '{"name": "Ann", "age": 30}', '{"k": [1, null, {"n": true}]}']
TOOLS = [
    {"name": "get_weather",
     "parameters": {"type": "object",
                    "properties": {"city": {"type": "string"}},
                    "required": ["city"]}},
    {"name": "add",
     "parameters": {"type": "object",
                    "properties": {"a": {"type": "integer"},
                                   "b": {"type": "integer"}},
                    "required": ["a", "b"]}},
]
FN_OPTS = [{}, {"parallel_calls": True}, {"prefix": "<tool_call>"},
           {"mixed_mode": True}, {"expect_strings_after_json": True},
           {"prop_order": ["arguments", "name"]},
           {"name_key": "function", "args_key": "params"}]
CALLS = [
    ('{"name": "add", "arguments": {"a": 1, "b": 2}}', {}),
    ('[{"name": "f1", "arguments": {}}, {"name": "f2", "arguments": '
     '{"x": 1}}]', {}),
    ('Sure! I will call {"name": "add", "arguments": {"a": 3, "b": 4}} now.',
     {}),
    ('<function=get_weather>{"city": "SF"}</function>', {}),
    ('{"function": "f", "params": {"k": "v"}}',
     {"function_name_key": "function", "function_arguments_key": "params"}),
    ('call:add({"a": 1})',
     {"response_regex": [r"call:(?P<name>\w+)\((?P<arguments>\{.*?\})\)"]}),
    ('<tool>{"name": "f", "arguments": {}}</tool>',
     {"json_regex_match": [r"<tool>(.*?)</tool>"]}),
    ("no call here at all", {}),
    ('{"name": "x", "arguments": "{\\"q\\": 1}"} tail',
     {"replace_llm_results": [{"key": "tail", "value": ""}]}),
]


def _matcher(mod, g):
    return mod.GrammarMatcher(mod.parse_gbnf(g))


def _rules(grammar):
    """A parsed grammar as plain data (symbols by class name and fields)."""
    return {name: [[(type(s).__name__, dataclasses.astuple(s)) for s in alt]
                   for alt in alts]
            for name, alts in grammar.rules.items()}


@pytest.mark.parametrize("i", range(len(GBNF_CASES)))
def test_gbnf_parse_and_match_agree_with_jax(i):
    g, strings = GBNF_CASES[i]
    assert _rules(tg.parse_gbnf(g)) == _rules(jg.parse_gbnf(g))
    ours, ref = _matcher(tg, g), _matcher(jg, g)
    for s in strings:
        assert ours.matches(s) == ref.matches(s), s


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_grammar_text_and_matches_agree_with_jax(i):
    g = ts.schema_to_gbnf(SCHEMAS[i])
    assert g == js.schema_to_gbnf(SCHEMAS[i])
    ours, ref = _matcher(tg, g), _matcher(jg, g)
    for doc in DOCS:
        assert ours.matches(doc) == ref.matches(doc), doc


@pytest.mark.parametrize("i", range(len(FN_OPTS)))
def test_functions_grammar_text_agrees_with_jax(i):
    kw = FN_OPTS[i]
    assert ts.functions_grammar(TOOLS, **kw) == js.functions_grammar(
        TOOLS, **kw)
    assert ts.llama31_functions_grammar(TOOLS) == \
        js.llama31_functions_grammar(TOOLS)


@pytest.mark.parametrize("i", range(len(CALLS)))
def test_parse_function_call_agrees_with_jax(i):
    text, cfg = CALLS[i]
    ours = tp.parse_function_call(text, FunctionsConfig(**cfg))
    ref = jp.parse_function_call(text, JaxFC(**cfg))
    assert [dataclasses.astuple(c) for c in ours] == \
        [dataclasses.astuple(c) for c in ref]
    cap = {"capture_llm_results": [r"(?s)^(.*?)<tool>"]}
    assert tp.parse_text_content(text + "<tool>", FunctionsConfig(**cap)) \
        == jp.parse_text_content(text + "<tool>", JaxFC(**cap))


# ---------------------------------------------------------------- masks


class _BPE:
    """A tiny byte-level BPE trained in-process (no files, no network),
    with the tokenizer surface the constraints read."""

    def __init__(self):
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers
        from tokenizers import trainers

        tk = Tokenizer(models.BPE())
        tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tk.decoder = decoders.ByteLevel()
        corpus = [json.dumps({"name": n, "arguments": {"a": i, "city": c}})
                  for i, (n, c) in enumerate(
                      [("add", "Paris"), ("get_weather", "SF"),
                       ("yes", "no")] * 20)]
        corpus += ["yes no maybe 12345 true false null [1, 2.5]"] * 10
        tk.train_from_iterator(corpus, trainers.BpeTrainer(
            vocab_size=400, special_tokens=["<eos>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        self._tk = tk
        self.vocab_size = tk.get_vocab_size()
        self.eos_ids = {tk.token_to_id("<eos>")}

    def decode(self, ids):
        return self._tk.decode(ids, skip_special_tokens=False)


def _tokenizers():
    out = [("bytes", ByteTokenizer(), JaxBytes())]
    try:
        bpe = _BPE()
    except ImportError:
        return out
    return out + [("bpe", bpe, bpe)]


WALK_GRAMMARS = [
    'root ::= "yes" | "no" | digits\ndigits ::= [0-9]+\n',
    ts.schema_to_gbnf(None),
    ts.schema_to_gbnf(SCHEMAS[8]),
    ts.functions_grammar(TOOLS),
    ts.functions_grammar(TOOLS, mixed_mode=True),
]


@pytest.mark.parametrize("gi", range(len(WALK_GRAMMARS)))
def test_masks_bitwise_equal_python_native_jax(gi):
    """Seeded walks: at each step the three masks are equal, then a random
    admissible token advances all three."""
    g = WALK_GRAMMARS[gi]
    for name, tok, jtok in _tokenizers():
        py = tc.GrammarConstraint.from_gbnf(g, tok)
        nat = native.NativeGrammarConstraint(g, tok)
        ref = jc.GrammarConstraint.from_gbnf(g, jtok)
        rng = np.random.default_rng(gi)
        for walk in range(3):
            sp, sn, sr = py.initial_state(), nat.initial_state(), \
                ref.initial_state()
            for step in range(40):
                mp, mn, mr = py.next_mask(sp), nat.next_mask(sn), \
                    ref.next_mask(sr)
                assert mp.dtype == mn.dtype == mr.dtype == np.bool_
                np.testing.assert_array_equal(
                    mp, mr, err_msg=f"{name} walk {walk} step {step}")
                np.testing.assert_array_equal(
                    mn, mr, err_msg=f"{name} walk {walk} step {step}")
                ok = np.nonzero(mr)[0]
                ok = [t for t in ok if t not in tok.eos_ids]
                if not ok:
                    break
                t = int(rng.choice(ok))
                sp, sn, sr = py.advance(sp, t), nat.advance(sn, t), \
                    ref.advance(sr, t)


def test_lazy_constraint_masks_agree_with_jax():
    g = ts.functions_grammar(TOOLS)
    tok, jtok = ByteTokenizer(), JaxBytes()
    ours = tc.LazyGrammarConstraint(native.NativeGrammarConstraint(g, tok),
                                    ["<tool>"], tok)
    ref = jc.LazyGrammarConstraint(jc.GrammarConstraint.from_gbnf(g, jtok),
                                   ["<tool>"], jtok)
    so, sr = ours.initial_state(), ref.initial_state()
    text = 'hm <tool>{"name": "add", "arguments": {"a": 1, "b": 2}}'
    for ch in text.encode():
        np.testing.assert_array_equal(ours.next_mask(so), ref.next_mask(sr))
        so, sr = ours.advance(so, ch), ref.advance(sr, ch)
    np.testing.assert_array_equal(ours.next_mask(so), ref.next_mask(sr))


def test_make_constraint_uses_native_and_raises_on_a_broken_build(
        monkeypatch, tmp_path):
    g = 'root ::= "yes" | "no"'
    tok = ByteTokenizer()
    assert isinstance(native.make_constraint(g, tok),
                      native.NativeGrammarConstraint)
    # a grammar the native parser rejects falls back to Python
    with monkeypatch.context() as m:
        def reject(*a):
            raise ValueError("gbnf parse error")
        m.setattr(native, "NativeGrammarConstraint", reject)
        assert isinstance(native.make_constraint(g, tok),
                          tc.GrammarConstraint)
    broken = tmp_path / "gbnf_mask.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native grammar build failed"):
        native.make_constraint(g, tok)
    monkeypatch.setattr(native, "SRC", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="source missing"):
        native.make_constraint(g, tok)
