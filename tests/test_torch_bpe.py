"""The port's ``tokenizer.json`` reader (localai_tfp_tpu_torch/engine/bpe.py)
against the ``tokenizers`` package on the same files.

One small tokenizer of each family the port serves is built here with
``tokenizers`` (trained on a corpus in this file, then saved): Llama-3
(``Split`` + ``ByteLevel``, ``ignore_merges``, special and stripped added
tokens), Qwen2 (``NFC``), GPT-2 (``ByteLevel(use_regex)``), Mistral
(``Prepend``/``Replace`` normalizer, ``byte_fallback``), a Metaspace
variant and an ``unk``/``fuse_unk`` one. Each is held to ``tokenizers``
exactly: equal ids from ``encode`` and equal text from ``decode`` over a
multilingual corpus (``\\x1c-\\x1f``, combining marks, CJK, emoji,
contractions in capitals), hypothesis text and seeded random ids. The
same holds on the 128256-id file ``chip_smoke.py`` writes for its text
phase. A component the reader does not read raises at load.
"""

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import AddedToken, Regex, Tokenizer  # noqa: E402
from tokenizers import decoders, normalizers, pre_tokenizers  # noqa: E402
from tokenizers.models import BPE  # noqa: E402
from tokenizers.trainers import BpeTrainer  # noqa: E402

from localai_tfp_tpu_torch.engine.bpe import BPETokenizer  # noqa: E402

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|"
                r"\s+")
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
               r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CORPUS = [
    "Hello, world! It's a test. Don't do that? I'LL say 'S and 'Re too.",
    "WE'RE HERE, THEY'VE GONE, I'M FINE, SHE'D GO, IT'S 'LL 'M 'D 'T",
    "Über naïve café résumé — “quotes” ‘single’ …",
    "Café with a combining accent, ë and ạ̊.",
    "中文测试：你好，世界。日本語のテキスト、カタカナ。한국어 문장입니다.",
    "Emoji: 🎉🚀👩‍👩‍👧‍👦 🇫🇷 ❤️ and 🙂🙃.",
    "Separators \x1c\x1d\x1e\x1f between\x1cwords\x1f here.",
    "Numbers 1234567 3.14159 1,000,000 and ٣٤٥ and ⅧⅨ ½.",
    "Tabs\tand\nnewlines\r\n\n\nand   many    spaces   \n  x",
    "code: def f(x):\n    return x ** 2  # square\n\n\tprint(f(3))",
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nHi<|eot_id|>",
    "a <tool> b  <tool>  c xyz wxyz xyz_ xyz.",
    "ſ 'ſ 'Ｓ Kelvin K ǅ ß ẞ İstanbul ı.",
    "   leading and trailing   ",
    " nbsp thin　ideographic​zero-width ls",
    "",
    " ",
    "\n",
    "'s",
    "abc xabc abcabc ab c bc",
    "x" * 300,
]


def _train(normalizer, pre_tokenizer, vocab_size: int, alphabet=None):
    tk = Tokenizer(BPE())
    if normalizer is not None:
        tk.normalizer = normalizer
    if pre_tokenizer is not None:
        tk.pre_tokenizer = pre_tokenizer
    trainer = BpeTrainer(vocab_size=vocab_size, show_progress=False,
                         initial_alphabet=alphabet or [])
    tk.train_from_iterator(CORPUS * 3, trainer=trainer)
    spec = json.loads(tk.to_str())["model"]
    return spec["vocab"], [tuple(m) if isinstance(m, list)
                           else tuple(m.split(" ")) for m in spec["merges"]]


def _byte_level_family(name: str, split: str, normalizer, ignore_merges):
    pre = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(split), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    vocab, merges = _train(normalizer, pre, 700,
                           pre_tokenizers.ByteLevel.alphabet())
    tk = Tokenizer(BPE(vocab=vocab, merges=merges,
                       ignore_merges=ignore_merges))
    if normalizer is not None:
        tk.normalizer = normalizer
    tk.pre_tokenizer = pre
    tk.decoder = decoders.ByteLevel()
    tk.add_special_tokens(["<|begin_of_text|>", "<|start_header_id|>",
                           "<|end_header_id|>", "<|eot_id|>"])
    tk.add_tokens([AddedToken("<tool>", lstrip=True, rstrip=True),
                   AddedToken("xyz", single_word=True, normalized=True),
                   AddedToken("Kelvin", normalized=False)])
    return tk


def _gpt2(prefix: bool):
    pre = pre_tokenizers.ByteLevel(add_prefix_space=prefix, use_regex=True)
    vocab, merges = _train(None, pre, 600, pre_tokenizers.ByteLevel.alphabet())
    tk = Tokenizer(BPE(vocab=vocab, merges=merges))
    tk.pre_tokenizer = pre
    tk.decoder = decoders.ByteLevel()
    tk.add_special_tokens(["<|endoftext|>"])
    return tk


def _sentencepiece(kind: str):
    """Mistral-style: byte fallback (or an unk that fuses), ▁ for space."""
    if kind == "metaspace":
        norm = None
        pre = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first",
                                       split=False)
    else:
        norm = normalizers.Sequence([normalizers.Prepend("▁"),
                                     normalizers.Replace(" ", "▁")])
        pre = None
    vocab, merges = _train(norm, pre, 500)
    vocab = dict(vocab)
    for tok in ["<unk>", "<s>", "</s>"] + (
            [f"<0x{b:02X}>" for b in range(256)] if kind != "unk" else []):
        vocab.setdefault(tok, len(vocab))
    if kind == "unk":  # drop a few characters so they are unknown
        for ch in "中文测试🎉":
            vocab.pop(ch, None)
        vocab = {t: i for i, t in enumerate(vocab)}
        merges = [(a, b) for a, b in merges
                  if a in vocab and b in vocab and a + b in vocab]
    tk = Tokenizer(BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                       byte_fallback=kind != "unk", fuse_unk=True))
    if norm is not None:
        tk.normalizer = norm
    if kind == "metaspace":
        tk.pre_tokenizer = pre
        tk.decoder = decoders.Metaspace(replacement="▁",
                                        prepend_scheme="first", split=False)
    else:
        tk.decoder = decoders.Sequence([
            decoders.Replace("▁", " "), decoders.ByteFallback(),
            decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tk.add_special_tokens(["<s>", "</s>", "[INST]", "[/INST]"])
    return tk


def _crafted_ignore_merges():
    """A vocabulary where merging and ``ignore_merges`` disagree: merging
    "abc" gives "ab" + "c" (there is no ("ab", "c") merge), while "abc"
    is whole in the vocabulary."""
    alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    vocab = {c: i for i, c in enumerate(alphabet)}
    for t in ("ab", "bc", "abc", "Ġabc"):
        vocab[t] = len(vocab)
    tk = Tokenizer(BPE(vocab=vocab, merges=[("a", "b"), ("b", "c"),
                                            ("a", "bc"), ("Ġ", "abc")],
                       ignore_merges=True))
    tk.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tk.decoder = decoders.ByteLevel()
    return tk


FAMILIES = {
    "llama3": lambda: _byte_level_family("llama3", LLAMA3_SPLIT, None, True),
    "ignore_merges": _crafted_ignore_merges,
    "qwen2": lambda: _byte_level_family("qwen2", QWEN2_SPLIT,
                                        normalizers.NFC(), False),
    "gpt2": lambda: _gpt2(False),
    "gpt2_prefix": lambda: _gpt2(True),
    "mistral": lambda: _sentencepiece("byte_fallback"),
    "mistral_metaspace": lambda: _sentencepiece("metaspace"),
    "unk_fused": lambda: _sentencepiece("unk"),
}


@pytest.fixture(scope="module")
def family_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("bpe")
    out = {}
    for name, build in FAMILIES.items():
        path = root / f"{name}.json"
        build().save(str(path))
        out[name] = path
    return out


def _pair(path):
    return Tokenizer.from_file(str(path)), BPETokenizer(str(path))


def _check(ref, port, text: str) -> list:
    want = ref.encode(text, add_special_tokens=False).ids
    got = port.encode(text)
    assert got == want, (text, got, want)
    assert port.decode(got) == ref.decode(want, skip_special_tokens=False)
    assert port.decode(got, skip_special_tokens=True) == \
        ref.decode(want, skip_special_tokens=True)
    return want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_corpus_ids_and_text_match_tokenizers(family_files, family):
    ref, port = _pair(family_files[family])
    assert port.vocab_size == ref.get_vocab_size(with_added_tokens=True)
    for text in CORPUS + [" ".join(CORPUS), "\n".join(CORPUS)]:
        _check(ref, port, text)
    for tok in ("<|eot_id|>", "<s>", "[INST]", "<tool>", "Ġ", "nope"):
        assert port.token_to_id(tok) == ref.token_to_id(tok)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_random_ids_decode_as_tokenizers(family_files, family):
    ref, port = _pair(family_files[family])
    rng = np.random.default_rng(0)
    n = ref.get_vocab_size(with_added_tokens=True)
    for _ in range(200):
        ids = rng.integers(0, n + 3, size=int(rng.integers(1, 12))).tolist()
        assert port.decode(ids) == ref.decode(ids, skip_special_tokens=False)
        assert port.decode(ids, skip_special_tokens=True) == \
            ref.decode(ids, skip_special_tokens=True)


_TEXT = st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
                max_size=60)


@pytest.mark.parametrize("family", ["llama3", "qwen2", "gpt2", "mistral",
                                    "mistral_metaspace"])
def test_hypothesis_text_matches_tokenizers(family_files, family):
    ref, port = _pair(family_files[family])

    @settings(derandomize=True, max_examples=150, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(_TEXT)
    def run(text):
        _check(ref, port, text)
    run()


def _pieces_agree(ref, port, text: str) -> None:
    from localai_tfp_tpu_torch.engine.bpe import _Piece

    norm = ref.normalizer.normalize_str(text) if ref.normalizer else text
    want = [p for p, _ in ref.pre_tokenizer.pre_tokenize_str(norm)]
    got = [p.text for p in port.pre_tokenize([_Piece(norm, True)])]
    assert got == want, (text, got, want)


@pytest.mark.parametrize("family", ["llama3", "qwen2", "gpt2", "gpt2_prefix",
                                    "mistral_metaspace"])
def test_pre_tokenizer_pieces_match_tokenizers(family_files, family):
    """The pieces the model sees, split for split: every character on
    which Python's ``\\s``, ``str.isspace`` and Unicode's White_Space
    disagree, and the corpus."""
    import re

    ref, port = _pair(family_files[family])
    odd = [chr(c) for c in range(0x3100)
           if bool(re.match(r"\s", chr(c))) or chr(c).isspace()]
    for c in odd:
        _pieces_agree(ref, port, f"a{c}b {c}{c}c\n{c} {c}'S{c}")
    for text in CORPUS:
        _pieces_agree(ref, port, text)

    @settings(derandomize=True, max_examples=100, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(_TEXT)
    def run(text):
        _pieces_agree(ref, port, text)
    run()


def test_chip_smoke_tokenizer_matches_tokenizers(tmp_path):
    """The 128256-id Llama-3-layout file chip_smoke.py writes."""
    import chip_smoke

    info = chip_smoke.write_text_tokenizer(tmp_path)
    assert info["vocab"] == 128256
    ref, port = _pair(tmp_path / "tokenizer.json")
    assert port.vocab_size == ref.get_vocab_size(with_added_tokens=True) \
        == 128256
    assert port.token_to_id("<|begin_of_text|>") == 128000
    assert port.token_to_id("<|eot_id|>") == 128009
    for text in CORPUS:
        _check(ref, port, text)
    rng = np.random.default_rng(1)
    for _ in range(50):
        ids = rng.integers(0, 128256, size=16).tolist()
        assert port.decode(ids) == ref.decode(ids, skip_special_tokens=False)


@pytest.mark.parametrize("component", [
    ("normalizer", {"type": "Lowercase"}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": "a"},
                       "behavior": "Removed", "invert": False}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"},
                       "behavior": "Isolated", "invert": False}),
    # WordPiece is read since the encoders came (engine/wordpiece.py)
    ("decoder", {"type": "CTC", "pad_token": "<pad>",
                 "word_delimiter_token": "|", "cleanup": True}),
    ("model", {"type": "WordLevel", "vocab": {"a": 0}, "unk_token": "a"}),
])
def test_unsupported_component_raises_naming_it(family_files, tmp_path,
                                                component):
    key, value = component
    spec = json.loads(family_files["llama3"].read_text())
    spec[key] = value
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match=str(path)):
        BPETokenizer(str(path))
