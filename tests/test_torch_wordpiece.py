"""The port's WordPiece path (engine/wordpiece.py behind engine/bpe.py
and engine/tokenizer.py::HFTokenizer) against the JAX package's
``HFTokenizer``, which loads the same directory through transformers'
``AutoTokenizer``.

The ``tokenizer.json`` files are trained here by the ``tokenizers``
package, offline: a ``BertNormalizer`` (lowercase on and off, accents
stripped or not), the ``BertPreTokenizer``, a ``WordPiece`` model and
decoder, and a ``TemplateProcessing`` or ``BertProcessing``
post-processor; one variant carries a ``truncation`` block (6 tokens),
which transformers ignores when ``encode`` asks for no truncation, as
the port does. Ids and type ids must be equal for ``encode``,
``encode_special`` and ``encode_pair`` on a corpus of accents, CJK,
ASCII and Unicode punctuation, control characters, a word over
``max_input_chars_per_word``, special tokens in the text and the empty
string; decoded text too.
"""

import json

import pytest
from tokenizers import (Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)

from localai_tfp_tpu.engine.tokenizer import HFTokenizer as JaxTokenizer
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.engine.tokenizer import HFTokenizer
from localai_tfp_tpu_torch.engine.wordpiece import WordPieceModel

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
TRAIN = [
    "The quick brown fox jumps over the lazy dog, again and again.",
    "Paged attention reads the keys of every slot from the arena.",
    "Café naïve résumé coöperate Ångström façade jalapeño",
    "北京是中国的首都。東京は日本の首都です。",
    "Embeddings are pooled; rerankers score a query against documents!",
    "don't stop 'em; it's the end-of-line (really?) [sic] {x} <y>",
]
CORPUS = [
    "Hello, world! The quick brown fox.",
    "Café NAÏVE Résumé coöperate ÅNGSTRÖM",  # accents, upper case
    "北京是中国的首都。東京",  # CJK ideographs and kana
    "¿Qué tal? «Bonjour» — “quotes” … 「括弧」",  # Unicode punctuation
    "a$b+c<d=e>f^g`h|i~j",  # ASCII punctuation that is not Unicode P*
    "tab\there\x0bvt\x85nel​zw\x00nul�\x07bell",  # controls
    "x" * 150 + " short",  # over max_input_chars_per_word (100)
    "",
    "   ",
    "ΣΊΣΥΦΟΣ ΟΔΟΣ İstanbul",
    "query [SEP] inside [CLS]text [MASK]",  # special tokens in the text
    "don't stop 'em; it's 12.5% of 3,000",
    "unseen zyzzyva qwertyuiop words",
]


def write_bert_tokenizer(path, lowercase: bool = True,
                         processor: str = "template",
                         truncation: int = 0, vocab_size: int = 600,
                         strip_accents=None) -> None:
    """A trained WordPiece ``tokenizer.json`` with its
    ``tokenizer_config.json`` (``BertTokenizer``, ``do_lower_case`` as the
    normalizer's) under ``path``."""
    path.mkdir(parents=True, exist_ok=True)
    tk = Tokenizer(models.WordPiece(unk_token="[UNK]",
                                    max_input_chars_per_word=100))
    tk.normalizer = normalizers.BertNormalizer(lowercase=lowercase,
                                               strip_accents=strip_accents)
    tk.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tk.train_from_iterator(TRAIN * 4, trainers.WordPieceTrainer(
        vocab_size=vocab_size, special_tokens=SPECIALS))
    cls, sep = tk.token_to_id("[CLS]"), tk.token_to_id("[SEP]")
    if processor == "template":
        tk.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", cls), ("[SEP]", sep)])
    else:
        tk.post_processor = processors.BertProcessing(("[SEP]", sep),
                                                      ("[CLS]", cls))
    tk.decoder = decoders.WordPiece()
    if truncation:
        tk.enable_truncation(truncation)
    tk.save(str(path / "tokenizer.json"))
    cfg = {"tokenizer_class": "BertTokenizer", "do_lower_case": lowercase,
           "model_max_length": 512, "clean_up_tokenization_spaces": True,
           **{f"{t[1:-1].lower()}_token": t for t in SPECIALS}}
    if strip_accents is not None:
        cfg["strip_accents"] = strip_accents
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))


VARIANTS = {
    "lower_template": dict(lowercase=True),
    "cased_template": dict(lowercase=False),
    "lower_bert": dict(lowercase=True, processor="bert"),
    "cased_bert_strip": dict(lowercase=False, processor="bert",
                             strip_accents=True),
    "lower_truncation": dict(lowercase=True, truncation=6),
}


@pytest.fixture(scope="module")
def tokenizers_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("wordpiece")
    out = {}
    for name, kw in VARIANTS.items():
        write_bert_tokenizer(root / name, **kw)
        out[name] = (JaxTokenizer(str(root / name)),
                     HFTokenizer(str(root / name)))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("text", range(len(CORPUS)))
def test_ids_equal_the_jax_tokenizer(tokenizers_pair, variant, text):
    jax, port = tokenizers_pair[variant]
    s = CORPUS[text]
    assert port.encode(s) == jax.encode(s)
    assert port.encode_special(s) == jax.encode_special(s)
    ids = jax.encode(s)
    assert port.decode(ids) == jax.decode(ids)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pairs_and_type_ids_equal_the_jax_tokenizer(tokenizers_pair,
                                                    variant):
    jax, port = tokenizers_pair[variant]
    for a in CORPUS:
        for b in CORPUS[:4] + CORPUS[7:8]:
            ids, types = port.encode_pair(a, b)
            want_ids, want_types = jax.encode_pair(a, b)
            assert ids == list(want_ids)
            assert types == list(want_types)
            assert len(ids) == len(types)


def test_truncation_block_is_ignored(tokenizers_pair):
    """transformers ignores the file's ``truncation`` (6 tokens) when no
    truncation is asked for, so the port does: a long text keeps every
    id, with and without special tokens."""
    jax, port = tokenizers_pair["lower_truncation"]
    long = CORPUS[0] + " " + CORPUS[4]
    assert len(port.encode_special(long)) > 6
    assert port.encode_special(long) == jax.encode_special(long)
    assert port.encode_pair(long, long)[0] == \
        list(jax.encode_pair(long, long)[0])


def test_tokenizer_config_sets_the_normalizer_as_transformers(tmp_path):
    """A Bert tokenizer class rebuilds the normalizer from
    ``tokenizer_config.json`` (``do_lower_case`` defaults to true):
    a cased ``tokenizer.json`` under a config without ``do_lower_case``
    lowercases in both packages."""
    write_bert_tokenizer(tmp_path, lowercase=False)
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    del cfg["do_lower_case"]
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    jax, port = JaxTokenizer(str(tmp_path)), HFTokenizer(str(tmp_path))
    for s in CORPUS[:3]:
        assert port.encode_special(s) == jax.encode_special(s)
    assert port.encode("Café") == port.encode("cafe")


def test_wordpiece_model_longest_match_and_unknowns():
    m = WordPieceModel({"vocab": {"[UNK]": 0, "un": 1, "##aff": 2,
                                  "##able": 3, "unaff": 4, "##a": 5},
                        "unk_token": "[UNK]",
                        "continuing_subword_prefix": "##",
                        "max_input_chars_per_word": 8})
    assert m.tokenize("unaffable") == [0]  # 9 characters: over the limit
    assert m.tokenize("unaffabl") == [0]  # no piece covers "bl"
    assert m.tokenize("unaff") == [4]  # the longest match first
    assert m.tokenize("una") == [1, 5]
    assert m.tokenize("") == []


def test_byte_tokenizer_special_and_pair_match_jax():
    from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes

    port, jax = ByteTokenizer(), JaxBytes()
    for a, b in (("héllo", "wörld"), ("", "x"), ("q", "")):
        assert port.encode_special(a) == jax.encode_special(a)
        assert port.encode_pair(a, b) == jax.encode_pair(a, b)
