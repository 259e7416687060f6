"""BERT's ``tokenizer.json`` components, with no ``tokenizers`` package.

``engine/bpe.py``'s ``BPETokenizer`` reads a ``tokenizer.json`` by
component; this module holds the components BERT-family checkpoints (the
encoders behind ``/v1/embeddings`` and ``/v1/rerank``) ship, each as
``tokenizers`` (0.22) computes it:

- ``bert_normalizer``: ``BertNormalizer`` — ``clean_text`` (drop NUL,
  U+FFFD and other-category characters, map whitespace to a space),
  ``handle_chinese_chars`` (spaces around each CJK ideograph),
  ``strip_accents`` (NFD, then no nonspacing marks; when null it follows
  ``lowercase``) and ``lowercase`` (character by character, so a final
  sigma is not special);
- ``bert_pre_tokenize``: ``BertPreTokenizer`` — split on whitespace
  (removed) and on every ASCII or Unicode punctuation character
  (isolated);
- ``WordPieceModel``: greedy longest match from the left, the
  continuing-subword prefix (``##``) on every piece after the first, a
  word with no match or longer than ``max_input_chars_per_word``
  characters becomes ``unk_token``;
- ``wordpiece_decoder``: the ``WordPiece`` decoder with its cleanup;
- ``post_processor``: ``TemplateProcessing`` and ``BertProcessing`` (and
  the id-neutral ``ByteLevel`` and ``Sequence`` around them): the special
  tokens and the type ids of a single sequence or a pair.

Character classes come from Python's ``unicodedata``; the tables of
``tokenizers`` are older, so a punctuation character assigned since
(U+2E52, Unicode 13) splits a word here and not there.
"""

from __future__ import annotations

import unicodedata
from typing import Callable, Optional

# what Rust's char::is_whitespace matches (the White_Space property)
WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
# tokenizers' is_other: control, format, private use, surrogate
_OTHER = ("Cc", "Cf", "Co", "Cs")
_PUNCT = ("Pc", "Pd", "Pe", "Pf", "Pi", "Po", "Ps")
_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c) in _OTHER


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(a <= cp <= b for a, b in _CJK)


def is_bert_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c) in _PUNCT


def bert_normalizer(spec: dict) -> Callable[[str], str]:
    """The ``BertNormalizer`` of ``spec`` as a ``str -> str`` function."""
    clean = spec.get("clean_text", True)
    chinese = spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    if strip is None:
        strip = lower

    def normalize(s: str) -> str:
        if clean:
            s = "".join(" " if c in WHITE_SPACE else c for c in s
                        if c not in "\0\ufffd" and not _is_control(c))
        if chinese:
            s = "".join(f" {c} " if _is_cjk(c) else c for c in s)
        if strip:
            s = "".join(c for c in unicodedata.normalize("NFD", s)
                        if unicodedata.category(c) != "Mn")
        if lower:
            s = "".join(c.lower() for c in s)
        return s
    return normalize


def bert_pre_tokenize(s: str) -> list[str]:
    """``BertPreTokenizer``: the words and punctuation marks of ``s``."""
    out: list[str] = []
    word: list[str] = []
    for c in s:
        if c in WHITE_SPACE or is_bert_punct(c):
            if word:
                out.append("".join(word))
                word = []
            if c not in WHITE_SPACE:
                out.append(c)
        else:
            word.append(c)
    if word:
        out.append("".join(word))
    return out


class WordPieceModel:
    """The ``WordPiece`` model of a ``tokenizer.json``."""

    def __init__(self, spec: dict) -> None:
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))
        self._cache: dict[str, list[int]] = {}

    def _unk(self) -> list[int]:
        if self.unk not in self.vocab:
            raise ValueError(f"WordPiece unk token {self.unk!r} is not in "
                             "the vocabulary")
        return [self.vocab[self.unk]]

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if len(word) > self.max_chars:
            return self._unk()
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            found = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.prefix + piece
                found = self.vocab.get(piece)
                if found is not None:
                    break
                end -= 1
            if found is None:
                ids = self._unk()
                break
            ids.append(found)
            start = end
        if len(self._cache) >= 1 << 16:
            self._cache.clear()
        self._cache[word] = ids
        return ids


def _cleanup(s: str) -> str:
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" do not", " don't")
            .replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def wordpiece_decoder(spec: dict) -> Callable[[list], list]:
    """The ``WordPiece`` decoder: pieces after the first lose their
    prefix, or else take a leading space; then the cleanup."""
    prefix = spec.get("prefix", "##")
    cleanup = spec.get("cleanup", True)

    def decode(tokens: list) -> list:
        out = []
        for i, t in enumerate(tokens):
            if i:
                t = t.replace(prefix, "", 1) if t.startswith(prefix) \
                    else " " + t
            out.append(_cleanup(t) if cleanup else t)
        return out
    return decode


# ----------------------------------------------------------- post-processors

Template = list  # of ("special", token ids, type id) / ("seq", "A"|"B", type)


def _template(spec: dict) -> tuple[Template, Template]:
    """(single, pair) templates of a ``TemplateProcessing`` or
    ``BertProcessing`` section."""
    kind = spec.get("type")
    if kind == "BertProcessing":
        (sep, sep_id), (cls, cls_id) = spec["sep"], spec["cls"]
        c, s = ("special", [cls_id], 0), ("special", [sep_id], 0)
        return ([c, ("seq", "A", 0), s],
                [c, ("seq", "A", 0), s, ("seq", "B", 1),
                 ("special", [sep_id], 1)])
    specials = {k: list(v["ids"]) for k, v in
                (spec.get("special_tokens") or {}).items()}

    def parse(items: list) -> Template:
        out: Template = []
        for item in items:
            if "SpecialToken" in item:
                d = item["SpecialToken"]
                if d["id"] not in specials:
                    raise ValueError(f"tokenizer.json TemplateProcessing: "
                                     f"special token {d['id']!r} has no ids")
                out.append(("special", specials[d["id"]], d["type_id"]))
            else:
                d = item["Sequence"]
                out.append(("seq", d["id"], d["type_id"]))
        return out
    return parse(spec["single"]), parse(spec["pair"])


def _refuse(what: str):
    def refuse(a, b=None):
        raise NotImplementedError(f"tokenizer.json post_processor {what} "
                                  "is not supported")
    return refuse


def post_processor(spec: Optional[dict]):
    """A function ``(ids_a, ids_b or None) -> (ids, type_ids)`` for the
    ``post_processor`` section, or one that raises ``NotImplementedError``
    naming what this module does not read (raised when a caller asks for
    special tokens, not at load: an LLM's tokenizer never does)."""
    steps = []
    pending = [spec] if spec is not None else []
    while pending:
        s = pending.pop(0)
        kind = s.get("type")
        if kind == "Sequence":
            pending = list(s["processors"]) + pending
        elif kind == "ByteLevel":
            continue  # offsets only
        elif kind in ("TemplateProcessing", "BertProcessing"):
            steps.append(_template(s))
        else:
            return _refuse(repr(kind))
    if len(steps) > 1:
        return _refuse("with more than one template")

    def apply(a: list, b: Optional[list] = None) -> tuple[list, list]:
        if not steps:  # no processor: the sequences as they are
            ids = list(a) + list(b or [])
            return ids, [0] * len(a) + [1] * len(b or [])
        single, pair = steps[0]
        ids: list[int] = []
        types: list[int] = []
        for kind, what, type_id in (single if b is None else pair):
            part = what if kind == "special" else (a if what == "A" else b)
            ids.extend(part)
            types.extend([type_id] * len(part))
        return ids, types
    return apply
