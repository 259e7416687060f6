"""A checkpoint's ``tokenizer.json`` read with no ``tokenizers`` package.

``BPETokenizer(path)`` encodes and decodes as ``tokenizers.Tokenizer``
does on the same file, byte for byte, for the components of the model
families the port serves:

- Llama-3 and Qwen2/Qwen3 (byte-level): normalizer ``null`` or ``NFC``;
  pre-tokenizer ``Sequence[Split(pattern, Isolated), ByteLevel(
  use_regex=false)]`` or ``ByteLevel(use_regex=true)`` with GPT-2's
  pattern; model ``BPE`` with ``ignore_merges`` (a word that is whole in
  the vocabulary takes its id unmerged); decoder ``ByteLevel``.
- Mistral / Llama-2 (sentencepiece-style): normalizer
  ``Sequence[Prepend("▁"), Replace(" ", "▁")]`` or a ``Metaspace``
  pre-tokenizer; ``byte_fallback`` and ``fuse_unk``; decoder
  ``Sequence[Replace("▁", " "), ByteFallback, Fuse, Strip(" ", 1, 0)]``
  or ``Metaspace``.
- Added tokens: matched before normalization (or after it, for those
  with ``normalized``), leftmost and longest first, with ``lstrip``,
  ``rstrip`` and ``single_word``; ``<|eot_id|>`` in a rendered template is
  one id.
- A Unigram model (``engine/unigram.py``), for the sentencepiece
  vocabularies of GGUF files: ``BPETokenizer(spec=...)`` takes a parsed
  tokenizer spec, which ``models/gguf.py`` builds from the file's
  metadata.
- BERT (``engine/wordpiece.py``): ``BertNormalizer``,
  ``BertPreTokenizer``, a ``WordPiece`` model and decoder.
- coqui XTTS's ``vocab.json``: a ``Whitespace`` pre-tokenizer (the
  matches of ``\\w+|[^\\w\\s]+``, Oniguruma's Unicode ``\\w``) over a
  BPE model with ``[UNK]`` and ``[en]``-style added tokens.
- ``encode_special`` and ``encode_pair`` add the ``post_processor``'s
  special tokens (``TemplateProcessing``, ``BertProcessing``) and give a
  pair's type ids, as transformers' ``encode(..., add_special_tokens=
  True)`` does. A ``truncation`` or ``padding`` section is ignored, as
  transformers ignores it when a caller asks for neither.

Any other component raises ``NotImplementedError`` at load, naming it
(a post-processor: when special tokens are asked for).
Python's ``re`` has no ``\\p{L}``/``\\p{N}`` and its ``\\s`` also matches
``\\x1c-\\x1f``, which Oniguruma's does not: a pattern's classes are
written out from ``unicodedata`` (built once, at first use) and its
whitespace is Unicode's ``White_Space``. Encoded words are cached, as
``tokenizers`` caches them.
"""

from __future__ import annotations

import heapq
import json
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Optional

from .wordpiece import (WordPieceModel, bert_normalizer, bert_pre_tokenize,
                        post_processor, wordpiece_decoder)

# Unicode's White_Space property: what Oniguruma's \s matches
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003"
                "\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029"
                "\u202f\u205f\u3000")
_WORD_CACHE_MAX = 1 << 16


@lru_cache(maxsize=None)
def _category_ranges(cat: str) -> str:
    """The body of a character class for the general category ``cat``
    (one letter: every category it starts; two: that one), as ``\\U``
    ranges."""
    out: list[str] = []
    start = prev = -1
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(cat):
            if cp != prev + 1:
                if start >= 0:
                    out.append(_range(start, prev))
                start = cp
            prev = cp
    if start >= 0:
        out.append(_range(start, prev))
    return "".join(out)


def _range(a: int, b: int) -> str:
    return f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"


# Other_Alphabetic characters outside the categories below (circled,
# squared and negative letters, So): unicodedata has no property table
_OTHER_ALPHABETIC_SO = ("\U000024b6-\U000024e9\U0001f130-\U0001f149"
                        "\U0001f150-\U0001f169\U0001f170-\U0001f189")


def _word_ranges() -> str:
    """Oniguruma's Unicode ``\\w`` as a class body: Alphabetic (letters,
    letter numbers, Other_Alphabetic), marks, decimal digits, connector
    punctuation and the two joiners; Python's ``\\w`` takes every number
    and omits the marks and joiners."""
    return "".join(_category_ranges(c) for c in ("L", "Nl", "M", "Nd",
                                                 "Pc")) \
        + "\U0000200c\U0000200d" + _OTHER_ALPHABETIC_SO


def _ws_ranges() -> str:
    return "".join(f"\\U{ord(c):08x}" for c in _WHITE_SPACE)


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern of a ``tokenizer.json`` as a Python ``re``
    pattern: ``\\p{..}``/``\\P{..}`` and ``\\s``/``\\S`` become explicit
    classes, and so does ``\\w``/``\\W`` (``_word_ranges``). An escape
    whose meanings differ (``\\b``, ``\\d``, ...) raises."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{\^?([A-Za-z]{1,2})\}", pattern[i + 2:])
                if not m:
                    raise NotImplementedError(
                        f"tokenizer.json pattern {pattern!r}: unsupported "
                        f"property at {i}")
                body = _category_ranges(m.group(1))
                neg = (e == "P") != ("^" in m.group(0))
                if in_class:
                    if neg:
                        raise NotImplementedError(
                            f"tokenizer.json pattern {pattern!r}: a negated "
                            "property inside a class")
                    out.append(body)
                else:
                    out.append(f"[{'^' if neg else ''}{body}]")
                i += 2 + len(m.group(0))
                continue
            if e in "sS":
                if in_class:
                    if e == "S":
                        raise NotImplementedError(
                            f"tokenizer.json pattern {pattern!r}: \\S inside "
                            "a class")
                    out.append(_ws_ranges())
                else:
                    out.append(f"[{'^' if e == 'S' else ''}{_ws_ranges()}]")
                i += 2
                continue
            if e in "wW":
                body = _word_ranges()
                if in_class:
                    if e == "W":
                        raise NotImplementedError(
                            f"tokenizer.json pattern {pattern!r}: \\W "
                            "inside a class")
                    out.append(body)
                else:
                    out.append(f"[{'^' if e == 'W' else ''}{body}]")
                i += 2
                continue
            if e in "bBdDhHAzZGRXK":
                raise NotImplementedError(
                    f"tokenizer.json pattern {pattern!r}: escape \\{e} "
                    "differs between Oniguruma and Python")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":  # a literal ] first
                out.append("\\]")
                i += 1
            continue
        if ch == "[" and in_class:
            raise NotImplementedError(
                f"tokenizer.json pattern {pattern!r}: nested classes")
        if ch == "]" and in_class:
            in_class = False
        out.append(ch)
        i += 1
    return "".join(out)


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte-level alphabet: each byte as a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    k = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + k)
            k += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")


class _Piece:
    """A span of the input on its way to the model: its text and whether
    it begins the input (Metaspace's ``first`` scheme)."""

    __slots__ = ("text", "first")

    def __init__(self, text: str, first: bool) -> None:
        self.text = text
        self.first = first


# ------------------------------------------------------------- normalizers


def _normalizer(spec: Optional[dict]):
    """A ``str -> str`` function for the normalizer ``spec``."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def seq(s: str) -> str:
            for f in steps:
                s = f(s)
            return s
        return seq
    if kind == "Prepend":
        p = spec["prepend"]
        return lambda s: p + s if s else s
    if kind == "Replace":
        a, b = _string_pattern(spec, "normalizer Replace"), spec["content"]
        return lambda s: s.replace(a, b)
    if kind == "BertNormalizer":
        return bert_normalizer(spec)
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r} is not "
                              "supported")


def _string_pattern(spec: dict, what: str) -> str:
    pat = spec["pattern"]
    if "String" not in pat:
        raise NotImplementedError(f"tokenizer.json {what} with a "
                                  f"{next(iter(pat))} pattern")
    return pat["String"]


# ---------------------------------------------------------- pre-tokenizers


def _pre_tokenizer(spec: Optional[dict]):
    """A ``list[_Piece] -> list[_Piece]`` function for ``spec``."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for f in steps:
                pieces = f(pieces)
            return pieces
        return seq
    if kind == "Split":
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise NotImplementedError(
                f"tokenizer.json Split with behavior {spec.get('behavior')!r}"
                f" invert {spec.get('invert')!r} (only Isolated is read)")
        pat = spec["pattern"]
        rx = re.compile(translate_pattern(pat["Regex"]) if "Regex" in pat
                        else re.escape(pat["String"]))
        return lambda pieces: _split_isolated(pieces, rx)
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space"))
        rx = (re.compile(translate_pattern(GPT2_PATTERN))
              if spec.get("use_regex", True) else None)

        def byte_level(pieces):
            out = []
            for p in pieces:
                if prefix and p.text and not p.text.startswith(" "):
                    p = _Piece(" " + p.text, p.first)
                for q in (_split_isolated([p], rx) if rx else [p]):
                    out.append(_Piece("".join(
                        BYTE_TO_CHAR[b] for b in q.text.encode("utf-8")),
                        q.first))
            return out
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        split = spec.get("split", True)

        def metaspace(pieces):
            out = []
            for p in pieces:
                t = p.text.replace(" ", rep)
                if t and not t.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and p.first)):
                    t = rep + t
                if not split:
                    if t:
                        out.append(_Piece(t, p.first))
                    continue
                start = 0
                for k in range(1, len(t)):
                    if t[k] == rep:
                        out.append(_Piece(t[start:k], p.first and start == 0))
                        start = k
                if t:
                    out.append(_Piece(t[start:], p.first and start == 0))
            return out
        return metaspace
    if kind == "Whitespace":
        # tokenizers' Whitespace: the matches of \w+|[^\w\s]+ (Oniguruma),
        # each a piece; the whitespace between them dropped
        rx = re.compile(translate_pattern(r"\w+|[^\w\s]+"))
        return lambda pieces: [_Piece(m.group(), p.first and m.start() == 0)
                               for p in pieces
                               for m in rx.finditer(p.text)]
    if kind == "BertPreTokenizer":
        return lambda pieces: [_Piece(w, p.first and k == 0)
                               for p in pieces
                               for k, w in enumerate(
                                   bert_pre_tokenize(p.text))]
    raise NotImplementedError(f"tokenizer.json pre_tokenizer {kind!r} is not "
                              "supported")


def _split_isolated(pieces: list, rx) -> list:
    out = []
    for p in pieces:
        pos = 0
        for m in rx.finditer(p.text):
            if m.start() > pos:
                out.append(_Piece(p.text[pos:m.start()], p.first and pos == 0))
            if m.end() > m.start():
                out.append(_Piece(m.group(), p.first and m.start() == 0))
            pos = m.end()
        if pos < len(p.text):
            out.append(_Piece(p.text[pos:], p.first and pos == 0))
    return out


# ---------------------------------------------------------------- decoders


def _decoder(spec: Optional[dict]):
    """A ``list[str] -> list[str]`` function (``decode_chain``)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for f in steps:
                tokens = f(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Replace":
        a, b = _string_pattern(spec, "decoder Replace"), spec["content"]
        return lambda tokens: [t.replace(a, b) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]
        return lambda tokens: [_strip(t, content, start, stop) for t in tokens]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"

        def metaspace(tokens):
            return ["".join(("" if i == 0 and scheme != "never" else " ")
                            if c == rep else c for c in t)
                    for i, t in enumerate(tokens)]
        return metaspace
    if kind == "WordPiece":
        return wordpiece_decoder(spec)
    raise NotImplementedError(f"tokenizer.json decoder {kind!r} is not "
                              "supported")


def _byte_level_decode(tokens: list) -> list:
    out = bytearray()
    for t in tokens:
        try:
            out += bytes(CHAR_TO_BYTE[c] for c in t)
        except KeyError:
            out += t.encode("utf-8")
    return [out.decode("utf-8", errors="replace")]


def _byte_fallback_decode(tokens: list) -> list:
    out: list[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(pending))
            pending.clear()
    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                pending.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(t: str, content: str, start: int, stop: int) -> str:
    """tokenizers' ``Strip``: it takes (byte length - cuts) characters
    after the leading cut, so a trailing cut does not apply to a token
    with a multi-byte character; kept as it is."""
    a = 0
    while a < start and a < len(t) and t[a] == content:
        a += 1
    b = 0
    while b < stop and b < len(t) and t[len(t) - 1 - b] == content:
        b += 1
    return t[a:][:len(t.encode("utf-8")) - a - b]


# ------------------------------------------------------------------ model


class _BPEModel:
    def __init__(self, spec: dict) -> None:
        if spec.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer.json model "
                                      f"{spec.get('type')!r} is not supported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise NotImplementedError(f"tokenizer.json BPE {key} is not "
                                          "supported")
        if spec.get("dropout"):
            raise NotImplementedError("tokenizer.json BPE dropout is not "
                                      "supported")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"tokenizer.json merge {m!r} is not two "
                                     "tokens")
                a, b = parts
            else:
                a, b = m
            try:
                ids = (self.vocab[a], self.vocab[b])
                new = self.vocab[a + b]
            except KeyError as e:
                raise ValueError(f"tokenizer.json merge {a!r} {b!r}: token "
                                 f"{e.args[0]!r} is not in the vocabulary"
                                 ) from None
            self.merges.setdefault(ids, (rank, new))
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges:
            i = self.vocab.get(word)
            if i is not None:
                return [i]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = self._merge_word(word)
        if len(self._cache) >= _WORD_CACHE_MAX:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def _symbols(self, word: str) -> list[int]:
        syms: list[int] = []
        unk: Optional[int] = None  # a pending unknown (fused) symbol
        for ch in word:
            i = self.vocab.get(ch)
            if i is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(i)
                continue
            if self.byte_fallback:
                bs = [self.vocab.get(f"<0x{b:02X}>")
                      for b in ch.encode("utf-8")]
                if all(b is not None for b in bs):
                    syms.extend(bs)
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                if unk is None or not self.fuse_unk:
                    if self.unk not in self.vocab:
                        raise ValueError(f"unk token {self.unk!r} is not in "
                                         "the vocabulary")
                    unk = self.vocab[self.unk]
        if unk is not None:
            syms.append(unk)
        return syms

    def _merge_word(self, word: str) -> list[int]:
        """tokenizers' ``Word::merge_all``: always the pair of lowest rank,
        the leftmost of equals first."""
        ids = self._symbols(word)
        n = len(ids)
        if n < 2:
            return ids
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for p in range(n - 1):
            m = merges.get((ids[p], ids[p + 1]))
            if m is not None:
                heap.append((m[0], p, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, p, new = heapq.heappop(heap)
            if not alive[p] or nxt[p] >= n:
                continue
            q = nxt[p]
            m = merges.get((ids[p], ids[q]))
            if m is None or m[1] != new:
                continue
            ids[p] = new
            alive[q] = False
            nxt[p] = nxt[q]
            if nxt[q] < n:
                prv[nxt[q]] = p
            if prv[p] >= 0:
                m = merges.get((ids[prv[p]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[p], m[1]))
            if nxt[p] < n:
                m = merges.get((new, ids[nxt[p]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
        return [ids[p] for p in range(n) if alive[p]]


# ---------------------------------------------------------- added tokens


class _AddedToken:
    __slots__ = ("id", "content", "single_word", "lstrip", "rstrip",
                 "normalized", "special")

    def __init__(self, d: dict) -> None:
        self.id = int(d["id"])
        self.content = d["content"]
        self.single_word = bool(d.get("single_word"))
        self.lstrip = bool(d.get("lstrip"))
        self.rstrip = bool(d.get("rstrip"))
        self.normalized = bool(d.get("normalized"))
        self.special = bool(d.get("special"))


class _Matcher:
    """Leftmost-longest, non-overlapping matches of a set of strings
    (what the Aho-Corasick automaton of ``tokenizers`` finds)."""

    def __init__(self, tokens: dict[str, _AddedToken]) -> None:
        self.tokens = tokens
        pats = sorted(tokens, key=len, reverse=True)
        self.rx = (re.compile("|".join(re.escape(p) for p in pats))
                   if pats else None)

    def find(self, s: str):
        if self.rx is None:
            return
        for m in self.rx.finditer(s):
            yield m.start(), m.end(), self.tokens[m.group()]


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _is_space(c: str) -> bool:
    return c in _WHITE_SPACE


def _split_added(text: str, first: bool, matcher: _Matcher) -> list:
    """(token id or None, text, begins the input) spans, as
    ``AddedVocabulary::find_matches`` splits a sentence."""
    out: list = []
    pos = 0
    for start, stop, tok in matcher.find(text):
        if tok.single_word:
            if (start > 0 and _is_word_char(text[start - 1])) or (
                    stop < len(text) and _is_word_char(text[stop])):
                continue
        if tok.lstrip:
            s = start
            while s > 0 and _is_space(text[s - 1]):
                s -= 1
            start = max(s, pos)
        if tok.rstrip:
            while stop < len(text) and _is_space(text[stop]):
                stop += 1
        if start < pos:
            continue  # inside an earlier token's stripped spaces
        if pos < start:
            out.append((None, text[pos:start], first and pos == 0))
        out.append((tok.id, text[start:stop], first and start == 0))
        pos = stop
    if pos < len(text):
        out.append((None, text[pos:], first and pos == 0))
    return out


# --------------------------------------------------------------- tokenizer


def _model(spec: dict):
    """The ``model`` section: BPE, WordPiece (``engine/wordpiece.py``), or
    (GGUF's sentencepiece vocabularies) Unigram, ``engine/unigram.py``."""
    if spec.get("type") == "WordPiece":
        return WordPieceModel(spec)
    if spec.get("type") == "Unigram":
        from .unigram import UnigramModel

        return UnigramModel([tuple(v) for v in spec["vocab"]],
                            spec.get("unk_id"),
                            bool(spec.get("byte_fallback")))
    return _BPEModel(spec)


class BPETokenizer:
    """``tokenizer.json`` encode/decode (``add_special_tokens=False``;
    ``encode_special``/``encode_pair`` with them), from the file at
    ``path`` or from its parsed ``spec``."""

    def __init__(self, path: str = "<spec>",
                 spec: Optional[dict] = None) -> None:
        if spec is None:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        try:
            self.model = _model(spec["model"])
            self.normalize = _normalizer(spec.get("normalizer"))
            self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
            self.decoder = _decoder(spec.get("decoder"))
            self.post_process = post_processor(spec.get("post_processor"))
        except NotImplementedError as e:
            raise NotImplementedError(f"{path}: {e}") from None
        self.added = [_AddedToken(d) for d in spec.get("added_tokens") or []]
        self.added_by_id = {t.id: t for t in self.added}
        self.added_by_content = {t.content: t for t in self.added}
        raw = {t.content: t for t in self.added if not t.normalized}
        norm = {}
        for t in self.added:
            if t.normalized:
                key = self.normalize(t.content) if self.normalize \
                    else t.content
                norm[key] = t
        self._raw = _Matcher(raw)
        self._norm = _Matcher(norm)

    @property
    def vocab_size(self) -> int:
        """Distinct tokens, added ones included
        (``get_vocab_size(with_added_tokens=True)``)."""
        return len(set(self.model.vocab) | set(self.added_by_content))

    def get_vocab(self) -> dict[str, int]:
        """Every token's id, added ones included (``get_vocab()``)."""
        return {**self.model.vocab,
                **{t.content: t.id for t in self.added}}

    def token_to_id(self, token: str) -> Optional[int]:
        t = self.added_by_content.get(token)
        return t.id if t is not None else self.model.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        t = self.added_by_id.get(i)
        return t.content if t is not None else self.model.vocab_r.get(i)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for tid, span, first in _split_added(text, True, self._raw):
            if tid is not None:
                ids.append(tid)
                continue
            if not span:
                continue
            if self.normalize is not None:
                span = self.normalize(span)
            for tid2, part, first2 in _split_added(span, first, self._norm):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                for piece in self.pre_tokenize([_Piece(part, first2)]):
                    ids.extend(self.model.tokenize(piece.text))
        return ids

    def encode_special(self, text: str) -> list[int]:
        """``encode`` with the post-processor's special tokens."""
        return self.post_process(self.encode(text))[0]

    def encode_pair(self, a: str, b: str) -> tuple[list[int], list[int]]:
        """A pair with its special tokens: (ids, type ids)."""
        return self.post_process(self.encode(a), self.encode(b))

    def decode(self, ids: list[int], skip_special_tokens: bool = False
               ) -> str:
        tokens = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None:
                continue
            if skip_special_tokens and i in self.added_by_id and \
                    self.added_by_id[i].special:
                continue
            tokens.append(t)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
