"""Tokenizers for the serving engine (the port's own copy of
localai_tfp_tpu/engine/tokenizer.py: ``ByteTokenizer``, ``StreamDecoder``
and ``load_tokenizer`` as there).

- ``ByteTokenizer``: dependency-free bytes <-> ids codec, used by tests
  and whenever a checkpoint ships no tokenizer files.
- ``HFTokenizer``: a checkpoint's ``tokenizer.json`` read by the port's
  own reader (``engine/bpe.py``: BPE, WordPiece or Unigram by its
  ``model.type``; no ``tokenizers`` package), with the
  ``tokenizer_config.json`` chat template rendered by the port's Jinja
  subset (``engine/jinja_lite.py``, no ``jinja2``). A file it cannot read
  fails the load with the reason: a checkpoint with a ``tokenizer.json``
  is never served by the byte tokenizer.

Streaming detokenization is UTF-8-safe: the engine emits byte-complete
strings only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Protocol

from . import jinja_lite
from .bpe import BPETokenizer


class Tokenizer(Protocol):
    eos_ids: set[int]
    bos_id: Optional[int]

    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...

    def decode(self, ids: list[int]) -> str: ...

    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """ids = raw UTF-8 bytes; 256=BOS, 257=EOS. Vocab 258 (tests/fallback)."""

    def __init__(self) -> None:
        self.bos_id: Optional[int] = 256
        self.eos_ids = {257}

    @property
    def vocab_size(self) -> int:
        return 258

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def encode_special(self, text: str) -> list[int]:
        """The encoders' input: BOS, the bytes, EOS."""
        return [self.bos_id] + self.encode(text) + [next(iter(self.eos_ids))]

    def encode_pair(self, a: str, b: str) -> tuple[list[int], list[int]]:
        """(ids, type ids) of ``BOS a EOS b EOS``; type 1 covers ``b``
        and the last EOS."""
        sep = next(iter(self.eos_ids))
        ea, eb = self.encode(a), self.encode(b)
        ids = [self.bos_id] + ea + [sep] + eb + [sep]
        types = [0] * (len(ea) + 2) + [1] * (len(eb) + 1)
        return ids, types


# the transformers classes that rebuild a BertNormalizer from their
# tokenizer_config.json arguments (BertTokenizerFast.__init__); a
# config.json of model_type "bert" maps to them when none is named
_BERT_CLASSES = ("BertTokenizer", "BertTokenizerFast")


def _bert_normalizer_args(model_dir: str, cfg: dict, spec: dict) -> None:
    """Set ``spec``'s ``BertNormalizer`` as transformers' Bert tokenizer
    classes do: from ``do_lower_case`` (default true), ``strip_accents``
    (default null) and ``tokenize_chinese_chars`` (default true) of
    ``tokenizer_config.json``, whatever ``tokenizer.json`` says."""
    norm = spec.get("normalizer")
    if not isinstance(norm, dict) or norm.get("type") != "BertNormalizer":
        return
    cls = cfg.get("tokenizer_class")
    if cls is None:
        mt = _read_json(os.path.join(model_dir, "config.json"),
                        strict=False).get("model_type")
        if mt != "bert":
            return
    elif cls not in _BERT_CLASSES:
        return
    norm["lowercase"] = cfg.get("do_lower_case", True)
    norm["strip_accents"] = cfg.get("strip_accents")
    norm["handle_chinese_chars"] = cfg.get("tokenize_chinese_chars", True)


def _special_token(entry) -> Optional[str]:
    """A tokenizer_config special-token entry (string or AddedToken
    dict) -> its content."""
    if isinstance(entry, dict):
        entry = entry.get("content")
    return entry if isinstance(entry, str) else None


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``: the same replacements in
    the same order."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


class HFTokenizer:
    """A checkpoint directory's ``tokenizer.json`` (read by
    ``engine/bpe.py``), its ``tokenizer_config.json`` and chat template,
    as transformers' ``AutoTokenizer`` presents them to the JAX worker:
    ``bos_id``, ``eos_ids`` (widened by ``generation_config.json``),
    ``vocab_size``, ``decode`` with ``clean_up_tokenization_spaces``, and
    ``apply_chat_template`` (``engine/jinja_lite.py``, transformers'
    environment)."""

    def __init__(self, model_dir: str) -> None:
        path = os.path.join(model_dir, "tokenizer.json")
        spec = _read_json(path)
        cfg = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
        _bert_normalizer_args(model_dir, cfg, spec)
        self._tk = BPETokenizer(path, spec)
        self.special_tokens: dict[str, Any] = {}
        for key in ("bos_token", "eos_token", "unk_token", "sep_token",
                    "pad_token", "cls_token", "mask_token"):
            tok = _special_token(cfg.get(key))
            if tok is not None:
                self.special_tokens[key] = tok
        extra = [t for t in (_special_token(e) for e in
                             cfg.get("additional_special_tokens") or [])
                 if t is not None]
        if extra:
            self.special_tokens["additional_special_tokens"] = extra
        bos = self.special_tokens.get("bos_token")
        self.bos_id = self._tk.token_to_id(bos) if bos is not None else None
        self.eos_ids: set[int] = set()
        eos = self.special_tokens.get("eos_token")
        if eos is not None and self._tk.token_to_id(eos) is not None:
            self.eos_ids.add(self._tk.token_to_id(eos))
        # generation_config may widen eos (llama3: <|eot_id|>)
        ge = _read_json(os.path.join(model_dir, "generation_config.json"),
                        strict=False).get("eos_token_id")
        if isinstance(ge, int):
            self.eos_ids.add(ge)
        elif isinstance(ge, list):
            self.eos_ids.update(int(e) for e in ge)
        self.clean_up_spaces = bool(cfg.get("clean_up_tokenization_spaces",
                                            False))
        self.chat_template = _chat_template(model_dir, cfg)
        self._env = jinja_lite.Environment.chat()
        # a template that does not parse fails the load, not a request
        for tpl in (self.chat_template.values()
                    if isinstance(self.chat_template, dict)
                    else [self.chat_template]):
            if tpl:
                self._env.from_string(tpl)

    @property
    def vocab_size(self) -> int:
        return self._tk.vocab_size

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tk.encode(text)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int], skip_special_tokens: bool = False
               ) -> str:
        text = self._tk.decode(ids, skip_special_tokens)
        return clean_up_tokenization(text) if self.clean_up_spaces else text

    def get_vocab(self) -> dict[str, int]:
        """Every token's id, added tokens included (transformers'
        ``get_vocab``)."""
        return self._tk.get_vocab()

    def token_to_id(self, token: str) -> Optional[int]:
        """``convert_tokens_to_ids`` of one token: its id, else the unknown
        token's (None without one)."""
        tid = self._tk.token_to_id(token)
        if tid is None and "unk_token" in self.special_tokens:
            tid = self._tk.token_to_id(self.special_tokens["unk_token"])
        return tid

    def encode_special(self, text: str) -> list[int]:
        """Encode WITH special tokens (``[CLS] ... [SEP]`` for BERT), as
        encoder models pool or classify them."""
        return self._tk.encode_special(text)

    def encode_pair(self, a: str, b: str) -> tuple[list[int], list[int]]:
        """``[CLS] a [SEP] b [SEP]`` and its type ids (1 on the ``b``
        half): the cross-encoder's input. An empty ``b`` is no pair, as
        transformers reads it: ``a`` alone, with its special tokens."""
        if not b:
            return self._tk.post_process(self._tk.encode(a))
        return self._tk.encode_pair(a, b)

    def apply_chat_template(self, messages: list[dict], *,
                            add_generation_prompt: bool = True,
                            tools: Optional[list] = None) -> str:
        """The chat template rendered as transformers renders it: the
        messages, ``tools``, ``documents`` (None), the generation prompt
        flag and the special-token strings."""
        template = self.chat_template
        if isinstance(template, dict):
            if tools is not None and "tool_use" in template:
                template = template["tool_use"]
            elif "default" in template:
                template = template["default"]
            else:
                raise ValueError(
                    "This model has multiple chat templates with no default "
                    "specified! Available template names are "
                    f"{sorted(template)}.")
        if not template:
            raise ValueError("the tokenizer has no chat template")
        if tools is not None:
            for t in tools:
                if not isinstance(t, dict):
                    raise ValueError("Tools should be JSON schemas (dicts)")
        return self._env.from_string(template).render(
            messages=messages, tools=tools, documents=None,
            add_generation_prompt=add_generation_prompt,
            **self.special_tokens)


def _chat_template(model_dir: str, cfg: dict):
    """The chat template as transformers 4.57 loads it: ``chat_template.
    jinja`` (and ``additional_chat_templates/*.jinja``) over the
    config's ``chat_template``, a list of named templates as a dict."""
    templates: dict[str, str] = {}
    path = os.path.join(model_dir, "chat_template.jinja")
    if os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            templates["default"] = f.read()
    extra = os.path.join(model_dir, "additional_chat_templates")
    if os.path.isdir(extra):
        for fname in sorted(os.listdir(extra)):
            if fname.endswith(".jinja"):
                with open(os.path.join(extra, fname), encoding="utf-8") as f:
                    templates[fname[:-len(".jinja")]] = f.read()
    if len(templates) == 1 and "default" in templates:
        return templates["default"]
    if templates:
        return templates
    tpl = cfg.get("chat_template")
    if isinstance(tpl, list):
        return {t["name"]: t["template"] for t in tpl}
    return tpl


def _read_json(path: str, strict: bool = True) -> dict:
    """A JSON object file; {} when it is absent. A file that is not JSON
    raises (``strict``) or reads as {} (``generation_config.json``, which
    the JAX worker reads the same way)."""
    if not os.path.isfile(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except ValueError as e:
        if strict:
            raise ValueError(f"{path}: {e}") from None
        return {}
    return data if isinstance(data, dict) else {}


class StreamDecoder:
    """Incremental detokenizer emitting only UTF-8-complete text.

    Held per active request. ``push(token_id)`` returns the newly completed
    text (possibly ""). Handles tokenizers whose decode is not prefix-stable
    (sentencepiece space handling) by re-decoding the whole id list.
    """

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._tk = tokenizer
        self._ids: list[int] = []
        self._emitted = ""

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tk.decode(self._ids)
        if text.endswith("�"):  # mid-UTF-8-sequence; wait for more bytes
            return ""
        if not text.startswith(self._emitted):
            # non-prefix-stable decode: emit the suffix after the longest
            # common prefix
            common = os.path.commonprefix([text, self._emitted])
            out = text[len(common):]
        else:
            out = text[len(self._emitted):]
        self._emitted = text
        return out

    @property
    def text(self) -> str:
        return self._emitted


def load_tokenizer(model_dir: str) -> Tokenizer:
    """The checkpoint's ``tokenizer.json``; the byte tokenizer only for a
    directory with no tokenizer files at all (the JAX package's rule). A
    directory with only a slow tokenizer's files is refused."""
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        return HFTokenizer(model_dir)
    for fname in ("tokenizer_config.json", "vocab.json"):
        if os.path.exists(os.path.join(model_dir, fname)):
            raise NotImplementedError(
                f"{model_dir}: has {fname} but no tokenizer.json; this port "
                "reads tokenizers from tokenizer.json only")
    return ByteTokenizer()
