"""Tokenizers for the serving engine (the port's own copy of
localai_tfp_tpu/engine/tokenizer.py: ``ByteTokenizer``, ``StreamDecoder``
and ``load_tokenizer`` as there).

- ``ByteTokenizer``: dependency-free bytes <-> ids codec, used by tests
  and whenever a checkpoint ships no tokenizer files.
- ``HFTokenizer``: a checkpoint's ``tokenizer.json`` through the
  ``tokenizers`` package, imported only when such a file is present.
  Chat templates from ``tokenizer_config.json`` are not applied yet: the
  model config's Go template (or the plain role-prefix join) assembles
  the prompt.

Streaming detokenization is UTF-8-safe: the engine emits byte-complete
strings only.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Protocol


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


def _special_id(tk, entry) -> Optional[int]:
    """A tokenizer_config special-token entry (string or AddedToken dict)
    -> its id."""
    if isinstance(entry, dict):
        entry = entry.get("content")
    return tk.token_to_id(entry) if isinstance(entry, str) else None


class HFTokenizer:
    """A checkpoint directory's ``tokenizer.json`` (``tokenizers``)."""

    def __init__(self, model_dir: str) -> None:
        from tokenizers import Tokenizer as _Tk

        self._tk = _Tk.from_file(os.path.join(model_dir, "tokenizer.json"))
        cfg = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
        self.bos_id = _special_id(self._tk, cfg.get("bos_token"))
        self.eos_ids: set[int] = set()
        eos = _special_id(self._tk, cfg.get("eos_token"))
        if eos is not None:
            self.eos_ids.add(eos)
        # generation_config may widen eos (llama3: <|eot_id|>)
        ge = _read_json(os.path.join(model_dir, "generation_config.json")
                        ).get("eos_token_id")
        if isinstance(ge, int):
            self.eos_ids.add(ge)
        elif isinstance(ge, list):
            self.eos_ids.update(int(e) for e in ge)

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size(with_added_tokens=True)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tk.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        return self._tk.decode(ids, skip_special_tokens=False)


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
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
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        return HFTokenizer(model_dir)
    return ByteTokenizer()
