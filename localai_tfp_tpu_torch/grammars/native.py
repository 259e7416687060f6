"""ctypes binding for the native GBNF mask engine (csrc/gbnf_mask.cpp):
the port's own copy of localai_tfp_tpu/grammars/native.py.

Same contract as grammars/constrain.py GrammarConstraint (the engine
accepts either). States are plain ints interned inside the C++ engine, so
the per-token host cost is one FFI call for advance and one for the mask
fill.

The library is built from the port's own source by ``utils/cxx.py``
(``g++ -O3 -std=c++17 -fPIC -shared``) at first use into
``build/torch_kernels/libgbnf_mask-<hash>.so`` (the hash covers the source
and the flags, so an edited source rebuilds), beside the CUDA kernels of
ops/_build.py. A failed build or load raises; a grammar the native
parser rejects falls back to the Python engine (grammars/constrain.py).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR, CSRC
from ..utils import cxx

SRC = CSRC / "gbnf_mask.cpp"

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def library_path(src: Optional[Path] = None) -> Path:
    """Where the library built from ``src`` lives."""
    return cxx.library_path(Path(src or SRC), BUILD_DIR)


def build(src: Optional[Path] = None) -> Path:
    """Compile ``src`` (default: the port's gbnf_mask.cpp) unless a current
    build exists; raise RuntimeError when the compiler fails."""
    return cxx.build(Path(src or SRC), "native grammar", BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """The native engine, built on first use; raises when it cannot be
    built or loaded."""
    with _lock:
        so = build()
        lib = _libs.get(so)
        if lib is None:
            try:
                lib = _bind(ctypes.CDLL(str(so)))
            except OSError as e:
                raise RuntimeError(f"native grammar load: {e}") from None
            _libs[so] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.gbnf_new.restype = c.c_void_p
    lib.gbnf_new.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
    lib.gbnf_free.argtypes = [c.c_void_p]
    lib.gbnf_set_vocab.argtypes = [c.c_void_p, c.c_int]
    lib.gbnf_add_token.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_int]
    lib.gbnf_add_eos.argtypes = [c.c_void_p, c.c_int]
    lib.gbnf_initial.restype = c.c_int
    lib.gbnf_initial.argtypes = [c.c_void_p]
    lib.gbnf_advance.restype = c.c_int
    lib.gbnf_advance.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.gbnf_accept_text.restype = c.c_int
    lib.gbnf_accept_text.argtypes = [c.c_void_p, c.c_int, c.c_char_p,
                                     c.c_int]
    lib.gbnf_can_end.restype = c.c_int
    lib.gbnf_can_end.argtypes = [c.c_void_p, c.c_int]
    lib.gbnf_is_dead.restype = c.c_int
    lib.gbnf_is_dead.argtypes = [c.c_void_p, c.c_int]
    lib.gbnf_mask.argtypes = [c.c_void_p, c.c_int,
                              np.ctypeslib.ndpointer(np.uint8)]
    return lib


class NativeGrammarConstraint:
    """Drop-in for GrammarConstraint backed by the C++ engine."""

    def __init__(self, gbnf_text: str, tokenizer) -> None:
        self._lib = load_library()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.gbnf_new(gbnf_text.encode(), err, 256)
        if not self._h:
            raise ValueError(f"gbnf parse error: {err.value.decode()}")
        self.vocab_size = tokenizer.vocab_size
        self._lib.gbnf_set_vocab(self._h, self.vocab_size)
        for tid in range(self.vocab_size):
            try:
                s = tokenizer.decode([tid])
            except (KeyError, IndexError, ValueError,
                    UnicodeDecodeError):
                continue  # special/control token: not grammar text
            if s and "�" not in s:
                b = s.encode("utf-8")
                self._lib.gbnf_add_token(self._h, tid, b, len(b))
        for e in getattr(tokenizer, "eos_ids", ()) or ():
            self._lib.gbnf_add_eos(self._h, int(e))
        self._mask_cache: dict[int, np.ndarray] = {}

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.gbnf_free(h)
            self._h = None

    # --- engine contract (engine/engine.py GenRequest.constraint) ---

    def initial_state(self) -> int:
        return self._lib.gbnf_initial(self._h)

    def advance(self, state: int, token_id: int) -> int:
        return self._lib.gbnf_advance(self._h, state, token_id)

    def next_mask(self, state: int) -> np.ndarray:
        cached = self._mask_cache.get(state)
        if cached is not None:
            return cached
        out = np.zeros(self.vocab_size, np.uint8)
        self._lib.gbnf_mask(self._h, state, out)
        mask = out.astype(bool)
        if len(self._mask_cache) < 4096:
            self._mask_cache[state] = mask
        return mask

    # --- test/introspection helpers mirroring GrammarMatcher ---

    def accept_text(self, state: int, text: str) -> int:
        b = text.encode("utf-8")
        return self._lib.gbnf_accept_text(self._h, state, b, len(b))

    def can_end(self, state: int) -> bool:
        return bool(self._lib.gbnf_can_end(self._h, state))

    def is_dead(self, state: int) -> bool:
        return bool(self._lib.gbnf_is_dead(self._h, state))

    def matches(self, text: str) -> bool:
        st = self.accept_text(self.initial_state(), text)
        return self.can_end(st)


def make_constraint(gbnf_text: str, tokenizer,
                    triggers: Optional[list[str]] = None):
    """Factory: the native engine (a failed build or load raises), or the
    Python engine for a grammar the native parser rejects. ``triggers`` (ref: grpc-server.cpp:2441-2454
    grammar_lazy) gates the grammar behind the first occurrence of a
    trigger word in the generated text."""
    load_library()  # raises: a missing native engine is not silent
    try:
        inner = NativeGrammarConstraint(gbnf_text, tokenizer)
    except (RuntimeError, ValueError):
        inner = None  # a grammar the native parser rejects
    if inner is None:
        from .constrain import GrammarConstraint

        inner = GrammarConstraint.from_gbnf(gbnf_text, tokenizer)
    live = [t for t in (triggers or []) if t]
    if live:
        from .constrain import LazyGrammarConstraint

        return LazyGrammarConstraint(inner, live, tokenizer)
    return inner
