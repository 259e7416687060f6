"""Grammar-constrained decoding: per-step token masks for the device
sampler (the port's own copy of localai_tfp_tpu/grammars/constrain.py).

The reference constrains generation by handing llama.cpp a GBNF grammar that
its sampler consults per candidate token (ref: pkg/functions builds the
grammar; grpc-server.cpp:2441-2454 plumbs grammar triggers). Here the
sampler runs on the device, so the constraint is realized as a boolean
vocab mask computed host-side by a pushdown automaton and shipped with the
decode dispatch (SURVEY.md §7 hard part #3: host mask computation
overlapped with the device step).

Mask computation walks a byte-trie of the vocabulary against the grammar's
"set of stacks" state: a trie subtree is pruned the moment a prefix char is
rejected, so the cost per step is proportional to the *feasible* frontier,
not the vocab size. States are cached by (state, char) in the matcher.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .gbnf import Grammar, GrammarMatcher, MatchState, parse_gbnf


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self) -> None:
        self.children: dict[str, _TrieNode] = {}
        self.token_ids: list[int] = []


def _build_trie(token_strs: list[Optional[str]]) -> _TrieNode:
    root = _TrieNode()
    for tid, s in enumerate(token_strs):
        if not s:
            continue
        node = root
        for ch in s:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = node.children[ch] = _TrieNode()
            node = nxt
        node.token_ids.append(tid)
    return root


class GrammarConstraint:
    """Constrains decoding to strings of a GBNF grammar.

    Engine contract (engine/engine.py GenRequest.constraint):
    - ``initial_state()`` → opaque state
    - ``next_mask(state)`` → np.bool_[vocab] of admissible next tokens
    - ``advance(state, token_id)`` → next state
    EOS is admitted iff the grammar can terminate at the current state.
    """

    def __init__(self, grammar: Grammar, tokenizer) -> None:
        self.matcher = GrammarMatcher(grammar)
        self.tokenizer = tokenizer
        self.vocab_size = tokenizer.vocab_size
        self.eos_ids = set(getattr(tokenizer, "eos_ids", ()) or ())
        self._token_strs: list[Optional[str]] = [None] * self.vocab_size
        for tid in range(self.vocab_size):
            try:
                s = tokenizer.decode([tid])
            except (KeyError, IndexError, ValueError,
                    UnicodeDecodeError):
                s = None  # special/control token: not grammar text
            # control/special tokens (decode to empty or replacement char)
            # are never part of grammar text
            if s and "�" not in s:
                self._token_strs[tid] = s
        self._trie = _build_trie(self._token_strs)
        self._mask_cache: dict[MatchState, np.ndarray] = {}

    @classmethod
    def from_gbnf(cls, text: str, tokenizer) -> "GrammarConstraint":
        return cls(parse_gbnf(text), tokenizer)

    def initial_state(self) -> MatchState:
        return self.matcher.initial_state()

    def advance(self, state: MatchState, token_id: int) -> MatchState:
        s = self._token_strs[token_id]
        if s is None:
            return state  # eos / special token: state unchanged (terminal)
        return self.matcher.accept_string(state, s)

    def accept_text(self, state: MatchState, text: str) -> MatchState:
        """Feed raw text (symmetric with NativeGrammarConstraint)."""
        return self.matcher.accept_string(state, text)

    def next_mask(self, state: MatchState) -> np.ndarray:
        cached = self._mask_cache.get(state)
        if cached is not None:
            return cached
        mask = np.zeros(self.vocab_size, dtype=bool)
        # iterative DFS over the vocab trie, pruning rejected prefixes
        stack = [(self._trie, state)]
        while stack:
            node, st = stack.pop()
            for tid in node.token_ids:
                mask[tid] = True
            for ch, child in node.children.items():
                nst = self.matcher.accept_char(st, ch)
                if nst:
                    stack.append((child, nst))
        if self.matcher.can_end(state):
            for e in self.eos_ids:
                mask[e] = True
        if len(self._mask_cache) < 4096:
            self._mask_cache[state] = mask
        return mask


class LazyGrammarConstraint:
    """Trigger-gated grammar (ref: grpc-server.cpp:2441-2454 grammar_lazy
    + grammar_triggers; pkg/functions/parse.go:51 `triggers:` yaml).

    The grammar stays DORMANT — generation unconstrained — until one of
    the trigger words appears in the generated text; from the trigger
    boundary on, the inner grammar constrains decoding, and the text
    from the trigger onward (trigger word included, llama.cpp
    semantics) is fed to it. This is how text-then-tool-call models
    work: prose preamble free-form, `<function=...` onward constrained.

    Wraps any constraint implementing the engine contract
    (initial_state/next_mask/advance) plus a ``tokenizer`` attribute.
    State: ("d", tail) while dormant, ("a", inner_state) once active.
    """

    def __init__(self, inner, triggers: list[str], tokenizer) -> None:
        self.triggers = [t for t in triggers if t]
        assert self.triggers, (
            "use the inner constraint when there are no triggers")
        self.inner = inner
        self.tokenizer = tokenizer
        self.vocab_size = inner.vocab_size
        self._max_trig = max(len(t) for t in self.triggers)
        self._free = np.ones(self.vocab_size, dtype=bool)
        # callers (engine logit_bias path) must not corrupt the shared
        # dormant mask in place — they copy before mutating, and this
        # flag turns any violation into a loud error
        self._free.setflags(write=False)
        strs = getattr(inner, "_token_strs", None)
        if strs is not None:  # reuse the inner table: a 128k-vocab
            # decode loop is seconds of first-request latency
            self._token_strs = strs
        else:
            self._token_strs = [None] * self.vocab_size
            for tid in range(self.vocab_size):
                try:
                    s = tokenizer.decode([tid])
                except (KeyError, IndexError, ValueError,
                        UnicodeDecodeError):
                    continue  # special/control token: not grammar text
                if s and "�" not in s:
                    self._token_strs[tid] = s

    def initial_state(self):
        return ("d", "")

    def next_mask(self, state) -> np.ndarray:
        kind, st = state
        if kind == "d":
            return self._free
        return self.inner.next_mask(st)

    def advance(self, state, token_id: int):
        kind, st = state
        if kind == "a":
            return ("a", self.inner.advance(st, token_id))
        s = self._token_strs[token_id] if token_id < self.vocab_size else None
        if not s:
            return state
        tail = st + s
        # a trigger fully inside the OLD tail would have fired then, so
        # scanning the whole (bounded) tail is idempotent-safe
        hit = min((p for p in (tail.find(t) for t in self.triggers)
                   if p >= 0), default=-1)
        if hit >= 0:
            # grammar receives the trigger word and everything after it
            return ("a", self.inner.accept_text(
                self.inner.initial_state(), tail[hit:]))
        # bound the rolling tail: a trigger can straddle token
        # boundaries, so keep max_trigger-1 chars of lookbehind
        return ("d", tail[-(self._max_trig - 1):] if self._max_trig > 1
                else "")


class JSONConstraint(GrammarConstraint):
    """Constrain output to (schema-conforming) JSON — the device-side realization of
    the reference's response_format json_schema → BNF path
    (ref: core/http/endpoints/openai/chat.go:216-246)."""

    def __init__(self, tokenizer, schema: Optional[dict] = None) -> None:
        from .json_schema import schema_to_gbnf

        super().__init__(parse_gbnf(schema_to_gbnf(schema)), tokenizer)
