"""GBNF grammar parser + incremental byte-level recognizer (the port's own
copy of localai_tfp_tpu/grammars/gbnf.py).

Capability counterpart of llama.cpp's grammar engine that the reference
relies on for constrained decoding (ref: pkg/functions/grammars/*.go emits
GBNF; the C++ side consumes it via llama.cpp's `llama_grammar` — vendored,
not in the reference tree). This is a clean-room implementation:

- `parse_gbnf` turns GBNF text into rules of alternates of symbols
  (literal bytes, char classes, rule refs); `*`/`+`/`?` repetitions are
  rewritten into auxiliary recursive rules, mirroring how GBNF defines them.
- `GrammarMatcher` is a pushdown recognizer: a match state is a frozenset of
  stacks (tuples of pending symbols); `accept_char` advances every stack.
  This matches llama.cpp's "set of stacks" representation, which handles the
  nondeterminism of alternates without backtracking.

The matcher is intentionally transport-free: grammars/constrain.py builds
per-step token masks from it for the decode loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union


@dataclass(frozen=True)
class Lit:
    ch: str  # exactly one unicode char


@dataclass(frozen=True)
class CharClass:
    ranges: tuple[tuple[str, str], ...]  # inclusive (lo, hi) pairs
    negated: bool = False

    def matches(self, ch: str) -> bool:
        hit = any(lo <= ch <= hi for lo, hi in self.ranges)
        return (not hit) if self.negated else hit


@dataclass(frozen=True)
class Ref:
    name: str


Symbol = Union[Lit, CharClass, Ref]
Alternate = tuple[Symbol, ...]


class Grammar:
    def __init__(self, rules: dict[str, list[Alternate]], root: str = "root"):
        if root not in rules:
            raise ValueError(f"grammar has no '{root}' rule")
        self.rules = rules
        self.root = root


class GBNFError(ValueError):
    pass


class _Parser:
    def __init__(self, text: str) -> None:
        self.text = text
        self.i = 0
        self.rules: dict[str, list[Alternate]] = {}
        self.aux = 0

    # --- lexing helpers ---

    def _ws(self, newlines: bool = True) -> None:
        while self.i < len(self.text):
            c = self.text[self.i]
            if c == "#":  # comment to EOL
                while self.i < len(self.text) and self.text[self.i] != "\n":
                    self.i += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.i += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.i] if self.i < len(self.text) else ""

    def _name(self) -> str:
        j = self.i
        while j < len(self.text) and (
            self.text[j].isalnum() or self.text[j] in "-_"
        ):
            j += 1
        if j == self.i:
            raise GBNFError(f"expected name at {self.i}")
        name, self.i = self.text[self.i:j], j
        return name

    def _escaped_char(self) -> str:
        c = self.text[self.i]
        self.i += 1
        if c != "\\":
            return c
        e = self.text[self.i]
        self.i += 1
        table = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
                 "/": "/", "'": "'", "[": "[", "]": "]"}
        if e in table:
            return table[e]
        if e == "x":
            h = self.text[self.i:self.i + 2]
            self.i += 2
            return chr(int(h, 16))
        if e == "u":
            h = self.text[self.i:self.i + 4]
            self.i += 4
            return chr(int(h, 16))
        if e == "U":
            h = self.text[self.i:self.i + 8]
            self.i += 8
            return chr(int(h, 16))
        raise GBNFError(f"bad escape \\{e}")

    # --- grammar parsing ---

    def parse(self) -> Grammar:
        self._ws()
        while self.i < len(self.text):
            name = self._name()
            self._ws()
            if self.text[self.i:self.i + 3] == "::=":
                self.i += 3
            else:
                raise GBNFError(f"expected '::=' after rule '{name}'")
            alts = self._alternates(name)
            if name in self.rules:
                self.rules[name].extend(alts)
            else:
                self.rules[name] = alts
            self._ws()
        return Grammar(self.rules)

    def _alternates(self, rulename: str) -> list[Alternate]:
        alts = [self._sequence(rulename)]
        self._ws(newlines=False)
        while self._peek() == "|":
            self.i += 1
            alts.append(self._sequence(rulename))
            self._ws(newlines=False)
        return alts

    def _sequence(self, rulename: str) -> Alternate:
        seq: list[Symbol] = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == "" or c in "|)\n":
                break
            sym = self._symbol(rulename)
            self._ws(newlines=False)
            c = self._peek()
            if c and c in "*+?{":
                sym = self._apply_repeat(rulename, sym, c)
            seq.append(sym)
        return tuple(seq)

    def _symbol(self, rulename: str) -> Symbol:
        c = self._peek()
        if c == '"':
            self.i += 1
            chars: list[str] = []
            while self._peek() != '"':
                if self.i >= len(self.text):
                    raise GBNFError("unterminated string literal")
                chars.append(self._escaped_char())
            self.i += 1
            if len(chars) == 1:
                return Lit(chars[0])
            # multi-char literal becomes an aux rule of single chars
            name = self._aux_name(rulename)
            self.rules[name] = [tuple(Lit(ch) for ch in chars)]
            return Ref(name)
        if c == "[":
            self.i += 1
            negated = False
            if self._peek() == "^":
                negated = True
                self.i += 1
            ranges: list[tuple[str, str]] = []
            while self._peek() != "]":
                if self.i >= len(self.text):
                    raise GBNFError("unterminated char class")
                lo = self._escaped_char()
                hi = lo
                if self._peek() == "-" and self.text[self.i + 1] != "]":
                    self.i += 1
                    hi = self._escaped_char()
                ranges.append((lo, hi))
            self.i += 1
            return CharClass(tuple(ranges), negated)
        if c == "(":
            self.i += 1
            name = self._aux_name(rulename)
            # placeholder so recursive refs resolve
            self.rules[name] = []
            alts = self._alternates(name)
            self._ws()
            if self._peek() != ")":
                raise GBNFError("expected ')'")
            self.i += 1
            self.rules[name] = alts
            return Ref(name)
        if c == ".":
            self.i += 1
            return CharClass((("\x00", "\U0010ffff"),), False)
        return Ref(self._name())

    def _apply_repeat(self, rulename: str, sym: Symbol, op: str) -> Symbol:
        self.i += 1
        if op == "{":  # {m}, {m,}, {m,n}
            j = self.text.index("}", self.i)
            body = self.text[self.i:j]
            self.i = j + 1
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s) if lo_s.strip() else 0
                hi = int(hi_s) if hi_s.strip() else None
            else:
                lo = hi = int(body)
            return self._bounded(rulename, sym, lo, hi)
        if op == "?":
            name = self._aux_name(rulename)
            self.rules[name] = [(sym,), ()]
            return Ref(name)
        if op == "*":
            name = self._aux_name(rulename)
            self.rules[name] = [(sym, Ref(name)), ()]
            return Ref(name)
        # op == "+"
        name = self._aux_name(rulename)
        star = self._aux_name(rulename)
        self.rules[star] = [(sym, Ref(star)), ()]
        self.rules[name] = [(sym, Ref(star))]
        return Ref(name)

    def _bounded(self, rulename: str, sym: Symbol, lo: int,
                 hi: Optional[int]) -> Symbol:
        name = self._aux_name(rulename)
        if hi is None:
            star = self._aux_name(rulename)
            self.rules[star] = [(sym, Ref(star)), ()]
            self.rules[name] = [tuple([sym] * lo) + (Ref(star),)]
        else:
            alts = [tuple([sym] * n) for n in range(lo, hi + 1)]
            self.rules[name] = alts or [()]
        return Ref(name)

    def _aux_name(self, rulename: str) -> str:
        self.aux += 1
        return f"{rulename}-aux{self.aux}"


def parse_gbnf(text: str) -> Grammar:
    return _Parser(text).parse()


# ---------------------------------------------------------------------------
# pushdown recognizer
# ---------------------------------------------------------------------------

Stack = tuple[Symbol, ...]  # symbols still to match; stack[0] is the top
MatchState = frozenset  # of Stack


class GrammarMatcher:
    """Incremental recognizer over unicode chars (one char at a time)."""

    def __init__(self, grammar: Grammar) -> None:
        self.grammar = grammar
        self._accept_cache: dict[tuple[MatchState, str], MatchState] = {}

    def initial_state(self) -> MatchState:
        stacks: set[Stack] = set()
        for alt in self.grammar.rules[self.grammar.root]:
            self._expand(tuple(alt), stacks, set())
        return frozenset(stacks)

    def _expand(self, stack: Stack, out: set[Stack],
                seen: set[Stack]) -> None:
        """Expand leading Refs until the top is a terminal (or empty)."""
        if stack in seen:
            return
        seen.add(stack)
        if not stack or isinstance(stack[0], (Lit, CharClass)):
            out.add(stack)
            return
        ref = stack[0]
        for alt in self.grammar.rules[ref.name]:
            self._expand(tuple(alt) + stack[1:], out, seen)

    def accept_char(self, state: MatchState, ch: str) -> MatchState:
        key = (state, ch)
        hit = self._accept_cache.get(key)
        if hit is not None:
            return hit
        nxt: set[Stack] = set()
        seen: set[Stack] = set()
        for stack in state:
            if not stack:
                continue
            top = stack[0]
            ok = top.ch == ch if isinstance(top, Lit) else top.matches(ch)
            if ok:
                self._expand(stack[1:], nxt, seen)
        res = frozenset(nxt)
        self._accept_cache[key] = res
        return res

    def accept_string(self, state: MatchState, s: str) -> MatchState:
        for ch in s:
            if not state:
                return state
            state = self.accept_char(state, ch)
        return state

    @staticmethod
    def is_dead(state: MatchState) -> bool:
        return len(state) == 0

    @staticmethod
    def can_end(state: MatchState) -> bool:
        return any(len(stack) == 0 for stack in state)

    def matches(self, text: str) -> bool:
        st = self.accept_string(self.initial_state(), text)
        return self.can_end(st)
