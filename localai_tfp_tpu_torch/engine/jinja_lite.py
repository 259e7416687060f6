"""The Jinja subset that chat templates and LocalAI config templates use,
with no ``jinja2`` package.

``Environment`` renders as one of the two ``jinja2`` environments the JAX
package renders with:

- ``Environment.chat()``: transformers' chat-template environment, an
  ``ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)``
  with loop controls, ``raise_exception``, ``strftime_now`` and a
  ``tojson`` that is ``json.dumps(x, ensure_ascii=False, indent=...,
  separators=..., sort_keys=...)``;
- ``Environment.config()``: the JAX ``Evaluator``'s
  ``Environment(keep_trailing_newline=True)``, whose ``tojson`` is
  jinja2's (sorted keys, ASCII, ``<>&'`` escaped) and which mutates
  freely.

It reads ``{%- -%}``/``{{- -}}``/``+`` whitespace control, comments,
``raw``; ``if``/``elif``/``else``; ``for ... in ... [if ...]`` with
``else``, ``loop.*`` and (chat) ``break``/``continue``; ``set`` (also of a
``namespace()`` attribute, and as a block); ``macro``/``call``; literals,
attribute and item access with jinja2's getattr/getitem fallback,
slicing; ``~``, arithmetic, comparisons, ``in``, ``and``/``or``/``not``,
``x if c else y``; the tests and filters listed in ``TESTS`` and
``FILTERS``; the str/dict/list methods a sandbox allows; jinja2's
``Undefined`` (renders "", is false, raises when used further); and the
sandbox's refusals (``list.append`` and the like raise ``SecurityError``).
A construct it does not read raises ``TemplateSyntaxError`` with the
template line; it never renders differently in silence.
"""

from __future__ import annotations

import json
import re
from collections import abc
from datetime import datetime
from typing import Any, Callable, Optional


class TemplateError(Exception):
    """Any template failure (jinja2's ``TemplateError``)."""


class TemplateSyntaxError(TemplateError):
    def __init__(self, message: str, lineno: int) -> None:
        super().__init__(f"{message} (template line {lineno})")
        self.lineno = lineno


class UndefinedError(TemplateError):
    pass


class SecurityError(TemplateError):
    pass


class TemplateRuntimeError(TemplateError):
    pass


class _Markup(str):
    """A string a filter marked safe (rendered as it is)."""


# ------------------------------------------------------------------ values


class Undefined:
    """jinja2's default ``Undefined``: "" when rendered, false, empty when
    iterated, equal only to another undefined; any other use raises."""

    __slots__ = ("_hint", "_obj", "_name", "_exc")

    def __init__(self, hint: Optional[str] = None, obj: Any = None,
                 name: Optional[str] = None, exc=UndefinedError) -> None:
        self._hint = hint
        self._obj = obj
        self._name = name
        self._exc = exc

    def _message(self) -> str:
        if self._hint is not None:
            return self._hint
        if self._obj is _MISSING:
            return f"{self._name!r} is undefined"
        if not isinstance(self._name, str):
            return f"{_type_repr(self._obj)} has no element {self._name!r}"
        return f"{_type_repr(self._obj)} has no attribute {self._name!r}"

    def _fail(self, *args, **kwargs):
        raise self._exc(self._message())

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = _fail
    __mod__ = __rmod__ = __pos__ = __neg__ = __call__ = __getitem__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __int__ = __float__ = _fail
    __pow__ = __rpow__ = _fail

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        self._fail()

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    def __str__(self) -> str:
        return ""

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "Undefined"


_MISSING = object()


def _type_repr(obj: Any) -> str:
    if obj is None:
        return "None"
    if obj is Ellipsis:
        return "Ellipsis"
    cls = type(obj)
    if cls.__module__ == "builtins":
        return f"'{cls.__name__} object'"
    return f"'{cls.__module__}.{cls.__name__} object'"


class Namespace:
    """``namespace(...)``: the one object a template may assign
    attributes of."""

    def __init__(self, *args, **kwargs) -> None:
        self.__attrs = dict(*args, **kwargs)

    def __getattribute__(self, name: str):
        if name in ("_Namespace__attrs", "__class__"):
            return object.__getattribute__(self, name)
        try:
            return self.__attrs[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self) -> str:
        return f"<Namespace {self.__attrs!r}>"


def _namespace_set(ns: Namespace, name: str, value: Any) -> None:
    object.__getattribute__(ns, "_Namespace__attrs")[name] = value


class _Loop:
    """``loop`` inside a for loop."""

    def __init__(self, items: list) -> None:
        self._items = items
        self.length = len(items)
        self.index0 = -1

    @property
    def index(self) -> int:
        return self.index0 + 1

    @property
    def revindex(self) -> int:
        return self.length - self.index0

    @property
    def revindex0(self) -> int:
        return self.length - self.index0 - 1

    @property
    def first(self) -> bool:
        return self.index0 == 0

    @property
    def last(self) -> bool:
        return self.index0 == self.length - 1

    @property
    def previtem(self):
        if self.index0 == 0:
            return Undefined("there is no previous item")
        return self._items[self.index0 - 1]

    @property
    def nextitem(self):
        if self.index0 + 1 >= self.length:
            return Undefined("there is no next item")
        return self._items[self.index0 + 1]

    def cycle(self, *args):
        if not args:
            raise TypeError("no items for cycling given")
        return args[self.index0 % len(args)]


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


def _soft_str(v: Any) -> str:
    return str(v)


# ------------------------------------------------------------------ lexer

_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+|"
                    r"\.(\d+_)*\d+)", re.I)
_INT = re.compile(r"(\d+_)*\d+")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'"
                     r'|"([^"\\]*(?:\\.[^"\\]*)*)")', re.S)
_OPERATORS = ["//", "**", "==", "!=", ">=", "<=", "+", "-", "/", "*", "%",
              "~", "[", "]", "(", ")", "{", "}", ">", "<", "=", ".", ":",
              "|", ",", ";"]
_WS = re.compile(r"\s+")


class _Tok:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind: str, value: Any, line: int) -> None:
        self.kind = kind  # name, string, int, float, op, end
        self.value = value
        self.line = line

    def __repr__(self) -> str:
        return f"{self.kind}:{self.value!r}"


def _lex(source: str, env: "Environment") -> list:
    """The template as ("data", text, line) and ("var"/"block", tokens,
    line) items, with jinja2's whitespace control applied."""
    source = re.sub(r"\r\n|\r", "\n", source)
    if not env.keep_trailing_newline and source.endswith("\n"):
        source = source[:-1]
    out: list = []
    pos = 0
    n = len(source)
    line = 1
    line_starting = True
    strip_next = False  # a "-" end: strip the whitespace after it
    start_rx = re.compile(r"\{(\{|%|#)(\-|\+|)")
    while pos < n:
        m = start_rx.search(source, pos)
        text_end = m.start() if m else n
        text = source[pos:text_end]
        if strip_next:
            text = text.lstrip()
            strip_next = False
        if m is None:
            if text:
                out.append(("data", text, line))
            break
        kind, sign = m.group(1), m.group(2)
        is_raw = kind == "%" and re.match(r"\s*raw\s*(\-%\}|%\})",
                                          source[m.end():]) is not None
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and env.lstrip_blocks and kind != "{":
            # only whitespace between the line's start and the tag
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and \
                    re.fullmatch(r"\s+", text[l_pos:]):
                text = text[:l_pos]
        if text:
            out.append(("data", text, line))
        line += source.count("\n", pos, m.end())
        pos = m.end()
        if kind == "#":
            e = re.compile(r"(\+#\}|\-#\}\s*|#\}" + ("\n?" if env.trim_blocks
                                                   else "") + ")")
            em = e.search(source, pos)
            if em is None:
                raise TemplateSyntaxError("unexpected end of template: a "
                                          "comment is not closed", line)
            line += source.count("\n", pos, em.end())
            pos = em.end()
            line_starting = source[pos - 1:pos] == "\n"
            continue
        if is_raw:
            rm = re.compile(r"\s*raw\s*(\-%\}\s*|%\})").match(source, pos)
            pos = rm.end()
            em = re.compile(r"\{%(\-|\+|)\s*endraw\s*(\+%\}|\-%\}\s*|%\}"
                            + ("\n?" if env.trim_blocks else "") + ")"
                            ).search(source, pos)
            if em is None:
                raise TemplateSyntaxError("missing endraw", line)
            body = source[pos:em.start()]
            if em.group(1) == "-":
                body = body.rstrip()
            elif em.group(1) != "+" and env.lstrip_blocks:
                l_pos = body.rfind("\n") + 1
                if l_pos > 0 and re.fullmatch(r"\s+", body[l_pos:]):
                    body = body[:l_pos]
            if body:
                out.append(("data", body, line))
            line += source.count("\n", pos, em.end())
            pos = em.end()
            line_starting = source[pos - 1:pos] == "\n"
            continue
        tokens, pos, line, strip_next, trimmed = _lex_tag(
            source, pos, line, kind, env)
        out.append(("var" if kind == "{" else "block", tokens,
                    tokens[0].line if tokens else line))
        line_starting = trimmed or source[pos - 1:pos] == "\n"
    return out


def _lex_tag(source: str, pos: int, line: int, kind: str, env):
    """Tokens of one ``{{ }}`` or ``{% %}`` up to its end delimiter (at
    bracket depth 0): (tokens, position after, line, strip whitespace
    after, ended by a trimmed newline)."""
    tokens: list = []
    depth = 0
    n = len(source)
    end = "}}" if kind == "{" else "%}"
    while True:
        if pos >= n:
            raise TemplateSyntaxError(f"unexpected end of template, expected "
                                      f"'{end}'", line)
        ws = _WS.match(source, pos)
        if ws:
            line += ws.group().count("\n")
            pos = ws.end()
            continue
        if depth == 0:
            if source.startswith("-" + end, pos):
                pos += 3
                return tokens, pos, line, True, False
            if kind == "%" and source.startswith("+%}", pos):
                return tokens, pos + 3, line, False, False
            if source.startswith(end, pos):
                pos += 2
                trimmed = False
                if kind == "%" and env.trim_blocks and \
                        source.startswith("\n", pos):
                    pos += 1
                    line += 1
                    trimmed = True
                return tokens, pos, line, False, trimmed
        m = _NAME.match(source, pos)
        if m:
            tokens.append(_Tok("name", m.group(), line))
            pos = m.end()
            continue
        m = _STRING.match(source, pos)
        if m:
            raw = m.group()[1:-1]
            value = raw.encode("ascii", "backslashreplace").decode(
                "unicode-escape")
            tokens.append(_Tok("string", value, line))
            line += m.group().count("\n")
            pos = m.end()
            continue
        m = _FLOAT.match(source, pos)
        if m:
            tokens.append(_Tok("float", float(m.group().replace("_", "")),
                               line))
            pos = m.end()
            continue
        m = _INT.match(source, pos)
        if m:
            tokens.append(_Tok("int", int(m.group().replace("_", "")), line))
            pos = m.end()
            continue
        for op in _OPERATORS:
            if source.startswith(op, pos):
                if op in "([{":
                    depth += 1
                elif op in ")]}":
                    depth -= 1
                tokens.append(_Tok("op", op, line))
                pos += len(op)
                break
        else:
            raise TemplateSyntaxError(
                f"unexpected char {source[pos]!r}", line)


# ----------------------------------------------------------------- parser


class _Stream:
    def __init__(self, tokens: list, line: int) -> None:
        self.t = tokens
        self.i = 0
        self.line = line

    @property
    def cur(self) -> _Tok:
        if self.i < len(self.t):
            return self.t[self.i]
        return _Tok("end", None, self.t[-1].line if self.t else self.line)

    def peek(self, k: int = 1) -> _Tok:
        j = self.i + k
        return self.t[j] if j < len(self.t) else _Tok("end", None, self.line)

    def next(self) -> _Tok:
        tok = self.cur
        self.i += 1
        return tok

    def is_op(self, op: str) -> bool:
        c = self.cur
        return c.kind == "op" and c.value == op

    def is_name(self, name: str) -> bool:
        c = self.cur
        return c.kind == "name" and c.value == name

    def skip_op(self, op: str) -> bool:
        if self.is_op(op):
            self.i += 1
            return True
        return False

    def skip_name(self, name: str) -> bool:
        if self.is_name(name):
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.skip_op(op):
            self.fail(f"expected '{op}', got {self.cur.value!r}")

    def expect_name(self, name: Optional[str] = None) -> str:
        c = self.cur
        if c.kind != "name" or (name is not None and c.value != name):
            self.fail(f"expected {name or 'a name'}, got {c.value!r}")
        self.i += 1
        return c.value

    def at_end(self) -> bool:
        return self.i >= len(self.t)

    def fail(self, msg: str):
        raise TemplateSyntaxError(msg, self.cur.line)


# expression nodes are tuples: (kind, ...); statement nodes too

_COMPARE = {"==": "eq", "!=": "ne", ">": "gt", ">=": "gteq", "<": "lt",
            "<=": "lteq"}


class _Parser:
    def __init__(self, env: "Environment") -> None:
        self.env = env

    # ---- expressions

    def expr(self, s: _Stream, condexpr: bool = True):
        return self.condexpr(s) if condexpr else self.or_(s)

    def condexpr(self, s: _Stream):
        e = self.or_(s)
        while s.skip_name("if"):
            cond = self.or_(s)
            other = self.condexpr(s) if s.skip_name("else") else None
            e = ("cond", cond, e, other)
        return e

    def or_(self, s):
        e = self.and_(s)
        while s.skip_name("or"):
            e = ("or", e, self.and_(s))
        return e

    def and_(self, s):
        e = self.not_(s)
        while s.skip_name("and"):
            e = ("and", e, self.not_(s))
        return e

    def not_(self, s):
        if s.skip_name("not"):
            return ("not", self.not_(s))
        return self.compare(s)

    def compare(self, s):
        e = self.math1(s)
        ops = []
        while True:
            c = s.cur
            if c.kind == "op" and c.value in _COMPARE:
                s.next()
                ops.append((_COMPARE[c.value], self.math1(s)))
            elif s.skip_name("in"):
                ops.append(("in", self.math1(s)))
            elif s.is_name("not") and s.peek().kind == "name" and \
                    s.peek().value == "in":
                s.next()
                s.next()
                ops.append(("notin", self.math1(s)))
            else:
                break
        return ("compare", e, ops) if ops else e

    def math1(self, s):
        e = self.concat(s)
        while s.cur.kind == "op" and s.cur.value in ("+", "-"):
            op = s.next().value
            e = ("bin", op, e, self.concat(s))
        return e

    def concat(self, s):
        args = [self.math2(s)]
        while s.skip_op("~"):
            args.append(self.math2(s))
        return ("concat", args) if len(args) > 1 else args[0]

    def math2(self, s):
        e = self.pow_(s)
        while s.cur.kind == "op" and s.cur.value in ("*", "/", "//", "%"):
            op = s.next().value
            e = ("bin", op, e, self.pow_(s))
        return e

    def pow_(self, s):
        e = self.unary(s)
        while s.skip_op("**"):
            e = ("bin", "**", e, self.unary(s))
        return e

    def unary(self, s, with_filter: bool = True):
        if s.skip_op("-"):
            e = ("neg", self.unary(s, False))
        elif s.skip_op("+"):
            e = ("pos", self.unary(s, False))
        else:
            e = self.primary(s)
        e = self.postfix(s, e)
        if with_filter:
            e = self.filter_expr(s, e)
        return e

    def primary(self, s):
        c = s.cur
        if c.kind == "name":
            s.next()
            if c.value in ("true", "True"):
                return ("const", True)
            if c.value in ("false", "False"):
                return ("const", False)
            if c.value in ("none", "None"):
                return ("const", None)
            return ("name", c.value, c.line)
        if c.kind == "string":
            s.next()
            buf = [c.value]
            while s.cur.kind == "string":
                buf.append(s.next().value)
            return ("const", "".join(buf))
        if c.kind in ("int", "float"):
            s.next()
            return ("const", c.value)
        if s.skip_op("("):
            e = self.tuple_(s, explicit=True)
            s.expect_op(")")
            return e
        if s.skip_op("["):
            items = []
            while not s.is_op("]"):
                if items:
                    s.expect_op(",")
                    if s.is_op("]"):
                        break
                items.append(self.expr(s))
            s.expect_op("]")
            return ("list", items)
        if s.skip_op("{"):
            items = []
            while not s.is_op("}"):
                if items:
                    s.expect_op(",")
                    if s.is_op("}"):
                        break
                k = self.expr(s)
                s.expect_op(":")
                items.append((k, self.expr(s)))
            s.expect_op("}")
            return ("dict", items)
        s.fail(f"unexpected {c.value!r}")

    def tuple_(self, s, explicit: bool = False, condexpr: bool = True,
               extra_end: tuple = ()):
        items = []
        is_tuple = False
        while True:
            if items:
                s.expect_op(",")
            if self._tuple_end(s, extra_end) or (explicit and s.is_op(")")):
                break
            items.append(self.expr(s, condexpr))
            if s.is_op(","):
                is_tuple = True
            else:
                break
        if not is_tuple:
            if items:
                return items[0]
            if not explicit:
                s.fail("expected an expression")
        return ("tuple", items)

    @staticmethod
    def _tuple_end(s, extra_end) -> bool:
        c = s.cur
        if c.kind == "end":
            return True
        if c.kind == "op" and c.value in (")", "]", "}"):
            return True
        return c.kind == "name" and c.value in extra_end

    def postfix(self, s, e):
        while True:
            if s.skip_op("."):
                c = s.next()
                if c.kind == "name":
                    e = ("getattr", e, c.value)
                elif c.kind == "int":
                    e = ("getitem", e, ("const", c.value))
                else:
                    s.fail("expected a name or a number after '.'")
            elif s.skip_op("["):
                args = []
                while not s.is_op("]"):
                    if args:
                        s.expect_op(",")
                    args.append(self.subscribed(s))
                s.expect_op("]")
                arg = args[0] if len(args) == 1 else ("tuple", args)
                e = ("getitem", e, arg)
            elif s.is_op("("):
                e = self.call(s, e)
            else:
                return e

    def subscribed(self, s):
        parts: list = []
        if s.is_op(":"):
            parts.append(None)
        else:
            node = self.expr(s)
            if not s.is_op(":"):
                return node
            parts.append(node)
        s.expect_op(":")
        if s.is_op("]") or s.is_op(","):
            parts.append(None)
        elif s.is_op(":"):
            parts.append(None)
        else:
            parts.append(self.expr(s))
        if s.skip_op(":"):
            if s.is_op("]") or s.is_op(","):
                parts.append(None)
            else:
                parts.append(self.expr(s))
        else:
            parts.append(None)
        return ("slice", *parts)

    def filter_expr(self, s, e):
        while True:
            if s.is_op("|"):
                e = self.filter_(s, e)
            elif s.is_name("is"):
                e = self.test(s, e)
            elif s.is_op("("):
                e = self.call(s, e)
            else:
                return e

    def filter_(self, s, e):
        while s.is_op("|"):
            s.next()
            tok = s.cur
            name = s.expect_name()
            while s.skip_op("."):
                name += "." + s.expect_name()
            if name not in self.env.filters:
                raise TemplateSyntaxError(f"No filter named {name!r}.",
                                          tok.line)
            args, kwargs = self.call_args(s) if s.is_op("(") else ([], [])
            e = ("filter", name, e, args, kwargs, tok.line)
        return e

    def test(self, s, e):
        s.next()  # is
        negated = s.skip_name("not")
        tok = s.cur
        name = s.expect_name()
        if name not in TESTS:
            raise TemplateSyntaxError(f"No test named {name!r}.", tok.line)
        args, kwargs = [], []
        if s.is_op("("):
            args, kwargs = self.call_args(s)
        elif (s.cur.kind in ("name", "string", "int", "float")
              or (s.cur.kind == "op" and s.cur.value in ("(", "[", "{"))) \
                and not (s.cur.kind == "name" and s.cur.value in (
                    "else", "or", "and")):
            if s.is_name("is"):
                s.fail("You cannot chain multiple tests with is")
            args = [self.postfix(s, self.primary(s))]
        e = ("test", name, e, args, kwargs, tok.line)
        return ("not", e) if negated else e

    def call(self, s, e):
        args, kwargs = self.call_args(s)
        return ("call", e, args, kwargs, s.cur.line)

    def call_args(self, s):
        s.expect_op("(")
        args, kwargs = [], []
        while not s.is_op(")"):
            if args or kwargs:
                s.expect_op(",")
                if s.is_op(")"):
                    break
            if s.is_op("*") or s.is_op("**"):
                s.fail("*args and **kwargs in calls are not supported")
            if s.cur.kind == "name" and s.peek().kind == "op" and \
                    s.peek().value == "=":
                key = s.next().value
                s.next()
                kwargs.append((key, self.expr(s)))
            else:
                if kwargs:
                    s.fail("a positional argument after a keyword one")
                args.append(self.expr(s))
        s.expect_op(")")
        return args, kwargs

    def assign_target(self, s, extra_end=(), namespace: bool = False):
        """A for or set target: a name, a tuple of names, or (``set``)
        a ``ns.attr``."""
        names = []
        while True:
            tok = s.cur
            name = s.expect_name()
            if namespace and s.skip_op("."):
                attr = s.expect_name()
                names.append(("nsattr", name, attr, tok.line))
            else:
                names.append(("name", name, tok.line))
            if not s.skip_op(","):
                break
            if self._tuple_end(s, extra_end):
                break
        return names[0] if len(names) == 1 else ("tuple", names)

    # ---- statements

    def parse(self, items: list) -> list:
        self.items = items
        self.pos = 0
        self.end_stack: list[tuple] = []  # the end tags each body awaits
        self.tag_stack: list[str] = []  # the open block statements
        return self.subparse(())

    def _fail_tag(self, name: Optional[str], line: int):
        """jinja2's message for an unknown tag (``name``) or the end of
        the template (``None``)."""
        expected = {t for tags in self.end_stack for t in tags}
        looking = (" or ".join(repr(t) for t in self.end_stack[-1])
                   if self.end_stack else None)
        msg = ["Unexpected end of template." if name is None
               else f"Encountered unknown tag {name!r}."]
        if looking:
            if name is not None and name in expected:
                msg.append("You probably made a nesting mistake. Jinja is "
                           "expecting this tag, but currently looking for "
                           f"{looking}.")
            else:
                msg.append(f"Jinja was looking for the following tags: "
                           f"{looking}.")
        if self.tag_stack:
            msg.append(f"The innermost block that needs to be closed is "
                       f"{self.tag_stack[-1]!r}.")
        raise TemplateSyntaxError(" ".join(msg), line)

    def subparse(self, end_tags: tuple) -> list:
        if end_tags:
            self.end_stack.append(end_tags)
        body: list = []
        while self.pos < len(self.items):
            kind, payload, line = self.items[self.pos]
            if kind == "data":
                body.append(("output", ("const", payload)))
                self.pos += 1
                continue
            s = _Stream(payload, line)
            if kind == "var":
                e = self.tuple_(s)
                if not s.at_end():
                    s.fail(f"expected the end of the print statement, got "
                           f"{s.cur.value!r}")
                body.append(("output", e))
                self.pos += 1
                continue
            if not payload or payload[0].kind != "name":
                raise TemplateSyntaxError("tag name expected", line)
            name = payload[0].value
            if name in end_tags:
                self.end_stack.pop()
                return body
            self.pos += 1
            s.next()
            fn = getattr(self, f"stmt_{name}", None)
            if name in ("break", "continue") and not self.env.loopcontrols:
                fn = None
            if name == "generation" and not self.env.generation_tag:
                fn = None
            if fn is None:
                self._fail_tag(name, line)
            self.tag_stack.append(name)
            body.append(fn(s))
            self.tag_stack.pop()
        if end_tags:
            self._fail_tag(None, self.items[-1][2] if self.items else 1)
        return body

    def _end_of_tag(self, s: _Stream) -> None:
        if not s.at_end():
            s.fail(f"expected the end of the statement block, got "
                   f"{s.cur.value!r}")

    def _take_end(self, names: tuple) -> tuple:
        """Consume the block tag that ended a body: (its name, the rest
        of its tokens)."""
        kind, payload, line = self.items[self.pos]
        s = _Stream(payload, line)
        name = s.next().value
        self.pos += 1
        return name, s

    def stmt_if(self, s):
        branches = []
        cond = self.tuple_(s, condexpr=False)
        self._end_of_tag(s)
        while True:
            body = self.subparse(("elif", "else", "endif"))
            branches.append((cond, body))
            name, s2 = self._take_end(())
            if name == "elif":
                cond = self.tuple_(s2, condexpr=False)
                self._end_of_tag(s2)
                continue
            if name == "else":
                self._end_of_tag(s2)
                else_body = self.subparse(("endif",))
                _, s3 = self._take_end(())
                self._end_of_tag(s3)
                return ("if", branches, else_body)
            self._end_of_tag(s2)
            return ("if", branches, [])

    def stmt_for(self, s):
        line = s.cur.line
        target = self.assign_target(s, extra_end=("in",))
        s.expect_name("in")
        it = self.tuple_(s, condexpr=False, extra_end=("recursive", "if"))
        cond = None
        if s.skip_name("if"):
            cond = self.expr(s)
        if s.is_name("recursive"):
            s.fail("recursive for loops are not supported")
        self._end_of_tag(s)
        body = self.subparse(("endfor", "else"))
        name, s2 = self._take_end(())
        self._end_of_tag(s2)
        else_body = []
        if name == "else":
            else_body = self.subparse(("endfor",))
            _, s3 = self._take_end(())
            self._end_of_tag(s3)
        return ("for", target, it, cond, body, else_body, line)

    def stmt_set(self, s):
        line = s.cur.line
        target = self.assign_target(s, namespace=True)
        if s.skip_op("="):
            value = self.tuple_(s)
            self._end_of_tag(s)
            return ("set", target, value, line)
        if s.is_op("|"):
            s.fail("filtered block sets are not supported")
        self._end_of_tag(s)
        body = self.subparse(("endset",))
        _, s2 = self._take_end(())
        self._end_of_tag(s2)
        return ("setblock", target, body, line)

    def stmt_macro(self, s):
        name = s.expect_name()
        params, defaults = self._signature(s)
        self._end_of_tag(s)
        body = self.subparse(("endmacro",))
        _, s2 = self._take_end(())
        if not s2.at_end():
            s2.expect_name(name)
        self._end_of_tag(s2)
        return ("macro", name, params, defaults, body)

    def _signature(self, s):
        params, defaults = [], {}
        s.expect_op("(")
        while not s.is_op(")"):
            if params:
                s.expect_op(",")
            p = s.expect_name()
            if s.skip_op("="):
                defaults[p] = self.expr(s)
            elif defaults:
                s.fail("a parameter without a default after one with it")
            params.append(p)
        s.expect_op(")")
        return params, defaults

    def stmt_call(self, s):
        params, defaults = ([], {})
        if s.is_op("("):
            params, defaults = self._signature(s)
        call = self.expr(s)
        if call[0] != "call":
            s.fail("expected a call")
        self._end_of_tag(s)
        body = self.subparse(("endcall",))
        _, s2 = self._take_end(())
        self._end_of_tag(s2)
        return ("callblock", call, params, defaults, body)

    def stmt_break(self, s):
        self._end_of_tag(s)
        return ("break",)

    def stmt_continue(self, s):
        self._end_of_tag(s)
        return ("continue",)

    def stmt_generation(self, s):
        self._end_of_tag(s)
        body = self.subparse(("endgeneration",))
        _, s2 = self._take_end(())
        self._end_of_tag(s2)
        return ("block", body)


# ---------------------------------------------------------------- runtime


class _Frame:
    """One scope: its own names, and the frame it reads through to."""

    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Frame"] = None,
                 values: Optional[dict] = None) -> None:
        self.vars = values if values is not None else {}
        self.parent = parent

    def get(self, name: str):
        f = self
        while f is not None:
            if name in f.vars:
                return f.vars[name]
            f = f.parent
        return _MISSING


class _Macro:
    def __init__(self, renderer: "_Renderer", name: str, params: list,
                 defaults: dict, body: list, frame: _Frame,
                 caller: Any = None) -> None:
        self.r = renderer
        self.name = name
        self.params = params
        self.defaults = defaults
        self.body = body
        self.frame = frame
        self.caller = caller

    def __call__(self, *args, **kwargs):
        if len(args) > len(self.params):
            raise TypeError(f"macro {self.name!r} takes not more than "
                            f"{len(self.params)} argument(s)")
        values: dict = {}
        for p, a in zip(self.params, args):
            values[p] = a
        caller = kwargs.pop("caller", self.caller)
        for k, v in kwargs.items():
            if k not in self.params:
                raise TypeError(f"macro {self.name!r} takes no keyword "
                                f"argument {k!r}")
            values[k] = v
        frame = _Frame(self.frame, values)
        for p in self.params:
            if p not in values:
                values[p] = (self.r.eval(self.defaults[p], frame)
                             if p in self.defaults else
                             Undefined(f"parameter {p!r} was not provided"))
        if caller is not None:
            values["caller"] = caller
        out: list[str] = []
        self.r.run(self.body, frame, out)
        return _Markup("".join(out))


def _is_safe_attribute(obj: Any, attr: str, sandboxed: bool,
                       immutable: bool) -> bool:
    if attr.startswith("_"):
        return False
    if sandboxed and immutable:
        for cls, names in (
                (abc.MutableSet, {"clear", "pop", "remove", "update",
                                  "difference_update", "add", "discard",
                                  "symmetric_difference_update"}),
                (abc.MutableMapping, {"clear", "setdefault", "pop",
                                      "update", "popitem"}),
                (abc.MutableSequence, {"clear", "append", "pop", "extend",
                                       "remove", "insert", "sort",
                                       "reverse"})):
            if isinstance(obj, cls) and attr in names:
                return False
    return True


class _Renderer:
    def __init__(self, env: "Environment") -> None:
        self.env = env

    # ---- attribute and item access

    def getattr(self, obj: Any, name: str):
        if isinstance(obj, Undefined):
            obj._fail()
        if isinstance(obj, str) and name in ("format", "format_map"):
            raise TemplateError("str.format in a template is not supported")
        try:
            value = getattr(obj, name)
        except AttributeError:
            try:
                return obj[name]
            except (TypeError, LookupError):
                return Undefined(obj=obj, name=name)
        if not _is_safe_attribute(obj, name, self.env.sandboxed,
                                  self.env.immutable):
            if name.startswith("_") and not self.env.sandboxed:
                raise TemplateError(f"access to attribute {name!r} is not "
                                    "supported")
            return Undefined(
                f"access to attribute {name!r} of "
                f"{type(obj).__name__!r} object is unsafe.",
                exc=SecurityError)
        return value

    def getitem(self, obj: Any, key: Any):
        if isinstance(obj, Undefined):
            obj._fail()
        try:
            return obj[key]
        except (TypeError, LookupError):
            if isinstance(key, str):
                try:
                    value = getattr(obj, key)
                except AttributeError:
                    pass
                else:
                    if not _is_safe_attribute(obj, key, self.env.sandboxed,
                                              self.env.immutable):
                        return Undefined(
                            f"access to attribute {key!r} of "
                            f"{type(obj).__name__!r} object is unsafe.",
                            exc=SecurityError)
                    return value
        return Undefined(obj=obj, name=key)

    # ---- expressions

    def eval(self, node, frame: _Frame):
        kind = node[0]
        if kind == "const":
            return node[1]
        if kind == "name":
            v = frame.get(node[1])
            if v is _MISSING:
                v = self.env.globals.get(node[1], _MISSING)
            if v is _MISSING:
                return Undefined(obj=_MISSING, name=node[1])
            return v
        if kind == "getattr":
            return self.getattr(self.eval(node[1], frame), node[2])
        if kind == "getitem":
            obj = self.eval(node[1], frame)
            key = node[2]
            if key[0] == "slice":
                if isinstance(obj, Undefined):
                    obj._fail()
                parts = [None if p is None else self.eval(p, frame)
                         for p in key[1:]]
                return obj[slice(*parts)]
            return self.getitem(obj, self.eval(key, frame))
        if kind == "list":
            return [self.eval(x, frame) for x in node[1]]
        if kind == "tuple":
            return tuple(self.eval(x, frame) for x in node[1])
        if kind == "dict":
            return {self.eval(k, frame): self.eval(v, frame)
                    for k, v in node[1]}
        if kind == "cond":
            if self.eval(node[1], frame):
                return self.eval(node[2], frame)
            if node[3] is None:
                return Undefined("the inline if-expression on line "
                                 "evaluated to false and no else section "
                                 "was defined.")
            return self.eval(node[3], frame)
        if kind == "or":
            a = self.eval(node[1], frame)
            return a if a else self.eval(node[2], frame)
        if kind == "and":
            a = self.eval(node[1], frame)
            return self.eval(node[2], frame) if a else a
        if kind == "not":
            return not self.eval(node[1], frame)
        if kind == "neg":
            return -self.eval(node[1], frame)
        if kind == "pos":
            return +self.eval(node[1], frame)
        if kind == "concat":
            return "".join(_soft_str(self.eval(x, frame)) for x in node[1])
        if kind == "bin":
            a = self.eval(node[2], frame)
            b = self.eval(node[3], frame)
            op = node[1]
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a / b
            if op == "//":
                return a // b
            if op == "%":
                return a % b
            return a ** b
        if kind == "compare":
            left = self.eval(node[1], frame)
            for op, rnode in node[2]:
                right = self.eval(rnode, frame)
                if not _compare(op, left, right):
                    return False
                left = right
            return True
        if kind == "filter":
            _, name, arg, args, kwargs, line = node
            value = self.eval(arg, frame)
            a = [self.eval(x, frame) for x in args]
            kw = {k: self.eval(v, frame) for k, v in kwargs}
            return self.env.filters[name](self, value, *a, **kw)
        if kind == "test":
            _, name, arg, args, kwargs, line = node
            value = self.eval(arg, frame)
            a = [self.eval(x, frame) for x in args]
            kw = {k: self.eval(v, frame) for k, v in kwargs}
            return TESTS[name](self, value, *a, **kw)
        if kind == "call":
            fn = self.eval(node[1], frame)
            a = [self.eval(x, frame) for x in node[2]]
            kw = {k: self.eval(v, frame) for k, v in node[3]}
            if isinstance(fn, Undefined):
                fn._fail()
            return fn(*a, **kw)
        raise TemplateError(f"cannot evaluate {kind}")

    # ---- statements

    def run(self, body: list, frame: _Frame, out: list) -> None:
        for node in body:
            kind = node[0]
            if kind == "output":
                v = self.eval(node[1], frame)
                out.append(self.env.finalize(v))
            elif kind == "if":
                for cond, branch in node[1]:
                    if self.eval(cond, frame):
                        self.run(branch, frame, out)
                        break
                else:
                    self.run(node[2], frame, out)
            elif kind == "for":
                self.run_for(node, frame, out)
            elif kind == "set":
                self.assign(node[1], self.eval(node[2], frame), frame)
            elif kind == "setblock":
                buf: list[str] = []
                self.run(node[2], frame, buf)
                self.assign(node[1], _Markup("".join(buf)), frame)
            elif kind == "macro":
                frame.vars[node[1]] = _Macro(self, node[1], node[2], node[3],
                                             node[4], frame)
            elif kind == "callblock":
                _, call, params, defaults, body2 = node
                caller = _Macro(self, "caller", params, defaults, body2,
                                frame)
                fn = self.eval(call[1], frame)
                a = [self.eval(x, frame) for x in call[2]]
                kw = {k: self.eval(v, frame) for k, v in call[3]}
                if isinstance(fn, _Macro):
                    out.append(str(fn(*a, caller=caller, **kw)))
                else:
                    raise TemplateError("call blocks call macros only")
            elif kind == "block":
                self.run(node[1], frame, out)
            elif kind == "break":
                raise _Break()
            elif kind == "continue":
                raise _Continue()

    def assign(self, target, value, frame: _Frame) -> None:
        if target[0] == "name":
            frame.vars[target[1]] = value
        elif target[0] == "nsattr":
            ns = self.eval(("name", target[1], target[3]), frame)
            if not isinstance(ns, Namespace):
                raise TemplateRuntimeError(
                    "cannot assign attribute on non-namespace object")
            _namespace_set(ns, target[2], value)
        else:
            names = target[1]
            values = list(value)
            if len(values) != len(names):
                raise ValueError(f"expected {len(names)} values to unpack, "
                                 f"got {len(values)}")
            for t, v in zip(names, values):
                self.assign(t, v, frame)

    def run_for(self, node, frame: _Frame, out: list) -> None:
        _, target, it, cond, body, else_body, line = node
        seq = self.eval(it, frame)
        items = list(seq) if not isinstance(seq, Undefined) else []
        if cond is not None:
            kept = []
            for x in items:
                f = _Frame(frame)
                self.assign(target, x, f)
                if self.eval(cond, f):
                    kept.append(x)
            items = kept
        loop = _Loop(items)
        for x in items:
            loop.index0 += 1
            f = _Frame(frame, {"loop": loop})
            self.assign(target, x, f)
            try:
                self.run(body, f, out)
            except _Continue:
                continue
            except _Break:
                break
        if not items:
            self.run(else_body, _Frame(frame), out)


def _compare(op: str, a: Any, b: Any) -> bool:
    if op == "eq":
        return a == b
    if op == "ne":
        return a != b
    if op == "gt":
        return a > b
    if op == "gteq":
        return a >= b
    if op == "lt":
        return a < b
    if op == "lteq":
        return a <= b
    if op == "in":
        return a in b
    return a not in b


# ---------------------------------------------------------------- filters


def _f_trim(r, value, chars=None):
    return _soft_str(value).strip(chars)


def _f_length(r, value):
    return len(value)


def _f_default(r, value, default_value="", boolean=False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def _f_first(r, seq):
    try:
        return next(iter(seq))
    except StopIteration:
        return Undefined("No first item, sequence was empty.")


def _f_last(r, seq):
    try:
        return next(iter(reversed(seq)))
    except StopIteration:
        return Undefined("No last item, sequence was empty.")


def _attrgetter(r, attribute):
    parts = ([attribute] if not isinstance(attribute, str) else
             [int(p) if p.isdigit() else p for p in attribute.split(".")])

    def get(item):
        for p in parts:
            item = r.getitem(item, p)
        return item
    return get


def _f_join(r, value, d="", attribute=None):
    if attribute is not None:
        value = map(_attrgetter(r, attribute), value)
    return _soft_str(d).join(map(_soft_str, value))


def _f_items(r, value):
    if isinstance(value, Undefined):
        return iter(())
    if not isinstance(value, abc.Mapping):
        raise TypeError("Can only get item pairs from a mapping.")
    return iter(value.items())


def _f_int(r, value, default=0, base=10):
    try:
        if isinstance(value, str):
            return int(value, base)
        return int(value)
    except (TypeError, ValueError):
        try:
            return int(float(value))
        except (TypeError, ValueError):
            return default


def _f_replace(r, s, old, new, count=None):
    return str(s).replace(str(old), str(new), -1 if count is None else count)


def _select(r, seq, args, kwargs, attr: bool, keep: bool):
    args = list(args)
    get = (lambda x: x)
    if attr:
        if not args:
            raise TypeError("Missing parameter for attribute name")
        get = _attrgetter(r, args.pop(0))
    if args:
        name = args.pop(0)
        if name not in TESTS:
            raise TemplateError(f"No test named {name!r}.")
        test = TESTS[name]

        def check(x):
            return test(r, get(x), *args, **kwargs)
    else:
        def check(x):
            return bool(get(x))
    return (x for x in seq if check(x) == keep)


def _f_map(r, seq, *args, **kwargs):
    if "attribute" in kwargs:
        get = _attrgetter(r, kwargs.pop("attribute"))
        default = kwargs.pop("default", None)
        if kwargs:
            raise TypeError(f"Unexpected keyword argument "
                            f"{next(iter(kwargs))!r}")

        def fn(x):
            v = get(x)
            return default if default is not None and \
                isinstance(v, Undefined) else v
        return map(fn, seq)
    if not args:
        raise TypeError("map requires a filter argument")
    name, rest = args[0], args[1:]
    if name not in r.env.filters:
        raise TemplateError(f"No filter named {name!r}.")
    f = r.env.filters[name]
    return (f(r, x, *rest, **kwargs) for x in seq)


def _tojson_chat(r, x, ensure_ascii=False, indent=None, separators=None,
                 sort_keys=False):
    return json.dumps(_plain(x), ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _tojson_html(r, x, indent=None):
    s = json.dumps(_plain(x), sort_keys=True, indent=indent)
    return _Markup(s.replace("<", "\\u003c").replace(">", "\\u003e")
                   .replace("&", "\\u0026").replace("'", "\\u0027"))


def _plain(x):
    """Generators a filter chain made (``items``, ``map``) are not JSON;
    jinja2 fails on them too, so only Undefined is refused here."""
    if isinstance(x, Undefined):
        raise TypeError("Object of type Undefined is not JSON serializable")
    return x


FILTERS: dict[str, Callable] = {
    "trim": _f_trim,
    "length": _f_length, "count": _f_length,
    "upper": lambda r, s: _soft_str(s).upper(),
    "lower": lambda r, s: _soft_str(s).lower(),
    "capitalize": lambda r, s: _soft_str(s).capitalize(),
    "title": lambda r, s: _soft_str(s).title(),
    "default": _f_default, "d": _f_default,
    "first": _f_first, "last": _f_last,
    "join": _f_join,
    "items": _f_items,
    "list": lambda r, v: list(v),
    "string": lambda r, v: _soft_str(v),
    "int": _f_int,
    "float": lambda r, v, default=0.0: _to_float(v, default),
    "abs": lambda r, v: abs(v),
    "replace": _f_replace,
    "select": lambda r, seq, *a, **k: _select(r, seq, a, k, False, True),
    "reject": lambda r, seq, *a, **k: _select(r, seq, a, k, False, False),
    "selectattr": lambda r, seq, *a, **k: _select(r, seq, a, k, True, True),
    "rejectattr": lambda r, seq, *a, **k: _select(r, seq, a, k, True, False),
    "map": _f_map,
    "safe": lambda r, v: _Markup(v),
    "reverse": lambda r, v: (v[::-1] if isinstance(v, str)
                             else list(reversed(v))),
}


def _to_float(v, default):
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


# ------------------------------------------------------------------ tests


def _t_sequence(r, v):
    try:
        len(v)
        v.__getitem__  # noqa: B018
    except Exception:
        return False
    return True


def _t_iterable(r, v):
    try:
        iter(v)
    except TypeError:
        return False
    return True


TESTS: dict[str, Callable] = {
    "defined": lambda r, v: not isinstance(v, Undefined),
    "undefined": lambda r, v: isinstance(v, Undefined),
    "none": lambda r, v: v is None,
    "string": lambda r, v: isinstance(v, str),
    "mapping": lambda r, v: isinstance(v, abc.Mapping),
    "iterable": _t_iterable,
    "sequence": _t_sequence,
    "number": lambda r, v: isinstance(v, (int, float, complex)),
    "integer": lambda r, v: isinstance(v, int) and v is not True
    and v is not False,
    "float": lambda r, v: isinstance(v, float),
    "boolean": lambda r, v: v is True or v is False,
    "true": lambda r, v: v is True,
    "false": lambda r, v: v is False,
    "odd": lambda r, v: v % 2 == 1,
    "even": lambda r, v: v % 2 == 0,
    "divisibleby": lambda r, v, n: v % n == 0,
    "eq": lambda r, a, b: a == b, "equalto": lambda r, a, b: a == b,
    "==": lambda r, a, b: a == b,
    "ne": lambda r, a, b: a != b, "!=": lambda r, a, b: a != b,
    "lt": lambda r, a, b: a < b, "<": lambda r, a, b: a < b,
    "le": lambda r, a, b: a <= b, "<=": lambda r, a, b: a <= b,
    "gt": lambda r, a, b: a > b, ">": lambda r, a, b: a > b,
    "ge": lambda r, a, b: a >= b, ">=": lambda r, a, b: a >= b,
    "in": lambda r, a, b: a in b,
    "callable": lambda r, v: callable(v),
}


# ------------------------------------------------------------ environment


def _raise_exception(message):
    raise TemplateError(message)


def _strftime_now(fmt):
    return datetime.now().strftime(fmt)


def _safe_range(*args):
    rng = range(*args)
    if len(rng) > 100000:
        raise OverflowError("Range too big. The sandbox blocks ranges larger "
                            "than MAX_RANGE (100000).")
    return rng


class Template:
    def __init__(self, env: "Environment", source: str) -> None:
        self.env = env
        self.body = _Parser(env).parse(_lex(source, env))

    def render(self, **context) -> str:
        r = _Renderer(self.env)
        out: list[str] = []
        frame = _Frame(None, dict(context))
        try:
            r.run(self.body, frame, out)
        except (_Break, _Continue):
            raise TemplateError("break or continue outside a loop") from None
        return "".join(out)


class Environment:
    """One rendering environment (see the module docstring)."""

    def __init__(self, *, trim_blocks: bool = False,
                 lstrip_blocks: bool = False,
                 keep_trailing_newline: bool = False,
                 sandboxed: bool = False, immutable: bool = False,
                 loopcontrols: bool = False,
                 generation_tag: bool = False) -> None:
        self.trim_blocks = trim_blocks
        self.lstrip_blocks = lstrip_blocks
        self.keep_trailing_newline = keep_trailing_newline
        self.sandboxed = sandboxed
        self.immutable = immutable
        self.loopcontrols = loopcontrols
        self.generation_tag = generation_tag
        self.filters = dict(FILTERS)
        self.filters["tojson"] = _tojson_html
        self.globals: dict[str, Any] = {
            "range": _safe_range if sandboxed else range,
            "dict": dict,
            "namespace": Namespace,
        }
        self._cache: dict[str, Template] = {}

    @classmethod
    def chat(cls) -> "Environment":
        """transformers' chat-template environment."""
        env = cls(trim_blocks=True, lstrip_blocks=True, sandboxed=True,
                  immutable=True, loopcontrols=True, generation_tag=True)
        env.filters["tojson"] = _tojson_chat
        env.globals["raise_exception"] = _raise_exception
        env.globals["strftime_now"] = _strftime_now
        return env

    @classmethod
    def config(cls) -> "Environment":
        """The JAX Evaluator's environment for config templates."""
        env = cls(keep_trailing_newline=True)
        env.globals["raise_exception"] = _raise_exception
        return env

    @staticmethod
    def finalize(value: Any) -> str:
        return _soft_str(value)

    def from_string(self, source: str) -> Template:
        tpl = self._cache.get(source)
        if tpl is None:
            tpl = Template(self, source)
            self._cache[source] = tpl
        return tpl
