"""A reader for the YAML that model configs use, with no ``yaml`` package.

``load_all(text)`` gives what ``yaml.safe_load_all`` gives for the
constructs LocalAI model YAMLs are written in:

- block mappings and sequences (a sequence may sit at its key's column);
- plain, single-quoted and double-quoted scalars (with the escapes), each
  folded over lines as YAML folds them;
- block scalars ``|`` and ``>`` with ``-``/``+`` chomping and an
  indentation indicator;
- flow ``[...]`` and ``{...}`` collections, over lines too;
- comments, ``---`` / ``...`` documents, anchors, aliases and ``<<``
  merge keys.

Plain scalars resolve by PyYAML's YAML 1.1 rules: ``yes``/``no``/``on``/
``off`` are bools, ``1e-5`` (no dot) is a string, ``0x1F`` and ``017``
(octal) are ints, ``~`` and an empty value are ``None``, and a date is a
``datetime.date``. The YAML 1.1 standard scalar tags that ``safe_load``
resolves, ``!!str``, ``!!int``, ``!!float``, ``!!bool`` and ``!!null``,
construct their scalar as PyYAML's ``SafeConstructor`` does (``!!str 5``
is ``"5"``). Anything else (other tags, a tag on a collection, complex
``?`` keys, directives, an anchor before a key, ...) raises
``ValueError`` with the file and line: a construct this reader does not
read never gives a value.
"""

from __future__ import annotations

import datetime
import re
from typing import Any, Optional

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
    -(?P<month>[0-9][0-9]?)
    -(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)
    (?P<hour>[0-9][0-9]?)
    :(?P<minute>[0-9][0-9])
    :(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
# a date alone, or a date and time (the resolver's shape; the constructor
# above reads the parts)
_TIMESTAMP_RESOLVE = re.compile(
    r"^(?:[0-9]{4}-[0-9][0-9]-[0-9][0-9]|[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_FLOW_IND = ",[]{}"
# characters a plain scalar may not start with (``-?:`` may, before a
# non-space)
_NO_PLAIN_START = "-?:,[]{}#&*!|>'\"%@`"
_MERGE = object()  # the key ``<<``
# the standard scalar tags read (``!!name``), and ``!!bool``'s values
_TAGS = ("str", "int", "float", "bool", "null")
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
# what PyYAML's reader refuses, plus the line breaks it knows beyond \n
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\xA0-\u2027\u202A-\uD7FF\uE000-\uFFFD"
    "\U00010000-\U0010FFFF]")


def load_all(text: str, name: str = "<yaml>") -> list:
    """Every document of ``text``, as ``yaml.safe_load_all`` reads it."""
    return _Reader(text, name).documents()


def resolve_plain(s: str) -> Any:
    """A plain scalar's value by the YAML 1.1 rules of PyYAML's
    resolver and ``SafeConstructor``."""
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _NULL.match(s):
        return None
    if _FLOAT.match(s):
        return _float(s)
    if _INT.match(s):
        return _int(s)
    if _TIMESTAMP_RESOLVE.match(s):
        return _timestamp(s)
    if s == "=":
        raise ValueError("the value key '=' has no constructor")
    return s


def _int(s: str) -> int:
    v = s.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        out = 0
        for part in v.split(":"):
            out = out * 60 + int(part)
        return sign * out
    return sign * int(v)


def _float(s: str) -> float:
    v = s.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        out = 0.0
        for part in v.split(":"):
            out = out * 60 + float(part)
        return sign * out
    return sign * float(v)


def _timestamp(s: str):
    m = _TIMESTAMP.match(s)
    g = m.groupdict()
    year, month, day = int(g["year"]), int(g["month"]), int(g["day"])
    if not g["hour"]:
        return datetime.date(year, month, day)
    frac = 0
    if g["fraction"]:
        frac = int(g["fraction"][:6].ljust(6, "0"))
    tz = None
    if g["tz_sign"]:
        delta = datetime.timedelta(hours=int(g["tz_hour"]),
                                   minutes=int(g["tz_minute"] or 0))
        tz = datetime.timezone(-delta if g["tz_sign"] == "-" else delta)
    elif g["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(g["hour"]),
                             int(g["minute"]), int(g["second"]), frac,
                             tzinfo=tz)


def _is_marker(line: str) -> bool:
    return line[:3] in ("---", "...") and (len(line) == 3
                                           or line[3] in " \t")


class _Reader:
    def __init__(self, text: str, name: str) -> None:
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        if bad:
            line = text.count("\n", 0, bad.start()) + 1
            raise ValueError(f"{name}:{line}: unacceptable character "
                             f"{bad.group()!r} (line breaks other than "
                             "\\n and non-printable characters are not "
                             "read)")
        self.lines = text.split("\n")
        self.name = name
        self.i = 0
        self.anchors: dict[str, Any] = {}

    # ---- positions: (line, column); the last line has no line break

    def err(self, msg: str, i: Optional[int] = None):
        line = (self.i if i is None else i) + 1
        raise ValueError(f"{self.name}:{line}: {msg}")

    def peek(self, i: int, c: int) -> str:
        line = self.lines[i]
        if c < len(line):
            return line[c]
        return "\n" if i < len(self.lines) - 1 else "\0"

    @staticmethod
    def indent_of(line: str) -> int:
        return len(line) - len(line.lstrip(" "))

    def blank(self, i: int) -> bool:
        s = self.lines[i].strip(" ")
        return s == "" or s.startswith("#")

    def skip_blank(self) -> None:
        while self.i < len(self.lines) and self.blank(self.i):
            self.i += 1

    def eof(self) -> bool:
        return self.i >= len(self.lines)

    def at_marker(self) -> bool:
        return not self.eof() and _is_marker(self.lines[self.i])

    def content_indent(self) -> int:
        line = self.lines[self.i]
        n = self.indent_of(line)
        if n < len(line) and line[n] == "\t":
            self.err("a tab in indentation")
        return n

    # ---- documents

    def documents(self) -> list:
        docs: list = []
        while True:
            self.skip_blank()
            if self.eof():
                return docs
            line = self.lines[self.i]
            if line.startswith("%"):
                self.err("directives are not supported")
            if line[:3] == "..." and _is_marker(line):
                self.err("document end marker without a document")
            if line[:3] == "---" and _is_marker(line):
                rest = line[3:].lstrip(" \t")
                if rest and not rest.startswith("#"):
                    value = self.inline(self.i, len(line) - len(rest), -1,
                                        False)
                else:
                    self.i += 1
                    value = self.node(-1)
            else:
                value = self.node(-1)
            docs.append(value)
            self.anchors = {}
            self.skip_blank()
            if self.eof():
                return docs
            line = self.lines[self.i]
            if line[:3] == "..." and _is_marker(line):
                self.i += 1
                if line[3:].strip(" \t") and not \
                        line[3:].strip(" \t").startswith("#"):
                    self.err("content after a document end marker")
                continue
            if not (line[:3] == "---" and _is_marker(line)):
                self.err("expected the end of the document")

    # ---- block structure

    def node(self, parent: int, seq_at_parent: bool = False) -> Any:
        """The node on the next content line, when it is indented past
        ``parent`` (or is a sequence at ``parent``'s column and
        ``seq_at_parent``); else ``None`` (an empty value)."""
        self.skip_blank()
        if self.eof() or self.at_marker():
            return None
        ind = self.content_indent()
        if ind > parent:
            return self.block(ind, parent)
        if seq_at_parent and ind == parent and self.is_seq(self.i, ind):
            return self.seq(ind)
        return None

    def is_seq(self, i: int, c: int) -> bool:
        line = self.lines[i]
        return line[c:c + 1] == "-" and (len(line) == c + 1
                                         or line[c + 1] in " \t")

    def block(self, col: int, parent: int) -> Any:
        if self.is_seq(self.i, col):
            return self.seq(col)
        if self.key_at(self.i, col) is not None:
            return self.mapping(col)
        return self.inline(self.i, col, parent, False)

    def seq(self, col: int) -> list:
        items: list = []
        while True:
            line = self.lines[self.i]
            c = col + 1
            while c < len(line) and line[c] == " ":
                c += 1
            if c >= len(line) or line[c] == "#":
                self.i += 1
                items.append(self.node(col))
            else:
                # the entry's content is a node at its own column
                self.lines[self.i] = " " * c + line[c:]
                items.append(self.block(c, col))
            self.skip_blank()
            if self.eof() or self.at_marker():
                return items
            ind = self.content_indent()
            if ind < col:
                return items
            if ind > col:
                self.err("bad indentation of a sequence entry")
            if not self.is_seq(self.i, col):
                return items  # the key after a sequence at its column

    def mapping(self, col: int) -> dict:
        pairs: list = []
        merges: list = []
        while True:
            k = self.key_at(self.i, col)
            if k is None:
                self.err("expected a mapping key")
            key, vcol = k
            value = self.inline(self.i, vcol, col, True)
            if key is _MERGE:
                merges.append(value)
            else:
                pairs.append((key, value))
            self.skip_blank()
            if self.eof() or self.at_marker():
                break
            ind = self.content_indent()
            if ind < col:
                break
            if ind > col:
                self.err("bad indentation of a mapping entry")
        return self.build_mapping(pairs, merges)

    def build_mapping(self, pairs: list, merges: list) -> dict:
        merged: list = []
        for m in merges:
            subs = m if isinstance(m, list) else [m]
            for sub in reversed(subs):
                if not isinstance(sub, dict):
                    self.err("a merge key takes a mapping or a list of "
                             "mappings")
                merged.extend(sub.items())
        out: dict = {}
        for key, value in merged + pairs:
            try:
                out[key] = value
            except TypeError:
                self.err(f"unhashable mapping key {key!r}")
        return out

    def key_at(self, i: int, c: int):
        """(key, value column) when line ``i`` holds a simple key at
        column ``c``; else None."""
        line = self.lines[i]
        ch = line[c:c + 1]
        nxt = line[c + 1:c + 2]
        if ch == "?" and nxt in ("", " ", "\t"):
            self.err("complex mapping keys ('? ') are not supported", i)
        if ch == "" or (ch in _NO_PLAIN_START and ch not in "\"'" and not (
                ch in "-?:" and nxt not in ("", " ", "\t"))):
            return None  # a node, not a key (or an error inline() names)
        if ch in "\"'":
            value, j, e = self.quoted(i, c)
            if j != i:
                return None
            while e < len(line) and line[e] == " ":
                e += 1
            if line[e:e + 1] == ":" and line[e + 1:e + 2] in ("", " ", "\t"):
                return value, self.after_colon(line, e)
            return None
        e = c
        while e < len(line):
            if line[e] == "#" and e > c and line[e - 1] == " ":
                return None
            if line[e] == "\t":
                self.err("a tab outside a quoted or block scalar", i)
            if line[e] == ":" and line[e + 1:e + 2] in ("", " ", "\t"):
                text = line[c:e].rstrip(" \t")
                if text == "<<":
                    return _MERGE, self.after_colon(line, e)
                return self.resolve(text, i), self.after_colon(line, e)
            e += 1
        return None

    def resolve(self, text: str, i: int) -> Any:
        try:
            return resolve_plain(text)
        except ValueError as e:
            self.err(str(e), i)

    @staticmethod
    def after_colon(line: str, e: int) -> int:
        e += 1
        while e < len(line) and line[e] == " ":
            e += 1
        return e

    def rest_is_empty(self, i: int, c: int) -> None:
        rest = self.lines[i][c:].lstrip(" ")
        if rest.startswith("\t"):
            self.err("a tab outside a quoted or block scalar", i)
        if rest and not rest.startswith("#"):
            self.err(f"unexpected {rest[:20]!r} after a value", i)

    def inline(self, i: int, c: int, parent: int, map_value: bool) -> Any:
        """The node that starts at column ``c`` of line ``i``, inside a
        block collection at column ``parent``; leaves ``self.i`` on the
        first line after it."""
        self.i = i
        line = self.lines[i]
        rest = line[c:]
        if rest == "" or rest.startswith("#"):
            self.i = i + 1
            return self.node(parent, seq_at_parent=map_value)
        ch = rest[0]
        if ch == "\t":
            self.err("a tab outside a quoted or block scalar", i)
        if ch == "&":
            name, e = self.anchor_name(i, c + 1)
            while e < len(line) and line[e] == " ":
                e += 1
            value = self.inline(i, e, parent, map_value)
            self.anchors[name] = value
            return value
        if ch == "*":
            name, e = self.anchor_name(i, c + 1)
            if name not in self.anchors:
                self.err(f"undefined alias *{name}", i)
            self.rest_is_empty(i, e)
            self.i = i + 1
            return self.anchors[name]
        if ch == "!":
            return self.tagged(i, c, parent, map_value)
        if ch in "|>":
            return self.block_scalar(i, c, parent)
        if ch in "[{":
            value, j, e = self.flow(i, c)
            self.rest_is_empty(j, e)
            self.i = j + 1
            return value
        if ch in "\"'":
            value, j, e = self.quoted(i, c)
            self.rest_is_empty(j, e)
            self.i = j + 1
            return value
        return self.resolve(self.plain_text(i, c, parent), i)

    def plain_text(self, i: int, c: int, parent: int) -> str:
        """The unresolved text of the block plain scalar at column ``c``
        of line ``i``; leaves ``self.i`` on the first line after it."""
        ch, nxt = self.lines[i][c], self.lines[i][c + 1:c + 2]
        if ch in _NO_PLAIN_START and not (
                ch in "-?:" and nxt not in ("", " ", "\t")):
            if ch == "-":
                self.err("a sequence entry is not allowed here", i)
            self.err(f"a plain scalar cannot start with {ch!r}", i)
        text, j, e, stop = self.plain(i, c, parent + 1, False)
        if stop == ":":
            self.err("mapping values are not allowed here", j)
        if stop == "next":
            self.i = j  # the first line the scalar does not continue to
        else:
            self.rest_is_empty(j, e)
            self.i = j + 1
        return text

    # ---- tags

    def tag_at(self, i: int, c: int) -> tuple[str, int]:
        """The standard tag at column ``c`` of line ``i``: (its name,
        the column after it). Any other tag raises."""
        line = self.lines[i]
        e = c
        while e < len(line) and line[e] not in " \t":
            e += 1
        tag = line[c:e]
        if not tag.startswith("!!") or tag[2:] not in _TAGS:
            self.err(f"tags other than {', '.join('!!' + t for t in _TAGS)}"
                     f" are not supported ({tag!r})", i)
        return tag[2:], e

    def construct(self, tag: str, text: str, i: int) -> Any:
        """A tagged scalar's value, as ``SafeConstructor`` builds it."""
        try:
            if tag == "str":
                return text
            if tag == "null":
                return None
            if tag == "bool":
                return _BOOL_VALUES[text.lower()]
            if tag == "int":
                return _int(text)
            return _float(text)
        except (KeyError, ValueError, IndexError):
            self.err(f"!!{tag} cannot construct {text!r}", i)

    def tagged(self, i: int, c: int, parent: int, map_value: bool) -> Any:
        """A tagged block node: the tag, then a scalar on its line (or
        nothing: the empty scalar)."""
        tag, e = self.tag_at(i, c)
        line = self.lines[i]
        while e < len(line) and line[e] == " ":
            e += 1
        rest = line[e:]
        if rest == "" or rest.startswith("#"):
            self.i = i + 1
            if self.node(parent, seq_at_parent=map_value) is not None:
                self.err("a tag on a node of later lines is not supported",
                         i)
            text = ""
        elif rest[0] in "\"'":
            text, j, e = self.quoted(i, e)
            self.rest_is_empty(j, e)
            self.i = j + 1
        elif rest[0] in "|>":
            text = self.block_scalar(i, e, parent)
        elif rest[0] in "[{&*!":
            self.err("a tag on a collection, an anchor or an alias is not "
                     "supported", i)
        else:
            text = self.plain_text(i, e, parent)
        return self.construct(tag, text, i)

    def anchor_name(self, i: int, c: int) -> tuple[str, int]:
        """An anchor's or alias's name (PyYAML's: letters, digits, '-'
        and '_', then a space or an indicator)."""
        line = self.lines[i]
        e = c
        while e < len(line) and (line[e].isascii() and line[e].isalnum()
                                 or line[e] in "-_"):
            e += 1
        if e == c or self.peek(i, e) not in "\0 \t\n?:,]}%@`":
            self.err("an anchor or alias needs a name of letters, digits, "
                     "'-' or '_'", i)
        return line[c:e], e

    # ---- scalars

    def plain(self, i: int, c: int, indent: int, flow: bool):
        """PyYAML's ``scan_plain``: (text, line, column, stop) where stop
        is ':' (a value indicator follows), '#', 'next' (ended at a line
        the scalar does not continue to) or '' (ended mid-line)."""
        chunks: list[str] = []
        spaces: list[str] = []
        stop = ""
        while True:
            if self.peek(i, c) == "#":
                stop = "#"
                break
            n = 0
            while True:
                ch = self.peek(i, c + n)
                nx = self.peek(i, c + n + 1)
                if ch in "\0 \t\n" or (
                        ch == ":" and nx in "\0 \t\n" + (_FLOW_IND if flow
                                                         else "")) or (
                        flow and ch in ",?[]{}"):
                    break
                n += 1
            if n == 0:
                stop = ":" if self.peek(i, c) == ":" else stop
                break
            chunks.extend(spaces)
            chunks.append(self.lines[i][c:c + n])
            c += n
            spaces, i2, c2 = self.plain_spaces(i, c)
            moved = i2 != i
            i, c = i2, c2
            if not spaces or self.peek(i, c) == "#" or (
                    not flow and c < indent):
                if moved:
                    stop = "next"
                elif self.peek(i, c) in "#:":
                    stop = self.peek(i, c)
                break
        return "".join(chunks), i, c, stop

    def plain_spaces(self, i: int, c: int):
        line = self.lines[i]
        n = c
        while n < len(line) and line[n] == " ":
            n += 1
        ws = line[c:n]
        ch = self.peek(i, n)
        if ch != "\n":
            return ([ws] if ws else []), i, n
        breaks: list[str] = []
        j = i + 1
        while True:
            if _is_marker(self.lines[j]):
                return [], j, 0
            s = self.lines[j]
            k = self.indent_of(s)
            if k == len(s) and j < len(self.lines) - 1:
                breaks.append("\n")
                j += 1
                continue
            break
        return (breaks if breaks else [" "]), j, k

    def quoted(self, i: int, c: int):
        """A single- or double-quoted scalar from column ``c`` of line
        ``i``: (value, line, column after the closing quote)."""
        q = self.lines[i][c]
        double = q == '"'
        c += 1
        chunks: list[str] = []
        while True:
            line = self.lines[i]
            # non-spaces
            while True:
                n = c
                while n < len(line) and line[n] not in "'\"\\ \t":
                    n += 1
                chunks.append(line[c:n])
                c = n
                ch = self.peek(i, c)
                if not double and ch == "'" and self.peek(i, c + 1) == "'":
                    chunks.append("'")
                    c += 2
                elif (double and ch == "'") or (not double and ch in '"\\'):
                    chunks.append(ch)
                    c += 1
                elif double and ch == "\\":
                    e = self.peek(i, c + 1)
                    if e in _ESCAPES:
                        chunks.append(_ESCAPES[e])
                        c += 2
                    elif e in _ESCAPE_CODES:
                        n = _ESCAPE_CODES[e]
                        code = line[c + 2:c + 2 + n]
                        if len(code) != n or any(
                                d not in "0123456789abcdefABCDEF"
                                for d in code):
                            self.err(f"bad escape \\{e}{code}", i)
                        chunks.append(chr(int(code, 16)))
                        c += 2 + n
                    elif e == "\n":
                        i, c, br = self.quoted_breaks(i + 1)
                        line = self.lines[i]
                        chunks.extend(br)
                    else:
                        self.err(f"unknown escape \\{e}", i)
                else:
                    break
            ch = self.peek(i, c)
            if ch == q:
                return "".join(chunks), i, c + 1
            # spaces
            n = c
            while n < len(line) and line[n] in " \t":
                n += 1
            ws = line[c:n]
            c = n
            ch = self.peek(i, c)
            if ch == "\0":
                self.err("unterminated quoted scalar", i)
            if ch == "\n":
                i, c, br = self.quoted_breaks(i + 1)
                chunks.extend(br if br else [" "])
            else:
                chunks.append(ws)

    def quoted_breaks(self, j: int):
        breaks: list[str] = []
        while True:
            if j >= len(self.lines):
                self.err("unterminated quoted scalar", j - 1)
            s = self.lines[j]
            if _is_marker(s):
                self.err("a document marker inside a quoted scalar", j)
            k = len(s) - len(s.lstrip(" \t"))
            if k == len(s) and j < len(self.lines) - 1:
                breaks.append("\n")
                j += 1
                continue
            return j, k, breaks

    def block_scalar(self, i: int, c: int, parent: int) -> str:
        """``|`` or ``>`` with its indicators, as PyYAML's
        ``scan_block_scalar`` reads it."""
        line = self.lines[i]
        folded = line[c] == ">"
        e = c + 1
        chomp: Optional[bool] = None  # None: clip, False: strip, True: keep
        incr: Optional[int] = None
        for _ in range(2):
            ch = line[e:e + 1]
            if ch in ("+", "-") and ch != "" and chomp is None:
                chomp = ch == "+"
                e += 1
            elif ch.isdigit() and ch != "" and incr is None:
                if ch == "0":
                    self.err("an indentation indicator of 0", i)
                incr = int(ch)
                e += 1
        self.rest_is_empty(i, e)
        min_indent = max(parent + 1, 1)
        last = len(self.lines) - 1
        k = i + 1
        breaks: list[str] = []
        if incr is None:
            max_indent = 0
            while k <= last:
                s = self.lines[k]
                n = self.indent_of(s)
                if n == len(s) and k < last:
                    max_indent = max(max_indent, n)
                    breaks.append("\n")
                    k += 1
                    continue
                max_indent = max(max_indent, n)
                break
            indent = max(min_indent, max_indent)
            if k <= last and self.indent_of(self.lines[k]) < indent and \
                    self.lines[k].strip(" "):
                if self.indent_of(self.lines[k]) >= min_indent:
                    self.err("a leading blank line of a block scalar is "
                             "indented past its text", k)
        else:
            indent = min_indent + incr - 1
            k, breaks = self.block_breaks(k, indent)
        chunks: list[str] = []
        line_break = ""
        while self.block_line_at(k, indent):
            chunks.extend(breaks)
            s = self.lines[k]
            leading_non_space = s[indent:indent + 1] not in (" ", "\t")
            chunks.append(s[indent:])
            line_break = "\n" if k < last else ""
            k, breaks = self.block_breaks(k + 1, indent)
            if self.block_line_at(k, indent):
                s2 = self.lines[k]
                if folded and line_break == "\n" and leading_non_space \
                        and s2[indent:indent + 1] not in (" ", "\t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomp is not False:
            chunks.append(line_break)
        if chomp is True:
            chunks.extend(breaks)
        self.i = k
        return "".join(chunks)

    def block_line_at(self, k: int, indent: int) -> bool:
        """Line ``k`` reaches column ``indent`` with a character there."""
        if k > len(self.lines) - 1:
            return False
        s = self.lines[k]
        return self.indent_of(s) >= indent and len(s) > indent

    def block_breaks(self, k: int, indent: int):
        breaks: list[str] = []
        last = len(self.lines) - 1
        while k < last:
            s = self.lines[k]
            if self.indent_of(s) == len(s) and len(s) <= indent:
                breaks.append("\n")
                k += 1
            else:
                break
        return k, breaks

    # ---- flow collections

    def skip_flow_space(self, i: int, c: int) -> tuple[int, int]:
        while True:
            ch = self.peek(i, c)
            if ch == " ":
                c += 1
            elif ch == "\t":
                self.err("a tab outside a quoted or block scalar", i)
            elif ch == "#" and (c == 0 or self.lines[i][c - 1] == " "):
                c = len(self.lines[i])
            elif ch == "\n":
                i, c = i + 1, 0
                if _is_marker(self.lines[i]):
                    self.err("a document marker inside a flow collection",
                             i)
            elif ch == "\0":
                self.err("unterminated flow collection", i)
            else:
                return i, c

    def flow(self, i: int, c: int):
        """A ``[...]`` or ``{...}`` collection: (value, line, column
        after its closing bracket)."""
        opening = self.lines[i][c]
        closing = "]" if opening == "[" else "}"
        c += 1
        if opening == "[":
            items: list = []
            while True:
                i, c = self.skip_flow_space(i, c)
                if self.peek(i, c) == "]":
                    return items, i, c + 1
                value, i, c = self.flow_node(i, c)
                items.append(value)
                i, c = self.skip_flow_space(i, c)
                ch = self.peek(i, c)
                if ch == ":":
                    self.err("single-pair mappings in a flow sequence are "
                             "not supported", i)
                if ch == ",":
                    c += 1
                elif ch != closing:
                    self.err(f"expected ',' or ']' in a flow sequence, "
                             f"found {ch!r}", i)
        pairs: list = []
        merges: list = []
        while True:
            i, c = self.skip_flow_space(i, c)
            ch = self.peek(i, c)
            if ch == "}":
                return self.build_mapping(pairs, merges), i, c + 1
            if ch == "?" and self.peek(i, c + 1) in " \t\n":
                self.err("complex mapping keys ('? ') are not supported", i)
            key_line = i
            key, i, c = self.flow_node(i, c, key=True)
            i, c = self.skip_flow_space(i, c)
            value = None
            if self.peek(i, c) == ":":
                if i != key_line:
                    self.err("a flow mapping key spans lines", i)
                i, c = self.skip_flow_space(i, c + 1)
                if self.peek(i, c) not in ",}":
                    value, i, c = self.flow_node(i, c)
                    i, c = self.skip_flow_space(i, c)
            if key is _MERGE:
                merges.append(value)
            else:
                pairs.append((key, value))
            ch = self.peek(i, c)
            if ch == ",":
                c += 1
            elif ch != "}":
                self.err(f"expected ',' or '}}' in a flow mapping, found "
                         f"{ch!r}", i)

    def flow_node(self, i: int, c: int, key: bool = False):
        ch = self.peek(i, c)
        if ch in "[{":
            if key:
                self.err("a collection as a mapping key", i)
            return self.flow(i, c)
        if ch in "\"'":
            return self.quoted(i, c)
        if ch == "&":
            name, e = self.anchor_name(i, c + 1)
            i, e = self.skip_flow_space(i, e)
            value, i, c = self.flow_node(i, e, key)
            self.anchors[name] = value
            return value, i, c
        if ch == "*":
            name, e = self.anchor_name(i, c + 1)
            if name not in self.anchors:
                self.err(f"undefined alias *{name}", i)
            return self.anchors[name], i, e
        if ch == "!":
            tag, e = self.tag_at(i, c)
            i, c = self.skip_flow_space(i, e)
            nxt = self.peek(i, c)
            if nxt in "\"'":
                text, i, c = self.quoted(i, c)
            elif nxt in ",]}":
                text = ""
            elif nxt in _NO_PLAIN_START and not (
                    nxt in "-?:" and self.peek(i, c + 1) not in " \t\n\0"):
                self.err("a tag on a collection, an anchor or an alias is "
                         "not supported", i)
            else:
                text, i, c, _ = self.plain(i, c, 0, True)
            return self.construct(tag, text, i), i, c
        if ch in _NO_PLAIN_START and not (
                ch == "-" and self.peek(i, c + 1) not in " \t\n\0"):
            self.err(f"unexpected {ch!r} in a flow collection", i)
        text, i, c, _ = self.plain(i, c, 0, True)
        if key and text == "<<":
            return _MERGE, i, c
        return self.resolve(text, i), i, c
