"""Minimal Go text/template interpreter for LocalAI model templates (the
port's own copy of localai_tfp_tpu/engine/gotmpl.py).

The reference renders model YAML templates with Go text/template (+ a
sprig function subset) — pkg/templates/evaluator.go:95-117. Gallery
templates use ``eq``, ``range``, ``index``, ``toJson``, ``$variables``,
trim markers and sprig helpers; this module evaluates that dialect
directly — the constructs observed across the reference's gallery YAMLs
and evaluator tests:

    {{.Field.Chain}}  {{- trim markers -}}
    {{if pipeline}} … {{else if pipeline}} … {{else}} … {{end}}
    {{range $k, $v := pipeline}} … {{else}} … {{end}}
    {{$var := pipeline}}  {{$var = pipeline}}
    functions: eq ne lt le gt ge and or not index len print printf
               toJson add1 add sub trim contains hasPrefix hasSuffix
               default empty upper lower title join quote replace

Semantics follow Go text/template where they matter for prompts: zero
values are falsy, ``range`` over maps iterates in sorted key order
(text/template sorts string map keys), pipelines feed the previous
value as the LAST argument of the next command.
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

__all__ = ["GoTemplate", "GoTemplateError", "looks_like_go_template"]


class GoTemplateError(ValueError):
    pass


_ACTION = re.compile(r"\{\{(-)?((?:[^}\"`]|\"(?:\\.|[^\"\\])*\"|`[^`]*`)*?)(-)?\}\}",
                     re.S)

_GO_HINT = re.compile(
    r"\{\{-|\{\{\s*(\.|\$|if\s|else\b|end\b|range\s|with\s)"
    r"|\{\{\s*\w+\s+[.$\"]"
)


def looks_like_go_template(src: str) -> bool:
    """Heuristic: Go actions present and no Jinja statement blocks."""
    return bool(_GO_HINT.search(src)) and "{%" not in src


# ------------------------------------------------------------ tokenizing

_EXPR_TOK = re.compile(
    r'"(?:\\.|[^"\\])*"'  # interpreted string
    r"|`[^`]*`"  # raw string
    r"|:=|=(?!=)|\(|\)|\||,"
    r"|[^\s()|,:=\"`]+"
)


def _lex_expr(src: str) -> list[str]:
    return _EXPR_TOK.findall(src)


def _split_actions(src: str):
    """Yield ("text", s) / ("action", body) with trim markers applied
    (Go: ``{{- `` trims whitespace before the action, `` -}}`` after).
    A chunk between `` -}}`` and ``{{- `` gets BOTH strips (the rtrim is
    deferred so a following ltrim can still reach the same chunk)."""
    parts: list[tuple[str, str]] = []
    pos = 0
    pending_rtrim = False
    for m in _ACTION.finditer(src):
        text = src[pos:m.start()]
        if pending_rtrim:
            text = text.lstrip()
        if m.group(1):  # left trim
            text = text.rstrip()
        parts.append(("text", text))
        parts.append(("action", m.group(2).strip()))
        pending_rtrim = bool(m.group(3))
        pos = m.end()
    text = src[pos:]
    if pending_rtrim:
        text = text.lstrip()
    parts.append(("text", text))
    return [(k, v) for k, v in parts if not (k == "text" and v == "")]


# --------------------------------------------------------------- parsing
# node forms:
#   ("text", s)
#   ("out", expr_tokens)
#   ("assign", varname, expr_tokens, declare: bool)
#   ("if", [(cond_tokens, body), ...], else_body | None)
#   ("range", kvar, vvar, expr_tokens, body, else_body | None)


def _parse(parts, i=0, *, stop=()):
    nodes = []
    while i < len(parts):
        kind, val = parts[i]
        if kind == "text":
            nodes.append(("text", val))
            i += 1
            continue
        word = val.split(None, 1)[0] if val else ""
        if word in stop:
            return nodes, i
        if word == "if":
            arms = []
            cond = _lex_expr(val[2:])
            body, i = _parse(parts, i + 1, stop=("else", "end"))
            arms.append((cond, body))
            else_body = None
            while True:
                _, ctl = parts[i]
                if ctl.startswith("else"):
                    rest = ctl[4:].strip()
                    if rest.startswith("if"):
                        cond = _lex_expr(rest[2:])
                        body, i = _parse(parts, i + 1, stop=("else", "end"))
                        arms.append((cond, body))
                        continue
                    else_body, i = _parse(parts, i + 1, stop=("end",))
                    continue
                break  # at "end"
            nodes.append(("if", arms, else_body))
            i += 1
            continue
        if word == "range":
            decl = val[5:].strip()
            kvar = vvar = None
            if ":=" in decl:
                vars_part, expr_part = decl.split(":=", 1)
                names = [v.strip() for v in vars_part.split(",")]
                if len(names) == 1:
                    vvar = names[0]
                elif len(names) == 2:
                    kvar, vvar = names
                else:
                    raise GoTemplateError(f"bad range declaration: {decl}")
            else:
                expr_part = decl
            body, i = _parse(parts, i + 1, stop=("else", "end"))
            else_body = None
            if parts[i][1].startswith("else"):
                else_body, i = _parse(parts, i + 1, stop=("end",))
            nodes.append(("range", kvar, vvar, _lex_expr(expr_part), body,
                          else_body))
            i += 1
            continue
        if word in ("end", "else"):
            raise GoTemplateError(f"unexpected {{{{{word}}}}}")
        toks = _lex_expr(val)
        if toks and toks[0].startswith("$") and len(toks) > 1 \
                and toks[1] in (":=", "="):
            nodes.append(("assign", toks[0], toks[2:], toks[1] == ":="))
        elif toks:
            nodes.append(("out", toks))
        i += 1
    if stop:
        raise GoTemplateError(f"missing {{{{end}}}} (wanted one of {stop})")
    return nodes, i


# ------------------------------------------------------------- functions


def _truthy(v: Any) -> bool:
    """Go zero values are falsy."""
    return not (v is None or v is False or v == "" or v == 0
                or (isinstance(v, (list, tuple, dict)) and not v))


def _num(v):
    if isinstance(v, bool):
        raise GoTemplateError("number expected")
    if isinstance(v, (int, float)):
        return v
    try:
        f = float(v)
        return int(f) if f.is_integer() else f
    except (TypeError, ValueError):
        raise GoTemplateError(f"number expected, got {v!r}")


def _go_index(coll, *keys):
    for k in keys:
        if coll is None:
            return None
        if isinstance(coll, dict):
            coll = coll.get(k)
        elif isinstance(coll, (list, tuple, str)):
            i = int(_num(k))
            coll = coll[i] if 0 <= i < len(coll) else None
        else:
            coll = getattr(coll, str(k), None)
    return coll


def _printf(fmt, *args):
    # the Go verbs that appear in prompt templates
    out, ai = [], 0
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            v = fmt[i + 1]
            if v == "%":
                out.append("%")
            elif v in "svd":
                a = args[ai] if ai < len(args) else ""
                ai += 1
                out.append(str(int(_num(a))) if v == "d" else _to_str(a))
            elif v == "q":
                a = args[ai] if ai < len(args) else ""
                ai += 1
                out.append(json.dumps(_to_str(a)))
            else:
                out.append(c + v)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _to_str(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (dict, list)):
        return json.dumps(v, separators=(", ", ": "))
    return str(v)


_FUNCS: dict[str, Any] = {
    "eq": lambda x, *ys: any(x == y for y in ys),
    "ne": lambda x, y: x != y,
    "lt": lambda x, y: _num(x) < _num(y),
    "le": lambda x, y: _num(x) <= _num(y),
    "gt": lambda x, y: _num(x) > _num(y),
    "ge": lambda x, y: _num(x) >= _num(y),
    "and": lambda *vs: next((v for v in vs if not _truthy(v)), vs[-1]),
    "or": lambda *vs: next((v for v in vs if _truthy(v)), vs[-1]),
    "not": lambda v: not _truthy(v),
    "index": _go_index,
    "len": lambda v: len(v) if v is not None else 0,
    "length": lambda v: len(v) if v is not None else 0,  # jinja-ism seen
    # in existing configs; harmless alias
    "print": lambda *vs: "".join(_to_str(v) for v in vs),
    "printf": _printf,
    # Go json.Marshal: compact separators, map keys sorted
    "toJson": lambda v: json.dumps(
        v, separators=(",", ":"), sort_keys=isinstance(v, dict),
        default=lambda o: getattr(o, "__dict__", str(o))),
    "add1": lambda v: _num(v) + 1,
    "add": lambda *vs: sum(_num(v) for v in vs),
    "sub": lambda a, b: _num(a) - _num(b),
    "mul": lambda a, b: _num(a) * _num(b),
    # sprig string helpers (argument order matches sprig)
    "trim": lambda s: _to_str(s).strip(),
    "upper": lambda s: _to_str(s).upper(),
    "lower": lambda s: _to_str(s).lower(),
    "title": lambda s: _to_str(s).title(),
    "quote": lambda *vs: " ".join(json.dumps(_to_str(v)) for v in vs),
    "contains": lambda sub, s: sub in _to_str(s),
    "hasPrefix": lambda p, s: _to_str(s).startswith(p),
    "hasSuffix": lambda p, s: _to_str(s).endswith(p),
    "default": lambda d, v=None: v if _truthy(v) else d,
    "empty": lambda v: not _truthy(v),
    "join": lambda sep, lst: _to_str(sep).join(
        _to_str(v) for v in (lst or [])),
    "replace": lambda old, new, s: _to_str(s).replace(old, new),
}


# ------------------------------------------------------------ evaluation


class _Scope:
    def __init__(self, dot: Any, parent: Optional["_Scope"] = None):
        self.dot = dot
        self.vars: dict[str, Any] = {}
        self.parent = parent

    def get(self, name: str):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise GoTemplateError(f"undefined variable {name}")

    def set(self, name: str, value, declare: bool):
        if declare:
            self.vars[name] = value
            return
        s = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = value
                return
            s = s.parent
        self.vars[name] = value  # tolerate assign-without-declare


def _field_chain(base: Any, chain: str):
    for part in chain.split("."):
        if not part:
            continue
        if base is None:
            return None
        if isinstance(base, dict):
            base = base.get(part)
        elif isinstance(base, (list, tuple)):
            return None
        else:
            base = getattr(base, part, None)
    return base


_STR_ESC = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}


def _operand(tok: str, scope: _Scope):
    if tok.startswith('"'):
        body = tok[1:-1]
        return re.sub(r"\\(.)", lambda m: _STR_ESC.get(m.group(1),
                                                       m.group(1)), body)
    if tok.startswith("`"):
        return tok[1:-1]
    if tok == ".":
        return scope.dot
    if tok.startswith("$"):
        name, _, chain = tok.partition(".")
        return _field_chain(scope.get(name), chain) if chain \
            else scope.get(name)
    if tok.startswith("."):
        return _field_chain(scope.dot, tok[1:])
    if tok in ("true", "false"):
        return tok == "true"
    if tok in ("nil", "none"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.]*", tok):
        # lenient: bare identifier as a dot field (legacy configs written
        # for the old Jinja transpile use `Field` without the dot)
        return _field_chain(scope.dot, tok)
    raise GoTemplateError(f"unknown operand {tok!r}")


def _eval_command(toks: list[str], scope: _Scope, extra=None):
    """One pipeline stage: operand, or function with args. ``extra`` is
    the piped-in value appended as the last argument."""
    i = 0
    head = toks[0]
    if head == "(":
        val, i = _eval_paren(toks, scope)
        if i == len(toks) and extra is None:
            return val
        args, j = [val], i
    elif head in _FUNCS:
        args, j = [], 1
    else:
        val = _operand(head, scope)
        if len(toks) == 1 and extra is None:
            return val
        if head.startswith((".", "$")) and callable(val):
            args, j = [], 1  # method-style: not used in practice
        elif len(toks) == 1:
            return val  # piped into an operand: Go errors; be lenient
        else:
            raise GoTemplateError(f"not a function: {head!r}")
    fn = _FUNCS.get(head) if head in _FUNCS else None
    while j < len(toks):
        if toks[j] == "(":
            val, j2 = _eval_paren(toks[j:], scope)
            args.append(val)
            j += j2
        else:
            args.append(_operand(toks[j], scope))
            j += 1
    if extra is not None:
        args.append(extra)
    if fn is None:
        raise GoTemplateError(f"not a function: {head!r}")
    try:
        return fn(*args)
    except GoTemplateError:
        raise
    except Exception as e:
        raise GoTemplateError(f"error calling {head}: {e}")


def _eval_paren(toks: list[str], scope: _Scope):
    """toks[0] == '(': evaluate the parenthesized pipeline, return
    (value, tokens consumed including both parens)."""
    depth = 0
    for i, t in enumerate(toks):
        if t == "(":
            depth += 1
        elif t == ")":
            depth -= 1
            if depth == 0:
                return _eval_pipeline(toks[1:i], scope), i + 1
    raise GoTemplateError("unbalanced parentheses")


def _eval_pipeline(toks: list[str], scope: _Scope):
    if not toks:
        raise GoTemplateError("empty pipeline")
    stages: list[list[str]] = [[]]
    depth = 0
    for t in toks:
        if t == "(":
            depth += 1
        elif t == ")":
            depth -= 1
        if t == "|" and depth == 0:
            stages.append([])
        else:
            stages[-1].append(t)
    val = _eval_command(stages[0], scope)
    for stage in stages[1:]:
        val = _eval_command(stage, scope, extra=val)
    return val


def _exec(nodes, scope: _Scope, out: list[str]):
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "out":
            out.append(_to_str(_eval_pipeline(node[1], scope)))
        elif kind == "assign":
            scope.set(node[1], _eval_pipeline(node[2], scope), node[3])
        elif kind == "if":
            _, arms, else_body = node
            for cond, body in arms:
                if _truthy(_eval_pipeline(cond, scope)):
                    _exec(body, _Scope(scope.dot, scope), out)
                    break
            else:
                if else_body is not None:
                    _exec(else_body, _Scope(scope.dot, scope), out)
        elif kind == "range":
            _, kvar, vvar, expr, body, else_body = node
            coll = _eval_pipeline(expr, scope)
            if isinstance(coll, dict):
                # text/template iterates string map keys in sorted order
                items = [(k, coll[k]) for k in sorted(coll)]
            elif isinstance(coll, (list, tuple)):
                items = list(enumerate(coll))
            elif coll:
                items = [(0, coll)]
            else:
                items = []
            if not items:
                if else_body is not None:
                    _exec(else_body, _Scope(scope.dot, scope), out)
                continue
            for k, v in items:
                inner = _Scope(v, scope)
                if kvar:
                    inner.vars[kvar[1:]] = k
                    inner.vars[kvar] = k  # $k usable with or without $
                if vvar:
                    inner.vars[vvar[1:]] = v
                    inner.vars[vvar] = v
                _exec(body, inner, out)


class GoTemplate:
    """Parsed Go text/template; render with a dot context."""

    def __init__(self, src: str) -> None:
        self._nodes, _ = _parse(_split_actions(src))

    def render(self, dot: Any) -> str:
        out: list[str] = []
        scope = _Scope(dot)
        _exec(self._nodes, scope, out)
        return "".join(out)
