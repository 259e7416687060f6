"""JSON-schema → GBNF grammar generation (the port's own copy of
localai_tfp_tpu/grammars/json_schema.py).

Capability counterpart of the reference's grammar generators
(ref: pkg/functions/grammars/json_schema.go:220 JSONSchemaConverter,
bnf_rules.go base rules, rules.go grammar-option assembly;
llama31_schema.go for the <function=…> syntax). Clean-room: rule naming
and structure follow the GBNF idiom, not the Go code.

Two entry points:
- ``schema_to_gbnf(schema)``: any JSON schema → grammar for one conforming
  JSON document (used by response_format json_schema,
  ref: core/http/endpoints/openai/chat.go:216-246).
- ``functions_grammar(functions, opts)``: OpenAI tool definitions → grammar
  for {"name": …, "arguments": …} calls, with the reference's options:
  parallel calls (array form), mixed text+JSON mode, prefix, llama 3.1
  <function=name>{args}</function> syntax (ref: parse.go:16-60
  FunctionsConfig grammar options).
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

SPACE_RULE = '" "?'

BASE_RULES = {
    "space": SPACE_RULE,
    "string": r'"\"" ( [^"\\\x00-\x1f] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F]) )* "\"" space',
    "number": '("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": '("-"? ([0-9] | [1-9] [0-9]*)) space',
    "boolean": '("true" | "false") space',
    "null": '"null" space',
    "value": "object | array | string | number | boolean | null",
    "object": '"{" space ( string ":" space value ("," space string ":" space value)* )? "}" space',
    "array": '"[" space ( value ("," space value)* )? "]" space',
    "freestring": r'( [^\x00] )*',
}

_INVALID_RULE_CHARS = re.compile(r"[^a-zA-Z0-9-]+")


def _fmt_literal(s: str) -> str:
    esc = s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return f'"{esc}"'


class SchemaConverter:
    def __init__(self, prop_order: Optional[list[str]] = None) -> None:
        self.prop_order = {k: i for i, k in enumerate(prop_order or [])}
        self.rules: dict[str, str] = {"space": SPACE_RULE}
        self.defs: dict[str, Any] = {}

    def _add_rule(self, name: str, rule: str) -> str:
        key = _INVALID_RULE_CHARS.sub("-", name) or "rule"
        if key in self.rules:
            if self.rules[key] == rule:
                return key
            i = 0
            while f"{key}{i}" in self.rules and self.rules[f"{key}{i}"] != rule:
                i += 1
            key = f"{key}{i}"
        self.rules[key] = rule
        return key

    def _base(self, name: str) -> str:
        return self._add_rule(name, BASE_RULES[name])

    def visit(self, schema: Any, name: str = "root") -> str:
        """Emit rules for ``schema``; returns the rule name."""
        if schema is None or schema is True or schema == {}:
            for dep in ("value", "object", "array", "string", "number",
                        "boolean", "null"):
                self._base(dep)
            return self._add_rule(name, "value")
        if not isinstance(schema, dict):
            raise ValueError(f"unsupported schema node: {schema!r}")

        for defs_key in ("$defs", "definitions"):
            if defs_key in schema:
                self.defs.update(schema[defs_key])

        if "$ref" in schema:
            ref = schema["$ref"]
            target = ref.split("/")[-1]
            if target not in self.defs:
                raise ValueError(f"unresolvable $ref {ref}")
            return self.visit(self.defs[target], target)

        if "const" in schema:
            return self._add_rule(
                name, _fmt_literal(json.dumps(schema["const"])) + " space"
            )
        if "enum" in schema:
            alts = " | ".join(
                _fmt_literal(json.dumps(v)) for v in schema["enum"]
            )
            return self._add_rule(name, f"({alts}) space")
        for comb in ("oneOf", "anyOf"):
            if comb in schema:
                alts = [
                    self.visit(sub, f"{name}-{i}")
                    for i, sub in enumerate(schema[comb])
                ]
                return self._add_rule(name, " | ".join(alts))

        t = schema.get("type")
        if isinstance(t, list):
            alts = [
                self.visit({**schema, "type": tt}, f"{name}-{tt}")
                for tt in t
            ]
            return self._add_rule(name, " | ".join(alts))

        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, name)
        if t == "array" or (t is None and "items" in schema):
            return self._array(schema, name)
        if t == "string":
            return self._string(schema, name)
        if t in ("number", "integer", "boolean", "null"):
            return self._add_rule(name, self._base(t))
        # unconstrained
        for dep in ("value", "object", "array", "string", "number",
                    "boolean", "null"):
            self._base(dep)
        return self._add_rule(name, "value")

    def _string(self, schema: dict, name: str) -> str:
        fmt = schema.get("format")
        if fmt == "date":
            return self._add_rule(
                name,
                '"\\"" [0-9] [0-9] [0-9] [0-9] "-" [0-9] [0-9] "-" [0-9] [0-9] "\\"" space',
            )
        return self._add_rule(name, self._base("string"))

    def _object(self, schema: dict, name: str) -> str:
        props = schema.get("properties") or {}
        required = set(schema.get("required") or props.keys())

        def order_key(item):
            k = item[0]
            return (self.prop_order.get(k, len(self.prop_order)), k)

        items = sorted(props.items(), key=order_key)
        if not items:
            return self._add_rule(name, self._base("object"))

        kvs: dict[str, str] = {}
        for k, sub in items:
            sub_rule = self.visit(sub, f"{name}-{k}")
            kvs[k] = f'{_fmt_literal(json.dumps(k))} space ":" space {sub_rule}'

        req = [k for k, _ in items if k in required]
        opt = [k for k, _ in items if k not in required]

        # optional tails: opt-i matches any ordered non-empty subset of
        # opt[i:], comma-separated (the canonical GBNF converter scheme)
        tail_rules: list[str] = []
        for i in range(len(opt) - 1, -1, -1):
            expr = kvs[opt[i]]
            if tail_rules:
                # start at opt[i] (optionally continuing) or skip to a later one
                expr = (f'{expr} ("," space {tail_rules[-1]})? '
                        f'| {tail_rules[-1]}')
            rule_name = self._add_rule(f"{name}-opt{i}", expr)
            tail_rules.append(rule_name)
        opt_entry = tail_rules[-1] if tail_rules else ""

        parts: list[str] = ['"{" space']
        for j, k in enumerate(req):
            if j:
                parts.append('"," space')
            parts.append(kvs[k])
        if opt_entry:
            if req:
                parts.append(f'("," space {opt_entry})?')
            else:
                parts.append(f"({opt_entry})?")
        parts.append('"}" space')
        return self._add_rule(name, " ".join(parts))

    def _array(self, schema: dict, name: str) -> str:
        items = schema.get("items")
        if isinstance(items, list):  # tuple validation
            rules = [
                self.visit(sub, f"{name}-{i}") for i, sub in enumerate(items)
            ]
            body = ' "," space '.join(rules)
            return self._add_rule(name, f'"[" space {body} "]" space')
        item_rule = self.visit(items, f"{name}-item")
        min_items = int(schema.get("minItems") or 0)
        rep = f'{item_rule} ("," space {item_rule})*'
        if min_items == 0:
            rep = f"({rep})?"
        return self._add_rule(name, f'"[" space {rep} "]" space')

    def format_grammar(self, root_rule: str = "root") -> str:
        lines = []
        if "root" not in self.rules:
            lines.append(f"root ::= {root_rule}")
        for k, v in self.rules.items():
            lines.append(f"{k} ::= {v}")
        return "\n".join(lines) + "\n"


def schema_to_gbnf(schema: Any, prop_order: Optional[list[str]] = None) -> str:
    c = SchemaConverter(prop_order)
    c.visit(schema if schema is not None else None, "root")
    return c.format_grammar()


# ---------------------------------------------------------------------------
# tool-calling grammars (ref: pkg/functions/grammars/rules.go options)
# ---------------------------------------------------------------------------


def _tool_call_schema(functions: list[dict],
                      name_key: str = "name",
                      args_key: str = "arguments") -> dict:
    """One-of over {name, arguments} objects, one alternative per tool
    (ref: pkg/functions/function_structure.go JSONFunctionStructure)."""
    alts = []
    for fn in functions:
        f = fn.get("function", fn)  # accept OpenAI tools[] or functions[]
        alts.append({
            "type": "object",
            "properties": {
                name_key: {"const": f["name"]},
                args_key: f.get("parameters") or {},
            },
            "required": [name_key, args_key],
        })
    return {"oneOf": alts} if len(alts) != 1 else alts[0]


def functions_grammar(
    functions: list[dict],
    *,
    parallel_calls: bool = False,
    mixed_mode: bool = False,
    prefix: str = "",
    expect_strings_after_json: bool = False,
    prop_order: Optional[list[str]] = None,
    name_key: str = "name",
    args_key: str = "arguments",
) -> str:
    """GBNF for tool calls (ref: rules.go:  disable-parallel / maybe-string /
    prefix / strings-after-json grammar options)."""
    c = SchemaConverter(prop_order or [name_key, args_key])
    call = c.visit(_tool_call_schema(functions, name_key, args_key), "call")
    if parallel_calls:
        root = f'( {call} | "[" space {call} ("," space {call})* "]" space )'
    else:
        root = call
    if prefix:
        root = f"{_fmt_literal(prefix)} {root}"
    if expect_strings_after_json:
        c.rules["freestring"] = BASE_RULES["freestring"]
        root = f"{root} freestring?"
    if mixed_mode:
        c.rules["freestring"] = BASE_RULES["freestring"]
        root = f"( {root} | freestring )"
    c.rules["root"] = root
    return c.format_grammar()


def llama31_functions_grammar(functions: list[dict]) -> str:
    """Llama-3.1 native tool syntax: <function=name>{args}</function>
    (ref: pkg/functions/grammars/llama31_schema.go:281)."""
    c = SchemaConverter()
    alts = []
    for i, fn in enumerate(functions):
        f = fn.get("function", fn)
        args = c.visit(f.get("parameters") or {}, f"args-{i}")
        alts.append(
            f'"<function=" {_fmt_literal(f["name"])} ">" {args} "</function>"'
        )
    c.rules["root"] = " | ".join(f"( {a} )" for a in alts)
    return c.format_grammar()
