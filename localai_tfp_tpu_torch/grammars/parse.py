"""Parse LLM output back into tool calls + text content (the port's own
copy of localai_tfp_tpu/grammars/parse.py).

Capability counterpart of the reference's function-call response parsing
(ref: pkg/functions/parse.go — FunctionsConfig options :16-60,
ParseFunctionCall :221-338 with regex/JSON recovery and parallel calls,
text-content capture ParseTextContent :163, cleanup rules CleanupLLMResult
:149). Clean-room Python implementation over the same YAML config surface
(config/model_config.py FunctionsConfig).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass

from ..config.model_config import FunctionsConfig


@dataclass
class FuncCallResults:
    name: str = ""
    arguments: str = ""  # JSON string (OpenAI wire format)


def cleanup_llm_result(text: str, cfg: FunctionsConfig) -> str:
    """Apply replace_llm_results regex rules (ref: parse.go:149-161)."""
    for rule in cfg.replace_llm_results or []:
        key = rule.get("key", "")
        value = rule.get("value", "")
        if key:
            text = re.sub(key, value, text)
    return text


def parse_text_content(text: str, cfg: FunctionsConfig) -> str:
    """Extract free-text content via capture_llm_results regexes
    (ref: parse.go ParseTextContent :163-186)."""
    for pattern in cfg.capture_llm_results or []:
        m = re.search(pattern, text, re.DOTALL)
        if m:
            return (m.group(1) if m.groups() else m.group(0)).strip()
    return ""


def _replace_results(text: str, cfg: FunctionsConfig) -> str:
    for rule in cfg.replace_function_results or []:
        key = rule.get("key", "")
        value = rule.get("value", "")
        if key:
            text = re.sub(key, value, text)
    return text


_LLAMA31_CALL = re.compile(
    r"<function=(\w+)>(.*?)</function>", re.DOTALL
)


def _json_candidates(text: str) -> list[str]:
    """Find balanced top-level JSON objects/arrays in free text."""
    out = []
    depth = 0
    start = -1
    in_str = False
    esc = False
    for i, ch in enumerate(text):
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "{[":
            if depth == 0:
                start = i
            depth += 1
        elif ch in "}]":
            if depth > 0:
                depth -= 1
                if depth == 0 and start >= 0:
                    out.append(text[start:i + 1])
                    start = -1
    return out


def parse_function_call(text: str, cfg: FunctionsConfig) -> list[FuncCallResults]:
    """Recover tool calls from model output (ref: parse.go
    ParseFunctionCall :221-338). Handles: single JSON object, JSON array of
    calls (parallel), llama3.1 <function=…> syntax, json_regex_match
    extraction, response_regex named groups, and argument-as-object or
    argument-as-string forms."""
    name_key = cfg.function_name_key or "name"
    args_key = cfg.function_arguments_key or "arguments"

    text = _replace_results(text, cfg)
    results: list[FuncCallResults] = []

    # llama 3.1 native syntax
    for m in _LLAMA31_CALL.finditer(text):
        results.append(FuncCallResults(name=m.group(1),
                                       arguments=m.group(2).strip()))
    if results:
        return results

    # response_regex with named groups (ref: parse.go:287-317)
    for pattern in cfg.response_regex or []:
        for m in re.finditer(pattern, text, re.DOTALL):
            gd = m.groupdict()
            if name_key in gd:
                args = gd.get(args_key, "") or "{}"
                results.append(FuncCallResults(name=gd[name_key],
                                               arguments=args))
    if results:
        return results

    # json_regex_match: extract the JSON blob first (ref: parse.go:240-255)
    candidates: list[str] = []
    for pattern in cfg.json_regex_match or []:
        m = re.search(pattern, text, re.DOTALL)
        if m:
            candidates.append(m.group(1) if m.groups() else m.group(0))
            break
    if not candidates:
        candidates = _json_candidates(text)

    for cand in candidates:
        try:
            obj = json.loads(cand)
        except ValueError:
            continue
        calls = obj if isinstance(obj, list) else [obj]
        for c in calls:
            if not isinstance(c, dict):
                continue
            name = c.get(name_key)
            if not isinstance(name, str) or not name:
                continue
            args = c.get(args_key, {})
            if isinstance(args, str):
                args_str = args
            else:
                args_str = json.dumps(args)
            results.append(FuncCallResults(name=name, arguments=args_str))
        if results:
            break
    return results
