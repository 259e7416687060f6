"""Parse LLM output back into tool calls + text content (the port's own
copy of localai_tfp_tpu/grammars/parse.py).

Capability counterpart of the reference's function-call response parsing
(ref: pkg/functions/parse.go — FunctionsConfig options :16-60,
ParseFunctionCall :221-338 with regex/JSON recovery and parallel calls,
text-content capture ParseTextContent :163, cleanup rules CleanupLLMResult
:149). Clean-room Python implementation over the same YAML config surface
(config/model_config.py FunctionsConfig). ``apply_finetune`` and
``FinetuneStream`` post-process a reply by the config's ``echo``,
``cutstrings``, ``extract_regex``, ``trimspace`` and ``trimsuffix``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Optional

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


def apply_finetune(text: str, *, echo_prompt: str = "",
                   cutstrings: Optional[list[str]] = None,
                   extract_regex: Optional[list[str]] = None,
                   trimspace: Optional[list[str]] = None,
                   trimsuffix: Optional[list[str]] = None) -> str:
    """Response post-processing, reference-exact order (ref:
    core/backend/llm.go:192-240 Finetune): echo → cutstrings (regex delete)
    → extract_regex (concatenate first match of each; replaces text if any)
    → trimspace (TrimPrefix then strip) → trimsuffix (TrimSuffix then
    strip)."""
    if echo_prompt:
        text = echo_prompt + text
    for pattern in cutstrings or []:
        text = re.sub(pattern, "", text)
    extracted = ""
    for pattern in extract_regex or []:
        m = re.search(pattern, text, re.DOTALL)
        if m:
            extracted += m.group(0)
    if extracted:
        text = extracted
    for s in trimspace or []:
        if s and text.startswith(s):
            text = text[len(s):]
        text = text.strip()
    for s in trimsuffix or []:
        if s and text.endswith(s):
            text = text[: -len(s)]
        text = text.strip()
    return text


class FinetuneStream:
    """Incremental ``apply_finetune`` for SSE streaming.

    The reference only post-processes NON-streaming responses (Finetune
    is called from ComputeChoices / handleQuestion, never from the token
    callback — ref: core/http/endpoints/openai/inference.go:58,
    chat.go:516,552). Here streamed output is post-processed too, so a
    model YAML with ``cutstrings:`` behaves identically in both modes:

    - ``cutstrings`` / ``extract_regex`` need the whole text; with
      either set the stream is buffered and emitted as ONE final chunk
      (semantics over latency — the same degeneration the tool-call
      streaming path already accepts).
    - ``echo`` / ``trimspace`` / ``trimsuffix`` stream incrementally: a
      start-phase state machine resolves the prefix trims, a
      conservative tail holdback (suffix candidates + adjacent
      whitespace, like stop-string withholding) keeps the final trims
      possible, and ``finish()`` reconciles against ``apply_finetune``
      on the full raw text, so the concatenated stream is bit-identical
      to the non-streaming result.
    """

    def __init__(self, *, echo_prompt: str = "",
                 cutstrings: Optional[list[str]] = None,
                 extract_regex: Optional[list[str]] = None,
                 trimspace: Optional[list[str]] = None,
                 trimsuffix: Optional[list[str]] = None) -> None:
        self._kw = dict(echo_prompt=echo_prompt, cutstrings=cutstrings,
                        extract_regex=extract_regex, trimspace=trimspace,
                        trimsuffix=trimsuffix)
        self._buffer_all = bool(cutstrings or extract_regex)
        self._trimspace = list(trimspace or [])
        self._trimsuffix = list(trimsuffix or [])
        self._raw: list[str] = []  # every raw span, for reconciliation
        # echo text flows THROUGH the trim pipeline like apply_finetune
        # prepends it before trimming (a trimspace entry may well match
        # the echoed prompt); it is seeded into the stream, not into
        # _raw — finish()'s apply_finetune re-adds it via echo_prompt
        self._start_done = not (self._trimspace or self._trimsuffix)
        self._head = "" if self._buffer_all else echo_prompt
        self._body = ""  # resolved text not yet emitted (tail holdback)
        if self._start_done:
            self._body, self._head = self._head, ""
        self._emitted = ""  # exactly what the caller has streamed so far

    def _resolve_start(self) -> Optional[str]:
        """Run the prefix side of the trim pipeline on the buffered
        head. None = undecided (a trim string may still be completed by
        future text, or we are inside a leading-whitespace run; a
        stream that ENDS undecided is settled by finish()'s
        apply_finetune reconciliation). Each trimsuffix entry's strip()
        ALSO trims the leading side, so with any trimsuffix configured
        the leading whitespace must be swallowed here too."""
        cur = self._head
        for s in self._trimspace:
            if s and len(cur) < len(s) and s.startswith(cur):
                return None  # proper prefix: hold
            if s and cur.startswith(s):
                cur = cur[len(s):]
            cur = cur.lstrip()
            if not cur:
                return None  # still swallowing leading whitespace
        if self._trimsuffix:
            cur = cur.lstrip()
            if not cur:
                return None
        return cur

    def _holdback_boundary(self, text: str) -> int:
        """Largest emit-safe prefix length: everything past it could
        still be consumed by the trailing-trim pipeline (each trimsuffix
        entry removes one suffix then strips; trimspace entries strip
        trailing whitespace)."""
        b = len(text)
        while b > 0 and text[b - 1].isspace():
            b -= 1
        for s in reversed(self._trimsuffix):
            b = max(0, b - len(s))
            while b > 0 and text[b - 1].isspace():
                b -= 1
        return b

    def feed(self, span: str) -> str:
        """Add raw model text; returns the text safe to stream now."""
        if not span:
            return ""
        self._raw.append(span)
        if self._buffer_all:
            return ""
        out = ""
        if not self._start_done:
            self._head += span
            resolved = self._resolve_start()
            if resolved is None:
                return out
            self._start_done = True
            self._body += resolved
        else:
            self._body += span
        b = self._holdback_boundary(self._body)
        if b > 0:
            out += self._body[:b]
            self._emitted += self._body[:b]
            self._body = self._body[b:]
        return out

    def finish(self) -> str:
        """Final span: whatever of the canonical post-processed text has
        not been streamed yet."""
        final = apply_finetune("".join(self._raw), **self._kw)
        if final.startswith(self._emitted):
            return final[len(self._emitted):]
        # conservative holdback should make this unreachable; emitting
        # nothing further keeps the stream a prefix of the canonical
        # text rather than diverging from it
        return ""
