"""Prompt templating: chat assembly and the completion and edit
templates (localai_tfp_tpu/engine/templating.py::Evaluator).

A template field is inline text when it contains ``{{`` or ``{%``, else
the name of a ``.tmpl``/``.jinja`` file in the models directory. Go
text/template sources (the LocalAI model-gallery dialect) render through
the port's own Go-template interpreter (engine/gotmpl.py), Jinja sources
through its Jinja subset (engine/jinja_lite.py, the JAX Evaluator's
environment). A chat takes the tokenizer's chat template when the config
asks for it (``template.use_tokenizer_template``) or names no chat
template, as in the JAX package.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

from ..config.model_config import ModelConfig
from . import jinja_lite
from .gotmpl import GoTemplate, looks_like_go_template


@dataclass
class ChatMessageData:
    """Per-message template variables (ref: evaluator.go:26-36)."""

    SystemPrompt: str = ""
    Role: str = ""
    RoleName: str = ""
    Content: str = ""
    FunctionCall: Any = None
    FunctionName: str = ""
    LastMessage: bool = False
    Function: bool = False
    MessageIndex: int = 0


@dataclass
class PromptTemplateData:
    """Top-level chat template variables."""

    SystemPrompt: str = ""
    Input: str = ""
    Instruction: str = ""
    Functions: list[dict] = field(default_factory=list)
    MessageIndex: int = 0


class Evaluator:
    """Renders a model config's chat templates."""

    def __init__(self, models_path: str = "") -> None:
        self.models_path = models_path
        self._env = jinja_lite.Environment.config()
        self._cache: dict[str, Any] = {}

    def _load_source(self, name_or_text: str) -> str:
        if "{{" in name_or_text or "{%" in name_or_text:
            return name_or_text
        for ext in ("", ".tmpl", ".jinja", ".jinja2"):
            p = os.path.join(self.models_path, name_or_text + ext)
            if self.models_path and os.path.isfile(p):
                with open(p) as f:
                    return f.read()
        return name_or_text  # literal text without placeholders

    def _render(self, source: str, data: Any) -> str:
        src = self._load_source(source)
        tpl = self._cache.get(src)
        if tpl is None:
            if looks_like_go_template(src) or "{{" not in src and \
                    "{%" not in src:
                tpl = GoTemplate(src)
            else:
                tpl = self._env.from_string(src)
            self._cache[src] = tpl
        if isinstance(tpl, GoTemplate):
            return tpl.render(data)
        ctx = dict(data.__dict__)
        for k, v in list(ctx.items()):  # Go-style and snake_case names
            ctx[_snake(k)] = v
        return tpl.render(**ctx)

    def evaluate_completion(self, cfg: ModelConfig, prompt: str) -> str:
        """A ``/v1/completions`` prompt through ``template.completion``."""
        if not cfg.template.completion:
            return prompt
        return self._render(cfg.template.completion, PromptTemplateData(
            Input=prompt, SystemPrompt=cfg.system_prompt))

    def evaluate_edit(self, cfg: ModelConfig, input_: str,
                      instruction: str) -> str:
        """A ``/v1/edits`` prompt through ``template.edit``, else the
        instruction, a blank line and the input."""
        if not cfg.template.edit:
            return f"{instruction}\n\n{input_}"
        return self._render(cfg.template.edit, PromptTemplateData(
            Input=input_, Instruction=instruction,
            SystemPrompt=cfg.system_prompt))

    def template_messages(self, cfg: ModelConfig, messages: list[dict],
                          tokenizer: Any = None,
                          functions: Optional[list[dict]] = None,
                          use_function_template: bool = False,
                          media: Optional[list] = None) -> str:
        """Assemble the full chat prompt. The tokenizer's chat template
        when the config asks for it or has no ``chat``/``chat_message``
        template (``system_prompt`` prepended as a system message when
        the chat has none); else each message through
        ``template.chat_message`` (else ``"<role>: <content>"``), joined,
        then wrapped by ``template.chat`` — or by ``template.function``
        when tools were requested and the config has one (``.Functions``
        holds the tool definitions). ``media`` (an out-parameter): each
        image part is appended to it and stands as an ``[img-N]`` marker
        in the text; without it image parts are dropped."""
        messages = [m if isinstance(m.get("content"), str)
                    else {**m, "content": content_to_text(m.get("content"),
                                                          media)}
                    for m in messages]
        use_tok = cfg.template.use_tokenizer_template or not (
            cfg.template.chat or cfg.template.chat_message)
        if use_tok and tokenizer is not None and getattr(
                tokenizer, "chat_template", None):
            msgs = list(messages)
            if cfg.system_prompt and not any(
                    m.get("role") == "system" for m in msgs):
                msgs = [{"role": "system", "content": cfg.system_prompt}] \
                    + msgs
            return tokenizer.apply_chat_template(
                msgs, add_generation_prompt=True, tools=functions or None)
        rendered: list[str] = []
        n = len(messages)
        for i, msg in enumerate(messages):
            role = msg.get("role", "user")
            content = msg["content"]
            fcall = msg.get("tool_calls") or msg.get("function_call")
            data = ChatMessageData(
                SystemPrompt=cfg.system_prompt,
                Role=cfg.roles.get(role, role),
                RoleName=role,
                Content=content,
                FunctionCall=fcall,
                FunctionName=msg.get("name", ""),
                LastMessage=i == n - 1,
                Function=bool(fcall) or role in ("tool", "function"),
                MessageIndex=i,
            )
            if cfg.template.chat_message:
                rendered.append(self._render(cfg.template.chat_message, data))
            else:
                prefix = data.Role
                rendered.append(f"{prefix}: {content}" if prefix else content)
        joiner = cfg.template.join_chat_messages_by_character
        combined = ("\n" if joiner is None else joiner).join(
            r for r in rendered if r)
        chat_tpl = (cfg.template.function
                    if use_function_template and cfg.template.function
                    else cfg.template.chat)
        if chat_tpl:
            return self._render(chat_tpl, PromptTemplateData(
                Input=combined, SystemPrompt=cfg.system_prompt,
                Functions=functions or []))
        return combined


def content_to_text(content: Any, media: Optional[list] = None) -> str:
    """OpenAI message content: a string or a list of parts. Text parts
    are kept; with ``media`` given, each ``image_url`` / ``image`` part is
    collected into it and replaced by an ``[img-N]`` marker (N its index
    in ``media``), which the LLM worker expands into soft tokens."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        parts = []
        for p in content:
            if not isinstance(p, dict):
                continue
            if p.get("type") == "text":
                parts.append(p.get("text", ""))
            elif p.get("type") in ("image_url", "image") and \
                    media is not None:
                media.append(p)
                parts.append(f"[img-{len(media) - 1}]")
        return "".join(parts)
    return str(content)


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
