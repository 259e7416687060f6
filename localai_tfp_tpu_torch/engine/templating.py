"""Chat prompt assembly (the Go-template and no-template branches of
localai_tfp_tpu/engine/templating.py::Evaluator.template_messages).

A template field is inline text when it contains ``{{`` or ``{%``, else
the name of a ``.tmpl``/``.jinja`` file in the models directory. Go
text/template sources (the LocalAI model-gallery dialect) render through
the port's own Go-template interpreter (engine/gotmpl.py); a Jinja source
imports ``jinja2`` when, and only when, one is rendered. Tokenizer chat
templates are not applied yet (see engine/tokenizer.py).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any

from ..config.model_config import ModelConfig
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
    MessageIndex: int = 0


class Evaluator:
    """Renders a model config's chat templates."""

    def __init__(self, models_path: str = "") -> None:
        self.models_path = models_path
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
                import jinja2

                tpl = jinja2.Environment(
                    loader=jinja2.BaseLoader(), keep_trailing_newline=True
                ).from_string(src)
            self._cache[src] = tpl
        if isinstance(tpl, GoTemplate):
            return tpl.render(data)
        ctx = dict(data.__dict__)
        for k, v in list(ctx.items()):  # Go-style and snake_case names
            ctx[_snake(k)] = v
        return tpl.render(**ctx)

    def template_messages(self, cfg: ModelConfig,
                          messages: list[dict]) -> str:
        """Assemble the full chat prompt: each message through
        ``template.chat_message`` (else ``"<role>: <content>"``), joined,
        then wrapped by ``template.chat`` when set."""
        rendered: list[str] = []
        n = len(messages)
        for i, msg in enumerate(messages):
            role = msg.get("role", "user")
            content = content_to_text(msg.get("content"))
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
        if cfg.template.chat:
            return self._render(cfg.template.chat, PromptTemplateData(
                Input=combined, SystemPrompt=cfg.system_prompt))
        return combined


def content_to_text(content: Any) -> str:
    """OpenAI message content: a string or a list of parts, of which the
    text parts are kept."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict) and p.get("type") == "text")
    return str(content)


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
