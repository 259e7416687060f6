"""The port's Jinja subset (localai_tfp_tpu_torch/engine/jinja_lite.py)
against ``jinja2`` in both environments the JAX package renders with:

- transformers' chat-template environment (``ImmutableSandboxedEnvironment
  (trim_blocks=True, lstrip_blocks=True)`` with loop controls,
  ``raise_exception``, ``strftime_now`` and its ``tojson``), built here
  as transformers 4.57 builds it (``_compile_jinja_template``);
- the JAX ``Evaluator``'s ``Environment(keep_trailing_newline=True)``.

Chat templates are written in this file in the style of the published
Llama-3.1 (tools, ``date_string``, ``namespace``), Qwen2.5 (ChatML,
tools), Qwen3 (``messages[::-1]``, ``namespace``) and Mistral (``[INST]``,
``raise_exception`` on role order) templates, each rendered with and
without tools and ``add_generation_prompt`` over conversations drawn from
a numpy seed; ``strftime_now`` is patched to one date in both. Each
output must be the same string, and each error the same message.
"""

import json

import numpy as np
import pytest

jinja2 = pytest.importorskip("jinja2")
from jinja2.sandbox import ImmutableSandboxedEnvironment  # noqa: E402

from localai_tfp_tpu_torch.engine import jinja_lite  # noqa: E402

FIXED_NOW = "17 Oct 2026"


def _jinja2_chat_env():
    """transformers' environment (chat_template_utils.
    _compile_jinja_template), strftime_now pinned."""
    import jinja2.ext

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = lambda fmt: FIXED_NOW
    return env


def _jinja2_config_env():
    """The JAX Evaluator's environment (engine/templating.py)."""
    from localai_tfp_tpu.engine.templating import _raise_exception

    env = jinja2.Environment(loader=jinja2.BaseLoader(),
                             keep_trailing_newline=True, trim_blocks=False,
                             lstrip_blocks=False)
    env.globals["raise_exception"] = _raise_exception
    return env


def _port_chat_env():
    env = jinja_lite.Environment.chat()
    env.globals["strftime_now"] = lambda fmt: FIXED_NOW
    return env


ENVS = {
    "chat": (_jinja2_chat_env, _port_chat_env),
    "config": (_jinja2_config_env, jinja_lite.Environment.config),
}


def _render(make_env, source: str, ctx: dict):
    try:
        return "ok", make_env().from_string(source).render(**ctx)
    except Exception as e:  # compared below: the same failure in both
        return "error", str(e).split(" (template line")[0]


def _same(env_name: str, source: str, ctx: dict):
    ref_env, port_env = ENVS[env_name]
    want = _render(ref_env, source, json.loads(json.dumps(ctx)))
    got = _render(port_env, source, json.loads(json.dumps(ctx)))
    assert got == want, (source, ctx)
    return want


LLAMA31_STYLE = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = strftime_now("%d %b %Y") %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- the system message goes first, in its own turn #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{%- set ns = namespace(tool_results=0, first=true) %}

{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{%- if tools_in_user_message and not tools is none %}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
    {%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}
    {{- "Given the following functions, respond with a JSON call.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
        {{- '{"name": "' + tool_call.name + '", ' }}
        {{- '"parameters": ' }}
        {{- tool_call.arguments | tojson }}
        {{- "}" }}
        {{- "<|eot_id|>" }}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {%- set ns.tool_results = ns.tool_results + 1 %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

QWEN25_STYLE = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\nYou are provided with function signatures within <tools></tools> XML tags:\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools>\\n\\nFor each function call, return a json object within <tool_call></tool_call> XML tags:\\n<tool_call>\\n{\\"name\\": <function-name>, \\"arguments\\": <args-json-object>}\\n</tool_call><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- else %}
        {{- '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- message.content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""

QWEN3_STYLE = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0].role == 'system' %}
        {{- messages[0].content + '\\n\\n' }}
    {%- endif %}
    {{- "# Tools\\n\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0].role == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0].content + '<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" and message.content is string and not(message.content.startswith('<tool_response>') and message.content.endswith('</tool_response>')) %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\\n' + content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if message.reasoning_content is string %}
            {%- set reasoning_content = message.reasoning_content %}
        {%- else %}
            {%- if '</think>' in content %}
                {%- set reasoning_content = content.split('</think>')[0].rstrip('\\n').split('<think>')[-1].lstrip('\\n') %}
                {%- set content = content.split('</think>')[-1].lstrip('\\n') %}
            {%- endif %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {%- if loop.last or (not loop.last and reasoning_content) %}
                {{- '<|im_start|>' + message.role + '\\n<think>\\n' + reasoning_content.strip('\\n') + '\\n</think>\\n\\n' + content.lstrip('\\n') }}
            {%- else %}
                {{- '<|im_start|>' + message.role + '\\n' + content }}
            {%- endif %}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- endif %}
        {%- if message.tool_calls %}
            {%- for tool_call in message.tool_calls %}
                {%- if (loop.first and content) or (not loop.first) %}
                    {{- '\\n' }}
                {%- endif %}
                {%- if tool_call.function %}
                    {%- set tool_call = tool_call.function %}
                {%- endif %}
                {{- '<tool_call>\\n{"name": "' }}
                {{- tool_call.name }}
                {{- '", "arguments": ' }}
                {%- if tool_call.arguments is string %}
                    {{- tool_call.arguments }}
                {%- else %}
                    {{- tool_call.arguments | tojson }}
                {%- endif %}
                {{- '}\\n</tool_call>' }}
            {%- endfor %}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}"""

MISTRAL_STYLE = """{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content'] %}
    {%- set loop_messages = messages[1:] %}
{%- else %}
    {%- set loop_messages = messages %}
{%- endif %}

{{- bos_token }}
{%- for message in loop_messages %}
    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}
        {{- raise_exception('After the optional system message, conversation roles must alternate user/assistant/user/assistant/...') }}
    {%- endif %}
    {%- if message['role'] == 'user' %}
        {%- if loop.first and system_message is defined %}
            {{- ' [INST] ' + system_message + '\\n\\n' + message['content'] + ' [/INST]' }}
        {%- else %}
            {{- ' [INST] ' + message['content'] + ' [/INST]' }}
        {%- endif %}
    {%- elif message['role'] == 'assistant' %}
        {{- ' ' + message['content'] + eos_token}}
    {%- else %}
        {{- raise_exception('Only user and assistant roles are supported, with the exception of an initial optional system message!') }}
    {%- endif %}
{%- endfor %}
"""

CHAT_TEMPLATES = {"llama31": LLAMA31_STYLE, "qwen25": QWEN25_STYLE,
                  "qwen3": QWEN3_STYLE, "mistral": MISTRAL_STYLE}

TOOLS = [
    {"name": "get_weather", "description": "Weather <now> & 'later'",
     "parameters": {"type": "object", "properties": {
         "city": {"type": "string", "description": "Zürich, 東京"},
         "days": {"type": "integer"}}, "required": ["city"]}},
    {"name": "add", "description": "Add two numbers",
     "parameters": {"type": "object", "properties": {
         "a": {"type": "number"}, "b": {"type": "number"}}}},
]
WORDS = ["hello", "Zürich", "東京", "  padded  ", "line\nbreak", "<b>&'\"",
         "</think>", "<think>why</think>answer", "🎉", "", "<tool_response>"]


def _conversation(rng, tools: bool) -> list:
    msgs = []
    if rng.random() < 0.5:
        msgs.append({"role": "system",
                     "content": " ".join(rng.choice(WORDS, 3))})
    for turn in range(int(rng.integers(1, 4))):
        msgs.append({"role": "user",
                     "content": " ".join(rng.choice(WORDS, 4))})
        if tools and rng.random() < 0.4:
            msgs.append({"role": "assistant", "content": "",
                         "tool_calls": [{"type": "function", "function": {
                             "name": "get_weather",
                             "arguments": {"city": "東京", "days": 3}}}]})
            msgs.append({"role": "tool",
                         "content": '{"temp": 21, "sky": "clear"}'})
        if turn < 2:
            msgs.append({"role": "assistant",
                         "content": " ".join(rng.choice(WORDS, 2))})
    if rng.random() < 0.5 and msgs[-1]["role"] == "assistant":
        msgs.pop()
    return msgs


@pytest.mark.parametrize("name", sorted(CHAT_TEMPLATES))
@pytest.mark.parametrize("tools", [False, True])
@pytest.mark.parametrize("gen", [False, True])
def test_chat_templates_render_as_transformers(name, tools, gen):
    rng = np.random.default_rng([len(name), int(tools), int(gen)])
    outcomes = set()
    for _ in range(12):
        ctx = {"messages": _conversation(rng, tools),
               "tools": TOOLS if tools else None, "documents": None,
               "add_generation_prompt": gen, "bos_token": "<s>",
               "eos_token": "</s>", "unk_token": "<unk>",
               "additional_special_tokens": ["[INST]", "[/INST]"]}
        outcomes.add(_same("chat", CHAT_TEMPLATES[name], ctx)[0])
        ctx["date_string"] = "26 Jul 2024"
        ctx["enable_thinking"] = False
        _same("chat", CHAT_TEMPLATES[name], ctx)
    assert "ok" in outcomes


# (source, context) pairs over every construct of the subset; each runs
# in both environments
CASES = [
    ("{{ a }}|{{ a.b }}|{{ a['c'] }}|{{ a.missing }}",
     {"a": {"b": 1, "c": [1, 2]}}),
    ("{% if x %}A{% elif y %}B{% else %}C{% endif %}", {"x": 0, "y": "s"}),
    ("{% for i in xs if i % 2 %}{{ loop.index }}/{{ loop.index0 }}/"
     "{{ loop.first }}/{{ loop.last }}/{{ loop.length }}/{{ loop.revindex }}"
     ";{% else %}none{% endfor %}", {"xs": [1, 2, 3, 5, 8]}),
    ("{% for i in xs %}{{ i }}{% else %}none{% endfor %}", {"xs": []}),
    ("{% for k, v in d.items() %}{{ k }}={{ v }};{% endfor %}",
     {"d": {"z": 1, "a": [2]}}),
    ("{% for k, v in d|items %}{{ k }}={{ v }};{% endfor %}",
     {"d": {"z": 1, "a": 2}}),
    ("{% set x = 0 %}{% for i in [1,2,3] %}{% set x = x + i %}{{ x }}"
     "{% endfor %}{{ x }}", {}),
    ("{% set ns = namespace(n=0, s='') %}{% for i in range(4) %}"
     "{% set ns.n = ns.n + i %}{% set ns.s = ns.s ~ i %}{% endfor %}"
     "{{ ns.n }} {{ ns.s }}", {}),
    ("{% set a, b = [1, 2] %}{{ b }}{{ a }}", {}),
    ("{% set t %}inner {{ 1 + 1 }}{% endset %}[{{ t }}]", {}),
    ("{% macro tag(name, attr='x') %}<{{ name }} {{ attr }}>"
     "{% endmacro %}{{ tag('a') }}{{ tag('b', attr='y') }}", {}),
    ("{% macro box(t) %}[{{ t }}:{{ caller() }}]{% endmacro %}"
     "{% call box('k') %}body{% endcall %}", {}),
    ("{% raw %}{{ not rendered }}{% endraw %}", {}),
    ("a {# a comment #} b {#- trimmed -#} c", {}),
    ("{{ 'x' if y else 'z' }}|{{ 'x' if y }}|{{ 1 + 2 * 3 - 4 / 2 }}|"
     "{{ 7 // 2 }}|{{ 7 % 3 }}|{{ 2 ** 10 }}|{{ -3 }}|{{ 'a' ~ 1 ~ none }}",
     {"y": False}),
    ("{{ 1 < 2 <= 2 }}{{ 'b' in 'abc' }}{{ 3 not in [1, 2] }}"
     "{{ not true or false and true }}{{ [1] == [1] }}{{ 1 != 1.0 }}", {}),
    ("{{ s.strip() }}|{{ s.split(',') }}|{{ s.startswith(' a') }}|"
     "{{ s.endswith('c ') }}|{{ s.replace('b', 'B') }}|{{ s.upper() }}|"
     "{{ s.lstrip() }}|{{ s.rstrip() }}|{{ s.title() }}",
     {"s": " a,b,c "}),
    ("{{ d.get('k') }}|{{ d.get('z', 9) }}|{{ d.keys()|list }}|"
     "{{ d.values()|list }}|{{ d.items()|list }}", {"d": {"k": 1}}),
    ("{{ xs[1:] }}{{ xs[:-1] }}{{ xs[::-1] }}{{ xs[::2] }}{{ 'hello'[1:4] }}"
     "{{ xs[-1] }}{{ xs.0 }}", {"xs": [1, 2, 3, 4]}),
    ("{{ s|trim }}|{{ s|length }}|{{ s|upper }}|{{ s|lower }}|"
     "{{ s|capitalize }}|{{ s|replace('a', 'o') }}|{{ s|string }}",
     {"s": "  aBc a  "}),
    ("{{ u|default('dflt') }}|{{ ''|default('e', true) }}|"
     "{{ xs|first }}|{{ xs|last }}|{{ xs|join(', ') }}|{{ xs|length }}|"
     "{{ xs|list }}|{{ '42.7'|int }}|{{ 'x'|int }}|{{ 3.9|int }}",
     {"xs": [3, 1, 2]}),
    ("{{ us|selectattr('a')|list }}|{{ us|rejectattr('a')|list }}|"
     "{{ us|selectattr('a', 'equalto', 2)|list }}|"
     "{{ us|map(attribute='a')|list }}|{{ us|map(attribute='a')|join }}|"
     "{{ ['a', 'b']|map('upper')|join }}",
     {"us": [{"a": 0}, {"a": 2}, {"a": 3}]}),
    ("{{ x is defined }}{{ u is undefined }}{{ n is none }}"
     "{{ s is string }}{{ d is mapping }}{{ xs is iterable }}"
     "{{ xs is sequence }}{{ 3 is number }}{{ true is true }}"
     "{{ false is false }}{{ s is not string }}{{ 4 is divisibleby 2 }}",
     {"x": 1, "n": None, "s": "s", "d": {}, "xs": [1]}),
    ("{{ v|tojson }}", {"v": {"b": "<é>&'", "a": [1, 2.5, None, True]}}),
    ("{{ v|tojson(indent=2) }}", {"v": {"b": "é", "a": {"c": [1]}}}),
    ("{{ 'tools' in d }}{{ d.tool_calls is defined }}", {"d": {"x": 1}}),
    ("  {% if true %}\n  yes\n  {% endif %}\nnext\n", {}),
    ("  {%+ if true %}\n  keep\n  {%- endif +%}\nafter", {}),
    ("{% for i in range(3) %}\n  {{ i }}\n{% endfor %}\n", {}),
    ("{%- for i in range(3) -%}\n  {{- i -}}\n{%- endfor -%}\n", {}),
    ("text\n    {#- c #}\n  {{ 1 }}\n", {}),
    ("{{ 'a' 'b' }}{{ \"q\\\"\\n\\u00e9\" }}{{ 'é' }}{{ 1.5e3 }}{{ 1_000 }}",
     {}),
    ("{{ (1, 2) }}{{ [1, 'a'] }}{{ {'k': 'v'} }}{{ none }}{{ True }}", {}),
    ("{{ u }}|{{ u|length }}|{{ u ~ 'x' }}|{% for x in u %}{{ x }}"
     "{% endfor %}|{{ u == u }}|{{ 1 in u }}", {}),
    ("{{ x | abs }}{{ -x|abs }}", {"x": -2}),
    ("{{ xs|reverse|list }}{{ 'abc'|reverse }}", {"xs": [1, 2]}),
    ("{% for a in [1, 2] %}{% for b in [3, 4] %}{{ loop.index }}{{ a }}{{ b }}"
     "{% endfor %}{% endfor %}", {}),
    ("{{ loop }}", {}),
    ("no trailing newline", {}),
    ("trailing newline\n", {}),
    ("{{ a.b.c }}", {"a": {"b": {"c": "deep"}}}),
    ("{{ x + 1 }}", {"x": 1.5}),
]

ERROR_CASES = [
    "{{ u + 1 }}",
    "{{ u.attr }}",
    "{{ u() }}",
    "{{ raise_exception('bad role') }}",
    "{% if x %}unclosed",
    "{% for x in y %}{% endif %}",
    "{{ x | nosuchfilter }}",
    "{{ x is nosuchtest }}",
    "{% set d = {} %}{% set d.x = 1 %}",
    "{% endfor %}",
    "{{ 'a' + 1 }}",
    "{{ {}.x.y }}",
]

# constructs the subset does not read: the port refuses them at parse
# time, where jinja2 may fail later or differently (a loader, an extension)
UNREAD_CASES = [
    "{% include 'other' %}",
    "{% extends 'base' %}",
    "{% filter upper %}x{% endfilter %}",
    "{% with a = 1 %}{{ a }}{% endwith %}",
    "{% for x in y recursive %}{{ loop(x) }}{% endfor %}",
    "{{ 1 +* 2 }}",
]

CHAT_ONLY_ERRORS = [
    "{% set xs = [1] %}{{ xs.append(2) }}",
    "{% set xs = [1] %}{{ xs.pop() }}",
    "{% set d = {} %}{{ d.update({'a': 1}) }}",
]


@pytest.mark.parametrize("env_name", ["chat", "config"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_constructs_render_as_jinja2(env_name, case):
    source, ctx = CASES[case]
    _same(env_name, source, ctx)


@pytest.mark.parametrize("env_name", ["chat", "config"])
@pytest.mark.parametrize("source", ERROR_CASES)
def test_errors_fail_as_jinja2(env_name, source):
    kind, message = _same(env_name, source, {"x": 1, "y": [1]})
    assert kind == "error", message


@pytest.mark.parametrize("source", UNREAD_CASES)
def test_unread_constructs_raise(source):
    for make in (_port_chat_env, jinja_lite.Environment.config):
        with pytest.raises(jinja_lite.TemplateError):
            make().from_string(source).render(y=[1])


@pytest.mark.parametrize("source", CHAT_ONLY_ERRORS)
def test_sandbox_refusals_raise_as_transformers(source):
    kind, message = _same("chat", source, {})
    assert kind == "error" and "is unsafe" in message


def test_private_attributes_render_empty_in_the_sandbox():
    assert _same("chat", "[{{ ''.__class__ }}]", {}) == ("ok", "[]")


def test_loop_controls_are_chat_only():
    src = "{% for i in range(5) %}{% if i == 3 %}{% break %}{% endif %}" \
          "{% if i == 1 %}{% continue %}{% endif %}{{ i }}{% endfor %}"
    assert _same("chat", src, {}) == ("ok", "02")
    assert _same("config", src, {})[0] == "error"


def test_config_env_mutates_as_plain_jinja2():
    src = "{% set xs = [1] %}{{ xs.append(2) }}{{ xs }}"
    assert _same("config", src, {}) == ("ok", "None[1, 2]")


def test_syntax_error_names_the_template_line():
    src = "line one\n{% if x %}\nline three\n{{ x |}}\n{% endif %}"
    with pytest.raises(jinja_lite.TemplateSyntaxError) as e:
        jinja_lite.Environment.chat().from_string(src)
    assert e.value.lineno == 4
    with pytest.raises(jinja_lite.TemplateSyntaxError, match="unknown tag"):
        jinja_lite.Environment.chat().from_string("{% with a = 1 %}{% endwith %}")


def test_strftime_now_is_the_host_clock():
    out = jinja_lite.Environment.chat().from_string(
        "{{ strftime_now('%Y') }}").render()
    from datetime import datetime

    assert out == datetime.now().strftime("%Y")
