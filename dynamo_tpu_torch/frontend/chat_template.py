"""A checkpoint's chat template, rendered as transformers renders it.

The reference renders through ``transformers``' ``apply_chat_template``
(``utils/chat_template_utils.py`` in transformers 4.57); this module keeps
a copy of what that does, without transformers:

- jinja2's ``ImmutableSandboxedEnvironment(trim_blocks=True,
  lstrip_blocks=True)`` with the ``loopcontrols`` extension and a
  ``{% generation %}`` block that renders its body unchanged;
- a ``tojson`` filter with ``ensure_ascii=False`` and its ``indent`` /
  ``separators`` / ``sort_keys`` arguments, and the ``raise_exception`` and
  ``strftime_now`` globals;
- the special-token strings (``bos_token``, ``eos_token``, ...), ``tools``
  and ``documents`` (always None here) as variables.

The template comes from ``chat_template.jinja`` (plus any
``additional_chat_templates/*.jinja``, by name) or else from
``tokenizer_config.json``'s ``chat_template``, a string or a list of named
templates. With several, ``tool_use`` serves requests with tools when
present and ``default`` serves the rest, as in transformers.
"""

from __future__ import annotations

import functools
import json
import os
from datetime import datetime
from typing import Any

__all__ = ["ChatTemplate"]

TEMPLATE_FILE = "chat_template.jinja"
TEMPLATE_DIR = "additional_chat_templates"


@functools.lru_cache(maxsize=16)
def _compile(source: str):
    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    class Generation(jinja2.ext.Extension):
        """``{% generation %}...{% endgeneration %}``: the body, unchanged
        (transformers tracks assistant spans with it; a plain render does
        not)."""

        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(["name:endgeneration"], drop_needle=True)
            return jinja2.nodes.CallBlock(
                self.call_method("_body"), [], [], body).set_lineno(lineno)

        def _body(self, caller):
            return caller()

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        # unlike jinja2's own filter: no HTML escaping
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(format):
        return datetime.now().strftime(format)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[Generation, jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(source)


class ChatTemplate:
    def __init__(self, template: str | dict[str, str] | None):
        self.template = template

    @classmethod
    def from_dir(cls, path: str, config: dict) -> "ChatTemplate":
        templates: dict[str, str] = {}
        file = os.path.join(path, TEMPLATE_FILE)
        if os.path.exists(file):
            with open(file, encoding="utf-8") as f:
                templates["default"] = f.read()
        extra = os.path.join(path, TEMPLATE_DIR)
        if os.path.isdir(extra):
            for name in sorted(os.listdir(extra)):
                if name.endswith(".jinja"):
                    with open(os.path.join(extra, name), encoding="utf-8") as f:
                        templates[name.removesuffix(".jinja")] = f.read()
        if list(templates) == ["default"]:
            return cls(templates["default"])
        if templates:
            return cls(templates)
        t = config.get("chat_template")
        if isinstance(t, (list, tuple)):
            t = {e["name"]: e["template"] for e in t}
        return cls(t)

    def source(self, tools: list | None = None) -> str:
        """The template a request renders with (transformers'
        get_chat_template)."""
        t = self.template
        if isinstance(t, dict):
            if tools is not None and "tool_use" in t:
                return t["tool_use"]
            if "default" in t:
                return t["default"]
            raise ValueError(
                "This model has multiple chat templates with no default "
                "specified! Available template names are "
                f"{sorted(t)}.")
        if t is None:
            raise ValueError(
                "Cannot use chat template functions because "
                "tokenizer.chat_template is not set and no template argument "
                "was passed!")
        return t

    def render(self, messages: list[dict], *, add_generation_prompt: bool = True,
               tools: list[dict] | None = None,
               special_tokens: dict[str, Any] | None = None) -> str:
        if tools is not None:
            for t in tools:
                if not isinstance(t, dict):
                    raise ValueError("tools must be JSON schemas (dicts)")
        return _compile(self.source(tools)).render(
            messages=messages, tools=tools, documents=None,
            add_generation_prompt=add_generation_prompt, **(special_tokens or {}))
