"""Grammar sources for guided decoding: OpenAI request -> regex.

This is the vocab-independent half of the grammar compiler, shared by
the FRONTEND (which lowers ``response_format`` / forced ``tool_choice``
to a regex source at the edge, so an unsupported schema is a typed 400
before any slot or page is touched) and the ENGINE (which lowers that
source to a token-mask automaton in guided/runtime.py). The split keeps
the wire payload tiny — one regex string + cache key — while both sides
agree on semantics by construction.

Schema coverage follows the strict structured-output contract (the
OpenAI ``json_schema`` + ``strict`` rules, which are also what makes
regular-language lowering exact): every declared property is required,
``additionalProperties`` must not be truthy, and the supported keywords
are type/enum/const/properties/items/anyOf/oneOf/min-maxItems/
min-maxLength. Generic ``json_object`` output is a JSON value grammar
at bounded nesting depth (a pure-regex lowering cannot count braces;
``DEFAULT_JSON_DEPTH`` levels cover the agentic payloads this targets).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

from dynamo_tpu_torch.guided.regex_dfa import parse_regex

__all__ = [
    "GrammarError",
    "DEFAULT_JSON_DEPTH",
    "schema_to_regex",
    "json_value_regex",
    "json_object_regex",
    "tool_call_regex",
    "grammar_from_request",
]


class GrammarError(ValueError):
    """Unsupported or malformed grammar request (maps to a client 400)."""


DEFAULT_JSON_DEPTH = 4

# inter-token whitespace the model may emit between structural chars.
# BOUNDED on purpose: an unbounded run would let a wandering model sit
# in a whitespace self-loop forever, while a bounded one forces
# structural progress — and, once the grammar is satisfied, forces the
# mask down to EOS-only within a few tokens (guaranteed termination)
_WS = "[ \\n\\t\\r]{0,3}"
# JSON string body char: anything but quote/backslash/controls, or escape
_STR_CHAR = '([^"\\\\\\u0000-\\u001f]|\\\\(["\\\\/bfnrt]|u[0-9a-fA-F]{4}))'
_STRING = f'"{_STR_CHAR}*"'
_INTEGER = "-?(0|[1-9][0-9]*)"
_NUMBER = f"{_INTEGER}(\\.[0-9]+)?([eE][+-]?[0-9]+)?"
_BOOLEAN = "(true|false)"
_NULL = "null"

_REGEX_SPECIAL = set("\\.[]{}()*+?|^$-")


def _lit(text: str) -> str:
    """Escape a literal string into regex source."""
    out = []
    for ch in text:
        if ch in _REGEX_SPECIAL:
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    return "".join(out)


def _json_lit(value: Any) -> str:
    """A regex matching exactly the canonical JSON encoding of value."""
    return _lit(json.dumps(value, ensure_ascii=False))


def json_value_regex(depth: int = DEFAULT_JSON_DEPTH) -> str:
    """Any JSON value, containers nesting at most ``depth`` levels."""
    scalar = f"({_STRING}|{_NUMBER}|{_BOOLEAN}|{_NULL})"
    value = scalar
    for _ in range(max(0, depth)):
        obj = (
            f"\\{{{_WS}({_STRING}{_WS}:{_WS}{value}"
            f"({_WS},{_WS}{_STRING}{_WS}:{_WS}{value})*)?{_WS}\\}}"
        )
        arr = f"\\[{_WS}({value}({_WS},{_WS}{value})*)?{_WS}\\]"
        value = f"({scalar}|{obj}|{arr})"
    return value


def json_object_regex(depth: int = DEFAULT_JSON_DEPTH) -> str:
    """A JSON object (the ``response_format: json_object`` contract —
    the top level must be an object, not a bare scalar/array)."""
    inner = json_value_regex(max(0, depth - 1))
    return (
        f"\\{{{_WS}({_STRING}{_WS}:{_WS}{inner}"
        f"({_WS},{_WS}{_STRING}{_WS}:{_WS}{inner})*)?{_WS}\\}}"
    )


def _string_schema_regex(schema: dict) -> str:
    lo = schema.get("minLength")
    hi = schema.get("maxLength")
    if lo is None and hi is None:
        return _STRING
    lo = int(lo or 0)
    if hi is None:
        return f'"{_STR_CHAR}{{{lo},}}"'
    hi = int(hi)
    if hi < lo:
        raise GrammarError("maxLength < minLength")
    return f'"{_STR_CHAR}{{{lo},{hi}}}"'


def _array_schema_regex(schema: dict, depth: int) -> str:
    item = schema_to_regex(schema.get("items", {}), depth - 1)
    lo = int(schema.get("minItems") or 0)
    hi = schema.get("maxItems")
    more = f"{_WS},{_WS}{item}"
    if hi is None:
        if lo == 0:
            body = f"({item}({more})*)?"
        else:
            body = f"{item}({more}){{{lo - 1},}}"
    else:
        hi = int(hi)
        if hi < lo or hi > 64:
            raise GrammarError("bad minItems/maxItems (need lo <= hi <= 64)")
        if lo == 0:
            body = f"({item}({more}){{0,{max(hi - 1, 0)}}})?" if hi else ""
        else:
            body = f"{item}({more}){{{lo - 1},{hi - 1}}}"
    return f"\\[{_WS}{body}{_WS}\\]"


def _object_schema_regex(schema: dict, depth: int) -> str:
    props = schema.get("properties") or {}
    if not isinstance(props, dict):
        raise GrammarError("'properties' must be an object")
    if schema.get("additionalProperties"):
        raise GrammarError(
            "additionalProperties is not supported in guided schemas "
            "(strict structured output)"
        )
    required = schema.get("required")
    if required is not None and set(required) != set(props):
        raise GrammarError(
            "guided schemas follow strict structured output: every "
            "declared property must be listed in 'required' "
            f"(missing: {sorted(set(props) - set(required))})"
        )
    if not props:
        return f"\\{{{_WS}\\}}"
    parts = []
    for i, (name, sub) in enumerate(props.items()):
        sep = f"{_WS},{_WS}" if i else ""
        parts.append(
            f"{sep}{_json_lit(name)}{_WS}:{_WS}"
            f"{schema_to_regex(sub, depth - 1)}"
        )
    return f"\\{{{_WS}{''.join(parts)}{_WS}\\}}"


_SUPPORTED_KEYS = {
    "type", "enum", "const", "properties", "required",
    "additionalProperties", "items", "minItems", "maxItems", "minLength",
    "maxLength", "anyOf", "oneOf", "title", "description", "default",
    "$schema", "examples",
}


def schema_to_regex(schema: Any, depth: int = DEFAULT_JSON_DEPTH) -> str:
    """One JSON-Schema node -> regex source. Raises GrammarError on
    anything outside the supported strict subset (the 400 contract —
    a schema we cannot GUARANTEE must be refused, not approximated)."""
    if depth < 0:
        raise GrammarError(
            f"schema nests deeper than the supported {DEFAULT_JSON_DEPTH} "
            "levels"
        )
    if not isinstance(schema, dict):
        raise GrammarError("schema must be an object")
    unknown = set(schema) - _SUPPORTED_KEYS
    if unknown:
        raise GrammarError(
            f"unsupported schema keyword(s) {sorted(unknown)} (supported: "
            "type/enum/const/properties+required/items/anyOf/oneOf/"
            "min-maxItems/min-maxLength)"
        )
    if "const" in schema:
        return _json_lit(schema["const"])
    if "enum" in schema:
        options = schema["enum"]
        if not isinstance(options, list) or not options:
            raise GrammarError("'enum' must be a non-empty array")
        return "(" + "|".join(_json_lit(v) for v in options) + ")"
    for alt_key in ("anyOf", "oneOf"):
        if alt_key in schema:
            subs = schema[alt_key]
            if not isinstance(subs, list) or not subs:
                raise GrammarError(f"'{alt_key}' must be a non-empty array")
            return (
                "("
                + "|".join(schema_to_regex(s, depth) for s in subs)
                + ")"
            )
    t = schema.get("type")
    if isinstance(t, list):
        if not t:
            raise GrammarError("'type' must not be empty")
        return (
            "("
            + "|".join(
                schema_to_regex({**schema, "type": one}, depth) for one in t
            )
            + ")"
        )
    if t == "string":
        return _string_schema_regex(schema)
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return _BOOLEAN
    if t == "null":
        return _NULL
    if t == "array":
        return _array_schema_regex(schema, depth)
    if t == "object" or (t is None and "properties" in schema):
        return _object_schema_regex(schema, depth)
    if t is None:
        # untyped node: any JSON value at the remaining depth
        return json_value_regex(min(depth, 2))
    raise GrammarError(f"unsupported schema type {t!r}")


# --------------------------------------------------------- tool grammars


def tool_call_regex(tools: list, tool_cfg, name: str | None = None) -> str:
    """Grammar for a forced tool call, shaped so the model's configured
    tool parser (parsers/tool_calls.py) parses the guaranteed output:
    the parser's own markers wrap a ``{"name": ..., "arguments": ...}``
    object whose arguments conform to that tool's parameter schema.
    ``name=None`` means any declared tool (``tool_choice: required``)."""
    if tool_cfg is None:
        raise GrammarError(
            "this model has no tool-call parser configured; forced "
            "tool_choice needs one (worker --tool-call-parser)"
        )
    if getattr(tool_cfg, "format", "json") != "json":
        raise GrammarError(
            f"guided tool calls are unsupported for the "
            f"{tool_cfg.format!r} tool-parser format (json-format "
            "parsers only)"
        )
    bodies = []
    for t in tools or ():
        fn = (t or {}).get("function") or {}
        fn_name = fn.get("name")
        if not isinstance(fn_name, str) or not fn_name:
            continue
        if name is not None and fn_name != name:
            continue
        params = fn.get("parameters")
        if params is None:
            args_re = json_object_regex(2)
        else:
            args_re = schema_to_regex(params)
        name_key = (tool_cfg.name_keys or ["name"])[0]
        arg_key = (tool_cfg.arg_keys or ["arguments"])[0]
        bodies.append(
            f"\\{{{_WS}{_json_lit(name_key)}{_WS}:{_WS}"
            f"{_json_lit(fn_name)}{_WS},{_WS}{_json_lit(arg_key)}"
            f"{_WS}:{_WS}{args_re}{_WS}\\}}"
        )
    if not bodies:
        raise GrammarError(
            f"tool_choice names {name!r} but no such tool is declared"
            if name is not None else "tool_choice requires 'tools'"
        )
    body = bodies[0] if len(bodies) == 1 else "(" + "|".join(bodies) + ")"
    start = tool_cfg.start_markers[0] if tool_cfg.start_markers else ""
    end = tool_cfg.end_markers[0] if tool_cfg.end_markers else ""
    if tool_cfg.bare_json_start:
        # llama3_json/mistral style: the jail triggers on the bare
        # leading '{', so the payload goes unmarked
        start = end = ""
    return f"{_lit(start)}{_WS}{body}{_WS}{_lit(end)}"


# ------------------------------------------------------ request lowering


def _forced_tool_name(tool_choice: Any) -> str | None:
    if isinstance(tool_choice, dict):
        fn = tool_choice.get("function") or {}
        name = fn.get("name")
        if tool_choice.get("type") != "function" or not isinstance(name, str):
            raise GrammarError(
                "tool_choice object must be "
                '{"type": "function", "function": {"name": ...}}'
            )
        return name
    return None


def grammar_from_request(
    request: dict,
    *,
    tool_cfg=None,
    json_depth: int = DEFAULT_JSON_DEPTH,
) -> dict | None:
    """OpenAI request -> guided-grammar wire spec, or None when nothing
    constrains generation. Raises GrammarError (a ValueError -> 400) on
    malformed/unsupported grammar requests.

    Selection order: a forced tool call (``tool_choice: required`` or a
    named function) wins over ``response_format``, which wins over the
    ``nvext.guided_regex`` escape hatch.
    """
    tc = request.get("tool_choice")
    kind = src = None
    if tc is not None and tc not in ("none", "auto"):
        if not isinstance(tc, (str, dict)):
            raise GrammarError("tool_choice must be a string or object")
        if isinstance(tc, str) and tc != "required":
            raise GrammarError(
                f"unknown tool_choice {tc!r} (none | auto | required | "
                "named function)"
            )
        tools = request.get("tools")
        if not tools:
            raise GrammarError("tool_choice requires 'tools'")
        kind = "tool_call"
        src = tool_call_regex(tools, tool_cfg, _forced_tool_name(tc))
    if src is None:
        rf = request.get("response_format")
        if rf is not None:
            if not isinstance(rf, dict):
                raise GrammarError("response_format must be an object")
            t = rf.get("type")
            if t in (None, "text"):
                pass
            elif t == "json_object":
                kind, src = "json_object", json_object_regex(json_depth)
            elif t == "json_schema":
                js = rf.get("json_schema")
                if not isinstance(js, dict) or not isinstance(
                    js.get("schema"), dict
                ):
                    raise GrammarError(
                        "response_format.json_schema.schema must be an "
                        "object"
                    )
                kind, src = "json_schema", schema_to_regex(
                    js["schema"], json_depth
                )
            else:
                raise GrammarError(
                    f"unsupported response_format type {t!r} "
                    "(text | json_object | json_schema)"
                )
    if src is None:
        nvext = request.get("nvext")
        if isinstance(nvext, dict) and nvext.get("guided_regex"):
            pattern = nvext["guided_regex"]
            if not isinstance(pattern, str):
                raise GrammarError("nvext.guided_regex must be a string")
            kind, src = "regex", f"{pattern}"
    if src is None:
        return None
    # allow leading/trailing whitespace around the payload: chat models
    # routinely open with a newline, and the trailing run gives the
    # automaton a place to sit while the model emits EOS. The payload is
    # grouped so a top-level alternation (nvext.guided_regex "yes|no")
    # binds the affixes to the WHOLE pattern, not its outer branches.
    src = f"{_WS}({src}){_WS}"
    try:
        parse_regex(src)
    except ValueError as e:
        raise GrammarError(f"grammar does not lower to a valid pattern: {e}") from e
    return {
        "kind": kind,
        "regex": src,
        "key": hashlib.sha256(src.encode()).hexdigest()[:16],
    }
