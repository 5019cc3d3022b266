"""Tool-call parsing over complete model output.

Parser registry mirrors the reference's map (tool_calling/parsers.rs:
hermes, nemotron_deci, llama3_json, mistral, phi4, pythonic, default) with
the same marker conventions (tool_calling/config.rs), re-derived for
Python:

  hermes        <tool_call>{...}</tool_call>
  nemotron_deci <TOOLCALL>[{...}]</TOOLCALL>
  llama3_json   <|python_tag|>{...}  or bare {...}
  mistral       [TOOL_CALLS][{...}]  or bare [{...}]
  phi4          functools[{...}]
  pythonic      [get_weather(location="SF"), f2()]
  default       <TOOLCALL>/<|python_tag|> + json

JSON payloads may be one object or a list; the function name comes from
the first present name key ("name"), arguments from "arguments" or
"parameters" (serialized back to a JSON string for the OpenAI surface).

A copy of ``dynamo_tpu/parsers/tool_calls.py``.
"""

from __future__ import annotations

import ast
import json
import uuid
from dataclasses import dataclass, field

__all__ = ["ToolCall", "ToolCallConfig", "TOOL_PARSERS", "make_tool_config",
           "parse_tool_calls"]


@dataclass
class ToolCall:
    name: str
    arguments: str  # JSON-encoded string (OpenAI wire format)
    id: str = field(default_factory=lambda: f"call-{uuid.uuid4().hex[:24]}")

    def to_openai(self, index: int) -> dict:
        return {
            "index": index,
            "id": self.id,
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


@dataclass
class ToolCallConfig:
    format: str = "json"  # "json" | "pythonic"
    start_markers: list[str] = field(
        default_factory=lambda: ["<TOOLCALL>", "<|python_tag|>"]
    )
    end_markers: list[str] = field(default_factory=lambda: ["</TOOLCALL>"])
    name_keys: list[str] = field(default_factory=lambda: ["name"])
    arg_keys: list[str] = field(
        default_factory=lambda: ["arguments", "parameters"]
    )
    # jail also triggers on a bare leading '{' / '[' (llama3/mistral style)
    bare_json_start: bool = False


def _cfg(**kw) -> ToolCallConfig:
    return ToolCallConfig(**kw)


TOOL_PARSERS: dict[str, ToolCallConfig] = {
    "hermes": _cfg(start_markers=["<tool_call>"], end_markers=["</tool_call>"]),
    "nemotron_deci": _cfg(start_markers=["<TOOLCALL>"], end_markers=["</TOOLCALL>"]),
    "llama3_json": _cfg(start_markers=["<|python_tag|>"], end_markers=[],
                        bare_json_start=True),
    "mistral": _cfg(start_markers=["[TOOL_CALLS]"], end_markers=[],
                    bare_json_start=True),
    "phi4": _cfg(start_markers=["functools"], end_markers=[]),
    "pythonic": _cfg(format="pythonic", start_markers=["["], end_markers=["]"]),
    # gpt-oss harmony channels (ref lib/parsers/src/tool_calling/harmony/):
    # <|channel|>commentary to=functions.NAME <|constrain|>json
    # <|message|>{...args...}<|call|>
    "harmony": _cfg(
        format="harmony",
        start_markers=["<|channel|>commentary to="],
        end_markers=["<|call|>"],
    ),
    "default": _cfg(),
}


def make_tool_config(name: str | None) -> ToolCallConfig | None:
    if not name:
        return None
    try:
        return TOOL_PARSERS[name]
    except KeyError:
        raise ValueError(
            f"unknown tool parser {name!r}; choose from {sorted(TOOL_PARSERS)}"
        ) from None


# ----------------------------------------------------------------- parsing


def _json_candidates(payload: str) -> list[dict]:
    """Parse a region's JSON: a dict, a list of dicts, or concatenated
    dicts separated by whitespace/semicolons/commas."""
    payload = payload.strip().rstrip(";")
    if not payload:
        return []
    try:
        data = json.loads(payload)
        if isinstance(data, dict):
            return [data]
        if isinstance(data, list):
            return [d for d in data if isinstance(d, dict)]
    except json.JSONDecodeError:
        pass
    # brace-matched scan for multiple/embedded objects
    out: list[dict] = []
    depth, start = 0, None
    in_str, esc = False, False
    for i, ch in enumerate(payload):
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
        elif ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0 and start is not None:
                try:
                    obj = json.loads(payload[start : i + 1])
                    if isinstance(obj, dict):
                        out.append(obj)
                except json.JSONDecodeError:
                    pass
                start = None
    return out


def _calls_from_objects(objs: list[dict], cfg: ToolCallConfig) -> list[ToolCall]:
    calls = []
    for obj in objs:
        name = next(
            (obj[k] for k in cfg.name_keys if isinstance(obj.get(k), str)), None
        )
        if not name:
            continue
        args = next((obj[k] for k in cfg.arg_keys if k in obj), {})
        if not isinstance(args, str):
            args = json.dumps(args)
        calls.append(ToolCall(name=name, arguments=args))
    return calls


def _parse_harmony_region(region: str) -> list[ToolCall]:
    """One harmony commentary region (start marker already stripped):
    ``functions.get_weather <|constrain|>json<|message|>{"city": "x"}``.
    The recipient header names the function; the payload after
    <|message|> is its (usually JSON) arguments."""
    head, sep, payload = region.partition("<|message|>")
    if not sep:
        return []
    name = head.split("<|")[0].strip()
    name = name.removeprefix("functions.")
    if not name:
        return []
    objs = _json_candidates(payload)
    args = json.dumps(objs[0]) if objs else payload.strip()
    return [ToolCall(name=name, arguments=args)]


def _parse_pythonic(payload: str) -> list[ToolCall]:
    """``[f(a=1), g(x="s")]`` -> calls; literal kwargs only."""
    payload = payload.strip()
    if not payload.startswith("["):
        payload = f"[{payload}]"
    try:
        tree = ast.parse(payload, mode="eval")
    except SyntaxError:
        return []
    if not isinstance(tree.body, ast.List):
        return []
    calls = []
    for node in tree.body.elts:
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute):
            parts = []
            cur = node.func
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                parts.append(cur.id)
            name = ".".join(reversed(parts))
        else:
            continue
        args = {}
        ok = True
        for kw in node.keywords:
            try:
                args[kw.arg] = ast.literal_eval(kw.value)
            except (ValueError, SyntaxError):
                ok = False
                break
        if ok:
            calls.append(ToolCall(name=name, arguments=json.dumps(args)))
    return calls


def parse_tool_calls(
    text: str, cfg: ToolCallConfig
) -> tuple[list[ToolCall], str]:
    """Complete-text parse -> (tool calls, normal content outside calls)."""
    if cfg.format == "pythonic":
        stripped = text.strip()
        if stripped.startswith("[") and stripped.endswith("]"):
            calls = _parse_pythonic(stripped)
            if calls:
                return calls, ""
        return [], text

    calls: list[ToolCall] = []
    normal: list[str] = []
    rest = text
    while True:
        idx, marker = -1, None
        for m in cfg.start_markers:
            i = rest.find(m)
            if i >= 0 and (idx < 0 or i < idx):
                idx, marker = i, m
        if marker is None:
            if cfg.bare_json_start and not calls:
                s = rest.lstrip()
                if s[:1] in ("{", "["):
                    got = _calls_from_objects(_json_candidates(s), cfg)
                    if got:
                        return got, ""
            normal.append(rest)
            break
        normal.append(rest[:idx])
        region = rest[idx + len(marker):]
        end_idx = -1
        end_marker = None
        for m in cfg.end_markers:
            j = region.find(m)
            if j >= 0 and (end_idx < 0 or j < end_idx):
                end_idx, end_marker = j, m
        if end_marker is not None:
            payload, rest = region[:end_idx], region[end_idx + len(end_marker):]
        else:
            payload, rest = region, ""
        if cfg.format == "harmony":
            calls.extend(_parse_harmony_region(payload))
        else:
            calls.extend(_calls_from_objects(_json_candidates(payload), cfg))
        if not rest:
            break
    return calls, "".join(normal).strip()
