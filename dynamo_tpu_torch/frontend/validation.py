"""Typed request validation for the OpenAI surface (a copy of
dynamo_tpu/frontend/validation.py).

Malformed bodies fail at the EDGE with an OpenAI-style
``invalid_request_error`` naming the offending param, not as a 500 from
deep inside template rendering or the engine.

One extension: a completions ``prompt`` may also be a list of token ids
(integers), as the OpenAI API allows; the preprocessor then skips
tokenization. The reference accepts strings only.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any

__all__ = [
    "RequestValidationError",
    "validate_request",
    "validate_tenancy",
]

_ROLES = {"system", "developer", "user", "assistant", "tool"}
_CONTENT_PART_TYPES = {"text", "image_url", "video_url"}

# tenancy edge validation (overload-control plane): the tenant id rides
# wire headers, metric labels, and log lines — constrain it to a safe
# charset/length HERE so a hostile header can't smuggle label injection
# or unbounded cardinality into every downstream surface
_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
_PRIORITIES = ("interactive", "batch")


def is_token_prompt(prompt: Any) -> bool:
    """A completions prompt given as a non-empty list of token ids."""
    return isinstance(prompt, list) and bool(prompt) and all(
        isinstance(t, int) and not isinstance(t, bool) and t >= 0 for t in prompt)


class RequestValidationError(ValueError):
    def __init__(self, message: str, param: str | None = None):
        super().__init__(message)
        self.param = param


def _fail(message: str, param: str | None = None) -> None:
    raise RequestValidationError(message, param)


def _check_number(
    body: dict, name: str, lo: float | None, hi: float | None,
    *, integer: bool = False,
) -> None:
    v = body.get(name)
    if v is None:
        return
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _fail(f"'{name}' must be a number", name)
    if integer and not isinstance(v, int):
        _fail(f"'{name}' must be an integer", name)
    if lo is not None and v < lo:
        _fail(f"'{name}' must be >= {lo}", name)
    if hi is not None and v > hi:
        _fail(f"'{name}' must be <= {hi}", name)


def _check_common(body: dict) -> None:
    _check_number(body, "temperature", 0.0, 2.0)
    _check_number(body, "top_p", 0.0, 1.0)
    _check_number(body, "top_k", 0, None, integer=True)
    _check_number(body, "max_tokens", 1, None, integer=True)
    _check_number(body, "max_completion_tokens", 1, None, integer=True)
    _check_number(body, "min_tokens", 0, None, integer=True)
    _check_number(body, "seed", None, None, integer=True)
    _check_number(body, "top_logprobs", 0, 20, integer=True)
    if not isinstance(body.get("stream", False), bool):
        _fail("'stream' must be a boolean", "stream")
    stop = body.get("stop")
    if stop is not None:
        if isinstance(stop, str):
            pass
        elif isinstance(stop, list):
            if len(stop) > 4:
                _fail("'stop' accepts at most 4 sequences", "stop")
            if not all(isinstance(s, str) for s in stop):
                _fail("'stop' entries must be strings", "stop")
        else:
            _fail("'stop' must be a string or list of strings", "stop")


def _check_messages(body: dict) -> None:
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        _fail("'messages' must be a non-empty array", "messages")
    for i, m in enumerate(messages):
        where = f"messages[{i}]"
        if not isinstance(m, dict):
            _fail(f"'{where}' must be an object", where)
        role = m.get("role")
        if not isinstance(role, str) or role not in _ROLES:
            _fail(
                f"'{where}.role' must be one of {sorted(_ROLES)}",
                f"{where}.role",
            )
        content = m.get("content")
        if content is None:
            if role != "assistant" or not m.get("tool_calls"):
                _fail(f"'{where}.content' is required", f"{where}.content")
            continue
        if isinstance(content, str):
            continue
        if isinstance(content, list):
            for j, part in enumerate(content):
                pw = f"{where}.content[{j}]"
                if not isinstance(part, dict):
                    _fail(f"'{pw}' must be an object", pw)
                ptype = part.get("type")
                if ptype not in _CONTENT_PART_TYPES:
                    _fail(
                        f"'{pw}.type' must be one of "
                        f"{sorted(_CONTENT_PART_TYPES)}",
                        f"{pw}.type",
                    )
                if ptype == "text" and not isinstance(part.get("text"), str):
                    _fail(f"'{pw}.text' must be a string", f"{pw}.text")
                if ptype in ("image_url", "video_url"):
                    iu = part.get(ptype)
                    url = iu.get("url") if isinstance(iu, dict) else iu
                    if not isinstance(url, str) or not url:
                        _fail(
                            f"'{pw}.{ptype}.url' must be a non-empty "
                            "string", f"{pw}.{ptype}",
                        )
            continue
        _fail(
            f"'{where}.content' must be a string or array of parts",
            f"{where}.content",
        )


_RESPONSE_FORMAT_TYPES = {"text", "json_object", "json_schema"}


def _check_response_format(body: dict) -> None:
    """Structural checks for the guided-decoding surface: a malformed
    ``response_format`` must 400 at the edge, not surface as a 500 (or
    worse, be silently dropped) once the stream is running."""
    rf = body.get("response_format")
    if rf is None:
        return
    if not isinstance(rf, dict):
        _fail("'response_format' must be an object", "response_format")
    t = rf.get("type")
    if t not in _RESPONSE_FORMAT_TYPES:
        _fail(
            f"'response_format.type' must be one of "
            f"{sorted(_RESPONSE_FORMAT_TYPES)}",
            "response_format.type",
        )
    if t == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict):
            _fail(
                "'response_format.json_schema' must be an object",
                "response_format.json_schema",
            )
        if not isinstance(js.get("schema"), dict):
            _fail(
                "'response_format.json_schema.schema' must be an object",
                "response_format.json_schema.schema",
            )


def _check_tool_choice(body: dict) -> None:
    tc = body.get("tool_choice")
    if tc is None:
        return
    if isinstance(tc, str):
        if tc not in ("none", "auto", "required"):
            _fail(
                "'tool_choice' must be 'none', 'auto', 'required' or a "
                "named function object",
                "tool_choice",
            )
        if tc == "required" and not body.get("tools"):
            _fail("'tool_choice: required' needs 'tools'", "tool_choice")
        return
    if not isinstance(tc, dict):
        _fail("'tool_choice' must be a string or object", "tool_choice")
    fn = tc.get("function")
    name = fn.get("name") if isinstance(fn, dict) else None
    if tc.get("type") != "function" or not isinstance(name, str) or not name:
        _fail(
            "'tool_choice' object must be "
            "{'type': 'function', 'function': {'name': ...}}",
            "tool_choice",
        )
    declared = {
        (t.get("function") or {}).get("name")
        for t in body.get("tools") or ()
        if isinstance(t, dict)
    }
    if name not in declared:
        _fail(
            f"'tool_choice' names unknown tool {name!r}",
            "tool_choice.function.name",
        )


def _check_tools(body: dict) -> None:
    tools = body.get("tools")
    if tools is None:
        return
    if not isinstance(tools, list):
        _fail("'tools' must be an array", "tools")
    for i, t in enumerate(tools):
        where = f"tools[{i}]"
        if not isinstance(t, dict):
            _fail(f"'{where}' must be an object", where)
        if t.get("type") != "function":
            _fail(f"'{where}.type' must be 'function'", f"{where}.type")
        fn = t.get("function")
        if not isinstance(fn, dict) or not isinstance(fn.get("name"), str):
            _fail(
                f"'{where}.function.name' is required",
                f"{where}.function",
            )


def validate_tenancy(headers: Any) -> tuple[str, str]:
    """Validate + resolve the request's (tenant, priority) at the edge.

    Sources, in precedence order: the explicit ``x-dyn-tenant`` header;
    an ``Authorization`` bearer credential (hashed to a stable opaque
    ``key-<digest>`` id so API-key traffic gets per-key fairness without
    the key itself ever reaching headers/labels/logs); else the shared
    ``default`` tenant. Priority comes from ``x-dyn-priority``
    (``interactive`` | ``batch``; default interactive).

    Raises RequestValidationError (-> HTTP 400 naming the header) on a
    malformed tenant id or unknown priority class — a typo'd priority
    must not silently demote (or promote) the request."""
    tenant = (headers.get("x-dyn-tenant") or "").strip()
    if tenant:
        if not _TENANT_RE.match(tenant):
            _fail(
                "'x-dyn-tenant' must be 1-64 chars of [A-Za-z0-9._-]",
                "x-dyn-tenant",
            )
    else:
        auth = (headers.get("Authorization")
                or headers.get("authorization") or "").strip()
        if auth:
            cred = auth.split(None, 1)[-1].encode()
            tenant = "key-" + hashlib.sha256(cred).hexdigest()[:12]
        else:
            tenant = "default"
    priority = (headers.get("x-dyn-priority") or "interactive").strip().lower()
    if priority not in _PRIORITIES:
        _fail(
            f"'x-dyn-priority' must be one of {list(_PRIORITIES)}",
            "x-dyn-priority",
        )
    return tenant, priority


def validate_request(body: Any, kind: str) -> None:
    """Validate one request body for ``kind`` in {chat, completions,
    embeddings, responses}. Raises RequestValidationError (a ValueError)
    naming the offending param."""
    if not isinstance(body, dict):
        _fail("request body must be a JSON object")
    if kind == "chat":
        _check_messages(body)
        _check_tools(body)
        _check_tool_choice(body)
        _check_response_format(body)
        _check_common(body)
        lp = body.get("logprobs")
        if lp is not None and not isinstance(lp, bool):
            _fail("'logprobs' must be a boolean for chat", "logprobs")
    elif kind == "completions":
        prompt = body.get("prompt")
        if prompt is None:
            _fail("'prompt' is required", "prompt")
        if not isinstance(prompt, str) and not is_token_prompt(prompt):
            if not isinstance(prompt, list) or not all(
                isinstance(p, str) for p in prompt
            ):
                _fail(
                    "'prompt' must be a string or list of strings", "prompt"
                )
        _check_common(body)
        lp = body.get("logprobs")
        if lp is not None and (isinstance(lp, bool) or not isinstance(lp, int)):
            _fail("'logprobs' must be an integer for completions", "logprobs")
    elif kind == "embeddings":
        inp = body.get("input")
        if inp is None:
            _fail("'input' is required", "input")
        if not isinstance(inp, str):
            if not isinstance(inp, list) or not all(
                isinstance(p, str) for p in inp
            ):
                _fail("'input' must be a string or list of strings", "input")
    elif kind == "responses":
        inp = body.get("input")
        if inp is None:
            _fail("'input' is required", "input")
        _check_common(body)
