"""OpenAIPreprocessor: OpenAI API request <-> token-level pipeline (the
counterpart of dynamo_tpu/frontend/preprocessor.py).

Forward: render the chat template (jinja2 or the tokenizer's), tokenize,
extract sampling + stop conditions -> PreprocessedRequest. A completions
prompt given as token ids is taken as is.

Backward: wrap the Backend's detokenized deltas as OpenAI
chat.completion.chunk / text_completion objects and aggregate non-streaming
responses.

Left out until their slices (ROADMAP Queue A): the tool-call and reasoning
parsers (a card naming one raises here, at pipeline build), grammar
compilation for guided decoding, and multimodal content parts. A request
that asks for constrained generation (``response_format`` json_object /
json_schema, a forced ``tool_choice``, ``nvext.guided_regex``) is marked
``guided`` on the reference's triggers and no grammar is built: the port's
engine refuses it as an engine with guided decoding off does.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

import jinja2

from dynamo_tpu_torch.frontend.protocols import (
    make_preprocessed_request,
    new_request_id,
    now_unix,
)
from dynamo_tpu_torch.frontend.tokenizer import Tokenizer
from dynamo_tpu_torch.frontend.validation import is_token_prompt


class OpenAIPreprocessor:
    def __init__(
        self,
        tokenizer: Tokenizer,
        *,
        model_name: str,
        context_length: int = 8192,
        chat_template: str | None = None,
        default_max_tokens: int = 256,
        tool_call_parser: str | None = None,
        reasoning_parser: str | None = None,
    ):
        if tool_call_parser or reasoning_parser:
            raise NotImplementedError(
                f"model {model_name!r} names a tool-call or reasoning parser "
                f"({tool_call_parser or reasoning_parser!r}); the port has no "
                "parsers yet (ROADMAP Queue A, parsers/)"
            )
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.context_length = context_length
        self.default_max_tokens = default_max_tokens
        self._template = (
            jinja2.Template(chat_template) if chat_template else None
        )

    @staticmethod
    def _guided_kind(request: dict[str, Any]) -> str | None:
        """Which constrained generation a request asks for, on the
        reference's triggers and in its order (``_guided_spec``): a forced
        tool call, then ``response_format``, then ``nvext.guided_regex``;
        None when nothing constrains generation."""
        tc = request.get("tool_choice")
        if tc is not None and tc not in ("none", "auto"):
            return "tool_call"
        rf = request.get("response_format")
        if isinstance(rf, dict) and rf.get("type") in ("json_object", "json_schema"):
            return rf["type"]
        nvext = request.get("nvext")
        if isinstance(nvext, dict) and nvext.get("guided_regex"):
            return "regex"
        return None

    # -- forward: OpenAI request -> PreprocessedRequest --------------------

    def _flatten_content(self, request: dict[str, Any]) -> dict[str, Any]:
        """OpenAI content-part lists -> string contents. Text parts
        concatenate; a media part raises (the port serves text-only models,
        so it answers as the reference does for one)."""
        if "messages" not in request:
            return request
        msgs = []
        changed = False
        for m in request["messages"]:
            c = m.get("content")
            if isinstance(c, list):
                parts: list[str] = []
                for part in c:
                    ptype = part.get("type") if isinstance(part, dict) else None
                    if ptype == "text":
                        parts.append(str(part.get("text") or ""))
                    elif ptype in ("image_url", "video_url"):
                        raise ValueError(
                            f"model {self.model_name!r} does not accept image input"
                        )
                    else:
                        raise ValueError(f"unsupported content part type {ptype!r}")
                m = {**m, "content": "".join(parts)}
                changed = True
            msgs.append(m)
        return {**request, "messages": msgs} if changed else request

    def render_prompt(self, request: dict[str, Any]) -> str:
        if "messages" in request:
            messages = request["messages"]
            tools = request.get("tools")
            if self._template is not None:
                return self._template.render(
                    messages=messages, add_generation_prompt=True, tools=tools
                )
            try:
                return self.tokenizer.apply_chat_template(
                    messages, add_generation_prompt=True, tools=tools
                )
            except TypeError:
                # tokenizer template without tools support
                return self.tokenizer.apply_chat_template(
                    messages, add_generation_prompt=True
                )
        prompt = request.get("prompt", "")
        if isinstance(prompt, list):
            prompt = "".join(prompt)
        return prompt

    def preprocess(self, request: dict[str, Any]) -> dict[str, Any]:
        """OpenAI chat/completions request (dict) -> PreprocessedRequest."""
        guided = self._guided_kind(request)
        request = self._flatten_content(request)
        if "messages" not in request and is_token_prompt(request.get("prompt")):
            token_ids = list(request["prompt"])
        else:
            token_ids = self.tokenizer.encode(self.render_prompt(request))
        if len(token_ids) >= self.context_length:
            raise ValueError(
                f"prompt ({len(token_ids)} tokens) exceeds context length "
                f"{self.context_length}"
            )
        max_tokens = request.get("max_completion_tokens") or request.get(
            "max_tokens"
        )
        if max_tokens is None:
            max_tokens = min(
                self.default_max_tokens, self.context_length - len(token_ids)
            )
        max_tokens = min(max_tokens, self.context_length - len(token_ids))
        stop = request.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        # OpenAI logprob knobs: chat uses logprobs=true + top_logprobs=N,
        # completions uses logprobs=N
        lp = request.get("logprobs")
        if lp is True:
            logprobs = int(request.get("top_logprobs") or 0)
        elif isinstance(lp, int) and not isinstance(lp, bool):
            logprobs = lp
        else:
            logprobs = None
        if logprobs is not None and not (0 <= logprobs <= 20):
            raise ValueError("logprobs/top_logprobs must be between 0 and 20")
        return make_preprocessed_request(
            token_ids,
            max_tokens=max_tokens,
            temperature=request.get("temperature"),
            top_p=request.get("top_p"),
            top_k=request.get("top_k"),
            seed=request.get("seed"),
            stop=stop,
            ignore_eos=bool(request.get("ignore_eos", False)),
            min_tokens=int(request.get("min_tokens") or 0),
            eos_token_ids=[self.tokenizer.eos_token_id],
            annotations=list(request.get("nvext", {}).get("annotations", []))
            if isinstance(request.get("nvext"), dict)
            else [],
            logprobs=logprobs,
            guided=(
                {"kind": guided, "prompt_len": len(token_ids)}
                if guided is not None else None
            ),
        )

    @staticmethod
    def _chat_logprob_content(entries: list[dict]) -> list[dict]:
        """Engine logprob entries -> OpenAI chat logprobs.content items."""
        return [
            {
                "token": e.get("token", ""),
                "logprob": e["logprob"],
                "bytes": list(e.get("token", "").encode("utf-8")),
                "top_logprobs": [
                    {"token": t.get("token", ""), "logprob": t["logprob"],
                     "bytes": list(t.get("token", "").encode("utf-8"))}
                    for t in e.get("top", ())
                ],
            }
            for e in entries
        ]

    @staticmethod
    def _usage(prompt_tokens: int, completion_tokens: int) -> dict[str, int]:
        return {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        }

    # -- backward: backend deltas -> OpenAI objects ------------------------

    async def postprocess_chat_stream(
        self,
        deltas: AsyncIterator[dict[str, Any]],
        *,
        request_id: str | None = None,
        include_usage: bool = False,
        prompt_tokens: int = 0,
        request: dict[str, Any] | None = None,
    ) -> AsyncIterator[dict[str, Any]]:
        """Backend deltas -> chat.completion.chunk dicts (SSE payloads): one
        chunk per backend delta, the role on the first, logprob entries on
        the chunk of their tokens."""
        rid = request_id or new_request_id()
        created = now_unix()
        first = True
        completion_tokens = 0
        async for d in deltas:
            completion_tokens += len(d.get("token_ids", ()))
            text = d.get("text") or ""
            delta: dict[str, Any] = {"content": text} if text else {}
            if first:
                delta = {"role": "assistant", **delta}
                first = False
            choice: dict[str, Any] = {
                "index": 0, "delta": delta,
                "finish_reason": d.get("finish_reason"),
            }
            if d.get("logprobs"):
                choice["logprobs"] = {
                    "content": self._chat_logprob_content(d["logprobs"])
                }
            yield {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
                "choices": [choice],
            }
        if include_usage:
            yield {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
                "choices": [],
                "usage": self._usage(prompt_tokens, completion_tokens),
            }

    async def aggregate_chat(
        self,
        deltas: AsyncIterator[dict[str, Any]],
        *,
        request_id: str | None = None,
        prompt_tokens: int = 0,
        request: dict[str, Any] | None = None,
    ) -> dict[str, Any]:
        """Backend deltas -> one chat.completion response (non-streaming)."""
        rid = request_id or new_request_id()
        text_parts: list[str] = []
        completion_tokens = 0
        finish = "stop"
        lp_entries: list[dict] = []
        async for d in deltas:
            if d.get("text"):
                text_parts.append(d["text"])
            completion_tokens += len(d.get("token_ids", ()))
            lp_entries.extend(d.get("logprobs") or ())
            if d.get("finish_reason"):
                finish = d["finish_reason"]
        choice: dict[str, Any] = {
            "index": 0,
            "message": {"role": "assistant", "content": "".join(text_parts)},
            "finish_reason": finish,
        }
        if lp_entries:
            choice["logprobs"] = {
                "content": self._chat_logprob_content(lp_entries)
            }
        return {
            "id": rid,
            "object": "chat.completion",
            "created": now_unix(),
            "model": self.model_name,
            "choices": [choice],
            "usage": self._usage(prompt_tokens, completion_tokens),
        }

    @staticmethod
    def _completions_logprobs(entries: list[dict]) -> dict[str, Any]:
        """Engine logprob entries -> classic completions logprobs block."""
        return {
            "tokens": [e.get("token", "") for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [
                {t.get("token", ""): t["logprob"] for t in e.get("top", ())}
                for e in entries
            ],
        }

    async def postprocess_completions_stream(
        self,
        deltas: AsyncIterator[dict[str, Any]],
        *,
        request_id: str | None = None,
        include_usage: bool = False,
        prompt_tokens: int = 0,
    ) -> AsyncIterator[dict[str, Any]]:
        rid = request_id or new_request_id()
        created = now_unix()
        completion_tokens = 0
        async for d in deltas:
            completion_tokens += len(d.get("token_ids", ()))
            choice: dict[str, Any] = {
                "index": 0,
                "text": d.get("text", ""),
                "finish_reason": d.get("finish_reason"),
            }
            if d.get("logprobs"):
                choice["logprobs"] = self._completions_logprobs(d["logprobs"])
            yield {
                "id": rid,
                "object": "text_completion",
                "created": created,
                "model": self.model_name,
                "choices": [choice],
            }
        if include_usage:
            # OpenAI stream_options.include_usage: one final chunk with
            # empty choices and the token accounting
            yield {
                "id": rid,
                "object": "text_completion",
                "created": created,
                "model": self.model_name,
                "choices": [],
                "usage": self._usage(prompt_tokens, completion_tokens),
            }

    async def aggregate_completions(
        self,
        deltas: AsyncIterator[dict[str, Any]],
        *,
        request_id: str | None = None,
        prompt_tokens: int = 0,
    ) -> dict[str, Any]:
        rid = request_id or new_request_id()
        text_parts: list[str] = []
        completion_tokens = 0
        finish = "stop"
        lp_entries: list[dict] = []
        async for d in deltas:
            if d.get("text"):
                text_parts.append(d["text"])
            completion_tokens += len(d.get("token_ids", ()))
            lp_entries.extend(d.get("logprobs") or ())
            if d.get("finish_reason"):
                finish = d["finish_reason"]
        choice: dict[str, Any] = {
            "index": 0, "text": "".join(text_parts), "finish_reason": finish
        }
        if lp_entries:
            choice["logprobs"] = self._completions_logprobs(lp_entries)
        return {
            "id": rid,
            "object": "text_completion",
            "created": now_unix(),
            "model": self.model_name,
            "choices": [choice],
            "usage": self._usage(prompt_tokens, completion_tokens),
        }
