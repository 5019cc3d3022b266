"""OpenAIPreprocessor: OpenAI API request <-> token-level pipeline (the
counterpart of dynamo_tpu/frontend/preprocessor.py).

Forward: render the chat template (jinja2 or the tokenizer's), tokenize,
extract sampling + stop conditions -> PreprocessedRequest. A completions
prompt given as token ids is taken as is.

Backward: wrap the Backend's detokenized deltas as OpenAI
chat.completion.chunk / text_completion objects and aggregate non-streaming
responses. A card's tool-call parser jails call regions out of the chat
stream (parsers/jail.py) and its reasoning parser splits think segments
into ``reasoning_content``, as the reference's preprocessor does.

A request that asks for constrained generation (``response_format``
json_object / json_schema, a forced ``tool_choice``, ``nvext.guided_regex``)
has its grammar lowered here (guided/schema.py ``grammar_from_request``),
and the wire carries ``guided: {kind, regex, key, prompt_len}`` as the
reference's frontend sends it: a worker of either package compiles that
regex. An unsupported or malformed grammar is a ``GrammarError`` (a
ValueError, so a typed 400 at the edge) with the reference's text.

Multimodal content parts: each ``image_url`` / ``video_url`` part becomes an
inline marker (``IMAGE_MARKER``, stripped from user text while media are
present) that is spliced into the card's placeholder ids after rendering;
the wire carries ``multimodal: {images, positions}`` for the encode hop
(multimodal/operator.py), as the reference's. A video counts
``mm_tokens_per_image * mm_video_frames`` placeholders here; the encode
worker refuses it. A text-only card refuses media.
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
from dynamo_tpu_torch.guided.schema import grammar_from_request
from dynamo_tpu_torch.parsers import (
    JailedStream,
    make_reasoning_parser,
    make_tool_config,
    parse_tool_calls,
)


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
        mm_tokens_per_image: int = 0,
        image_token_id: int = 0,
        mm_video_frames: int = 0,
    ):
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.context_length = context_length
        self.default_max_tokens = default_max_tokens
        self.tool_call_parser = tool_call_parser
        self.reasoning_parser = reasoning_parser
        # multimodal: 0 = a text-only model (media parts refused); a video
        # part takes mm_video_frames frames of mm_tokens_per_image rows
        self.mm_tokens_per_image = mm_tokens_per_image
        self.image_token_id = image_token_id
        self.mm_video_frames = mm_video_frames
        # fail fast on unknown parser names: a typo must break worker
        # startup, not every subsequent chat request
        self._tool_cfg = make_tool_config(tool_call_parser)
        make_reasoning_parser(reasoning_parser)
        self._template = (
            jinja2.Template(chat_template) if chat_template else None
        )

    def _tool_config(self, request: dict[str, Any] | None):
        """Jail only when the model has a parser AND the request brought
        tools. Every tool_choice shape except "none" flows through: "auto"
        (parse if the model calls), "required" and named functions
        (generation is grammar-forced into a call, ``_guided_spec``, and the
        jail and parser consume the guaranteed output)."""
        if self._tool_cfg is None or not request or not request.get("tools"):
            return None
        if request.get("tool_choice") == "none":
            return None
        return self._tool_cfg

    def _reasoning(self):
        return make_reasoning_parser(self.reasoning_parser)

    def _guided_spec(self, request: dict[str, Any]) -> dict[str, Any] | None:
        """Grammar selection for guided decoding (guided/schema.py): a
        forced tool call wins over response_format over nvext.guided_regex;
        None when nothing constrains generation. Raises GrammarError (a
        ValueError, a typed 400 at the edge): an unsupported schema must
        never become a mid-stream 500."""
        return grammar_from_request(request, tool_cfg=self._tool_cfg)

    # -- forward: OpenAI request -> PreprocessedRequest --------------------

    IMAGE_MARKER = "<|mm_image|>"

    def _flatten_content(
        self, request: dict[str, Any]
    ) -> tuple[dict[str, Any], list[str | dict[str, Any]]]:
        """OpenAI content-part lists -> string contents + media refs. Text
        parts concatenate; each image_url / video_url part becomes an inline
        marker and its ref collects in order: a URL string for an image, a
        ``{"url": ..., "kind": "video"}`` dict for a video."""
        if "messages" not in request:
            return request, []
        has_media = any(
            isinstance(m.get("content"), list)
            and any(isinstance(p, dict) and p.get("type") in ("image_url", "video_url")
                    for p in m["content"])
            for m in request["messages"]
        )

        def clean(text: str) -> str:
            # the marker is reserved while media are present: a literal one
            # in user text would desync the marker and media counts
            return text.replace(self.IMAGE_MARKER, "") if has_media else text

        images: list[str | dict[str, Any]] = []
        msgs = []
        changed = False
        for m in request["messages"]:
            c = m.get("content")
            if isinstance(c, list):
                parts: list[str] = []
                for part in c:
                    ptype = part.get("type") if isinstance(part, dict) else None
                    if ptype == "text":
                        parts.append(clean(str(part.get("text") or "")))
                    elif ptype in ("image_url", "video_url"):
                        iu = part.get(ptype)
                        url = iu.get("url") if isinstance(iu, dict) else iu
                        if not url:
                            raise ValueError(f"{ptype} part without url")
                        images.append(url if ptype == "image_url"
                                      else {"url": url, "kind": "video"})
                        parts.append(self.IMAGE_MARKER)
                    else:
                        raise ValueError(f"unsupported content part type {ptype!r}")
                m = {**m, "content": "".join(parts)}
                changed = True
            elif has_media and isinstance(c, str) and self.IMAGE_MARKER in c:
                m = {**m, "content": clean(c)}
                changed = True
            msgs.append(m)
        return ({**request, "messages": msgs} if changed else request), images

    def _attachment_tokens(self, att) -> int:
        """Placeholder rows one attachment occupies: an image is
        mm_tokens_per_image; a video is that per sampled frame."""
        if isinstance(att, dict) and att.get("kind") == "video":
            return self.mm_tokens_per_image * self.mm_video_frames
        return self.mm_tokens_per_image

    def _tokenize_with_images(
        self, prompt: str, attachments: list
    ) -> tuple[list[int], list[int]]:
        """Tokenize around the media markers, splicing each attachment's
        placeholder ids. Returns (token_ids, the placeholder positions: the
        absolute prompt positions the engine overwrites with the encoder's
        rows)."""
        segs = prompt.split(self.IMAGE_MARKER)
        if len(segs) - 1 != len(attachments):
            raise ValueError(
                "media markers and media parts diverged (chat template "
                "dropped message content?)"
            )
        token_ids: list[int] = []
        positions: list[int] = []
        for i, seg in enumerate(segs):
            if seg:
                token_ids.extend(self.tokenizer.encode(seg))
            if i < len(attachments):
                n = self._attachment_tokens(attachments[i])
                positions.extend(range(len(token_ids), len(token_ids) + n))
                token_ids.extend([self.image_token_id] * n)
        return token_ids, positions

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
        guided = self._guided_spec(request)
        request, images = self._flatten_content(request)
        if images and not self.mm_tokens_per_image:
            raise ValueError(f"model {self.model_name!r} does not accept image input")
        if any(isinstance(a, dict) and a.get("kind") == "video" for a in images) \
                and not self.mm_video_frames:
            raise ValueError(f"model {self.model_name!r} does not accept video input")
        mm_positions: list[int] = []
        if images:
            token_ids, mm_positions = self._tokenize_with_images(
                self.render_prompt(request), images)
        elif "messages" not in request and is_token_prompt(request.get("prompt")):
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
        pre = make_preprocessed_request(
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
                {**guided, "prompt_len": len(token_ids)}
                if guided is not None else None
            ),
        )
        if images:
            # the image refs ride to the MultimodalEncode operator, which
            # swaps them for embeddings before routing (the encode hop)
            pre["multimodal"] = {"images": images, "positions": mm_positions}
        return pre

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
        """Backend deltas -> chat.completion.chunk dicts (SSE payloads).

        When the model card configures a tool parser and the request
        carries ``tools``, text runs through the jail (parsers/jail.py):
        marker-delimited call regions leave the stream as ``tool_calls``
        deltas. A configured reasoning parser independently splits think
        segments into ``reasoning_content``.
        """
        rid = request_id or new_request_id()
        created = now_unix()
        first = True
        completion_tokens = 0
        tool_cfg = self._tool_config(request)
        jail = JailedStream(tool_cfg) if tool_cfg is not None else None
        reasoning = self._reasoning()
        tool_index = 0
        saw_tool_calls = False
        held_lp: list[dict] = []  # logprob entries from jailed deltas

        def chunk_for(delta: dict[str, Any], finish: str | None,
                      logprobs: list[dict] | None = None):
            nonlocal first
            if first:
                delta = {"role": "assistant", **delta}
                first = False
            choice: dict[str, Any] = {
                "index": 0, "delta": delta, "finish_reason": finish
            }
            if logprobs:
                choice["logprobs"] = {
                    "content": self._chat_logprob_content(logprobs)
                }
            return {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
                "choices": [choice],
            }

        async for d in deltas:
            completion_tokens += len(d.get("token_ids", ()))
            finish = d.get("finish_reason")
            text = d.get("text") or ""

            r_delta, content = reasoning.feed(text) if reasoning else ("", text)
            events = []
            if content:
                events = (
                    jail.feed(content) if jail else [("content", content)]
                )
            if finish is not None:
                if reasoning is not None:
                    r_tail, c_tail = reasoning.finish()
                    r_delta += r_tail
                    if c_tail:
                        events += (
                            jail.feed(c_tail) if jail
                            else [("content", c_tail)]
                        )
                if jail is not None:
                    events += jail.finish()

            pending: list[dict[str, Any]] = []
            if r_delta:
                pending.append({"reasoning_content": r_delta})
            for kind, payload in events:
                if kind == "content":
                    if payload:
                        pending.append({"content": payload})
                else:  # tool_calls
                    calls = [
                        c.to_openai(tool_index + i)
                        for i, c in enumerate(payload)
                    ]
                    tool_index += len(calls)
                    saw_tool_calls = True
                    pending.append({"tool_calls": calls})

            if finish is not None and saw_tool_calls and finish == "stop":
                finish = "tool_calls"
            # keep a chunk per backend delta when not jailing (clients see
            # per-token progress even for invisible tokens); while jailed,
            # silence is the point
            if not pending and (jail is None or finish is not None):
                pending.append({})
            # logprob entries ride the first emitted chunk; while the jail
            # holds a delta back entirely they accumulate (clients align
            # logprobs.content to tokens, so none may be dropped)
            held_lp.extend(d.get("logprobs") or ())
            for i, delta in enumerate(pending):
                lp_out = None
                if i == 0 and held_lp:
                    lp_out, held_lp = held_lp, []
                yield chunk_for(
                    delta,
                    finish if (finish is not None and i == len(pending) - 1)
                    else None,
                    logprobs=lp_out,
                )
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
        text = "".join(text_parts)

        message: dict[str, Any] = {"role": "assistant"}
        reasoning = self._reasoning()
        if reasoning is not None:
            r1, c1 = reasoning.feed(text)
            r2, c2 = reasoning.finish()
            if r1 + r2:
                message["reasoning_content"] = r1 + r2
            text = c1 + c2
        tool_cfg = self._tool_config(request)
        calls, normal = (
            parse_tool_calls(text, tool_cfg) if tool_cfg is not None
            else ([], text)
        )
        if calls:
            message["tool_calls"] = [c.to_openai(i) for i, c in enumerate(calls)]
            message["content"] = normal or None
            if finish == "stop":
                finish = "tool_calls"
        else:
            message["content"] = text
        choice: dict[str, Any] = {
            "index": 0,
            "message": message,
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
