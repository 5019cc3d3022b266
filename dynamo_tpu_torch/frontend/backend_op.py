"""Backend operator: incremental detokenization + stop-sequence scanning (a
copy of dynamo_tpu/frontend/backend_op.py).

Sits between the router (token deltas from workers) and the preprocessor's
postprocessing (OpenAI deltas). Ref: lib/llm/src/backend.rs:55 ``Backend`` -
incremental Decoder, stop-sequence scan over a sliding text window, token
accumulation.
"""

from __future__ import annotations

from contextlib import aclosing
from typing import Any, AsyncIterator

from dynamo_tpu_torch.frontend.tokenizer import IncrementalDecoder, Tokenizer
from dynamo_tpu_torch.runtime.context import Context


class Backend:
    """Wraps a downstream token engine; yields deltas with ``text`` attached."""

    def __init__(self, tokenizer: Tokenizer, downstream):
        self.tokenizer = tokenizer
        self.downstream = downstream

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        stops: list[str] = list(
            (request.get("stop_conditions") or {}).get("stop") or []
        )
        stop_token_ids = set(
            (request.get("stop_conditions") or {}).get("stop_token_ids") or []
        )
        eos_ids = set(request.get("eos_token_ids") or [])
        ignore_eos = bool(
            (request.get("stop_conditions") or {}).get("ignore_eos", False)
        )
        decoder = IncrementalDecoder(self.tokenizer)
        emitted_text_len = 0
        # longest stop string bounds how much text we must hold back
        holdback = max((len(s) for s in stops), default=0)

        # deterministic close: this operator returns as soon as it sees a
        # terminal item, and an abandoned downstream chain would otherwise
        # be torn down by GC finalizer tasks — one per layer, per request
        downstream = self.downstream.generate(request, context)
        async with aclosing(downstream):
            async for item in downstream:
                out = dict(item)
                tokens = out.get("token_ids") or []
                finish = out.get("finish_reason")

                # token-level stops: explicit stop_token_ids always apply;
                # ignore_eos disables only the EOS check
                if tokens:
                    for pos, t in enumerate(tokens):
                        if t in stop_token_ids or (t in eos_ids and not ignore_eos):
                            out["token_ids"] = tokens[: pos + 1]
                            tokens = out["token_ids"]
                            finish = out["finish_reason"] = "stop"
                            break

                if out.get("logprobs"):
                    # align with any token truncation above; attach token text
                    entries = list(out["logprobs"])[: len(tokens)]
                    for e in entries:
                        e["token"] = self.tokenizer.decode([e["id"]])
                        for t in e.get("top", ()):
                            t["token"] = self.tokenizer.decode([t["id"]])
                    out["logprobs"] = entries

                delta_text = decoder.push(tokens) if tokens else ""
                if finish is not None:
                    delta_text += decoder.flush()

                if stops:
                    # scan the full text for stop strings (sliding window)
                    full = decoder.text
                    hit = -1
                    for s in stops:
                        idx = full.find(s, max(emitted_text_len - len(s), 0))
                        if idx != -1:
                            hit = idx if hit == -1 else min(hit, idx)
                    if hit != -1:
                        # truncate at the stop string and finish
                        out["text"] = full[emitted_text_len:hit]
                        out["finish_reason"] = "stop"
                        emitted_text_len = hit
                        if out.get("logprobs"):
                            # drop entries for tokens past the stop string
                            # (OpenAI truncates logprobs with the text)
                            kept, seen = [], 0
                            for e in out["logprobs"]:
                                if seen >= len(out["text"]):
                                    break
                                kept.append(e)
                                seen += len(e.get("token", ""))
                            out["logprobs"] = kept
                        yield out
                        context.stop_generating()
                        return
                    # hold back enough text to catch a stop string spanning deltas
                    if finish is None and holdback:
                        safe = max(len(full) - holdback, emitted_text_len)
                        delta_text = full[emitted_text_len:safe]
                        out["text"] = delta_text
                        emitted_text_len = safe
                    else:
                        out["text"] = full[emitted_text_len:]
                        emitted_text_len = len(full)
                else:
                    out["text"] = delta_text
                    emitted_text_len += len(delta_text)

                yield out
                if out.get("finish_reason") is not None:
                    return


def make_operator(sink, *, tokenizer) -> "Backend":
    """Operator-registry factory (runtime/pipeline.py): sink-first form."""
    return Backend(tokenizer, sink)
