"""Pipeline wire types: PreprocessedRequest and engine outputs (a copy of
dynamo_tpu/frontend/protocols.py).

The worker protocol is tokens-in/tokens-out: the frontend owns tokenization
and detokenization; workers see only token ids. Plain dicts on the wire;
this module documents + constructs them.
"""

from __future__ import annotations

import time
import uuid
from typing import Any

# PreprocessedRequest fields (dict keys):
#   token_ids: list[int]            - the tokenized prompt
#   sampling: {temperature, top_p, top_k, seed}
#   stop_conditions: {max_tokens, stop: [str], stop_token_ids: [int],
#                     ignore_eos: bool, min_tokens: int}
#   eos_token_ids: list[int]
#   output_options: {logprobs: None | N}
#   backend_instance_id: int | None - router override (direct pinning)
#   estimated_prefix_hit_num_blocks: int | None
#   annotations: list[str]
#   disagg: None
#   guided: None | {"kind", "regex", "key", "prompt_len"} - the grammar of a
#     constrained-generation request (guided/schema.py)


def make_preprocessed_request(
    token_ids: list[int],
    *,
    max_tokens: int = 256,
    temperature: float | None = None,
    top_p: float | None = None,
    top_k: int | None = None,
    seed: int | None = None,
    stop: list[str] | None = None,
    stop_token_ids: list[int] | None = None,
    ignore_eos: bool = False,
    min_tokens: int = 0,
    eos_token_ids: list[int] | None = None,
    annotations: list[str] | None = None,
    logprobs: int | None = None,  # None=off, N=top-N alternatives
    guided: dict[str, Any] | None = None,
) -> dict[str, Any]:
    return {
        "token_ids": token_ids,
        "sampling": {
            k: v
            for k, v in {
                "temperature": temperature,
                "top_p": top_p,
                "top_k": top_k,
                "seed": seed,
            }.items()
            if v is not None
        },
        "stop_conditions": {
            "max_tokens": max_tokens,
            "stop": stop or [],
            "stop_token_ids": stop_token_ids or [],
            "ignore_eos": ignore_eos,
            "min_tokens": min_tokens,
        },
        "eos_token_ids": eos_token_ids or [],
        "output_options": {"logprobs": logprobs},
        "backend_instance_id": None,
        "estimated_prefix_hit_num_blocks": None,
        "annotations": annotations or [],
        "disagg": None,
        "guided": guided,
    }


# Engine output (dict keys), per stream item:
#   token_ids: list[int]      - newly generated tokens (usually 1)
#   finish_reason: None | "stop" | "length" | "cancelled" | "error"
#   logprobs                  - optional entries, one per token
#   error: str                - when finish_reason == "error"


def new_request_id() -> str:
    return f"chatcmpl-{uuid.uuid4().hex[:24]}"


def now_unix() -> int:
    return int(time.time())
