"""Streaming output parsers: tool calls + reasoning content.

TPU-framework counterpart of the reference's dynamo-parsers crate
(lib/parsers/src/, 6.2k LoC) and the chat-stream jail
(lib/llm/src/protocols/openai/chat_completions/jail.rs): detect
marker-delimited tool-call regions in the detokenized output stream, hold
("jail") the tokens while a call is forming, parse it, and surface OpenAI
``tool_calls`` deltas; independently split reasoning ("think") segments
into ``reasoning_content``.

A copy of ``dynamo_tpu/parsers/__init__.py``.
"""

from dynamo_tpu_torch.parsers.jail import JailedStream
from dynamo_tpu_torch.parsers.markers import MarkerMatcher
from dynamo_tpu_torch.parsers.reasoning import (
    REASONING_PARSERS,
    ReasoningParser,
    make_reasoning_parser,
)
from dynamo_tpu_torch.parsers.tool_calls import (
    TOOL_PARSERS,
    ToolCall,
    ToolCallConfig,
    make_tool_config,
    parse_tool_calls,
)

__all__ = [
    "JailedStream",
    "MarkerMatcher",
    "REASONING_PARSERS",
    "ReasoningParser",
    "TOOL_PARSERS",
    "ToolCall",
    "ToolCallConfig",
    "make_reasoning_parser",
    "make_tool_config",
    "parse_tool_calls",
]
