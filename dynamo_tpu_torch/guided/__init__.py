"""Guided decoding: grammar-constrained sampling with a guarantee.

parsers/ recovers structure AFTER generation; this package constrains
generation itself, turning "usually JSON" into provably
schema-conformant output at any temperature (ROADMAP #5, the
xgrammar-style engine slot the reference serves via dynamo-parsers):

- guided/schema.py   — OpenAI ``response_format`` / forced
  ``tool_choice`` / ``nvext.guided_regex`` -> regex grammar source
  (frontend edge; unsupported schemas are typed 400s);
- guided/regex_dfa.py — regex source -> char-level DFA;
- guided/runtime.py   — DFA x vocab -> per-state allowed-token
  bitmasks (LRU-cached per (grammar, vocab)) + the per-slot cursor the
  engine advances host-side while the mask applies on device in
  engine/sampling.py::sample_tokens_masked.

The constrain-then-parse contract: guided grammars emit exactly what
parsers/tool_calls.py expects, so ``parse_tool_calls`` consumes
guaranteed output instead of retry fodder.
"""

from dynamo_tpu_torch.guided.regex_dfa import RegexError, compile_regex, parse_regex
from dynamo_tpu_torch.guided.runtime import (
    GUIDED_REQUESTS,
    GrammarCompiler,
    GuidedState,
    TokenDFA,
)
from dynamo_tpu_torch.guided.schema import (
    DEFAULT_JSON_DEPTH,
    GrammarError,
    grammar_from_request,
    json_object_regex,
    json_value_regex,
    schema_to_regex,
    tool_call_regex,
)
from dynamo_tpu_torch.guided.vocab import TokenVocab

__all__ = [
    "DEFAULT_JSON_DEPTH",
    "GUIDED_REQUESTS",
    "GrammarCompiler",
    "GrammarError",
    "GuidedState",
    "RegexError",
    "TokenDFA",
    "TokenVocab",
    "compile_regex",
    "grammar_from_request",
    "json_object_regex",
    "json_value_regex",
    "parse_regex",
    "schema_to_regex",
    "tool_call_regex",
]
