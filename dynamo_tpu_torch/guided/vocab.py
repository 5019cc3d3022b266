"""Token vocabulary view for guided decoding.

The grammar automaton is char-level; lifting it to token masks needs
every token id's SURFACE STRING. This wraps that mapping (plus a stable
digest for the (grammar, vocab) compile-cache key) independently of any
tokenizer implementation: build it once from a Tokenizer at worker
startup, or hand the engine an explicit string table in tests/bench.

Tokens that decode to the empty string (pad/bos/special ids, ids past
the tokenizer's range inside a padded model vocab) are never maskable:
an empty token advances no automaton state, so allowing one would let
the model spin without progressing the grammar.
"""

from __future__ import annotations

import hashlib

__all__ = ["TokenVocab"]


class TokenVocab:
    def __init__(self, tokens: list[str]):
        self.tokens = [t or "" for t in tokens]
        h = hashlib.sha256()
        for t in self.tokens:
            h.update(t.encode("utf-8", "surrogatepass"))
            h.update(b"\x00")
        self.digest = h.hexdigest()[:16]

    def __len__(self) -> int:
        return len(self.tokens)

    def text(self, ids) -> str:
        """Decode a token-id sequence through this view (test/bench
        helper — the serving path detokenizes in frontend/backend_op)."""
        toks = self.tokens
        return "".join(toks[i] for i in ids if 0 <= i < len(toks))

    @classmethod
    def from_tokenizer(cls, tokenizer, vocab_size: int | None = None)\
            -> "TokenVocab":
        """Build from any frontend Tokenizer. ``vocab_size`` pads/trims
        to the MODEL's vocab (mask width must equal the logits width;
        padded ids decode empty and stay unmaskable)."""
        n = vocab_size or getattr(tokenizer, "vocab_size", 0)
        limit = min(n, getattr(tokenizer, "vocab_size", n))
        tokens = [""] * n
        for i in range(limit):
            try:
                tokens[i] = tokenizer.decode([i])
            # dynalint: disable=DL003 -- per-id decode probe: a special
            # id a tokenizer refuses to decode stays empty, which is
            # exactly "never maskable" (the documented contract above)
            except Exception:  # noqa: BLE001
                tokens[i] = ""
        return cls(tokens)

    @classmethod
    def ascii_json(cls, vocab_size: int) -> "TokenVocab":
        """Deterministic JSON-capable vocab for tiny test/bench models
        whose MockTokenizer byte mapping cannot reach '{' within a small
        vocab: ids 0-2 stay pad/bos/eos, then every char JSON needs, a
        few multi-char tokens to exercise multi-step walks, and letters.
        """
        tokens = [""] * vocab_size
        charset = (
            '{}[]",:.- 0123456789eE+\\_/<>\n\t'
            "abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        )
        multi = ["true", "false", "null", '": "', '", "', "{\"", "\"}"]
        i = 3
        for ch in charset:
            if i >= vocab_size:
                break
            tokens[i] = ch
            i += 1
        for m in multi:
            if i >= vocab_size:
                break
            tokens[i] = m
            i += 1
        return cls(tokens)

    @classmethod
    def coerce(cls, obj, vocab_size: int | None = None) -> "TokenVocab":
        if isinstance(obj, TokenVocab):
            return obj
        if isinstance(obj, (list, tuple)):
            return cls(list(obj))
        if hasattr(obj, "decode"):
            return cls.from_tokenizer(obj, vocab_size)
        raise TypeError(
            f"cannot build a TokenVocab from {type(obj).__name__}"
        )
