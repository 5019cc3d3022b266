"""Tokenizer abstraction + incremental detokenization (the counterpart of
dynamo_tpu/frontend/tokenizer.py).

``MockTokenizer`` is the deterministic byte-level tokenizer of the
reference (no model files). The reference's ``HFTokenizer`` needs
``transformers``, which the GPU machine lacks: ``load_tokenizer`` with a
path raises, a kept departure (a checkpoint's weights load without it:
models/loader.py).

``IncrementalDecoder`` converts a stream of token ids into clean UTF-8 text
deltas: it withholds bytes until they form complete codepoints, so
multi-byte characters split across tokens never emit mojibake.
"""

from __future__ import annotations

from typing import Protocol, Sequence

__all__ = ["Tokenizer", "MockTokenizer", "IncrementalDecoder", "load_tokenizer"]


class Tokenizer(Protocol):
    eos_token_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...  # pragma: no cover
    def decode(self, ids: Sequence[int]) -> str: ...  # pragma: no cover
    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str: ...  # pragma: no cover


_DEFAULT_CHAT_TEMPLATE = (
    "{% for m in messages %}"
    "<|{{ m['role'] }}|>{{ m['content'] }}<|end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}"
)


class MockTokenizer:
    """Byte-level tokenizer: token id = byte value + 16 (0..15 reserved).

    Deterministic, reversible, and needs no model files. Special ids:
    0=pad, 1=bos, 2=eos.
    """

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 16

    def __init__(self) -> None:
        self.eos_token_id = self.EOS
        self.vocab_size = 256 + self.OFFSET
        import jinja2

        self._template = jinja2.Template(_DEFAULT_CHAT_TEMPLATE)

    def encode(self, text: str) -> list[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
    ) -> str:
        return self._template.render(
            messages=messages, add_generation_prompt=add_generation_prompt,
            tools=tools,
        )


def load_tokenizer(spec: str | None) -> Tokenizer:
    """Resolve a tokenizer spec from a model card: "mock" (or empty). A
    local path needs ``transformers``, which the port does not use: it
    raises ValueError."""
    if not spec or spec == "mock":
        return MockTokenizer()
    raise ValueError(
        f"tokenizer {spec!r}: the port serves the mock tokenizer only; a "
        "HuggingFace tokenizer needs transformers, which the GPU machine "
        "lacks"
    )


def _utf8_incomplete_tail(data: bytes) -> int:
    """Length of a trailing incomplete UTF-8 sequence (0 if none).

    Scans back at most 3 bytes for a lead byte whose declared sequence
    length exceeds the bytes present; invalid sequences count as complete
    (the errors="replace" decode handles them)."""
    for i in range(1, min(3, len(data)) + 1):
        b = data[-i]
        if b < 0x80:
            return 0  # ASCII: nothing held back
        if b >= 0xC0:  # lead byte
            need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            return i if need > i else 0
        # else: continuation byte, keep scanning
    return 0


class IncrementalDecoder:
    """Streaming token-ids -> text deltas without broken codepoints.

    Sliding-window algorithm (the standard incremental detokenizer): decode
    only a bounded window ``ids[prefix_offset:]`` each step and hold the
    delta back while it ends in U+FFFD (a token boundary split a multi-byte
    character). Byte-level tokenizers (``decode_bytes``) take a faster
    path: raw bytes with only an incomplete UTF-8 tail held back.
    """

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer
        self._ids: list[int] = []
        self._prefix_offset = 0  # window start (last fully-emitted boundary)
        self._read_offset = 0  # ids already attributed to emitted text
        self._text_parts: list[str] = []  # all emitted deltas
        self._text_len = 0
        self._byte_mode = hasattr(tokenizer, "decode_bytes")
        self._pending_bytes = b""

    def _emit(self, delta: str) -> str:
        if delta:
            self._text_parts.append(delta)
            self._text_len += len(delta)
        return delta

    def push(self, ids: Sequence[int]) -> str:
        if self._byte_mode:
            data = self._pending_bytes + self.tokenizer.decode_bytes(ids)
            cut = len(data) - _utf8_incomplete_tail(data)
            self._pending_bytes = data[cut:]
            return self._emit(data[:cut].decode("utf-8", errors="replace"))
        self._ids.extend(ids)
        prefix_text = self.tokenizer.decode(
            self._ids[self._prefix_offset: self._read_offset]
        )
        window_text = self.tokenizer.decode(self._ids[self._prefix_offset:])
        if window_text.endswith("�"):
            return ""  # incomplete codepoint: wait for more tokens
        delta = window_text[len(prefix_text):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return self._emit(delta)

    def flush(self) -> str:
        if self._byte_mode:
            delta = self._pending_bytes.decode("utf-8", errors="replace")
            self._pending_bytes = b""
            return self._emit(delta)
        window_text = self.tokenizer.decode(self._ids[self._prefix_offset:])
        prefix_text = self.tokenizer.decode(
            self._ids[self._prefix_offset: self._read_offset]
        )
        delta = window_text[len(prefix_text):]
        self._prefix_offset = self._read_offset = len(self._ids)
        return self._emit(delta)

    @property
    def text(self) -> str:
        """All text emitted so far (O(1) amortized; no re-decode)."""
        if len(self._text_parts) > 1:
            self._text_parts = ["".join(self._text_parts)]
        return self._text_parts[0] if self._text_parts else ""
