"""Reasoning-content extraction from the output stream.

Role of the reference's reasoning parsers (lib/parsers/src/reasoning/:
base marker parser, granite, gpt_oss): split "thinking" segments out of
the visible stream into the OpenAI-extension ``reasoning_content`` field.
Streaming-safe: markers split across deltas are held back by
MarkerMatcher.

Registry:
  basic        <think> ... </think>
  deepseek_r1  like basic but the stream STARTS inside reasoning (R1 chat
               templates open the think block in the prompt)
  granite      "Here is my thought process:" / "Here is my response:"

A copy of ``dynamo_tpu/parsers/reasoning.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from dynamo_tpu_torch.parsers.markers import MarkerMatcher

__all__ = ["ReasoningParser", "REASONING_PARSERS", "make_reasoning_parser"]


@dataclass
class ReasoningConfig:
    start_marker: str
    end_marker: str
    starts_in_reasoning: bool = False
    # channel-protocol markup to drop from the CONTENT stream (harmony's
    # final-channel framing); stream-safe via a MarkerMatcher filter
    strip_markers: tuple = ()


REASONING_PARSERS: dict[str, ReasoningConfig] = {
    "basic": ReasoningConfig("<think>", "</think>"),
    "deepseek_r1": ReasoningConfig("<think>", "</think>",
                                   starts_in_reasoning=True),
    "granite": ReasoningConfig(
        "Here is my thought process:", "Here is my response:"
    ),
    # gpt-oss harmony channels (ref lib/parsers/src/reasoning/gpt_oss):
    # analysis channel = reasoning; final channel framing stripped from
    # content. (Tool-call commentary channels are consumed upstream by
    # the harmony jail before text reaches this parser.)
    "gpt_oss": ReasoningConfig(
        "<|channel|>analysis<|message|>", "<|end|>",
        strip_markers=(
            "<|start|>assistant", "<|channel|>final<|message|>",
            "<|return|>", "<|end|>",
        ),
    ),
}


def make_reasoning_parser(name: str | None) -> "ReasoningParser | None":
    if not name:
        return None
    try:
        cfg = REASONING_PARSERS[name]
    except KeyError:
        raise ValueError(
            f"unknown reasoning parser {name!r}; "
            f"choose from {sorted(REASONING_PARSERS)}"
        ) from None
    return ReasoningParser(cfg)


class _StripFilter:
    """Delete protocol markers from a text stream (chunk-boundary safe)."""

    def __init__(self, markers: tuple):
        self._matcher = MarkerMatcher(list(markers))

    def feed(self, text: str) -> str:
        out: list[str] = []
        while text:
            clean, marker, rest = self._matcher.feed(text)
            out.append(clean)
            if marker is None:
                break
            text = rest
        return "".join(out)

    def flush(self) -> str:
        return self._matcher.flush()


class ReasoningParser:
    def __init__(self, cfg: ReasoningConfig):
        self.cfg = cfg
        self.in_reasoning = cfg.starts_in_reasoning
        self._matcher = MarkerMatcher(
            [cfg.end_marker if self.in_reasoning else cfg.start_marker]
        )
        self._strip = (
            _StripFilter(cfg.strip_markers) if cfg.strip_markers else None
        )

    def _switch(self) -> None:
        self.in_reasoning = not self.in_reasoning
        self._matcher = MarkerMatcher(
            [self.cfg.end_marker if self.in_reasoning else self.cfg.start_marker]
        )

    def feed(self, text: str) -> tuple[str, str]:
        """Delta -> (reasoning_delta, content_delta)."""
        reasoning: list[str] = []
        content: list[str] = []
        while text:
            clean, marker, rest = self._matcher.feed(text)
            if not self.in_reasoning and self._strip is not None:
                clean = self._strip.feed(clean)
            (reasoning if self.in_reasoning else content).append(clean)
            if marker is None:
                break
            self._switch()
            text = rest
        return "".join(reasoning), "".join(content)

    def finish(self) -> tuple[str, str]:
        held = self._matcher.flush()
        if self.in_reasoning:
            return held, ""
        if self._strip is not None:
            held = self._strip.feed(held) + self._strip.flush()
        return "", held
