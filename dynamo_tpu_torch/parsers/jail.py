"""JailedStream: hold tool-call text out of the visible stream, release
parsed.

Role of the reference's jail.rs (911 LoC): while the model is writing a
tool call, the raw marker + JSON must not reach the client as content.
The jail watches the detokenized text stream for start markers, buffers
("jails") everything until the region closes, parses the jailed region,
and emits structured tool calls; text outside regions passes straight
through with partial-marker holdback (markers.MarkerMatcher).

Region close rules:
  - marker formats (hermes, nemotron, ...): the configured end marker;
  - pythonic: bracket-depth tracking from the leading ``[`` (string-aware),
    so list-valued arguments don't terminate the region early;
  - markerless bare-JSON (llama3/mistral) and unterminated regions: end of
    stream.

A region that fails to parse is released VERBATIM (markers included) so
streaming and non-streaming output agree.

Events returned by feed()/finish():
  ("content", str)                 visible text delta
  ("tool_calls", [ToolCall])       a parsed call group

A copy of ``dynamo_tpu/parsers/jail.py``.
"""

from __future__ import annotations

from dynamo_tpu_torch.parsers.markers import MarkerMatcher
from dynamo_tpu_torch.parsers.tool_calls import (
    ToolCallConfig,
    parse_tool_calls,
)

__all__ = ["JailedStream"]

Event = tuple[str, object]


def _pythonic_close(buf: str) -> int:
    """Index just past the ``]`` closing the leading ``[``, or -1.

    String-aware square-bracket depth scan (buf starts with '[')."""
    depth = 0
    in_str: str | None = None
    esc = False
    for i, ch in enumerate(buf):
        if in_str is not None:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == in_str:
                in_str = None
            continue
        if ch in "\"'":
            in_str = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
            if depth == 0:
                return i + 1
    return -1


class JailedStream:
    def __init__(self, cfg: ToolCallConfig):
        self.cfg = cfg
        self._pythonic = cfg.format == "pythonic"
        # pythonic + bare-JSON configs jail from a bare leading bracket;
        # their start "markers" are not scanned mid-stream
        self._bare = cfg.bare_json_start or self._pythonic
        starts = [] if self._pythonic else cfg.start_markers
        self._matcher = MarkerMatcher(starts)
        self._jailed: str | None = None
        self._start_marker = ""
        self._at_start = True
        self._ws_hold = ""  # leading whitespace held while bare-start pends

    # -- release helpers ---------------------------------------------------

    def _release(self, parse_text: str, verbatim: str) -> list[Event]:
        """Parse a closed region; on success emit calls (+ trailing normal
        content the parser separated), on failure emit ``verbatim``."""
        calls, normal = parse_tool_calls(parse_text, self.cfg)
        if calls:
            out: list[Event] = [("tool_calls", calls)]
            if normal:
                out.append(("content", normal))
            return out
        return [("content", verbatim)] if verbatim else []

    def _close_region(self, payload: str, end_marker: str) -> list[Event]:
        full = self._start_marker + payload + end_marker
        self._jailed = None
        self._start_marker = ""
        return self._release(full, full)

    # -- streaming ---------------------------------------------------------

    def feed(self, text: str) -> list[Event]:
        out: list[Event] = []
        while text:
            if self._jailed is not None:
                text = self._feed_jailed(text, out)
                continue
            if self._at_start and self._bare:
                probe = (self._ws_hold + text).lstrip()
                if not probe:
                    # whitespace so far: keep holding, stay undecided
                    self._ws_hold += text
                    return out
                self._at_start = False
                trigger = "[" if self._pythonic else ("{", "[")
                if probe[0] in trigger:
                    # jail from the bracket to the region close/stream end
                    self._jailed = ""
                    self._start_marker = ""
                    text, self._ws_hold = probe, ""
                    continue
                text, self._ws_hold = self._ws_hold + text, ""
            clean, marker, rest = self._matcher.feed(text)
            if clean:
                out.append(("content", clean))
                self._at_start = False
            if marker is None:
                return out
            self._jailed = ""
            self._start_marker = marker
            text = rest
        return out

    def _feed_jailed(self, text: str, out: list[Event]) -> str:
        """Append to the jailed region; close it if its end appears.
        Returns the unconsumed remainder."""
        self._jailed += text
        if self._pythonic:
            end = _pythonic_close(self._jailed)
            if end >= 0:
                payload, rest = self._jailed[:end], self._jailed[end:]
                out.extend(self._close_region(payload, ""))
                return rest
            return ""
        idx, end_marker = -1, None
        for m in self.cfg.end_markers:
            j = self._jailed.find(m)
            if j >= 0 and (idx < 0 or j < idx):
                idx, end_marker = j, m
        if end_marker is not None:
            payload = self._jailed[:idx]
            rest = self._jailed[idx + len(end_marker):]
            out.extend(self._close_region(payload, end_marker))
            return rest
        return ""

    def finish(self) -> list[Event]:
        """End of stream: resolve any open jail / held text."""
        out: list[Event] = []
        if self._jailed is not None:
            payload, self._jailed = self._jailed, None
            full = self._start_marker + payload
            self._start_marker = ""
            out.extend(self._release(full, full))
        held = self._ws_hold + self._matcher.flush()
        self._ws_hold = ""
        if held:
            out.append(("content", held))
        return out
