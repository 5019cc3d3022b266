"""Streaming marker detection with chunk-boundary holdback.

The core problem of stream parsing: a marker like ``<tool_call>`` can be
split across text deltas (``"...<tool_"`` + ``"call>..."``). MarkerMatcher
buffers the smallest suffix that could still become a marker and releases
everything before it, so downstream consumers never see a partial marker
and never wait longer than necessary. (Same role as the reference's
MarkerMatcher used by jail.rs.)

A copy of ``dynamo_tpu/parsers/markers.py``.
"""

from __future__ import annotations

__all__ = ["MarkerMatcher"]


class MarkerMatcher:
    """Scan a text stream for the earliest occurrence of any marker."""

    def __init__(self, markers: list[str]):
        self.markers = [m for m in markers if m]
        self._buf = ""

    def feed(self, text: str) -> tuple[str, str | None, str]:
        """Consume a delta; returns (clean, matched_marker, rest).

        ``clean`` is text definitely before any marker (safe to emit).
        When a full marker is found, ``matched_marker`` is it and ``rest``
        is everything after (caller switches state and re-feeds ``rest``
        where appropriate). Otherwise a possible marker prefix stays held.
        """
        self._buf += text
        if not self.markers:
            out, self._buf = self._buf, ""
            return out, None, ""

        # earliest full marker occurrence
        best: tuple[int, str] | None = None
        for m in self.markers:
            i = self._buf.find(m)
            if i >= 0 and (best is None or i < best[0]):
                best = (i, m)
        if best is not None:
            i, m = best
            clean = self._buf[:i]
            rest = self._buf[i + len(m):]
            self._buf = ""
            return clean, m, rest

        # hold the longest tail that is a prefix of some marker
        hold = 0
        for m in self.markers:
            probe = min(len(m) - 1, len(self._buf))
            for n in range(probe, 0, -1):
                if self._buf.endswith(m[:n]):
                    hold = max(hold, n)
                    break
        if hold:
            clean, self._buf = self._buf[:-hold], self._buf[-hold:]
        else:
            clean, self._buf = self._buf, ""
        return clean, None, ""

    def flush(self) -> str:
        """End of stream: release whatever was held."""
        out, self._buf = self._buf, ""
        return out
