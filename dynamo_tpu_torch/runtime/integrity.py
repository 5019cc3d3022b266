"""End-to-end integrity stamps: the part of dynamo_tpu/runtime/integrity.py
the port uses (the migration operator's resume-prompt checksum)."""

from __future__ import annotations

import zlib


def token_checksum(token_ids) -> int:
    """Checksum over a token-id sequence (migration resume payloads).
    Order- and value-sensitive, independent of list/tuple container."""
    crc = 0
    for t in token_ids or ():
        crc = zlib.crc32(int(t).to_bytes(8, "big", signed=True), crc)
    return crc & 0xFFFFFFFF
