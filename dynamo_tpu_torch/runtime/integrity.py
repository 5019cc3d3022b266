"""End-to-end integrity stamps: the part of dynamo_tpu/runtime/integrity.py
the port uses (the migration operator's resume-prompt checksum, and the
``corrupt`` chaos hook the SDC canary runs its tokens through)."""

from __future__ import annotations

import zlib


def token_checksum(token_ids) -> int:
    """Checksum over a token-id sequence (migration resume payloads).
    Order- and value-sensitive, independent of list/tuple container."""
    crc = 0
    for t in token_ids or ():
        crc = zlib.crc32(int(t).to_bytes(8, "big", signed=True), crc)
    return crc & 0xFFFFFFFF


def corrupt_token_ids(site: str, token_ids: list, instance=None) -> list:
    """Chaos hook: run a token-id sequence through the ``corrupt`` fault
    at ``site`` (no-op unless a rule is armed; ``instance`` scopes sticky
    per-worker rules). Tokens round-trip through the same 8-byte encoding
    :func:`token_checksum` hashes, so a flipped bit lands in exactly one
    token value."""
    from dynamo_tpu_torch.runtime.faults import FAULTS

    if not FAULTS.enabled or not token_ids:
        return token_ids
    buf = b"".join(
        int(t).to_bytes(8, "big", signed=True) for t in token_ids
    )
    flipped = FAULTS.corrupt_bytes(site, buf, instance=instance)
    if flipped is buf:
        return token_ids
    return [
        int.from_bytes(flipped[i : i + 8], "big", signed=True)
        for i in range(0, len(flipped), 8)
    ]
