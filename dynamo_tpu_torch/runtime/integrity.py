"""End-to-end integrity stamps: the part of dynamo_tpu/runtime/integrity.py
the port uses (the KV block checksum every KVBM tier verifies on onboard;
the migration operator's resume-prompt checksum, verified at the engine's
intake; the ``corrupt`` chaos hook the SDC canary and the resume check run
their tokens through; the failure counter and its exposition).

``kv_checksum`` is a chained ``zlib.crc32`` over byte-like parts, zero-copy
over contiguous numpy blocks, so a block's value is the same in both
packages for the same bytes (a bf16 block the port carries as its
``uint16`` bits hashes like the reference's ``bfloat16`` array).

A failed check raises :class:`IntegrityError`, a ``StreamError`` subclass:
on a KVBM onboard the manager catches it and reports a tier miss (the
engine re-prefills, never decodes the poisoned block); on a resume prompt
it rides the migration operator's retry path, which re-drives from its
pristine copy. Failures are counted per path and exported on every
/metrics surface as ``dynamo_integrity_failures_total{path}``.
"""

from __future__ import annotations

import threading
import zlib

from dynamo_tpu_torch.runtime.context import StreamError


class IntegrityError(StreamError):
    """A payload failed its content checksum on receipt.

    Subclassing StreamError is the design: the migration operator retries
    StreamErrors, so a corrupt payload recovers through the machinery
    worker death already exercises, and is never decoded."""


_lock = threading.Lock()
_failures: dict[str, int] = {}


def kv_checksum(*parts) -> int:
    """Chained CRC-32 over byte-like parts (bytes, memoryview, numpy arrays
    through their buffer). A contiguous array hashes through a flattened
    memoryview without a copy; a strided view takes one materializing copy
    (the same bytes as its contiguous layout). None parts are skipped."""
    crc = 0
    for p in parts:
        if p is None:
            continue
        if isinstance(p, (bytes, bytearray, memoryview)):
            mv = memoryview(p)
        else:
            try:
                mv = memoryview(p).cast("B")
            except TypeError:
                mv = memoryview(p.tobytes())
        crc = zlib.crc32(mv, crc)
    return crc & 0xFFFFFFFF


def verify_checksum(expected, *parts, path: str) -> None:
    """Verify ``parts`` against ``expected``; raise IntegrityError (and
    count the failure on ``path``) on a mismatch. ``expected`` None (an
    unstamped payload) verifies trivially."""
    if expected is None:
        return
    actual = kv_checksum(*parts)
    if actual != int(expected):
        integrity_failure(path)
        raise IntegrityError(
            f"KV payload checksum mismatch on {path}: "
            f"expected {int(expected):#010x}, got {actual:#010x}"
        )


def token_checksum(token_ids) -> int:
    """Checksum over a token-id sequence (migration resume payloads).
    Order- and value-sensitive, independent of list/tuple container."""
    crc = 0
    for t in token_ids or ():
        crc = zlib.crc32(int(t).to_bytes(8, "big", signed=True), crc)
    return crc & 0xFFFFFFFF


def integrity_failure(path: str) -> None:
    """Count one checksum failure on ``path`` (kvbm.host, kvbm.disk,
    kvbm.remote, migration.resume)."""
    with _lock:
        _failures[path] = _failures.get(path, 0) + 1


def integrity_snapshot() -> dict[str, int]:
    with _lock:
        return dict(_failures)


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


def verify_resume_tokens(request: dict) -> dict:
    """Engine-intake guard for migration resume payloads.

    The migration operator stamps ``token_checksum`` over the resume
    prompt (original + pre-crash tokens). Here, in the receiving engine,
    the tokens first pass the ``migration.resume`` corrupt fault (the
    simulated wire), then verify. A mismatch raises IntegrityError, a
    StreamError, so the operator re-drives from its pristine copy instead
    of this engine prefilling a poisoned prompt. Requests without the
    stamp pass through untouched."""
    expected = request.get("token_checksum")
    if expected is None:
        return request
    toks = corrupt_token_ids(
        "migration.resume", list(request.get("token_ids") or [])
    )
    actual = token_checksum(toks)
    if actual != int(expected):
        integrity_failure("migration.resume")
        raise IntegrityError(
            f"resume prompt checksum mismatch: expected "
            f"{int(expected):#010x}, got {actual:#010x}"
        )
    return request


def _exposition() -> str:
    snap = integrity_snapshot()
    if not snap:
        return ""
    lines = [
        "# HELP dynamo_integrity_failures_total KV payload checksum "
        "failures by path (detected corruption, never decoded).",
        "# TYPE dynamo_integrity_failures_total counter",
    ]
    for path, n in sorted(snap.items()):
        lines.append(
            f'dynamo_integrity_failures_total{{path="{path}"}} {n}'
        )
    return "\n".join(lines) + "\n"


def _register_metrics() -> None:
    from dynamo_tpu_torch.runtime import metrics

    metrics.register_global_provider("integrity", _exposition)


_register_metrics()
