"""Length-prefixed msgpack framing shared by all TCP planes (a copy of
dynamo_tpu/runtime/framing.py).

Wire format: 4-byte big-endian unsigned length, then a msgpack-encoded map.
Used by the hub protocol (hub_server/hub_client) and the request/response
data plane (transport.py). The bodies go through ``codec``, the port's
stdlib msgpack subset, which writes the bytes msgpack writes: the port's
processes and the JAX package's share one wire.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Callable

from dynamo_tpu_torch.runtime import codec

_LEN = struct.Struct(">I")
MAX_FRAME = 512 * 1024 * 1024  # object-store blobs can be large


def pack(msg: dict[str, Any]) -> bytes:
    body = codec.packb(msg)
    return _LEN.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> dict[str, Any] | None:
    """Read one frame; None on clean EOF."""
    got = await read_frame_sized(reader)
    return None if got is None else got[0]


async def read_frame_sized(
    reader: asyncio.StreamReader,
) -> tuple[dict[str, Any], int] | None:
    """Read one frame and its on-wire size (header + body) for rx
    accounting; None on clean EOF."""
    try:
        header = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return codec.unpackb(body), _LEN.size + length


async def write_frame(writer: asyncio.StreamWriter, msg: dict[str, Any]) -> None:
    writer.write(pack(msg))
    await writer.drain()


class FrameFeeder:
    """Incremental frame parser for chunked socket reads.

    ``feed(chunk)`` returns every complete frame (with its on-wire size)
    buffered so far; a partial frame tail is held until the next chunk.
    This is the receive-side dual of the corked ``FrameWriter``: the send
    path batches many frames into one TCP segment, so the rx loop should
    pay ONE ``reader.read()`` await per segment — not two ``readexactly``
    coroutine hops per frame, which dominate rx cost under coalescing.

    Raises ``ValueError`` on an oversize length prefix (same contract as
    ``read_frame_sized``: length-prefixed framing cannot resync, the
    caller must drop the connection).
    """

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list[tuple[Any, int]]:
        buf = self._buf
        buf += chunk
        out: list[tuple[Any, int]] = []
        pos = 0
        n = len(buf)
        while n - pos >= _LEN.size:
            length = int.from_bytes(buf[pos : pos + _LEN.size], "big")
            if length > MAX_FRAME:
                raise ValueError(f"frame too large: {length}")
            end = pos + _LEN.size + length
            if end > n:
                break
            out.append((
                codec.unpackb(bytes(buf[pos + _LEN.size : end])),
                _LEN.size + length,
            ))
            pos = end
        if pos:
            del buf[:pos]
        return out

    @property
    def pending_bytes(self) -> int:
        """Bytes of partial frame currently held (torn-frame visibility)."""
        return len(self._buf)


class FrameWriter:
    """Corked frame writer: the data plane's batched send path.

    ``feed()`` appends a packed frame to a user-space buffer; the buffer is
    written to the transport once per event-loop tick (or immediately when
    it crosses ``high_water`` bytes), so a burst of N frames — e.g. one
    decode step across 64 concurrent streams — costs one writev-shaped
    ``transport.write`` instead of N write+drain round-trips. ``drain()``
    is awaited only when the kernel-side write buffer reports backpressure
    (``drain_above`` bytes), which is what bounds memory against a stalled
    peer without paying a coroutine suspension per frame.

    With ``cork=False`` every frame is written and drained immediately —
    the pre-corking behavior, kept for A/B benchmarking (stream_bench) and
    as an escape hatch (``DYN_STREAM_CORK=0``).
    """

    def __init__(
        self,
        writer: asyncio.StreamWriter,
        *,
        cork: bool = True,
        high_water: int = 64 * 1024,
        drain_above: int = 256 * 1024,
        stats: dict[str, int] | None = None,
        on_flush: Callable[[int], None] | None = None,
    ) -> None:
        self._writer = writer
        self.cork = cork
        self.high_water = high_water
        self.drain_above = drain_above
        self._buf = bytearray()
        self._tick_scheduled = False
        self._stats = stats
        self._on_flush = on_flush
        # per-writer counters (module-wide aggregation rides ``stats``)
        self.frames = 0
        self.flushes = 0
        self.drains = 0
        self.bytes_out = 0

    def feed(self, msg: dict[str, Any]) -> None:
        """Buffer one frame; written at end of tick / high water. Callers
        that can await should follow up with ``pump()``."""
        self._buf += pack(msg)
        self.frames += 1
        if not self.cork:
            self._write_out()
            return
        if not self._tick_scheduled:
            self._tick_scheduled = True
            asyncio.get_running_loop().call_soon(self._tick)

    async def send(self, msg: dict[str, Any]) -> None:
        """feed + pump in one call."""
        self.feed(msg)
        await self.pump()

    async def pump(self) -> None:
        """Write out if over high water; drain only on backpressure."""
        if not self.cork:
            self.drains += 1
            if self._stats is not None:
                self._stats["drains"] += 1
            await self._writer.drain()
            return
        if len(self._buf) >= self.high_water:
            self._write_out()
        transport = self._writer.transport
        if (
            transport is not None
            and transport.get_write_buffer_size() > self.drain_above
        ):
            self.drains += 1
            if self._stats is not None:
                self._stats["drains"] += 1
            await self._writer.drain()

    async def flush(self) -> None:
        """Force the buffer onto the transport now (still corked for the
        kernel: drain only on backpressure)."""
        self._write_out()
        transport = self._writer.transport
        if (
            transport is not None
            and transport.get_write_buffer_size() > self.drain_above
        ):
            self.drains += 1
            if self._stats is not None:
                self._stats["drains"] += 1
            await self._writer.drain()

    def _tick(self) -> None:
        self._tick_scheduled = False
        self._write_out()

    def _write_out(self) -> None:
        if not self._buf:
            return
        n = len(self._buf)
        if self._writer.is_closing():
            self._buf.clear()
            return
        self._writer.write(bytes(self._buf))
        self._buf.clear()
        self.flushes += 1
        self.bytes_out += n
        if self._stats is not None:
            self._stats["flushes"] += 1
            self._stats["bytes_out"] += n
        if self._on_flush is not None:
            self._on_flush(n)
