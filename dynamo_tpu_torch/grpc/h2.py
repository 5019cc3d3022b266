"""An HTTP/2 server connection (RFC 9113) on an asyncio stream pair, for the
gRPC server (grpc/server.py). No HTTP/2 library is used: the port runs
where none is installed.

What a connection does:

- reads the client preface and answers with its SETTINGS; ACKs the
  client's SETTINGS, ignoring ids it does not know (grpc's client sends
  0xFE03); a later ``INITIAL_WINDOW_SIZE`` moves the send window of every
  open stream, which may go negative; ``HEADER_TABLE_SIZE`` resizes the
  HPACK encoder's table; ``MAX_FRAME_SIZE`` bounds the frames it sends;
- ACKs PINGs (grpc's C core sends BDP pings and waits for their ACKs);
- reads HEADERS with CONTINUATION, padding and the priority flag, and
  DATA (padded or not), and returns what it received to the peer with
  WINDOW_UPDATEs on the connection and on the stream once half a window
  has been consumed;
- sends DATA only inside the peer's connection and stream windows,
  waiting for its WINDOW_UPDATEs, in frames of at most its
  ``MAX_FRAME_SIZE``;
- RST_STREAM both ways; GOAWAY (``goaway()``, and a connection error
  sends one with its code); refuses a stream past its advertised
  ``MAX_CONCURRENT_STREAMS`` with RST_STREAM ``REFUSED_STREAM``.

The frame codec (``frame``, ``read_frame``) is shared with chip_smoke.py's
minimal client.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Callable

from dynamo_tpu_torch.grpc import hpack

log = logging.getLogger("dynamo_tpu_torch.grpc.h2")

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20
# SETTINGS ids
HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, \
    MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE = range(1, 7)
# error codes
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, SETTINGS_TIMEOUT, \
    STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = range(10)

DEFAULT_WINDOW = 65535
DEFAULT_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1
MAX_HEADER_BLOCK = 1 << 20  # a longer header block is a connection error


class ConnectionError_(Exception):
    """A connection error: the connection sends GOAWAY with ``code``."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class StreamReset(Exception):
    """The stream was reset (by the peer or by this side) with ``code``."""

    def __init__(self, code: int):
        super().__init__(f"stream reset (error code {code})")
        self.code = code


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    """One frame's bytes: the 9-byte header, then the payload."""
    n = len(payload)
    return struct.pack(">BHBBI", n >> 16, n & 0xFFFF, ftype, flags,
                       stream_id & MAX_WINDOW) + bytes(payload)


async def read_frame(reader: asyncio.StreamReader, max_size: int = DEFAULT_FRAME):
    """(type, flags, stream id, payload) of the next frame; a payload past
    ``max_size`` raises a FRAME_SIZE_ERROR."""
    head = await reader.readexactly(9)
    hi, lo, ftype, flags, sid = struct.unpack(">BHBBI", head)
    n = hi << 16 | lo
    if n > max_size:
        raise ConnectionError_(FRAME_SIZE_ERROR, f"frame of {n} bytes past {max_size}")
    return ftype, flags, sid & MAX_WINDOW, await reader.readexactly(n)


def settings_payload(settings: dict[int, int]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in settings.items())


def parse_settings(payload: bytes) -> list[tuple[int, int]]:
    if len(payload) % 6:
        raise ConnectionError_(FRAME_SIZE_ERROR, "SETTINGS payload not a multiple of 6")
    return [struct.unpack_from(">HI", payload, i) for i in range(0, len(payload), 6)]


def strip_padding(flags: int, payload: bytes, priority: bool = False) -> bytes:
    """A DATA or HEADERS payload without its padding (and priority fields)."""
    start, end = 0, len(payload)
    if flags & PADDED:
        if not payload:
            raise ConnectionError_(PROTOCOL_ERROR, "padded frame without a pad length")
        start, end = 1, end - payload[0]
    if priority and flags & PRIORITY_FLAG:
        start += 5
    if end < start:
        raise ConnectionError_(PROTOCOL_ERROR, "padding past the frame's payload")
    return payload[start:end]


def header_frames(stream_id: int, block: bytes, end_stream: bool, max_frame: int) -> bytes:
    """A header block as HEADERS plus CONTINUATION frames of at most
    ``max_frame`` bytes each."""
    parts = [block[i:i + max_frame] for i in range(0, len(block), max_frame)] or [b""]
    out = bytearray()
    for i, part in enumerate(parts):
        flags = END_HEADERS if i == len(parts) - 1 else 0
        if i == 0:
            out += frame(HEADERS, flags | (END_STREAM if end_stream else 0), stream_id, part)
        else:
            out += frame(CONTINUATION, flags, stream_id, part)
    return bytes(out)


class Stream:
    """One request stream as the server sees it: the request's headers, its
    DATA (``read``) and this side's response (``send_headers``,
    ``send_data``, ``reset``). ``on_reset`` is called once if the stream is
    reset."""

    def __init__(self, conn: "Connection", stream_id: int, headers: list[tuple[str, str]]):
        self.conn = conn
        self.id = stream_id
        self.headers = headers
        self.send_window = conn.peer_initial_window
        self.recv_closed = False  # the peer sent END_STREAM
        self.send_closed = False  # this side sent END_STREAM
        self.reset_code: int | None = None
        self.on_reset: Callable[[int], None] | None = None
        self._chunks: asyncio.Queue = asyncio.Queue()
        self._unacked = 0  # received bytes not yet returned with a WINDOW_UPDATE

    async def read(self) -> bytes | None:
        """The next DATA payload, or None once the peer ended its side."""
        if self.reset_code is not None:
            raise StreamReset(self.reset_code)
        if self.recv_closed and self._chunks.empty():
            return None
        item = await self._chunks.get()
        if isinstance(item, StreamReset):
            raise item
        return item

    async def send_headers(self, headers, end_stream: bool = False) -> None:
        self._check_open()
        self.conn.write_headers(self.id, headers, end_stream)
        if end_stream:
            self._close_send()
        await self.conn.drain()

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        """``data`` in frames inside the peer's windows; waits for them."""
        conn = self.conn
        view = memoryview(data)
        while True:
            self._check_open()
            n = min(len(view), conn.peer_max_frame)
            if n:
                avail = min(self.send_window, conn.send_window)
                if avail <= 0:
                    await conn.wait_window()
                    continue
                n = min(n, avail)
            last = end_stream and n == len(view)
            conn.write(frame(DATA, END_STREAM if last else 0, self.id, view[:n]))
            self.send_window -= n
            conn.send_window -= n
            view = view[n:]
            if not len(view):
                break
        if end_stream:
            self._close_send()
        await conn.drain()

    def reset(self, code: int = CANCEL) -> None:
        """Send RST_STREAM (once) and close the stream; its handler is told
        (``on_reset``) as for a reset by the peer."""
        if self.reset_code is None and not (self.send_closed and self.recv_closed):
            self.conn.write(frame(RST_STREAM, 0, self.id, struct.pack(">I", code)))
            self._mark_reset(code)

    def _check_open(self) -> None:
        if self.reset_code is not None:
            raise StreamReset(self.reset_code)
        if self.send_closed:
            raise RuntimeError(f"stream {self.id}: this side already ended it")
        if self.conn.closed:
            raise StreamReset(CANCEL)

    def _close_send(self) -> None:
        self.send_closed = True
        if not self.recv_closed:
            # the response ended before the request: the peer may stop sending
            self.conn.write(frame(RST_STREAM, 0, self.id, struct.pack(">I", NO_ERROR)))
            self.recv_closed = True
        self.conn.forget(self)

    def _mark_reset(self, code: int) -> None:
        if self.reset_code is not None:
            return
        self.reset_code = code
        self._chunks.put_nowait(StreamReset(code))
        self.conn.forget(self)
        self.conn.wake_senders()
        if self.on_reset is not None:
            self.on_reset(code)

    def _received(self, data: bytes, size: int, end: bool) -> None:
        if data:
            self._chunks.put_nowait(data)
        if end:
            self.recv_closed = True
            self._chunks.put_nowait(None)
        else:
            self._unacked += size
            if self._unacked >= self.conn.local_window // 2:
                self.conn.write(frame(WINDOW_UPDATE, 0, self.id,
                                      struct.pack(">I", self._unacked)))
                self._unacked = 0


class Connection:
    """One client connection. ``on_stream(stream)`` is called (not awaited)
    for each new request stream once its headers have arrived; ``run()``
    serves the connection until the peer closes it or a connection error."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 on_stream: Callable[[Stream], None], *, max_concurrent_streams: int):
        self.reader, self.writer = reader, writer
        self.on_stream = on_stream
        self.max_concurrent_streams = max_concurrent_streams
        self.local_window = DEFAULT_WINDOW  # this side's INITIAL_WINDOW_SIZE
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_FRAME
        self.send_window = DEFAULT_WINDOW  # the connection's, for DATA this side sends
        self.streams: dict[int, Stream] = {}
        self.last_stream_id = 0  # the highest stream id the peer opened
        self.going_away = False
        self.closed = False
        self.goaway_sent: int | None = None  # the error code of the GOAWAY sent
        self.encoder = hpack.Encoder()
        self.decoder = hpack.Decoder()
        self._window = asyncio.Event()
        self._unacked = 0  # connection-level bytes received, not yet returned

    # -- writing -------------------------------------------------------------

    def write(self, data: bytes) -> None:
        if not self.closed:
            self.writer.write(data)

    async def drain(self) -> None:
        if not self.closed:
            try:
                await self.writer.drain()
            except ConnectionError:
                self.close()

    def write_headers(self, stream_id: int, headers, end_stream: bool) -> None:
        """Encode and write one header block; nothing may come between the
        encoder's state and the frames' order, so this does not await."""
        block = self.encoder.encode(headers)
        self.write(header_frames(stream_id, block, end_stream, self.peer_max_frame))

    async def wait_window(self) -> None:
        """Until a WINDOW_UPDATE or SETTINGS moves a window (or the
        connection closes)."""
        if self.closed:
            raise StreamReset(CANCEL)
        event = self._window
        await event.wait()

    def wake_senders(self) -> None:
        self._window.set()
        self._window = asyncio.Event()

    def forget(self, stream: Stream) -> None:
        if (stream.reset_code is not None or (stream.send_closed and stream.recv_closed)):
            self.streams.pop(stream.id, None)

    def goaway(self, code: int = NO_ERROR, message: str = "") -> None:
        """Send GOAWAY naming the last stream this side will serve; no new
        stream is accepted after it."""
        self.going_away = True
        if self.goaway_sent is None:
            self.goaway_sent = code
            self.write(frame(GOAWAY, 0, 0, struct.pack(">II", self.last_stream_id, code)
                             + message.encode()))

    # -- reading -------------------------------------------------------------

    async def run(self) -> None:
        try:
            preface = await self.reader.readexactly(len(PREFACE))
            if preface != PREFACE:
                raise ConnectionError_(PROTOCOL_ERROR, "not an HTTP/2 client preface")
            self.write(frame(SETTINGS, 0, 0, settings_payload({
                MAX_CONCURRENT_STREAMS: self.max_concurrent_streams,
                INITIAL_WINDOW_SIZE: self.local_window,
                MAX_FRAME_SIZE: DEFAULT_FRAME})))
            await self.drain()
            while True:
                ftype, flags, sid, payload = await read_frame(self.reader)
                # control frames written here (ACKs, WINDOW_UPDATEs) are not
                # drained: a peer slow to read must not stop this loop reading
                # its WINDOW_UPDATEs
                if ftype == HEADERS:
                    await self._on_headers(flags, sid, payload)
                else:
                    self._on_frame(ftype, flags, sid, payload)
        except ConnectionError_ as e:
            log.info("h2 connection error %d: %s", e.code, e)
            self.goaway(e.code, str(e))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # the peer went away
        except hpack.HpackError as e:
            log.info("h2 header block: %s", e)
            self.goaway(COMPRESSION_ERROR, str(e))
        finally:
            self.close()

    def close(self) -> None:
        """Close the connection: every open stream is reset (its handler's
        ``on_reset`` runs), every sender waiting on a window wakes."""
        if self.closed:
            return
        self.closed = True
        for stream in list(self.streams.values()):
            stream._mark_reset(CANCEL)
        self.wake_senders()
        self.writer.close()

    async def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        block = bytearray(strip_padding(flags, payload, priority=True))
        end_stream = bool(flags & END_STREAM)
        while not flags & END_HEADERS:
            ftype, flags, csid, more = await read_frame(self.reader)
            if ftype != CONTINUATION or csid != sid:
                raise ConnectionError_(PROTOCOL_ERROR, "header block interrupted")
            block += more
            if len(block) > MAX_HEADER_BLOCK:
                raise ConnectionError_(PROTOCOL_ERROR, "header block too large")
        headers = self.decoder.decode(bytes(block))  # always: the table's state
        if sid == 0 or sid % 2 == 0:
            raise ConnectionError_(PROTOCOL_ERROR, f"HEADERS on stream {sid}")
        stream = self.streams.get(sid)
        if stream is not None:  # trailers of a request
            if stream.recv_closed:
                raise ConnectionError_(STREAM_CLOSED, f"HEADERS on half-closed {sid}")
            if not end_stream:
                raise ConnectionError_(PROTOCOL_ERROR, "trailers without END_STREAM")
            stream._received(b"", 0, True)
            self.forget(stream)
            return
        if sid <= self.last_stream_id:
            raise ConnectionError_(STREAM_CLOSED, f"HEADERS on closed stream {sid}")
        self.last_stream_id = sid
        if self.going_away or len(self.streams) >= self.max_concurrent_streams:
            self.write(frame(RST_STREAM, 0, sid, struct.pack(">I", REFUSED_STREAM)))
            return
        stream = Stream(self, sid, headers)
        self.streams[sid] = stream
        if end_stream:
            stream._received(b"", 0, True)
        self.on_stream(stream)

    def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == SETTINGS:
            if sid:
                raise ConnectionError_(PROTOCOL_ERROR, "SETTINGS on a stream")
            if flags & ACK:
                return
            self._apply_settings(parse_settings(payload))
            self.write(frame(SETTINGS, ACK, 0))
        elif ftype == PING:
            if len(payload) != 8 or sid:
                raise ConnectionError_(FRAME_SIZE_ERROR, "PING of the wrong size")
            if not flags & ACK:
                self.write(frame(PING, ACK, 0, payload))
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise ConnectionError_(FRAME_SIZE_ERROR, "WINDOW_UPDATE of the wrong size")
            inc = struct.unpack(">I", payload)[0] & MAX_WINDOW
            if sid == 0:
                if inc == 0:
                    raise ConnectionError_(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                self.send_window += inc
                if self.send_window > MAX_WINDOW:
                    raise ConnectionError_(FLOW_CONTROL_ERROR, "connection window overflow")
            else:
                stream = self.streams.get(sid)
                if stream is not None:
                    if inc == 0:
                        stream.reset(PROTOCOL_ERROR)
                        return
                    stream.send_window += inc
                    if stream.send_window > MAX_WINDOW:
                        stream.reset(FLOW_CONTROL_ERROR)
            self.wake_senders()
        elif ftype == RST_STREAM:
            if len(payload) != 4 or sid == 0:
                raise ConnectionError_(PROTOCOL_ERROR, "bad RST_STREAM")
            stream = self.streams.get(sid)
            if stream is not None:
                stream._mark_reset(struct.unpack(">I", payload)[0])
        elif ftype == GOAWAY:
            self.going_away = True  # the peer opens no more streams
        elif ftype == PRIORITY:
            if len(payload) != 5:
                raise ConnectionError_(FRAME_SIZE_ERROR, "PRIORITY of the wrong size")
        elif ftype == PUSH_PROMISE:
            raise ConnectionError_(PROTOCOL_ERROR, "PUSH_PROMISE from a client")
        elif ftype == CONTINUATION:
            raise ConnectionError_(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        # any other type is an extension this side ignores

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        size = len(payload)
        self._unacked += size
        if self._unacked >= self.local_window // 2:
            self.write(frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", self._unacked)))
            self._unacked = 0
        if sid == 0:
            raise ConnectionError_(PROTOCOL_ERROR, "DATA on stream 0")
        data = strip_padding(flags, payload)
        stream = self.streams.get(sid)
        if stream is None:
            if sid > self.last_stream_id:
                raise ConnectionError_(PROTOCOL_ERROR, f"DATA on idle stream {sid}")
            return  # a stream this side reset or ended: dropped
        if stream.recv_closed:
            stream.reset(STREAM_CLOSED)
            return
        stream._received(data, size, bool(flags & END_STREAM))
        self.forget(stream)

    def _apply_settings(self, settings) -> None:
        for key, value in settings:
            if key == HEADER_TABLE_SIZE:
                self.encoder.set_max_table_size(value)
            elif key == ENABLE_PUSH:
                if value > 1:
                    raise ConnectionError_(PROTOCOL_ERROR, "ENABLE_PUSH not 0 or 1")
            elif key == INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise ConnectionError_(FLOW_CONTROL_ERROR, "INITIAL_WINDOW_SIZE too large")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for stream in self.streams.values():
                    stream.send_window += delta  # may go negative
                self.wake_senders()
            elif key == MAX_FRAME_SIZE:
                if not DEFAULT_FRAME <= value <= (1 << 24) - 1:
                    raise ConnectionError_(PROTOCOL_ERROR, "MAX_FRAME_SIZE out of range")
                self.peer_max_frame = value
            # MAX_CONCURRENT_STREAMS and MAX_HEADER_LIST_SIZE bound what
            # this side would open or send, and unknown ids are ignored
