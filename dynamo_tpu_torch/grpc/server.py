"""gRPC over HTTP/2 (grpc/h2.py): the part of ``grpc.aio``'s server that the
KServe frontend (grpc/service.py) uses, with the stdlib only.

- ``Server.add_service(name, {method: rpc})`` routes ``/name/method`` to a
  unary-unary (``unary_unary(handler, ...)``) or unary-stream
  (``unary_stream(handler, ...)``) handler; an unknown method answers
  ``UNIMPLEMENTED``.
- Messages are length-prefixed (a 1-byte compressed flag, a 4-byte
  big-endian length). A request compressed with ``grpc-encoding`` gzip or
  deflate is read through zlib; responses are sent uncompressed. A request
  message past ``MAX_RECEIVE_MESSAGE`` (4 MiB, grpc's default) is
  refused with ``RESOURCE_EXHAUSTED``.
- A handler gets ``(request, context)``; ``ServicerContext`` has grpc's
  names: ``abort(code, details)`` (raises), ``set_trailing_metadata``,
  ``time_remaining()`` (from ``grpc-timeout``) and
  ``invocation_metadata()``. The call's deadline is enforced: past it the
  handler is cancelled and the call ends ``DEADLINE_EXCEEDED``.
- A response is its headers, then one DATA message per response, then
  trailers: ``grpc-status``, ``grpc-message`` (percent-encoded as the gRPC
  HTTP/2 spec says) and the trailing metadata. A status before the first
  message is a trailers-only response. An exception a handler does not
  handle ends the call ``UNKNOWN`` with grpc's "Unexpected <type>: ..."
  details.
- A client's RST_STREAM cancels the handler's task, so its ``finally``
  blocks run.
- ``stop(grace)`` stops accepting, sends GOAWAY on every connection, lets
  in-flight calls finish within ``grace`` seconds, then cancels them.
"""

from __future__ import annotations

import asyncio
import base64
import enum
import logging
import re
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Callable

from dynamo_tpu_torch.grpc import h2

log = logging.getLogger("dynamo_tpu_torch.grpc.server")

MAX_RECEIVE_MESSAGE = 4 * 1024 * 1024  # grpc's default max_receive_message_length
MAX_CONCURRENT_STREAMS = 100  # per connection, advertised in SETTINGS
CONTENT_TYPE = "application/grpc"
ACCEPT_ENCODING = "identity,deflate,gzip"
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}
_TIMEOUT_RE = re.compile(r"^(\d{1,8})([HMSmun])$")
# request headers that are transport, not the caller's metadata
_TRANSPORT = frozenset(("te", "content-type", "grpc-timeout", "grpc-encoding",
                        "grpc-accept-encoding", "content-length"))


class StatusCode(enum.IntEnum):
    """gRPC status codes, with grpc's numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class AbortError(Exception):
    """Raised by ``ServicerContext.abort``: the call ends with this status."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(details)
        self.code = StatusCode(code)
        self.details = details


def percent_encode(text: str) -> str:
    """``grpc-message``'s encoding: every UTF-8 octet outside 0x20..0x7E,
    and ``%``, as ``%XX``."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode("utf-8"))


def percent_decode(text: str) -> str:
    out, i = bytearray(), 0
    raw = text.encode("latin-1")
    while i < len(raw):
        if raw[i] == 0x25 and i + 2 < len(raw) and re.fullmatch(
                rb"[0-9A-Fa-f]{2}", raw[i + 1:i + 3]):
            out.append(int(raw[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def parse_timeout(value: str) -> float:
    """Seconds of a ``grpc-timeout`` value (at most 8 digits and a unit)."""
    m = _TIMEOUT_RE.match(value)
    if not m:
        raise ValueError(f"malformed grpc-timeout {value!r}")
    return int(m.group(1)) * _TIMEOUT_UNITS[m.group(2)]


def metadata_value(key: str, value: str):
    """A metadata value as the caller sent it: ``-bin`` keys are base64
    (padded or not) of bytes."""
    if key.endswith("-bin"):
        return base64.b64decode(value + "=" * (-len(value) % 4))
    return value


def wire_metadata(metadata) -> list[tuple[str, str]]:
    """(key, value) pairs for the wire: keys lower-case, ``-bin`` values
    base64 without padding (what grpc emits)."""
    out = []
    for key, value in metadata or ():
        key = key.lower()
        if key.endswith("-bin"):
            value = base64.b64encode(bytes(value)).decode("ascii").rstrip("=")
        out.append((key, str(value)))
    return out


def frame_message(data: bytes, compressed: bool = False) -> bytes:
    """One length-prefixed gRPC message."""
    return struct.pack(">BI", 1 if compressed else 0, len(data)) + data


def decompress(data: bytes, encoding: str) -> bytes:
    if encoding == "gzip":
        return zlib.decompress(data, 16 + zlib.MAX_WBITS)
    if encoding == "deflate":
        return zlib.decompress(data)
    raise AbortError(StatusCode.INTERNAL,
                     f"compressed message with grpc-encoding {encoding!r}")


@dataclass
class RpcMethod:
    """One method: its kind, handler and (de)serializers."""

    kind: str  # "unary_unary" | "unary_stream"
    handler: Callable
    request_deserializer: Callable[[bytes], Any]
    response_serializer: Callable[[Any], bytes]


def unary_unary(handler, request_deserializer, response_serializer) -> RpcMethod:
    return RpcMethod("unary_unary", handler, request_deserializer, response_serializer)


def unary_stream(handler, request_deserializer, response_serializer) -> RpcMethod:
    return RpcMethod("unary_stream", handler, request_deserializer, response_serializer)


class ServicerContext:
    """What a handler sees of its call (grpc.aio's names)."""

    def __init__(self, metadata: tuple, deadline: float | None):
        self._metadata = metadata
        self._deadline = deadline  # on the loop's clock
        self.trailing_metadata: tuple = ()

    def invocation_metadata(self) -> tuple:
        return self._metadata

    def time_remaining(self) -> float | None:
        if self._deadline is None:
            return None
        return max(self._deadline - asyncio.get_running_loop().time(), 0.0)

    def set_trailing_metadata(self, metadata) -> None:
        self.trailing_metadata = tuple(metadata)

    async def abort(self, code: StatusCode, details: str = "", trailing_metadata=()):
        if trailing_metadata:
            self.set_trailing_metadata(trailing_metadata)
        raise AbortError(code, details)


class Server:
    """A gRPC server on asyncio. ``start(host, port)`` returns the bound
    port (0 picks one)."""

    def __init__(self):
        self._methods: dict[str, RpcMethod] = {}
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[h2.Connection] = set()
        self._conn_tasks: set[asyncio.Task] = set()
        self._calls: set[asyncio.Task] = set()
        self._stopping = False

    def add_service(self, service: str, methods: dict[str, RpcMethod]) -> None:
        for name, rpc in methods.items():
            self._methods[f"/{service}/{name}"] = rpc

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._on_connection, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self, grace: float | None = None) -> None:
        """GOAWAY to every client; calls in flight get ``grace`` seconds
        (None: no limit), then are cancelled; every connection closes."""
        if self._server is None:
            return
        self._stopping = True
        self._server.close()
        for conn in list(self._conns):
            conn.goaway()
        calls = list(self._calls)
        if calls:
            await asyncio.wait(calls, timeout=grace)
        for task in list(self._calls):
            task.cancel()
        if self._calls:
            await asyncio.gather(*self._calls, return_exceptions=True)
        for conn in list(self._conns):
            conn.close()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # -- connections and calls ----------------------------------------------

    async def _on_connection(self, reader, writer) -> None:
        conn = h2.Connection(reader, writer, self._on_stream,
                             max_concurrent_streams=MAX_CONCURRENT_STREAMS)
        if self._stopping:
            writer.close()
            return
        task = asyncio.current_task()
        self._conns.add(conn)
        self._conn_tasks.add(task)
        try:
            await conn.run()
        finally:
            self._conns.discard(conn)
            self._conn_tasks.discard(task)

    def _on_stream(self, stream: h2.Stream) -> None:
        task = asyncio.get_running_loop().create_task(self._call(stream))
        self._calls.add(task)
        task.add_done_callback(self._calls.discard)
        stream.on_reset = lambda _code: task.cancel()

    async def _call(self, stream: h2.Stream) -> None:
        first: dict[str, str] = {}
        for k, v in stream.headers:
            first.setdefault(k, v)
        metadata = tuple((k, metadata_value(k, v)) for k, v in stream.headers
                         if not k.startswith(":") and k not in _TRANSPORT)
        loop = asyncio.get_running_loop()
        deadline = None
        ctx = ServicerContext(metadata, None)
        sent_headers = [False]
        timed_out = False
        try:
            if "grpc-timeout" in first:
                try:
                    deadline = loop.time() + parse_timeout(first["grpc-timeout"])
                except ValueError as e:
                    raise AbortError(StatusCode.INTERNAL, str(e)) from None
                ctx._deadline = deadline
            limit = asyncio.timeout_at(deadline)
            try:
                async with limit:
                    await self._run(stream, first, ctx, sent_headers)
            except TimeoutError:
                if not limit.expired():
                    raise
                timed_out = True
        except AbortError as e:
            await self._finish(stream, e.code, e.details, ctx.trailing_metadata,
                               sent_headers[0])
        except h2.StreamReset:
            pass  # the client reset the stream, or the connection closed
        except asyncio.CancelledError:
            if self._stopping:
                await self._finish(stream, StatusCode.UNAVAILABLE, "server shutting down",
                                   (), sent_headers[0])
            elif stream.reset_code is None:
                raise  # not the client's cancel: someone else's
        except Exception as e:  # noqa: BLE001 - the handler's fault ends its call
            log.exception("unexpected error in %s", first.get(":path"))
            await self._finish(stream, StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}",
                               ctx.trailing_metadata, sent_headers[0])
        if timed_out:
            await self._finish(stream, StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded",
                               ctx.trailing_metadata, sent_headers[0])

    async def _run(self, stream: h2.Stream, first: dict, ctx: ServicerContext,
                   sent_headers: list) -> None:
        method = self._methods.get(first.get(":path", ""))
        if first.get(":method") != "POST" or method is None:
            raise AbortError(StatusCode.UNIMPLEMENTED, "Method not found!")
        encoding = first.get("grpc-encoding", "identity")
        if encoding not in ("identity", "gzip", "deflate"):
            raise AbortError(StatusCode.UNIMPLEMENTED,
                             f"grpc-encoding {encoding!r} is not supported")
        # a request that does not parse ends UNKNOWN, as on grpc.aio
        request = method.request_deserializer(await self._read_request(stream, encoding))

        async def send(response) -> None:
            data = frame_message(method.response_serializer(response))
            if not sent_headers[0]:
                await stream.send_headers([(":status", "200"), ("content-type", CONTENT_TYPE),
                                           ("grpc-accept-encoding", ACCEPT_ENCODING)])
                sent_headers[0] = True
            await stream.send_data(data)

        if method.kind == "unary_unary":
            await send(await method.handler(request, ctx))
        else:
            agen = method.handler(request, ctx)
            try:
                async for response in agen:
                    await send(response)
            finally:
                await agen.aclose()
        await self._finish(stream, StatusCode.OK, "", ctx.trailing_metadata, sent_headers[0])

    async def _read_request(self, stream: h2.Stream, encoding: str) -> bytes:
        """The request's one message (the body must hold exactly one)."""
        buf = bytearray()
        limit = MAX_RECEIVE_MESSAGE
        while True:
            chunk = await stream.read()
            if chunk is None:
                break
            buf += chunk
            if len(buf) >= 5:
                n = struct.unpack_from(">I", buf, 1)[0]
                if n > limit:
                    raise AbortError(StatusCode.RESOURCE_EXHAUSTED,
                                     f"SERVER: Received message larger than max ({n} vs. {limit})")
        if len(buf) < 5:
            raise AbortError(StatusCode.INTERNAL, "a request with no message")
        flag, n = struct.unpack_from(">BI", buf, 0)
        if len(buf) != 5 + n:
            raise AbortError(StatusCode.INTERNAL,
                             f"request body of {len(buf)} bytes for one message of {n}")
        data = bytes(buf[5:])
        if flag & 1:
            if encoding == "identity":
                raise AbortError(StatusCode.INTERNAL, "compressed message without grpc-encoding")
            try:
                data = decompress(data, encoding)
            except zlib.error as e:
                raise AbortError(StatusCode.INTERNAL, f"decompressing the request: {e}") from None
            if len(data) > limit:
                raise AbortError(StatusCode.RESOURCE_EXHAUSTED,
                                 f"SERVER: Received message larger than max ({len(data)} vs. {limit})")
        return data

    async def _finish(self, stream: h2.Stream, code: StatusCode, details: str,
                      trailing, headers_sent: bool) -> None:
        """Trailers with the status (a trailers-only response when nothing
        was sent yet). A stream already reset or ended is left alone."""
        if stream.reset_code is not None or stream.send_closed or stream.conn.closed:
            return
        trailers = [("grpc-status", str(int(code)))]
        if details:
            trailers.append(("grpc-message", percent_encode(details)))
        trailers += wire_metadata(trailing)
        if not headers_sent:
            trailers = [(":status", "200"), ("content-type", CONTENT_TYPE)] + trailers
        try:
            await stream.send_headers(trailers, end_stream=True)
        except h2.StreamReset:
            pass
