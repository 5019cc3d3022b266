"""A small HTTP/1.1 server on asyncio streams, for the OpenAI frontend.

The reference frontend runs on aiohttp, which the GPU machine lacks. This
module does the part of aiohttp's work that frontend/http.py relies on:

- requests with ``Content-Length`` or chunked bodies, ``Expect:
  100-continue``, keep-alive (HTTP/1.1 default, ``Connection: close`` ends
  it), a body of 1 MiB or more refused with 413 (aiohttp's default
  ``client_max_size``) without reading it;
- routing by (method, path): an unknown path answers 404, a known path
  with another method 405 with ``Allow``; ``HEAD`` on a GET route answers
  the GET's status and headers, ``Content-Length`` included, with no body
  (aiohttp's ``allow_head=True``);
- JSON / text responses with ``Content-Length``, and streamed responses
  (SSE) in chunked transfer encoding, so the connection stays usable after
  the stream ends; an HTTP/1.0 client, which has no chunked coding, gets
  the raw body and the connection closes at its end, as aiohttp does;
- a client that goes away mid-stream surfaces as ``ConnectionResetError``
  from ``StreamResponse.write``;
- ``stop()`` closes every open connection itself: Python 3.12's
  ``Server.wait_closed()`` waits for them.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qsl, urlsplit

log = logging.getLogger("dynamo_tpu_torch.http_server")

MAX_BODY = 1024 ** 2  # aiohttp's default client_max_size: 413 at or above it
MAX_HEAD = 64 * 1024  # request line + headers
JSON_TYPE = "application/json; charset=utf-8"

_REASONS = {
    100: "Continue", 200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Request Entity Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    501: "Not Implemented", 502: "Bad Gateway", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Request:
    """One parsed request. ``headers`` keys are lower-case."""

    def __init__(self, method: str, target: str, version: str,
                 headers: dict[str, str], body: bytes, writer: asyncio.StreamWriter):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path or "/"
        self.query = dict(parse_qsl(parts.query))
        self.version = version
        self.headers = headers
        self.body = body
        self.writer = writer

    def json(self) -> Any:
        """The body as JSON; raises ValueError (JSONDecodeError or
        UnicodeDecodeError) on a malformed body."""
        return json.loads(self.body)

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class Response:
    """A complete response: status, body, content type, extra headers."""

    def __init__(self, status: int = 200, body: bytes | str = b"",
                 content_type: str = "text/plain; charset=utf-8",
                 headers: dict[str, str] | None = None):
        self.status = status
        self.body = body.encode() if isinstance(body, str) else body
        self.content_type = content_type
        self.headers = headers or {}

    @classmethod
    def json(cls, data: Any, status: int = 200,
             headers: dict[str, str] | None = None) -> "Response":
        return cls(status, json.dumps(data), JSON_TYPE, headers)

    def head(self, keep_alive: bool) -> bytes:
        lines = [f"HTTP/1.1 {self.status} {_REASONS.get(self.status, 'Unknown')}",
                 f"Content-Type: {self.content_type}",
                 f"Content-Length: {len(self.body)}",
                 *(f"{k}: {v}" for k, v in self.headers.items())]
        if not keep_alive:
            lines.append("Connection: close")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A streamed 200 response (SSE): in chunked transfer encoding, or raw
    up to the connection's close for an HTTP/1.0 client. A write to a
    client that went away raises ConnectionResetError."""

    def __init__(self, request: Request, headers: dict[str, str]):
        self._writer = request.writer
        self._headers = headers
        self.status = 200
        self.finished = False
        self.chunked = request.version != "HTTP/1.0"

    async def _send(self, data: bytes) -> None:
        if self._writer.is_closing():
            raise ConnectionResetError("client closed the connection")
        self._writer.write(data)
        await self._writer.drain()

    async def prepare(self) -> None:
        framing = "Transfer-Encoding: chunked" if self.chunked else "Connection: close"
        lines = ["HTTP/1.1 200 OK", framing,
                 *(f"{k}: {v}" for k, v in self._headers.items())]
        await self._send(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def write(self, data: bytes) -> None:
        if data:
            await self._send(b"%x\r\n%b\r\n" % (len(data), data) if self.chunked
                             else data)

    async def write_eof(self) -> None:
        if not self.finished:
            self.finished = True
            if self.chunked:
                await self._send(b"0\r\n\r\n")


Handler = Callable[[Request], Awaitable["Response | StreamResponse"]]


async def _read_head(reader: asyncio.StreamReader) -> bytes | None:
    """The request head up to the blank line; None on a clean EOF between
    requests."""
    try:
        return await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise _BadRequest(400, "incomplete request head") from e
    except asyncio.LimitOverrunError as e:
        raise _BadRequest(400, "request head too large") from e


def _parse_head(head: bytes) -> tuple[str, str, str, dict[str, str]]:
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, version = lines[0].split(" ")
    except ValueError as e:
        raise _BadRequest(400, f"malformed request line {lines[0]!r}") from e
    if not version.startswith("HTTP/1."):
        raise _BadRequest(400, f"unsupported protocol {version!r}")
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise _BadRequest(400, f"malformed header line {line!r}")
        headers[name.strip().lower()] = value.strip()
    return method.upper(), target, version, headers


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        return await reader.readuntil(b"\r\n")
    except asyncio.LimitOverrunError as e:
        raise _BadRequest(400, "chunk line too long") from e


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    body = bytearray()
    while True:
        size_line = await _read_line(reader)
        try:
            size = int(size_line.split(b";")[0].strip(), 16)
        except ValueError as e:
            raise _BadRequest(400, "malformed chunk size") from e
        if size == 0:
            # trailers, up to the blank line
            while (await _read_line(reader)) != b"\r\n":
                pass
            return bytes(body)
        if len(body) + size >= MAX_BODY:
            raise _BadRequest(413, f"request body of {MAX_BODY} bytes or more")
        body += await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise _BadRequest(400, "malformed chunk")


class HttpServer:
    """Routes (method, path) -> async handler(Request)."""

    def __init__(self) -> None:
        self._routes: dict[str, dict[str, Handler]] = {}
        self._server: asyncio.base_events.Server | None = None
        self._writers: set[asyncio.StreamWriter] = set()

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.setdefault(path, {})[method.upper()] = handler

    async def start(self, host: str, port: int) -> int:
        """Listen; returns the bound port (the real one when ``port`` is 0)."""
        self._server = await asyncio.start_server(
            self._connection, host, port, limit=MAX_HEAD)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for w in list(self._writers):
            w.close()
        try:
            await asyncio.wait_for(self._server.wait_closed(), 5.0)
        except asyncio.TimeoutError:
            log.warning("http server: connections still open after stop")
        self._server = None

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while await self._one_request(reader, writer):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _one_request(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> bool:
        """Serve one request; False when the connection should close."""
        try:
            head = await _read_head(reader)
            if head is None:
                return False
            method, target, version, headers = _parse_head(head)
            te = headers.get("transfer-encoding", "").lower()
            length = headers.get("content-length")
            if length is not None and (not length.isdigit()):
                raise _BadRequest(400, "malformed Content-Length")
            if length is not None and int(length) >= MAX_BODY:
                raise _BadRequest(413, f"request body of {MAX_BODY} bytes or more")
            if headers.get("expect", "").lower() == "100-continue":
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            if te == "chunked":
                body = await _read_chunked(reader)
            elif length:
                body = await reader.readexactly(int(length))
            else:
                body = b""
        except _BadRequest as e:
            # the rest of the request was not read: answer, then close
            resp = Response(e.status, f"{e.status}: {e}")
            writer.write(resp.head(keep_alive=False) + resp.body)
            await writer.drain()
            return False
        request = Request(method, target, version, headers, body, writer)
        resp = await self._dispatch(request)
        if isinstance(resp, StreamResponse):
            # a streamed response ends its own body; one that failed
            # before its end, or one delimited by the close, leaves the
            # connection unusable
            return resp.finished and resp.chunked and request.keep_alive
        head = resp.head(request.keep_alive)
        writer.write(head if method == "HEAD" else head + resp.body)
        await writer.drain()
        return request.keep_alive

    async def _dispatch(self, request: Request) -> "Response | StreamResponse":
        methods = self._routes.get(request.path)
        if methods is None:
            return Response(404, "404: Not Found")
        handler = methods.get(request.method)
        if handler is None and request.method == "HEAD":
            handler = methods.get("GET")
        if handler is None:
            return Response(405, "405: Method Not Allowed",
                            headers={"Allow": ",".join(sorted(methods))})
        try:
            return await handler(request)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception:  # noqa: BLE001 - one bad handler must not kill the server
            log.exception("handler for %s %s failed", request.method, request.path)
            return Response(500, "500: Internal Server Error")
