"""A small HTTP/1.1 client on asyncio streams (the port's stand-in for the
aiohttp client sessions the reference's planner, sim and load generator
use).

- ``read_response``: the status, headers and body of one response:
  Content-Length, chunked, or read to the close;
- ``http_get``: one GET on a connection of its own (``Connection: close``);
- ``HttpSession``: keep-alive requests to one ``host:port`` with JSON
  bodies, idle connections reused; ``stream`` reads a response's SSE
  events as they arrive, each stamped with its arrival time.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time
from collections.abc import AsyncIterator
from typing import Any
from urllib.parse import urlsplit

__all__ = ["HttpSession", "http_get", "read_response"]


async def _read_head(reader: asyncio.StreamReader) -> tuple[int, dict[str, str]]:
    """(status, lower-cased headers) of the next response on ``reader``."""
    status = (await reader.readline()).decode("latin-1").split()
    if len(status) < 2 or not status[0].startswith("HTTP/") or not status[1].isdigit():
        raise ConnectionError(f"malformed HTTP status line {status!r}")
    headers: dict[str, str] = {}
    while True:
        line = (await reader.readline()).decode("latin-1").strip()
        if not line:
            break
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(status[1]), headers


def _chunked(headers: dict[str, str]) -> bool:
    return "chunked" in headers.get("transfer-encoding", "").lower()


async def _body(reader: asyncio.StreamReader, headers: dict[str, str]
                ) -> AsyncIterator[bytes]:
    """The body's bytes as they arrive: chunk by chunk, the Content-Length
    at once, or every read up to the close."""
    if _chunked(headers):
        while True:
            line = await reader.readline()
            try:
                size = int(line.split(b";")[0].strip(), 16)
            except ValueError:
                raise ConnectionError(f"malformed chunk size line {line!r}") from None
            if size == 0:
                await reader.readline()  # the empty trailer's CRLF
                return
            chunk = await reader.readexactly(size)
            await reader.readexactly(2)  # the chunk's CRLF
            yield chunk
    elif "content-length" in headers:
        yield await reader.readexactly(int(headers["content-length"]))
    else:
        while chunk := await reader.read(65536):
            yield chunk


async def read_response(reader: asyncio.StreamReader) -> tuple[int, dict[str, str], bytes]:
    """(status, lower-cased headers, body) of the next response on ``reader``."""
    status, headers = await _read_head(reader)
    return status, headers, await _join(_body(reader, headers))


async def _join(chunks: AsyncIterator[bytes]) -> bytes:
    return b"".join([c async for c in chunks])


async def http_get(url: str, timeout_s: float = 10.0) -> str:
    """GET ``http://host[:port]/path`` (HTTP/1.1, ``Connection: close``):
    the body decoded as UTF-8. A status other than 2xx raises."""
    parts = urlsplit(url)
    if parts.scheme != "http" or not parts.hostname:
        raise ValueError(f"not an http:// URL: {url!r}")
    path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")

    async def fetch() -> tuple[int, bytes]:
        reader, writer = await asyncio.open_connection(parts.hostname, parts.port or 80)
        try:
            writer.write(f"GET {path} HTTP/1.1\r\nHost: {parts.netloc}\r\n"
                         "Accept: text/plain\r\nConnection: close\r\n\r\n".encode())
            await writer.drain()
            status, _, body = await read_response(reader)
            return status, body
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:
                pass

    status, body = await asyncio.wait_for(fetch(), timeout_s)
    if not 200 <= status < 300:
        raise ConnectionError(f"GET {url}: HTTP {status}")
    return body.decode("utf-8")


class HttpSession:
    """Keep-alive HTTP/1.1 requests to one server. Concurrent requests each
    take an idle connection or dial a new one, with no cap on their number;
    a connection goes back to the idle pool after its response unless the
    server closes it."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self._idle: list[tuple[asyncio.StreamReader, asyncio.StreamWriter]] = []
        self._all: set[asyncio.StreamWriter] = set()

    async def _exchange(self, method: str, path: str, body: Any
                        ) -> tuple[asyncio.StreamReader, asyncio.StreamWriter, int,
                                   dict[str, str]]:
        """Send one request and read its response head: (reader, writer,
        status, headers). An idle connection the server closed is redialled
        once; ``timeout_s`` bounds the dial and the head."""
        data = b"" if body is None else json.dumps(body).encode()
        head = (f"{method} {path} HTTP/1.1\r\nHost: {self.host}:{self.port}\r\n"
                f"Content-Length: {len(data)}\r\n"
                + ("Content-Type: application/json\r\n" if body is not None else "")
                + "\r\n").encode()
        for attempt in range(2):
            reused = bool(self._idle)
            if reused:
                reader, writer = self._idle.pop()
            else:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(self.host, self.port), self.timeout_s)
                self._all.add(writer)
            try:
                writer.write(head + data)
                await writer.drain()
                status, headers = await asyncio.wait_for(_read_head(reader),
                                                         self.timeout_s)
            except (ConnectionError, asyncio.IncompleteReadError):
                self._drop(writer)
                if reused and attempt == 0:
                    continue  # the server closed an idle connection: redial once
                raise
            except BaseException:
                self._drop(writer)
                raise
            return reader, writer, status, headers
        raise AssertionError("unreachable")

    def _release(self, reader, writer, headers: dict[str, str]) -> None:
        """Back to the idle pool after a body read to its end, unless the
        server closes the connection."""
        if (headers.get("connection", "").lower() == "close"
                or not (_chunked(headers) or "content-length" in headers)):
            self._drop(writer)
        else:
            self._idle.append((reader, writer))

    async def request(self, method: str, path: str, body: Any = None
                      ) -> tuple[int, bytes]:
        """(status, body) of one request; ``body`` goes out as JSON."""
        reader, writer, status, headers = await self._exchange(method, path, body)
        try:
            out = await asyncio.wait_for(
                _join(_body(reader, headers)), self.timeout_s)
        except BaseException:
            self._drop(writer)
            raise
        self._release(reader, writer, headers)
        return status, out

    @contextlib.asynccontextmanager
    async def stream(self, method: str, path: str, body: Any = None):
        """One request whose response is read as it arrives: yields (status,
        events), ``events`` an async iterator of (the payload of each SSE
        ``data: `` line, ``time.perf_counter()`` when the bytes that end the
        line arrived). The connection returns to the idle pool only when
        ``events`` was read to the body's end; ``timeout_s`` bounds the dial
        and the head, not the body."""
        reader, writer, status, headers = await self._exchange(method, path, body)
        done = False

        async def events() -> AsyncIterator[tuple[bytes, float]]:
            nonlocal done
            rest = b""
            async for chunk in _body(reader, headers):
                t = time.perf_counter()
                *lines, rest = (rest + chunk).split(b"\n")
                for line in lines:
                    if line.startswith(b"data: "):
                        yield line[6:].rstrip(b"\r"), t
            if rest.startswith(b"data: "):
                yield rest[6:].rstrip(b"\r"), time.perf_counter()
            done = True

        gen = events()
        try:
            yield status, gen
        finally:
            await gen.aclose()
            if done:
                self._release(reader, writer, headers)
            else:
                self._drop(writer)

    def _drop(self, writer: asyncio.StreamWriter) -> None:
        self._all.discard(writer)
        writer.close()

    async def close(self) -> None:
        for writer in list(self._all):
            self._drop(writer)
        self._idle.clear()

    async def __aenter__(self) -> "HttpSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

