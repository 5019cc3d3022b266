"""Lean persistent-connection /pick transport ("pickline"; the port's copy
of dynamo_tpu/gateway/pickline.py, on the same wire bytes).

The cluster sim measured the aiohttp /pick p50 at ~4-6 ms over a
sub-millisecond routing decision — request parsing, header machinery,
and per-request connection bookkeeping dominating the data plane
(ROADMAP #7c). This module is the displacement: a raw-asyncio
newline-JSON protocol over long-lived TCP connections, one line per
pick, ids echoed so clients can pipeline::

    -> {"id": 1, "token_ids": [...], "request_id": "r1"}\n
    <- {"id": 1, "status": 200, "worker_id": ..., "endpoint": "h:p",
        "overlap_blocks": N}\n

Request bodies take the SAME fields as ``POST /pick`` (token_ids or
model+prompt); responses carry the /pick payload plus ``status`` (the
HTTP status the /pick route would have answered). The server is a
thin shell over ``EndpointPicker.pick_decision`` — one decision path,
two transports — and responses on a connection are written in request
order (pipelining overlaps the network RTT, not the decision).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import time
from typing import Any

log = logging.getLogger("dynamo_tpu_torch.gateway.pickline")

_MAX_LINE = 4 * 1024 * 1024  # generous: 128k-token prompts fit


class PickLineServer:
    """Serve pick decisions over newline-JSON on a persistent socket."""

    def __init__(self, picker, host: str = "127.0.0.1", port: int = 0):
        self.picker = picker
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        # live peer writers: close() must actively close them — on
        # py3.12.1+ Server.wait_closed() waits for every connection
        # handler, and pickline connections are long-lived BY DESIGN,
        # so a close() that only stops the listener would hang shutdown
        # until clients disconnect (the repo-wide Server.wait_closed
        # gotcha)
        self._conns: set[asyncio.StreamWriter] = set()

    async def start(self) -> "PickLineServer":
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port, limit=_MAX_LINE
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("pickline listening on %s:%d", self.host, self.port)
        return self

    async def _serve_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conns.add(writer)
        try:
            while True:
                try:
                    line = await reader.readline()
                except (ValueError, ConnectionError, OSError):
                    break  # oversized line or dead peer: drop the conn
                if not line:
                    break
                resp = await self._handle_line(line)
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        except (ConnectionError, OSError):
            pass  # peer vanished mid-write: nothing to answer
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _handle_line(self, line: bytes) -> dict[str, Any]:
        try:
            body = json.loads(line)
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            # malformed input answers in-band (the connection survives:
            # one bad line must not kill a pipelined neighbor's pick)
            return {"id": None, "status": 400, "error": f"bad line: {e}"}
        t0 = time.monotonic()
        try:
            status, payload, _hdrs = await self.picker.pick_decision(body)
        # answered in-band as a 500 (like the HTTP route's
        # per-request error handling): an unexpected decision failure
        # must not tear down the connection and fail every pipelined
        # neighbor's pick
        except Exception as e:  # noqa: BLE001
            log.warning("pickline decision failed: %s", e, exc_info=True)
            status, payload = 500, {"error": f"pick failed: {e}"}
        self.picker.observe_pick(time.monotonic() - t0)
        return {"id": body.get("id"), "status": status, **payload}

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._conns):
                w.close()  # wait_closed would block on live peers
            await self._server.wait_closed()


class PickLineClient:
    """Persistent pipelined pick client (one connection, in-order
    responses matched back to callers by request order)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._ids = itertools.count(1)
        self._pending: "asyncio.Queue[asyncio.Future]" = asyncio.Queue()
        self._rx_task: asyncio.Task | None = None
        self._wlock = asyncio.Lock()
        # set the moment the rx loop exits (EOF, error, or cancel): a
        # pick() enqueued after that point would have nothing left to
        # resolve or fail its future — it must raise instead of hanging
        self._closed = False

    async def connect(self) -> "PickLineClient":
        from dynamo_tpu_torch.runtime.context import spawn

        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=_MAX_LINE
        )
        self._rx_task = spawn(self._rx_loop(), name="pickline-rx")
        return self

    async def _rx_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                fut = await self._pending.get()
                if not fut.done():
                    try:
                        fut.set_result(json.loads(line))
                    except ValueError as e:
                        fut.set_exception(
                            ConnectionError(f"bad pickline frame: {e}")
                        )
        except (ConnectionError, OSError) as e:
            log.warning("pickline rx loop died: %s", e)
        finally:
            # connection gone OR task cancelled (close()): fail whatever
            # is still waiting — a drain outside finally would be
            # skipped on cancellation and strand concurrent pick()ers.
            # _closed flips FIRST so a pick() racing this drain can
            # never enqueue a future nothing will ever resolve.
            self._closed = True
            while not self._pending.empty():
                fut = self._pending.get_nowait()
                if not fut.done():
                    fut.set_exception(ConnectionError("pickline closed"))

    async def pick(self, body: dict[str, Any]) -> dict[str, Any]:
        """One pick round-trip; concurrent callers pipeline on the one
        connection (responses are in request order by protocol)."""
        if self._writer is None:
            raise ConnectionError("pickline client not connected")
        if self._closed:
            # server hung up: the rx loop already drained its pending
            # queue; enqueueing now would block this caller forever
            raise ConnectionError("pickline connection lost")
        body = dict(body)
        body.setdefault("id", next(self._ids))
        # serialize BEFORE enqueueing the future: a dumps failure after
        # the put would leave an orphan future eating the next response
        # and desync every later pick on the connection
        frame = json.dumps(body).encode() + b"\n"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # dynalint: disable=DL009 -- write serialization point: the
        # (enqueue future, write frame) pair must be atomic per request
        # or a neighbor's interleaved write would desync the in-order
        # response matching; the guarded await is a socket drain, never
        # a wire-tainted call that could re-enter this lock
        async with self._wlock:
            if self._closed:  # rx loop died while we awaited the lock
                raise ConnectionError("pickline connection lost")
            await self._pending.put(fut)
            self._writer.write(frame)
            await self._writer.drain()
        return await fut

    async def close(self) -> None:
        if self._rx_task is not None:
            self._rx_task.cancel()
        if self._writer is not None:
            self._writer.close()
