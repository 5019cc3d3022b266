"""Request/response data plane: direct TCP streaming to workers (the
counterpart of dynamo_tpu/runtime/transport.py).

Each worker process runs a single ``EndpointServer``; all of its endpoints
share it, demultiplexed by endpoint path. Multiple in-flight requests are
multiplexed per connection by a per-connection integer channel id
established by the ``open`` handshake (headers and the uuid request id
cross the wire once, at open; every later frame carries the small ``ch``).

Frames (framing.py, msgpack bytes through the port's ``codec``):
  client -> worker: {"kind": "open", "ch": n, "req": id, "path": str,
                     "payload": ..., "headers": {}}
                    {"kind": "cancel", "ch": n}
  worker -> client: {"kind": "data", "ch": n, "payload": ...}
                    {"kind": "data", "ch": n, "payloads": [...]}  (coalesced)
                    {"kind": "end", "ch": n}
                    {"kind": "err", "ch": n, "error": str}
  legacy client -> worker: {"kind": "req", "req": id, ...} — served with
                    ``req``-stamped uncoalesced replies for pre-``open``
                    peers.

The send path is corked (framing.FrameWriter): frames buffer in user space
and hit the socket once per event-loop tick, draining only on transport
backpressure; adjacent items of one stream coalesce into a single
``payloads`` frame (DYN_STREAM_COALESCE, default on).

In-process instances short-circuit the wire entirely (LocalRegistry), which
the one-process stack uses.

Tracing: a served request binds the caller's ``traceparent`` from its open
frame's headers (runtime/tracing.py ``bind_trace``), so the handler's spans
nest beneath the caller's ``transport.call``. Fault sites
(runtime/faults.py): ``transport.connect`` at dial, ``transport.send`` at
the open frame, ``transport.recv`` per received frame (a drop or an error
there cuts the connection, as a real death does).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import uuid
from typing import Any, AsyncIterator, Awaitable, Callable

from dynamo_tpu_torch.runtime import framing, tracing
from dynamo_tpu_torch.runtime.context import (
    Context,
    DeadlineExceeded,
    OverQuota,
    ServiceUnavailable,
    StreamError,
    deadline_from_headers,
    spawn,
)
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

log = logging.getLogger("dynamo_tpu_torch.transport")

Handler = Callable[[Any, Context], AsyncIterator[Any]]


# ------------------------------------------------------------------ knobs

def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw is None else int(raw)


# ---------------------------------------------------------------- metrics

_METRICS = MetricsRegistry()
_FRAMES_TOTAL = _METRICS.counter(
    "transport_frames_total",
    "Data-plane frames sent, by frame kind (a coalesced data frame "
    "counts once however many payloads it carries).",
    ["kind"],
)
_FLUSH_BYTES = _METRICS.histogram(
    "transport_flush_bytes",
    "Bytes handed to the transport per corked flush.",
    buckets=(64, 256, 1024, 4096, 16384, 65536, 262144, 1048576),
)
register_registry("transport", _METRICS)

# Plain-int mirror of the counters for the stream bench / tier-1
# micro-guard: resettable and free of prometheus overhead to read.
# ``flushes``/``drains``/``bytes_out`` are fed by framing.FrameWriter.
STREAM_STATS: dict[str, int] = {}


def reset_stream_stats() -> None:
    for k in (
        "frames", "flushes", "drains", "bytes_out", "data_frames",
        "data_items",
    ):
        STREAM_STATS[k] = 0


def stream_stats() -> dict[str, int]:
    return dict(STREAM_STATS)


reset_stream_stats()

# pre-bound label children: .labels() does a dict lookup + lock per call,
# too hot for the per-frame path
_FRAME_KINDS = ("open", "req", "cancel", "data", "end", "err")
_FRAME_COUNTERS = {k: _FRAMES_TOTAL.labels(k) for k in _FRAME_KINDS}


def _note_frame(kind: str) -> None:
    STREAM_STATS["frames"] += 1
    if kind == "data":
        STREAM_STATS["data_frames"] += 1
    _FRAME_COUNTERS[kind].inc()


def _note_flush(nbytes: int) -> None:
    _FLUSH_BYTES.observe(nbytes)


def _frame_writer(writer: asyncio.StreamWriter, cork: bool) -> framing.FrameWriter:
    return framing.FrameWriter(
        writer, cork=cork, stats=STREAM_STATS, on_flush=_note_flush
    )


class LocalRegistry:
    """Process-local instance registry for zero-copy in-proc dispatch."""

    def __init__(self) -> None:
        self._handlers: dict[str, Handler] = {}

    def register(self, path: str, handler: Handler) -> None:
        self._handlers[path] = handler

    def unregister(self, path: str) -> None:
        self._handlers.pop(path, None)

    def get(self, path: str) -> Handler | None:
        return self._handlers.get(path)


def _rough_size(item: Any) -> int:
    """Cheap payload-size estimate for the coalescer's byte cap.

    Not a serialization: just large-blob detection, so a stream of fat
    payloads commits per-frame instead of accumulating max_batch of them
    into one giant frame (which would defeat frame-granular rx bounding
    on the receiver and add head-of-line latency).
    """
    if isinstance(item, (str, bytes, bytearray)):
        return len(item)
    if isinstance(item, dict):
        # one level deep, blobs only — token-delta dicts are small and
        # a full recursive walk per item taxes every send; a fat blob
        # (the thing the cap exists for) lives in a top-level value
        return 16 + sum(
            len(v) for v in item.values()
            if isinstance(v, (str, bytes, bytearray))
        )
    if isinstance(item, (list, tuple)):
        return 8 + 8 * len(item)
    return 8


class _StreamSender:
    """Send half of one response stream.

    With coalescing on, adjacent items buffer and ship as a single
    ``{"kind": "data", "payloads": [...]}`` frame at end-of-tick, at the
    batch cap, or at the byte cap — a decode burst that yields N tokens
    between two event-loop ticks costs one frame, not N. Item order and
    error placement are exact: ``end``/``err`` always commit pending
    items first, into the same corked buffer, so the peer observes the
    identical stream the uncoalesced path would produce.
    """

    __slots__ = ("fw", "reply", "coalesce", "max_batch", "max_bytes",
                 "_pending", "_pending_sz", "_tick_scheduled", "_failed")

    def __init__(
        self,
        fw: framing.FrameWriter,
        reply: dict[str, Any],
        *,
        coalesce: bool,
        max_batch: int,
        max_bytes: int = 64 * 1024,
    ) -> None:
        self.fw = fw
        self.reply = reply
        self.coalesce = coalesce
        self.max_batch = max_batch
        self.max_bytes = max_bytes
        self._pending: list[Any] = []
        self._pending_sz = 0
        self._tick_scheduled = False
        self._failed = False  # an item the codec refused ended the stream

    async def data(self, item: Any) -> None:
        if self._failed:
            raise RuntimeError("stream ended: an earlier item was unserializable")
        STREAM_STATS["data_items"] += 1
        if not self.coalesce:
            frame = {"kind": "data", "payload": item}
            frame.update(self.reply)
            _note_frame("data")
            await self.fw.send(frame)
            return
        self._pending.append(item)
        self._pending_sz += _rough_size(item)
        if len(self._pending) >= self.max_batch or self._pending_sz >= self.max_bytes:
            self._commit()
            await self.fw.pump()
            return
        if not self._tick_scheduled:
            self._tick_scheduled = True
            asyncio.get_running_loop().call_soon(self._tick)
        # backpressure check rides every item: a stalled peer blocks the
        # handler here instead of ballooning the transport buffer
        await self.fw.pump()

    def _tick(self) -> None:
        self._tick_scheduled = False
        self._commit()

    def _commit(self) -> None:
        pending = self._pending
        if not pending:
            return
        self._pending_sz = 0
        if len(pending) == 1:
            frame = {"kind": "data", "payload": pending[0]}
        else:
            frame = {"kind": "data", "payloads": list(pending)}
        frame.update(self.reply)
        pending.clear()
        try:
            self.fw.feed(frame)
        except (TypeError, ValueError, OverflowError) as e:
            # the codec refused an item (a tensor or numpy scalar in a
            # payload): a bug upstream. End the stream with an error here,
            # often inside a loop callback, so the peer is not left waiting
            log.error("unserializable stream item: %s", e)
            self._failed = True
            err = {"kind": "err", "error": f"unserializable stream item: {e}"}
            err.update(self.reply)
            _note_frame("err")
            self.fw.feed(err)
            return
        _note_frame("data")

    async def end(self) -> None:
        self._commit()
        if self._failed:
            return
        frame = {"kind": "end"}
        frame.update(self.reply)
        _note_frame("end")
        await self.fw.send(frame)

    async def err(self, frame: dict[str, Any]) -> None:
        # pending items ship first: the peer sees every item the handler
        # yielded before the failure, then the error — same placement as
        # the uncoalesced path
        self._commit()
        if self._failed:
            return
        frame.update(self.reply)
        _note_frame("err")
        try:
            await self.fw.send(frame)
        except (ConnectionError, RuntimeError):
            pass


class EndpointServer:
    """Worker-side TCP listener serving all endpoints of one process."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        uds_path: str | None = None,
        coalesce: bool | None = None,
        cork: bool | None = None,
    ):
        self.host = host
        self.port = port
        self.uds_path = uds_path
        self.coalesce = (
            _env_flag("DYN_STREAM_COALESCE", True)
            if coalesce is None else coalesce
        )
        self.cork = _env_flag("DYN_STREAM_CORK", True) if cork is None else cork
        self.coalesce_max = _env_int("DYN_STREAM_COALESCE_MAX", 64)
        self._handlers: dict[str, Handler] = {}
        self._server: asyncio.AbstractServer | None = None
        self._uds_server: asyncio.AbstractServer | None = None
        self._inflight: set[asyncio.Task] = set()
        self._conns: set[asyncio.StreamWriter] = set()
        self.draining = False
        self.drain_retry_after_s = 1.0  # hint sent with draining refusals
        self.aborted_inflight = 0  # streams force-cancelled at drain timeout

    def register(self, path: str, handler: Handler) -> None:
        self._handlers[path] = handler

    def unregister(self, path: str) -> None:
        self._handlers.pop(path, None)

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.host, self.port = self._server.sockets[0].getsockname()[:2]
        if self.uds_path:
            # co-located hop fast path; falls back to TCP-only cleanly
            try:
                self._uds_server = await asyncio.start_unix_server(
                    self._handle, self.uds_path
                )
            except (OSError, NotImplementedError, AttributeError) as e:
                log.warning("UDS listener unavailable (%s): %s", self.uds_path, e)
                self.uds_path = None
        return self.host, self.port

    async def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting; optionally wait for in-flight requests to finish.

        Streams that outlive the drain timeout are FORCE-cancelled (and
        counted in ``aborted_inflight``): a wedged handler must not turn a
        graceful drain into an unbounded hang — its client sees a stream
        death and re-drives via migration."""
        self.draining = True
        if self._server is not None:
            self._server.close()
        if self._uds_server is not None:
            self._uds_server.close()
        if drain and self._inflight:
            _done, pending = await asyncio.wait(self._inflight, timeout=timeout)
            if pending:
                self.aborted_inflight += len(pending)
                log.warning(
                    "drain timeout (%.1fs): force-cancelling %d in-flight "
                    "stream(s)", timeout, len(pending),
                )
        leftover = list(self._inflight)
        for t in leftover:
            t.cancel()
        if leftover:
            # give cancellation a moment to actually unwind the handlers
            await asyncio.wait(leftover, timeout=5)
        # Actively close peer connections: from 3.12 Server.wait_closed()
        # blocks until every client connection is gone.
        for w in list(self._conns):
            w.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5)
            except asyncio.TimeoutError:  # pragma: no cover
                pass
        if self.uds_path:
            with contextlib.suppress(OSError):
                os.unlink(self.uds_path)

    @property
    def num_inflight(self) -> int:
        return len(self._inflight)

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        fw = _frame_writer(writer, self.cork)
        # streams keyed by int channel id ("open") or uuid req id (legacy
        # "req"); the two cannot collide (int vs str)
        contexts: dict[Any, Context] = {}
        self._conns.add(writer)

        try:
            # chunked rx: one socket read drains every frame the peer's
            # corked writer packed into the segment (framing.FrameFeeder)
            feeder = framing.FrameFeeder()
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                for msg, _nbytes in feeder.feed(chunk):
                    if not isinstance(msg, dict):
                        raise ValueError(
                            f"bad frame type {type(msg).__name__}"
                        )
                    self._handle_frame(msg, fw, contexts)
        except (ConnectionResetError, BrokenPipeError):
            pass
        except (ValueError, TypeError, KeyError) as e:
            # torn length header, oversize frame, garbage bytes, or a
            # malformed envelope: length-prefixed framing cannot resync
            # mid-stream, so drop THIS connection — the accept loop stays
            # up and well-formed peers are unaffected
            log.warning("dropping connection with bad framing: %r", e)
        finally:
            # peer gone: cancel everything it had in flight here
            for ctx in contexts.values():
                ctx.kill()
            self._conns.discard(writer)
            writer.close()

    def _handle_frame(
        self,
        msg: dict[str, Any],
        fw: framing.FrameWriter,
        contexts: dict[Any, Context],
    ) -> None:
        kind = msg.get("kind")
        if kind == "open" or kind == "req":
            key = msg["ch"] if kind == "open" else msg["req"]
            # Register the context BEFORE scheduling the handler task:
            # a cancel frame in the same read buffer must find it.
            headers = msg.get("headers") or {}
            ctx = Context(
                request_id=msg["req"], headers=headers,
                deadline=deadline_from_headers(headers),
            )
            # join the caller's W3C trace: the handler task created below
            # copies this binding
            tracing.bind_trace(ctx.headers)
            contexts[key] = ctx
            task = asyncio.ensure_future(
                self._serve_request(msg, ctx, fw, contexts, key)
            )
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
        elif kind == "cancel":
            key = msg["ch"] if "ch" in msg else msg.get("req")
            ctx = contexts.get(key)
            if ctx is not None:
                ctx.stop_generating()

    async def _serve_request(
        self,
        msg: dict[str, Any],
        ctx: Context,
        fw: framing.FrameWriter,
        contexts: dict[Any, Context],
        key: Any,
    ) -> None:
        path = msg.get("path", "")
        # legacy "req" peers get req-stamped, uncoalesced replies (they
        # predate the payloads fan-out)
        legacy = msg.get("kind") == "req"
        reply: dict[str, Any] = {"req": key} if legacy else {"ch": key}
        handler = self._handlers.get(path)
        if handler is None or self.draining:
            contexts.pop(key, None)
            # draining carries a machine-readable code + Retry-After hint:
            # the client raises ServiceUnavailable, migration re-drives on
            # a live worker, and the frontend maps exhaustion to HTTP 503
            err: dict[str, Any] = {"kind": "err"}
            err.update(reply)
            if self.draining:
                err.update(error="draining", code="unavailable",
                           retry_after=self.drain_retry_after_s)
            else:
                err.update(error=f"no handler for {path!r}")
            _note_frame("err")
            try:
                await fw.send(err)
            except (ConnectionError, RuntimeError):
                pass
            return
        out = _StreamSender(
            fw, reply,
            coalesce=self.coalesce and not legacy,
            max_batch=self.coalesce_max,
        )
        try:
            async for item in handler(msg.get("payload"), ctx):
                if ctx.is_killed:
                    break
                await out.data(item)
            if not ctx.is_killed:
                await out.end()
        except (ConnectionResetError, BrokenPipeError):
            ctx.kill()
        except asyncio.CancelledError:
            ctx.kill()
            raise
        except ServiceUnavailable as e:
            # typed refusal (draining/saturated handler): ship the code so
            # the client side re-raises ServiceUnavailable, not a generic
            # RuntimeError — that's what makes it retryable + 503-mappable
            await out.err({"kind": "err", "error": str(e),
                           "code": "unavailable",
                           "retry_after": e.retry_after_s})
        except OverQuota as e:
            # tenant quota refusal: typed so the client side re-raises
            # OverQuota (NOT retryable — migration must not burn the
            # tenant's bucket on every other worker too) and the
            # frontend maps it to 429 + Retry-After
            await out.err({"kind": "err", "error": str(e),
                           "code": "over_quota",
                           "retry_after": e.retry_after_s})
        except DeadlineExceeded as e:
            await out.err({"kind": "err", "error": str(e),
                           "code": "deadline"})
        except StreamError as e:
            # worker-death-shaped failure raised IN the handler (e.g. a
            # backend losing its engine mid-stream): keep the retryable
            # typing across the wire so the migration operator re-drives
            # it — locally-dispatched handlers already propagate
            # StreamError natively, and the TCP plane must match
            await out.err({"kind": "err", "error": str(e),
                           "code": "stream"})
        except Exception as e:  # noqa: BLE001 - report handler errors to the peer
            log.exception("handler error on %s", path)
            await out.err({"kind": "err", "error": repr(e)})
        finally:
            contexts.pop(key, None)


class _BoundedRx:
    """Per-request rx queue with a byte/item high-water mark.

    The bound is enforced by the channel's rx loop, not the queue: when a
    consumer falls behind, the rx loop parks on ``wait_resume()`` and
    stops reading the socket, so kernel-side TCP backpressure propagates
    to the worker and caps memory on BOTH sides — the old unbounded
    ``asyncio.Queue`` let one stalled SSE consumer balloon the process.
    Death sentinels bypass the bound (they must always be deliverable).
    """

    __slots__ = ("_q", "_bytes", "max_items", "max_bytes", "_resume",
                 "_released")

    def __init__(self, max_items: int, max_bytes: int) -> None:
        self._q: asyncio.Queue = asyncio.Queue()
        self._bytes = 0
        self.max_items = max_items
        self.max_bytes = max_bytes
        self._resume = asyncio.Event()
        self._resume.set()
        self._released = False

    @property
    def saturated(self) -> bool:
        return not self._released and (
            self._q.qsize() >= self.max_items or self._bytes >= self.max_bytes
        )

    def put(self, msg: dict[str, Any], nbytes: int) -> None:
        self._q.put_nowait((msg, nbytes))
        self._bytes += nbytes
        if self.saturated:
            self._resume.clear()

    def put_sentinel(self) -> None:
        self._q.put_nowait((None, 0))
        self._resume.set()

    async def get(self) -> dict[str, Any] | None:
        msg, nbytes = await self._q.get()
        self._bytes -= nbytes
        if not self.saturated:
            self._resume.set()
        return msg

    async def wait_resume(self) -> None:
        await self._resume.wait()

    def release(self) -> None:
        """Consumer is gone: never park the rx loop on this queue again."""
        self._released = True
        self._resume.set()

    def terminal_pending(self) -> bool:
        """True if the stream's terminal frame (end/err/death sentinel)
        is already queued — nothing more will arrive, so an abandoning
        consumer need not send a cancel for it."""
        queue = self._q._queue
        if not queue:
            return False
        msg, _ = queue[-1]
        return msg is None or msg["kind"] in ("end", "err")


class InstanceChannel:
    """Client-side multiplexed connection to one worker instance."""

    def __init__(self, host: str, port: int, uds: str = ""):
        self.host, self.port = host, port
        self.uds = uds
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._fw: framing.FrameWriter | None = None
        self._queues: dict[int, _BoundedRx] = {}
        self._next_ch = 0
        self._rx: asyncio.Task | None = None
        self._closed = False
        self.rx_max_items = _env_int("DYN_STREAM_RX_MAX_ITEMS", 1024)
        self.rx_max_bytes = _env_int("DYN_STREAM_RX_MAX_BYTES", 8 * 1024 * 1024)

    async def connect(self, timeout: float = 5.0) -> None:
        if FAULTS.enabled:
            await FAULTS.fire("transport.connect")  # drop/error: the dial fails
        if self.uds and os.path.exists(self.uds):
            # co-located worker advertised a unix socket; TCP remains the
            # fallback if it races the worker's shutdown/unlink
            try:
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_unix_connection(self.uds), timeout
                )
            except (OSError, NotImplementedError, asyncio.TimeoutError):
                self._reader = self._writer = None
        if self._writer is None:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), timeout
            )
        self._fw = _frame_writer(self._writer, _env_flag("DYN_STREAM_CORK", True))
        self._rx = asyncio.get_running_loop().create_task(self._rx_loop())

    @property
    def connected(self) -> bool:
        return self._writer is not None and not self._closed

    @property
    def busy(self) -> bool:
        """True while a call on this channel is streaming."""
        return bool(self._queues)

    async def _rx_loop(self) -> None:
        assert self._reader is not None
        try:
            # chunked rx (framing.FrameFeeder): one await per socket
            # read, all frames the peer's corked writer batched into the
            # segment handled synchronously
            feeder = framing.FrameFeeder()
            stop = False
            while not stop:
                chunk = await self._reader.read(65536)
                if not chunk:
                    break
                for msg, nbytes in feeder.feed(chunk):
                    if not isinstance(msg, dict):
                        stop = True
                        break
                    if FAULTS.enabled:
                        try:
                            await FAULTS.fire("transport.recv")
                        except (ConnectionError, RuntimeError):
                            # an injected drop or error dies exactly like a
                            # cut connection: close the socket so both
                            # sides see it; leaving the loop marks the
                            # channel closed and delivers the sentinels
                            if self._writer is not None:
                                self._writer.close()
                            stop = True
                            break
                    key = msg["ch"] if "ch" in msg else msg.get("req")
                    q = self._queues.get(key)
                    if q is None:
                        continue
                    q.put(msg, nbytes)
                    if q.saturated:
                        # stop reading the socket until the consumer
                        # catches up: TCP backpressure does the rest
                        # (satellite of the unbounded-queue fix; see
                        # _BoundedRx)
                        await q.wait_resume()
        finally:
            self._closed = True
            for q in self._queues.values():
                q.put_sentinel()  # stream death sentinel

    async def call(
        self, path: str, payload: Any, context: Context
    ) -> AsyncIterator[Any]:
        """Issue a request; yields response payloads; raises StreamError on
        mid-stream connection death (the migration trigger)."""
        if not self.connected:
            raise StreamError(f"not connected to {self.host}:{self.port}")
        if context.deadline_expired:
            raise DeadlineExceeded(
                f"deadline passed before dispatch of {context.id}"
            )
        req_id = context.id or uuid.uuid4().hex
        self._next_ch += 1
        ch_id = self._next_ch
        q = _BoundedRx(self.rx_max_items, self.rx_max_bytes)
        self._queues[ch_id] = q
        try:
            if FAULTS.enabled:
                await FAULTS.fire("transport.send")  # drop: StreamError
            # corked single-writer send path: feed() appends whole packed
            # frames, so concurrent opens/cancels on this channel cannot
            # interleave mid-frame (the old per-call write lock is gone)
            frame = {
                "kind": "open",
                "ch": ch_id,
                "req": req_id,
                "path": path,
                "payload": payload,
                # remaining deadline budget + the live trace
                # context ride the headers (context.wire_headers
                # stamps the sender's current span)
                "headers": context.wire_headers(),
            }
            _note_frame("open")
            await self._fw.send(frame)
        except (ConnectionError, RuntimeError) as e:
            self._queues.pop(ch_id, None)
            raise StreamError(f"send failed: {e}") from e

        # stop-edge callback instead of a watcher task parked on
        # context.stopped() per call — cancellation is rare, the
        # per-call task was not
        def _on_stop() -> None:
            spawn(self._send_cancel(ch_id), name="transport-cancel")

        context.add_stop_callback(_on_stop)
        finished = False
        try:
            while True:
                msg = await q.get()
                if msg is None:
                    finished = True
                    raise StreamError("response stream died (worker lost)")
                kind = msg["kind"]
                if kind == "data":
                    payloads = msg.get("payloads")
                    if payloads is None:
                        yield msg["payload"]
                    else:
                        # fan a coalesced frame back out, item by item
                        for p in payloads:
                            yield p
                elif kind == "end":
                    finished = True
                    return
                elif kind == "err":
                    finished = True
                    code = msg.get("code")
                    if code == "unavailable":
                        raise ServiceUnavailable(
                            msg.get("error", "worker unavailable"),
                            retry_after_s=float(msg.get("retry_after") or 1.0),
                        )
                    if code == "over_quota":
                        raise OverQuota(
                            msg.get("error", "tenant over quota"),
                            retry_after_s=float(msg.get("retry_after") or 1.0),
                        )
                    if code == "deadline":
                        raise DeadlineExceeded(
                            msg.get("error", "deadline exceeded")
                        )
                    if code == "stream":
                        # handler-raised StreamError: retryable (the
                        # migration operator re-drives it elsewhere)
                        raise StreamError(
                            msg.get("error", "worker stream failed")
                        )
                    raise RuntimeError(msg.get("error", "remote error"))
        finally:
            context.remove_stop_callback(_on_stop)
            self._queues.pop(ch_id, None)
            q.release()  # never park the rx loop on an abandoned stream
            if not finished and not q.terminal_pending():
                # Consumer abandoned the stream (break / exception upstream):
                # tell the worker to stop generating. Fire-and-forget - we may
                # be inside GeneratorExit where awaiting is restricted; spawn
                # keeps the strong reference so GC can't cancel the send.
                # (If the terminal frame is already queued there is nothing
                # left to cancel — common when a consumer stops at the
                # finish-reason item with the end frame one read behind.)
                spawn(self._send_cancel(ch_id), name="transport-cancel")

    async def _send_cancel(self, ch_id: int) -> None:
        if self.connected:
            try:
                frame = {"kind": "cancel", "ch": ch_id}
                _note_frame("cancel")
                await self._fw.send(frame)
            except (ConnectionError, RuntimeError):
                pass

    async def close(self) -> None:
        self._closed = True
        if self._rx is not None:
            self._rx.cancel()
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass


async def call_local(
    handler: Handler, payload: Any, context: Context
) -> AsyncIterator[Any]:
    """In-process dispatch path (no serialization)."""
    async for item in handler(payload, context):
        yield item
