"""Per-request context: identity, cancellation, deadline, error types.

The counterpart of dynamo_tpu/runtime/context.py: a handle that travels with
a request through every operator, letting any stage observe or trigger
cancellation, plus the typed errors the serving path maps to HTTP statuses.

One difference: the engine's step THREAD reads the stop flags while the
event loop sets them, so the flags are ``threading.Event``s and the stop
callbacks run on whichever thread stops the context. ``stopped()`` bridges
back to the waiting coroutine's loop with ``call_soon_threadsafe``.
"""

from __future__ import annotations

import asyncio
import logging
import math
import threading
import time
import uuid
from typing import Any, Coroutine

from dynamo_tpu_torch.runtime import tracing

_task_log = logging.getLogger("dynamo_tpu_torch.tasks")

# Strong references for fire-and-forget tasks: the event loop holds tasks
# only weakly, so a task whose result is dropped can be collected mid-flight.
_BACKGROUND_TASKS: set[asyncio.Task] = set()


def spawn(coro: Coroutine, *, name: str | None = None) -> asyncio.Task:
    """create_task with a strong reference until the task finishes and a
    done-callback that logs unexpected exceptions instead of losing them.
    Returns the task so callers can still cancel/await it."""
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _BACKGROUND_TASKS.add(task)

    def _done(t: asyncio.Task) -> None:
        _BACKGROUND_TASKS.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            _task_log.error(
                "background task %s crashed: %s: %s",
                t.get_name(), type(exc).__name__, exc,
                exc_info=exc,
            )

    task.add_done_callback(_done)
    return task


class StreamError(RuntimeError):
    """A response stream died mid-flight (worker crash / connection loss).

    The migration operator (frontend/migration.py) catches this to re-drive
    the request on another instance."""


class ServiceUnavailable(StreamError):
    """A worker refused the request because it is draining or saturated.

    Retryable (a StreamError, so migration re-drives it with backoff); when
    retries run out the HTTP frontend answers 503 with ``Retry-After``."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """The request's end-to-end deadline passed. NOT a StreamError: retrying
    a request whose client has given up is what deadlines exist to prevent.
    HTTP maps it to 504."""


class OverQuota(RuntimeError):
    """The tenant's token bucket cannot cover this request. NOT a
    StreamError: the client must back off. HTTP maps it to 429 with
    ``Retry-After``."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


# Remaining request budget in milliseconds, attached to the wire headers at
# send time (relative, so no cross-host clock sync) and rebuilt into an
# absolute monotonic deadline on the receiving side.
DEADLINE_HEADER = "x-dyn-deadline-ms"

# Tenancy baggage: stamped into Context.headers at the serving edge
# (frontend/validation.py validate_tenancy) and carried to the worker.
TENANT_HEADER = "x-dyn-tenant"
PRIORITY_HEADER = "x-dyn-priority"


def tenancy_from_headers(
    headers: dict[str, str] | None,
) -> tuple[str, str]:
    """(tenant, priority) from wire headers, defaulted for untagged traffic:
    tenant "default", priority "interactive"."""
    h = headers or {}
    tenant = (h.get(TENANT_HEADER) or "default").strip() or "default"
    priority = (h.get(PRIORITY_HEADER) or "interactive").strip().lower()
    if priority not in ("interactive", "batch"):
        priority = "interactive"
    return tenant, priority


def tighten_timeout_s(default_s: float, raw_ms: Any) -> float:
    """Tighten (never loosen) an end-to-end budget with a client-supplied
    relative timeout in milliseconds.

    Invalid or non-finite input leaves the default; with the default
    disabled (``<= 0``) the client value is the sole source; the floor is
    1 ms so a zero/negative request fails fast instead of disabling the
    deadline."""
    try:
        ms = float(raw_ms)
    except (TypeError, ValueError):
        return default_s
    if not math.isfinite(ms):
        return default_s
    s = max(ms / 1000.0, 0.001)
    return min(s, default_s) if default_s > 0 else s


def deadline_from_headers(headers: dict[str, str] | None) -> float | None:
    """Absolute monotonic deadline from a relative wire header, or None."""
    raw = (headers or {}).get(DEADLINE_HEADER)
    if not raw:
        return None
    try:
        return time.monotonic() + max(float(raw), 0.0) / 1000.0
    except ValueError:
        return None


class Context:
    """Cancellation + identity context for one in-flight request."""

    def __init__(
        self,
        request_id: str | None = None,
        headers: dict[str, str] | None = None,
        deadline: float | None = None,
    ):
        self.id: str = request_id or uuid.uuid4().hex
        self.headers: dict[str, str] = headers or {}
        # absolute time.monotonic() deadline; None = unbounded
        self.deadline: float | None = deadline
        # read by the engine's step thread, set from any thread
        self._stopped = threading.Event()
        self._killed = threading.Event()
        self._lock = threading.Lock()
        self._children: list[Context] = []
        # sync callbacks fired once on the stopped edge, on the stopping
        # thread
        self._stop_cbs: list = []

    # -- cancellation ------------------------------------------------------

    def stop_generating(self) -> None:
        """Graceful cancel: finish the current step, emit no more tokens."""
        with self._lock:
            first = not self._stopped.is_set()
            self._stopped.set()
            cbs, self._stop_cbs = (self._stop_cbs, []) if first else ([], self._stop_cbs)
            children = list(self._children)
        for cb in cbs:
            cb()
        for c in children:
            c.stop_generating()

    def add_stop_callback(self, cb) -> None:
        """Register a sync callback for the stopped edge (runs at once if
        already stopped). Pair with ``remove_stop_callback``."""
        with self._lock:
            if not self._stopped.is_set():
                self._stop_cbs.append(cb)
                return
        cb()

    def remove_stop_callback(self, cb) -> None:
        with self._lock:
            try:
                self._stop_cbs.remove(cb)
            except ValueError:
                pass

    def kill(self) -> None:
        """Hard cancel: abandon the request immediately."""
        self._killed.set()
        self.stop_generating()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    @property
    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def stopped(self) -> None:
        """Wait for the stopped edge, whichever thread stops the context."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def _wake() -> None:
            if not fut.done():
                fut.set_result(None)

        def _cb() -> None:
            try:
                loop.call_soon_threadsafe(_wake)
            except RuntimeError:  # the loop closed first
                pass

        self.add_stop_callback(_cb)
        try:
            await fut
        finally:
            self.remove_stop_callback(_cb)

    async def killed_or_stopped(self) -> None:
        await self.stopped()

    # -- deadlines ---------------------------------------------------------

    def remaining_s(self) -> float | None:
        """Seconds until the deadline (clamped at 0), or None if unbounded."""
        if self.deadline is None:
            return None
        return max(self.deadline - time.monotonic(), 0.0)

    @property
    def deadline_expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    def wire_headers(self) -> dict[str, str]:
        """Headers to send with this request: baggage plus the remaining
        deadline budget in ms (the receiver rebuilds an absolute deadline
        via deadline_from_headers), plus the LIVE trace context: the
        sender's current span as ``traceparent``, not the one stashed at
        admission, so the receiver binds the actual calling span as its
        remote parent (runtime/tracing.py)."""
        cur = tracing.current_trace()
        remaining = self.remaining_s()
        if remaining is None and cur is None:
            return self.headers
        headers = dict(self.headers)
        if cur is not None:
            headers[tracing.TRACEPARENT] = cur.to_traceparent()
        if remaining is not None:
            headers[DEADLINE_HEADER] = str(int(remaining * 1000))
        return headers

    def child(self, request_id: str | None = None) -> "Context":
        """Derived context: cancelling the parent cancels the child."""
        c = Context(request_id or self.id, dict(self.headers), deadline=self.deadline)
        if self.is_killed:
            c.kill()
        with self._lock:
            self._children.append(c)
            stopped = self._stopped.is_set()
        if stopped:
            c.stop_generating()
        return c

    def link_task(self, task: asyncio.Task) -> None:
        """Cancel ``task`` when this context is stopped."""

        async def _watch() -> None:
            await self.stopped()
            if not task.done():
                task.cancel()

        watcher = spawn(_watch(), name=f"link-{self.id[:8]}")
        task.add_done_callback(lambda _t: watcher.cancel())

    def __repr__(self) -> str:  # pragma: no cover
        state = "killed" if self.is_killed else "stopped" if self.is_stopped else "live"
        return f"Context({self.id[:8]}, {state})"


def ensure_context(ctx: Context | None) -> Context:
    return ctx if ctx is not None else Context()


def annotation(event: str, data: Any = None) -> dict[str, Any]:
    """Out-of-band event envelope entry."""
    return {"event": event, "data": data}
