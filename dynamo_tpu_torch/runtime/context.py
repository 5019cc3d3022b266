"""Per-request context: identity, cancellation, deadline.

The surface of dynamo_tpu/runtime/context.py that the engine reads: a handle
that travels with a request, letting the caller stop or kill it and carrying
an optional absolute deadline.
"""

from __future__ import annotations

import threading
import time
import uuid


class DeadlineExceeded(RuntimeError):
    """The request's end-to-end deadline passed before admission."""


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

    def stop_generating(self) -> None:
        """Graceful cancel: finish the current step, emit no more tokens."""
        self._stopped.set()

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

    def remaining_s(self) -> float | None:
        """Seconds until the deadline (clamped at 0), or None if unbounded."""
        if self.deadline is None:
            return None
        return max(self.deadline - time.monotonic(), 0.0)

    @property
    def deadline_expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    def __repr__(self) -> str:  # pragma: no cover
        state = "killed" if self.is_killed else "stopped" if self.is_stopped else "live"
        return f"Context({self.id[:8]}, {state})"
