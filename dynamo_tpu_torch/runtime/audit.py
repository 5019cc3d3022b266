"""Request/response audit bus (the counterpart of
dynamo_tpu/runtime/audit.py).

Every completed request on the serving surface can emit one audit
record — who asked for what, what came back, how long it took — to
pluggable sinks. Records are emitted AFTER the response finishes (audit
must never sit on the request path); a slow sink drops records rather
than applying backpressure.

Sinks: JSONL file (greppable, the recorder's format family) and hub
subject (retained, so an auditor can attach late). ``DYN_AUDIT_PATH``
env enables the file sink process-wide.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any

log = logging.getLogger("dynamo_tpu_torch.audit")

AUDIT_SUBJECT = "audit/{namespace}/requests"


class AuditRecord(dict):
    """One request's audit entry (a dict; keys stay wire-stable)."""

    @classmethod
    def make(
        cls,
        *,
        route: str,
        model: str | None,
        request_id: str,
        request: dict[str, Any],
        status: int,
        finish_reason: str | None = None,
        output_tokens: int = 0,
        duration_ms: float = 0.0,
        error: str | None = None,
    ) -> "AuditRecord":
        rec = cls(
            ts=time.time(),
            route=route,
            model=model,
            request_id=request_id,
            status=status,
            finish_reason=finish_reason,
            output_tokens=output_tokens,
            duration_ms=round(duration_ms, 3),
            # request essentials only: prompts can be huge and sensitive;
            # sinks get sizes + sampling knobs, not content
            request={
                "messages_count": len(request.get("messages") or []),
                "prompt_chars": len(str(request.get("prompt") or "")),
                "max_tokens": request.get("max_tokens"),
                "temperature": request.get("temperature"),
                "stream": bool(request.get("stream")),
                "tools": len(request.get("tools") or []),
            },
        )
        if error:
            rec["error"] = error
        return rec


class JsonlSink:
    """File sink with a writer thread: emit() only enqueues, so a slow
    or network-mounted disk never stalls the serving event loop (the
    module contract). A full queue drops records."""

    def __init__(self, path: str, *, max_queue: int = 1024):
        import queue as _queue
        import threading

        self._f = open(path, "a")
        # records dropped because the queue was full (observable: silent
        # audit loss under backpressure is itself an audit failure)
        self.dropped = 0
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max_queue)
        self._stop = object()
        self._thread = threading.Thread(
            target=self._run, name="audit-jsonl", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            rec = self._q.get()
            if rec is self._stop:
                self._f.close()
                return
            try:
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()
            except Exception:  # noqa: BLE001
                log.warning("audit jsonl write failed", exc_info=True)

    def emit(self, rec: AuditRecord) -> None:
        try:
            self._q.put_nowait(rec)
        # drop-don't-block is the module contract; the drop is counted
        except Exception:  # noqa: BLE001
            self.dropped += 1  # full queue: drop, never block serving

    def flush(self, timeout: float = 5.0) -> None:
        """Blocking drain for tests and process shutdown ONLY — the
        serving path never calls it (emit() is enqueue-and-return)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while not self._q.empty() and _time.monotonic() < deadline:
            _time.sleep(0.01)

    def close(self) -> None:
        self._q.put(self._stop)
        self._thread.join(timeout=5)


class HubSink:
    """Publish to a retained hub subject (fire-and-forget)."""

    def __init__(self, hub, namespace: str = "dynamo"):
        self.hub = hub
        self.subject = AUDIT_SUBJECT.format(namespace=namespace)
        # the loop holds only weak task refs: keep publishes alive
        self._tasks: set = set()

    def emit(self, rec: AuditRecord) -> None:
        task = asyncio.ensure_future(self.hub.publish(self.subject, dict(rec)))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def close(self) -> None:
        pass


class AuditBus:
    def __init__(self) -> None:
        self.sinks: list = []
        self.emitted = 0
        path = (os.environ.get("DYN_AUDIT_PATH") or "").strip()
        if path:
            self.sinks.append(JsonlSink(path))

    @property
    def enabled(self) -> bool:
        return bool(self.sinks)

    def add_sink(self, sink) -> "AuditBus":
        self.sinks.append(sink)
        return self

    def emit(self, rec: AuditRecord) -> None:
        for sink in self.sinks:
            try:
                sink.emit(rec)
            except Exception:  # noqa: BLE001
                log.warning("audit sink failed (record dropped)",
                            exc_info=True)
        self.emitted += 1

    def close(self) -> None:
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:  # noqa: BLE001
                # shutdown fan-out: one sink's close failure must not stop
                # the others from closing
                log.warning("audit sink close failed", exc_info=True)
