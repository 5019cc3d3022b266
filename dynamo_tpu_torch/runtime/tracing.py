"""Distributed tracing: W3C traceparent propagation, JSONL spans and an
optional OTLP/HTTP exporter (the counterpart of
dynamo_tpu/runtime/tracing.py).

Every span is one structured JSONL log record carrying trace_id, span_id
and parent_span_id. With ``DYN_TRACE_FILE`` set (or ``set_trace_file``)
each record also appends to that file; with ``DYN_OTLP_ENDPOINT`` (or
``set_otlp_endpoint``) the same spans batch to ``{endpoint}/v1/traces`` as
OTLP/HTTP JSON, posted with ``urllib.request`` (no opentelemetry package:
the body is built by hand to the OTLP spec, key for key the reference's,
so any standard collector ingests it). The ``traceparent`` header follows
https://www.w3.org/TR/trace-context/ (version 00), lower-case hex only.

Propagation: the frontend binds the incoming trace (``bind_trace``) and
opens its ``http.request`` span; the transport client opens
``transport.call`` and ``Context.wire_headers`` stamps that span's
traceparent on the wire; the worker's transport binds it, and the engine
emits the request-lifecycle spans beneath it at finish (runtime/flight.py).
Span names are the catalogued ones (SPAN_NAMES in the reference's
tools/dynalint/catalog.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import json
import logging
import os
import queue
import secrets
import threading
import time
import urllib.request
from dataclasses import dataclass

log = logging.getLogger("dynamo_tpu_torch.trace")

TRACEPARENT = "traceparent"

_current: contextvars.ContextVar["TraceContext | None"] = contextvars.ContextVar(
    "dynamo_trace", default=None
)


@dataclass(frozen=True)
class TraceContext:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    sampled: bool = True

    def to_traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, new_span_id(), self.sampled)


def new_span_id() -> str:
    return secrets.token_hex(8)


def new_trace() -> TraceContext:
    return TraceContext(secrets.token_hex(16), new_span_id())


_HEX = frozenset("0123456789abcdef")


def _lower_hex(s: str) -> bool:
    """W3C trace-context requires LOWERCASE hex; uppercase is malformed."""
    return bool(s) and all(c in _HEX for c in s)


def parse_traceparent(header: str | None) -> TraceContext | None:
    """W3C header -> TraceContext; None on absent/malformed.

    Spec-compliant rejection set (https://www.w3.org/TR/trace-context/):
    wrong field count/length, non-hex or UPPERCASE hex in any field,
    version ``ff`` (explicitly forbidden), and all-zero trace/span ids.
    """
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if (
        len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16
        or len(flags) != 2
        or not _lower_hex(version) or not _lower_hex(trace_id)
        or not _lower_hex(span_id) or not _lower_hex(flags)
        or version == "ff"  # forbidden by the spec
        or trace_id == "0" * 32 or span_id == "0" * 16
    ):
        return None
    sampled = bool(int(flags, 16) & 1)
    return TraceContext(trace_id, span_id, sampled)


def current_trace() -> TraceContext | None:
    return _current.get()


def set_current(tc: TraceContext | None) -> None:
    """Bind the current trace context by hand. ``span()`` and
    ``bind_trace`` are the usual way; this is for code that manages span
    identities itself (the flight recorder's span derivation)."""
    _current.set(tc)


def ensure_trace(headers: dict[str, str] | None = None) -> TraceContext:
    """Extract the incoming trace or start a new one; writes the (child)
    traceparent back into ``headers`` so downstream hops continue it."""
    incoming = parse_traceparent((headers or {}).get(TRACEPARENT))
    tc = incoming.child() if incoming else new_trace()
    if headers is not None:
        headers[TRACEPARENT] = tc.to_traceparent()
    _current.set(tc)
    return tc


def bind_trace(headers) -> TraceContext | None:
    """Server side: join the CALLER's span context from propagated
    headers — the parsed context becomes current (the remote parent), so
    the first ``span()`` opened here is its direct child and the cross-
    process parent chain has no unemitted gap. Absent or malformed
    headers CLEAR the binding: a task reused across requests (keep-alive
    HTTP connections, transport reader loops) must not leak the previous
    request's trace into the next."""
    tc = parse_traceparent((headers or {}).get(TRACEPARENT))
    _current.set(tc)
    return tc


def _record_span(
    name: str,
    tc: TraceContext,
    parent_span_id: str | None,
    start_ns: int,
    end_ns: int,
    attrs: dict | None,
    error: str | None,
) -> None:
    """Single emission chokepoint: JSONL log record + optional trace file
    + optional OTLP batch. Never raises (tracing must not take serving
    down)."""
    if not _tracing_active():
        # nothing will observe this span: skip the JSON serialization
        return
    record = {
        "span": name,
        "trace_id": tc.trace_id,
        "span_id": tc.span_id,
        "parent_span_id": parent_span_id,
        "duration_ms": round((end_ns - start_ns) / 1e6, 3),
        **(attrs or {}),
    }
    if error:
        record["error"] = error
    line = json.dumps(record)
    log.info("%s", line)
    if _file_sink() is not None:
        try:
            with _trace_file_lock:
                # re-read under the lock: a concurrent set_trace_file
                # may have closed the handle _file_sink() returned
                if _trace_file is not None:
                    _trace_file.write(line + "\n")
                    _trace_file.flush()
        except (OSError, ValueError):  # disk full / closed file: drop,
            pass  # keep serving
    exporter = _exporter()
    if exporter is not None:
        exporter.enqueue(
            name, tc, parent_span_id, start_ns, end_ns, attrs or {}, error
        )


def emit_span(
    name: str,
    tc: TraceContext,
    *,
    parent_span_id: str | None = None,
    start_ns: int,
    end_ns: int,
    attrs: dict | None = None,
    error: str | None = None,
) -> None:
    """Emit one already-timed span with an explicit identity — the
    low-level API behind ``span()``, used where timings were recorded
    off-thread (the engine's flight recorder derives request-lifecycle
    spans from step-thread timestamps at finish)."""
    _record_span(name, tc, parent_span_id, start_ns, end_ns, attrs, error)


def _tracing_active() -> bool:
    """Anything observing spans in this process? When not, span() and
    _record_span() take fast paths — spans ride every pick and every
    transport call, and clock reads plus JSON serialization are
    measurable per-request tax at 1k+ req/s."""
    return (
        log.isEnabledFor(logging.INFO)
        or _file_sink() is not None
        or _exporter() is not None
    )


@contextlib.contextmanager
def span(name: str, **attrs):
    """Timed span under the current trace, emitted as one JSONL record
    (and to the trace file / OTLP exporter when configured)."""
    if not _tracing_active():
        # nothing records here: keep the identity contract (a fresh
        # child span context, installed for downstream wire hops) but
        # skip the clock reads and the record path entirely
        parent = _current.get()
        tc = parent.child() if parent else new_trace()
        token = _current.set(tc)
        try:
            yield tc
        finally:
            try:
                _current.reset(token)
            except ValueError:
                pass
        return
    parent = _current.get()
    tc = parent.child() if parent else new_trace()
    token = _current.set(tc)
    t0 = time.monotonic()
    start_ns = time.time_ns()
    error: str | None = None
    try:
        yield tc
    except BaseException as e:
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        try:
            _current.reset(token)
        except ValueError:
            # abandoned-async-generator finalization runs in a fresh
            # context (loop shutdown_asyncgens / GC hook); the token is
            # foreign there. The binding we'd reset doesn't exist in
            # this context anyway — emit the span and move on.
            pass
        end_ns = start_ns + int((time.monotonic() - t0) * 1e9)
        _record_span(
            name, tc, parent.span_id if parent else None,
            start_ns, end_ns, attrs, error,
        )


# ------------------------------------------------------------ file sink

_trace_file_lock = threading.Lock()
_trace_file = None
_trace_file_checked = False


def set_trace_file(path: str | None):
    """Install (or clear, with None) the process-wide span JSONL file."""
    global _trace_file, _trace_file_checked
    with _trace_file_lock:
        if _trace_file is not None:
            try:
                _trace_file.close()
            except OSError:
                pass
        _trace_file = open(path, "a") if path else None
        _trace_file_checked = True
    return _trace_file


def _file_sink():
    global _trace_file, _trace_file_checked
    if not _trace_file_checked:
        with _trace_file_lock:
            if not _trace_file_checked:
                _trace_file_checked = True
                env = (os.environ.get("DYN_TRACE_FILE") or "").strip()
                if env:
                    try:
                        _trace_file = open(env, "a")
                    except OSError as e:
                        log.warning("DYN_TRACE_FILE %r unusable: %s", env, e)
    return _trace_file


# ------------------------------------------------------------ OTLP export


class OtlpExporter:
    """Batching OTLP/HTTP JSON exporter. Spans queue from any thread; a daemon thread batches and
    POSTs to ``{endpoint}/v1/traces``. Failures drop batches with a
    warning — tracing must never take serving down. ``close()`` drains
    the queue AND joins the worker thread, so the final batch's POST
    completes (or fails loudly) before shutdown proceeds."""

    def __init__(self, endpoint: str, *, service_name: str = "dynamo-tpu",
                 flush_interval_s: float = 1.0, max_batch: int = 256):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self._q: queue.Queue = queue.Queue(maxsize=4096)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="otlp-export", daemon=True
        )
        self._thread.start()

    def enqueue(self, name, tc, parent_span_id, start_ns, end_ns, attrs,
                error):
        span = {
            "traceId": tc.trace_id,
            "spanId": tc.span_id,
            "name": name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in attrs.items()
            ],
            "status": (
                {"code": 2, "message": error} if error else {"code": 1}
            ),
        }
        if parent_span_id is not None:
            span["parentSpanId"] = parent_span_id
        try:
            self._q.put_nowait(span)
        except queue.Full:
            pass  # drop under backpressure

    def _drain(self, timeout: float) -> list[dict]:
        spans: list[dict] = []
        try:
            spans.append(self._q.get(timeout=timeout))
            while len(spans) < self.max_batch:
                spans.append(self._q.get_nowait())
        except queue.Empty:
            pass
        return spans

    def _post(self, spans: list[dict]) -> None:
        body = json.dumps({
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "dynamo_tpu.runtime.tracing"},
                    "spans": spans,
                }],
            }]
        }).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=5).read()

    def _run(self) -> None:
        # loop until a stop is requested AND the queue has drained, so the
        # last batch is posted before close() returns
        while True:
            spans = self._drain(
                0.01 if self._stop.is_set() else self.flush_interval_s
            )
            if spans:
                try:
                    self._post(spans)
                except Exception:  # noqa: BLE001
                    log.warning("OTLP export failed (%d spans dropped)",
                                len(spans))
            elif self._stop.is_set():
                return

    def flush(self, timeout: float = 5.0) -> None:
        """Best-effort synchronous drain, for tests and shutdown only: waits
        (at most ``timeout`` s) until the queue is empty, then one beat more
        for the batch being posted. Span emission never calls it; code on an
        event loop uses ``aflush``."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.05)  # the in-flight POST

    async def aflush(self, timeout: float = 5.0) -> None:
        """``flush`` without blocking the event loop."""
        await asyncio.to_thread(self.flush, timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Flush AND join: the worker thread drains the queue, finishes
        its final POST, and exits before close() returns — queued spans
        can no longer drop silently at shutdown (they either land at the
        collector or log an export-failure warning)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
            if self._thread.is_alive():  # pragma: no cover - wedged POST
                log.warning("OTLP exporter did not drain within %.1fs",
                            timeout)


_otlp: OtlpExporter | None = None
_otlp_checked = False


def set_otlp_endpoint(endpoint: str | None, **kw) -> OtlpExporter | None:
    """Install (or clear, with None) the process-wide OTLP exporter."""
    global _otlp, _otlp_checked
    if _otlp is not None:
        _otlp.close()
    _otlp = OtlpExporter(endpoint, **kw) if endpoint else None
    _otlp_checked = True
    return _otlp


def _exporter() -> OtlpExporter | None:
    global _otlp, _otlp_checked
    if not _otlp_checked:
        _otlp_checked = True
        env = (os.environ.get("DYN_OTLP_ENDPOINT") or "").strip()
        if env:
            _otlp = OtlpExporter(env)
    return _otlp
