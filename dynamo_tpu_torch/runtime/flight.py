"""Flight recorder: a bounded per-worker ring of per-request event
timelines, the "why was THIS request slow" tool (the counterpart of
dynamo_tpu/runtime/flight.py).

Every request the engine admits gets a timeline: admission, phase
transitions (prefill chunks, first token, spec verifies, disagg
events, fault trips), and the finish reason, each stamped with a
monotonic offset from enqueue and carrying the request's trace_id.
The step thread records events with one lock + append (coalescing
repeats, bounded per timeline), so the hot path stays cheap.

Retention is TAIL-BIASED: besides the most-recent ring, errored
timelines and the slowest requests survive eviction in their own
buckets — the interesting requests are exactly the ones a plain ring
would have rotated out by the time an operator asks.

Live queries: worker admin ``{"op": "timeline"}`` (engine/worker.py)
and the frontend's ``GET /debug/timeline`` fan-out (frontend/http.py).

At finish, the timeline is also the source for the worker-side spans
(``worker.request`` / ``engine.queue_wait`` / ``engine.prefill`` /
``engine.decode`` / ``engine.spec``, joined to the caller's trace via
the span context the engine bound at admission) — one cross-process
trace per request without the step thread ever touching contextvars.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any

from dynamo_tpu_torch.runtime import tracing

__all__ = ["FlightRecorder", "Timeline", "FLIGHT", "emit_request_spans"]

# per-timeline event cap: spec verifies / prefill chunks coalesce, but a
# pathological event storm must stay bounded (drops are counted)
MAX_EVENTS = 96


class Timeline:
    """One request's recorded lifecycle. Not thread-safe on its own —
    the recorder's lock guards all mutation."""

    __slots__ = (
        "request_id", "trace_id", "span_id", "parent_span_id", "sampled",
        "t0_wall_ns", "t0", "attrs", "events", "dropped_events",
        "finish_reason", "error", "ended_t", "seq",
    )

    def __init__(self, request_id: str, attrs: dict[str, Any]):
        self.request_id = request_id
        self.trace_id: str | None = None
        self.span_id: str | None = None
        self.parent_span_id: str | None = None
        self.sampled = True
        self.t0_wall_ns = time.time_ns()
        self.t0 = time.monotonic()
        self.attrs = attrs
        # [{"name", "t", "t_last", "n", **attrs}] — repeats of the SAME
        # name coalesce in place (n++, t_last advances), so per-token /
        # per-verify chatter costs one entry, not one per occurrence
        self.events: list[dict[str, Any]] = []
        self.dropped_events = 0
        self.finish_reason: str | None = None
        self.error: str | None = None
        self.ended_t: float | None = None
        self.seq = 0  # heap tiebreak

    @property
    def duration_s(self) -> float:
        end = self.ended_t if self.ended_t is not None else time.monotonic()
        return end - self.t0

    def first(self, name: str) -> dict[str, Any] | None:
        for ev in self.events:
            if ev["name"] == name:
                return ev
        return None

    def last(self, name: str) -> dict[str, Any] | None:
        for ev in reversed(self.events):
            if ev["name"] == name:
                return ev
        return None

    def to_dict(self) -> dict[str, Any]:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "started_unix_ns": self.t0_wall_ns,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "finish_reason": self.finish_reason,
            "error": self.error,
            "live": self.ended_t is None,
            "dropped_events": self.dropped_events,
            **self.attrs,
            "events": [
                {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in ev.items()}
                for ev in self.events
            ],
        }

    def summary(self) -> dict[str, Any]:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "finish_reason": self.finish_reason,
            "error": self.error,
            "live": self.ended_t is None,
        }


class FlightRecorder:
    """Bounded in-memory store of request timelines (active + retained)."""

    def __init__(self, capacity: int = 128, keep_errors: int = 32,
                 keep_slow: int = 32):
        self._lock = threading.Lock()
        self._active: dict[str, Timeline] = {}
        self._recent: list[Timeline] = []
        self._capacity = capacity
        self._errors: list[Timeline] = []
        self._keep_errors = keep_errors
        # min-heap of (duration, seq, timeline): the slowest keep_slow
        # finished requests survive even when the recent ring rotates
        self._slow: list[tuple[float, int, Timeline]] = []
        self._keep_slow = keep_slow
        self._seq = 0

    # -- recording (any thread) -------------------------------------------

    def start(self, request_id: str, *, trace: "tracing.TraceContext | None"
              = None, parent_span_id: str | None = None,
              **attrs: Any) -> Timeline:
        tl = Timeline(request_id, attrs)
        if trace is not None:
            tl.trace_id = trace.trace_id
            tl.span_id = trace.span_id
            tl.sampled = trace.sampled
            tl.parent_span_id = parent_span_id
        with self._lock:
            self._seq += 1
            tl.seq = self._seq
            self._active[request_id] = tl
        return tl

    def event(self, request_id: str, name: str, **attrs: Any) -> None:
        """Record one lifecycle event; unknown request ids no-op (the
        caller may be a step-thread path racing a finished stream)."""
        now = time.monotonic()
        with self._lock:
            tl = self._active.get(request_id)
            if tl is None:
                return
            t = now - tl.t0
            if tl.events and tl.events[-1]["name"] == name:
                ev = tl.events[-1]
                ev["n"] += 1
                ev["t_last"] = t
                ev.update(attrs)
                return
            if len(tl.events) >= MAX_EVENTS:
                tl.dropped_events += 1
                return
            tl.events.append({"name": name, "t": t, "t_last": t, "n": 1,
                              **attrs})

    def finish(self, request_id: str, reason: str | None,
               error: str | None = None, **attrs: Any) -> Timeline | None:
        """Close a timeline and move it into retention. Returns the
        closed timeline (None when the id is unknown / already closed)."""
        now = time.monotonic()
        with self._lock:
            tl = self._active.pop(request_id, None)
            if tl is None:
                return None
            tl.ended_t = now  # absolute monotonic end
            tl.finish_reason = reason
            tl.error = error
            tl.attrs.update(attrs)
            self._recent.append(tl)
            if len(self._recent) > self._capacity:
                self._recent.pop(0)
            if error or reason == "error":
                self._errors.append(tl)
                if len(self._errors) > self._keep_errors:
                    self._errors.pop(0)
            item = (tl.duration_s, tl.seq, tl)
            if len(self._slow) < self._keep_slow:
                heapq.heappush(self._slow, item)
            elif item[0] > self._slow[0][0]:
                heapq.heapreplace(self._slow, item)
            return tl

    # -- queries (event loop / admin) -------------------------------------

    def _lookup_locked(self, request_id: str) -> Timeline | None:
        tl = self._active.get(request_id)
        if tl is not None:
            return tl
        for bucket in (self._recent, self._errors,
                       [t for _d, _s, t in self._slow]):
            for tl in reversed(bucket):
                if tl.request_id == request_id:
                    return tl
        return None

    def lookup(self, request_id: str) -> Timeline | None:
        """The timeline of ``request_id`` (active, recent, error or slow),
        found under the recorder's lock. An active one is still being
        changed by the step thread: render it with ``snapshot``, which
        does so under the lock."""
        with self._lock:
            return self._lookup_locked(request_id)

    def snapshot(self, request_id: str | None = None,
                 n: int = 16) -> dict[str, Any]:
        """Admin-op payload: one full timeline (by request id), or the
        summary view (active + recent tail + retained errors/slowest).

        The by-id render happens UNDER the recorder lock: an active
        timeline's event list (and the coalesced tail event's dict) is
        still being mutated by the step thread, so serializing it
        outside the lock races ``event()``: ``dict.update`` on the
        tail entry while ``to_dict`` iterates it can raise and, short
        of that, tears the event.
        """
        if request_id:
            with self._lock:
                tl = self._lookup_locked(request_id)
                if tl is None:
                    return {"found": False, "request_id": request_id}
                return {"found": True, "timeline": tl.to_dict()}
        with self._lock:
            slowest = sorted(self._slow, key=lambda it: -it[0])
            return {
                "active": [t.summary() for t in self._active.values()],
                "recent": [t.summary() for t in self._recent[-n:]],
                "errors": [t.summary() for t in self._errors[-n:]],
                "slowest": [t.summary() for _d, _s, t in slowest[:n]],
            }

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._recent.clear()
            self._errors.clear()
            self._slow.clear()


# process-wide recorder: the engine records into it, the worker admin op
# and the frontend debug route read from it
FLIGHT = FlightRecorder()


def emit_request_spans(tl: Timeline) -> None:
    """Derive the worker-side span tree from a finished timeline and
    emit it under the request's trace: ``worker.request`` (child of the
    caller's transport span) with ``engine.queue_wait`` / ``engine.
    prefill`` / ``engine.decode`` / ``engine.spec`` children. Phases the
    request never reached are simply absent."""
    if tl.trace_id is None or tl.span_id is None or tl.ended_t is None:
        return
    wr = tracing.TraceContext(tl.trace_id, tl.span_id, tl.sampled)

    def ns(rel_s: float) -> int:
        return tl.t0_wall_ns + int(rel_s * 1e9)

    def child_tc() -> "tracing.TraceContext":
        return tracing.TraceContext(
            tl.trace_id, tracing.new_span_id(), tl.sampled
        )

    end_rel = tl.ended_t - tl.t0
    admit = tl.first("admit")
    first_tok = tl.first("first_token") or tl.first("disagg_resume")
    if admit is not None:
        tracing.emit_span(
            "engine.queue_wait", child_tc(), parent_span_id=tl.span_id,
            start_ns=ns(0.0), end_ns=ns(admit["t"]),
        )
        if first_tok is not None:
            chunks = tl.first("prefill_chunk")
            tracing.emit_span(
                "engine.prefill", child_tc(), parent_span_id=tl.span_id,
                start_ns=ns(admit["t"]), end_ns=ns(first_tok["t"]),
                attrs={"chunks": chunks["n"]} if chunks else None,
            )
            tracing.emit_span(
                "engine.decode", child_tc(), parent_span_id=tl.span_id,
                start_ns=ns(first_tok["t"]), end_ns=ns(end_rel),
                attrs={"tokens": tl.attrs.get("generated")},
            )
    spec = tl.first("spec_verify")
    if spec is not None:
        tracing.emit_span(
            "engine.spec", child_tc(), parent_span_id=tl.span_id,
            start_ns=ns(spec["t"]),
            end_ns=ns(tl.last("spec_verify")["t_last"]),
            attrs={"verifies": spec["n"]},
        )
    attrs = {"request_id": tl.request_id, **tl.attrs}
    if tl.finish_reason:
        attrs["finish_reason"] = tl.finish_reason
    tracing.emit_span(
        "worker.request", wr, parent_span_id=tl.parent_span_id,
        start_ns=tl.t0_wall_ns, end_ns=ns(end_rel), attrs=attrs,
        error=tl.error,
    )
