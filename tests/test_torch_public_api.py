"""Public functions of ported modules that the reference has and earlier
slices left out, each held against the reference's on the same inputs:
``runtime/tracing.set_current``, ``OtlpExporter.flush`` / ``aflush`` and
``runtime/flight.FlightRecorder.lookup``."""

from __future__ import annotations

import asyncio
import contextvars
import http.server
import json
import threading

import pytest

from dynamo_tpu.runtime import flight as jflight
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu_torch.runtime import flight as tflight
from dynamo_tpu_torch.runtime import tracing as ttracing

pytestmark = pytest.mark.unit

TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"


@pytest.mark.parametrize("mod", [ttracing, jtracing], ids=["port", "jax"])
def test_set_current_binds_and_clears_the_trace(mod):
    def run():
        tc = mod.TraceContext(TID, SID, True)
        before = mod.current_trace()
        mod.set_current(tc)
        bound = mod.current_trace()
        with mod.span("http.request") as child:
            inner = mod.current_trace()
        after = mod.current_trace()
        mod.set_current(None)
        return before, bound, inner.trace_id, inner is child, after, mod.current_trace()

    # a fresh context: a test that ran earlier in this process may have left
    # a trace bound in the thread's own
    before, bound, inner_tid, same, after, cleared = contextvars.Context().run(run)
    assert before is None and bound.span_id == SID and inner_tid == TID and same
    assert after is bound and cleared is None


def _port_and_ref(fn):
    """``fn(module)`` for the port's module and the reference's."""
    return fn(ttracing), fn(jtracing)


class _Collector:
    """A stdlib OTLP/HTTP collector that answers after ``delay`` seconds."""

    def __init__(self, delay: float = 0.0):
        bodies = self.bodies = []
        import time

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                time.sleep(delay)
                n = int(self.headers["Content-Length"])
                bodies.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _names(bodies) -> list[str]:
    return sorted(s["name"] for b in bodies for rs in b["resourceSpans"]
                  for ss in rs["scopeSpans"] for s in ss["spans"])


@pytest.mark.parametrize("use_async", [False, True], ids=["flush", "aflush"])
def test_flush_drains_spans_queued_before_it(use_async):
    """Spans queued before ``flush`` / ``aflush`` are at the collector when
    it returns, without ``close``; the same for the reference."""

    def run(mod):
        col = _Collector(delay=0.01)
        exp = mod.OtlpExporter(col.url, service_name="svc", flush_interval_s=0.02,
                               max_batch=2)
        try:
            for i in range(5):
                exp.enqueue(f"span{i}", mod.TraceContext(TID, f"{i + 1:016x}"), SID,
                            1_000 + i, 2_000 + i, {"i": i}, None)
            if use_async:
                asyncio.run(exp.aflush(5.0))
            else:
                exp.flush(5.0)
            landed = _names(col.bodies)
        finally:
            exp.close()
            col.close()
        return landed

    got, want = _port_and_ref(run)
    assert got == want == [f"span{i}" for i in range(5)]


def test_flush_with_nothing_queued_returns_at_once():
    def run(mod):
        import time

        exp = mod.OtlpExporter("http://127.0.0.1:9", flush_interval_s=0.05)
        t0 = time.monotonic()
        exp.flush(5.0)
        took = time.monotonic() - t0
        exp.close()
        return took < 1.0

    assert _port_and_ref(run) == (True, True)


def _recorder_record(mod):
    """Active, recent, error and missing ids looked up in a recorder of
    capacity 2 (one finished id rotated out of the recent ring)."""
    rec = mod.FlightRecorder(capacity=2, keep_errors=4)
    for rid in ("a", "b", "c", "d", "live"):
        rec.start(rid, model="m")
        rec.event(rid, "admit", slot=1)
    rec.finish("a", "error", error="boom")
    for rid in ("b", "c", "d"):
        rec.finish(rid, "length")
    out = {}
    for rid in ("live", "a", "b", "c", "d", "nope"):
        tl = rec.lookup(rid)
        out[rid] = None if tl is None else (tl.request_id, tl.finish_reason,
                                             tl.error, [e["name"] for e in tl.events])
    return out


def test_lookup_finds_active_recent_and_error_timelines_as_the_reference():
    got, want = _port_and_ref(lambda mod: _recorder_record(
        tflight if mod is ttracing else jflight))
    assert got == want
    assert got["live"] == ("live", None, None, ["admit"])
    assert got["a"] == ("a", "error", "boom", ["admit"])  # kept as an error
    assert got["nope"] is None


def test_lookup_takes_the_recorder_lock():
    rec = tflight.FlightRecorder()
    rec.start("x")
    got = []
    with rec._lock:
        t = threading.Thread(target=lambda: got.append(rec.lookup("x")))
        t.start()
        t.join(0.2)
        assert t.is_alive() and not got  # waits for the lock
    t.join(5)
    assert not t.is_alive() and got[0].request_id == "x"
