"""The port's tracing and audit wire shapes held against the JAX package's.

``dynamo_tpu_torch/runtime/tracing.py`` and ``runtime/audit.py`` are read by
collectors, auditors and dashboards built for the reference: the W3C header
rules, the JSONL span records, the OTLP/HTTP JSON body and the audit
records must be the reference's, key for key. Each test feeds both packages
the same inputs (fixed ids and clocks where the record carries them).
"""

from __future__ import annotations

import asyncio
import http.server
import json
import threading

import pytest

from dynamo_tpu.runtime import audit as jaudit
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu_torch.runtime import audit as taudit
from dynamo_tpu_torch.runtime import tracing as ttracing
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer

pytestmark = pytest.mark.unit

TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"

# valid and malformed traceparent headers (https://www.w3.org/TR/trace-context/)
HEADERS = [
    None, "", f"00-{TID}-{SID}-01", f"00-{TID}-{SID}-00", f"00-{TID}-{SID}-03",
    f"  00-{TID}-{SID}-01  ", f"01-{TID}-{SID}-01",
    f"00-{TID.upper()}-{SID}-01", f"00-{TID}-{SID.upper()}-01",
    f"0A-{TID}-{SID}-01", f"00-{TID}-{SID}-0F", f"ff-{TID}-{SID}-01",
    f"00-{'0' * 32}-{SID}-01", f"00-{TID}-{'0' * 16}-01",
    f"00-{TID[:-1]}-{SID}-01", f"00-{TID}-{SID}1-01", f"00-{TID}-{SID}-1",
    f"00-{TID}-{SID}", f"00-{TID}-{SID}-01-extra", f"00-{TID}-{SID[:-1]}g-01",
    f"0-{TID}-{SID}-01", "garbage", "00--" + SID + "-01",
]


@pytest.fixture(autouse=True)
def _no_sinks():
    """Tests install process-wide sinks; none outlives its test."""
    yield
    for mod in (ttracing, jtracing):
        mod.set_trace_file(None)
        mod.set_otlp_endpoint(None)


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_matches_reference(header):
    got, want = ttracing.parse_traceparent(header), jtracing.parse_traceparent(header)
    if want is None:
        assert got is None
        return
    assert (got.trace_id, got.span_id, got.sampled) == (
        want.trace_id, want.span_id, want.sampled)
    assert got.to_traceparent() == want.to_traceparent()


@pytest.mark.parametrize("sampled", [True, False])
def test_to_traceparent_matches_reference(sampled):
    got = ttracing.TraceContext(TID, SID, sampled).to_traceparent()
    assert got == jtracing.TraceContext(TID, SID, sampled).to_traceparent()
    # a fresh trace and its child parse back to the same ids in both packages
    tc = ttracing.new_trace()
    child = tc.child()
    assert child.trace_id == tc.trace_id and child.span_id != tc.span_id
    back = jtracing.parse_traceparent(child.to_traceparent())
    assert (back.trace_id, back.span_id) == (child.trace_id, child.span_id)


def _nested_spans(mod, path):
    """http.request > transport.call, then a sibling error span, under a
    bound caller header; returns the JSONL records."""
    mod.set_trace_file(str(path))
    mod.bind_trace({"traceparent": f"00-{TID}-{SID}-01"})
    with mod.span("http.request", route="chat", model="m"):
        with mod.span("transport.call", endpoint="ns/c/e", instance="1f"):
            pass
    with pytest.raises(ValueError):
        with mod.span("migration.resume", attempt=0):
            raise ValueError("boom")
    mod.bind_trace(None)
    mod.set_trace_file(None)
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_span_jsonl_records_match_reference(tmp_path):
    got = _nested_spans(ttracing, tmp_path / "port.jsonl")
    want = _nested_spans(jtracing, tmp_path / "ref.jsonl")
    assert [r["span"] for r in got] == [r["span"] for r in want] == [
        "transport.call", "http.request", "migration.resume"]
    for g, w in zip(got, want):
        assert list(g) == list(w)  # the same keys, in the same order
        assert g["trace_id"] == w["trace_id"] == TID
        for key in g:
            if key not in ("span_id", "parent_span_id", "duration_ms"):
                assert g[key] == w[key], key
    # parentage: the call under the route span under the caller's span; the
    # error span a sibling of the route span
    for recs in (got, want):
        call, route, err = recs
        assert route["parent_span_id"] == SID
        assert call["parent_span_id"] == route["span_id"]
        assert err["parent_span_id"] == SID
        assert err["error"] == "ValueError: boom"


class _Collector:
    """An in-process OTLP/HTTP collector on the stdlib: keeps every body
    POSTed to /v1/traces."""

    def __init__(self):
        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                bodies.append((self.path, self.headers["Content-Type"],
                               json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_otlp_exporter_posts_the_reference_body():
    col = _Collector()
    try:
        for mod in (ttracing, jtracing):
            exp = mod.OtlpExporter(col.url, service_name="svc", flush_interval_s=0.05)
            tc = mod.TraceContext(TID, SID)
            exp.enqueue("http.request", tc, None, 1_000, 2_500,
                        {"route": "chat", "n": 3}, None)
            exp.enqueue("transport.call", mod.TraceContext(TID, "1" * 16), SID,
                        1_100, 2_400, {}, "StreamError: cut")
            exp.close()
        assert len(col.bodies) == 2
        (p_path, p_type, got), (r_path, r_type, want) = col.bodies
        assert p_path == r_path == "/v1/traces"
        assert p_type == r_type == "application/json"
        assert got == want
        spans = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert [s["name"] for s in spans] == ["http.request", "transport.call"]
    finally:
        col.close()


def _fixed_clock(monkeypatch):
    for mod in (taudit, jaudit):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)


AUDIT_CASES = [
    dict(route="chat", model="m", request_id="r1",
         request={"messages": [{"role": "user", "content": "hi"}] * 2,
                  "max_tokens": 32, "temperature": 0.5, "stream": True,
                  "tools": [{"type": "function"}]},
         status=200, finish_reason="length", output_tokens=32,
         duration_ms=12.34567),
    dict(route="completions", model=None, request_id="r2",
         request={"prompt": "x" * 40}, status=503, duration_ms=0.5,
         error="service unavailable"),
    dict(route="responses", model="m", request_id="r3", request={}, status=429),
]


@pytest.mark.parametrize("case", range(len(AUDIT_CASES)))
def test_audit_record_matches_reference(case, monkeypatch):
    _fixed_clock(monkeypatch)
    kw = AUDIT_CASES[case]
    got = taudit.AuditRecord.make(**kw)
    want = jaudit.AuditRecord.make(**kw)
    assert dict(got) == dict(want)
    assert list(got) == list(want)


def test_jsonl_sink_writes_the_reference_lines(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    files = []
    for mod in (taudit, jaudit):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        sink = mod.JsonlSink(str(path))
        for kw in AUDIT_CASES:
            sink.emit(mod.AuditRecord.make(**kw))
        sink.flush()
        sink.close()
        files.append(path.read_text())
    assert files[0] == files[1]
    assert len(files[0].splitlines()) == len(AUDIT_CASES)
    # the env switch builds the same sink
    monkeypatch.setenv("DYN_AUDIT_PATH", str(tmp_path / "env.jsonl"))
    bus = taudit.AuditBus()
    assert bus.enabled and isinstance(bus.sinks[0], taudit.JsonlSink)
    bus.close()


async def test_port_hub_sink_record_is_read_on_the_reference_subject(monkeypatch):
    """A port HubSink publishes to ``audit/{namespace}/requests`` over a TCP
    hub; a JAX subscriber on the reference's subject reads the record."""
    _fixed_clock(monkeypatch)
    server = HubServer(port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"
    pub = await RemoteHub.connect(addr)
    sub = await JaxRemoteHub.connect(addr)
    try:
        subject = jaudit.AUDIT_SUBJECT.format(namespace="obs")
        assert taudit.HubSink(pub, "obs").subject == subject
        bus = taudit.AuditBus().add_sink(taudit.HubSink(pub, "obs"))
        rec = taudit.AuditRecord.make(**AUDIT_CASES[0])
        bus.emit(rec)
        stream = sub.subscribe(subject, replay=True)
        item = await asyncio.wait_for(stream.__anext__(), 10)
        await stream.aclose()
        payload = item[-1] if isinstance(item, tuple) else item
        assert payload == dict(jaudit.AuditRecord.make(**AUDIT_CASES[0]))
        assert bus.emitted == 1
    finally:
        await pub.close()
        await sub.close()
        await server.stop()
