"""The port's observability plane held against the JAX package's on a tiny
spec on the CPU: the flight recorder, the engines' per-request timelines,
the step profiler's phase names, the worker telemetry registry, and the
span tree of a traced request through the port's HTTP frontend.

The names (phases, spans, metrics) are the reference's catalog
(tools/dynalint/catalog.py): dashboards, bench.py and the reference's tests
read those exact strings. Two catalogued names wait for slices the port
lacks: the ``spmd_sync`` phase (ROADMAP Queue A item 11) and the
``epp.pick`` span (item 14, gateway/).
"""

from __future__ import annotations

import ast
import asyncio
import json
import threading
import urllib.request
from contextlib import aclosing
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

import dynamo_tpu.engine.telemetry as jtel
import dynamo_tpu.kvbm as jkvbm
import dynamo_tpu.runtime.context as jctx
import dynamo_tpu.runtime.flight as jflight
import dynamo_tpu.runtime.tracing as jtracing
import dynamo_tpu_torch.engine.telemetry as ttel
import dynamo_tpu_torch.kvbm as tkvbm
import dynamo_tpu_torch.runtime.audit as taudit
import dynamo_tpu_torch.runtime.context as tctx
import dynamo_tpu_torch.runtime.flight as tflight
import dynamo_tpu_torch.runtime.tracing as ttracing
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from tools.dynalint import catalog

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"
SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=256, max_pages_per_seq=32,
              max_decode_slots=2, prefill_buckets=(8, 16, 32, 64, 128))
EMBED_SCALE = 4.0  # diverse greedy streams, equal across the packages

# catalogued names that wait for slices the port lacks
# every phase of the reference's catalog is ported (spmd_sync came with the
# SPMD plane, ROADMAP Queue A item 11a)
PHASES_NOT_PORTED: set[str] = set()
SPANS_NOT_PORTED = {"epp.pick"}  # the gateway's EPP: ROADMAP Queue A item 14


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_flight():
    for mod in (tflight, jflight):
        mod.FLIGHT.clear()
    yield
    for mod in (tflight, jflight):
        mod.FLIGHT.clear()
    for mod in (ttracing, jtracing):
        mod.set_trace_file(None)
    FAULTS.clear()


_WEIGHTS: dict[int, tuple] = {}


def _weights(seed=5):
    if seed not in _WEIGHTS:
        jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(seed)))
        jp["embed"] = jp["embed"] * EMBED_SCALE
        _WEIGHTS[seed] = (jp, params_from_numpy(
            ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp), device="cpu"))
    return _WEIGHTS[seed]


SIDES = {
    "jax": SimpleNamespace(Engine=JaxEngine, Config=JaxEngineConfig, Spec=JaxSpec,
                           ctx=jctx, flight=jflight, tel=jtel, kvbm=jkvbm,
                           render=lambda: generate_latest(jtel.REGISTRY.registry).decode(),
                           pick=lambda w: w[0], kw={}),
    "port": SimpleNamespace(Engine=InferenceEngine, Config=EngineConfig, Spec=ModelSpec,
                            ctx=tctx, flight=tflight, tel=ttel, kvbm=tkvbm,
                            render=lambda: ttel.REGISTRY.render(),
                            pick=lambda w: w[1], kw={"device": "cpu"}),
}


def _engine(m, **cfg):
    return m.Engine(m.Spec(**SPEC_KW), m.Config(**{**CFG_KW, **cfg}),
                    params=m.pick(_weights()), **m.kw)


def _req(tokens, n, temperature=0.0, **extra):
    return {"token_ids": list(tokens), "sampling": {"temperature": temperature, "seed": 7},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}, **extra}


def _ctx(m, tenant=None, priority=None):
    headers = {}
    if tenant:
        headers[m.ctx.TENANT_HEADER] = tenant
    if priority:
        headers[m.ctx.PRIORITY_HEADER] = priority
    return m.ctx.Context(headers=headers)


async def _collect(eng, req, ctx, first_only=False):
    out = []
    agen = eng.generate(req, ctx)
    async with aclosing(agen):
        async for item in agen:
            out.append(item)
            if first_only:
                break
    return out


async def _until(cond, n=3000):
    for _ in range(n):
        if cond():
            return True
        await asyncio.sleep(0.01)
    return False


async def _both(scenario):
    return {name: await scenario(m) for name, m in SIDES.items()}


# ------------------------------------------------------------ flight recorder


class _FakeTime:
    """An injected clock for both flight modules: the snapshots, times
    included, are then comparable."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def time_ns(self):
        return 1_700_000_000_000_000_000 + int(self.t * 1e9)


def _script(mod, tr, clock, trace_path):
    """A scripted event sequence: coalescing repeats, an event storm past
    MAX_EVENTS, errors, slow and fast requests past every retention cap."""
    rec = mod.FlightRecorder(capacity=4, keep_errors=2, keep_slow=2)
    durations = [0.5, 0.01, 2.0, 0.02, 0.3, 1.5, 0.05, 0.2]
    for i, dur in enumerate(durations):
        rid = f"r{i}"
        rec.start(rid, trace=tr.TraceContext(TID, f"{i + 1:016x}"),
                  parent_span_id=SID, model="m", prompt_tokens=10 + i)
        clock.t += 0.01
        rec.event(rid, "admit")
        for _ in range(3):
            clock.t += 0.001
            rec.event(rid, "prefill_chunk")
        rec.event(rid, "first_token")
        for k in range(40 * i):  # alternating names never coalesce
            clock.t += 0.0001
            rec.event(rid, "spec_verify" if k % 2 else "fault", accepted=k)
        clock.t += dur
        reason = "error" if i in (2, 5) else "length"
        tl = rec.finish(rid, reason, error="boom" if i == 2 else None, generated=i)
        if i == 1:
            tr.set_trace_file(str(trace_path))
            mod.emit_request_spans(tl)
            tr.set_trace_file(None)
    rec.start("live", model="m")
    rec.event("live", "admit")
    rec.event("nobody", "admit")  # an unknown id is a no-op
    out = {"summary": rec.snapshot(n=3), "missing": rec.snapshot("r99"),
           "live": rec.snapshot("live"), "again": rec.finish("r0", "length")}
    for i in range(len(durations)):
        out[f"r{i}"] = rec.snapshot(f"r{i}")
    return out


def test_flight_recorder_snapshots_match_reference(monkeypatch, tmp_path):
    got = {}
    for name, mod, tr in (("port", tflight, ttracing), ("jax", jflight, jtracing)):
        clock = _FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        got[name] = (_script(mod, tr, clock, tmp_path / f"{name}.jsonl"),
                     [json.loads(x) for x in
                      (tmp_path / f"{name}.jsonl").read_text().splitlines()])
    (port, port_spans), (ref, ref_spans) = got["port"], got["jax"]
    assert port == ref
    # what the script reaches: retention by recency, error and duration
    s = port["summary"]
    assert [t["request_id"] for t in s["recent"]] == ["r5", "r6", "r7"]
    assert [t["request_id"] for t in s["errors"]] == ["r2", "r5"]
    assert [t["request_id"] for t in s["slowest"]] == ["r2", "r5"]
    assert [t["request_id"] for t in s["active"]] == ["live"]
    # r1 rotated out of the ring; r0 (slow once, since outranked) too; the
    # errored r2 survives in its bucket
    assert not port["r1"]["found"] and port["r2"]["found"]
    assert port["live"]["timeline"]["live"]
    assert not port["missing"]["found"] and port["again"] is None
    r7 = port["r7"]["timeline"]
    assert r7["dropped_events"] > 0 and len(r7["events"]) == tflight.MAX_EVENTS
    chunk = port["r7"]["timeline"]["events"][1]
    assert chunk["name"] == "prefill_chunk" and chunk["n"] == 3
    # the derived spans: names, parentage and timing, span ids aside
    def shape(recs):
        ids = {r["span_id"]: r["span"] for r in recs}
        return [(r["span"], ids.get(r["parent_span_id"], r["parent_span_id"]),
                 r["duration_ms"], {k: v for k, v in r.items() if k not in (
                     "span", "span_id", "parent_span_id", "duration_ms")})
                for r in recs]
    assert shape(port_spans) == shape(ref_spans)
    assert [r["span"] for r in port_spans] == [
        "engine.queue_wait", "engine.prefill", "engine.decode", "engine.spec",
        "worker.request"]


# ------------------------------------------------------------ engine timelines


def _events(m, eng_ids):
    """Per tag: (event names with counts, finish reason, generated)."""
    out = {}
    for tag, rid in eng_ids.items():
        snap = m.flight.FLIGHT.snapshot(rid)
        if not snap["found"]:
            out[tag] = None
            continue
        tl = snap["timeline"]
        out[tag] = ([(e["name"], e["n"]) for e in tl["events"]], tl["finish_reason"],
                    tl["generated"], tl["error"])
    return out


async def test_engine_timelines_match_jax():
    """A chunked prompt, a speculative request and an abandoned stream, one
    after another: the same events, counts and finish reasons in both
    engines' flight recorders."""
    seg = [11, 29, 40, 7, 63, 2]

    async def scenario(m):
        eng = _engine(m, max_prefill_chunk_tokens=16, spec_mode="ngram", spec_k_max=4)
        ids = {}
        ctx = _ctx(m)
        await _collect(eng, _req(range(1, 41), 4, temperature=0.8), ctx)
        ids["chunked"] = ctx.id
        ctx = _ctx(m)
        spec_out = await _collect(eng, _req(seg * 4, 24), ctx)
        ids["spec"] = ctx.id
        ctx = _ctx(m)
        # sampled, so never speculated: after its first token the slot runs
        # bursts, which record no event, however late the break lands
        await _collect(eng, _req([5, 6, 7, 8, 9], 40, temperature=0.8), ctx,
                       first_only=True)
        ctx.stop_generating()
        ids["abandoned"] = ctx.id
        assert await _until(lambda: eng.allocator.active_pages == 0)
        res = (_events(m, ids), [t for x in spec_out for t in x["token_ids"]])
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    ev = got["port"][0]
    assert ev["chunked"][0] == [("admit", 1), ("prefill_chunk", 3), ("first_token", 1)]
    assert ev["chunked"][1:3] == ("length", 4)
    assert [n for n, _ in ev["spec"][0]] == ["admit", "prefill_chunk", "first_token",
                                             "spec_verify"]
    assert ev["abandoned"][1:3] == ("abandoned", 1)


async def test_shed_timeline_matches_jax():
    """max_waiting overflow with the step thread parked: the saturated
    bounce opens no timeline, the shed victim's records its shed, and the
    survivors finish by length, as in the JAX engine."""

    async def scenario(m):
        eng = _engine(m, max_decode_slots=1, max_waiting=1, preemption=False)
        open_, parked = threading.Event(), threading.Event()
        open_.set()
        admit = eng._admit_phase

        def gated():
            if not open_.is_set():
                parked.set()
                open_.wait(60.0)
            return admit()

        eng._admit_phase = gated
        ids = {}
        hold = _ctx(m, "bt", "batch")
        t_hold = asyncio.create_task(_collect(eng, _req([1, 2, 3], 30), hold))
        assert await _until(lambda: any(s is not None for s in eng._slots))
        open_.clear()
        assert await _until(parked.is_set)
        victim = _ctx(m, "bt", "batch")
        t_wait = asyncio.create_task(_collect(eng, _req([1, 2, 3], 30), victim))
        assert await _until(lambda: eng._waiting.qsize() >= 1)
        bounced = _ctx(m, "bt2", "batch")
        with pytest.raises(m.ctx.ServiceUnavailable):
            await _collect(eng, _req([1, 2, 3], 30), bounced)
        inter = _ctx(m, "it")
        t_int = asyncio.create_task(_collect(eng, _req([7, 8], 2), inter))
        with pytest.raises(m.ctx.ServiceUnavailable):
            await t_wait
        open_.set()
        await t_int
        await t_hold
        ids.update(hold=hold.id, victim=victim.id, bounced=bounced.id, inter=inter.id)
        res = _events(m, ids)
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    ev = got["port"]
    assert ev["bounced"] is None
    assert ev["victim"] == ([("shed", 1)], "shed", 0, None)
    assert ev["hold"][1] == ev["inter"][1] == "length"


# ------------------------------------------------------------ profiler names


def _core_phases() -> set[str]:
    """Every phase name engine/core.py feeds the profiler: _phase and
    _prof_add calls, and profile_snapshot's own keys (the reference's
    tests/test_dispatch_profile.py scan)."""
    import re

    src = (ROOT / "dynamo_tpu_torch/engine/core.py").read_text()
    used: set[str] = set()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("_phase", "_prof_add") and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            used.add(node.args[0].value)
    used.update(re.findall(r'(?:snap|self\._prof)(?:\.setdefault\(|\[)"([a-z_.0-9]+)"',
                           src))
    return used


def test_profile_phases_match_the_catalog():
    used = _core_phases()
    catalogued = set(catalog.PROFILE_PHASES)
    assert used - catalogued == set(), used - catalogued
    assert catalogued - used == PHASES_NOT_PORTED, catalogued - used


async def test_profile_snapshot_counts_the_serve():
    """With profiling on, a serve fills the catalogued phases; the dispatch
    accounting counts one program per burst, forward and sample; a reset
    window starts from zero. Profiling off still counts dispatches."""
    for profile in (True, False):
        eng = InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW, profile=profile),
                              params=_weights()[1], device="cpu")
        report = eng.precompile()
        assert report and all(v == {"secs": v["secs"], "compiles": 0}
                              for v in report.values()), report
        assert "decode[2xgreedy]" in report and "decode[2xsampled,lp20]" in report
        outs = await asyncio.gather(*(_collect(eng, _req(range(1 + i, 9 + i), 6),
                                               tctx.Context()) for i in range(3)))
        n_tok = sum(len(x["token_ids"]) for o in outs for x in o)
        if profile:
            # a client may read its finish item before the step thread
            # closes the process phase that posted it
            def settled():
                s = eng.profile_snapshot()
                return s["dispatch"]["calls"] == s["process"]["calls"]

            assert await _until(settled)
        snap = eng.profile_snapshot()
        assert n_tok == 18
        assert snap["dispatch.dispatches"]["calls"] == eng.dispatches > 0
        assert snap["dispatch.compile"] == {"secs": 0.0, "calls": 0}
        if profile:
            for phase in ("admit_loop", "packed_prefill", "complete_admissions",
                          "build_batch", "dispatch", "process", "process.d2h_sync",
                          "dispatch.d2h_wait", "readmit.admit_wait",
                          "readmit.prefill_dispatch", "readmit.first_token"):
                assert snap[phase]["calls"] > 0, phase
            assert sum(eng.burst_fills) + 3 == n_tok  # first tokens land apart
        else:
            assert set(snap) == {"dispatch.d2h_wait", "readmit.d2h_wait",
                                 "dispatch.dispatches", "dispatch.compile"}
        eng.reset_profile_window()
        snap = eng.profile_snapshot()
        assert snap["dispatch.dispatches"]["calls"] == 0 and "process" not in snap
        await eng.close()


# ------------------------------------------------------------ telemetry


def _series(text: str, label: str) -> dict:
    """{(sample name, labels without engine): value} of one collector's
    series, ``_created`` samples aside."""
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith("_created") or s.labels.get("engine") != label:
                continue
            labels = tuple(sorted((k, v) for k, v in s.labels.items() if k != "engine"))
            out[(s.name, labels)] = s.value
    return out


VALUE_METRICS = ("engine_pages", "engine_slots_active", "engine_batch_occupancy",
                 "engine_waiting_requests", "engine_admission_rejects_total",
                 "engine_preemptions_total", "tenant_tokens_total", "kvbm_tier_bytes",
                 "engine_spec_acceptance_rate", "engine_burst_tokens_count",
                 "engine_burst_tokens_bucket", "engine_burst_tokens_sum")


def _telemetry(m, eng):
    col = m.tel.EngineCollector(eng)
    col.sample()
    series = _series(m.render(), col.label)
    names = {(n, tuple(k for k, _ in lab)) for n, lab in series}
    values = {k: v for k, v in series.items()
              if k[0].removeprefix("dynamo_") in VALUE_METRICS}
    return names, values


@pytest.mark.parametrize("case", ["traffic", "preemption"])
async def test_telemetry_render_matches_reference(case):
    """After the same traffic the port's worker telemetry renders every
    metric name and label set of the reference's, with equal pool, slot,
    queue, reject, preemption, tenant-token, KVBM tier, spec acceptance and
    burst-token readings."""
    seg = [11, 29, 40, 7, 63, 2]

    async def traffic(m):
        kvbm = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(host_bytes=1 << 20))
        eng = m.Engine(m.Spec(**SPEC_KW), m.Config(**{
            **CFG_KW, "spec_mode": "ngram", "spec_k_max": 4,
            "tenants": "q:rate=0.001,burst=40"}), params=m.pick(_weights()),
            kvbm=kvbm, **m.kw)
        await _collect(eng, _req(range(1, 11), 16), _ctx(m, "q"))
        with pytest.raises(m.ctx.OverQuota):
            await _collect(eng, _req(range(1, 11), 16), _ctx(m, "q"))
        await _collect(eng, _req(seg * 4, 20), _ctx(m, "a"))
        await _collect(eng, _req(range(30, 50), 12, temperature=0.8), _ctx(m, "b", "batch"))
        eng.begin_drain()
        with pytest.raises(m.ctx.ServiceUnavailable):
            await _collect(eng, _req([1, 2], 2), _ctx(m))
        await asyncio.to_thread(eng.offload.flush)
        res = _telemetry(m, eng)
        await eng.close()
        return res

    async def preemption(m):
        eng = _engine(m, max_decode_slots=1)
        open_, parked = threading.Event(), threading.Event()
        open_.set()
        admit = eng._admit_phase

        def gated():
            if not open_.is_set():
                parked.set()
                open_.wait(60.0)
            return admit()

        eng._admit_phase = gated
        items: list = []

        async def batch():
            async for item in eng.generate(_req([1, 2, 3, 4, 5], 40), _ctx(m, "bt", "batch")):
                items.append(item)

        t_batch = asyncio.create_task(batch())
        assert await _until(lambda: len(items) >= 3)
        open_.clear()
        assert await _until(parked.is_set)
        t_int = asyncio.create_task(_collect(eng, _req([7, 8, 9], 4), _ctx(m, "it")))
        assert await _until(lambda: eng._waiting.qsize() == 1)
        open_.set()
        await t_int
        await t_batch
        res = _telemetry(m, eng)
        await eng.close()
        return res

    got = await _both(traffic if case == "traffic" else preemption)
    (pnames, pvals), (jnames, jvals) = got["port"], got["jax"]
    assert pnames == jnames
    assert pvals == jvals
    if case == "traffic":
        assert pvals[("dynamo_engine_admission_rejects_total",
                      (("reason", "over_quota"),))] == 1
        assert ("dynamo_engine_spec_acceptance_rate", ()) in pvals
        assert pvals[("dynamo_kvbm_tier_bytes", (("tier", "host"),))] > 0
    else:
        assert pvals[("dynamo_engine_preemptions_total",
                      (("reason", "interactive_admission"),))] == 1


# ------------------------------------------------------------ the span tree

SPEC272 = ModelSpec(name="tiny-test", vocab_size=272, hidden_size=32,
                    intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                    head_dim=8, dtype="float32")
MODEL = "tiny-obs"


def _post(port: int, route: str, body: dict, headers: dict | None = None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port: int, route: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=60) as r:
        return r.status, json.loads(r.read())


async def test_traced_chat_is_one_tree_and_every_span_is_emitted(tmp_path):
    """One traced chat through the port's frontend, an in-memory hub and a
    port worker is one trace: http.request -> transport.call ->
    worker.request -> engine.*. With a migrated, a disaggregated, a
    speculative and a guided request, every catalogued span is emitted
    (epp.pick aside: item 14). /debug/timeline reads the request back, and
    the frontend's audit file holds one record per request."""
    path = tmp_path / "spans.jsonl"
    ttracing.set_trace_file(str(path))
    cfg = dict(page_size=4, num_pages=256, max_pages_per_seq=64, max_decode_slots=4,
               prefill_buckets=(32, 64, 128, 256))
    drt = DistributedRuntime(InMemoryHub())
    pre, _ = await launch_engine_worker(drt, spec=SPEC272, engine_config=EngineConfig(**cfg),
                                        mode="prefill", device="cpu", model_name=MODEL)
    dec, _ = await launch_engine_worker(
        drt, spec=SPEC272, engine_config=EngineConfig(**cfg, spec_mode="ngram"),
        mode="decode", device="cpu", model_name=MODEL, router_mode="round_robin",
        max_local_prefill_length=64)
    await dec.frontdoor.wait_for_prefill_pool()
    watch = await ModelWatcher(drt, ModelManager()).start()
    await watch.wait_for_model(MODEL, timeout=10)
    sink = taudit.JsonlSink(str(tmp_path / "audit.jsonl"))
    http = HttpFrontend(watch.manager, host="127.0.0.1", port=0, drt=drt,
                        audit=taudit.AuditBus().add_sink(sink))
    await http.start()
    port = http.port
    try:
        tp = f"00-{TID}-{SID}-01"
        status, body = await asyncio.to_thread(
            _post, port, "/v1/chat/completions",
            {"model": MODEL, "messages": [{"role": "user", "content": "hi"}],
             "max_tokens": 4, "temperature": 0}, {"traceparent": tp})
        assert status == 200 and body["usage"]["completion_tokens"] == 4
        seg = [41, 57, 90, 33, 78, 12]
        for prompt, n in ((seg * 4, 16), (list(range(20, 120)), 4)):
            # speculative (repetitive, local prefill), then disaggregated
            # (past max_local_prefill_length)
            status, _ = await asyncio.to_thread(
                _post, port, "/v1/completions",
                {"model": MODEL, "prompt": prompt, "max_tokens": n, "temperature": 0})
            assert status == 200
        status, _ = await asyncio.to_thread(
            _post, port, "/v1/chat/completions",
            {"model": MODEL, "messages": [{"role": "user", "content": "pick"}],
             "max_tokens": 8, "response_format": {"type": "json_schema", "json_schema": {
                 "name": "c", "schema": {"type": "object", "properties": {
                     "c": {"enum": ["red", "blue"]}}, "required": ["c"]}}}})
        assert status == 200
        FAULTS.configure("engine.admit:drop@1x1")
        status, _ = await asyncio.to_thread(
            _post, port, "/v1/completions",
            {"model": MODEL, "prompt": [5, 6, 7], "max_tokens": 2})
        assert status == 200
        FAULTS.clear()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        mine = [r for r in recs if r["trace_id"] == TID]
        by_id = {r["span_id"]: r for r in mine}
        names = {r["span"]: r for r in mine}
        # the decode worker speculates on greedy requests: engine.spec may
        # join the engine's spans
        assert set(names) - {"engine.spec"} == {
            "http.request", "http.preprocess", "transport.call", "worker.request",
            "engine.queue_wait", "engine.prefill", "engine.decode"}, sorted(names)
        assert len(mine) == len(names)  # one of each: a single tree
        assert names["http.request"]["parent_span_id"] == SID

        def parent(r):
            return by_id[r["parent_span_id"]]["span"]

        assert parent(names["http.preprocess"]) == "http.request"
        assert parent(names["transport.call"]) == "http.request"
        assert parent(names["worker.request"]) == "transport.call"
        for n in names:
            if n.startswith("engine."):
                assert parent(names[n]) == "worker.request"
        wr = names["worker.request"]
        assert wr["finish_reason"] == "length" and wr["generated"] == 4
        emitted = {r["span"] for r in recs}
        assert emitted == set(catalog.SPAN_NAMES) - SPANS_NOT_PORTED, (
            sorted(set(catalog.SPAN_NAMES) - emitted))
        # the flight recorder through the frontend's fan-out
        status, tl = await asyncio.to_thread(
            _get, port, f"/debug/timeline?request_id={wr['request_id']}")
        assert status == 200
        found = [w["timeline"] for comp in tl["results"].values()
                 for w in comp.values() if isinstance(w, dict) and w.get("found")]
        assert found and found[0]["trace_id"] == TID
        assert [e["name"] for e in found[0]["events"]][:2] == ["admit", "first_token"]
        assert found[0]["finish_reason"] == "length"
        status, summary = await asyncio.to_thread(_get, port, "/debug/timeline?n=2")
        assert status == 200 and all(
            "recent" in w for comp in summary["results"].values()
            for w in comp.values())
        await asyncio.to_thread(sink.flush)
        audit = [json.loads(x) for x in (tmp_path / "audit.jsonl").read_text().splitlines()]
        assert [(a["route"], a["status"]) for a in audit] == [
            ("chat", 200), ("completions", 200), ("completions", 200), ("chat", 200),
            ("completions", 200)]
        assert audit[0]["request_id"] == wr["request_id"]
        assert audit[0]["output_tokens"] == 4 and audit[0]["finish_reason"] == "length"
        assert audit[0]["request"]["messages_count"] == 1
    finally:
        await http.stop()
        await watch.close()
        await dec.close()
        await pre.close()
        await drt.close()
