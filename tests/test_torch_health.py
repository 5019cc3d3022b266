"""The port's health subsystem (runtime/health.py) against the JAX package's.

Mirrors the JAX ``tests/test_health.py`` and ``test_integrity.py::
test_sdc_canary_mismatch_quarantines_then_clean_readmit`` on the port's
in-memory and TCP hubs: a wedged handler flips readiness and the router
drops the instance; the status server's ``/live``, ``/ready`` and
``/health`` answer as the JAX ``SystemStatusServer`` does for the same
handler history (statuses and JSON bodies equal, the probe counters and
timestamps aside, which tick on each side's own clock); ``EngineMonitor``
shuts the runtime down when the engine's step thread dies; an armed
``health.canary:corrupt~<instance>`` fault quarantines a worker serving a
tiny CPU engine (``dynamo_worker_quarantines_total{reason="sdc"}`` on its
``/metrics``) and clean canaries readmit it. A worker quarantined by the
port's monitor is skipped by the JAX ``KvPushRouter``, and the reverse.
"""

import asyncio
import json

import pytest
import torch

from dynamo_tpu.kv_router.protocols import RouterConfig as JaxRouterConfig
from dynamo_tpu.kv_router.router import KvPushRouter as JaxKvPushRouter
from dynamo_tpu.kv_router.router import KvRouter as JaxKvRouter
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu.runtime.push import PushRouter as JaxPushRouter
from dynamo_tpu.runtime.push import RouterMode as JaxRouterMode
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import health as thealth
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

pytestmark = pytest.mark.integration

FAST = dict(interval_s=0.03, timeout_s=0.2, failure_threshold=2)
# a tiny CPU engine: the canary is a real one-token greedy generate
SPEC = ModelSpec(name="hm", vocab_size=272, hidden_size=32, intermediate_size=64,
                 num_layers=1, num_heads=2, num_kv_heads=2, head_dim=8,
                 dtype="float32")
CFG = dict(page_size=4, num_pages=32, max_pages_per_seq=8, max_decode_slots=1,
           prefill_buckets=(16,))


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class WedgeableHandler:
    """Streams one token normally; hangs forever while wedged."""

    def __init__(self, name="w"):
        self.wedged = False
        self.name = name

    async def __call__(self, request, context):
        if self.wedged:
            await asyncio.Event().wait()  # never returns
        yield {"token_ids": [5], "text": self.name, "finish_reason": "stop"}


async def _until(pred, what="condition", timeout=10.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        assert loop.time() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.01)


async def _runtime(hub_kind):
    """(runtime, closer) on the port's in-memory hub or a TCP hub server."""
    if hub_kind == "inmem":
        drt = DistributedRuntime(InMemoryHub())

        async def close():
            await drt.close()
        return drt, close
    server = HubServer(port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"
    drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))

    async def close():
        await drt.close()
        await server.stop()
    return drt, close


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode())
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    ctype = [ln.split(b":", 1)[1].strip().decode() for ln in head.split(b"\r\n")[1:]
             if ln.lower().startswith(b"content-type")]
    return status, (ctype[0] if ctype else None), body


@pytest.mark.parametrize("hub_kind", ["inmem", "tcp"])
async def test_wedged_handler_flips_readiness_and_router_drops_instance(hub_kind):
    drt, close = await _runtime(hub_kind)
    handler = WedgeableHandler()
    ep = drt.namespace("dyn").component("backend").endpoint("generate")
    served = await ep.serve(handler)
    client = await ep.client().start()
    await client.wait_for_instances(1, timeout=5)
    health = thealth.HealthCheckManager(drt, thealth.HealthCheckConfig(**FAST))
    h = health.register(served)
    try:
        await _until(lambda: h.status == "ready", "initial ready")
        assert health.all_ready
        handler.wedged = True
        await _until(lambda: h.status == "unhealthy", "unhealthy flip")
        assert not health.all_ready
        # the instance key is withdrawn: watching clients drop it
        await _until(lambda: client.instance_ids() == [], "router drop")
        handler.wedged = False
        await _until(lambda: h.status == "ready", "recovery")
        await _until(lambda: len(client.instance_ids()) == 1, "re-publication")
    finally:
        await health.close()
        await client.close()
        await close()


async def _status_side(pkg, drt_cls, hub_cls, handler):
    drt = drt_cls(hub_cls())
    ep = drt.namespace("dyn").component("backend").endpoint("generate")
    served = await ep.serve(handler)
    health = pkg.HealthCheckManager(drt, pkg.HealthCheckConfig(**FAST))
    h = health.register(served)
    server = await pkg.SystemStatusServer(health=health, port=0).start()
    return drt, health, h, server


def _comparable(body):
    """A /health body minus the fields that tick on each side's clock."""
    body = json.loads(body)
    for e in body.get("endpoints", ()):
        assert e.pop("probes") >= 1
        e["last_ok"] = e["last_ok"] is not None
        e["consecutive_failures"] = min(e["consecutive_failures"], 2)
    return body


async def test_status_server_bodies_match_jax():
    handlers = {"jax": WedgeableHandler(), "port": WedgeableHandler()}
    sides = {"jax": await _status_side(jhealth, JaxRuntime, JaxHub, handlers["jax"]),
             "port": await _status_side(thealth, DistributedRuntime, InMemoryHub,
                                        handlers["port"])}

    async def answers():
        out = {}
        for side, (_, _, _, server) in sides.items():
            out[side] = {p: await _get(server.port, p)
                         for p in ("/live", "/ready", "/health", "/metrics", "/nope")}
        return out

    try:
        for _, _, h, _ in sides.values():
            await _until(lambda h=h: h.status == "ready", "ready")
        ready = await answers()
        for handler in handlers.values():
            handler.wedged = True
        for _, _, h, _ in sides.values():
            await _until(lambda h=h: h.status == "unhealthy" and
                         h.consecutive_failures >= 2, "unhealthy")
        wedged = await answers()
        for got in (ready, wedged):
            for path in ("/live", "/ready"):
                assert got["port"][path] == got["jax"][path], path
            assert got["port"]["/health"][:2] == got["jax"]["/health"][:2]
            assert _comparable(got["port"]["/health"][2]) == _comparable(
                got["jax"]["/health"][2])
            # no metrics registry: /metrics is 404 on both; an unknown path too
            assert got["port"]["/metrics"][0] == got["jax"]["/metrics"][0] == 404
            assert got["port"]["/nope"][0] == got["jax"]["/nope"][0] == 404
        assert ready["port"]["/ready"][:2] == (200, "application/json; charset=utf-8")
        assert wedged["port"]["/ready"][0] == 503
        body = json.loads(wedged["port"]["/health"][2])
        assert body["status"] == "notready"
        assert "TimeoutError" in body["endpoints"][0]["last_error"]
    finally:
        for drt, health, _, server in sides.values():
            await server.stop()
            await health.close()
            await drt.close()


async def test_engine_monitor_shuts_down_on_dead_loop():
    drt = DistributedRuntime(InMemoryHub())
    engine, served = await launch_engine_worker(
        drt, spec=SPEC, engine_config=EngineConfig(**CFG), device="cpu",
        router_mode="round_robin")
    monitor = thealth.EngineMonitor(drt, engine, interval_s=0.05)
    try:
        assert not engine.is_dead

        # an engine death (not an orderly close): a BaseException escapes
        # the step thread's Exception recovery and ends it
        def _boom() -> bool:
            raise BaseException("simulated engine death")

        engine._step = _boom
        engine._wake.set()
        await _until(lambda: drt._closed, "runtime shutdown")
        assert engine.is_dead
        # the worker's instances are deregistered from the hub
        assert await drt.hub.get_prefix("v1/instances/") == {}
    finally:
        await monitor.close()
        engine._closed = True
        await drt.close()


def _sdc_count(text: str) -> float:
    for line in text.splitlines():
        if line.startswith('dynamo_worker_quarantines_total{reason="sdc"}'):
            return float(line.split()[-1])
    return 0.0


@pytest.mark.parametrize("hub_kind", ["inmem", "tcp"])
async def test_sdc_canary_quarantines_then_clean_readmit(hub_kind):
    """The canary is a known-answer test on the real engine: the first
    clean canary's tokens are the golden; a corrupted answer quarantines at
    once (the card stays in the hub, flagged), a dirty canary mid-quarantine
    resets the clean streak, and readmit_threshold clean canaries readmit."""
    drt, close = await _runtime(hub_kind)
    health = thealth.HealthCheckManager(drt, thealth.HealthCheckConfig(
        interval_s=0.05, timeout_s=5.0, failure_threshold=2, readmit_threshold=3))
    server = await thealth.SystemStatusServer(
        health=health, metrics=MetricsRegistry(), port=0).start()
    engine, served = await launch_engine_worker(
        drt, spec=SPEC, engine_config=EngineConfig(**CFG), device="cpu",
        health=health, router_mode="round_robin")
    (h,) = health.statuses
    client = await drt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    key = thealth.HealthCheckManager._fault_key(served.instance)
    assert key == (f"127.0.0.1:{served.instance.port}" if hub_kind == "tcp"
                   else f"{served.instance.instance_id:x}")
    before = _sdc_count((await _get(server.port, "/metrics"))[2].decode())
    try:
        await _until(lambda: h.status == "ready", "initial ready")
        # a rule scoped to another worker does not touch this one
        tfaults.FAULTS.configure("health.canary:corrupt~10.9.9.9:*")
        probes = h.probes
        await _until(lambda: h.probes >= probes + 2, "two more canaries")
        assert h.status == "ready"
        tfaults.FAULTS.configure(f"health.canary:corrupt~{key}")
        await _until(lambda: h.status == "quarantined", "quarantine")
        assert h.quarantine_reason == "sdc" and h.quarantines == 1
        assert "sdc" in (h.last_error or "")
        card = await drt.hub.get(served.instance.path)
        assert thealth.is_quarantined(card) and jhealth.is_quarantined(card)
        await _until(lambda: any(thealth.is_quarantined(i) for i in client.instances()),
                     "client sees the quarantined card")
        status, ctype, body = await _get(server.port, "/metrics")
        assert status == 200 and ctype == "text/plain; charset=utf-8"
        assert _sdc_count(body.decode()) == before + 1
        assert (await _get(server.port, "/ready"))[0] == 503
        tfaults.FAULTS.clear()
        await _until(lambda: h.clean_streak >= 1, "streak starts")
        tfaults.FAULTS.configure(f"health.canary:corrupt=1x1~{key}")
        await _until(lambda: h.clean_streak == 0, "streak reset")
        tfaults.FAULTS.clear()
        assert h.status == "quarantined" and h.quarantines == 1
        await _until(lambda: h.status == "ready", "readmission")
        assert not thealth.is_quarantined(await drt.hub.get(served.instance.path))
        await _until(lambda: not any(thealth.is_quarantined(i)
                                     for i in client.instances()), "client readmits")
        assert (await _get(server.port, "/ready"))[0] == 200
    finally:
        tfaults.FAULTS.clear()
        await server.stop()
        await health.close()
        await client.close()
        await engine.close()
        await close()


@pytest.mark.parametrize("quarantined_by", ["port", "jax"])
async def test_quarantine_is_honoured_across_packages(quarantined_by):
    """Workers A and B, each in its own runtime (its own endpoint server,
    so its own fault identity), on one TCP hub; the health monitor of one
    package quarantines A (canary fault scoped to A's address); the OTHER
    package's KvPushRouter sends the next 4 requests all to B."""
    server = HubServer(port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"

    async def port_rt():
        return DistributedRuntime(await RemoteHub.connect(addr),
                                  RuntimeConfig(hub_address=addr))

    async def jax_rt():
        return JaxRuntime(await JaxRemoteHub.connect(addr),
                          JaxRuntimeConfig(hub_address=addr))

    by_port = quarantined_by == "port"
    hpkg, faults = (thealth, tfaults) if by_port else (jhealth, jfaults)
    workers = {n: await (port_rt() if by_port else jax_rt()) for n in ("A", "B")}
    rdrt = await (jax_rt() if by_port else port_rt())
    served, health, hs = {}, {}, {}
    for n, drt in workers.items():
        ep = drt.namespace("dyn").component("backend").endpoint("generate")
        served[n] = await ep.serve(WedgeableHandler(n))
        health[n] = hpkg.HealthCheckManager(drt, hpkg.HealthCheckConfig(**FAST))
        hs[n] = health[n].register(served[n])
    # the router of the other package
    rep = rdrt.namespace("dyn").component("backend").endpoint("generate")
    if by_port:
        push = await JaxPushRouter.from_endpoint(rep, JaxRouterMode.DIRECT)
        kv = await JaxKvRouter(rdrt.hub, "dyn/backend", JaxRouterConfig(block_size=4)).start()
        router, ctx_cls = JaxKvPushRouter(push, kv), JaxContext
    else:
        push = await PushRouter.from_endpoint(rep, RouterMode.DIRECT)
        kv = await KvRouter(rdrt.hub, "dyn/backend", RouterConfig(block_size=4)).start()
        router, ctx_cls = KvPushRouter(push, kv), Context

    async def route(i):
        req = {"token_ids": [i, i + 1, i + 2, i + 3, i + 4],
               "stop_conditions": {"max_tokens": 1}}
        return [x async for x in router.generate(req, ctx_cls())][0]["text"]

    try:
        await _until(lambda: all(h.status == "ready" for h in hs.values()), "ready")
        await _until(lambda: len(push.client.instance_ids()) == 2, "both instances")
        key = hpkg.HealthCheckManager._fault_key(served["A"].instance)
        assert key != hpkg.HealthCheckManager._fault_key(served["B"].instance)
        faults.FAULTS.configure(f"health.canary:corrupt~{key}")
        await _until(lambda: hs["A"].status == "quarantined", "quarantine")
        await _until(lambda: any(jhealth.is_quarantined(i) for i in push.client.instances()),
                     "the router sees the quarantined card")
        assert hs["B"].status == "ready"
        assert [await route(10 * i) for i in range(4)] == ["B"] * 4
        faults.FAULTS.clear()
        await _until(lambda: hs["A"].status == "ready", "readmission", timeout=15)
        await _until(lambda: not any(jhealth.is_quarantined(i)
                                     for i in push.client.instances()), "readmitted")
    finally:
        faults.FAULTS.clear()
        for h in health.values():
            await h.close()
        await kv.close()
        await push.client.close()
        for drt in (rdrt, *workers.values()):
            await drt.close()
        await server.stop()


def test_degradation_detector_scores_like_jax():
    """The same step-time fingerprints give the same EWMA scores, the same
    degraded set and the same exposition (peer-relative, min-peer guard,
    forget); exact equality: the arithmetic is the same float64 code."""
    import random

    rng = random.Random(3)
    dets = [pkg.DegradationDetector(tolerance=3.0, ewma_alpha=0.3, min_peers=3)
            for pkg in (jhealth, thealth)]
    outs = [[], []]
    for tick in range(30):
        for w in ("w0", "w1", "w2", "w3")[: 2 + min(tick, 2)]:
            ms = rng.uniform(8.0, 12.0) * (10.0 if w == "w3" and tick > 10 else 1.0)
            for d in dets:
                d.observe(w, ms)
        if tick == 20:
            for d in dets:
                d.forget("w1")
        for d, out in zip(dets, outs):
            out.append((d.scores(), d.degraded(), d.exposition()))
    assert outs[0] == outs[1]
    assert outs[1][-1][1] == ["w3"]


async def test_status_server_metrics_match_jax():
    """With a metrics registry, /metrics carries the quarantine counter
    family in the reference's exact text (HELP, TYPE, one sample per
    reason, sorted), from the same counts; both bodies are Prometheus
    text."""
    saved = [dict(pkg.QUARANTINE_STATS) for pkg in (jhealth, thealth)]
    from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxMetricsRegistry

    servers = []
    try:
        for pkg, reg in ((jhealth, JaxMetricsRegistry), (thealth, MetricsRegistry)):
            pkg.QUARANTINE_STATS.clear()
            for reason in ("sdc", "degraded", "sdc", "manual"):
                pkg.count_quarantine(reason)
            servers.append(await pkg.SystemStatusServer(metrics=reg(), port=0).start())
        bodies = []
        for server in servers:
            status, ctype, body = await _get(server.port, "/metrics")
            assert status == 200 and ctype.startswith("text/plain")
            bodies.append([ln for ln in body.decode().splitlines()
                           if "dynamo_worker_quarantines_total" in ln])
        assert bodies[0] == bodies[1]
        assert bodies[1][2:] == ['dynamo_worker_quarantines_total{reason="degraded"} 1',
                                 'dynamo_worker_quarantines_total{reason="manual"} 1',
                                 'dynamo_worker_quarantines_total{reason="sdc"} 2']
        assert thealth._quarantine_exposition() == jhealth._quarantine_exposition()
    finally:
        for server in servers:
            await server.stop()
        for pkg, snap in zip((jhealth, thealth), saved):
            pkg.QUARANTINE_STATS.clear()
            pkg.QUARANTINE_STATS.update(snap)
