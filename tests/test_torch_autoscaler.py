"""The port's autoscaler (dynamo_tpu_torch/autoscaler/) against the
reference's (dynamo_tpu/autoscaler/): the control law emits equal plans on
the same demand sequences, FleetTelemetry the same signals on the same
metrics (stale expiry and quarantine included), the controller the same
plans, convergence ticks, forecast errors and report, the backends the
same hub writes and observations, the metrics the same series; and a live
loop: the port's telemetry forms its signal from port mock workers' own
ForwardPassMetrics over the hub and K8sBackend's plan is converged by the
port's operator. Inputs come from numpy seeds."""

import asyncio
import time
from dataclasses import asdict

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.autoscaler import backends as jax_backends
from dynamo_tpu.autoscaler import controller as jax_controller
from dynamo_tpu.autoscaler import metrics as jax_metrics
from dynamo_tpu.autoscaler import plan as jax_plan
from dynamo_tpu.autoscaler import telemetry as jax_telemetry
from dynamo_tpu.kv_router.protocols import ForwardPassMetrics as JaxMetrics
from dynamo_tpu_torch.autoscaler import backends, controller, metrics, plan, telemetry
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.runtime.hub import InMemoryHub

pytestmark = pytest.mark.unit

PKGS = {"port": (plan, telemetry, controller, backends, ForwardPassMetrics),
        "ref": (jax_plan, jax_telemetry, jax_controller, jax_backends, JaxMetrics)}


def _config(pkg: str, seed: int):
    rng = np.random.default_rng(seed)
    kw = dict(
        slots_per_worker=int(rng.integers(2, 9)),
        target_occupancy=float(rng.uniform(0.5, 0.9)),
        prefill_tokens_per_worker=float(rng.uniform(500, 9000)),
        workers_per_router_shard=int(rng.integers(2, 6)),
        min_workers=1, max_workers=int(rng.integers(6, 40)),
        min_prefill=0, max_prefill=int(rng.integers(2, 9)),
        max_router_shards=int(rng.integers(2, 5)),
        scale_up_at=float(rng.uniform(0.7, 0.95)),
        scale_down_at=float(rng.uniform(0.2, 0.6)),
        up_cooldown_s=float(rng.choice([0.0, 2.0, 5.0])),
        down_cooldown_s=float(rng.choice([0.0, 6.0, 20.0])),
        max_step_up=int(rng.integers(1, 5)), max_step_down=int(rng.integers(1, 3)),
        predict_ahead_ticks=int(rng.choice([0, 2, 3])),
        predictor=str(rng.choice(["holt", "ar", "constant"])),
        seasonal_period=int(rng.choice([0, 0, 6])),
        tick_interval_s=1.0)
    return PKGS[pkg][0].AutoscalerConfig(**kw)


def _signals(pkg: str, seed: int, n: int = 80) -> list:
    rng = np.random.default_rng(1000 + seed)
    t = np.arange(n)
    demand = np.maximum(0, 40 + 35 * np.sin(2 * np.pi * t / 24) + rng.normal(0, 6, n))
    demand[30:36] += 80
    out = []
    for i in range(n):
        out.append(PKGS[pkg][0].DemandSignal(
            demand=float(demand[i]),
            prefill_queue_tokens=float(max(0.0, rng.normal(6000, 5000))),
            workers_observed=int(rng.integers(1, 9)),
            live_workers_reporting=int(rng.integers(1, 9)),
            quarantined_workers=int(rng.choice([0, 0, 0, 1, 2]))))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_plan_engine_matches_the_reference(seed):
    got, want = [], []
    for pkg, out in (("port", got), ("ref", want)):
        cfg = _config(pkg, seed)
        eng = PKGS[pkg][0].PlanEngine(cfg, initial_workers=2, initial_prefill=1)
        now = 0.0
        for i, sig in enumerate(_signals(pkg, seed)):
            now += float(np.random.default_rng(i).uniform(0.2, 3.0))
            p = eng.plan(sig, now)
            out.append((None if p is None else p.to_dict(), eng.current(), eng.revision))
    assert got == want
    assert any(p is not None for p, _c, _r in got)


def test_config_scaled_and_plan_schema_match_the_reference():
    for seed in range(3):
        a, b = _config("port", seed).scaled(10.0), _config("ref", seed).scaled(10.0)
        assert asdict(a) == asdict(b)
    assert plan.PLAN_SCHEMA == jax_plan.PLAN_SCHEMA
    p = plan.ScalePlan(revision=3, workers=4, prefill=1, router_shards=2, reason="r")
    assert p.to_dict() == jax_plan.ScalePlan(**p.to_dict()).to_dict()
    assert p.counts() == (4, 1, 2)


def _metric_stream(seed: int, n: int = 120) -> list[tuple[float, dict]]:
    """(clock, ForwardPassMetrics fields) from 6 workers, some going quiet."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.uniform(0.01, 0.4))
        w = int(rng.integers(1, 7))
        if w == 6 and i > n // 2:
            continue  # worker 6 stops reporting halfway
        out.append((t, {"worker_id": w, "running_requests": int(rng.integers(0, 9)),
                        "waiting_requests": int(rng.integers(0, 5)),
                        "prefill_tokens_queued": int(rng.integers(0, 4000)),
                        "active_kv_blocks": int(rng.integers(0, 100)),
                        "total_kv_blocks": 128, "step_time_ms": float(rng.uniform(1, 30))}))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_fleet_telemetry_matches_the_reference(seed):
    got, want = [], []
    for pkg, out in (("port", got), ("ref", want)):
        clock = [0.0]
        tel = PKGS[pkg][1].FleetTelemetry(None, "ns/backend", stale_after_s=1.0,
                                          clock=lambda c=clock: c[0])
        for i, (t, fields) in enumerate(_metric_stream(seed)):
            clock[0] = t
            tel.ingest(PKGS[pkg][4](**fields))
            if i % 10 == 3:
                tel.set_quarantined({fields["worker_id"], 99} if i % 20 == 3 else set())
            if i % 3 == 0:
                out.append((asdict(tel.signal()), sorted(tel.quarantined())))
    assert got == want
    assert telemetry.FleetTelemetry(None, "ns/backend").subject == (
        jax_telemetry.FleetTelemetry(None, "ns/backend").subject)


async def test_fleet_telemetry_consumes_the_hub_subject():
    """start(): ForwardPassMetrics published on kv_metrics.{component} land
    in the signal; a malformed payload is dropped; close() ends the task."""
    from dynamo_tpu_torch.kv_router.protocols import KV_METRICS_SUBJECT

    hub = InMemoryHub()
    tel = telemetry.FleetTelemetry(hub, "ns/backend", stale_after_s=30.0).start()
    await asyncio.sleep(0.05)
    subject = KV_METRICS_SUBJECT.format(component="ns/backend")
    await hub.publish(subject, ForwardPassMetrics(worker_id=1, running_requests=3,
                                                  waiting_requests=1).to_dict())
    await hub.publish(subject, None)  # malformed: dropped
    await hub.publish(subject, ForwardPassMetrics(worker_id=2, running_requests=2,
                                                  prefill_tokens_queued=64).to_dict())
    t0 = time.monotonic()
    while tel.signal().workers_observed < 2:
        assert time.monotonic() - t0 < 5
        await asyncio.sleep(0.01)
    sig = tel.signal()
    assert (sig.demand, sig.prefill_queue_tokens, sig.workers_observed) == (6.0, 64.0, 2)
    await tel.close()
    await hub.close()


class _LagBackend:
    """An actuator that converges ``lag`` ticks after each plan."""

    def __init__(self, lag: int):
        self.lag = lag
        self.applied: list = []
        self._target = (1, 0, 1)
        self._pending: list = []

    async def apply(self, p) -> None:
        self.applied.append(p.counts())
        self._pending = [self._target] * self.lag + [p.counts()]

    async def observed(self):
        if self._pending:
            self._target = self._pending.pop(0)
        return self._target


@pytest.mark.parametrize("seed", range(4))
async def test_controller_matches_the_reference(seed):
    got = {}
    for pkg in ("port", "ref"):
        p, t, c, _b, fpm = PKGS[pkg]
        clock = [0.0]
        tel = t.FleetTelemetry(None, "ns/c", stale_after_s=1e9, clock=lambda: clock[0])
        be = _LagBackend(lag=seed % 3)
        ctl = c.AutoscaleController(_config(pkg, seed), tel, be, initial_workers=1,
                                    clock=lambda: clock[0])
        plans = []
        for i, sig in enumerate(_signals(pkg, seed, 60)):
            tel.ingest(fpm(worker_id=1 + i % 3, running_requests=int(sig.demand) // 3,
                           waiting_requests=int(sig.demand) % 3,
                           prefill_tokens_queued=int(sig.prefill_queue_tokens)))
            tel.set_quarantined(range(sig.quarantined_workers))
            out = await ctl.tick()
            plans.append(None if out is None else out.to_dict())
            clock[0] += 1.0
        got[pkg] = (plans, be.applied, ctl.converge_ticks, ctl.forecast_errors, ctl.report())
    assert got["port"] == got["ref"]
    assert got["port"][1], "the demand wave must emit plans"


async def test_controller_run_loop_ticks_and_closes():
    clock = [0.0]
    tel = telemetry.FleetTelemetry(None, "ns/c", stale_after_s=1e9, clock=lambda: clock[0])
    tel.ingest(ForwardPassMetrics(worker_id=1, running_requests=40))
    cfg = plan.AutoscalerConfig(tick_interval_s=0.02, up_cooldown_s=0.0)
    be = _LagBackend(0)
    ctl = controller.AutoscaleController(cfg, tel, be).start()
    t0 = time.monotonic()
    while not be.applied:
        assert time.monotonic() - t0 < 5
        await asyncio.sleep(0.01)
    await ctl.close()
    assert be.applied[0][0] > 1 and not ctl.report()["unconverged"]


async def _k8s_story(pkg: str) -> list:
    from dynamo_tpu.operator import graph as jax_graph
    from dynamo_tpu_torch.operator import graph

    g = graph if pkg == "port" else jax_graph
    p, b = PKGS[pkg][0], PKGS[pkg][3]
    hub = InMemoryHub()
    out = []
    be = b.K8sBackend(hub, "ns", dgd_name="g", model="m")
    out.append(("no status", await be.observed()))
    await be.apply(p.ScalePlan(revision=1, workers=3, prefill=1, router_shards=2))
    out.append(("no dgd", await hub.get("v1/planner/ns/desired")))
    out[-1][1].pop("updated_at")
    out.append(("desired only", await be.observed()))
    await g.DynamoGraphDeployment(name="g", namespace="ns", services=[
        g.ServiceSpec(name="decode", replicas=1, command=["-m", "d"], role="decode"),
        g.ServiceSpec(name="prefill", replicas=1, command=["-m", "p"], role="prefill"),
        g.ServiceSpec(name="router", replicas=1, command=["-m", "r"], role="router"),
        g.ServiceSpec(name="frontend", replicas=1, command=["-m", "f"]),
    ]).apply(hub)
    await be.apply(p.ScalePlan(revision=2, workers=4, prefill=2, router_shards=3))
    await be.apply(p.ScalePlan(revision=3, workers=4, prefill=2, router_shards=3))
    dgd = await g.DynamoGraphDeployment.get(hub, "g")
    out.append(("dgd", dgd.to_dict()))
    await hub.put(g.DGD_STATUS_KEY.format(name="g"), {"revision": dgd.revision, "services": {
        "decode": {"desired": 4, "ready": 3}, "prefill": {"desired": 2, "ready": 2},
        "router": {"desired": 3, "ready": 1}, "frontend": {"desired": 1, "ready": 1}}})
    out.append(("status", await be.observed()))
    out.append(("no name", await b.K8sBackend(hub, "ns").observed()))
    return out


async def test_k8s_backend_matches_the_reference():
    mine = await _k8s_story("port")
    assert mine == await _k8s_story("ref")
    assert dict(mine)["status"] == (3, 2, 1)


async def test_sim_backend_matches_the_reference():
    class Worker:
        def __init__(self, fleet):
            self.fleet = fleet

        async def drain(self):
            self.fleet.workers.remove(self)

    class Fleet:
        def __init__(self):
            self.workers = [Worker(self)]

        def alive_workers(self):
            return list(self.workers)

        async def launch_worker(self):
            self.workers.append(Worker(self))

    got = {}
    for pkg in ("port", "ref"):
        p, b = PKGS[pkg][0], PKGS[pkg][3]
        be = b.SimBackend(Fleet())
        seen = []
        for rev, (w, pf, sh) in enumerate([(3, 1, 1), (5, 0, 2), (2, 2, 1), (2, 2, 1)]):
            await be.apply(p.ScalePlan(revision=rev, workers=w, prefill=pf, router_shards=sh))
            seen.append((await be.observed(), be.spawned, be.drained))
        got[pkg] = seen
    assert got["port"] == got["ref"]
    # the same plans against each package's sim MockFleet: mock workers
    # launched and drained through the runtime
    from dynamo_tpu.sim import harness as jax_harness
    from dynamo_tpu_torch.sim import harness

    fleets = {}
    for pkg, mod in (("port", harness), ("ref", jax_harness)):
        p, b = PKGS[pkg][0], PKGS[pkg][3]
        fleet = await mod.MockFleet(mod.SimConfig(workers=1, speedup=1000.0), 1).start()
        try:
            be = b.SimBackend(fleet)
            seen = []
            for rev, (w, pf, sh) in enumerate([(3, 1, 1), (5, 0, 2), (2, 2, 1), (2, 2, 1)]):
                await be.apply(p.ScalePlan(revision=rev, workers=w, prefill=pf,
                                           router_shards=sh))
                seen.append((await be.observed(), be.spawned, be.drained,
                             len(await fleet.hub.get_prefix("v1/instances/"))))
            fleets[pkg] = seen
        finally:
            await fleet.close()
    assert fleets["port"] == fleets["ref"]
    assert [s[0][0] for s in fleets["port"]] == [3, 5, 2, 2]
    assert [s[3] for s in fleets["port"]] == [3, 5, 2, 2]


def _samples(text: str) -> dict:
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for fam in text_string_to_metric_families(text) for s in fam.samples}


def test_metrics_render_the_reference_series():
    for mod in (metrics, jax_metrics):
        mod.PLAN_REVISIONS.inc()
        mod.ACTUATION_SECONDS.observe(0.25)
        mod.REPLICAS_DESIRED.labels("workers").set(3)
        mod.REPLICAS_ACTUAL.labels("workers").set(2)
        mod.PREDICTOR_ERROR.set(-1.5)
        mod.CONVERGENCE_TICKS.set(4)
    from prometheus_client import generate_latest

    mine = _samples(metrics._REG.render())
    ref = _samples(generate_latest(jax_metrics._REG.registry).decode())
    ref = {k: v for k, v in ref.items() if not k[0].endswith("_created")}
    # the same series; each package's values are its own (other tests of
    # this process may have moved either registry)
    assert mine.keys() == ref.keys()
    assert mine[("dynamo_autoscaler_replicas_desired", (("dimension", "workers"),))] == 3


async def test_live_loop_signal_from_mock_workers_converged_by_the_operator():
    """Port mock workers publish their own ForwardPassMetrics; streams held
    open on them make demand; the controller's K8sBackend writes the plan to
    the planner key and the port's Reconciler converges a recording backend
    to it (status ready = the plan)."""
    from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
    from dynamo_tpu_torch.mocker.engine import MockEngineConfig
    from dynamo_tpu_torch.operator import controller as op_controller
    from dynamo_tpu_torch.operator import graph
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    drt = DistributedRuntime(InMemoryHub())
    engines = []
    for i in range(2):
        eng, _ = await launch_mock_worker(
            drt, "dynamo", "backend", "generate",
            MockEngineConfig(block_size=4, total_kv_blocks=512, speedup_ratio=2.0, seed=i),
            model_name="m")
        engines.append(eng)

    class Live:
        def __init__(self):
            self.live = {}

        def running(self, name):
            return self.live.get(name, 0)

        async def scale(self, spec, n):
            self.live[spec.name] = n

        async def close(self):
            pass

    op_be = Live()
    await graph.DynamoGraphDeployment(name="g", services=[graph.ServiceSpec(
        name="decode", replicas=2, command=["-m", "d"], role="decode")]).apply(drt.hub)
    rec = await op_controller.Reconciler(drt.hub, "g", op_be, interval_s=0.05).start()
    tel = telemetry.FleetTelemetry(drt.hub, "dynamo/backend", stale_after_s=5.0).start()
    cfg = plan.AutoscalerConfig(slots_per_worker=2, target_occupancy=1.0, up_cooldown_s=0.0,
                                max_workers=8)
    ctl = controller.AutoscaleController(cfg, tel, backends.K8sBackend(
        drt.hub, "dynamo", dgd_name="g"), initial_workers=2)
    req = {"token_ids": list(range(24)),
           "stop_conditions": {"max_tokens": 400, "ignore_eos": True}}

    async def stream(eng):
        async for _ in eng.generate(dict(req), Context()):
            pass

    tasks = [asyncio.create_task(stream(engines[i % 2])) for i in range(10)]
    try:
        t0 = time.monotonic()
        while tel.signal().demand < 10:
            assert time.monotonic() - t0 < 10, tel.signal()
            await asyncio.sleep(0.05)
        sig = tel.signal()
        assert sig.workers_observed == 2
        p = await ctl.tick()
        assert p is not None and p.workers == 5, (sig, p)
        while op_be.running("decode") != 5 or ctl._converging is not None:
            assert time.monotonic() - t0 < 10, (op_be.live, ctl.report())
            await asyncio.sleep(0.05)
            await ctl._track_convergence()
        assert ctl.report()["converge_ticks_max"] >= 1
    finally:
        for t in tasks:
            t.cancel()
        await tel.close()
        await rec.close()
        for eng in engines:
            for pub in (eng.events, eng.metrics):
                await pub.close()
        await drt.close()
