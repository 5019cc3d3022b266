"""Sim harness: fleet/cluster building blocks + artifact plumbing (the
counterpart of dynamo_tpu/sim/harness.py).

Everything here composes REAL components — ``MockEngine`` workers served
through the real ``DistributedRuntime`` endpoint plumbing (so the KV
router sees real KV events and worker metrics), in-process and
subprocess ``HubReplica`` quorum clusters, and the Migration-wrapped
client path the frontend uses — the scenarios in ``scenarios.py`` only
script traffic and chaos on top.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import signal
import subprocess
import time
from dataclasses import asdict, dataclass
from pathlib import Path

from dynamo_tpu_torch.frontend.migration import STATS as MIGRATION_STATS
from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.kv_router.publisher import (
    KvEventPublisher,
    WorkerMetricsPublisher,
)
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineConfig
from dynamo_tpu_torch.runtime.context import StreamError
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.hub_replica import HubReplica
from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode
from dynamo_tpu_torch.sim import cluster as hubctl

log = logging.getLogger("dynamo_tpu.sim")

NS, COMP, EP = "sim", "mock", "generate"


@dataclass
class SimConfig:
    """One knob set for a whole sim run; scenarios read what they need.
    Defaults are the full-matrix (nightly) scale; the smoke in
    tests/test_torch_sim.py shrinks everything."""

    workers: int = 200
    speedup: float = 150.0  # time dilation: simulated s per wall s
    block_size: int = 16
    worker_blocks: int = 2048
    max_batch_size: int = 8
    seed: int = 0
    # pick_scaling: fleet sizes for the saturation curve (empty =
    # derived: workers/4, workers/2, workers)
    fleet_sizes: tuple = ()
    picks: int = 400
    pick_concurrency: int = 8
    # hub scenarios
    replicas: int = 3
    lease_s: float = 0.5
    commit_timeout_s: float = 1.5
    storm_writers: int = 8
    storm_duration_s: float = 8.0
    partition_window_s: float = 3.0
    # churn / storms
    trace_requests: int = 0  # 0 = 2 * workers
    trace_rate_per_s: float = 0.0  # 0 = workers * 10 req/s (wall)
    churn_waves: int = 3
    churn_kill_frac: float = 0.12
    osl: int = 8
    # tenant storm SLO: contended interactive TTFT p99 must stay under
    # max(slo_ttft_factor * uncontended p50, slo_ttft_floor_s)
    slo_ttft_factor: float = 4.0
    slo_ttft_floor_s: float = 0.25
    # autoscale scenario: diurnal wave + flash spike against the closed
    # autoscaler loop. The scenario builds its OWN small fleets (slow
    # engines so concurrency is visible demand), so these knobs are
    # independent of the churn-scale ones above.
    autoscale_duration_s: float = 12.0
    autoscale_base_rate: float = 12.0  # wall req/s at the trough
    autoscale_peak_rate: float = 40.0  # diurnal crest
    autoscale_spike_factor: float = 10.0  # flash spike = factor * base
    autoscale_tick_s: float = 0.3  # controller cadence (wall)
    autoscale_lead_ticks: int = 3  # predictive pass forecast horizon
    autoscale_start_workers: int = 2
    autoscale_max_workers: int = 24
    autoscale_slots: int = 2  # decode slots per worker
    autoscale_speedup: float = 5.0
    autoscale_osl: int = 40
    autoscale_slo_ttft_s: float = 0.75  # wall TTFT p99 bar
    autoscale_compare: bool = True  # also run the reactive baseline
    # worker ForwardPassMetrics publish cadence (wall s); the gray
    # scenario shrinks it so degradation fingerprints propagate fast
    # enough to meet its dilated detection budget
    metrics_interval_s: float = 0.25
    # gray_failure scenario: one worker degraded to ``gray_slowdown``x
    # step time via a sticky per-instance delay fault must be detected
    # peer-relatively, quarantined within ``gray_detect_budget_s``
    # DILATED seconds, excluded by routers, replaced by the autoscaler,
    # and re-admitted after it heals — with zero client-visible errors.
    # Builds its OWN small, mildly-dilated fleet (like autoscale).
    gray_workers: int = 6
    gray_speedup: float = 5.0
    gray_slowdown: float = 10.0
    gray_requests: int = 36  # per traffic phase (baseline / degraded / after)
    gray_rate_per_s: float = 40.0
    gray_osl: int = 6
    gray_detect_budget_s: float = 5.0  # dilated seconds
    data_dir: str | None = None  # replica WALs; None = tempdir

    def trace_n(self) -> int:
        return self.trace_requests or 2 * self.workers

    def trace_rate(self) -> float:
        # wall req/s; the DILATED rate (x speedup) is what the artifact
        # reports — at the default dilation the achieved replay clears
        # 100k req/s dilated even where the single replay loop binds
        return self.trace_rate_per_s or self.workers * 10.0

    def sizes(self) -> list[int]:
        if self.fleet_sizes:
            return sorted(set(int(s) for s in self.fleet_sizes))
        w = self.workers
        return sorted({max(w // 4, 2), max(w // 2, 4), w})


# -- mock worker fleet -------------------------------------------------------


class SimWorker:
    """One mock worker with a power switch: ``kill()`` makes in-flight
    streams die exactly like a cut connection (StreamError at the next
    item — the transport's peer-vanished contract, which the migration
    operator retries) and withdraws the instance registration."""

    def __init__(self, fleet: "MockFleet", engine: MockEngine):
        self.fleet = fleet
        self.engine = engine
        self.alive = True
        self.served = None
        self.events: KvEventPublisher | None = None
        self.metrics: WorkerMetricsPublisher | None = None
        # gray-failure state: a quarantined worker is ALIVE (card stays
        # in the hub, flagged) but cuts its in-flight streams so the
        # migration operator re-drives them on healthy peers
        self.quarantined = False
        self.served_requests = 0

    @property
    def wid(self) -> int:
        return self.served.instance.instance_id if self.served else 0

    @property
    def fault_instance(self) -> str:
        """Identity this worker presents to ``~instance``-scoped faults."""
        return self.engine.config.fault_instance

    def handler(self):
        async def _serve(request, context):
            if not self.alive:
                raise StreamError(f"sim worker {self.wid:x} is dead")
            self.served_requests += 1
            async for item in self.engine.generate(request, context):
                if not self.alive:
                    raise StreamError(
                        f"sim worker {self.wid:x} killed mid-stream"
                    )
                if self.quarantined:
                    # proactive migration off gray capacity: the stream
                    # dies with the peer-vanished contract the migration
                    # operator already re-drives
                    raise StreamError(
                        f"sim worker {self.wid:x} quarantined mid-stream"
                    )
                yield item
        return _serve

    async def kill(self) -> None:
        """SIGKILL-shaped: no drain, no dying KV events — the fleet's
        router keeps stale radix state exactly as it would for a real
        crashed worker until instance reconciliation prunes it."""
        self.alive = False
        if self.events is not None:
            await self.events.close()
        if self.metrics is not None:
            await self.metrics.close()
        # drain=False: a crash does not get the withdraw grace — the
        # handler vanishes with the key, exactly like a dead process
        await self.fleet.drt.deregister_endpoint(self.served, drain=False)

    async def drain(self, timeout_s: float = 10.0) -> None:
        """SIGTERM-shaped scale-down: withdraw the instance key FIRST
        (routers stop picking; racing picks still land on the live
        handler through the withdraw grace), then wait for in-flight
        streams to finish before tearing the worker down — the sim twin
        of the worker drain contract (zero client-visible errors)."""
        await self.fleet.drt.deregister_endpoint(self.served, drain=True)
        deadline = time.monotonic() + timeout_s
        while self.engine._running > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        self.alive = False
        if self.events is not None:
            await self.events.close()
        if self.metrics is not None:
            await self.metrics.close()


class MockFleet:
    """N time-dilated mock workers on one DistributedRuntime, with kill
    and rejoin waves for churn scenarios."""

    def __init__(self, cfg: SimConfig, n: int, *, hub=None, seed: int = 0):
        self.cfg = cfg
        self.n = n
        self.hub = hub or InMemoryHub()
        self.drt = DistributedRuntime(self.hub)
        self.workers: list[SimWorker] = []
        self.launched = 0
        self.rng = random.Random(seed or cfg.seed)
        self._push: PushRouter | None = None
        self._kv: KvRouter | None = None

    async def start(self) -> "MockFleet":
        for _ in range(self.n):
            await self.launch_worker()
        return self

    async def launch_worker(self) -> SimWorker:
        i = self.launched
        self.launched += 1
        engine = MockEngine(MockEngineConfig(
            block_size=self.cfg.block_size,
            total_kv_blocks=self.cfg.worker_blocks,
            max_batch_size=self.cfg.max_batch_size,
            speedup_ratio=self.cfg.speedup,
            seed=self.cfg.seed * 100003 + i,
            # per-worker fault identity: many sim workers share one
            # process (one FAULTS registry), so ~instance-scoped rules
            # (the sticky gray-failure straggler) need each engine to
            # say who it is on every fire
            fault_instance=f"sim-w{i}",
        ))
        w = SimWorker(self, engine)
        ep = self.drt.namespace(NS).component(COMP).endpoint(EP)
        w.served = await ep.serve(
            w.handler(),
            metadata={"model": "sim-model", "engine": "mocker"},
        )
        comp_path = f"{NS}/{COMP}"
        w.events = KvEventPublisher(self.drt.hub, comp_path, w.wid).start()
        w.metrics = WorkerMetricsPublisher(
            self.drt.hub, comp_path, w.wid,
            interval_s=self.cfg.metrics_interval_s,
        ).start()
        engine.events = w.events
        engine.metrics = w.metrics
        engine._publish_metrics()
        self.workers.append(w)
        return w

    def alive_workers(self) -> list[SimWorker]:
        return [w for w in self.workers if w.alive]

    async def kill_wave(
        self, k: int, wait_busy_s: float = 2.0
    ) -> list[SimWorker]:
        """Kill up to ``k`` workers, catching BUSY ones in the act: at
        heavy time dilation a request lives for ~ms, so a wave that
        picks victims blindly almost never cuts an in-flight stream —
        and cutting streams (so migration re-drives them) is the point.
        Polls for workers with running requests and flips their power
        switch mid-flight; falls back to idle victims at the deadline."""
        victims: list[SimWorker] = []
        deadline = time.monotonic() + wait_busy_s
        while len(victims) < k and time.monotonic() < deadline:
            alive = self.alive_workers()
            if len(alive) <= 1:
                break
            busy = [
                w for w in alive
                if w.engine._running > 0 and w not in victims
            ]
            if busy:
                w = self.rng.choice(busy)
                w.alive = False  # streams on it die at the next item
                victims.append(w)
                await w.kill()
            else:
                await asyncio.sleep(0.001)
        idle = [w for w in self.alive_workers() if w not in victims]
        self.rng.shuffle(idle)
        while len(victims) < k and len(idle) > 1:
            w = idle.pop()
            victims.append(w)
            await w.kill()
        return victims

    async def rejoin_wave(self, k: int) -> None:
        # thundering-herd shape on purpose: all replacements register at
        # once (hub put + event/metrics stream (re)subscription each)
        await asyncio.gather(*(self.launch_worker() for _ in range(k)))

    async def quarantine_worker(self, w: SimWorker, reason: str) -> None:
        """Soft-withdraw a gray worker: its instance card stays in the
        hub flagged ``quarantined`` (routers exclude it through the
        exclude= fail-open path, the autoscaler counts it as zero
        capacity), and its in-flight streams are cut so the migration
        operator re-drives them on healthy peers."""
        from dynamo_tpu_torch.runtime.health import count_quarantine, quarantined_card

        w.quarantined = True
        count_quarantine(reason)
        card = quarantined_card(w.served.instance, reason)
        # plain put (no lease arg): the key keeps its existing binding to
        # the worker's lease, so worker death still removes the card
        await self.drt.hub.put(card.path, card.to_dict())

    async def readmit_worker(self, w: SimWorker) -> None:
        """Lift a quarantine: republish the clean card; routers pick the
        worker again and the autoscaler's replacement overlay unwinds."""
        from dynamo_tpu_torch.runtime.health import admitted_card

        w.quarantined = False
        card = admitted_card(w.served.instance)
        await self.drt.hub.put(card.path, card.to_dict())

    async def client_path(
        self, *, migration: bool = True, **mig_kwargs
    ):
        """The frontend's serving path, minus HTTP: KV-aware routing
        wrapped in the migration operator. Returns (engine-like, parts)
        where parts need closing via ``close_client``."""
        ep = self.drt.namespace(NS).component(COMP).endpoint(EP)
        self._push = await PushRouter.from_endpoint(ep, RouterMode.DIRECT)
        await self._push.client.wait_for_instances(
            len(self.alive_workers()), timeout=15
        )
        self._kv = await KvRouter(
            self.drt.hub, f"{NS}/{COMP}",
            RouterConfig(block_size=self.cfg.block_size),
        ).start()
        engine = KvPushRouter(self._push, self._kv)
        if migration:
            mig_kwargs.setdefault("migration_limit", 6)
            mig_kwargs.setdefault("retry_budget_s", 15.0)
            mig_kwargs.setdefault("retry_delay_s", 0.05)
            engine = Migration(engine, **mig_kwargs)
        return engine

    @property
    def kv_router(self) -> KvRouter | None:
        return self._kv

    async def close(self) -> None:
        if self._kv is not None:
            await self._kv.close()
        if self._push is not None:
            await self._push.client.close()
        for w in self.alive_workers():
            if w.events is not None:
                await w.events.close()
            if w.metrics is not None:
                await w.metrics.close()
        await self.drt.close()


def migrations_snapshot() -> int:
    return MIGRATION_STATS["migrations"]


# -- hub replica clusters ----------------------------------------------------


class ReplicaCluster:
    """In-process quorum cluster (HubReplica objects): fast to start,
    partitionable live via ``FAULTS.configure`` (the partition site is
    consulted inside this process's replica links)."""

    def __init__(self, cfg: SimConfig, base_dir: Path):
        self.cfg = cfg
        self.base = Path(base_dir)
        self.reps: list[HubReplica] = []
        self.addrs: list[str] = []

    async def start(self) -> "ReplicaCluster":
        ports = sorted(hubctl.free_port() for _ in range(self.cfg.replicas))
        self.addrs = [f"127.0.0.1:{p}" for p in ports]
        peers = ",".join(self.addrs)
        self.reps = [
            HubReplica(
                "127.0.0.1", p, peers, self.base / f"replica{i}",
                lease_s=self.cfg.lease_s,
                commit_timeout_s=self.cfg.commit_timeout_s,
            )
            for i, p in enumerate(ports)
        ]
        for r in self.reps:
            await r.start()
        return self

    async def wait_leader(self, timeout: float = 20.0) -> HubReplica:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            live = [r for r in self.reps if not r._stopping]
            leaders = [r for r in live if r.hub.role == "leader"]
            if len(leaders) == 1 and all(
                r.leader_addr == leaders[0].advertise for r in live
            ):
                return leaders[0]
            await asyncio.sleep(0.02)
        raise AssertionError(
            f"no single leader: "
            f"{[(r.advertise, r.hub.role) for r in self.reps]}"
        )

    def data_dirs(self) -> list[Path]:
        return [r.hub.store.dir for r in self.reps]

    async def stop_all(self) -> None:
        for r in self.reps:
            await r.stop()


class ProcReplicaCluster:
    """Subprocess quorum cluster (``python -m
    dynamo_tpu_torch.runtime.hub_replica``): the leader can be SIGKILLed for
    real, the kill -9 mid-commit-storm scenario."""

    def __init__(self, cfg: SimConfig, base_dir: Path):
        self.cfg = cfg
        self.base = Path(base_dir)
        self.addrs: list[str] = []
        self.procs: dict[str, object] = {}
        self.dirs: dict[str, Path] = {}

    async def start(self) -> "ProcReplicaCluster":
        ports = sorted(hubctl.free_port() for _ in range(self.cfg.replicas))
        self.addrs = [f"127.0.0.1:{p}" for p in ports]
        peers = ",".join(self.addrs)
        for i, a in enumerate(self.addrs):
            d = self.base / f"rep{i}"
            self.dirs[a] = d
            self.procs[a] = await asyncio.to_thread(
                hubctl.spawn_replica, a, peers, str(d), self.cfg.lease_s
            )
        return self

    async def find_leader(self, timeout: float = 20.0) -> str:
        return await hubctl.find_leader(self.addrs, timeout)

    def sigkill(self, addr: str) -> None:
        self.procs[addr].send_signal(signal.SIGKILL)

    def terminate_all(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=10)
            # last-resort teardown: a replica that ignores SIGTERM for 10 s
            # is SIGKILLed (its WAL is read post-mortem either way)
            except subprocess.TimeoutExpired:
                p.kill()

    def data_dirs(self) -> list[Path]:
        return [self.dirs[a] for a in self.addrs]


# -- telemetry overhead micro-measure ---------------------------------------


def telemetry_overhead(cfg: SimConfig, iters: int = 4000) -> dict:
    """Span/metric emission cost as a fraction of a (dilated) engine
    step: does observability load the fleet down? Measures the real emit
    paths, a catalogued ``tracing.span`` (epp.pick, the hot control-plane
    span) and a labelled counter inc."""
    from dynamo_tpu_torch.runtime import tracing
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    t0 = time.perf_counter()
    for _ in range(iters):
        with tracing.span("epp.pick"):
            pass
    span_s = (time.perf_counter() - t0) / iters

    reg = MetricsRegistry()
    # a throwaway probe counter on a private registry, never exported
    ctr = reg.counter("sim_overhead_probe_total", "sim micro-bench", ["k"])
    t0 = time.perf_counter()
    for _ in range(iters):
        ctr.labels("x").inc()
    ctr_s = (time.perf_counter() - t0) / iters

    dilated_step_s = MockEngineConfig().decode_step_s / max(cfg.speedup, 1e-9)
    # a serving step emits ~1 span-equivalent + ~4 counter/gauge updates
    per_step = span_s + 4 * ctr_s
    return {
        "span_emit_us": round(span_s * 1e6, 3),
        "counter_inc_us": round(ctr_s * 1e6, 3),
        "dilated_step_us": round(dilated_step_s * 1e6, 3),
        "emission_frac_of_step": round(per_step / dilated_step_s, 4),
        # the undilated fraction is what a REAL worker pays (step time
        # not shrunk by speedup): the honest production number
        "emission_frac_of_real_step": round(
            per_step / MockEngineConfig().decode_step_s, 6
        ),
    }


# -- orchestration + artifact ------------------------------------------------


async def run_scenarios(
    cfg: SimConfig, names: list[str]
) -> dict:
    """Run the named scenarios sequentially; AssertionError = a failed
    invariant (verdict fail with the reason), any other exception is a
    harness error (verdict error). Returns the artifact dict."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.sim.scenarios import SCENARIOS

    # one run-scoped scratch dir for every scenario's WALs and traces
    # (kept on a failing run for post-mortem, removed on pass) — per-
    # scenario mkdtemps would accumulate in /tmp across nightlies
    own_scratch = not cfg.data_dir
    if own_scratch:
        cfg.data_dir = tempfile.mkdtemp(prefix="dynamo-sim-")
    artifact: dict = {
        "schema": "dynamo-sim/v1",
        "config": asdict(cfg),
        "scenarios": {},
    }
    for name in names:
        fn = SCENARIOS[name]
        log.warning("sim scenario %s starting", name)
        t0 = time.monotonic()
        try:
            out = await fn(cfg)
            out.setdefault("verdict", _verdict(out))
        except AssertionError as e:
            out = {"verdict": "fail", "reason": str(e)}
        except Exception as e:  # noqa: BLE001 — harness error != invariant fail
            log.exception("sim scenario %s errored", name)
            out = {"verdict": "error", "reason": f"{type(e).__name__}: {e}"}
        out["wall_s"] = round(time.monotonic() - t0, 2)
        artifact["scenarios"][name] = out
        log.warning(
            "sim scenario %s: %s (%.1fs)", name, out["verdict"], out["wall_s"]
        )
    artifact["verdict"] = (
        "pass"
        if all(
            s["verdict"] == "pass" for s in artifact["scenarios"].values()
        )
        else "fail"
    )
    if own_scratch:
        if artifact["verdict"] == "pass":
            shutil.rmtree(cfg.data_dir, ignore_errors=True)
        else:
            log.warning(
                "sim scratch kept for post-mortem: %s", cfg.data_dir
            )
    return artifact


def _verdict(out: dict) -> str:
    inv = out.get("invariants") or {}
    ok = all(
        (v.get("pass") if isinstance(v, dict) else bool(v))
        for v in inv.values()
    )
    return "pass" if ok else "fail"


def write_artifact(artifact: dict, path: str) -> None:
    Path(path).write_text(json.dumps(artifact, indent=1, default=str) + "\n")
    log.warning("sim artifact written to %s", path)
