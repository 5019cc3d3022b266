"""Health subsystem: canary probes, readiness state, status server, engine
watchdog — and the gray-failure plane (degradation scoring, SDC canaries,
quarantine-and-replace).

Reference parity:
  - HealthCheckManager (lib/runtime/src/health_check.rs:44-353): periodic
    canary requests THROUGH the real endpoint transport with a
    configurable payload; consecutive failures flip the endpoint
    unhealthy.
  - system_status_server.rs: /live /ready /health (+ /metrics) on a
    dedicated port.
  - engine-death watchdog (components/src/dynamo/vllm/engine_monitor.py):
    a dead engine loop deregisters the worker and shuts the runtime down.

Twist: an unhealthy endpoint's instance key is WITHDRAWN
from the hub (lease kept alive), so routers drop it immediately — the
same effect the reference gets from lease-expiry, but without waiting out
the TTL; recovery re-publishes the key.

Beyond the reference (gray failures — degraded-but-alive capacity):

  - **SDC canaries**: the canary is a known-answer test, not just a
    liveness ping. A pinned greedy decode's tokens are compared against a
    golden recorded at the endpoint's first clean canary; any later
    mismatch is a silent-data-corruption verdict — immediate QUARANTINE,
    no failure-threshold grace (a chip that flips bits once will flip
    them again). ``readmit_threshold`` consecutive clean canaries
    re-admit.
  - **Quarantine** is soft-withdrawal: the instance card stays in the hub
    with ``metadata.state = "quarantined"`` (+ reason), so routers
    exclude it through their existing exclude= fail-open path while the
    autoscaler still SEES it (counts it as zero capacity and spawns a
    replacement) — unlike the fail-stop delete above, which makes the
    worker invisible to both.
  - **DegradationDetector**: fleet-side peer-relative outlier scoring
    over the ``step_time_ms`` fingerprint workers publish in
    ForwardPassMetrics. score = EWMA(step_time / fleet median); no
    absolute threshold to mistune, so a 10x-slow straggler is flagged
    within a few observations on any hardware generation, real or
    time-dilated sim.

A copy of ``dynamo_tpu/runtime/health.py``. The status server runs on
``frontend/http_server.py`` (the reference's runs on aiohttp), with the
reference's routes, statuses and bodies.
"""

from __future__ import annotations

import asyncio
import logging
import statistics
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.integrity import corrupt_token_ids
from dynamo_tpu_torch.runtime.transport import InstanceChannel, call_local

log = logging.getLogger("dynamo_tpu_torch.health")

DEFAULT_CANARY = {
    "token_ids": [1],
    "stop_conditions": {"max_tokens": 1, "ignore_eos": True},
    "sampling": {"temperature": 0.0},
    "annotations": ["health-canary"],
}

# process-wide quarantine counters by reason (sdc | degraded | manual),
# exported on every /metrics surface as
# ``dynamo_worker_quarantines_total{reason}``
QUARANTINE_STATS: dict[str, int] = {}
_QUARANTINE_LOCK = threading.Lock()


def count_quarantine(reason: str) -> None:
    with _QUARANTINE_LOCK:
        QUARANTINE_STATS[reason] = QUARANTINE_STATS.get(reason, 0) + 1


def _quarantine_exposition() -> str:
    with _QUARANTINE_LOCK:
        snap = dict(QUARANTINE_STATS)
    if not snap:
        return ""
    lines = [
        "# HELP dynamo_worker_quarantines_total Workers soft-withdrawn "
        "by reason (sdc | degraded | manual).",
        "# TYPE dynamo_worker_quarantines_total counter",
    ]
    for reason, n in sorted(snap.items()):
        lines.append(
            f'dynamo_worker_quarantines_total{{reason="{reason}"}} {n}'
        )
    return "\n".join(lines) + "\n"


def _register_quarantine_metrics() -> None:
    from dynamo_tpu_torch.runtime import metrics

    metrics.register_global_provider("quarantine", _quarantine_exposition)


_register_quarantine_metrics()


def quarantined_card(instance, reason: str):
    """The soft-withdrawn instance card: same identity, ``metadata.state``
    flipped to "quarantined" (+ reason). Routers exclude it; the
    autoscaler counts it as zero capacity."""
    meta = dict(instance.metadata)
    meta["state"] = "quarantined"
    meta["quarantine_reason"] = reason
    return replace(instance, metadata=meta)


def admitted_card(instance):
    """The re-admitted card: quarantine metadata stripped."""
    meta = {
        k: v for k, v in instance.metadata.items()
        if k not in ("state", "quarantine_reason")
    }
    return replace(instance, metadata=meta)


def is_quarantined(instance) -> bool:
    """True for an Instance (or raw card dict) in the quarantined state."""
    meta = (
        instance.get("metadata") if isinstance(instance, dict)
        else getattr(instance, "metadata", None)
    )
    return bool(meta) and meta.get("state") == "quarantined"


class DegradationDetector:
    """Peer-relative straggler scoring over worker step-time fingerprints.

    ``observe(worker, step_time_ms)`` feeds the latest fingerprint (from
    ForwardPassMetrics); ``scores()`` returns the EWMA-smoothed ratio of
    each worker's step time to the FLEET MEDIAN. A healthy fleet scores
    ~1.0 everywhere; a thermally-throttled chip drifts to its slowdown
    factor within a few observations (alpha=0.3: >2x after 3, >5x after
    ~6 observations of a 10x straggler). No absolute threshold exists to
    mistune — hardware generation and sim time-dilation divide out.

    Guards: scoring needs ``min_peers`` reporting workers (the median of
    a tiny fleet is the straggler itself — score everything 1.0 rather
    than flag noise), and workers with no fingerprint yet (0) are
    skipped. Thread-safe; ``forget()`` drops departed workers.
    """

    def __init__(
        self,
        *,
        tolerance: float = 3.0,
        ewma_alpha: float = 0.3,
        min_peers: int = 3,
    ):
        self.tolerance = tolerance
        self.ewma_alpha = ewma_alpha
        self.min_peers = min_peers
        self._latest: dict[Any, float] = {}
        self._ewma: dict[Any, float] = {}
        self._lock = threading.Lock()

    def observe(self, worker, step_time_ms: float) -> None:
        if step_time_ms and step_time_ms > 0:
            with self._lock:
                self._latest[worker] = float(step_time_ms)

    def forget(self, worker) -> None:
        with self._lock:
            self._latest.pop(worker, None)
            self._ewma.pop(worker, None)

    def scores(self) -> dict[Any, float]:
        """Smoothed peer-relative scores; advances the EWMA one step, so
        call at a steady cadence (router tick / autoscaler tick)."""
        with self._lock:
            if len(self._latest) < self.min_peers:
                # min-sample guard: don't score a fleet too small for its
                # median to mean anything
                return {w: 1.0 for w in self._latest}
            med = statistics.median(self._latest.values())
            if med <= 0:
                return {w: 1.0 for w in self._latest}
            a = self.ewma_alpha
            out = {}
            for w, v in self._latest.items():
                raw = v / med
                prev = self._ewma.get(w)
                self._ewma[w] = raw if prev is None else a * raw + (1 - a) * prev
                out[w] = self._ewma[w]
            return out

    def degraded(self) -> list:
        """Workers whose smoothed score breaches ``tolerance`` (e.g. 3.0 =
        3x the fleet median step time)."""
        return [w for w, s in self.scores().items() if s >= self.tolerance]

    def exposition(self) -> str:
        with self._lock:
            snap = dict(self._ewma)
        if not snap:
            return ""
        lines = [
            "# HELP dynamo_worker_degradation_score Peer-relative "
            "step-time ratio (EWMA vs fleet median; 1.0 = healthy).",
            "# TYPE dynamo_worker_degradation_score gauge",
        ]
        for w, s in sorted(snap.items(), key=lambda kv: str(kv[0])):
            lines.append(
                f'dynamo_worker_degradation_score{{worker="{w}"}} {s:.4f}'
            )
        return "\n".join(lines) + "\n"

    def export_metrics(self, name: str = "degradation") -> None:
        """Publish this detector's scores on every /metrics surface."""
        from dynamo_tpu_torch.runtime import metrics

        metrics.register_global_provider(name, self.exposition)


@dataclass
class HealthCheckConfig:
    interval_s: float = 5.0
    timeout_s: float = 5.0
    failure_threshold: int = 2  # consecutive failures -> unhealthy
    # known-answer (SDC) checking: the first clean canary's tokens become
    # the golden; later mismatches quarantine IMMEDIATELY (no threshold —
    # silent corruption is not a transient), and ``readmit_threshold``
    # consecutive clean canaries lift the quarantine
    sdc_check: bool = True
    readmit_threshold: int = 3
    payload: dict[str, Any] = field(
        default_factory=lambda: dict(DEFAULT_CANARY)
    )


@dataclass
class EndpointHealth:
    path: str
    status: str = "unknown"  # unknown | ready | unhealthy | quarantined
    consecutive_failures: int = 0
    last_ok: float | None = None
    last_error: str | None = None
    probes: int = 0
    # quarantine lifecycle (SDC verdicts)
    quarantine_reason: str | None = None
    clean_streak: int = 0
    quarantines: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "path": self.path,
            "status": self.status,
            "consecutive_failures": self.consecutive_failures,
            "last_ok": self.last_ok,
            "last_error": self.last_error,
            "probes": self.probes,
            "quarantine_reason": self.quarantine_reason,
            "clean_streak": self.clean_streak,
            "quarantines": self.quarantines,
        }


@dataclass
class _ProbeEntry:
    served: Any
    health: EndpointHealth
    payload: dict
    golden: list | None = None  # known-answer tokens, set on first success


class HealthCheckManager:
    """Canary-probes served endpoints; withdraws/restores their instance
    keys in the hub as they flip unhealthy/ready."""

    def __init__(self, drt, config: HealthCheckConfig | None = None):
        self.drt = drt
        self.config = config or HealthCheckConfig()
        self._entries: list[_ProbeEntry] = []
        self._tasks: list[asyncio.Task] = []
        self._closed = False

    def register(self, served, payload: dict | None = None) -> EndpointHealth:
        """Start probing a ServedEndpoint (worker supplies the canary
        payload when the default token probe doesn't fit, ref
        vllm/main.py:199 health_check_payload)."""
        health = EndpointHealth(path=served.instance.endpoint_path)
        entry = _ProbeEntry(
            served=served, health=health,
            payload=payload or self.config.payload,
        )
        self._entries.append(entry)
        self._tasks.append(
            asyncio.get_running_loop().create_task(self._probe_loop(entry))
        )
        return health

    @property
    def statuses(self) -> list[EndpointHealth]:
        return [e.health for e in self._entries]

    @property
    def all_ready(self) -> bool:
        return bool(self._entries) and all(
            e.health.status == "ready" for e in self._entries
        )

    async def close(self) -> None:
        self._closed = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass  # we cancelled it: the expected outcome
            except Exception:  # noqa: BLE001
                # a probe loop that died of something OTHER than our
                # cancel was broken before close(): surface it
                log.warning("health probe task died unclean",
                            exc_info=True)

    # -- probing -----------------------------------------------------------

    @staticmethod
    def _check_item(item) -> None:
        """A handler reporting failure as an error item (finish_reason
        'error') is just as unhealthy as one that raises."""
        if isinstance(item, dict) and (
            item.get("finish_reason") == "error" or item.get("error")
        ):
            raise RuntimeError(f"canary error item: {item.get('error')}")

    @staticmethod
    def _fault_key(inst) -> str:
        """Identity this instance presents to ~instance-scoped faults."""
        return (
            f"{inst.host}:{inst.port}" if inst.port
            else f"{inst.instance_id:x}"
        )

    async def _canary(self, served, payload: dict) -> list:
        """One canary generate through the instance's real transport.
        Returns the first item's token ids — the known-answer material —
        after they pass the ``health.canary`` corrupt fault (the chaos
        stand-in for a chip flipping bits in the decode path)."""
        inst = served.instance
        ctx = Context(request_id=f"canary-{inst.instance_id:x}")
        toks: list = []
        if inst.transport == "local":
            handler = self.drt.local_registry.get(inst.wire_path)
            if handler is None:
                raise RuntimeError("handler not registered")
            stream = call_local(handler, payload, ctx)
            async for item in stream:
                self._check_item(item)
                toks = list(item.get("token_ids") or [])
                break
            ctx.stop_generating()
        else:
            ch = InstanceChannel(inst.host, inst.port)
            await ch.connect(self.drt.config.connect_timeout_s)
            try:
                async for item in ch.call(inst.wire_path, payload, ctx):
                    self._check_item(item)
                    toks = list(item.get("token_ids") or [])
                    break
                ctx.stop_generating()
            finally:
                await ch.close()
        return corrupt_token_ids(
            "health.canary", toks, instance=self._fault_key(inst)
        )

    async def _publish_card(self, instance) -> None:
        lease = await self.drt.lease_id()
        await self.drt.hub.put(
            instance.path, instance.to_dict(), lease_id=lease
        )

    async def _quarantine(self, served, health: EndpointHealth,
                          reason: str) -> None:
        """Soft-withdraw: the card stays in the hub, flagged quarantined —
        routers exclude it (fail-open), the autoscaler counts it as zero
        capacity and spawns a replacement."""
        health.status = "quarantined"
        health.quarantine_reason = reason
        health.clean_streak = 0
        health.quarantines += 1
        count_quarantine(reason)
        log.warning(
            "endpoint %s QUARANTINED (%s); soft-withdrawing instance %x",
            health.path, reason, served.instance.instance_id,
        )
        await self._publish_card(quarantined_card(served.instance, reason))

    async def _readmit(self, served, health: EndpointHealth) -> None:
        log.info(
            "endpoint %s re-admitted after %d clean canaries; "
            "re-publishing instance %x",
            health.path, health.clean_streak, served.instance.instance_id,
        )
        health.quarantine_reason = None
        health.clean_streak = 0
        await self._publish_card(admitted_card(served.instance))

    async def _probe_loop(self, entry: _ProbeEntry) -> None:
        served, health, payload = entry.served, entry.health, entry.payload
        cfg = self.config
        while not self._closed:
            await asyncio.sleep(cfg.interval_s)
            health.probes += 1
            try:
                toks = await asyncio.wait_for(
                    self._canary(served, payload), cfg.timeout_s
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                health.consecutive_failures += 1
                health.last_error = f"{type(e).__name__}: {e}"
                if (
                    health.consecutive_failures >= cfg.failure_threshold
                    and health.status != "unhealthy"
                ):
                    health.status = "unhealthy"
                    log.warning(
                        "endpoint %s unhealthy (%s); withdrawing instance %x",
                        health.path, health.last_error,
                        served.instance.instance_id,
                    )
                    await self.drt.hub.delete(served.instance.path)
                continue
            health.consecutive_failures = 0
            health.last_ok = time.time()
            if cfg.sdc_check:
                if entry.golden is None:
                    # golden recorded at startup: the first clean canary's
                    # tokens ARE the known answer (pinned greedy decode)
                    entry.golden = toks
                elif toks != entry.golden:
                    # silent data corruption: the worker answered — fast,
                    # confidently, and WRONG. Quarantine immediately; no
                    # consecutive-failure grace for flipped bits.
                    health.last_error = (
                        f"sdc: canary tokens {toks} != golden {entry.golden}"
                    )
                    if health.status != "quarantined":
                        await self._quarantine(served, health, "sdc")
                    else:
                        health.clean_streak = 0
                    continue
            if health.status == "quarantined":
                health.clean_streak += 1
                if health.clean_streak < cfg.readmit_threshold:
                    continue
                await self._readmit(served, health)
            elif health.status == "unhealthy":
                log.info(
                    "endpoint %s recovered; re-publishing instance %x",
                    health.path, served.instance.instance_id,
                )
                await self._publish_card(served.instance)
            health.status = "ready"


class SystemStatusServer:
    """Liveness/readiness/health/metrics on a dedicated port (ref
    system_status_server.rs, DYN_SYSTEM_PORT)."""

    def __init__(
        self,
        *,
        health: HealthCheckManager | None = None,
        metrics=None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        # imported here: the frontend package imports the router, which
        # imports this module
        from dynamo_tpu_torch.frontend.http_server import HttpServer, Response

        self._response = Response
        self.health = health
        self.metrics = metrics
        self.host = host
        self.port = port
        self._server = HttpServer()
        for path, handler in (
            ("/live", self._live),
            ("/ready", self._ready),
            ("/health", self._health),
            ("/metrics", self._metrics),
        ):
            self._server.add_route("GET", path, handler)

    async def start(self) -> "SystemStatusServer":
        self.port = await self._server.start(self.host, self.port)
        return self

    async def stop(self) -> None:
        await self._server.stop()

    async def _live(self, _request):
        return self._response.json({"status": "live"})

    async def _ready(self, _request):
        ready = self.health.all_ready if self.health is not None else True
        return self._response.json(
            {"status": "ready" if ready else "notready"},
            status=200 if ready else 503,
        )

    async def _health(self, _request):
        statuses = (
            [h.to_dict() for h in self.health.statuses]
            if self.health is not None
            else []
        )
        ready = self.health.all_ready if self.health is not None else True
        return self._response.json(
            {"status": "ready" if ready else "notready",
             "endpoints": statuses}
        )

    async def _metrics(self, _request):
        if self.metrics is None:
            return self._response(404)
        return self._response(200, self.metrics.exposition(),
                              "text/plain; charset=utf-8")


class EngineMonitor:
    """Watchdog: if the engine's step loop dies, deregister this worker and
    shut the runtime down (ref VllmEngineMonitor engine_monitor.py;
    EngineDeadError -> runtime.shutdown in handlers.py:112-117)."""

    def __init__(self, drt, engine, *, interval_s: float = 1.0):
        self.drt = drt
        self.engine = engine
        self.interval_s = interval_s
        self._task = asyncio.get_running_loop().create_task(self._watch())

    def _engine_dead(self) -> bool:
        dead = getattr(self.engine, "is_dead", None)
        if dead is not None:
            return bool(dead)
        task = getattr(self.engine, "_loop_task", None)
        return task is not None and task.done()

    async def _watch(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            if self.engine is None:
                continue
            if getattr(self.engine, "_closed", False):
                return  # orderly close, not a death
            if self._engine_dead():
                log.error(
                    "engine step loop died; deregistering worker and "
                    "shutting down"
                )
                await self.drt.shutdown(drain=False)
                return

    async def close(self) -> None:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
