"""Worker telemetry: the engine's ForwardPassMetrics analogue on
/metrics (the counterpart of dynamo_tpu/engine/telemetry.py, on the
port's stdlib runtime/metrics.py).

A module-level ``MetricsRegistry`` holds step-latency and burst-size
histograms, page-pool / batch-occupancy / waiting-queue gauges, and
dispatch / admission-reject / spec counters. ``EngineCollector`` is the
cheap periodic sampler: the step thread only appends to two bounded
deques (step durations, burst fills) and bumps plain ints; the collector
drains those into Prometheus objects off the hot path. The registry is
exported through ``metrics.register_registry``, so it renders on EVERY
/metrics surface in the process — the worker's system status server
first among them. The metric names, help strings, labels and buckets
are the reference's: dashboards and the planner read those strings.

``engine_dispatches_total`` counts the device programs the step thread
issues (``InferenceEngine.dispatches``: each graph replay of a decode
burst or verify, and each eager forward or sample). The
``engine_dispatch_overhead_frac`` gauge is the step thread's share of the
sample window spent blocked on device-to-host reads, 0 unless the step
profiler is on (``EngineConfig.profile`` or ``DYNAMO_ENGINE_PROFILE=1``).
"""

from __future__ import annotations

import asyncio
import logging
import time

from dynamo_tpu_torch.runtime import metrics as metrics_mod
from dynamo_tpu_torch.runtime.context import spawn
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

log = logging.getLogger("dynamo_tpu_torch.engine.telemetry")

# one registry per process, shared across engines; every metric carries
# an ``engine`` label (collector ordinal) because one process can host
# MORE than one engine (single-process disagg runs a prefill and a
# decode engine over local transport) — unlabeled gauges would flap
# between the two samplers and counters would silently merge
REGISTRY = MetricsRegistry()
metrics_mod.register_registry("engine_telemetry", REGISTRY)

_STEP_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0,
)
_BURST_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

_M_STEP = REGISTRY.histogram(
    "engine_step_seconds",
    "engine step-thread cycle latency (work cycles only)",
    ["engine"], buckets=_STEP_BUCKETS,
)
_M_BURST = REGISTRY.histogram(
    "engine_burst_tokens",
    "tokens landed per processed decode burst",
    ["engine"], buckets=_BURST_BUCKETS,
)
_M_PAGES = REGISTRY.gauge(
    "engine_pages", "KV page pool by state", ["engine", "state"]
)
_M_SLOTS = REGISTRY.gauge(
    "engine_slots_active", "decode slots currently running", ["engine"]
)
_M_OCCUPANCY = REGISTRY.gauge(
    "engine_batch_occupancy", "active slots / max_decode_slots (0..1)",
    ["engine"],
)
_M_WAITING = REGISTRY.gauge(
    "engine_waiting_requests", "admission queue depth", ["engine"]
)
_M_DISPATCHES = REGISTRY.counter(
    "engine_dispatches_total", "jitted device programs issued",
    ["engine"],
)
_M_REJECTS = REGISTRY.counter(
    "engine_admission_rejects_total",
    "requests refused at admission (503/504 feeders)",
    ["engine", "reason"],
)
_M_OVERHEAD = REGISTRY.gauge(
    "engine_dispatch_overhead_frac",
    "step-thread d2h-blocked fraction of the sample window "
    "(0 unless DYNAMO_ENGINE_PROFILE=1)", ["engine"],
)
_M_SPEC_ACCEPT = REGISTRY.gauge(
    "engine_spec_acceptance_rate",
    "cumulative speculative-draft acceptance rate (NaN-free: 0 until "
    "the first verify)", ["engine"],
)
_M_KVBM_TIER = REGISTRY.gauge(
    "kvbm_tier_bytes",
    "KVBM tier footprint in bytes by tier (host | disk | remote — "
    "remote counts this process's G4 writes); quantized blocks "
    "(kv_dtype=fp8) land at packed fp8+scale width",
    ["engine", "tier"],
)

_M_PREEMPT = REGISTRY.counter(
    "engine_preemptions_total",
    "batch streams paused to the host tier by reason "
    "(interactive_admission | interactive_pages)",
    ["engine", "reason"],
)
_M_TENANT_TOKENS = REGISTRY.counter(
    "tenant_tokens_total",
    "admission-charged token cost by tenant and outcome "
    "(admitted | rejected | shed) — the live per-tenant quota picture",
    ["engine", "tenant", "outcome"],
)

_REJECT_REASONS = ("draining", "saturated", "deadline", "over_quota", "shed")
_COLLECTOR_IDS = iter(range(1 << 30))


class EngineCollector:
    """Periodic sampler bridging one engine's counters into REGISTRY.

    The engine side stays dumb and cheap (deque appends, int bumps);
    everything Prometheus-shaped happens here at a low duty cycle.
    ``sample()`` is callable directly (tests, pre-scrape refresh)."""

    def __init__(self, engine, *, interval_s: float = 1.0):
        self.engine = engine
        self.interval_s = interval_s
        # series identity: one label value per collector, so two
        # engines in one process (disagg prefill+decode) never write
        # the same gauge child
        self.label = str(next(_COLLECTOR_IDS))
        self._task: asyncio.Task | None = None
        self._closed = False
        # counter baselines: prometheus counters only move forward, so
        # deltas are computed against the engine's monotonically
        # increasing raw ints. Zero, not the current values: events from
        # before the collector attached (precompile dispatches, early
        # bounces) belong in the cumulative counters too.
        self._dispatch_base = 0
        self._reject_base = {k: 0 for k in engine.admission_rejects}
        self._preempt_base: dict[str, int] = {}
        self._tenant_base: dict[tuple[str, str], int] = {}
        self._d2h_base = self._d2h_secs()
        self._t_base = time.monotonic()

    def start(self) -> "EngineCollector":
        if self._task is None:
            self.sample()
            self._task = spawn(self._loop(), name="engine-telemetry")
        return self

    def _d2h_secs(self) -> float:
        prof = self.engine._prof
        total = 0.0
        for name in ("dispatch.d2h_wait", "readmit.d2h_wait"):
            rec = prof.get(name)
            if rec:
                total += rec[0]
        return total

    def sample(self) -> None:
        eng = self.engine
        lbl = self.label
        # drain the step/burst observation deques (step thread appends)
        while eng.step_times:
            try:
                _M_STEP.labels(lbl).observe(eng.step_times.popleft())
            except IndexError:  # pragma: no cover - racing appender
                break
        while eng.burst_fills:
            try:
                _M_BURST.labels(lbl).observe(eng.burst_fills.popleft())
            except IndexError:  # pragma: no cover
                break
        alloc = eng.allocator
        _M_PAGES.labels(lbl, "active").set(alloc.active_pages)
        _M_PAGES.labels(lbl, "cached").set(alloc.evictable_pages)
        _M_PAGES.labels(lbl, "free").set(alloc.free_pages)
        n_active = sum(s is not None for s in eng._slots)
        _M_SLOTS.labels(lbl).set(n_active)
        _M_OCCUPANCY.labels(lbl).set(n_active / max(len(eng._slots), 1))
        _M_WAITING.labels(lbl).set(eng._waiting.qsize())
        d = int(eng.dispatches) - self._dispatch_base
        if d > 0:
            _M_DISPATCHES.labels(lbl).inc(d)
            self._dispatch_base += d
        for reason in _REJECT_REASONS:
            cur = eng.admission_rejects.get(reason, 0)
            delta = cur - self._reject_base.get(reason, 0)
            if delta > 0:
                _M_REJECTS.labels(lbl, reason).inc(delta)
                self._reject_base[reason] = cur
        # overload-control plane: preemption counts (engine.preemptions)
        # and per-tenant charged token cost (the fair-admission
        # scheduler's token_counts feed, engine/tenancy.py)
        for reason, cur in dict(eng.preemptions).items():
            delta = cur - self._preempt_base.get(reason, 0)
            if delta > 0:
                _M_PREEMPT.labels(lbl, reason).inc(delta)
                self._preempt_base[reason] = cur
        counts = getattr(eng._waiting, "token_counts", None)
        if counts:
            for key, cur in dict(counts).items():
                delta = cur - self._tenant_base.get(key, 0)
                if delta > 0:
                    _M_TENANT_TOKENS.labels(lbl, key[0], key[1]).inc(delta)
                    self._tenant_base[key] = cur
        if eng.kvbm is not None:
            for tier, nbytes in eng.kvbm.tier_bytes().items():
                _M_KVBM_TIER.labels(lbl, tier).set(nbytes)
        judged = eng.spec_accepted + eng.spec_rejected
        _M_SPEC_ACCEPT.labels(lbl).set(
            eng.spec_accepted / judged if judged else 0.0
        )
        now = time.monotonic()
        d2h = self._d2h_secs()
        window = now - self._t_base
        if window > 0:
            _M_OVERHEAD.labels(lbl).set(
                min((d2h - self._d2h_base) / window, 1.0)
            )
        self._d2h_base = d2h
        self._t_base = now

    async def _loop(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(self.interval_s)
                try:
                    self.sample()
                except Exception:  # noqa: BLE001 - telemetry must not
                    # take the worker down; next tick retries
                    log.warning("telemetry sample failed", exc_info=True)
        except asyncio.CancelledError:
            pass

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
