"""Scale plans and the control law that emits them (a copy of
dynamo_tpu/autoscaler/plan.py).

The law is deterministic and side-effect free — the controller feeds it a
:class:`DemandSignal` plus a clock reading and gets back either a new
versioned :class:`ScalePlan` or None (hold). All the stability machinery
lives here, per scaled dimension (decode workers, prefill workers, router
shards):

  hysteresis    — scaling up needs utilization >= ``scale_up_at``; scaling
                  down needs utilization <= ``scale_down_at``. The dead
                  band between them absorbs noise so the fleet doesn't
                  flap around a steady load.
  cooldowns     — per-direction refractory periods after the last move in
                  that dimension; downscale cooldowns default much longer
                  than upscale (adding capacity late costs latency,
                  removing it late costs only dollars).
  bounded steps — one plan moves a dimension at most ``max_step_up`` /
                  ``max_step_down`` replicas, so a telemetry glitch can't
                  order a fleet-halving in one tick.

Sizing itself is occupancy-targeted: desired = ceil(demand / (capacity per
replica × ``target_occupancy``)). Demand is concurrent work (running +
waiting requests for decode, queued prefill tokens for prefill); feeding a
k-step-ahead forecast instead of the live reading is what makes the loop
predictive — the law doesn't care where the number came from.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field

__all__ = ["AutoscalerConfig", "DemandSignal", "PlanEngine", "ScalePlan"]

PLAN_SCHEMA = "dynamo-scaleplan/v1"


@dataclass
class AutoscalerConfig:
    """Control-law knobs. Defaults are production-shaped (seconds-scale
    cooldowns); the sim dilates them via ``scaled(time_scale)``."""

    # capacity model
    slots_per_worker: int = 8  # decode slots (engine max_batch_size)
    target_occupancy: float = 0.75  # size for this fraction of slots busy
    prefill_tokens_per_worker: float = 8192.0  # queued tokens one prefill
    # worker is expected to absorb within a tick
    workers_per_router_shard: int = 64  # fleet size one /pick shard serves

    # bounds
    min_workers: int = 1
    max_workers: int = 64
    min_prefill: int = 0
    max_prefill: int = 16
    min_router_shards: int = 1
    max_router_shards: int = 8

    # hysteresis band (utilization = demand / (replicas * capacity))
    scale_up_at: float = 0.85
    scale_down_at: float = 0.5

    # per-direction cooldowns (seconds on the controller's clock)
    up_cooldown_s: float = 15.0
    down_cooldown_s: float = 120.0

    # bounded step sizes (replicas per plan, per dimension)
    max_step_up: int = 4
    max_step_down: int = 2

    # predictive pre-scaling: forecast demand this many ticks ahead and
    # plan for max(live, forecast). 0 = purely reactive.
    predict_ahead_ticks: int = 0
    predictor: str = "holt"
    predictor_window: int = 128
    seasonal_period: int = 0  # >0 selects the seasonal predictor

    # controller cadence (used by AutoscaleController.run, not the law)
    tick_interval_s: float = 5.0

    def scaled(self, time_scale: float) -> "AutoscalerConfig":
        """A copy with every time constant divided by ``time_scale`` — the
        sim runs the same law under time dilation."""
        out = AutoscalerConfig(**asdict(self))
        out.up_cooldown_s /= time_scale
        out.down_cooldown_s /= time_scale
        out.tick_interval_s /= time_scale
        return out


@dataclass
class DemandSignal:
    """One tick's aggregated fleet observation (possibly forecast)."""

    demand: float = 0.0  # concurrent decode work: running + waiting reqs
    prefill_queue_tokens: float = 0.0
    workers_observed: int = 0
    prefill_observed: int = 0
    live_workers_reporting: int = 0  # telemetry coverage, for the plan note
    # soft-withdrawn (quarantined) workers: alive but excluded from
    # routing — zero effective capacity, so the law holds replacements
    # on top of its load-based target (gray-failure immunity)
    quarantined_workers: int = 0


@dataclass
class ScalePlan:
    """One versioned scaling decision, self-describing enough to audit."""

    revision: int
    workers: int
    prefill: int
    router_shards: int
    reason: str = ""
    created_at: float = 0.0
    schema: str = PLAN_SCHEMA
    signal: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    def counts(self) -> tuple[int, int, int]:
        return (self.workers, self.prefill, self.router_shards)


@dataclass
class _DimState:
    """Per-dimension controller memory: current target + move timestamps."""

    current: int
    last_up: float = float("-inf")
    last_down: float = float("-inf")


class PlanEngine:
    """The pure control law. ``step()`` per dimension, ``plan()`` overall."""

    def __init__(self, cfg: AutoscalerConfig, *, initial_workers: int = 1,
                 initial_prefill: int = 0, initial_shards: int = 1):
        self.cfg = cfg
        self.revision = 0
        self._dims = {
            "workers": _DimState(initial_workers),
            "prefill": _DimState(initial_prefill),
            "shards": _DimState(initial_shards),
        }
        # quarantine replacement overlay: replicas held ON TOP of the
        # load-based workers target, one per quarantined worker. Kept
        # outside _DimState on purpose — replacing withdrawn capacity is
        # not load-driven scaling, so it bypasses the hysteresis band
        # and both cooldowns, and unwinds instantly on re-admission
        # without burning the downscale cooldown.
        self._quarantine_overlay = 0

    # -- single-dimension law ---------------------------------------------

    def _step(
        self,
        dim: str,
        demand: float,
        per_replica: float,
        lo: int,
        hi: int,
        now: float,
    ) -> tuple[int, str | None]:
        """Next target for one dimension; (value, reason|None if holding)."""
        cfg = self.cfg
        st = self._dims[dim]
        cap = max(per_replica, 1e-9)
        want = max(lo, min(hi, math.ceil(demand / (cap * cfg.target_occupancy))))
        cur = st.current
        if want == cur:
            return cur, None
        util = demand / (cap * max(cur, 1))
        if want > cur:
            if util < cfg.scale_up_at:
                return cur, None  # inside the dead band
            if now - st.last_up < cfg.up_cooldown_s:
                return cur, None
            nxt = min(want, cur + cfg.max_step_up, hi)
            if nxt == cur:
                return cur, None
            st.current, st.last_up = nxt, now
            return nxt, (
                f"{dim} {cur}->{nxt} (util {util:.2f} >= {cfg.scale_up_at})"
            )
        # scale down
        if util > cfg.scale_down_at:
            return cur, None
        if now - st.last_down < cfg.down_cooldown_s:
            return cur, None
        # an upscale also resets the downscale clock: never remove capacity
        # while the up-cooldown from a recent burst is still running
        if now - st.last_up < cfg.down_cooldown_s:
            return cur, None
        nxt = max(want, cur - cfg.max_step_down, lo)
        if nxt == cur:
            return cur, None
        st.current, st.last_down = nxt, now
        return nxt, (
            f"{dim} {cur}->{nxt} (util {util:.2f} <= {cfg.scale_down_at})"
        )

    # -- full plan ---------------------------------------------------------

    def plan(self, sig: DemandSignal, now: float) -> ScalePlan | None:
        """Run the law over every dimension; a new revision only when at
        least one dimension moved."""
        cfg = self.cfg
        reasons: list[str] = []
        workers, r = self._step(
            "workers", sig.demand, float(cfg.slots_per_worker),
            cfg.min_workers, cfg.max_workers, now,
        )
        if r:
            reasons.append(r)
        overlay = min(
            max(int(sig.quarantined_workers), 0),
            cfg.max_workers - workers,
        )
        if overlay != self._quarantine_overlay:
            reasons.append(
                f"workers quarantine overlay "
                f"{self._quarantine_overlay}->{overlay} "
                f"({sig.quarantined_workers} quarantined)"
            )
            self._quarantine_overlay = overlay
        workers += self._quarantine_overlay
        prefill, r = self._step(
            "prefill", sig.prefill_queue_tokens,
            cfg.prefill_tokens_per_worker,
            cfg.min_prefill, cfg.max_prefill, now,
        )
        if r:
            reasons.append(r)
        # router shards track fleet size, not load: demand = planned
        # workers, capacity = workers_per_router_shard
        shards, r = self._step(
            "shards", float(workers), float(cfg.workers_per_router_shard),
            cfg.min_router_shards, cfg.max_router_shards, now,
        )
        if r:
            reasons.append(r)
        if not reasons:
            return None
        self.revision += 1
        return ScalePlan(
            revision=self.revision,
            workers=workers,
            prefill=prefill,
            router_shards=shards,
            reason="; ".join(reasons),
            created_at=now,
            signal={
                "demand": round(sig.demand, 2),
                "prefill_queue_tokens": round(sig.prefill_queue_tokens, 1),
                "workers_observed": sig.workers_observed,
                "reporting": sig.live_workers_reporting,
                "quarantined": sig.quarantined_workers,
            },
        )

    def current(self) -> tuple[int, int, int]:
        return (
            self._dims["workers"].current + self._quarantine_overlay,
            self._dims["prefill"].current,
            self._dims["shards"].current,
        )
