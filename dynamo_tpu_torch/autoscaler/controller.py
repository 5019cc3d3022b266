"""The closed loop: telemetry -> predictor -> plan -> actuation (a copy of
dynamo_tpu/autoscaler/controller.py).

``AutoscaleController.tick()`` is one full pass and the unit the sim and
tests drive directly; ``start()`` runs it on a wall-clock cadence for live
deployments. Each tick:

  1. snapshot the fleet's DemandSignal from :class:`FleetTelemetry`;
  2. feed the demand predictor and (when ``predict_ahead_ticks > 0``)
     plan for ``max(live, forecast)`` — the forecast may pre-scale a ramp
     but can never starve live load;
  3. run the PlanEngine control law; on a new revision, actuate through
     the backend and start convergence accounting (ticks until
     ``backend.observed()`` matches the plan).

The controller also scores its own forecasts: each tick the forecast made
``predict_ahead_ticks`` ago matures against the demand that actually
arrived, feeding the ``dynamo_autoscaler_predictor_error`` gauge — a
predictor that hurts is visible before it pages anyone.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque

from dynamo_tpu_torch.autoscaler.metrics import (
    ACTUATION_SECONDS,
    CONVERGENCE_TICKS,
    PLAN_REVISIONS,
    PREDICTOR_ERROR,
    REPLICAS_ACTUAL,
    REPLICAS_DESIRED,
)
from dynamo_tpu_torch.autoscaler.plan import (
    AutoscalerConfig,
    DemandSignal,
    PlanEngine,
    ScalePlan,
)
from dynamo_tpu_torch.planner.predictor import make_predictor

log = logging.getLogger("dynamo.autoscaler")

__all__ = ["AutoscaleController"]

_DIMS = ("workers", "prefill", "router_shards")


class AutoscaleController:
    def __init__(
        self,
        cfg: AutoscalerConfig,
        telemetry,
        backend,
        *,
        initial_workers: int = 1,
        clock=time.monotonic,
    ):
        self.cfg = cfg
        self.telemetry = telemetry
        self.backend = backend
        self.clock = clock
        self.engine = PlanEngine(cfg, initial_workers=initial_workers)
        kwargs = {}
        if cfg.seasonal_period > 0:
            kind = "seasonal"
            kwargs["period"] = cfg.seasonal_period
        else:
            kind = cfg.predictor
        self.predictor = make_predictor(
            kind, window_size=cfg.predictor_window, **kwargs
        )
        self.plans: list[ScalePlan] = []
        self.converge_ticks: list[int] = []  # per converged plan
        self._converging: ScalePlan | None = None
        self._converge_age = 0
        self._pending_forecasts: deque[float] = deque()
        self.forecast_errors: list[float] = []
        self._task: asyncio.Task | None = None

    # -- one pass ----------------------------------------------------------

    async def tick(self) -> ScalePlan | None:
        sig = self.telemetry.signal()
        demand = sig.demand
        self.predictor.observe(demand)

        # score the forecast that was made predict_ahead_ticks ago and
        # has now matured against the observed demand
        if self._pending_forecasts and self.cfg.predict_ahead_ticks > 0:
            if len(self._pending_forecasts) > self.cfg.predict_ahead_ticks:
                matured = self._pending_forecasts.popleft()
                err = matured - demand
                self.forecast_errors.append(err)
                PREDICTOR_ERROR.set(err)

        planning_demand = demand
        if self.cfg.predict_ahead_ticks > 0:
            forecast = self.predictor.predict_ahead(
                self.cfg.predict_ahead_ticks
            )
            self._pending_forecasts.append(forecast)
            planning_demand = max(demand, forecast)

        plan_sig = DemandSignal(
            demand=planning_demand,
            prefill_queue_tokens=sig.prefill_queue_tokens,
            workers_observed=sig.workers_observed,
            prefill_observed=sig.prefill_observed,
            live_workers_reporting=sig.live_workers_reporting,
            quarantined_workers=sig.quarantined_workers,
        )
        plan = self.engine.plan(plan_sig, self.clock())
        if plan is not None:
            await self._actuate(plan)
        await self._track_convergence()
        return plan

    async def _actuate(self, plan: ScalePlan) -> None:
        self.plans.append(plan)
        PLAN_REVISIONS.inc()
        for dim, val in zip(_DIMS, plan.counts()):
            REPLICAS_DESIRED.labels(dim).set(val)
        t0 = time.perf_counter()
        await self.backend.apply(plan)
        ACTUATION_SECONDS.observe(time.perf_counter() - t0)
        log.info("plan r%d actuated: %s", plan.revision, plan.reason)
        self._converging = plan
        self._converge_age = 0

    async def _track_convergence(self) -> None:
        obs = await self.backend.observed()
        for dim, val in zip(_DIMS, obs):
            REPLICAS_ACTUAL.labels(dim).set(val)
        if self._converging is None:
            return
        self._converge_age += 1
        if obs == self._converging.counts():
            self.converge_ticks.append(self._converge_age)
            CONVERGENCE_TICKS.set(self._converge_age)
            self._converging = None

    # -- live loop ---------------------------------------------------------

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.tick_interval_s)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                log.exception("autoscaler tick failed")

    def start(self) -> "AutoscaleController":
        self._task = asyncio.get_running_loop().create_task(self.run())
        return self

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """Artifact-shaped summary of what the loop did."""
        errs = self.forecast_errors
        return {
            "plans": len(self.plans),
            "final": dict(zip(_DIMS, self.engine.current())),
            "converge_ticks_max": max(self.converge_ticks, default=0),
            "unconverged": self._converging is not None,
            "forecast_mae": (
                round(sum(abs(e) for e in errs) / len(errs), 3)
                if errs else None
            ),
            "revisions": [
                {"rev": p.revision, "workers": p.workers,
                 "prefill": p.prefill, "shards": p.router_shards,
                 "reason": p.reason}
                for p in self.plans
            ],
        }
