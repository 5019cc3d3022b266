"""Actuation backends: where ScalePlans become real replicas (a copy of
dynamo_tpu/autoscaler/backends.py).

Both backends speak the same two-method protocol so the controller (and
its convergence accounting) is backend-blind:

  ``apply(plan)``  — start converging the fleet toward the plan.
  ``observed()``   — current actual (workers, prefill, router_shards).

:class:`SimBackend` drives a fleet like the reference chaos sim's MockFleet — scale-up
spawns mock workers on the live DistributedRuntime, scale-down drains them
through the withdraw-grace contract (key first, handler later), which is
what lets the diurnal scenario assert zero client-visible errors while
replicas fall.

:class:`K8sBackend` actuates through the EXISTING operator instead of
talking to kubelets itself: worker/prefill counts go to the planner's
desired-replicas hub key (the operator's reconciler already overrides
prefill/decode-role service replicas from it), and router shard count
patches the DGD's router-role service replicas directly. Scale-down
therefore rides the operator's SIGTERM -> drain path end to end.
"""

from __future__ import annotations

import logging
from typing import Protocol

from dynamo_tpu_torch.autoscaler.plan import ScalePlan
from dynamo_tpu_torch.planner.connector import DesiredReplicas, VirtualConnector

log = logging.getLogger("dynamo.autoscaler.backends")

__all__ = ["K8sBackend", "ScaleBackend", "SimBackend"]


class ScaleBackend(Protocol):
    async def apply(self, plan: ScalePlan) -> None: ...

    async def observed(self) -> tuple[int, int, int]:
        """(workers, prefill, router_shards) actually running."""
        ...


class SimBackend:
    """Actuate against the sim's fleet (sim/harness.py ``MockFleet``:
    ``alive_workers()``, ``launch_worker()``, each worker's ``drain()``).

    Scale-up: ``fleet.launch_worker()`` per missing replica. Scale-down:
    drain the most recently launched workers (LIFO keeps the fleet's
    radix-warm veterans serving). Prefill/router dimensions have no sim
    twin yet; they are tracked as virtual counts so plans exercise the
    full law."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.virtual_prefill = 0
        self.virtual_shards = 1
        self.drained = 0
        self.spawned = 0

    async def apply(self, plan: ScalePlan) -> None:
        alive = self.fleet.alive_workers()
        want = plan.workers
        if len(alive) < want:
            for _ in range(want - len(alive)):
                await self.fleet.launch_worker()
                self.spawned += 1
        elif len(alive) > want:
            for w in reversed(alive[-(len(alive) - want):]):
                await w.drain()
                self.drained += 1
        self.virtual_prefill = plan.prefill
        self.virtual_shards = plan.router_shards

    async def observed(self) -> tuple[int, int, int]:
        return (
            len(self.fleet.alive_workers()),
            self.virtual_prefill,
            self.virtual_shards,
        )


class K8sBackend:
    """Actuate through the operator: planner desired-replicas key for the
    prefill/decode pools, DGD patch for router-role service replicas."""

    ROUTER_ROLE = "router"

    def __init__(self, hub, namespace: str, dgd_name: str | None = None,
                 model: str | None = None):
        self.hub = hub
        self.namespace = namespace
        self.dgd_name = dgd_name
        self.connector = VirtualConnector(hub, namespace, model=model)

    async def apply(self, plan: ScalePlan) -> None:
        await self.connector.set_replicas(
            DesiredReplicas(prefill=plan.prefill, decode=plan.workers)
        )
        if self.dgd_name:
            await self._patch_router_shards(plan.router_shards)

    async def _patch_router_shards(self, shards: int) -> None:
        from dynamo_tpu_torch.operator.graph import DynamoGraphDeployment

        dgd = await DynamoGraphDeployment.get(self.hub, self.dgd_name)
        if dgd is None:
            log.warning("DGD %s not found; router shards not actuated",
                        self.dgd_name)
            return
        changed = False
        for svc in dgd.services:
            if svc.role == self.ROUTER_ROLE and svc.replicas != shards:
                svc.replicas = shards
                changed = True
        if changed:
            await dgd.apply(self.hub)
            log.info("DGD %s router replicas -> %d", self.dgd_name, shards)

    async def observed(self) -> tuple[int, int, int]:
        """Actuals from the operator's status write-back (service roles
        come from the DGD spec); falls back to the desired key (converged
        assumption) when no status exists."""
        from dynamo_tpu_torch.operator.graph import (
            DGD_STATUS_KEY,
            DynamoGraphDeployment,
        )

        workers = prefill = shards = 0
        status = (
            await self.hub.get(DGD_STATUS_KEY.format(name=self.dgd_name))
            if self.dgd_name else None
        )
        if status:
            dgd = await DynamoGraphDeployment.get(self.hub, self.dgd_name)
            roles = {s.name: s.role for s in dgd.services} if dgd else {}
            for name, st in (status.get("services") or {}).items():
                role = roles.get(name, "")
                ready = int(st.get("ready", 0))
                if role == "decode":
                    workers += ready
                elif role == "prefill":
                    prefill += ready
                elif role == self.ROUTER_ROLE:
                    shards += ready
            return (workers, prefill, max(shards, 1))
        desired = await self.hub.get(self.connector.key)
        if desired:
            return (
                int(desired.get("decode", 0)),
                int(desired.get("prefill", 0)),
                1,
            )
        return (0, 0, 1)
