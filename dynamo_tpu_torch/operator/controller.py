"""The reconciler: level-triggered convergence of graph deployments (the
port's copy of dynamo_tpu/operator/controller.py).

Control loop shape of the upstream controllers
(deploy/cloud/operator/internal/controller/): every interval (and on
desired-state change) compare DESIRED — the DynamoGraphDeployment
resource, with the SLA planner's desired-replica counts overriding the
prefill/decode services (ref KubernetesConnector patching DGD replicas,
planner/kubernetes_connector.py) — against OBSERVED (backend-reported
running replicas) and converge via the backend. Scale-down sends
SIGTERM so workers deregister their leases gracefully; anything that
dies hard loses its lease at TTL and the hub reaper drops its instance
keys (this stack's equivalent of the reference operator's etcd cleanup
on scale-down — proven by the worker-kill fault-tolerance test).
"""

from __future__ import annotations

import asyncio
import logging

from dynamo_tpu_torch.operator.graph import (
    DGD_KEY,
    DGD_STATUS_KEY,
    DynamoGraphDeployment,
    ServiceSpec,
)
from dynamo_tpu_torch.planner.connector import read_desired_replicas

log = logging.getLogger("dynamo.operator")


class Reconciler:
    def __init__(
        self,
        hub,
        name: str,
        backend,
        *,
        interval_s: float = 1.0,
        apply_planner_desired: bool = True,
    ):
        self.hub = hub
        self.name = name
        self.backend = backend
        self.interval_s = interval_s
        self.apply_planner_desired = apply_planner_desired
        self._task: asyncio.Task | None = None
        self._watch_task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self.reconciles = 0
        # services seen last pass: a service dropped from the resource
        # must be torn down (backend.delete when it manages the objects,
        # else scale-to-zero). In-memory diffing misses edits made while
        # the operator was down — backend.prune (label-selected sweep)
        # covers those; together they are the reference controller's
        # owner-reference GC equivalent
        self._last_services: dict[str, ServiceSpec] = {}
        self._last_revision: int | None = None

    async def start(self) -> "Reconciler":
        loop = asyncio.get_running_loop()
        if hasattr(self.backend, "start_watch"):
            # observed-state watch (informer role): cluster-side changes
            # wake the loop immediately, and running() becomes a cache
            # read instead of a kubectl subprocess per service per pass
            try:
                await self.backend.start_watch(self._wake.set)
            except Exception:  # noqa: BLE001 — fall back to polling
                log.warning("observed-state watch unavailable; polling",
                            exc_info=True)
        self._task = loop.create_task(self._run())
        self._watch_task = loop.create_task(self._watch_desired())
        return self

    async def _watch_desired(self) -> None:
        """Edge trigger on top of the level loop: react immediately when
        the resource (or the planner's desired counts) changes."""
        try:
            async for _ev in self.hub.watch_prefix(
                DGD_KEY.format(name=self.name)
            ):
                self._wake.set()
        except (asyncio.CancelledError, ConnectionError):
            pass

    async def reconcile_once(self) -> DynamoGraphDeployment | None:
        dgd = await DynamoGraphDeployment.get(self.hub, self.name)
        if dgd is None:
            # resource deleted: tear down everything it owned and drop
            # the status key (else dynamo_check reports a ghost graph)
            if self._last_services:
                log.info("reconcile %s: resource deleted; tearing down",
                         self.name)
                for old in self._last_services.values():
                    if hasattr(self.backend, "delete"):
                        await self.backend.delete(old)
                    else:
                        await self.backend.scale(old, 0)
                self._last_services = {}
                self._last_revision = None
                try:
                    await self.hub.delete(
                        DGD_STATUS_KEY.format(name=self.name)
                    )
                except Exception:  # noqa: BLE001
                    log.warning("dgd status delete failed", exc_info=True)
            return None
        # a revision bump means the SPEC may have changed (command, env,
        # port), not just counts — managed backends must re-apply even
        # at matching replica counts for the rolling update to happen.
        # Also true on the first pass after (re)start: converge from
        # whatever state the cluster was left in.
        spec_changed = dgd.revision != self._last_revision
        desired_override = None
        if self.apply_planner_desired:
            try:
                desired_override = await read_desired_replicas(
                    self.hub, dgd.namespace
                )
            except Exception:  # noqa: BLE001
                log.warning("planner desired-replica read failed",
                            exc_info=True)
        status: dict[str, dict[str, int]] = {}
        for svc in dgd.services:
            replicas = svc.replicas
            if desired_override is not None and svc.role in (
                "prefill", "decode"
            ):
                replicas = getattr(desired_override, svc.role)
            have = self.backend.running(svc.name)
            if have != replicas or spec_changed:
                if have != replicas:
                    log.info(
                        "reconcile %s/%s: %d -> %d replicas",
                        self.name, svc.name, have, replicas,
                    )
                await self.backend.scale(svc, replicas)
            status[svc.name] = {"desired": replicas, "ready": have}
        # tear down services that left the resource
        current = {svc.name for svc in dgd.services}
        for name, old in self._last_services.items():
            if name in current:
                continue
            log.info("reconcile %s/%s: removed from graph", self.name, name)
            if hasattr(self.backend, "delete"):
                await self.backend.delete(old)
            else:
                await self.backend.scale(old, 0)
        # durable sweep: objects labeled for this graph but absent from
        # the resource (edits made while the operator was down)
        if spec_changed and hasattr(self.backend, "prune"):
            await self.backend.prune(current)
        self._last_services = {svc.name: svc for svc in dgd.services}
        self._last_revision = dgd.revision
        # status subresource equivalent: observed counts for dynamo_check
        # and dashboards ("ready" lags one pass after a scale by design —
        # it is the OBSERVED state this pass converged from)
        try:
            await self.hub.put(
                DGD_STATUS_KEY.format(name=self.name),
                {
                    "revision": dgd.revision,
                    "services": status,
                    "ready": all(
                        s["ready"] == s["desired"] for s in status.values()
                    ),
                },
            )
        except Exception:  # noqa: BLE001 - status is best-effort
            log.warning("dgd status write failed", exc_info=True)
        self.reconciles += 1
        return dgd

    async def _run(self) -> None:
        try:
            while True:
                try:
                    await self.reconcile_once()
                except Exception:  # noqa: BLE001
                    log.exception("reconcile failed; retrying")
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), timeout=self.interval_s
                    )
                    self._wake.clear()
                except asyncio.TimeoutError:
                    pass
        except asyncio.CancelledError:
            pass

    async def close(self) -> None:
        for t in (self._task, self._watch_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
                except Exception:  # noqa: BLE001 - already-dead task
                    log.exception("reconciler task died before close")
        await self.backend.close()
