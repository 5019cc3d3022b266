"""CRD <-> hub bridge: make the apiserver-native resource functional (the
port's copy of dynamo_tpu/operator/crd_sync.py).

The upstream operator reconciles DynamoGraphDeployment CRDs straight
off the apiserver through controller-runtime informers
(ref deploy/cloud/operator/internal/controller/
dynamographdeployment_controller.go). Here the Reconciler converges on
the HUB resource (``v1/dgd/{name}``); this module closes the loop for
cluster-native workflows:

- ``kubectl get dgd <name> -w -o json`` streams the CRD object; each
  change is translated (spec.services map -> ServiceSpec list) and
  applied to the hub resource, which wakes the Reconciler edge-
  triggered.
- the Reconciler's status write-back (``v1/dgd-status/{name}``) is
  patched onto the CRD's status subresource, so ``kubectl get dgd``
  shows State/Ready columns (deploy/k8s/crd.yaml printer columns).

A user then drives the whole stack with ``kubectl apply -f dgd.yaml``
exactly like the reference.
"""

from __future__ import annotations

import asyncio
import json
import logging

from dynamo_tpu_torch.operator.graph import (
    DGD_STATUS_KEY,
    DynamoGraphDeployment,
    ServiceSpec,
)

log = logging.getLogger("dynamo.operator")


def services_from_crd(spec: dict) -> list[ServiceSpec]:
    """Translate the CRD's ``spec.services`` map (deploy/k8s/crd.yaml
    schema) into the hub resource's ServiceSpec list. Graph-wide
    ``spec.envs`` layer under per-service env."""
    base_env = dict(spec.get("envs") or {})
    out = []
    for name, svc in sorted((spec.get("services") or {}).items()):
        out.append(ServiceSpec(
            name=name,
            replicas=int(svc.get("replicas", 1)),
            command=list(svc.get("command") or []),
            component=svc.get("component", "backend"),
            role=svc.get("role", ""),
            port=int(svc.get("port", 0)),
            env={**base_env, **(svc.get("env") or {})},
            hosts=int(svc.get("hosts", 1)),
        ))
    return out


class CrdSync:
    """One task pair per graph: CRD spec -> hub, hub status -> CRD."""

    def __init__(
        self, hub, name: str, *, namespace: str = "dynamo",
        kubectl: str = "kubectl",
    ):
        self.hub = hub
        self.name = name
        self.namespace = namespace
        self.kubectl = kubectl
        self._tasks: list[asyncio.Task] = []
        self._proc: asyncio.subprocess.Process | None = None
        self.synced_revisions = 0  # observability + test hook

    async def start(self) -> "CrdSync":
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._spec_watch_loop()),
            loop.create_task(self._status_push_loop()),
        ]
        return self

    # -- CRD spec -> hub resource ------------------------------------------

    async def _spec_watch_loop(self) -> None:
        delay = 1.0
        while True:
            try:
                proc = await asyncio.create_subprocess_exec(
                    self.kubectl, "-n", self.namespace, "get",
                    "dynamographdeployments", self.name, "-w", "-o", "json",
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.DEVNULL,
                )
                self._proc = proc
                assert proc.stdout is not None
                # -w -o json emits CONCATENATED json documents; feed an
                # incremental decoder
                buf = ""
                decoder = json.JSONDecoder()
                while True:
                    chunk = await proc.stdout.read(65536)
                    if not chunk:
                        break
                    buf += chunk.decode()
                    while buf.lstrip():
                        try:
                            obj, end = decoder.raw_decode(buf.lstrip())
                        except json.JSONDecodeError:
                            break  # incomplete document: read more
                        buf = buf.lstrip()[end:]
                        await self._apply_crd_object(obj)
                        delay = 1.0
                await proc.wait()
            except asyncio.CancelledError:
                if self._proc and self._proc.returncode is None:
                    self._proc.kill()
                    try:
                        await self._proc.wait()  # reap on the loop
                    # best-effort zombie reap on a process we just
                    # killed; cancellation must proceed
                    except Exception:  # noqa: BLE001
                        pass
                raise
            except Exception:  # noqa: BLE001
                log.warning("dgd CRD watch failed; retrying", exc_info=True)
            await asyncio.sleep(delay)
            delay = min(delay * 2, 30.0)

    async def _apply_crd_object(self, obj: dict) -> None:
        spec = obj.get("spec") or {}
        services = services_from_crd(spec)
        current = await DynamoGraphDeployment.get(self.hub, self.name)
        if current is not None and [
            s.__dict__ for s in current.services
        ] == [s.__dict__ for s in services]:
            return  # no-op events (status-only updates) must not bump rev
        dgd = DynamoGraphDeployment(
            name=self.name,
            namespace=self.namespace,
            services=services,
            revision=current.revision if current is not None else 0,
        )
        await dgd.apply(self.hub)
        self.synced_revisions += 1
        log.info(
            "crd-sync %s: applied revision %d (%d services)",
            self.name, dgd.revision, len(services),
        )

    # -- hub status -> CRD status subresource ------------------------------

    async def _status_push_loop(self) -> None:
        key = DGD_STATUS_KEY.format(name=self.name)
        try:
            async for ev in self.hub.watch_prefix(key):
                if ev.kind != "put" or not ev.value:
                    continue
                status = {
                    "state": "successful" if ev.value.get("ready")
                    else "pending",
                    "ready": "True" if ev.value.get("ready") else "False",
                    "revision": ev.value.get("revision", 0),
                    "services": ev.value.get("services", {}),
                }
                proc = await asyncio.create_subprocess_exec(
                    self.kubectl, "-n", self.namespace, "patch",
                    "dynamographdeployments", self.name,
                    "--subresource=status", "--type=merge",
                    "-p", json.dumps({"status": status}),
                    stdout=asyncio.subprocess.DEVNULL,
                    stderr=asyncio.subprocess.DEVNULL,
                )
                await proc.wait()
        except (asyncio.CancelledError, ConnectionError):
            pass

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
        if self._proc is not None and self._proc.returncode is None:
            self._proc.kill()
            try:
                await asyncio.wait_for(self._proc.wait(), timeout=5)
            except (asyncio.TimeoutError, ProcessLookupError):
                pass
