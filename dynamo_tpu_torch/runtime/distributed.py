"""Runtime and DistributedRuntime: process + cluster handles (the
counterpart of dynamo_tpu/runtime/distributed.py).

``Runtime`` owns the process lifecycle (shutdown event). ``DistributedRuntime``
adds the cluster: the hub, the process lease and its keepalive, the local
in-proc handler registry, and the component tree accessor.

The port runs the one-process stack only: the hub is the in-memory one
living in this process, so every served endpoint is a ``"local"`` instance.
A hub address raises NotImplementedError until the TCP hub client and the
endpoint transport are ported (ROADMAP Queue A item 4b).
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any

from dynamo_tpu_torch.runtime.component import (
    Endpoint,
    Instance,
    Namespace,
    ServedEndpoint,
)
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.hub import Hub, InMemoryHub
from dynamo_tpu_torch.runtime.transport import Handler, LocalRegistry

log = logging.getLogger("dynamo_tpu_torch.runtime")

REMOTE_HUB_TODO = (
    "the port's runtime serves an in-memory hub only; the TCP hub client, "
    "hub server and endpoint transport are ROADMAP Queue A item 4b"
)


class Runtime:
    """Process runtime: shutdown coordination."""

    def __init__(self) -> None:
        self._shutdown = asyncio.Event()

    def shutdown(self) -> None:
        self._shutdown.set()

    @property
    def is_shutdown(self) -> bool:
        return self._shutdown.is_set()

    async def wait_for_shutdown(self) -> None:
        await self._shutdown.wait()


class DistributedRuntime:
    """Cluster handle: hub + lease + endpoint serving + component tree."""

    def __init__(self, hub: Hub, config: RuntimeConfig | None = None, runtime: Runtime | None = None):
        if not isinstance(hub, InMemoryHub):
            raise NotImplementedError(REMOTE_HUB_TODO)
        self.hub = hub
        self.config = config or RuntimeConfig()
        self.runtime = runtime or Runtime()
        self.local_registry = LocalRegistry()
        self._lease_id: int | None = None
        self._keepalive_task: asyncio.Task | None = None
        self._served: list[ServedEndpoint] = []
        self._closed = False

    # -- construction ------------------------------------------------------

    @classmethod
    async def from_settings(cls, config: RuntimeConfig | None = None) -> "DistributedRuntime":
        """An in-memory hub; a configured hub address raises."""
        config = config or RuntimeConfig.from_env()
        if config.hub_target():
            raise NotImplementedError(
                f"hub address {config.hub_target()!r}: {REMOTE_HUB_TODO}")
        return cls(InMemoryHub(), config)

    # -- component tree ----------------------------------------------------

    def namespace(self, name: str | None = None) -> Namespace:
        return Namespace(self, name or self.config.namespace)

    # -- lease -------------------------------------------------------------

    async def lease_id(self) -> int:
        """This process's primary lease (allocated on first use)."""
        if self._lease_id is None:
            self._lease_id = await self.hub.grant_lease(self.config.lease_ttl_s)
            self._keepalive_task = asyncio.get_running_loop().create_task(
                self._keepalive_loop()
            )
        return self._lease_id

    async def _keepalive_loop(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(self.config.keepalive_interval_s)
                if self._lease_id is None:
                    continue
                ok = await self.hub.keepalive(self._lease_id)
                if not ok:
                    log.error("lease %s lost; shutting down", self._lease_id)
                    self.runtime.shutdown()
                    return
        except asyncio.CancelledError:
            pass

    # -- endpoint serving --------------------------------------------------

    async def serve_endpoint(
        self,
        endpoint: Endpoint,
        handler: Handler,
        *,
        metadata: dict[str, Any],
        graceful_shutdown: bool = True,
    ) -> ServedEndpoint:
        lease = await self.lease_id()
        inst = Instance(
            instance_id=self._alloc_instance_id(lease),
            namespace=endpoint.namespace,
            component=endpoint.component,
            endpoint=endpoint.name,
            host="local",
            port=0,
            transport="local",
            metadata=metadata,
        )
        self.local_registry.register(inst.wire_path, handler)
        await self.hub.put(inst.path, inst.to_dict(), lease_id=lease)
        served = ServedEndpoint(inst, endpoint, self)
        self._served.append(served)
        log.info("serving %s as instance %x", endpoint.path, inst.instance_id)
        return served

    _instance_seq = 0

    def _alloc_instance_id(self, lease: int) -> int:
        """Unique instance id: lease id in the high bits + per-process seq,
        so one process can serve several endpoints under one lease."""
        DistributedRuntime._instance_seq += 1
        return (lease << 16) | (
            (DistributedRuntime._instance_seq & 0xFF) << 8
        ) | random.randrange(256)

    async def deregister_endpoint(
        self,
        served: ServedEndpoint,
        drain: bool = True,
        grace_s: float | None = None,
    ) -> None:
        """Withdraw an instance: hub key first, handler last.

        The ordering is the scale-down drain contract: routers route from a
        WATCHED copy of the instance set, so a pick made between the hub
        delete and every router observing it must still land on a live
        handler. With ``drain=True`` the handler stays registered for
        ``grace_s`` (default ``withdraw_grace_s``) after the key goes;
        ``shutdown`` passes 0."""
        await self.hub.delete(served.instance.path)
        if drain:
            g = self.config.withdraw_grace_s if grace_s is None else grace_s
            if g > 0:
                await asyncio.sleep(g)
        self.local_registry.unregister(served.instance.wire_path)
        if served in self._served:
            self._served.remove(served)

    # -- shutdown ----------------------------------------------------------

    async def shutdown(
        self, drain: bool = True, drain_timeout: float = 30.0
    ) -> None:
        if self._closed:
            return
        self._closed = True
        for served in list(self._served):
            await self.deregister_endpoint(served, drain=drain, grace_s=0.0)
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        if self._lease_id is not None:
            await self.hub.revoke_lease(self._lease_id)
        self.runtime.shutdown()

    async def close(self) -> None:
        await self.shutdown()
        await self.hub.close()
