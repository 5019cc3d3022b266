"""Runtime and DistributedRuntime: process + cluster handles (the
counterpart of dynamo_tpu/runtime/distributed.py).

``Runtime`` owns the process lifecycle (shutdown event). ``DistributedRuntime``
adds the cluster: the hub (in-memory, or a ``RemoteHub`` over TCP), the
process lease and its keepalive, the shared ``EndpointServer`` for this
process's endpoints, the local in-proc handler registry, and the component
tree accessor. Endpoints serve as ``"local"`` instances only when the hub is
the in-memory one living in this process; otherwise they serve over TCP.
"""

from __future__ import annotations

import asyncio
import logging
import os
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
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.transport import EndpointServer, Handler, LocalRegistry

log = logging.getLogger("dynamo_tpu_torch.runtime")

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
        self.hub = hub
        self.config = config or RuntimeConfig()
        self.runtime = runtime or Runtime()
        self.local_registry = LocalRegistry()
        self._server: EndpointServer | None = None
        self._lease_id: int | None = None
        self._keepalive_task: asyncio.Task | None = None
        self._served: list[ServedEndpoint] = []
        self._closed = False
        # local instances dispatch in-proc only when hub state is shared, i.e.
        # the hub is the in-memory one living in this very process
        self._local_ok = isinstance(hub, InMemoryHub)

    # -- construction ------------------------------------------------------

    @classmethod
    async def from_settings(cls, config: RuntimeConfig | None = None) -> "DistributedRuntime":
        """Connect per config: remote hub if ``hub_target()`` (replica
        list or single address) is set, else an in-memory one."""
        config = config or RuntimeConfig.from_env()
        hub: Hub
        if config.hub_target():
            hub = await RemoteHub.connect(config.hub_target(), config.connect_timeout_s)
        else:
            hub = InMemoryHub()
        return cls(hub, config)

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
        except ConnectionError:
            log.error("hub connection lost in keepalive; shutting down")
            self.runtime.shutdown()

    # -- endpoint serving --------------------------------------------------

    _uds_seq = 0

    async def _endpoint_server(self) -> EndpointServer:
        if self._server is None:
            uds_path = None
            if self.config.uds_dir:
                DistributedRuntime._uds_seq += 1
                uds_path = os.path.join(
                    self.config.uds_dir,
                    f"dyn-{os.getpid()}-{DistributedRuntime._uds_seq}.sock",
                )
            self._server = EndpointServer(host=self.config.host, uds_path=uds_path)
            await self._server.start()
        return self._server

    async def serve_endpoint(
        self,
        endpoint: Endpoint,
        handler: Handler,
        *,
        metadata: dict[str, Any],
        graceful_shutdown: bool = True,
    ) -> ServedEndpoint:
        lease = await self.lease_id()
        instance_id = self._alloc_instance_id(lease)
        if self._local_ok:
            # in-proc hub => one-process deployment: skip the TCP hop
            inst = Instance(
                instance_id=instance_id,
                namespace=endpoint.namespace,
                component=endpoint.component,
                endpoint=endpoint.name,
                host="local",
                port=0,
                transport="local",
                metadata=metadata,
            )
            self.local_registry.register(inst.wire_path, handler)
        else:
            server = await self._endpoint_server()
            inst = Instance(
                instance_id=instance_id,
                namespace=endpoint.namespace,
                component=endpoint.component,
                endpoint=endpoint.name,
                host=server.host,
                port=server.port,
                transport="tcp",
                metadata=metadata,
                uds=server.uds_path or "",
            )
            server.register(inst.wire_path, handler)
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
        if served.instance.transport == "local":
            self.local_registry.unregister(served.instance.wire_path)
        elif self._server is not None:
            self._server.unregister(served.instance.wire_path)
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
        if self._server is not None:
            await self._server.stop(drain=drain, timeout=drain_timeout)
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        if self._lease_id is not None:
            try:
                await self.hub.revoke_lease(self._lease_id)
            except (ConnectionError, RuntimeError):
                pass
        self.runtime.shutdown()

    async def close(self) -> None:
        await self.shutdown()
        await self.hub.close()
