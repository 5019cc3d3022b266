"""Component model: Namespace -> Component -> Endpoint tree (the counterpart
of dynamo_tpu/runtime/component.py).

Each live worker serving an endpoint registers an ``Instance`` in the hub
KV store under ``v1/instances/{ns}/{component}/{endpoint}/{instance_id}``,
bound to its lease: when the lease dies the key goes, and every watcher
(routers, clients) sees the worker disappear.

The port's ``Client`` serves instances of transport ``"local"`` (handlers
in this process). A ``"tcp"`` instance raises StreamError until the TCP
transport is ported (ROADMAP Queue A item 4b).
"""

from __future__ import annotations

import asyncio
import logging
from contextlib import aclosing
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, AsyncIterator

from dynamo_tpu_torch.runtime.context import Context, StreamError
from dynamo_tpu_torch.runtime.transport import Handler, call_local

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

log = logging.getLogger("dynamo_tpu_torch.component")

INSTANCE_ROOT = "v1/instances"


@dataclass(frozen=True)
class Instance:
    """One live worker registration for an endpoint."""

    instance_id: int
    namespace: str
    component: str
    endpoint: str
    host: str
    port: int
    transport: str = "tcp"  # "tcp" | "local"
    metadata: dict[str, Any] = field(default_factory=dict)
    uds: str = ""

    @property
    def path(self) -> str:
        return f"{INSTANCE_ROOT}/{self.namespace}/{self.component}/{self.endpoint}/{self.instance_id:x}"

    @property
    def endpoint_path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.endpoint}"

    @property
    def wire_path(self) -> str:
        """Handler-registry key: instance-qualified so one process can serve
        several instances of the same endpoint."""
        return f"{self.endpoint_path}@{self.instance_id:x}"

    def to_dict(self) -> dict[str, Any]:
        return {
            "instance_id": self.instance_id,
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "host": self.host,
            "port": self.port,
            "transport": self.transport,
            "metadata": self.metadata,
            "uds": self.uds,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Instance":
        return cls(**{k: d[k] for k in (
            "instance_id", "namespace", "component", "endpoint",
            "host", "port", "transport", "metadata", "uds",
        ) if k in d})


class Namespace:
    def __init__(self, drt: "DistributedRuntime", name: str):
        self._drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self._drt, self.name, name)


class Component:
    def __init__(self, drt: "DistributedRuntime", namespace: str, name: str):
        self._drt = drt
        self.namespace = namespace
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.name}"

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._drt, self.namespace, self.name, name)


class Endpoint:
    def __init__(self, drt: "DistributedRuntime", namespace: str, component: str, name: str):
        self._drt = drt
        self.namespace = namespace
        self.component = component
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    @property
    def instance_prefix(self) -> str:
        return f"{INSTANCE_ROOT}/{self.namespace}/{self.component}/{self.name}/"

    async def serve(
        self,
        handler: Handler,
        *,
        metadata: dict[str, Any] | None = None,
        graceful_shutdown: bool = True,
    ) -> "ServedEndpoint":
        """Register + serve this endpoint with ``handler``."""
        return await self._drt.serve_endpoint(
            self, handler, metadata=metadata or {}, graceful_shutdown=graceful_shutdown
        )

    def client(self) -> "Client":
        return Client(self._drt, self)


@dataclass
class ServedEndpoint:
    """Handle to a live served endpoint (for deregistration/drain)."""

    instance: Instance
    endpoint: Endpoint
    _drt: "DistributedRuntime"

    async def shutdown(self, drain: bool = True) -> None:
        await self._drt.deregister_endpoint(self, drain=drain)


class Client:
    """Endpoint client: watches live instances and issues calls."""

    def __init__(self, drt: "DistributedRuntime", endpoint: Endpoint):
        self._drt = drt
        self.endpoint = endpoint
        self._instances: dict[int, Instance] = {}
        self._watch_task: asyncio.Task | None = None
        self._started = False
        self._events: asyncio.Event = asyncio.Event()  # set on any membership change
        # bumped on every membership change
        self.membership_gen = 0

    async def start(self) -> "Client":
        if self._started:
            return self
        self._started = True
        self._watch_task = asyncio.get_running_loop().create_task(self._watch())
        return self

    async def _watch(self) -> None:
        try:
            async for ev in self._drt.hub.watch_prefix(self.endpoint.instance_prefix):
                if ev.kind == "put" and ev.value:
                    inst = Instance.from_dict(ev.value)
                    self._instances[inst.instance_id] = inst
                elif ev.kind == "delete":
                    iid = int(ev.key.rsplit("/", 1)[-1], 16)
                    self._instances.pop(iid, None)
                self.membership_gen += 1
                self._events.set()
        except asyncio.CancelledError:
            pass
        except ConnectionError:
            log.warning("hub watch lost for %s", self.endpoint.path)

    def instances(self) -> list[Instance]:
        return list(self._instances.values())

    def instance_ids(self) -> list[int]:
        return sorted(self._instances)

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> list[Instance]:
        await self.start()
        deadline = asyncio.get_running_loop().time() + timeout
        while len(self._instances) < n:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"{self.endpoint.path}: {len(self._instances)}/{n} instances after {timeout}s"
                )
            self._events.clear()
            try:
                await asyncio.wait_for(self._events.wait(), remaining)
            except asyncio.TimeoutError:
                continue
        return self.instances()

    async def membership_changed(self) -> None:
        """Wait for the next instance add/remove."""
        self._events.clear()
        await self._events.wait()

    async def call_instance(
        self, instance_id: int, payload: Any, context: Context
    ) -> AsyncIterator[Any]:
        """Issue a streaming call to a specific instance."""
        inst = self._instances.get(instance_id)
        if inst is None:
            raise StreamError(f"instance {instance_id:x} not found for {self.endpoint.path}")
        if inst.transport != "local":
            raise StreamError(
                f"instance {instance_id:x} of {self.endpoint.path} serves over "
                f"{inst.transport!r}; the port serves in-process instances only "
                "until the TCP transport lands (ROADMAP Queue A item 4b)"
            )
        handler = self._drt.local_registry.get(inst.wire_path)
        if handler is None:
            raise StreamError(f"local instance {instance_id:x} has no handler")
        local_stream = call_local(handler, payload, context)
        async with aclosing(local_stream):
            async for item in local_stream:
                yield item

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
