"""Distributed runtime: the foundation layer (the counterpart of
dynamo_tpu/runtime/, the same public surface).

  Runtime / DistributedRuntime  - process + cluster handles
  Namespace / Component / Endpoint / Instance / Client
  AsyncEngine protocol + Context cancellation
  PushRouter with RouterMode
  Hub implementations: InMemoryHub, RemoteHub + hub server
"""

from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context, StreamError
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Annotated
from dynamo_tpu_torch.runtime.hub import Hub, InMemoryHub, WatchEvent
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.component import (
    Client,
    Component,
    Endpoint,
    Instance,
    Namespace,
)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime, Runtime
from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

__all__ = [
    "RuntimeConfig",
    "Context",
    "StreamError",
    "AsyncEngine",
    "Annotated",
    "Hub",
    "InMemoryHub",
    "RemoteHub",
    "WatchEvent",
    "Namespace",
    "Component",
    "Endpoint",
    "Instance",
    "Client",
    "Runtime",
    "DistributedRuntime",
    "PushRouter",
    "RouterMode",
]
