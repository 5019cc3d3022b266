"""PushRouter: client-side request distribution across worker instances (a
copy of dynamo_tpu/runtime/push.py).

Modes: random, round_robin, direct(instance_id). The KV-aware mode wraps
this router in direct mode (kv_router/router.py KvPushRouter). On no
instances or stream death the caller (the migration operator) decides
whether to retry.
"""

from __future__ import annotations

import enum
import random
from contextlib import aclosing
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime.component import Client
from dynamo_tpu_torch.runtime.context import Context, StreamError


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    KV = "kv"


class NoInstancesError(StreamError):
    """No live instances to route to (retryable; migration op backs off)."""


class PushRouter:
    def __init__(self, client: Client, mode: RouterMode = RouterMode.ROUND_ROBIN):
        self.client = client
        self.mode = mode
        self._rr = 0

    @classmethod
    async def from_endpoint(
        cls, endpoint, mode: RouterMode = RouterMode.ROUND_ROBIN
    ) -> "PushRouter":
        client = await endpoint.client().start()
        return cls(client, mode)

    def select(self, instance_id: int | None = None) -> int:
        ids = self.client.instance_ids()
        if not ids:
            raise NoInstancesError(f"no instances for {self.client.endpoint.path}")
        if instance_id is not None:
            if instance_id not in ids:
                raise NoInstancesError(
                    f"instance {instance_id:x} not live for {self.client.endpoint.path}"
                )
            return instance_id
        if self.mode is RouterMode.RANDOM:
            return random.choice(ids)
        # round-robin default
        self._rr = (self._rr + 1) % len(ids)
        return ids[self._rr]

    async def generate(
        self,
        request: Any,
        context: Context,
        *,
        instance_id: int | None = None,
    ) -> AsyncIterator[Any]:
        """Route and stream. ``instance_id`` forces direct mode for this call."""
        target = self.select(instance_id)
        stream = self.client.call_instance(target, request, context)
        async with aclosing(stream):
            async for item in stream:
                yield item
