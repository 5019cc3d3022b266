"""Request/response data plane: the in-process part of
dynamo_tpu/runtime/transport.py.

In-process instances short-circuit the wire: a ``LocalRegistry`` maps each
served endpoint's wire path to its handler, and ``call_local`` streams the
handler's items with no serialization. That is all the one-process stack
needs. The TCP ``EndpointServer`` / ``InstanceChannel`` pair and its framing
wait for ROADMAP Queue A item 4b.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.runtime.context import Context

Handler = Callable[[Any, Context], AsyncIterator[Any]]


class LocalRegistry:
    """Process-local instance registry for zero-copy in-proc dispatch."""

    def __init__(self) -> None:
        self._handlers: dict[str, Handler] = {}

    def register(self, path: str, handler: Handler) -> None:
        self._handlers[path] = handler

    def unregister(self, path: str) -> None:
        self._handlers.pop(path, None)

    def get(self, path: str) -> Handler | None:
        return self._handlers.get(path)


async def call_local(
    handler: Handler, payload: Any, context: Context
) -> AsyncIterator[Any]:
    """In-process dispatch path (no serialization)."""
    async for item in handler(payload, context):
        yield item
