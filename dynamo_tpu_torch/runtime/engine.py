"""The AsyncEngine abstraction (the counterpart of
dynamo_tpu/runtime/engine.py): a streaming request -> response protocol.

Everything that serves requests - the torch engine, the mocker, each
pipeline operator (preprocessor, backend, migration, routers) - has this
one ``generate(request, context)`` shape, so operators compose into
pipelines and any stage can move across a process boundary.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.context import Context


@runtime_checkable
class AsyncEngine(Protocol):
    """Streaming engine: one request in, many responses out."""

    def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[Any]:  # pragma: no cover - protocol
        ...


class Annotated(dict):
    """Response envelope: either a data item or an out-of-band event
    (routing metadata, health-check probes, errors) without polluting the
    data type."""

    @classmethod
    def from_data(cls, data: Any) -> "Annotated":
        return cls(data=data)

    @classmethod
    def from_event(cls, event: str, data: Any = None) -> "Annotated":
        return cls(event=event, data=data)

    @property
    def data(self) -> Any:
        return self.get("data")

    @property
    def event(self) -> str | None:
        return self.get("event")

    def is_error(self) -> bool:
        return self.get("event") == "error"


async def collect(stream: AsyncIterator[Any]) -> list[Any]:
    """Drain a response stream into a list (test/CLI helper)."""
    return [item async for item in stream]
