"""Generic operator graph: named, composable AsyncEngine operators (a copy of
dynamo_tpu/runtime/pipeline.py).

Every stage of a serving chain implements the same surface
(``generate(request, context) -> async iterator``), so chains are DATA: an
ordered list of operator names + kwargs. The frontend's model pipelines
build through this registry (frontend/watcher.py). Operators register
lazily by import path.
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Callable

log = logging.getLogger("dynamo_tpu_torch.pipeline")

__all__ = ["OperatorRegistry", "registry", "build_chain"]


class OperatorRegistry:
    """name -> factory(sink_engine, **kwargs) -> engine."""

    def __init__(self) -> None:
        self._factories: dict[str, Callable] = {}
        self._lazy: dict[str, tuple[str, str]] = {}

    def register(self, name: str, factory: Callable) -> None:
        self._factories[name] = factory

    def register_lazy(self, name: str, module: str, attr: str) -> None:
        """Register by import path; resolved on first build."""
        self._lazy[name] = (module, attr)

    def names(self) -> list[str]:
        return sorted(set(self._factories) | set(self._lazy))

    def _resolve(self, name: str) -> Callable:
        if name in self._factories:
            return self._factories[name]
        if name in self._lazy:
            module, attr = self._lazy[name]
            factory = getattr(importlib.import_module(module), attr)
            self._factories[name] = factory
            return factory
        raise KeyError(
            f"unknown pipeline operator {name!r}; registered: {self.names()}"
        )

    def build(self, name: str, sink: Any, /, **kwargs: Any) -> Any:
        # positional-only: operator kwargs may legitimately be called
        # "name" or "sink"
        return self._resolve(name)(sink, **kwargs)


registry = OperatorRegistry()

# builtin operator table. Factories take (sink, **kwargs) and return an
# AsyncEngine-shaped object.
registry.register_lazy(
    "migration", "dynamo_tpu_torch.frontend.migration", "make_operator"
)
registry.register_lazy(
    "backend", "dynamo_tpu_torch.frontend.backend_op", "make_operator"
)
registry.register_lazy(
    "mm_encode", "dynamo_tpu_torch.multimodal.operator", "make_operator"
)


def build_chain(ops: list, sink: Any, *, reg: OperatorRegistry | None = None):
    """Compose operators onto ``sink``, OUTERMOST FIRST.

    ``ops`` entries are ``"name"`` or ``("name", {kwargs})``:
    ``build_chain(["backend", "migration"], router)`` produces
    backend(migration(router)): requests flow left to right, responses
    right to left.
    """
    reg = reg or registry
    engine = sink
    normalized = []
    for op in ops:
        if isinstance(op, str):
            normalized.append((op, {}))
        elif isinstance(op, (list, tuple)) and len(op) == 2 and isinstance(
            op[0], str
        ) and isinstance(op[1], dict):
            normalized.append((op[0], dict(op[1])))
        else:
            raise ValueError(
                f"bad pipeline operator entry {op!r}: expected \"name\" "
                "or [name, kwargs]"
            )
    for name, kwargs in reversed(normalized):
        engine = reg.build(name, engine, **kwargs)
    return engine
