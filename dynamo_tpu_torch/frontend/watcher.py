"""Model discovery: watch cards, build per-model pipelines (the counterpart
of dynamo_tpu/frontend/watcher.py).

ModelWatcher watches the hub ``v1/mdc/`` prefix; for each card it assembles
the serving chain Preprocessor -> Backend -> Migration -> PushRouter ->
instances and registers it in ModelManager under the served model name.
Cards disappearing (lease expiry / deregistration) tear the pipeline down.

A card asking for the KV router or multimodal input raises at pipeline
build (ROADMAP Queue A items 4b and 14); the watcher logs it and keeps
watching, as the reference does for a card it cannot build.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.frontend.model_card import MDC_ROOT, ModelDeploymentCard
from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.pipeline import build_chain
from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

log = logging.getLogger("dynamo_tpu_torch.discovery")


@dataclass
class ModelPipeline:
    card: ModelDeploymentCard
    preprocessor: OpenAIPreprocessor
    engine: Any  # Backend(Migration(router))
    push_router: PushRouter

    async def close(self) -> None:
        await self.push_router.client.close()

    def generate(self, preprocessed: dict, context: Context) -> AsyncIterator[dict]:
        return self.engine.generate(preprocessed, context)


class ModelManager:
    def __init__(self) -> None:
        self._models: dict[str, ModelPipeline] = {}

    def get(self, name: str) -> ModelPipeline | None:
        return self._models.get(name)

    def add(self, pipeline: ModelPipeline) -> None:
        self._models[pipeline.card.name] = pipeline

    async def remove(self, name: str) -> None:
        pipe = self._models.pop(name, None)
        if pipe is not None:
            await pipe.close()

    def names(self) -> list[str]:
        return sorted(self._models)

    def cards(self) -> list[ModelDeploymentCard]:
        return [p.card for p in self._models.values()]


async def build_pipeline(
    drt: DistributedRuntime, card: ModelDeploymentCard
) -> ModelPipeline:
    if card.router_mode == "kv":
        raise NotImplementedError(
            f"model {card.name!r}: router_mode 'kv' needs the KV router "
            "(ROADMAP Queue A item 4b); register with 'round_robin'"
        )
    if card.mm_tokens_per_image or card.mm_video_frames:
        raise NotImplementedError(
            f"model {card.name!r}: multimodal input is ROADMAP Queue A item 14"
        )
    tokenizer = load_tokenizer(card.tokenizer)
    preprocessor = OpenAIPreprocessor(
        tokenizer,
        model_name=card.name,
        context_length=card.context_length,
        chat_template=card.chat_template,
        tool_call_parser=card.tool_call_parser,
        reasoning_parser=card.reasoning_parser,
    )
    endpoint = (
        drt.namespace(card.namespace)
        .component(card.component)
        .endpoint(card.endpoint)
    )
    mode = RouterMode.RANDOM if card.router_mode == "random" else RouterMode.ROUND_ROBIN
    push = await PushRouter.from_endpoint(endpoint, mode)
    # chains are data through the operator registry: cards may splice extra
    # operators via runtime_config["operators"] between backend and router
    extra = list(card.runtime_config.get("operators") or [])
    backend = build_chain(
        [
            ("backend", {"tokenizer": tokenizer}),
            *extra,
            ("migration", {"migration_limit": card.migration_limit}),
        ],
        push,
    )
    return ModelPipeline(
        card=card, preprocessor=preprocessor, engine=backend, push_router=push,
    )


class ModelWatcher:
    def __init__(self, drt: DistributedRuntime, manager: ModelManager):
        self.drt = drt
        self.manager = manager
        self._task: asyncio.Task | None = None
        self._known_keys: dict[str, str] = {}  # card key -> model name
        self._model_refs: dict[str, set[str]] = {}  # model name -> card keys

    async def start(self) -> "ModelWatcher":
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._watch())
        return self

    async def wait_for_model(self, name: str | None = None, timeout: float = 30.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            if name is None and self.manager.names():
                return
            if name is not None and self.manager.get(name) is not None:
                return
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"model {name!r} not discovered in {timeout}s")
            await asyncio.sleep(0.05)

    async def _watch(self) -> None:
        try:
            async for ev in self.drt.hub.watch_prefix(MDC_ROOT + "/"):
                try:
                    if ev.kind == "put" and ev.value:
                        card = ModelDeploymentCard.from_dict(ev.value)
                        self._known_keys[ev.key] = card.name
                        refs = self._model_refs.setdefault(card.name, set())
                        refs.add(ev.key)
                        if self.manager.get(card.name) is None:
                            pipe = await build_pipeline(self.drt, card)
                            self.manager.add(pipe)
                            log.info("model %r discovered (%s)", card.name, ev.key)
                    elif ev.kind == "delete":
                        name = self._known_keys.pop(ev.key, None)
                        if name is not None:
                            refs = self._model_refs.get(name, set())
                            refs.discard(ev.key)
                            if not refs:  # last worker gone
                                self._model_refs.pop(name, None)
                                await self.manager.remove(name)
                                log.info("model %r removed", name)
                except Exception:  # noqa: BLE001 - keep watching
                    log.exception("failed handling model card event %s", ev.key)
        except asyncio.CancelledError:
            pass

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
        for name in list(self.manager.names()):
            await self.manager.remove(name)
        self._known_keys.clear()
        self._model_refs.clear()
