"""Model discovery: watch cards, build per-model pipelines (the counterpart
of dynamo_tpu/frontend/watcher.py).

ModelWatcher watches the hub ``v1/mdc/`` prefix; for each card it assembles
the serving chain Preprocessor -> Backend -> Migration -> router ->
instances and registers it in ModelManager under the served model name.
The router is a PushRouter (round_robin / random cards) or, for a "kv"
card, a KvPushRouter over a direct-mode PushRouter: a KvRouter fed by the
workers' KV events and load picks each request's instance. Cards
disappearing (lease expiry / deregistration) tear the pipeline down.

A multimodal card (``mm_tokens_per_image``) gets the encode hop: a
round-robin PushRouter over the namespace's encoder component and the
``mm_encode`` operator (multimodal/operator.py) between the backend and
migration, so image refs resolve to embeddings before routing; the pipeline
closes the encode router with the rest. A card the watcher cannot build is
logged and the watch goes on, as the reference's.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.frontend.model_card import MDC_ROOT, ModelDeploymentCard
from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
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
    kv_router: KvRouter | None = None
    encode_router: PushRouter | None = None  # the multimodal encode hop

    async def close(self) -> None:
        if self.kv_router is not None:
            await self.kv_router.close()
        if self.encode_router is not None:
            await self.encode_router.client.close()
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
    tokenizer = load_tokenizer(card.tokenizer)
    preprocessor = OpenAIPreprocessor(
        tokenizer,
        model_name=card.name,
        context_length=card.context_length,
        chat_template=card.chat_template,
        tool_call_parser=card.tool_call_parser,
        reasoning_parser=card.reasoning_parser,
        mm_tokens_per_image=card.mm_tokens_per_image,
        image_token_id=card.image_token_id,
        mm_video_frames=card.mm_video_frames,
    )
    endpoint = (
        drt.namespace(card.namespace)
        .component(card.component)
        .endpoint(card.endpoint)
    )
    mode = {
        "kv": RouterMode.KV,
        "round_robin": RouterMode.ROUND_ROBIN,
        "random": RouterMode.RANDOM,
    }.get(card.router_mode, RouterMode.ROUND_ROBIN)
    push = await PushRouter.from_endpoint(
        endpoint, RouterMode.DIRECT if mode is RouterMode.KV else mode)
    kv_router: KvRouter | None = None
    router_engine: Any = push
    if mode is RouterMode.KV:
        kv_router = await KvRouter(
            drt.hub, card.component_path,
            RouterConfig(block_size=card.kv_block_size),
        ).start()
        # the block size and the hash salt MUST match what the workers hash
        # their KV events with (engines hash unsalted unless the card says
        # otherwise): a mismatch silently zeroes every prefix overlap
        router_engine = KvPushRouter(
            push, kv_router, salt=card.runtime_config.get("kv_salt"))
    # chains are data through the operator registry: cards may splice extra
    # operators via runtime_config["operators"] between backend and router
    extra = list(card.runtime_config.get("operators") or [])
    # a multimodal card gets the encode hop: image refs resolve to embeddings
    # at the encoder component before migration and routing
    encode_router: PushRouter | None = None
    mm_ops: list = []
    if card.mm_tokens_per_image:
        from dynamo_tpu_torch.multimodal.worker import ENCODER_COMPONENT, ENCODER_ENDPOINT

        encode_router = await PushRouter.from_endpoint(
            drt.namespace(card.namespace).component(ENCODER_COMPONENT)
            .endpoint(ENCODER_ENDPOINT), RouterMode.ROUND_ROBIN)
        mm_ops = [("mm_encode", {"encode_router": encode_router})]
    backend = build_chain(
        [
            ("backend", {"tokenizer": tokenizer}),
            *mm_ops,
            *extra,
            ("migration", {"migration_limit": card.migration_limit}),
        ],
        router_engine,
    )
    return ModelPipeline(
        card=card, preprocessor=preprocessor, engine=backend, push_router=push,
        kv_router=kv_router, encode_router=encode_router,
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
