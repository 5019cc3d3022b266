"""Standalone KV router service: ``python -m dynamo_tpu_torch.kv_router.service``
or ``python -m dynamo_tpu_torch.cli router`` (a copy of
dynamo_tpu/kv_router/service.py).

The equivalent of the reference's ``python -m dynamo.router``
(components/src/dynamo/router/__main__.py:30-102): a routing process that
exposes ``generate`` (KV-route + proxy the stream) and ``best_worker``
(routing decision only) over runtime endpoints. Used as the prefill router
in disaggregated deployments, or as a shared router tier in front of a
large decode pool.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import connect_hub
from dynamo_tpu_torch.runtime.logging_util import setup_logging
from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

log = logging.getLogger("dynamo.router.service")


class RouterService:
    """KV-aware routing for one target component, served as endpoints."""

    def __init__(
        self,
        drt: DistributedRuntime,
        *,
        namespace: str = "dynamo",
        target_component: str = "backend",
        target_endpoint: str = "generate",
        router_component: str = "router",
        config: RouterConfig | None = None,
    ):
        self.drt = drt
        self.namespace = namespace
        self.target_component = target_component
        self.target_endpoint = target_endpoint
        self.router_component = router_component
        self.config = config
        self.kv_push: KvPushRouter | None = None
        self._served: list = []

    async def start(self) -> "RouterService":
        target = (
            self.drt.namespace(self.namespace)
            .component(self.target_component)
            .endpoint(self.target_endpoint)
        )
        push = await PushRouter.from_endpoint(target, RouterMode.DIRECT)
        kv = await KvRouter(
            self.drt.hub,
            f"{self.namespace}/{self.target_component}",
            self.config,
        ).start()
        # NOTE: KvRouter.start() already restored the snapshot and is
        # replaying the retained tail; a second load here would overwrite
        # replayed state mid-flight
        self.kv_push = KvPushRouter(push, kv)

        comp = self.drt.namespace(self.namespace).component(self.router_component)
        self._served.append(
            await comp.endpoint("generate").serve(
                self.generate, metadata={"role": "router",
                                         "target": self.target_component},
            )
        )
        self._served.append(
            await comp.endpoint("best_worker").serve(
                self.best_worker, metadata={"role": "router"},
            )
        )
        return self

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[Any]:
        async for item in self.kv_push.generate(request, context):
            yield item

    async def best_worker(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        token_ids = request.get("token_ids") or []
        wid, overlap = self.kv_push.best_worker_id(
            token_ids, context.id,
            salt=(request.get("multimodal") or {}).get("salt"),
        )
        yield {"worker_id": wid, "overlap_blocks": overlap,
               "finish_reason": "stop"}

    async def close(self) -> None:
        if self.kv_push is not None:
            await self.kv_push.kv_router.save_snapshot()
            await self.kv_push.kv_router.close()


async def _amain(args: argparse.Namespace) -> None:
    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    drt = DistributedRuntime(await connect_hub(rcfg.hub_target()), rcfg)
    svc = RouterService(
        drt,
        namespace=args.namespace,
        target_component=args.component,
        target_endpoint=args.endpoint,
        router_component=args.router_component,
        config=RouterConfig(block_size=args.block_size),
    )
    await svc.start()
    print("ROUTER_READY", flush=True)
    await drt.runtime.wait_for_shutdown()
    await svc.close()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="dynamo-tpu torch standalone KV router")
    p.add_argument("--hub", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend",
                   help="target component to route over")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--router-component", default="router")
    p.add_argument("--block-size", type=int, default=16)
    args = p.parse_args(argv)
    setup_logging()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
