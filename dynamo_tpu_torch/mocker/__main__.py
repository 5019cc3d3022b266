"""Mock worker fleet launcher: ``python -m dynamo_tpu_torch.mocker`` or
``python -m dynamo_tpu_torch.cli mocker``.

Registers N mock engine workers against a hub (ref: components/src/dynamo/
mocker - ``python -m dynamo.mocker``). Each worker is a full endpoint
instance with its own KV pool, cache-event stream, and metrics stream, so a
frontend + KV router sees an N-worker deployment.

A copy of ``dynamo_tpu/mocker/__main__.py`` without uvloop (the port runs
on the standard event loop).
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineConfig
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import connect_hub
from dynamo_tpu_torch.runtime.logging_util import setup_logging

log = logging.getLogger("dynamo.mocker")


async def launch_mock_worker(
    drt: DistributedRuntime,
    namespace: str,
    component: str,
    endpoint: str,
    config: MockEngineConfig,
    *,
    model_name: str = "mock-model",
    register_card: bool = False,
    router_mode: str = "kv",
    model_type: str = "chat",
    tool_call_parser: str | None = None,
    reasoning_parser: str | None = None,
    runtime_config: dict | None = None,
) -> tuple[MockEngine, object]:
    """Serve one mock worker; returns (engine, served_handle)."""
    engine = MockEngine(config)
    ep = drt.namespace(namespace).component(component).endpoint(endpoint)
    if register_card:
        from dynamo_tpu_torch.frontend.model_card import register_llm

        served, _card = await register_llm(
            drt, ep, engine.generate,
            model_name=model_name,
            model_type=model_type,
            tokenizer="mock",
            kv_block_size=config.block_size,
            router_mode=router_mode,
            tool_call_parser=tool_call_parser,
            reasoning_parser=reasoning_parser,
            runtime_config=runtime_config,
            metadata={"engine": "mocker", "dp_rank": config.data_parallel_rank},
        )
    else:
        served = await ep.serve(
            engine.generate,
            metadata={"model": model_name, "engine": "mocker",
                      "dp_rank": config.data_parallel_rank},
        )
    wid = served.instance.instance_id
    comp_path = f"{namespace}/{component}"
    engine.events = KvEventPublisher(drt.hub, comp_path, wid).start()
    engine.metrics = WorkerMetricsPublisher(drt.hub, comp_path, wid).start()
    engine._publish_metrics()
    log.info("mock worker %x up (%d kv blocks)", wid, config.total_kv_blocks)
    return engine, served


async def _amain(args: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_env()
    if args.hub:
        cfg.override_hub(args.hub)
    drt = DistributedRuntime(await connect_hub(cfg.hub_target()), cfg)
    for i in range(args.num_workers):
        mcfg = MockEngineConfig(
            block_size=args.block_size,
            total_kv_blocks=args.num_blocks,
            speedup_ratio=args.speedup_ratio,
            data_parallel_rank=i if args.dp_ranks else 0,
            seed=i,
        )
        await launch_mock_worker(
            drt, args.namespace, args.component, args.endpoint, mcfg,
            model_name=args.model_name, register_card=True,
            router_mode=args.router_mode,
        )
    print(f"MOCKERS_READY {args.num_workers}", flush=True)
    await drt.runtime.wait_for_shutdown()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="dynamo-tpu mock worker fleet")
    p.add_argument("--hub", default=None, help="hub address host:port")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--model-name", default="mock-model")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--num-blocks", type=int, default=4096)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--speedup-ratio", type=float, default=1.0)
    p.add_argument("--router-mode", default="kv",
                   choices=["kv", "round_robin", "random"])
    p.add_argument("--dp-ranks", action="store_true",
                   help="give each worker a distinct data_parallel_rank")
    args = p.parse_args(argv)
    setup_logging()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
