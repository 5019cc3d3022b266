"""Frontend process: ``python -m dynamo_tpu_torch.frontend`` (the
counterpart of dynamo_tpu/frontend/__main__.py).

Connects to the hub, watches for model cards, serves the OpenAI API and
prints ``DYNAMO_HTTP=host:port`` once listening. ``--grpc-port N`` also
serves the KServe gRPC inference protocol (grpc/) and prints
``DYNAMO_GRPC=host:port``. SIGTERM stops it.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import connect_hub
from dynamo_tpu_torch.runtime.logging_util import setup_logging


async def _amain(args: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_env()
    if args.hub:
        cfg.override_hub(args.hub)
    if args.port is not None:
        cfg.http_port = args.port
    drt = DistributedRuntime(await connect_hub(cfg.hub_target()), cfg)
    try:
        asyncio.get_running_loop().add_signal_handler(
            signal.SIGTERM, drt.runtime.shutdown)
    except (NotImplementedError, RuntimeError):  # pragma: no cover
        pass  # non-unix event loop
    manager = ModelManager()
    watcher = await ModelWatcher(drt, manager).start()
    frontend = HttpFrontend(
        manager, host=args.host, port=cfg.http_port, drt=drt,
        request_timeout_s=cfg.request_timeout_s,
    )
    grpc_frontend = None
    try:
        host, port = await frontend.start()
        print(f"DYNAMO_HTTP={host}:{port}", flush=True)
        if args.grpc_port is not None:
            from dynamo_tpu_torch.grpc import KserveGrpcFrontend

            grpc_frontend = await KserveGrpcFrontend(
                manager, host=args.host, port=args.grpc_port,
                request_timeout_s=cfg.request_timeout_s,
            ).start()
            print(f"DYNAMO_GRPC={args.host}:{grpc_frontend.port}", flush=True)
        await drt.runtime.wait_for_shutdown()
    finally:
        if grpc_frontend is not None:
            await grpc_frontend.stop()
        await frontend.stop()
        await watcher.close()
        await drt.close()


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu OpenAI frontend (torch port)")
    p.add_argument("--hub", default=None, help="hub address host:port")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (default DYN_HTTP_PORT or 8000)")
    p.add_argument("--grpc-port", type=int, default=None,
                   help="also serve the KServe gRPC inference protocol on "
                        "this port (0 = ephemeral)")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    setup_logging()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
