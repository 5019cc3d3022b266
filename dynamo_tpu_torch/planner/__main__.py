"""``python -m dynamo_tpu_torch.planner`` (or ``python -m dynamo_tpu_torch.cli
planner``) — SLA planner service, the port's copy of dynamo_tpu/planner/__main__.py
with the same flags.

Upstream: ``python -m dynamo.planner`` (planner_sla.py). Scrapes the
frontend's /metrics, plans every --adjustment-interval, and publishes
desired replica counts to the hub (virtual connector) for a supervisor to
act on. ``--dryrun-trace`` replays a JSONL trace of
{num_req, isl, osl[, ttft, itl]} records instead and prints decisions.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

from dynamo_tpu_torch.planner.connector import (
    LoggingConnector,
    ProcessConnector,
    VirtualConnector,
)
from dynamo_tpu_torch.planner.core import (
    FrontendMetricsSource,
    PlannerConfig,
    SlaPlanner,
)
from dynamo_tpu_torch.planner.interpolation import (
    DecodeInterpolator,
    PrefillInterpolator,
    synthetic_profile,
)
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.logging_util import setup_logging


def build_planner(args, hub=None) -> SlaPlanner:
    if args.profile_dir:
        prefill = PrefillInterpolator(args.profile_dir)
        decode = DecodeInterpolator(args.profile_dir)
    else:
        prof = synthetic_profile()
        prefill = PrefillInterpolator(prof)
        decode = DecodeInterpolator(prof)
    cfg = PlannerConfig(
        namespace=args.namespace,
        model=args.model,
        ttft_sla_s=args.ttft,
        itl_sla_s=args.itl,
        adjustment_interval_s=args.adjustment_interval,
        predictor=args.load_predictor,
        min_endpoint=args.min_endpoint,
        max_chip_budget=args.max_chip_budget,
        prefill_engine_num_chips=args.prefill_engine_num_chips,
        decode_engine_num_chips=args.decode_engine_num_chips,
        no_correction=args.no_correction,
        decode_component=args.decode_component,
        prefill_component=args.prefill_component,
    )
    if args.no_operation or hub is None:
        connector = LoggingConnector()
    elif args.connector == "process":
        # closes the loop locally: this planner process spawns/retires
        # mocker workers itself (ref tests/planner scaling runs)
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

        connector = ProcessConnector(
            DistributedRuntime(hub), cfg.namespace,
            component=cfg.decode_component,
            prefill_component=cfg.prefill_component,
            model_name=cfg.model or "mock-model",
        )
    else:
        connector = VirtualConnector(hub, cfg.namespace, cfg.model)
    source = (
        FrontendMetricsSource(args.metrics_url, cfg.model)
        if args.metrics_url
        else None
    )

    worker_counts = None
    if hub is not None:
        def _count_workers(keys: dict) -> int:
            # v1/instances/{ns}/{component}/{endpoint}/{id}: count serving
            # endpoints, excluding the control-plane "admin" one (endpoint
            # names are configurable, so don't hardcode "generate")
            n = 0
            for key in keys:
                parts = key.split("/")
                if len(parts) >= 6 and parts[4] != "admin":
                    n += 1
            return n

        async def worker_counts():
            p = await hub.get_prefix(
                f"v1/instances/{cfg.namespace}/{cfg.prefill_component}/"
            )
            d = await hub.get_prefix(
                f"v1/instances/{cfg.namespace}/{cfg.decode_component}/"
            )
            return _count_workers(p), _count_workers(d)

    return SlaPlanner(
        cfg, prefill, decode, connector=connector,
        metrics_source=source, worker_counts=worker_counts,
    )


async def _amain(args) -> None:
    if args.dryrun_trace:
        planner = build_planner(args)
        # trace read AND parsed off the loop: dryrun
        # traces can be hundreds of MB of JSONL
        def read_trace() -> list[dict]:
            with open(args.dryrun_trace) as f:
                return [json.loads(line) for line in f if line.strip()]

        trace = await asyncio.to_thread(read_trace)
        decisions = await planner.dryrun(trace)
        for i, (p, d) in enumerate(decisions):
            print(json.dumps({"interval": i, "prefill": p, "decode": d}))
        return

    from dynamo_tpu_torch.runtime.hub_client import connect_hub

    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    hub = await connect_hub(rcfg.hub_target())
    planner = build_planner(args, hub=hub).start()
    # SIGTERM stops the loop between iterations and closes the hub client
    # (the reference's planner dies on the signal)
    stop = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
    print("PLANNER_READY", flush=True)
    try:
        await stop.wait()
    finally:
        await planner.close()
        if isinstance(planner.connector, ProcessConnector):
            await planner.connector.close()  # drains the mock workers it spawned
        await hub.close()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="dynamo-tpu SLA planner")
    p.add_argument("--hub", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--model", default=None)
    p.add_argument("--metrics-url", default="http://127.0.0.1:8000/metrics")
    p.add_argument("--ttft", type=float, default=0.5, help="TTFT SLA (s)")
    p.add_argument("--itl", type=float, default=0.05, help="ITL SLA (s)")
    p.add_argument("--adjustment-interval", type=float, default=60.0)
    p.add_argument("--load-predictor", default="ar",
                   choices=["constant", "ar", "arima", "holt", "prophet"])
    p.add_argument("--min-endpoint", type=int, default=1)
    p.add_argument("--max-chip-budget", type=int, default=64)
    p.add_argument("--prefill-engine-num-chips", type=int, default=1)
    p.add_argument("--decode-engine-num-chips", type=int, default=1)
    p.add_argument("--no-correction", action="store_true")
    p.add_argument("--no-operation", action="store_true",
                   help="log decisions without writing to the hub")
    p.add_argument("--connector", default="virtual",
                   choices=["virtual", "process"],
                   help="virtual: publish desired counts to the hub for a "
                        "supervisor; process: spawn/retire local mocker "
                        "workers directly (self-contained scaling loop)")
    p.add_argument("--prefill-component", default="prefill")
    p.add_argument("--decode-component", default="backend")
    p.add_argument("--profile-dir", default=None,
                   help="pre-deployment profiling npz dir (default: "
                        "synthetic analytic profile)")
    p.add_argument("--dryrun-trace", default=None,
                   help="JSONL trace to replay without a cluster")
    args = p.parse_args(argv)
    setup_logging()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
