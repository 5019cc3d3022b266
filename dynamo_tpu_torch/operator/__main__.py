"""Operator process: ``python -m dynamo_tpu_torch.operator --hub ... --name g``
(or ``python -m dynamo_tpu_torch.cli operator``), the port's copy of
dynamo_tpu/operator/__main__.py.

Reconciles the named DynamoGraphDeployment (hub key ``v1/dgd/{name}``)
with the chosen backend; ``--backend kubectl`` scales Kubernetes
deployments instead of local processes. Prints OPERATOR_READY. SIGTERM
closes the reconciler, and with it the process backend, which SIGTERMs its
workers and waits for them to drain (the reference's operator dies on the
signal and leaves its workers running). ``--log-dir`` keeps each worker's
output.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.operator.backends import make_backend
from dynamo_tpu_torch.operator.controller import Reconciler
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.hub_client import connect_hub
from dynamo_tpu_torch.runtime.logging_util import setup_logging


async def _amain(args: argparse.Namespace) -> None:
    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    if not rcfg.hub_target():
        # an operator against a process-local in-memory hub reconciles
        # nothing anyone can see — fail loudly, not "successfully"
        raise SystemExit(
            "operator: --hub (or DYN_HUB_ADDRESSES / DYN_HUB_ADDRESS) "
            "is required"
        )
    hub = await connect_hub(rcfg.hub_target())
    backend = (
        make_backend(
            "kubectl", namespace=args.k8s_namespace, image=args.k8s_image,
            hub=rcfg.hub_target(), graph=args.name,
        )
        if args.backend == "kubectl"
        else make_backend("process", log_dir=args.log_dir)
    )
    rec = await Reconciler(
        hub, args.name, backend, interval_s=args.interval
    ).start()
    crd_sync = None
    if args.from_crd:
        from dynamo_tpu_torch.operator.crd_sync import CrdSync

        crd_sync = await CrdSync(
            hub, args.name, namespace=args.k8s_namespace
        ).start()
    stop = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
    print("OPERATOR_READY", flush=True)
    try:
        await stop.wait()
    finally:
        if crd_sync is not None:
            await crd_sync.close()
        await rec.close()
        await hub.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("dynamo-tpu operator")
    p.add_argument("--hub", default="",
                   help="hub address or comma-separated replica list "
                   "(default: DYN_HUB_ADDRESSES / DYN_HUB_ADDRESS env)")
    p.add_argument("--name", default="default",
                   help="DynamoGraphDeployment name to reconcile")
    p.add_argument("--backend", default="process",
                   choices=("process", "kubectl"))
    p.add_argument("--k8s-namespace", default="default")
    p.add_argument("--k8s-image", default="",
                   help="container image for MANAGED mode: the operator "
                   "renders+applies full Deployment/Service objects; "
                   "empty = scale-only (Deployments created externally)")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--log-dir", default=None,
                   help="process backend: append each worker's output to "
                   "DIR/{service}-{index}.log (default: discarded)")
    p.add_argument("--from-crd", action="store_true",
                   help="watch the DynamoGraphDeployment CRD on the "
                   "apiserver (deploy/k8s/crd.yaml) and mirror it into "
                   "the hub resource + push status back")
    args = p.parse_args(argv)
    setup_logging()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
