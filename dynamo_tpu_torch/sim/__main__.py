"""``python -m dynamo_tpu_torch.sim``: run the cluster chaos scenarios and
write the saturation-curve artifact.

    python -m dynamo_tpu_torch.sim --scenario all --workers 200
    python -m dynamo_tpu_torch.sim --scenario churn,partition --workers 32 \
        --speedup 200 --out build/sim/smoke.json

Exit code is 0 only when every scenario's invariants pass. The artifact's
schema is the reference's (``dynamo-sim/v1``, see the README's "Cluster
simulation" section); it is written to ``build/sim/SIM.json`` unless
``--out`` names another file.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
from pathlib import Path

from dynamo_tpu_torch.sim.harness import SimConfig, run_scenarios, write_artifact
from dynamo_tpu_torch.sim.scenarios import SCENARIOS

DEFAULT_OUT = str(Path("build") / "sim" / "SIM.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "dynamo-tpu cluster chaos sim",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scenario", default="all",
                   help="'all' or comma-separated names: "
                        + ",".join(SCENARIOS))
    p.add_argument("--workers", type=int, default=200)
    p.add_argument("--speedup", type=float, default=150.0)
    p.add_argument("--fleet-sizes", default=None,
                   help="pick_scaling curve sizes, e.g. 50,100,200 "
                        "(default: workers/4, workers/2, workers)")
    p.add_argument("--trace-requests", type=int, default=0,
                   help="replay length (0 = 2 * workers)")
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--lease-s", type=float, default=0.5)
    p.add_argument("--storm-duration-s", type=float, default=8.0)
    p.add_argument("--partition-window-s", type=float, default=3.0)
    p.add_argument("--churn-waves", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.WARNING,
        format="%(asctime)s %(name)s %(message)s",
    )
    cfg = SimConfig(
        workers=args.workers,
        speedup=args.speedup,
        fleet_sizes=tuple(
            int(s) for s in args.fleet_sizes.split(",")
        ) if args.fleet_sizes else (),
        trace_requests=args.trace_requests,
        replicas=args.replicas,
        lease_s=args.lease_s,
        storm_duration_s=args.storm_duration_s,
        partition_window_s=args.partition_window_s,
        churn_waves=args.churn_waves,
        seed=args.seed,
    )
    names = (
        list(SCENARIOS)
        if args.scenario == "all"
        else [s.strip() for s in args.scenario.split(",") if s.strip()]
    )
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        p.error(f"unknown scenario(s) {unknown}; have {list(SCENARIOS)}")

    artifact = asyncio.run(run_scenarios(cfg, names))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    write_artifact(artifact, args.out)
    for name, sc in artifact["scenarios"].items():
        print(f"{name:>20}: {sc['verdict']:5} ({sc['wall_s']}s)"
              + (f" — {sc.get('reason')}" if sc.get("reason") else ""))
    print(json.dumps({
        "verdict": artifact["verdict"], "artifact": args.out,
    }))
    return 0 if artifact["verdict"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
