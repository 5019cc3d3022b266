"""Pre-deployment SLA profiler: sweep a deployment, emit planner grids;
``cli profile``.

The port of the reference's ``benchmarks/profile_sla.py`` (the role of
its upstream's benchmarks/profiler/profile_sla.py + profile_prefill /
profile_decode): measure TTFT-vs-ISL at concurrency 1 and ITL/throughput
over a (concurrency x context) grid through ``loadgen.run_load``, then
write the regular-grid npz files the planner's interpolators consume
(``planner/interpolation.py`` format: prefill.npz + decode.npz, the same
keys, dtypes and shapes as the reference's, so either package's planner
reads them).

``python -m dynamo_tpu_torch.cli profile --url ... --model m --out profiles/cfg``
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

import numpy as np

from dynamo_tpu_torch.profiling.loadgen import run_load

__all__ = ["amain", "main", "profile_decode", "profile_prefill"]


async def profile_prefill(url: str, model: str, isls: list[int],
                          requests_per_point: int = 4) -> dict:
    """TTFT(isl) + saturated prefill throughput/chip at concurrency 1."""
    ttft, thpt = [], []
    for isl in isls:
        res = await run_load(
            url, model, concurrency=1, num_requests=requests_per_point,
            isl=isl, osl=1, warmup=1,
        )
        ok = [r for r in res.results if r.ok and r.ttft_s]
        if not ok:
            raise RuntimeError(f"no successful probes at isl={isl}")
        t = float(np.median([r.ttft_s for r in ok]))
        ttft.append(t)
        # prompt tokens processed per second of TTFT ~ prefill throughput
        thpt.append(isl / t)
    return {
        "prefill_isl": np.asarray(isls, np.float64),
        "prefill_ttft_s": np.asarray(ttft, np.float64),
        "prefill_thpt_per_chip": np.asarray(thpt, np.float64),
    }


async def profile_decode(
    url: str, model: str, concurrencies: list[int], contexts: list[int],
    max_kv_tokens: int, osl: int = 32, requests_per_point: int = 8,
) -> dict:
    """ITL + output throughput over the (kv usage x context) grid."""
    ny, nx = len(contexts), len(concurrencies)
    itl = np.zeros((ny, nx))
    thpt = np.zeros((ny, nx))
    kv_usage = np.zeros((nx,))
    for xi, conc in enumerate(concurrencies):
        for yi, ctx in enumerate(contexts):
            res = await run_load(
                url, model, concurrency=conc,
                num_requests=max(requests_per_point, conc * 2),
                isl=ctx, osl=osl, warmup=1,
            )
            s = res.summary()
            itl[yi, xi] = (s["itl_ms"]["p50"] or 0.0) / 1e3
            thpt[yi, xi] = s["output_tok_per_s"]
        kv_usage[xi] = min(
            1.0, conc * (np.mean(contexts) + osl / 2) / max_kv_tokens
        )
    return {
        "decode_kv_usage": kv_usage,
        "decode_context": np.asarray(contexts, np.float64),
        "decode_itl_s": itl,
        "decode_thpt_per_chip": thpt,
        "max_kv_tokens": np.asarray([max_kv_tokens]),
    }


async def amain(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    isls = [int(x) for x in args.isl_grid.split(",")]
    concs = [int(x) for x in args.concurrency_grid.split(",")]
    ctxs = [int(x) for x in args.context_grid.split(",")]

    prefill = await profile_prefill(args.url, args.model, isls,
                                    args.requests_per_point)
    np.savez(os.path.join(args.out, "prefill.npz"), **prefill)
    print(json.dumps({"written": "prefill.npz",
                      "points": len(isls)}), flush=True)

    decode = await profile_decode(
        args.url, args.model, concs, ctxs, args.max_kv_tokens,
        osl=args.osl, requests_per_point=args.requests_per_point,
    )
    np.savez(os.path.join(args.out, "decode.npz"), **decode)
    print(json.dumps({"written": "decode.npz",
                      "grid": [len(ctxs), len(concs)]}), flush=True)

    # smoke the planner's loaders on what we just wrote
    from dynamo_tpu_torch.planner import DecodeInterpolator, PrefillInterpolator

    pre = PrefillInterpolator(os.path.join(args.out, "prefill.npz"))
    dec = DecodeInterpolator(os.path.join(args.out, "decode.npz"))
    print(json.dumps({
        "ttft_at_mid_isl_ms": round(pre.interpolate_ttft(isls[len(isls) // 2]) * 1e3, 2),
        "best_thpt_at_sla": round(
            dec.find_best_throughput_per_chip(args.itl_sla, ctxs[0])[0], 1
        ),
    }), flush=True)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli profile",
                                description="dynamo-tpu SLA profiler")
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--model", required=True)
    p.add_argument("--out", required=True, help="output profile dir")
    p.add_argument("--isl-grid", default="64,256,1024,2048")
    p.add_argument("--concurrency-grid", default="1,4,16")
    p.add_argument("--context-grid", default="128,512,2048")
    p.add_argument("--osl", type=int, default=32)
    p.add_argument("--max-kv-tokens", type=int, default=65536,
                   help="KV pool capacity (tokens) of one replica")
    p.add_argument("--requests-per-point", type=int, default=4)
    p.add_argument("--itl-sla", type=float, default=0.05)
    args = p.parse_args(argv)
    asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
