"""Split-count sweep of the two attention kernels (needs one GPU).

    python3 -m dynamo_tpu_torch.ops.cuda.sweep [--out PATH] [--fp8]

Times the public wrappers ``paged_decode_attention_v3`` and
``fused_decode_attention`` in bf16 (KH 8, G 4, D 128, page 16) at decode
shapes: the smoke's B=8 x seq_len 1..1024, one 8192-token sequence, B=8 x
1024, B=32 x 512, and a single short sequence in a 64-page row (seq_len 1,
16 and 64: one user early in generation). Both kernels run at the split
count ``num_splits`` picks; the read-only kernel also at the other split
counts listed per case. Times are CUDA events around one call after an L2
flush and a device sleep, mean of 20, as ``chip_smoke.py`` times them; a
one-element ``add_`` timed the same way gives the floor. With ``--fp8``
both kernels also run at each case's default split count on fp8 pools
(e4m3 values with one bf16 scale per page and KV head), beside the bf16
points at the same shapes.

Only the wrappers' public arguments are used, so a copy of this file times
an older tree of the package as well (one without ``num_splits`` at its
own grid only). Prints the card and one line per point, and writes the
points as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from dynamo_tpu_torch.ops.cuda import build, fused_decode
from dynamo_tpu_torch.ops.cuda import paged_attention_v3 as pa

CASES = {  # name: (B, P, seq_lens, further split counts for the read-only kernel)
    "smoke": (8, 64, (1, 37, 130, 256, 511, 700, 1000, 1024), (1, 2, 3, 6, 8)),
    "B1x8192": (1, 512, (8192,), (8, 16, 24, 48, 64)),
    "B8x1024": (8, 64, (1024,), (1, 2, 6, 8)),
    "B32x512": (32, 32, (512,), (2, 3)),
    "B1x1": (1, 64, (1,), (1,)),
    "B1x16": (1, 64, (16,), (1,)),
    "B1x64": (1, 64, (64,), (1, 4)),
}
KH, G, D, PAGE = 8, 4, 128, 16
REPS = 20
SLEEP_CYCLES = 5_000_000


def inputs(B: int, P: int, seq_lens, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    NP = 1 + B * P
    bt = np.stack([rng.permutation(np.arange(1 + i * P, 1 + (i + 1) * P)) for i in range(B)])
    sl = np.asarray((tuple(seq_lens) * B)[:B], np.int32)
    pos = sl - 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    return {"q": randn(B, KH * G, D), "k": randn(2, NP, KH, PAGE, D),
            "v": randn(2, NP, KH, PAGE, D), "k_new": randn(B, KH, D),
            "v_new": randn(B, KH, D), "bt": ints(bt), "sl": ints(sl),
            "dst_page": ints(bt[np.arange(B), pos // PAGE]), "dst_off": ints(pos % PAGE)}


def fp8_pool(x: torch.Tensor, gen: torch.Generator):
    """A pool of normal draws ``x [L, NP, KH, page, D]`` as an fp8
    QuantPool that dequantizes to about ``x``: e4m3 values of 40 x the
    draws (clipped to +-448), scales per (layer, page, head) uniform in
    [0.5, 1.5] / 40 (bf16) from ``gen``."""
    from dynamo_tpu_torch.ops.quant import FP8_DTYPE, SCALE_DTYPE, QuantPool

    scale = (torch.rand(x.shape[:3], generator=gen, device=x.device) + 0.5) / 40
    return QuantPool((40 * x.float()).clamp(-448, 448).to(FP8_DTYPE),
                     scale.to(SCALE_DTYPE))


def time_ms(fn, flush) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(REPS):
        torch.cuda._sleep(SLEEP_CYCLES)  # the host enqueues while the device sleeps
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / REPS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(build.BUILD_DIR / "sweep.json"))
    ap.add_argument("--fp8", action="store_true",
                    help="also time both kernels on fp8 pools at each case's "
                         "default split count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(card, flush=True)
    plan = getattr(pa, "num_splits", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    floor = time_ms(lambda: one.add_(1), flush)
    rows = [{"case": "empty op", "kernel": "torch add_", "S": None, "pool": None,
             "ms": floor}]
    print(f"empty op (one-element add_): {floor:.4f} ms", flush=True)
    for case, (B, P, seq_lens, splits) in CASES.items():
        t = inputs(B, P, seq_lens)
        calls = {
            "paged_attention_v3": lambda: pa.paged_decode_attention_v3(
                t["q"], t["k"][1], t["v"][1], t["bt"], t["sl"]),
            "fused_decode": lambda: fused_decode.fused_decode_attention(
                t["q"], t["k"], t["v"], t["k_new"], t["v_new"], t["bt"], t["sl"],
                t["dst_page"], t["dst_off"], layer=1),
        }
        S0 = plan(B, KH, P, sms) if plan else None
        points = [(name, None) for name in calls]
        if plan:
            points += [("paged_attention_v3", S) for S in splits if S != S0]
        for name, S in points:
            if S is not None:
                pa.num_splits = lambda *_, S=S: S
            try:
                ms = time_ms(calls[name], flush)
            finally:
                if plan:
                    pa.num_splits = plan
            S_run = S if S is not None else S0
            rows.append({"case": case, "kernel": name, "S": S_run,
                         "default": S is None, "pool": "bf16", "ms": ms})
            label = "grid" if S_run is None else f"S {S_run:3d}{' *' if S is None else ''}"
            print(f"{case:8s} {name:18s} {label:8s} bf16 {ms:.4f} ms", flush=True)
        if args.fp8:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1000)
            f8 = {name: fp8_pool(t[name], gen) for name in ("k", "v")}
            calls = {
                "paged_attention_v3": lambda: pa.paged_decode_attention_v3(
                    t["q"], f8["k"].layer(1), f8["v"].layer(1), t["bt"], t["sl"]),
                "fused_decode": lambda: fused_decode.fused_decode_attention(
                    t["q"], f8["k"], f8["v"], t["k_new"], t["v_new"], t["bt"],
                    t["sl"], t["dst_page"], t["dst_off"], layer=1),
            }
            for name, call in calls.items():
                ms = time_ms(call, flush)
                rows.append({"case": case, "kernel": name, "S": S0, "default": True,
                             "pool": "fp8", "ms": ms})
                print(f"{case:8s} {name:18s} S {S0:3d} * fp8  {ms:.4f} ms", flush=True)
            del f8
        del t, calls
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
