"""Step-thread phase profile of the serving hot loop.

The port of the reference's ``benchmarks/profile_engine.py``. Runs one
closed-loop serving rung (ISL=128, OSL=48, the reference's bench ladder)
on an engine built with ``EngineConfig(profile=True)`` and prints where
the step thread's wall time goes: device sync, host bookkeeping,
admissions, batch building.

Output sections (the reference's keys):

- ``phases``: raw per-phase wall seconds + call counts
  (``InferenceEngine.profile_snapshot``).
- ``readmission``: the finish->next-first-token gap broken into
  ``readmit.*`` per-request phases (see readmission_attribution).
- ``dispatch``: the dispatch attribution from the ``dispatch.*`` phases:
    - ``dispatches`` / ``dispatches_per_step``: device programs the step
      thread issued (decode bursts, prefill dispatches, first-token
      samples);
    - ``d2h_wait_s``: wall time the step thread spent BLOCKED on
      device->host token transfers (burst sync, sync admissions, aged
      wave materialization) — ~0 when pipelining hides the RTT;
    - ``compile_events`` / ``compile_s``: in the port, CUDA graph
      captures during the measured window (the reference counts XLA
      compiles there) — nonzero means a decode variant escaped the
      warm-up set;
    - ``issue_s``: host time inside the dispatch phase.
- ``overhead``: dispatch + readmission step-thread seconds as a
  fraction of the measured window (the reference's "done" bar: < 0.15).

The engine: on the GPU the reference's accelerator configuration
(``llama-1b-bench``: d 2048, 16 layers, 16/8 heads, vocab 32768; 64
slots) with page 16, the only page size of the port's attention kernels
(the reference's TPU configuration pages by 32), its decode graphs
captured before the warm-up; ``--cpu`` the reference's CPU clamps on
``ModelSpec.dryrun()``. Without a GPU and without ``--cpu`` it raises, as
``cli worker`` does. The engine's kernel launches, steps and graph
replays since its warm-up go to stderr as one ``ENGINE_LAUNCHES {json}``
line, as a worker prints them.

Usage:
  python -m dynamo_tpu_torch.profiling.profile_engine [--concurrency N] [--secs S] [--cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

import numpy as np

__all__ = [
    "DISPATCH_ISSUE_PHASES",
    "READMIT_PHASES",
    "SPEC_PHASES",
    "dispatch_attribution",
    "dispatch_overhead",
    "main",
    "readmission_attribution",
    "spec_attribution",
]


def readmission_attribution(snap: dict) -> dict:
    """Break the finish->next-first-token gap into named per-request
    phases from the engine's ``readmit.*`` profile counters:

    - ``admit_wait``: generate() enqueue -> the step thread dequeued the
      request (queue time; in a closed loop this starts ~a loop-tick
      after the previous request's finish item posted).
    - ``prefill_dispatch``: dequeue -> prompt forward + fused first-token
      sample dispatched (device work enqueued, host copy in flight).
    - ``first_token``: dispatch complete -> the first token's host value
      landed and streamed (admission-wave materialization: residual
      sample/d2h latency not hidden behind decode bursts).

    Per-phase mean milliseconds x event count; their sum is the engine-
    attributable slice of the re-admission gap (the client-side
    finish->resubmit hop is outside the engine and shows up only in
    admit_wait's lower bound)."""
    out: dict[str, dict] = {}
    total_ms = 0.0
    for key in ("admit_wait", "prefill_dispatch", "first_token"):
        rec = snap.get(f"readmit.{key}")
        if not rec or not rec.get("calls"):
            out[key] = {"events": 0, "mean_ms": None}
            continue
        mean_ms = rec["secs"] / rec["calls"] * 1e3
        out[key] = {"events": rec["calls"], "mean_ms": round(mean_ms, 2)}
        total_ms += mean_ms
    out["engine_gap_ms"] = round(total_ms, 2)
    return out


# step-thread phases attributed to re-admission work (admitting the next
# request into a freed slot) vs dispatch overhead — the two halves of the
# < 15%-of-step-time budget. NOTE eager_readmit is NOT summed: it wraps a
# whole _admit_phase pass, so its time is already inside
# admit_loop/packed_prefill/complete_admissions.
READMIT_PHASES = (
    "admit_loop", "packed_prefill", "complete_admissions", "materialize",
    "readmit_wait",
)
DISPATCH_ISSUE_PHASES = ("dispatch",)
# speculative-decoding step-thread phases (engine/core.py _spec_phase):
# drafting is host-side n-gram lookup, verify is the packed dispatch +
# target-token sync, rollback is the rejected-tail page release
SPEC_PHASES = ("spec.draft", "spec.verify", "spec.rollback")


def _secs(snap: dict, key: str) -> float:
    rec = snap.get(key) or {}
    return float(rec.get("secs") or 0.0)


def dispatch_attribution(snap: dict, model_steps: int) -> dict:
    """The ``dispatch.*`` section: dispatch count/step, D2H block time,
    compile events, host issue time (see module docstring). ``d2h_wait_s``
    is the TOTAL device->host block time — the dispatch.d2h_wait spans
    plus the readmit.d2h_wait spans that nest inside admission phases
    (kept apart so dispatch_overhead never double-counts them)."""
    disp = snap.get("dispatch.dispatches") or {}
    comp = snap.get("dispatch.compile") or {}
    n = int(disp.get("calls") or 0)
    return {
        "dispatches": n,
        "dispatches_per_step": (
            round(n / model_steps, 3) if model_steps else None
        ),
        "d2h_wait_s": round(
            _secs(snap, "dispatch.d2h_wait")
            + _secs(snap, "readmit.d2h_wait"), 4
        ),
        "d2h_waits": int(
            ((snap.get("dispatch.d2h_wait") or {}).get("calls") or 0)
            + ((snap.get("readmit.d2h_wait") or {}).get("calls") or 0)
        ),
        "compile_events": int(comp.get("calls") or 0),
        "compile_s": round(float(comp.get("secs") or 0.0), 4),
        "issue_s": round(
            sum(_secs(snap, k) for k in DISPATCH_ISSUE_PHASES), 4
        ),
    }


def spec_attribution(snap: dict, counters: dict) -> dict:
    """Speculative-decoding attribution: the engine's verify counters
    (engine.spec_snapshot()) joined with the ``spec.*`` phase times.

    ``accepted_tokens_per_dispatch`` is the headline: tokens each verify
    dispatch landed (accepted drafts + the always-emitted target token)
    against the 1.0-token-per-dispatch non-spec decode baseline."""
    verifies = int(counters.get("verifies") or 0)
    accepted = int(counters.get("accepted") or 0)
    return {
        **counters,
        "draft_s": round(_secs(snap, "spec.draft"), 4),
        "verify_s": round(_secs(snap, "spec.verify"), 4),
        "rollback_s": round(_secs(snap, "spec.rollback"), 4),
        "accepted_tokens_per_dispatch": (
            round((accepted + verifies) / verifies, 3) if verifies else None
        ),
        "nonspec_baseline_tokens_per_dispatch": 1.0,
    }


def dispatch_overhead(snap: dict, window_s: float, model_steps: int) -> dict:
    """Dispatch + re-admission step-thread seconds as a fraction of the
    measured window (the step thread's whole time budget); the target is
    < 0.15. A CPU window short enough to still be capturing or warming
    can exceed 1.0: only a GPU run's number means anything."""
    # dispatch.d2h_wait only: the readmit.d2h_wait spans nest inside
    # complete_admissions/materialize, which readmit_s already sums —
    # counting them here too would double-bill the same wall time
    dispatch_s = (
        sum(_secs(snap, k) for k in DISPATCH_ISSUE_PHASES)
        + _secs(snap, "dispatch.d2h_wait")
        + _secs(snap, "dispatch.compile")
    )
    readmit_s = sum(_secs(snap, k) for k in READMIT_PHASES)
    frac = (
        round((dispatch_s + readmit_s) / window_s, 4) if window_s > 0
        else None
    )
    return {
        "dispatch_s": round(dispatch_s, 4),
        "readmit_s": round(readmit_s, 4),
        "window_s": round(window_s, 2),
        "model_steps": model_steps,
        "dispatch_plus_readmit_frac_of_window": frac,
        "target_frac_max": 0.15,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.profiling.profile_engine")
    ap.add_argument("--concurrency", type=int, default=64)
    ap.add_argument("--secs", type=float, default=20.0)
    ap.add_argument("--warm-secs", type=float, default=6.0)
    ap.add_argument("--burst", type=int, default=24)
    ap.add_argument("--spec", default="off", choices=["off", "ngram"],
                    help="speculative decoding mode for the profiled engine")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.engine.worker import engine_launches, launch_base
    from dynamo_tpu_torch.models.llama import resolve_device
    from dynamo_tpu_torch.runtime.context import Context

    # no GPU and no --cpu raises here: nothing falls back to the CPU
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        spec = ModelSpec(
            name="llama-1b-bench", vocab_size=32768, hidden_size=2048,
            intermediate_size=8192, num_layers=16, num_heads=16,
            num_kv_heads=8, head_dim=128, tie_embeddings=False,
        )
        page, slots = 16, 64
    else:
        spec = ModelSpec.dryrun()
        page, slots = 16, 8
        args.concurrency = min(args.concurrency, 4)
        args.secs = min(args.secs, 4.0)
        args.warm_secs = min(args.warm_secs, 2.0)

    ISL, OSL = 128, 48
    pps = (ISL + OSL + page - 1) // page + 2
    cfg = EngineConfig(
        page_size=page,
        num_pages=slots * pps + 64,
        max_pages_per_seq=pps,
        max_decode_slots=slots,
        prefill_buckets=(128, 256),
        decode_steps_per_dispatch=args.burst,
        pipeline_decode=True,
        spec_mode=args.spec,
        # set here, not through DYNAMO_ENGINE_PROFILE: run through an import
        # (python -m, cli) an environment default would come too late
        profile=True,
    )

    async def run() -> None:
        engine = InferenceEngine(spec, cfg, device=device)
        engine.precompile()  # every decode graph variant (none on the CPU)
        await engine.start()

        if os.environ.get("DYNAMO_PROFILE_STACKS") == "1":
            import threading
            import traceback

            def dump_stacks():
                while True:
                    time.sleep(5)
                    for tid, frame in sys._current_frames().items():
                        name = next(
                            (t.name for t in threading.enumerate()
                             if t.ident == tid), "?",
                        )
                        if name == "engine-step":
                            lines = traceback.format_stack(frame)
                            app = [
                                ln for ln in lines
                                if "dynamo_tpu" in ln or "sampling" in ln
                            ]
                            print(f"=== {name} ===", file=sys.stderr)
                            print("".join(app[-4:]) or "".join(lines[-2:]),
                                  file=sys.stderr)

            threading.Thread(target=dump_stacks, daemon=True).start()
        rng = np.random.default_rng(0)
        base = launch_base(engine)

        # warm every serving shape BEFORE the measured window: the full
        # admission wave (packed prefill + burst programs), the
        # single-prompt prefill + width-1 fused sample (straggler), and the
        # ramp-up capped bursts (trickle)
        async def warm_one(i: int):
            toks = rng.integers(3, spec.vocab_size, ISL).tolist()
            async for _ in engine.generate(
                {"token_ids": toks,
                 "stop_conditions": {"max_tokens": 4, "ignore_eos": True},
                 "sampling": {"temperature": 0.0}},
                Context(f"warm-{i}"),
            ):
                pass

        await asyncio.gather(*(warm_one(i) for i in range(args.concurrency)))
        await warm_one(9999)  # straggler: single-prompt programs
        for r in range(3):
            await asyncio.gather(
                *(warm_one(5000 + r * 10 + j) for j in range(4))
            )

        stop = asyncio.Event()
        n_done = [0]

        async def stream(sid: int):
            while not stop.is_set():
                toks = rng.integers(3, spec.vocab_size, ISL).tolist()
                async for _item in engine.generate(
                    {"token_ids": toks,
                     "stop_conditions": {"max_tokens": OSL,
                                         "ignore_eos": True},
                     "sampling": {"temperature": 0.0}},
                    Context(f"prof-{sid}"),
                ):
                    pass
                n_done[0] += 1

        tasks = [
            asyncio.create_task(stream(i)) for i in range(args.concurrency)
        ]
        await asyncio.sleep(args.warm_secs)
        engine.reset_profile_window()  # drop capture/warmup noise
        t0 = time.perf_counter()
        steps0 = engine.steps
        await asyncio.sleep(args.secs)
        elapsed = time.perf_counter() - t0
        steps1 = engine.steps
        snap = engine.profile_snapshot()
        spec_counters = engine.spec_snapshot()
        stop.set()
        await asyncio.gather(*tasks)
        await engine.close()

        accounted = sum(
            v["secs"] for k, v in snap.items()
            if k in ("materialize", "flush", "admit_loop", "packed_prefill",
                     "complete_admissions", "build_batch", "dispatch",
                     "process", "idle", "eager_readmit", "readmit_wait")
        )
        out = {
            "concurrency": args.concurrency,
            "window_s": round(elapsed, 2),
            "model_steps": steps1 - steps0,
            "requests_done": n_done[0],
            "accounted_s": round(accounted, 2),
            "phases": snap,
            "readmission": readmission_attribution(snap),
            "dispatch": dispatch_attribution(snap, steps1 - steps0),
            "overhead": dispatch_overhead(snap, elapsed, steps1 - steps0),
            "eager_readmits": engine.eager_readmits,
        }
        if spec_counters["verifies"]:
            out["spec"] = spec_attribution(snap, spec_counters)
        print(json.dumps(out, indent=2), flush=True)
        print("ENGINE_LAUNCHES " + json.dumps(engine_launches(engine, base)),
              file=sys.stderr, flush=True)

    asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
