"""Open-loop trace replay for the cluster sim (the port's copy of
benchmarks/replay.py, with ``pct_ms`` of benchmarks/loadgen.py): for the
same seed it writes and loads the same traces and computes the same
summaries.

- ``synthesize_trace`` / ``load_trace``: mooncake-style JSONL records
  ``{"timestamp": ms, "input_length": N, "output_length": M,
  "hash_ids": [...]}`` where hash_ids name shared-prefix blocks;
- ``synthesize_wave_trace``: a diurnal wave plus a flash spike;
- ``replay_trace``: fire each request at its trace timestamp (scaled by
  ``rate_scale``) regardless of completions, so queueing shows up as TTFT,
  never as a silently closed loop;
- ``summarize``: the percentile summary, built on ``pct_ms``
  (nearest rank).

A request whose stream raises, or that yields a ``finish_reason: "error"``
item, lands in ``errors`` with its message: the chaos scenarios assert this
list is empty under churn.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from contextlib import aclosing
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from dynamo_tpu_torch.runtime.context import Context, deadline_from_headers

__all__ = [
    "pct_ms",
    "synthesize_trace",
    "synthesize_wave_trace",
    "load_trace",
    "replay_trace",
    "summarize",
    "ReplayResult",
]


def pct_ms(xs, p: float, ndigits: int = 3):
    """The ``p`` percentile of ``xs`` (seconds) in milliseconds, nearest
    rank on the sorted sample; None for an empty one."""
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(p * len(xs)))] * 1e3, ndigits)


def synthesize_trace(
    path: str, *, requests: int = 256, block_size: int = 16,
    groups: int = 12, depth: int = 6, rate_per_s: float = 48.0,
    osl: int = 8, seed: int = 0,
) -> None:
    """Write a mooncake-style JSONL trace: Poisson arrivals over a
    radix-structured context tree (each group is a chain of shared
    blocks; each request reuses a random-depth prefix of its group's
    chain plus a unique tail block — the same shape the reference
    synthesizer derives from the real mooncake trace)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    with open(path, "w") as f:
        for i in range(requests):
            g = int(rng.integers(0, groups))
            keep = int(rng.integers(1, depth + 1))
            hash_ids = [g * 1000 + d for d in range(keep)] + [10_000_000 + i]
            input_length = len(hash_ids) * block_size
            t += float(rng.exponential(1.0 / rate_per_s))
            f.write(json.dumps({
                "timestamp": int(t * 1000),
                "input_length": input_length,
                "output_length": osl,
                "hash_ids": hash_ids,
            }) + "\n")


def synthesize_wave_trace(
    path: str, *, duration_s: float = 12.0, base_rate: float = 12.0,
    peak_rate: float = 40.0, spike_rate: float = 0.0,
    spike_start_frac: float = 0.55, spike_dur_frac: float = 0.12,
    block_size: int = 16, groups: int = 12, depth: int = 6,
    osl: int = 8, seed: int = 0,
) -> None:
    """Diurnal wave + flash spike: a non-homogeneous Poisson trace for
    the autoscaler scenarios. The rate follows one raised-cosine cycle
    from ``base_rate`` up to ``peak_rate`` (peaking mid-trace — the
    morning ramp and evening trough of a serving fleet compressed into
    ``duration_s``), with an optional flash-crowd window adding
    ``spike_rate`` on top for ``spike_dur_frac`` of the trace starting
    at ``spike_start_frac``. Arrivals come from Lewis-Shedler thinning,
    so inter-arrival statistics stay honestly Poisson at every instant.
    Request shapes (radix prefix groups) match ``synthesize_trace``."""
    rng = np.random.default_rng(seed)

    def rate(t: float) -> float:
        r = base_rate + (peak_rate - base_rate) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / duration_s)
        )
        s0 = spike_start_frac * duration_s
        if spike_rate > 0 and s0 <= t < s0 + spike_dur_frac * duration_s:
            r += spike_rate
        return r

    rate_max = max(base_rate, peak_rate) + max(spike_rate, 0.0)
    t = 0.0
    i = 0
    with open(path, "w") as f:
        while True:
            t += float(rng.exponential(1.0 / rate_max))
            if t >= duration_s:
                break
            if rng.random() > rate(t) / rate_max:
                continue  # thinned
            g = int(rng.integers(0, groups))
            keep = int(rng.integers(1, depth + 1))
            hash_ids = [g * 1000 + d for d in range(keep)] + [10_000_000 + i]
            f.write(json.dumps({
                "timestamp": int(t * 1000),
                "input_length": len(hash_ids) * block_size,
                "output_length": osl,
                "hash_ids": hash_ids,
            }) + "\n")
            i += 1


def load_trace(path: str, block_size: int) -> list[dict]:
    """Parse a mooncake-style JSONL trace into replayable requests.
    Tokens are derived deterministically from each hash id (one block of
    ``block_size`` tokens per id), so equal hash_ids share prefixes
    exactly as the trace's radix structure dictates."""
    block_cache: dict[int, list[int]] = {}

    def block(h: int) -> list[int]:
        if h not in block_cache:
            block_cache[h] = (
                np.random.default_rng(h & 0x7FFFFFFF)
                .integers(10, 30000, block_size)
                .tolist()
            )
        return block_cache[h]

    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            toks: list[int] = []
            for h in rec["hash_ids"]:
                toks.extend(block(h))
            n = int(rec["input_length"])
            if len(toks) < n:  # tail beyond the hashed blocks: unique
                toks.extend(
                    np.random.default_rng(len(out))
                    .integers(10, 30000, n - len(toks))
                    .tolist()
                )
            out.append({
                "t_ms": int(rec["timestamp"]),
                "token_ids": toks[:n],
                "osl": int(rec.get("output_length", 8)),
                "blocks": len(rec["hash_ids"]),
            })
    out.sort(key=lambda r: r["t_ms"])
    return out


@dataclass
class ReplayResult:
    """Raw per-request outcomes of one open-loop replay."""

    results: list[dict] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    elapsed_s: float = 0.0

    def ttfts(self) -> list[float]:
        return [r["ttft"] for r in self.results if r["ttft"] is not None]

    def itls(self) -> list[float]:
        return [x for r in self.results for x in r["itl"]]

    def summary(self) -> dict:
        return summarize(self)


async def replay_trace(
    generate: Callable[[dict, Context], Any],
    trace: list[dict],
    *,
    rate_scale: float = 1.0,
    headers: dict[str, str] | Callable[[int, dict], dict] | None = None,
    id_prefix: str = "tr",
) -> ReplayResult:
    """Open-loop replay at the trace's own timestamps (scaled).

    ``generate`` is any AsyncEngine-compatible callable — a raw mock
    engine, a (Kv)PushRouter, or a Migration-wrapped client path.
    ``headers`` stamps Context baggage per request (dict, or a callable
    of (index, record) for per-request tenancy).
    """
    out = ReplayResult()

    async def one(rec: dict, idx: int):
        req = {
            "token_ids": rec["token_ids"],
            "stop_conditions": {"max_tokens": rec["osl"], "ignore_eos": True},
            "sampling": {"temperature": 0.0},
        }
        h = headers(idx, rec) if callable(headers) else headers
        # the replay client IS the serving edge: an x-dyn-deadline-ms
        # header becomes a live Context deadline exactly as a frontend
        # would set it (and wire_headers re-stamps it on real hops)
        ctx = Context(
            f"{id_prefix}-{idx}", dict(h) if h else None,
            deadline=deadline_from_headers(h),
        )
        t0 = time.perf_counter()
        ttft = cached = None
        itl: list[float] = []
        last = None
        err: str | None = None
        try:
            stream = generate(req, ctx)
            async with aclosing(stream):
                async for item in stream:
                    if not isinstance(item, dict):
                        continue
                    if (item.get("error")
                            or item.get("finish_reason") == "error"):
                        err = str(item.get("error") or "finish_reason=error")
                        break
                    if item.get("token_ids"):
                        now = time.perf_counter()
                        if ttft is None:
                            ttft = now - t0
                            cached = item.get("cached_blocks")
                        elif last is not None:
                            itl.append(now - last)
                        last = now
        except Exception as e:  # noqa: BLE001 — replay records, caller asserts
            err = f"{type(e).__name__}: {e}"
        if err is not None:
            out.errors.append(f"{id_prefix}-{idx}: {err}")
        out.results.append({
            "ttft": ttft,
            "itl": itl,
            "cached": cached or 0,
            "blocks": rec.get("blocks", 0),
            "duration": time.perf_counter() - t0,
            "error": err,
        })

    start = time.perf_counter()
    tasks = []
    for idx, rec in enumerate(trace):
        target = rec["t_ms"] / 1000.0 / rate_scale
        now = time.perf_counter() - start
        if target > now:
            await asyncio.sleep(target - now)
        tasks.append(asyncio.ensure_future(one(rec, idx)))
    await asyncio.gather(*tasks)
    out.elapsed_s = time.perf_counter() - start
    return out


def summarize(res: ReplayResult) -> dict:
    """The artifact summary of a replay: TTFT percentiles through
    ``pct_ms`` plus the measured prefix-hit rate (blocks reused at the
    serving worker over blocks offered)."""
    ttfts = res.ttfts()
    total_blocks = sum(r["blocks"] for r in res.results)
    return {
        "requests": len(res.results),
        "errors": len(res.errors),
        "req_per_s": round(
            len(res.results) / max(res.elapsed_s, 1e-9), 2
        ),
        "ttft_ms_p50": pct_ms(ttfts, 0.5),
        "ttft_ms_p90": pct_ms(ttfts, 0.9),
        "ttft_ms_p99": pct_ms(ttfts, 0.99),
        "ttft_ms_mean": (
            round(float(np.mean(ttfts)) * 1e3, 2) if ttfts else None
        ),
        "prefix_hit_rate": round(
            sum(r["cached"] for r in res.results) / max(total_blocks, 1), 4
        ),
    }
