"""OpenAI-surface load generator (aiperf equivalent); ``cli bench``.

``python -m dynamo_tpu_torch.cli bench --url http://host:port --model m
--concurrency 8 --num-requests 64 --isl 256 --osl 64`` drives streaming
chat completions at fixed concurrency and reports TTFT / ITL / duration
percentiles and throughput, one JSON line per rung (``--concurrency
1,4,16`` sweeps); ``--arrival poisson|sin|trace`` drives an open loop
instead. The port of the reference's ``benchmarks/loadgen.py``: the same
prompts, schedules, request bodies and report, on the port's HTTP/1.1
client (``runtime/http_client.HttpSession``) in place of aiohttp. Each
SSE event is stamped when its bytes arrive, so TTFT and ITL are read off
the stream, not off a buffered body.

Connections: a closed loop holds at most ``concurrency`` keep-alive
connections (its requests are bounded by a semaphore and reuse idle
ones); an open loop has no cap, one connection per request in flight (the
reference's ``TCPConnector(limit=0)``: a cap would silently close the
loop). Each request may take at most SESSION_TIMEOUT_S (the reference's
``ClientTimeout(total=600)``).

Synthetic prompts: ISL is approximated in tokenizer-agnostic fashion by
byte count with a distinct numeric prefix per request (defeats accidental
full-prefix cache hits unless --shared-prefix asks for them).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import string
import sys
import time
from dataclasses import dataclass, field
from urllib.parse import urlsplit

from dynamo_tpu_torch.runtime.http_client import HttpSession
from dynamo_tpu_torch.sim.replay import pct_ms

__all__ = [
    "LoadResult",
    "RequestResult",
    "SESSION_TIMEOUT_S",
    "amain",
    "arrival_times",
    "main",
    "make_prompt",
    "pct_ms",
    "run_load",
    "run_one",
    "run_open_loop",
]

SESSION_TIMEOUT_S = 600.0


@dataclass
class RequestResult:
    ok: bool
    ttft_s: float | None = None
    itl_s: list[float] = field(default_factory=list)
    duration_s: float = 0.0
    output_tokens: int = 0
    error: str | None = None


@dataclass
class LoadResult:
    concurrency: int
    results: list[RequestResult]
    wall_s: float

    def summary(self) -> dict:
        ok = [r for r in self.results if r.ok]
        ttfts = sorted(r.ttft_s for r in ok if r.ttft_s is not None)
        itls = sorted(x for r in ok for x in r.itl_s)
        durs = sorted(r.duration_s for r in ok)
        tokens = sum(r.output_tokens for r in ok)
        pct = pct_ms

        return {
            "concurrency": self.concurrency,
            "requests": len(self.results),
            "errors": len(self.results) - len(ok),
            "wall_s": round(self.wall_s, 3),
            "output_tok_per_s": round(tokens / self.wall_s, 2),
            "req_per_s": round(len(ok) / self.wall_s, 3),
            "ttft_ms": {"p50": pct(ttfts, 0.5), "p90": pct(ttfts, 0.9),
                        "p99": pct(ttfts, 0.99)},
            "itl_ms": {"p50": pct(itls, 0.5), "p90": pct(itls, 0.9),
                       "p99": pct(itls, 0.99)},
            "duration_ms": {"p50": pct(durs, 0.5), "p99": pct(durs, 0.99)},
        }


def make_prompt(isl_bytes: int, index: int, shared_prefix: float = 0.0,
                seed: int = 0) -> str:
    """~isl_bytes of text; the first shared_prefix fraction is identical
    across requests (prefix-cache hit material), the rest unique."""
    rng = random.Random(seed)
    shared_len = int(isl_bytes * shared_prefix)
    shared = "".join(rng.choice(string.ascii_lowercase) for _ in range(shared_len))
    rng_u = random.Random(seed * 7919 + index)
    unique = "".join(
        rng_u.choice(string.ascii_lowercase)
        for _ in range(max(0, isl_bytes - shared_len - 12))
    )
    return f"{shared}[req {index:06d}] {unique}"


def _session(url: str) -> HttpSession:
    """A session to the server of ``http://host[:port][/prefix]``."""
    parts = urlsplit(url)
    if parts.scheme != "http" or not parts.hostname:
        raise ValueError(f"not an http:// URL: {url!r}")
    return HttpSession(parts.hostname, parts.port or 80, timeout_s=SESSION_TIMEOUT_S)


async def run_one(
    sess: HttpSession, url: str, model: str, prompt: str, osl: int,
) -> RequestResult:
    r = RequestResult(ok=False)
    t0 = time.perf_counter()
    try:
        async with asyncio.timeout(sess.timeout_s), sess.stream(
            "POST",
            urlsplit(url).path.rstrip("/") + "/v1/chat/completions",
            {
                "model": model,
                "messages": [{"role": "user", "content": prompt}],
                "max_tokens": osl,
                "ignore_eos": True,
                "stream": True,
            },
        ) as (status, events):
            if status != 200:
                r.error = f"http {status}"
                return r
            last = None
            async for payload, now in events:
                if b"[DONE]" in payload:
                    continue
                try:
                    chunk = json.loads(payload)
                except json.JSONDecodeError:
                    continue
                delta = (chunk.get("choices") or [{}])[0].get("delta", {})
                if not delta.get("content") and not delta.get("role"):
                    continue
                if last is None:
                    r.ttft_s = now - t0
                else:
                    r.itl_s.append(now - last)
                last = now
                r.output_tokens += 1
            r.ok = True
    # the reference's aiohttp.ClientError: a refused or reset connection, a
    # body cut short, a malformed response (ConnectionError)
    except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
        r.error = f"{type(e).__name__}: {e}"
    finally:
        r.duration_s = time.perf_counter() - t0
    return r


async def run_load(
    url: str,
    model: str,
    *,
    concurrency: int,
    num_requests: int,
    isl: int,
    osl: int,
    shared_prefix: float = 0.0,
    warmup: int = 2,
    seed: int = 0,
) -> LoadResult:
    sem = asyncio.Semaphore(concurrency)
    results: list[RequestResult] = []
    async with _session(url) as sess:
        for i in range(warmup):
            await run_one(sess, url, model,
                          make_prompt(isl, 10**6 + i, 0.0, seed), osl)

        t0 = time.perf_counter()

        async def one(i: int):
            async with sem:
                results.append(
                    await run_one(
                        sess, url, model,
                        make_prompt(isl, i, shared_prefix, seed), osl,
                    )
                )

        await asyncio.gather(*(one(i) for i in range(num_requests)))
        wall = time.perf_counter() - t0
    return LoadResult(concurrency=concurrency, results=results, wall_s=wall)


def arrival_times(args) -> list[tuple[float, int, int]]:
    """Open-loop schedule: [(t_offset_s, isl, osl)] per request.

    Modes (ref benchmarks/ sin_load_generator + burstgpt/mooncake trace
    replay):
      poisson — exponential inter-arrivals at --rate req/s for
                --duration seconds
      sin     — Poisson with rate(t) = rate + sin-amp * sin(2*pi*t /
                sin-period): the diurnal-swing shape SLA planners are
                tuned against
      trace   — JSONL replay: {"ts": seconds, "isl": n, "osl": n} per
                line (timestamps relative to trace start)
    """
    import math

    rng = random.Random(args.seed)
    out: list[tuple[float, int, int]] = []
    if args.arrival == "trace":
        with open(args.trace) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
        base = min(float(r["ts"]) for r in rows) if rows else 0.0
        for r in rows:
            out.append((
                float(r["ts"]) - base,
                int(r.get("isl", args.isl)),
                int(r.get("osl", args.osl)),
            ))
        return sorted(out)
    t = 0.0
    while t < args.duration:
        rate = args.rate
        if args.arrival == "sin":
            rate = max(
                0.05,
                args.rate
                + args.sin_amp * math.sin(2 * math.pi * t / args.sin_period),
            )
        t += rng.expovariate(rate)
        if t < args.duration:
            out.append((t, args.isl, args.osl))
    return out


async def run_open_loop(
    url: str, model: str, schedule: list[tuple[float, int, int]],
    *, shared_prefix: float = 0.0, warmup: int = 2, seed: int = 0,
) -> LoadResult:
    """Fire requests at scheduled offsets regardless of completions —
    the open-loop counterpart of run_load (queueing shows up as TTFT).
    The session has no connection cap: each request in flight holds a
    connection of its own."""
    results: list[RequestResult] = []
    async with _session(url) as sess:
        for i in range(warmup):
            await run_one(
                sess, url, model,
                make_prompt(schedule[0][1] if schedule else 64,
                            10**6 + i, 0.0, seed),
                schedule[0][2] if schedule else 8,
            )
        t0 = time.perf_counter()

        async def one(i: int, at: float, isl: int, osl: int):
            delay = at - (time.perf_counter() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            results.append(
                await run_one(
                    sess, url, model,
                    make_prompt(isl, i, shared_prefix, seed), osl,
                )
            )

        await asyncio.gather(
            *(one(i, at, isl, osl)
              for i, (at, isl, osl) in enumerate(schedule))
        )
        wall = time.perf_counter() - t0
    return LoadResult(concurrency=0, results=results, wall_s=wall)


async def amain(args) -> list[dict]:
    out = []
    if args.arrival != "closed":
        schedule = arrival_times(args)
        res = await run_open_loop(
            args.url, args.model, schedule,
            shared_prefix=args.shared_prefix,
            warmup=args.warmup, seed=args.seed,
        )
        s = res.summary()
        s["arrival"] = args.arrival
        s["offered_rps"] = round(
            len(schedule) / max(args.duration, 1e-9), 2
        ) if args.arrival != "trace" else None
        print(json.dumps(s), flush=True)
        return [s]
    for conc in args.concurrency:
        res = await run_load(
            args.url, args.model,
            concurrency=conc,
            num_requests=args.num_requests,
            isl=args.isl, osl=args.osl,
            shared_prefix=args.shared_prefix,
            warmup=args.warmup, seed=args.seed,
        )
        s = res.summary()
        print(json.dumps(s), flush=True)
        out.append(s)
    return out


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli bench",
                                description="dynamo-tpu load generator")
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--model", required=True)
    p.add_argument("--concurrency", default="8",
                   help="comma-separated sweep, e.g. 1,4,16")
    p.add_argument("--num-requests", type=int, default=64)
    p.add_argument("--isl", type=int, default=256, help="prompt bytes")
    p.add_argument("--osl", type=int, default=64, help="output tokens")
    p.add_argument("--shared-prefix", type=float, default=0.0,
                   help="fraction of the prompt shared across requests")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arrival", default="closed",
                   choices=("closed", "poisson", "sin", "trace"),
                   help="closed = fixed concurrency ladder; the rest are "
                        "open-loop arrival processes")
    p.add_argument("--rate", type=float, default=4.0,
                   help="open loop: mean arrivals/s")
    p.add_argument("--duration", type=float, default=30.0,
                   help="open loop: schedule length (s)")
    p.add_argument("--sin-amp", type=float, default=2.0)
    p.add_argument("--sin-period", type=float, default=20.0)
    p.add_argument("--trace", default=None,
                   help="arrival=trace: JSONL with ts/isl/osl per line")
    args = p.parse_args(argv)
    if args.arrival == "trace" and not args.trace:
        p.error("--arrival trace requires --trace FILE.jsonl")
    args.concurrency = [int(c) for c in str(args.concurrency).split(",")]
    asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
