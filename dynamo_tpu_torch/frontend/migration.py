"""Migration operator: fault-tolerant retry across workers (a copy of
dynamo_tpu/frontend/migration.py).

If the response stream dies mid-generation (worker crash, connection loss ->
StreamError from the transport; draining/saturated worker ->
ServiceUnavailable), re-issue the request to another worker with the
already-generated tokens appended to the prompt, up to ``migration_limit``
times. The client never notices beyond a brief pause.
Ref: lib/llm/src/migration.rs (Migration :26, RetryManager :74).

Retry discipline (robustness PR):
  - jittered exponential backoff between attempts (base doubles per retry,
    multiplied by uniform [0.5, 1.5) jitter so a worker crash doesn't make
    every in-flight request hammer the survivors in lockstep);
  - a per-request retry BUDGET (total seconds spent backing off) replaces
    the old unbounded fixed ``retry_delay_s`` sleeps;
  - the request's end-to-end deadline is honored: no retry is attempted
    whose backoff would outlive the deadline (DeadlineExceeded instead);
  - non-retryable failures are never migrated: client cancellation
    (context stopped), DeadlineExceeded (not a StreamError), validation
    errors (plain RuntimeError from the worker);
  - cumulative resume-prompt growth is capped: each migration re-sends
    prompt+generated, so a crash-looping worker must not grow the resume
    prompt unboundedly (max_resume_tokens).

Each backoff is a ``migration.resume`` span (runtime/tracing.py).
Recovery counters are exported on every /metrics surface as
``dynamo_migrations_total`` / ``dynamo_migrations_exhausted_total``
(runtime/metrics.py global providers).
"""

from __future__ import annotations

from contextlib import aclosing

import asyncio
import logging
import random
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.context import (
    Context,
    DeadlineExceeded,
    ServiceUnavailable,
    StreamError,
)
from dynamo_tpu_torch.runtime.integrity import token_checksum

log = logging.getLogger("dynamo_tpu_torch.migration")

# process-wide recovery counters (all Migration instances; exported via the
# global metrics provider below)
STATS = {"migrations": 0, "exhausted": 0, "resumed_tokens": 0}


def _stats_exposition() -> str:
    return (
        "# HELP dynamo_migrations_total Requests re-driven on another "
        "worker after a stream failure.\n"
        "# TYPE dynamo_migrations_total counter\n"
        f"dynamo_migrations_total {STATS['migrations']}\n"
        "# HELP dynamo_migrations_exhausted_total Requests whose retry "
        "budget/attempts ran out.\n"
        "# TYPE dynamo_migrations_exhausted_total counter\n"
        f"dynamo_migrations_exhausted_total {STATS['exhausted']}\n"
        "# HELP dynamo_migration_resumed_tokens_total Pre-crash tokens "
        "re-sent in resume prompts across all migrations.\n"
        "# TYPE dynamo_migration_resumed_tokens_total counter\n"
        f"dynamo_migration_resumed_tokens_total {STATS['resumed_tokens']}\n"
    )


def _register_metrics() -> None:
    from dynamo_tpu_torch.runtime import metrics

    metrics.register_global_provider("migration", _stats_exposition)


_register_metrics()


class Migration:
    def __init__(
        self,
        downstream,
        *,
        migration_limit: int = 3,
        retry_delay_s: float = 0.2,  # backoff BASE (first-retry delay)
        retry_budget_s: float = 5.0,  # total backoff seconds per request
        backoff_max_s: float = 2.0,
        max_resume_tokens: int = 8192,
        rng: random.Random | None = None,
    ):
        self.downstream = downstream
        self.migration_limit = migration_limit
        self.retry_delay_s = retry_delay_s
        self.retry_budget_s = retry_budget_s
        self.backoff_max_s = backoff_max_s
        self.max_resume_tokens = max_resume_tokens
        self._rng = rng or random.Random()

    def _backoff_s(self, attempt: int) -> float:
        """Jittered exponential backoff for retry ``attempt`` (0-based)."""
        base = min(self.retry_delay_s * (2 ** attempt), self.backoff_max_s)
        return base * (0.5 + self._rng.random())

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        request = dict(request)
        attempts_left = self.migration_limit
        budget_left = self.retry_budget_s
        attempt = 0
        generated: list[int] = []

        while True:
            retry = False
            try:
                # aclosing: the early return on finish_reason must tear
                # the downstream chain down synchronously, not via GC
                stream = self.downstream.generate(request, context)
                async with aclosing(stream):
                    async for item in stream:
                        if isinstance(item, dict):
                            generated.extend(item.get("token_ids") or [])
                        yield item
                        if isinstance(item, dict) and item.get("finish_reason"):
                            return
                    return  # clean end of stream
            except StreamError as e:
                # DeadlineExceeded and validation errors are NOT
                # StreamErrors — they propagate without a retry. Client
                # cancellation never retries either.
                if context.is_stopped or attempts_left <= 0:
                    if attempts_left <= 0:
                        STATS["exhausted"] += 1
                    raise
                if context.deadline_expired:
                    STATS["exhausted"] += 1
                    raise DeadlineExceeded(
                        f"deadline passed after stream failure ({e})"
                    ) from e
                delay = self._backoff_s(attempt)
                if isinstance(e, ServiceUnavailable):
                    delay = max(delay, min(e.retry_after_s, budget_left))
                if delay > budget_left:
                    STATS["exhausted"] += 1
                    raise
                remaining = context.remaining_s()
                if remaining is not None and delay >= remaining:
                    STATS["exhausted"] += 1
                    raise DeadlineExceeded(
                        f"no deadline budget left to retry ({e})"
                    ) from e
                resume_len = len(request.get("token_ids") or []) + len(
                    generated
                )
                if resume_len > self.max_resume_tokens:
                    # a crash-looping backend must not grow the resume
                    # prompt (prompt+generated, re-sent every migration)
                    # without bound
                    STATS["exhausted"] += 1
                    raise StreamError(
                        f"resume prompt would reach {resume_len} tokens "
                        f"(cap {self.max_resume_tokens}); not migrating"
                    ) from e
                budget_left -= delay
                attempts_left -= 1
                attempt += 1
                retry = True
                log.warning(
                    "stream died (%s); migrating request %s in %.2fs "
                    "(%d tokens generated, %d retries / %.1fs budget left)",
                    e, context.id, delay, len(generated), attempts_left,
                    budget_left,
                )
            if retry:
                STATS["migrations"] += 1
                STATS["resumed_tokens"] += len(generated)
                # the backoff joins the request's trace: the re-driven
                # attempt is the NEXT transport.call span in the same trace
                # (this span's sibling), so it reads call -> resume -> call
                with tracing.span(
                    "migration.resume", attempt=attempt,
                    resumed_tokens=len(generated),
                ):
                    await asyncio.sleep(delay)
                # resume: prompt = original + generated so far; shrink budget
                stop = dict(request.get("stop_conditions") or {})
                max_tokens = stop.get("max_tokens")
                if max_tokens is not None:
                    stop["max_tokens"] = max(max_tokens - len(generated), 1)
                resume_tokens = (
                    list(request.get("token_ids") or []) + generated
                )
                request = {
                    **request,
                    "token_ids": resume_tokens,
                    "stop_conditions": stop,
                    "backend_instance_id": None,  # re-route freely
                    # end-to-end integrity stamp: the receiving engine
                    # verifies the resume prompt arrived bit-identical —
                    # a corrupted resume raises IntegrityError back here
                    # and re-drives from this (pristine) request
                    "token_checksum": token_checksum(resume_tokens),
                }
                generated = []
                # fresh child context: the old request id may be poisoned on
                # the dead worker's peers
                context = context.child(f"{context.id}-m{attempt}")


def make_operator(sink, **kwargs) -> "Migration":
    """Operator-registry factory (runtime/pipeline.py): sink-first form."""
    return Migration(sink, **kwargs)
