"""MockEngine: streaming AsyncEngine with simulated compute.

Timing model (ref lib/llm/src/mocker/scheduler.rs): prefill costs
``prefill_base_s + prefill_per_token_s * uncached_tokens``, each decode step
costs ``decode_step_s`` (scaled by active batch pressure), all divided by
``speedup_ratio`` so large fleets simulate fast. KV blocks are allocated per
request through MockKvManager; decode extends the sequence one token at a
time, sealing new blocks (emitting store events) at block boundaries exactly
like a real paged engine.

Request schema = the framework's PreprocessedRequest (see
frontend/protocols): {"token_ids": [...], "stop_conditions": {"max_tokens"},
"sampling": {...}, ...}. Responses: {"token_ids": [t], "finish_reason"}.

CHAOS PARITY with the real engine (dynamo_tpu/sim rides this): one
``DYN_FAULTS`` spec applies uniformly to real and mock fleets —

- ``engine.admit`` fires at admission; an injected drop maps to the real
  engine's retryable ``ServiceUnavailable`` contract (migration re-drives
  on another instance), an injected error surfaces as-is;
- ``engine.step`` fires per decode step; an injected failure fails the
  in-flight stream with a ``finish_reason: "error"`` item — the real
  engine's fail-everything-then-keep-serving shape — and the NEXT request
  serves normally;
- the ``x-dyn-deadline-ms`` contract holds: an admission whose deadline
  already passed raises ``DeadlineExceeded`` (HTTP 504), and generation
  is CUT at the deadline mid-decode with the real engine's
  ``"deadline exceeded"`` error item;
- admission is class-prioritized like engine/tenancy.py's scheduler:
  ``x-dyn-priority: interactive`` waiters are admitted STRICTLY before
  ``batch`` waiters, so fleet-scale tenant-storm scenarios exercise the
  same SLO shape the real engine's fairness lanes provide.

A copy of ``dynamo_tpu/mocker/engine.py``. Block identities go
through the port's ``tokens.py`` (xxh3), so its KV events fold into either
package's radix.
"""

from __future__ import annotations

import asyncio
import collections
import random
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.mocker.kv_manager import MockKvManager, NotEnoughBlocks
from dynamo_tpu_torch.runtime.context import (
    Context,
    DeadlineExceeded,
    ServiceUnavailable,
    tenancy_from_headers,
)
from dynamo_tpu_torch.runtime.faults import FAULTS

from dynamo_tpu_torch.tokens import TokenBlockSequence

__all__ = ["MockEngineConfig", "MockEngine"]


class _PriorityGate:
    """Class-prioritized admission slots: interactive waiters are granted
    strictly before batch waiters (the mock analogue of the real engine's
    TenantScheduler class ordering). FIFO within a class; slots released
    by finished requests hand off directly to the head waiter."""

    def __init__(self, slots: int):
        self._free = slots
        self._waiters: dict[str, collections.deque] = {
            "interactive": collections.deque(),
            "batch": collections.deque(),
        }

    def waiting(self) -> int:
        return sum(len(q) for q in self._waiters.values())

    async def acquire(self, priority: str) -> None:
        q = self._waiters["interactive" if priority != "batch" else "batch"]
        head_clear = not self._waiters["interactive"] and (
            priority != "batch" or not self._waiters["batch"]
        )
        if self._free > 0 and head_clear:
            self._free -= 1
            return
        fut = asyncio.get_running_loop().create_future()
        q.append(fut)
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # the grant raced the cancel: hand the slot onward
                self.release()
            else:
                try:
                    q.remove(fut)
                except ValueError:
                    pass
            raise

    def release(self) -> None:
        for cls in ("interactive", "batch"):
            q = self._waiters[cls]
            while q:
                fut = q.popleft()
                if not fut.done():
                    fut.set_result(None)
                    return
        self._free += 1


@dataclass
class MockEngineConfig:
    block_size: int = 16
    total_kv_blocks: int = 4096
    max_batch_size: int = 64
    speedup_ratio: float = 1.0  # >1 = time dilation (faster than real)
    prefill_base_s: float = 0.02
    prefill_per_token_s: float = 0.0002
    decode_step_s: float = 0.01
    # default matches MockTokenizer's decodable range (bytes + 16 offset) so
    # mock generations detokenize to visible text
    vocab_size: int = 272
    eos_token_id: int = 2
    data_parallel_rank: int = 0
    seed: int = 0
    # echo mode (ref: dynamo-run out=echo, opt.rs Output::Echo): decode
    # replays the prompt tokens instead of sampling randomly — byte-level
    # MockTokenizer makes output text == prompt text, which E2E tests use
    # to drive the tool-call/reasoning parser paths deterministically
    echo_prompt: bool = False
    # sim-pacing granularity: 0 sleeps exactly once per simulated step
    # (one asyncio timer each). At high speedup ratios those dilated
    # sleeps are single-digit µs and the timer bookkeeping costs more
    # than the wait itself, throttling throughput benches below the
    # plumbing they measure — set >0 to accumulate dilated time as debt
    # and pay one real sleep per `sleep_granularity_s` of it instead
    # (aggregate pacing preserved; per-step interleaving coarsened)
    sleep_granularity_s: float = 0.0
    # identity this engine presents to the fault registry: many mock
    # workers share one process (and thus one FAULTS), so per-instance
    # fault scoping (``engine.step:delay=80ms~10.0.0.3:*``) needs each
    # engine to say who it is on every fire. "" = unscoped rules only.
    fault_instance: str = ""


class MockEngine:
    """Simulated engine worker; one instance per mock worker process/task."""

    def __init__(
        self,
        config: MockEngineConfig | None = None,
        *,
        event_publisher=None,  # KvEventPublisher | None
        metrics_publisher=None,  # WorkerMetricsPublisher | None
    ):
        self.config = config or MockEngineConfig()
        self.events = event_publisher
        self.metrics = metrics_publisher
        self.kv = MockKvManager(
            self.config.total_kv_blocks,
            on_store=self._on_store,
            on_evict=self._on_evict,
        )
        self._rng = random.Random(self.config.seed)
        self._running = 0
        self._sleep_debt = 0.0
        self._waiting = 0
        self._admit = _PriorityGate(self.config.max_batch_size)
        # degradation fingerprint: EWMA of MEASURED wall-clock decode-step
        # time (ms). Measured, not modeled — an injected per-instance
        # delay fault shows up here exactly like a thermal-throttled chip,
        # and peer-relative scoring makes the sim's time dilation cancel
        self.step_time_ewma_ms = 0.0

    # -- kv event plumbing -------------------------------------------------

    def _on_store(self, sh: int, parent: int) -> None:
        if self.events is not None:
            self.events.block_stored(sh, parent)

    def _on_evict(self, shs: list[int]) -> None:
        if self.events is not None and shs:
            self.events.blocks_removed(shs)

    def _publish_metrics(self) -> None:
        if self.metrics is not None:
            self.metrics.publish(
                ForwardPassMetrics(
                    active_kv_blocks=self.kv.active_blocks,
                    total_kv_blocks=self.kv.total_blocks,
                    waiting_requests=self._waiting,
                    running_requests=self._running,
                    data_parallel_rank=self.config.data_parallel_rank,
                    step_time_ms=self.step_time_ewma_ms,
                )
            )

    async def _sleep(self, seconds: float) -> None:
        delay = seconds / max(self.config.speedup_ratio, 1e-9)
        gran = self.config.sleep_granularity_s
        if gran <= 0.0:
            await asyncio.sleep(delay)
            return
        self._sleep_debt += delay
        if self._sleep_debt >= gran:
            debt, self._sleep_debt = self._sleep_debt, 0.0
            await asyncio.sleep(debt)

    # -- the engine --------------------------------------------------------

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        cfg = self.config
        token_ids: list[int] = list(request.get("token_ids") or [])
        if request.get("embedding_request"):
            # deterministic fake embedding: seeded by the token ids, so
            # identical inputs embed identically (frontend E2E tests)
            import random as _random

            rng = _random.Random(hash(tuple(token_ids)) & 0xFFFFFFFF)
            yield {
                "token_ids": [],
                "embedding": [round(rng.uniform(-1, 1), 6) for _ in range(8)],
                "finish_reason": "stop",
            }
            return
        stop = request.get("stop_conditions") or {}
        max_tokens = int(stop.get("max_tokens") or 16)
        ignore_eos = bool(stop.get("ignore_eos", True))

        seq = TokenBlockSequence.from_tokens(token_ids, cfg.block_size)
        prefix_hashes = seq.sequence_hashes()

        # -- admission: the real engine's contract, mock-sized ------------
        # expired deadline bounces BEFORE taking a slot (HTTP 504), and an
        # injected engine.admit drop behaves like the worker vanishing
        # pre-admit (retryable ServiceUnavailable — migration re-drives)
        if context.deadline_expired:
            raise DeadlineExceeded(
                f"request {context.id} deadline passed before admission"
            )
        if FAULTS.enabled:
            try:
                await FAULTS.fire(
                    "engine.admit", instance=cfg.fault_instance
                )
            except ConnectionError as e:
                raise ServiceUnavailable(f"injected admit drop: {e}") from e
        _tenant, priority = tenancy_from_headers(context.headers)

        self._waiting += 1
        self._publish_metrics()
        owned: list[int] = []  # block hashes this request holds a ref on
        try:
            await self._admit.acquire(priority)  # class-priority admission
        finally:
            self._waiting -= 1
        try:
            self._running += 1
            try:
                # --- prefill ---------------------------------------------
                reused = self.kv.touch(prefix_hashes)
                owned.extend(prefix_hashes[:reused])
                new_hashes = prefix_hashes[reused:]
                if new_hashes:
                    parents = [
                        seq.blocks[i].parent_sequence_hash
                        for i in range(reused, len(seq.blocks))
                    ]
                    try:
                        self.kv.allocate(new_hashes, parents)
                        owned.extend(new_hashes)
                    except NotEnoughBlocks:
                        yield {
                            "token_ids": [],
                            "finish_reason": "error",
                            "error": "kv pool exhausted",
                        }
                        return
                uncached_tokens = len(token_ids) - reused * cfg.block_size
                await self._sleep(
                    cfg.prefill_base_s
                    + cfg.prefill_per_token_s * max(uncached_tokens, 0)
                )
                self._publish_metrics()

                # --- decode ----------------------------------------------
                generated = 0
                while generated < max_tokens:
                    if context.is_stopped:
                        yield {"token_ids": [], "finish_reason": "cancelled"}
                        return
                    if context.deadline_expired:
                        # generation CUT at the end-to-end deadline: the
                        # real engine's mid-generation contract
                        yield {"token_ids": [], "finish_reason": "error",
                               "error": "deadline exceeded"}
                        return
                    step_t0 = time.perf_counter()
                    if FAULTS.enabled:
                        try:
                            # instance= scopes sticky per-worker faults
                            # (a delay here is the measured fingerprint's
                            # whole point: it lands in step_time_ewma_ms)
                            await FAULTS.fire(
                                "engine.step", instance=cfg.fault_instance
                            )
                        except (ConnectionError, RuntimeError) as e:
                            # the real engine fails every in-flight stream
                            # on a step fault, then keeps serving — mirror
                            # the per-stream half here
                            yield {
                                "token_ids": [],
                                "finish_reason": "error",
                                "error": f"injected step failure: {e}",
                            }
                            return
                    # batch pressure: decode step slows with concurrency
                    pressure = 1.0 + 0.02 * max(self._running - 1, 0)
                    await self._sleep(cfg.decode_step_s * pressure)
                    dt_ms = (time.perf_counter() - step_t0) * 1000.0
                    self.step_time_ewma_ms = (
                        dt_ms if self.step_time_ewma_ms == 0.0
                        else 0.8 * self.step_time_ewma_ms + 0.2 * dt_ms
                    )
                    if cfg.echo_prompt and token_ids:
                        # replay the prompt once, then stop cleanly
                        tok = (
                            token_ids[generated]
                            if generated < len(token_ids)
                            else cfg.eos_token_id
                        )
                    else:
                        tok = self._rng.randrange(3, cfg.vocab_size)
                    sealed = seq.append(tok)
                    if sealed is not None:
                        # new decode block materializes in the KV pool
                        try:
                            self.kv.allocate(
                                [sealed.sequence_hash],
                                [sealed.parent_sequence_hash],
                            )
                            owned.append(sealed.sequence_hash)
                        except NotEnoughBlocks:
                            yield {
                                "token_ids": [tok],
                                "finish_reason": "error",
                                "error": "kv pool exhausted mid-decode",
                            }
                            return
                    generated += 1
                    is_eos = (not ignore_eos) and tok == cfg.eos_token_id
                    if cfg.echo_prompt and generated > len(token_ids):
                        # echo finished (the emitted token was the closing
                        # EOS): stop regardless of ignore_eos
                        is_eos = True
                    done = generated >= max_tokens or is_eos
                    item = {
                        "token_ids": [tok],
                        "finish_reason": (
                            "stop" if is_eos else "length" if done else None
                        ),
                    }
                    if generated == 1:
                        # routing-quality observability: how much of the
                        # prompt the serving worker actually reused (ref
                        # mocker KvStats / router bench hit-rate surfaces)
                        item["cached_blocks"] = reused
                    yield item
                    if done:
                        return
            finally:
                self._running -= 1
                self.kv.free(owned)
                self._publish_metrics()
        finally:
            self._admit.release()
