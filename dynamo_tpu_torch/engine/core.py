"""InferenceEngine: continuous batching over the paged PyTorch model.

The counterpart of dynamo_tpu/engine/core.py, written for this package and
reduced to the serving core. One dedicated step THREAD owns the device:

  admit (by priority class and tenant, into free slots) -> packed prefill
        + first-token sample -> decode bursts over all active slots
        -> stream tokens

Prefix caching is page-granular and keyed by the sequence-hash chain of
tokens.py. Completed requests' sealed pages stay cached (evictable LRU).
Every seal and eviction is a KV event (``events``, a KvEventPublisher), and
the engine's load goes out as ForwardPassMetrics (``metrics``) at the
reference's points: admissions, chunked-prefill advances, slot releases,
the admin cache clear and every 16th decode step. Both publishers are
attached by the worker; the step thread calls them, and they post to the
loop.

A prompt whose uncached tail exceeds ``max_prefill_chunk_tokens`` prefills
in chunks, one per step, interleaved with decode bursts (``_PartialPrefill``).
Decode bursts run through ``engine/graphs.DecodeGraphs``: on a CUDA device
every burst replays a captured step graph. With ``pipeline_decode`` up to
``pipeline_depth`` bursts are in flight, each fed on the device from the
previous ones' tokens. With ``async_admissions`` (the default) a prompt's
first token is sampled on the device right after its prefill, feeds the
next burst there, and lands on the host later, so the step thread never
waits for it.

With ``spec_mode="ngram"`` greedy, logprob-free requests decode
speculatively (engine/spec.py): each cycle, every slot whose drafts keep
verifying drafts from its own history, and all of them verify in one
packed dispatch (``_spec_phase``: ``engine/graphs.VerifyGraphs``, one
captured graph per power-of-two row count), landing 1..k+1 tokens each,
while every other slot takes the decode burst. The stream equals
spec-off's at temperature 0.

Admission is the reference's overload plane (engine/tenancy.py): the
waiting queue is a ``TenantScheduler`` that serves the interactive class
first and shares each class between tenants by weighted fair queueing,
charges each request's token cost (prompt + decode budget) to its tenant's
token bucket (``OverQuota``, HTTP 429, when it cannot pay), bounds the
queue at ``max_waiting`` (shedding a lower-priority entry in a
higher-priority arrival's favour, else ``ServiceUnavailable``), and, with
``preemption``, pauses the newest batch stream for an interactive request
that finds no free slot or no free pages. A paused stream re-enqueues
prompt + generated with its seed pinned and resumes by re-prefill through
the prefix cache (the reference also offloads its blocks to the KVBM host
tier, which this package does not have yet). Tenant and priority come from
the ``x-dyn-tenant`` / ``x-dyn-priority`` headers of the Context, or the
request's ``tenant`` / ``priority`` fields. A resume prompt stamped with
``token_checksum`` by the migration operator is verified at intake
(``IntegrityError``, a StreamError, on a mismatch).

``generate(request, context)`` is the AsyncEngine surface: it yields
``{"token_ids": [...]}`` deltas (plus ``"logprobs"`` entries when asked)
and ends with an item whose ``finish_reason`` is ``stop``, ``length``,
``cancelled`` or ``error``. Request fields read: ``token_ids``; ``sampling``
(temperature, top_k, top_p, seed); ``stop_conditions`` (max_tokens,
ignore_eos, stop_token_ids, min_tokens); ``eos_token_ids``;
``output_options.logprobs`` (the sampled token's logprob plus the top N,
N clamped to 20).

Guided decoding (guided/): with a token vocabulary (``guided_vocab``, which
the worker builds from its tokenizer) a request carrying a grammar
(``guided``: the frontend's ``{regex, key, kind, prompt_len}``) compiles it
at intake, off the step thread, and a bad grammar or the armed
``engine.guided_compile`` fault site is a typed ``invalid_request`` error
item (HTTP 400) with no page, no slot and no quota charge kept; without a
vocabulary (or ``guided_mode="off"``) every guided request is refused so.
Its slot carries a ``GuidedState`` cursor advanced on the host as tokens
land. Its first token is sampled synchronously under the start state's
mask; while a constrained slot is live the engine leaves pipelining and
dispatches single masked steps (a pipelined burst's mask would predate
the in-flight tokens), free slots riding the same step with all-True rows;
with speculation a greedy guided slot walks its draft on a scratch cursor
and verifies under [n, W, V] masks. It is never a preemption victim.
``dynamo_guided_requests_total{outcome}`` counts each finish (ok,
truncated, violation, aborted) and each refusal (compile_error,
unavailable).

Not in this engine yet (see ROADMAP): KVBM and disagg,
SPMD/meshes, multimodal, embeddings, telemetry and tracing, the fault
sites other than ``engine.spec_verify``, ``engine.preempt`` and the
``migration.resume`` corrupt site.

The engine is family-blind (models/family.py): a DeepSeek spec runs MLA
(models/mla.py) through the same scheduler, prefix cache, KV events,
decode graphs, verify graphs and guided masks, its latent cache in the
``k_pages`` slot and an empty placeholder in ``v_pages`` (``pool_bytes``
is the latent cache's); its forwards report 0 dropped slots, as the
reference's MLA family does.

MoE specs (models/moe.py): every prefill, packed prefill, chunk and verify
returns its capacity-dropped slot count as a device scalar, which the
engine sums on the device (``_note_moe_dropped``, no host read on the hot
path); every 64th metrics publish fetches the total into
``moe_dropped_slots`` and publishes it in ``ForwardPassMetrics``, as the
reference does. A packed prefill of a MoE spec pads its group to
``prefill_pack_size`` rows, as the reference's always does: the experts'
capacity, and so the drops, depend on the rows routed.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator

import numpy as np
import torch

from dynamo_tpu_torch.engine.cache import OutOfPages, PageAllocator, SeqPages
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.graphs import DecodeGraphs, HostCopy, VerifyGraphs
from dynamo_tpu_torch.engine.sampling import (
    greedy_tokens,
    mask_logits,
    sample_tokens,
    token_logprobs,
)
from dynamo_tpu_torch.engine.spec import SPEC_TOKENS, SlotSpec
from dynamo_tpu_torch.engine.tenancy import TenantScheduler
from dynamo_tpu_torch.guided.runtime import GUIDED_REQUESTS, GrammarCompiler
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.models.family import get_family
from dynamo_tpu_torch.models.llama import resolve_device
from dynamo_tpu_torch.runtime.context import (
    PRIORITY_HEADER,
    TENANT_HEADER,
    Context,
    DeadlineExceeded,
    OverQuota,
    ServiceUnavailable,
    tenancy_from_headers,
)
from dynamo_tpu_torch.runtime.faults import FAULTS, FaultDrop, FaultInjected
from dynamo_tpu_torch.runtime.integrity import verify_resume_tokens
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.engine")

MAX_PAGE_STALLS = 2000  # admission passes / decode steps a request may wait for pages
MAX_SPEC_STALLS = 200  # verify cycles a spec slot may wait for its fed token's page


@dataclass
class _Slot:
    request_id: str
    context: Context
    out_q: asyncio.Queue
    seq: TokenBlockSequence  # prompt + generated tokens
    pages: SeqPages
    seq_len: int  # tokens currently in the KV cache
    remaining: int  # decode budget left
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    ignore_eos: bool = False
    stop_token_ids: frozenset[int] = frozenset()
    eos_ids: frozenset[int] = frozenset((2,))
    min_tokens: int = 0
    generated: int = 0
    last_token: int = 0
    sample_seed: int = 0  # per-request seed (reproducible if client-set)
    stalled_steps: int = 0  # consecutive steps skipped waiting for pages
    logprobs: int | None = None  # None = off, N = sampled + top-N per token
    # async admission: the first sampled token is still on the device (it
    # feeds the next decode burst there); its host value lands later
    first_pending: bool = False
    spec: SlotSpec | None = None  # speculative decoding state (greedy slots)
    # tenancy (engine/tenancy.py): who this stream belongs to, its priority
    # class, and the request dict a preemption rebuilds its resume from
    tenant: str = "default"
    priority: str = "interactive"
    request: dict[str, Any] | None = None
    admitted_seq: int = 0  # monotonic admission order (preempt newest first)
    # guided decoding (guided/runtime.py): the grammar cursor the host
    # advances as tokens land, None for a free slot
    guided: Any | None = None


@dataclass
class _Waiting:
    request: dict[str, Any]
    context: Context
    out_q: asyncio.Queue
    # perf_counter at enqueue: the admit-wait start the reference's step
    # profiler reads (ROADMAP Queue A item 13)
    enq_t: float = 0.0
    # the TenantScheduler's keys: the class picks the lane group, the
    # tenant the lane, the cost the weighted-fair vtime advance
    tenant: str = "default"
    priority: str = "interactive"
    cost: float = 1.0
    # True when generate() charged the tenant's bucket: a zero-service
    # bounce refunds only charged entries (preemption resumes re-enter
    # uncharged)
    charged: bool = False
    page_stalls: int = 0  # admission passes bounced on OutOfPages


@dataclass
class _PartialPrefill:
    """A long prompt mid-way through chunked prefill: the engine runs one
    chunk per step, interleaved with decode bursts. Its slot stays empty
    (and reserved: no admission runs while a partial is live) until the
    last chunk completes."""

    slot_idx: int
    waiting: _Waiting
    seq: TokenBlockSequence
    sp: SeqPages
    token_ids: list[int]
    done: int  # prompt tokens already in the KV cache
    max_tokens: int


@dataclass
class _Admitted:
    """A prompt whose prefill has run: its last position's logits [V] on
    the device and, when the first token was sampled on the prefill's
    dispatch (async admissions), ``pre = (samples, row, seed)``."""

    slot_idx: int
    waiting: _Waiting
    seq: TokenBlockSequence
    sp: SeqPages
    token_ids: list[int]
    max_tokens: int
    logits: torch.Tensor
    pre: tuple | None = None


_REQUEUED = object()  # _prefill sentinel: entry went back to its lane head


class InferenceEngine:
    def __init__(
        self,
        spec: ModelSpec,
        config: EngineConfig | None = None,
        *,
        params=None,
        device: str | torch.device | None = None,
        event_publisher=None,
        metrics_publisher=None,
        guided_vocab=None,
    ):
        self.spec = spec
        self.config = config or EngineConfig()
        cfg = self.config
        if self._prefill_chunk_max() % cfg.page_size:
            raise ValueError(
                f"prefill chunk of {self._prefill_chunk_max()} tokens is not a "
                f"multiple of page_size {cfg.page_size}: chunks must start on "
                "page boundaries")
        self.device = resolve_device(device)
        self.fam = get_family(spec)
        if params is None:
            params = self.fam.init_params(spec, cfg.seed, device=self.device)
        self.params = params
        # +1 page: index 0 is the trash page. kv_dtype "fp8" makes both
        # pools QuantPools (ops/quant.py): e4m3 values + bf16 scales
        self.kv_dtype = cfg.kv_dtype
        self.k_pages, self.v_pages = self.fam.init_cache(
            spec, cfg.num_pages + 1, cfg.page_size,
            device=self.device, kv_dtype=self.kv_dtype,
        )
        # device bytes of both pools (values and, for fp8, scales)
        self.pool_bytes = sum(p.nbytes for p in (self.k_pages, self.v_pages))
        log.info("KV pools: kv_dtype %s, %d pages of %d tokens, %.3f GB",
                 self.kv_dtype, cfg.num_pages + 1, cfg.page_size,
                 self.pool_bytes / 1e9)
        # KV events and load metrics (kv_router/publisher.py), None until a
        # worker attaches its publishers
        self.events = event_publisher
        self.metrics = metrics_publisher
        self._metrics_publishes = 0
        self._moe_dropped_dev = None  # device-side running drop count
        self.moe_dropped_slots = 0  # last fetched total (metrics surface)
        self.allocator = PageAllocator(
            cfg.num_pages + 1, cfg.page_size,
            on_store=self._on_store, on_evict=self._on_evict,
        )
        self._slots: list[_Slot | None] = [None] * cfg.max_decode_slots
        # fair admission (engine/tenancy.py): weighted-fair tenant lanes in
        # two priority classes plus token buckets. The event loop enqueues
        # and sheds, the step thread dequeues; one lock inside covers both
        self._waiting = TenantScheduler(
            cfg.tenants if isinstance(cfg.tenants, dict) else None)
        # paused batch streams by reason (interactive_admission,
        # interactive_pages)
        self.preemptions: dict[str, int] = {}
        self._admit_seq = 0  # monotonic admission order for victim ranking
        self.admission_rejects = {
            "draining": 0, "saturated": 0, "deadline": 0,
            "over_quota": 0, "shed": 0,
        }
        self._seed_counter = cfg.seed
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: int | None = None
        self._wake = threading.Event()
        self._closed = False
        # graceful drain (worker SIGTERM): refuse new requests, finish the
        # admitted ones; the deadline prices the refusals' Retry-After
        self._draining = False
        self._drain_deadline: float | None = None
        self._clear_cache_requested = False
        self._partial: _PartialPrefill | None = None
        # dispatched-but-unprocessed decode bursts, oldest first (at most
        # pipeline_depth + 1 when pipelined)
        self._pipeline: list[dict] = []
        # async first-token waves, oldest first: each holds a device sample
        # whose host copy is in flight; waves touch disjoint live slots
        self._admit_waves: list[dict] = []
        # one fixed logprob width for every burst that asks (the graph
        # variant), as the JAX engine's static n_logprobs
        self._n_lp = (min(20, spec.vocab_size - 1)
                      if self.fam.supports_logprobs else 0)
        # guided decoding (guided/): the grammar compiler and its per-
        # (grammar, vocab) mask cache; needs a token vocabulary (the worker
        # builds one from its tokenizer, tests pass one)
        self._guided = None
        if guided_vocab is not None and cfg.guided_mode != "off":
            self._guided = GrammarCompiler(
                guided_vocab, vocab_size=spec.vocab_size,
                cache_entries=cfg.guided_cache_entries)
        # with a compiler, the decode and verify graphs get masked variants
        mask_width = spec.vocab_size if self._guided is not None else None
        self._graphs = DecodeGraphs(
            self._graph_step, batch=len(self._slots),
            pages_per_seq=cfg.max_pages_per_seq,
            max_steps=max(1, cfg.decode_steps_per_dispatch),
            n_logprobs=self._n_lp, device=self.device, vocab_size=mask_width,
        )
        # speculative decoding (engine/spec.py): the verify grid, one
        # captured graph per power-of-two row count at width k_max + 1
        self._spec_on = (cfg.spec_mode == "ngram"
                         and getattr(self.fam, "supports_spec_decode", False))
        self._verify = VerifyGraphs(
            self._verify_fn, batch=len(self._slots), width=cfg.spec_k_max + 1,
            pages_per_seq=cfg.max_pages_per_seq, device=self.device,
            vocab_size=mask_width,
        ) if self._spec_on else None
        self.spec_verifies = 0  # verify dispatches issued
        self.spec_drafted = 0  # draft tokens proposed into verifies
        self.spec_accepted = 0  # drafts the target's argmax confirmed
        self.spec_rejected = 0  # drafts cut by accept-longest-prefix
        self.spec_rows = 0  # slot rows verified (a dispatch verifies 1..B)
        # wall seconds per verify dispatch, host clock from the dispatch to
        # its targets on the host
        self.verify_times: collections.deque = collections.deque(maxlen=4096)
        self.steps = 0  # decode model steps dispatched
        self.cached_prompt_tokens = 0  # prompt tokens served from the prefix cache
        self.eager_readmits = 0  # admission passes that refilled a freed slot at once
        self.prefill_chunks = 0  # chunked-prefill chunks run
        # wall seconds per decode dispatch, host clock from the dispatch to
        # its sampled tokens on the host
        self.decode_step_times: collections.deque = collections.deque(maxlen=4096)
        # wall seconds per step-loop cycle that did work: the saturation
        # Retry-After's step-time samples
        self.step_times: collections.deque = collections.deque(maxlen=4096)
        # rolling wall-clock latency of a step that did work, in ms (0 = not
        # measured yet): published in ForwardPassMetrics as the worker's
        # degradation fingerprint
        self.step_time_ewma_ms = 0.0

    # -- public API --------------------------------------------------------

    async def start(self) -> "InferenceEngine":
        if self._thread is None or not self._thread.is_alive():
            self._loop = asyncio.get_running_loop()
            self._loop_thread = threading.get_ident()
            self._thread = threading.Thread(
                target=self._thread_loop, name="engine-step", daemon=True
            )
            self._thread.start()
        return self

    @property
    def is_dead(self) -> bool:
        """True when the step thread exited WITHOUT an orderly close: the
        engine monitor's signal (runtime/health.py ``EngineMonitor``)."""
        return (
            self._thread is not None
            and not self._thread.is_alive()
            and not self._closed
        )

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            await asyncio.to_thread(self._thread.join, 10.0)
        if self._thread is None or not self._thread.is_alive():
            self.release_graphs()
        # the step thread is gone: flush the last KV events (bounded: a hub
        # that went away first retries its reconnect window), stop publishing
        for pub in (self.events, self.metrics):
            if pub is not None:
                try:
                    await asyncio.wait_for(pub.close(), 2.0)
                except (asyncio.TimeoutError, ConnectionError):
                    log.warning("publisher close: last KV events not flushed")

    def precompile(self) -> None:
        """Capture every decode graph variant, and with spec on the verify
        grid, now, before traffic (the JAX engine's precompile()); the
        masked variants too when the engine serves guided requests. Call
        before start() or while idle; a no-op on the CPU."""
        self._graphs.precompile()
        if self._verify is not None:
            self._verify.precompile()

    def release_graphs(self) -> None:
        """Drop the captured decode and verify graphs. They hold raw
        pointers to the KV pools and the weights: call this before freeing
        either."""
        self._graphs.release()
        if self._verify is not None:
            self._verify.release()

    def request_clear_cache(self) -> None:
        """Admin: drop every inactive prefix-cache page (the HTTP
        clear_kv_blocks route). Honoured on the step thread, the
        allocator's owner, after the in-flight bursts land."""
        self._clear_cache_requested = True
        self._wake.set()

    def begin_drain(self, deadline_s: float | None = None) -> None:
        """Graceful-drain entry (the worker's SIGTERM path): refuse NEW
        requests with ServiceUnavailable (retryable, so the frontend's
        migration operator re-drives them on a live worker) while admitted
        work runs to completion. The step loop keeps running until close().
        ``deadline_s``: seconds until the drain force-cancels; refusals
        carry what is left of it as Retry-After."""
        self._draining = True
        if deadline_s is not None:
            self._drain_deadline = time.monotonic() + max(deadline_s, 0.0)
        self._wake.set()

    @property
    def draining(self) -> bool:
        return self._draining

    def _drain_retry_after(self) -> float:
        """Retry-After for draining refusals: the remaining drain window
        when known (clamped to [1, 60]), else 1 s."""
        if self._drain_deadline is None:
            return 1.0
        return min(max(self._drain_deadline - time.monotonic(), 1.0), 60.0)

    def _saturation_retry_after(self) -> float:
        """Retry-After for saturation bounces and sheds, from live state:
        queue depth x recent mean step time / slot count estimates how long
        until the backlog drains a slot's worth of work. Clamped to
        [0.25, 30] so a cold engine (no step samples yet) still gives a
        sane hint."""
        depth = self._waiting.qsize()
        samples = list(self.step_times)[-64:]
        mean_step = (sum(samples) / len(samples)) if samples else 0.05
        est = depth * mean_step / max(len(self._slots), 1)
        return min(max(est, 0.25), 30.0)

    def _request_tenancy(
        self, request: dict[str, Any], context: Context
    ) -> tuple[str, str]:
        """(tenant, priority) for one request: the validated wire headers
        first (the frontend stamped them into Context.headers), the request
        dict's fields as the direct caller's fallback. Past the scheduler's
        dynamic-tenant cap, fresh tenant ids share the overflow tenant."""
        tenant, priority = tenancy_from_headers(context.headers)
        if TENANT_HEADER not in context.headers and request.get("tenant"):
            tenant = str(request["tenant"])
        if (PRIORITY_HEADER not in context.headers
                and request.get("priority") in ("interactive", "batch")):
            priority = str(request["priority"])
        return self._waiting.resolve(tenant), priority

    def inflight(self) -> int:
        """Admitted-but-unfinished work (the drain-completion signal)."""
        return (
            sum(s is not None for s in self._slots)
            + self._waiting.qsize()
            + (1 if self._partial is not None else 0)
        )

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        """AsyncEngine surface: stream token deltas for one request."""
        if self._closed:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": "engine closed"}
            return
        tenant, priority = self._request_tenancy(request, context)
        if self._draining:
            # typed refusal: it crosses the transport as a retryable,
            # 503-mappable error (another worker may accept)
            self.admission_rejects["draining"] += 1
            raise ServiceUnavailable(
                "worker draining", retry_after_s=self._drain_retry_after()
            )
        max_waiting = self.config.max_waiting
        if (max_waiting and self._waiting.qsize() >= max_waiting
                and not self._waiting.sheddable_below(priority)):
            # full queue and nothing outranked: bounce now; with a
            # sheddable lower-priority entry the enqueue check sheds it
            self.admission_rejects["saturated"] += 1
            raise ServiceUnavailable(
                f"engine saturated ({self._waiting.qsize()} waiting)",
                retry_after_s=self._saturation_retry_after(),
            )
        if context.deadline_expired:
            self.admission_rejects["deadline"] += 1
            raise DeadlineExceeded(
                f"request {context.id} deadline passed before admission"
            )
        await self.start()
        # a migration resume prompt arrives stamped with its checksum; a
        # mismatch raises IntegrityError, a StreamError, so the operator
        # re-drives from its pristine copy
        verify_resume_tokens(request)
        token_ids = list(request.get("token_ids") or [])
        if not token_ids:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": "empty token_ids"}
            return
        if len(token_ids) >= self.config.max_context:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": f"prompt exceeds max context {self.config.max_context}"}
            return
        # token-bucket quota: the request's full token cost (prompt + decode
        # budget) before any staging; over quota is a typed, non-retryable
        # bounce whose Retry-After comes from bucket state (HTTP 429).
        # Preemption resumes re-enter through the queue, never here
        cost = float(len(token_ids) + self._decode_budget(request, len(token_ids)))
        quota_retry = self._waiting.charge(tenant, cost)
        if quota_retry is not None:
            self.admission_rejects["over_quota"] += 1
            raise OverQuota(
                f"tenant {tenant!r} over token quota (cost {cost:.0f} tokens)",
                retry_after_s=quota_retry,
            )
        if request.get("guided"):
            # compile (or fetch) the grammar before admission, off the step
            # thread: a bad grammar bounces here as a typed invalid_request
            # (HTTP 400) with no slot or page touched, and a good one is a
            # cache hit when _make_slot builds the slot's cursor
            err = outcome = None
            if self._guided is None:
                outcome = "unavailable"
                err = ("guided decoding unavailable on this worker "
                       "(guided_mode=off, multi-host SPMD, or no tokenizer "
                       "vocabulary)")
            else:
                try:
                    await asyncio.to_thread(self._guided.compile, request["guided"])
                except Exception as e:  # noqa: BLE001
                    outcome = "compile_error"
                    err = f"guided grammar rejected: {e}"
            if err is not None:
                GUIDED_REQUESTS.labels(outcome=outcome).inc()
                # zero service rendered: the quota charge comes back
                self._waiting.refund(tenant, cost)
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"invalid_request: {err}"}
                return
        if max_waiting and self._waiting.qsize() >= max_waiting:
            # re-check at the enqueue (arrivals that passed the early check
            # together must not blow past the bound): shed the lowest-
            # priority, most-over-quota, newest waiting entry in this
            # request's favour when one ranks below it
            victim = self._waiting.shed_victim(priority)
            if victim is None:
                self.admission_rejects["saturated"] += 1
                self._waiting.refund(tenant, cost)
                raise ServiceUnavailable(
                    f"engine saturated ({self._waiting.qsize()} waiting)",
                    retry_after_s=self._saturation_retry_after(),
                )
            self.admission_rejects["shed"] += 1
            # zero service rendered: the victim's charge comes back
            self._refund_if_charged(victim)
            self._post(victim.out_q, {"_shed": self._saturation_retry_after()})
        out_q: asyncio.Queue = asyncio.Queue()
        self._waiting.put_nowait(_Waiting(
            request, context, out_q, enq_t=time.perf_counter(), tenant=tenant,
            priority=priority, cost=cost, charged=True))
        self._wake.set()
        deadline_hit = False
        while True:
            # after the deadline every wait is bounded: a stuck step must
            # not turn a deadline into a hang
            remaining = 2.0 if deadline_hit else context.remaining_s()
            try:
                if remaining is None:
                    item = await out_q.get()
                else:
                    item = await asyncio.wait_for(out_q.get(), remaining)
            except asyncio.TimeoutError:
                if deadline_hit:
                    yield {"token_ids": [], "finish_reason": "cancelled",
                           "error": "deadline exceeded"}
                    return
                # deadline passed mid-generation: the step loop finishes
                # the slot as 'cancelled'
                deadline_hit = True
                context.stop_generating()
                self._wake.set()
                continue
            if "_shed" in item:
                # shed from the queue in a higher-priority arrival's favour:
                # the retryable typed refusal (another worker may take it)
                raise ServiceUnavailable(
                    "shed under overload (outranked while waiting)",
                    retry_after_s=float(item["_shed"]),
                )
            yield item
            if item.get("finish_reason") is not None:
                return

    # -- KV events and load ------------------------------------------------

    def _on_store(self, sh: int, parent: int) -> None:
        if self.events is not None:
            self.events.block_stored(sh, parent)

    def _on_evict(self, shs: list[int]) -> None:
        if self.events is not None and shs:
            self.events.blocks_removed(shs)

    def _note_moe_dropped(self, dropped: torch.Tensor) -> None:
        """Add a forward's MoE capacity-dropped slot count to the running
        total ON THE DEVICE (no sync on the hot path); _publish_metrics
        fetches the total at a low duty cycle."""
        if not self.spec.num_experts:
            return
        # the first count is copied: a verify's is the graph's static output
        self._moe_dropped_dev = (
            dropped.clone() if self._moe_dropped_dev is None
            else self._moe_dropped_dev + dropped
        )

    def _publish_metrics(self) -> None:
        if self.metrics is not None:
            self._metrics_publishes += 1
            if (self._moe_dropped_dev is not None
                    and self._metrics_publishes % 64 == 1):
                self.moe_dropped_slots = int(self._moe_dropped_dev)
            self.metrics.publish(ForwardPassMetrics(
                active_kv_blocks=self.allocator.active_pages,
                total_kv_blocks=self.allocator.num_pages - 1,
                waiting_requests=self._waiting.qsize(),
                running_requests=sum(s is not None for s in self._slots),
                moe_dropped_slots=self.moe_dropped_slots,
                step_time_ms=self.step_time_ewma_ms,
            ))

    # -- step loop ---------------------------------------------------------

    def _post(self, q: asyncio.Queue, item: Any) -> None:
        """Thread-safe queue put: the step thread must not touch asyncio
        primitives directly."""
        if self._loop is None or threading.get_ident() == self._loop_thread:
            q.put_nowait(item)
        else:
            self._loop.call_soon_threadsafe(q.put_nowait, item)

    def _thread_loop(self) -> None:
        """The step thread: owns the device; blocking waits are fine here."""
        while not self._closed:
            try:
                step_t0 = time.perf_counter()
                did_work = self._step()
                if did_work:
                    dt = time.perf_counter() - step_t0
                    self.step_times.append(dt)
                    dt_ms = dt * 1000.0
                    self.step_time_ewma_ms = (
                        dt_ms if self.step_time_ewma_ms == 0.0
                        else 0.8 * self.step_time_ewma_ms + 0.2 * dt_ms
                    )
                if not did_work:
                    self._wake.clear()
                    if (self._waiting.empty() and not any(self._slots)
                            and not self._clear_cache_requested):
                        self._wake.wait()
                    else:
                        self._wake.wait(self.config.step_idle_sleep_s)
            except Exception:  # noqa: BLE001
                # fail every in-flight request, then KEEP SERVING: one bad
                # step must not brick the engine
                log.exception("engine step failed; failing in-flight requests")
                self._fail_all("engine step failure")
                time.sleep(0.05)
        self._fail_all("engine closed")

    def _fail_all(self, error: str) -> None:
        self._pipeline.clear()
        self._admit_waves.clear()
        p, self._partial = self._partial, None
        if p is not None:
            self.allocator.release(p.sp.pages)
            p.sp.pages = []
            self._error(p.waiting, error)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._finish(i, slot, "error", error=error)
        for w in self._waiting.drain():
            self._refund_if_charged(w)
            self._error(w, error)

    def _step(self) -> bool:
        did = False
        if self._admit_waves:
            # land admission waves lazily: each once its host copy is in
            # (or, aged, when no in-flight burst will land it)
            did |= self._materialize_waves()
        if self._pipeline:
            # cancels need exact slot state: land the in-flight bursts
            # first. Plain admissions do not (the device stream is in
            # order; bursts are guarded by active mask + request id). A
            # live chunked prefill flushes too: its slot bookkeeping
            # interleaves with the reserved slot.
            stopped = any(s is not None and s.context.is_stopped
                          for s in self._slots)
            if self._partial is not None or stopped or self._clear_cache_requested:
                self._flush_pipeline()
                did = True
        if self._clear_cache_requested:
            self._clear_cache_requested = False
            n = self.allocator.clear_cache()
            log.info("admin clear_kv_blocks: evicted %d cached pages", n)
            self._publish_metrics()
            did = True
        # advance an in-flight chunked prefill, or admit waiting requests
        # up to a per-step token budget; decode still runs below, so a
        # prefill steals at most a budget's (or a chunk's) worth of time
        if self._partial is not None:
            self._advance_partial_safe()
            did = True
            self._publish_metrics()
        else:
            did |= self._admit_phase()
        # speculative verify of the spec-managed slots: each lands 1..k+1
        # tokens in one packed dispatch; the others take the burst below
        if self._spec_on:
            did |= self._spec_phase()
        if any(s is not None for s in self._slots):
            did |= self._decode_step()
        elif self._pipeline:
            # every participant finished early: drain stale bursts
            self._flush_pipeline()
            did = True
        return did

    def _admit_phase(self) -> bool:
        """Admit waiting requests in the scheduler's order (interactive
        class first, then the tenant lane of least vtime) into free slots,
        pausing a batch stream for an interactive head that finds no free
        slot (``preemption``), up to a per-step
        prompt-token budget while other streams decode (a queue of short
        prompts lands in one step; a long one waits a step rather than
        stalling running decodes). On a cold batch, admit at most half the
        slots per step: staggered cohorts keep closed-loop clients from
        locking into one convoy. A prompt longer than one chunk starts a
        chunked prefill, which stops admission until it completes. Returns
        True when any entry was handled."""
        cfg = self.config
        budget = cfg.max_prefill_tokens_per_step
        n_active = sum(s is not None for s in self._slots)
        decoding = n_active > 0
        warm = n_active * 2 >= len(self._slots)
        cold_cap = max(1, (len(self._slots) + 1) // 2)
        n_admitted = 0
        did = False
        preps: list[dict] = []
        reserved: set[int] = set()
        while self._partial is None:
            free_idx = next(
                (i for i, s in enumerate(self._slots)
                 if s is None and i not in reserved),
                None,
            )
            if free_idx is None and not self._waiting.empty():
                # no free slot for a waiting INTERACTIVE request: pause a
                # batch stream instead of making the interactive user wait
                # out the batch tenant's backlog
                free_idx = self._preempt_for_admission(reserved)
            # the head's cost, peeked before the dequeue
            head = self._waiting.peek()
            if free_idx is None or head is None:
                break
            cost = min(len(head.request.get("token_ids") or ()) or 1,
                       self._prefill_chunk_max())
            if n_admitted and cost > budget and decoding and not warm:
                break  # the first admission always proceeds
            if not decoding and n_admitted >= cold_cap:
                break
            try:
                waiting = self._waiting.get_nowait()
            except queue.Empty:
                break  # a concurrent shed emptied the queue since the peek
            if waiting.context.is_stopped:
                self._post(waiting.out_q,
                           {"token_ids": [], "finish_reason": "cancelled"})
                did = True
                continue
            out = self._prefill_safe(free_idx, waiting)
            if out is _REQUEUED:
                # page backpressure: nothing else can admit this pass; not
                # counted as work, so a page-stalled engine paces on the
                # idle wait instead of spinning
                break
            did = True
            if out is not None:
                preps.append(out)
                reserved.add(free_idx)
            budget -= cost
            n_admitted += 1
        if preps:
            self._complete_admissions(self._run_packed_prefills(preps))
        if did:
            self._publish_metrics()
        return did

    def _eager_readmit(self, freed: int) -> None:
        """Fill slots freed by the burst just processed within the same
        step cycle instead of leaving them idle until the next admission
        phase. When the queue is momentarily empty and a burst is still in
        flight, a bounded wait catches a closed-loop client's next request
        behind that burst's device time."""
        cfg = self.config
        if (not cfg.eager_readmit or freed <= 0 or self._partial is not None
                or self._closed):
            return
        if self._waiting.empty() and cfg.readmit_wait_s > 0 and self._pipeline:
            self._wake.clear()
            self._wake.wait(cfg.readmit_wait_s)
        if not self._waiting.empty() and self._admit_phase():
            self.eager_readmits += 1

    # -- priority preemption -----------------------------------------------

    def _preempt_for_admission(self, reserved: set[int]) -> int | None:
        """Slot-pressure preemption: the head of the waiting queue is
        interactive and no slot is free: pause a batch stream and hand its
        slot to the admission loop. Returns the freed index, or None (no
        eligible victim, preemption off, or the head is not interactive)."""
        if not self.config.preemption:
            return None
        head = self._waiting.peek()
        if head is None or head.priority != "interactive":
            return None
        return self._preempt_batch_slot(
            reason="interactive_admission", reserved=reserved)

    def _victim_slot(self) -> tuple[int, _Slot] | None:
        """Preemption victim policy: batch-class slots only, over-quota
        tenants first, newest admission first (the oldest batch stream
        keeps its progress). Slots whose first token is still on the device
        are not eligible, nor are guided slots (a resume would have to carry
        the grammar cursor, which a plain text re-prefill does not)."""
        best: tuple[tuple[int, int], int, _Slot] | None = None
        for i, slot in enumerate(self._slots):
            if slot is None or slot.priority != "batch":
                continue
            if slot.first_pending or slot.context.is_stopped or slot.remaining < 1:
                continue
            if slot.guided is not None:
                continue
            over = self._waiting.tenant_over_quota(slot.tenant)
            key = (0 if over else 1, -slot.admitted_seq)
            if best is None or key < best[0]:
                best = (key, i, slot)
        if best is None:
            return None
        return best[1], best[2]

    def _preempt_batch_slot(
        self, *, reason: str, reserved: set[int] | None = None,
        free_slot_ok: bool = True,
    ) -> int | None:
        """Pause one batch stream to make room (slots and pages):

        1. fire the ``engine.preempt`` fault site (an injected error skips
           the preemption: serving degrades to waiting, never breaks);
        2. process every in-flight burst and land every admission wave, so
           slot state is exact and no replay still reads the victim's
           pages (the bursts' record copies are what synchronise);
        3. seal the victim's complete blocks into the prefix cache;
        4. release its pages and slot as a finish does (the next replay's
           staged row for the slot reads inactive and writes only trash
           page 0), and re-enqueue ``prompt + generated`` with the shrunk
           budget and the seed pinned, uncharged, in its batch lane: the
           client's stream pauses, then resumes through the normal
           prefix-cache admission (greedy streams continue as unpaused).

        Returns the freed slot index (also when the flush alone freed one,
        unless ``free_slot_ok`` is False: a page-pressure caller's own empty
        slot would match and nothing would be freed), or None."""
        victim = self._victim_slot()
        if victim is None:
            return None
        if FAULTS.enabled:
            try:
                FAULTS.fire_sync("engine.preempt")
            except Exception as e:  # noqa: BLE001 - injected failure
                log.warning("engine.preempt fault: skipping preemption (%s)", e)
                return None
        self._flush_pipeline()
        self._materialize_waves(force=True)
        if free_slot_ok:
            free_idx = next(
                (i for i, s in enumerate(self._slots)
                 if s is None and i not in (reserved or ())),
                None,
            )
            if free_idx is not None:
                return free_idx  # the flush landed a finish
        i, slot = victim
        if self._slots[i] is not slot or slot.context.is_stopped:
            return None  # finished or cancelled during the flush
        self._maybe_seal(slot)
        resume = self._build_resume_request(slot)
        self.preemptions[reason] = self.preemptions.get(reason, 0) + 1
        self._finish(i, slot, "preempted", emit=False)
        self._waiting.put_nowait(_Waiting(
            resume, slot.context, slot.out_q, enq_t=time.perf_counter(),
            tenant=slot.tenant, priority=slot.priority,
            cost=float(len(resume["token_ids"]) + slot.remaining),
        ))
        log.info("preempted %s (tenant=%s, %d generated) for %s",
                 slot.request_id, slot.tenant, slot.generated, reason)
        return i

    @staticmethod
    def _build_resume_request(slot: _Slot) -> dict[str, Any]:
        """Resume request for a preempted stream: prompt + everything
        already streamed becomes the new prompt (sealed blocks rehit the
        prefix cache; only the unsealed tail re-prefills), the decode budget
        shrinks to what was left, and the sampling seed is pinned."""
        req = dict(slot.request)
        req["token_ids"] = [int(t) for t in slot.seq.tokens()]
        stop = dict(req.get("stop_conditions") or {})
        stop["max_tokens"] = max(int(slot.remaining), 1)
        if stop.get("min_tokens"):
            stop["min_tokens"] = max(int(stop["min_tokens"]) - slot.generated, 0)
        req["stop_conditions"] = stop
        sampling = dict(req.get("sampling") or {})
        sampling["seed"] = slot.sample_seed
        req["sampling"] = sampling
        return req

    def _refund_if_charged(self, waiting: _Waiting) -> None:
        """Credit back a charged entry's quota when it is bounced with zero
        service (shed, never-fitting prompt, page stalls exhausted, prefill
        failure): a tenant must not burn bucket on requests it was never
        served, or retryable errors decay into 429s."""
        if waiting.charged:
            waiting.charged = False  # at most one refund per entry
            self._waiting.refund(waiting.tenant, waiting.cost)

    # -- admission ---------------------------------------------------------

    @staticmethod
    def _opt(d: dict, key: str, default):
        v = d.get(key)
        return default if v is None else v

    def _decode_budget(self, req: dict, n_prompt: int) -> int:
        stop = req.get("stop_conditions") or {}
        max_tokens = stop.get("max_tokens")
        max_tokens = 16 if max_tokens is None else int(max_tokens)
        return max(min(max_tokens, self.config.max_context - n_prompt - 1), 1)

    def _prefill_chunk_max(self) -> int:
        cfg = self.config
        return min(cfg.max_prefill_chunk_tokens, cfg.prefill_buckets[-1])

    def _clamp_logprobs(self, n) -> int | None:
        """The one place the logprob width is set: at most 20 (the OpenAI
        surface's cap) and below the vocabulary size."""
        if n is None or not self.fam.supports_logprobs:
            return None
        return max(0, min(int(n), 20, self.spec.vocab_size - 1))

    def _error(self, waiting: _Waiting, msg: str) -> None:
        self._post(waiting.out_q,
                   {"token_ids": [], "finish_reason": "error", "error": msg})

    def _prefill_safe(self, slot_idx: int, waiting: _Waiting):
        """Per-request error isolation: a bad request must not kill the
        loop. Returns a prep dict (forward deferred to the packed prefill),
        ``_REQUEUED`` (page backpressure) or None (handled: an error, or a
        chunked prefill started)."""
        try:
            return self._prefill(slot_idx, waiting)
        except Exception as e:  # noqa: BLE001
            log.exception("prefill failed for %s", waiting.context.id)
            self._refund_if_charged(waiting)
            self._error(waiting, f"prefill failed: {e}")
            return None

    def _acquire_prompt_pages(
        self, request_id: str, seq: TokenBlockSequence, needed_pages: int,
        n_tokens: int,
    ) -> SeqPages:
        """Prefix-cache take + allocation to cover the prompt. At least one
        token stays uncached (prefill needs the last position's logits).
        Raises OutOfPages, holding nothing, if the pool is exhausted."""
        hashes = seq.sequence_hashes()
        page_size = self.config.page_size
        cached = self.allocator.take_prefix(hashes)
        while cached and len(cached) * page_size >= n_tokens:
            self.allocator.release([cached.pop()])
        sp = SeqPages(request_id=request_id)
        sp.pages = list(cached)
        sp.hashes = [hashes[i] for i in range(len(cached))]
        sp.cached_prefix_pages = len(cached)
        try:
            while sp.num_pages < needed_pages:
                sp.pages.append(self.allocator.alloc_page())
                sp.hashes.append(None)
        except OutOfPages:
            self.allocator.release(sp.pages)
            raise
        return sp

    def _prefill(self, slot_idx: int, waiting: _Waiting):
        cfg = self.config
        req = waiting.request
        token_ids = list(req["token_ids"])
        seq = TokenBlockSequence.from_tokens(token_ids, cfg.page_size)
        needed_pages = (len(token_ids) + cfg.page_size - 1) // cfg.page_size
        sp = None
        try:
            sp = self._acquire_prompt_pages(
                waiting.context.id, seq, needed_pages, len(token_ids)
            )
        except OutOfPages:
            # PAGE-pressure preemption: an interactive prompt that cannot
            # get pages may pause a batch stream and retry once
            if (cfg.preemption and waiting.priority == "interactive"
                    and self._preempt_batch_slot(
                        reason="interactive_pages", free_slot_ok=False)
                    is not None):
                try:
                    sp = self._acquire_prompt_pages(
                        waiting.context.id, seq, needed_pages, len(token_ids))
                except OutOfPages:
                    sp = None
        if sp is None:
            # page BACKPRESSURE: a neighbour finishing (or a later
            # preemption) frees pages, so the entry waits at its lane head,
            # with bounded patience; a prompt that could never fit errors
            # at once
            if needed_pages >= self.allocator.num_pages - 1:
                self._refund_if_charged(waiting)
                self._error(waiting, f"kv pages exhausted (prompt needs "
                                     f"{needed_pages} pages; pool can never hold it)")
                return None
            if waiting.page_stalls >= MAX_PAGE_STALLS:
                self._refund_if_charged(waiting)
                self._error(waiting, "kv pages exhausted (admission waited "
                                     f"{waiting.page_stalls} passes)")
                return None
            waiting.page_stalls += 1
            # lane-head requeue with the dequeue's vtime advance undone: a
            # stall is zero service and must not burn fair share
            self._waiting.requeue(waiting)
            return _REQUEUED
        start_pos = sp.cached_prefix_pages * cfg.page_size
        self.cached_prompt_tokens += start_pos
        max_tokens = self._decode_budget(req, len(token_ids))
        chunk_max = self._prefill_chunk_max()
        if start_pos + chunk_max >= len(token_ids):
            # fits one dispatch: the packed prefill stage runs it
            return {
                "slot_idx": slot_idx, "waiting": waiting, "seq": seq, "sp": sp,
                "token_ids": token_ids, "max_tokens": max_tokens,
                "start_pos": start_pos, "tail": len(token_ids) - start_pos,
            }
        # long prompt: the first chunk now, the rest on later steps,
        # interleaved with decode (_step)
        end = start_pos + chunk_max
        try:
            self._run_prefill_chunk(sp, token_ids, start_pos, end)
        except Exception:
            self.allocator.release(sp.pages)
            sp.pages = []
            raise
        self._partial = _PartialPrefill(
            slot_idx, waiting, seq, sp, token_ids, end, max_tokens
        )
        return None

    def _run_prefill_chunk(
        self, sp: SeqPages, token_ids: list[int], start: int, end: int
    ) -> torch.Tensor:
        """One bucketed prefill forward over positions [start, end) (start
        on a page boundary); returns the last position's logits [V]."""
        cfg = self.config
        new_tokens = token_ids[start:end]
        padded = np.zeros((cfg.bucket_for(len(new_tokens)),), np.int32)
        padded[: len(new_tokens)] = new_tokens
        block_table = np.zeros((cfg.max_pages_per_seq,), np.int32)
        block_table[: sp.num_pages] = sp.pages
        dev = self.device
        self.prefill_chunks += 1
        logits, dropped = self.fam.prefill(
            self.spec, self.params, torch.from_numpy(padded).to(dev),
            torch.from_numpy(block_table).to(dev), start, self.k_pages,
            self.v_pages, len(new_tokens),
        )
        self._note_moe_dropped(dropped)
        return logits

    def _advance_partial_safe(self) -> None:
        p = self._partial
        try:
            self._advance_partial()
        except Exception as e:  # noqa: BLE001
            log.exception("chunked prefill failed for %s", p.waiting.context.id)
            self._partial = None
            self.allocator.release(p.sp.pages)
            p.sp.pages = []
            self._error(p.waiting, f"prefill failed: {e}")

    def _advance_partial(self) -> None:
        """Run the next chunk of the in-flight chunked prefill; after the
        last one, seal the prompt and admit it like a packed prefill."""
        p = self._partial
        if p.waiting.context.is_stopped:
            self._partial = None
            self.allocator.release(p.sp.pages)
            p.sp.pages = []
            self._post(p.waiting.out_q,
                       {"token_ids": [], "finish_reason": "cancelled"})
            self._publish_metrics()
            return
        end = min(p.done + self._prefill_chunk_max(), len(p.token_ids))
        logits = self._run_prefill_chunk(p.sp, p.token_ids, p.done, end)
        p.done = end
        if end == len(p.token_ids):
            self._partial = None
            self._seal_prompt_blocks(p.sp, p.seq)
            self._complete_admissions([_Admitted(
                p.slot_idx, p.waiting, p.seq, p.sp, p.token_ids, p.max_tokens,
                logits)])

    def _run_packed_prefills(self, preps: list[dict]) -> list[_Admitted]:
        """Same-bucket prompts batch into one prefill_forward_batch of up
        to ``prefill_pack_size`` rows; singletons take the single-prompt
        forward. Groups are not padded to the pack size: PyTorch runs
        eagerly, so a new row count costs no compile. The first tokens are
        sampled on the same logits right away when the admission is async
        (``_fused_first_tokens``). Seals each prompt's complete blocks into
        the prefix cache."""
        cfg = self.config
        groups: dict[int, list[dict]] = {}
        for p in preps:
            groups.setdefault(cfg.bucket_for(p["tail"]), []).append(p)
        pack = max(1, cfg.prefill_pack_size)
        records: list[_Admitted] = []
        for bucket, group in sorted(groups.items()):
            for i in range(0, len(group), pack):
                chunk = group[i: i + pack]
                try:
                    logits = self._prefill_dispatch(bucket, chunk)
                except Exception as e:  # noqa: BLE001
                    log.exception("prefill failed (%d prompts)", len(chunk))
                    for p in chunk:
                        self.allocator.release(p["sp"].pages)
                        p["sp"].pages = []
                        self._refund_if_charged(p["waiting"])
                        self._error(p["waiting"], f"prefill failed: {e}")
                    continue
                pres = self._fused_first_tokens(logits, [p["waiting"] for p in chunk])
                for j, p in enumerate(chunk):
                    self._seal_prompt_blocks(p["sp"], p["seq"])
                    records.append(_Admitted(
                        p["slot_idx"], p["waiting"], p["seq"], p["sp"],
                        p["token_ids"], p["max_tokens"], logits[j],
                        pres[j] if pres else None))
        return records

    def _prefill_dispatch(self, bucket: int, group: list[dict]) -> torch.Tensor:
        """One prefill forward for ``group``; returns last-position logits
        [len(group), V] on the device. A packed group of a MoE spec pads to
        ``prefill_pack_size`` rows of token 0 (no tokens: they write the
        trash page), as the reference's packed prefill does: the experts
        route the same N*T rows, so capacity and drops are the
        reference's."""
        cfg = self.config
        nb = len(group)
        if nb > 1 and self.spec.num_experts:
            nb = max(nb, cfg.prefill_pack_size)
        tokens = np.zeros((nb, bucket), np.int32)
        bts = np.zeros((nb, cfg.max_pages_per_seq), np.int32)
        starts = np.zeros((nb,), np.int64)
        nts = np.zeros((nb,), np.int64)
        for i, p in enumerate(group):
            tail = p["token_ids"][p["start_pos"]:]
            tokens[i, : len(tail)] = tail
            bts[i, : p["sp"].num_pages] = p["sp"].pages
            starts[i] = p["start_pos"]
            nts[i] = p["tail"]
        dev = self.device
        tok_d = torch.from_numpy(tokens).to(dev)
        bts_d = torch.from_numpy(bts).to(dev)
        if nb == 1:
            logits, dropped = self.fam.prefill(
                self.spec, self.params, tok_d[0], bts_d[0], int(starts[0]),
                self.k_pages, self.v_pages, int(nts[0]),
            )
            logits = logits[None]
        else:
            logits, dropped = self.fam.prefill_batch(
                self.spec, self.params, tok_d, bts_d, torch.from_numpy(starts),
                self.k_pages, self.v_pages, torch.from_numpy(nts),
            )
        self._note_moe_dropped(dropped)
        return logits[: len(group)]

    def _seal_prompt_blocks(self, sp: SeqPages, seq: TokenBlockSequence) -> None:
        """Seal the prompt's complete, newly computed blocks into the
        prefix cache."""
        for i in range(sp.cached_prefix_pages, len(seq.blocks)):
            blk = seq.blocks[i]
            self.allocator.seal_page(
                sp.pages[i], blk.sequence_hash, blk.parent_sequence_hash
            )
            sp.hashes[i] = blk.sequence_hash

    def _sampling_params(self, req: dict) -> tuple[float, int, float, int]:
        """(temperature, top_k, top_p, seed) for a request, allocating the
        per-request seed. The first-token sample fused onto the prefill
        fixes the seed before the slot exists; _make_slot takes it then."""
        sampling = req.get("sampling") or {}
        self._seed_counter += 1
        return (
            float(self._opt(sampling, "temperature", 0.0)),
            int(self._opt(sampling, "top_k", 0)),
            float(self._opt(sampling, "top_p", 1.0)),
            int(self._opt(sampling, "seed", self._seed_counter)) & 0xFFFFFFFF,
        )

    def _make_slot(
        self, waiting: _Waiting, seq: TokenBlockSequence, sp: SeqPages, *,
        seq_len: int, remaining: int, generated: int = 0, last_token: int,
        sample_seed: int | None = None,
    ) -> _Slot:
        req = waiting.request
        sampling = req.get("sampling") or {}
        stop = req.get("stop_conditions") or {}
        if sample_seed is None:
            self._seed_counter += 1
            sample_seed = (int(self._opt(sampling, "seed", self._seed_counter))
                           & 0xFFFFFFFF)
        temperature = float(self._opt(sampling, "temperature", 0.0))
        logprobs = self._clamp_logprobs(
            (req.get("output_options") or {}).get("logprobs"))
        # speculation is greedy-only (accept-longest-prefix against the
        # target's argmax is exact at temperature 0) and logprob-free (the
        # verify returns token ids)
        slot_spec = None
        if self._spec_on and temperature <= 0.0 and logprobs is None:
            slot_spec = SlotSpec.for_config(self.config)
        guided_state = None
        g = req.get("guided")
        if g and self._guided is not None:
            # the slot's grammar cursor (a cache hit: generate() compiled
            # it). End-of-stream and stop ids join the mask at accepting
            # states only. Tokens past prompt_len are completions a
            # migration folded into the prompt: the cursor walks them, so a
            # resumed stream continues mid-grammar
            token_ids = req.get("token_ids") or []
            guided_state = self._guided.state_for(
                g,
                eos_ids=(frozenset(req.get("eos_token_ids") or (2,))
                         | frozenset(stop.get("stop_token_ids") or ())),
                prefix_tokens=token_ids[int(g.get("prompt_len") or len(token_ids)):],
            )
        self._admit_seq += 1
        return _Slot(
            request_id=waiting.context.id,
            context=waiting.context,
            out_q=waiting.out_q,
            seq=seq,
            pages=sp,
            seq_len=seq_len,
            remaining=remaining,
            temperature=temperature,
            top_k=int(self._opt(sampling, "top_k", 0)),
            top_p=float(self._opt(sampling, "top_p", 1.0)),
            ignore_eos=bool(stop.get("ignore_eos", False)),
            stop_token_ids=frozenset(stop.get("stop_token_ids") or ()),
            eos_ids=frozenset(req.get("eos_token_ids") or (2,)),
            min_tokens=int(self._opt(stop, "min_tokens", 0)),
            generated=generated,
            last_token=last_token,
            sample_seed=sample_seed,
            logprobs=logprobs,
            spec=slot_spec,
            tenant=waiting.tenant,
            priority=waiting.priority,
            request=req,
            admitted_seq=self._admit_seq,
            guided=guided_state,
        )

    @staticmethod
    def _sample(logits: torch.Tensor, temps, topk, topp, seeds,
                allowed: np.ndarray | None = None) -> torch.Tensor:
        """First tokens [n] on the device (RNG step 0): the argmax for an
        all-greedy batch, the full sampler otherwise (decided on the host
        from its own arrays). ``allowed`` [n, V] masks the logits first
        (``sample_tokens_masked``)."""
        if allowed is not None:
            logits = mask_logits(logits, torch.from_numpy(allowed))
        if not any(t > 0.0 for t in temps):
            return greedy_tokens(logits)
        n = logits.shape[0]
        return sample_tokens(
            logits, torch.tensor(temps, dtype=torch.float32),
            torch.tensor(topk, dtype=torch.int32),
            torch.tensor(topp, dtype=torch.float32),
            torch.tensor(seeds, dtype=torch.int64),
            torch.zeros(n, dtype=torch.int64),
        )

    def _sample_slots(self, logits: torch.Tensor, slots: list[_Slot],
                      allowed: np.ndarray | None = None) -> torch.Tensor:
        return self._sample(logits, [s.temperature for s in slots],
                            [s.top_k for s in slots], [s.top_p for s in slots],
                            [s.sample_seed for s in slots], allowed)

    def _needs_sync_admission(self, req: dict) -> bool:
        """True when the admission must read its first token and logits on
        the host at once: logprob entries, and guided requests (the first
        token must respect the grammar's start state, and the cursor must
        advance on its host value before the next mask is built, which the
        async path's deferred landing breaks)."""
        if req.get("guided"):
            return True
        return ((req.get("output_options") or {}).get("logprobs") is not None
                and self.fam.supports_logprobs)

    def _fused_first_tokens(
        self, logits: torch.Tensor, waitings: list[_Waiting]
    ) -> list[tuple] | None:
        """Sample a prefill dispatch's first tokens straight off its
        [nb, V] logits, with no host copy. Returns per-row ``(samples, row,
        seed)`` for the async admission path, or None when these records
        take the synchronous path."""
        if (not self.config.async_admissions
                or any(self._needs_sync_admission(w.request) for w in waitings)):
            return None
        params = [self._sampling_params(w.request) for w in waitings]
        samples = self._sample(logits, *zip(*params))
        return [(samples, i, params[i][3]) for i in range(len(waitings))]

    def _complete_admissions(self, records: list[_Admitted]) -> None:
        """First tokens of the admitted prompts. Async path (default): the
        samples stay on the device and feed the next burst there
        (_complete_admissions_async). Synchronous path (async admissions
        off, or a request wants logprobs): one batched sample, read on the
        host, emitted now."""
        if not records:
            return
        if self.config.async_admissions and not any(
                self._needs_sync_admission(r.waiting.request) for r in records):
            self._complete_admissions_async(records)
            return
        try:
            # a mixed round can carry presampled records onto this path;
            # their seed was allocated with the sample, so reuse it
            slots = [self._make_slot(
                r.waiting, r.seq, r.sp, seq_len=len(r.token_ids),
                remaining=r.max_tokens, last_token=r.token_ids[-1],
                sample_seed=r.pre[2] if r.pre is not None else None)
                for r in records]
            stacked = torch.stack([r.logits for r in records])
            sampled = self._sample_slots(
                stacked, slots, self._admission_guided_mask(slots))
            lp = top_i = top_v = None
            if any(s.logprobs is not None for s in slots):
                picked, ti, tv = token_logprobs(stacked, sampled, self._n_lp)
                lp, top_i, top_v = (x.cpu().numpy() for x in (picked, ti, tv))
            toks = sampled.cpu().numpy()
        except Exception as e:  # noqa: BLE001
            log.exception("first-token sampling failed")
            for r in records:
                self.allocator.release(r.sp.pages)
                r.sp.pages = []
                self._error(r.waiting, f"prefill failed: {e}")
            return
        for i, (r, slot) in enumerate(zip(records, slots)):
            tok = int(toks[i])
            entry = None
            if slot.logprobs is not None and lp is not None:
                entry = {"id": tok, "logprob": float(lp[i]),
                         "top": [{"id": int(top_i[i, t]),
                                  "logprob": float(top_v[i, t])}
                                 for t in range(slot.logprobs)]}
            self._emit_token(r.slot_idx, slot, tok, logprob_entry=entry)

    def _admission_guided_mask(self, slots: list[_Slot]) -> np.ndarray | None:
        """[n, V] allowed mask for a first-token sample, or None when no
        slot is constrained (the all-free batch samples unmasked). Free
        rows are all-True, the identity under the mask."""
        if not any(s.guided is not None and s.guided.constraining for s in slots):
            return None
        allowed = np.ones((len(slots), self.spec.vocab_size), bool)
        for i, slot in enumerate(slots):
            if slot.guided is not None and slot.guided.constraining:
                allowed[i] = slot.guided.mask()
        return allowed

    def _complete_admissions_async(self, records: list[_Admitted]) -> None:
        """Async admission: slots installed with ``first_pending`` and
        their counters advanced past the first token, whose value is still
        on the device. The round's samples join one wave with one copy to
        the host started now. The next burst feeds the new slots' tokens
        from the device samples (_dispatch_burst); host values land from
        that burst's download or from the wave's own copy
        (_materialize_waves). Records without a fused sample (a chunked
        prefill's completion) are sampled here in one batch."""
        recs: list[tuple[int, _Slot]] = []
        parts: dict[int, tuple[torch.Tensor, list]] = {}
        unsampled: list[tuple[int, _Slot, torch.Tensor]] = []
        try:
            for r in records:
                slot = self._make_slot(
                    r.waiting, r.seq, r.sp, seq_len=len(r.token_ids),
                    remaining=r.max_tokens - 1, generated=1,
                    last_token=r.token_ids[-1],
                    sample_seed=r.pre[2] if r.pre is not None else None)
                slot.first_pending = True
                recs.append((r.slot_idx, slot))
                if r.pre is not None:
                    samples, row, _seed = r.pre
                    parts.setdefault(id(samples), (samples, []))[1].append(
                        (r.slot_idx, slot, row))
                else:
                    unsampled.append((r.slot_idx, slot, r.logits))
            if unsampled:
                samples = self._sample_slots(
                    torch.stack([lg for _, _, lg in unsampled]),
                    [s for _, s, _ in unsampled])
                parts[id(samples)] = (samples, [
                    (si, s, i) for i, (si, s, _lg) in enumerate(unsampled)])
            devs, wave_recs, off = [], [], 0
            for samples, prs in parts.values():
                devs.append(samples)
                wave_recs += [(si, s, off + row) for si, s, row in prs]
                off += samples.shape[0]
            dev = devs[0] if len(devs) == 1 else torch.cat(devs)
            wave = {"dev": dev, "copy": HostCopy(dev), "recs": wave_recs,
                    "fed": set(), "age": 0}
        except Exception as e:  # noqa: BLE001
            log.exception("async admission completion failed")
            for r in records:
                self.allocator.release(r.sp.pages)
                r.sp.pages = []
                self._error(r.waiting, f"prefill failed: {e}")
            return
        for slot_idx, slot in recs:
            self._slots[slot_idx] = slot
        self._admit_waves.append(wave)

    def _materialize_waves(self, force: bool = False) -> bool:
        """Land admission waves whose host copy is in. A wave whose pending
        slots are all covered by an in-flight burst is left to that burst's
        processing, which lands its tokens from the burst's own download;
        an aged wave that no burst covers lands from its own copy.
        ``force`` lands every wave now (a preemption needs exact slots)."""
        did = False
        keep: list[dict] = []
        covered: set[int] = set()
        for pb in self._pipeline:
            covered.update(si for si in pb["batch"]["participants"]
                           if pb["batch"]["active"][si])
        for ap in self._admit_waves:
            ap["age"] += 1
            live = [(si, s, row) for si, s, row in ap["recs"]
                    if self._slots[si] is s and s.first_pending]
            if not live:
                did = True  # every record finished or was cancelled
                continue
            in_burst = all(si in covered for si, _s, _row in live)
            if force or ap["copy"].ready() or (ap["age"] >= 2 and not in_burst):
                self._materialize_one(ap)
                did = True
            else:
                keep.append(ap)
        self._admit_waves = keep
        return did

    def _materialize_one(
        self, ap: dict, *, fed_col: np.ndarray | None = None,
        part: np.ndarray | None = None, participants: dict | None = None,
    ) -> dict | None:
        """Land a wave's first tokens. Direct mode (``fed_col`` None): from
        the wave's own host copy. Burst mode (_process_burst): slots fed
        into the burst being processed take their token from the burst's
        fed column; records not covered stay in a residual wave, returned.
        The ``participants`` request-id check matters: a burst dispatched
        before this slot's admission may have the same index active under
        the previous request, whose chained token is not this wave's."""
        if fed_col is None:
            toks = ap["copy"].wait().numpy()
            for slot_idx, slot, row in ap["recs"]:
                if self._slots[slot_idx] is slot and slot.first_pending:
                    self._land_first_token(slot_idx, slot, int(toks[row]))
            return None
        rest: list[tuple] = []
        for slot_idx, slot, row in ap["recs"]:
            if self._slots[slot_idx] is not slot or not slot.first_pending:
                continue  # finished or cancelled since admission
            if (slot_idx in ap["fed"] and part[slot_idx]
                    and participants.get(slot_idx) == slot.request_id):
                self._land_first_token(slot_idx, slot, int(fed_col[slot_idx]))
            else:
                rest.append((slot_idx, slot, row))
        return {**ap, "recs": rest} if rest else None

    def _land_first_token(self, slot_idx: int, slot: _Slot, tok: int) -> None:
        """Record + stream an async admission's first token (the stop
        rules of _accept_token, counters already advanced)."""
        slot.seq.append(tok)
        slot.last_token = tok
        slot.first_pending = False
        finish = None
        if (not slot.ignore_eos and slot.generated >= slot.min_tokens
                and tok in slot.eos_ids):
            finish = "stop"
        elif tok in slot.stop_token_ids and slot.generated >= slot.min_tokens:
            finish = "stop"
        elif slot.remaining <= 0:
            finish = "length"
        if finish is not None:
            self._finish(slot_idx, slot, finish, emit=False)
        self._post(slot.out_q, {"token_ids": [tok], "finish_reason": finish})

    def _emit_token(self, slot_idx: int, slot: _Slot, tok: int,
                    logprob_entry: dict | None = None) -> None:
        """Record + stream a synchronous admission's first token; place the
        slot or finish."""
        finish = self._accept_token(slot, tok)
        if finish is not None:
            # release BEFORE posting the finish item, so a client seeing
            # the end of its stream sees the pages freed
            self._finish(slot_idx, slot, finish, emit=False)
        else:
            self._slots[slot_idx] = slot
        item: dict[str, Any] = {"token_ids": [tok], "finish_reason": finish}
        if logprob_entry is not None:
            item["logprobs"] = [logprob_entry]
        self._post(slot.out_q, item)

    # -- speculative decoding ----------------------------------------------

    def spec_snapshot(self) -> dict[str, Any]:
        """Speculation counters: verify dispatches, draft outcomes and the
        live acceptance rate."""
        judged = self.spec_accepted + self.spec_rejected
        return {
            "verifies": self.spec_verifies,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "rejected": self.spec_rejected,
            "acceptance_rate": (
                round(self.spec_accepted / judged, 4) if judged else None),
        }

    def guided_snapshot(self) -> dict[str, Any] | None:
        """The grammar compiler's cache counters (compiles, hits, compile
        ms); None when this engine serves no guided request."""
        return self._guided.snapshot() if self._guided is not None else None

    def _verify_fn(self, tokens, block_tables, start_pos, num_tokens, allowed=None):
        """The verify VerifyGraphs captures (bound to the engine's weights
        and pools): (targets, moe_dropped); ``allowed`` [n, W, V] in its
        masked captures."""
        return self.fam.verify(self.spec, self.params, tokens, block_tables,
                               start_pos, self.k_pages, self.v_pages, num_tokens,
                               allowed)

    def _spec_managed(self, slot: _Slot) -> bool:
        """True while the slot takes the verify path INSTEAD of decode
        bursts. first_pending slots stay burst-managed: their first token
        is still on the device, so the drafter has no suffix to match yet
        (and the burst's feed lands it)."""
        return (slot.spec is not None and slot.spec.active
                and not slot.first_pending)

    def _spec_phase(self) -> bool:
        """Draft + one batched verify for every spec-managed slot that no
        in-flight decode burst covers.

        With the pipeline, a slot is either burst-managed or spec-managed
        in a cycle: _build_batch skips spec-managed slots, so their
        in-flight bursts drain within pipeline_depth cycles, after which
        every cycle verifies them. A verified slot's last token is on the
        host, so its next burst (after k decays) stages it from there. A
        slot whose drafter finds nothing still verifies at width 1 (it must
        emit a token this cycle), and the miss decays its k."""
        cfg = self.config
        B = len(self._slots)
        covered = [False] * B
        for pb in self._pipeline:
            for i in range(B):
                if pb["batch"]["active"][i] and self._slot_matches(i, pb["batch"]):
                    covered[i] = True
        cands: list[tuple[int, _Slot, list[int], list | None]] = []
        for i, slot in enumerate(self._slots):
            if slot is None or not self._spec_managed(slot):
                continue
            if slot.context.is_stopped or covered[i]:
                # stopped slots cancel through _build_batch; covered ones
                # verify once their in-flight burst is processed
                continue
            if cfg.max_context - slot.seq_len < 2:
                continue  # no room to write even the fed token safely
            k_cap = min(slot.remaining - 1, cfg.max_context - slot.seq_len - 2,
                        cfg.spec_k_max)
            slot.spec.sync_from_seq(slot.seq)
            draft = [int(t) for t in slot.spec.propose(k_cap)] if k_cap > 0 else []
            masks = None
            if slot.guided is not None and slot.guided.constraining:
                # guided x spec: the draft's grammar-legal prefix, walked on
                # a scratch cursor, with the mask of every verify position;
                # the real cursor advances only over emitted tokens, so a
                # rejected tail needs no rollback
                draft, masks = slot.guided.lookahead(draft)
            cands.append((i, slot, draft, masks))
        if not cands:
            return False

        # page room for the fed token + drafts: OutOfPages trims the draft
        # to the pages held; a slot that cannot hold its fed token stalls
        ready: list[tuple[int, _Slot, list[int], int, list | None]] = []
        for i, slot, draft, masks in cands:
            m = 1 + len(draft)
            base_pages = slot.pages.num_pages
            while (slot.seq_len + m - 1) // cfg.page_size >= slot.pages.num_pages:
                try:
                    slot.pages.pages.append(self.allocator.alloc_page())
                    slot.pages.hashes.append(None)
                except OutOfPages:
                    m = min(m, slot.pages.num_pages * cfg.page_size - slot.seq_len)
                    break
            if m < 1:
                # a long stall hands the slot back to the burst path, whose
                # backpressure owns the give-up decision
                slot.stalled_steps += 1
                if slot.stalled_steps > MAX_SPEC_STALLS:
                    slot.spec.disable()
                continue
            slot.stalled_steps = 0
            ready.append((i, slot, draft[: m - 1], base_pages, masks))
        if not ready:
            return False

        if FAULTS.enabled:
            try:
                # an injected verify failure falls back per slot before any
                # KV write: rollback is allocator bookkeeping only, and the
                # request decodes on untouched state
                FAULTS.fire_sync("engine.spec_verify")
            except (FaultInjected, FaultDrop) as e:
                for _i, slot, _draft, base_pages, _masks in ready:
                    self.allocator.release(slot.pages.truncate(base_pages))
                    slot.spec.disable()
                log.warning("spec verify fault (%s): %d slot(s) fall back to "
                            "non-spec decode", e, len(ready))
                return True

        # ONE packed dispatch: rows pad to a captured power of two, width
        # spec_k_max + 1; padded rows have 0 tokens and write trash page 0
        W = cfg.spec_k_max + 1
        n = next(c for c in self._verify.row_counts if c >= len(ready))
        tokens = np.zeros((n, W), np.int32)
        bts = np.zeros((n, cfg.max_pages_per_seq), np.int32)
        starts = np.zeros((n,), np.int32)
        nts = np.zeros((n,), np.int32)
        allowed = None
        if any(masks is not None for *_r, masks in ready):
            # [n, W, V] guided masks: row r position j constrains the
            # target's choice after draft[:j], so a rejected draft's
            # correction is itself grammar-legal; free and padded rows stay
            # all-True
            allowed = np.ones((n, W, self.spec.vocab_size), bool)
        for r, (_i, slot, draft, _bp, masks) in enumerate(ready):
            row = [slot.last_token, *draft]
            tokens[r, : len(row)] = row
            bts[r, : slot.pages.num_pages] = slot.pages.pages
            starts[r] = slot.seq_len
            nts[r] = len(row)
            if allowed is not None and masks is not None:
                for j in range(min(len(row), len(masks))):
                    allowed[r, j] = masks[j]
        t0 = time.perf_counter()
        targets = self._verify.dispatch(tokens, bts, starts, nts, allowed)
        self._note_moe_dropped(self._verify.dropped)
        targets = targets.wait().numpy()
        self.verify_times.append(time.perf_counter() - t0)
        self.spec_verifies += 1
        self.spec_rows += len(ready)
        for r, (i, slot, draft, _bp, _masks) in enumerate(ready):
            if self._slots[i] is slot:
                self._process_verify(i, slot, draft, targets[r])
        self._publish_metrics()
        return True

    def _process_verify(self, slot_idx: int, slot: _Slot, draft: list[int],
                        targets: np.ndarray) -> None:
        """Greedy accept-longest-prefix over one slot's verify row.
        ``targets[j]`` is the target's argmax after [last_token,
        draft[:j]]: drafts are accepted while they equal it, and
        ``targets[n_acc]`` (the correction, or the bonus token when all
        matched) always emits. Every emitted token goes through
        _accept_token, so a max_tokens / EOS / stop boundary inside the
        verify cuts exactly there."""
        n_acc = 0
        while n_acc < len(draft) and int(targets[n_acc]) == draft[n_acc]:
            n_acc += 1
        drafted = len(draft)
        self.spec_drafted += drafted
        self.spec_accepted += n_acc
        self.spec_rejected += drafted - n_acc
        if drafted:
            SPEC_TOKENS.labels(outcome="accepted").inc(n_acc)
            SPEC_TOKENS.labels(outcome="rejected").inc(drafted - n_acc)
        slot.spec.observe(drafted, n_acc)
        toks: list[int] = []
        finish = None
        for tok in targets[: n_acc + 1]:
            toks.append(int(tok))
            finish = self._accept_token(slot, int(tok))
            if finish is not None:
                break
        # the fed token and the accepted drafts are now cache state (the
        # last emitted token's write belongs to the next dispatch)
        slot.seq_len += len(toks)
        # release pages past the accepted prefix: the rejected tail sits
        # beyond seq_len (masked, overwritten later), its pages must not
        # stay pinned
        keep = (slot.seq_len + self.config.page_size - 1) // self.config.page_size
        released = slot.pages.truncate(max(keep, 1))
        if released:
            self.allocator.release(released)
        self._maybe_seal(slot)
        item: dict[str, Any] = {"token_ids": toks, "finish_reason": finish}
        if finish is not None:
            self._finish(slot_idx, slot, finish, emit=False)
        self._post(slot.out_q, item)

    # -- decode ------------------------------------------------------------

    def _graph_step(self, t, sampled: bool, n_logprobs: int) -> None:
        """The one-step function DecodeGraphs captures (bound to the
        engine's weights and pools)."""
        self.fam.decode_step(self.spec, self.params, self.k_pages, self.v_pages,
                             t, sampled=sampled, n_logprobs=n_logprobs)

    def _decode_step(self) -> bool:
        """One decode dispatch of up to ``decode_steps_per_dispatch`` model
        steps with sampling, then stop rules and streaming. Tokens sampled
        past a mid-burst stop are discarded; their cache writes land in
        pages the finished slot releases.

        ``pipeline_decode`` keeps up to ``pipeline_depth`` bursts in
        flight: each new burst is fed on the device from the in-flight
        bursts' tokens, and only the oldest burst is processed per step, so
        the host's processing overlaps the device's execution. Stops are
        detected up to depth bursts late (discarded, as a mid-burst stop);
        cancels flush the pipeline first (_step).

        While a grammar-constrained slot is live the engine leaves
        pipelining: it flushes the in-flight bursts, then dispatches
        synchronous single masked steps (a pipelined burst would carry a
        mask computed before the in-flight tokens advanced the cursor).
        Free-only batches keep the pipeline.

        Returns False when nothing could be built (every live slot
        page-stalled), so the loop paces on the idle wait."""
        if self.config.pipeline_decode and self._guided_live():
            # flush, then fall through to the synchronous schedule below
            self._flush_pipeline()
        elif self.config.pipeline_decode:
            batch = self._build_batch(self._pipeline)
            if batch is None:
                if self._pipeline:
                    before = sum(s is not None for s in self._slots)
                    self._process_burst(self._pipeline.pop(0))
                    self._eager_readmit(before - sum(s is not None for s in self._slots))
                    return True
                return False
            self._pipeline.append(self._dispatch_burst(batch, chain=self._pipeline))
            if len(self._pipeline) > max(1, self.config.pipeline_depth):
                before = sum(s is not None for s in self._slots)
                self._process_burst(self._pipeline.pop(0))
                # freed slots refill now: their prefill dispatches behind
                # the in-flight burst and their first tokens feed the next
                self._eager_readmit(before - sum(s is not None for s in self._slots))
            return True
        batch = self._build_batch(None)
        if batch is None:
            return False
        before = sum(s is not None for s in self._slots)
        self._process_burst(self._dispatch_burst(batch, chain=None))
        self._eager_readmit(before - sum(s is not None for s in self._slots))
        return True

    def _guided_live(self) -> bool:
        """True while any live slot is grammar-constrained (those cycles run
        the synchronous dispatch-process schedule)."""
        return any(s is not None and s.guided is not None and s.guided.constraining
                   and not s.context.is_stopped for s in self._slots)

    def _flush_pipeline(self) -> None:
        """Process every in-flight burst, so slot state is exact."""
        pending, self._pipeline = self._pipeline, []
        for pb in pending:
            self._process_burst(pb)

    def _slot_matches(self, i: int, batch: dict) -> bool:
        slot = self._slots[i]
        return slot is not None and slot.request_id == batch["participants"].get(i)

    def _build_batch(self, pending: list[dict] | None) -> dict | None:
        """Host arrays for the next burst; finishes cancelled slots and
        extends each active slot's pages to cover the burst. ``pending``
        (pipelined) holds the dispatched-but-unprocessed bursts, oldest
        first: their participants have ``extra`` tokens already scheduled
        on the device, so lengths, pages and RNG steps advance past them."""
        cfg = self.config
        B = len(self._slots)
        tokens = np.zeros((B,), np.int32)
        block_tables = np.zeros((B, cfg.max_pages_per_seq), np.int32)
        seq_lens = np.ones((B,), np.int32)
        active = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        topk = np.zeros((B,), np.int32)
        topp = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.uint32)
        steps = np.zeros((B,), np.int32)

        extra = np.zeros((B,), np.int32)
        for p in pending or ():
            pb = p["batch"]
            for i in range(B):
                if pb["active"][i] and self._slot_matches(i, pb):
                    extra[i] += pb["n_burst"]

        n_burst = cfg.decode_steps_per_dispatch
        n_active = sum(s is not None for s in self._slots)
        if (cfg.decode_steps_admit_pending and not self._waiting.empty()
                and n_active * 2 < len(self._slots)):
            # ramp-up: short bursts get the next admission wave in sooner
            n_burst = max(1, min(n_burst, cfg.decode_steps_admit_pending))
        for i, slot in enumerate(self._slots):
            if (slot is not None and not slot.context.is_stopped
                    and not self._spec_managed(slot)):
                # an overshooting position would index past the table
                n_burst = max(1, min(n_burst, cfg.max_context - slot.seq_len
                                     - int(extra[i])))
                if slot.guided is not None and slot.guided.constraining:
                    # a constrained slot's mask holds for one token (the
                    # cursor advances as tokens land): the whole batch runs
                    # single steps, free slots in the same dispatch
                    n_burst = 1

        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.context.is_stopped:
                if not pending:
                    self._finish(i, slot, "cancelled")
                # pipelined: _step flushes before cancels; the next step
                # finishes the slot
                continue
            if self._spec_managed(slot):
                # its tokens come from the verify path (_spec_phase)
                continue
            if slot.remaining <= extra[i]:
                continue  # the in-flight bursts already cover its budget
            # pages for every token this burst will EMIT (overshoot beyond
            # ``remaining`` lands on the trash page via the zero table tail)
            sched_len = slot.seq_len + int(extra[i])
            need = min(slot.remaining - int(extra[i]), n_burst)
            last_page = (sched_len + need - 1) // cfg.page_size
            stalled = False
            while last_page >= slot.pages.num_pages:
                try:
                    slot.pages.pages.append(self.allocator.alloc_page())
                    slot.pages.hashes.append(None)
                except OutOfPages:
                    # backpressure: a neighbour finishing frees pages
                    slot.stalled_steps += 1
                    if slot.stalled_steps > MAX_PAGE_STALLS:
                        self._finish(i, slot, "error", error=(
                            "kv pages exhausted (decode stalled "
                            f"{slot.stalled_steps} steps)"))
                    stalled = True
                    break
            if stalled:
                continue
            slot.stalled_steps = 0
            active[i] = True
            tokens[i] = slot.last_token  # replaced on the device when fed
            block_tables[i, : slot.pages.num_pages] = slot.pages.pages
            seq_lens[i] = sched_len + 1  # including the new token
            temps[i] = slot.temperature
            topk[i] = slot.top_k
            topp[i] = slot.top_p
            seeds[i] = slot.sample_seed
            steps[i] = slot.generated + int(extra[i])
        if not active.any():
            return None
        # one logprob width whenever any slot asks: a graph variant, as
        # n_logprobs is a static argument of the JAX engine's program
        wants_lp = any(s is not None and s.logprobs is not None for s in self._slots)
        # the burst's guided mask: None unless an active slot is constrained
        # (an all-free batch runs the unmasked graph)
        allowed = None
        if any(active[i] and self._slots[i].guided is not None
               and self._slots[i].guided.constraining for i in range(B)):
            allowed = np.ones((B, self.spec.vocab_size), bool)
            for i in range(B):
                slot = self._slots[i]
                if active[i] and slot.guided is not None and slot.guided.constraining:
                    allowed[i] = slot.guided.mask()
        return {
            "n_burst": n_burst, "n_lp": self._n_lp if wants_lp else 0,
            "allowed": allowed,
            "active": active,
            "participants": {i: self._slots[i].request_id
                             for i in range(B) if active[i]},
            "inputs": {"tokens": tokens, "block_tables": block_tables,
                       "seq_lens": seq_lens, "active": active,
                       "temperature": temps, "top_k": topk, "top_p": topp,
                       "seeds": seeds, "steps": steps},
        }

    def _dispatch_burst(self, batch: dict, chain: list[dict] | None) -> dict:
        """Issue the burst; feed tokens on the device from the in-flight
        bursts (``chain``, oldest first, newer overriding older) and from
        admission waves' first-token samples. Chain feeds are guarded by
        request identity: a slot freed and reused by a new request must not
        take the dead request's in-flight token."""
        B = len(self._slots)
        feeds: list[torch.Tensor] = []
        feed_src = np.full((B,), -1, np.int32)
        feed_idx = np.zeros((B,), np.int32)
        for prev in chain or ():
            valid = np.fromiter(
                (prev["batch"]["active"][i] and self._slot_matches(i, prev["batch"])
                 for i in range(B)), dtype=bool, count=B)
            if valid.any():
                feed_src[valid] = len(feeds)
                feed_idx[valid] = np.arange(B, dtype=np.int32)[valid]
                feeds.append(prev["burst"].last_tokens())
        for ap in self._admit_waves:
            # freshly admitted slots: their first token from the wave's
            # device sample, fed into each slot's FIRST burst only (later
            # bursts chain from newer device tokens)
            fed_any = False
            for slot_idx, slot, row in ap["recs"]:
                if (self._slots[slot_idx] is slot and slot.first_pending
                        and batch["active"][slot_idx] and slot_idx not in ap["fed"]):
                    feed_src[slot_idx] = len(feeds)
                    feed_idx[slot_idx] = row
                    ap["fed"].add(slot_idx)
                    fed_any = True
            if fed_any:
                feeds.append(ap["dev"])
        inputs = batch["inputs"]
        sampled = bool((inputs["temperature"][batch["active"]] > 0).any())
        t0 = time.perf_counter()
        burst = self._graphs.dispatch(
            inputs, batch["n_burst"], sampled=sampled, n_logprobs=batch["n_lp"],
            feeds=feeds, feed_src=feed_src, feed_idx=feed_idx,
            allowed=batch["allowed"])
        self.steps += batch["n_burst"]
        return {"batch": batch, "burst": burst, "t0": t0}

    def _process_burst(self, pending: dict) -> None:
        """Take a dispatched burst's tokens to the host; land the first
        tokens its fed column carries; apply stop rules, seal pages, stream
        items (with logprob entries when asked), finish slots. Participant
        request ids guard against a slot finished and reused since the
        dispatch."""
        batch = pending["batch"]
        fed_col, sampled, lp, top_i, top_v = pending["burst"].result()
        self.decode_step_times.append(time.perf_counter() - pending["t0"])
        n_burst = batch["n_burst"]
        active = batch["active"]
        if self._admit_waves:
            # first tokens of slots fed into this burst land from its
            # download before its own tokens (sequence order holds)
            keep = []
            for ap in self._admit_waves:
                if any(self._slots[si] is s and s.first_pending and active[si]
                       for si, s, _row in ap["recs"]):
                    rest = self._materialize_one(
                        ap, fed_col=fed_col, part=active,
                        participants=batch["participants"])
                    if rest is not None:
                        keep.append(rest)
                else:
                    keep.append(ap)
            self._admit_waves = keep
        # phase 1: per-slot emit counts, cache state, seals; before any
        # finish releases pages
        burst: dict[int, tuple[list[int], str | None]] = {}
        for i, slot in enumerate(self._slots):
            if slot is None or not active[i] or not self._slot_matches(i, batch):
                continue
            toks: list[int] = []
            finish = None
            for tok in sampled[i, :n_burst]:
                toks.append(int(tok))
                finish = self._accept_token(slot, int(tok))
                if finish is not None:
                    break
            burst[i] = (toks, finish)
            slot.seq_len += len(toks)  # the fed tokens are now in the cache
            if slot.spec is not None:
                # a parked spec slot (k 0) counts down to its next reprobe
                slot.spec.on_tokens(len(toks))
            self._maybe_seal(slot)
        # phase 2: stream tokens, finish slots
        for i, (toks, finish) in burst.items():
            slot = self._slots[i]
            item: dict[str, Any] = {"token_ids": toks, "finish_reason": finish}
            if slot.logprobs is not None and lp is not None:
                item["logprobs"] = [
                    {"id": int(sampled[i, j]), "logprob": float(lp[i, j]),
                     "top": [{"id": int(top_i[i, j, t]),
                              "logprob": float(top_v[i, j, t])}
                             for t in range(slot.logprobs)]}
                    for j in range(len(toks))
                ]
            if finish is not None:
                self._finish(i, slot, finish, emit=False)
            self._post(slot.out_q, item)
        if self.steps % 16 < n_burst:
            self._publish_metrics()

    def _accept_token(self, slot: _Slot, tok: int) -> str | None:
        """Record one sampled token on the slot; return its finish reason
        (None = keep decoding). The single source of stop semantics for the
        prefill first token and decode bursts."""
        slot.seq.append(tok)
        slot.generated += 1
        slot.remaining -= 1
        slot.last_token = tok
        if slot.guided is not None and not slot.guided.advance(tok):
            # every path a constrained slot samples on is masked, so an
            # off-grammar token marks an unmasked escape: the slot decodes
            # free from here and counts as a violation at its finish
            log.warning("guided slot %s emitted off-grammar token %d; "
                        "constraint released", slot.request_id, tok)
        # a completed grammar leaves only its end ids legal (eos and stop
        # ids join its cursor): min_tokens must not pad past it
        done = (slot.guided is not None and slot.guided.done
                and not slot.guided.violated)
        if (not slot.ignore_eos and tok in slot.eos_ids
                and (slot.generated >= slot.min_tokens or done)):
            return "stop"
        if tok in slot.stop_token_ids and (slot.generated >= slot.min_tokens or done):
            return "stop"
        if slot.remaining <= 0:
            return "length"
        return None

    def _maybe_seal(self, slot: _Slot) -> None:
        """Seal pages whose block just completed into the prefix cache."""
        n_complete = slot.seq_len // self.config.page_size
        for i in range(n_complete):
            if (i < len(slot.pages.hashes) and slot.pages.hashes[i] is None
                    and i < len(slot.seq.blocks)):
                blk = slot.seq.blocks[i]
                self.allocator.seal_page(
                    slot.pages.pages[i], blk.sequence_hash,
                    blk.parent_sequence_hash,
                )
                slot.pages.hashes[i] = blk.sequence_hash

    def _finish(
        self, slot_idx: int, slot: _Slot, reason: str,
        *, error: str | None = None, emit: bool = True,
    ) -> None:
        if slot.guided is not None:
            # ok only when the grammar reached acceptance: max_tokens or a
            # stop sequence cutting it mid-grammar is truncated (the client
            # got a prefix, not a document); a cancel or an error is aborted
            if slot.guided.violated:
                outcome = "violation"
            elif reason in ("stop", "length"):
                outcome = "ok" if slot.guided.conformant else "truncated"
            else:
                outcome = "aborted"
            GUIDED_REQUESTS.labels(outcome=outcome).inc()
        # release BEFORE posting the finish item, so a client seeing the
        # end of its stream sees the pages freed
        pages, slot.pages.pages = slot.pages.pages, []
        self.allocator.release(pages)
        self._slots[slot_idx] = None
        self._publish_metrics()
        if emit:
            item: dict[str, Any] = {"token_ids": [], "finish_reason": reason}
            if error:
                item["error"] = error
            self._post(slot.out_q, item)
