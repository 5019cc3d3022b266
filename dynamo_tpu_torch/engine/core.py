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
prompt + generated with its seed pinned and resumes through the prefix
cache; with KVBM its sealed blocks are force-offloaded to the host tier
first (the depth filter bypassed), so the resume onboards them even after
G1 evicted them. Tenant and priority come from
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

KVBM (kvbm/, ``kvbm=`` a KvBlockManager): every sealed block is queued for
write-through offload and drained in one batch per step, before any queued
page can be released (``_drain_offload``: a gather on the compute stream,
the device-to-host copy on a copy stream, the offers on the offload
thread). At admission, blocks beyond the G1 prefix hit that live in
G2/G3/G4 are onboarded into fresh pages in place (``onboard_from_tiers``)
and sealed without re-offload; on an fp8 engine each onboarded block is
validated first (``_validate_quant_blocks``, the ``engine.quant`` fault
site), a bad one a miss.

Disaggregated serving (disagg/, ``transfer_source=`` a KvTransferSource on
a prefill worker): a request carrying ``disagg.kv_transfer.do_remote_decode``
takes the synchronous admission, and its first token is emitted with the
prompt's pages exported (``_export_and_finish``: one gather on the compute
stream; the transfer plane copies and stamps later, off the step thread)
and released. On a decode worker a request with ``disagg.mode == "decode"``
has its blocks pulled at intake, off the step thread (host blocks go up to
the card there too, on a copy stream, behind an event), and is admitted by
``_resume_from_remote``: the pages beyond any G1 or KVBM prefix are
installed in place, sealed, and the slot enters decode after the remote
first token. A failed pull (``disagg.pull`` fault site) falls back to a
full local prefill of prompt + first token with the budget cut by one
(``disagg_fallbacks``); a bounced, shed or cancelled resume releases its
export. A multimodal resume seals its blocks under the image salt.

Multimodal and embeddings: a request whose ``multimodal`` carries the encode
worker's rows (``embeds_b64``) and the placeholder ``positions`` has them
decoded and validated once in ``generate()``, off the step thread, and is
prefilled in ONE dispatch of its own (no packing, no chunking: a prompt past
``_prefill_chunk_max()`` errors), the rows overwriting the placeholder
embeddings (padded to a power-of-two row count, at least 8; rows under a
cached prefix skipped), and its prompt blocks are hashed under the image
salt (the embedding digest), so the same prompt with the same image rehits
the cache and another image misses. An ``embedding_request`` is answered off
the step thread by one pooled forward at its bucketed pad (``_embed``).

Observability (runtime/flight.py, runtime/tracing.py, engine/telemetry.py):
``generate()`` opens the request's flight-recorder timeline, bound to the
caller's trace, and the step thread records its events (``admit``,
``prefill_chunk``, ``first_token``, ``spec_verify``, ``disagg_resume``,
``shed``, ``preempt``, ``fault``); at finish the timeline becomes the
``worker.request`` span and its ``engine.*`` children. The step profiler
(``EngineConfig.profile`` or ``DYNAMO_ENGINE_PROFILE=1``) accumulates wall
seconds and calls per catalogued phase of the step thread
(``profile_snapshot``); dispatch accounting (``dispatches``) and the CUDA
graph captures since the engine was built (``dispatch.compile``, the
counterpart of the reference's XLA compile events) are always on. The step
thread feeds ``step_times`` and ``burst_fills``, which the worker's
``EngineCollector`` drains onto /metrics. Fault sites: ``engine.step`` (a
work cycle; an error fails the in-flight requests and the engine keeps
serving), ``engine.admit`` (intake; a drop is a retryable refusal),
``engine.compile`` (per precompiled variant), ``engine.spec_verify``,
``engine.preempt``, ``engine.quant``, ``disagg.pull``, and the
``migration.resume`` and ``kvbm.onboard`` corrupt sites.

Meshes (parallel/): the weights and KV heads shard over tp (experts over
ep x tp) and replicate over sp and dp; every rank but the leader replays
the leader's dispatches (parallel/spmd.py). Under sp > 1 a cold prompt
that fits the largest bucket, with a bucket that divides by sp, takes a
ring prefill of its own (``_ring_dispatch``; the reference's conditions);
a cached prefix, a multimodal prompt or a bucket that does not divide
takes the packed path. The engine stages no layers: ``pp`` > 1 is refused
(parallel/pipeline.py is the pp path).

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
import contextlib
import logging
import os
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
from dynamo_tpu_torch.kvbm.offload import HostBatch, OffloadEngine, block_numpy, block_tensor
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.models.convert import check_shardable
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
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.faults import FAULTS, FaultDrop, FaultInjected
from dynamo_tpu_torch.runtime.flight import FLIGHT, emit_request_spans
from dynamo_tpu_torch.runtime.integrity import verify_resume_tokens
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.engine")

MAX_PAGE_STALLS = 2000  # admission passes / decode steps a request may wait for pages
MAX_SPEC_STALLS = 200  # verify cycles a spec slot may wait for its fed token's page


class TierMiss(LookupError):
    """An SPMD follower's tiers lack blocks the leader onboarded."""

    def __init__(self, hashes: list[int]):
        super().__init__(f"{len(hashes)} onboarded blocks not in this rank's tiers")
        self.hashes = hashes


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
    # step profiler (perf_counter): the dequeue, and the end of the prefill
    # dispatch; 0 when profiling is off or the span was recorded
    admit_t: float = 0.0
    prefill_done_t: float = 0.0


@dataclass
class _Waiting:
    request: dict[str, Any]
    context: Context
    out_q: asyncio.Queue
    # perf_counter at enqueue and at the step thread's dequeue: the step
    # profiler's readmit.admit_wait span
    enq_t: float = 0.0
    admit_t: float = 0.0
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
    # the decoded multimodal payload (``_decode_multimodal``), made once in
    # generate(): a page-stall requeue does not decode it again
    mm: dict[str, Any] | None = None


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


def _transfer_params(disagg: dict) -> dict:
    """A decode request's kv_transfer_params without the handler's
    ``first_token`` (what the transfer plane's calls take)."""
    return {k: v for k, v in disagg["kv_transfer"].items() if k != "first_token"}


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
        transfer_source=None,
        kvbm=None,
        guided_vocab=None,
        mesh=None,
        spmd=None,
    ):
        self.spec = spec
        # disagg (disagg/transfer.py): a prefill worker's export table
        self.transfer_source = transfer_source
        self.disagg_fallbacks = 0  # failed KV pulls served by a local prefill
        # per export: (timing events around the gather or None, host ms of
        # the step thread's gather + export, bytes); per resume: host ms of
        # the step thread's whole resume, pages installed, and that time
        # split by piece ({"acquire", "install", "seal", "drain", "slot"})
        self.export_times: collections.deque = collections.deque(maxlen=4096)
        self.resume_times: collections.deque = collections.deque(maxlen=4096)
        self.resumes = 0  # resumes installed (stamps each dispatched burst)
        # KVBM tiers (kvbm/manager.KvBlockManager): write-through offload
        # of sealed blocks, onboard at admission
        self.kvbm = kvbm
        self.offload = None
        if kvbm is not None:
            self.offload = OffloadEngine(kvbm).start()
        # (sequence_hash, page, block_index) sealed since the last drain
        self._pending_offload: list[tuple[int, int, int]] = []
        self._copy_stream = None  # the offload's device-to-host stream (CUDA)
        # (request id, first block, blocks) per admission that onboarded
        self.onboards: collections.deque = collections.deque(maxlen=4096)
        self.config = config or EngineConfig()
        cfg = self.config
        if self._prefill_chunk_max() % cfg.page_size:
            raise ValueError(
                f"prefill chunk of {self._prefill_chunk_max()} tokens is not a "
                f"multiple of page_size {cfg.page_size}: chunks must start on "
                "page boundaries")
        self.device = resolve_device(device)
        # pulled host blocks go up to the card on this stream (disagg)
        self._h2d_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        # a follower's shards of sharded exports, pulled at the leader's
        # intake (op kv_prefetch): futures by transfer id
        self._prefetched: dict[str, Any] = {}
        self._prefetch_pool = None
        self.prefetch_wait_secs = 0.0  # a resume's wait for its prefetch
        self.fam = get_family(spec)
        # tensor and expert parallelism (parallel/): this rank's mesh, its
        # shard of the weights (heads and FFN columns over tp, experts over
        # ep x tp) and of the KV heads; the collectives run in the forwards
        self.mesh = mesh
        self._check_mesh(mesh, transfer_source)
        if params is None:
            params = self.fam.init_params(spec, cfg.seed, device=self.device, mesh=mesh)
        elif mesh is not None and getattr(params, "mesh", None) is None:
            params = self.fam.shard_params(spec, params, mesh)
        self.params = params
        # SPMD replay (parallel/spmd.py): the leader publishes a descriptor
        # before each device dispatch and the followers replay it. As in the
        # reference, admissions take the synchronous first-token path under
        # it (their first tokens reach the followers in the next burst's
        # host token array) and guided decoding is off (its masks are not
        # in the replay protocol)
        self.spmd = spmd
        self._burst_id = 0  # decode bursts dispatched (descriptor ids)
        self._digest_reqs: list = []  # kv_digest() calls for the step thread
        # embedding requests under SPMD: (token ids, future), run by the step
        # thread in descriptor order (op ``embed``)
        self._embed_reqs: list = []
        self._async_admissions = cfg.async_admissions and spmd is None
        # +1 page: index 0 is the trash page. kv_dtype "fp8" makes both
        # pools QuantPools (ops/quant.py): e4m3 values + bf16 scales
        self.kv_dtype = cfg.kv_dtype
        self.k_pages, self.v_pages = self.fam.init_cache(
            spec, cfg.num_pages + 1, cfg.page_size,
            device=self.device, kv_dtype=self.kv_dtype,
            tp=mesh.tp if mesh is not None else 1,
        )
        # device bytes of this rank's pools (values and, for fp8, scales):
        # its KV heads under tp; MLA's latent pool whole on every rank
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
        if spmd is not None:
            # a rejoining mirror follower waits for a step boundary: wake an
            # idle step loop the moment one asks
            spmd.on_sync_request = self._wake.set
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
        if guided_vocab is not None and cfg.guided_mode != "off" and spmd is None:
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
            capture=cfg.cuda_graphs,
        )
        # speculative decoding (engine/spec.py): the verify grid, one
        # captured graph per power-of-two row count at width k_max + 1
        self._spec_on = (cfg.spec_mode == "ngram"
                         and getattr(self.fam, "supports_spec_decode", False))
        self._verify = VerifyGraphs(
            self._verify_fn, batch=len(self._slots), width=cfg.spec_k_max + 1,
            pages_per_seq=cfg.max_pages_per_seq, device=self.device,
            vocab_size=mask_width, capture=cfg.cuda_graphs,
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
        self.prefill_forwards = 0  # prefill dispatches (packed groups and chunks)
        self.ring_prefills = 0  # of them, sequence-parallel ring prefills
        # wall seconds per decode dispatch, host clock from the dispatch to
        # its sampled tokens on the host; and per dispatch (dispatch time,
        # tokens-on-host time, whether a disagg resume ran on the step
        # thread between the two), on the host's monotonic clock
        self.decode_step_times: collections.deque = collections.deque(maxlen=4096)
        self.decode_spans: collections.deque = collections.deque(maxlen=4096)
        # wall seconds per step-loop cycle that did work (the saturation
        # Retry-After's samples) and tokens landed per processed burst: the
        # step thread appends, the telemetry collector drains
        self.step_times: collections.deque = collections.deque(maxlen=4096)
        self.burst_fills: collections.deque = collections.deque(maxlen=4096)
        self.telemetry = None  # EngineCollector, attached by the worker
        # step-phase profiler (EngineConfig.profile or DYNAMO_ENGINE_PROFILE=1):
        # wall seconds + calls per phase, read by profile_snapshot()
        self._profiling = (cfg.profile
                           or os.environ.get("DYNAMO_ENGINE_PROFILE") == "1")
        self._prof: dict[str, list[float]] = {}
        # dispatch accounting, always on: device programs the step thread
        # issued, and the graph-capture baseline dispatch.compile counts from
        self.dispatches = 0
        self._capture_base = self._capture_totals()
        # rolling wall-clock latency of a step that did work, in ms (0 = not
        # measured yet): published in ForwardPassMetrics as the worker's
        # degradation fingerprint
        self.step_time_ewma_ms = 0.0

    def _check_mesh(self, mesh, transfer_source) -> None:
        """Refuse what the mesh does not cover: a config whose tp or ep is
        not the mesh's, a spec that does not divide over it, and graph
        capture over collectives no graph can capture."""
        cfg = self.config
        for axis in ("tp", "ep", "sp", "dp", "pp"):
            have = mesh.shape[axis] if mesh is not None else 1
            if getattr(cfg, axis) != have:
                raise ValueError(
                    f"EngineConfig.{axis}={getattr(cfg, axis)} but the mesh has "
                    f"{axis}={have}: a group needs its mesh (parallel.make_mesh over "
                    "an initialised group)")
        if mesh is None:
            return
        check_shardable(self.spec, mesh)  # heads, FFN widths, experts
        if (self.device.type == "cuda" and cfg.cuda_graphs
                and mesh.distributed and not mesh.capturable):
            raise ValueError(
                f"a {mesh.backend} group's collectives cannot be captured in a "
                "CUDA graph: set EngineConfig(cuda_graphs=False) to run its "
                "steps eagerly")

    async def kv_digest(self) -> dict:
        """sha256 digests of the K and V pools over the pages in use, taken
        by the step thread at a step boundary (no burst in flight). Under
        SPMD each follower takes its own at the same point of the replay
        and prints it (``SPMD_KV_DIGEST``): a mirror's must equal the
        leader's, bit for bit."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._digest_reqs.append(fut)
        self._wake.set()
        return await asyncio.wrap_future(fut)

    def pool_digest(self, page_ids: list[int]) -> dict:
        """sha256 of pages ``page_ids`` of each pool (values, and an fp8
        pool's scales, as extract_pages packs them)."""
        import hashlib

        from dynamo_tpu_torch.kvbm.offload import block_numpy

        out = {"pages": len(page_ids), "tp_rank": self.mesh.tp_rank if self.mesh else 0}
        if not page_ids:
            return {**out, "k": "", "v": ""}
        kb, vb = self.fam.extract_pages(self.k_pages, self.v_pages,
                                        self._page_ids(page_ids))
        for name, b in (("k", kb), ("v", vb)):
            out[name] = hashlib.sha256(block_numpy(b.cpu()).tobytes()).hexdigest()
        return out

    def _serve_digests(self) -> None:
        reqs, self._digest_reqs = self._digest_reqs, []
        try:
            self._flush_pipeline()
            self._materialize_waves(force=True)
            ids = [int(p) for p in self.allocator.used_page_ids()]
            self._publish("kv_digest", None, {"page_ids": np.asarray(ids, np.int32)})
            got = self.pool_digest(ids)
        except Exception as e:  # noqa: BLE001
            for f in reqs:
                f.set_exception(e)
            return
        for f in reqs:
            f.set_result(got)

    def _publish(self, op: str, scalars: dict | None = None,
                 arrays: dict | None = None, side: bool = False) -> None:
        """Publish one step descriptor ahead of a device dispatch (a no-op
        without an SPMD leader); ``side``: one whose replay runs no
        collective, from any thread."""
        if self.spmd is not None:
            self.spmd.publish(op, scalars, arrays, side=side)

    def _spmd_mark(self) -> int:
        """Publish-count watermark that scopes a failure to actual sends
        (the step thread's: side descriptors do not count)."""
        return self.spmd.lockstep_count if self.spmd is not None else 0

    def _spmd_broken(self, reason: str, since: int) -> None:
        """A dispatch failed after its descriptor went out (something was
        published since the ``since`` watermark): the followers replayed
        what the leader abandoned, so lockstep is gone. Latch the plane
        broken (``is_dead``) instead of deadlocking the next collective; a
        failure before any publish is the request's alone."""
        if self.spmd is not None and self.spmd.lockstep_count != since:
            self.spmd.mark_broken(reason)

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
        if (self.spmd is not None and not self.spmd.healthy
                and not self._closed):
            return True  # followers out of lockstep: nothing more can run
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
        if self.offload is not None:
            # a blocking join (it may wait on an in-flight copy): off the loop
            await asyncio.to_thread(self.offload.close)
        if self.transfer_source is not None:
            # its server, its registry entry and every unpulled export
            await self.transfer_source.close()
        if self._prefetch_pool is not None:
            self._prefetched.clear()
            self._prefetch_pool.shutdown(wait=False, cancel_futures=True)
        if self.telemetry is not None:
            await self.telemetry.close()
        if self.spmd is not None:
            # the followers' replay ends at this descriptor
            self.spmd.stop()
            await self.spmd.close()
        # the step thread is gone: flush the last KV events (bounded: a hub
        # that went away first retries its reconnect window), stop publishing
        for pub in (self.events, self.metrics):
            if pub is not None:
                try:
                    await asyncio.wait_for(pub.close(), 2.0)
                except (asyncio.TimeoutError, ConnectionError):
                    log.warning("publisher close: last KV events not flushed")

    def precompile(self) -> dict[str, dict]:
        """Capture every decode graph variant, and with spec on the verify
        grid, now, before traffic (the JAX engine's precompile()); the
        masked variants too when the engine serves guided requests. Call
        before start() or while idle. Returns the reference's report,
        ``{variant: {"secs", "compiles"[, "error"]}}``, where ``compiles``
        counts the variant's graph captures (0 on the CPU, where nothing is
        captured). The ``engine.compile`` fault site fires per variant: on
        an error the variant stays uncaptured, is reported with the error,
        and its first use captures it lazily."""
        report: dict[str, dict] = {}

        def timed(name: str, capture, graphs: str, key: tuple) -> None:
            c0 = self._capture_totals()[0]
            t0 = time.perf_counter()
            try:
                if FAULTS.enabled:
                    FAULTS.fire_sync("engine.compile")
                # a capture's warm-up steps run the collectives: the
                # followers capture the same graph in step
                self._publish("precompile", {"graphs": graphs, "key": list(key)})
                capture()
            except Exception as e:  # noqa: BLE001
                log.warning("precompile %s failed (%s); its first use "
                            "captures it instead", name, e)
                report[name] = {"secs": round(time.perf_counter() - t0, 3),
                                "compiles": self._capture_totals()[0] - c0,
                                "error": str(e)}
                return
            dt = time.perf_counter() - t0
            report[name] = {"secs": round(dt, 3),
                            "compiles": self._capture_totals()[0] - c0}
            log.info("precompile %s: %.0f ms (%d captures)", name, dt * 1e3,
                     report[name]["compiles"])

        B = len(self._slots)
        for key in self._graphs.variants():
            sampled, n_lp, masked = key
            name = (f"decode[{B}x{'sampled' if sampled else 'greedy'}"
                    f"{f',lp{n_lp}' if n_lp else ''}{',masked' if masked else ''}]")
            timed(name, lambda k=key: self._graphs.precompile([k]), "decode", key)
        if self._verify is not None:
            W = self._verify.width
            for key in self._verify.variants():
                n, masked = key
                name = f"verify{'_masked' if masked else ''}[{n}x{W}]"
                timed(name, lambda k=key: self._verify.precompile([k]), "verify", key)
        return report

    # -- step profiler -----------------------------------------------------

    def _capture_totals(self) -> tuple[int, float]:
        """(graph captures, seconds capturing) of the decode and verify
        graphs since they were built: the counterpart of the reference's
        XLA compile events."""
        objs = [g for g in (self._graphs, self._verify) if g is not None]
        return (sum(g.captures for g in objs),
                sum(g.capture_secs for g in objs))

    def _prof_add(self, name: str, dt: float) -> None:
        """Accumulate one timed span into the phase profiler (a no-op
        unless profiling): the re-admission spans ``readmit.admit_wait`` /
        ``readmit.prefill_dispatch`` / ``readmit.first_token``, measured
        across cycles."""
        if not self._profiling:
            return
        rec = self._prof.setdefault(name, [0.0, 0])
        rec[0] += dt
        rec[1] += 1

    @contextlib.contextmanager
    def _phase(self, name: str):
        """Time the enclosed step-thread work as phase ``name`` (a no-op
        unless profiling)."""
        if not self._profiling:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = self._prof.setdefault(name, [0.0, 0])
            rec[0] += time.perf_counter() - t0
            rec[1] += 1

    def profile_snapshot(self) -> dict[str, dict[str, float]]:
        """Per-phase accumulated step-thread wall seconds and calls
        (profiling mode), plus the always-on dispatch accounting:

        - ``dispatch.dispatches``: device programs the step thread issued
          (calls; secs stays 0). One per decode burst (its chained replays
          of the captured one-step graph, or its eager steps on the CPU),
          one per verify replay, and one per eager forward or sample: each
          prefill, packed prefill and prefill chunk, each first-token
          sample and each logprob pass over admission logits.
        - ``dispatch.d2h_wait`` / ``readmit.d2h_wait``: wall seconds the
          step thread spent blocked on a host read of a CUDA tensor (a
          burst's or a verify's records, a first-token copy), outside and
          inside the admission phases.
        - ``dispatch.compile``: CUDA graph captures (and their seconds)
          since the engine was built; nonzero in a steady window after
          precompile() means a variant escaped the warm-up set.
        """
        snap = {
            k: {"secs": round(v[0], 4), "calls": int(v[1])}
            for k, v in sorted(self._prof.items(), key=lambda kv: -kv[1][0])
        }
        snap.setdefault("dispatch.d2h_wait", {"secs": 0.0, "calls": 0})
        snap.setdefault("readmit.d2h_wait", {"secs": 0.0, "calls": 0})
        snap["dispatch.dispatches"] = {"secs": 0.0, "calls": self.dispatches}
        c, secs = self._capture_totals()
        snap["dispatch.compile"] = {
            "secs": round(secs - self._capture_base[1], 4),
            "calls": c - self._capture_base[0],
        }
        return snap

    def reset_profile_window(self) -> None:
        """Zero the profiler and the dispatch accounting, so the next
        profile_snapshot covers only work from here on (drop warm-up and
        capture noise before a measured window)."""
        self._prof.clear()
        self.dispatches = 0
        self._capture_base = self._capture_totals()

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
        if self.spmd is not None and not self.spmd.healthy:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": f"spmd plane broken: {self.spmd.broken_reason}"}
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
        if FAULTS.enabled:
            try:
                await FAULTS.fire("engine.admit")
            except ConnectionError as e:
                # a drop at intake: this worker vanished before taking the
                # request, which stays retryable (migration re-drives it)
                raise ServiceUnavailable(f"injected admit drop: {e}") from e
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
        if request.get("embedding_request"):
            if not self.fam.supports_embeddings:
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"embeddings unsupported for {self.spec.name}"}
                return
            # a standalone forward that touches no KV page: it runs off the
            # step thread, beside the decode bursts; under SPMD replay its
            # collectives must keep the descriptor order, so the step thread
            # runs it (op ``embed``)
            try:
                if self.spmd is not None:
                    emb = await self._embed_on_step_thread(token_ids)
                else:
                    emb = await asyncio.to_thread(self._embed, token_ids)
            except Exception as e:  # noqa: BLE001
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"embedding failed: {e}"}
                return
            yield {"token_ids": [], "embedding": emb, "finish_reason": "stop"}
            return
        if len(token_ids) >= self.config.max_context:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": f"prompt exceeds max context {self.config.max_context}"}
            return
        mm = None
        if request.get("multimodal"):
            # the encoder's rows (an MB-scale base64 payload) decoded and
            # validated once, in a thread of the loop: never on the step
            # thread, where every decode slot would wait on it. A refusal is
            # the item the step thread's prefill would post
            try:
                mm = await asyncio.to_thread(self._decode_multimodal, request)
            except Exception as e:  # noqa: BLE001
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"prefill failed: {e}"}
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
                    with tracing.span("engine.guided_compile", request_id=context.id):
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
        disagg = request.get("disagg") or {}
        if disagg.get("mode") == "decode" and disagg.get("kv_transfer"):
            # stage the remote KV payload HERE (a thread of the loop), before
            # admission: a slow or hung transfer on the step thread would
            # stall decode for every active slot
            from dynamo_tpu_torch.disagg.transfer import release_kv_blocks

            kvp = _transfer_params(disagg)
            if self._decode_budget(request, len(token_ids)) <= 1:
                # the remote first token (emitted by the handler) was the
                # whole budget: no pull, and this engine served nothing
                self._waiting.refund(tenant, cost)
                await asyncio.to_thread(release_kv_blocks, kvp)
                yield {"token_ids": [], "finish_reason": "length"}
                return
            mode = self._resume_mode(kvp)
            if mode == "shard":
                # every other rank of the group pulls its own shard now, in
                # the background, as this rank pulls its own below
                self._publish("kv_prefetch", {"kvp": kvp}, side=True)
            try:
                # one span per staging attempt: the disagg hop joins the
                # request's trace, duration and failure
                with tracing.span("disagg.pull", request_id=context.id):
                    disagg["_staged_kv"] = await asyncio.to_thread(
                        self._stage_pull, kvp, mode)
            except Exception as e:  # noqa: BLE001
                # transfer-plane failure (the prefill worker died between
                # export and pull, a cut link, the disagg.pull fault): a
                # FULL LOCAL prefill of prompt + the emitted first token,
                # the budget cut by one, instead of an error
                log.warning("kv transfer pull failed (%s); falling back to local "
                            "prefill for %s", e, context.id)
                self.disagg_fallbacks += 1
                if mode == "shard":
                    self._publish("kv_unstage", {"transfer_id": kvp["transfer_id"]},
                                  side=True)
                try:
                    # unpin the export (every shard) on a prefill worker
                    # still alive; the TTL is the backstop
                    await asyncio.to_thread(release_kv_blocks, kvp)
                except Exception:  # noqa: BLE001
                    pass
                first = disagg["kv_transfer"].get("first_token")
                request = dict(request)
                request["disagg"] = None
                disagg = {}  # nothing staged or exported is left to release
                if first is not None:
                    token_ids = token_ids + [int(first)]
                    request["token_ids"] = token_ids
                    stop = dict(request.get("stop_conditions") or {})
                    if stop.get("max_tokens") is not None:
                        stop["max_tokens"] = max(int(stop["max_tokens"]) - 1, 1)
                    request["stop_conditions"] = stop
                if len(token_ids) >= self.config.max_context:
                    self._waiting.refund(tenant, cost)
                    yield {"token_ids": [], "finish_reason": "error",
                           "error": f"prompt exceeds max context "
                                    f"{self.config.max_context}"}
                    return
            if self._closed:
                # closed while the pull was parked: no step thread will read
                # the queue
                self._drop_staged_kv(request)
                self._waiting.refund(tenant, cost)
                yield {"token_ids": [], "finish_reason": "error",
                       "error": "engine closed"}
                return
        if max_waiting and self._waiting.qsize() >= max_waiting:
            # re-check at the enqueue (arrivals that passed the early check
            # together must not blow past the bound): shed the lowest-
            # priority, most-over-quota, newest waiting entry in this
            # request's favour when one ranks below it
            victim = self._waiting.shed_victim(priority)
            if victim is None:
                if disagg.get("mode") == "decode" and disagg.get("kv_transfer"):
                    # the bounce must not strand the pulled payload or leave
                    # the prefill worker's export pinned to its TTL
                    from dynamo_tpu_torch.disagg.transfer import release_kv_blocks

                    self._drop_staged_kv(request)
                    try:
                        await asyncio.to_thread(release_kv_blocks,
                                                _transfer_params(disagg))
                    except Exception:  # noqa: BLE001 - the TTL is the backstop
                        pass
                self.admission_rejects["saturated"] += 1
                self._waiting.refund(tenant, cost)
                raise ServiceUnavailable(
                    f"engine saturated ({self._waiting.qsize()} waiting)",
                    retry_after_s=self._saturation_retry_after(),
                )
            self.admission_rejects["shed"] += 1
            # zero service rendered: the victim's charge comes back
            self._refund_if_charged(victim)
            self._release_waiting_disagg(victim)
            FLIGHT.event(victim.context.id, "shed")
            self._post(victim.out_q, {"_shed": self._saturation_retry_after()})
        # the flight-recorder timeline, joined to the caller's trace: the
        # caller's span (bound by the transport, or live in this context
        # for an in-process call) parents this request's worker.request
        # span; the step thread records events, and the spans are derived
        # and emitted at finish (runtime/flight.py)
        caller_tc = tracing.current_trace() or tracing.parse_traceparent(
            context.headers.get(tracing.TRACEPARENT))
        FLIGHT.start(
            context.id,
            trace=caller_tc.child() if caller_tc else tracing.new_trace(),
            parent_span_id=caller_tc.span_id if caller_tc else None,
            model=self.spec.name, prompt_tokens=len(token_ids),
        )
        out_q: asyncio.Queue = asyncio.Queue()
        self._waiting.put_nowait(_Waiting(
            request, context, out_q, enq_t=time.perf_counter(), tenant=tenant,
            priority=priority, cost=cost, charged=True, mm=mm))
        self._wake.set()
        deadline_hit = False
        finish_reason: str | None = None
        finish_error: str | None = None
        n_generated = 0
        try:
            while True:
                # after the deadline every wait is bounded: a stuck step
                # must not turn a deadline into a hang
                remaining = 2.0 if deadline_hit else context.remaining_s()
                try:
                    if remaining is None:
                        item = await out_q.get()
                    else:
                        item = await asyncio.wait_for(out_q.get(), remaining)
                except asyncio.TimeoutError:
                    if deadline_hit:
                        finish_reason = "cancelled"
                        finish_error = "deadline exceeded"
                        yield {"token_ids": [], "finish_reason": "cancelled",
                               "error": "deadline exceeded"}
                        return
                    # deadline passed mid-generation: the step loop
                    # finishes the slot as 'cancelled'
                    deadline_hit = True
                    context.stop_generating()
                    self._wake.set()
                    continue
                if "_shed" in item:
                    # shed from the queue in a higher-priority arrival's
                    # favour: the retryable typed refusal (another worker
                    # may take it)
                    finish_reason = "shed"
                    raise ServiceUnavailable(
                        "shed under overload (outranked while waiting)",
                        retry_after_s=float(item["_shed"]),
                    )
                n_generated += len(item.get("token_ids") or ())
                # recorded BEFORE the yield: a consumer that stops at the
                # finish item never resumes this generator past it
                if item.get("finish_reason") is not None:
                    finish_reason = item["finish_reason"]
                    finish_error = item.get("error")
                yield item
                if finish_reason is not None:
                    return
        finally:
            tl = FLIGHT.finish(
                context.id,
                finish_reason or "abandoned",  # the consumer broke the stream
                error=finish_error, generated=n_generated,
            )
            if tl is not None:
                emit_request_spans(tl)

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
                with self._phase("dispatch.d2h_wait"):
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
            if self.spmd is not None and not self.spmd.healthy:
                # a follower is out of lockstep: the next collective would
                # never complete. Fail loudly; the engine reports itself dead
                self._fail_all(f"spmd plane broken: {self.spmd.broken_reason}")
                return
            try:
                if FAULTS.enabled and (self._partial is not None
                                       or not self._waiting.empty()
                                       or any(s is not None for s in self._slots)):
                    # inside the recovery try, on work cycles only: an error
                    # fails every in-flight request and the engine keeps
                    # serving; a delay is a stalled step. An idle cycle
                    # fires nothing (it would use up an xN rule before any
                    # request is in flight)
                    FAULTS.fire_sync("engine.step")
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
                        with self._phase("idle"):
                            self._wake.wait()
                    else:
                        with self._phase("idle"):
                            self._wake.wait(self.config.step_idle_sleep_s)
            except Exception:  # noqa: BLE001
                # fail every in-flight request, then KEEP SERVING: one bad
                # step must not brick the engine
                log.exception("engine step failed; failing in-flight requests")
                if self.spmd is not None and self.spmd.strict:
                    # the followers replayed what failed here, or wait in
                    # a collective it never reached: lockstep is lost
                    self.spmd.mark_broken("a step failed on the leader")
                # queued offloads may name pages about to be released
                self._pending_offload.clear()
                self._fail_all("engine step failure")
                time.sleep(0.05)
        self._fail_all("engine closed")

    def _fail_all(self, error: str) -> None:
        """Fail every request the failed step held: the waiting queue
        first, then the partial prefill, then the slots. A slot's error
        item is what tells a client the step failed, so by the time any
        client can react the queue is already drained: a request it sends
        then is served, not failed by a step it never took part in."""
        reqs, self._embed_reqs = self._embed_reqs, []
        for _ids, fut in reqs:
            fut.set_exception(RuntimeError(error))
        self._pipeline.clear()
        self._admit_waves.clear()
        for w in self._waiting.drain():
            self._refund_if_charged(w)
            self._drop_staged_kv(w.request)
            self._error(w, error)
        p, self._partial = self._partial, None
        if p is not None:
            self.allocator.release(p.sp.pages)
            p.sp.pages = []
            self._error(p.waiting, error)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._finish(i, slot, "error", error=error)

    def _step(self) -> bool:
        did = False
        if self._digest_reqs:
            self._serve_digests()
            did = True
        if self._embed_reqs:
            self._serve_embeds()
            did = True
        if self.spmd is not None and self.spmd.sync_pending:
            # a mirror follower rejoins: quiesce (no burst in flight), then
            # snapshot the pages in use; it replays from the next descriptor
            with self._phase("spmd_sync"):
                self._flush_pipeline()
                self._materialize_waves(force=True)
                self._drain_offload()
                self.spmd.serve_sync(self._spmd_sync_state())
            did = True
        if self._admit_waves:
            # land admission waves lazily: each once its host copy is in
            # (or, aged, when no in-flight burst will land it)
            with self._phase("materialize"):
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
                with self._phase("flush"):
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
        admit_t0 = time.perf_counter() if self._profiling else 0.0
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
            FLIGHT.event(waiting.context.id, "admit")
            if self._profiling:
                waiting.admit_t = time.perf_counter()
                if waiting.enq_t:
                    self._prof_add("readmit.admit_wait",
                                   waiting.admit_t - waiting.enq_t)
            if waiting.context.is_stopped:
                self._drop_staged_kv(waiting.request)
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
        if n_admitted:
            self._prof_add("admit_loop", time.perf_counter() - admit_t0)
        if preps:
            with self._phase("packed_prefill"):
                records = self._run_packed_prefills(preps)
            with self._phase("complete_admissions"):
                self._complete_admissions(records)
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
            with self._phase("readmit_wait"):
                self._wake.clear()
                self._wake.wait(cfg.readmit_wait_s)
        if self._waiting.empty():
            return
        with self._phase("eager_readmit"):
            if self._admit_phase():
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
        the grammar cursor, which a plain text re-prefill does not), nor
        multimodal ones (a text re-prefill would drop the image rows)."""
        best: tuple[tuple[int, int], int, _Slot] | None = None
        for i, slot in enumerate(self._slots):
            if slot is None or slot.priority != "batch":
                continue
            if slot.first_pending or slot.context.is_stopped or slot.remaining < 1:
                continue
            if slot.guided is not None or slot.request.get("multimodal"):
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
        3. seal the victim's complete blocks into the prefix cache and,
           with KVBM, offload every one of them (the depth filter
           bypassed: the resume must be able to onboard them after G1
           evicts them);
        4. release its pages and slot as a finish does (the next replay's
           staged row for the slot reads inactive and writes only trash
           page 0), and re-enqueue ``prompt + generated`` with the shrunk
           budget and the seed pinned, uncharged, in its batch lane: the
           client's stream pauses, then resumes through the normal
           prefix-cache and KVBM admission (greedy streams continue as
           unpaused).

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
                FLIGHT.event(victim[1].context.id, "fault", site="engine.preempt")
                return None
        with self._phase("preempt"):
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
            if self.offload is not None:
                # the victim's sealed blocks go to the host tier whatever
                # their depth: the resume must onboard them even after G1
                # evicts them
                queued = {(s, p) for s, p, _b in self._pending_offload}
                for bi, (pg, h) in enumerate(zip(slot.pages.pages,
                                                 slot.pages.hashes)):
                    if h is not None and (h, pg) not in queued:
                        self._pending_offload.append((h, pg, bi))
            self._drain_offload()
            resume = self._build_resume_request(slot)
            FLIGHT.event(slot.context.id, "preempt", generated=slot.generated,
                         reason=reason)
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
        # a resumed disagg stream comes back as a plain request: its sealed
        # prompt pages rehit the prefix cache or KVBM, and the export it
        # was pulled from is gone
        req["disagg"] = None
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

    # -- disagg (decode side) ----------------------------------------------

    def _stage_pull(self, kvp: dict, mode: str) -> tuple:
        """Pull a remote export and put its blocks on this engine's device
        (blocking: runs in a thread of the loop, never the step thread).
        Returns (k, v, ready event or None, meta, resume mode): in mode
        ``shard`` this rank's shard of a sharded export (each other rank of
        the group prefetches its own: op ``kv_prefetch``), else the whole
        blocks."""
        from dynamo_tpu_torch.disagg.transfer import pull_kv_blocks

        k, v, meta = pull_kv_blocks(kvp, shard=0 if mode == "shard" else None)
        return (*self._blocks_to_device(k, v), meta, mode)

    def _resume_mode(self, kvp: dict) -> str:
        """How a resume installs under SPMD: ``shard`` when the export's
        shards are this tp group's KV heads (one shard per rank, no other
        mesh axis: the reference's ``_dest_tp_devices`` case); ``scatter``
        when the leader pulls the whole blocks and sends each rank of its
        group its heads (another width, replicas, MLA's latent rows);
        ``inline`` when mirror links follow the stream (they share no
        collective: the descriptors carry the tail in chunks); ``local``
        with no followers."""
        if self.spmd is None:
            return "local"
        m, shards = self.mesh, kvp.get("shards") or ()
        if self.spmd.mirrored or m is None or not m.distributed:
            return "inline"
        if (len(shards) == m.tp > 1 and self.fam.shards_kv_heads
                and all(m.shape[a] == 1 for a in m.shape if a != "tp")):
            return "shard"
        return "scatter"

    def prefetch_shard(self, kvp: dict) -> None:
        """A follower's op ``kv_prefetch``: pull this rank's shard of a
        sharded export in the background (off the replay: the resume only
        waits for it) and keep it, on the device, by transfer id."""
        import concurrent.futures

        from dynamo_tpu_torch.disagg.transfer import pull_kv_blocks

        r = self.mesh.tp_rank

        def pull() -> tuple:
            k, v, _meta = pull_kv_blocks(kvp, shard=r)
            return self._blocks_to_device(k, v)

        if self._prefetch_pool is None:
            self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
                4, thread_name_prefix="kv-prefetch")
        self._prefetched[kvp["transfer_id"]] = self._prefetch_pool.submit(pull)

    def unstage_shard(self, transfer_id: str) -> None:
        """A follower's op ``kv_unstage``: the leader will not resume this
        export; drop the prefetched shard (a pull in flight lands, then
        goes)."""
        self._prefetched.pop(transfer_id, None)

    def _release_export(self, kvp: dict) -> None:
        """Release every shard of an export that will not be installed, in
        the background (a round trip per shard: never on the step thread;
        the TTL is the backstop)."""
        from dynamo_tpu_torch.disagg.transfer import release_kv_blocks

        def release() -> None:
            try:
                release_kv_blocks(kvp)
            except Exception as e:  # noqa: BLE001
                log.debug("kv release failed (%s)", e)

        threading.Thread(target=release, name="kv-release", daemon=True).start()

    @property
    def kv_shards(self) -> int:
        """KV-head shards of this engine's pools: the mesh's tp for a
        family whose KV heads shard, else 1 (MLA's latent pool is whole)."""
        if self.mesh is None or not self.fam.shards_kv_heads:
            return 1
        return self.mesh.tp

    def _packed_blocks(self) -> bool:
        return self.kv_dtype == "fp8" and self.fam.shards_kv_heads

    def install_remote(self, mode: str, info: dict, page_ids: list[int], first: int,
                       staged: tuple | None = None, inline: tuple | None = None) -> bool:
        """Install a remote prefill's blocks past ``first`` into pages
        ``page_ids``, on the leader and on every follower alike (op
        ``kv_resume``). ``shard``: the leader staged its own shard at
        intake and each follower prefetched its own (op ``kv_prefetch``,
        ``info['transfer_id']``); the group agrees that every rank holds
        its shard (one all-reduce over tp) before any rank installs, so a
        failed pull installs nothing anywhere and the leader prefills
        locally. ``scatter``: the leader (``staged``: the whole tail) sends
        each rank of its group that rank's heads (``info``: their shapes
        and types). ``inline``: the whole blocks ride the descriptor
        (``inline``, host arrays, or the leader's own tensors), and each
        rank installs its heads. Returns False when the group's pulls did
        not all land."""
        ready = None
        if mode == "shard":
            fut = None
            if staged is None:
                fut = self._prefetched.pop(info["transfer_id"], None)
            if not page_ids:
                return True  # every page was cached: nothing to install
            ok = 1.0
            if staged is None:
                try:
                    if fut is None:
                        raise KeyError(f"no prefetched shard of {info['transfer_id']}")
                    t0 = time.perf_counter()
                    try:
                        k, v, ready = fut.result()
                    finally:
                        self.prefetch_wait_secs += time.perf_counter() - t0
                except Exception as e:  # noqa: BLE001
                    log.warning("kv shard %d pull failed (%s)", self.mesh.tp_rank, e)
                    ok = 0.0
            else:
                k, v, ready = staged
            agreed = self.mesh.all_reduce(
                torch.tensor([ok], device=self.device), over="tp")
            if float(agreed.item()) < self.mesh.tp:
                return False
        elif mode == "scatter":
            if not page_ids:
                return True
            if staged is not None:
                k, v = self._scatter_heads(*staged)
            else:
                k, v = self._receive_heads(info)
            first = 0  # the tail only
        else:
            k, v = inline
            if not page_ids:
                return True
            k, v = (self._heads_of(b) for b in (k, v))
            if isinstance(k, np.ndarray):
                # a descriptor's arrays are read-only views of its frame
                k, v, ready = self._blocks_to_device(
                    *(np.require(b, requirements=["C", "W"]) for b in (k, v)))
            else:
                k, v = k.contiguous().to(self.device), v.contiguous().to(self.device)
            first = 0  # the descriptor carries the install's tail only
        self._insert_blocks(k, v, ready, page_ids, first)
        return True

    def _heads_of(self, block, tp_rank: int | None = None):
        """This rank's (or tp rank ``tp_rank``'s) KV heads of a block of
        every head: the whole block when the heads do not shard."""
        from dynamo_tpu_torch.disagg.transfer import split_heads

        n = self.kv_shards
        if n == 1:
            return block
        r = self.mesh.tp_rank if tp_rank is None else tp_rank
        return split_heads(block, self.spec.num_kv_heads, n, r, self._packed_blocks())

    def _scatter_heads(self, k, v, ready) -> tuple:
        """The leader's side of a ``scatter`` install: send every other
        rank of the world its tp coordinate's heads of the whole tail
        ``k``, ``v`` (as bytes, point to point; through host memory where
        the collectives are staged), and return its own."""
        import torch.distributed as dist

        from dynamo_tpu_torch.parallel.mesh import AXES, rank_grid

        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        grid, tp_axis = rank_grid(self.mesh.shape), AXES.index("tp")
        reqs, keep = [], []
        for g in range(1, dist.get_world_size()):
            c = int(np.argwhere(grid == g)[0][tp_axis])
            for b in (k, v):
                part = self._heads_of(b, c).contiguous()
                if part.numel() == 0:
                    continue
                if self.mesh.staged:
                    part = part.cpu()
                keep.append(part.reshape(-1).view(torch.uint8))
                reqs.append(dist.isend(keep[-1], dst=g))
        for r in reqs:
            r.wait()
        return self._heads_of(k, 0), self._heads_of(v, 0)

    def _receive_heads(self, info: dict) -> tuple:
        """A follower's side of a ``scatter`` install: its heads of the
        tail, from the leader (global rank 0), on this rank's device."""
        import torch.distributed as dist

        host = self.mesh.staged
        out = []
        for name in ("k", "v"):
            dtype = getattr(torch, info[f"{name}_dtype"])
            shape = [int(x) for x in info[f"{name}_shape"]]
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if host else self.device)
            if buf.numel():
                dist.recv(buf.reshape(-1).view(torch.uint8), src=0)
            out.append(buf.to(self.device) if host else buf)
        return out[0], out[1]

    def _insert_blocks(self, k_blocks, v_blocks, ready, page_ids: list[int],
                       first: int) -> None:
        if k_blocks.is_cuda:
            # blocks staged on another stream (the H2D stream, the device
            # route's copy stream): ordered before, and kept alive for, the
            # install on this one
            cur = torch.cuda.current_stream(self.device)
            if ready is not None:
                cur.wait_event(ready)
            k_blocks.record_stream(cur)
            v_blocks.record_stream(cur)
        # the install is the export's tail past the cached prefix: a view,
        # no gather (a fresh block of the size would ask the caching
        # allocator for memory on the step thread)
        k_blocks = k_blocks[:, first:]
        v_blocks = v_blocks[:, first:]
        self.fam.insert_pages(self.k_pages, self.v_pages, self._page_ids(page_ids),
                              k_blocks, v_blocks)

    def _blocks_to_device(self, k, v) -> tuple:
        """Pulled blocks as tensors on the engine's device. Host blocks
        (numpy, bf16 as ``uint16`` bits) go up from pinned memory on the
        H2D stream, behind an event the resume's stream waits on: a pageable
        copy would make the step thread wait for the bursts in flight."""
        if not isinstance(k, np.ndarray):
            return k.to(self.device), v.to(self.device), None
        kt, vt = block_tensor(k), block_tensor(v)
        if self.device.type != "cuda":
            return kt, vt, None
        kt, vt = kt.pin_memory(), vt.pin_memory()
        with torch.cuda.stream(self._h2d_stream):
            kd = kt.to(self.device, non_blocking=True)
            vd = vt.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d_stream)
        return kd, vd, ready

    def _release_waiting_disagg(self, waiting: _Waiting) -> None:
        """Shed victim (event-loop side): drop its staged blocks and unpin
        the prefill worker's export in the background, the contract the
        saturation bounce keeps for the incoming request."""
        disagg = waiting.request.get("disagg") or {}
        self._drop_staged_kv(waiting.request)
        if disagg.get("mode") == "decode" and disagg.get("kv_transfer"):
            from dynamo_tpu_torch.disagg.transfer import release_kv_blocks
            from dynamo_tpu_torch.runtime.context import spawn

            kvp = _transfer_params(disagg)

            async def _release() -> None:
                try:
                    await asyncio.to_thread(release_kv_blocks, kvp)
                except Exception as e:  # noqa: BLE001 - the TTL is the backstop
                    log.debug("shed kv release failed (%s)", e)

            spawn(_release(), name="shed-kv-release")

    def _drop_staged_kv(self, request: dict[str, Any]) -> bool:
        """Free the staged blocks of a request that will never be admitted
        (cancel, bounce, step failure): the handler keeps the request dict
        alive for the stream's lifetime. A ``shard`` staging's followers
        drop their prefetched shards (op ``kv_unstage``), and every shard
        is released at its source (one whose prefetch failed is still
        there). Returns True when it released the export."""
        disagg = request.get("disagg")
        if not disagg:
            return False
        staged = disagg.pop("_staged_kv", None)
        if staged is None or staged[-1] != "shard":
            return False
        kvp = _transfer_params(disagg)
        self._publish("kv_unstage", {"transfer_id": kvp["transfer_id"]}, side=True)
        self._release_export(kvp)
        return True

    def _prefill_safe(self, slot_idx: int, waiting: _Waiting):
        """Per-request error isolation: a bad request must not kill the
        loop. Returns a prep dict (forward deferred to the packed prefill),
        ``_REQUEUED`` (page backpressure) or None (handled: a disagg resume,
        an error, or a chunked prefill started)."""
        mark = self._spmd_mark()
        try:
            disagg = waiting.request.get("disagg") or {}
            if disagg.get("mode") == "decode" and disagg.get("kv_transfer"):
                return self._resume_from_remote(slot_idx, waiting)
            return self._prefill(slot_idx, waiting)
        except Exception as e:  # noqa: BLE001
            log.exception("prefill failed for %s", waiting.context.id)
            self._spmd_broken("prefill failed after publish", mark)
            self._refund_if_charged(waiting)
            self._error(waiting, f"prefill failed: {e}")
            return None

    def prefix_hit_tokens(self, token_ids: list[int]) -> int:
        """Leading prompt tokens cached locally: G1 pages plus the KVBM
        host and disk tiers the admission can onboard from (a policy
        probe). Advisory and unlocked: called from the event loop while the
        step thread moves pages, so the answer may be stale when used; the
        admission checks again."""
        seq = TokenBlockSequence.from_tokens(token_ids, self.config.page_size)
        hashes = seq.sequence_hashes()
        n = len(self.allocator.match_prefix(hashes))
        if self.kvbm is not None:
            while n < len(hashes) and hashes[n] in self.kvbm:
                n += 1
        return n * self.config.page_size

    def _acquire_prompt_pages(
        self, request_id: str, seq: TokenBlockSequence, needed_pages: int,
        n_tokens: int, *, full_prefix_ok: bool = False,
    ) -> SeqPages:
        """Prefix-cache take (G1, then the KVBM tiers' consecutive blocks
        onboarded into fresh pages) + allocation to cover the prompt. Unless
        ``full_prefix_ok`` (a disagg resume computes nothing), at least one
        token stays uncached: prefill needs the last position's logits.
        Raises OutOfPages, holding nothing, if the pool is exhausted."""
        hashes = seq.sequence_hashes()
        page_size = self.config.page_size
        cached = self.allocator.take_prefix(hashes)
        while (not full_prefix_ok and cached
               and len(cached) * page_size >= n_tokens):
            self.allocator.release([cached.pop()])
        onboard: list = []
        if self.kvbm is not None:
            limit = needed_pages if full_prefix_ok else (n_tokens - 1) // page_size
            wanted = hashes[len(cached): min(limit, len(hashes))]
            onboard = self.kvbm.get_consecutive(wanted)
            if onboard and self.kv_dtype == "fp8":
                onboard = self._validate_quant_blocks(onboard, wanted)
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
        if onboard:
            idxs = range(len(cached), len(cached) + len(onboard))
            try:
                self.onboard_from_tiers([sp.pages[i] for i in idxs], onboard,
                                        hashes=list(wanted[: len(onboard)]))
            except Exception:
                self.allocator.release(sp.pages)
                raise
            # the content came FROM the tiers: sealed without re-offload
            self._seal_prompt_blocks(sp, seq, start=len(cached),
                                     end=len(cached) + len(onboard), offload=False)
            sp.cached_prefix_pages = len(cached) + len(onboard)
            self.onboards.append((request_id, len(cached), len(onboard)))
        return sp

    def _embed(self, token_ids: list[int]) -> list[float]:
        """Pooled sequence embedding of ``token_ids`` (padded to its prefill
        bucket, as the reference's). Under SPMD the step thread publishes
        op ``embed`` first: the followers run the same forward and its tp
        collectives."""
        padded = np.zeros((self.config.bucket_for(len(token_ids)),), np.int32)
        padded[: len(token_ids)] = token_ids
        self._publish("embed", {"num_tokens": len(token_ids)}, {"tokens": padded})
        return self.embed_padded(padded, len(token_ids)).float().cpu().numpy().tolist()

    def embed_padded(self, padded: np.ndarray, num_tokens: int) -> torch.Tensor:
        """The embedding forward of a bucket-padded prompt (a follower's
        replay of op ``embed`` too)."""
        with torch.inference_mode():
            return self.fam.embed_forward(
                self.spec, self.params, torch.from_numpy(padded).to(self.device),
                num_tokens)

    async def _embed_on_step_thread(self, token_ids: list[int]) -> list[float]:
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._embed_reqs.append((token_ids, fut))
        self._wake.set()
        return await asyncio.wrap_future(fut)

    def _serve_embeds(self) -> None:
        reqs, self._embed_reqs = self._embed_reqs, []
        for token_ids, fut in reqs:
            mark = self._spmd_mark()
            try:
                fut.set_result(self._embed(token_ids))
            except Exception as e:  # noqa: BLE001
                self._spmd_broken("embedding failed after publish", mark)
                fut.set_exception(e)

    def _decode_multimodal(self, req: dict) -> dict | None:
        """Validate and decode the request's multimodal payload (the encoder's
        rows and the placeholder positions). None for a text request."""
        mm = req.get("multimodal")
        if not mm:
            return None
        if "embeds_b64" not in mm:
            raise ValueError(
                "multimodal request reached the engine without embeddings "
                "(is an encode worker registered?)"
            )
        if not self.fam.supports_multimodal:
            raise ValueError(f"{type(self.fam).__name__} does not support image input")
        from dynamo_tpu_torch.multimodal.worker import embeds_from_wire, salt_from_wire

        embeds = embeds_from_wire(mm).astype(np.float32, copy=False)
        positions = np.asarray(mm.get("positions") or (), np.int32)
        if embeds.ndim != 2 or embeds.shape[0] != positions.shape[0]:
            raise ValueError(
                f"multimodal rows {embeds.shape} do not match "
                f"{positions.shape[0]} placeholder positions"
            )
        if embeds.shape[1] != self.spec.hidden_size:
            raise ValueError(
                f"multimodal embedding width {embeds.shape[1]} != model "
                f"hidden size {self.spec.hidden_size}"
            )
        # the cache-partitioning salt: prompts with different images share
        # placeholder ids, so unsalted block hashes would alias across
        # images (and with text prompts). Salted by the embedding digest,
        # the same prompt and image rehit, anything else misses
        return {"embeds": embeds, "positions": positions,
                "salt": mm.get("salt") or salt_from_wire(mm)}

    def _prefill(self, slot_idx: int, waiting: _Waiting):
        cfg = self.config
        req = waiting.request
        token_ids = list(req["token_ids"])
        mm = waiting.mm
        seq = TokenBlockSequence.from_tokens(token_ids, cfg.page_size,
                                             salt=mm["salt"] if mm else None)
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
        tail = len(token_ids) - start_pos
        ring = self._takes_ring(start_pos, tail, mm)
        if ring or start_pos + chunk_max >= len(token_ids):
            # fits one dispatch: the packed prefill stage runs it (a
            # multimodal prompt in a dispatch of its own, with injection;
            # a cold prompt under sp > 1 in a ring prefill of its own,
            # unchunked up to the largest bucket, as the reference's)
            return {
                "slot_idx": slot_idx, "waiting": waiting, "seq": seq, "sp": sp,
                "token_ids": token_ids, "max_tokens": max_tokens,
                "start_pos": start_pos, "tail": tail, "mm": mm, "ring": ring,
            }
        if mm is not None:
            # chunking would split the placeholder span across dispatches
            self.allocator.release(sp.pages)
            sp.pages = []
            raise ValueError(
                "multimodal prompt exceeds a single prefill dispatch "
                f"({len(token_ids) - start_pos} uncached tokens > "
                f"max_prefill_chunk_tokens {chunk_max})"
            )
        # long prompt: the first chunk now, the rest on later steps,
        # interleaved with decode (_step)
        end = start_pos + chunk_max
        FLIGHT.event(waiting.context.id, "prefill_chunk")
        self.prefill_chunks += 1
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
        self, sp: SeqPages, token_ids: list[int], start: int, end: int,
        mm: dict | None = None,
    ) -> torch.Tensor:
        """One bucketed prefill forward over positions [start, end) (start
        on a page boundary); returns the last position's logits [V]. ``mm``:
        the multimodal rows injected at their window-relative placeholder
        positions; rows under the cached prefix are skipped (the salted
        cache already holds their KV)."""
        cfg = self.config
        new_tokens = token_ids[start:end]
        bucket = cfg.bucket_for(len(new_tokens))
        padded = np.zeros((bucket,), np.int32)
        padded[: len(new_tokens)] = new_tokens
        block_table = np.zeros((cfg.max_pages_per_seq,), np.int32)
        block_table[: sp.num_pages] = sp.pages
        dev = self.device
        mm_kw: dict[str, torch.Tensor] = {}
        if mm is not None:
            rel = mm["positions"] - start
            keep = rel >= 0
            rel, rows = rel[keep], mm["embeds"][keep]
            # padded to a power-of-two row count (at least 8), as the
            # reference's compiled shapes; padded positions point past the
            # bucket, so the injection drops them
            m = max(8, 1 << max(0, int(rel.shape[0]) - 1).bit_length())
            pos_pad = np.full((m,), bucket, np.int32)
            pos_pad[: rel.shape[0]] = rel
            emb_pad = np.zeros((m, self.spec.hidden_size), np.float32)
            emb_pad[: rows.shape[0]] = rows
            mm_kw = {"mm_embeds": torch.from_numpy(emb_pad).to(dev),
                     "mm_pos": torch.from_numpy(pos_pad).to(dev)}
        self._publish("prefill", {"start": start, "num_tokens": len(new_tokens)},
                      {"tokens": padded, "block_table": block_table,
                       **({"mm_embeds": emb_pad, "mm_pos": pos_pad} if mm_kw else {})})
        self.prefill_forwards += 1
        self.dispatches += 1
        logits, dropped = self.fam.prefill(
            self.spec, self.params, torch.from_numpy(padded).to(dev),
            torch.from_numpy(block_table).to(dev), start, self.k_pages,
            self.v_pages, len(new_tokens), **mm_kw,
        )
        self._note_moe_dropped(dropped)
        return logits

    def _advance_partial_safe(self) -> None:
        p = self._partial
        mark = self._spmd_mark()
        try:
            self._advance_partial()
        except Exception as e:  # noqa: BLE001
            log.exception("chunked prefill failed for %s", p.waiting.context.id)
            self._spmd_broken("chunked prefill failed after publish", mark)
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
        FLIGHT.event(p.waiting.context.id, "prefill_chunk")
        self.prefill_chunks += 1
        logits = self._run_prefill_chunk(p.sp, p.token_ids, p.done, end)
        p.done = end
        if end == len(p.token_ids):
            self._partial = None
            self._seal_prompt_blocks(p.sp, p.seq)
            self._drain_offload()
            self._complete_admissions([_Admitted(
                p.slot_idx, p.waiting, p.seq, p.sp, p.token_ids, p.max_tokens,
                logits)])

    def _run_packed_prefills(self, preps: list[dict]) -> list[_Admitted]:
        """Same-bucket prompts batch into one prefill_forward_batch of up
        to ``prefill_pack_size`` rows; singletons take the single-prompt
        forward. Groups are not padded to the pack size: PyTorch runs
        eagerly, so a new row count costs no compile. The first tokens are
        sampled on the same logits right away when the admission is async
        (``_fused_first_tokens``). A multimodal prompt takes a dispatch of
        its own, its rows injected (``_run_prefill_chunk``). Seals each
        prompt's complete blocks into the prefix cache."""
        cfg = self.config
        groups: dict[int, list[dict]] = {}
        dispatches: list[tuple[int, list[dict]]] = []
        for p in preps:
            if p["mm"] is not None or p["ring"]:
                # one dispatch of its own (the rows injected, or the ring
                # over the sp ranks): no packing
                dispatches.append((cfg.bucket_for(p["tail"]), [p]))
            else:
                groups.setdefault(cfg.bucket_for(p["tail"]), []).append(p)
        pack = max(1, cfg.prefill_pack_size)
        for bucket, group in sorted(groups.items()):
            dispatches.extend((bucket, group[i: i + pack])
                              for i in range(0, len(group), pack))
        records: list[_Admitted] = []
        for bucket, chunk in dispatches:
            mark = self._spmd_mark()
            try:
                if chunk[0]["ring"]:
                    logits = self._ring_dispatch(bucket, chunk[0])[None]
                elif chunk[0]["mm"] is None:
                    logits = self._prefill_dispatch(bucket, chunk)
                else:
                    (p,) = chunk
                    logits = self._run_prefill_chunk(
                        p["sp"], p["token_ids"], p["start_pos"],
                        len(p["token_ids"]), mm=p["mm"])[None]
            except Exception as e:  # noqa: BLE001
                log.exception("prefill failed (%d prompts)", len(chunk))
                self._spmd_broken("packed prefill failed after publish", mark)
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
        self._drain_offload()
        return records

    def _ring_sp(self) -> int:
        """The sp ranks a cold prompt's ring prefill spreads over (1: no
        ring)."""
        if self.mesh is None or not self.fam.supports_ring_prefill:
            return 1
        return self.mesh.shape["sp"]

    def _takes_ring(self, start_pos: int, tail: int, mm) -> bool:
        """The reference's ring conditions: sp > 1 (and a family with ring
        prefill), a cold text prompt (no cached prefix, no image rows) that
        fits the largest bucket, whose bucket divides by sp."""
        cfg, sp = self.config, self._ring_sp()
        return (sp > 1 and mm is None and start_pos == 0
                and tail <= cfg.prefill_buckets[-1] and cfg.bucket_for(tail) % sp == 0)

    def _ring_dispatch(self, bucket: int, p: dict) -> torch.Tensor:
        """A cold prompt's sequence-parallel prefill over the sp ranks
        (``fam.prefill_ring``): the whole prompt in one dispatch, each rank
        its ``bucket / sp`` tokens. Published as ``ring_prefill`` first, so
        every follower joins the ring. Returns the last logits [V]."""
        cfg = self.config
        tokens = np.zeros((bucket,), np.int32)
        tokens[: p["tail"]] = p["token_ids"]
        bt = np.zeros((cfg.max_pages_per_seq,), np.int32)
        bt[: p["sp"].num_pages] = p["sp"].pages
        self._publish("ring_prefill", {"num_tokens": p["tail"]},
                      {"tokens": tokens, "block_table": bt})
        self.prefill_forwards += 1
        self.dispatches += 1
        self.ring_prefills += 1
        dev = self.device
        logits, dropped = self.fam.prefill_ring(
            self.spec, self.params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(bt).to(dev), self.k_pages, self.v_pages, p["tail"])
        self._note_moe_dropped(dropped)
        return logits

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
        self.prefill_forwards += 1
        self.dispatches += 1
        tok_d = torch.from_numpy(tokens).to(dev)
        bts_d = torch.from_numpy(bts).to(dev)
        if nb == 1:
            self._publish("prefill", {"start": int(starts[0]), "num_tokens": int(nts[0])},
                          {"tokens": tokens[0], "block_table": bts[0]})
            logits, dropped = self.fam.prefill(
                self.spec, self.params, tok_d[0], bts_d[0], int(starts[0]),
                self.k_pages, self.v_pages, int(nts[0]),
            )
            logits = logits[None]
        else:
            self._publish("prefill_batch", None,
                          {"tokens": tokens, "block_tables": bts, "start": starts,
                           "num_tokens": nts})
            logits, dropped = self.fam.prefill_batch(
                self.spec, self.params, tok_d, bts_d, torch.from_numpy(starts),
                self.k_pages, self.v_pages, torch.from_numpy(nts),
            )
        self._note_moe_dropped(dropped)
        return logits[: len(group)]

    def _seal_prompt_blocks(
        self, sp: SeqPages, seq: TokenBlockSequence, start: int | None = None,
        end: int | None = None, *, offload: bool = True,
    ) -> None:
        """Seal complete prompt blocks [start, end) (default: the newly
        computed ones) into the prefix cache, queueing each for offload
        unless ``offload`` is False (onboarded blocks)."""
        start = sp.cached_prefix_pages if start is None else start
        end = len(seq.blocks) if end is None else end
        for i in range(start, end):
            blk = seq.blocks[i]
            self.allocator.seal_page(
                sp.pages[i], blk.sequence_hash, blk.parent_sequence_hash
            )
            sp.hashes[i] = blk.sequence_hash
            if offload:
                self._queue_offload(blk.sequence_hash, sp.pages[i], i)

    def _validate_quant_blocks(self, blocks: list, hashes: list) -> list:
        """The fp8 onboard guard: a tier block whose payload length is wrong
        or whose scale bytes decode non-finite would dequantize a whole page
        to NaN/inf, so it (and every later block: an onboard prefix is
        consecutive) is a tier miss, logged, and evicted from G2 and G3 (G4
        is shared and left alone: a refetch validates here again).
        ``engine.quant`` is the injectable fault site. Only the parts whose
        pool is quantized are judged: an MLA block's inert v slot is not a
        payload."""
        from dynamo_tpu_torch.ops.quant import (
            is_quant,
            packed_block_ok,
            packed_bytes_per_page,
            packed_scale_bytes,
        )

        checks = [(packed_bytes_per_page(pool), packed_scale_bytes(pool))
                  if is_quant(pool) else None
                  for pool in (self.k_pages, self.v_pages)]
        for i, blk in enumerate(blocks):
            bad = None
            try:
                if FAULTS.enabled:
                    FAULTS.fire_sync("engine.quant")
            except Exception as e:  # noqa: BLE001 - injected corruption
                bad = f"injected dequant corruption: {e}"
            if bad is None:
                for part, chk in zip(blk, checks):
                    if chk is not None and not packed_block_ok((part,), chk[0], chk[1]):
                        bad = "payload length or scale bytes invalid"
                        break
            if bad is not None:
                log.error("kvbm quantized onboard: block %d/%d corrupt (%s); "
                          "treating the remaining prefix as a miss",
                          i, len(blocks), bad)
                sh = hashes[i] if i < len(hashes) else None
                if sh is not None:
                    self.kvbm.host.remove(sh)
                    if self.kvbm.disk is not None:
                        self.kvbm.disk.remove(sh)
                with self.kvbm._lock:
                    self.kvbm.stats.onboard_misses += 1
                return blocks[:i]
        return blocks

    def onboard_from_tiers(self, page_ids: list[int], blocks: list | None,
                           hashes: list[int] | None = None,
                           zero_fill: bool = False) -> None:
        """Install tier ``blocks`` into device pages ``page_ids``, in place:
        the host blocks stacked page-major (``[L, n, ...]``), one
        host-to-device copy, the family's insert, all on the compute stream
        ahead of the prefill that reads them. ``blocks=None`` (an SPMD
        follower replaying the leader's onboard) fetches this rank's own
        shard of each block of ``hashes`` from its own tiers
        (``_follower_blocks``: a block they lack raises ``TierMiss``, or
        with ``zero_fill`` zero-fills its page, loudly)."""
        if blocks is None:
            blocks = self._follower_blocks(page_ids, hashes, zero_fill)
        elif self.spmd is not None:
            self._publish("kv_onboard", {"hashes": [int(h) for h in hashes or []]},
                          {"page_ids": np.asarray(page_ids, np.int32)})
        log.debug("kvbm onboard n=%d pages=%s", len(blocks), page_ids[:4])
        kb = block_tensor(np.stack([b[0] for b in blocks], axis=1)).to(self.device)
        vb = block_tensor(np.stack([b[1] for b in blocks], axis=1)).to(self.device)
        ids = torch.tensor(page_ids, dtype=torch.int64).to(self.device)
        self.fam.insert_pages(self.k_pages, self.v_pages, ids, kb, vb)

    # -- KVBM offload (device -> host tiers) -------------------------------

    def _queue_offload(self, sh: int, page: int, block_index: int) -> None:
        if self.kvbm is not None and self.kvbm.should_offload(block_index):
            self._pending_offload.append((sh, page, block_index))

    def _drain_offload(self) -> None:
        """One gather of every page sealed since the last drain into a new
        device tensor, on the compute stream; the copy to the host runs on
        the copy stream and lands in the offload thread (kvbm/offload.py).

        MUST run before any queued page can be released or re-allocated
        (callers: right after sealing, before a finish): the gather reads
        the live pools, and only its place on the compute stream orders it
        before a later write to a re-allocated page. Exactly the queued
        pages are gathered (no padding to a bucket: nothing here
        compiles)."""
        if not self._pending_offload:
            return
        batch, self._pending_offload = self._pending_offload, []
        hashes, pages = [s for s, _p, _i in batch], [p for _s, p, _i in batch]
        # published only once this rank's queue took the batch: a
        # follower's tiers then hold exactly the blocks the leader's do
        if self.offload_pages(hashes, pages):
            self._publish("kv_offload", {"hashes": hashes},
                          {"page_ids": np.asarray(pages, np.int32)})

    def _follower_blocks(self, page_ids: list[int], hashes: list[int],
                         zero_fill: bool) -> list:
        """A follower's own tier copies of the leader's onboarded blocks.
        A block not landed yet is waited for (this rank's offload queue is
        flushed). A block still missing raises ``TierMiss``: a tp rank's
        zero K/V would enter the all-reduce and change the leader's tokens.
        ``zero_fill`` (a mirror follower whose tier copy died with its old
        process) fills it with zeros instead, loudly: the mirror is
        degraded until the page cycles out."""
        from dynamo_tpu_torch.kvbm.offload import block_numpy

        if self.kvbm is None:
            raise TierMiss(list(hashes))
        got = [self.kvbm.get(h) for h in hashes]
        if any(g is None for g in got) and self.offload is not None:
            self.offload.flush()
            got = [g if g is not None else self.kvbm.get(h) for g, h in zip(got, hashes)]
        missing = [h for g, h in zip(got, hashes) if g is None]
        if not missing:
            return got
        if not zero_fill:
            raise TierMiss(missing)
        log.error("kvbm onboard replay: %d/%d blocks not in this rank's tiers; "
                  "their pages zero-fill", len(missing), len(hashes))
        kb, vb = self.fam.extract_pages(self.k_pages, self.v_pages,
                                        self._page_ids(page_ids[:1]))
        zero = (np.zeros_like(block_numpy(kb[:, 0].cpu())),
                np.zeros_like(block_numpy(vb[:, 0].cpu())))
        return [g if g is not None else zero for g in got]

    def offload_pages(self, hashes: list[int], pages: list[int],
                      wait: bool = False) -> bool:
        """Gather ``pages`` and hand them to the offload thread under
        ``hashes`` (each rank offloads its own shard of the blocks). False
        when the thread's full queue dropped the batch; ``wait`` (an SPMD
        follower: its tiers must hold what the leader's hold) waits for
        room instead."""
        if self.offload is None:
            return False
        ids = self._page_ids(pages)
        t0 = None
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record()
        kb, vb = self.fam.extract_pages(self.k_pages, self.v_pages, ids)
        return self.offload.submit(hashes, HostBatch(kb, vb, self._copy_stream, t0),
                                   wait=wait)

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
        kvt = (req.get("disagg") or {}).get("kv_transfer") or {}
        if kvt.get("do_remote_decode") and self.transfer_source is not None:
            return True  # the first token leaves with the export
        return ((req.get("output_options") or {}).get("logprobs") is not None
                and self.fam.supports_logprobs)

    def _fused_first_tokens(
        self, logits: torch.Tensor, waitings: list[_Waiting]
    ) -> list[tuple] | None:
        """Sample a prefill dispatch's first tokens straight off its
        [nb, V] logits, with no host copy. Returns per-row ``(samples, row,
        seed)`` for the async admission path, or None when these records
        take the synchronous path."""
        if (not self._async_admissions
                or any(self._needs_sync_admission(w.request) for w in waitings)):
            return None
        params = [self._sampling_params(w.request) for w in waitings]
        samples = self._sample(logits, *zip(*params))
        self.dispatches += 1
        return [(samples, i, params[i][3]) for i in range(len(waitings))]

    def _complete_admissions(self, records: list[_Admitted]) -> None:
        """First tokens of the admitted prompts. Async path (default): the
        samples stay on the device and feed the next burst there
        (_complete_admissions_async). Synchronous path (async admissions
        off, or a request wants logprobs): one batched sample, read on the
        host, emitted now."""
        if not records:
            return
        if self._async_admissions and not any(
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
            self.dispatches += 1
            lp = top_i = top_v = None
            # readmit.d2h_wait, not dispatch.d2h_wait: these reads nest in
            # the complete_admissions phase (one name per accounting bucket)
            if any(s.logprobs is not None for s in slots):
                picked, ti, tv = token_logprobs(stacked, sampled, self._n_lp)
                self.dispatches += 1
                with self._phase("readmit.d2h_wait"):
                    lp, top_i, top_v = (x.cpu().numpy() for x in (picked, ti, tv))
            with self._phase("readmit.d2h_wait"):
                toks = sampled.cpu().numpy()
        except Exception as e:  # noqa: BLE001
            log.exception("first-token sampling failed")
            for r in records:
                self.allocator.release(r.sp.pages)
                r.sp.pages = []
                self._error(r.waiting, f"prefill failed: {e}")
            return
        self._note_prefill_done(records, slots)
        for i, (r, slot) in enumerate(zip(records, slots)):
            tok = int(toks[i])
            entry = None
            if slot.logprobs is not None and lp is not None:
                entry = {"id": tok, "logprob": float(lp[i]),
                         "top": [{"id": int(top_i[i, t]),
                                  "logprob": float(top_v[i, t])}
                                 for t in range(slot.logprobs)]}
            kvt = (r.waiting.request.get("disagg") or {}).get("kv_transfer") or {}
            if kvt.get("do_remote_decode") and self.transfer_source is not None:
                try:
                    self._export_and_finish(slot, r.sp, r.token_ids, tok, entry)
                except Exception as e:  # noqa: BLE001
                    log.exception("kv export failed for %s", r.waiting.context.id)
                    self.allocator.release(r.sp.pages)
                    r.sp.pages = []
                    self._error(r.waiting, f"kv export failed: {e}")
                continue
            self._emit_token(r.slot_idx, slot, tok, logprob_entry=entry)

    def _admission_guided_mask(self, slots: list[_Slot]) -> np.ndarray | None:
        """[n, V] allowed mask for a first-token sample, or None when no
        slot is constrained (the all-free batch samples unmasked). Free
        rows are all-True, the identity under the mask."""
        if not any(s.guided is not None and s.guided.constraining for s in slots):
            return None
        with self._phase("guided.mask"):
            allowed = np.ones((len(slots), self.spec.vocab_size), bool)
            for i, slot in enumerate(slots):
                if slot.guided is not None and slot.guided.constraining:
                    allowed[i] = slot.guided.mask()
        return allowed

    def _note_prefill_done(self, records: list[_Admitted],
                           slots: list[_Slot]) -> None:
        """Step profiler: each admission's dequeue -> prefill-and-sample
        dispatched span (``readmit.prefill_dispatch``), and the start of
        its ``readmit.first_token`` span."""
        if not self._profiling:
            return
        now = time.perf_counter()
        for r, slot in zip(records, slots):
            if r.waiting.admit_t:
                self._prof_add("readmit.prefill_dispatch", now - r.waiting.admit_t)
            slot.prefill_done_t = now

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
                self.dispatches += 1
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
        self._note_prefill_done(records, [slot for _si, slot in recs])
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
            # nests in the materialize phase: the readmit bucket
            with self._phase("readmit.d2h_wait"):
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
        self._note_first_token(slot)
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
        self._note_first_token(slot)
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

    def _note_first_token(self, slot: _Slot) -> None:
        """The first token reaches the host: its flight event, and the
        profiler's prefill-dispatched -> first-token span."""
        if slot.prefill_done_t:
            self._prof_add("readmit.first_token",
                           time.perf_counter() - slot.prefill_done_t)
            slot.prefill_done_t = 0.0
        FLIGHT.event(slot.context.id, "first_token")

    # -- disagg: export (prefill side) and resume (decode side) -------------

    def _spmd_sync_state(self) -> list[tuple]:
        """A rejoining follower's snapshot: the pages in use, as ``(page_ids,
        k, v)`` numpy chunks of at most SYNC_CHUNK_BYTES each, gathered one
        chunk at a time (the weights are not shipped: the follower builds
        them from the same seed or checkpoint). Under tp each chunk holds
        every rank's KV heads (op ``kv_gather``): a mirror rank installs
        its own."""
        from dynamo_tpu_torch.parallel.spmd import SYNC_CHUNK_BYTES

        ids = [int(p) for p in self.allocator.used_page_ids()]
        if not ids:
            return []
        per_page = max(1, self.kv_shards * self.pool_bytes // (self.config.num_pages + 1))
        step = max(1, SYNC_CHUNK_BYTES // per_page)
        chunks = []
        for i in range(0, len(ids), step):
            sub = ids[i: i + step]
            if self.kv_shards > 1:
                self._publish("kv_gather", None, {"page_ids": np.asarray(sub, np.int32)})
            chunks.append((np.asarray(sub, np.int32), *self.gather_pages(sub)))
        return chunks

    def gather_pages(self, pages: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Pages ``pages`` of the pools as host blocks of every KV head: this
        rank's, all-gathered over tp when the heads are sharded (a
        follower's replay of op ``kv_gather`` runs the same collectives)."""
        from dynamo_tpu_torch.disagg.transfer import join_heads

        kb, vb = self.fam.extract_pages(self.k_pages, self.v_pages, self._page_ids(pages))
        n = self.kv_shards
        if n > 1:
            heads = [self.spec.num_kv_heads // n] * n
            kb, vb = (join_heads(list(self.mesh.all_gather(b.unsqueeze(0), dim=0).unbind(0)),
                                 heads, self._packed_blocks()) for b in (kb, vb))
        return block_numpy(kb.contiguous().cpu()), block_numpy(vb.contiguous().cpu())

    def _page_ids(self, pages: list[int]) -> torch.Tensor:
        """Page (or block) indices on the device; on CUDA from pinned
        memory, non-blocking (a pageable copy would make the step thread
        wait for the bursts in flight)."""
        ids = torch.tensor(pages, dtype=torch.int64)
        if self.device.type == "cuda":
            return ids.pin_memory().to(self.device, non_blocking=True)
        return ids

    def export_pages(self, pages: list[int], num_tokens: int,
                     transfer_id: str | None = None) -> tuple:
        """Gather ``pages`` of this rank's pools into fresh blocks on the
        compute stream and export them from its transfer source (under
        ``transfer_id`` on a tp follower: op ``kv_export``). Returns
        (params, k blocks, v blocks, timing events or None)."""
        timing = None
        if self.device.type == "cuda":
            timing = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            timing[0].record()
        kb, vb = self.fam.extract_pages(self.k_pages, self.v_pages, self._page_ids(pages))
        if timing is not None:
            timing[1].record()
        params = self.transfer_source.export(
            kb, vb, num_tokens=num_tokens, page_size=self.config.page_size,
            transfer_id=transfer_id)
        return params, kb, vb, timing

    def _shard_entries(self, params: dict, kb, vb) -> list[dict]:
        """Every rank's entry of a sharded export: rank r holds KV heads
        from ``r * KH / tp`` in its own source (``transfer_source.peers``:
        ranks 1..tp-1, found through the group's store), shaped as this
        rank's shard."""
        src, n = self.transfer_source, self.kv_shards
        peers = src.peers
        if len(peers) != n - 1:
            raise RuntimeError(
                f"sharded export over tp={n} needs the transfer sources of ranks "
                f"1..{n - 1}; {len(peers)} known")
        heads = self.spec.num_kv_heads // n
        own = {"addr": params["addr"], "uid": src.uid}
        out = []
        for r, peer in enumerate([own] + peers):
            e = {"start": r * heads, "k_shape": list(kb.shape),
                 "v_shape": list(vb.shape), "addr": peer["addr"],
                 "transfer_id": params["transfer_id"], "source_uid": peer["uid"]}
            if params.get("cuda_ipc"):
                e["cuda_ipc"] = True
            out.append(e)
        return out

    def _prefill_after_failed_resume(self, slot_idx: int, waiting: _Waiting,
                                     first_token: int):
        """A rank of the group lost its shard pull: nothing was installed
        anywhere, so this request prefills here, prompt plus the emitted
        first token, its budget cut by one (the intake fallback's request,
        on the step thread)."""
        log.warning("kv shard pull failed on a rank; local prefill for %s",
                    waiting.context.id)
        self.disagg_fallbacks += 1
        req = dict(waiting.request)
        req["disagg"] = None
        req["token_ids"] = list(req["token_ids"]) + [first_token]
        stop = dict(req.get("stop_conditions") or {})
        if stop.get("max_tokens") is not None:
            stop["max_tokens"] = max(int(stop["max_tokens"]) - 1, 1)
        req["stop_conditions"] = stop
        waiting.request = req
        return self._prefill(slot_idx, waiting)

    def _export_and_finish(self, slot: _Slot, sp: SeqPages, token_ids: list[int],
                           tok: int, logprob_entry: dict | None = None) -> None:
        """Prefill-worker handoff: gather the prompt's pages into fresh
        blocks on the compute stream, export them (the transfer plane copies
        and stamps later, off this thread), release the pages, and end the
        stream with the first token and the kv_transfer_params. Under tp
        every rank exports its own KV heads (op ``kv_export``, before the
        pages go back) and the params list the shards."""
        t0 = time.perf_counter()
        params, kb, vb, timing = self.export_pages(sp.pages, len(token_ids))
        if self.kv_shards > 1:
            self._publish("kv_export", {"transfer_id": params["transfer_id"],
                                        "num_tokens": len(token_ids)},
                          {"page_ids": np.asarray(sp.pages, np.int32)})
            shards = self._shard_entries(params, kb, vb)
            self.transfer_source.shard(params["transfer_id"], shards,
                                       self._packed_blocks())
            params.update(shard_axis=2, shards=shards)
        # the decode side refuses a mismatched pool type before installing
        # (packed fp8 and bf16 blocks do not convert in insert_pages)
        params["kv_dtype"] = self.kv_dtype
        # the pages go back now: the gather precedes any later write to a
        # re-allocated page on the compute stream
        pages, sp.pages = sp.pages, []
        self.allocator.release(pages)
        self.export_times.append((timing, 1e3 * (time.perf_counter() - t0),
                                  kb.nbytes + vb.nbytes))
        item: dict[str, Any] = {"token_ids": [tok], "finish_reason": "length",
                                "kv_transfer_params": params}
        if logprob_entry is not None:
            # the decode handler relays this item to the client
            item["logprobs"] = [logprob_entry]
        self._post(slot.out_q, item)
        self._publish_metrics()

    def _resume_from_remote(self, slot_idx: int, waiting: _Waiting):
        """Decode-worker resume: install the pulled blocks beyond the cached
        prefix in place, seal the prompt, and enter decode after the remote
        first token. A multimodal resume seals its blocks under the image
        salt the prefill side hashed them with. Under SPMD every rank
        installs its heads (op ``kv_resume``); when a rank's shard pull
        failed, nothing is installed and the request prefills here
        (returns ``_prefill``'s result, else None)."""
        from dynamo_tpu_torch.parallel.spmd import RESUME_CHUNK_BYTES

        t0 = time.perf_counter()
        cfg = self.config
        req = waiting.request
        disagg = req.get("disagg") or {}
        kvp = dict(disagg.get("kv_transfer") or {})
        first_token = int(kvp.pop("first_token"))
        token_ids = list(req["token_ids"])
        max_tokens = self._decode_budget(req, len(token_ids))
        if max_tokens <= 1:
            # the remote first token was the whole budget
            if not self._drop_staged_kv(req):
                self._release_export(kvp)
            self._post(waiting.out_q, {"token_ids": [], "finish_reason": "length"})
            return None
        # pop: the handler holds the request dict for the whole decode; the
        # staged blocks must not outlive their install
        staged = disagg.pop("_staged_kv", None)
        if staged is None:
            # generate() stages every pull off this thread: no network I/O
            # may run on the step thread
            raise RuntimeError("disagg resume without a staged pull")
        k_blocks, v_blocks, ready, meta, mode = staged
        if int(meta.get("page_size", cfg.page_size)) != cfg.page_size:
            raise ValueError("page_size mismatch between prefill and decode")
        export_dtype = str(kvp.get("kv_dtype", "bf16"))
        if export_dtype != self.kv_dtype:
            raise ValueError(
                f"disagg kv_dtype mismatch: prefill exported {export_dtype} "
                f"KV but this decode worker runs kv_dtype={self.kv_dtype} "
                "(set DYN_KV_DTYPE / EngineConfig.kv_dtype identically on "
                "both sides)")
        # the sealed blocks hold IMAGE-conditioned KV: hashed under the image
        # salt (generate() decoded it), or identical placeholder ids would
        # alias across images
        mm_salt = waiting.mm["salt"] if waiting.mm else None
        seq = TokenBlockSequence.from_tokens(token_ids, cfg.page_size, salt=mm_salt)
        needed_pages = (len(token_ids) + cfg.page_size - 1) // cfg.page_size
        try:
            sp = self._acquire_prompt_pages(
                waiting.context.id, seq, needed_pages, len(token_ids),
                full_prefix_ok=True)
        except OutOfPages:
            self._refund_if_charged(waiting)
            self._error(waiting, "kv pages exhausted")
            return
        marks = [time.perf_counter()]
        install = list(range(sp.cached_prefix_pages, needed_pages))
        page_ids = [sp.pages[i] for i in install]
        first = install[0] if install else 0
        try:
            if mode == "local":
                if install:
                    self._insert_blocks(k_blocks, v_blocks, ready, page_ids, first)
                landed = True
            elif mode == "shard":
                self._publish("kv_resume", {"mode": mode, "first": first,
                                            "transfer_id": kvp["transfer_id"]},
                              {"page_ids": np.asarray(page_ids, np.int32)})
                landed = self.install_remote(mode, kvp, page_ids, first,
                                             staged=(k_blocks, v_blocks, ready))
            elif mode == "scatter":
                # the leader sends each rank its heads of the tail over the
                # group (no host copy of the whole on this thread)
                tail = (k_blocks[:, first:], v_blocks[:, first:])
                info = {"mode": mode, "first": 0, "transfer_id": kvp.get("transfer_id")}
                for name, b in zip("kv", tail):
                    part = self._heads_of(b, 0)
                    info[f"{name}_shape"] = list(part.shape)
                    info[f"{name}_dtype"] = str(part.dtype).removeprefix("torch.")
                self._publish("kv_resume", info,
                              {"page_ids": np.asarray(page_ids, np.int32)})
                landed = self.install_remote(mode, info, page_ids, 0,
                                             staged=(*tail, ready))
            else:
                # mirror links share no collective: the whole tail rides
                # the descriptors, RESUME_CHUNK_BYTES at most each, and
                # every rank installs its heads of each chunk
                if ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                tail = (k_blocks[:, first:], v_blocks[:, first:])
                per_page = max(1, (tail[0].nbytes + tail[1].nbytes) // max(len(page_ids), 1))
                step = max(1, RESUME_CHUNK_BYTES // per_page)
                for i in range(0, len(page_ids), step):
                    self._publish("kv_resume", {"mode": mode},
                                  {"page_ids": np.asarray(page_ids[i:i + step], np.int32),
                                   "k": block_numpy(tail[0][:, i:i + step].cpu()),
                                   "v": block_numpy(tail[1][:, i:i + step].cpu())})
                landed = self.install_remote(mode, {}, page_ids, first,
                                             inline=tail)
            if not landed:
                self.allocator.release(sp.pages)
                # a shard whose pull failed is still at its source
                self._release_export(kvp)
                return self._prefill_after_failed_resume(slot_idx, waiting, first_token)
            marks.append(time.perf_counter())
            self._seal_prompt_blocks(sp, seq)
            marks.append(time.perf_counter())
            self._drain_offload()
            marks.append(time.perf_counter())
        except Exception:
            self._pending_offload.clear()
            self.allocator.release(sp.pages)
            raise
        self.cached_prompt_tokens += sp.cached_prefix_pages * cfg.page_size
        slot = self._make_slot(
            waiting, seq, sp, seq_len=len(token_ids), remaining=max_tokens - 1,
            generated=1,  # the remote first token, emitted by the handler
            last_token=first_token)
        slot.seq.append(first_token)
        self._slots[slot_idx] = slot
        # the remote prefill made the first token: this is the request's
        # decode start on its flight timeline and spans
        FLIGHT.event(waiting.context.id, "disagg_resume")
        self._publish_metrics()
        marks.append(time.perf_counter())
        self.resumes += 1
        split = dict(zip(("acquire", "install", "seal", "drain", "slot"),
                         (1e3 * (b - a) for a, b in zip([t0, *marks], marks))))
        self.resume_times.append((1e3 * (marks[-1] - t0), len(install), split))

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
        with self._phase("spec.draft"):
            for i, slot in enumerate(self._slots):
                if slot is None or not self._spec_managed(slot):
                    continue
                if slot.context.is_stopped or covered[i]:
                    # stopped slots cancel through _build_batch; covered
                    # ones verify once their in-flight burst is processed
                    continue
                if cfg.max_context - slot.seq_len < 2:
                    continue  # no room to write even the fed token safely
                k_cap = min(slot.remaining - 1, cfg.max_context - slot.seq_len - 2,
                            cfg.spec_k_max)
                slot.spec.sync_from_seq(slot.seq)
                draft = [int(t) for t in slot.spec.propose(k_cap)] if k_cap > 0 else []
                masks = None
                if slot.guided is not None and slot.guided.constraining:
                    # guided x spec: the draft's grammar-legal prefix,
                    # walked on a scratch cursor, with the mask of every
                    # verify position; the real cursor advances only over
                    # emitted tokens, so a rejected tail needs no rollback
                    with self._phase("guided.lookahead"):
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
                with self._phase("spec.rollback"):
                    for _i, slot, _draft, base_pages, _masks in ready:
                        self.allocator.release(slot.pages.truncate(base_pages))
                        slot.spec.disable()
                        # the timeline says why the request went non-spec
                        FLIGHT.event(slot.context.id, "fault",
                                     site="engine.spec_verify")
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
        with self._phase("spec.verify"):
            self._publish("verify", None, {"tokens": tokens, "block_tables": bts,
                                           "start_pos": starts, "num_tokens": nts})
            targets = self._verify.dispatch(tokens, bts, starts, nts, allowed)
            self.dispatches += 1
            self._note_moe_dropped(self._verify.dropped)
            with self._phase("dispatch.d2h_wait"):
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
        FLIGHT.event(slot.context.id, "spec_verify", accepted=n_acc)
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
        with self._phase("spec.rollback"):
            keep = (slot.seq_len + self.config.page_size - 1) // self.config.page_size
            released = slot.pages.truncate(max(keep, 1))
            if released:
                self.allocator.release(released)
        self._maybe_seal(slot)
        self._drain_offload()
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
            if self._pipeline:
                with self._phase("flush"):
                    self._flush_pipeline()
        elif self.config.pipeline_decode:
            with self._phase("build_batch"):
                batch = self._build_batch(self._pipeline)
            if batch is None:
                if self._pipeline:
                    before = sum(s is not None for s in self._slots)
                    with self._phase("process"):
                        self._process_burst(self._pipeline.pop(0))
                    self._eager_readmit(before - sum(s is not None for s in self._slots))
                    return True
                return False
            with self._phase("dispatch"):
                pending = self._dispatch_burst(batch, chain=self._pipeline)
            self._pipeline.append(pending)
            if len(self._pipeline) > max(1, self.config.pipeline_depth):
                before = sum(s is not None for s in self._slots)
                with self._phase("process"):
                    self._process_burst(self._pipeline.pop(0))
                # freed slots refill now: their prefill dispatches behind
                # the in-flight burst and their first tokens feed the next
                self._eager_readmit(before - sum(s is not None for s in self._slots))
            return True
        with self._phase("build_batch"):
            batch = self._build_batch(None)
        if batch is None:
            return False
        before = sum(s is not None for s in self._slots)
        with self._phase("dispatch"):
            pending = self._dispatch_burst(batch, chain=None)
        with self._phase("process"):
            self._process_burst(pending)
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
            with self._phase("guided.mask"):
                allowed = np.ones((B, self.spec.vocab_size), bool)
                for i in range(B):
                    slot = self._slots[i]
                    if (active[i] and slot.guided is not None
                            and slot.guided.constraining):
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
        feed_ids: list[int] = []  # the chained bursts' ids (SPMD descriptors)
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
                feed_ids.append(prev["id"])
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
        self._burst_id += 1
        if self.spmd is not None:
            # admissions are synchronous under SPMD: every feed is a chained
            # burst, which each follower holds from its own replay
            if len(feed_ids) != len(feeds):
                raise RuntimeError("an admission wave's device feed under SPMD replay")
            self._publish("decode", {
                "id": self._burst_id, "chain": feed_ids, "n_steps": batch["n_burst"],
                "n_lp": batch["n_lp"], "sampled": sampled,
            }, {**{f"in_{k}": v for k, v in inputs.items()},
                "feed_src": feed_src, "feed_idx": feed_idx})
        t0 = time.perf_counter()
        burst = self._graphs.dispatch(
            inputs, batch["n_burst"], sampled=sampled, n_logprobs=batch["n_lp"],
            feeds=feeds, feed_src=feed_src, feed_idx=feed_idx,
            allowed=batch["allowed"])
        self.dispatches += 1
        self.steps += batch["n_burst"]
        return {"batch": batch, "burst": burst, "t0": t0, "resumes": self.resumes,
                "id": self._burst_id}

    def _process_burst(self, pending: dict) -> None:
        """Take a dispatched burst's tokens to the host; land the first
        tokens its fed column carries; apply stop rules, seal pages, stream
        items (with logprob entries when asked), finish slots. Participant
        request ids guard against a slot finished and reused since the
        dispatch."""
        batch = pending["batch"]
        with self._phase("process.d2h_sync"), self._phase("dispatch.d2h_wait"):
            fed_col, sampled, lp, top_i, top_v = pending["burst"].result()
        t1 = time.perf_counter()
        self.decode_step_times.append(t1 - pending["t0"])
        self.decode_spans.append((pending["t0"], t1, self.resumes != pending["resumes"]))
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
        # phase 1: per-slot emit counts, cache state, seals, then the offload
        # drain; all before any finish releases a page (a neighbour's
        # finish could free, and a later alloc re-use, a just-sealed page)
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
        self._drain_offload()
        if burst:
            # telemetry feed: the tokens this dispatch landed over all its
            # slots (stops cut bursts short)
            self.burst_fills.append(sum(len(t) for t, _f in burst.values()))
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
        """Seal pages whose block just completed into the prefix cache (and
        queue them for offload)."""
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
                self._queue_offload(blk.sequence_hash, slot.pages.pages[i], i)

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
