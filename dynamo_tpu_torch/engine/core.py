"""InferenceEngine: continuous batching over the paged PyTorch model.

The counterpart of dynamo_tpu/engine/core.py, written for this package and
reduced to the serving core. One dedicated step THREAD owns the device:

  admit (FIFO, into free slots) -> packed prefill + first-token sample
        -> decode bursts over all active slots -> stream tokens

Prefix caching is page-granular and keyed by the sequence-hash chain of
tokens.py. Completed requests' sealed pages stay cached (evictable LRU).

A prompt whose uncached tail exceeds ``max_prefill_chunk_tokens`` prefills
in chunks, one per step, interleaved with decode bursts (``_PartialPrefill``).
Decode bursts run through ``engine/graphs.DecodeGraphs``: on a CUDA device
every burst replays a captured step graph. With ``pipeline_decode`` up to
``pipeline_depth`` bursts are in flight, each fed on the device from the
previous ones' tokens. With ``async_admissions`` (the default) a prompt's
first token is sampled on the device right after its prefill, feeds the
next burst there, and lands on the host later, so the step thread never
waits for it.

``generate(request, context)`` is the AsyncEngine surface: it yields
``{"token_ids": [...]}`` deltas (plus ``"logprobs"`` entries when asked)
and ends with an item whose ``finish_reason`` is ``stop``, ``length``,
``cancelled`` or ``error``. Request fields read: ``token_ids``; ``sampling``
(temperature, top_k, top_p, seed); ``stop_conditions`` (max_tokens,
ignore_eos, stop_token_ids, min_tokens); ``eos_token_ids``;
``output_options.logprobs`` (the sampled token's logprob plus the top N,
N clamped to 20).

Not in this engine yet (see ROADMAP): tenancy and quotas, preemption,
speculative and guided decoding (a request marked ``guided`` is refused
with a typed ``invalid_request`` error item, as the reference engine with
guided decoding off does), KVBM and disagg, migration resume, SPMD/meshes,
multimodal, embeddings, telemetry, faults and tracing.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator

import numpy as np
import torch

from dynamo_tpu_torch.engine.cache import OutOfPages, PageAllocator, SeqPages
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.graphs import DecodeGraphs, HostCopy
from dynamo_tpu_torch.engine.sampling import (
    greedy_tokens,
    sample_tokens,
    token_logprobs,
)
from dynamo_tpu_torch.models.family import get_family
from dynamo_tpu_torch.models.llama import resolve_device
from dynamo_tpu_torch.runtime.context import Context, DeadlineExceeded
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.engine")

MAX_PAGE_STALLS = 2000  # admission passes / decode steps a request may wait for pages


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


@dataclass
class _Waiting:
    request: dict[str, Any]
    context: Context
    out_q: asyncio.Queue
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


_REQUEUED = object()  # _prefill sentinel: entry went back to the queue head


class InferenceEngine:
    def __init__(
        self,
        spec: ModelSpec,
        config: EngineConfig | None = None,
        *,
        params=None,
        device: str | torch.device | None = None,
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
        self.allocator = PageAllocator(cfg.num_pages + 1, cfg.page_size)
        self._slots: list[_Slot | None] = [None] * cfg.max_decode_slots
        # FIFO admission queue: the event loop appends, only the step
        # thread pops (deque ends are thread-safe)
        self._waiting: collections.deque[_Waiting] = collections.deque()
        self._seed_counter = cfg.seed
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: int | None = None
        self._wake = threading.Event()
        self._closed = False
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
        self._graphs = DecodeGraphs(
            self._graph_step, batch=len(self._slots),
            pages_per_seq=cfg.max_pages_per_seq,
            max_steps=max(1, cfg.decode_steps_per_dispatch),
            n_logprobs=self._n_lp, device=self.device,
        )
        self.steps = 0  # decode model steps dispatched
        self.cached_prompt_tokens = 0  # prompt tokens served from the prefix cache
        self.eager_readmits = 0  # admission passes that refilled a freed slot at once
        self.prefill_chunks = 0  # chunked-prefill chunks run
        # wall seconds per decode dispatch, host clock from the dispatch to
        # its sampled tokens on the host
        self.decode_step_times: collections.deque = collections.deque(maxlen=4096)

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

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            await asyncio.to_thread(self._thread.join, 10.0)
        if self._thread is None or not self._thread.is_alive():
            self.release_graphs()

    def precompile(self) -> None:
        """Capture every decode graph variant now, before traffic (the JAX
        engine's precompile()). Call before start() or while idle; a no-op
        on the CPU."""
        self._graphs.precompile()

    def release_graphs(self) -> None:
        """Drop the captured decode graphs. They hold raw pointers to the
        KV pools and the weights: call this before freeing either."""
        self._graphs.release()

    def request_clear_cache(self) -> None:
        """Admin: drop every inactive prefix-cache page (the HTTP
        clear_kv_blocks route). Honoured on the step thread, the
        allocator's owner, after the in-flight bursts land."""
        self._clear_cache_requested = True
        self._wake.set()

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        """AsyncEngine surface: stream token deltas for one request."""
        if self._closed:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": "engine closed"}
            return
        if context.deadline_expired:
            raise DeadlineExceeded(
                f"request {context.id} deadline passed before admission"
            )
        await self.start()
        token_ids = list(request.get("token_ids") or [])
        if not token_ids:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": "empty token_ids"}
            return
        if len(token_ids) >= self.config.max_context:
            yield {"token_ids": [], "finish_reason": "error",
                   "error": f"prompt exceeds max context {self.config.max_context}"}
            return
        if request.get("guided"):
            # no guided decoding here yet: refuse as the reference engine
            # does with guided_mode=off (a typed invalid_request -> HTTP 400)
            yield {"token_ids": [], "finish_reason": "error",
                   "error": "invalid_request: guided decoding unavailable on this "
                            "worker (guided_mode=off, multi-host SPMD, or no "
                            "tokenizer vocabulary)"}
            return
        out_q: asyncio.Queue = asyncio.Queue()
        self._waiting.append(_Waiting(request, context, out_q))
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
            yield item
            if item.get("finish_reason") is not None:
                return

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
                did_work = self._step()
                if not did_work:
                    self._wake.clear()
                    if (not self._waiting and not any(self._slots)
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
        while self._waiting:
            self._error(self._waiting.popleft(), error)

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
            did = True
        # advance an in-flight chunked prefill, or admit waiting requests
        # up to a per-step token budget; decode still runs below, so a
        # prefill steals at most a budget's (or a chunk's) worth of time
        if self._partial is not None:
            self._advance_partial_safe()
            did = True
        else:
            did |= self._admit_phase()
        if any(s is not None for s in self._slots):
            did |= self._decode_step()
        elif self._pipeline:
            # every participant finished early: drain stale bursts
            self._flush_pipeline()
            did = True
        return did

    def _admit_phase(self) -> bool:
        """Admit waiting requests FIFO into free slots, up to a per-step
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
        while self._partial is None and self._waiting:
            free_idx = next(
                (i for i, s in enumerate(self._slots)
                 if s is None and i not in reserved),
                None,
            )
            if free_idx is None:
                break
            head = self._waiting[0]
            cost = min(len(head.request.get("token_ids") or ()) or 1,
                       self._prefill_chunk_max())
            if n_admitted and cost > budget and decoding and not warm:
                break  # the first admission always proceeds
            if not decoding and n_admitted >= cold_cap:
                break
            waiting = self._waiting.popleft()
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
        if not self._waiting and cfg.readmit_wait_s > 0 and self._pipeline:
            self._wake.clear()
            self._wake.wait(cfg.readmit_wait_s)
        if self._waiting and self._admit_phase():
            self.eager_readmits += 1

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
        try:
            sp = self._acquire_prompt_pages(
                waiting.context.id, seq, needed_pages, len(token_ids)
            )
        except OutOfPages:
            # page BACKPRESSURE: a neighbour finishing frees pages, so the
            # entry waits at the queue head, with bounded patience; a prompt
            # that could never fit errors at once
            if needed_pages >= self.allocator.num_pages - 1:
                self._error(waiting, f"kv pages exhausted (prompt needs "
                                     f"{needed_pages} pages; pool can never hold it)")
                return None
            if waiting.page_stalls >= MAX_PAGE_STALLS:
                self._error(waiting, "kv pages exhausted (admission waited "
                                     f"{waiting.page_stalls} passes)")
                return None
            waiting.page_stalls += 1
            self._waiting.appendleft(waiting)
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
        return self.fam.prefill(
            self.spec, self.params, torch.from_numpy(padded).to(dev),
            torch.from_numpy(block_table).to(dev), start, self.k_pages,
            self.v_pages, len(new_tokens),
        )

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
        [len(group), V] on the device."""
        cfg = self.config
        nb = len(group)
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
            logits = self.fam.prefill(
                self.spec, self.params, tok_d[0], bts_d[0], int(starts[0]),
                self.k_pages, self.v_pages, int(nts[0]),
            )
            return logits[None]
        return self.fam.prefill_batch(
            self.spec, self.params, tok_d, bts_d, torch.from_numpy(starts),
            self.k_pages, self.v_pages, torch.from_numpy(nts),
        )

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
        return _Slot(
            request_id=waiting.context.id,
            context=waiting.context,
            out_q=waiting.out_q,
            seq=seq,
            pages=sp,
            seq_len=seq_len,
            remaining=remaining,
            temperature=float(self._opt(sampling, "temperature", 0.0)),
            top_k=int(self._opt(sampling, "top_k", 0)),
            top_p=float(self._opt(sampling, "top_p", 1.0)),
            ignore_eos=bool(stop.get("ignore_eos", False)),
            stop_token_ids=frozenset(stop.get("stop_token_ids") or ()),
            eos_ids=frozenset(req.get("eos_token_ids") or (2,)),
            min_tokens=int(self._opt(stop, "min_tokens", 0)),
            generated=generated,
            last_token=last_token,
            sample_seed=sample_seed,
            logprobs=self._clamp_logprobs(
                (req.get("output_options") or {}).get("logprobs")),
        )

    @staticmethod
    def _sample(logits: torch.Tensor, temps, topk, topp, seeds) -> torch.Tensor:
        """First tokens [n] on the device (RNG step 0): the argmax for an
        all-greedy batch, the full sampler otherwise (decided on the host
        from its own arrays)."""
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

    def _sample_slots(self, logits: torch.Tensor, slots: list[_Slot]) -> torch.Tensor:
        return self._sample(logits, [s.temperature for s in slots],
                            [s.top_k for s in slots], [s.top_p for s in slots],
                            [s.sample_seed for s in slots])

    def _needs_sync_admission(self, req: dict) -> bool:
        """True when the admission must read its first token and logits on
        the host at once (logprob entries)."""
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
            sampled = self._sample_slots(stacked, slots)
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

    def _materialize_waves(self) -> bool:
        """Land admission waves whose host copy is in. A wave whose pending
        slots are all covered by an in-flight burst is left to that burst's
        processing, which lands its tokens from the burst's own download;
        an aged wave that no burst covers lands from its own copy."""
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
            if ap["copy"].ready() or (ap["age"] >= 2 and not in_burst):
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

        Returns False when nothing could be built (every live slot
        page-stalled), so the loop paces on the idle wait."""
        if self.config.pipeline_decode:
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
        if (cfg.decode_steps_admit_pending and self._waiting
                and n_active * 2 < len(self._slots)):
            # ramp-up: short bursts get the next admission wave in sooner
            n_burst = max(1, min(n_burst, cfg.decode_steps_admit_pending))
        for i, slot in enumerate(self._slots):
            if slot is not None and not slot.context.is_stopped:
                # an overshooting position would index past the table
                n_burst = max(1, min(n_burst, cfg.max_context - slot.seq_len
                                     - int(extra[i])))

        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.context.is_stopped:
                if not pending:
                    self._finish(i, slot, "cancelled")
                # pipelined: _step flushes before cancels; the next step
                # finishes the slot
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
        return {
            "n_burst": n_burst, "n_lp": self._n_lp if wants_lp else 0,
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
            feeds=feeds, feed_src=feed_src, feed_idx=feed_idx)
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

    def _accept_token(self, slot: _Slot, tok: int) -> str | None:
        """Record one sampled token on the slot; return its finish reason
        (None = keep decoding). The single source of stop semantics for the
        prefill first token and decode bursts."""
        slot.seq.append(tok)
        slot.generated += 1
        slot.remaining -= 1
        slot.last_token = tok
        if (not slot.ignore_eos and tok in slot.eos_ids
                and slot.generated >= slot.min_tokens):
            return "stop"
        if tok in slot.stop_token_ids and slot.generated >= slot.min_tokens:
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
        # release BEFORE posting the finish item, so a client seeing the
        # end of its stream sees the pages freed
        pages, slot.pages.pages = slot.pages.pages, []
        self.allocator.release(pages)
        self._slots[slot_idx] = None
        if emit:
            item: dict[str, Any] = {"token_ids": [], "finish_reason": reason}
            if error:
                item["error"] = error
            self._post(slot.out_q, item)
