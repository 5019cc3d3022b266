"""InferenceEngine: continuous batching over the paged PyTorch model.

The counterpart of dynamo_tpu/engine/core.py, written for this package and
reduced to the serving core. One dedicated step THREAD owns the device:

  admit (FIFO, into free slots) -> packed prefill + first-token sample
        -> decode bursts over all active slots -> stream tokens

Prefix caching is page-granular and keyed by the sequence-hash chain of
tokens.py. Completed requests' sealed pages stay cached (evictable LRU).

``generate(request, context)`` is the AsyncEngine surface: it yields
``{"token_ids": [...]}`` deltas and ends with an item whose
``finish_reason`` is ``stop``, ``length``, ``cancelled`` or ``error``.
Request fields read: ``token_ids``; ``sampling`` (temperature, top_k, top_p,
seed); ``stop_conditions`` (max_tokens, ignore_eos, stop_token_ids,
min_tokens); ``eos_token_ids``.

Not in this engine yet (see ROADMAP): tenancy and quotas, preemption,
speculative and guided decoding, logprobs, chunked prefill (a prompt whose
uncached tail exceeds ``max_prefill_chunk_tokens`` finishes with an error),
pipelined decode and async admissions, KVBM and disagg, migration resume,
SPMD/meshes, multimodal, embeddings, telemetry, faults and tracing.
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
from dynamo_tpu_torch.engine.sampling import sample_tokens
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


@dataclass
class _Waiting:
    request: dict[str, Any]
    context: Context
    out_q: asyncio.Queue
    page_stalls: int = 0  # admission passes bounced on OutOfPages


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
        self.device = resolve_device(device)
        self.fam = get_family(spec)
        if params is None:
            params = self.fam.init_params(spec, self.config.seed, device=self.device)
        self.params = params
        # +1 page: index 0 is the trash page. kv_dtype "fp8" makes both
        # pools QuantPools (ops/quant.py): e4m3 values + bf16 scales
        self.kv_dtype = self.config.kv_dtype
        self.k_pages, self.v_pages = self.fam.init_cache(
            spec, self.config.num_pages + 1, self.config.page_size,
            device=self.device, kv_dtype=self.kv_dtype,
        )
        # device bytes of both pools (values and, for fp8, scales)
        self.pool_bytes = sum(p.nbytes for p in (self.k_pages, self.v_pages))
        log.info("KV pools: kv_dtype %s, %d pages of %d tokens, %.3f GB",
                 self.kv_dtype, self.config.num_pages + 1,
                 self.config.page_size, self.pool_bytes / 1e9)
        self.allocator = PageAllocator(
            self.config.num_pages + 1, self.config.page_size
        )
        self._slots: list[_Slot | None] = [None] * self.config.max_decode_slots
        # FIFO admission queue: the event loop appends, only the step
        # thread pops (deque ends are thread-safe)
        self._waiting: collections.deque[_Waiting] = collections.deque()
        self._seed_counter = self.config.seed
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: int | None = None
        self._wake = threading.Event()
        self._closed = False
        self.steps = 0  # decode model steps dispatched
        self.cached_prompt_tokens = 0  # prompt tokens served from the prefix cache
        # wall seconds per decode dispatch, host clock around work that
        # ends in the sampled tokens' copy to the host
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
                    if not self._waiting and not any(self._slots):
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
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._finish(i, slot, "error", error=error)
        while self._waiting:
            w = self._waiting.popleft()
            self._post(w.out_q, {"token_ids": [], "finish_reason": "error",
                                 "error": error})

    def _step(self) -> bool:
        did = self._admit_phase()
        if any(s is not None for s in self._slots):
            did |= self._decode_step()
        return did

    def _admit_phase(self) -> bool:
        """Admit waiting requests FIFO into free slots, up to a per-step
        prompt-token budget while other streams decode (a queue of short
        prompts lands in one step; a long one waits a step rather than
        stalling running decodes). On a cold batch, admit at most half the
        slots per step: staggered cohorts keep closed-loop clients from
        locking into one convoy. Returns True when any entry was handled."""
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
        while self._waiting:
            free_idx = next(
                (i for i, s in enumerate(self._slots)
                 if s is None and i not in reserved),
                None,
            )
            if free_idx is None:
                break
            head = self._waiting[0]
            cost = min(len(head.request.get("token_ids") or ()) or 1,
                       cfg.max_prefill_chunk_tokens)
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

    def _error(self, waiting: _Waiting, msg: str) -> None:
        self._post(waiting.out_q,
                   {"token_ids": [], "finish_reason": "error", "error": msg})

    def _prefill_safe(self, slot_idx: int, waiting: _Waiting):
        """Per-request error isolation: a bad request must not kill the
        loop. Returns a prep dict (forward deferred to the packed prefill),
        ``_REQUEUED`` (page backpressure) or None (handled: error)."""
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
        tail = len(token_ids) - start_pos
        if tail > min(cfg.max_prefill_chunk_tokens, cfg.prefill_buckets[-1]):
            self.allocator.release(sp.pages)
            self._error(
                waiting,
                f"prompt's uncached tail of {tail} tokens exceeds "
                f"max_prefill_chunk_tokens={cfg.max_prefill_chunk_tokens}; "
                "chunked prefill is not in this engine yet",
            )
            return None
        self.cached_prompt_tokens += start_pos
        return {
            "slot_idx": slot_idx, "waiting": waiting, "seq": seq, "sp": sp,
            "token_ids": token_ids,
            "max_tokens": self._decode_budget(req, len(token_ids)),
            "start_pos": start_pos, "tail": tail,
        }

    def _run_packed_prefills(self, preps: list[dict]) -> list[tuple]:
        """Same-bucket prompts batch into one prefill_forward_batch of up
        to ``prefill_pack_size`` rows; singletons take the single-prompt
        forward. Groups are not padded to the pack size: PyTorch runs
        eagerly, so a new row count costs no compile. Seals each prompt's
        complete blocks into the prefix cache. Returns (prep, logits [V])
        records for _complete_admissions."""
        cfg = self.config
        groups: dict[int, list[dict]] = {}
        for p in preps:
            groups.setdefault(cfg.bucket_for(p["tail"]), []).append(p)
        pack = max(1, cfg.prefill_pack_size)
        records: list[tuple] = []
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
                for j, p in enumerate(chunk):
                    self._seal_prompt_blocks(p["sp"], p["seq"])
                    records.append((p, logits[j]))
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
        logits = self.fam.prefill_batch(
            self.spec, self.params, tok_d, bts_d, torch.from_numpy(starts),
            self.k_pages, self.v_pages, torch.from_numpy(nts),
        )
        return logits

    def _seal_prompt_blocks(self, sp: SeqPages, seq: TokenBlockSequence) -> None:
        """Seal the prompt's complete, newly computed blocks into the
        prefix cache."""
        for i in range(sp.cached_prefix_pages, len(seq.blocks)):
            blk = seq.blocks[i]
            self.allocator.seal_page(
                sp.pages[i], blk.sequence_hash, blk.parent_sequence_hash
            )
            sp.hashes[i] = blk.sequence_hash

    def _make_slot(self, p: dict) -> _Slot:
        req = p["waiting"].request
        sampling = req.get("sampling") or {}
        stop = req.get("stop_conditions") or {}
        self._seed_counter += 1
        return _Slot(
            request_id=p["waiting"].context.id,
            context=p["waiting"].context,
            out_q=p["waiting"].out_q,
            seq=p["seq"],
            pages=p["sp"],
            seq_len=len(p["token_ids"]),
            remaining=p["max_tokens"],
            temperature=float(self._opt(sampling, "temperature", 0.0)),
            top_k=int(self._opt(sampling, "top_k", 0)),
            top_p=float(self._opt(sampling, "top_p", 1.0)),
            ignore_eos=bool(stop.get("ignore_eos", False)),
            stop_token_ids=frozenset(stop.get("stop_token_ids") or ()),
            eos_ids=frozenset(req.get("eos_token_ids") or (2,)),
            min_tokens=int(self._opt(stop, "min_tokens", 0)),
            last_token=p["token_ids"][-1],
            sample_seed=int(self._opt(sampling, "seed", self._seed_counter))
            & 0xFFFFFFFF,
        )

    def _complete_admissions(self, records: list[tuple]) -> None:
        """Sample every admitted prompt's first token in ONE call (one
        device->host copy per admission round), then emit it."""
        if not records:
            return
        slots = [self._make_slot(p) for p, _ in records]
        try:
            logits = torch.stack([row for _, row in records])
            toks = sample_tokens(
                logits,
                torch.tensor([s.temperature for s in slots]),
                torch.tensor([s.top_k for s in slots]),
                torch.tensor([s.top_p for s in slots]),
                torch.tensor([s.sample_seed for s in slots]),
                torch.zeros(len(slots), dtype=torch.int64),  # RNG step 0
            ).tolist()
        except Exception as e:  # noqa: BLE001
            log.exception("first-token sampling failed")
            for (p, _), slot in zip(records, slots):
                self.allocator.release(slot.pages.pages)
                slot.pages.pages = []
                self._error(p["waiting"], f"prefill failed: {e}")
            return
        for (p, _), slot, tok in zip(records, slots, toks):
            self._emit_first_token(p["slot_idx"], slot, int(tok))

    def _emit_first_token(self, slot_idx: int, slot: _Slot, tok: int) -> None:
        """Record + stream the first token; place the slot or finish."""
        finish = self._accept_token(slot, tok)
        if finish is not None:
            # release BEFORE posting the finish item, so a client seeing
            # the end of its stream sees the pages freed
            self._finish(slot_idx, slot, finish, emit=False)
        else:
            self._slots[slot_idx] = slot
        self._post(slot.out_q, {"token_ids": [tok], "finish_reason": finish})

    # -- decode ------------------------------------------------------------

    def _decode_step(self) -> bool:
        """One decode dispatch of ``decode_steps_per_dispatch`` model steps
        with sampling, then stop rules and streaming. Tokens sampled past a
        mid-burst stop are discarded; their cache writes land in pages the
        finished slot releases. Returns False when nothing could be built
        (every live slot page-stalled), so the loop paces on the idle
        wait instead of spinning."""
        batch = self._build_batch()
        if batch is None:
            return False
        t0 = time.perf_counter()
        dev = self.device
        sampled = self.fam.decode_steps(
            self.spec, self.params,
            torch.from_numpy(batch["tokens"]).to(dev),
            torch.from_numpy(batch["block_tables"]).to(dev),
            torch.from_numpy(batch["seq_lens"]).to(dev),
            self.k_pages, self.v_pages,
            torch.from_numpy(batch["active"]).to(dev),
            torch.from_numpy(batch["temps"]),
            torch.from_numpy(batch["topk"]),
            torch.from_numpy(batch["topp"]),
            torch.from_numpy(batch["seeds"]),
            torch.from_numpy(batch["steps"]),
            n_steps=batch["n_burst"],
        )
        host = sampled.cpu().numpy()
        self.decode_step_times.append(time.perf_counter() - t0)
        self.steps += batch["n_burst"]
        self._process_burst(batch, host)
        return True

    def _build_batch(self) -> dict | None:
        """Host arrays for the next burst; finishes cancelled slots and
        extends each active slot's pages to cover the burst."""
        cfg = self.config
        B = len(self._slots)
        tokens = np.zeros((B,), np.int32)
        block_tables = np.zeros((B, cfg.max_pages_per_seq), np.int32)
        seq_lens = np.ones((B,), np.int32)
        active = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        topk = np.zeros((B,), np.int32)
        topp = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int64)
        steps = np.zeros((B,), np.int64)

        n_burst = cfg.decode_steps_per_dispatch
        n_active = sum(s is not None for s in self._slots)
        if (cfg.decode_steps_admit_pending and self._waiting
                and n_active * 2 < len(self._slots)):
            # ramp-up: short bursts get the next admission wave in sooner
            n_burst = max(1, min(n_burst, cfg.decode_steps_admit_pending))
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.context.is_stopped:
                self._finish(i, slot, "cancelled")
                continue
            # an overshooting position would index past the table
            n_burst = max(1, min(n_burst, cfg.max_context - slot.seq_len))

        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            # pages for every token this burst will EMIT (overshoot beyond
            # ``remaining`` lands on the trash page via the zero table tail)
            need = min(slot.remaining, n_burst)
            last_page = (slot.seq_len + need - 1) // cfg.page_size
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
            tokens[i] = slot.last_token
            block_tables[i, : slot.pages.num_pages] = slot.pages.pages
            seq_lens[i] = slot.seq_len + 1  # including the new token
            temps[i] = slot.temperature
            topk[i] = slot.top_k
            topp[i] = slot.top_p
            seeds[i] = slot.sample_seed
            steps[i] = slot.generated
        if not active.any():
            return None
        return {
            "n_burst": n_burst, "active": active,
            "participants": {i: self._slots[i].request_id
                             for i in range(B) if active[i]},
            "tokens": tokens, "block_tables": block_tables,
            "seq_lens": seq_lens, "temps": temps, "topk": topk,
            "topp": topp, "seeds": seeds, "steps": steps,
        }

    def _process_burst(self, batch: dict, sampled: np.ndarray) -> None:
        """Apply stop rules to a burst's tokens, seal completed pages,
        stream items, finish slots."""
        n_burst = batch["n_burst"]
        burst: dict[int, tuple[list[int], str | None]] = {}
        for i, rid in batch["participants"].items():
            slot = self._slots[i]
            if slot is None or slot.request_id != rid:
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
        for i, (toks, finish) in burst.items():
            slot = self._slots[i]
            if finish is not None:
                self._finish(i, slot, finish, emit=False)
            self._post(slot.out_q, {"token_ids": toks, "finish_reason": finish})

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
