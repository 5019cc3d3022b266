"""Worker selection: cost model + sampling (ref lib/llm/src/kv_router/scheduler.rs;
a copy of dynamo_tpu/kv_router/scheduler.py).

Default cost per worker (scheduler.rs:494-539):

    potential_prefill_blocks = request_blocks - overlap_blocks(worker)
    decode_blocks            = worker's active blocks (published + predicted)
    logit = overlap_weight * potential_prefill_blocks + decode_blocks

Lower is better. With temperature 0 the argmin wins (ties broken by fewest
waiting requests, then lowest worker id for determinism); otherwise workers
are softmax-sampled over ``-logit / temperature``, which spreads load when
costs are close.

Two selection paths share that cost model:

- ``DefaultWorkerSelector`` — the reference O(instances) scan, kept behind
  the ``WorkerSelector`` protocol as the ORACLE: every pick walks every
  worker. At fleet scale this scan IS the pick.
- the scheduler's INCREMENTAL path (default) — ``KvScheduler`` maintains a
  load-ordered index (lazy-deletion min-heap keyed on the decode-load term,
  updated on ``update_metrics``/``set_predicted_load``, NOT per pick), so a
  pick computes logits over only the sparse overlap-scored workers (those
  actually holding the request's prefix) plus the ``candidate_k``
  lowest-load workers. Bit-identical to the oracle at temperature 0 (the
  heap orders by (load, worker_id), so its head dominates every
  non-candidate in the argmin's (cost, id) tie-break order); temperature>0
  softmax-samples over the same candidate set — power-of-k-choices
  (``candidate_k=2`` is classic power-of-two) whose distribution matches
  the full softmax wherever the excluded tail carries negligible mass.
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass
from typing import Mapping, Protocol, Sequence

from dynamo_tpu_torch.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics, RouterConfig

__all__ = ["WorkerSelector", "DefaultWorkerSelector", "KvScheduler", "softmax_sample"]


def softmax_sample(
    logits: Mapping[int, float],
    temperature: float,
    rng: random.Random | None = None,
) -> int:
    """Pick a worker id by softmax over negated costs (ref scheduler.rs:389).

    ``logits`` are COSTS (lower = better). temperature<=0 => deterministic
    argmin with stable tie-breaking on worker id.
    """
    if not logits:
        raise ValueError("no workers to sample from")
    if temperature <= 0.0:
        return min(logits.items(), key=lambda kv: (kv[1], kv[0]))[0]
    if len(logits) == 1:
        # single candidate: the draw is a foregone conclusion — skip the
        # exp/normalize loop entirely (hot for sparse candidate sets)
        return next(iter(logits))
    rng = rng or random
    # NOTE: no sort — ordering only matters for the deterministic
    # temperature-0 tie-break, which min() above already handles; the
    # sampled distribution is iteration-order-independent.
    items = list(logits.items())
    inv = 1.0 / temperature
    mn = min(cost for _, cost in items)
    weights = [math.exp((mn - cost) * inv) for _, cost in items]
    total = sum(weights)
    r = rng.random() * total
    acc = 0.0
    for (wid, _), w in zip(items, weights):
        acc += w
        if r <= acc:
            return wid
    return items[-1][0]


@dataclass
class WorkerState:
    """Scheduler's view of one worker = published metrics + local predictions."""

    worker_id: int
    metrics: ForwardPassMetrics
    predicted_active_blocks: int = 0  # from ActiveSequences tracking
    predicted_prefill_tokens: int = 0


class WorkerSelector(Protocol):
    """Pluggable selection policy (ref kv_router.rs:74)."""

    def select(
        self,
        workers: Sequence[WorkerState],
        request_blocks: int,
        overlaps: OverlapScores,
        config: RouterConfig,
    ) -> tuple[int, int]:  # pragma: no cover - protocol
        """Returns (worker_id, overlap_blocks_on_that_worker)."""
        ...


def _decode_load(state: WorkerState) -> float:
    """The overlap-independent cost term: decode blocks (published or
    predicted, whichever is larger) plus the waiting-queue penalty. This
    is what the incremental path's load index is keyed on — it changes
    only on metrics/prediction updates, never per pick."""
    m = state.metrics
    decode_blocks = m.active_kv_blocks
    if state.predicted_active_blocks > decode_blocks:
        decode_blocks = state.predicted_active_blocks
    return decode_blocks + 0.5 * m.waiting_requests


class DefaultWorkerSelector:
    """The reference cost function (scheduler.rs:461 DefaultWorkerSelector).

    Kept as the ORACLE: an O(instances) full-fleet scan per pick, exactly
    the reference semantics. The scheduler's incremental path is golden-
    tested against this class (bit-identical winner at temperature 0)."""

    def __init__(self, rng: random.Random | None = None):
        self.rng = rng or random.Random()
        self.last_logits: dict[int, float] = {}  # observability

    def select(
        self,
        workers: Sequence[WorkerState],
        request_blocks: int,
        overlaps: OverlapScores,
        config: RouterConfig,
    ) -> tuple[int, int]:
        # This loop runs once per pick over EVERY worker: at fleet scale
        # it IS the pick, so locals are hoisted and the two per-worker
        # max() builtins inlined (identical logits).
        logits: dict[int, float] = {}
        scores = overlaps.scores
        ow = config.overlap_weight
        for w in workers:
            m = w.metrics
            prefill_blocks = request_blocks - scores.get(w.worker_id, 0)
            if prefill_blocks < 0:
                prefill_blocks = 0
            # normalize decode load to blocks of this request's size domain
            decode_blocks = m.active_kv_blocks
            if w.predicted_active_blocks > decode_blocks:
                decode_blocks = w.predicted_active_blocks
            logits[w.worker_id] = (
                ow * prefill_blocks
                + decode_blocks
                + 0.5 * m.waiting_requests
            )
        self.last_logits = logits
        wid = softmax_sample(logits, config.temperature, self.rng)
        return wid, scores.get(wid, 0)


class KvScheduler:
    """Maintains WorkerStates from published metrics; applies selection.

    With no explicit ``selector`` the INCREMENTAL path runs: a
    lazy-deletion min-heap over ``(decode_load, worker_id)`` — maintained
    on state updates, consulted (never rebuilt) per pick — supplies the
    ``candidate_k`` lowest-load workers, which together with the sparse
    overlap-scored set form the candidate pool the cost model is
    evaluated over. Passing a selector (e.g. ``DefaultWorkerSelector``)
    restores the full-fleet oracle scan behind the ``WorkerSelector``
    protocol; every such scan is counted in ``full_pick_scans`` so the
    zero-full-scan CI guard can assert the fast path stayed fast."""

    def __init__(
        self,
        config: RouterConfig | None = None,
        selector: WorkerSelector | None = None,
    ):
        self.config = config or RouterConfig()
        self.selector = selector  # None => incremental fast path
        self.rng = getattr(selector, "rng", None) or random.Random()
        self._states: dict[int, WorkerState] = {}
        # load-ordered index: lazy-deletion heap of (load, worker_id).
        # _load_of holds each worker's CURRENT key; heap entries whose
        # key disagrees are stale and skipped (and discarded) on peek.
        self._load_heap: list[tuple[float, int]] = []
        self._load_of: dict[int, float] = {}
        # full-fleet scans actually paid at pick time (oracle selector
        # path). The incremental path never bumps this — the tier-1
        # micro-benchmark counter-asserts it stays 0 in steady state.
        self.full_pick_scans = 0
        # bumped whenever a NEW worker state appears (a metrics event
        # from a worker we don't track — possibly a dead one's replayed
        # tail). KvPushRouter keys its membership-reconcile memo on this
        # so a resurrected stale state is re-pruned on the next request
        # instead of silently re-entering the candidate set.
        self.states_version = 0

    # -- load index maintenance (update-time, never per pick) ---------------

    def _reindex(self, state: WorkerState) -> None:
        key = _decode_load(state)
        if self._load_of.get(state.worker_id) == key:
            return  # unchanged load: no heap churn
        self._load_of[state.worker_id] = key
        heapq.heappush(self._load_heap, (key, state.worker_id))
        # bound stale-entry buildup: churn-heavy metric streams would
        # otherwise grow the heap without limit between picks
        if len(self._load_heap) > 4 * len(self._load_of) + 64:
            self._load_heap = [
                (k, wid) for wid, k in self._load_of.items()
            ]
            heapq.heapify(self._load_heap)

    def _drop_index(self, worker_id: int) -> None:
        self._load_of.pop(worker_id, None)  # heap entries expire lazily

    def _lowest_load(
        self, k: int, skip: "set[int] | None" = None
    ) -> list[WorkerState]:
        """Up to ``k`` distinct live workers in (load, worker_id) order.
        Stale heap entries hit along the way are discarded permanently —
        including DUPLICATE live entries: a load that returns to an
        earlier value (A -> B -> A) leaves two entries passing the
        key check, and without dedup they would eat candidate slots and
        thin the power-of-k sampling pool. Live entries are pushed back,
        so the amortized cost is O(k log n) plus one log n per stale or
        duplicate entry ever created."""
        out: list[WorkerState] = []
        keep: list[tuple[float, int]] = []
        seen: set[int] = set()
        heap = self._load_heap
        load_of = self._load_of
        while heap and len(out) < k:
            key, wid = heapq.heappop(heap)
            if load_of.get(wid) != key or wid in seen:
                continue  # stale, removed, or a duplicate live entry
            seen.add(wid)
            keep.append((key, wid))
            if skip is not None and wid in skip:
                continue
            state = self._states.get(wid)
            if state is not None:
                out.append(state)
        for entry in keep:
            heapq.heappush(heap, entry)
        return out

    # -- state updates -------------------------------------------------------

    def update_metrics(self, metrics: ForwardPassMetrics) -> None:
        state = self._states.get(metrics.worker_id)
        if state is None:
            state = WorkerState(metrics.worker_id, metrics)
            self._states[metrics.worker_id] = state
            self.states_version += 1
        else:
            state.metrics = metrics
        self._reindex(state)

    def update_workers(self, worker_ids: Sequence[int]) -> None:
        """Reconcile with live instance set (lease-expiry removal)."""
        live = set(worker_ids)
        for wid in list(self._states):
            if wid not in live:
                del self._states[wid]
                self._drop_index(wid)
        for wid in live:
            if wid not in self._states:
                state = WorkerState(wid, ForwardPassMetrics(worker_id=wid))
                self._states[wid] = state
                self._reindex(state)

    def set_predicted_load(self, worker_id: int, active_blocks: int, prefill_tokens: int) -> None:
        state = self._states.get(worker_id)
        if state is not None:
            state.predicted_active_blocks = active_blocks
            state.predicted_prefill_tokens = prefill_tokens
            self._reindex(state)

    def workers(self) -> list[WorkerState]:
        return list(self._states.values())

    # -- the pick ------------------------------------------------------------

    def schedule(
        self, request_blocks: int, overlaps: OverlapScores,
        *, exclude: "set[int] | None" = None,
    ) -> tuple[int, int]:
        """Pick (worker_id, overlap_blocks); raises if no workers known.

        ``exclude`` (circuit-breaker ejections) narrows the candidate
        set — unless it would empty it, in which case every worker
        stays eligible (fail open rather than blackhole)."""
        if not self._states:
            raise LookupError("no workers registered with scheduler")
        if exclude:
            # fail-open check without walking the fleet: exclusion is
            # honored only if at least one worker survives it
            known = sum(1 for wid in exclude if wid in self._states)
            if known >= len(self._states):
                exclude = None
        if self.selector is not None:
            # oracle path: the reference full-fleet scan (counted — the
            # CI guard asserts the default path never takes it)
            workers = self.workers()
            if exclude:
                workers = [w for w in workers if w.worker_id not in exclude]
            self.full_pick_scans += 1
            return self.selector.select(
                workers, request_blocks, overlaps, self.config
            )
        return self._schedule_incremental(request_blocks, overlaps, exclude)

    def _schedule_incremental(
        self, request_blocks: int, overlaps: OverlapScores,
        exclude: "set[int] | None",
    ) -> tuple[int, int]:
        cfg = self.config
        ow = cfg.overlap_weight
        scores = overlaps.scores
        states = self._states
        logits: dict[int, float] = {}
        # sparse half: workers actually holding the request's prefix
        for wid, overlap in scores.items():
            if exclude is not None and wid in exclude:
                continue
            state = states.get(wid)
            if state is None:
                continue  # radix knows a worker the scheduler doesn't yet
            prefill_blocks = request_blocks - overlap
            if prefill_blocks < 0:
                prefill_blocks = 0
            logits[wid] = ow * prefill_blocks + _decode_load(state)
        # dense half, truncated: the candidate_k lowest-load workers.
        # At temperature 0 the head alone guarantees bit-identity with
        # the oracle (any non-candidate has zero overlap and load >= the
        # head's, i.e. cost >= head's cost with a losing id tie-break);
        # the extra k-1 feed the temperature>0 power-of-k-choices sample.
        k = cfg.candidate_k if cfg.candidate_k > 0 else 1
        for state in self._lowest_load(k, skip=exclude):
            wid = state.worker_id
            if wid not in logits:
                logits[wid] = ow * request_blocks + _decode_load(state)
        if not logits:
            raise LookupError("no workers registered with scheduler")
        self.last_logits = logits  # observability, mirrors the oracle
        wid = softmax_sample(logits, cfg.temperature, self.rng)
        return wid, scores.get(wid, 0)
