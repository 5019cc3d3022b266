"""Active-sequence tracking: the router's local view of in-flight load (a
copy of dynamo_tpu/kv_router/sequence.py).

Published worker metrics lag (they arrive per forward pass); the router
corrects for its own just-routed requests by tracking the blocks + prefill
tokens it has sent each worker until the request completes or force-expires.
Ref: lib/llm/src/kv_router/sequence.rs (ActiveSequences :54,
ActiveSequencesMultiWorker :282).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["ActiveSequences", "ActiveSequencesMultiWorker"]


@dataclass
class _ActiveSeq:
    request_id: str
    blocks: int
    prefill_tokens: int
    started: float
    expires: float


@dataclass
class ActiveSequences:
    """Per-worker tracker of requests the router has dispatched.

    Totals are maintained incrementally: ``load_of`` feeds every pick's
    prediction (per candidate, per lifecycle event), so recomputing
    ``sum()`` over the in-flight set there made prediction cost grow
    with backlog depth — the deeper the queue, the slower every pick.
    """

    force_expiry_s: float = 600.0
    _seqs: dict[str, _ActiveSeq] = field(default_factory=dict)
    _blocks_total: int = 0
    _prefill_total: int = 0
    # earliest force-expiry among tracked seqs; expire() is a no-op int
    # compare until the clock passes it. May go stale (point at a seq
    # already removed) — that only costs one extra scan, never a miss.
    _soonest_expiry: float = float("inf")

    def add(self, request_id: str, blocks: int, prefill_tokens: int) -> None:
        now = time.monotonic()
        old = self._seqs.get(request_id)
        if old is not None:  # re-add replaces: back out the old totals
            self._blocks_total -= old.blocks
            self._prefill_total -= old.prefill_tokens
        expires = now + self.force_expiry_s
        self._seqs[request_id] = _ActiveSeq(
            request_id, blocks, prefill_tokens, now, expires
        )
        self._blocks_total += blocks
        self._prefill_total += prefill_tokens
        if expires < self._soonest_expiry:
            self._soonest_expiry = expires

    def mark_prefill_done(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq is not None:
            self._prefill_total -= seq.prefill_tokens
            seq.prefill_tokens = 0

    def add_decode_block(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq is not None:
            seq.blocks += 1
            self._blocks_total += 1

    def remove(self, request_id: str) -> None:
        seq = self._seqs.pop(request_id, None)
        if seq is not None:
            self._blocks_total -= seq.blocks
            self._prefill_total -= seq.prefill_tokens

    def expire(self) -> None:
        now = time.monotonic()
        if now < self._soonest_expiry:
            return
        for rid in [r for r, s in self._seqs.items() if s.expires <= now]:
            self.remove(rid)
        self._soonest_expiry = min(
            (s.expires for s in self._seqs.values()), default=float("inf")
        )

    @property
    def active_blocks(self) -> int:
        return self._blocks_total

    @property
    def prefill_tokens(self) -> int:
        return self._prefill_total

    @property
    def num_requests(self) -> int:
        return len(self._seqs)


class ActiveSequencesMultiWorker:
    """Router-side map worker_id -> ActiveSequences."""

    def __init__(self, force_expiry_s: float = 600.0):
        self.force_expiry_s = force_expiry_s
        self._workers: dict[int, ActiveSequences] = {}
        self._request_worker: dict[str, int] = {}

    def update_workers(self, worker_ids) -> None:
        live = set(worker_ids)
        for wid in list(self._workers):
            if wid not in live:
                del self._workers[wid]
        for wid in live:
            self._workers.setdefault(wid, ActiveSequences(self.force_expiry_s))

    def add_request(
        self, request_id: str, worker_id: int, blocks: int, prefill_tokens: int
    ) -> None:
        self._workers.setdefault(
            worker_id, ActiveSequences(self.force_expiry_s)
        ).add(request_id, blocks, prefill_tokens)
        self._request_worker[request_id] = worker_id

    def mark_prefill_done(self, request_id: str) -> None:
        wid = self._request_worker.get(request_id)
        if wid is not None and wid in self._workers:
            self._workers[wid].mark_prefill_done(request_id)

    def free(self, request_id: str) -> None:
        wid = self._request_worker.pop(request_id, None)
        if wid is not None and wid in self._workers:
            self._workers[wid].remove(request_id)

    def worker_of(self, request_id: str) -> int | None:
        return self._request_worker.get(request_id)

    def load_of(self, worker_id: int) -> tuple[int, int]:
        """(active_blocks, prefill_tokens) of ONE worker — the per-pick
        prediction feed: the router updates only the worker a lifecycle
        event touched, instead of folding every worker's load into the
        scheduler per pick (which made predictions an O(instances) tax
        on the decision)."""
        seqs = self._workers.get(worker_id)
        if seqs is None:
            return (0, 0)
        seqs.expire()
        return (seqs.active_blocks, seqs.prefill_tokens)

    def loads(self) -> dict[int, tuple[int, int]]:
        """worker_id -> (active_blocks, prefill_tokens)."""
        out = {}
        for wid, seqs in self._workers.items():
            seqs.expire()
            out[wid] = (seqs.active_blocks, seqs.prefill_tokens)
        return out
