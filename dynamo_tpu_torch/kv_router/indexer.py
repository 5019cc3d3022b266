"""Global prefix index: which KV blocks live on which workers (a copy of
dynamo_tpu/kv_router/indexer.py).

``RadixTree`` (ref lib/llm/src/kv_router/indexer.rs:225) is event-sourced
from worker cache events. Nodes are keyed by *sequence hash* (the chained
prefix identity from tokens.py), so lookup of a request's prefix overlap is a
straight walk down its sequence-hash list - no token re-hashing or trie
traversal per character, and workers never ship token content.

``ApproxKvIndexer`` (ref approx.rs:165) needs no worker events at all: it
optimistically records the blocks of each *routed* request for the chosen
worker with a TTL, approximating cache state for engines that don't emit
events.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Iterable

__all__ = ["OverlapScores", "RadixTree", "ApproxKvIndexer"]


@dataclass
class OverlapScores:
    """Per-worker consecutive-prefix-block hit counts (ref indexer.rs)."""

    scores: dict[int, int] = field(default_factory=dict)
    total_blocks: int = 0

    def best(self) -> tuple[int | None, int]:
        if not self.scores:
            return None, 0
        wid = max(self.scores, key=lambda w: self.scores[w])
        return wid, self.scores[wid]


@dataclass
class _Node:
    sequence_hash: int
    parent_sequence_hash: int
    workers: set[int] = field(default_factory=set)
    children: set[int] = field(default_factory=set)  # child sequence hashes
    last_access: float = 0.0


class RadixTree:
    """Sequence-hash-keyed prefix index over workers' KV blocks."""

    def __init__(self) -> None:
        self._nodes: dict[int, _Node] = {}
        self._worker_blocks: dict[int, set[int]] = {}  # worker -> seq hashes
        self.applied_events = 0

    # -- queries -----------------------------------------------------------

    def find_matches(
        self, sequence_hashes: Iterable[int], *, touch: bool = True
    ) -> OverlapScores:
        """Longest consecutive prefix overlap per worker (ref indexer.rs:277).

        A worker scores ``k`` iff it holds blocks 1..k of the request prefix
        (consecutive from the start - partial interior hits don't help
        prefill skip).

        Scores are recorded only at each worker's FINAL depth (when it
        drops out of the walk, or once at the end for the survivors) —
        the old per-depth rewrite (``scores[w] = depth`` for every alive
        worker at every level) made the walk O(workers x depth), which at
        fleet scale out-costed the set intersections it sat next to.
        """
        now = time.monotonic()
        scores: dict[int, int] = {}
        alive: set[int] | None = None
        depth = 0  # depth the current ``alive`` set has fully matched
        total = 0
        for sh in sequence_hashes:
            total += 1
            node = self._nodes.get(sh)
            if node is None or not node.workers:
                break
            if touch:
                node.last_access = now
            if alive is None:
                # reference, not copy: every later step derives NEW sets
                # (&, -) rather than mutating this one
                alive = node.workers
            else:
                survivors = alive & node.workers
                if len(survivors) != len(alive):
                    for w in alive - survivors:
                        scores[w] = depth  # final depth: last level held
                    alive = survivors
                    if not alive:
                        break
            depth += 1
        if alive:
            for w in alive:
                scores[w] = depth
        return OverlapScores(scores=scores, total_blocks=total)

    def workers(self) -> set[int]:
        return set(self._worker_blocks)

    def num_blocks(self, worker_id: int | None = None) -> int:
        if worker_id is None:
            return len(self._nodes)
        return len(self._worker_blocks.get(worker_id, ()))

    # -- mutations ---------------------------------------------------------

    def apply_event(self, worker_id: int, event) -> None:
        """Apply one worker cache event (ref indexer.rs:334)."""
        self.applied_events += 1
        if event.kind == "stored":
            for b in event.stored:
                self._store(worker_id, b.sequence_hash, b.parent_sequence_hash)
        elif event.kind == "removed":
            for sh in event.removed:
                self._remove(worker_id, sh)
        elif event.kind == "cleared":
            self.remove_worker(worker_id)
        else:
            raise ValueError(f"unknown event kind {event.kind!r}")

    def _store(self, worker_id: int, sh: int, parent_sh: int) -> None:
        node = self._nodes.get(sh)
        if node is None:
            node = _Node(sh, parent_sh, last_access=time.monotonic())
            self._nodes[sh] = node
            parent = self._nodes.get(parent_sh)
            if parent is not None:
                parent.children.add(sh)
        node.workers.add(worker_id)
        self._worker_blocks.setdefault(worker_id, set()).add(sh)

    def _remove(self, worker_id: int, sh: int) -> None:
        node = self._nodes.get(sh)
        if node is None:
            return
        node.workers.discard(worker_id)
        wb = self._worker_blocks.get(worker_id)
        if wb is not None:
            wb.discard(sh)
        if not node.workers:
            self._drop_node(sh)

    def _drop_node(self, sh: int) -> None:
        node = self._nodes.pop(sh, None)
        if node is None:
            return
        parent = self._nodes.get(node.parent_sequence_hash)
        if parent is not None:
            parent.children.discard(sh)
        # children keep existing; their entries just become unreachable from
        # this parent (they are still directly addressable by hash).

    def remove_worker(self, worker_id: int) -> None:
        """Drop every block a dead worker held (ref lease-expiry path)."""
        for sh in list(self._worker_blocks.pop(worker_id, ())):
            node = self._nodes.get(sh)
            if node is not None:
                node.workers.discard(worker_id)
                if not node.workers:
                    self._drop_node(sh)

    # -- snapshot / restore (ref kv_router.rs RADIX_STATE_BUCKET) ----------

    def snapshot(self) -> dict:
        return {
            "nodes": [
                {
                    "sh": n.sequence_hash,
                    "parent": n.parent_sequence_hash,
                    "workers": sorted(n.workers),
                }
                for n in self._nodes.values()
            ],
            "applied_events": self.applied_events,
        }

    @classmethod
    def restore(cls, snap: dict) -> "RadixTree":
        tree = cls()
        for n in snap.get("nodes", ()):
            for w in n["workers"]:
                tree._store(w, n["sh"], n["parent"])
        tree.applied_events = snap.get("applied_events", 0)
        return tree


class ApproxKvIndexer:
    """TTL-predicted cache index - no worker events needed (ref approx.rs:165).

    On every routed request, the router records the request's prefix blocks
    as (optimistically) resident on the chosen worker for ``ttl_s``.
    """

    def __init__(self, ttl_s: float = 120.0):
        self.ttl_s = ttl_s
        self._tree = RadixTree()
        # latest deadline per (worker, sh): re-routing the same prefix
        # refreshes the TTL instead of leaving a stale earlier deadline.
        self._deadlines: dict[tuple[int, int], float] = {}
        # lazy min-heap over (deadline, worker, sh). Each live key has
        # exactly ONE heap entry: a TTL refresh only updates the dict,
        # and when the (now stale-dated) entry reaches the heap top it
        # is re-pushed at the refreshed deadline instead of removed — so
        # a hot prefix re-routed every pick costs O(1) heap ops per TTL,
        # not per pick, and expiry is O(expired log n) per find_matches
        # instead of the full O(entries) scan the dict-walk version
        # paid on EVERY call.
        self._expiry_heap: list[tuple[float, int, int]] = []

    def find_matches(self, sequence_hashes: Iterable[int]) -> OverlapScores:
        self._expire()
        return self._tree.find_matches(sequence_hashes)

    def process_routing_decision(
        self, worker_id: int, sequence_hashes: Iterable[int], parent_hashes: Iterable[int]
    ) -> None:
        now = time.monotonic()
        deadline = now + self.ttl_s
        deadlines = self._deadlines
        for sh, parent in zip(sequence_hashes, parent_hashes):
            self._tree._store(worker_id, sh, parent)
            if (worker_id, sh) not in deadlines:
                heapq.heappush(self._expiry_heap, (deadline, worker_id, sh))
            deadlines[(worker_id, sh)] = deadline  # refresh: dict only

    def remove_worker(self, worker_id: int) -> None:
        self._tree.remove_worker(worker_id)
        for key in [k for k in self._deadlines if k[0] == worker_id]:
            del self._deadlines[key]  # heap entries expire lazily

    def _expire(self) -> None:
        now = time.monotonic()
        heap = self._expiry_heap
        deadlines = self._deadlines
        while heap and heap[0][0] <= now:
            deadline, worker, sh = heapq.heappop(heap)
            current = deadlines.get((worker, sh))
            if current is None:
                continue  # worker removed: entry retired
            if current > deadline:
                # refreshed since this entry was dated: carry the key's
                # single entry forward at its live deadline
                heapq.heappush(heap, (current, worker, sh))
                continue
            self._tree._remove(worker, sh)
            del deadlines[(worker, sh)]
