"""Simulated paged-KV block manager with prefix caching.

Behavioral model of a real engine's KV pool (ref lib/llm/src/mocker/
kv_manager.rs + evictor.rs): a fixed budget of blocks; blocks referenced by
running requests are *active*; completed requests' blocks become *inactive*
but stay cached (keyed by sequence hash) until evicted LRU when a new
allocation would exceed the pool. Store/evict callbacks drive the real
KvEventPublisher, so routers see exactly the event stream a real worker
produces.

A copy of ``dynamo_tpu/mocker/kv_manager.py``.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["MockKvManager", "NotEnoughBlocks"]


class NotEnoughBlocks(Exception):
    """Allocation cannot be satisfied even after evicting everything."""


@dataclass
class _Block:
    sequence_hash: int
    parent_sequence_hash: int
    ref_count: int = 0


class MockKvManager:
    def __init__(
        self,
        total_blocks: int,
        *,
        on_store: Callable[[int, int], None] | None = None,
        on_evict: Callable[[list[int]], None] | None = None,
    ):
        self.total_blocks = total_blocks
        self._blocks: dict[int, _Block] = {}  # sequence_hash -> block
        self._inactive: OrderedDict[int, float] = OrderedDict()  # LRU of ref_count==0
        self._on_store = on_store or (lambda sh, parent: None)
        self._on_evict = on_evict or (lambda shs: None)

    # -- observers ---------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        return len(self._blocks)

    @property
    def active_blocks(self) -> int:
        return len(self._blocks) - len(self._inactive)

    @property
    def free_blocks(self) -> int:
        return self.total_blocks - len(self._blocks)

    def cached_prefix_blocks(self, sequence_hashes: list[int]) -> int:
        """Consecutive prefix blocks already resident (the engine-side
        prefix-cache hit count)."""
        n = 0
        for sh in sequence_hashes:
            if sh in self._blocks:
                n += 1
            else:
                break
        return n

    # -- allocation --------------------------------------------------------

    def can_allocate(self, n_new: int) -> bool:
        return n_new <= self.free_blocks + len(self._inactive)

    def touch(self, sequence_hashes: list[int]) -> int:
        """Re-reference cached prefix blocks for a new request; returns the
        number of blocks reused."""
        reused = 0
        for sh in sequence_hashes:
            blk = self._blocks.get(sh)
            if blk is None:
                break
            blk.ref_count += 1
            self._inactive.pop(sh, None)
            reused += 1
        return reused

    def allocate(self, sequence_hashes: list[int], parents: list[int]) -> None:
        """Materialize new blocks (beyond the cached prefix), evicting LRU
        inactive blocks as needed. Emits store events. Hashes already
        resident are re-referenced (protecting them from eviction), so
        callers own one reference on every hash passed in."""
        need = []
        for sh, p in zip(sequence_hashes, parents):
            blk = self._blocks.get(sh)
            if blk is not None:
                blk.ref_count += 1
                self._inactive.pop(sh, None)
            else:
                need.append((sh, p))
        overflow = len(self._blocks) + len(need) - self.total_blocks
        if overflow > 0:
            self._evict(overflow)
        for sh, parent in need:
            self._blocks[sh] = _Block(sh, parent, ref_count=1)
            self._on_store(sh, parent)

    def _evict(self, n: int) -> None:
        if n > len(self._inactive):
            raise NotEnoughBlocks(
                f"need {n} evictions, only {len(self._inactive)} inactive"
            )
        evicted = []
        for _ in range(n):
            sh, _ts = self._inactive.popitem(last=False)
            del self._blocks[sh]
            evicted.append(sh)
        self._on_evict(evicted)

    def free(self, sequence_hashes: list[int]) -> None:
        """Release a request's references; unreferenced blocks become
        inactive (cached) rather than destroyed."""
        now = time.monotonic()
        for sh in sequence_hashes:
            blk = self._blocks.get(sh)
            if blk is None:
                continue
            blk.ref_count = max(blk.ref_count - 1, 0)
            if blk.ref_count == 0:
                self._inactive[sh] = now
                self._inactive.move_to_end(sh)

    def clear(self) -> list[int]:
        """Drop every inactive block (admin cache-reset endpoint)."""
        dropped = list(self._inactive)
        for sh in dropped:
            del self._blocks[sh]
        self._inactive.clear()
        self._on_evict(dropped)
        return dropped
