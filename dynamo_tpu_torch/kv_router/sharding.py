"""Consistent prefix-hash shard map for router sharding (a copy of
dynamo_tpu/kv_router/sharding.py).

One router process saturates around its single-core routing-decision
budget. Router state is
event-sourced and convergent — every shard process runs the FULL
scheduler fed by the same hub KV-event watch — so sharding the DECISION
traffic is safe as long as one prefix's picks always land on one shard:
the ``ApproxKvIndexer``'s optimistic state (recorded per routed request,
no worker events) then stays coherent per prefix instead of being split
across shards that each saw half the decisions.

``ShardMap`` maps a request to its home shard by the FIRST block's
sequence identity (the same chained hash the radix index is keyed on,
salt included — tenant/model cache partitions shard independently),
through Lamport's jump consistent hash: growing N -> N+1 shards remaps
only ~1/(N+1) of prefixes, so a resharding event invalidates a bounded
slice of optimistic state rather than all of it.

Deployment (gateway/epp.py): ``python -m dynamo_tpu_torch.gateway
--shards N`` runs ``DYN_ROUTER_SHARDS`` picker processes, and the caller
dispatches each pick by ``ShardMap.shard_for``. The map is an AFFINITY
optimization, not a correctness gate — a pick landing on the "wrong"
shard still routes correctly off that shard's converged radix state.
"""

from __future__ import annotations

import os
from typing import Sequence

from dynamo_tpu_torch.tokens import block_hash, chain_hash, salt_hash

__all__ = ["ShardMap", "jump_hash", "shards_from_env"]

_ENV_SHARDS = "DYN_ROUTER_SHARDS"


def shards_from_env(default: int = 1) -> int:
    try:
        n = int(os.environ.get(_ENV_SHARDS, default))
    except ValueError:
        return default
    return max(n, 1)


def jump_hash(key: int, n_buckets: int) -> int:
    """Lamport's jump consistent hash: uniform, and growing the bucket
    count moves only ~1/n of keys (the property "consistent" promises
    here — no ring, no vnode table)."""
    if n_buckets <= 1:
        return 0
    key &= 0xFFFFFFFFFFFFFFFF
    b, j = -1, 0
    while j < n_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
        j = int(float((b + 1) * (1 << 31)) / float((key >> 33) + 1))
    return b


class ShardMap:
    """Request -> home-shard mapping on the first prefix block."""

    def __init__(self, n_shards: int, block_size: int):
        if n_shards <= 0:
            raise ValueError("n_shards must be positive")
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.n_shards = n_shards
        self.block_size = block_size

    def shard_for(
        self, token_ids: Sequence[int], salt: str | bytes | None = None
    ) -> int:
        """Home shard of a request: jump hash of its first block's
        sequence hash (short prompts hash whatever tokens exist, so
        sub-block requests still map deterministically)."""
        if self.n_shards == 1:
            return 0
        head = token_ids[: self.block_size]
        key = chain_hash(salt_hash(salt), block_hash(head))
        return jump_hash(key, self.n_shards)
