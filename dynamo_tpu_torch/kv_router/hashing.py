"""Amortized prefix hashing for the routing hot path (the counterpart of
dynamo_tpu/kv_router/hashing.py: the same chunked LRU and the same hashes,
keyed on the chunk's bytes instead of their xxh3 digest).

``compute_sequence_hashes`` re-hashes every token of every request —
O(tokens) of per-block xxh3 chaining per pick. The workload the KV
router exists for (repeated system prompts, shared few-shot preambles,
multi-turn histories) re-submits the SAME leading tokens over and over,
so the chained hash list of those tokens is recomputed millions of
times. ``PrefixHashCache`` amortizes it: the complete-block region of a
request is split into fixed-size CHUNKS of blocks, and a bounded LRU
maps ``(parent sequence hash, block size, chunk bytes)`` -> that chunk's
chained sequence-hash list. A repeated preamble costs one dict lookup
per chunk (the interpreter's own bytes hash, in C) instead of the
per-block xxh3 chain walk; only the request's unique tail chunk is ever
re-chained. Keying each chunk on its PARENT hash makes hits exact by
construction — a chunk can only be reused under the same salt and the
same preceding tokens, so the cached list is bit-identical to what
``compute_sequence_hashes`` would produce (test-asserted).

The reference keys on ``xxh3_64(chunk bytes, seed=block_size)``: in C, a
digest costs little beside the chain it saves. This package's XXH3 runs in
the interpreter, where the 256-byte digest of a 4-block chunk costs about
half of chaining its four blocks (PERF.md): a miss would pay 1.5x the
direct chain and a hit the digest. The raw bytes are an exact key at no
hashing cost. Same hits, misses and outputs as the reference's cache
(barring an xxh3 collision there).

Sizing: one entry is ``chunk_blocks`` ints plus a tuple key holding the
chunk's bytes (256 at the default 4-block chunks of 16 tokens). The
``DYN_ROUTER_HASH_CACHE`` env knob bounds entries (default 4096 — at
the default 4-block chunks that is ~16k cached block hashes, ~2 MB);
``0`` disables the cache entirely (every call falls through to the
direct computation). Chunk granularity trades hit resolution against
per-chunk overhead: 4 blocks (64 tokens at block_size 16) hits on
preambles as short as one chat system prompt.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Sequence

from dynamo_tpu_torch.tokens import (
    _tokens_bytes,
    block_hash,
    chain_hash,
    salt_hash,
)

__all__ = ["PrefixHashCache", "DEFAULT_CACHE_ENTRIES"]

DEFAULT_CACHE_ENTRIES = 4096
_ENV_ENTRIES = "DYN_ROUTER_HASH_CACHE"


def _chain_chunk(
    tokens: Sequence[int], start: int, end: int, block_size: int,
    parent: int,
) -> list[int]:
    """Chained sequence hashes of the complete blocks in tokens[start:end]."""
    out: list[int] = []
    for i in range(start, end, block_size):
        parent = chain_hash(parent, block_hash(tokens[i : i + block_size]))
        out.append(parent)
    return out


class PrefixHashCache:
    """Bounded LRU: (parent seq hash, chunk digest) -> chunk hash chain."""

    def __init__(
        self,
        max_entries: int = DEFAULT_CACHE_ENTRIES,
        chunk_blocks: int = 4,
    ):
        if chunk_blocks <= 0:
            raise ValueError("chunk_blocks must be positive")
        self.max_entries = max_entries
        self.chunk_blocks = chunk_blocks
        self._lru: OrderedDict[tuple[int, int, bytes], list[int]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @classmethod
    def from_env(cls) -> "PrefixHashCache":
        try:
            entries = int(os.environ.get(_ENV_ENTRIES, DEFAULT_CACHE_ENTRIES))
        except ValueError:
            entries = DEFAULT_CACHE_ENTRIES
        return cls(max_entries=max(entries, 0))

    def sequence_hashes(
        self,
        tokens: Sequence[int],
        block_size: int,
        salt: str | bytes | None = None,
    ) -> list[int]:
        """Drop-in for ``compute_sequence_hashes`` (identical output)."""
        n_complete = (len(tokens) // block_size) * block_size
        parent = salt_hash(salt)
        if self.max_entries <= 0:
            return _chain_chunk(tokens, 0, n_complete, block_size, parent)
        out: list[int] = []
        lru = self._lru
        span = self.chunk_blocks * block_size
        # one C-level pack of the whole complete-block region; chunk keys
        # then slice byte ranges of it (no per-chunk re-pack)
        raw = _tokens_bytes(tokens[:n_complete])
        for start in range(0, n_complete, span):
            end = min(start + span, n_complete)
            # the key holds the chunk's exact bytes; the parent hash pins
            # everything BEFORE the chunk (incl. the salt), the block size
            # how the chunk splits into blocks
            key = (parent, block_size, raw[start * 4 : end * 4])
            chain = lru.get(key)
            if chain is None:
                self.misses += 1
                chain = _chain_chunk(tokens, start, end, block_size, parent)
                lru[key] = chain
                if len(lru) > self.max_entries:
                    lru.popitem(last=False)
            else:
                self.hits += 1
                lru.move_to_end(key)
            out.extend(chain)
            parent = chain[-1]
        return out
