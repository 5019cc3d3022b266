"""Token-block hashing primitives.

Every KV-cache feature in the framework (router radix index, engine prefix
cache, KVBM block reuse, disagg KV handoff) keys off the same content hash of
token blocks, so workers and routers agree on block identity without
communicating.

Scheme (the reference's, dynamo_tpu/tokens.py, bit for bit): xxh3_64 from
this package's standard-library XXH3 (xxh3.py), so a worker's prefix cache,
its KV events and any router (this package's or the reference's) agree on
block identity:

- ``block_hash(tokens)``: xxh3_64 over the little-endian u32 token ids of one
  block. Position-independent (content identity).
- ``sequence_hash``: chained prefix identity -
  ``xxh3_64(parent_sequence_hash_u64le || block_hash_u64le)`` with the first block
  chaining from the salt hash. Two sequences share a sequence_hash iff they
  share the whole token prefix (and salt: model + lora + tenant separation).

``TokenBlockSequence`` incrementally maintains the block decomposition of a
growing/shrinking token stream (append, extend, truncate, unwind) so per-token
decode loops pay O(1) amortized hashing cost.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

from dynamo_tpu_torch.xxh3 import xxh3_64

__all__ = [
    "block_hash",
    "salt_hash",
    "chain_hash",
    "compute_block_hashes",
    "compute_sequence_hashes",
    "TokenBlock",
    "TokenBlockSequence",
]

_U64 = struct.Struct("<Q")
_NULL_SALT = 0


def _tokens_bytes(tokens: Sequence[int]) -> bytes:
    try:
        # one C-level pack of the whole block — ~40x the per-token
        # pack/join loop, byte-identical for in-range ids
        return struct.pack(f"<{len(tokens)}I", *tokens)
    except struct.error:
        # out-of-range id (negative / >u32): mask per token like before
        return b"".join(struct.pack("<I", t & 0xFFFFFFFF) for t in tokens)


def block_hash(tokens: Sequence[int], seed: int = 0) -> int:
    """Content hash of one block of token ids (order-sensitive)."""
    return xxh3_64(_tokens_bytes(tokens), seed)


def salt_hash(salt: str | bytes | None) -> int:
    """Hash of the cache-partitioning salt (model id / lora id / tenant)."""
    if salt is None:
        return _NULL_SALT
    if isinstance(salt, str):
        salt = salt.encode("utf-8")
    return xxh3_64(salt)


def chain_hash(parent: int, child_block_hash: int) -> int:
    """Extend a sequence hash chain by one block."""
    return xxh3_64(
        _U64.pack(parent & 0xFFFFFFFFFFFFFFFF)
        + _U64.pack(child_block_hash & 0xFFFFFFFFFFFFFFFF)
    )


def compute_block_hashes(
    tokens: Sequence[int], block_size: int
) -> list[int]:
    """Block-content hashes of every *complete* block of ``tokens``."""
    n = len(tokens) // block_size
    return [
        block_hash(tokens[i * block_size : (i + 1) * block_size])
        for i in range(n)
    ]


def compute_sequence_hashes(
    tokens: Sequence[int], block_size: int, salt: str | bytes | None = None
) -> list[int]:
    """Chained prefix hashes of every complete block of ``tokens``."""
    parent = salt_hash(salt)
    out = []
    for bh in compute_block_hashes(tokens, block_size):
        parent = chain_hash(parent, bh)
        out.append(parent)
    return out


@dataclass(frozen=True)
class TokenBlock:
    """One complete, immutable block of tokens with its identity hashes."""

    tokens: tuple[int, ...]
    block_hash: int
    sequence_hash: int
    parent_sequence_hash: int
    block_index: int

    def __len__(self) -> int:
        return len(self.tokens)


@dataclass
class TokenBlockSequence:
    """Incremental block decomposition of a token sequence.

    Maintains complete blocks (hashed) plus a partial tail. Mirrors the
    extend/append/truncate/unwind surface of reference
    lib/llm/src/tokens.rs:479 ``TokenBlockSequence``.
    """

    block_size: int
    salt: str | bytes | None = None
    blocks: list[TokenBlock] = field(default_factory=list)
    partial: list[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        self._salt_hash = salt_hash(self.salt)

    # -- observers ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial)

    @property
    def num_complete_blocks(self) -> int:
        return len(self.blocks)

    @property
    def last_sequence_hash(self) -> int:
        return self.blocks[-1].sequence_hash if self.blocks else self._salt_hash

    def tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial)
        return out

    def block_hashes(self) -> list[int]:
        return [b.block_hash for b in self.blocks]

    def sequence_hashes(self) -> list[int]:
        return [b.sequence_hash for b in self.blocks]

    def __iter__(self) -> Iterator[TokenBlock]:
        return iter(self.blocks)

    # -- mutators ----------------------------------------------------------

    def append(self, token: int) -> TokenBlock | None:
        """Append one token; returns the block if one was completed."""
        self.partial.append(token)
        if len(self.partial) == self.block_size:
            return self._seal()
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns all blocks completed along the way."""
        sealed = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                sealed.append(b)
        return sealed

    def _seal(self) -> TokenBlock:
        bh = block_hash(self.partial)
        parent = self.last_sequence_hash
        blk = TokenBlock(
            tokens=tuple(self.partial),
            block_hash=bh,
            sequence_hash=chain_hash(parent, bh),
            parent_sequence_hash=parent,
            block_index=len(self.blocks),
        )
        self.blocks.append(blk)
        self.partial.clear()
        return blk

    def truncate(self, length: int) -> None:
        """Shrink to the first ``length`` tokens (unwinds sealed blocks)."""
        if length < 0 or length > len(self):
            raise ValueError(f"cannot truncate to {length} (len={len(self)})")
        keep_blocks, rem = divmod(length, self.block_size)
        if keep_blocks < len(self.blocks):
            reopened = list(self.blocks[keep_blocks].tokens[:rem])
            del self.blocks[keep_blocks:]
            self.partial = reopened
        else:
            del self.partial[rem:]

    def unwind(self, n: int = 1) -> None:
        """Remove the last ``n`` tokens."""
        self.truncate(len(self) - n)

    @classmethod
    def from_tokens(
        cls,
        tokens: Sequence[int],
        block_size: int,
        salt: str | bytes | None = None,
    ) -> "TokenBlockSequence":
        seq = cls(block_size=block_size, salt=salt)
        seq.extend(tokens)
        return seq
