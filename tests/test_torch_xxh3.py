"""dynamo_tpu_torch.xxh3 against xxhash, and the port's token hashes against
dynamo_tpu.tokens, bit for bit.

XXH3-64 has one code path per length class (0, 1-3, 4-8, 9-16, 17-128,
129-240 and the long path above 240 with its 1024-byte blocks); every class
and every boundary between them is held against
``xxhash.xxh3_64_intdigest`` under the seeds the port uses (0 and the block
size 16 of the router's chunk digest) and under extreme and random ones.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu import tokens as jtok
from dynamo_tpu_torch import tokens as ttok
from dynamo_tpu_torch.xxh3 import xxh3_64

pytestmark = pytest.mark.unit

SEEDS = (0, 16, 64, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15)
BOUNDARIES = (0, 1, 3, 4, 8, 9, 16, 17, 128, 129, 240, 241, 1024, 1025)


@pytest.mark.parametrize("n", BOUNDARIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_xxh3_class_boundaries(n, seed):
    rng = np.random.default_rng(n * 7 + 1)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed)
    # a memoryview (the router's chunk digests read one) hashes the same
    assert xxh3_64(memoryview(data), seed) == xxh3_64(data, seed)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(data=st.binary(min_size=0, max_size=2048),
       seed=st.one_of(st.sampled_from(SEEDS),
                      st.integers(min_value=0, max_value=2**64 - 1)))
def test_xxh3_matches_xxhash(data, seed):
    assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed)


def test_xxh3_every_length_to_2048():
    """Every length 0..2048 once (the long path's stripe counts and the
    last-stripe overlap at each remainder), random seed per length."""
    rng = random.Random(7)
    buf = np.random.default_rng(7).integers(0, 256, 2048, dtype=np.uint8).tobytes()
    for n in range(2049):
        seed = rng.getrandbits(64) if n % 3 else 0
        assert xxh3_64(buf[:n], seed) == xxhash.xxh3_64_intdigest(buf[:n], seed=seed), n


def test_xxh3_negative_seed_wraps_like_u64():
    assert xxh3_64(b"abc", -1) == xxhash.xxh3_64_intdigest(b"abc", seed=2**64 - 1)


@pytest.mark.parametrize("block_size", [1, 4, 16, 64, 128])
def test_token_hashes_equal_reference(block_size):
    """block_hash (with seeds), salt_hash, chain_hash and
    compute_sequence_hashes equal dynamo_tpu.tokens on seeded streams; a
    block of more than 60 tokens takes the long path."""
    rng = np.random.default_rng(block_size)
    toks = rng.integers(0, 128_256, 5 * block_size + 3).tolist()
    for i in range(0, len(toks) - block_size, block_size):
        blk = toks[i: i + block_size]
        for seed in (0, 16, 2**64 - 1):
            assert ttok.block_hash(blk, seed) == jtok.block_hash(blk, seed)
    assert ttok.compute_block_hashes(toks, block_size) == jtok.compute_block_hashes(
        toks, block_size)
    for salt in (None, "", "llama-3-8b", b"\x00lora", "ténant"):
        assert ttok.salt_hash(salt) == jtok.salt_hash(salt)
        assert (ttok.compute_sequence_hashes(toks, block_size, salt)
                == jtok.compute_sequence_hashes(toks, block_size, salt))
    for parent, child in ((0, 0), (2**64 - 1, 1), (-5, 2**70 + 3)):
        assert ttok.chain_hash(parent, child) == jtok.chain_hash(parent, child)
    # out-of-range ids mask to u32 in both
    odd = [-1, 2**32 + 5, 7, 2**33]
    assert ttok.block_hash(odd) == jtok.block_hash(odd)


def test_token_block_sequence_equals_reference():
    """TokenBlockSequence through extend, append, truncate and unwind: the
    same blocks (tokens and all three hashes) as the reference's."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 50_000, 150).tolist()
    ts = ttok.TokenBlockSequence.from_tokens(toks[:70], 16, salt="m")
    js = jtok.TokenBlockSequence.from_tokens(toks[:70], 16, salt="m")

    def same():
        assert ts.tokens() == js.tokens()
        assert [(b.tokens, b.block_hash, b.sequence_hash, b.parent_sequence_hash,
                 b.block_index) for b in ts] == [
            (b.tokens, b.block_hash, b.sequence_hash, b.parent_sequence_hash,
             b.block_index) for b in js]
        assert ts.last_sequence_hash == js.last_sequence_hash

    same()
    for t in toks[70:110]:
        a, b = ts.append(t), js.append(t)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.sequence_hash == b.sequence_hash
    same()
    ts.truncate(33)
    js.truncate(33)
    same()
    ts.unwind(5)
    js.unwind(5)
    same()
    assert ([b.sequence_hash for b in ts.extend(toks[110:])]
            == [b.sequence_hash for b in js.extend(toks[110:])])
    same()
