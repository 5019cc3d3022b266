"""XXH3-64 (``XXH3_64bits_withSeed``) in the standard library.

Bit-equal to ``xxhash.xxh3_64_intdigest(data, seed=seed)`` for every input
length and seed: this package hashes token blocks with it (tokens.py), so a
worker's KV events, its prefix cache and any router agree with the
reference's xxh3 block identities without the xxhash package.

Every length class of the reference implementation (xxhash.h, v0.8):

- 0, 1-3, 4-8, 9-16: single-shot mixes of the secret's first 64 bytes;
- 17-128: up to four 16-byte mix pairs from both ends;
- 129-240: eight 16-byte mixes, an avalanche, then the rest (secret read
  at offset 3) and the last 16 bytes (secret offset 136 - 17);
- above 240: the long path over 64-byte stripes with eight 64-bit
  accumulators, a scramble after every 16 stripes (one 1024-byte block),
  the last stripe at secret offset 192 - 64 - 7, and the merge at offset
  11. A nonzero seed derives a custom secret first: the seed is added to
  the even 8-byte words of the default secret and subtracted from the odd.

Python ints masked to 64 bits; ``_fold`` is the full 128-bit product folded
to 64 (``XXH3_mul128_fold64``). A 16-token block (64 bytes) costs one
17-128 hash, a chain link (16 bytes) one 9-16 hash.
"""

from __future__ import annotations

import struct
from functools import lru_cache

__all__ = ["xxh3_64"]

_M = 0xFFFFFFFFFFFFFFFF
_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_MX1 = 0x165667919E3779F9
_MX2 = 0x9FB21C651E98DF25

_K_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_SECRET_SIZE = 192
_STRIPE = 64
_STRIPES_PER_BLOCK = (_SECRET_SIZE - _STRIPE) // 8  # 16
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK  # 1024

_Q = struct.Struct("<Q")
_I = struct.Struct("<I")
_QQ = struct.Struct("<QQ")
_Q8 = struct.Struct("<8Q")
_q = _Q.unpack_from
_i = _I.unpack_from
_qq = _QQ.unpack_from
_q8 = _Q8.unpack_from

# the default secret's words at the fixed offsets of the short classes
_S = _K_SECRET
_BITFLIP_0 = _q(_S, 56)[0] ^ _q(_S, 64)[0]
_BITFLIP_3 = _i(_S, 0)[0] ^ _i(_S, 4)[0]
_BITFLIP_8 = _q(_S, 8)[0] ^ _q(_S, 16)[0]
_BITFLIP_16A = _q(_S, 24)[0] ^ _q(_S, 32)[0]
_BITFLIP_16B = _q(_S, 40)[0] ^ _q(_S, 48)[0]
# the 16-byte mixes' secret pairs: offsets 0, 16, ..., 128 (17-128 and the
# first eight rounds of 129-240), 3 + 16 i (129-240 rounds 9+) and 119
_MIX_KEYS = tuple(_qq(_S, off) for off in range(0, 129, 16))
_MID_KEYS = tuple(_qq(_S, 3 + 16 * i) for i in range(7))
_MID_LAST = _qq(_S, 136 - 17)


def _avalanche64(h: int) -> int:
    """XXH64_avalanche."""
    h ^= h >> 33
    h = (h * _P64_2) & _M
    h ^= h >> 29
    h = (h * _P64_3) & _M
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    """XXH3_avalanche."""
    h ^= h >> 37
    h = (h * _MX1) & _M
    return h ^ (h >> 32)


def _fold(a: int, b: int) -> int:
    """XXH3_mul128_fold64: low ^ high half of the 128-bit product."""
    p = a * b
    return (p & _M) ^ (p >> 64)


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _mix16(data, off: int, key: tuple[int, int], seed: int) -> int:
    lo, hi = _qq(data, off)
    return _fold(lo ^ ((key[0] + seed) & _M), hi ^ ((key[1] - seed) & _M))


def _len_0(seed: int) -> int:
    return _avalanche64(seed ^ _BITFLIP_0)


def _len_1to3(data, n: int, seed: int) -> int:
    combined = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
    return _avalanche64(combined ^ ((_BITFLIP_3 + seed) & _M))


def _len_4to8(data, n: int, seed: int) -> int:
    seed ^= _swap32(seed & 0xFFFFFFFF) << 32
    in1 = _i(data, 0)[0]
    in2 = _i(data, n - 4)[0]
    h = (in2 + (in1 << 32)) ^ ((_BITFLIP_8 - seed) & _M)
    # XXH3_rrmxmx
    h ^= ((h << 49) | (h >> 15)) & _M ^ ((h << 24) | (h >> 40)) & _M
    h = (h * _MX2) & _M
    h ^= ((h >> 35) + n) & _M
    h = (h * _MX2) & _M
    return h ^ (h >> 28)


def _len_9to16(data, n: int, seed: int) -> int:
    lo = _q(data, 0)[0] ^ ((_BITFLIP_16A + seed) & _M)
    hi = _q(data, n - 8)[0] ^ ((_BITFLIP_16B - seed) & _M)
    acc = (n + _swap64(lo) + hi + _fold(lo, hi)) & _M
    return _avalanche(acc)


def _len_17to128(data, n: int, seed: int) -> int:
    k = _MIX_KEYS
    acc = n * _P64_1
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(data, 48, k[6], seed)
                acc += _mix16(data, n - 64, k[7], seed)
            acc += _mix16(data, 32, k[4], seed)
            acc += _mix16(data, n - 48, k[5], seed)
        acc += _mix16(data, 16, k[2], seed)
        acc += _mix16(data, n - 32, k[3], seed)
    acc += _mix16(data, 0, k[0], seed)
    acc += _mix16(data, n - 16, k[1], seed)
    return _avalanche(acc & _M)


def _len_129to240(data, n: int, seed: int) -> int:
    k = _MIX_KEYS
    acc = n * _P64_1
    for i in range(8):
        acc += _mix16(data, 16 * i, k[i], seed)
    acc_end = _mix16(data, n - 16, _MID_LAST, seed)
    acc = _avalanche(acc & _M)
    for i in range(8, n // 16):
        acc_end += _mix16(data, 16 * i, _MID_KEYS[i - 8], seed)
    return _avalanche((acc + acc_end) & _M)


@lru_cache(maxsize=64)
def _long_secret(seed: int) -> tuple:
    """The long path's secret tables for ``seed``: per-stripe key lanes
    (stripe n reads 8 words from byte 8 n), the scramble keys (byte 128),
    the last stripe's keys (byte 121) and the merge keys (byte 11)."""
    if seed:
        words = struct.unpack(f"<{_SECRET_SIZE // 8}Q", _K_SECRET)
        secret = struct.pack(
            f"<{_SECRET_SIZE // 8}Q",
            *(((w + seed) if i % 2 == 0 else (w - seed)) & _M
              for i, w in enumerate(words)),
        )
    else:
        secret = _K_SECRET
    stripes = tuple(_q8(secret, 8 * n) for n in range(_STRIPES_PER_BLOCK))
    scramble = _q8(secret, _SECRET_SIZE - _STRIPE)
    last = _q8(secret, _SECRET_SIZE - _STRIPE - 7)
    merge = _q8(secret, 11)
    return stripes, scramble, last, merge


def _stripes(acc: tuple, data, start: int, count: int, keys: tuple) -> tuple:
    """``count`` XXH3_accumulate_512 rounds (scalar) over the 64-byte stripes
    from byte ``start``, stripe s keyed by ``keys[s]``: for each lane i,
    acc[i ^ 1] += lane and acc[i] += lo32 * hi32 of (lane ^ key)."""
    a0, a1, a2, a3, a4, a5, a6, a7 = acc
    for s in range(count):
        v0, v1, v2, v3, v4, v5, v6, v7 = _q8(data, start + s * _STRIPE)
        k0, k1, k2, k3, k4, k5, k6, k7 = keys[s]
        d0, d1, d2, d3 = v0 ^ k0, v1 ^ k1, v2 ^ k2, v3 ^ k3
        d4, d5, d6, d7 = v4 ^ k4, v5 ^ k5, v6 ^ k6, v7 ^ k7
        a0 = (a0 + v1 + (d0 & 0xFFFFFFFF) * (d0 >> 32)) & _M
        a1 = (a1 + v0 + (d1 & 0xFFFFFFFF) * (d1 >> 32)) & _M
        a2 = (a2 + v3 + (d2 & 0xFFFFFFFF) * (d2 >> 32)) & _M
        a3 = (a3 + v2 + (d3 & 0xFFFFFFFF) * (d3 >> 32)) & _M
        a4 = (a4 + v5 + (d4 & 0xFFFFFFFF) * (d4 >> 32)) & _M
        a5 = (a5 + v4 + (d5 & 0xFFFFFFFF) * (d5 >> 32)) & _M
        a6 = (a6 + v7 + (d6 & 0xFFFFFFFF) * (d6 >> 32)) & _M
        a7 = (a7 + v6 + (d7 & 0xFFFFFFFF) * (d7 >> 32)) & _M
    return a0, a1, a2, a3, a4, a5, a6, a7


def _long(data, n: int, seed: int) -> int:
    stripes, scramble, last, merge = _long_secret(seed)
    acc = (_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1)
    nb_blocks = (n - 1) // _BLOCK
    for b in range(nb_blocks):
        acc = _stripes(acc, data, b * _BLOCK, _STRIPES_PER_BLOCK, stripes)
        scrambled = []
        for a, k in zip(acc, scramble):  # XXH3_scrambleAcc
            a ^= a >> 47
            scrambled.append(((a ^ k) * _P32_1) & _M)
        acc = tuple(scrambled)
    base = nb_blocks * _BLOCK
    acc = _stripes(acc, data, base, ((n - 1) - base) // _STRIPE, stripes)
    acc = _stripes(acc, data, n - _STRIPE, 1, (last,))
    result = n * _P64_1
    for i in range(4):  # XXH3_mergeAccs
        result += _fold(acc[2 * i] ^ merge[2 * i], acc[2 * i + 1] ^ merge[2 * i + 1])
    return _avalanche(result & _M)


def xxh3_64(data, seed: int = 0) -> int:
    """XXH3_64bits_withSeed(data, seed) as an unsigned int (the value of
    ``xxhash.xxh3_64_intdigest``). ``data``: bytes, bytearray or a
    memoryview of bytes."""
    seed &= _M
    n = len(data)
    if n <= 16:
        if n > 8:
            return _len_9to16(data, n, seed)
        if n >= 4:
            return _len_4to8(data, n, seed)
        if n:
            return _len_1to3(data, n, seed)
        return _len_0(seed)
    if n <= 128:
        return _len_17to128(data, n, seed)
    if n <= 240:
        return _len_129to240(data, n, seed)
    return _long(data, n, seed)
