"""The port's stdlib msgpack codec (dynamo_tpu_torch/runtime/codec.py) held
against msgpack-python bit for bit.

``codec.packb(x)`` must equal ``msgpack.packb(x, use_bin_type=True)`` and
``codec.unpackb(b)`` must equal ``msgpack.unpackb(b, raw=False)``: over
nested values drawn by hypothesis, at every int and length boundary where
msgpack changes its form, and on the messages the hub and data planes send.
The refusals (types that must not cross, ext types, truncated bodies,
trailing bytes, non-string map keys) are checked beside what msgpack does.
"""

import math
import struct

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.runtime import codec

pytestmark = pytest.mark.unit


def ref_pack(x):
    return msgpack.packb(x, use_bin_type=True)


def ref_unpack(b):
    return msgpack.unpackb(b, raw=False)


_ints = st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
_scalars = st.one_of(
    st.none(), st.booleans(), _ints, st.floats(allow_nan=False), st.text(),
    st.binary())
_keys = st.one_of(st.text(max_size=12), st.binary(max_size=12))
_values = st.recursive(
    _scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.tuples(inner, inner),
        st.dictionaries(_keys, inner, max_size=20)),
    max_leaves=60)
_SETTINGS = settings(max_examples=300, deadline=None,
                     suppress_health_check=[HealthCheck.too_slow])


@_SETTINGS
@given(_values)
def test_packb_matches_msgpack_bytes(x):
    got = codec.packb(x)
    assert got == ref_pack(x)
    assert codec.unpackb(got) == ref_unpack(got)


@_SETTINGS
@given(_values, st.booleans())
def test_unpackb_matches_msgpack_objects(x, single_float):
    """Bodies written by msgpack itself, float32 ones included, decode to
    the objects msgpack decodes them to (tuples come back as lists)."""
    body = msgpack.packb(x, use_bin_type=True, use_single_float=single_float)
    assert codec.unpackb(body) == ref_unpack(body)


@_SETTINGS
@given(st.floats(allow_nan=True, allow_infinity=True))
def test_every_float_is_float64(f):
    body = codec.packb(f)
    assert body == ref_pack(f) and body[0] == 0xCB
    back = codec.unpackb(body)
    assert back == f or (math.isnan(back) and math.isnan(f))


_INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, -31, -32, -33, -127, -128, -129,
              -32767, -32768, -32769, -(2 ** 31) + 1, -(2 ** 31), -(2 ** 31) - 1,
              -(2 ** 63) + 1, -(2 ** 63)]


@pytest.mark.parametrize("n", _INT_EDGES)
def test_int_boundaries(n):
    assert codec.packb(n) == ref_pack(n)
    assert codec.unpackb(codec.packb(n)) == n
    assert codec.packb(True) == b"\xc3" and codec.packb(False) == b"\xc2"


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_length_boundaries(n):
    """fixstr/str8/16/32, bin8/16/32, fixarray/array16/32, fixmap/map16/32
    at the lengths where msgpack switches form (str in ASCII and in
    two-byte UTF-8, whose byte length is what counts)."""
    cases = ["a" * n, "é" * (n // 2), b"\x00" * n, bytearray(b"z" * n),
             memoryview(b"m" * n), list(range(n)), tuple([None] * n),
             {f"k{i}": i for i in range(n)}, {str(i).encode(): [i] for i in range(n)}]
    for x in cases:
        body = codec.packb(x)
        assert body == ref_pack(x), (type(x), n)
        assert codec.unpackb(body) == ref_unpack(body)


def test_wire_messages_round_trip():
    """The frames the hub and data planes send, including an engine item
    with logprobs and the coalesced form."""
    msgs = [
        {"id": 7, "op": "put", "key": "v1/instances/ns/c/e/1a2b",
         "value": {"instance_id": 0x1A2B, "host": "127.0.0.1", "port": 40123,
                   "transport": "tcp", "metadata": {}, "uds": ""}, "lease": 3},
        {"id": 8, "stream": {"kind": "put", "key": "k", "value": None}},
        {"kind": "open", "ch": 1, "req": "a" * 32, "path": "ns/c/gen@1a2b",
         "payload": {"token_ids": list(range(300)), "sampling": {"temperature": 0.8},
                     "stop_conditions": {"max_tokens": 32, "ignore_eos": True}},
         "headers": {"x-dyn-deadline-ms": "600000"}},
        {"kind": "data", "ch": 1, "payloads": [
            {"token_ids": [17], "logprobs": [{"id": 17, "logprob": -0.25,
                                              "top": [{"id": 17, "logprob": -0.25}]}]},
            {"token_ids": [], "finish_reason": "length"}]},
        {"kind": "err", "ch": 2, "error": "draining", "code": "unavailable",
         "retry_after": 29.5},
        {"id": 9, "op": "put_object", "bucket": "b", "name": "n", "data": b"\x00" * 300},
    ]
    for m in msgs:
        assert codec.packb(m) == ref_pack(m)
        assert codec.unpackb(ref_pack(m)) == ref_unpack(ref_pack(m))


@pytest.mark.parametrize("bad", [
    np.float64(1.0), np.int64(3), np.float32(0.5), torch.tensor(1), torch.tensor([1.0]),
    {1, 2}, object(), 1 + 2j, [1, np.int32(2)], {"k": torch.zeros(2)}])
def test_refuses_types_that_must_not_cross(bad):
    """A tensor or numpy scalar in a payload is a bug upstream: TypeError
    naming the type, never a coercion (msgpack itself would pack a numpy
    float64, which subclasses float)."""
    with pytest.raises(TypeError, match="serialize"):
        codec.packb(bad)


@pytest.mark.parametrize("n", [2 ** 64, -(2 ** 63) - 1])
def test_int_out_of_range_raises_like_msgpack(n):
    with pytest.raises(OverflowError):
        ref_pack(n)
    with pytest.raises(OverflowError):
        codec.packb(n)


_BAD_BODIES = {
    "reserved-c1": b"\xc1",
    "ext8": b"\xc7\x01\x05\x00",
    "fixext1": b"\xd4\x01\x00",
    "int-map-key": b"\x81\x01\x02",
    "nil-map-key": b"\x81\xc0\x02",
    "array-map-key": b"\x81\x90\x02",
    "trailing": b"\x01\x02",
    "truncated-u32": b"\xce\x00\x01",
    "truncated-str": b"\xa5abc",
    "truncated-array": b"\x93\x01\x02",
    "truncated-map": b"\x82\xa1a\x01",
    "empty": b"",
    "bad-utf8": b"\xa2\xff\xfe",
}


@pytest.mark.parametrize("case", list(_BAD_BODIES))
def test_decoder_refusals(case):
    """ValueError on every malformed body; msgpack refuses the same bodies,
    except that it returns an ExtType where the wire has none."""
    body = _BAD_BODIES[case]
    with pytest.raises(ValueError):
        codec.unpackb(body)
    if case.startswith(("ext", "fixext")):
        assert isinstance(ref_unpack(body), msgpack.ExtType)
    else:
        with pytest.raises(ValueError):
            ref_unpack(body)


def test_every_truncation_of_a_frame_raises():
    body = ref_pack({"kind": "data", "ch": 3, "payloads": [
        {"token_ids": [1, 2, 300, 70000], "text": "héllo", "p": -1.5, "b": b"xy"}]})
    for cut in range(len(body)):
        with pytest.raises(ValueError):
            codec.unpackb(body[:cut])
    assert codec.unpackb(body) == ref_unpack(body)


def test_float32_decodes_like_msgpack():
    body = b"\xca" + struct.pack(">f", 0.1)
    assert codec.unpackb(body) == ref_unpack(body) == struct.unpack(">f", struct.pack(">f", 0.1))[0]
