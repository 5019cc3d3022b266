"""The msgpack subset the wire uses, written from the standard library.

The JAX package frames its hub and data-plane messages with
``msgpack.packb(msg, use_bin_type=True)`` and reads them with
``msgpack.unpackb(body, raw=False)``. The port may not import msgpack, so
this module encodes and decodes the same bytes itself:

- ``packb`` gives exactly the encoding msgpack-python chooses: the smallest
  int form (positive fixint up to 127, negative fixint down to -32, then
  uint8..uint64 for positives and int8..int64 for negatives), every float
  as float64, fixstr/str8/str16/str32, bin8/bin16/bin32, fixarray/array16/
  array32 and fixmap/map16/map32, maps in insertion order. A torch worker
  and a JAX process therefore share one wire in both directions.
- ``unpackb`` also reads float32, returns arrays as lists, accepts only
  ``str`` and ``bytes`` map keys (msgpack's ``strict_map_key=True``) and
  raises ``ValueError`` on an ext type, a reserved byte, a truncated body or
  trailing bytes.

Types that cross: ``None``, ``bool``, ``int`` (-2**63 .. 2**64-1), ``float``,
``str``, ``bytes``/``bytearray``/``memoryview``, ``list``/``tuple`` and
``dict``. Scalars must be of exactly those types: anything else (a
``torch.Tensor``, a numpy scalar, even a numpy float that subclasses
``float``) raises ``TypeError`` naming the type, because a payload holding
one is a bug upstream, not something to coerce.
"""

from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb"]

_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_F32 = struct.Struct(">f")
_F64 = struct.Struct(">d")


def packb(obj: Any) -> bytes:
    """``obj`` encoded as ``msgpack.packb(obj, use_bin_type=True)`` would."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        if n <= 0x7F:
            out.append(n)
        elif n <= 0xFF:
            out += b"\xcc" + _U8.pack(n)
        elif n <= 0xFFFF:
            out += b"\xcd" + _U16.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xce" + _U32.pack(n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _U64.pack(n)
        else:
            raise OverflowError(f"int {n} is above the msgpack range (2**64 - 1)")
    elif n >= -32:
        out.append(n & 0xFF)
    elif n >= -0x80:
        out += b"\xd0" + _I8.pack(n)
    elif n >= -0x8000:
        out += b"\xd1" + _I16.pack(n)
    elif n >= -0x80000000:
        out += b"\xd2" + _I32.pack(n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + _I64.pack(n)
    else:
        raise OverflowError(f"int {n} is below the msgpack range (-2**63)")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes: tuple[bytes, ...], what: str) -> None:
    """A length header: the fix form below ``fix_max``, then the 8- (if
    ``codes`` has three), 16- and 32-bit forms."""
    if n <= fix_max:
        out.append(fix | n)
        return
    if len(codes) == 3:
        if n <= 0xFF:
            out += codes[0] + _U8.pack(n)
            return
        codes = codes[1:]
    if n <= 0xFFFF:
        out += codes[0] + _U16.pack(n)
    elif n <= 0xFFFFFFFF:
        out += codes[1] + _U32.pack(n)
    else:
        raise ValueError(f"{what} of length {n} is over the msgpack limit")


def _pack(obj: Any, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + _F64.pack(obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 31, (b"\xd9", b"\xda", b"\xdb"), "str")
        out += data
    elif t is bytes or t is bytearray or t is memoryview:
        data = bytes(obj)
        n = len(data)
        if n <= 0xFF:
            out += b"\xc4" + _U8.pack(n)
        elif n <= 0xFFFF:
            out += b"\xc5" + _U16.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xc6" + _U32.pack(n)
        else:
            raise ValueError(f"bytes of length {n} is over the msgpack limit")
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (b"\xdc", b"\xdd"), "array")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (b"\xde", b"\xdf"), "map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {t.__module__}.{t.__qualname__} object")


def unpackb(data: bytes | bytearray | memoryview) -> Any:
    """``data`` decoded as ``msgpack.unpackb(data, raw=False)`` would."""
    buf = bytes(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after the msgpack object")
    return obj


def _take(buf: bytes, pos: int, n: int) -> int:
    """End of ``n`` bytes from ``pos``; raises on a truncated body."""
    end = pos + n
    if end > len(buf):
        raise ValueError(f"truncated msgpack body: {n} bytes needed at offset {pos}")
    return end


def _sized(buf: bytes, pos: int, fmt: struct.Struct) -> tuple[int, int]:
    end = _take(buf, pos, fmt.size)
    return fmt.unpack_from(buf, pos)[0], end


def _str(buf: bytes, pos: int, n: int) -> tuple[str, int]:
    end = _take(buf, pos, n)
    return buf[pos:end].decode("utf-8"), end


def _array(buf: bytes, pos: int, n: int) -> tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        out.append(item)
    return out, pos


def _map(buf: bytes, pos: int, n: int) -> tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        if type(key) is not str and type(key) is not bytes:
            raise ValueError(
                f"{type(key).__name__} is not allowed for a map key (str or bytes only)")
        out[key], pos = _unpack(buf, pos)
    return out, pos


_INTS = {0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
         0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64,
         0xCA: _F32, 0xCB: _F64}
_STR_LEN = {0xD9: _U8, 0xDA: _U16, 0xDB: _U32}
_BIN_LEN = {0xC4: _U8, 0xC5: _U16, 0xC6: _U32}
_ARRAY_LEN = {0xDC: _U16, 0xDD: _U32}
_MAP_LEN = {0xDE: _U16, 0xDF: _U32}


def _unpack(buf: bytes, pos: int) -> tuple[Any, int]:
    end = _take(buf, pos, 1)
    b = buf[pos]
    pos = end
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if b <= 0x9F:
        return _array(buf, pos, b & 0x0F)
    if b <= 0xBF:
        return _str(buf, pos, b & 0x1F)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    fmt = _INTS.get(b)
    if fmt is not None:
        return _sized(buf, pos, fmt)
    fmt = _STR_LEN.get(b)
    if fmt is not None:
        n, pos = _sized(buf, pos, fmt)
        return _str(buf, pos, n)
    fmt = _BIN_LEN.get(b)
    if fmt is not None:
        n, pos = _sized(buf, pos, fmt)
        end = _take(buf, pos, n)
        return buf[pos:end], end
    fmt = _ARRAY_LEN.get(b)
    if fmt is not None:
        n, pos = _sized(buf, pos, fmt)
        return _array(buf, pos, n)
    fmt = _MAP_LEN.get(b)
    if fmt is not None:
        n, pos = _sized(buf, pos, fmt)
        return _map(buf, pos, n)
    if 0xC7 <= b <= 0xC9 or 0xD4 <= b <= 0xD8:
        raise ValueError(f"msgpack ext type (0x{b:02x}) is not part of the wire")
    raise ValueError(f"reserved msgpack byte 0x{b:02x}")
