"""The KServe v2 (Open Inference Protocol) messages and their protobuf wire
(the counterpart of dynamo_tpu/grpc/kserve_pb2.py, without protobuf).

``FIELDS`` is the message table of the reference's kserve.proto: for each
message, its fields as (name, number, type, repeated). A type is a scalar
type's protobuf name, another message's name, or ``map<string,V>``. The
classes below are dataclasses over that table; ``Message.to_bytes`` and
``Message.from_bytes`` are the wire codec:

- proto3 defaults are left out of a message's bytes; a oneof member or a
  message field that is set is written even when it holds its default;
- varints for bool, int32, int64, uint32 and uint64 (no zigzag: a negative
  int32 is a 10-byte varint, as protobuf writes it); fixed32 and fixed64
  for float and double;
- repeated scalars are written packed and read packed or unpacked;
- a map is a run of entry messages (key 1, value 2), key and value always
  written, in the order of protobuf's deterministic serializer (upb's:
  bytewise on the keys' common prefix, and a key that extends another
  before it), so a message's bytes equal protobuf's
  ``SerializeToString(deterministic=True)``;
- fields are written in field-number order; unknown fields are skipped on
  read; a singular message field met twice is merged, as protobuf merges.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field
from typing import Any, ClassVar

SCALARS = ("bool", "int32", "int64", "uint32", "uint64", "float", "double",
           "string", "bytes")
_VARINT = ("bool", "int32", "int64", "uint32", "uint64")
_WIRE = {**dict.fromkeys(_VARINT, 0), "double": 1, "float": 5, "string": 2,
         "bytes": 2}
_MAP = "map<string,InferParameter>"

# message -> ((field, number, type, repeated), ...), read from the
# reference's serialized descriptor (kserve_pb2.py)
FIELDS: dict[str, tuple[tuple[str, int, str, bool], ...]] = {
    "ServerLiveRequest": (),
    "ServerLiveResponse": (("live", 1, "bool", False),),
    "ServerReadyRequest": (),
    "ServerReadyResponse": (("ready", 1, "bool", False),),
    "ModelReadyRequest": (("name", 1, "string", False), ("version", 2, "string", False)),
    "ModelReadyResponse": (("ready", 1, "bool", False),),
    "ServerMetadataRequest": (),
    "ServerMetadataResponse": (
        ("name", 1, "string", False), ("version", 2, "string", False),
        ("extensions", 3, "string", True)),
    "ModelMetadataRequest": (("name", 1, "string", False), ("version", 2, "string", False)),
    "ModelMetadataResponse": (
        ("name", 1, "string", False), ("versions", 2, "string", True),
        ("platform", 3, "string", False),
        ("inputs", 4, "ModelMetadataResponse.TensorMetadata", True),
        ("outputs", 5, "ModelMetadataResponse.TensorMetadata", True)),
    "ModelMetadataResponse.TensorMetadata": (
        ("name", 1, "string", False), ("datatype", 2, "string", False),
        ("shape", 3, "int64", True)),
    "InferParameter": (
        ("bool_param", 1, "bool", False), ("int64_param", 2, "int64", False),
        ("string_param", 3, "string", False), ("double_param", 4, "double", False)),
    "InferTensorContents": (
        ("bool_contents", 1, "bool", True), ("int_contents", 2, "int32", True),
        ("int64_contents", 3, "int64", True), ("uint_contents", 4, "uint32", True),
        ("uint64_contents", 5, "uint64", True), ("fp32_contents", 6, "float", True),
        ("fp64_contents", 7, "double", True), ("bytes_contents", 8, "bytes", True)),
    "ModelInferRequest": (
        ("model_name", 1, "string", False), ("model_version", 2, "string", False),
        ("id", 3, "string", False), ("parameters", 4, _MAP, True),
        ("inputs", 5, "ModelInferRequest.InferInputTensor", True),
        ("outputs", 6, "ModelInferRequest.InferRequestedOutputTensor", True),
        ("raw_input_contents", 7, "bytes", True)),
    "ModelInferRequest.InferInputTensor": (
        ("name", 1, "string", False), ("datatype", 2, "string", False),
        ("shape", 3, "int64", True), ("parameters", 4, _MAP, True),
        ("contents", 5, "InferTensorContents", False)),
    "ModelInferRequest.InferRequestedOutputTensor": (
        ("name", 1, "string", False), ("parameters", 2, _MAP, True)),
    "ModelInferResponse": (
        ("model_name", 1, "string", False), ("model_version", 2, "string", False),
        ("id", 3, "string", False), ("parameters", 4, _MAP, True),
        ("outputs", 5, "ModelInferResponse.InferOutputTensor", True),
        ("raw_output_contents", 6, "bytes", True)),
    "ModelInferResponse.InferOutputTensor": (
        ("name", 1, "string", False), ("datatype", 2, "string", False),
        ("shape", 3, "int64", True), ("parameters", 4, _MAP, True),
        ("contents", 5, "InferTensorContents", False)),
    "ModelStreamInferResponse": (
        ("error_message", 1, "string", False),
        ("infer_response", 2, "ModelInferResponse", False)),
}
# message -> its oneof's name and members (a member is written when set)
ONEOFS = {"InferParameter": ("parameter_choice",
                             ("bool_param", "int64_param", "string_param", "double_param"))}

_CLASSES: dict[str, type] = {}


# --------------------------------------------------------------- varints


def _varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1  # a negative int32 / int64 is its 64-bit two's complement
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_varint(data, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _from_varint(typ: str, v: int):
    if typ == "bool":
        return v != 0
    if typ == "int32":
        return _signed(v, 32)
    if typ == "int64":
        return _signed(v, 64)
    if typ == "uint32":
        return v & 0xFFFFFFFF
    return v


def _pack_float(v: float) -> bytes:
    try:
        return struct.pack("<f", v)
    except OverflowError:  # past float32's range rounds to an infinity
        return struct.pack("<f", float("inf") if v > 0 else float("-inf"))


def _scalar_bytes(typ: str, v) -> bytes:
    """One scalar's payload without its tag."""
    if typ in _VARINT:
        out = bytearray()
        _varint(out, int(v))
        return bytes(out)
    if typ == "float":
        return _pack_float(v)
    if typ == "double":
        return struct.pack("<d", v)
    raise TypeError(typ)


def _map_cmp(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    if a[:n] != b[:n]:
        return -1 if a[:n] < b[:n] else 1
    return len(b) - len(a)  # a key that extends another comes first


_map_order = functools.cmp_to_key(lambda a, b: _map_cmp(a.encode(), b.encode()))


def _tag(out: bytearray, number: int, wire: int) -> None:
    _varint(out, number << 3 | wire)


def _len_field(out: bytearray, number: int, payload: bytes) -> None:
    _tag(out, number, 2)
    _varint(out, len(payload))
    out += payload


# -------------------------------------------------------------- messages


class Message:
    """Base of the KServe messages: the codec over the table of ``NAME``."""

    NAME: ClassVar[str] = ""

    def to_bytes(self) -> bytes:
        out = bytearray()
        oneof = ONEOFS.get(self.NAME, ("", ()))[1]
        for name, number, typ, repeated in _ALL_FIELDS[self.NAME]:
            v = getattr(self, name)
            if typ == _MAP:
                for key in sorted(v, key=_map_order):
                    entry = bytearray()
                    _len_field(entry, 1, key.encode("utf-8"))
                    _len_field(entry, 2, v[key].to_bytes())
                    _len_field(out, number, bytes(entry))
            elif repeated:
                if not v:
                    continue
                if typ in _WIRE and typ not in ("string", "bytes"):
                    if typ == "float":
                        payload = b"".join(_pack_float(x) for x in v)
                    elif typ == "double":
                        payload = struct.pack(f"<{len(v)}d", *v)
                    else:
                        buf = bytearray()
                        for x in v:
                            _varint(buf, int(x))
                        payload = bytes(buf)
                    _len_field(out, number, payload)
                else:
                    for x in v:
                        _len_field(out, number, _payload(typ, x))
            elif typ in SCALARS:
                if v is None or (name not in oneof and not v):
                    continue  # unset oneof member, or a proto3 default
                if typ in ("string", "bytes"):
                    _len_field(out, number, _payload(typ, v))
                else:
                    _tag(out, number, _WIRE[typ])
                    out += _scalar_bytes(typ, v)
            elif v is not None:
                _len_field(out, number, v.to_bytes())
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes):
        msg = cls()
        msg.merge_from_bytes(data)
        return msg

    def merge_from_bytes(self, data) -> None:
        """Parse ``data`` into this message, as protobuf's MergeFromString."""
        by_number = {f[1]: f for f in _ALL_FIELDS[self.NAME]}
        oneof = ONEOFS.get(self.NAME, ("", ()))[1]
        data = memoryview(data)
        pos, end = 0, len(data)
        while pos < end:
            key, pos = _read_varint(data, pos)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise ValueError("field number 0")
            f = by_number.get(number)
            if wire == 0:
                raw, pos = _read_varint(data, pos)
            elif wire == 1:
                raw, pos = data[pos:pos + 8], pos + 8
            elif wire == 5:
                raw, pos = data[pos:pos + 4], pos + 4
            elif wire == 2:
                n, pos = _read_varint(data, pos)
                raw, pos = data[pos:pos + n], pos + n
            else:
                raise ValueError(f"wire type {wire} (groups are not supported)")
            if pos > end:
                raise ValueError("truncated message")
            if f is None:
                continue  # an unknown field
            name, _, typ, repeated = f
            if typ == _MAP:
                entry = _MapEntry.from_bytes(raw)
                getattr(self, name)[entry.key] = entry.value or InferParameter()
                continue
            if typ not in SCALARS:
                if wire != 2:
                    raise ValueError(f"{self.NAME}.{name}: wire type {wire}")
                if repeated:
                    getattr(self, name).append(_CLASSES[typ].from_bytes(raw))
                else:
                    cur = getattr(self, name)
                    if cur is None:
                        cur = _CLASSES[typ]()
                        setattr(self, name, cur)
                    cur.merge_from_bytes(raw)
                continue
            if repeated and wire == 2 and typ not in ("string", "bytes"):
                vals = _unpack(typ, raw)  # packed
                getattr(self, name).extend(vals)
                continue
            if wire != _WIRE[typ]:
                raise ValueError(f"{self.NAME}.{name}: wire type {wire}")
            val = _decode(typ, raw)
            if repeated:
                getattr(self, name).append(val)
            else:
                if name in oneof:
                    for other in oneof:
                        setattr(self, other, None)
                setattr(self, name, val)


def _payload(typ: str, v) -> bytes:
    return v.encode("utf-8") if typ == "string" else bytes(v) if typ == "bytes" \
        else v.to_bytes()


def _decode(typ: str, raw):
    if typ in _VARINT:
        return _from_varint(typ, raw)
    if typ == "float":
        return struct.unpack("<f", raw)[0]
    if typ == "double":
        return struct.unpack("<d", raw)[0]
    if typ == "string":
        return bytes(raw).decode("utf-8")  # invalid UTF-8 raises, as protobuf's
    return bytes(raw)


def _unpack(typ: str, raw) -> list:
    if typ == "float":
        return list(struct.unpack(f"<{len(raw) // 4}f", raw)) if len(raw) % 4 == 0 \
            else _bad_packed(typ)
    if typ == "double":
        return list(struct.unpack(f"<{len(raw) // 8}d", raw)) if len(raw) % 8 == 0 \
            else _bad_packed(typ)
    out, pos = [], 0
    while pos < len(raw):
        v, pos = _read_varint(raw, pos)
        out.append(_from_varint(typ, v))
    return out


def _bad_packed(typ: str):
    raise ValueError(f"packed {typ} run of a partial element")


def _message(name: str):
    def register(cls):
        cls.NAME = name
        _CLASSES[name] = cls
        return cls
    return register


@_message("ServerLiveRequest")
@dataclass
class ServerLiveRequest(Message):
    pass


@_message("ServerLiveResponse")
@dataclass
class ServerLiveResponse(Message):
    live: bool = False


@_message("ServerReadyRequest")
@dataclass
class ServerReadyRequest(Message):
    pass


@_message("ServerReadyResponse")
@dataclass
class ServerReadyResponse(Message):
    ready: bool = False


@_message("ModelReadyRequest")
@dataclass
class ModelReadyRequest(Message):
    name: str = ""
    version: str = ""


@_message("ModelReadyResponse")
@dataclass
class ModelReadyResponse(Message):
    ready: bool = False


@_message("ServerMetadataRequest")
@dataclass
class ServerMetadataRequest(Message):
    pass


@_message("ServerMetadataResponse")
@dataclass
class ServerMetadataResponse(Message):
    name: str = ""
    version: str = ""
    extensions: list[str] = field(default_factory=list)


@_message("ModelMetadataRequest")
@dataclass
class ModelMetadataRequest(Message):
    name: str = ""
    version: str = ""


@_message("ModelMetadataResponse.TensorMetadata")
@dataclass
class TensorMetadata(Message):
    name: str = ""
    datatype: str = ""
    shape: list[int] = field(default_factory=list)


@_message("ModelMetadataResponse")
@dataclass
class ModelMetadataResponse(Message):
    TensorMetadata: ClassVar[type] = TensorMetadata
    name: str = ""
    versions: list[str] = field(default_factory=list)
    platform: str = ""
    inputs: list[TensorMetadata] = field(default_factory=list)
    outputs: list[TensorMetadata] = field(default_factory=list)


@_message("InferParameter")
@dataclass
class InferParameter(Message):
    """The ``parameter_choice`` oneof: at most one member is not None."""

    bool_param: bool | None = None
    int64_param: int | None = None
    string_param: str | None = None
    double_param: float | None = None

    def __post_init__(self):
        if sum(v is not None for v in (self.bool_param, self.int64_param,
                                       self.string_param, self.double_param)) > 1:
            raise ValueError("InferParameter: more than one member of parameter_choice")

    def which_oneof(self, name: str = "parameter_choice") -> str | None:
        """The set member's name (protobuf's ``WhichOneof``), or None."""
        if name != "parameter_choice":
            raise ValueError(f"InferParameter has no oneof {name!r}")
        return next((m for m in ONEOFS["InferParameter"][1]
                     if getattr(self, m) is not None), None)


@_message("InferTensorContents")
@dataclass
class InferTensorContents(Message):
    bool_contents: list[bool] = field(default_factory=list)
    int_contents: list[int] = field(default_factory=list)
    int64_contents: list[int] = field(default_factory=list)
    uint_contents: list[int] = field(default_factory=list)
    uint64_contents: list[int] = field(default_factory=list)
    fp32_contents: list[float] = field(default_factory=list)
    fp64_contents: list[float] = field(default_factory=list)
    bytes_contents: list[bytes] = field(default_factory=list)


@_message("ModelInferRequest.InferInputTensor")
@dataclass
class InferInputTensor(Message):
    name: str = ""
    datatype: str = ""
    shape: list[int] = field(default_factory=list)
    parameters: dict[str, InferParameter] = field(default_factory=dict)
    contents: InferTensorContents | None = None


@_message("ModelInferRequest.InferRequestedOutputTensor")
@dataclass
class InferRequestedOutputTensor(Message):
    name: str = ""
    parameters: dict[str, InferParameter] = field(default_factory=dict)


@_message("ModelInferRequest")
@dataclass
class ModelInferRequest(Message):
    InferInputTensor: ClassVar[type] = InferInputTensor
    InferRequestedOutputTensor: ClassVar[type] = InferRequestedOutputTensor
    model_name: str = ""
    model_version: str = ""
    id: str = ""
    parameters: dict[str, InferParameter] = field(default_factory=dict)
    inputs: list[InferInputTensor] = field(default_factory=list)
    outputs: list[InferRequestedOutputTensor] = field(default_factory=list)
    raw_input_contents: list[bytes] = field(default_factory=list)


@_message("ModelInferResponse.InferOutputTensor")
@dataclass
class InferOutputTensor(Message):
    name: str = ""
    datatype: str = ""
    shape: list[int] = field(default_factory=list)
    parameters: dict[str, InferParameter] = field(default_factory=dict)
    contents: InferTensorContents | None = None


@_message("ModelInferResponse")
@dataclass
class ModelInferResponse(Message):
    InferOutputTensor: ClassVar[type] = InferOutputTensor
    model_name: str = ""
    model_version: str = ""
    id: str = ""
    parameters: dict[str, InferParameter] = field(default_factory=dict)
    outputs: list[InferOutputTensor] = field(default_factory=list)
    raw_output_contents: list[bytes] = field(default_factory=list)


@_message("ModelStreamInferResponse")
@dataclass
class ModelStreamInferResponse(Message):
    error_message: str = ""
    infer_response: ModelInferResponse | None = None


@dataclass
class _MapEntry(Message):
    """A ``map<string, InferParameter>`` entry on the wire."""

    NAME: ClassVar[str] = "ParametersEntry"
    key: str = ""
    value: InferParameter | None = None


_ALL_FIELDS = {**FIELDS, "ParametersEntry": (
    ("key", 1, "string", False), ("value", 2, "InferParameter", False))}


def tensor_contents(msg: Any) -> InferTensorContents:
    """A tensor's ``contents``, empty when unset (protobuf's read of an
    unset message field)."""
    return msg.contents if msg.contents is not None else InferTensorContents()
