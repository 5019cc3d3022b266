"""The port's KServe gRPC frontend (dynamo_tpu_torch/grpc/) against the JAX
package's (dynamo_tpu/grpc/, on grpc.aio and protobuf), driven by a real
``grpc.aio`` client.

- tests/test_grpc.py's four cases (probes and unary infer, stream infer,
  tokens in and out, OpenAI passthrough) on a port stack and on a JAX
  stack, each a mocker echoing its prompt behind a ModelWatcher: every
  response equal as ``SerializeToString(deterministic=True)`` bytes with
  the random request ids and ``created`` times masked, every error the
  same code and details;
- the slice: a tiny llama (the peaked embedding of
  tests/test_quant_goldens.py) on shared weights, served by the port's
  worker behind the port's frontend and by the JAX engine behind the JAX
  frontend: greedy ``input_ids`` streams byte-equal, an over-quota tenant
  the same RESOURCE_EXHAUSTED with ``retry-after``;
- the wire: the field table against ``pb.DESCRIPTOR``, hypothesis-made
  messages byte-equal to protobuf's, packed and unpacked reads;
- HPACK: the Huffman table against grpc's own library, ``-bin`` metadata,
  dynamic-table eviction;
- HTTP/2 and gRPC behaviour against grpc.aio: a 1 MiB request and a 5 MiB
  one (past grpc's 4 MiB limit), a response past a small client window, 16
  streams on one channel, cancel, deadline, tenancy errors, an unknown
  method, gzip, ``stop()`` mid-stream (GOAWAY); and frames written by hand
  (SETTINGS, a window taken negative, CONTINUATION, padding, PING, a
  stream past MAX_CONCURRENT_STREAMS);
- chip_smoke.py's minimal client against grpc.aio on the same server;
- ``python -m dynamo_tpu_torch.frontend --grpc-port 0`` as a process.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import signal
import struct
import sys
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.grpc import KserveGrpcFrontend as JaxKserveFrontend
from dynamo_tpu.grpc import kserve_pb2 as pb
from dynamo_tpu_torch.grpc import KserveGrpcFrontend, h2, hpack, kserve
from dynamo_tpu_torch.grpc import server as gserver

pytestmark = pytest.mark.integration

ROOT = Path(__file__).resolve().parents[1]
SERVICE = "/inference.GRPCInferenceService"
MODEL = "grpc-model"
# the tiny llama of the slice: vocab past the mock tokenizer's byte ids
# (16..271), the embedding scaled as tests/test_quant_goldens.py's
SPEC_KW = dict(vocab_size=288, hidden_size=64, intermediate_size=128, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=16, dtype="float32")
CFG_KW = dict(page_size=4, num_pages=128, max_pages_per_seq=32, max_decode_slots=4,
              prefill_buckets=(16, 32, 64))
EMBED_SCALE = 32.0
QUOTAS = "q:rate=0.001,burst=8"  # tenant q: one request, then over quota


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ stacks


class _Stack:
    """A mocker worker echoing its prompt, a ModelWatcher and the package's
    KServe frontend on port 0, all on the running loop."""

    @classmethod
    async def start(cls, kind: str, speedup: float = 500.0) -> "_Stack":
        if kind == "port":
            from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
            from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
            from dynamo_tpu_torch.mocker.engine import MockEngineConfig
            from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
            from dynamo_tpu_torch.runtime.hub import InMemoryHub
            frontend = KserveGrpcFrontend
        else:
            from dynamo_tpu.frontend.watcher import ModelManager, ModelWatcher
            from dynamo_tpu.mocker.__main__ import launch_mock_worker
            from dynamo_tpu.mocker.engine import MockEngineConfig
            from dynamo_tpu.runtime.distributed import DistributedRuntime
            from dynamo_tpu.runtime.hub import InMemoryHub
            frontend = JaxKserveFrontend
        self = cls()
        self.drt = DistributedRuntime(InMemoryHub())
        cfg = MockEngineConfig(block_size=4, total_kv_blocks=512, speedup_ratio=speedup,
                               echo_prompt=True)
        self.engine, _ = await launch_mock_worker(
            self.drt, "dyn", "backend", "generate", cfg, model_name=MODEL,
            register_card=True)
        self.watcher = await ModelWatcher(self.drt, ModelManager()).start()
        await self.watcher.wait_for_model(MODEL, timeout=5)
        self.server = await frontend(self.watcher.manager, port=0).start()
        self.target = f"127.0.0.1:{self.server.port}"
        return self

    async def close(self) -> None:
        await self.server.stop()
        await self.watcher.close()
        await self.drt.close()


def _mask(data: bytes) -> bytes:
    """Serialized bytes with the random request ids and creation times
    replaced by placeholders of the same length."""
    data = re.sub(rb"chatcmpl-[0-9a-f]{24}", b"chatcmpl-" + b"x" * 24, data)
    return re.sub(rb'"created": \d+', lambda m: b'"created": ' + b"1" * (len(m[0]) - 11),
                  data)


def _bytes(msg) -> bytes:
    return _mask(msg.SerializeToString(deterministic=True))


async def _unary(chan, method, req, resp_cls, **kw):
    """("ok", masked bytes) or ("error", code name, details, trailing)."""
    call = chan.unary_unary(f"{SERVICE}/{method}",
                            request_serializer=type(req).SerializeToString,
                            response_deserializer=resp_cls.FromString)
    try:
        return ("ok", _bytes(await call(req, **kw)))
    except grpc.aio.AioRpcError as e:
        return ("error", e.code().name, e.details(), tuple(e.trailing_metadata() or ()))


async def _stream(chan, req, **kw):
    call = chan.unary_stream(f"{SERVICE}/ModelStreamInfer",
                             request_serializer=pb.ModelInferRequest.SerializeToString,
                             response_deserializer=pb.ModelStreamInferResponse.FromString)
    try:
        return ("ok", [_bytes(m) async for m in call(req, **kw)])
    except grpc.aio.AioRpcError as e:
        return ("error", e.code().name, e.details())


def _text_request(prompt: str, max_tokens: int = 6, rid: str = "req-1"):
    req = pb.ModelInferRequest(model_name=MODEL, id=rid, inputs=[
        pb.ModelInferRequest.InferInputTensor(
            name="text_input", datatype="BYTES", shape=[1],
            contents=pb.InferTensorContents(bytes_contents=[prompt.encode()]))])
    req.parameters["max_tokens"].int64_param = max_tokens
    req.parameters["ignore_eos"].bool_param = True
    req.parameters["temperature"].double_param = 0.0
    return req


def _ids_request(ids, max_tokens: int, rid: str = "tok-1"):
    req = pb.ModelInferRequest(model_name=MODEL, id=rid, inputs=[
        pb.ModelInferRequest.InferInputTensor(
            name="input_ids", datatype="INT32", shape=[len(ids)],
            contents=pb.InferTensorContents(int_contents=list(ids)))])
    req.parameters["max_tokens"].int64_param = max_tokens
    req.parameters["ignore_eos"].bool_param = True
    return req


def _openai_request(stream: bool, body=None):
    body = body or {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 5,
                    "temperature": 0.0, "ignore_eos": True, "stream": stream}
    return pb.ModelInferRequest(model_name=MODEL, inputs=[
        pb.ModelInferRequest.InferInputTensor(
            name="openai_request", datatype="BYTES", shape=[1],
            contents=pb.InferTensorContents(bytes_contents=[json.dumps(body).encode()]))])


async def _both(case):
    """``case(channel)`` on a port stack and on a JAX stack; both records."""
    out = {}
    for kind in ("port", "jax"):
        stack = await _Stack.start(kind)
        try:
            # the client sends past grpc's 4 MiB; the servers' own limit holds
            opts = [("grpc.max_send_message_length", 16 << 20)]
            async with grpc.aio.insecure_channel(stack.target, options=opts) as chan:
                out[kind] = await case(chan)
        finally:
            await stack.close()
    return out["port"], out["jax"]


# ------------------------------------------ the reference's four cases


async def test_probes_and_unary_infer_equal_jax():
    async def case(chan):
        return [
            await _unary(chan, "ServerLive", pb.ServerLiveRequest(), pb.ServerLiveResponse),
            await _unary(chan, "ServerReady", pb.ServerReadyRequest(), pb.ServerReadyResponse),
            await _unary(chan, "ServerMetadata", pb.ServerMetadataRequest(),
                         pb.ServerMetadataResponse),
            await _unary(chan, "ModelReady", pb.ModelReadyRequest(name=MODEL),
                         pb.ModelReadyResponse),
            await _unary(chan, "ModelReady", pb.ModelReadyRequest(name="nope"),
                         pb.ModelReadyResponse),
            await _unary(chan, "ModelMetadata", pb.ModelMetadataRequest(name=MODEL),
                         pb.ModelMetadataResponse),
            await _unary(chan, "ModelMetadata", pb.ModelMetadataRequest(name="nope"),
                         pb.ModelMetadataResponse),
            await _unary(chan, "ModelInfer", _text_request("hello grpc"),
                         pb.ModelInferResponse),
            await _unary(chan, "ModelInfer", _text_request("hello grpc"),
                         pb.ModelInferResponse),
            await _unary(chan, "ModelInfer", _text_request("x", rid=""),
                         pb.ModelInferResponse),
            await _unary(chan, "ModelInfer", pb.ModelInferRequest(model_name="nope"),
                         pb.ModelInferResponse),
        ]

    port, ref = await _both(case)
    assert port == ref
    assert pb.ServerLiveResponse.FromString(port[0][1]).live
    assert pb.ModelReadyResponse.FromString(port[3][1]).ready
    assert not pb.ModelReadyResponse.FromString(port[4][1]).ready
    meta = pb.ModelMetadataResponse.FromString(port[5][1])
    assert meta.inputs[0].name == "text_input" and meta.outputs[0].name == "text_output"
    assert port[6][:2] == ("error", "NOT_FOUND")
    resp = pb.ModelInferResponse.FromString(port[7][1])
    assert resp.outputs[0].name == "text_output"
    assert resp.parameters["output_tokens"].int64_param == 6
    assert port[7] == port[8]
    assert port[10][:2] == ("error", "NOT_FOUND")


async def test_stream_infer_equals_jax():
    async def case(chan):
        folded = _text_request("fold me", max_tokens=6)
        folded.inputs.append(pb.ModelInferRequest.InferInputTensor(
            name="streaming", datatype="BOOL", shape=[1],
            contents=pb.InferTensorContents(bool_contents=[False])))
        return [await _stream(chan, _text_request("stream me", max_tokens=8)),
                await _stream(chan, folded),
                await _stream(chan, pb.ModelInferRequest(model_name=MODEL))]

    port, ref = await _both(case)
    assert port == ref
    chunks = [pb.ModelStreamInferResponse.FromString(m) for m in port[0][1]]
    assert len(chunks) >= 2 and not any(c.error_message for c in chunks)
    assert sum(c.infer_response.parameters["triton_final_response"].bool_param
               for c in chunks) == 1
    (folded,) = [pb.ModelStreamInferResponse.FromString(m) for m in port[1][1]]
    assert folded.infer_response.parameters["output_tokens"].int64_param == 6
    assert pb.ModelStreamInferResponse.FromString(port[2][1][-1]).error_message


async def test_tokens_in_tokens_out_equal_jax():
    async def case(chan):
        req = _ids_request([21, 22, 23, 24, 25], 4)
        return [await _unary(chan, "ModelInfer", req, pb.ModelInferResponse),
                await _stream(chan, req)]

    port, ref = await _both(case)
    assert port == ref
    resp = pb.ModelInferResponse.FromString(port[0][1])
    ids = list({t.name: t for t in resp.outputs}["output_ids"].contents.int_contents)
    assert len(ids) == 4 and resp.parameters["output_tokens"].int64_param == 4
    streamed = [i for m in port[1][1] for t in
                pb.ModelStreamInferResponse.FromString(m).infer_response.outputs
                if t.name == "output_ids" for i in t.contents.int_contents]
    assert streamed == ids


async def test_openai_passthrough_equals_jax():
    async def case(chan):
        bad = _openai_request(False, body={"messages": "nope"})
        return [await _unary(chan, "ModelInfer", _openai_request(False),
                             pb.ModelInferResponse),
                await _stream(chan, _openai_request(True)),
                await _unary(chan, "ModelInfer", bad, pb.ModelInferResponse)]

    port, ref = await _both(case)
    assert port == ref
    agg = json.loads(pb.ModelInferResponse.FromString(port[0][1]).outputs[0]
                     .contents.bytes_contents[0])
    assert agg["object"] == "chat.completion" and agg["usage"]["completion_tokens"] == 5
    msgs = [pb.ModelStreamInferResponse.FromString(m).infer_response for m in port[1][1]]
    chunks = [json.loads(r.outputs[0].contents.bytes_contents[0]) for r in msgs]
    assert chunks[0]["object"] == "chat.completion.chunk"
    assert "length" in [c["choices"][0].get("finish_reason") for c in chunks if c["choices"]]
    assert [r.parameters["triton_final_response"].bool_param for r in msgs] == \
        [False] * (len(msgs) - 1) + [True]
    assert port[2][:2] == ("error", "INVALID_ARGUMENT")


# ----------------------------------------------------------- the slice


async def test_tiny_llama_streams_and_quota_equal_jax():
    """A tiny llama on shared weights: the port's worker behind the port's
    frontend, the JAX engine behind the JAX frontend. Greedy input_ids
    streams through ModelStreamInfer are byte-equal (so output_ids and
    text_output are equal); tenant q's request over its token quota gets
    the same RESOURCE_EXHAUSTED, details and retry-after."""
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
    from dynamo_tpu.frontend.model_card import register_llm as jax_register_llm
    from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
    from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.models.convert import params_from_numpy
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(5)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    tp = params_from_numpy(ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(16, 272, n).tolist() for n in (5, 11, 19)]

    async def drive(target):
        out = []
        async with grpc.aio.insecure_channel(target) as chan:
            for i, p in enumerate(prompts):
                out.append(await _stream(chan, _ids_request(p, 8, rid=f"s{i}")))
            # the first of tenant q's requests empties its bucket, the
            # second is over quota; retry-after depends on the clock
            q = _ids_request(prompts[2], 8, rid="q")
            for _ in range(2):
                res = await _unary(chan, "ModelInfer", q, pb.ModelInferResponse,
                                   metadata=(("x-dyn-tenant", "q"),))
                out.append(res[:3] + (sorted(dict(res[3:] and res[3]).keys()),)
                           if res[0] == "error" else res)
        return out

    jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW, tenants=QUOTAS), params=jp)
    jdrt = JaxRuntime(JaxHub())
    ep = jdrt.namespace("dynamo").component("backend").endpoint("generate")
    await jax_register_llm(jdrt, ep, jeng.generate, model_name=MODEL,
                           router_mode="round_robin",
                           context_length=jeng.config.max_context,
                           kv_block_size=CFG_KW["page_size"])
    await jeng.start()
    jwatch = await JaxModelWatcher(jdrt, JaxModelManager()).start()
    await jwatch.wait_for_model(MODEL, timeout=10)
    jfront = await JaxKserveFrontend(jwatch.manager, port=0).start()
    try:
        ref = await drive(f"127.0.0.1:{jfront.port}")
    finally:
        await jfront.stop()
        await jwatch.close()
        await jeng.close()
        await jdrt.close()

    drt = DistributedRuntime(InMemoryHub())
    eng, _ = await launch_engine_worker(
        drt, model_name=MODEL, spec=ModelSpec(**SPEC_KW),
        engine_config=EngineConfig(**CFG_KW, tenants=QUOTAS), params=tp, device="cpu",
        router_mode="round_robin")
    watch = await ModelWatcher(drt, ModelManager()).start()
    await watch.wait_for_model(MODEL, timeout=10)
    front = await KserveGrpcFrontend(watch.manager, port=0).start()
    try:
        got = await drive(f"127.0.0.1:{front.port}")
    finally:
        await front.stop()
        await watch.close()
        await eng.close()
        await drt.close()

    assert got == ref
    assert got[-2][0] == "ok"
    for status, msgs in got[:-2]:
        resps = [pb.ModelStreamInferResponse.FromString(m).infer_response for m in msgs]
        ids = [i for r in resps for t in r.outputs if t.name == "output_ids"
               for i in t.contents.int_contents]
        assert status == "ok" and len(ids) == 8
    status, code, details, trailing = got[-1]
    assert code == "RESOURCE_EXHAUSTED" and details == \
        "tenant 'q' over token quota (cost 27 tokens)" and "retry-after" in trailing


# ------------------------------------------------------------- the wire


def _descriptor_table():
    def type_name(f):
        if f.message_type is not None:
            if f.message_type.GetOptions().map_entry:
                key, value = f.message_type.fields_by_name["key"], \
                    f.message_type.fields_by_name["value"]
                assert key.type == key.TYPE_STRING
                return f"map<string,{value.message_type.name}>"
            return f.message_type.full_name.split(".", 1)[1]
        return {f.TYPE_BOOL: "bool", f.TYPE_INT32: "int32", f.TYPE_INT64: "int64",
                f.TYPE_UINT32: "uint32", f.TYPE_UINT64: "uint64", f.TYPE_FLOAT: "float",
                f.TYPE_DOUBLE: "double", f.TYPE_STRING: "string",
                f.TYPE_BYTES: "bytes"}[f.type]

    table, oneofs = {}, {}

    def walk(m):
        if m.GetOptions().map_entry:
            return
        name = m.full_name.split(".", 1)[1]
        table[name] = tuple((f.name, f.number, type_name(f), f.is_repeated)
                            for f in m.fields)
        for o in m.oneofs:
            oneofs[name] = (o.name, tuple(f.name for f in o.fields))
        for n in m.nested_types:
            walk(n)

    for m in pb.DESCRIPTOR.message_types_by_name.values():
        walk(m)
    return table, oneofs


def test_field_table_equals_the_descriptor():
    table, oneofs = _descriptor_table()
    assert kserve.FIELDS == table
    assert kserve.ONEOFS == oneofs
    assert len(table) == 19  # 15 messages and 4 nested ones


_TEXT = st.text(max_size=6)
_SCALAR = {
    "bool": st.booleans(), "int32": st.integers(-2**31, 2**31 - 1),
    "int64": st.integers(-2**63, 2**63 - 1), "uint32": st.integers(0, 2**32 - 1),
    "uint64": st.integers(0, 2**64 - 1),
    "float": st.floats(width=32, allow_nan=False), "double": st.floats(allow_nan=False),
    "string": _TEXT, "bytes": st.binary(max_size=6),
}


def _strategy(name: str, depth: int = 0):
    cls = kserve._CLASSES[name]
    if name == "InferParameter":
        members = kserve.ONEOFS[name][1]
        types = dict((f[0], f[2]) for f in kserve.FIELDS[name])
        return st.one_of(st.just(cls()), *(
            _SCALAR[types[m]].map(lambda v, m=m: cls(**{m: v})) for m in members))
    fields = {}
    for fname, _num, typ, repeated in kserve.FIELDS[name]:
        if typ.startswith("map<"):
            fields[fname] = st.dictionaries(_TEXT, _strategy("InferParameter"), max_size=3)
        elif typ in _SCALAR:
            fields[fname] = st.lists(_SCALAR[typ], max_size=4) if repeated else _SCALAR[typ]
        elif depth > 1:
            fields[fname] = st.just([] if repeated else None)
        else:
            sub = _strategy(typ, depth + 1)
            fields[fname] = st.lists(sub, max_size=2) if repeated else st.none() | sub
    return st.builds(cls, **fields)


def _to_pb(msg, target=None):
    """The protobuf message of a port message (set fields only)."""
    name = msg.NAME
    if target is None:
        target = pb
        for part in name.split("."):
            target = getattr(target, part)
        target = target()
    oneof = kserve.ONEOFS.get(name, ("", ()))[1]
    for fname, _num, typ, repeated in kserve.FIELDS[name]:
        v = getattr(msg, fname)
        if typ.startswith("map<"):
            for key, param in v.items():
                entry = getattr(target, fname)[key]
                entry.SetInParent()
                _to_pb(param, entry)
        elif typ in _SCALAR:
            if repeated:
                getattr(target, fname).extend(v)
            elif fname in oneof:
                if v is not None:
                    setattr(target, fname, v)
            else:
                setattr(target, fname, v)
        elif repeated:
            for item in v:
                _to_pb(item, getattr(target, fname).add())
        elif v is not None:
            getattr(target, fname).SetInParent()
            _to_pb(v, getattr(target, fname))
    return target


def _same(a, b) -> bool:
    """Port messages equal, -0.0 and 0.0 told apart (protobuf does)."""
    return a.to_bytes() == b.to_bytes() and a == b


@pytest.mark.parametrize("name", sorted(kserve.FIELDS))
def test_message_bytes_equal_protobuf(name):
    @settings(max_examples=40, deadline=None,
              suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
    @given(_strategy(name))
    def check(msg):
        ref = _to_pb(msg)
        data = ref.SerializeToString(deterministic=True)
        assert msg.to_bytes() == data
        back = kserve._CLASSES[name].from_bytes(data)
        assert _same(back, msg)
        assert type(ref).FromString(msg.to_bytes()) == ref

    check()


def _unpacked(field: int, typ: str, values) -> bytes:
    out = bytearray()
    for v in values:
        if typ in ("float", "double"):
            kserve._tag(out, field, 5 if typ == "float" else 1)
            out += struct.pack("<f" if typ == "float" else "<d", v)
        else:
            kserve._tag(out, field, 0)
            kserve._varint(out, int(v))
    return bytes(out)


def test_packed_and_unpacked_and_unknown_fields_read_as_protobuf():
    """Every repeated scalar of InferTensorContents written unpacked, then
    packed, plus unknown fields of each wire type: the port reads what
    protobuf reads."""
    vals = {"bool_contents": [True, False, True], "int_contents": [-1, 7, -2**31],
            "int64_contents": [-2**63, 3], "uint_contents": [2**32 - 1, 0],
            "uint64_contents": [2**64 - 1, 5], "fp32_contents": [1.5, -0.0],
            "fp64_contents": [2.25, -1e300]}
    types = {f[0]: (f[1], f[2]) for f in kserve.FIELDS["InferTensorContents"]}
    unpacked = b"".join(_unpacked(*types[k], v) for k, v in vals.items())
    unknown = bytearray()
    kserve._tag(unknown, 99, 0)
    kserve._varint(unknown, 300)
    kserve._len_field(unknown, 100, b"skip me")
    kserve._tag(unknown, 101, 5)
    unknown += b"\x00" * 4
    kserve._tag(unknown, 102, 1)
    unknown += b"\x00" * 8
    packed = pb.InferTensorContents(**vals).SerializeToString()
    for data in (unpacked, packed, bytes(unknown) + unpacked + packed):
        ref = pb.InferTensorContents.FromString(data)
        ref.DiscardUnknownFields()  # protobuf keeps them; the port skips them
        got = kserve.InferTensorContents.from_bytes(data)
        assert got.to_bytes() == ref.SerializeToString(deterministic=True)
        for k in vals:
            assert list(getattr(got, k)) == list(getattr(ref, k))
    # a singular message field met twice merges, as protobuf merges
    a = pb.ModelStreamInferResponse(infer_response=pb.ModelInferResponse(model_name="m"))
    b = pb.ModelStreamInferResponse(infer_response=pb.ModelInferResponse(id="i"))
    data = a.SerializeToString() + b.SerializeToString()
    assert kserve.ModelStreamInferResponse.from_bytes(data).to_bytes() == \
        pb.ModelStreamInferResponse.FromString(data).SerializeToString(deterministic=True)


# ------------------------------------------------------------------- HPACK


def test_huffman_table_equals_grpcs_library():
    """The 257 (code, length) pairs derived from the port's lengths equal
    the table compiled into grpc's C core, found by its first two entries."""
    lib = Path(grpc._cython.cygrpc.__file__).read_bytes()
    first = struct.pack("<IIII", 0x1FF8, 13, 0x7FFFD8, 23)
    at = lib.find(first)
    if at < 0:
        pytest.skip("the Huffman table's pattern is not in this grpc build")
    table = [struct.unpack_from("<II", lib, at + 8 * i) for i in range(257)]
    assert hpack.huffman_codes() == table
    assert table[hpack.EOS] == (0x3FFFFFFF, 30)


def _huffman_encode(data: bytes) -> bytes:
    """``data`` Huffman-coded, padded with EOS's leading ones."""
    codes, acc, bits = hpack.huffman_codes(), 0, 0
    for b in data:
        code, n = codes[b]
        acc, bits = acc << n | code, bits + n
    pad = -bits % 8
    return (acc << pad | (1 << pad) - 1).to_bytes((bits + pad) // 8, "big")


def test_huffman_padding_and_eos_are_refused():
    text = bytes(range(256)) + b"www.example.com"
    assert hpack.huffman_decode(_huffman_encode(text)) == text
    enc = _huffman_encode(b"a")  # 5 bits of code, 3 of padding
    assert hpack.huffman_decode(enc) == b"a"
    with pytest.raises(hpack.HpackError, match="longer than 7"):
        hpack.huffman_decode(enc + b"\xff")
    with pytest.raises(hpack.HpackError, match="EOS's prefix"):
        hpack.huffman_decode(bytes([enc[0] & 0xF8]))
    eos = (0x3FFFFFFF << 2 | 0x3).to_bytes(4, "big")  # EOS, then 2 bits of padding
    with pytest.raises(hpack.HpackError, match="EOS inside"):
        hpack.huffman_decode(eos)


def test_dynamic_table_eviction_at_a_small_size():
    """Literals with incremental indexing into a 100-octet table: each new
    entry evicts the oldest; a size update shrinks it; an index past the
    table is an error; the encoder's size update reaches the decoder."""
    dec = hpack.Decoder(max_table_size=100)

    def literal(name, value):
        return bytes(hpack.encode_int(0, 6, 0x40) + hpack._encode_string(name.encode())
                     + hpack._encode_string(value.encode()))

    size_update = bytes(hpack.encode_int(100, 5, 0x20))
    assert dec.decode(size_update + literal("aaaa", "1111")) == [("aaaa", "1111")]
    assert dec.decode(literal("bbbb", "2222")) == [("bbbb", "2222")]  # 40 + 40 octets
    assert dec.decode(bytes(hpack.encode_int(62, 7, 0x80))) == [("bbbb", "2222")]
    assert dec.decode(bytes(hpack.encode_int(63, 7, 0x80))) == [("aaaa", "1111")]
    dec.decode(literal("cccc", "3333"))  # evicts aaaa
    assert [e[0] for e in dec.table.entries] == ["cccc", "bbbb"]
    with pytest.raises(hpack.HpackError):
        dec.decode(bytes(hpack.encode_int(64, 7, 0x80)))
    dec.decode(bytes(hpack.encode_int(50, 5, 0x20)))
    assert dec.table.entries == [("cccc", "3333")] and dec.table.size == 40
    with pytest.raises(hpack.HpackError, match="above"):
        dec.decode(bytes(hpack.encode_int(101, 5, 0x20)))
    enc = hpack.Encoder()
    enc.set_max_table_size(100)
    headers = [(":status", "200"), ("grpc-status", "0"), ("content-type", "application/grpc"),
               ("grpc-message", "x")]
    first, second = enc.encode(headers), enc.encode(headers)
    dec = hpack.Decoder(max_table_size=100)
    assert dec.decode(first) == headers and dec.decode(second) == headers
    assert len(second) < len(first)  # the repeated headers go by index


async def _bare_server(methods: dict):
    srv = gserver.Server()
    srv.add_service("t.T", methods)
    return srv, await srv.start("127.0.0.1", 0)


async def test_bin_metadata_decodes_to_its_bytes():
    """grpc base64-encodes a -bin value and Huffman-codes its headers: the
    handler reads the caller's bytes back through invocation_metadata."""
    seen = {}

    async def echo(req, ctx):
        seen.update(ctx.invocation_metadata())
        return req

    srv, port = await _bare_server({"Echo": gserver.unary_unary(echo, bytes, bytes)})
    blob = bytes(range(256)) * 3
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as chan:
            got = await chan.unary_unary("/t.T/Echo")(
                b"ping", metadata=(("trace-bin", blob), ("x-dyn-tenant", "team-a")))
    finally:
        await srv.stop(0)
    assert got == b"ping"
    assert seen["trace-bin"] == blob and seen["x-dyn-tenant"] == "team-a"
    assert "user-agent" in seen and not any(k.startswith(":") for k in seen)


# --------------------------------------------- HTTP/2 and gRPC behaviour


async def test_large_requests_equal_jax():
    """A 1 MiB input_ids request (past the 65,535-byte initial window) is
    read whole: the answer names its token count, as the JAX frontend's. A
    5 MiB one is past grpc's 4 MiB receive limit: RESOURCE_EXHAUSTED with
    grpc's details."""
    ids = [2**31 - 1] * (1024 * 1024 // 5)  # 5-byte varints

    async def case(chan):
        return [await _unary(chan, "ModelInfer", _ids_request(ids, 4), pb.ModelInferResponse),
                await _unary(chan, "ModelInfer", _text_request("x" * (5 << 20)),
                             pb.ModelInferResponse)]

    port, ref = await _both(case)
    assert port == ref
    assert port[0][0] == "error" and f"({len(ids)} tokens)" in port[0][2]
    assert port[1][1] == "RESOURCE_EXHAUSTED" and "larger than max" in port[1][2]


async def test_raw_frames_settings_windows_continuation_and_refused_streams(monkeypatch):
    """Frames written by hand: an unknown SETTINGS id is ignored and ACKed,
    a PING is ACKed, a request's header block split over HEADERS (padded,
    with priority) and CONTINUATION and its padded DATA are read; a
    response stops at the stream's 1,000-byte window, a later
    INITIAL_WINDOW_SIZE of 0 takes that window to -1,000 (a WINDOW_UPDATE
    of 500 leaves it negative: nothing moves), and one of 200,000 lets the
    rest through. A second stream past MAX_CONCURRENT_STREAMS (1) is
    refused with RST_STREAM."""
    blob = os.urandom(100_000)
    release = asyncio.Event()

    async def big(req, ctx):
        assert req == b"hello"
        await release.wait()
        return blob

    monkeypatch.setattr(gserver, "MAX_CONCURRENT_STREAMS", 1)
    srv, port = await _bare_server({"Big": gserver.unary_unary(big, bytes, bytes)})
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    enc, dec = hpack.Encoder(), hpack.Decoder()

    def settings(**kv):
        ids = {"window": h2.INITIAL_WINDOW_SIZE, "unknown": 0xFE03}
        return h2.frame(h2.SETTINGS, 0, 0, h2.settings_payload(
            {ids[k]: v for k, v in kv.items()}))

    async def frames_until(pred, limit=5.0):
        got = []
        while True:
            f = await asyncio.wait_for(h2.read_frame(reader, 1 << 20), limit)
            got.append(f)
            if pred(f):
                return got

    def request_block():
        return enc.encode([(":method", "POST"), (":scheme", "http"), (":path", "/t.T/Big"),
                           (":authority", "x"), ("content-type", "application/grpc"),
                           ("te", "trailers")])

    try:
        writer.write(h2.PREFACE + settings(window=1000, unknown=7)
                     + h2.frame(h2.PING, 0, 0, b"12345678"))
        got = await frames_until(lambda f: f[0] == h2.PING)
        assert (h2.SETTINGS, h2.ACK) in [(f[0], f[1]) for f in got]
        assert got[-1][1] == h2.ACK and got[-1][3] == b"12345678"
        block = request_block()
        head = bytes([3]) + struct.pack(">IB", 0, 15) + block[:7] + b"\0" * 3
        body = gserver.frame_message(b"hello")
        writer.write(h2.frame(h2.HEADERS, h2.PADDED | h2.PRIORITY_FLAG, 1, head)
                     + h2.frame(h2.CONTINUATION, h2.END_HEADERS, 1, block[7:])
                     + h2.frame(h2.DATA, h2.PADDED | h2.END_STREAM, 1,
                                bytes([4]) + body + b"\0" * 4))
        # a second stream while the first is open: refused
        writer.write(h2.header_frames(3, request_block(), True, 16384))
        got = await frames_until(lambda f: f[0] == h2.RST_STREAM)
        assert got[-1][2] == 3 and struct.unpack(">I", got[-1][3])[0] == h2.REFUSED_STREAM
        release.set()
        got = await frames_until(lambda f: f[0] == h2.DATA and f[2] == 1)
        data = b"".join(f[3] for f in got if f[0] == h2.DATA)
        (head,) = [f for f in got if f[0] == h2.HEADERS]
        assert dict(dec.decode(head[3]))[":status"] == "200"
        await asyncio.sleep(0.2)
        assert len(data) == 1000  # the stream's window
        writer.write(settings(window=0)
                     + h2.frame(h2.WINDOW_UPDATE, 0, 1, struct.pack(">I", 500)))
        await asyncio.sleep(0.2)
        writer.write(h2.frame(h2.WINDOW_UPDATE, 0, 0, struct.pack(">I", 1 << 20)))
        got = await frames_until(lambda f: f[0] == h2.SETTINGS and f[1] == h2.ACK)
        assert not [f for f in got if f[0] == h2.DATA]  # -1,000 + 500 < 0
        writer.write(settings(window=200_000))
        got = await frames_until(lambda f: f[0] == h2.HEADERS and f[1] & h2.END_STREAM)
        data += b"".join(f[3] for f in got if f[0] == h2.DATA)
        trailers = dict(dec.decode(got[-1][3]))
        assert trailers["grpc-status"] == "0"
        assert data == gserver.frame_message(blob)
    finally:
        writer.close()
        await srv.stop(0)


async def test_response_past_a_small_client_window(monkeypatch):
    """A 256 KiB response to a client whose stream window is 1 KiB (BDP
    probing off): the server waits for WINDOW_UPDATEs and the bytes arrive
    whole."""
    waits = []
    real = h2.Connection.wait_window

    async def wait_window(self):
        waits.append(1)
        await real(self)

    monkeypatch.setattr(h2.Connection, "wait_window", wait_window)
    blob = os.urandom(256 * 1024)

    async def big(req, ctx):
        return blob

    srv, port = await _bare_server({"Big": gserver.unary_unary(big, bytes, bytes)})
    try:
        opts = [("grpc.http2.lookahead_bytes", 1024), ("grpc.http2.bdp_probe", 0)]
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}", options=opts) as chan:
            got = await chan.unary_unary("/t.T/Big")(b"")
    finally:
        await srv.stop(0)
    assert got == blob and len(waits) > 0


async def test_sixteen_concurrent_streams_on_one_channel():
    stack = await _Stack.start("port")
    try:
        async with grpc.aio.insecure_channel(stack.target) as chan:
            reqs = [_text_request(f"prompt {i:02d} " * 3, max_tokens=12, rid=f"r{i}")
                    for i in range(16)]
            alone = [await _stream(chan, r) for r in reqs[:2]]
            together = await asyncio.gather(*(_stream(chan, r) for r in reqs))
    finally:
        await stack.close()
    assert together[:2] == alone
    for status, msgs in together:
        last = pb.ModelStreamInferResponse.FromString(msgs[-1]).infer_response
        assert status == "ok" and last.parameters["triton_final_response"].bool_param


async def _running(engine, want: int, within: float) -> float:
    t0 = asyncio.get_running_loop().time()
    while engine._running != want:
        assert asyncio.get_running_loop().time() - t0 < within, engine._running
        await asyncio.sleep(0.01)
    return asyncio.get_running_loop().time() - t0


async def test_cancel_after_the_third_chunk_stops_the_worker():
    stack = await _Stack.start("port", speedup=5.0)
    try:
        async with grpc.aio.insecure_channel(stack.target) as chan:
            call = chan.unary_stream(
                f"{SERVICE}/ModelStreamInfer",
                request_serializer=pb.ModelInferRequest.SerializeToString,
                response_deserializer=pb.ModelStreamInferResponse.FromString)(
                    _text_request("a long stream " * 8, max_tokens=100))
            n = 0
            async for _ in call:
                n += 1
                if n == 3:
                    assert stack.engine._running == 1
                    call.cancel()
                    break
            await _running(stack.engine, 0, 2.0)
    finally:
        await stack.close()


async def test_deadline_exceeded_and_the_worker_stops():
    stack = await _Stack.start("port", speedup=5.0)
    try:
        async with grpc.aio.insecure_channel(stack.target) as chan:
            got = await _stream(chan, _text_request("slow " * 8, max_tokens=100), timeout=0.05)
            unary = await _unary(chan, "ModelInfer", _text_request("slow " * 8, max_tokens=100),
                                 pb.ModelInferResponse, timeout=0.05)
            await _running(stack.engine, 0, 2.0)
    finally:
        await stack.close()
    assert got[:2] == ("error", "DEADLINE_EXCEEDED")
    assert unary[:2] == ("error", "DEADLINE_EXCEEDED")


async def test_tenancy_errors_and_unknown_method_equal_jax():
    async def case(chan):
        bad = await _unary(chan, "ModelInfer", _text_request("hi"), pb.ModelInferResponse,
                           metadata=(("x-dyn-tenant", "not a tenant!"),))
        prio = await _unary(chan, "ModelInfer", _text_request("hi"), pb.ModelInferResponse,
                            metadata=(("x-dyn-priority", "urgent"),))
        try:
            await chan.unary_unary(f"{SERVICE}/NoSuchMethod")(b"")
            unknown = None
        except grpc.aio.AioRpcError as e:
            unknown = (e.code().name, e.details())
        return [bad[:3], prio[:3], unknown]

    port, ref = await _both(case)
    assert port == ref
    assert port[0][1] == port[1][1] == "INVALID_ARGUMENT"
    assert port[2] == ("UNIMPLEMENTED", "Method not found!")


async def test_gzip_request_equals_the_plain_one(monkeypatch):
    inflated = []
    real = gserver.decompress

    def decompress(data, encoding):
        inflated.append(encoding)
        return real(data, encoding)

    monkeypatch.setattr(gserver, "decompress", decompress)
    stack = await _Stack.start("port")
    try:
        async with grpc.aio.insecure_channel(stack.target) as chan:
            req = _text_request("compress me " * 20, max_tokens=6)
            plain = await _unary(chan, "ModelInfer", req, pb.ModelInferResponse)
            gz = await _unary(chan, "ModelInfer", req, pb.ModelInferResponse,
                              compression=grpc.Compression.Gzip)
    finally:
        await stack.close()
    assert plain[0] == "ok" and gz == plain and inflated == ["gzip"]


async def test_stop_mid_stream_sends_goaway_and_ends_within_grace():
    """``stop()`` while streams run: the minimal client sees GOAWAY; both
    its stream and grpc.aio's end within the 1 s grace (plus slack)."""
    import chip_smoke

    stack = await _Stack.start("port", speedup=2.0)
    loop = asyncio.get_running_loop()
    try:
        client = await chip_smoke.GrpcClient().connect(stack.server.port)
        req = kserve.ModelInferRequest.from_bytes(
            _text_request("a slow stream " * 8, max_tokens=200).SerializeToString())
        started = asyncio.Event()

        async def on_message(n):
            started.set()

        raw = loop.create_task(client.call("ModelStreamInfer", req.to_bytes(),
                                           on_message=on_message))
        async with grpc.aio.insecure_channel(stack.target) as chan:
            aio = loop.create_task(_stream(chan, _text_request("slow " * 8, max_tokens=200)))
            await asyncio.wait_for(started.wait(), 10)
            await asyncio.sleep(0.1)
            t0 = loop.time()
            await stack.server.stop()
            out = await asyncio.wait_for(raw, 5)
            aio_out = await asyncio.wait_for(aio, 5)
            took = loop.time() - t0
        await client.close()
    finally:
        await stack.watcher.close()
        await stack.drt.close()
    assert client.goaway is not None and client.goaway[1] == h2.NO_ERROR
    assert out["messages"] and (out["status"] is not None or out["reset"] is not None)
    assert aio_out[0] == "error" or aio_out[1]
    assert took < 2.5


async def test_chip_smoke_client_equals_grpc_aio():
    """chip_smoke.py's minimal client and grpc.aio on the same server: the
    same messages (ids masked) and statuses."""
    import chip_smoke

    stack = await _Stack.start("port")
    calls = [
        ("ServerLive", pb.ServerLiveRequest(), pb.ServerLiveResponse, False),
        ("ServerReady", pb.ServerReadyRequest(), pb.ServerReadyResponse, False),
        ("ModelReady", pb.ModelReadyRequest(name=MODEL), pb.ModelReadyResponse, False),
        ("ModelMetadata", pb.ModelMetadataRequest(name=MODEL), pb.ModelMetadataResponse,
         False),
        ("ModelInfer", _text_request("hello smoke"), pb.ModelInferResponse, False),
        ("ModelInfer", pb.ModelInferRequest(model_name="nope"), pb.ModelInferResponse, False),
        ("ModelStreamInfer", _ids_request([30, 31, 32, 33], 6), pb.ModelStreamInferResponse,
         True),
        ("ModelStreamInfer", _openai_request(True), pb.ModelStreamInferResponse, True),
    ]
    try:
        client = await chip_smoke.GrpcClient().connect(stack.server.port)
        async with grpc.aio.insecure_channel(stack.target) as chan:
            for method, req, resp_cls, streaming in calls:
                mine = await client.call(method, req.SerializeToString())
                if streaming:
                    ref = await _stream(chan, req)
                    assert mine["status"] == 0 and ref[0] == "ok"
                    assert [_bytes(resp_cls.FromString(m)) for m in mine["messages"]] == ref[1]
                else:
                    ref = await _unary(chan, method, req, resp_cls)
                    if ref[0] == "ok":
                        assert mine["status"] == 0
                        assert [_bytes(resp_cls.FromString(m)) for m in mine["messages"]] \
                            == [ref[1]]
                    else:
                        assert (gserver.StatusCode(mine["status"]).name, mine["details"]) \
                            == ref[1:3]
            deadline = await client.call("ModelInfer", _text_request("x" * 2000, 2000)
                                         .SerializeToString(), timeout_ms=50)
        await client.close()
    finally:
        await stack.close()
    assert deadline["status"] == gserver.StatusCode.DEADLINE_EXCEEDED


# ----------------------------------------------------------- entry point


async def test_frontend_process_serves_grpc_and_exits_on_sigterm():
    from dynamo_tpu_torch.runtime.hub_server import HubServer

    hub = HubServer()
    host, port = await hub.start()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.frontend", "--hub", f"{host}:{port}",
        "--port", "0", "--host", "127.0.0.1", "--grpc-port", "0", cwd=ROOT,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)
    try:
        lines = []
        while True:
            line = (await asyncio.wait_for(proc.stdout.readline(), 30)).decode()
            assert line, lines
            lines.append(line)
            if line.startswith("DYNAMO_GRPC="):
                target = line.strip().split("=", 1)[1]
                break
        assert any(ln.startswith("DYNAMO_HTTP=") for ln in lines)
        async with grpc.aio.insecure_channel(target) as chan:
            live = await _unary(chan, "ServerLive", pb.ServerLiveRequest(),
                                pb.ServerLiveResponse)
            ready = await _unary(chan, "ServerReady", pb.ServerReadyRequest(),
                                 pb.ServerReadyResponse)
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.wait_for(proc.wait(), 30)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        await hub.stop()
    assert live == ("ok", pb.ServerLiveResponse(live=True).SerializeToString())
    assert ready == ("ok", b"")  # no model yet: ready is false, the empty message
    assert rc == 0
