"""The port's cross-process runtime (framing, endpoint transport, TCP hub
server and client, DistributedRuntime over a RemoteHub) on loopback.

Port counterparts of the JAX package's TCP tests (tests/test_stream_plane.py,
tests/test_runtime.py): framing EOF and oversize, FrameFeeder splits, one
flush per tick, coalescing, golden item order, error placement, typed
errors, cancel, mid-stream death then migration, backpressure, garbage then
a valid peer, UDS; remote hub round trip, TCP call with cancellation,
StreamError on worker death, push router, lease expiry.

Interop, all four directions: the same hub script through the JAX
``RemoteHub`` against the port's ``HubServer`` and the port's ``RemoteHub``
against the JAX ``HubServer``, and the same streams through the JAX
``InstanceChannel`` against the port's ``EndpointServer`` and the reverse,
each held against the JAX-JAX transcript. Both sides speak msgpack bytes:
the JAX package through msgpack, the port through its stdlib codec.
"""

import asyncio
import os
import socket
import struct

import pytest

from dynamo_tpu.runtime import framing as jax_framing
from dynamo_tpu.runtime import hub_client as jax_hub_client
from dynamo_tpu.runtime import hub_server as jax_hub_server
from dynamo_tpu.runtime import transport as jax_transport
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.context import ServiceUnavailable as JaxUnavailable
from dynamo_tpu.runtime.context import StreamError as JaxStreamError
from dynamo_tpu_torch.runtime import framing, hub_client, hub_server, transport
from dynamo_tpu_torch.runtime.component import Instance
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import (
    Context,
    ServiceUnavailable,
    StreamError,
)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import KeyExists
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer
from dynamo_tpu_torch.runtime.push import NoInstancesError, PushRouter, RouterMode
from dynamo_tpu_torch.runtime.transport import EndpointServer, InstanceChannel

pytestmark = pytest.mark.unit


# ------------------------------------------------------------ helpers


async def _tcp_pair(**cfg_kwargs):
    """HubServer + worker/client DistributedRuntimes over real TCP."""
    server = HubServer(port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"
    cfg = RuntimeConfig(hub_address=addr, **cfg_kwargs)
    worker = DistributedRuntime(await RemoteHub.connect(addr), cfg)
    client = DistributedRuntime(await RemoteHub.connect(addr), cfg)
    return server, worker, client


async def _close_pair(server, worker, client):
    await client.close()
    await worker.close()
    await server.stop()


async def _collect(server_coalesce: bool, handler, payload=None, first_n=None):
    """Serve ``handler`` on a raw EndpointServer (coalescing on/off) and
    collect (items, exception) from one InstanceChannel call."""
    srv = EndpointServer(coalesce=server_coalesce)
    srv.register("ep", handler)
    host, port = await srv.start()
    ch = InstanceChannel(host, port)
    await ch.connect()
    items, exc = [], None
    try:
        async for item in ch.call("ep", payload, Context()):
            items.append(item)
            if first_n is not None and len(items) >= first_n:
                break
    except Exception as e:  # noqa: BLE001 - the exception IS the golden
        exc = e
    await ch.close()
    await srv.stop(drain=False)
    return items, exc


# ------------------------------------------------------------ framing


async def test_framing_partial_header_and_truncated_body_are_clean_eof():
    for data in (b"\x00\x01", struct.pack(">I", 100) + b"short"):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        assert await framing.read_frame(reader) is None


async def test_framing_oversize_frame_rejected():
    reader = asyncio.StreamReader()
    reader.feed_data(struct.pack(">I", framing.MAX_FRAME + 1))
    with pytest.raises(ValueError, match="frame too large"):
        await framing.read_frame(reader)


def test_frame_feeder_reassembles_across_arbitrary_chunk_splits():
    frames = [{"kind": "data", "ch": i, "payload": "x" * (i * 7)} for i in range(5)]
    wire = b"".join(framing.pack(f) for f in frames)
    assert wire == b"".join(jax_framing.pack(f) for f in frames)
    for step in (1, 2, 3, 5, 11, len(wire)):
        feeder = framing.FrameFeeder()
        got = []
        for off in range(0, len(wire), step):
            got.extend(feeder.feed(wire[off:off + step]))
        assert [m for m, _ in got] == frames, f"chunk step {step}"
        assert sum(n for _, n in got) == len(wire)
        assert feeder.pending_bytes == 0


def test_frame_feeder_holds_partial_tail_and_rejects_oversize():
    feeder = framing.FrameFeeder()
    wire = framing.pack({"kind": "end", "ch": 1})
    assert feeder.feed(wire[:5]) == []
    assert feeder.pending_bytes == 5
    assert [m for m, _ in feeder.feed(wire[5:])] == [{"kind": "end", "ch": 1}]
    with pytest.raises(ValueError, match="frame too large"):
        feeder.feed(struct.pack(">I", framing.MAX_FRAME + 1))


async def test_frame_writer_single_flush_per_tick():
    server = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
    host, port = server.sockets[0].getsockname()[:2]
    _reader, writer = await asyncio.open_connection(host, port)
    writes = []
    orig_write = writer.write
    writer.write = lambda data: (writes.append(len(data)), orig_write(data))
    fw = framing.FrameWriter(writer)
    for i in range(32):
        fw.feed({"kind": "data", "ch": 1, "payload": i})
    assert writes == []  # corked: nothing hit the transport yet
    await asyncio.sleep(0)
    assert len(writes) == 1 and fw.flushes == 1 and fw.frames == 32
    writes.clear()
    fw2 = framing.FrameWriter(writer, cork=False)
    for i in range(4):
        await fw2.send({"kind": "data", "ch": 1, "payload": i})
    assert len(writes) == 4 and fw2.drains == 4
    writer.close()
    server.close()


# ------------------------------------------------------------ stream plane


async def test_decode_burst_coalesces_frames_and_avoids_drains():
    n_items = 64

    async def burst(request, context):
        for i in range(n_items):
            yield {"token_ids": [i], "text": f"t{i}"}

    srv = EndpointServer()
    assert srv.coalesce and srv.cork
    srv.register("ep", burst)
    host, port = await srv.start()
    ch = InstanceChannel(host, port)
    await ch.connect()
    transport.reset_stream_stats()
    got = [x async for x in ch.call("ep", None, Context())]
    assert len(got) == n_items
    stats = transport.stream_stats()
    assert stats["data_items"] == n_items
    assert stats["data_frames"] / n_items <= 0.5, stats
    assert stats["flushes"] >= 1 and stats["drains"] == 0, stats
    await ch.close()
    await srv.stop(drain=False)


async def test_golden_item_order_identical():
    n = 200

    async def gen(request, context):
        for i in range(n):
            yield {"seq": i, "text": f"tok-{i}"}
            if i % 17 == 0:
                await asyncio.sleep(0)

    a, ea = await _collect(True, gen)
    b, eb = await _collect(False, gen)
    assert ea is None and eb is None
    assert a == b == [{"seq": i, "text": f"tok-{i}"} for i in range(n)]


async def test_golden_error_placement_and_typed_errors():
    async def boom(request, context):
        for i in range(5):
            yield {"seq": i}
        raise ValueError("boom")

    async def refuse(request, context):
        yield {"seq": 0}
        raise ServiceUnavailable("saturated", retry_after_s=2.5)

    async def die(request, context):
        yield {"seq": 0}
        raise StreamError("engine lost")

    for coalesce in (True, False):
        items, e = await _collect(coalesce, boom)
        assert items == [{"seq": i} for i in range(5)]
        assert type(e) is RuntimeError and str(e) == "ValueError('boom')"
        items, e = await _collect(coalesce, refuse)
        assert items == [{"seq": 0}]
        assert isinstance(e, ServiceUnavailable) and e.retry_after_s == 2.5
        items, e = await _collect(coalesce, die)
        assert items == [{"seq": 0}]
        assert type(e) is StreamError and "engine lost" in str(e)


async def test_unserializable_item_ends_the_stream_with_an_error():
    """An item the codec refuses (a tensor in a payload) ends its stream
    with an error frame, after the items before it; the peer does not
    wait forever, coalesced or not."""
    import torch

    async def leaky(request, context):
        yield {"token_ids": [1]}
        yield {"token_ids": [torch.tensor(2)]}
        yield {"token_ids": [3]}

    for coalesce in (True, False):
        items, e = await _collect(coalesce, leaky)
        assert items == [{"token_ids": [1]}] or items == []
        assert isinstance(e, RuntimeError) and "serialize" in str(e), e


async def test_golden_cancel_semantics_identical():
    async def run(coalesce: bool):
        stopped = asyncio.Event()

        async def slow(request, context):
            try:
                for i in range(10_000):
                    if context.is_stopped:
                        return
                    yield {"seq": i}
                    await asyncio.sleep(0.005)
            finally:
                stopped.set()

        items, exc = await _collect(coalesce, slow, first_n=3)
        assert exc is None
        await asyncio.wait_for(stopped.wait(), 5)
        return items

    assert await run(True) == await run(False) == [{"seq": i} for i in range(3)]


async def test_midstream_death_then_migration_continuity():
    """A worker dies mid-stream: StreamError, and the port's Migration
    re-drives on a live worker; the merged stream is the full sequence."""
    from dynamo_tpu_torch.frontend.migration import Migration

    total = 12

    async def run(coalesce: bool):
        os.environ["DYN_STREAM_COALESCE"] = "1" if coalesce else "0"
        try:
            server, worker_a, worker_b = await _tcp_pair(prewarm_dials=False)
            client_drt = DistributedRuntime(
                await RemoteHub.connect(f"127.0.0.1:{server.port}"),
                RuntimeConfig(hub_address=f"127.0.0.1:{server.port}",
                              prewarm_dials=False))

            def make_gen(slow: bool):
                async def gen(request, context):
                    start = len(request.get("token_ids") or [])
                    stop = request.get("stop_conditions") or {}
                    for i in range(stop.get("max_tokens", total)):
                        tok = start + i
                        yield {"token_ids": [tok], "text": f"t{tok}"}
                        if slow:
                            await asyncio.sleep(0.02)
                    yield {"token_ids": [], "finish_reason": "stop"}

                return gen

            await worker_a.namespace("ns").component("w").endpoint("gen").serve(
                make_gen(slow=True))
            ep_c = client_drt.namespace("ns").component("w").endpoint("gen")
            router = await PushRouter.from_endpoint(ep_c, RouterMode.ROUND_ROBIN)
            await router.client.wait_for_instances(1, timeout=5)
            mig = Migration(router, migration_limit=6, retry_delay_s=0.01,
                            backoff_max_s=0.02)
            toks, killed = [], False
            request = {"token_ids": [], "stop_conditions": {"max_tokens": total}}
            async for item in mig.generate(request, Context()):
                toks.extend(item.get("token_ids") or [])
                if not killed and len(toks) >= 3:
                    killed = True
                    await worker_a._server.stop(drain=False)
                    await worker_b.namespace("ns").component("w").endpoint(
                        "gen").serve(make_gen(slow=False))
            await client_drt.close()
            await _close_pair(server, worker_a, worker_b)
            return toks
        finally:
            os.environ.pop("DYN_STREAM_COALESCE", None)

    from dynamo_tpu_torch.frontend import migration

    stats = dict(migration.STATS)  # process-wide counters other tests read
    try:
        assert await run(True) == await run(False) == list(range(total))
    finally:
        migration.STATS.update(stats)


async def test_open_handshake_and_legacy_req_frames():
    async def gen(request, context):
        for i in range(3):
            yield i

    srv = EndpointServer(coalesce=True)
    srv.register("ep", gen)
    host, port = await srv.start()
    reader, writer = await asyncio.open_connection(host, port)

    async def frames_until(kinds):
        out = []
        while True:
            msg = await asyncio.wait_for(framing.read_frame(reader), 5)
            out.append(msg)
            if msg["kind"] in kinds:
                return out

    await framing.write_frame(writer, {"kind": "open", "ch": 1, "req": "a" * 32,
                                       "path": "ep", "payload": None, "headers": {}})
    frames = await frames_until(("end", "err"))
    assert frames[-1]["kind"] == "end" and all(f["ch"] == 1 and "req" not in f
                                               for f in frames)
    assert [p for f in frames[:-1] for p in f.get("payloads", [f.get("payload")])] == [0, 1, 2]
    await framing.write_frame(writer, {"kind": "req", "req": "r1", "path": "ep",
                                       "payload": None, "headers": {}})
    frames = await frames_until(("end",))
    assert [f.get("req") for f in frames] == ["r1"] * 4
    assert [f.get("payload") for f in frames[:3]] == [0, 1, 2]
    assert all("payloads" not in f for f in frames)
    writer.close()
    await srv.stop(drain=False)


async def test_channel_dial_race_single_flight_and_prewarm(monkeypatch):
    server, worker, client_drt = await _tcp_pair(prewarm_dials=False)
    try:
        async def h(request, context):
            yield "ok"

        await worker.namespace("ns").component("c").endpoint("g").serve(h)
        client = await client_drt.namespace("ns").component("c").endpoint(
            "g").client().start()
        iid = (await client.wait_for_instances(1, timeout=5))[0].instance_id
        dials = {"n": 0}
        orig_connect = InstanceChannel.connect

        async def counted_connect(self, timeout=5.0):
            dials["n"] += 1
            await asyncio.sleep(0.05)
            await orig_connect(self, timeout)

        monkeypatch.setattr(InstanceChannel, "connect", counted_connect)

        async def one_call():
            return [x async for x in client.call_instance(iid, {}, Context())]

        assert await asyncio.gather(one_call(), one_call()) == [["ok"], ["ok"]]
        assert dials["n"] == 1 and len(client._channels) == 1
    finally:
        await _close_pair(server, worker, client_drt)
    # prewarm on (the default): discovery alone opens the channel
    server, worker, client_drt = await _tcp_pair()
    try:
        await worker.namespace("ns").component("c").endpoint("g").serve(h)
        client = await client_drt.namespace("ns").component("c").endpoint(
            "g").client().start()
        iid = (await client.wait_for_instances(1, timeout=5))[0].instance_id
        for _ in range(100):
            if iid in client._channels and client._channels[iid].connected:
                break
            await asyncio.sleep(0.02)
        assert iid in client._channels and client._channels[iid].connected
    finally:
        await _close_pair(server, worker, client_drt)


async def test_stalled_consumer_applies_backpressure():
    """A stalled consumer parks the producer: the rx queue stays bounded and
    the producer stops short of its end and stays stopped. The stream is
    64 MiB: a loopback receive buffer autotunes up to net.ipv4.tcp_rmem's
    maximum (32 MiB on some hosts), so a shorter stream can fit wholly in
    kernel buffers without any backpressure."""
    total = 1024
    payload = "x" * (64 * 1024)
    produced = {"n": 0}

    async def firehose(request, context):
        for i in range(total):
            produced["n"] = i + 1
            yield {"seq": i, "blob": payload}

    srv = EndpointServer()
    srv.register("ep", firehose)
    host, port = await srv.start()
    ch = InstanceChannel(host, port)
    ch.rx_max_items = 4
    ch.rx_max_bytes = 256 * 1024
    await ch.connect()
    got = []
    stream = ch.call("ep", None, Context())
    async for item in stream:
        got.append(item)
        break  # stall with the stream open
    await asyncio.sleep(0.5)
    q = next(iter(ch._queues.values()))
    assert q._q.qsize() <= ch.rx_max_items + 1, q._q.qsize()
    assert q._bytes <= ch.rx_max_bytes + 3 * len(payload)
    parked_at = produced["n"]
    assert parked_at < total, "producer ran unbounded despite stall"
    await asyncio.sleep(0.5)
    assert produced["n"] == parked_at, "producer kept running despite stall"
    async for item in stream:
        got.append(item)
    assert [g["seq"] for g in got] == list(range(total))
    await ch.close()
    await srv.stop(drain=False)


async def test_server_survives_garbage_then_serves_valid_connection():
    async def h(request, context):
        yield "fine"

    srv = EndpointServer()
    srv.register("ep", h)
    host, port = await srv.start()
    for junk in (b"\x00\x02",  # torn header at EOF
                 struct.pack(">I", framing.MAX_FRAME + 7) + b"\xff" * 16,  # oversize
                 struct.pack(">I", 1) + b"\x01",  # an int, not a map
                 struct.pack(">I", 1) + b"\xc1"):  # a byte msgpack never writes
        _r, w = await asyncio.open_connection(host, port)
        w.write(junk)
        await w.drain()
        w.close()
    await asyncio.sleep(0.05)
    ch = InstanceChannel(host, port)
    await ch.connect()
    assert [x async for x in ch.call("ep", None, Context())] == ["fine"]
    await ch.close()
    await srv.stop(drain=False)


async def test_uds_endpoint_roundtrip(tmp_path):
    server = HubServer(port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"
    cfg = RuntimeConfig(hub_address=addr, uds_dir=str(tmp_path))
    worker = DistributedRuntime(await RemoteHub.connect(addr), cfg)
    client_drt = DistributedRuntime(await RemoteHub.connect(addr), cfg)
    try:
        async def h(request, context):
            yield {"via": "uds"}

        await worker.namespace("ns").component("c").endpoint("g").serve(h)
        client = await client_drt.namespace("ns").component("c").endpoint(
            "g").client().start()
        inst = (await client.wait_for_instances(1, timeout=5))[0]
        assert inst.uds and os.path.exists(inst.uds)
        assert [x async for x in client.call_instance(
            inst.instance_id, {}, Context())] == [{"via": "uds"}]
        sock = client._channels[inst.instance_id]._writer.get_extra_info("socket")
        assert sock.family == socket.AF_UNIX
    finally:
        await client_drt.close()
        await worker.close()
        await server.stop()
    assert not any(p.suffix == ".sock" for p in tmp_path.iterdir())


def test_instance_uds_field_roundtrips_and_tolerates_absence():
    inst = Instance(1, "ns", "c", "e", "h", 1, "tcp", {}, uds="/tmp/x.sock")
    assert Instance.from_dict(inst.to_dict()).uds == "/tmp/x.sock"
    d = inst.to_dict()
    del d["uds"]
    assert Instance.from_dict(d).uds == ""


# ------------------------------------------------------------ runtime over TCP


async def test_remote_hub_roundtrip():
    server = HubServer(port=0)
    await server.start()
    try:
        hub = await RemoteHub.connect(f"127.0.0.1:{server.port}")
        await hub.put("k", [1, 2, 3])
        assert await hub.get("k") == [1, 2, 3]
        with pytest.raises(KeyExists):
            await hub.create("k", 0)
        lease = await hub.grant_lease(5.0)
        await hub.put("leased", "v", lease_id=lease)
        await hub.revoke_lease(lease)
        assert await hub.get("leased") is None
        events = []

        async def watch():
            async for ev in hub.watch_prefix("k"):
                events.append(ev)
                if len(events) == 2:
                    return

        task = asyncio.ensure_future(watch())
        await asyncio.sleep(0.1)
        await hub.put("k2", "x")
        await asyncio.wait_for(task, 5)
        assert [e.key for e in events] == ["k", "k2"]
        await hub.put_object("bucket", "obj", b"\x00\x01bytes")
        assert await hub.get_object("bucket", "obj") == b"\x00\x01bytes"
        assert await hub.get_object("bucket", "missing") is None
        assert hub_client.failover_stats()["backoff_count"] >= 0
        await hub.close()
    finally:
        await server.stop()


async def test_remote_hub_reconnects_and_resyncs_watch():
    """The hub drops every client: calls retry on a fresh connection, and
    the watch re-syncs by snapshot diff (a key deleted meanwhile arrives
    as a delete)."""
    server = HubServer(port=0)
    await server.start()
    hub = await RemoteHub.connect(f"127.0.0.1:{server.port}")
    other = await RemoteHub.connect(f"127.0.0.1:{server.port}")
    try:
        await hub.put("w/a", 1)
        await hub.put("w/b", 2)
        events = []
        seen = asyncio.Event()

        async def watch():
            async for ev in hub.watch_prefix("w/"):
                events.append((ev.kind, ev.key))
                seen.set()

        task = asyncio.ensure_future(watch())
        while len(events) < 2:
            await asyncio.wait_for(seen.wait(), 5)
            seen.clear()
        server.kick_clients()
        await other.delete("w/a")
        assert await hub.get("w/b") == 2  # retried on the new connection
        for _ in range(100):
            if ("delete", "w/a") in events:
                break
            await asyncio.sleep(0.02)
        assert events[:2] == [("put", "w/a"), ("put", "w/b")]
        assert ("delete", "w/a") in events[2:]
        task.cancel()
    finally:
        await hub.close()
        await other.close()
        await server.stop()


async def test_serve_and_call_tcp_with_cancellation():
    server, worker_drt, client_drt = await _tcp_pair()
    cancelled = asyncio.Event()

    async def slow_stream(request, context):
        try:
            for i in range(10_000):
                if context.is_stopped:
                    return
                yield i
                await asyncio.sleep(0.01)
        finally:
            cancelled.set()

    await worker_drt.namespace("ns").component("w").endpoint("gen").serve(slow_stream)
    client = await client_drt.namespace("ns").component("w").endpoint(
        "gen").client().start()
    insts = await client.wait_for_instances(1, timeout=5)
    assert insts[0].transport == "tcp"
    ctx = Context()
    got = []
    async for item in client.call_instance(insts[0].instance_id, {}, ctx):
        got.append(item)
        if len(got) == 3:
            ctx.stop_generating()
            break
    assert got == [0, 1, 2]
    await asyncio.wait_for(cancelled.wait(), 5)
    await _close_pair(server, worker_drt, client_drt)


async def test_stream_error_on_worker_death():
    server, worker_drt, client_drt = await _tcp_pair()

    async def infinite(request, context):
        i = 0
        while True:
            yield i
            i += 1
            await asyncio.sleep(0.01)

    await worker_drt.namespace("ns").component("dying").endpoint("gen").serve(infinite)
    client = await client_drt.namespace("ns").component("dying").endpoint(
        "gen").client().start()
    insts = await client.wait_for_instances(1, timeout=5)
    got = []
    with pytest.raises(StreamError):
        async for item in client.call_instance(insts[0].instance_id, {}, Context()):
            got.append(item)
            if len(got) == 2:
                await worker_drt._server.stop(drain=False)
    assert len(got) >= 2
    await _close_pair(server, worker_drt, client_drt)


async def test_draining_server_refuses_with_retry_after():
    """A stopping EndpointServer answers new opens with the typed
    ``unavailable`` refusal and its Retry-After."""
    gate = asyncio.Event()

    async def h(request, context):
        await gate.wait()
        yield "late"

    srv = EndpointServer()
    srv.register("ep", h)
    host, port = await srv.start()
    ch = InstanceChannel(host, port)
    await ch.connect()
    srv.draining = True
    srv.drain_retry_after_s = 7.0
    with pytest.raises(ServiceUnavailable) as e:
        [x async for x in ch.call("ep", None, Context())]
    assert e.value.retry_after_s == 7.0
    gate.set()
    await ch.close()
    await srv.stop(drain=False)


async def test_drain_refusal_spares_the_streams_in_flight():
    """A worker that starts draining refuses a new call with
    ServiceUnavailable, and the stream it already serves on the same
    channel runs to its end (the refusal is an answer, not a dead
    connection); the withdrawn instance's channel closes after it."""
    server, worker_drt, client_drt = await _tcp_pair()
    release = asyncio.Event()

    async def h(request, context):
        for i in range(6):
            yield i
            if i == 1:
                await release.wait()

    await worker_drt.namespace("ns").component("w").endpoint("gen").serve(h)
    client = await client_drt.namespace("ns").component("w").endpoint(
        "gen").client().start()
    (inst,) = await client.wait_for_instances(1, timeout=5)
    stream = client.call_instance(inst.instance_id, {}, Context())
    got = [await stream.__anext__(), await stream.__anext__()]
    worker_drt._server.draining = True
    with pytest.raises(ServiceUnavailable):
        [x async for x in client.call_instance(inst.instance_id, {}, Context())]
    await worker_drt.hub.delete(inst.path)  # withdrawn, as a drain does
    for _ in range(100):
        if not client.instance_ids():
            break
        await asyncio.sleep(0.01)
    assert client.instance_ids() == [] and len(client._retiring) == 1
    release.set()
    got += [x async for x in stream]
    assert got == list(range(6))
    assert not client._retiring and not client._channels
    await client.close()
    await _close_pair(server, worker_drt, client_drt)


async def test_push_router_round_robin_and_direct_over_tcp():
    server, worker_drt, client_drt = await _tcp_pair()

    def make_handler(tag):
        async def h(request, context):
            yield tag

        return h

    ep_w = worker_drt.namespace("ns").component("pool").endpoint("gen")
    await ep_w.serve(make_handler("a"))
    await ep_w.serve(make_handler("b"))
    router = await PushRouter.from_endpoint(
        client_drt.namespace("ns").component("pool").endpoint("gen"),
        RouterMode.ROUND_ROBIN)
    await router.client.wait_for_instances(2, timeout=5)
    seen = []
    for _ in range(4):
        async for item in router.generate({}, Context()):
            seen.append(item)
    assert sorted(seen) == ["a", "a", "b", "b"]
    iid = router.client.instance_ids()[0]
    assert len([x async for x in router.generate({}, Context(), instance_id=iid)]) == 1
    with pytest.raises(NoInstancesError):
        router.select(instance_id=0xDEAD)
    await router.client.close()
    await _close_pair(server, worker_drt, client_drt)


async def test_lease_expiry_removes_instance_from_remote_client():
    """A worker that stops its keepalives vanishes from a client watching
    through another TCP connection once the hub reaps its lease."""
    server = HubServer(port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"
    worker = DistributedRuntime(await RemoteHub.connect(addr),
                                RuntimeConfig(hub_address=addr, lease_ttl_s=0.3,
                                              keepalive_interval_s=10.0))
    client_drt = DistributedRuntime(await RemoteHub.connect(addr),
                                    RuntimeConfig(hub_address=addr))

    async def h(request, context):
        yield "ok"

    await worker.namespace("ns").component("flaky").endpoint("gen").serve(h)
    client = await client_drt.namespace("ns").component("flaky").endpoint(
        "gen").client().start()
    await client.wait_for_instances(1, timeout=5)
    worker._keepalive_task.cancel()
    for _ in range(150):  # the hub's reaper runs every 0.5 s
        if not client.instance_ids():
            break
        await asyncio.sleep(0.02)
    assert client.instance_ids() == []
    await client.close()
    await client_drt.close()
    await worker.close()
    await server.stop()


# ------------------------------------------------------------ interop


class _Side:
    """One package's hub server/client and transport classes."""

    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.HubServer = jax_hub_server.HubServer if jax else hub_server.HubServer
        self.RemoteHub = jax_hub_client.RemoteHub if jax else hub_client.RemoteHub
        self.EndpointServer = (jax_transport.EndpointServer if jax
                               else transport.EndpointServer)
        self.InstanceChannel = (jax_transport.InstanceChannel if jax
                                else transport.InstanceChannel)
        self.Context = JaxContext if jax else Context
        self.Unavailable = JaxUnavailable if jax else ServiceUnavailable
        self.StreamError = JaxStreamError if jax else StreamError


SIDES = {n: _Side(n) for n in ("jax", "port")}
PAIRS = [("jax", "jax"), ("jax", "port"), ("port", "jax"), ("port", "port")]


async def _hub_script(client_cls, port: int) -> list:
    """Every hub op, a watch with its snapshot and updates, a replayed
    subscription with a deduplicated publish: the transcript of results."""
    hub = await client_cls.connect(f"127.0.0.1:{port}")
    out = []
    try:
        await hub.put("v1/k", {"n": 1, "b": b"\x00\xff", "f": -0.5, "l": [1, None]})
        out.append(await hub.get("v1/k"))
        try:
            await hub.create("v1/k", 0)
        except Exception as e:  # noqa: BLE001 - the error type is the result
            out.append(type(e).__name__)
        await hub.create("v1/k2", "x")
        out.append(sorted((await hub.get_prefix("v1/")).items()))
        lease = await hub.grant_lease(30.0)
        await hub.put("v1/leased", 2 ** 40, lease_id=lease)
        out.append(await hub.keepalive(lease))
        await hub.revoke_lease(lease)
        out.append(await hub.get("v1/leased"))
        out.append(await hub.keepalive(lease))
        out.append(await hub.delete("v1/k2"))
        out.append(await hub.delete("v1/k2"))
        events = []

        async def watch():
            async for ev in hub.watch_prefix("v1/"):
                events.append((ev.kind, ev.key, ev.value))
                if len(events) == 3:
                    return

        task = asyncio.ensure_future(watch())
        await asyncio.sleep(0.1)
        await hub.put("v1/new", [True, False])
        await hub.delete("v1/new")
        await asyncio.wait_for(task, 5)
        out.append(events)
        out.append(await hub.publish("kv.a", {"seq": 1}, pub_id="p1"))
        out.append(await hub.publish("kv.a", {"seq": 1}, pub_id="p1"))
        out.append(await hub.publish("kv.b", "two"))
        got = []

        async def sub():
            async for item in hub.subscribe("kv.*", replay=True, with_seq=True):
                got.append(item)
                if len(got) == 3:
                    return

        task = asyncio.ensure_future(sub())
        await asyncio.sleep(0.1)
        await hub.publish("kv.a", {"seq": 2})
        await asyncio.wait_for(task, 5)
        out.append(got)
        out.append(await hub.purge_subject("kv.a", keep_last=1))
        await hub.put_object("bkt", "obj", b"\x01" * 300)
        out.append(await hub.get_object("bkt", "obj"))
        out.append(await hub.get_object("bkt", "none"))
        await hub.delete_object("bkt", "obj")
        out.append(await hub.get_object("bkt", "obj"))
        out.append(len(await hub.get_boot_id()))
    finally:
        await hub.close()
    return out


async def test_hub_interop_all_directions():
    """The same ops give the same results whichever package serves the hub
    and whichever package is the client."""
    transcripts = {}
    for server_side, client_side in PAIRS:
        server = SIDES[server_side].HubServer(port=0)
        await server.start()
        try:
            transcripts[server_side, client_side] = await _hub_script(
                SIDES[client_side].RemoteHub, server.port)
        finally:
            await server.stop()
    want = transcripts["jax", "jax"]
    assert want[1] == "KeyExists"
    for pair, got in transcripts.items():
        assert got == want, pair


def _handlers(side):
    unavailable = SIDES[side].Unavailable
    stream_error = SIDES[side].StreamError

    async def tokens(request, context):
        for i in range(request["n"]):
            yield {"token_ids": [i], "logprobs": [{"id": i, "logprob": -0.125 * i}]}
            if i % 5 == 0:
                await asyncio.sleep(0)
        yield {"token_ids": [], "finish_reason": "length"}

    async def boom(request, context):
        yield {"seq": 0}
        raise ValueError("boom")

    async def refuse(request, context):
        yield {"seq": 0}
        raise unavailable("draining", retry_after_s=3.5)

    async def lost(request, context):
        yield {"seq": 0}
        raise stream_error("engine lost")

    async def slow(request, context):
        for i in range(1000):
            if context.is_stopped:
                yield {"stopped_at": i}
                return
            yield {"seq": i}
            await asyncio.sleep(0.005)

    return {"tokens": tokens, "boom": boom, "refuse": refuse, "lost": lost, "slow": slow}


async def _stream_script(server_side, client_side) -> list:
    srv = SIDES[server_side].EndpointServer()
    for path, h in _handlers(server_side).items():
        srv.register(path, h)
    host, port = await srv.start()
    c = SIDES[client_side]
    ch = c.InstanceChannel(host, port)
    await ch.connect()
    out = []
    try:
        for path, payload in (("tokens", {"n": 40}), ("boom", None), ("refuse", None),
                              ("lost", None), ("missing", None)):
            items = []
            try:
                async for item in ch.call(path, payload, c.Context()):
                    items.append(item)
                out.append((path, items, None))
            except Exception as e:  # noqa: BLE001 - the error is the result
                kind = ("unavailable" if isinstance(e, c.Unavailable) else
                        "stream" if type(e) is c.StreamError else type(e).__name__)
                out.append((path, items, kind, str(e), getattr(e, "retry_after_s", None)))
        ctx = c.Context()
        items = []
        async for item in ch.call("slow", None, ctx):
            items.append(item)
            if len(items) == 3:
                ctx.stop_generating()
        out.append(("slow", items[:3], "stopped" in items[-1]))
    finally:
        await ch.close()
        await srv.stop(drain=False)
    return out


async def test_endpoint_interop_all_directions():
    """Streams, typed errors and cancellation agree whichever package serves
    the endpoint and whichever package calls it."""
    transcripts = {pair: await _stream_script(*pair) for pair in PAIRS}
    want = transcripts["jax", "jax"]
    assert want[0][1][-1] == {"token_ids": [], "finish_reason": "length"}
    assert want[2][2:] == ("unavailable", "draining", 3.5)
    assert want[3][2] == "stream"
    for pair, got in transcripts.items():
        assert got == want, pair
