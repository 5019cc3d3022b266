"""The port's inference gateway (dynamo_tpu_torch/gateway/): every case of
tests/test_gateway_epp.py against the port's endpoint picker (on
frontend/http_server.py), the breaker cases tests/test_overload.py and
tests/test_observability.py drive, and the port held against the JAX
package's EPP: on one hub state both pick the same worker with the same
overlap and GIE header, and each package's pickline client talks to the
other's server.
"""

import argparse
import asyncio
import json
import time

import aiohttp
import pytest

from dynamo_tpu_torch.frontend.model_card import ModelDeploymentCard
from dynamo_tpu_torch.gateway.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerBoard,
    BreakerConfig,
    CircuitBreaker,
)
from dynamo_tpu_torch.gateway.epp import EndpointPicker, _PrefixCache, shard_child_argv
from dynamo_tpu_torch.gateway.pickline import PickLineClient, PickLineServer
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
from dynamo_tpu_torch.mocker.engine import MockEngineConfig
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.hub import InMemoryHub

pytestmark = pytest.mark.integration

MOCK = MockEngineConfig(block_size=4, speedup_ratio=1000.0)


async def _epp(drt, **kw):
    return await EndpointPicker(
        drt, namespace="dyn", target_component="backend",
        config=RouterConfig(block_size=4), host="127.0.0.1", port=0, **kw,
    ).start()


async def _workers(drt, n):
    return [await launch_mock_worker(drt, "dyn", "backend", "generate", MOCK)
            for _ in range(n)]


async def _pick_until_ok(sess, base, payload, timeout_s=8.0):
    """First picks can 503 while the router is still discovering the
    fleet (instance watch + metrics subscription): poll to 200."""
    deadline = time.monotonic() + timeout_s
    while True:
        async with sess.post(f"{base}/pick", json=payload) as r:
            if r.status == 200:
                return await r.json(), dict(r.headers)
            assert time.monotonic() < deadline, await r.text()
        await asyncio.sleep(0.05)


# ------------------------------------------------ tests/test_gateway_epp.py


async def test_epp_picks_kv_warm_worker_with_gie_header():
    drt = DistributedRuntime(InMemoryHub())
    (eng_a, served_a), _b = await _workers(drt, 2)
    epp = await _epp(drt)
    base = f"http://127.0.0.1:{epp.port}"
    try:
        async with aiohttp.ClientSession() as sess:
            async with sess.get(f"{base}/healthz") as r:
                assert r.status == 200
            # warm worker A with a prefix through the mock engine: its KV
            # events flow to the router the EPP consumes
            warm = list(range(40, 72))
            async for _ in eng_a.generate({"token_ids": warm,
                                           "stop_conditions": {"max_tokens": 2}},
                                          Context("warm")):
                pass
            picked = None
            for _ in range(100):
                async with sess.post(f"{base}/pick", json={"token_ids": warm}) as r:
                    if r.status == 200:
                        body = await r.json()
                        if body["overlap_blocks"] > 0:
                            picked = (body, dict(r.headers))
                            break
                await asyncio.sleep(0.05)
            assert picked is not None, "router never saw the warm prefix"
            body, headers = picked
            assert body["worker_id"] == served_a.instance.instance_id
            assert body["endpoint"]
            assert headers["x-gateway-destination-endpoint"] == body["endpoint"]

            card = ModelDeploymentCard(name="mock-model", namespace="dyn",
                                       component="backend", endpoint="generate")
            await drt.hub.put(card.key_for(served_a.instance.instance_id), card.to_dict())
            async with sess.post(f"{base}/pick",
                                 json={"model": "mock-model", "prompt": "hello epp"}) as r:
                assert r.status == 200
                assert (await r.json())["endpoint"]
            async with sess.post(f"{base}/pick", json={}) as r:
                assert r.status == 400
            async with sess.post(f"{base}/pick",
                                 json={"model": "no-such-model", "prompt": "hi"}) as r:
                assert r.status == 404
                assert "no-such-model" in (await r.json())["error"]
            async with sess.post(f"{base}/pick", json={"prompt": "hi"}) as r:
                assert r.status == 200
            async with sess.post(f"{base}/pick", data=b"{not json") as r:
                assert r.status == 400
    finally:
        await epp.close()
        await drt.close()


async def test_epp_metrics_expose_pick_latency_and_cache_outcomes():
    drt = DistributedRuntime(InMemoryHub())
    await _workers(drt, 1)
    epp = await _epp(drt)
    base = f"http://127.0.0.1:{epp.port}"
    try:
        async with aiohttp.ClientSession() as sess:
            ok = 0
            for _ in range(100):
                async with sess.post(f"{base}/pick", json={"token_ids": [1, 2, 3, 4]}) as r:
                    ok += r.status == 200
                if ok >= 3:
                    break
                await asyncio.sleep(0.05)
            assert ok >= 3
            async with sess.get(f"{base}/metrics") as r:
                assert r.status == 200
                text = await r.text()
        lines = text.splitlines()
        count = next(ln for ln in lines if ln.startswith("dynamo_epp_pick_seconds_count"))
        assert float(count.split()[-1]) >= 3
        cache = [ln for ln in lines if ln.startswith("dynamo_epp_cache_lookups_total")]
        assert any('outcome="miss"' in ln and float(ln.split()[-1]) > 0 for ln in cache), text
        assert any('outcome="hit"' in ln and float(ln.split()[-1]) > 0 for ln in cache), text
    finally:
        await epp.close()
        await drt.close()


async def test_epp_503_when_no_workers():
    drt = DistributedRuntime(InMemoryHub())
    epp = await _epp(drt)
    try:
        async with aiohttp.ClientSession() as sess:
            async with sess.post(f"http://127.0.0.1:{epp.port}/pick",
                                 json={"token_ids": [1, 2, 3]}) as r:
                assert r.status == 503
    finally:
        await epp.close()
        await drt.close()


async def test_prefix_cache_ttl_backstop():
    hub = InMemoryHub()
    cache = _PrefixCache(hub, "x/", ttl_s=0.05)
    assert await cache.get() == {}
    await hub.put("x/a", {"v": 1})
    assert await cache.get() == {}  # inside the TTL: served from cache
    assert cache.scans == 1
    await asyncio.sleep(0.06)
    assert (await cache.get()).get("x/a") == {"v": 1}
    assert cache.scans == 2


async def test_epp_cached_pick_does_zero_hub_scans():
    drt = DistributedRuntime(InMemoryHub())
    ((_eng, served),) = await _workers(drt, 1)
    card = ModelDeploymentCard(name="mock-model", namespace="dyn",
                               component="backend", endpoint="generate")
    await drt.hub.put(card.key_for(served.instance.instance_id), card.to_dict())
    epp = await _epp(drt, card_ttl_s=30.0)  # the watch is the invalidator
    base = f"http://127.0.0.1:{epp.port}"
    try:
        async with aiohttp.ClientSession() as sess:
            await _pick_until_ok(sess, base, {"model": "mock-model",
                                              "prompt": "warm the caches"})
            warm_scans = epp._cards.scans + epp._instances.scans
            assert warm_scans >= 1
            n_picks = 20
            for i in range(n_picks):
                async with sess.post(f"{base}/pick", json={"model": "mock-model",
                                                           "prompt": f"pick {i}"}) as r:
                    assert r.status == 200
            assert epp._cards.scans + epp._instances.scans == warm_scans, (
                "steady-state picks paid hub round-trips")
            async with sess.get(f"{base}/healthz") as r:
                health = await r.json()
            assert health["hub_scans"] == warm_scans
            assert health["picks"] >= n_picks + 1
    finally:
        await epp.close()
        await drt.close()


async def test_epp_card_add_and_remove_invalidate_within_window():
    drt = DistributedRuntime(InMemoryHub())
    ((_eng, served),) = await _workers(drt, 1)
    epp = await _epp(drt, card_ttl_s=30.0)
    base = f"http://127.0.0.1:{epp.port}"

    async def pick_status(sess, model):
        async with sess.post(f"{base}/pick", json={"model": model, "prompt": "hi"}) as r:
            return r.status

    try:
        async with aiohttp.ClientSession() as sess:
            assert await pick_status(sess, "late-model") == 404
            card = ModelDeploymentCard(name="late-model", namespace="dyn",
                                       component="backend", endpoint="generate")
            key = card.key_for(served.instance.instance_id)
            await drt.hub.put(key, card.to_dict())
            for _ in range(40):
                if await pick_status(sess, "late-model") == 200:
                    break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError("new card never became pickable")
            await drt.hub.delete(key)
            for _ in range(40):
                if await pick_status(sess, "late-model") == 404:
                    break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError("removed card kept resolving")
    finally:
        await epp.close()
        await drt.close()


async def test_pickline_fast_path_matches_http_pick():
    drt = DistributedRuntime(InMemoryHub())
    await _workers(drt, 3)
    epp = await _epp(drt, pick_port=0, shard_id=1, shards=2)
    try:
        for _ in range(100):
            if len(epp.kv.scheduler.workers()) >= 3:
                break
            await asyncio.sleep(0.02)
        assert epp.pick_port, "pickline never started"
        cl = await PickLineClient("127.0.0.1", epp.pick_port).connect()
        toks = list(range(16))
        rs = await asyncio.gather(*(cl.pick({"token_ids": toks, "request_id": f"pl-{i}"})
                                    for i in range(8)))
        assert all(r["status"] == 200 for r in rs)
        assert all(r["endpoint"] and "worker_id" in r for r in rs)
        assert all(r["shard"] == 1 for r in rs)
        assert [r["id"] for r in rs] == sorted(r["id"] for r in rs)
        async with aiohttp.ClientSession() as sess:
            async with sess.post(f"http://127.0.0.1:{epp.port}/pick",
                                 json={"token_ids": toks}) as r:
                http_body = await r.json()
        assert http_body["worker_id"] == rs[0]["worker_id"]
        bad = await cl.pick({"token_ids": "not-a-list"})
        assert bad["status"] == 503  # the scheduler bounced the bad tokens
        ok = await cl.pick({"token_ids": toks})
        assert ok["status"] == 200
        await cl.close()
        async with aiohttp.ClientSession() as sess:
            async with sess.get(f"http://127.0.0.1:{epp.port}/metrics") as r:
                text = await r.text()
        assert "dynamo_epp_pick_seconds" in text
        assert "dynamo_router_pick_seconds" in text
        assert "dynamo_router_shard_id 1.0" in text
    finally:
        await epp.close()
        await drt.close()


class _EchoPicker:
    def __init__(self, fail_first=False):
        self.calls = 0
        self.fail_first = fail_first

    async def pick_decision(self, body):
        self.calls += 1
        if self.fail_first and self.calls == 1:
            raise RuntimeError("boom")
        return 200, {"worker_id": 7 if self.fail_first else 1,
                     **({} if self.fail_first else {"echo": body.get("x")})}, {}

    def observe_pick(self, s):
        pass


async def test_pickline_malformed_line_keeps_connection():
    srv = await PickLineServer(_EchoPicker(), port=0).start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        writer.write(b"this is not json\n")
        writer.write(json.dumps({"id": 7, "x": "y"}).encode() + b"\n")
        await writer.drain()
        bad = json.loads(await reader.readline())
        good = json.loads(await reader.readline())
        assert bad["status"] == 400 and bad["id"] is None
        assert good == {"id": 7, "status": 200, "worker_id": 1, "echo": "y"}
        writer.close()
    finally:
        await srv.close()


def test_shard_child_argv_fanout():
    args = argparse.Namespace(hub="h:1", namespace="n", component="c", endpoint="e",
                              block_size=16, host="0.0.0.0", port=9100, pick_port=9200,
                              shards=4)
    argv2 = shard_child_argv(args, 2)
    assert argv2[1:3] == ["-m", "dynamo_tpu_torch.gateway"]
    s = " ".join(argv2)
    assert "--shard-id 2" in s and "--shards 4" in s
    assert "--port 9102" in s and "--pick-port 9202" in s
    assert "--hub h:1" in s
    args.port, args.pick_port = 0, 0
    s0 = " ".join(shard_child_argv(args, 3))
    assert "--port 0" in s0 and "--pick-port 0" in s0


async def test_pickline_client_close_fails_pending_picks():
    """close() cancels the rx task; an in-flight pick() gets
    ConnectionError instead of hanging. The silent server closes its end
    once the client has gone: on Python 3.12 ``Server.wait_closed()``
    waits for every connection's transport (the reference's copy of this
    test leaves it open, and its teardown hangs)."""
    async def silent(reader, writer):
        await reader.read()  # never answers
        writer.close()

    srv = await asyncio.start_server(silent, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    cl = await PickLineClient("127.0.0.1", port).connect()
    try:
        task = asyncio.ensure_future(cl.pick({"token_ids": [1, 2]}))
        await asyncio.sleep(0.05)
        await cl.close()
        with pytest.raises(ConnectionError):
            await asyncio.wait_for(task, 5)
    finally:
        srv.close()
        await srv.wait_closed()


async def test_pickline_decision_error_is_in_band_500():
    srv = await PickLineServer(_EchoPicker(fail_first=True), port=0).start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        writer.write(b'{"id": 1}\n{"id": 2}\n')
        await writer.drain()
        r1 = json.loads(await reader.readline())
        r2 = json.loads(await reader.readline())
        assert r1["status"] == 500 and "boom" in r1["error"]
        assert r2 == {"id": 2, "status": 200, "worker_id": 7}
        writer.close()
    finally:
        await srv.close()


async def test_pickline_unserializable_body_does_not_desync():
    async def echo(reader, writer):
        while True:
            line = await reader.readline()
            if not line:
                break
            body = json.loads(line)
            writer.write(json.dumps({"id": body["id"], "status": 200,
                                     "tag": body["tag"]}).encode() + b"\n")
            await writer.drain()
        writer.close()

    srv = await asyncio.start_server(echo, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    cl = await PickLineClient("127.0.0.1", port).connect()
    try:
        with pytest.raises(TypeError):
            await cl.pick({"tag": b"bytes are not json"})
        r = await asyncio.wait_for(cl.pick({"tag": "ok"}), 5)
        assert r["status"] == 200 and r["tag"] == "ok"
    finally:
        await cl.close()
        srv.close()
        await srv.wait_closed()


async def test_pickline_pick_after_server_hangup_raises():
    async def hangup(reader, writer):
        writer.close()

    srv = await asyncio.start_server(hangup, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    cl = await PickLineClient("127.0.0.1", port).connect()
    try:
        for _ in range(100):
            if cl._closed:
                break
            await asyncio.sleep(0.01)
        assert cl._closed
        with pytest.raises(ConnectionError):
            await asyncio.wait_for(cl.pick({"token_ids": [1]}), 5)
    finally:
        await cl.close()
        srv.close()
        await srv.wait_closed()


async def test_pickline_server_close_with_live_peer_returns():
    srv = await PickLineServer(_EchoPicker(), port=0).start()
    cl = await PickLineClient("127.0.0.1", srv.port).connect()
    r = await cl.pick({"token_ids": [1]})
    assert r["status"] == 200
    assert len(srv._conns) == 1
    await asyncio.wait_for(srv.close(), 5)
    assert not srv._conns
    await cl.close()


# -------------------------------------- breakers (test_overload.py cases)


def test_breaker_open_halfopen_close_transitions():
    b = CircuitBreaker(BreakerConfig(window=8, min_samples=4, failure_threshold=0.5,
                                     open_cooldown_s=10.0, half_open_probes=1,
                                     close_after=2))
    for _ in range(3):
        b.record(False, now=0.0)
    assert b.state == CLOSED
    b.record(False, now=0.0)
    assert b.state == OPEN
    assert not b.allow(now=1.0)
    assert b.allow(now=11.0)
    assert b.state == HALF_OPEN
    assert not b.allow(now=11.0)
    b.record(True, now=12.0)
    assert b.state == HALF_OPEN
    assert b.allow(now=12.0)
    b.record(True, now=13.0)
    assert b.state == CLOSED
    assert b.allow(now=13.0)


def test_breaker_failing_probe_reopens_with_fresh_cooldown():
    b = CircuitBreaker(BreakerConfig(window=8, min_samples=2, failure_threshold=0.5,
                                     open_cooldown_s=5.0, half_open_probes=1,
                                     close_after=1))
    b.record(False, now=0.0)
    b.record(False, now=0.0)
    assert b.state == OPEN
    assert b.allow(now=6.0)
    b.record(False, now=6.0)
    assert b.state == OPEN
    assert not b.allow(now=7.0)
    assert b.allow(now=11.5)


def test_breaker_latency_slo_counts_as_failure():
    b = CircuitBreaker(BreakerConfig(window=8, min_samples=4, failure_threshold=0.5,
                                     latency_slo_s=0.1))
    for _ in range(4):
        b.record(True, latency_s=5.0, now=0.0)
    assert b.state == OPEN


def test_breaker_unreported_probes_expire():
    b = CircuitBreaker(BreakerConfig(window=8, min_samples=2, failure_threshold=0.5,
                                     open_cooldown_s=1.0, half_open_probes=2,
                                     close_after=1, probe_timeout_s=5.0))
    b.record(False, now=0.0)
    b.record(False, now=0.0)
    assert b.state == OPEN
    assert b.allow(now=2.0) and b.allow(now=2.0)
    assert not b.allow(now=3.0)
    assert b.allow(now=8.0)
    b.record(True, now=8.5)
    assert b.state == CLOSED


def test_breaker_board_forget_drops_gauge_series():
    forgotten = []
    board = BreakerBoard(BreakerConfig(), on_forget=forgotten.append)
    board.record(1, ok=True)
    board.record(2, ok=True)
    board.forget({2})
    assert forgotten == [1]
    assert set(board._breakers) == {2}


async def test_epp_breaker_ejects_sick_worker_and_readmits():
    bc = BreakerConfig(window=8, min_samples=4, failure_threshold=0.5,
                       open_cooldown_s=0.3, half_open_probes=2, close_after=1)
    drt = DistributedRuntime(InMemoryHub())
    await _workers(drt, 2)
    epp = await _epp(drt, breaker_config=bc)
    base = f"http://127.0.0.1:{epp.port}"
    try:
        async with aiohttp.ClientSession() as sess:
            body, _h = await _pick_until_ok(sess, base, {"token_ids": list(range(16))})
            sick = body["worker_id"]
            for _ in range(6):
                async with sess.post(f"{base}/report", json={
                        "worker_id": sick, "ok": False, "latency_ms": 50}) as r:
                    assert r.status == 200
            assert epp.breakers.state(sick) == OPEN
            async with sess.post(f"{base}/report",
                                 json={"worker_id": 0xdeadbeef, "ok": False}) as r:
                assert r.status == 404
            async with sess.post(f"{base}/report",
                                 json={"worker_id": f"{sick:x}", "ok": "yes"}) as r:
                assert r.status == 400
            for _ in range(5):
                async with sess.post(f"{base}/pick",
                                     json={"token_ids": list(range(16))}) as r:
                    assert r.status == 200
                    assert (await r.json())["worker_id"] != sick
            async with sess.get(f"{base}/metrics") as r:
                text = await r.text()
            assert "dynamo_epp_breaker_state" in text
            assert f'instance="{sick:x}"' in text
            await asyncio.sleep(0.35)
            assert epp.breakers.allow(sick)  # half-open probe admission
            async with sess.post(f"{base}/report", json={
                    "worker_id": f"{sick:x}", "ok": True, "latency_ms": 5}) as r:
                assert (await r.json())["state"] == "closed"
            assert epp.breakers.state(sick) == CLOSED
            seen = set()
            for _ in range(12):
                async with sess.post(f"{base}/pick",
                                     json={"token_ids": list(range(16))}) as r:
                    seen.add((await r.json())["worker_id"])
            assert sick in seen, "recovered worker never re-admitted"
    finally:
        await epp.close()
        await drt.close()


async def test_epp_breaker_fault_site_forces_outcomes():
    bc = BreakerConfig(window=8, min_samples=4, failure_threshold=0.5,
                       open_cooldown_s=30.0)
    drt = DistributedRuntime(InMemoryHub())
    ((_e, served),) = await _workers(drt, 1)
    epp = await _epp(drt, breaker_config=bc)
    base = f"http://127.0.0.1:{epp.port}"
    FAULTS.configure("epp.breaker:error", seed=3)
    try:
        async with aiohttp.ClientSession() as sess:
            await _pick_until_ok(sess, base, {"token_ids": list(range(16))})
            for _ in range(6):
                async with sess.post(f"{base}/pick",
                                     json={"token_ids": list(range(16))}) as r:
                    assert r.status == 200
        assert epp.breakers.state(served.instance.instance_id) == OPEN
        assert FAULTS.snapshot()["trips"].get("epp.breaker:error", 0) >= 4
    finally:
        FAULTS.clear()
        await epp.close()
        await drt.close()


async def test_epp_pick_span_joins_the_callers_trace(tmp_path):
    """The ``epp.pick`` span (test_observability.py's gateway hop): a
    pick sent with a ``traceparent`` header is a child of the caller's
    span in the same trace."""
    spans_path = tmp_path / "spans.jsonl"
    tracing.set_trace_file(str(spans_path))
    drt = DistributedRuntime(InMemoryHub())
    await _workers(drt, 1)
    epp = await _epp(drt)
    tc = tracing.new_trace()
    try:
        async with aiohttp.ClientSession() as sess:
            for _ in range(100):
                async with sess.post(f"http://127.0.0.1:{epp.port}/pick",
                                     json={"token_ids": [1, 2, 3, 4]},
                                     headers={tracing.TRACEPARENT: tc.to_traceparent()}) as r:
                    if r.status == 200:
                        break
                await asyncio.sleep(0.05)
            assert r.status == 200
    finally:
        await epp.close()
        await drt.close()
        tracing.set_trace_file(None)
    spans = [json.loads(ln) for ln in spans_path.read_text().splitlines()]
    ours = [s for s in spans if s["span"] == "epp.pick" and s["trace_id"] == tc.trace_id]
    assert ours and all(s["parent_span_id"] == tc.span_id for s in ours)


# ----------------------------------------------------- against the JAX EPP


async def _both_on_one_hub():
    """A port TCP hub, two port mock workers (one warmed with a prefix),
    the port's EPP and the JAX package's on it: one hub state."""
    from dynamo_tpu.gateway.epp import EndpointPicker as JaxPicker
    from dynamo_tpu.kv_router.protocols import RouterConfig as JaxRouterConfig
    from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.hub_server import HubServer

    hub = HubServer()
    host, port = await hub.start()
    addr = f"{host}:{port}"
    drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))
    workers = await _workers(drt, 2)
    jdrt = JaxRuntime(await JaxRemoteHub.connect(addr), JaxRuntimeConfig(hub_address=addr))
    port_epp = await _epp(drt, pick_port=0)
    jax_epp = await JaxPicker(jdrt, namespace="dyn", target_component="backend",
                              config=JaxRouterConfig(block_size=4), host="127.0.0.1",
                              port=0, pick_port=0).start()

    async def close():
        await port_epp.close()
        await jax_epp.close()
        await jdrt.close()
        await drt.close()
        await hub.stop()

    return workers, port_epp, jax_epp, close


async def test_port_and_jax_epp_pick_alike_on_one_hub_state():
    """On one hub state (two workers, one of them warm on a prefix) the
    port's EPP and the JAX package's answer the same prompts with the same
    ``worker_id``, ``overlap_blocks`` and ``x-gateway-destination-endpoint``
    header: a warm prompt goes to its prefix's worker."""
    workers, port_epp, jax_epp, close = await _both_on_one_hub()
    (eng_a, served_a), _b = workers
    warm = list(range(40, 72))
    try:
        async for _ in eng_a.generate({"token_ids": warm,
                                       "stop_conditions": {"max_tokens": 2}},
                                      Context("warm")):
            pass
        prompts = [warm, warm[:20] + [1, 2, 3], warm + [9] * 8]
        async with aiohttp.ClientSession() as sess:
            for epp in (port_epp, jax_epp):  # both indexed the warm prefix
                base = f"http://127.0.0.1:{epp.port}"
                for _ in range(200):
                    body, _h = await _pick_until_ok(sess, base, {"token_ids": warm})
                    if body["overlap_blocks"] == len(warm) // 4:
                        break
                    await asyncio.sleep(0.05)
            for p in prompts:
                got = []
                for epp in (port_epp, jax_epp):
                    body, headers = await _pick_until_ok(
                        sess, f"http://127.0.0.1:{epp.port}", {"token_ids": p})
                    got.append((body["worker_id"], body["overlap_blocks"], body["endpoint"],
                                headers["x-gateway-destination-endpoint"]))
                assert got[0] == got[1], (p, got)
                assert got[0][0] == served_a.instance.instance_id and got[0][1] > 0
    finally:
        await close()


async def test_pickline_interop_both_ways():
    """The JAX package's pickline client picks from the port's server and
    the port's client from the JAX package's server, on the same wire:
    the answers equal the HTTP picks of each server."""
    from dynamo_tpu.gateway.pickline import PickLineClient as JaxPickLineClient

    workers, port_epp, jax_epp, close = await _both_on_one_hub()
    toks = list(range(16))
    try:
        async with aiohttp.ClientSession() as sess:
            http = [(await _pick_until_ok(sess, f"http://127.0.0.1:{e.port}",
                                          {"token_ids": toks}))[0]
                    for e in (port_epp, jax_epp)]
        for client_cls, epp, want in ((JaxPickLineClient, port_epp, http[0]),
                                      (PickLineClient, jax_epp, http[1])):
            cl = await client_cls("127.0.0.1", epp.pick_port).connect()
            try:
                rs = await asyncio.gather(*(cl.pick({"token_ids": toks}) for _ in range(4)))
            finally:
                await cl.close()
            assert [r["id"] for r in rs] == [1, 2, 3, 4]
            for r in rs:
                assert r["status"] == 200
                assert (r["worker_id"], r["endpoint"], r["overlap_blocks"]) == (
                    want["worker_id"], want["endpoint"], want["overlap_blocks"])
    finally:
        await close()


async def test_gateway_module_serves_pick_healthz_metrics_and_pickline():
    """``python -m dynamo_tpu_torch.gateway`` as a user starts it, against a
    TCP hub with a mock worker: it prints its HTTP and pickline addresses
    and serves /healthz, /pick (with the GIE header), /metrics and a
    pickline pick."""
    import subprocess
    import sys

    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.hub_server import HubServer

    hub = HubServer()
    host, port = await hub.start()
    addr = f"{host}:{port}"
    drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))
    await launch_mock_worker(drt, "dynamo", "backend", "generate", MOCK)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.gateway", "--hub", addr, "--host",
         "127.0.0.1", "--port", "0", "--pick-port", "0", "--block-size", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        lines = {}
        while len(lines) < 2:
            line = await asyncio.wait_for(asyncio.to_thread(proc.stdout.readline), 30)
            assert line, "the gateway exited"
            k, _, v = line.strip().partition("=")
            lines[k] = v
        http, pick = lines["DYNAMO_EPP"], lines["DYNAMO_EPP_PICK"]
        base = f"http://{http}"
        async with aiohttp.ClientSession() as sess:
            async with sess.get(f"{base}/healthz") as r:
                assert r.status == 200 and (await r.json())["status"] == "ok"
            body, headers = await _pick_until_ok(sess, base, {"token_ids": list(range(8))},
                                                 timeout_s=20.0)
            assert headers["x-gateway-destination-endpoint"] == body["endpoint"]
            async with sess.get(f"{base}/metrics") as r:
                assert "dynamo_epp_pick_seconds" in await r.text()
        h, p = pick.rsplit(":", 1)
        cl = await PickLineClient(h, int(p)).connect()
        try:
            r = await cl.pick({"token_ids": list(range(8))})
        finally:
            await cl.close()
        assert r["status"] == 200 and r["worker_id"] == body["worker_id"]
    finally:
        proc.terminate()
        await asyncio.to_thread(proc.wait, 10)
        await drt.close()
        await hub.stop()
