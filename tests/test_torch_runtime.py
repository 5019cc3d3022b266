"""The port's runtime layer (dynamo_tpu_torch/runtime/) against the JAX
package's: the in-memory hub, the push router, the operator chain, the
metrics registry and its text exposition, the context and the config, on
the same scripted inputs."""

import asyncio
import dataclasses
import json
import threading
import time

import pytest

from dynamo_tpu.runtime import context as jctx
from dynamo_tpu.runtime import pipeline as jpipeline
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu.runtime.hub import KeyExists as JaxKeyExists
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxMetrics
from dynamo_tpu_torch.runtime import context as tctx
from dynamo_tpu_torch.runtime import pipeline as tpipeline
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context, StreamError
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub, KeyExists
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.push import NoInstancesError, PushRouter, RouterMode

pytestmark = pytest.mark.unit


# ------------------------------------------------------------------- hub


class _Tap:
    """Consumes watch/subscribe generators in tasks, one event list per tag
    (cancelling a pending ``__anext__`` would close the generator)."""

    def __init__(self):
        self.events: dict[str, list] = {}
        self._tasks = []

    def add(self, tag, gen):
        async def consume():
            async for ev in gen:
                self.events[tag].append(
                    ev if isinstance(ev, tuple) else (ev.kind, ev.key, ev.value))
        self.events[tag] = []
        self._tasks.append(asyncio.ensure_future(consume()))

    async def settle(self):
        for _ in range(5):
            await asyncio.sleep(0)

    async def close(self):
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)


async def _hub_script(hub, key_exists):
    """One scripted session: KV with leases, watches, expiry, pub/sub with
    replay and dedup, purges, objects. Returns the observed log and the
    events each watcher/subscriber saw."""
    log = []
    tap = _Tap()
    await hub.put("v1/a/x", {"n": 1})
    tap.add("all", hub.watch_prefix("v1/a/", sync_marker=True))
    tap.add("new", hub.watch_prefix("v1/", initial=False))
    await tap.settle()
    lease = await hub.grant_lease(5.0)
    await hub.put("v1/a/y", [1, 2], lease_id=lease)
    await hub.put("v1/b/z", "zz", lease_id=lease)
    try:
        await hub.create("v1/a/x", 0)
    except key_exists:
        log.append(("create", "exists"))
    await hub.create("v1/a/w", 3)
    log.append(("delete", await hub.delete("v1/a/w"), await hub.delete("nope")))
    log.append(("get", await hub.get("v1/a/y"), await hub.get("v1/missing")))
    log.append(("prefix", sorted((await hub.get_prefix("v1/a/")).items())))
    log.append(("keepalive", await hub.keepalive(lease), await hub.keepalive(999)))
    lease2 = await hub.grant_lease(1.0)
    await hub.put("v1/a/short", True, lease_id=lease2)
    log.append(("reaped", len(hub.reap_expired(time.monotonic() + 2.0))))
    await hub.revoke_lease(lease)
    await tap.settle()
    log.append(("after", sorted((await hub.get_prefix("v1/")).items())))
    # pub/sub: history for late subscribers, dedup by pub_id, purges
    for i in range(4):
        log.append(("pub", await hub.publish("ev.kv.w1", {"i": i}, pub_id=f"p{i}")))
    log.append(("dup", await hub.publish("ev.kv.w1", {"i": 0}, pub_id="p0")))
    await hub.publish("ev.kv.w2", "other")
    tap.add("sub", hub.subscribe("ev.kv.*", replay=True))
    await tap.settle()
    await hub.publish("ev.kv.w2", "live")
    await hub.publish("ev.other", "unseen")
    await tap.settle()
    log.append(("purge", await hub.purge_subject("ev.kv.w1", up_to_seq=2),
                await hub.purge_subject("ev.kv.*", keep_last=1)))
    tap.add("late", hub.subscribe("ev.kv.w1", replay=True))
    await tap.settle()
    await hub.put_object("b", "o", b"data")
    log.append(("obj", await hub.get_object("b", "o"), await hub.get_object("b", "x")))
    await hub.delete_object("b", "o")
    log.append(("obj", await hub.get_object("b", "o")))
    await tap.close()
    await hub.close()
    return log, tap.events


async def test_in_memory_hub_matches_jax_hub():
    want = await _hub_script(JaxHub(), JaxKeyExists)
    got = await _hub_script(InMemoryHub(), KeyExists)
    assert got == want
    log, events = got
    assert {e[0] for e in events["all"] + events["new"]} == {"put", "delete", "sync"}
    assert len(events["sub"]) == 6 and len(events["late"]) == 1


# ---------------------------------------------------------- push router


def _named_handler(name):
    async def handler(request, context):
        yield {"name": name, "echo": request}
    return handler


async def test_push_router_round_robin_over_local_instances():
    drt = DistributedRuntime(InMemoryHub())
    ep = drt.namespace("ns").component("backend").endpoint("generate")
    served = [await ep.serve(_named_handler(n)) for n in ("a", "b")]
    router = await PushRouter.from_endpoint(ep, RouterMode.ROUND_ROBIN)
    await router.client.wait_for_instances(2, timeout=2)
    names = []
    for i in range(6):
        async for item in router.generate(i, Context()):
            assert item["echo"] == i
            names.append(item["name"])
    assert sorted(names) == ["a", "a", "a", "b", "b", "b"]
    assert all(x != y for x, y in zip(names, names[1:]))  # alternates
    # direct pinning, and a pin to an instance that is not live
    iid = served[1].instance.instance_id
    assert [x["name"] async for x in router.generate(0, Context(), instance_id=iid)] == ["b"]
    with pytest.raises(NoInstancesError):
        router.select(instance_id=12345)
    # withdrawn instances leave the rotation; none left -> NoInstancesError
    for s in served:
        await s.shutdown()
    await asyncio.sleep(0.05)
    with pytest.raises(NoInstancesError):
        router.select()
    await router.client.close()
    await drt.close()


async def test_client_refuses_tcp_instances_and_remote_hubs():
    drt = DistributedRuntime(InMemoryHub())
    ep = drt.namespace("ns").component("c").endpoint("e")
    await drt.hub.put(ep.instance_prefix + "ab", {
        "instance_id": 0xAB, "namespace": "ns", "component": "c", "endpoint": "e",
        "host": "10.0.0.1", "port": 9, "transport": "tcp"})
    client = await ep.client().start()
    await client.wait_for_instances(1, timeout=2)
    with pytest.raises(StreamError, match="4b"):
        async for _ in client.call_instance(0xAB, {}, Context()):
            pass
    await client.close()
    await drt.close()
    with pytest.raises(NotImplementedError, match="4b"):
        await DistributedRuntime.from_settings(RuntimeConfig(hub_address="h:1"))
    local = await DistributedRuntime.from_settings(RuntimeConfig())
    assert isinstance(local.hub, InMemoryHub)
    await local.close()


async def test_deregister_withdraws_key_before_handler():
    """The drain contract: the hub key goes first; the handler serves for
    the grace period, then goes."""
    drt = DistributedRuntime(InMemoryHub(), RuntimeConfig(withdraw_grace_s=0.2))
    ep = drt.namespace("ns").component("c").endpoint("e")
    served = await ep.serve(_named_handler("a"))
    path, wire = served.instance.path, served.instance.wire_path
    task = asyncio.ensure_future(served.shutdown())
    await asyncio.sleep(0.05)
    assert await drt.hub.get(path) is None
    assert drt.local_registry.get(wire) is not None
    await task
    assert drt.local_registry.get(wire) is None
    await drt.close()


# ------------------------------------------------------------- pipeline


def _recording_registry(mod):
    reg = mod.OperatorRegistry()

    def factory(name):
        def make(sink, **kw):
            return (name, kw, sink)
        return make

    for n in ("backend", "migration", "extra"):
        reg.register(n, factory(n))
    return reg


@pytest.mark.parametrize("ops", [
    ["backend", "migration"],
    [("backend", {"tokenizer": "t"}), "extra", ("migration", {"migration_limit": 2})],
    [],
])
def test_build_chain_order_matches_jax(ops):
    want = jpipeline.build_chain(ops, "sink", reg=_recording_registry(jpipeline))
    got = tpipeline.build_chain(ops, "sink", reg=_recording_registry(tpipeline))
    assert got == want
    with pytest.raises(ValueError):
        tpipeline.build_chain([("bad",)], "sink", reg=_recording_registry(tpipeline))
    assert {"backend", "migration"} <= set(tpipeline.registry.names())


# -------------------------------------------------------------- metrics


def _feed(reg):
    c = reg.counter("http_requests_total", 'HTTP "requests"\\ n\nlines',
                    ["model", "route", "status"])
    c.labels("m", "chat", "200").inc()
    c.labels(model='we"ird\\mo\ndel', route="completions", status="400").inc(2.5)
    reg.counter("plain_total", "unlabelled").inc(3)
    reg.counter("no_suffix", "a counter named without _total").inc()
    g = reg.gauge("inflight_requests", "in-flight requests", ["model"])
    g.labels("m").inc()
    g.labels("m").inc(4)
    g.labels("m").dec(2)
    g.labels("n").set(-1.5)
    reg.gauge("empty_gauge", "no children yet", ["model"])
    h = reg.histogram("ttft_seconds", "TTFT", ["model"])
    for v in (0.0004, 0.003, 0.2, 0.2, 7.0, 1e4):
        h.labels("m").observe(v)
    h.labels("n").observe(0.5)
    h2 = reg.histogram("flush_bytes", "bytes", buckets=(64, 1024, 1048576))
    for v in (1, 64, 65, 5_000_000):
        h2.observe(v)


def _without_created(text: str) -> str:
    return "".join(line + "\n" for line in text.splitlines()
                   if not line.split(" ")[0].split("{")[0].endswith("_created")
                   and not (line.startswith("#") and line.split(" ")[2].endswith("_created")))


def test_metrics_exposition_matches_prometheus_client():
    from prometheus_client import generate_latest
    from prometheus_client.parser import text_string_to_metric_families

    jreg, treg = JaxMetrics(), MetricsRegistry()
    _feed(jreg)
    _feed(treg)
    want = _without_created(generate_latest(jreg.registry).decode())
    got = treg.render()
    assert got == want

    def samples(text):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for f in text_string_to_metric_families(text) for s in f.samples)

    assert samples(got) == samples(want)
    # global providers (the migration counters) join every exposition
    import dynamo_tpu_torch.frontend.migration  # noqa: F401

    assert treg.exposition().startswith(got.encode())
    assert b"\ndynamo_migrations_total 0\n" in treg.exposition()


def test_metrics_children_and_guards():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "d", ["a", "b"])
    assert c.labels("1", "2") is c.labels(a="1", b="2")
    assert reg.counter("x_total", "d", ["a", "b"]) is c
    with pytest.raises(ValueError):
        c.labels("only-one")
    with pytest.raises(ValueError):
        c.labels("1", "2").inc(-1)
    with pytest.raises(ValueError):
        c.inc()  # a labelled family needs .labels()


# -------------------------------------------------------- context, config


@pytest.mark.parametrize("default_s,raw", [
    (600.0, "1500"), (600.0, "0"), (600.0, "-5"), (600.0, "nan"), (600.0, "inf"),
    (600.0, "abc"), (600.0, None), (0.0, "2500"), (1.0, "5000"),
])
def test_tighten_timeout_matches_jax(default_s, raw):
    assert tctx.tighten_timeout_s(default_s, raw) == jctx.tighten_timeout_s(default_s, raw)


def test_tenancy_and_deadline_headers_match_jax():
    for h in ({}, {"x-dyn-tenant": " t1 ", "x-dyn-priority": "BATCH"},
              {"x-dyn-priority": "bogus"}, None):
        assert tctx.tenancy_from_headers(h) == jctx.tenancy_from_headers(h)
    ctx = Context(deadline=time.monotonic() + 2.0)
    ms = int(ctx.wire_headers()[tctx.DEADLINE_HEADER])
    assert 1500 < ms <= 2000
    assert 1.4 < tctx.deadline_from_headers(ctx.wire_headers()) - time.monotonic() <= 2.0
    assert tctx.deadline_from_headers({tctx.DEADLINE_HEADER: "x"}) is None
    assert Context(headers={"a": "b"}).wire_headers() == {"a": "b"}


async def test_context_stop_from_another_thread_wakes_waiters():
    """The engine's step thread and the event loop share the context: a
    stop from any thread wakes ``stopped()``, fires the callbacks once,
    cancels children and linked tasks."""
    ctx = Context()
    child = ctx.child("kid")
    fired = []
    ctx.add_stop_callback(lambda: fired.append(threading.get_ident()))
    waiter = asyncio.ensure_future(ctx.stopped())
    linked = asyncio.ensure_future(asyncio.sleep(30))
    ctx.link_task(linked)
    await asyncio.sleep(0.01)
    assert not waiter.done()
    t = threading.Thread(target=ctx.stop_generating)
    t.start()
    t.join(5)
    assert not t.is_alive()
    await asyncio.wait_for(waiter, 2)
    await asyncio.sleep(0.01)
    assert linked.cancelled()
    assert fired == [t.ident] and child.is_stopped and child.id == "kid"
    ctx.stop_generating()
    assert len(fired) == 1
    late = ctx.child()
    assert late.is_stopped
    ctx.kill()
    assert ctx.is_killed and not child.is_killed
    await asyncio.wait_for(ctx.stopped(), 1)  # already stopped: returns at once


def test_runtime_config_json_layer_matches_jax(tmp_path):
    cfg = tmp_path / "dyn.json"
    cfg.write_text(json.dumps({"namespace": "prod", "lease_ttl_s": 4.5,
                               "custom_knob": 7}))
    env = {"DYN_CONFIG": str(cfg), "DYN_STATIC": "yes", "DYN_HTTP_PORT": "9001",
           "DYN_REQUEST_TIMEOUT_S": "12.5", "UNRELATED": "x"}
    got = dataclasses.asdict(RuntimeConfig.from_env(env))
    assert got == dataclasses.asdict(JaxRuntimeConfig.from_env(env))
    assert got["namespace"] == "prod" and got["static"] is True
    assert got["extra"] == {"custom_knob": 7}
    assert RuntimeConfig().override_hub("a:1,b:2").hub_target() == "a:1,b:2"
    yml = tmp_path / "dyn.yaml"
    yml.write_text("namespace: prod\n")
    with pytest.raises(ValueError, match="PyYAML"):
        RuntimeConfig.from_env({"DYN_CONFIG": str(yml)})
