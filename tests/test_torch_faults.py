"""The port's fault registry (runtime/faults.py) against the JAX package's.

The spec grammar parses to the same rules and round-trips through
``spec()``; malformed specs raise the same errors; the same spec and seed
give the same drop / delay / error / no-op decision at every call, the same
``corrupt_bytes`` flips and ``corrupt_token_ids`` values, the same
snapshots, and trip counts that stay cumulative across ``configure()``.
All comparisons are exact (the decisions are seeded ``random.Random``
draws; there is no tolerance).
"""

import asyncio
import random

import pytest

from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime.integrity import corrupt_token_ids as jax_corrupt_tokens
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime.integrity import corrupt_token_ids, token_checksum

pytestmark = pytest.mark.unit

SPECS = [
    "transport.send:drop@0.02",
    "hub.fsync:delay=50ms",
    "engine.step:error@0.001",
    "disagg.pull:error@1x1",
    "disagg.pull:corrupt=3x1",
    "engine.step:delay=80ms~10.0.0.3:*",
    "transport.partition:drop=a:1|b:2",
    "transport.partition:drop=a:1>b:2@0.5",
    "x.y:delay=0.2s@0.5x3,x.y:drop@0.3,z:error",
    "health.canary:corrupt~127.0.0.1:*",
    "health.canary:corrupt=2@0.5",
    "a:delay=1.5,b:delay=2m",
]
BAD_SPECS = [
    "site_without_action",
    "x:explode",
    "x:delay",
    "transport.partition:drop",
    "transport.partition:delay=5ms",
    "transport.partition:drop=a:1>",
    "x:corrupt=0",
    "x:corrupt=-1",
    "x:drop~",
    "x:drop@abc",
    "x:delay=fast",
]


def _rules(pkg, spec):
    return [vars(r) for r in pkg.parse_spec(spec)]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_and_round_trips_like_jax(spec):
    assert _rules(tfaults, spec) == _rules(jfaults, spec)
    specs = [r.spec() for r in tfaults.parse_spec(spec)]
    assert specs == [r.spec() for r in jfaults.parse_spec(spec)]
    assert _rules(tfaults, ",".join(specs)) == _rules(tfaults, spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_like_jax(spec):
    errors = []
    for pkg in (jfaults, tfaults):
        with pytest.raises(Exception) as e:
            pkg.FaultRegistry(spec)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


def _decisions(pkg, spec, seed, n=300):
    """Every site's decision for n calls, interleaved across sites and
    instances, plus the delays fire() would sleep."""
    reg = pkg.FaultRegistry(spec, seed=seed, instance="10.0.0.3:7000")
    out = []
    rng = random.Random(seed)
    for _ in range(n):
        site = rng.choice(["transport.send", "hub.fsync", "engine.step", "x.y", "z",
                           "disagg.pull", "a", "b"])
        inst = rng.choice([None, "10.0.0.3:1", "10.0.0.4:1", ""])
        rule = reg.decide(site, instance=inst, kinds=("drop", "delay", "error"))
        out.append(None if rule is None else (rule.spec(), rule.trips))
    links = [reg.link_blocked("transport.partition", s, d)
             for s, d in [("a:1", "b:2"), ("b:2", "a:1"), ("a:1", "c:3")] * 20]
    return out, links, reg.snapshot(), dict(reg.trip_counts), reg.exposition()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_same_spec_and_seed_same_decisions(seed):
    spec = ",".join(s for s in SPECS if not s.startswith("health"))
    assert _decisions(tfaults, spec, seed) == _decisions(jfaults, spec, seed)


def test_fire_and_fire_sync_raise_and_sleep_like_jax():
    spec = "s:drop@0.3,s:error@0.3,s:delay=1ms@0.3"

    async def run(pkg):
        reg = pkg.FaultRegistry(spec, seed=3)
        out = []
        for i in range(60):
            try:
                if i % 2:
                    await reg.fire("s")
                else:
                    reg.fire_sync("s")
                out.append("ok")
            except ConnectionResetError as e:
                out.append(("drop", type(e).__name__, str(e)))
            except RuntimeError as e:
                out.append(("error", type(e).__name__, str(e)))
        return out, reg.snapshot()

    assert asyncio.run(run(tfaults)) == asyncio.run(run(jfaults))
    assert issubclass(tfaults.FaultDrop, ConnectionResetError)
    assert issubclass(tfaults.FaultInjected, RuntimeError)


@pytest.mark.parametrize("seed", [0, 5])
def test_corrupt_bytes_flip_the_same_bits(seed):
    spec = "p:corrupt=3@0.7x5,q:corrupt"
    regs = [pkg.FaultRegistry(spec, seed=seed) for pkg in (jfaults, tfaults)]
    data = bytes(range(64))
    for i in range(10):
        site = "p" if i % 3 else "q"
        outs = [r.corrupt_bytes(site, data) for r in regs]
        assert outs[0] == outs[1]
        # a corrupt rule never fires at a fire() site
        assert all(r.decide(site, kinds=("drop", "delay", "error")) is None
                   for r in regs)
    assert regs[0].snapshot() == regs[1].snapshot()


def test_corrupt_token_ids_and_cumulative_trips():
    """The process-wide registries: the canary hook flips one token value
    the same way in both packages, only for the scoped instance; trip
    counts keep growing across configure()."""
    toks = [5, 6, 7, 128255]
    try:
        for pkg in (jfaults, tfaults):
            pkg.FAULTS.configure("health.canary:corrupt~127.0.0.1:*", seed=11)
        got = corrupt_token_ids("health.canary", toks, instance="127.0.0.1:9000")
        want = jax_corrupt_tokens("health.canary", toks, instance="127.0.0.1:9000")
        assert got == want and got != toks
        assert sum(a != b for a, b in zip(got, toks)) == 1
        assert token_checksum(got) != token_checksum(toks)
        # another worker's canary is untouched, and so is no identity
        assert corrupt_token_ids("health.canary", toks, instance="10.1.1.1:1") is toks
        assert corrupt_token_ids("health.canary", toks) is toks
        before = tfaults.FAULTS.trip_counts[("health.canary", "corrupt")]
        tfaults.FAULTS.configure("health.canary:corrupt", seed=11)
        corrupt_token_ids("health.canary", toks)
        assert tfaults.FAULTS.trip_counts[("health.canary", "corrupt")] == before + 1
        snap = tfaults.FAULTS.snapshot()
        assert snap["rules"] == ["health.canary:corrupt"] and snap["enabled"]
        assert snap["trips"]["health.canary:corrupt"] == before + 1
        from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

        text = MetricsRegistry().exposition().decode()
        assert ('dynamo_fault_trips_total{site="health.canary",action="corrupt"} '
                f"{before + 1}") in text
    finally:
        jfaults.FAULTS.clear()
        tfaults.FAULTS.clear()
    assert corrupt_token_ids("health.canary", toks) is toks


# ------------------------------------------------------------ wired sites


def _tiny_engine(**cfg):
    import torch

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.core import InferenceEngine

    torch.set_num_threads(2)
    spec = ModelSpec(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                     num_heads=4, num_kv_heads=2, head_dim=8, dtype="float32")
    return InferenceEngine(spec, EngineConfig(**{
        "page_size": 4, "num_pages": 128, "max_pages_per_seq": 32,
        "max_decode_slots": 2, "prefill_buckets": (16, 32), **cfg}), device="cpu")


def _greedy(tokens, n):
    return {"token_ids": list(tokens), "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}}


@pytest.fixture
def port_faults():
    from dynamo_tpu_torch.runtime.flight import FLIGHT

    FLIGHT.clear()
    yield tfaults.FAULTS
    tfaults.FAULTS.clear()
    FLIGHT.clear()


async def test_engine_step_error_fails_in_flight_and_keeps_serving(port_faults):
    """``engine.step:error`` on a work cycle fails the in-flight request
    (its timeline retained among the errors) and the engine serves the
    next request."""
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.flight import FLIGHT

    eng = _tiny_engine()
    ctx, items = Context(), []
    async for item in eng.generate(_greedy(range(1, 9), 60), ctx):
        items.append(item)
        if len(items) == 2:
            port_faults.configure("engine.step:error@1.0x1")
    assert items[-1]["finish_reason"] == "error"
    assert items[-1]["error"] == "engine step failure"
    assert port_faults.trip_counts[("engine.step", "error")] == 1
    errors = FLIGHT.snapshot()["errors"]
    assert [t["request_id"] for t in errors] == [ctx.id]
    tl = FLIGHT.snapshot(ctx.id)["timeline"]
    assert tl["finish_reason"] == "error" and tl["error"] == "engine step failure"
    out = [x async for x in eng.generate(_greedy(range(1, 9), 4), Context())]
    assert out[-1]["finish_reason"] == "length"
    assert sum(len(x["token_ids"]) for x in out) == 4
    assert eng.allocator.active_pages == 0
    await eng.close()


async def test_engine_step_error_spares_a_request_sent_after_the_error(port_faults):
    """The step-failure sweep drains the waiting queue before it fails the
    slots: a request sent once an in-flight stream has seen its error is
    served. The step thread is held inside the sweep, right after the
    slot's error item is posted, until the next request is queued, which
    makes the old order (slots first, queue second) fail it every time."""
    import threading

    from dynamo_tpu_torch.runtime.context import Context

    eng = _tiny_engine()
    finish, gate = eng._finish, threading.Event()

    def held_finish(slot_idx, slot, reason, **kw):
        finish(slot_idx, slot, reason, **kw)
        if reason == "error" and not gate.is_set():
            gate.wait(10.0)

    eng._finish = held_finish
    items = []
    async for item in eng.generate(_greedy(range(1, 9), 60), Context()):
        items.append(item)
        if len(items) == 2:
            port_faults.configure("engine.step:error@1.0x1")
    assert items[-1]["error"] == "engine step failure"

    async def second():
        return [x async for x in eng.generate(_greedy(range(1, 9), 4), Context())]

    task = asyncio.ensure_future(second())
    for _ in range(1000):
        if eng._waiting.qsize():
            break
        await asyncio.sleep(0.005)
    assert eng._waiting.qsize() == 1
    gate.set()
    out = await task
    assert out[-1]["finish_reason"] == "length", out[-1]
    assert sum(len(x["token_ids"]) for x in out) == 4
    assert eng.allocator.active_pages == 0
    await eng.close()


async def test_engine_admit_drop_stays_retryable(port_faults):
    """An ``engine.admit`` drop is the retryable ServiceUnavailable (a
    StreamError: migration re-drives it); an error is not retryable; both
    open no timeline, and the next request is served."""
    from dynamo_tpu_torch.runtime.context import Context, ServiceUnavailable, StreamError
    from dynamo_tpu_torch.runtime.flight import FLIGHT

    eng = _tiny_engine()
    port_faults.configure("engine.admit:drop@1.0x1")
    ctx = Context()
    with pytest.raises(ServiceUnavailable, match="injected admit drop") as e:
        [x async for x in eng.generate(_greedy([1, 2, 3], 2), ctx)]
    assert isinstance(e.value, StreamError)
    port_faults.configure("engine.admit:error@1.0x1")
    with pytest.raises(tfaults.FaultInjected):
        [x async for x in eng.generate(_greedy([1, 2, 3], 2), Context())]
    assert not FLIGHT.snapshot(ctx.id)["found"]
    out = [x async for x in eng.generate(_greedy([1, 2, 3], 2), Context())]
    assert out[-1]["finish_reason"] == "length"
    await eng.close()


async def test_engine_compile_error_is_reported_and_serving_works(port_faults):
    """``engine.compile`` fires per precompiled variant: an error is in the
    precompile() report (the variant captures at first use) and the engine
    still serves."""
    from dynamo_tpu_torch.runtime.context import Context

    eng = _tiny_engine(spec_mode="ngram")
    port_faults.configure("engine.compile:error@1.0x2")
    report = eng.precompile()
    names = list(report)
    assert names[:2] == ["decode[2xgreedy]", "decode[2xgreedy,lp20]"]
    assert names[4:] == ["verify[1x9]", "verify[2x9]"]  # spec_k_max 8: width 9
    errored = [n for n, r in report.items() if "error" in r]
    assert errored == names[:2]
    assert all(r["compiles"] == 0 for r in report.values())  # nothing captures on the CPU
    out = [x async for x in eng.generate(_greedy(range(1, 9), 6), Context())]
    assert out[-1]["finish_reason"] == "length"
    assert sum(len(x["token_ids"]) for x in out) == 6
    await eng.close()


async def test_transport_and_hub_sites_fire(port_faults):
    """The transport.* and hub.* sites: a dial that fails, a request that
    dies at send or on receipt, a hub dial that fails and a dropped hub call
    the client retries."""
    from dynamo_tpu_torch.runtime.context import Context, StreamError
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.hub_server import HubServer
    from dynamo_tpu_torch.runtime.transport import EndpointServer, InstanceChannel

    async def gen(request, context):
        for i in range(4):
            yield i

    srv = EndpointServer()
    srv.register("ep", gen)
    host, port = await srv.start()
    hub = HubServer(port=0)
    await hub.start()
    try:
        port_faults.configure("transport.connect:error@1.0x1")
        with pytest.raises(tfaults.FaultInjected):
            await InstanceChannel(host, port).connect()
        ch = InstanceChannel(host, port)
        await ch.connect()
        port_faults.configure("transport.send:drop@1.0x1")
        with pytest.raises(StreamError, match="send failed"):
            [x async for x in ch.call("ep", None, Context())]
        assert [x async for x in ch.call("ep", None, Context())] == [0, 1, 2, 3]
        port_faults.configure("transport.recv:drop@1.0x1")
        with pytest.raises(StreamError):
            [x async for x in ch.call("ep", None, Context())]
        await ch.close()
        addr = f"127.0.0.1:{hub.port}"
        port_faults.configure("hub.dial:error@1.0x1")
        with pytest.raises(tfaults.FaultInjected):
            await RemoteHub.connect(addr)
        client = await RemoteHub.connect(addr)
        port_faults.configure("hub.call:drop@1.0x1")
        await client.put("k", b"v")
        assert await client.get("k") == b"v"
        await client.close()
        counts = port_faults.trip_counts
        for site, action in (("transport.connect", "error"), ("transport.send", "drop"),
                             ("transport.recv", "drop"), ("hub.dial", "error"),
                             ("hub.call", "drop")):
            assert counts[(site, action)] == 1, (site, counts)
    finally:
        await srv.stop(drain=False)
        await hub.stop()
