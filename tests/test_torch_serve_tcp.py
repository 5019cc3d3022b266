"""The serving stacks of tests/test_torch_serve.py, each cut into hub server,
worker and frontend with their own DistributedRuntime over a RemoteHub on
loopback: requests cross the TCP hub (discovery, leases) and the TCP
endpoint transport (token streams), msgpack bytes on both sides.

- JAX: its HubServer; a worker runtime with the JAX engine registered by
  hand (guided decoding off, round-robin); a frontend runtime with its
  ModelWatcher and aiohttp HttpFrontend.
- Port: the same cut with the port's HubServer, ``launch_engine_worker``
  on the same weights (``device="cpu"``) and its HttpFrontend.
- Mixed: a second port worker on the JAX hub, served under another model
  name and component, so the JAX frontend routes to a port worker over the
  JAX wire.

Each test sends the same requests to the stacks and compares the answers
minus ``id``/``created`` (and the model name, for the mixed stack):
bodies equal, logprobs within LP_TOL, SSE chunks in order.
"""

import asyncio
import threading

import aiohttp
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.frontend.http import HttpFrontend as JaxHttpFrontend
from dynamo_tpu.frontend.model_card import register_llm as jax_register_llm
from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu.runtime.hub_server import HubServer as JaxHubServer
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer
from test_torch_serve import (
    CFG_KW,
    MODEL,
    SPEC_KW,
    _PARITY,
    _assert_same,
    _sse_chunks,
    _strip,
    _weights,
)

pytestmark = pytest.mark.integration

TIMEOUT = 120
MIXED_MODEL = "tiny-port"


class _TcpStacks:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=TIMEOUT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def start(self):
        jp, tp = _weights()
        # JAX: hub server, worker runtime, frontend runtime
        self.jhub = JaxHubServer(port=0)
        await self.jhub.start()
        jaddr = f"127.0.0.1:{self.jhub.port}"
        jcfg = JaxRuntimeConfig(hub_address=jaddr)
        self.jworker = JaxRuntime(await JaxRemoteHub.connect(jaddr), jcfg)
        self.jeng = JaxEngine(JaxSpec(**SPEC_KW),
                              JaxEngineConfig(**CFG_KW, guided_mode="off"), params=jp)
        await jax_register_llm(
            self.jworker, self.jworker.namespace("dynamo").component("backend").endpoint(
                "generate"), self.jeng.generate, model_name=MODEL,
            router_mode="round_robin", context_length=self.jeng.config.max_context,
            kv_block_size=CFG_KW["page_size"])
        await self.jeng.start()
        # mixed: a port worker on the JAX hub, under its own model name
        self.mworker = DistributedRuntime(await RemoteHub.connect(jaddr),
                                          RuntimeConfig(hub_address=jaddr))
        self.meng, served = await launch_engine_worker(
            self.mworker, component="port-backend", model_name=MIXED_MODEL,
            spec=ModelSpec(**SPEC_KW),
            engine_config=EngineConfig(**CFG_KW), params=tp, device="cpu",
            router_mode="round_robin")
        assert served.instance.transport == "tcp"
        self.jfront = JaxRuntime(await JaxRemoteHub.connect(jaddr), jcfg)
        self.jwatch = await JaxModelWatcher(self.jfront, JaxModelManager()).start()
        await self.jwatch.wait_for_model(MODEL, timeout=10)
        await self.jwatch.wait_for_model(MIXED_MODEL, timeout=10)
        self.jhttp = JaxHttpFrontend(self.jwatch.manager, host="127.0.0.1", port=0,
                                     drt=self.jfront)
        await self.jhttp.start()
        # the port: the same cut
        self.hub = HubServer(port=0)
        await self.hub.start()
        addr = f"127.0.0.1:{self.hub.port}"
        self.worker = DistributedRuntime(await RemoteHub.connect(addr),
                                         RuntimeConfig(hub_address=addr))
        self.eng, served = await launch_engine_worker(
            self.worker, model_name=MODEL, spec=ModelSpec(**SPEC_KW),
            engine_config=EngineConfig(**CFG_KW), params=tp, device="cpu",
            router_mode="round_robin")
        assert served.instance.transport == "tcp"
        self.front = DistributedRuntime(await RemoteHub.connect(addr),
                                        RuntimeConfig(hub_address=addr))
        self.watch = await ModelWatcher(self.front, ModelManager()).start()
        await self.watch.wait_for_model(MODEL, timeout=10)
        self.http = HttpFrontend(self.watch.manager, host="127.0.0.1", port=0,
                                 drt=self.front)
        await self.http.start()
        self.bases = {"jax": f"http://127.0.0.1:{self.jhttp.port}",
                      "mixed": f"http://127.0.0.1:{self.jhttp.port}",
                      "port": f"http://127.0.0.1:{self.http.port}"}
        self.session = aiohttp.ClientSession()

    async def stop(self):
        await self.session.close()
        await self.http.stop()
        await self.watch.close()
        await self.front.close()
        await self.eng.close()
        await self.worker.close()
        await self.hub.stop()
        await self.jhttp.stop()
        await self.jwatch.close()
        await self.jfront.close()
        await self.meng.close()
        await self.mworker.close()
        await self.jeng.close()
        await self.jworker.close()
        await self.jhub.stop()

    async def post(self, side, route, body):
        if side == "mixed":
            body = {**body, "model": MIXED_MODEL}
        async with self.session.post(self.bases[side] + route, json=body) as r:
            text = await r.text()
            if r.content_type == "text/event-stream":
                return r.status, _sse_chunks(text)
            return r.status, (await r.json() if r.content_type == "application/json"
                              else text)


@pytest.fixture(scope="module")
def tcp_stacks():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    s = _TcpStacks()
    s.run(s.start())
    try:
        yield s
    finally:
        s.run(s.stop())
        s.loop.call_soon_threadsafe(s.loop.stop)
        s.thread.join(10)
        s.loop.close()
        torch.set_num_threads(prev)


def _unname(x):
    """The mixed stack's answers name MIXED_MODEL where the others name MODEL."""
    if isinstance(x, dict):
        return {k: (MODEL if k == "model" and v == MIXED_MODEL else _unname(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_unname(v) for v in x]
    return x


@pytest.mark.parametrize("case", list(_PARITY))
def test_tcp_stack_parity(tcp_stacks, case):
    """JAX over TCP, the port over TCP, and the JAX frontend and hub routing
    to a port worker give the same answers."""
    route, body, jax_body = _PARITY[case]

    async def all_sides():
        return await asyncio.gather(
            tcp_stacks.post("jax", route, jax_body or body),
            tcp_stacks.post("port", route, body),
            tcp_stacks.post("mixed", route, jax_body or body))

    (ws, want), (gs, got), (ms, mixed) = tcp_stacks.run(all_sides())
    assert gs == ws == ms == 200, (got, want, mixed)
    _assert_same(_strip(got), _strip(want))
    _assert_same(_unname(_strip(mixed)), _strip(want))
    usage = (got[-2] if isinstance(got, list) else got).get("usage")
    if usage is not None and body.get("ignore_eos"):
        assert usage["completion_tokens"] == body["max_tokens"]


def test_tcp_concurrent_completions_round_robin(tcp_stacks):
    """Six completions at once through each stack: equal answers; the
    port's worker saw them through its EndpointServer."""
    prompts = ["alpha beta", "gamma", "delta epsilon zeta eta", "theta iota",
               "kappa", "lambda mu nu"]
    bodies = [{"model": MODEL, "prompt": p, "max_tokens": 6, "ignore_eos": True,
               "stream": i % 2 == 0} for i, p in enumerate(prompts)]

    async def fan(side):
        return await asyncio.gather(*(tcp_stacks.post(side, "/v1/completions", b)
                                      for b in bodies))

    want = tcp_stacks.run(fan("jax"))
    for side in ("port", "mixed"):
        got = tcp_stacks.run(fan(side))
        for (gs, g), (ws, w) in zip(got, want):
            assert gs == ws == 200
            _assert_same(_unname(_strip(g)), _strip(w))
    assert tcp_stacks.worker._server is not None
    assert tcp_stacks.worker._server.num_inflight == 0


def test_tcp_models_and_health(tcp_stacks):
    async def get(base, route):
        async with tcp_stacks.session.get(base + route) as r:
            return r.status, await r.json()

    status, models = tcp_stacks.run(get(tcp_stacks.bases["port"], "/v1/models"))
    assert status == 200 and [m["id"] for m in models["data"]] == [MODEL]
    status, health = tcp_stacks.run(get(tcp_stacks.bases["jax"], "/health"))
    assert status == 200 and health["models"] == {MODEL: {"instances": 1},
                                                   MIXED_MODEL: {"instances": 1}}


async def _admin_drain(side):
    """One worker (the JAX package's or the port's) on its own TCP hub: ask
    its admin endpoint to drain, then send a new request straight to its
    endpoint server. Returns (admin answer, instance keys left under
    v1/instances/ as their endpoints, the refusal's type name and message,
    its Retry-After)."""
    if side == "jax":
        from dynamo_tpu.engine.worker import launch_engine_worker as jax_launch
        from dynamo_tpu.runtime.context import Context as Ctx
        from dynamo_tpu.runtime.context import ServiceUnavailable as Refused
        from dynamo_tpu.runtime.transport import InstanceChannel as Channel

        hub = JaxHubServer(port=0)
        await hub.start()
        addr = f"127.0.0.1:{hub.port}"
        cfg = JaxRuntimeConfig(hub_address=addr)
        worker = JaxRuntime(await JaxRemoteHub.connect(addr), cfg)
        client = JaxRuntime(await JaxRemoteHub.connect(addr), cfg)
        eng, _ = await jax_launch(
            worker, model_name=MODEL, spec=JaxSpec(**SPEC_KW), router_mode="round_robin",
            engine_config=JaxEngineConfig(**CFG_KW, guided_mode="off"))
    else:
        from dynamo_tpu_torch.runtime.context import Context as Ctx
        from dynamo_tpu_torch.runtime.context import ServiceUnavailable as Refused
        from dynamo_tpu_torch.runtime.transport import InstanceChannel as Channel

        hub = HubServer(port=0)
        await hub.start()
        addr = f"127.0.0.1:{hub.port}"
        cfg = RuntimeConfig(hub_address=addr)
        worker = DistributedRuntime(await RemoteHub.connect(addr), cfg)
        client = DistributedRuntime(await RemoteHub.connect(addr), cfg)
        eng, _ = await launch_engine_worker(
            worker, model_name=MODEL, spec=ModelSpec(**SPEC_KW),
            engine_config=EngineConfig(**CFG_KW), device="cpu")
    comp = client.namespace("dynamo").component("backend")
    gen = await comp.endpoint("generate").client().start()
    admin = await comp.endpoint("admin").client().start()
    (inst,) = await gen.wait_for_instances(1, timeout=10)
    (adm,) = await admin.wait_for_instances(1, timeout=10)
    answer = [x async for x in admin.call_instance(adm.instance_id, {"op": "drain"},
                                                   Ctx())]
    for _ in range(500):
        if not gen.instance_ids():
            break
        await asyncio.sleep(0.01)
    keys = sorted(k.split("/")[-2] for k in await client.hub.get_prefix("v1/instances/"))
    ch = Channel(inst.host, inst.port)
    await ch.connect()
    request = {"token_ids": [5, 6, 7], "stop_conditions": {"max_tokens": 2},
               "sampling_options": {"temperature": 0.0}}
    with pytest.raises(Refused) as refusal:
        [x async for x in ch.call(inst.wire_path, request, Ctx())]
    await ch.close()
    await gen.close()
    await admin.close()
    await eng.close()
    if side == "jax":
        # the JAX worker's KV-event and load publishers outlive its engine
        await eng.events.close()
        await eng.metrics.close()
    await client.close()
    await worker.close()
    await hub.stop()
    return (answer, keys, type(refusal.value).__name__, str(refusal.value),
            refusal.value.retry_after_s, cfg.drain_timeout_s)


def test_admin_drain_op_matches_the_reference():
    """The admin ``drain`` op on a port worker and on a JAX worker: the same
    answer, the generate instance withdrawn from the hub (the admin one
    kept), and a new request refused as draining with a Retry-After inside
    the drain window."""
    async def both():
        return await _admin_drain("jax"), await _admin_drain("port")

    loop = asyncio.new_event_loop()
    try:
        want, got = loop.run_until_complete(asyncio.wait_for(both(), TIMEOUT))
    finally:
        loop.close()
    assert got[:4] == want[:4], (got, want)
    assert want[0] == [{"ok": True, "inflight": 0}]
    assert want[1] == ["admin"]
    assert "worker draining" in want[3]
    for answer in (want, got):
        assert 0 < answer[4] <= answer[5], answer
