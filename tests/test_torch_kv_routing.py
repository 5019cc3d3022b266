"""KV-aware routing end to end: the port's engine as an event source, its
workers behind a kv frontend, and a mixed deployment with the reference.

- Events: the port's engine and the JAX engine on shared tiny weights
  (params_from_numpy) serve the same prompts one after another in a pool
  small enough to evict; each emits the same ordered ``stored (sh,
  parent)`` / ``removed`` stream (prompt seals, decode seals, LRU
  evictions, the admin clear), whose prompt hashes are
  dynamo_tpu.tokens.compute_sequence_hashes, and ends on the same load.
- Routing: two port workers (CPU, tiny model) on a TCP hub behind the
  port's ModelWatcher for a "kv" card: concurrent heads spread over both
  workers, and each prefix follower goes to its head's worker with the
  shared prefix's block count as its overlap estimate.
- Interop: a port worker and a JAX worker on one hub; the port's KvRouter
  and the JAX KvRouter each fold both workers' events, giving equal radix
  snapshots and equal picks for probe prompts.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.kv_router.protocols import RouterConfig as JaxRouterConfig
from dynamo_tpu.kv_router.router import KvRouter as JaxKvRouter
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu.tokens import compute_sequence_hashes as jax_hashes
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer
from dynamo_tpu_torch.tokens import compute_sequence_hashes

pytestmark = pytest.mark.integration

SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
PAGE = 4
# 24 usable pages of 4 tokens: the prompts below overflow it, so the LRU
# evicts cached pages while later prompts admit
CFG_KW = dict(page_size=PAGE, num_pages=24, max_pages_per_seq=16,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
EMBED_SCALE = 8.0  # no greedy token on a near-tie (test_torch_engine_modes.py)
MODEL = "tiny-kv"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Recorder:
    """A publisher stand-in: the engine's KV events and load, in order."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.load: list[tuple] = []

    def block_stored(self, sh, parent, block_hash=0):
        self.ops.append(("stored", sh, parent))

    def blocks_removed(self, shs):
        self.ops += [("removed", sh) for sh in shs]

    def publish(self, m):
        self.load.append((m.active_kv_blocks, m.total_kv_blocks, m.waiting_requests,
                          m.running_requests))

    async def close(self):
        pass


def _req(tokens, n=6):
    return {"token_ids": list(tokens), "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}}


async def _run(eng, ctx_cls, prompts):
    outs = []
    for p in prompts:
        outs.append([t async for item in eng.generate(_req(p), ctx_cls())
                     for t in item["token_ids"]])
    eng.request_clear_cache()
    for _ in range(500):
        if eng.allocator.evictable_pages == 0:
            break
        await asyncio.sleep(0.01)
    await eng.close()
    return outs


def test_engine_kv_events_equal_reference():
    jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(1)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    tp = params_from_numpy(ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(4)
    base = rng.integers(3, 128, 24).tolist()
    prompts = [base + rng.integers(3, 128, 6).tolist(),
               base + rng.integers(3, 128, 9).tolist(),  # prefix hit
               rng.integers(3, 128, 37).tolist(),  # evicts
               base + rng.integers(3, 128, 4).tolist(),
               rng.integers(3, 128, 41).tolist(),
               base[:16] + rng.integers(3, 128, 5).tolist()]
    jrec, trec = _Recorder(), _Recorder()
    jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW, guided_mode="off"),
                     params=jp, event_publisher=jrec, metrics_publisher=jrec)
    teng = InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW), params=tp,
                           device="cpu", event_publisher=trec, metrics_publisher=trec)
    want = asyncio.run(_run(jeng, JaxContext, prompts))
    got = asyncio.run(_run(teng, Context, prompts))
    assert got == want
    assert trec.ops == jrec.ops
    kinds = {op[0] for op in trec.ops}
    assert kinds == {"stored", "removed"}
    # every sealed page was evicted by the end (LRU, then the admin clear)
    stored = [op[1] for op in trec.ops if op[0] == "stored"]
    assert sorted(stored) == sorted(op[1] for op in trec.ops if op[0] == "removed")
    # the first prompt's blocks are the reference's sequence hashes
    hs = jax_hashes(prompts[0], PAGE)
    assert [op[1:] for op in trec.ops[:len(hs)]] == list(zip(hs, [0] + hs[:-1]))
    assert trec.load[-1] == jrec.load[-1] == (0, 24, 0, 0)


async def _until(cond, timeout=10.0):
    t = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < t, "condition not reached"
        await asyncio.sleep(0.01)


async def _tcp_hub():
    hub = HubServer(port=0)
    await hub.start()
    addr = f"127.0.0.1:{hub.port}"
    return hub, addr


async def _port_runtime(addr):
    return DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))


def _cfg():
    return EngineConfig(**{**CFG_KW, "num_pages": 128})


async def test_two_workers_behind_kv_frontend_route_followers_to_heads():
    hub, addr = await _tcp_hub()
    workers, engines = [], []
    for _ in range(2):
        drt = await _port_runtime(addr)
        eng, served = await launch_engine_worker(
            drt, model_name=MODEL, spec=ModelSpec(**SPEC_KW), engine_config=_cfg(),
            device="cpu")
        workers.append((drt, served.instance.instance_id))
        engines.append(eng)
    front = await _port_runtime(addr)
    watcher = await ModelWatcher(front, ModelManager()).start()
    try:
        await watcher.wait_for_model(MODEL, timeout=10)
        pipe = watcher.manager.get(MODEL)
        assert pipe.card.router_mode == "kv" and pipe.card.kv_block_size == PAGE
        kvp = pipe.engine.downstream.downstream
        assert type(kvp).__name__ == "KvPushRouter"
        await pipe.push_router.client.wait_for_instances(2, timeout=10)
        picks = {}
        inner = kvp.push_router.generate

        def spy(request, context, *, instance_id=None):
            picks[tuple(request["token_ids"])] = (
                instance_id, request["estimated_prefix_hit_num_blocks"])
            return inner(request, context, instance_id=instance_id)

        kvp.push_router.generate = spy
        rng = np.random.default_rng(7)
        heads, followers = [], []
        for _ in range(2):
            prefix = rng.integers(3, 128, 24).tolist()
            heads.append(prefix + rng.integers(3, 128, 8).tolist())
            followers.append(prefix + rng.integers(3, 128, 8).tolist())

        async def complete(toks):
            pre = pipe.preprocessor.preprocess({"model": MODEL, "prompt": toks,
                                                "max_tokens": 4, "ignore_eos": True})
            return [d async for d in pipe.generate(pre, Context())]

        await asyncio.gather(*(complete(h) for h in heads))
        head_workers = [picks[tuple(h)][0] for h in heads]
        assert sorted(head_workers) == sorted(w for _, w in workers)  # one each
        kv = pipe.kv_router
        for h, w in zip(heads, head_workers):
            hs = compute_sequence_hashes(h, PAGE)
            await _until(lambda: kv.tree.find_matches(hs, touch=False).scores.get(w)
                         == len(hs))

        def idle() -> bool:
            # both workers' published load is idle: a stale one (published
            # every 0.25 s) can outweigh 24 tokens of overlap in the pick
            states = {s.worker_id: s.metrics for s in kv.scheduler.workers()}
            return len(states) == 2 and all(
                m.active_kv_blocks == 0 and m.running_requests == 0
                for m in states.values())

        await _until(idle)
        await asyncio.gather(*(complete(f) for f in followers))
        for f, w in zip(followers, head_workers):
            assert picks[tuple(f)] == (w, 24 // PAGE)
        assert not kv.sequences._request_worker  # every request freed
    finally:
        await watcher.close()
        for eng in engines:
            await eng.close()
        for drt, _ in workers:
            await drt.close()
        await front.close()
        await hub.stop()


async def test_mixed_deployment_routes_identically_in_both_directions():
    """A port worker and a JAX worker publish to one hub; the port's
    KvRouter and the JAX KvRouter fold the same events into equal radix
    snapshots and make the same picks."""
    from dynamo_tpu.engine.worker import launch_engine_worker as jax_launch

    hub, addr = await _tcp_hub()
    pdrt = await _port_runtime(addr)
    peng, pserved = await launch_engine_worker(
        pdrt, model_name=MODEL, spec=ModelSpec(**SPEC_KW), engine_config=_cfg(),
        device="cpu")
    jdrt = JaxRuntime(await JaxRemoteHub.connect(addr), JaxRuntimeConfig(hub_address=addr))
    jeng, jserved = await jax_launch(
        jdrt, model_name=MODEL, spec=JaxSpec(**SPEC_KW),
        engine_config=JaxEngineConfig(**{**CFG_KW, "num_pages": 128}, guided_mode="off"))
    ids = [pserved.instance.instance_id, jserved.instance.instance_id]
    rdrt = await _port_runtime(addr)
    jrdrt = JaxRuntime(await JaxRemoteHub.connect(addr), JaxRuntimeConfig(hub_address=addr))
    prouter = await KvRouter(rdrt.hub, "dynamo/backend", RouterConfig(block_size=PAGE)).start()
    jrouter = await JaxKvRouter(jrdrt.hub, "dynamo/backend",
                                JaxRouterConfig(block_size=PAGE)).start()
    try:
        rng = np.random.default_rng(11)
        shared = rng.integers(3, 128, 16).tolist()
        p_prompts = [shared + rng.integers(3, 128, 8).tolist() for _ in range(2)]
        j_prompts = [rng.integers(3, 128, 20).tolist(),
                     shared + rng.integers(3, 128, 5).tolist()]
        for p in p_prompts:
            [x async for x in peng.generate(_req(p, 5), Context())]
        for p in j_prompts:
            [x async for x in jeng.generate(_req(p, 5), JaxContext())]
        for r in (prouter, jrouter):
            r.update_workers(ids)
        for p, w in [(p, ids[0]) for p in p_prompts] + [(p, ids[1]) for p in j_prompts]:
            hs = compute_sequence_hashes(p, PAGE)
            for r in (prouter, jrouter):
                await _until(lambda: r.tree.find_matches(hs, touch=False).scores.get(w)
                             == len(hs))
        await _until(lambda: prouter.tree.applied_events == jrouter.tree.applied_events)

        def snap(tree):
            return sorted((n["sh"], n["parent"], tuple(n["workers"]))
                          for n in tree.snapshot()["nodes"])

        assert snap(prouter.tree) == snap(jrouter.tree)
        probes = p_prompts + j_prompts + [shared + [5, 6, 7, 8], rng.integers(
            3, 128, 12).tolist(), shared[:8]]
        for i, probe in enumerate(probes):
            got = prouter.find_best_match(f"q{i}", probe)
            want = jrouter.find_best_match(f"q{i}", probe)
            assert got == want
            prouter.free(f"q{i}")
            jrouter.free(f"q{i}")
    finally:
        await prouter.close()
        await jrouter.close()
        await peng.close()
        await jeng.close()
        for d in (pdrt, jdrt, rdrt, jrdrt):
            await d.close()
        await hub.stop()
