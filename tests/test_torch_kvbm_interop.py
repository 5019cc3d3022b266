"""KVBM across packages and under faults: G4 blocks shared through one hub
between a port engine and a JAX engine (both directions), the
``kvbm.onboard`` corrupt site on every tier and the ``engine.quant`` site
(tests/test_integrity.py's posture), preemption's force-offload with a
resume that onboards, and ``cli worker --kvbm-*`` as a process.
"""

import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

import dynamo_tpu_torch.kvbm as tkvbm
from dynamo_tpu.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.faults import FAULTS as PORT_FAULTS
from dynamo_tpu_torch.runtime.integrity import integrity_snapshot
from dynamo_tpu_torch.tokens import TokenBlockSequence
from test_torch_kvbm import PROMPT, SIDES, _engine, _run

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def port_faults():
    yield PORT_FAULTS
    PORT_FAULTS.clear()


async def _until(cond, n=500):
    for _ in range(n):
        if cond():
            return True
        await asyncio.sleep(0.02)
    return False


# ------------------------------------------------------------------- G4


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
async def test_g4_blocks_onboard_across_packages(writer, reader):
    """One hub, one namespace: the writer's engine offloads a prompt to G4;
    the reader's engine (empty G1, G2) onboards every block from G4 and
    serves the writer's stream, then finds the blocks promoted into its
    G2."""
    hub, loop = InMemoryHub(), asyncio.get_running_loop()
    engines = {}
    for name in (writer, reader):
        m = SIDES[name]
        kvbm = m.kvbm.KvBlockManager(
            m.kvbm.KvbmConfig(host_bytes=1 << 20, remote_max_blocks=64),
            hub=hub, loop=loop, namespace="x")
        engines[name] = (m, kvbm, _engine(m, kvbm))
    wm, wkvbm, weng = engines[writer]
    want = await _run(weng, wm, PROMPT)
    await asyncio.to_thread(weng.offload.flush)
    hashes = TokenBlockSequence.from_tokens(PROMPT, 4).sequence_hashes()
    names = {f"{h:016x}" for h in hashes}
    # G4 writes land from the manager's writer thread
    assert await _until(lambda: names <= {n for (_b, n) in hub._objects})
    rm, rkvbm, reng = engines[reader]
    assert not any(h in rkvbm for h in hashes)
    got = await _run(reng, rm, PROMPT)
    assert got == want
    assert rkvbm.stats.onboard_hits_remote == 3
    assert all(h in rkvbm.host for h in hashes[:3])
    for _m, _k, eng in engines.values():
        await eng.close()


# --------------------------------------------------------------- faults


def _packed_block(fill):
    k = np.arange(2 * 130, dtype=np.uint8).reshape(2, 130)
    return (k + fill) % 251, (k + fill + 100) % 251


@pytest.mark.parametrize("tier", ["host", "disk", "remote"])
async def test_corrupt_onboard_is_a_miss_on_every_tier(tier, port_faults, tmp_path):
    """A bit flipped at ``kvbm.onboard`` is caught by the tier's checksum:
    a miss (never the poisoned bytes), counted on the tier's integrity
    path, the block evicted from G2/G3; the next clean read serves the
    block (test_integrity.py's three cases)."""
    hub, loop = InMemoryHub(), asyncio.get_running_loop()
    # each case holds the block in its tier alone (a lower tier would serve
    # the miss)
    cfg = tkvbm.KvbmConfig(host_bytes=1 << 20)
    if tier == "disk":
        cfg.disk_bytes, cfg.disk_dir = 1 << 20, str(tmp_path / "kv")
    if tier == "remote":
        cfg.remote_max_blocks = 8
    mgr = tkvbm.KvBlockManager(cfg, hub=hub, loop=loop, namespace="c")
    k, v = _packed_block(5)
    if tier == "host":
        mgr.offer(0xA1, k, v)
    elif tier == "disk":
        mgr.disk.put(0xA1, k, v)
    else:
        writer = tkvbm.KvBlockManager(cfg, hub=hub, loop=loop, namespace="c")
        assert await asyncio.to_thread(writer.remote.put, 0xA1, k, v)
    path = f"kvbm.{tier}"
    before = integrity_snapshot().get(path, 0)
    port_faults.configure("kvbm.onboard:corrupt=1x1")
    assert await asyncio.to_thread(mgr.get, 0xA1) is None
    port_faults.clear()
    assert integrity_snapshot()[path] == before + 1
    assert mgr.stats.onboard_misses == 1
    assert 0xA1 not in mgr
    if tier == "host":
        mgr.offer(0xA1, k, v)  # the re-prefill's reseal
    elif tier == "disk":
        mgr.disk.put(0xA1, k, v)
    got = await asyncio.to_thread(mgr.get, 0xA1)
    assert np.array_equal(got[0], k) and np.array_equal(got[1], v)
    assert 0xA1 in mgr.host  # a lower-tier hit is promoted into G2


async def test_engine_quant_site_makes_an_fp8_onboard_a_miss(port_faults):
    """The ``engine.quant`` site fires once at the first validated block of
    an fp8 onboard: that block and the rest of the prefix are a miss, the
    block leaves G2, the prompt re-prefills and the stream is unchanged."""
    m = SIDES["port"]
    kvbm = tkvbm.KvBlockManager(tkvbm.KvbmConfig(host_bytes=1 << 20))
    eng = _engine(m, kvbm, kv_dtype="fp8")
    hashes = TokenBlockSequence.from_tokens(PROMPT, 4).sequence_hashes()
    want = await _run(eng, m, PROMPT)
    hit = await _run(eng, m, PROMPT)
    eng.offload.flush()
    eng.allocator.clear_cache()
    misses = kvbm.stats.onboard_misses
    port_faults.configure("engine.quant:error@1x1")
    got = await _run(eng, m, PROMPT)
    port_faults.clear()
    assert got == want  # a full re-prefill, as the first serve
    assert kvbm.stats.onboard_misses == misses + 1
    assert not list(eng.onboards)  # nothing was onboarded
    eng.offload.flush()
    assert hashes[0] in kvbm.host  # re-sealed and offloaded again
    eng.allocator.clear_cache()
    assert await _run(eng, m, PROMPT) == hit  # a clean onboard after
    assert list(eng.onboards)[-1][1:] == (0, 3)
    await eng.close()


# ----------------------------------------------------------- preemption


async def test_preempted_stream_offloads_and_resumes_by_onboard():
    """A batch stream paused for an interactive request whose prompt takes
    most of a small pool: its sealed blocks are force-offloaded past the
    depth filter (1 block), G1 evicts them, the resume onboards them from
    G2 and the greedy stream equals its unpaused run; both packages alike."""
    from test_torch_overload import _collect, _ctx, _Gate, _tokens

    batch_prompt, inter_prompt = PROMPT, [(i * 7) % 120 + 3 for i in range(100)]
    res = {}
    for name, m in SIDES.items():
        cfg = dict(num_pages=28, max_pages_per_seq=32, max_decode_slots=1,
                   prefill_buckets=(8, 16, 32, 64, 128))
        plain = _engine(m, **cfg)
        ref = await _run(plain, m, batch_prompt, 40)
        await plain.close()
        kvbm = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(host_bytes=1 << 20,
                                                       max_offload_depth_blocks=1))
        eng = _engine(m, kvbm, **cfg)
        gate = _Gate(eng)
        items: list = []
        req = {"token_ids": batch_prompt, "sampling": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 40, "ignore_eos": True}}
        t_batch = asyncio.create_task(_collect(eng, req, _ctx(m, "bt", "batch"), items))
        assert await _until(lambda: len(items) >= 12)
        await gate.close()
        inter = asyncio.create_task(_collect(
            eng, {"token_ids": inter_prompt, "stop_conditions": {"max_tokens": 4,
                                                                "ignore_eos": True}},
            _ctx(m, "it")))
        assert await _until(lambda: eng._waiting.qsize() == 1)
        gate.release()
        await inter
        bout = await t_batch
        eng.offload.flush()
        res[name] = (_tokens(bout), ref, dict(eng.preemptions), kvbm.stats.to_dict(),
                     eng.allocator.active_pages)
        await eng.close()
    port = res["port"]
    assert port[0] == port[1] and len(port[0]) == 40
    assert port[2] == {"interactive_admission": 1}
    assert port[3]["onboard_hits_host"] > 1  # past the depth-filtered block
    assert port[4] == 0
    # the pause point follows each engine's speed: the streams and the
    # preemption compare, the counters need not
    assert res["jax"][0] == port[0] and res["jax"][2] == port[2]


# ---------------------------------------------------------- cli worker


@pytest.mark.e2e
async def test_cli_worker_serves_with_kvbm_and_reports_it(tmp_path):
    """``cli worker --kvbm-host-mb 64 --kvbm-disk-mb 8 --kvbm-disk-dir D
    --device cpu`` starts, serves a prompt twice, and the admin
    ``cache_status`` carries the KVBM counters."""
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from test_torch_processes import _Child

    hub = _Child("hub", "--port", "0")
    worker = None
    try:
        addr = hub.wait_line(r"^DYNAMO_HUB=").split("=", 1)[1]
        worker = _Child("worker", "--hub", addr, "--device", "cpu", "--model",
                        "tiny-test", "--kvbm-host-mb", "64", "--kvbm-disk-mb", "8",
                        "--kvbm-disk-dir", str(tmp_path / "g3"))
        worker.wait_line(r"^ENGINE_READY$")
        drt = DistributedRuntime(await RemoteHub.connect(addr),
                                 RuntimeConfig(hub_address=addr))
        try:
            comp = drt.namespace("dynamo").component("backend")
            gen = await comp.endpoint("generate").client().start()
            admin = await comp.endpoint("admin").client().start()
            assert await _until(lambda: gen.instance_ids() and admin.instance_ids())
            req = {"token_ids": list(range(20, 53)),
                   "stop_conditions": {"max_tokens": 4, "ignore_eos": True}}
            for _ in range(2):
                async for _item in gen.call_instance(gen.instance_ids()[0], req, Context()):
                    pass

            async def status():
                out = None
                async for item in admin.call_instance(admin.instance_ids()[0],
                                                      {"op": "cache_status"}, Context()):
                    out = item
                return out

            st = await status()
            for _ in range(100):
                if st["kvbm"]["offloaded"] >= 2:
                    break
                await asyncio.sleep(0.05)
                st = await status()
            assert st["ok"] and set(st["kvbm"]) == {
                "offloaded", "onboard_hits_host", "onboard_hits_disk",
                "onboard_hits_remote", "onboard_misses"}
            assert st["kvbm"]["offloaded"] >= 2
            await gen.close()
            await admin.close()
        finally:
            await drt.close()
        assert worker.stop() == 0
    finally:
        for child in (worker, hub):
            if child is not None and child.proc.poll() is None:
                child.stop()
