"""The port's runtime package surface and event recorder (Queue A item 15)
against the reference's: ``dynamo_tpu_torch.runtime`` and
``dynamo_tpu_torch.engine`` export the reference's names; a port worker's
KV events captured by the port's EventRecorder replay, through
``replay_events``, into a port KvRouter and into the reference's with
equal radix snapshots (equal to the live router's too); and both
recorders write equal JSONL lines for the same events."""

import asyncio
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import dynamo_tpu.engine as jax_engine_pkg
import dynamo_tpu.runtime as jax_runtime_pkg
from dynamo_tpu.kv_router.protocols import RouterConfig as JaxRouterConfig
from dynamo_tpu.kv_router.router import KvRouter as JaxKvRouter
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu.runtime.recorder import EventRecorder as JaxRecorder
from dynamo_tpu.runtime.recorder import replay_events as jax_replay
import dynamo_tpu_torch.engine as engine_pkg
import dynamo_tpu_torch.runtime as runtime_pkg
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Annotated, AsyncEngine, collect
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.recorder import EventRecorder, load_recording, replay_events

pytestmark = pytest.mark.integration

SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
PAGE = 4
# a pool small enough that the LRU evicts: stored and removed events both
CFG_KW = dict(page_size=PAGE, num_pages=24, max_pages_per_seq=16,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
SUBJECT = "kv_events.dynamo/backend"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("port,ref", [(runtime_pkg, jax_runtime_pkg),
                                      (engine_pkg, jax_engine_pkg)])
def test_packages_export_the_reference_names(port, ref):
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        obj = getattr(port, name)
        assert obj.__module__.startswith("dynamo_tpu_torch."), name


def test_engine_package_import_builds_no_kernel_library():
    code = ("import dynamo_tpu_torch.engine as e, dynamo_tpu_torch.ops.cuda.build as b\n"
            "assert e.InferenceEngine.__module__ == 'dynamo_tpu_torch.engine.core'\n"
            "assert b._lib is None\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


async def test_async_engine_protocol_and_annotated():
    class Echo:
        async def generate(self, request, context):
            for x in request:
                yield Annotated.from_data(x)

    assert isinstance(Echo(), AsyncEngine)
    items = await collect(Echo().generate([1, 2], Context()))
    assert [a.data for a in items] == [1, 2] and items[0] == {"data": 1}
    err = Annotated.from_event("error", "boom")
    assert err.is_error() and err.event == "error" and err.data == "boom"


async def _until(pred, timeout=10.0):
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not pred():
        assert loop.time() < end, "timed out"
        await asyncio.sleep(0.02)


def _snap(tree):
    return sorted((n["sh"], n["parent"], tuple(n["workers"]))
                  for n in tree.snapshot()["nodes"])


async def test_recorded_worker_events_replay_into_both_routers(tmp_path):
    drt = DistributedRuntime(InMemoryHub())
    path = tmp_path / "session.jsonl"
    sink = open(path, "w")
    rec = EventRecorder(drt.hub, "kv_events.*", sink).start()
    live = await KvRouter(drt.hub, "dynamo/backend", RouterConfig(block_size=PAGE)).start()
    engine, served = await launch_engine_worker(
        drt, spec=ModelSpec(**SPEC_KW), engine_config=EngineConfig(**CFG_KW),
        device="cpu")
    rng = np.random.default_rng(5)
    shared = rng.integers(3, 128, 12).tolist()
    prompts = [shared + rng.integers(3, 128, 6).tolist() for _ in range(3)]
    prompts += [rng.integers(3, 128, 30).tolist() for _ in range(3)]  # evicts
    for p in prompts:
        [x async for x in engine.generate(
            {"token_ids": p, "stop_conditions": {"max_tokens": 4, "ignore_eos": True}},
            Context())]
    await engine.close()  # closes its publishers: every event is out
    await _until(lambda: live.tree.applied_events > 0)
    await asyncio.sleep(0.1)
    await rec.close()
    sink.close()
    records = load_recording(str(path))
    assert records and {r["subject"] for r in records} == {SUBJECT}
    kinds = {ev["kind"] for r in records for ev in [r["payload"]["event"]]}
    assert {"stored", "removed"} <= kinds, kinds

    phub, jhub = InMemoryHub(), JaxHub()
    prouter = await KvRouter(phub, "dynamo/backend", RouterConfig(block_size=PAGE)).start()
    jrouter = await JaxKvRouter(jhub, "dynamo/backend",
                                JaxRouterConfig(block_size=PAGE)).start()
    try:
        assert await replay_events(phub, str(path)) == len(records)
        assert await jax_replay(jhub, str(path)) == len(records)
        await _until(lambda: prouter.tree.applied_events == live.tree.applied_events
                     == jrouter.tree.applied_events)
        assert _snap(prouter.tree) == _snap(jrouter.tree) == _snap(live.tree) != []
    finally:
        for r in (live, prouter, jrouter):
            await r.close()
        await drt.close()


async def test_both_recorders_write_equal_lines():
    payloads = [{"worker_id": 7, "event": {"kind": "stored", "blocks": [1, 2]}},
                {"worker_id": 7, "event": {"kind": "removed", "hashes": [2]}},
                {"text": "é 中 \x1c", "x": [1.5, None, True]}]
    out = []
    for hub, recorder in ((InMemoryHub(), EventRecorder), (JaxHub(), JaxRecorder)):
        await hub.publish("kv_events.a", {"seed": 0})  # retained: replay=True
        sink = io.StringIO()
        rec = recorder(hub, "kv_events.*", sink).start()
        for i, p in enumerate(payloads):
            await hub.publish(f"kv_events.{'ab'[i % 2]}", p)
        await asyncio.sleep(0.05)
        await rec.close()
        lines = [json.loads(ln) for ln in sink.getvalue().splitlines()]
        for ln in lines:
            ln["t"] = 0.0
        out.append([json.dumps(ln) for ln in lines])
    assert out[0] == out[1] and len(out[0]) == 4
