"""The port's mocker against the JAX package's, and the CLI's mock outputs.

With the same config and seed, one request stream gives equal token
streams, equal ForwardPassMetrics (all fields but the measured wall-clock
``step_time_ms``) and equal KV events, block hashes included: the port's
mocker hashes through its own xxh3 ``tokens.py``. The same holds with the
same fault spec armed in both packages' registries. Exact equality: the
mocker's tokens are seeded ``random.Random`` draws. A port mocker on a JAX
TCP hub is indexed by the JAX KvRouter. ``cli run --out echo`` echoes the
prompt from a batch file and from piped stdin (``--in text``).
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dynamo_tpu.kv_router.protocols import RouterConfig as JaxRouterConfig
from dynamo_tpu.kv_router.router import KvRouter as JaxKvRouter
from dynamo_tpu.mocker.engine import MockEngine as JaxMockEngine
from dynamo_tpu.mocker.engine import MockEngineConfig as JaxMockConfig
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu.runtime.hub_server import HubServer as JaxHubServer
from dynamo_tpu.tokens import compute_sequence_hashes as jax_hashes
from dynamo_tpu_torch.mocker import MockEngine, MockEngineConfig
from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import RemoteHub

pytestmark = pytest.mark.integration

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 4
# 12 blocks of 4 tokens: the prompts below overflow it, so the LRU evicts
CFG = dict(block_size=BLOCK, total_kv_blocks=12, speedup_ratio=1000.0, seed=3)


class _Recorder:
    """Stands in for both publishers: records every call in order."""

    def __init__(self):
        self.log = []

    def block_stored(self, sh, parent):
        self.log.append(("stored", sh, parent))

    def blocks_removed(self, shs):
        self.log.append(("removed", list(shs)))

    def publish(self, m):
        d = dict(vars(m))
        d.pop("step_time_ms")  # measured wall clock, not modelled
        self.log.append(("metrics", d))


def _requests():
    rng = np.random.default_rng(5)
    shared = rng.integers(3, 272, 10).tolist()
    reqs = []
    for i in range(8):
        toks = (shared if i % 2 else []) + rng.integers(3, 272, 6 + i).tolist()
        reqs.append({"token_ids": toks,
                     "stop_conditions": {"max_tokens": 5 + i % 3,
                                         "ignore_eos": bool(i % 3)}})
    return reqs


async def _drive(engine_cls, cfg, ctx_cls, reqs):
    rec = _Recorder()
    eng = engine_cls(cfg, event_publisher=rec, metrics_publisher=rec)
    streams = []
    for r in reqs:
        out = []
        try:
            async for item in eng.generate(dict(r), ctx_cls()):
                out.append(item)
        except Exception as e:  # noqa: BLE001 - the fault cases raise
            out.append((type(e).__name__, str(e)))
        streams.append(out)
    return streams, rec.log


@pytest.mark.parametrize("case", ["plain", "echo", "faults"])
async def test_same_requests_same_tokens_metrics_events(case):
    echo = case == "echo"
    spec = "engine.step:error@0.2,engine.admit:drop@0.2" if case == "faults" else ""
    try:
        for pkg in (jfaults, tfaults):
            pkg.FAULTS.configure(spec, seed=4)
        want = await _drive(JaxMockEngine, JaxMockConfig(**CFG, echo_prompt=echo),
                            JaxContext, _requests())
        for pkg in (jfaults, tfaults):
            pkg.FAULTS.configure(spec, seed=4)
        got = await _drive(MockEngine, MockEngineConfig(**CFG, echo_prompt=echo),
                           Context, _requests())
    finally:
        jfaults.FAULTS.clear()
        tfaults.FAULTS.clear()
    assert got == want
    streams, log = got
    assert any(e[0] == "removed" for e in log)  # the pool evicted
    if echo:
        assert [t for d in streams[0] for t in d["token_ids"]][:5] == (
            _requests()[0]["token_ids"][:5])
    if case == "faults":
        assert any(isinstance(x, tuple) or x.get("finish_reason") == "error"
                   for s in streams for x in s)


async def _until(cond, timeout=10.0):
    t = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < t, "condition not reached"
        await asyncio.sleep(0.01)


async def test_port_mocker_on_jax_hub_is_indexed_by_jax_router():
    hub = JaxHubServer(port=0)
    await hub.start()
    addr = f"127.0.0.1:{hub.port}"
    drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))
    jdrt = JaxRuntime(await JaxRemoteHub.connect(addr), JaxRuntimeConfig(hub_address=addr))
    router = await JaxKvRouter(jdrt.hub, "dynamo/backend",
                               JaxRouterConfig(block_size=BLOCK)).start()
    eng, served = await launch_mock_worker(
        drt, "dynamo", "backend", "generate", MockEngineConfig(**CFG),
        model_name="mock", register_card=True)
    wid = served.instance.instance_id
    try:
        prompt = list(range(20, 37))  # 4 full blocks
        [x async for x in eng.generate(
            {"token_ids": prompt, "stop_conditions": {"max_tokens": 2}}, Context())]
        router.update_workers([wid])
        hs = jax_hashes(prompt, BLOCK)
        await _until(lambda: router.tree.find_matches(hs, touch=False).scores.get(wid)
                     == len(hs))
        assert router.find_best_match("q", prompt + [1, 2])[0] == wid
        router.free("q")
    finally:
        await router.close()
        for pub in (eng.events, eng.metrics):
            await pub.close()
        await drt.close()
        await jdrt.close()
        await hub.stop()


def _cli(*args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=60, **kw)


def test_cli_echo_batch_and_text(tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text('{"prompt": "echo me", "max_tokens": 400}\n')
    out = tmp_path / "out.jsonl"
    proc = _cli("--out", "echo", "--in", f"batch:{reqs}", "--output", str(out))
    assert proc.returncode == 0, proc.stderr
    (line,) = [json.loads(x) for x in out.read_text().splitlines()]
    assert "echo me" in line["text"]
    proc = _cli("--out", "echo", "--in", "text", "--max-tokens", "400",
                input="hello there\n\nsecond line\n")
    assert proc.returncode == 0, proc.stderr
    assert "interactive chat with 'echo'" in proc.stdout
    assert "hello there" in proc.stdout and "second line" in proc.stdout
    proc = _cli("--out", "mocker", "--in", f"batch:{reqs}", "--max-tokens", "6",
                "--speedup-ratio", "100")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["index"] == 0
