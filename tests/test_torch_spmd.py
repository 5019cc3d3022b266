"""The SPMD descriptor plane of the port (dynamo_tpu_torch/parallel/spmd.py),
after tests/test_multihost.py of the JAX package.

Mirror topology in one process: a leader engine serves through an
``SpmdLeader`` (the hub in memory), and follower engine shells, each with
the whole model, replay its descriptors over TCP as asyncio tasks on the
same loop. A follower that replays every descriptor holds the leader's
pools bit for bit (same device, same functions, same inputs). Then the
catch-up ring for a late joiner, a follower lost and rejoining through the
``__sync__`` snapshot, strict mode failing loudly (in process, and a gloo
tp group whose follower rank dies), and a ``--tp 2`` worker process
serving through the frontend.
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.parallel.spmd import ADDR_KEY_FMT, SpmdFollower, SpmdLeader
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from test_torch_parallel import group_store, join_group

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
SPEC = ModelSpec(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=16, dtype="float32")
CFG_KW = dict(page_size=4, num_pages=96, max_pages_per_seq=16, max_decode_slots=4,
              prefill_buckets=(8, 16, 32, 64))
GROUP = "dynamo/backend/generate"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params():
    params = llama.init_params(SPEC, 0, device="cpu")
    params.embed.data.mul_(32.0)  # peaked logits
    return params


def _prompts(seed=0, lens=(5, 13, 9, 22)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).tolist() for n in lens]


async def _serve(eng, prompts, n=8):
    async def one(p):
        req = {"token_ids": p, "stop_conditions": {"max_tokens": n, "ignore_eos": True}}
        return [t for x in [x async for x in eng.generate(req, Context())]
                for t in x["token_ids"]]

    return list(await asyncio.gather(*(one(p) for p in prompts)))


def _bytes(pool) -> list[np.ndarray]:
    from dynamo_tpu_torch.ops.quant import is_quant

    if is_quant(pool):
        return [pool.vals.view(torch.uint8).numpy(), pool.scale.view(torch.int16).numpy()]
    return [pool.view(torch.int32).numpy()]


def _assert_pools_equal(a, b, pages=None):
    for pa, pb in zip((a.k_pages, a.v_pages), (b.k_pages, b.v_pages)):
        for x, y in zip(_bytes(pa), _bytes(pb)):
            if pages is not None:
                x, y = x[:, pages], y[:, pages]
            np.testing.assert_array_equal(x, y)


async def _clear_device_cache(eng):
    """Evict the engine's cached pages, and return only once the step
    thread has (a request sent before could be admitted on the old cache),
    so the next serve of the same prompt onboards from the KVBM tiers."""
    t0 = time.monotonic()
    eng.offload.flush()
    eng.request_clear_cache()
    while eng.allocator.active_pages or eng.allocator.evictable_pages:
        assert time.monotonic() - t0 < 20, "cached pages not evicted"
        await asyncio.sleep(0.02)


class _Plane:
    """A mirror leader engine and its followers in this process."""

    def __init__(self, cfg: dict, params, kvbm=False, strict=False):
        self.hub = InMemoryHub()
        self.cfg, self.params, self.kvbm, self.strict = cfg, params, kvbm, strict
        self.tasks: list[asyncio.Task] = []

    def _kvbm(self):
        if not self.kvbm:
            return None
        from dynamo_tpu_torch.kvbm import KvbmConfig, KvBlockManager

        return KvBlockManager(KvbmConfig(host_bytes=1 << 22))

    async def start(self):
        self.leader = await SpmdLeader(self.hub, asyncio.get_running_loop(), GROUP,
                                       strict=self.strict).start()
        self.eng = InferenceEngine(SPEC, EngineConfig(**CFG_KW, **self.cfg),
                                   params=self.params, device="cpu", spmd=self.leader,
                                   kvbm=self._kvbm())
        await self.eng.start()
        return self

    def follower(self, rejoin=True) -> tuple[InferenceEngine, SpmdFollower]:
        eng = InferenceEngine(SPEC, EngineConfig(**CFG_KW, **self.cfg),
                              params=self.params, device="cpu", kvbm=self._kvbm())
        f = SpmdFollower(self.hub, GROUP, eng, rejoin=rejoin)
        self.tasks.append(asyncio.create_task(f.run()))
        return eng, f

    async def close(self):
        await self.eng.close()
        done, _pending = await asyncio.wait(self.tasks, timeout=30)
        assert len(done) == len(self.tasks)


MIRROR_CASES = {
    "pipelined": {"pipeline_decode": True, "decode_steps_per_dispatch": 2},
    "spec": {"pipeline_decode": True, "spec_mode": "ngram", "spec_k_max": 4},
    "fp8_kvbm": {"kv_dtype": "fp8"},
}


@pytest.mark.parametrize("case", list(MIRROR_CASES))
async def test_mirror_follower_pool_equals_the_leader_bitwise(case):
    """A follower that replays the whole stream (prefills and packed
    prefills, then pipelined two-step bursts with their chain feeds; or
    spec verifies; or fp8 pools with KVBM offloads and onboards) holds the
    leader's pools bit for bit, and the leader's streams equal a plain
    engine's."""
    cfg = MIRROR_CASES[case]
    params = _params()
    plane = await _Plane(cfg, params, kvbm=case == "fp8_kvbm").start()
    feng, f = plane.follower()
    prompts = _prompts()
    prompts.append(prompts[3][:16] + [3, 4, 5, 3, 4, 5])
    got = await _serve(plane.eng, prompts)
    if case == "fp8_kvbm":
        await _clear_device_cache(plane.eng)  # the next serve onboards from G2
        got2 = await _serve(plane.eng, prompts[3:4])
        assert plane.eng.onboards
        assert got2 == got[3:4]
    await plane.close()
    plain = InferenceEngine(SPEC, EngineConfig(**CFG_KW, **cfg), params=params,
                            device="cpu")
    await plain.start()
    assert got == await _serve(plain, prompts)
    await plain.close()
    _assert_pools_equal(plane.eng, feng)
    assert f.ops.get("prefill", 0) + f.ops.get("prefill_batch", 0) > 0
    if case == "spec":
        assert f.ops.get("verify", 0) == plane.eng.spec_verifies > 0
    else:
        assert f.ops.get("decode", 0) > 0
    if case == "fp8_kvbm":
        assert f.ops.get("kv_offload", 0) > 0 and f.ops.get("kv_onboard", 0) > 0
    assert plane.leader.publish_count == f.replayed + 1  # and the stop
    assert plane.leader.publish_bytes > 0 and plane.leader.publish_secs > 0


async def test_late_follower_catches_up_through_the_ring():
    """A follower that joins after a serve replays the ring's backlog and
    ends bitwise equal to the leader."""
    plane = await _Plane({}, _params()).start()
    await _serve(plane.eng, _prompts(1))
    feng, f = plane.follower()
    await _serve(plane.eng, _prompts(2, (7, 11)))
    await plane.close()
    _assert_pools_equal(plane.eng, feng)
    assert f.rejoins == 0


async def test_killed_follower_rejoins_through_sync():
    """A follower lost mid-run: the mirror leader keeps serving; a new
    follower (a restarted process: a sync join) installs the quiesced
    snapshot of the pages in use, replays on, and holds every block the
    leader's prefix cache sealed bit for bit."""
    plane = await _Plane({"pipeline_decode": True}, _params()).start()
    feng, f = plane.follower()
    await _serve(plane.eng, _prompts(1))
    plane.tasks[0].cancel()  # the follower process dies
    await asyncio.gather(plane.tasks.pop(0), return_exceptions=True)
    await _serve(plane.eng, _prompts(2, (7, 11)))
    assert plane.leader.healthy and not plane.eng.is_dead
    os.environ["DYNAMO_SPMD_SYNC_JOIN"] = "1"
    try:
        feng2, f2 = plane.follower()
        t0 = time.monotonic()
        while f2.rejoins == 0:
            assert time.monotonic() - t0 < 20, "no rejoin sync"
            await asyncio.sleep(0.05)
    finally:
        del os.environ["DYNAMO_SPMD_SYNC_JOIN"]
    await _serve(plane.eng, _prompts(3, (6, 17)))
    await plane.close()
    sealed = sorted(plane.eng.allocator._hash_page.values())
    assert len(sealed) > 8
    _assert_pools_equal(plane.eng, feng2, sealed)
    assert f2.rejoins == 1


async def test_mirror_follower_resyncs_on_a_tier_miss():
    """A mirror follower whose tiers lost the blocks the leader onboards
    re-syncs (the snapshot holds the leader's onboarded pages) instead of
    zero-filling them, and ends bitwise equal to the leader."""
    plane = await _Plane({}, _params(), kvbm=True).start()
    feng, f = plane.follower()
    prompts = _prompts()
    await _serve(plane.eng, prompts)
    feng.offload.flush()
    feng.kvbm.clear()  # this rank's tier copies are gone
    await _clear_device_cache(plane.eng)
    await _serve(plane.eng, prompts[3:4])
    assert plane.eng.onboards
    t0 = time.monotonic()
    while f.rejoins == 0:
        assert time.monotonic() - t0 < 20, "no re-sync after the tier miss"
        await asyncio.sleep(0.05)
    await _serve(plane.eng, _prompts(3, (6, 17)))
    await plane.close()
    assert f.rejoins == 1 and f._tier_missed
    sealed = sorted(plane.eng.allocator._hash_page.values())
    _assert_pools_equal(plane.eng, feng, sealed)


async def test_strict_leader_fails_loudly_on_a_lost_follower():
    """Strict mode (a group whose ranks share collectives): a follower
    whose stream is lost latches the plane broken; the engine reports
    itself dead and every request, in flight or new, ends with an error
    naming the plane, instead of waiting forever."""
    plane = await _Plane({}, _params(), strict=True).start()
    plane.follower(rejoin=False)
    await _serve(plane.eng, _prompts(1, (5,)))
    task = plane.tasks.pop(0)
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    t0 = time.monotonic()
    while plane.leader.healthy:
        assert time.monotonic() - t0 < 20, "the lost follower went unnoticed"
        req = {"token_ids": [1, 2, 3], "stop_conditions": {"max_tokens": 2,
                                                           "ignore_eos": True}}
        _ = [x async for x in plane.eng.generate(req, Context())]
    assert plane.eng.is_dead
    req = {"token_ids": [1, 2, 3], "stop_conditions": {"max_tokens": 2}}
    out = [x async for x in plane.eng.generate(req, Context())]
    assert out[-1]["finish_reason"] == "error" and "spmd plane broken" in out[-1]["error"]
    await plane.eng.close()


async def test_leader_withdraws_its_address_and_rejects_past_the_window():
    """The leader's address sits under spmd/<group>/addr until it closes; a
    join from before the ring's oldest frame is refused (strict: loudly)."""
    from dynamo_tpu_torch.parallel import spmd as spmd_mod
    from dynamo_tpu_torch.runtime.framing import read_frame, write_frame

    hub = InMemoryHub()
    leader = await SpmdLeader(hub, asyncio.get_running_loop(), "g", strict=True).start()
    addr = await hub.get(ADDR_KEY_FMT.format(group="g"))
    assert addr and addr.startswith("127.0.0.1:")
    for _ in range(spmd_mod.RING_FRAMES + 5):
        leader.publish("decode", {"n": 1})
    await asyncio.sleep(0.05)
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    await write_frame(writer, {"from_seq": 0})
    msg = await read_frame(reader)
    assert msg["op"] == "__reject__" and "window" in msg["scalars"]["reason"]
    writer.close()
    assert not leader.healthy
    await leader.close()
    assert not await hub.get(ADDR_KEY_FMT.format(group="g"))


# ------------------------------------------------- a tp group losing a rank


def _put_and_exit(q, item, code):
    q.put(item)
    q.close()
    q.join_thread()  # the item is in the pipe before the process ends
    os._exit(code)


def _dying_group_rank(rank, port, q):
    """Rank 0 serves through a strict leader; rank 1 replays three
    descriptors and then dies."""
    try:
        torch.set_num_threads(1)
        from dynamo_tpu_torch.parallel.mesh import make_mesh
        from dynamo_tpu_torch.parallel.spmd import StoreHub

        join_group(port, 2, rank, 20)
        mesh = make_mesh(tp=2)
        cfg = EngineConfig(**CFG_KW, tp=2)

        async def main():
            if rank == 1:
                eng = InferenceEngine(SPEC, cfg, device="cpu", mesh=mesh)
                f = SpmdFollower(StoreHub(), "g", eng)
                apply = f.apply

                def dying(op, sc, ar):
                    if f.replayed == 3:
                        _put_and_exit(q, (1, "died"), 1)
                    apply(op, sc, ar)

                f.apply = dying
                await f.run()
                return None
            leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), "g",
                                      strict=True).start()
            eng = InferenceEngine(SPEC, cfg, device="cpu", mesh=mesh, spmd=leader)
            await eng.start()
            t0 = time.monotonic()
            outs = []
            while not eng.is_dead and time.monotonic() - t0 < 60:
                req = {"token_ids": [1, 2, 3, 4, 5],
                       "stop_conditions": {"max_tokens": 6, "ignore_eos": True}}
                outs.append([x async for x in eng.generate(req, Context())][-1])
            return {"dead": eng.is_dead, "secs": time.monotonic() - t0,
                    "last": outs[-1], "reason": leader.broken_reason}

        # the group cannot be torn down politely with a rank gone
        _put_and_exit(q, (rank, asyncio.run(main())), 0)
    except BaseException:  # noqa: BLE001
        _put_and_exit(q, (rank, traceback.format_exc()), 1)


def test_tp_group_leader_fails_loudly_when_a_rank_dies():
    """A gloo tp=2 group whose follower rank dies mid-serve: the leader's
    engine errors its requests and reports itself dead well inside the
    collective timeout, instead of hanging."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = group_store()
    port = store.port
    procs = [ctx.Process(target=_dying_group_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(20)
            if p.is_alive():
                p.kill()
    assert got[1] == "died"
    res = got[0]
    assert isinstance(res, dict), res
    assert res["dead"] and res["last"]["finish_reason"] == "error"
    assert res["secs"] < 40


def _tier_miss_group_rank(rank, port, q):
    """Rank 0 serves a prompt, then serves it again from its KVBM tiers
    (its device cache cleared). Rank 1's offload thread lost the prompt's
    first batch, as one whose copy failed does."""
    try:
        torch.set_num_threads(1)
        from dynamo_tpu_torch.kvbm import KvbmConfig, KvBlockManager
        from dynamo_tpu_torch.parallel.mesh import make_mesh
        from dynamo_tpu_torch.parallel.spmd import StoreHub

        join_group(port, 2, rank, 20)
        mesh = make_mesh(tp=2)
        cfg = EngineConfig(**CFG_KW, tp=2)
        kvbm = KvBlockManager(KvbmConfig(host_bytes=1 << 22))

        async def main():
            if rank == 1:
                eng = InferenceEngine(SPEC, cfg, device="cpu", mesh=mesh, kvbm=kvbm)
                submit, lost = eng.offload.submit, []

                def lossy(hashes, batch, wait=False):
                    if not lost:
                        lost.append(hashes)
                        return True
                    return submit(hashes, batch, wait=wait)

                eng.offload.submit = lossy
                f = SpmdFollower(StoreHub(), "g", eng)
                try:
                    await f.run()
                except RuntimeError as e:
                    return {"error": str(e), "lost": len(lost[0])}
                return {"error": None}
            leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), "g",
                                      strict=True).start()
            eng = InferenceEngine(SPEC, cfg, device="cpu", mesh=mesh, spmd=leader,
                                  kvbm=kvbm)
            await eng.start()
            req = {"token_ids": list(range(1, 22)),
                   "stop_conditions": {"max_tokens": 4, "ignore_eos": True}}
            first = [x async for x in eng.generate(req, Context())]
            await _clear_device_cache(eng)
            second = [x async for x in eng.generate(req, Context())]
            t0 = time.monotonic()
            while leader.healthy and time.monotonic() - t0 < 30:
                await asyncio.sleep(0.1)
            return {"first": first[-1], "second": second[-1],
                    "onboards": len(eng.onboards), "dead": eng.is_dead,
                    "reason": leader.broken_reason}

        # the group cannot be torn down politely with a rank gone
        _put_and_exit(q, (rank, asyncio.run(main())), 0)
    except BaseException:  # noqa: BLE001
        _put_and_exit(q, (rank, traceback.format_exc()), 1)


def test_tp_group_fails_loudly_when_a_rank_misses_an_onboarded_block():
    """A gloo tp=2 group whose follower rank lost an offload batch: when
    the leader onboards those blocks the follower refuses to zero-fill
    its shard (zeros would enter the all-reduce and change the tokens);
    the plane breaks and the request ends with an error, not a changed
    stream."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = group_store()
    port = store.port
    procs = [ctx.Process(target=_tier_miss_group_rank, args=(r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(20)
            if p.is_alive():
                p.kill()
    assert isinstance(got[1], dict) and isinstance(got[0], dict), got
    assert got[1]["lost"] > 0 and "cannot make up its shard" in got[1]["error"]
    res = got[0]
    assert isinstance(res, dict), res
    assert res["first"]["finish_reason"] == "length"
    assert res["onboards"] == 1
    assert res["second"]["finish_reason"] == "error"
    assert res["dead"] and res["reason"]


@pytest.mark.parametrize("coordinator,host,published", [
    ("10.1.2.3:29500", "127.0.0.1", "10.1.2.3"),
    ("node0:29500", "127.0.0.1", "node0"),
    ("tcp://[fd00::5]:29500", "127.0.0.1", "fd00::5"),
    ("10.1.2.3:29500", "10.9.9.9", "10.9.9.9"),
    ("127.0.0.1:29500", "127.0.0.1", "127.0.0.1"),
])
async def test_tp_leader_publishes_an_address_the_followers_reach(
        monkeypatch, coordinator, host, published):
    """Rank 0 of a group whose coordinator is on another host binds and
    publishes its descriptor plane on a routable address (the runtime
    config's host, else the coordinator's, which rank 0 serves the
    rendezvous on), never on loopback."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine import worker
    from dynamo_tpu_torch.parallel import mesh as mesh_mod
    from dynamo_tpu_torch.parallel import multihost
    from dynamo_tpu_torch.parallel import spmd as spmd_mod

    bound = {}

    class Leader:
        def __init__(self, hub, loop, group, host="127.0.0.1", strict=None):
            bound.update(host=host, strict=strict)

        async def start(self):
            return self

    monkeypatch.setattr(multihost, "initialize_multihost", lambda *a, **k: True)
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda **k: SimpleNamespace(rank=0))
    monkeypatch.setattr(spmd_mod, "SpmdLeader", Leader)
    monkeypatch.setattr(spmd_mod, "StoreHub", lambda: None)
    group = await worker.start_tp_group(
        EngineConfig(**CFG_KW, tp=2), spec_json=json.dumps(SPEC.__dict__),
        coordinator=coordinator, num_processes=2, process_id=0, host=host)
    assert group.leader and bound == {"host": published, "strict": True}


# ------------------------------------------------ a --tp 2 worker process


def _child(*args, env=None):
    proc = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.cli", *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    proc.lines, proc.seen = lines, []
    return proc


def _wait_line(proc, pattern, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            line = proc.lines.get(timeout=0.2)
        except queue.Empty:
            continue
        if line is None:
            break
        proc.seen.append(line)
        if re.search(pattern, line):
            return line
    raise AssertionError(f"no {pattern!r} (exit {proc.poll()}): {proc.seen[-20:]}")


def _complete(http, model, prompt):
    body = json.dumps({"model": model, "prompt": prompt, "max_tokens": 8,
                       "temperature": 0, "ignore_eos": True}).encode()
    req = urllib.request.Request(http + "/v1/completions", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["choices"][0]["text"]


def test_tp2_worker_process_serves_through_the_frontend(tmp_path):
    """``cli worker --tp 2`` (it starts its follower rank itself, gloo on
    the CPU) serves a checkpoint through ``cli frontend``: the same
    completions as a ``--tp 1`` worker on the same checkpoint; its
    follower printed MULTIHOST_FOLLOWER_READY, loaded its slice of the
    checkpoint, and both stop on SIGTERM."""
    from dynamo_tpu_torch.models import loader

    spec = ModelSpec(vocab_size=272, hidden_size=64, intermediate_size=128,
                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                     dtype="float32")
    params = llama.init_params(spec, 0, device="cpu")
    params.embed.data.mul_(32.0)
    loader.save_params(spec, params, str(tmp_path))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "DYN_LEASE_TTL_S": "3", "DYN_KEEPALIVE_INTERVAL_S": "1"}
    children = []
    try:
        hub = _child("hub", "--port", "0", env=env)
        children.append(hub)
        addr = _wait_line(hub, r"^DYNAMO_HUB=").split("=", 1)[1]
        common = ("worker", "--hub", addr, "--device", "cpu", "--model-path",
                  str(tmp_path), "--router-mode", "round_robin")
        w1 = _child(*common, "--model-name", "one", "--component", "one", env=env)
        w2 = _child(*common, "--model-name", "two", "--component", "two", "--tp", "2",
                    env=env)
        children += [w1, w2]
        _wait_line(w1, r"^ENGINE_READY$")
        _wait_line(w2, r"^ENGINE_READY$")  # its two ranks print in either order
        if "MULTIHOST_FOLLOWER_READY" not in w2.seen:
            _wait_line(w2, r"^MULTIHOST_FOLLOWER_READY$")
        front = _child("frontend", "--hub", addr, "--port", "0", "--host",
                       "127.0.0.1", env=env)
        children.append(front)
        http = "http://" + _wait_line(front, r"^DYNAMO_HTTP=").split("=", 1)[1]
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(http + "/v1/models", timeout=10) as r:
                ids = {m["id"] for m in json.loads(r.read())["data"]}
            if {"one", "two"} <= ids:
                break
            assert time.monotonic() < deadline, ids
            time.sleep(0.1)
        for prompt in ("tensor parallel", "hello there, ranks"):
            assert _complete(http, "two", prompt) == _complete(http, "one", prompt)
        w2.send_signal(signal.SIGTERM)
        assert w2.wait(60) == 0
        _wait_line(w2, r"^ENGINE_DRAINED")
    finally:
        for c in reversed(children):
            if c.poll() is None:
                c.send_signal(signal.SIGTERM)
                try:
                    c.wait(30)
                except subprocess.TimeoutExpired:
                    c.kill()
