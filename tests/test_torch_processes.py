"""The port as a deployment of processes on the CPU: ``python -m
dynamo_tpu_torch.cli hub``, two ``cli worker --device cpu --model
tiny-test`` and ``cli frontend``, each a process of its own talking TCP.

- Streamed completions through the frontend equal ``generate()`` of an
  in-process engine on the same seeded weights (text, and each token's
  logprob within LP_TOL), and both workers serve.
- SIGTERM drain: a worker SIGTERM'd mid-stream finishes that stream whole,
  exits 0 after ``ENGINE_DRAINED leftover=0``, its instance key leaves the
  hub, and the next request goes to the survivor.
- SIGKILL mid-stream: the frontend's migration finishes the stream on the
  survivor with the tokens of an uninterrupted run.
- Every child runs with jax, msgpack and the JAX package made unimportable,
  so a child that reached for one would die.
- The kernel build's cross-process lock: two processes that start
  together on a fresh build directory run nvcc (a stub here) for one build.
"""

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
import urllib.request
from pathlib import Path

import aiohttp
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import RemoteHub

pytestmark = pytest.mark.e2e

ROOT = Path(__file__).resolve().parents[1]
MODEL = "tiny-test"
LP_TOL = 1e-4
START_S = 60  # a child's limit to print its ready line
EXIT_S = 30  # a child's limit to exit after SIGTERM
BLOCKED = ("jax", "jaxlib", "dynamo_tpu", "msgpack", "xxhash", "aiohttp",
           "prometheus_client", "ml_dtypes", "yaml", "transformers", "tokenizers",
           "uvloop")
# run the CLI with the blocked packages unimportable
BOOT = ("import runpy, sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        "sys.argv = ['dynamo_tpu_torch.cli', *sys.argv[1:]]\n"
        "runpy.run_module('dynamo_tpu_torch.cli', run_name='__main__')\n")
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
       "DYN_LEASE_TTL_S": "3", "DYN_KEEPALIVE_INTERVAL_S": "1"}


class _Child:
    """One CLI process; its stdout and stderr lines land in a queue."""

    def __init__(self, *args):
        self.args = args
        self.proc = subprocess.Popen(
            [sys.executable, "-c", BOOT, *args], cwd=ROOT, env=ENV,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.seen: list[str] = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))
        self.lines.put(None)

    def wait_line(self, pattern: str, timeout: float = START_S) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=0.2)
            except queue.Empty:
                continue
            if line is None:
                break
            self.seen.append(line)
            if re.search(pattern, line):
                return line
        raise AssertionError(f"{self.args[0]}: no {pattern!r} (exit {self.proc.poll()}); "
                             f"last lines {self.seen[-15:]}")

    def stop(self, sig=signal.SIGTERM, timeout: float = EXIT_S) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
            raise AssertionError(f"{self.args[0]} did not exit within {timeout} s")


class _Deployment:
    def __init__(self):
        self.children: list[_Child] = []
        hub = self.spawn("hub", "--port", "0")
        self.hub = hub.wait_line(r"^DYNAMO_HUB=").split("=", 1)[1]
        self.workers = [self.worker() for _ in range(2)]
        front = self.spawn("frontend", "--hub", self.hub, "--port", "0",
                           "--host", "127.0.0.1")
        self.http = "http://" + front.wait_line(r"^DYNAMO_HTTP=").split("=", 1)[1]
        for w in self.workers:
            w.wait_line(r"^ENGINE_READY$")
        deadline = time.monotonic() + START_S
        while MODEL not in self.models():  # the frontend saw the model card
            assert time.monotonic() < deadline, "the frontend lists no model"
            time.sleep(0.05)

    def models(self) -> list[str]:
        with urllib.request.urlopen(self.http + "/v1/models", timeout=10) as r:
            return [m["id"] for m in json.loads(r.read())["data"]]

    def spawn(self, *args) -> _Child:
        child = _Child(*args)
        self.children.append(child)
        return child

    def worker(self) -> _Child:
        return self.spawn("worker", "--hub", self.hub, "--device", "cpu",
                          "--model", MODEL)

    def close(self):
        for child in reversed(self.children):
            if child.proc.poll() is None:
                child.stop()


@pytest.fixture(scope="module")
def deployment():
    d = _Deployment()
    try:
        yield d
    finally:
        d.close()


async def _runtime(d) -> DistributedRuntime:
    return DistributedRuntime(await RemoteHub.connect(d.hub), RuntimeConfig(hub_address=d.hub))


async def _instances(drt, endpoint="generate") -> dict[int, object]:
    client = await drt.namespace("dynamo").component("backend").endpoint(
        endpoint).client().start()
    await asyncio.sleep(0.2)
    out = {i.instance_id: i for i in client.instances()}
    await client.close()
    return out


async def _admin_all(drt, op="cache_status") -> dict[int, dict]:
    """{instance id: answer} from every worker's admin endpoint."""
    client = await drt.namespace("dynamo").component("backend").endpoint(
        "admin").client().start()
    await asyncio.sleep(0.2)
    out = {}
    for iid in client.instance_ids():
        async for item in client.call_instance(iid, {"op": op}, Context()):
            out[iid] = item
    await client.close()
    return out


def _body(prompt, n):
    return {"model": MODEL, "prompt": prompt, "max_tokens": n, "ignore_eos": True,
            "stream": True, "logprobs": 1}


async def _stream(session, url, body, on_chunk=None):
    """(text, token logprobs, finish reason, saw [DONE]) of one streamed
    completion; ``on_chunk(i)`` is awaited after the i-th chunk."""
    text, lps, finish, done, i = [], [], None, False, 0
    async with session.post(url + "/v1/completions", json=body) as r:
        assert r.status == 200, await r.text()
        async for raw in r.content:
            line = raw.decode().strip()
            if not line:
                continue
            assert line.startswith("data: "), line
            if line == "data: [DONE]":
                done = True
                continue
            choice = json.loads(line[6:])["choices"][0]
            text.append(choice["text"])
            lps += choice["logprobs"]["token_logprobs"]
            finish = choice["finish_reason"] or finish
            i += 1
            if on_chunk is not None:
                await on_chunk(i)
    return "".join(text), lps, finish, done


async def _migrations(session, url) -> tuple[int, int]:
    """The frontend's (migrations, resumed tokens) counters."""
    async with session.get(url + "/metrics") as r:
        text = await r.text()
    return tuple(int(float(re.search(rf"^{name} (\S+)$", text, re.M).group(1)))
                 for name in ("dynamo_migrations_total",
                              "dynamo_migration_resumed_tokens_total"))


async def _direct(prompts, n):
    """The same requests through generate() of an in-process engine built
    as the workers build theirs, on one thread as theirs run
    (OMP_NUM_THREADS=1): another thread count sums in another order, and
    this model's near-flat logits turn that into other greedy tokens."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    eng = InferenceEngine(ModelSpec.preset(MODEL), EngineConfig(pipeline_decode=True),
                          device="cpu")
    tok = MockTokenizer()

    async def one(p):
        items = [x async for x in eng.generate(
            {"token_ids": p, "stop_conditions": {"max_tokens": n, "ignore_eos": True},
             "output_options": {"logprobs": 1}}, Context())]
        toks = [t for x in items for t in x["token_ids"]]
        return (tok.decode(toks), [e["logprob"] for x in items for e in x.get("logprobs") or ()],
                toks)

    try:
        return await asyncio.gather(*(one(p) for p in prompts))
    finally:
        await eng.close()
        torch.set_num_threads(threads)


def _same(got, want):
    (g_text, g_lps), (w_text, w_lps) = got[:2], want[:2]
    assert g_text == w_text
    assert len(g_lps) == len(w_lps) and all(abs(a - b) <= LP_TOL
                                            for a, b in zip(g_lps, w_lps))


PROMPTS = [[20 + i, 40 + 3 * i, 60, 80 + i, 100] for i in range(6)]


async def test_processes_stream_like_generate(deployment):
    d = deployment
    want = await _direct(PROMPTS, 12)
    async with aiohttp.ClientSession() as session:
        got = await asyncio.gather(*(_stream(session, d.http, _body(p, 12))
                                     for p in PROMPTS))
    for (text, lps, finish, done), w in zip(got, want):
        assert finish == "length" and done
        _same((text, lps), w)
    drt = await _runtime(d)
    try:
        status = await _admin_all(drt)
    finally:
        await drt.close()
    assert len(status) == 2
    assert all(s["ok"] and s["cached_pages"] > 0 and s["active_pages"] == 0
               for s in status.values()), status  # both workers served


async def test_worker_processes_answer_the_timeline_op(deployment):
    """Each worker process answers the admin ``timeline`` op from its flight
    recorder: the summary lists the streams it served, and a request id
    from it reads back the full timeline, trace id and events included."""
    d = deployment
    async with aiohttp.ClientSession() as session:
        await asyncio.gather(*(_stream(session, d.http, _body(p, 4)) for p in PROMPTS[:2]))
    drt = await _runtime(d)
    try:
        summaries = await _admin_all(drt, "timeline")
        recent = [t for s in summaries.values() for t in s["recent"]]
        assert len(summaries) == 2 and all(s["ok"] for s in summaries.values())
        assert sum(t["finish_reason"] == "length" for t in recent) >= 2
        rid = recent[-1]["request_id"]
        client = await drt.namespace("dynamo").component("backend").endpoint(
            "admin").client().start()
        await asyncio.sleep(0.2)
        found = []
        for iid in client.instance_ids():
            async for item in client.call_instance(
                    iid, {"op": "timeline", "request_id": rid}, Context()):
                if item.get("found"):
                    found.append(item["timeline"])
        await client.close()
    finally:
        await drt.close()
    (tl,) = found
    assert tl["request_id"] == rid and len(tl["trace_id"]) == 32
    assert [e["name"] for e in tl["events"]] == ["admit", "first_token"]


async def _serving_worker(drt) -> int:
    """The admin instance id of the worker holding active pages."""
    for _ in range(50):
        busy = [iid for iid, s in (await _admin_all(drt)).items() if s["active_pages"]]
        if busy:
            return busy[0]
        await asyncio.sleep(0.02)
    raise AssertionError("no worker holds the stream")


def _worker_by_admin(d, admin_iid) -> _Child:
    """The worker process behind an admin instance: instance ids carry the
    process's lease in their high bits (_tag_leases)."""
    lease = admin_iid >> 16
    for w in d.workers:
        if w.proc.poll() is None and getattr(w, "lease", None) == lease:
            return w
    raise AssertionError(f"no live worker with lease {lease}")


def _tag_leases(d):
    """Tag each worker process with its lease, from its log line naming its
    generate instance."""
    for w in d.workers:
        if not hasattr(w, "lease"):
            line = next((ln for ln in w.seen if "engine worker" in ln), None)
            if line is None:
                line = w.wait_line(r"engine worker [0-9a-f]+ up", 5)
            w.lease = int(re.search(r"engine worker ([0-9a-f]+) up", line).group(1), 16) >> 16


async def test_sigterm_drain_finishes_the_stream(deployment):
    d = deployment
    drt = await _runtime(d)
    n = 64
    prompt = [33, 44, 55, 66, 77, 88]
    (want,) = await _direct([prompt], n)
    try:
        _tag_leases(d)
        victim = {}

        async def on_chunk(i):
            if i == 5:
                admin = await _serving_worker(drt)
                victim["w"] = _worker_by_admin(d, admin)
                victim["w"].proc.send_signal(signal.SIGTERM)

        async with aiohttp.ClientSession() as session:
            migrations = await _migrations(session, d.http)
            text, lps, finish, done = await _stream(session, d.http, _body(prompt, n),
                                                    on_chunk)
            assert finish == "length" and done and len(lps) == n
            _same((text, lps), want)
            # the draining worker finished it: no migration
            assert (await _migrations(session, d.http))[0] == migrations[0]
            w = victim["w"]
            assert w.stop(timeout=EXIT_S) == 0
            w.wait_line(r"^ENGINE_DRAINED leftover=0$", 5)
            line = next(ln for ln in w.seen if ln.startswith("ENGINE_LAUNCHES "))
            launches = json.loads(line.split(" ", 1)[1])
            assert launches["steps"] > 0  # the CPU engine launches no kernel
            assert all(v == 0 for v in launches["launches"].values())
            left = await _instances(drt)
            assert len(left) == 1 and all(i.instance_id >> 16 != w.lease
                                          for i in left.values())
            # the survivor serves the next request
            text, lps, finish, done = await _stream(session, d.http,
                                                    _body(PROMPTS[0], 12))
            assert finish == "length" and done
            _same((text, lps), (await _direct([PROMPTS[0]], 12))[0])
    finally:
        await drt.close()


async def test_sigkill_mid_stream_migrates_to_the_survivor(deployment):
    """A worker SIGKILL'd mid-stream: the frontend's migration re-drives the
    request on the survivor with the prompt plus the k tokens already
    streamed. The stream holds the uninterrupted run's first k tokens, then
    the tokens of that resumed request through generate(): the re-prefill
    may flip a near-tie of this near-flat random model, so the resumed
    request, not an undisturbed decode, is what the tail is held to."""
    d = deployment
    d.workers.append(d.worker())  # back to two workers
    d.workers[-1].wait_line(r"^ENGINE_READY$")
    drt = await _runtime(d)
    n = 64
    prompt = [91, 92, 93, 94]
    (want,) = await _direct([prompt], n)
    try:
        _tag_leases(d)
        for _ in range(100):
            if len(await _instances(drt)) == 2:
                break
        killed = {}

        async def on_chunk(i):
            if i == 5:
                admin = await _serving_worker(drt)
                killed["w"] = _worker_by_admin(d, admin)
                killed["w"].proc.kill()

        async with aiohttp.ClientSession() as session:
            before = await _migrations(session, d.http)
            text, lps, finish, done = await _stream(session, d.http, _body(prompt, n),
                                                    on_chunk)
            after = await _migrations(session, d.http)
        assert killed["w"].proc.wait(10) == -signal.SIGKILL
        assert finish == "length" and done and len(lps) == n
        assert after[0] == before[0] + 1
        k = after[1] - before[1]  # tokens streamed before the kill
        assert 5 <= k < n
        _same(("", lps[:k]), ("", want[1][:k]))
        (_, rest_lps, rest) = (await _direct([prompt + want[2][:k]], n - k))[0]
        _same((text, lps), (MockTokenizer().decode(want[2][:k] + rest),
                            want[1][:k] + rest_lps))
    finally:
        await drt.close()


_REFUSED_FLAGS = {
    # ported since (disaggregation): these build their config
    "mode-prefill": (["--mode", "prefill"], None),
    "mode-decode": (["--mode", "decode"], None),
    # ported since (KVBM): builds its config
    "kvbm": (["--kvbm-host-mb", "64"], None),
    "prefill-component": (["--prefill-component", "p2"], None),
    "always-remote-prefill": (["--always-remote-prefill"], None),
    # ported since (tensor parallelism, item 11a; expert parallelism, item
    # 11b; sequence parallelism, item 11d): these build their config
    "tp": (["--tp", "2"], None),
    "sp": (["--sp", "2"], None),
    "ep": (["--ep", "2"], None),
    "mirror": (["--mirror", "leader"], None),
    "coordinator": (["--coordinator-address", "h:1"], None),
    # ported since (speculative decoding, overload, checkpoint loading):
    # these build their config
    "model-path": (["--model-path", "/ckpt"], None),
    "spec": (["--spec", "ngram"], None),
    "spec-k-max": (["--spec-k-max", "4"], None),
    "tenant-quotas": (["--tenant-quotas", "a:weight=2"], None),
    "max-waiting": (["--max-waiting", "8"], None),
    "no-preemption": (["--no-preemption"], None),
    # multimodal: the flags go on the model card
    "mm-tokens": (["--mm-tokens-per-image", "4"], None),
    # --router-mode kv is ported (the default), and since disaggregation
    # the prefill router's mode too
    "prefill-router-mode": (["--prefill-router-mode", "round_robin"], None),
}


@pytest.mark.parametrize("case", list(_REFUSED_FLAGS))
def test_worker_flags_of_unported_features_raise(case):
    """The JAX worker's flags for features the port lacks raise
    NotImplementedError naming their ROADMAP item, before any set-up. The
    flags of a feature ported since build the worker's engine config."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.engine.worker import (
        _engine_config,
        _kvbm_config_from_args,
        parse_args,
    )

    flags, item = _REFUSED_FLAGS[case]
    if item is None:
        args = parse_args(["--device", "cpu", *flags])
        kvbm = _kvbm_config_from_args(args)
        assert (kvbm.host_bytes if kvbm else 0) == (
            64 << 20 if "--kvbm-host-mb" in flags else 0)
        cfg = _engine_config(args)
        assert cfg.spec_mode == ("ngram" if "--spec" in flags else "off")
        assert cfg.spec_k_max == (4 if "--spec-k-max" in flags else 8)
        assert {t: q.weight for t, q in cfg.tenants.items()} == (
            {"a": 2.0} if "--tenant-quotas" in flags else {})
        assert cfg.max_waiting == (8 if "--max-waiting" in flags else 0)
        assert cfg.preemption is ("--no-preemption" not in flags)
        assert args.mode == (flags[1] if flags[0] == "--mode" else "aggregated")
        assert args.prefill_component == ("p2" if "--prefill-component" in flags
                                          else "prefill")
        assert args.prefill_router_mode == ("round_robin" if "--prefill-router-mode"
                                            in flags else "kv")
        assert args.always_remote_prefill is ("--always-remote-prefill" in flags)
        assert cfg.tp == (2 if "--tp" in flags else 1)
        assert cfg.ep == (2 if "--ep" in flags else 1)
        assert cfg.sp == (2 if "--sp" in flags else 1)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue A {item}"):
        cli.main(["worker", "--hub", "127.0.0.1:1", "--device", "cpu", *flags])


async def test_disagg_processes_stream_like_an_aggregated_worker():
    """cli hub, a ``--mode prefill`` worker, a ``--mode decode
    --always-remote-prefill`` worker and cli frontend, each a process: a
    streamed completion equals generate() of an aggregated in-process
    engine; the decode worker pulled the prompt's KV from the other process
    over TCP with no fallback (its admin cache_status), and the prefill
    worker ran no decode step (its ENGINE_LAUNCHES at SIGTERM)."""
    children = []
    try:
        hub = _Child("hub", "--port", "0")
        children.append(hub)
        addr = hub.wait_line(r"^DYNAMO_HUB=").split("=", 1)[1]
        common = ("worker", "--hub", addr, "--device", "cpu", "--model", MODEL)
        pre = _Child(*common, "--mode", "prefill")
        children.append(pre)
        pre.wait_line(r"^ENGINE_READY$")
        dec = _Child(*common, "--mode", "decode", "--always-remote-prefill")
        children.append(dec)
        front = _Child("frontend", "--hub", addr, "--port", "0", "--host", "127.0.0.1")
        children.append(front)
        http = "http://" + front.wait_line(r"^DYNAMO_HTTP=").split("=", 1)[1]
        dec.wait_line(r"^ENGINE_READY$")
        deadline = time.monotonic() + START_S
        while True:
            with urllib.request.urlopen(http + "/v1/models", timeout=10) as r:
                if MODEL in [m["id"] for m in json.loads(r.read())["data"]]:
                    break
            assert time.monotonic() < deadline, "the frontend lists no model"
            time.sleep(0.05)
        prompt = PROMPTS[0] * 4  # 20 tokens
        want = await _direct([prompt], 12)
        async with aiohttp.ClientSession() as session:
            text, lps, finish, done = await _stream(session, http, _body(prompt, 12))
        assert finish == "length" and done
        _same((text, lps), want[0])
        drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))
        try:
            (status,) = (await _admin_all(drt)).values()
        finally:
            await drt.close()
        disagg = status["disagg"]
        assert disagg["pulls"] == {"local": 0, "device": 0, "tcp": 1}, disagg
        assert disagg["fallbacks"] == 0 and disagg["route_fallbacks"] == 0
        assert pre.stop() == 0
        launches = json.loads(pre.wait_line(r"^ENGINE_LAUNCHES ", EXIT_S).split(" ", 1)[1])
        assert launches["steps"] == 0
    finally:
        for child in reversed(children):
            if child.proc.poll() is None:
                child.stop()


def test_service_refusals_and_the_cpu_default():
    """cli frontend --grpc-port is ported (item 14b: it parses, and no
    refusal names the item); cli bench|profile are ported (item 14d: --help
    exits 0, and no refusal names the item); cli hub --data-dir and cli
    hub-replica are ported (a bad flag is argparse's error, not a refusal);
    without a GPU and without --device cpu, cli worker raises instead of
    running on the CPU."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.frontend import __main__ as frontend_main

    assert frontend_main.parse_args(["--grpc-port", "0"]).grpc_port == 0
    assert not {"item 14b", "item 14d"} & set(cli.REFUSED_COMMANDS.values())
    for cmd in ("bench", "profile"):
        assert cmd in cli.SUBCOMMAND_MODULES and cmd not in cli.REFUSED_COMMANDS
        with pytest.raises(SystemExit) as done:
            cli.main([cmd, "--help"])
        assert done.value.code == 0
    assert "hub-replica" in cli.SUBCOMMAND_MODULES
    assert "hub-replica" not in cli.REFUSED_COMMANDS
    for argv in (["hub", "--data-dir"], ["hub-replica", "--peers", "a:1"]):
        with pytest.raises(SystemExit):  # a flag without its value / no --data-dir
            cli.main(argv)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["worker", "--hub", "127.0.0.1:1"])


def test_build_lock_builds_once_across_processes(tmp_path):
    """Two processes that load the kernels at once on a fresh build
    directory: one links the library, the other waits on the lock and
    finds it fresh. nvcc is a stub that logs its runs."""
    (tmp_path / "csrc").mkdir()
    for name in ("a.cu", "b.cu"):
        (tmp_path / "csrc" / name).write_text("// source\n")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "sleep 0.5\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && touch \"$2\"; shift; done\n")
    nvcc.chmod(0o755)
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from dynamo_tpu_torch.ops.cuda import build\n"
        "tmp = Path(sys.argv[1])\n"
        "build.CSRC = tmp / 'csrc'\n"
        "build.BUILD_DIR = tmp / 'build'\n"
        "build.LIB_PATH = build.BUILD_DIR / 'libkernels.so'\n"
        "print(build.ensure_built())\n")
    env = {**ENV, "CUDA_HOME": str(tmp_path / "cuda")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    runs = log.read_text().splitlines()
    assert sum("-shared" in r for r in runs) == 1, runs  # one link
    assert sum(" -c " in f" {r} " for r in runs) == 2, runs  # one compile per source
    assert (tmp_path / "build" / "libkernels.so").exists()


async def _admin_op(hub: str, payload: dict) -> dict:
    drt = DistributedRuntime(await RemoteHub.connect(hub), RuntimeConfig(hub_address=hub))
    try:
        client = await drt.namespace("dynamo").component("backend").endpoint(
            "admin").client().start()
        (inst,) = await client.wait_for_instances(1, timeout=10)
        async for item in client.call_instance(inst.instance_id, payload, Context()):
            await client.close()
            return item
    finally:
        await drt.close()


async def _faults_op(hub: str, spec: str | None) -> dict:
    return await _admin_op(
        hub, {"op": "faults"} if spec is None else {"op": "faults", "spec": spec})


def _status(port: int, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_worker_health_server_parsers_and_faults_op():
    """A worker with --health-port, --health-interval, the hermes and
    deepseek_r1 parsers: its status server answers /ready 200 once a clean
    canary has run; the admin faults op arms health.canary:corrupt scoped
    to this worker, which quarantines it (/ready 503, reason="sdc" on its
    /metrics); clearing the spec readmits it. Its /metrics carries the
    dynamo_engine_* series of the canaries' work and its admin answers the
    timeline op. `cli mocker` serves a fleet of mock workers on the same
    hub."""
    children = []
    try:
        hub = _Child("hub", "--port", "0")
        children.append(hub)
        addr = hub.wait_line(r"^DYNAMO_HUB=").split("=", 1)[1]
        worker = _Child("worker", "--hub", addr, "--device", "cpu", "--model", MODEL,
                        "--health-port", "0", "--health-interval", "0.2",
                        "--tool-call-parser", "hermes", "--reasoning-parser",
                        "deepseek_r1")
        children.append(worker)
        port = int(worker.wait_line(r"^SYSTEM_STATUS_PORT=").split("=", 1)[1])
        worker.wait_line(r"^ENGINE_READY$")

        def until(path, status, body=None, timeout=20.0):
            deadline = time.monotonic() + timeout
            while True:
                got = _status(port, path)
                if got[0] == status and (body is None or body in got[1]):
                    return got
                assert time.monotonic() < deadline, (path, got)
                time.sleep(0.1)

        assert until("/live", 200)[1] == '{"status": "live"}'
        until("/ready", 200)
        health = json.loads(_status(port, "/health")[1])
        assert health["endpoints"][0]["path"] == "dynamo/backend/generate"
        card = asyncio.run(_instances_cards(addr))
        assert card["tool_call_parser"] == "hermes"
        assert card["reasoning_parser"] == "deepseek_r1"
        snap = asyncio.run(_faults_op(addr, "health.canary:corrupt~*"))
        assert snap["ok"] and snap["rules"] == ["health.canary:corrupt~*"]
        until("/ready", 503)
        until("/metrics", 200, 'dynamo_worker_quarantines_total{reason="sdc"} 1')
        bad = asyncio.run(_faults_op(addr, "x:explode"))
        assert bad["ok"] is False and "explode" in bad["error"]
        assert asyncio.run(_faults_op(addr, ""))["rules"] == []
        until("/ready", 200)
        # the worker telemetry on the status server's /metrics: the canaries'
        # work cycles and device programs, sampled every second
        text = until("/metrics", 200, "dynamo_engine_dispatches_total")[1]
        for name in ("dynamo_engine_step_seconds_count", "dynamo_engine_dispatches_total"):
            assert float(re.search(rf'^{name}{{engine="\d+"}} (\S+)$', text,
                                   re.M).group(1)) > 0, name
        assert "dynamo_engine_pages{" in text and "dynamo_engine_burst_tokens" in text
        # the admin timeline op: the canaries are this worker's requests
        tl = asyncio.run(_admin_op(addr, {"op": "timeline", "n": 4}))
        assert tl["ok"] and tl["recent"] and all(
            t["finish_reason"] == "length" for t in tl["recent"])
        mocker = _Child("mocker", "--hub", addr, "--num-workers", "2",
                        "--model-name", "mock", "--speedup-ratio", "100")
        children.append(mocker)
        mocker.wait_line(r"^MOCKERS_READY 2$")
    finally:
        for child in reversed(children):
            child.stop()


async def _instances_cards(hub: str) -> dict:
    """The worker's model card, as the hub holds it."""
    drt = DistributedRuntime(await RemoteHub.connect(hub), RuntimeConfig(hub_address=hub))
    try:
        cards = await drt.hub.get_prefix("v1/mdc/")
        (card,) = cards.values()
        return card
    finally:
        await drt.close()
