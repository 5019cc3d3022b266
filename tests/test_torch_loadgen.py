"""The port's load generator (dynamo_tpu_torch/profiling/loadgen.py, ``cli
bench``) held against the reference's benchmarks/loadgen.py on the CPU:

- ``make_prompt``, ``arrival_times`` and ``pct_ms``: equal outputs for the
  same arguments and seed;
- ``run_load`` and ``run_open_loop``, the port's and the reference's
  (aiohttp) against one port mocker frontend: no errors, the same request
  count, equal sorted per-request output tokens, equal summary key trees;
- the port's streaming client stamps each SSE event when it arrives
  (chunked and close-delimited bodies), the reference's error strings for
  a 500 and a refused connection, and an open loop with no connection cap
  (120 requests in flight at once, past aiohttp's default cap of 100);
- ``cli bench`` end to end in subprocesses against ``cli run --out
  mocker``: the reference's JSON lines.
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmarks import loadgen as jload
from dynamo_tpu_torch.profiling import loadgen

pytestmark = pytest.mark.integration

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


async def _stack():
    """Two port mock workers (speedup 1000) behind the port's frontend. The
    workers echo the prompt: its ASCII bytes stream one visible character
    per token, so every request counts exactly its max_tokens (a random
    mock token may detokenize to no text, which neither client counts)."""
    from dynamo_tpu_torch.frontend.http import HttpFrontend
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
    from dynamo_tpu_torch.mocker.engine import MockEngineConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    drt = DistributedRuntime(InMemoryHub())
    cfg = MockEngineConfig(block_size=4, total_kv_blocks=4096, speedup_ratio=1000.0,
                           echo_prompt=True)
    for _ in range(2):
        await launch_mock_worker(drt, "dyn", "backend", "generate", cfg,
                                 model_name="bench-model", register_card=True)
    manager = ModelManager()
    watcher = await ModelWatcher(drt, manager).start()
    await watcher.wait_for_model("bench-model", timeout=5)
    frontend = HttpFrontend(manager, host="127.0.0.1", port=0)
    await frontend.start()

    async def close():
        await frontend.stop()
        await watcher.close()
        await drt.close()

    return f"http://127.0.0.1:{frontend.port}", close


def _keys(tree):
    return {k: _keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None


@pytest.mark.parametrize("isl,index,shared,seed", [
    (0, 0, 0.0, 0), (5, 3, 0.0, 0), (12, 1, 0.0, 1), (13, 2, 0.5, 2),
    (64, 0, 0.0, 0), (64, 7, 0.25, 3), (200, 1, 0.5, 3), (200, 2, 0.5, 3),
    (256, 10**6 + 1, 0.0, 0), (333, 42, 1.0, 9), (1024, 5, 0.8, 11),
])
def test_make_prompt_equals_the_reference(isl, index, shared, seed):
    assert loadgen.make_prompt(isl, index, shared, seed) == jload.make_prompt(
        isl, index, shared, seed)


def _args(arrival, **kw):
    base = dict(arrival=arrival, rate=6.0, duration=4.0, sin_amp=5.0, sin_period=1.5,
                isl=48, osl=4, seed=3, trace=None)
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("arrival", ["poisson", "sin", "trace"])
def test_arrival_times_equal_the_reference(arrival, tmp_path):
    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(
        json.dumps({"ts": 100.0 + 0.37 * ((i * 7) % 11), "isl": 16 + i, **(
            {"osl": 3} if i % 2 else {})}) + "\n" for i in range(9)) + "\n")
    args = _args(arrival, trace=str(trace))
    got = loadgen.arrival_times(args)
    assert got and got == jload.arrival_times(args)


def test_pct_ms_is_the_reference_one():
    import numpy as np

    from dynamo_tpu_torch.sim.replay import pct_ms

    assert loadgen.pct_ms is pct_ms
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100, 1001):
        xs = rng.exponential(0.05, n).tolist()
        for p in (0.0, 0.5, 0.9, 0.99, 1.0):
            for nd in (1, 3):
                assert pct_ms(xs, p, nd) == jload.pct_ms(xs, p, nd)


async def test_run_load_equals_the_reference():
    url, close = await _stack()
    try:
        kw = dict(concurrency=4, num_requests=12, isl=64, osl=8, warmup=1, seed=2)
        got = await loadgen.run_load(url, "bench-model", **kw)
        want = await jload.run_load(url, "bench-model", **kw)
    finally:
        await close()
    gs, ws = got.summary(), want.summary()
    assert gs["errors"] == ws["errors"] == 0 and gs["requests"] == ws["requests"] == 12
    assert sorted(r.output_tokens for r in got.results) == sorted(
        r.output_tokens for r in want.results) == [8] * 12
    assert _keys(gs) == _keys(ws)
    assert all(len(r.itl_s) == 7 and r.ttft_s < r.duration_s for r in got.results)


async def test_run_open_loop_equals_the_reference():
    sched = loadgen.arrival_times(_args("sin", rate=20.0, duration=1.0, sin_amp=10.0,
                                        sin_period=1.0, osl=5, seed=0))
    url, close = await _stack()
    try:
        got = await loadgen.run_open_loop(url, "bench-model", sched, warmup=1)
        want = await jload.run_open_loop(url, "bench-model", sched, warmup=1)
    finally:
        await close()
    gs, ws = got.summary(), want.summary()
    assert gs["errors"] == ws["errors"] == 0
    assert gs["requests"] == ws["requests"] == len(sched) > 5
    assert sorted(r.output_tokens for r in got.results) == sorted(
        r.output_tokens for r in want.results)
    assert _keys(gs) == _keys(ws) and gs["concurrency"] == ws["concurrency"] == 0


class _Stub:
    """An asyncio HTTP server that answers every request with
    ``respond(stub, writer)`` (False: close the connection after it),
    counting the requests in flight."""

    def __init__(self, respond):
        self.respond = respond
        self.active = self.most = 0

    async def _handle(self, reader, writer):
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                n = int(next((ln.split(b":")[1] for ln in head.split(b"\r\n")
                              if ln.lower().startswith(b"content-length")), b"0"))
                await reader.readexactly(n)
                self.active += 1
                self.most = max(self.most, self.active)
                try:
                    if not await self.respond(self, writer):
                        break
                finally:
                    self.active -= 1
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def __aenter__(self):
        self.server = await asyncio.start_server(self._handle, "127.0.0.1", 0, backlog=512)
        self.url = f"http://127.0.0.1:{self.server.sockets[0].getsockname()[1]}"
        return self

    async def __aexit__(self, *exc):
        self.server.close()


def _event(text: str) -> bytes:
    return b"data: " + json.dumps({"choices": [{"delta": {"content": text}}]}).encode() + b"\n\n"


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "close-delimited"])
async def test_stream_stamps_each_event_on_arrival(chunked):
    """One event, 0.3 s of silence, a second event: TTFT is the first
    event's arrival, not the end of the body."""

    async def respond(stub, writer):
        def send(data: bytes):
            writer.write(b"%x\r\n%b\r\n" % (len(data), data) if chunked else data)

        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     + (b"Transfer-Encoding: chunked\r\n" if chunked else
                        b"Connection: close\r\n") + b"\r\n")
        send(_event("a"))
        await writer.drain()
        await asyncio.sleep(0.3)
        send(_event("b") + b"data: [DONE]\n\n")
        if chunked:
            writer.write(b"0\r\n\r\n")
        await writer.drain()
        return chunked

    async with _Stub(respond) as stub:
        async with loadgen._session(stub.url) as sess:
            r = await loadgen.run_one(sess, stub.url, "m", "hi", 2)
            again = await loadgen.run_one(sess, stub.url, "m", "hi", 2)
            pooled = len(sess._all)
    assert r.ok and r.output_tokens == 2 and again.ok, (r, again)
    assert r.ttft_s < 0.2 and len(r.itl_s) == 1 and r.itl_s[0] >= 0.25, r
    assert pooled == (1 if chunked else 0)  # a chunked body leaves its connection reusable


async def test_error_strings_are_the_references():
    async def fail(stub, writer):
        writer.write(b"HTTP/1.1 500 Internal Server Error\r\nContent-Length: 4\r\n\r\noops")
        await writer.drain()
        return True

    async def garbage(stub, writer):
        writer.write(b"HELLO\r\n\r\n")
        await writer.drain()
        return False

    async def both(url):
        async with loadgen._session(url) as sess:
            got = await loadgen.run_one(sess, url, "m", "hi", 2)
        import aiohttp

        async with aiohttp.ClientSession() as sess:
            want = await jload.run_one(sess, url, "m", "hi", 2)
        return got, want

    async with _Stub(fail) as stub:
        got, want = await both(stub.url)
    assert got.error == want.error == "http 500" and not got.ok and not want.ok
    async with _Stub(garbage) as stub:
        got, want = await both(stub.url)
    assert got.error.startswith("ConnectionError: malformed HTTP status line")
    assert want.error and not got.ok and not want.ok
    closed = _Stub(fail)
    async with closed:
        url = closed.url
    await asyncio.sleep(0.05)
    got, want = await both(url)
    port = int(url.rsplit(":", 1)[1])
    refused = f"Connect call failed ('127.0.0.1', {port})"
    # the reference's aiohttp wraps the same OSError in ClientConnectorError
    assert got.error.startswith("ConnectionRefusedError: ") and refused in got.error
    assert want.error.startswith("ClientConnectorError: ") and refused in want.error
    assert issubclass(ConnectionRefusedError, OSError)


@pytest.mark.parametrize("mod", [loadgen, jload], ids=["port", "reference"])
async def test_open_loop_has_no_connection_cap(mod):
    """120 requests due at t = 0 against a stream that answers only once
    all 120 are in flight (or after 5 s): every one is in flight at once."""
    n = 120
    everyone = asyncio.Event()

    async def slow(stub, writer):
        if stub.active >= n:
            everyone.set()
        try:
            await asyncio.wait_for(everyone.wait(), 5.0)
        except TimeoutError:
            pass
        body = _event("x") + b"data: [DONE]\n\n"
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%b" % (len(body), body))
        await writer.drain()
        return True

    async with _Stub(slow) as stub:
        res = await mod.run_open_loop(stub.url, "m", [(0.0, 16, 1)] * n, warmup=0)
    s = res.summary()
    assert stub.most == n and s["requests"] == n and s["errors"] == 0, (stub.most, s)


def _cli(*args, **kw):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def mocker_server():
    """``cli run --in http --out mocker --port 0``: (process, url)."""
    proc = _cli("dynamo_tpu_torch.cli", "run", "--in", "http", "--out", "mocker",
                "--port", "0", "--speedup-ratio", "100")
    for line in proc.stdout:
        if line.startswith("DYNAMO_HTTP="):
            return proc, "http://" + line.strip().split("=", 1)[1]
    proc.kill()
    raise AssertionError(proc.stderr.read())


def _json_lines(proc, timeout=60):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_cli_bench_prints_the_references_lines():
    server, url = mocker_server()
    try:
        common = ["--url", url, "--model", "mock-model", "--isl", "48", "--osl", "4"]
        closed = ["--concurrency", "1,3", "--num-requests", "6", "--warmup", "1"]
        opened = ["--arrival", "poisson", "--rate", "20", "--duration", "0.5", "--seed", "1"]
        got = _json_lines(_cli("dynamo_tpu_torch.cli", "bench", *common, *closed))
        want = _json_lines(_cli("benchmarks.loadgen", *common, *closed))
        got_open = _json_lines(_cli("dynamo_tpu_torch.cli", "bench", *common, *opened))
        want_open = _json_lines(_cli("benchmarks.loadgen", *common, *opened))
    finally:
        server.terminate()
        server.communicate(timeout=30)  # reaps it and closes its pipes
    assert [g["concurrency"] for g in got] == [w["concurrency"] for w in want] == [1, 3]
    for g, w in zip(got + got_open, want + want_open):
        assert _keys(g) == _keys(w) and g["errors"] == w["errors"] == 0
        assert g["requests"] == w["requests"]
    n = len(loadgen.arrival_times(_args("poisson", rate=20.0, duration=0.5, seed=1)))
    assert got_open[0]["requests"] == n and got_open[0]["offered_rps"] == want_open[0][
        "offered_rps"]
