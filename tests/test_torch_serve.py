"""The port's one-process serving stack against the JAX package's, over HTTP.

JAX side: ``InferenceEngine(params=..., guided_mode="off")``, ``register_llm``
with round-robin routing, ``ModelWatcher`` and the aiohttp ``HttpFrontend``.
Port side: ``launch_engine_worker`` on the same weights (``device="cpu"``),
its ``ModelWatcher`` and its asyncio ``HttpFrontend``. Both stacks live on
one background event loop for the module; each test sends the same
requests to both and compares the answers: response bodies minus
``id``/``created`` (logprobs within LP_TOL, everything else, text included,
equal), SSE chunk sequences, usage, statuses and JSON error bodies.

Also here: a client that disconnects mid-stream frees its pages, the admin
routes, the routes this slice does not serve, and the CLI in a subprocess.
"""

import asyncio
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import aiohttp
import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.frontend.http import HttpFrontend as JaxHttpFrontend
from dynamo_tpu.frontend.model_card import register_llm as jax_register_llm
from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub

pytestmark = pytest.mark.integration

ROOT = Path(__file__).resolve().parents[1]
MODEL = "tiny"
LP_TOL = 1e-4
# vocab >= 272: the mock tokenizer's byte ids (16..271) are model tokens
SPEC_KW = dict(vocab_size=288, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=256, max_pages_per_seq=64,
              max_decode_slots=4, prefill_buckets=(16, 32, 64, 128))
# embeddings scaled so no greedy token rides on a near-tie and a
# temperature-0.8 draw is not always the argmax (test_torch_engine_modes.py)
EMBED_SCALE = 8.0
TIMEOUT = 120


def _weights(seed=3):
    jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(seed)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    return jp, params_from_numpy(ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp),
                                 device="cpu")


class _Stacks:
    """Both serving stacks on one event loop in a background thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=TIMEOUT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def start(self):
        jp, tp = _weights()
        # JAX: engine with guided decoding off, registered by hand
        self.jeng = JaxEngine(JaxSpec(**SPEC_KW),
                              JaxEngineConfig(**CFG_KW, guided_mode="off"), params=jp)
        self.jdrt = JaxRuntime(JaxHub())
        ep = self.jdrt.namespace("dynamo").component("backend").endpoint("generate")
        await jax_register_llm(self.jdrt, ep, self.jeng.generate, model_name=MODEL,
                               router_mode="round_robin",
                               context_length=self.jeng.config.max_context,
                               kv_block_size=CFG_KW["page_size"])
        await self.jeng.start()
        self.jwatch = await JaxModelWatcher(self.jdrt, JaxModelManager()).start()
        await self.jwatch.wait_for_model(MODEL, timeout=10)
        self.jhttp = JaxHttpFrontend(self.jwatch.manager, host="127.0.0.1", port=0,
                                     drt=self.jdrt)
        await self.jhttp.start()
        # the port: its worker entry point on the same weights
        self.drt = DistributedRuntime(InMemoryHub())
        self.eng, _ = await launch_engine_worker(
            self.drt, model_name=MODEL, spec=ModelSpec(**SPEC_KW),
            engine_config=EngineConfig(**CFG_KW), params=tp, device="cpu")
        self.watch = await ModelWatcher(self.drt, ModelManager()).start()
        await self.watch.wait_for_model(MODEL, timeout=10)
        self.http = HttpFrontend(self.watch.manager, host="127.0.0.1", port=0,
                                 drt=self.drt)
        await self.http.start()
        self.bases = {"jax": f"http://127.0.0.1:{self.jhttp.port}",
                      "port": f"http://127.0.0.1:{self.http.port}"}
        self.session = aiohttp.ClientSession()

    async def stop(self):
        await self.session.close()
        for frontend, watcher, engine, drt in (
                (self.http, self.watch, self.eng, self.drt),
                (self.jhttp, self.jwatch, self.jeng, self.jdrt)):
            await frontend.stop()
            await watcher.close()
            await engine.close()
            await drt.close()

    async def post(self, side, route, body, headers=None, raw=None):
        """(status, parsed body: JSON, SSE chunk list, or text)."""
        kw = {"data": raw} if raw is not None else {"json": body}
        async with self.session.post(self.bases[side] + route, headers=headers,
                                     **kw) as r:
            text = await r.text()
            if r.content_type == "text/event-stream":
                return r.status, _sse_chunks(text)
            if r.content_type == "application/json":
                return r.status, json.loads(text)
            return r.status, text

    async def get(self, side, route):
        async with self.session.get(self.bases[side] + route) as r:
            body = await r.text()
            return r.status, (json.loads(body) if r.content_type == "application/json"
                              else body)


@pytest.fixture(scope="module")
def stacks():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    s = _Stacks()
    s.run(s.start())
    try:
        yield s
    finally:
        s.run(s.stop())
        s.loop.call_soon_threadsafe(s.loop.stop)
        s.thread.join(10)
        s.loop.close()
        torch.set_num_threads(prev)


async def _gather(*coros):
    return await asyncio.gather(*coros)


def _sse_chunks(text: str) -> list:
    assert text.endswith("data: [DONE]\n\n"), text[-200:]
    events = [e for e in text.split("\n\n") if e]
    assert all(e.startswith("data: ") for e in events)
    return [e[len("data: "):] if e == "data: [DONE]" else json.loads(e[len("data: "):])
            for e in events]


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("id", "created")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _assert_same(got, want, path="", lp=False):
    """Equal structures; floats under a logprob key within LP_TOL."""
    lp = lp or "logprob" in path
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}", lp)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]", lp)
    elif isinstance(want, float) and lp:
        assert abs(got - want) <= LP_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _tokens_of(text: str) -> list[int]:
    return MockTokenizer().encode(text)


CHAT = [{"role": "system", "content": "You are terse."},
        {"role": "user", "content": "Name three colours."}]
# (route, port body, JAX body or None = the same)
_PARITY = {
    "chat": ("/v1/chat/completions",
             {"model": MODEL, "messages": CHAT, "max_tokens": 10, "ignore_eos": True},
             None),
    "chat-stream": ("/v1/chat/completions",
                    {"model": MODEL, "messages": CHAT, "max_tokens": 9, "stream": True,
                     "ignore_eos": True, "stream_options": {"include_usage": True}},
                    None),
    "completion-token-prompt": (
        "/v1/completions",
        {"model": MODEL, "prompt": _tokens_of("The quick brown fox"), "max_tokens": 8,
         "ignore_eos": True},
        {"model": MODEL, "prompt": "The quick brown fox", "max_tokens": 8,
         "ignore_eos": True}),
    "seeded-temperature": ("/v1/chat/completions",
                           {"model": MODEL, "messages": CHAT, "max_tokens": 12,
                            "temperature": 0.8, "seed": 1234, "ignore_eos": True},
                           None),
    "completion-logprobs": ("/v1/completions",
                            {"model": MODEL, "prompt": "log me", "max_tokens": 6,
                             "logprobs": 3, "ignore_eos": True},
                            None),
    "chat-logprobs-stream": ("/v1/chat/completions",
                             {"model": MODEL, "messages": CHAT, "max_tokens": 5,
                              "logprobs": True, "top_logprobs": 2, "stream": True,
                              "temperature": 0.8, "seed": 9, "ignore_eos": True},
                             None),
    "stop-string": ("/v1/completions",
                    {"model": MODEL, "prompt": "abc", "max_tokens": 20,
                     "stop": ["e", "a"], "stream": True},
                    None),
}


@pytest.mark.parametrize("case", list(_PARITY))
def test_stack_parity(stacks, case):
    route, body, jax_body = _PARITY[case]
    (ws, want), (gs, got) = stacks.run(_gather(
        stacks.post("jax", route, jax_body or body), stacks.post("port", route, body)))
    assert gs == ws == 200, (got, want)
    _assert_same(_strip(got), _strip(want))
    if isinstance(got, list):  # SSE
        assert got[-1] == "[DONE]"
        finish = [c["choices"][0]["finish_reason"] for c in got[:-1] if c["choices"]]
        assert finish[-1] in ("length", "stop") and all(f is None for f in finish[:-1])
    usage = (got[-2] if isinstance(got, list) else got).get("usage")
    if usage is not None and body.get("ignore_eos"):
        assert usage["completion_tokens"] == body["max_tokens"]


def test_stack_parity_concurrent_completions(stacks):
    """Four completions at once on each stack: equal answers per request."""
    prompts = ["alpha beta", "gamma", "delta epsilon zeta eta", "theta iota"]
    bodies = [{"model": MODEL, "prompt": p, "max_tokens": 7, "ignore_eos": True}
              for p in prompts]

    async def fan(side):
        return await asyncio.gather(*(stacks.post(side, "/v1/completions", b)
                                      for b in bodies))

    want, got = stacks.run(fan("jax")), stacks.run(fan("port"))
    for (gs, g), (ws, w) in zip(got, want):
        assert gs == ws == 200
        _assert_same(_strip(g), _strip(w))
        assert g["usage"]["completion_tokens"] == 7


def test_models_and_health_match(stacks):
    for route in ("/v1/models", "/health", "/live", "/ready"):
        (ws, want), (gs, got) = stacks.run(_gather(
            stacks.get("jax", route), stacks.get("port", route)))
        assert gs == ws == 200 and got == want, route
    assert got["models"] == {MODEL: {"instances": 1}}


_ERRORS = {
    "invalid-json": ("/v1/chat/completions", None, "{not json", None),
    "empty-body": ("/v1/completions", None, "", None),
    "not-an-object": ("/v1/completions", [1, 2], None, None),
    "bad-role": ("/v1/chat/completions",
                 {"model": MODEL, "messages": [{"role": "x"}]}, None, None),
    "bad-content-part": ("/v1/chat/completions",
                         {"model": MODEL, "messages": [{"role": "user",
                                                        "content": [{"t": 1}]}]},
                         None, None),
    "bad-temperature": ("/v1/completions",
                        {"model": MODEL, "prompt": "x", "temperature": [1]}, None, None),
    "no-prompt": ("/v1/completions", {"model": MODEL}, None, None),
    "too-many-stops": ("/v1/chat/completions",
                       {"model": MODEL, "messages": CHAT, "stop": list("abcde")},
                       None, None),
    "missing-model": ("/v1/completions", {"prompt": "x"}, None, None),
    "unknown-model": ("/v1/chat/completions", {"model": "nope", "messages": CHAT},
                      None, None),
    "bad-tenant": ("/v1/completions", {"model": MODEL, "prompt": "x"}, None,
                   {"x-dyn-tenant": "not ok!"}),
    "prompt-over-context": ("/v1/completions",
                            {"model": MODEL, "prompt": "x" * 300}, None, None),
    "guided-json-schema": ("/v1/chat/completions",
                           {"model": MODEL, "messages": CHAT, "max_tokens": 8,
                            "response_format": {
                                "type": "json_schema",
                                "json_schema": {"name": "t", "schema": {
                                    "type": "object",
                                    "properties": {"ok": {"type": "boolean"}},
                                    "required": ["ok"]}}}},
                           None, None),
}


@pytest.mark.parametrize("case", list(_ERRORS))
def test_error_contract_matches(stacks, case):
    route, body, raw, headers = _ERRORS[case]
    (ws, want), (gs, got) = stacks.run(_gather(
        stacks.post("jax", route, body, headers, raw),
        stacks.post("port", route, body, headers, raw)))
    assert (gs, got) == (ws, want)
    assert 400 <= gs < 500 and got["error"]["type"] == "invalid_request_error"


def test_body_over_limit_is_413(stacks):
    """aiohttp refuses a body of 1 MiB or more (its client_max_size); so
    does the port's server (the bodies differ: aiohttp's is not JSON)."""
    big = json.dumps({"model": MODEL, "prompt": "x" * (1024 ** 2)})
    (ws, _), (gs, _) = stacks.run(_gather(
        stacks.post("jax", "/v1/completions", None, raw=big),
        stacks.post("port", "/v1/completions", None, raw=big)))
    assert gs == ws == 413
    # the server keeps serving
    assert stacks.run(stacks.get("port", "/health"))[0] == 200


_CHUNKED_BODY = json.dumps({"model": MODEL, "prompt": "hi", "max_tokens": 2,
                            "ignore_eos": True}).encode()
_CHUNKED = {  # chunked request body -> status
    "two-chunks": (b"%x\r\n%b\r\n%x\r\n%b\r\n0\r\n\r\n" % (
        10, _CHUNKED_BODY[:10], len(_CHUNKED_BODY) - 10, _CHUNKED_BODY[10:]), 200),
    "bad-size": (b"zz\r\n" + _CHUNKED_BODY + b"\r\n0\r\n\r\n", 400),
    "size-line-over-64k": (b"1" * 70_000 + b"\r\n", 400),
}


@pytest.mark.parametrize("case", list(_CHUNKED))
def test_chunked_request_bodies(stacks, case):
    """A chunked request body is read like a Content-Length one; a
    malformed or endless chunk-size line gets 400, and the connection
    closes."""
    body, want = _CHUNKED[case]

    async def send():
        reader, writer = await asyncio.open_connection("127.0.0.1", stacks.http.port)
        writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                     b"Content-Type: application/json\r\nTransfer-Encoding: chunked\r\n\r\n"
                     + body)
        out = await reader.read()
        writer.close()
        return out

    out = stacks.run(send())
    assert out.startswith(b"HTTP/1.1 %d " % want), out[:200]
    if want == 200:
        assert json.loads(out.split(b"\r\n\r\n", 1)[1])["usage"]["completion_tokens"] == 2


def test_unserved_routes_and_methods(stacks):
    for route in ("/v1/responses", "/v1/embeddings", "/nope"):
        assert stacks.run(stacks.post("port", route, {"model": MODEL}))[0] == 404
    assert stacks.run(stacks.get("port", "/debug/timeline"))[0] == 404
    (ws, _), (gs, _) = stacks.run(_gather(
        stacks.get("jax", "/v1/completions"), stacks.get("port", "/v1/completions")))
    assert gs == ws == 405
    status, spec = stacks.run(stacks.get("port", "/openapi.json"))
    assert status == 200 and "/v1/chat/completions" in spec["paths"]
    assert "/v1/responses" not in spec["paths"]
    status, html = stacks.run(stacks.get("port", "/docs"))
    assert status == 200 and "/v1/completions" in html


def _counters(text: str) -> dict:
    """Counter samples and histogram counts of an exposition, by
    (name, labels): the parts two stacks fed the same requests share."""
    from prometheus_client.parser import text_string_to_metric_families

    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith(("_total", "_count")) and s.name.startswith("dynamo_"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def test_metrics_move_like_jax(stacks):
    """The same requests move the same counters on both stacks; TTFT is
    observed once per request that reached the engine."""
    bodies = [("/v1/completions", {"model": MODEL, "prompt": "m1", "max_tokens": 3,
                                   "ignore_eos": True}),
              ("/v1/chat/completions", {"model": MODEL, "messages": CHAT,
                                        "max_tokens": 2, "stream": True,
                                        "ignore_eos": True}),
              ("/v1/completions", {"model": MODEL, "prompt": "x", "top_p": 7})]

    async def scrape(side):
        async with stacks.session.get(stacks.bases[side] + "/metrics") as r:
            assert r.status == 200
            return _counters(await r.text())

    async def drive(side):
        before = await scrape(side)
        for route, body in bodies:
            await stacks.post(side, route, body)
        after = await scrape(side)
        return {k: v - before.get(k, 0.0) for k, v in after.items()
                if v != before.get(k, 0.0)}

    want, got = stacks.run(drive("jax")), stacks.run(drive("port"))
    # the JAX engine counts its first traces per shape on every /metrics
    # surface (a process-global provider); no frontend metric
    want = {k: v for k, v in want.items() if k[0] != "dynamo_fused_fallback_total"}
    assert got == want
    assert got[("dynamo_time_to_first_token_seconds_count", (("model", MODEL),))] == 2
    assert got[("dynamo_output_tokens_total", (("model", MODEL),))] == 5


async def _open_stream(port: int, body: dict):
    """A raw HTTP/1.1 client: send a streamed request, read the head."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n%b"
                 % (len(data), data))
    head = await reader.readuntil(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200") and b"chunked" in head.lower()
    return reader, writer


async def _read_chunk(reader) -> bytes:
    size = int((await reader.readuntil(b"\r\n")).strip(), 16)
    data = await reader.readexactly(size)
    await reader.readexactly(2)
    return data


def test_disconnect_mid_stream_frees_pages(stacks):
    """A client that goes away after two chunks stops its request: the
    engine finishes the slot and frees its pages, and the admin
    cache_status route says so."""

    async def drop():
        reader, writer = await _open_stream(stacks.http.port, {
            "model": MODEL, "prompt": "drop me", "max_tokens": 200,
            "ignore_eos": True, "stream": True})
        chunks = [await _read_chunk(reader) for _ in range(2)]
        assert all(c.startswith(b"data: {") for c in chunks)
        assert stacks.eng.allocator.active_pages > 0
        writer.close()
        t0 = time.monotonic()
        while stacks.eng.allocator.active_pages and time.monotonic() - t0 < 5:
            await asyncio.sleep(0.02)
        return stacks.eng.allocator.active_pages, stacks.eng.steps

    active, steps = stacks.run(drop())
    assert active == 0 and steps < 150
    status = stacks.run(_admin(stacks, {"op": "cache_status"}))
    assert status["ok"] and status["active_pages"] == 0
    assert stacks.run(_admin(stacks, {"op": "drain"})) == {
        "ok": False, "error": "unknown op 'drain'"}


async def _admin(stacks, payload):
    client = await stacks.drt.namespace("dynamo").component("backend").endpoint(
        "admin").client().start()
    try:
        (inst,) = await client.wait_for_instances(1, timeout=2)
        async for item in client.call_instance(inst.instance_id, payload, Context()):
            return item
    finally:
        await client.close()


def test_clear_kv_blocks_route(stacks):
    """POST /clear_kv_blocks reaches the worker's admin endpoint; every
    inactive prefix-cache page is evicted."""
    body = {"model": MODEL, "prompt": "cache these pages please", "max_tokens": 2}
    assert stacks.run(stacks.post("port", "/v1/completions", body))[0] == 200
    assert stacks.eng.allocator.evictable_pages > 0
    status, out = stacks.run(stacks.post("port", "/clear_kv_blocks", {}))
    assert status == 200 and out == {
        "results": {"dynamo/backend": {"workers_cleared": 1}}}
    # the JAX stack here is registered by hand, without an admin endpoint:
    # nothing to clear, the same answer shape
    assert stacks.run(stacks.post("jax", "/clear_kv_blocks", {})) == (200, {"results": {}})
    t0 = time.monotonic()
    while stacks.eng.allocator.evictable_pages and time.monotonic() - t0 < 2:
        time.sleep(0.02)
    assert stacks.eng.allocator.evictable_pages == 0


async def test_request_clear_cache_matches_jax_engine():
    """After a clear, a repeated prompt is prefilled again: no prefix hit,
    as in the reference engine."""
    jp, tp = _weights()
    jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW), params=jp)
    teng = InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW), params=tp,
                           device="cpu")
    prompt = list(range(20, 41))  # 21 tokens: 5 full pages
    req = {"token_ids": prompt, "stop_conditions": {"max_tokens": 3, "ignore_eos": True}}

    async def run(eng, ctx_cls):
        return [t for x in [i async for i in eng.generate(dict(req), ctx_cls())]
                for t in x["token_ids"]]

    async def clear(eng):
        eng.request_clear_cache()
        t0 = time.monotonic()
        while eng.allocator.evictable_pages and time.monotonic() - t0 < 5:
            await asyncio.sleep(0.01)
        assert eng.allocator.evictable_pages == 0

    first = await run(jeng, JaxContext)
    assert await run(jeng, JaxContext) == first
    assert jeng.prefix_hit_tokens(prompt) == 20  # 5 sealed prompt pages
    await clear(jeng)
    assert jeng.prefix_hit_tokens(prompt) == 0
    assert await run(jeng, JaxContext) == first

    assert await run(teng, Context) == first
    assert teng.cached_prompt_tokens == 0
    assert await run(teng, Context) == first
    assert teng.cached_prompt_tokens == 20  # the repeat hit the 5 pages
    await clear(teng)
    assert await run(teng, Context) == first
    assert teng.cached_prompt_tokens == 20  # prefilled again: no hit
    assert (teng.allocator.free_pages, teng.allocator.evictable_pages) == (
        jeng.allocator.free_pages, jeng.allocator.evictable_pages)
    await jeng.close()
    await teng.close()


# ------------------------------------------------------------------ CLI


def _cli(*args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--out", "engine",
         "--model", "tiny-test", "--device", "cpu", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, **kw)


def test_cli_serves_http():
    import urllib.request

    proc = _cli("--in", "http", "--port", "0")
    try:
        addr = None
        t0 = time.monotonic()
        while addr is None and time.monotonic() - t0 < 60:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.match(r"DYNAMO_HTTP=(\S+)", line)
            addr = m.group(1) if m else None
        assert addr, proc.stderr.read() if proc.poll() is not None else "no address"
        req = urllib.request.Request(
            f"http://{addr}/v1/completions", method="POST",
            headers={"Content-Type": "application/json"},
            data=json.dumps({"model": "tiny-test", "prompt": "hi", "max_tokens": 4,
                             "ignore_eos": True}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        assert out["usage"]["completion_tokens"] == 4
        assert out["choices"][0]["finish_reason"] == "length"
    finally:
        proc.terminate()
        proc.wait(10)


def test_cli_batch_and_refusals(tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text('{"prompt": "one", "max_tokens": 3, "ignore_eos": true}\n\n'
                    '{"messages": [{"role": "user", "content": "two"}], "max_tokens": 2,'
                    ' "ignore_eos": true}\n')
    out = tmp_path / "out.jsonl"
    proc = _cli("--in", f"batch:{reqs}", "--output", str(out))
    stdout, stderr = proc.communicate(timeout=60)
    assert proc.returncode == 0, stderr
    assert "BATCH_DONE n=2" in stdout
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["index"] for x in lines] == [0, 1] and all(isinstance(x["text"], str)
                                                         for x in lines)
    from dynamo_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="mocker"):
        cli.main(["run", "--out", "mocker"])
    with pytest.raises(NotImplementedError, match="4b"):
        cli.main(["hub"])


def test_cli_without_gpu_refuses_the_cpu():
    """With no GPU and no --device cpu, `run` raises instead of serving
    from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from dynamo_tpu_torch import cli

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["run", "--in", "http", "--out", "engine", "--port", "0"])
