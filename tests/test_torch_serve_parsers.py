"""Tool calls and reasoning over HTTP: the port's stack against the JAX
package's, each in front of an echo mocker.

The echo mocker replays the rendered prompt as its output, so the tool-call
markup and think blocks of a user message come back verbatim and both
frontends' parsers see the same text. Each stack serves one model card with
the hermes tool-call parser and the basic reasoning parser. SSE chunk
sequences and aggregated bodies compare minus ``id``/``created`` (tool-call
ids are random in both packages), exactly: no number in these bodies comes
from a model.
"""

import asyncio
import json
import threading

import aiohttp
import pytest

from dynamo_tpu.frontend.http import HttpFrontend as JaxHttpFrontend
from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
from dynamo_tpu.mocker.__main__ import launch_mock_worker as jax_launch_mock
from dynamo_tpu.mocker.engine import MockEngineConfig as JaxMockConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
from dynamo_tpu_torch.mocker.engine import MockEngineConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub

pytestmark = pytest.mark.integration

MODEL = "echo-tools"
MOCK = dict(block_size=4, total_kv_blocks=512, speedup_ratio=500.0, echo_prompt=True)
CARD = dict(model_name=MODEL, register_card=True, tool_call_parser="hermes",
            reasoning_parser="basic")
TIMEOUT = 60


class _EchoStacks:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(TIMEOUT)

    async def start(self):
        self.sides = {}
        for side, drt_cls, hub_cls, launch, cfg_cls, mgr_cls, watch_cls, http_cls in (
                ("jax", JaxRuntime, JaxHub, jax_launch_mock, JaxMockConfig,
                 JaxModelManager, JaxModelWatcher, JaxHttpFrontend),
                ("port", DistributedRuntime, InMemoryHub, launch_mock_worker,
                 MockEngineConfig, ModelManager, ModelWatcher, HttpFrontend)):
            drt = drt_cls(hub_cls())
            eng, _ = await launch(drt, "dyn", "backend", "generate", cfg_cls(**MOCK),
                                  **CARD)
            watcher = await watch_cls(drt, mgr_cls()).start()
            await watcher.wait_for_model(MODEL, timeout=10)
            http = http_cls(watcher.manager, host="127.0.0.1", port=0)
            await http.start()
            self.sides[side] = (drt, eng, watcher, http)
        self.session = aiohttp.ClientSession()

    async def stop(self):
        await self.session.close()
        for drt, eng, watcher, http in self.sides.values():
            await http.stop()
            await watcher.close()
            for pub in (eng.events, eng.metrics):
                await pub.close()
            await drt.close()

    async def post(self, side, route, body):
        port = self.sides[side][3].port
        async with self.session.post(f"http://127.0.0.1:{port}{route}", json=body) as r:
            text = await r.text()
            if r.content_type == "text/event-stream" and route == "/v1/responses":
                return r.status, [e for e in text.split("\n\n") if e]
            if r.content_type == "text/event-stream":
                assert text.endswith("data: [DONE]\n\n")
                return r.status, [json.loads(e[len("data: "):])
                                  for e in text.split("\n\n")
                                  if e and e != "data: [DONE]"]
            return r.status, json.loads(text)


@pytest.fixture(scope="module")
def echo():
    s = _EchoStacks()
    s.run(s.start())
    try:
        yield s
    finally:
        s.run(s.stop())
        s.loop.call_soon_threadsafe(s.loop.stop)
        s.thread.join(10)
        s.loop.close()


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in ("id", "created", "created_at", "item_id")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    if isinstance(x, str) and x.startswith("event: "):
        name, data = x.split("\n")
        return name, _strip(json.loads(data[len("data: "):]))
    return x


CALL = '<tool_call>{"name": "get_weather", "arguments": {"city": "SF"}}</tool_call>'
THINK = "<think>The user wants weather.</think>"
TOOLS = [{"type": "function", "function": {"name": "get_weather", "parameters": {}}}]
_CASES = {
    "tools": ("/v1/chat/completions",
              {"messages": [{"role": "user", "content": f"{THINK}Checking. {CALL} ok"}],
               "tools": TOOLS}),
    "two-calls": ("/v1/chat/completions",
                  {"messages": [{"role": "user", "content": CALL + CALL.replace(
                      "SF", "NYC")}], "tools": TOOLS}),
    "tool-choice-none": ("/v1/chat/completions",
                         {"messages": [{"role": "user", "content": CALL}],
                          "tools": TOOLS, "tool_choice": "none"}),
    "no-tools-reasoning": ("/v1/chat/completions",
                           {"messages": [{"role": "user", "content": THINK + CALL}]}),
    "malformed-call": ("/v1/chat/completions",
                       {"messages": [{"role": "user",
                                      "content": "<tool_call>not json</tool_call>"}],
                        "tools": TOOLS}),
    "responses": ("/v1/responses", {"input": f"{THINK}plain answer"}),
}


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", list(_CASES))
def test_parsed_bodies_match(echo, case, stream):
    route, body = _CASES[case]
    body = {"model": MODEL, "stream": stream,
            ("max_output_tokens" if route == "/v1/responses" else "max_tokens"): 400,
            **body}

    async def both():
        return await asyncio.gather(echo.post("jax", route, body),
                                    echo.post("port", route, body))

    (ws, want), (gs, got) = echo.run(both())
    assert gs == ws == 200, (got, want)
    assert _strip(got) == _strip(want)
    if route == "/v1/responses":
        return
    if stream:
        deltas = [c["choices"][0]["delta"] for c in got if c["choices"]]
        calls = [t for d in deltas for t in d.get("tool_calls", ())]
        reasoning = "".join(d.get("reasoning_content", "") for d in deltas)
        finish = [c["choices"][0]["finish_reason"] for c in got if c["choices"]][-1]
    else:
        msg = got["choices"][0]["message"]
        calls, reasoning = msg.get("tool_calls") or [], msg.get("reasoning_content", "")
        finish = got["choices"][0]["finish_reason"]
    n_calls = {"tools": 1, "two-calls": 2}.get(case, 0)
    assert len(calls) == n_calls
    assert finish == ("tool_calls" if n_calls else "stop")
    if n_calls:
        assert json.loads(calls[0]["function"]["arguments"]) == {"city": "SF"}
        assert [c["index"] for c in calls] == list(range(n_calls))
    assert reasoning == ("The user wants weather." if THINK in str(body) else "")
