"""Serving real text: both packages' stacks on one checkpoint directory that
holds tokenizer files (the llama-3 component set of
tests/test_torch_tokenizer.py, with a tool-aware llama-3 chat template).

- In process: the reference's aiohttp stack (its engine with the guided
  vocabulary its worker builds from that tokenizer, registered with the
  directory as the card's tokenizer) and the port's stack
  (``launch_engine_worker(tokenizer=DIR)``) on shared tiny weights answer
  plain, tool and ``json_object`` chats with equal bodies and streams, and
  ``usage.prompt_tokens`` is the tokenizer's count of the rendered prompt.
- Over the shared TCP wire: a port frontend serves a JAX worker whose card
  names the tokenizer directory, and a JAX frontend serves a port worker;
  both answer as the in-process stacks do.
- A checkpoint directory (``save_params`` + the tokenizer files) serves
  through ``launch_engine_worker(model_path=DIR)`` with the card naming
  the directory and the guided vocabulary built from its tokenizer.
"""

import asyncio
import json
import threading

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
from dynamo_tpu.frontend.tokenizer import HFTokenizer as JaxHFTokenizer
from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
from dynamo_tpu.guided import TokenVocab as JaxTokenVocab
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu.runtime.hub_server import HubServer as JaxHubServer
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.tokenizer import HFTokenizer
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.models import llama, loader
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer
from test_torch_serve import _assert_same, _sse_chunks, _strip
from test_torch_tokenizer import build_tokenizer_dir

pytestmark = pytest.mark.integration

MODEL = "tiny-text"
TIMEOUT = 120
# the tokenizer's ids (trained vocab + llama-3 specials) fit the logits
SPEC_KW = dict(vocab_size=1024, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=256, max_pages_per_seq=64,
              max_decode_slots=4, prefill_buckets=(16, 32, 64, 128))
EMBED_SCALE = 8.0
# llama-3's template with a tools header (llama-3.1 renders tools this way)
TEMPLATE = (
    "{{ bos_token }}{% if tools %}<|start_header_id|>system<|end_header_id|>\n\n"
    "You may call:{% for t in tools %}\n{{ t | tojson(indent=2) }}{% endfor %}"
    "<|eot_id|>{% endif %}{% for message in messages %}"
    "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n' + "
    "message['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
CHAT = [{"role": "system", "content": "You are terse."},
        {"role": "user", "content": "Name three colours, and say 机器学习 in English."}]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather for a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]
BODIES = {
    "chat": {"model": MODEL, "messages": CHAT, "max_tokens": 12, "ignore_eos": True},
    "chat-stream": {"model": MODEL, "messages": CHAT, "max_tokens": 10, "stream": True,
                    "ignore_eos": True, "stream_options": {"include_usage": True}},
    "tools": {"model": MODEL, "messages": CHAT[1:], "tools": TOOLS, "max_tokens": 10,
              "ignore_eos": True},
    "json-object": {"model": MODEL, "messages": CHAT[1:], "max_tokens": 12,
                    "response_format": {"type": "json_object"}},
}


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "llama3-text"
    build_tokenizer_dir("llama3", path)
    cfg = json.loads((path / "tokenizer_config.json").read_text())
    cfg["chat_template"] = TEMPLATE
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(path)


def _weights(seed=3):
    jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(seed)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    return jp, params_from_numpy(ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp),
                                 device="cpu")


async def _jax_worker(drt, jp, tok_dir, component="backend"):
    """The reference's engine registered as its worker would: the guided
    vocabulary from the card's tokenizer, the directory on the card."""
    eng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW), params=jp,
                    guided_vocab=JaxTokenVocab.from_tokenizer(
                        JaxHFTokenizer(tok_dir), SPEC_KW["vocab_size"]))
    await jax_register_llm(
        drt, drt.namespace("dynamo").component(component).endpoint("generate"),
        eng.generate, model_name=MODEL, tokenizer=tok_dir, router_mode="round_robin",
        tool_call_parser="hermes", context_length=eng.config.max_context,
        kv_block_size=CFG_KW["page_size"])
    await eng.start()
    return eng


async def _port_worker(drt, tp, tok_dir):
    eng, _ = await launch_engine_worker(
        drt, model_name=MODEL, spec=ModelSpec(**SPEC_KW), tokenizer=tok_dir,
        engine_config=EngineConfig(**CFG_KW), params=tp, device="cpu",
        router_mode="round_robin", tool_call_parser="hermes")
    return eng


async def _front(cls_watch, cls_manager, cls_http, drt):
    watch = await cls_watch(drt, cls_manager()).start()
    await watch.wait_for_model(MODEL, timeout=10)
    http = cls_http(watch.manager, host="127.0.0.1", port=0, drt=drt)
    await http.start()
    return watch, http


class _Stacks:
    def __init__(self, tok_dir):
        self.tok_dir = tok_dir
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.closers = []

    def run(self, coro, timeout=TIMEOUT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def start(self):
        self.jp, self.tp = _weights()
        self.session = aiohttp.ClientSession()
        jdrt = JaxRuntime(JaxHub())
        jeng = await _jax_worker(jdrt, self.jp, self.tok_dir)
        jwatch, jhttp = await _front(JaxModelWatcher, JaxModelManager, JaxHttpFrontend, jdrt)
        drt = DistributedRuntime(InMemoryHub())
        eng = await _port_worker(drt, self.tp, self.tok_dir)
        watch, http = await _front(ModelWatcher, ModelManager, HttpFrontend, drt)
        self.bases = {"jax": f"http://127.0.0.1:{jhttp.port}",
                      "port": f"http://127.0.0.1:{http.port}"}
        self.closers += [http.stop, watch.close, eng.close, drt.close,
                         jhttp.stop, jwatch.close, jeng.close, jdrt.close]

    async def stop(self):
        await self.session.close()
        for close in self.closers:
            await close()

    async def post(self, base, body):
        async with self.session.post(base + "/v1/chat/completions", json=body) as r:
            text = await r.text()
            if r.content_type == "text/event-stream":
                return r.status, _sse_chunks(text)
            return r.status, json.loads(text)


@pytest.fixture(scope="module")
def stacks(tok_dir):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    s = _Stacks(tok_dir)
    s.run(s.start())
    try:
        yield s
    finally:
        s.run(s.stop())
        s.loop.call_soon_threadsafe(s.loop.stop)
        s.thread.join(10)
        s.loop.close()
        torch.set_num_threads(prev)


@pytest.mark.parametrize("case", list(BODIES))
def test_text_chats_equal_the_reference(stacks, tok_dir, case):
    body = BODIES[case]

    async def both():
        return await asyncio.gather(stacks.post(stacks.bases["jax"], body),
                                    stacks.post(stacks.bases["port"], body))

    (ws, want), (gs, got) = stacks.run(both())
    assert ws == gs == 200, (want, got)
    _assert_same(_strip(got), _strip(want))
    tok = HFTokenizer(tok_dir)
    prompt = tok.apply_chat_template(body["messages"], tools=body.get("tools"))
    usage = (want[-2] if body.get("stream") else want)["usage"]
    assert usage["prompt_tokens"] == len(tok.encode(prompt))
    if case == "json-object":
        text = want["choices"][0]["message"]["content"]
        if want["choices"][0]["finish_reason"] == "stop":
            assert isinstance(json.loads(text), dict)
        assert text.lstrip().startswith("{")


def test_text_crosses_the_wire_both_ways(stacks, tok_dir):
    """A port frontend before a JAX worker whose card names the tokenizer
    directory, and a JAX frontend before a port worker, over TCP hubs:
    every body equals the in-process stacks'."""
    async def run():
        out = {}
        closers = []
        try:
            jhub = JaxHubServer(port=0)
            await jhub.start()
            jaddr = f"127.0.0.1:{jhub.port}"
            jworker = JaxRuntime(await JaxRemoteHub.connect(jaddr),
                                 JaxRuntimeConfig(hub_address=jaddr))
            jeng = await _jax_worker(jworker, stacks.jp, tok_dir)
            pfront = DistributedRuntime(await RemoteHub.connect(jaddr),
                                        RuntimeConfig(hub_address=jaddr))
            pwatch, phttp = await _front(ModelWatcher, ModelManager, HttpFrontend, pfront)
            closers += [phttp.stop, pwatch.close, pfront.close, jeng.close,
                        jworker.close, jhub.stop]
            hub = HubServer(port=0)
            await hub.start()
            addr = f"127.0.0.1:{hub.port}"
            pworker = DistributedRuntime(await RemoteHub.connect(addr),
                                         RuntimeConfig(hub_address=addr))
            peng = await _port_worker(pworker, stacks.tp, tok_dir)
            jfront = JaxRuntime(await JaxRemoteHub.connect(addr),
                                JaxRuntimeConfig(hub_address=addr))
            jwatch, jhttp = await _front(JaxModelWatcher, JaxModelManager,
                                         JaxHttpFrontend, jfront)
            closers += [jhttp.stop, jwatch.close, jfront.close, peng.close,
                        pworker.close, hub.stop]
            for name, base in (("port-front", f"http://127.0.0.1:{phttp.port}"),
                               ("jax-front", f"http://127.0.0.1:{jhttp.port}"),
                               ("in-process", stacks.bases["jax"])):
                out[name] = await asyncio.gather(*(
                    stacks.post(base, BODIES[c]) for c in ("chat", "chat-stream", "tools")))
        finally:
            for close in closers:
                await close()
        return out

    out = stacks.run(run())
    for name in ("port-front", "jax-front"):
        for (gs, got), (ws, want) in zip(out[name], out["in-process"]):
            assert gs == ws == 200, (name, got)
            _assert_same(_strip(got), _strip(want))


async def test_checkpoint_directory_serves_with_its_tokenizer(tmp_path):
    """save_params + the tokenizer files in one directory: the worker
    serves it with that tokenizer (no refusal), its card names the
    directory, and a chat streams text the tokenizer decodes."""
    spec = ModelSpec(**{**SPEC_KW, "name": "ckpt-text"})
    loader.save_params(spec, llama.init_params(spec, 1, device="cpu"), str(tmp_path))
    build_tokenizer_dir("llama3", tmp_path)
    drt = DistributedRuntime(InMemoryHub())
    eng, _ = await launch_engine_worker(
        drt, model_path=str(tmp_path), engine_config=EngineConfig(**CFG_KW),
        device="cpu", router_mode="round_robin")
    watch = await ModelWatcher(drt, ModelManager()).start()
    try:
        name = eng.spec.name
        await watch.wait_for_model(name, timeout=10)
        pipe = watch.manager.get(name)
        tok = pipe.preprocessor.tokenizer
        assert isinstance(tok, HFTokenizer) and pipe.card.tokenizer == str(tmp_path)
        vocab = eng._guided.vocab  # built by the worker from the card's tokenizer
        assert len(vocab) == SPEC_KW["vocab_size"] and vocab.tokens[5] == tok.decode([5])
        from dynamo_tpu_torch.runtime.context import Context

        pre = pipe.preprocessor.preprocess({"model": name, "messages": CHAT,
                                            "max_tokens": 6, "ignore_eos": True})
        assert pre["token_ids"] == tok.encode(tok.apply_chat_template(CHAT))
        deltas = [d async for d in pipe.generate(pre, Context())]
        assert sum(len(d.get("token_ids") or []) for d in deltas) == 6
    finally:
        await watch.close()
        await eng.close()
        await drt.close()
