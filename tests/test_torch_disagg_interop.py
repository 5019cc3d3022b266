"""Disaggregation across packages: the port's transfer plane, engines and
workers held against the JAX package's.

- The wire, bit for bit: a JAX source pulled by the port and a port source
  pulled by JAX, f32 and the packed fp8 block; a port bf16 export (its
  ``uint16`` bits named bfloat16) pulled by JAX equals its bits, and a
  port-only ``cuda_ipc`` key does not lead the JAX reader anywhere.
- Engine to engine: a JAX prefill engine's ``kv_transfer_params`` resumed
  by a port decode engine, and the reverse, on f32 and fp8 pools: the
  stream equals both packages' aggregated streams (the reference's
  ``kv_checksum`` cannot hash a bf16 export, so bf16 is the port's own).
- Workers over a TCP hub on real prompts: a JAX prefill worker feeding a
  port decode worker, and the reverse, both serving one checkpoint
  directory that holds a llama-3-format tokenizer (tests/test_torch_text.py's):
  chat prompts encoded by the tokenizer stream the tokens the decode
  package's aggregated engine streams.
"""

import asyncio

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import dynamo_tpu.disagg.transfer as jtr
import dynamo_tpu.runtime.context as jctx
import dynamo_tpu_torch.disagg.transfer as tr
import dynamo_tpu_torch.runtime.context as tctx
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.engine.worker import launch_engine_worker as jax_launch_worker
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.hf_tokenizer import HFTokenizer
from dynamo_tpu_torch.models import loader
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer
from test_torch_tokenizer import build_tokenizer_dir

pytestmark = pytest.mark.integration

SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=64, max_pages_per_seq=16,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
EMBED_SCALE = 8.0  # peaked logits: greedy streams agree across packages
PROMPT = list(range(30, 49))  # 4 full pages of 4 and 3 tokens
TOKENS = 6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_WEIGHTS: dict = {}


def _weights(vocab=SPEC_KW["vocab_size"]):
    if vocab not in _WEIGHTS:
        kw = {**SPEC_KW, "vocab_size": vocab}
        jp = jax.tree.map(np.asarray, jllama.init_params(JaxSpec(**kw), jax.random.PRNGKey(3)))
        jp["embed"] = jp["embed"] * EMBED_SCALE
        _WEIGHTS[vocab] = (jp, params_from_numpy(ModelSpec(**kw), jp, device="cpu"))
    return _WEIGHTS[vocab]


def _req(prompt, n=TOKENS, **kw):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True},
            "eos_token_ids": [2], **kw}


async def _tokens(agen):
    out = []
    async for item in agen:
        assert item.get("finish_reason") != "error", item
        out.extend(item.get("token_ids") or [])
    return out


# ------------------------------------------------------------------- wire


def _wire_blocks(case):
    rng = np.random.default_rng(11)
    if case == "f32":
        k = rng.standard_normal((2, 3, 2, 4, 8)).astype(np.float32)
        return k, k * -2.0
    k = rng.integers(0, 256, (2, 3, 136), dtype=np.uint8)  # packed fp8 pages
    return k, k[:, ::-1].copy()


@pytest.mark.parametrize("case", ["f32", "packed"])
async def test_jax_source_pulled_by_the_port(case):
    k, v = _wire_blocks(case)
    src = await jtr.KvTransferSource(device_transfer=False).start()
    try:
        params = src.export(k, v, num_tokens=11, page_size=4)
        k2, v2, meta = await asyncio.to_thread(tr.pull_kv_blocks, params)
    finally:
        await src.close()
    assert meta == {"num_tokens": 11, "page_size": 4}
    assert k2.dtype == k.dtype and v2.dtype == v.dtype
    assert np.array_equal(k2, k) and np.array_equal(v2, v)


@pytest.mark.parametrize("case", ["f32", "packed", "bf16"])
async def test_port_source_pulled_by_jax(case):
    if case == "bf16":
        f = np.random.default_rng(12).standard_normal((2, 3, 2, 4, 8)).astype(np.float32)
        k, v = torch.from_numpy(f).to(torch.bfloat16), torch.from_numpy(-f).to(torch.bfloat16)
        want = [x.view(torch.int16).numpy().view(np.uint16) for x in (k, v)]
    else:
        k, v = _wire_blocks(case)
        want = [k, v]
    src = await tr.KvTransferSource().start()
    try:
        params = src.export(k, v, num_tokens=11, page_size=4)
        params["cuda_ipc"] = True  # what a device export adds: not the JAX reader's key
        k2, v2, meta = await asyncio.to_thread(jtr.pull_kv_blocks, params)
    finally:
        await src.close()
    assert meta == {"num_tokens": 11, "page_size": 4}
    if case == "bf16":
        assert k2.dtype == ml_dtypes.bfloat16
        k2, v2 = k2.view(np.uint16), v2.view(np.uint16)
    assert np.array_equal(k2, want[0]) and np.array_equal(v2, want[1])


# ------------------------------------------------------- engine to engine


_AGG: dict = {}


async def _aggregated(kv):
    """Both packages' aggregated greedy streams of PROMPT on fresh engines."""
    if kv not in _AGG:
        jp, tp = _weights()
        jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW, kv_dtype=kv), params=jp)
        want_j = await _tokens(jeng.generate(_req(PROMPT), jctx.Context()))
        await jeng.close()
        teng = InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW, kv_dtype=kv),
                               params=tp, device="cpu")
        want_p = await _tokens(teng.generate(_req(PROMPT), tctx.Context()))
        await teng.close()
        _AGG[kv] = (want_j, want_p)
    return _AGG[kv]


def _engines(side, kv, source=None):
    jp, tp = _weights()
    if side == "jax":
        return JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW, kv_dtype=kv),
                         params=jp, transfer_source=source)
    return InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW, kv_dtype=kv),
                           params=tp, device="cpu", transfer_source=source)


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("prefill,decode", [("jax", "port"), ("port", "jax")])
async def test_engine_export_resumed_across_packages(prefill, decode, kv, monkeypatch):
    """One package's prefill engine exports PROMPT's pages with its first
    token; the other's decode engine pulls them (TCP: each package has its
    own in-process registry), installs them and decodes: the stream equals
    both packages' aggregated streams. f32 weights (kv "bf16" is the
    spec's f32 pool) and fp8 pools (the JAX side on its Pallas route)."""
    if kv == "fp8":
        monkeypatch.setenv("DYNAMO_PALLAS", "1")
    want_j, want_p = await _aggregated(kv)
    assert want_j == want_p and len(want_j) == TOKENS
    mods = {"jax": (jtr, jctx), "port": (tr, tctx)}
    ptr, pctx = mods[prefill]
    # the reference's own switch keeps its PJRT route out of a CPU run
    kwargs = {"device_transfer": False} if prefill == "jax" else {}
    source = await ptr.KvTransferSource(**kwargs).start()
    pre = _engines(prefill, kv, source)
    dec = _engines(decode, kv)
    try:
        r = _req(PROMPT, n=1)
        r["disagg"] = {"mode": "prefill", "kv_transfer": {"do_remote_decode": True}}
        items = [i async for i in pre.generate(r, pctx.Context())]
        (item,) = items
        first, kvp = item["token_ids"][0], item["kv_transfer_params"]
        assert item["finish_reason"] == "length" and kvp["kv_dtype"] == kv
        resume = _req(PROMPT, disagg={"mode": "decode",
                                      "kv_transfer": {**kvp, "first_token": first}})
        got = await _tokens(dec.generate(resume, mods[decode][1].Context()))
        assert [first] + got == want_j
        assert dec.disagg_fallbacks == 0 and not source._exports
        assert pre.steps == 0
    finally:
        await pre.close()
        await dec.close()
        await source.close()


# -------------------------------------------------- workers over a TCP hub

TEXT_VOCAB = 1024  # the tokenizer's ids fit the logits
TEXT_CFG = {**CFG_KW, "num_pages": 256, "max_pages_per_seq": 64,
            "prefill_buckets": (16, 32, 64, 128)}
CHATS = [[{"role": "user", "content": "Name three colours, and say 机器学习 in English."}],
         [{"role": "system", "content": "You are terse."},
          {"role": "user", "content": "Count from one to five, then stop."}]]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A checkpoint directory: the shared weights in HF safetensors and the
    llama-3 tokenizer set."""
    path = tmp_path_factory.mktemp("disagg") / "llama3-ckpt"
    _jp, tp = _weights(TEXT_VOCAB)
    loader.save_params(ModelSpec(**{**SPEC_KW, "vocab_size": TEXT_VOCAB, "name": "ckpt"}),
                       tp, str(path))
    build_tokenizer_dir("llama3", path)
    return str(path)


async def _worker(side, addr, ckpt, mode):
    kw = dict(model_path=ckpt, mode=mode, always_remote_prefill=mode == "decode",
              router_mode="round_robin", prefill_router_mode="round_robin")
    if side == "jax":
        drt = JaxRuntime(await JaxRemoteHub.connect(addr), JaxRuntimeConfig(hub_address=addr))
        eng, _ = await jax_launch_worker(drt, engine_config=JaxEngineConfig(**TEXT_CFG), **kw)
    else:
        drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))
        eng, _ = await launch_engine_worker(drt, engine_config=EngineConfig(**TEXT_CFG),
                                            device="cpu", **kw)
    return drt, eng


def _text_engine(side):
    """An aggregated engine of ``side`` on the checkpoint's weights."""
    jp, tp = _weights(TEXT_VOCAB)
    kw = {**SPEC_KW, "vocab_size": TEXT_VOCAB}
    if side == "jax":
        return JaxEngine(JaxSpec(**kw), JaxEngineConfig(**TEXT_CFG), params=jp)
    return InferenceEngine(ModelSpec(**kw), EngineConfig(**TEXT_CFG), params=tp, device="cpu")


@pytest.mark.parametrize("prefill,decode", [("jax", "port"), ("port", "jax")])
async def test_workers_across_packages_on_real_prompts(prefill, decode, ckpt_dir):
    """A prefill worker of one package and a decode worker of the other,
    over one TCP hub, both serving the checkpoint directory: each chat,
    rendered and encoded by the directory's tokenizer, is prefilled
    remotely (one export each, pulled over TCP, no fallback, no decode step
    on the prefill side) and streams through the decode worker's front door
    what an aggregated engine of the decode package streams; the texts
    decode equal."""
    tok = HFTokenizer(ckpt_dir)
    prompts = [tok.encode(tok.apply_chat_template(c)) for c in CHATS]
    ctx = (jctx if decode == "jax" else tctx).Context
    agg = _text_engine(decode)
    want = [await _tokens(agg.generate(_req(p, n=8), ctx())) for p in prompts]
    await agg.close()
    hub = HubServer(port=0)
    await hub.start()
    addr = f"127.0.0.1:{hub.port}"
    closers = [hub.stop]
    try:
        pdrt, pre = await _worker(prefill, addr, ckpt_dir, "prefill")
        closers = [pre.close, pdrt.close] + closers
        exports = []
        export = pre.transfer_source.export
        pre.transfer_source.export = lambda *a, **k: exports.append(1) or export(*a, **k)
        ddrt, dec = await _worker(decode, addr, ckpt_dir, "decode")
        closers = [dec.close, ddrt.close] + closers
        handler = dec.frontdoor
        await handler.wait_for_prefill_pool(timeout=20.0)
        got = [await _tokens(handler.generate(_req(p, n=8), ctx())) for p in prompts]
        assert len(exports) == len(prompts) and pre.steps == 0
        assert dec.disagg_fallbacks == 0
        assert got == want and all(len(g) == 8 for g in got)
        assert [tok.decode(g) for g in got] == [tok.decode(w) for w in want]
    finally:
        for close in closers:
            await close()
