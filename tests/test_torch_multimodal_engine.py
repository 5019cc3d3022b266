"""The port's multimodal and embeddings serving held against the JAX
package's on the CPU, on shared weights (a tiny f32 llama, its input
embedding scaled by EMBED_SCALE so no greedy token rides on a near-tie):

- the engines: one multimodal request (the encoder's rows as
  ``embeds_b64``, the placeholder positions) streams the same tokens
  through both and seals the same salted block hashes: a rehit with the
  same image and a miss with another; a text prompt with the same ids is a
  partition of its own;
- the engines' errors are the reference's (no rows, rows/positions and
  width mismatches, a prompt past one prefill dispatch, MLA's refusal);
- ``embed_forward`` of tiny llama and tiny deepseek and the engines'
  ``embedding_request`` answers agree within EMB_TOL;
- a disaggregated multimodal request (prefill worker + decode worker)
  streams the aggregated tokens and seals the salted hashes on both sides;
- EPD end to end: both packages' HTTP frontends, each over an in-memory hub
  with its own encode worker (the mock encoder) and engine, give equal chat
  bodies for one image, two images, a repeated image and another image,
  and equal /v1/embeddings bodies (vectors within EMB_TOL) and errors;
- a JPEG image and a GIF video in one chat give equal bodies from both
  EPD stacks (the port samples the reference's PNG frame bytes), and so do
  a WebP image with an animated WebP video and an APNG video;
- across packages over one TCP hub: a JAX frontend and encode worker serve
  a port engine worker, and a port frontend and encode worker a JAX one;
- the port's ``cli encoder`` serves the tiny ViT tower on PNGs, a GIF
  video and WebP images and videos, refuses BMP naming item 12b-iii, and
  its mock encode worker's rows for a GIF video and a JPEG are the JAX
  encode worker's.
"""

import asyncio
import base64
import json
import threading

import aiohttp
import jax
import numpy as np
import pytest
import torch

import dynamo_tpu.runtime.context as jctx
import dynamo_tpu_torch.runtime.context as tctx
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.frontend.http import HttpFrontend as JaxHttpFrontend
from dynamo_tpu.frontend.model_card import register_llm as jax_register_llm
from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import mla as jmla
from dynamo_tpu.multimodal.worker import launch_encode_worker as jax_launch_encoder
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.models import llama, mla
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.multimodal.encoder import MockVisionEncoder
from dynamo_tpu_torch.multimodal.worker import embeds_to_wire, launch_encode_worker
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_server import HubServer
from dynamo_tpu_torch.tokens import TokenBlockSequence
from test_torch_mla import _weights as mla_weights

pytestmark = pytest.mark.integration

# vocab >= 272: the mock tokenizer's byte ids (16..271) are model tokens
SPEC_KW = dict(vocab_size=288, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=256, max_pages_per_seq=64,
              max_decode_slots=4, prefill_buckets=(16, 32, 64, 128))
EMBED_SCALE = 8.0
TPI, IMAGE_TOKEN = 4, 5  # placeholder rows per image, their token id
EMB_TOL = 1e-5  # unit-norm f32 vectors: XLA and PyTorch sum in other orders
TOKENS = 6
PROMPT = list(range(30, 38)) + [IMAGE_TOKEN] * TPI + list(range(40, 48))  # 20
POSITIONS = list(range(8, 8 + TPI))


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_WEIGHTS: dict = {}


def _weights():
    if not _WEIGHTS:
        jp = jax.tree.map(np.asarray, jllama.init_params(JaxSpec(**SPEC_KW),
                                                         jax.random.PRNGKey(5)))
        jp["embed"] = jp["embed"] * EMBED_SCALE
        _WEIGHTS["w"] = (jp, params_from_numpy(ModelSpec(**SPEC_KW), jp, device="cpu"))
    return _WEIGHTS["w"]


def _png(seed: int) -> bytes:
    """Image bytes (the mock encoder seeds its rows by their digest)."""
    return b"\x89PNG-test-" + bytes([seed]) * 16


def _mm_req(image=0, prompt=PROMPT, positions=POSITIONS, n=TOKENS, rows=None, **mm):
    if rows is None:
        rows = MockVisionEncoder(SPEC_KW["hidden_size"], TPI).encode([_png(image)])
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True},
            "eos_token_ids": [2],
            "multimodal": {**embeds_to_wire(rows), "positions": list(positions), **mm}}


async def _stream(agen):
    toks, last = [], None
    async for item in agen:
        toks.extend(item.get("token_ids") or [])
        last = item
    return toks, last


def _engine(side, **cfg):
    jp, tp = _weights()
    if side == "jax":
        return JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**{**CFG_KW, **cfg}), params=jp)
    return InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**{**CFG_KW, **cfg}),
                           params=tp, device="cpu")


def _engines(**cfg):
    return _engine("jax", **cfg), _engine("port", **cfg)


def _salted_hashes(req):
    from dynamo_tpu_torch.multimodal.worker import salt_from_wire

    return TokenBlockSequence.from_tokens(req["token_ids"], CFG_KW["page_size"],
                                          salt=salt_from_wire(req["multimodal"])
                                          ).sequence_hashes()


# ---------------------------------------------------------------- engines


async def test_engine_streams_and_salted_hashes_match_jax():
    """Image 0, image 0 again (a cached-prefix rehit), image 1 (a miss) and
    the same ids as text: equal streams and equal sealed hash sets after
    each; the image's prompt blocks are sealed under its salt only."""
    jeng, teng = _engines()
    text = {k: v for k, v in _mm_req().items() if k != "multimodal"}
    try:
        streams = []
        for req in (_mm_req(0), _mm_req(0), _mm_req(1), text):
            cached = teng.cached_prompt_tokens
            want, wl = await _stream(jeng.generate(req, jctx.Context()))
            got, gl = await _stream(teng.generate(req, tctx.Context()))
            assert wl["finish_reason"] == gl["finish_reason"] == "length", (wl, gl)
            assert got == want and len(got) == TOKENS
            assert set(teng.allocator._hash_page) == set(jeng.allocator._hash_page)
            streams.append(got)
            if req is not text:
                hashes = _salted_hashes(req)
                assert len(teng.allocator.match_prefix(hashes)) == len(hashes) == 5
            hit = teng.cached_prompt_tokens - cached
            assert hit == (16 if len(streams) == 2 else 0)
        # another image (or none) changes what the model sees
        assert streams[0] == streams[1] and streams[2] != streams[0] != streams[3]
        plain = TokenBlockSequence.from_tokens(PROMPT, 4).sequence_hashes()
        assert not set(plain) & set(_salted_hashes(_mm_req(0)))
    finally:
        await jeng.close()
        await teng.close()


async def test_operator_salt_is_used_as_given():
    """An operator-set ``salt`` partitions the cache without a payload
    decode, in both engines alike."""
    jeng, teng = _engines()
    try:
        req = _mm_req(2, salt="a-given-salt")
        want, _ = await _stream(jeng.generate(req, jctx.Context()))
        got, _ = await _stream(teng.generate(req, tctx.Context()))
        assert got == want
        hashes = TokenBlockSequence.from_tokens(PROMPT, 4, salt="a-given-salt").sequence_hashes()
        assert len(teng.allocator.match_prefix(hashes)) == 5
        assert set(teng.allocator._hash_page) == set(jeng.allocator._hash_page)
    finally:
        await jeng.close()
        await teng.close()


async def test_payload_decoded_once_off_the_step_thread(monkeypatch):
    """The encoder's rows are decoded in generate(), in a thread of the
    loop: a request that waits for pages (page-stall requeues) is not
    decoded again, and its stream equals the one it gives alone."""
    ref, teng = _engine("port"), _engine("port", num_pages=9)
    calls: list[str] = []
    requeues: list[str] = []
    decode, requeue = teng._decode_multimodal, teng._waiting.requeue

    def counted(req):
        calls.append(threading.current_thread().name)
        return decode(req)

    def counted_requeue(w):
        requeues.append(w.context.id)
        return requeue(w)

    monkeypatch.setattr(teng, "_decode_multimodal", counted)
    monkeypatch.setattr(teng._waiting, "requeue", counted_requeue)
    try:
        alone, _ = await _stream(ref.generate(_mm_req(3), tctx.Context()))
        # 5 prompt pages each, 7 with the decode, and 8 usable pages: the
        # second waits for the first to finish
        first, second = await asyncio.gather(
            _stream(teng.generate(_mm_req(2), tctx.Context())),
            _stream(teng.generate(_mm_req(3), tctx.Context())))
        assert second[0] == alone and len(first[0]) == TOKENS, first[1]
        assert requeues and len(calls) == 2 and "engine-step" not in calls
    finally:
        await ref.close()
        await teng.close()


def _error_cases():
    good = _mm_req(0)
    narrow = MockVisionEncoder(32, TPI).encode([_png(0)])
    long_prompt = list(range(30, 60)) + [IMAGE_TOKEN] * TPI + list(range(60, 80))
    return {
        "no rows": {**good, "multimodal": {"images": ["x"], "positions": POSITIONS}},
        "rows vs positions": _mm_req(0, positions=POSITIONS[:3]),
        "width": _mm_req(0, rows=narrow),
        "over one dispatch": _mm_req(0, prompt=long_prompt,
                                     positions=list(range(30, 30 + TPI))),
    }


@pytest.mark.parametrize("case", list(_error_cases()))
async def test_engine_errors_match_jax(case):
    """Each refusal ends the stream with the reference's error item, and the
    engine holds no page after it (the over-dispatch case runs at a chunk
    cap of 32)."""
    req = _error_cases()[case]
    jeng, teng = _engines(max_prefill_chunk_tokens=32)
    try:
        _, want = await _stream(jeng.generate(req, jctx.Context()))
        _, got = await _stream(teng.generate(req, tctx.Context()))
        assert got == want and got["finish_reason"] == "error", (got, want)
        assert teng.allocator.active_pages == 0
        # the engine serves on
        ok, _ = await _stream(teng.generate(_mm_req(0), tctx.Context()))
        assert len(ok) == TOKENS
    finally:
        await jeng.close()
        await teng.close()


async def test_mla_refuses_images_and_serves_embeddings():
    """tiny-deepseek: an image request is refused with the reference's
    error; an embedding request is answered as the reference's engine
    answers it."""
    jspec, tspec, jp, tp = mla_weights()
    cfg = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_decode_slots=2,
               prefill_buckets=(16, 32))
    jeng = JaxEngine(jspec, JaxEngineConfig(**cfg), params=jp)
    teng = InferenceEngine(tspec, EngineConfig(**cfg), params=tp, device="cpu")
    rows = MockVisionEncoder(tspec.hidden_size, TPI).encode([_png(0)])
    prompt = [10 + i % 50 for i in range(20)]
    req = _mm_req(0, prompt=prompt, rows=rows)
    emb = {"token_ids": prompt[:13], "embedding_request": True}
    try:
        _, want = await _stream(jeng.generate(req, jctx.Context()))
        _, got = await _stream(teng.generate(req, tctx.Context()))
        assert got == want and "does not support image input" in got["error"]
        _, want = await _stream(jeng.generate(emb, jctx.Context()))
        _, got = await _stream(teng.generate(emb, tctx.Context()))
        assert got.keys() == want.keys() == {"token_ids", "embedding", "finish_reason"}
        np.testing.assert_allclose(got["embedding"], want["embedding"], rtol=0, atol=EMB_TOL)
    finally:
        await jeng.close()
        await teng.close()


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_embed_forward_matches_jax(family):
    """embed_forward on a bucket-padded prompt: the pooled, L2-normalized
    vector of the reference within EMB_TOL (unit norm)."""
    if family == "llama":
        jp, tp = _weights()
        jspec, tspec, jm, tm = JaxSpec(**SPEC_KW), ModelSpec(**SPEC_KW), jllama, llama
    else:
        jspec, tspec, jp, tp = mla_weights()
        jm, tm = jmla, mla
    for n in (1, 11, 32):
        tokens = np.zeros(32, np.int32)
        tokens[:n] = np.arange(17, 17 + n) % tspec.vocab_size
        want = np.asarray(jm.embed_forward(jspec, jp, tokens, np.int32(n)))
        got = tm.embed_forward(tspec, tp, torch.from_numpy(tokens), n).numpy()
        assert got.dtype == np.float32 and got.shape == (tspec.hidden_size,)
        np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)
        assert abs(np.linalg.norm(got) - 1.0) < 1e-5


async def test_engine_embedding_requests_match_jax():
    jeng, teng = _engines()
    try:
        for ids in ([7], list(range(20, 60)), list(range(100, 228))):
            req = {"token_ids": ids, "stop_conditions": {"max_tokens": 1},
                   "embedding_request": True}
            _, want = await _stream(jeng.generate(req, jctx.Context()))
            _, got = await _stream(teng.generate(req, tctx.Context()))
            assert got["finish_reason"] == want["finish_reason"] == "stop"
            np.testing.assert_allclose(got["embedding"], want["embedding"], rtol=0,
                                       atol=EMB_TOL)
        assert teng.allocator.active_pages == 0 and teng.steps == 0
    finally:
        await jeng.close()
        await teng.close()


# ------------------------------------------------------------------ disagg


async def test_disagg_multimodal_resume_equals_aggregated():
    """A prefill worker runs the image prompt's one dispatch and exports;
    the decode worker resumes it and seals the blocks under the image salt:
    the stream is the aggregated engine's."""
    _, tp = _weights()
    spec = ModelSpec(**SPEC_KW)
    agg = InferenceEngine(spec, EngineConfig(**CFG_KW), params=tp, device="cpu")
    want, _ = await _stream(agg.generate(_mm_req(3), tctx.Context()))
    await agg.close()
    drt = DistributedRuntime(InMemoryHub())
    pre, _ = await launch_engine_worker(drt, spec=spec, params=tp, mode="prefill",
                                        engine_config=EngineConfig(**CFG_KW), device="cpu")
    dec, _ = await launch_engine_worker(drt, spec=spec, params=tp, mode="decode",
                                        engine_config=EngineConfig(**CFG_KW), device="cpu",
                                        always_remote_prefill=True)
    try:
        await dec.frontdoor.wait_for_prefill_pool()
        got, last = await _stream(dec.frontdoor.generate(_mm_req(3), tctx.Context()))
        assert got == want and last["finish_reason"] == "length"
        assert dec.disagg_fallbacks == 0 and dec.prefill_forwards == 0 and pre.steps == 0
        hashes = _salted_hashes(_mm_req(3))
        for eng in (pre, dec):
            assert len(eng.allocator.match_prefix(hashes)) == 5
    finally:
        await pre.close()
        await dec.close()
        await drt.close()


# ---------------------------------------------------------------- EPD/HTTP

MM_MODEL, EMB_MODEL = "tiny-vl", "tiny-emb"
TIMEOUT = 120
VIDEO_FRAMES = 8  # both cards and both encode workers (their default)


def _data_url(seed: int) -> str:
    return "data:image/png;base64," + base64.b64encode(_png(seed)).decode()


def _chat(*images, text="describe"):
    parts = [{"type": "text", "text": text}]
    parts += [{"type": "image_url", "image_url": {"url": _data_url(s)}} for s in images]
    return {"model": MM_MODEL, "max_tokens": TOKENS, "temperature": 0.0,
            "ignore_eos": True, "messages": [{"role": "user", "content": parts}]}


class _Stacks:
    """Both packages' EPD stacks (in-memory hub, mock encode worker, a
    multimodal chat model and an embeddings model, HTTP frontend) on one
    event loop in a background thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=TIMEOUT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def start(self):
        jp, tp = _weights()
        hidden = SPEC_KW["hidden_size"]
        self.jdrt = JaxRuntime(JaxHub())
        await jax_launch_encoder(self.jdrt, hidden_size=hidden, tokens_per_image=TPI)
        self.jengs = []
        for name, kind in ((MM_MODEL, "chat"), (EMB_MODEL, "embeddings")):
            eng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW), params=jp)
            ep = self.jdrt.namespace("dynamo").component(name).endpoint("generate")
            mm = (dict(mm_tokens_per_image=TPI, image_token_id=IMAGE_TOKEN,
                       mm_video_frames=VIDEO_FRAMES) if kind == "chat" else {})
            await jax_register_llm(self.jdrt, ep, eng.generate, model_name=name,
                                   model_type=kind, router_mode="round_robin",
                                   context_length=eng.config.max_context,
                                   kv_block_size=CFG_KW["page_size"], **mm)
            await eng.start()
            self.jengs.append(eng)
        self.jwatch = await JaxModelWatcher(self.jdrt, JaxModelManager()).start()
        self.drt = DistributedRuntime(InMemoryHub())
        await launch_encode_worker(self.drt, hidden_size=hidden, tokens_per_image=TPI)
        self.engs = []
        for name, kind in ((MM_MODEL, "chat"), (EMB_MODEL, "embeddings")):
            mm = dict(mm_tokens_per_image=TPI, image_token_id=IMAGE_TOKEN) \
                if kind == "chat" else {}
            eng, _ = await launch_engine_worker(
                self.drt, component=name, model_name=name, model_type=kind,
                spec=ModelSpec(**SPEC_KW), engine_config=EngineConfig(**CFG_KW),
                params=tp, device="cpu", router_mode="round_robin", **mm)
            self.engs.append(eng)
        self.watch = await ModelWatcher(self.drt, ModelManager()).start()
        for w in (self.jwatch, self.watch):
            for name in (MM_MODEL, EMB_MODEL):
                await w.wait_for_model(name, timeout=10)
        self.jhttp = JaxHttpFrontend(self.jwatch.manager, host="127.0.0.1", port=0)
        await self.jhttp.start()
        self.http = HttpFrontend(self.watch.manager, host="127.0.0.1", port=0)
        await self.http.start()
        self.bases = {"jax": f"http://127.0.0.1:{self.jhttp.port}",
                      "port": f"http://127.0.0.1:{self.http.port}"}
        self.session = aiohttp.ClientSession()

    async def stop(self):
        await self.session.close()
        for frontend, watcher, engines, drt in (
                (self.http, self.watch, self.engs, self.drt),
                (self.jhttp, self.jwatch, self.jengs, self.jdrt)):
            await frontend.stop()
            await watcher.close()
            for eng in engines:
                await eng.close()
            await drt.close()

    async def post(self, side, route, body):
        async with self.session.post(self.bases[side] + route, json=body) as r:
            return r.status, json.loads(await r.text())

    def both(self, route, body):
        async def gather():
            return await asyncio.gather(self.post("jax", route, body),
                                        self.post("port", route, body))

        return self.run(gather())


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


def _strip(body):
    return {k: v for k, v in body.items() if k not in ("id", "created")}


def test_epd_chat_bodies_match_jax(stacks):
    """One image, two images, the first image again (its prompt rehits the
    salted cache) and another image: equal chat bodies from both stacks;
    a chat whose text names the marker keeps it out of the placeholders."""
    eng = stacks.engs[0]
    bodies = []
    for images in ((0,), (0, 1), (0,), (2,)):
        cached = eng.cached_prompt_tokens
        (js, jb), (ps, pb) = stacks.both("/v1/chat/completions", _chat(*images))
        assert js == ps == 200, (jb, pb)
        assert _strip(pb) == _strip(jb)
        assert pb["usage"]["completion_tokens"] == TOKENS
        bodies.append(pb["choices"][0]["message"]["content"])
        if len(bodies) == 3:
            assert eng.cached_prompt_tokens > cached
    assert bodies[0] == bodies[2] and bodies[3] != bodies[0]
    (js, jb), (ps, pb) = stacks.both("/v1/chat/completions",
                                     _chat(1, text="a <|mm_image|> b"))
    assert js == ps == 200 and _strip(pb) == _strip(jb)


def test_epd_jpeg_and_gif_video_match_jax(stacks):
    """A JPEG image and a GIF video in one chat: the port's encode worker
    samples the video's frames into the reference's PNG bytes, so both
    stacks give the same body over 4 + 8 x 4 placeholder rows."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.open(io.BytesIO(_gif_video(4))).convert("RGB").save(buf, "JPEG", quality=85)
    body = _chat()
    body["messages"][0]["content"] += [
        {"type": "image_url", "image_url": {
            "url": "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()}},
        {"type": "video_url", "video_url": {
            "url": "data:image/gif;base64," + base64.b64encode(_gif_video(4)).decode()}}]
    (js, jb), (ps, pb) = stacks.both("/v1/chat/completions", body)
    assert js == ps == 200, (jb, pb)
    assert _strip(pb) == _strip(jb) and pb["usage"]["completion_tokens"] == TOKENS
    (_, text) = stacks.both("/v1/chat/completions", _chat())[1]
    assert pb["usage"]["prompt_tokens"] - text["usage"]["prompt_tokens"] == TPI * (
        1 + VIDEO_FRAMES)


def _apng_video(n: int = 5, size=(24, 20)) -> bytes:
    import io

    from PIL import Image

    w, h = size
    y, x = np.mgrid[:h, :w]
    frames = [Image.fromarray(np.stack([(x * 11 + 30 * k) % 256, y * 7 % 256,
                                        np.full_like(x, 200 - 20 * k), (x * y + 90) % 256],
                                       -1).astype(np.uint8), "RGBA") for k in range(n)]
    buf = io.BytesIO()
    frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:], duration=40,
                   disposal=[0, 1, 2, 0, 1][:n], blend=[0, 1, 1, 0, 1][:n])
    return buf.getvalue()


def test_epd_webp_and_apng_video_match_jax(stacks):
    """A lossy WebP image, an animated WebP video and an APNG video in one
    chat: the port decodes them without Pillow into the reference's pixels
    and PNG frame bytes, so both stacks give the same body over 4 + 2 x 8 x
    4 placeholder rows."""
    body = _chat()
    body["messages"][0]["content"] += [
        {"type": "image_url", "image_url": {
            "url": "data:image/webp;base64," + base64.b64encode(_webp(False)).decode()}},
        {"type": "video_url", "video_url": {
            "url": "data:image/webp;base64," + base64.b64encode(_webp(True)).decode()}},
        {"type": "video_url", "video_url": {
            "url": "data:image/png;base64," + base64.b64encode(_apng_video()).decode()}}]
    (js, jb), (ps, pb) = stacks.both("/v1/chat/completions", body)
    assert js == ps == 200, (jb, pb)
    assert _strip(pb) == _strip(jb) and pb["usage"]["completion_tokens"] == TOKENS
    (_, text) = stacks.both("/v1/chat/completions", _chat())[1]
    assert pb["usage"]["prompt_tokens"] - text["usage"]["prompt_tokens"] == TPI * (
        1 + 2 * VIDEO_FRAMES)


def test_epd_errors_match_jax(stacks):
    """A bad data URI fails at the encode hop with the reference's text; an
    embeddings model refuses chat images; http URLs are refused."""
    bad = _chat(0)
    bad["messages"][0]["content"][1]["image_url"]["url"] = "http://example.invalid/a.png"
    (js, jb), (ps, pb) = stacks.both("/v1/chat/completions", bad)
    assert (js, _strip(jb)) == (ps, _strip(pb))
    chat_on_emb = {**_chat(0), "model": EMB_MODEL}
    (js, jb), (ps, pb) = stacks.both("/v1/chat/completions", chat_on_emb)
    assert (js, jb) == (ps, pb) and ps == 400


def test_embeddings_route_matches_jax(stacks):
    """/v1/embeddings for one input and a batch of eight: the same body
    (each vector within EMB_TOL); a batch answer equals its inputs one by
    one; the reference's errors."""
    texts = [f"input number {i} " * (i + 1) for i in range(8)]
    one = {"model": EMB_MODEL, "input": texts[3]}
    batch = {"model": EMB_MODEL, "input": texts}
    got = {}
    for name, body in (("one", one), ("batch", batch)):
        (js, jb), (ps, pb) = stacks.both("/v1/embeddings", body)
        assert js == ps == 200
        jv = [d.pop("embedding") for d in jb["data"]]
        pv = [d.pop("embedding") for d in pb["data"]]
        assert pb == jb and len(pv) == (1 if name == "one" else 8)
        np.testing.assert_allclose(pv, jv, rtol=0, atol=EMB_TOL)
        assert np.allclose(np.linalg.norm(pv, axis=1), 1.0, atol=1e-5)
        got[name] = pv
    np.testing.assert_array_equal(got["batch"][3], got["one"][0])
    for body in ({"model": EMB_MODEL}, {"model": MM_MODEL, "input": "x"},
                 {"model": "nope", "input": "x"}, {"model": EMB_MODEL, "input": 3}):
        (js, jb), (ps, pb) = stacks.both("/v1/embeddings", body)
        assert (js, jb) == (ps, pb) and js in (400, 404), body


# ------------------------------------------------------- across packages


async def _tcp_stack(front, back, addr):
    """A frontend + encode worker of package ``front`` and an engine worker
    of ``back`` on the TCP hub at ``addr``; returns (pipeline, closers)."""
    jp, tp = _weights()
    hidden = SPEC_KW["hidden_size"]
    jdrt = JaxRuntime(await JaxRemoteHub.connect(addr), JaxRuntimeConfig(hub_address=addr))
    tdrt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))
    closers = [jdrt.close, tdrt.close]
    if back == "jax":
        eng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW), params=jp)
        ep = jdrt.namespace("dynamo").component("backend").endpoint("generate")
        await jax_register_llm(jdrt, ep, eng.generate, model_name=MM_MODEL,
                               router_mode="round_robin", kv_block_size=4,
                               context_length=eng.config.max_context,
                               mm_tokens_per_image=TPI, image_token_id=IMAGE_TOKEN,
                               mm_video_frames=0)
        await eng.start()
    else:
        eng, _ = await launch_engine_worker(
            tdrt, model_name=MM_MODEL, spec=ModelSpec(**SPEC_KW),
            engine_config=EngineConfig(**CFG_KW), params=tp, device="cpu",
            router_mode="round_robin", mm_tokens_per_image=TPI, image_token_id=IMAGE_TOKEN)
    closers.insert(0, eng.close)
    if front == "jax":
        await jax_launch_encoder(jdrt, hidden_size=hidden, tokens_per_image=TPI)
        watch = await JaxModelWatcher(jdrt, JaxModelManager()).start()
    else:
        await launch_encode_worker(tdrt, hidden_size=hidden, tokens_per_image=TPI)
        watch = await ModelWatcher(tdrt, ModelManager()).start()
    closers.insert(0, watch.close)
    await watch.wait_for_model(MM_MODEL, timeout=20)
    return watch.manager.get(MM_MODEL), closers


@pytest.mark.parametrize("front,back", [("jax", "port"), ("port", "jax")])
async def test_epd_across_packages_over_tcp(front, back):
    """The encode hop of one package feeds the other's engine over a TCP hub:
    each chat streams what the engine's package streams in process for the
    same rows (the mock encoder's), image for image."""
    hub = HubServer(port=0)
    await hub.start()
    closers = [hub.stop]
    try:
        pipe, more = await _tcp_stack(front, back, f"127.0.0.1:{hub.port}")
        closers = more + closers
        ctx = (jctx if front == "jax" else tctx).Context
        ref = _engine(back)
        rctx = (jctx if back == "jax" else tctx).Context
        try:
            for images in ((0,), (1, 2)):
                pre = pipe.preprocessor.preprocess(_chat(*images))
                want_req = dict(pre)
                rows = MockVisionEncoder(SPEC_KW["hidden_size"], TPI).encode(
                    [_png(s) for s in images])
                want_req["multimodal"] = {**embeds_to_wire(rows),
                                          "positions": pre["multimodal"]["positions"]}
                want, _ = await _stream(ref.generate(want_req, rctx()))
                got = []
                async for item in pipe.generate(pre, ctx()):
                    assert item.get("finish_reason") != "error", item
                    got.extend(item.get("token_ids") or [])
                assert got == want and len(got) == TOKENS
        finally:
            await ref.close()
    finally:
        for close in closers:
            await close()


# ------------------------------------------------------------ encode worker


def _real_png(w=20, h=12):
    import struct
    import zlib

    rows = b"".join(b"\x00" + bytes((x * 12 + y * 5) % 256 for x in range(w * 3))
                    for y in range(h))
    body = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", body) + chunk(b"IDAT", zlib.compress(rows))
            + chunk(b"IEND", b""))


def _gif_video(n=3, size=(24, 18)) -> bytes:
    """A Pillow-written animated GIF with a transparent index."""
    import io

    from PIL import Image

    w, h = size
    y, x = np.mgrid[:h, :w]
    frames = [Image.fromarray(np.stack([(x * 9 + 40 * k) % 256, y * 13 % 256,
                                        (x + y) * 5 % 256], -1).astype(np.uint8)).quantize(16)
              for k in range(n)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], transparency=3,
                   disposal=2, duration=40)
    return buf.getvalue()


def _webp(animated: bool) -> bytes:
    import io

    from PIL import Image

    y, x = np.mgrid[:20, :28]
    frames = [Image.fromarray(np.stack([(x * 9 + 60 * k) % 256, y * 12 % 256,
                                        np.full_like(x, 60 * k)], -1).astype(np.uint8))
              for k in range(3)]
    buf = io.BytesIO()
    kw = dict(save_all=True, append_images=frames[1:], duration=40) if animated else {}
    frames[0].save(buf, "WEBP", quality=70, **kw)
    return buf.getvalue()


async def _encode_rows(launch, drt, push, images) -> np.ndarray:
    """One encode request's rows from an encode worker ``launch`` serves on
    ``drt`` (the mock encoder), through ``push``'s router."""
    await launch(drt, hidden_size=SPEC_KW["hidden_size"], tokens_per_image=TPI)
    ep = drt.namespace("dynamo").component("encoder").endpoint("encode")
    router = await push.PushRouter.from_endpoint(ep, push.RouterMode.ROUND_ROBIN)
    await router.client.wait_for_instances(1, timeout=10)
    ctx = (jctx if push.__name__.startswith("dynamo_tpu.") else tctx).Context
    (reply,) = [r async for r in router.generate({"images": images}, ctx())]
    await router.client.close()
    assert "error" not in reply, reply
    return np.frombuffer(base64.b64decode(reply["embeds_b64"]), "<f4").reshape(reply["shape"])


async def test_cli_encoder_serves_the_vit_tower_and_refuses_video():
    """``cli encoder --encoder vit --vit-size tiny --device cpu`` on a TCP
    hub: a real PNG twice encodes once and tiles (LLM-hidden rows through
    the projector), the reply carries the reference's keys; a GIF video
    gives 8 sampled frames' rows (repeated frames tiled); a WebP image and
    an animated WebP video encode (the video's 3 frames tiled as the GIF's
    are); a BMP image and a BMP video answer the encode error naming item
    12b-iii. With the mock encoder, the port's encode worker gives the JAX
    encode worker's rows for the same GIF video and JPEG."""
    import dynamo_tpu.runtime.push as jpush
    import dynamo_tpu_torch.runtime.push as tpush
    from dynamo_tpu_torch.multimodal import worker
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

    gif = "data:image/gif;base64," + base64.b64encode(_gif_video()).decode()
    hub = HubServer(port=0)
    await hub.start()
    addr = f"127.0.0.1:{hub.port}"
    args = worker.parse_args(["--hub", addr, "--hidden-size", "64", "--encoder", "vit",
                              "--vit-size", "tiny", "--device", "cpu"])
    task = asyncio.ensure_future(worker._amain(args))
    drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))
    try:
        ep = drt.namespace("dynamo").component("encoder").endpoint("encode")
        router = await PushRouter.from_endpoint(ep, RouterMode.ROUND_ROBIN)
        (inst,) = await router.client.wait_for_instances(1, timeout=30)
        url = "data:image/png;base64," + base64.b64encode(_real_png()).decode()
        (reply,) = [r async for r in router.generate({"images": [url, url]}, tctx.Context())]
        assert reply["shape"] == [8, 64] and reply["tokens_per_image"] == 4
        assert reply["video_frames"] == 8 and reply["dtype"] == "float32"
        rows = np.frombuffer(base64.b64decode(reply["embeds_b64"]), "<f4").reshape(8, 64)
        assert np.array_equal(rows[:4], rows[4:]) and np.isfinite(rows).all()
        (reply,) = [r async for r in router.generate(
            {"images": [{"url": gif, "kind": "video"}]}, tctx.Context())]
        rows = np.frombuffer(base64.b64decode(reply["embeds_b64"]), "<f4").reshape(-1, 4, 64)
        # 3 frames sampled at round(i * 2 / 7): 0 0 1 1 1 1 2 2 (half to even)
        assert rows.shape == (8, 4, 64) and np.isfinite(rows).all()
        assert np.array_equal(rows[0], rows[1]) and np.array_equal(rows[2], rows[5])
        assert not np.array_equal(rows[1], rows[2])
        webp_video = {"url": "data:image/webp;base64," + base64.b64encode(_webp(True)).decode(),
                      "kind": "video"}
        (reply,) = [r async for r in router.generate({"images": [webp_video]}, tctx.Context())]
        rows = np.frombuffer(base64.b64decode(reply["embeds_b64"]), "<f4").reshape(-1, 4, 64)
        assert rows.shape == (8, 4, 64) and np.isfinite(rows).all()
        assert np.array_equal(rows[0], rows[1]) and np.array_equal(rows[2], rows[5])
        assert not np.array_equal(rows[1], rows[2])
        webp = "data:image/webp;base64," + base64.b64encode(_webp(False)).decode()
        (reply,) = [r async for r in router.generate({"images": [webp]}, tctx.Context())]
        assert reply["shape"] == [4, 64]
        assert np.isfinite(np.frombuffer(base64.b64decode(reply["embeds_b64"]), "<f4")).all()
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.open(io.BytesIO(_webp(False))).convert("RGB").save(buf, "BMP")
        bmp = "data:image/bmp;base64," + base64.b64encode(buf.getvalue()).decode()
        for att in ({"url": bmp, "kind": "video"}, bmp):
            (err,) = [r async for r in router.generate({"images": [att]}, tctx.Context())]
            assert err["error"].startswith("image encode failed:") and "item 12b-iii" in err["error"]
        await router.client.close()
    finally:
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        await drt.close()
        await hub.stop()
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.open(io.BytesIO(_gif_video(5))).convert("RGB").save(buf, "JPEG", quality=90)
    images = [{"url": "data:image/gif;base64," + base64.b64encode(_gif_video(5)).decode(),
               "kind": "video"}, "data:image/jpeg;base64," + base64.b64encode(
                   buf.getvalue()).decode(), {"url": gif, "kind": "video"}]
    jdrt, pdrt = JaxRuntime(JaxHub()), DistributedRuntime(InMemoryHub())
    try:
        want = await _encode_rows(jax_launch_encoder, jdrt, jpush, images)
        got = await _encode_rows(launch_encode_worker, pdrt, tpush, images)
    finally:
        await jdrt.close()
        await pdrt.close()
    assert got.shape == (17 * TPI, SPEC_KW["hidden_size"]) and np.array_equal(got, want)
