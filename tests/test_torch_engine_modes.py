"""The port's engine modes against the JAX engine: chunked prefill,
pipelined decode, async and synchronous admissions, seeded sampling and
logprob items (dynamo_tpu_torch/engine/core.py vs dynamo_tpu/engine/core.py).

Both engines get the same weights (the JAX init, bridged through
params_from_numpy) on a peaked f32 tiny spec and the same configuration, so
every stream must be identical token for token: greedy ones, and sampled
ones with a client seed (the samplers share the threefry stream). Logprob
items carry identical ids and values within 1e-4 (f32 logits that differ
by sums in another order). The chunked-prefill tests mirror
tests/test_chunked_prefill.py. The port runs on the CPU (``device="cpu"``),
where decode bursts run the graph runner's step function eagerly.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.context import Context

pytestmark = pytest.mark.unit

LP_TOL = 1e-4
SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=128, max_pages_per_seq=64,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
# input embeddings scaled (tests/test_quant_goldens.py) far enough that no
# greedy token rides on a near-tie, and not so far (32 is) that a
# temperature-0.8 draw always lands on the argmax
EMBED_SCALE = 8.0


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _weights(seed=0):
    jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(seed)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    return jp, params_from_numpy(ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp),
                                 device="cpu")


def _engines(jp, tp, **cfg):
    kw = {**CFG_KW, **cfg}
    return (JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**kw), params=jp),
            InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**kw), params=tp,
                            device="cpu"))


def _req(tokens, n, sampling=None, logprobs=None):
    req = {"token_ids": list(tokens),
           "stop_conditions": {"max_tokens": n, "ignore_eos": True},
           "sampling": sampling or {"temperature": 0.0}}
    if logprobs is not None:
        req["output_options"] = {"logprobs": logprobs}
    return req


async def _collect(eng, req, ctx, sink=None, tag=None):
    items = []
    async for item in eng.generate(req, ctx):
        items.append(item)
        if sink is not None:
            sink.extend([tag] * len(item["token_ids"]))
    return items


def _tokens(items):
    return [t for x in items for t in x["token_ids"]]


def _logprobs(items):
    return [e for x in items for e in x.get("logprobs") or ()]


async def _both(jeng, teng, reqs):
    """Every request on both engines, concurrently within each engine."""
    want = await asyncio.gather(*(_collect(jeng, r, JaxContext()) for r in reqs))
    got = await asyncio.gather(*(_collect(teng, r, Context()) for r in reqs))
    await jeng.close()
    await teng.close()
    return want, got


def _assert_same(want, got):
    for w, g in zip(want, got):
        assert _tokens(g) == _tokens(w)
        assert g[-1]["finish_reason"] == w[-1]["finish_reason"]
        lw, lg = _logprobs(w), _logprobs(g)
        assert len(lg) == len(lw)
        for a, b in zip(lg, lw):
            assert a["id"] == b["id"]
            assert abs(a["logprob"] - b["logprob"]) <= LP_TOL
            assert [t["id"] for t in a["top"]] == [t["id"] for t in b["top"]]
            for ta, tb in zip(a["top"], b["top"]):
                assert abs(ta["logprob"] - tb["logprob"]) <= LP_TOL


MODES = {
    "sync-admissions": dict(async_admissions=False),
    "burst4-sync": dict(decode_steps_per_dispatch=4, async_admissions=False),
    "burst4-async": dict(decode_steps_per_dispatch=4),
    "pipelined-burst1": dict(pipeline_decode=True, pipeline_depth=2),
    "pipelined-burst4": dict(pipeline_decode=True, pipeline_depth=2,
                             decode_steps_per_dispatch=4),
    "pipelined-burst4-sync": dict(pipeline_decode=True, pipeline_depth=2,
                                  decode_steps_per_dispatch=4, async_admissions=False),
}


@pytest.mark.parametrize("mode", list(MODES))
async def test_engine_modes_match_jax_engine(mode):
    """Seven requests over four slots (slots are reused while bursts are
    in flight): greedy, seeded temperature-0.8 (one with top-k, one with
    top-p), and logprob requests (greedy and sampled); streams identical
    to the JAX engine's in the same mode."""
    jp, tp = _weights(seed=3)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 128, n).tolist() for n in (5, 13, 9, 22, 3, 17, 11)]
    reqs = [
        _req(prompts[0], 9),
        _req(prompts[1], 12, {"temperature": 0.8, "seed": 11}),
        _req(prompts[2], 7, {"temperature": 0.8, "top_k": 4, "seed": 2**32 - 5}),
        _req(prompts[3], 10, logprobs=5),
        _req(prompts[4], 6, {"temperature": 0.8, "top_p": 0.9, "seed": 99}),
        _req(prompts[5], 11, {"temperature": 0.8, "seed": 5}, logprobs=3),
        _req(prompts[6], 1),
    ]
    jeng, teng = _engines(jp, tp, **MODES[mode])
    want, got = await _both(jeng, teng, reqs)
    _assert_same(want, got)
    assert all(len(_tokens(g)) == r["stop_conditions"]["max_tokens"]
               for g, r in zip(got, reqs))
    assert len(_logprobs(got[3])) == 10 and len(_logprobs(got[3])[0]["top"]) == 5
    assert len(_logprobs(got[5])[0]["top"]) == 3 and not _logprobs(got[0])
    assert teng.allocator.active_pages == 0 and all(s is None for s in teng._slots)


async def test_seeded_sampling_reproduces_and_moves_with_seed():
    """A seeded sampled stream leaves the greedy one, repeats whatever
    shares the batch, and another seed gives another stream."""
    _, tp = _weights(seed=4)
    eng = InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW), params=tp,
                          device="cpu")
    prompt = [9, 8, 7, 6, 5]
    hot = {"temperature": 0.8, "seed": 1234}
    alone = _tokens(await _collect(eng, _req(prompt, 16, hot), Context()))
    greedy = _tokens(await _collect(eng, _req(prompt, 16), Context()))
    assert sum(a != b for a, b in zip(alone, greedy)) >= 4
    crowd = await asyncio.gather(
        _collect(eng, _req(prompt, 16, hot), Context()),
        *(_collect(eng, _req([i, i + 1], 12, {"temperature": 0.8}), Context())
          for i in range(3)))
    other = _tokens(await _collect(eng, _req(prompt, 16, {**hot, "seed": 4321}),
                                   Context()))
    await eng.close()
    assert _tokens(crowd[0]) == alone
    assert other != alone


@pytest.mark.parametrize("mode", ["burst4-async", "pipelined-burst4"])
async def test_cancel_mid_stream_releases_pages(mode):
    """A stream cancelled while its bursts are in flight ends
    "cancelled" (the pipeline is flushed first), its neighbour runs on
    untouched, and every page comes back."""
    _, tp = _weights(seed=8)
    eng = InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW, **MODES[mode]),
                          params=tp, device="cpu")
    ref = await _collect(eng, _req([4, 5, 6], 24), Context())
    ctx = Context()
    got: list[dict] = []

    async def cancelled():
        async for item in eng.generate(_req([1, 2, 3], 10_000), ctx):
            got.append(item)
            if len(_tokens(got)) >= 6:
                ctx.stop_generating()

    other = asyncio.ensure_future(_collect(eng, _req([4, 5, 6], 24), Context()))
    await asyncio.wait_for(cancelled(), 60)
    assert got[-1]["finish_reason"] == "cancelled"
    assert _tokens(await other) == _tokens(ref)
    await eng.close()
    assert eng.allocator.active_pages == 0 and not eng._pipeline
    assert all(s is None for s in eng._slots)


@pytest.mark.parametrize("pipelined", [False, True])
async def test_chunked_prefill_matches_jax_engine(pipelined):
    """A 200-token prompt prefills in chunks of 64 (four steps) beside a
    decoding stream; streams equal the JAX engine's, and the chunked
    prompt's sealed pages then serve a repeat from the prefix cache."""
    jp, tp = _weights(seed=5)
    rng = np.random.default_rng(1)
    long_prompt = rng.integers(0, 128, 200).tolist()
    reqs = [_req([3, 1, 4, 1, 5], 20), _req(long_prompt, 8),
            _req(long_prompt[:150], 6, {"temperature": 0.8, "seed": 8})]
    cfg = dict(max_prefill_chunk_tokens=64, pipeline_decode=pipelined)
    jeng, teng = _engines(jp, tp, **cfg)
    want, got = await _both(jeng, teng, reqs)
    _assert_same(want, got)
    assert teng.allocator.active_pages == 0
    # the one-shot engine (a bucket that holds the prompt) agrees, and a
    # repeat of the chunked prompt rides the prefix cache
    one_shot = InferenceEngine(
        ModelSpec(**SPEC_KW),
        EngineConfig(**{**CFG_KW, "prefill_buckets": (8, 16, 32, 64, 256)},
                     max_prefill_chunk_tokens=256),
        params=tp, device="cpu")
    ref = await _collect(one_shot, reqs[1], Context())
    await one_shot.close()
    assert _tokens(ref) == _tokens(got[1])
    teng2 = InferenceEngine(ModelSpec(**SPEC_KW),
                            EngineConfig(**CFG_KW, **cfg), params=tp, device="cpu")
    first = await _collect(teng2, reqs[1], Context())
    again = await _collect(teng2, reqs[1], Context())
    await teng2.close()
    assert _tokens(first) == _tokens(again) == _tokens(ref)
    assert teng2.cached_prompt_tokens == 196  # 49 whole pages of the 200


async def test_decode_progress_during_long_prefill():
    """While a 256-token prompt prefills in 64-token chunks, an already-
    decoding stream keeps emitting instead of stalling for the whole
    admission."""
    _, tp = _weights(seed=6)
    eng = InferenceEngine(ModelSpec(**SPEC_KW),
                          EngineConfig(**CFG_KW, max_prefill_chunk_tokens=64),
                          params=tp, device="cpu")
    order: list[str] = []
    a = asyncio.ensure_future(_collect(eng, _req([5, 9, 13], 40), Context(),
                                       sink=order, tag="A"))
    while order.count("A") < 4:
        await asyncio.sleep(0.01)
    long_prompt = list(np.arange(250) % 120 + 3)
    b = asyncio.ensure_future(_collect(eng, _req(long_prompt, 4), Context(),
                                       sink=order, tag="B"))
    out_a, out_b = await asyncio.gather(a, b)
    await eng.close()
    assert len(_tokens(out_a)) == 40 and len(_tokens(out_b)) == 4
    # B's prefill spans 4 chunk steps; each interleaves a decode step
    first_b = order.index("B")
    window = order[max(0, first_b - 6): first_b]
    assert window.count("A") >= 2, order


async def test_chunked_prefill_cancel_mid_flight():
    """Cancelling during a chunked prefill reports cancelled and releases
    every page."""
    _, tp = _weights(seed=7)
    eng = InferenceEngine(ModelSpec(**SPEC_KW),
                          EngineConfig(**CFG_KW, max_prefill_chunk_tokens=16),
                          params=tp, device="cpu")
    ctx = Context()
    started = asyncio.Event()
    orig = eng._run_prefill_chunk

    def chunk(*a, **kw):  # signal once the first chunk has run
        out = orig(*a, **kw)
        eng._loop.call_soon_threadsafe(started.set)
        return out

    eng._run_prefill_chunk = chunk
    task = asyncio.ensure_future(_collect(eng, _req(list(np.arange(240) % 120 + 3), 8),
                                          ctx))
    await started.wait()
    ctx.stop_generating()
    items = await task
    assert items[-1]["finish_reason"] == "cancelled"
    for _ in range(200):
        if eng.allocator.active_pages == 0:
            break
        await asyncio.sleep(0.01)
    assert eng.allocator.active_pages == 0 and eng._partial is None
    await eng.close()
