"""Routed experts in the port (dynamo_tpu_torch/models/moe.py and the MoE
paths of models/llama.py, engine/core.py and engine/graphs.py) against the
JAX package.

Shared numpy inputs go through the reference's ``moe_mlp`` and the port's:
the same experts per token, exactly the same dropped slots, outputs within
1e-5 (f32), for both scorings (softmax top-k with renormalisation, and
DeepSeek's sigmoid with its correction bias and group-limited top-k), with
gpt-oss's biases and clamped swiglu, a skewed router that forces drops and
routers whose scores tie. Then ``tiny_moe`` and ``tiny_gpt_oss`` run
through both engines on the same weights and prompts, a padded packed
prefill included: greedy streams equal, the same dropped-slot totals, and
prefill / verify logits within 1e-4. The decode graph runner's MoE step
(its eager route on the CPU, the step a CUDA graph captures) must equal
``decode_steps`` exactly, and ``decode_steps`` the reference's.
"""

import asyncio
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import moe as jmoe
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.graphs import DecodeGraphs
from dynamo_tpu_torch.models import llama, moe
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.family import get_family
from dynamo_tpu_torch.models.llama import LlamaLayer
from dynamo_tpu_torch.runtime.context import Context

pytestmark = pytest.mark.unit

OUT_TOL = 1e-5  # moe_mlp outputs in f32: sums in another order
LOGIT_TOL = 1e-4
CFG_KW = dict(page_size=4, num_pages=160, max_pages_per_seq=16,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
SIGMOID_KW = dict(name="tiny-sigmoid", vocab_size=96, hidden_size=32,
                  intermediate_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                  head_dim=8, dtype="float32", num_experts=8,
                  num_experts_per_token=2, moe_intermediate_size=16,
                  moe_scoring="sigmoid", n_group=4, topk_group=2,
                  routed_scaling_factor=2.5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _specs(name: str):
    if name == "sigmoid":
        return JaxSpec(**SIGMOID_KW), ModelSpec(**SIGMOID_KW)
    return getattr(JaxSpec, name)(), getattr(ModelSpec, name)()


def _layer(jspec, seed: int, router: str = "random") -> dict[str, np.ndarray]:
    """One MoE layer's numpy leaves: the reference's init keys, every leaf
    redrawn from numpy so biases and score biases are not zero. ``router``
    "skewed" boosts expert 0 (drops), "tied" zeroes it (every score ties)."""
    lp = jmoe.init_moe_layer(jspec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in lp.items():
        scale = 0.3 if k in ("router", "router_bias", "score_bias") else 0.2
        out[k] = (rng.standard_normal(np.shape(v)) * scale).astype(np.float32)
    if router == "skewed":
        out["router"][:, 0] += 1.0
    elif router == "tied":
        out["router"][:] = 0.0
        for k in ("router_bias", "score_bias"):
            if k in out:
                out[k][:] = 0.0
    return out


def _jax_selection(spec, lp, x):
    """The reference's routing lines (dynamo_tpu/models/moe.py moe_mlp):
    the experts each token picks, [T, k]."""
    logits = x @ lp["router"]
    if "router_bias" in lp:
        logits = logits + lp["router_bias"]
    E, k, T = spec.num_experts, spec.num_experts_per_token, x.shape[0]
    if spec.moe_scoring == "sigmoid":
        choice = jax.nn.sigmoid(logits) + lp["score_bias"]
        if spec.n_group > 1:
            gsz = E // spec.n_group
            gs = jax.lax.top_k(choice.reshape(T, spec.n_group, gsz), 2)[0].sum(-1)
            gidx = jax.lax.top_k(gs, spec.topk_group)[1]
            gmask = jax.nn.one_hot(gidx, spec.n_group).sum(axis=1)
            choice = jnp.where(jnp.repeat(gmask, gsz, axis=-1) > 0, choice, 0.0)
        return np.asarray(jax.lax.top_k(choice, k)[1])
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)[1])


@pytest.mark.parametrize("router", ["random", "skewed", "tied"])
@pytest.mark.parametrize("name", ["tiny_moe", "tiny_gpt_oss", "sigmoid"])
def test_moe_mlp_matches_jax(name, router):
    jspec, tspec = _specs(name)
    lp = _layer(jspec, seed=len(name) + len(router), router=router)
    # a mean of 0.3: the skewed router's column 0 wins for most tokens
    x = (np.random.default_rng(1).standard_normal((48, jspec.hidden_size))
         + 0.3).astype(np.float32)
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    want, want_drop = jmoe.moe_mlp(jspec, jlp, jnp.asarray(x), return_dropped=True)
    tlp = LlamaLayer({k: torch.from_numpy(v) for k, v in lp.items()})
    got, got_drop = moe.moe_mlp(tspec, tlp, torch.from_numpy(x), return_dropped=True)
    _w, topi = moe.route(tspec, tlp, torch.from_numpy(x))
    np.testing.assert_array_equal(topi.numpy(), _jax_selection(jspec, jlp, jnp.asarray(x)))
    assert got_drop.dtype == torch.int32 and got_drop.shape == ()
    assert int(got_drop) == int(want_drop)
    if router == "skewed":
        assert int(got_drop) > 0
    if router == "tied":  # every score equal: the lowest ids, as jax.lax.top_k
        assert (topi == torch.arange(tspec.num_experts_per_token)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=OUT_TOL)


def test_moe_mlp_bf16_keeps_router_f32():
    """In a bf16 spec the router still routes in f32 (bf16 logits would pick
    other experts), and the output comes back in bf16."""
    spec = dataclasses.replace(ModelSpec.tiny_moe(), dtype="bfloat16")
    p = llama.init_params(spec, 3, device="cpu")
    lp = p.layers[0].moe
    assert lp.router.dtype == torch.float32 and lp.w_gate.dtype == torch.bfloat16
    # the stacked [E, d, f] weights draw at fan-in shape[-2] = d
    assert abs(lp.w_gate.float().std().item() * spec.hidden_size ** 0.5 - 1.0) < 0.1
    x = torch.randn(20, spec.hidden_size, generator=torch.Generator().manual_seed(0))
    out, dropped = moe.moe_mlp(spec, lp, x.to(torch.bfloat16), return_dropped=True)
    assert out.dtype == torch.bfloat16 and int(dropped) == 0


@pytest.mark.parametrize("T", [1, 8, 16, 17, 64, 4096])
def test_expert_capacity_matches_reference(T):
    for E, k in ((4, 2), (8, 2), (128, 4), (256, 8)):
        assert moe.expert_capacity(T, E, k) == jmoe.expert_capacity(T, E, k)


def test_get_family_admits_experts_and_refuses_mla():
    assert get_family(ModelSpec.tiny_gpt_oss()) is not None
    with pytest.raises(NotImplementedError, match="item 9"):
        get_family(ModelSpec.deepseek_r1())


# ------------------------------------------------------------ whole models


def _weights(name: str, seed: int = 0, skew: float = 0.0):
    """Both packages' params on the same weights: the reference's init,
    input embeddings scaled by 4 (peaked logits: greedy streams do not sit
    on near-ties), biases and sinks drawn non-zero, the routers' column 0
    raised by ``skew`` (drops)."""
    jspec, tspec = _specs(name)
    jp = jax.tree.map(np.asarray, jllama.init_params(jspec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    jp["embed"] = jp["embed"] * 4.0
    for lp in jp["layers"]:
        for k in ("bq", "bk", "bv", "bo", "sinks"):
            if k in lp:
                lp[k] = (rng.standard_normal(lp[k].shape) * 0.2).astype(np.float32)
        m = lp["moe"]
        for k in ("router_bias", "b_gate", "b_up", "b_down"):
            if k in m:
                m[k] = (rng.standard_normal(m[k].shape) * 0.2).astype(np.float32)
        m["router"] = m["router"] * 20.0
        m["router"][:, 0] += skew
    return jspec, tspec, jp, params_from_numpy(tspec, jp, device="cpu")


@pytest.mark.parametrize("name", ["tiny_moe", "tiny_gpt_oss"])
def test_packed_prefill_and_verify_match_jax(name):
    """A packed prefill of 4 rows of 16 (one behind a cached page, one
    padded row of token 0) and a verify over the same pools: the last
    logits within 1e-4, the verify's targets equal, and each forward's
    dropped-slot count equal to the reference's."""
    jspec, tspec, jp, tp = _weights(name, seed=3, skew=2.0)
    jk, jv = jllama.init_cache(jspec, 40, 4, dtype="float32")
    tk, tv = llama.init_cache(tspec, 40, 4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    N, T, P = 4, 16, 8
    lens, starts = [13, 16, 9, 0], [0, 0, 4, 0]
    tokens = np.zeros((N, T), np.int32)
    bts = np.zeros((N, P), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, tspec.vocab_size, n)
        if n:
            bts[i, :5] = np.arange(1 + 5 * i, 6 + 5 * i)
    want, jk, jv, wdrop = jllama.prefill_forward_batch(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts), jnp.asarray(starts, jnp.int32),
        jk, jv, jnp.asarray(lens, jnp.int32))
    got, gdrop = llama.prefill_forward_batch(
        tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts), torch.tensor(starts),
        tk, tv, torch.tensor(lens))
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert int(gdrop) == int(wdrop) > 0

    W = 3
    vt = np.stack([rng.integers(1, tspec.vocab_size, N) for _ in range(W)], 1)
    vt = vt.astype(np.int32)
    vstart = np.asarray([n + s for n, s in zip(lens, starts)], np.int32)
    vn = np.asarray([3, 2, 3, 0], np.int32)
    wt, jk, jv, wdrop = jllama.verify_forward(
        jspec, jp, jnp.asarray(vt), jnp.asarray(bts), jnp.asarray(vstart), jk, jv,
        jnp.asarray(vn))
    gt, gdrop = llama.verify_forward(tspec, tp, *(torch.from_numpy(a) for a in
                                                  (vt, bts, vstart)), tk, tv,
                                     torch.from_numpy(vn))
    for r, n in enumerate(vn):
        assert gt[r, :n].tolist() == np.asarray(wt)[r, :n].tolist()
    assert int(gdrop) == int(wdrop)


@pytest.mark.parametrize("name", ["tiny_moe", "tiny_gpt_oss"])
def test_reference_forward_matches_jax(name):
    jspec, tspec, jp, tp = _weights(name, seed=4)
    tokens = np.random.default_rng(0).integers(0, tspec.vocab_size, 21).astype(np.int32)
    want = jllama.reference_forward(jspec, jp, jnp.asarray(tokens))
    got = llama.reference_forward(tspec, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


class _Gate:
    """Parks an engine's step thread at its next admission pass, so every
    arrival meets one admission decision (the same packed groups, whose
    rows the experts route together) in both packages."""

    def __init__(self, eng):
        self.open, self.parked = threading.Event(), threading.Event()
        admit = eng._admit_phase

        def gated():
            if not self.open.is_set():
                self.parked.set()
                self.open.wait(60.0)
            return admit()

        eng._admit_phase = gated


async def _until(cond, n=3000):
    for _ in range(n):
        if cond():
            return True
        await asyncio.sleep(0.01)
    return False


class _Meter:
    def __init__(self):
        self.seen = []

    def publish(self, m):
        self.seen.append(m)

    async def close(self):
        pass


async def _serve(eng, ctx_cls, prompts, n):
    gate = _Gate(eng)
    await eng.start()
    assert await _until(gate.parked.is_set)
    tasks = [asyncio.create_task(_collect(eng, _req(p, n), ctx_cls())) for p in prompts]
    assert await _until(lambda: eng._waiting.qsize() == len(prompts))
    gate.open.set()
    outs = await asyncio.gather(*tasks)
    total = int(eng._moe_dropped_dev)
    # the 64-publish duty cycle's fetch, forced
    eng._metrics_publishes = 0
    eng._publish_metrics()
    published = eng.metrics.seen[-1].moe_dropped_slots
    await eng.close()
    return [[t for x in o for t in x["token_ids"]] for o in outs], total, published


def _req(tokens, n):
    return {"token_ids": list(tokens),
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}}


async def _collect(eng, req, ctx):
    return [x async for x in eng.generate(req, ctx)]


@pytest.mark.parametrize("name", ["tiny_moe", "tiny_gpt_oss"])
async def test_engine_streams_and_drops_match_jax(name):
    """Six prompts admitted at once (packed prefills: two groups of two
    padded to the pack size of 4, one single prefill, one chunked prompt)
    then decoded: greedy streams equal the JAX engine's, and so do the
    dropped-slot totals and the published ``moe_dropped_slots``."""
    jspec, tspec, jp, tp = _weights(name, seed=6, skew=2.0)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, tspec.vocab_size, n).tolist()
               for n in (5, 7, 13, 14, 30, 40)]
    kw = dict(CFG_KW, prefill_pack_size=4, max_prefill_chunk_tokens=32)
    jeng = JaxEngine(jspec, JaxEngineConfig(**kw), params=jax.tree.map(jnp.asarray, jp),
                     metrics_publisher=_Meter())
    teng = InferenceEngine(tspec, EngineConfig(**kw), params=tp, device="cpu",
                           metrics_publisher=_Meter())
    want = await _serve(jeng, JaxContext, prompts, 6)
    got = await _serve(teng, Context, prompts, 6)
    assert got[0] == want[0]
    assert all(len(s) == 6 for s in got[0])
    assert got[1] == want[1] > 0
    assert got[2] == want[2] == got[1]
    assert teng.allocator.active_pages == 0


# ------------------------------------------------------------ decode step


def _decode_setup(name="tiny_gpt_oss"):
    jspec, tspec, jp, tp = _weights(name, seed=7)
    B, P = 4, 8
    jk, jv = jllama.init_cache(jspec, 33, 4, dtype="float32")
    tk, tv = llama.init_cache(tspec, 33, 4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    lens = [5, 3, 2, 7]
    tokens = np.zeros((B, 8), np.int32)
    bts = np.zeros((B, P), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, tspec.vocab_size, n)
        bts[i, :4] = np.arange(1 + 4 * i, 5 + 4 * i)
    logits, jk, jv, _ = jllama.prefill_forward_batch(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts), jnp.zeros((B,), jnp.int32),
        jk, jv, jnp.asarray(lens, jnp.int32))
    llama.prefill_forward_batch(tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts),
                                torch.zeros(B, dtype=torch.int64), tk, tv, torch.tensor(lens))
    first = np.asarray(logits).argmax(-1).astype(np.int32)
    s = dict(active=np.asarray([True, True, False, True]),
             temperature=np.asarray([0.0, 0.8, 0.0, 0.0], np.float32),
             top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
             seeds=np.asarray([1, 2, 3, 4], np.uint32), steps=np.ones(B, np.int32))
    seq_lens = np.asarray(lens, np.int32) + 1
    return (jspec, jp, jk, jv), (tspec, tp, tk, tv), bts, first, seq_lens, s


def _port_sampling(s):
    return (torch.from_numpy(s["active"]), torch.from_numpy(s["temperature"]),
            torch.from_numpy(s["top_k"]), torch.from_numpy(s["top_p"]),
            torch.from_numpy(s["seeds"].astype(np.int64)), torch.from_numpy(s["steps"]))


def test_moe_decode_steps_match_jax():
    """Three MoE decode steps (greedy, a seeded sampled row, an inactive
    row) with logprobs: tokens identical to the reference's decode_steps,
    logprobs within 1e-4."""
    (jspec, jp, jk, jv), (tspec, tp, tk, tv), bts, first, seq_lens, s = _decode_setup()
    want = jax.jit(lambda *a: jllama.decode_steps_impl(jspec, *a, n_steps=3, n_logprobs=4))(
        jp, jnp.asarray(first), jnp.asarray(bts), jnp.asarray(seq_lens), jk, jv,
        *(jnp.asarray(s[k]) for k in ("active", "temperature", "top_k", "top_p",
                                      "seeds", "steps")))
    got = llama.decode_steps(tspec, tp, torch.from_numpy(first), torch.from_numpy(bts),
                             torch.from_numpy(seq_lens), tk, tv, *_port_sampling(s),
                             n_steps=3, n_logprobs=4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    act = s["active"]
    np.testing.assert_allclose(got[1].numpy()[act], np.asarray(want[1])[act],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_moe_graph_step_equals_eager_decode_steps():
    """The decode graph runner's MoE step (static tensors, fixed shapes:
    the function a CUDA graph captures; run eagerly on the CPU) gives
    decode_steps' tokens, logprobs and pool bytes exactly."""
    _, (tspec, tp, tk, tv), bts, first, seq_lens, s = _decode_setup()
    k2, v2 = tk.clone(), tv.clone()
    want = llama.decode_steps(tspec, tp, torch.from_numpy(first), torch.from_numpy(bts),
                              torch.from_numpy(seq_lens), k2, v2, *_port_sampling(s),
                              n_steps=3, n_logprobs=4)

    def step(t, sampled, n_lp):
        llama.decode_step_(tspec, tp, tk, tv, t, sampled=sampled, n_logprobs=n_lp)

    g = DecodeGraphs(step, batch=4, pages_per_seq=bts.shape[1], max_steps=4,
                     n_logprobs=4, device=torch.device("cpu"))
    burst = g.dispatch({"tokens": first, "block_tables": bts, "seq_lens": seq_lens, **s},
                       3, sampled=True, n_logprobs=4)
    fed, toks, lp, ti, tvals = burst.result()
    np.testing.assert_array_equal(toks, want[0].numpy())
    for a, b in zip((lp, ti, tvals), want[1:]):
        np.testing.assert_array_equal(a, b.numpy())
    assert torch.equal(tk, k2) and torch.equal(tv, v2)
