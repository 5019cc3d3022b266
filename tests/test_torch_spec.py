"""Speculative decoding in the port (dynamo_tpu_torch/engine/spec.py,
models/llama.py verify_forward, engine/graphs.py VerifyGraphs and the
engine's _spec_phase) against the JAX package's.

- The drafter and the adaptive-k state follow the reference's trajectories
  on the same histories.
- ``verify_forward`` against JAX ``llama.verify_forward`` (its XLA route on
  the CPU) on the same weights and the same pool bytes: targets equal at
  every valid position; every KV row lands where the reference's write puts
  it, bitwise (the port's rows placed by the reference's own
  ``write_new_kv``, fp8 values and scales included); f32 pools and logits
  within 1e-4 (logits against the reference's unpaged forward). Rows start
  mid-page, share pages, stop short of the width, are padded (0 tokens) or
  reach past the block table.
- The port's engine streams the same greedy tokens with spec on and off,
  on a peaked tiny spec (input embeddings scaled, so no argmax rides on a
  near-tie between the verify's and the decode step's sums).
"""

import asyncio
import functools
import json
import os
import queue
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import spec as jspec_mod
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops.pallas.kv_write import write_new_kv
from dynamo_tpu.ops.quant import QuantPool as JaxQuantPool
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.tokens import TokenBlockSequence as JaxTokenBlockSequence
from dynamo_tpu_torch.engine import spec as tspec_mod
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.graphs import VerifyGraphs, verify_row_counts
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.ops.cuda import kv_write as kv_write_mod
from dynamo_tpu_torch.ops.quant import QuantPool
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.tokens import TokenBlockSequence

pytestmark = pytest.mark.unit

jax_write_new_kv = jax.jit(write_new_kv, static_argnames=("layer",))

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
EMBED_SCALE = 32.0  # peaked logits (tests/test_quant_goldens.py)
# the verify-parity spec and pools: 4 rows of width 5 over 8 pages of 4
V_KW = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=8, dtype="float32")
# bias, sinks, alternating sliding windows and YaRN on the same widths
EXTRAS_KW = dict(V_KW, attn_bias=True, attn_sinks=True, sliding_window=3,
                 layer_types=("sliding_attention", "full_attention"),
                 rope_scaling_factor=32.0, rope_orig_max_pos=4096,
                 rope_truncate=False, rope_theta=150000.0)
PAGE, P, NUM_PAGES, W = 4, 8, 17, 5
# rows: prompt length (the verify's start), valid tokens, pages
ROWS = ((3, 5, [1, 2]),  # mid-page start, siblings on page 2
        (6, 2, [3, 4, 5]),  # fewer tokens than the width
        (29, 3, list(range(6, 14))),  # positions 32, 33 past the table
        (0, 0, []))  # padded row
# the engine spec (the reference's tests/test_spec_decode.py TINY_GQA) and
# its embedding scale: peaked enough that spec on and off agree (at 8
# most greedy streams collapse into a one-token loop)
E_KW = dict(vocab_size=272, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=8, dtype="float32")
E_SCALE = 4.0


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- drafter


def _histories():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 9, 12).tolist()
    return [(base * 4)[:40], rng.integers(0, 6, 60).tolist(),
            rng.integers(0, 1000, 30).tolist()]


@pytest.mark.parametrize("ngrams", [(1, 4), (2, 3), (1, 1)])
def test_drafter_proposals_match_reference(ngrams):
    """After every token of each history, propose(k) for k in 0..6 equals
    the reference drafter's."""
    for hist in _histories():
        t = tspec_mod.PromptLookupDrafter(*ngrams)
        j = jspec_mod.PromptLookupDrafter(*ngrams)
        for tok in hist:
            t.extend([tok])
            j.extend([tok])
            for k in range(7):
                assert t.propose(k) == j.propose(k)
        assert t.tokens == j.tokens


def test_slot_spec_trajectory_matches_reference():
    """The same seeded sequence of observe / on_tokens / disable calls moves
    k, active, ewma and cooldown as the reference's SlotSpec."""
    cfg_t = EngineConfig(spec_mode="ngram", spec_k_max=6, spec_reprobe_tokens=10)
    cfg_j = JaxEngineConfig(spec_mode="ngram", spec_k_max=6, spec_reprobe_tokens=10)
    t, j = tspec_mod.SlotSpec.for_config(cfg_t), jspec_mod.SlotSpec.for_config(cfg_j)
    rng = np.random.default_rng(5)
    for step in range(300):
        op = rng.integers(0, 10)
        if op < 6:
            d = int(rng.integers(0, 7))
            a = int(rng.integers(0, d + 1))
            t.observe(d, a)
            j.observe(d, a)
        elif op < 9:
            n = int(rng.integers(1, 5))
            t.on_tokens(n)
            j.on_tokens(n)
        elif step > 250:
            t.disable()
            j.disable()
        assert (t.k, t.active, t.ewma, t.cooldown, t.disabled, t.drafted,
                t.accepted) == (j.k, j.active, j.ewma, j.cooldown, j.disabled,
                                j.drafted, j.accepted)


def test_sync_from_seq_and_spec_tokens_surface():
    """sync_from_seq catches the drafter up block by block as the
    reference's; SPEC_TOKENS is the reference's counter by name and
    labels; __all__ is the reference's."""
    hist = _histories()[1]
    t = tspec_mod.SlotSpec.for_config(EngineConfig(spec_mode="ngram"))
    j = jspec_mod.SlotSpec.for_config(JaxEngineConfig(spec_mode="ngram"))
    tseq = TokenBlockSequence.from_tokens(hist[:7], 4)
    jseq = JaxTokenBlockSequence.from_tokens(hist[:7], 4)
    for tok in hist[7:]:
        tseq.append(tok)
        jseq.append(tok)
        if tok % 3 == 0:
            t.sync_from_seq(tseq)
            j.sync_from_seq(jseq)
            assert t.drafter.tokens == j.drafter.tokens
            assert t.propose(5) == j.propose(5)
    assert tspec_mod.__all__ == jspec_mod.__all__
    counter = tspec_mod.SPEC_TOKENS
    assert (counter.kind, counter.name, counter.labelnames) == (
        "counter", "dynamo_spec_tokens", ("outcome",))


# ------------------------------------------------------------- verify


def _verify_models(extras: bool, dtype: str):
    kw = dict(EXTRAS_KW if extras else V_KW, dtype=dtype)
    jspec, tspec = JaxSpec(**kw), ModelSpec(**kw)
    jp = dict(jllama.init_params(jspec, jax.random.PRNGKey(7 if extras else 3)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    if extras:
        # the reference inits biases and sinks to zero: give them values
        rng = np.random.default_rng(2)
        layers = []
        for lp in jp["layers"]:
            lp = dict(lp)
            for name in ("bq", "bk", "bv", "bo", "sinks"):
                lp[name] = jnp.asarray(
                    rng.standard_normal(lp[name].shape) * 0.5, lp[name].dtype)
            layers.append(lp)
        jp["layers"] = layers
    return tspec, jspec, jp, params_from_numpy(tspec, jax.tree.map(np.asarray, jp),
                                               device="cpu")


def _rows(seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    N = len(ROWS)
    tokens = np.zeros((N, W), np.int32)
    bts = np.zeros((N, P), np.int32)
    starts = np.zeros((N,), np.int32)
    nts = np.zeros((N,), np.int32)
    prompts = []
    for r, (start, n, pages) in enumerate(ROWS):
        tokens[r, :n] = rng.integers(0, vocab, n)
        bts[r, : len(pages)] = pages
        starts[r], nts[r] = start, n
        prompts.append(rng.integers(0, vocab, start).tolist())
    return tokens, bts, starts, nts, prompts


def _to_jax_pool(tpool):
    """The reference's form of a port pool, with the same bytes."""
    if isinstance(tpool, QuantPool):
        return JaxQuantPool(
            jnp.asarray(tpool.vals.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn),
            jnp.asarray(tpool.scale.view(torch.int16).numpy()).view(jnp.bfloat16))
    if tpool.dtype == torch.bfloat16:
        return jnp.asarray(tpool.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(tpool.numpy().copy())


def _pool_bytes(pool) -> list[np.ndarray]:
    """Every byte of a pool of either package, page 0 dropped."""
    if isinstance(pool, (QuantPool, JaxQuantPool)):
        parts = (pool.vals, pool.scale)
    else:
        parts = (pool,)
    out = []
    for a in parts:
        if isinstance(a, torch.Tensor):
            a = a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a
            a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
            a = a.numpy()
        else:
            a = np.asarray(a)
        out.append(np.ascontiguousarray(a[:, 1:]).view(np.uint8))
    return out


def _jax_placement(starts, nts):
    """The reference verify's write indices, computed as it does (JAX ops)."""
    idx = jnp.arange(W)
    positions = jnp.asarray(starts)[:, None] + idx[None, :]
    valid = idx[None, :] < jnp.asarray(nts)[:, None]
    return positions, valid


def _prefilled(tspec, tp, kv_dtype, prompts, bts):
    """The port's pools after prefilling each row's prompt (start 0), and
    the reference's pools holding the same bytes."""
    tk, tv = llama.init_cache(tspec, NUM_PAGES, PAGE, device="cpu", kv_dtype=kv_dtype)
    for r, prompt in enumerate(prompts):
        if not prompt:
            continue
        T = 8 if len(prompt) <= 8 else 32
        padded = np.zeros((T,), np.int32)
        padded[: len(prompt)] = prompt
        llama.prefill_forward(tspec, tp, torch.from_numpy(padded),
                              torch.from_numpy(bts[r]), 0, tk, tv, len(prompt))
    return (_to_jax_pool(tk), _to_jax_pool(tv)), (tk, tv)


@pytest.mark.parametrize("extras", [False, True], ids=["peaked", "bias-sinks-window"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "fp8"])
def test_verify_forward_matches_reference(extras, kv, monkeypatch):
    dtype = "bfloat16" if kv == "bf16" else "float32"
    kv_dtype = "fp8" if kv == "fp8" else "bf16"
    tspec, jspec, jp, tp = _verify_models(extras, dtype)
    tokens, bts, starts, nts, prompts = _rows(1 + extras, tspec.vocab_size)
    (jk, jv), (tk, tv) = _prefilled(tspec, tp, kv_dtype, prompts, bts)
    # the reference's verify donates its pools: keep a copy of the bytes
    jk0, jv0 = jax.tree.map(jnp.copy, jk), jax.tree.map(jnp.copy, jv)

    want, jk, jv, _ = jllama.verify_forward(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts), jnp.asarray(starts),
        jk, jv, jnp.asarray(nts))
    writes = []
    real = kv_write_mod.kv_write

    def spy(k_pages, v_pages, k_new, v_new, dst_page, dst_off, *, layer):
        writes.append((layer, k_new.clone(), v_new.clone(), dst_page.clone(),
                       dst_off.clone()))
        return real(k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer=layer)

    monkeypatch.setattr(kv_write_mod, "kv_write", spy)
    logits = llama.verify_logits(
        tspec, tp, *(torch.from_numpy(a) for a in (tokens, bts, starts)), tk, tv,
        torch.from_numpy(nts))
    got = torch.argmax(logits, dim=-1).numpy()
    want = np.asarray(want)
    for r, n in enumerate(nts):
        assert got[r, :n].tolist() == want[r, :n].tolist(), r

    # token-granular writes: one kv_write of all N x W rows per layer, on
    # either pool type
    assert [w[0] for w in writes] == list(range(tspec.num_layers))
    positions, valid = _jax_placement(starts, nts)
    pg = jnp.take_along_axis(jnp.asarray(bts), positions // PAGE, axis=1)
    pg = jnp.where(valid, pg, 0)
    offs = positions % PAGE
    # the reference's write, on the port's rows, from the same pool bytes
    for li, kn, vn, dp, do in writes:
        np.testing.assert_array_equal(dp.numpy(), np.asarray(pg.reshape(-1)))
        np.testing.assert_array_equal(do.numpy(), np.asarray(offs.reshape(-1)))
        jn = [jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32) for x in (kn, vn)]
        if kv == "fp8":
            # the reference's verify lands an fp8 pool's rows one position
            # per call (dynamo_tpu/models/llama.py verify_forward)
            jn = [x.reshape(len(nts), W, *x.shape[1:]) for x in jn]
            for w in range(W):
                jk0, jv0 = jax_write_new_kv(jk0, jv0, jn[0][:, w], jn[1][:, w],
                                            pg[:, w], offs[:, w], layer=li)
        else:
            jk0, jv0 = jax_write_new_kv(jk0, jv0, *jn, pg.reshape(-1), offs.reshape(-1),
                                        layer=li)
    for t_pool, j_pool in ((tk, jk0), (tv, jv0)):
        for a, b in zip(_pool_bytes(t_pool), _pool_bytes(j_pool)):
            np.testing.assert_array_equal(a, b)
    if kv == "f32":
        for t_pool, j_pool in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(t_pool[:, 1:].numpy(), np.asarray(j_pool)[:, 1:],
                                       rtol=ATOL, atol=ATOL)
        # logits at every valid position vs the reference's unpaged forward
        for r, n in enumerate(nts):
            if not n:
                continue
            seq = np.asarray(prompts[r] + tokens[r, :n].tolist(), np.int32)
            ref = np.asarray(jllama.reference_forward(jspec, jp, jnp.asarray(seq)))
            np.testing.assert_allclose(logits[r, :n].numpy(), ref[starts[r]:],
                                       rtol=ATOL, atol=ATOL)


def test_verify_allowed_mask_matches_reference():
    """Guided masks at every position: the masked argmax equals the
    reference's."""
    tspec, jspec, jp, tp = _verify_models(False, "float32")
    tokens, bts, starts, nts, prompts = _rows(4, tspec.vocab_size)
    (jk, jv), (tk, tv) = _prefilled(tspec, tp, "bf16", prompts, bts)
    rng = np.random.default_rng(9)
    allowed = rng.random((len(ROWS), W, tspec.vocab_size)) < 0.2
    want, *_ = jllama.verify_forward(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts), jnp.asarray(starts),
        jk, jv, jnp.asarray(nts), allowed=jnp.asarray(allowed))
    got = llama.verify_forward(
        tspec, tp, *(torch.from_numpy(a) for a in (tokens, bts, starts)), tk, tv,
        torch.from_numpy(nts), torch.from_numpy(allowed)).numpy()
    want = np.asarray(want)
    for r, n in enumerate(nts):
        assert got[r, :n].tolist() == want[r, :n].tolist()
        assert all(allowed[r, j, got[r, j]] for j in range(n))


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_verify_graphs_eager_route_equals_verify_forward(kv):
    """VerifyGraphs on the CPU runs verify_forward eagerly through its own
    staged buffers: targets and pools equal a direct call's; row counts
    outside the grid raise."""
    tspec, jspec, jp, tp = _verify_models(False, "float32")
    tokens, bts, starts, nts, prompts = _rows(6, tspec.vocab_size)
    _, (tk, tv) = _prefilled(tspec, tp, kv, prompts, bts)
    clone = (lambda p: QuantPool(p.vals.clone(), p.scale.clone())
             if isinstance(p, QuantPool) else p.clone())
    k2, v2 = clone(tk), clone(tv)
    want = llama.verify_forward(
        tspec, tp, *(torch.from_numpy(a) for a in (tokens, bts, starts)), k2, v2,
        torch.from_numpy(nts))
    runner = VerifyGraphs(
        lambda t, b, s, n: llama.verify_forward(tspec, tp, t, b, s, tk, tv, n),
        batch=3, width=W, pages_per_seq=P, device=torch.device("cpu"))
    assert runner.row_counts == verify_row_counts(3) == [1, 2, 4]
    got = runner.dispatch(tokens, bts, starts, nts).wait()
    assert torch.equal(got, want)
    for a, b in ((tk, k2), (tv, v2)):
        for x, y in zip(_pool_bytes(a), _pool_bytes(b)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="rows must be one of"):
        runner.dispatch(tokens[:3], bts[:3], starts[:3], nts[:3])
    assert verify_row_counts(8) == [1, 2, 4, 8] and verify_row_counts(1) == [1]


# ------------------------------------------------------------- engine


def _weights(seed=0, scale=E_SCALE):
    jp = dict(jllama.init_params(JaxSpec(**E_KW), jax.random.PRNGKey(seed)))
    jp["embed"] = jp["embed"] * scale
    return jp, params_from_numpy(ModelSpec(**E_KW), jax.tree.map(np.asarray, jp),
                                 device="cpu")


@functools.cache
def _tp(seed=0):
    """The port's weights for ``seed`` (built once per test process)."""
    return _weights(seed)[1]


def _cfg(mode="off", **kw):
    base = dict(page_size=4, num_pages=256, max_pages_per_seq=64, max_decode_slots=2,
                prefill_buckets=(16, 32, 64), decode_steps_per_dispatch=2,
                pipeline_decode=True, spec_mode=mode, spec_reprobe_tokens=16)
    base.update(kw)
    return base


def _engine(mode="off", seed=0, **kw):
    return InferenceEngine(ModelSpec(**E_KW), EngineConfig(**_cfg(mode, **kw)),
                           params=_tp(seed), device="cpu")


def _repetitive(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(3, 272, 12).tolist()
    return (base * (n // 12 + 1))[:n]


async def _gen(engine, prompt, n, temperature=0.0, ctx=None, **stop):
    out, reasons = [], []
    async for item in engine.generate(
            {"token_ids": list(prompt),
             "stop_conditions": {"max_tokens": n, "ignore_eos": True, **stop},
             "sampling": {"temperature": temperature}},
            ctx or Context()):
        assert not item.get("error"), item
        out.extend(item["token_ids"])
        if item.get("finish_reason") is not None:
            reasons.append(item["finish_reason"])
    return out, reasons


async def _both(fn, **kw):
    """fn(engine) on a spec-off engine, then on a spec-on one; returns
    (off result, on result, on engine's spec snapshot)."""
    out = {}
    snap = None
    for mode in ("off", "ngram"):
        engine = _engine(mode, **kw)
        await engine.start()
        try:
            out[mode] = await fn(engine)
            assert engine.allocator.active_pages == 0
            if mode == "ngram":
                snap = engine.spec_snapshot()
        finally:
            await engine.close()
    return out["off"], out["ngram"], snap


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("kv", ["bf16", "fp8"])
async def test_greedy_streams_bit_identical_spec_on_vs_off(pipeline, kv):
    """Concurrent requests (three prompts on two slots: repetitive,
    incompressible, repetitive) stream the same greedy tokens with spec on
    and off; spec engages and accepts drafts."""
    rng = np.random.default_rng(3)
    prompts = [_repetitive(40), rng.integers(3, 272, 40).tolist(),
               _repetitive(30, seed=5)]

    async def run(engine):
        return await asyncio.gather(*(_gen(engine, p, 28) for p in prompts))

    off, on, snap = await _both(run, pipeline_decode=pipeline, kv_dtype=kv)
    assert on == off
    assert snap["verifies"] > 0 and snap["accepted"] > 0, snap
    assert snap["drafted"] == snap["accepted"] + snap["rejected"]


async def test_chunked_prefill_and_resume_with_spec():
    """A chunked-prefill prompt with spec on, and the migration resume
    shape (prompt + generated as the new prompt, drafted tokens included):
    the stitched stream equals one spec-off generation."""
    prompt = _repetitive(48)
    kw = dict(max_prefill_chunk_tokens=16)
    ref = _engine("off", **kw)
    await ref.start()
    full, _ = await _gen(ref, prompt, 24)
    await ref.close()
    a = _engine("ngram", **kw)
    await a.start()
    part1, _ = await _gen(a, prompt, 10)
    assert a.prefill_chunks >= 2 and a.spec_verifies > 0
    await a.close()
    b = _engine("ngram", **kw)
    await b.start()
    part2, _ = await _gen(b, prompt + part1, 14)
    assert b.allocator.active_pages == 0
    await b.close()
    assert part1 + part2 == full


async def test_mixed_spec_and_sampled_slots_one_engine():
    """A greedy (spec-managed) and a sampled (burst-managed) slot share one
    engine: the greedy stream equals spec-off's; only greedy slots get
    spec state."""
    greedy_prompt, sampled_prompt = _repetitive(40), _repetitive(24, seed=5)

    async def run(engine):
        return await asyncio.gather(
            _gen(engine, greedy_prompt, 24),
            _gen(engine, sampled_prompt, 24, temperature=0.8))

    off, on, snap = await _both(run)
    assert on[0] == off[0]
    assert len(on[1][0]) == 24 and on[1][1] == ["length"]
    assert snap["verifies"] > 0


@pytest.mark.parametrize("n", [1, 3, 7, 13])
async def test_max_tokens_boundary_exact_mid_verify(n):
    """A verify whose accepted prefix crosses the budget ends with
    "length" after exactly n tokens, the same tokens as spec-off."""
    off, on, _ = await _both(lambda e: _gen(e, _repetitive(40), n))
    assert on == off and len(on[0]) == n and on[1] == ["length"]


async def test_stop_and_eos_tokens_mid_verify():
    """A stop token id and an EOS id that the stream reaches mid-verify cut
    it at exactly that token, as with spec off."""
    prompt = _repetitive(40)
    off, _, _ = await _both(lambda e: _gen(e, prompt, 30), seed=1)
    stream = off[0]
    # tokens that first appear well into the stream
    late = [t for i, t in enumerate(stream) if i >= 5 and t not in stream[:i]]
    stop_tok, eos_tok = late[0], late[1]

    async def stops(engine):
        a = await _gen(engine, prompt, 30, stop_token_ids=[stop_tok])
        out, reasons = [], []
        async for item in engine.generate(
                {"token_ids": prompt, "eos_token_ids": [eos_tok],
                 "stop_conditions": {"max_tokens": 30}}, Context()):
            out.extend(item["token_ids"])
            if item.get("finish_reason"):
                reasons.append(item["finish_reason"])
        return a, (out, reasons)

    s_off, s_on, snap = await _both(stops, seed=1)
    assert s_on == s_off
    assert s_on[0][0][-1] == stop_tok and s_on[0][1] == ["stop"]
    assert s_on[1][0][-1] == eos_tok and s_on[1][1] == ["stop"]
    assert snap["verifies"] > 0


async def test_cancel_mid_verify_frees_pages():
    """A spec-managed stream stopped by its client mid-generation ends
    "cancelled" and its pages are freed."""
    engine = _engine("ngram", page_size=16, num_pages=512)
    await engine.start()
    ctx = Context()
    got, reason = [], None
    async for item in engine.generate(
            {"token_ids": _repetitive(40),
             "stop_conditions": {"max_tokens": 900, "ignore_eos": True},
             "sampling": {"temperature": 0.0}}, ctx):
        got.extend(item["token_ids"])
        if len(got) >= 12:
            ctx.stop_generating()
        reason = item.get("finish_reason")
        if reason is not None:
            break
    assert reason == "cancelled" and len(got) < 900
    assert engine.spec_verifies > 0
    for _ in range(250):
        if engine.allocator.active_pages == 0:
            break
        await asyncio.sleep(0.02)
    assert engine.allocator.active_pages == 0
    await engine.close()


async def test_adaptive_k_decays_on_incompressible_prompt():
    """A random-token prompt: the slot parks at k 0 within a handful of
    verifies and the stream equals spec-off's."""
    prompt = np.random.default_rng(2).integers(3, 272, 48).tolist()
    off, on, snap = await _both(lambda e: _gen(e, prompt, 48), seed=4)
    assert on == off
    assert 0 < snap["verifies"] <= 10, snap


async def test_accepted_tokens_per_verify_dispatch_meets_bar():
    """On the repetitive workload at concurrency 1, each verify dispatch
    lands >= 1.5 tokens (accepted drafts + the emitted target)."""
    engine = _engine("ngram", decode_steps_per_dispatch=1)
    await engine.start()
    await _gen(engine, _repetitive(64), 48)
    snap = engine.spec_snapshot()
    await engine.close()
    assert (snap["accepted"] + snap["verifies"]) / snap["verifies"] >= 1.5, snap
    assert 0.0 < snap["acceptance_rate"] <= 1.0


async def test_spec_verify_fault_falls_back_with_stream_unchanged():
    """An injected engine.spec_verify failure: the slot falls back to
    bursts with no client-visible error, the same stream, and every page
    back (the free count restored)."""
    prompt = _repetitive(40)
    off, _, _ = await _both(lambda e: _gen(e, prompt, 24))
    FAULTS.configure("engine.spec_verify:error@1.0x1", seed=11)
    try:
        engine = _engine("ngram")
        free0 = engine.allocator.free_pages
        await engine.start()
        got = await _gen(engine, prompt, 24)
        assert got == off
        assert engine.spec_verifies == 0
        assert engine.allocator.active_pages == 0
        assert engine.allocator.free_pages + engine.allocator.evictable_pages == free0
        assert FAULTS.snapshot()["trips"].get("engine.spec_verify:error") == 1
        await engine.close()
    finally:
        FAULTS.configure("")


async def test_spec_stream_matches_jax_engine():
    """One request, pipeline off, spec on in both engines on the same
    weights: the same stream and the same verify counters."""
    jp, tp = _weights(seed=6)
    prompt = _repetitive(36, seed=2)
    cfg = _cfg("ngram", pipeline_decode=False)
    jeng = JaxEngine(JaxSpec(**E_KW), JaxEngineConfig(**cfg), params=jp)
    teng = InferenceEngine(ModelSpec(**E_KW), EngineConfig(**cfg), params=tp,
                           device="cpu")
    out = []
    for eng, ctx in ((jeng, JaxContext()), (teng, Context())):
        toks = []
        async for item in eng.generate(
                {"token_ids": prompt,
                 "stop_conditions": {"max_tokens": 30, "ignore_eos": True},
                 "sampling": {"temperature": 0.0}}, ctx):
            toks.extend(item["token_ids"])
        out.append((toks, eng.spec_snapshot()))
        await eng.close()
    assert out[1] == out[0]
    assert out[1][1]["verifies"] > 0


class _Events:
    def __init__(self):
        self.stored, self.removed = [], []

    def block_stored(self, sh, parent):
        self.stored.append((sh, parent))

    def blocks_removed(self, shs):
        self.removed.append(list(shs))

    async def close(self):
        pass


async def test_kv_events_with_spec_equal_spec_off():
    """Pages filled by accepted drafts are sealed and published: the stored
    hashes, in order, equal spec-off's, request after request."""
    prompts = [_repetitive(37), _repetitive(45, seed=8)]

    async def run(engine):
        engine.events = _Events()
        for p in prompts:
            await _gen(engine, p, 26)
        return engine.events.stored, engine.events.removed

    off, on, snap = await _both(run, decode_steps_per_dispatch=1)
    assert on == off and len(on[0]) > 0
    assert snap["accepted"] > 0


async def test_spec_tokens_counter_on_metrics():
    """dynamo_spec_tokens_total{outcome} moves with the verifies and rides
    every /metrics exposition."""
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    def counts():
        text = MetricsRegistry().exposition().decode()
        got = dict(re.findall(
            r'^dynamo_spec_tokens_total\{outcome="(\w+)"\} (\S+)$', text, re.M))
        return {k: float(v) for k, v in got.items()}

    before = counts()
    engine = _engine("ngram")
    await engine.start()
    await _gen(engine, _repetitive(40), 24)
    snap = engine.spec_snapshot()
    await engine.close()
    after = counts()
    assert after["accepted"] - before.get("accepted", 0.0) == snap["accepted"]
    assert after["rejected"] - before.get("rejected", 0.0) == snap["rejected"]
    assert "# TYPE dynamo_spec_tokens_total counter" in \
        MetricsRegistry().exposition().decode()


def test_spec_config_builds_and_gates_the_engine():
    """EngineConfig(spec_mode="ngram", ...) builds; only greedy,
    logprob-free requests get spec state; spec off builds no verify
    grid."""
    cfg = EngineConfig(spec_mode="ngram", spec_k_max=4, spec_ngram_min=2,
                       spec_ngram_max=3, spec_ewma_alpha=0.25,
                       spec_reprobe_tokens=8, **{k: v for k, v in _cfg().items()
                                                 if not k.startswith("spec")})
    assert (cfg.spec_mode, cfg.spec_k_max, cfg.spec_ngram_max) == ("ngram", 4, 3)
    eng = InferenceEngine(ModelSpec(**E_KW), cfg, params=_tp(), device="cpu")
    assert eng._spec_on and eng._verify.width == 5
    assert eng._verify.row_counts == [1, 2]
    from dynamo_tpu_torch.engine.core import _Waiting

    def slot(req):
        return eng._make_slot(_Waiting(req, Context(), None), None, None,
                              seq_len=1, remaining=4, last_token=3)

    assert slot({"sampling": {"temperature": 0.0}}).spec is not None
    assert slot({"sampling": {"temperature": 0.7}}).spec is None
    assert slot({"output_options": {"logprobs": 2}}).spec is None
    assert _engine("off")._verify is None


def test_worker_with_spec_ngram_serves():
    """`cli worker --spec ngram --spec-k-max 4 --device cpu` builds its
    config and serves a stream over TCP; its drain line reports verifies.
    DYN_SPEC_MODE turns it on too."""
    from dynamo_tpu_torch.engine.worker import _engine_config, parse_args
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub

    cfg = _engine_config(parse_args(["--spec", "ngram", "--spec-k-max", "4",
                                     "--spec-ngram-min", "2"]))
    assert (cfg.spec_mode, cfg.spec_k_max, cfg.spec_ngram_min) == ("ngram", 4, 2)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "DYN_LEASE_TTL_S": "3", "DYN_KEEPALIVE_INTERVAL_S": "1"}

    def child(*args, extra_env=None):
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", *args], cwd=ROOT,
            env={**env, **(extra_env or {})}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        proc.lines = queue.Queue()

        def pump():
            for line in proc.stdout:
                proc.lines.put(line.rstrip("\n"))
            proc.lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
        return proc

    def wait_line(proc, pattern, timeout=60.0):
        deadline = time.monotonic() + timeout
        seen = []
        while time.monotonic() < deadline:
            try:
                line = proc.lines.get(timeout=0.2)
            except queue.Empty:
                continue
            if line is None:
                break
            seen.append(line)
            if re.search(pattern, line):
                return line
        raise AssertionError(f"no {pattern!r}: {seen[-10:]}")

    procs = []
    try:
        hub = child("hub", "--port", "0")
        procs.append(hub)
        addr = wait_line(hub, r"^DYNAMO_HUB=").split("=", 1)[1]
        worker = child("worker", "--hub", addr, "--device", "cpu", "--model",
                       "tiny-test", "--spec-k-max", "4",
                       extra_env={"DYN_SPEC_MODE": "ngram"})
        procs.append(worker)
        wait_line(worker, r"^ENGINE_READY$")

        async def stream():
            drt = DistributedRuntime(await RemoteHub.connect(addr),
                                     RuntimeConfig(hub_address=addr))
            try:
                client = await drt.namespace("dynamo").component("backend").endpoint(
                    "generate").client().start()
                (inst,) = await client.wait_for_instances(1, timeout=10)
                toks, fin = [], None
                async for item in client.call_instance(
                        inst.instance_id,
                        {"token_ids": _repetitive(40),
                         "stop_conditions": {"max_tokens": 24, "ignore_eos": True},
                         "sampling": {"temperature": 0.0}}, Context()):
                    toks.extend(item["token_ids"])
                    fin = item.get("finish_reason") or fin
                await client.close()
                return toks, fin
            finally:
                await drt.close()

        toks, fin = asyncio.run(stream())
        assert len(toks) == 24 and fin == "length"
        worker.terminate()
        line = wait_line(worker, r"^ENGINE_LAUNCHES ", timeout=30)
        spec = json.loads(line.split(" ", 1)[1])["spec"]
        assert spec["verifies"] > 0, spec
        assert worker.wait(30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(10)
