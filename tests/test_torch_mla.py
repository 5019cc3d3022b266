"""DeepSeek's latent attention in the port (dynamo_tpu_torch/models/mla.py,
the MLA codec of ops/quant.py, models/family.MlaFamily and the engine over
it) against the JAX package's dynamo_tpu/models/mla.py.

Both packages get the same weights: the reference's ``tiny_deepseek`` init
(f32; the router's correction bias drawn non-zero) bridged through
``convert.params_from_numpy``. On bf16-or-f32 and on fp8 latent pools:

- the 2-D ``quant_append_rows``, ``gather_dequant_rows`` and the per-row
  ``quant_page_tiles`` give the reference's bytes on shared inputs;
- ``reference_forward``, the paged prefill and the packed prefill give the
  reference's logits within LOGIT_TOL (1e-4: f32 sums in another order),
  and the packed prefill its own singles' within PACKED_TOL (2e-4, the
  reference test's);
- ``decode_steps`` (greedy; seeded sampling through the threefry bits;
  logprobs) gives the reference's tokens exactly and logprobs within
  LOGIT_TOL; the decode graph runner's eager route (the step a CUDA graph
  captures) gives ``decode_steps``' records and pools bitwise;
- ``verify_forward``, with and without the guided ``allowed`` masks, gives
  the reference's targets exactly.

Pools: the same rows written (placement exact), their values within
POOL_TOL (bf16/f32), or (fp8) within one e4m3 step of the row's scale.
Then tiny-deepseek through both engines (prefix-cache hit, ngram
speculation, a guided json_object request, seeded sampling with logprobs):
streams equal, logprobs within LOGIT_TOL; and a DeepSeek checkpoint
directory served by ``cli run --model-path`` over HTTP.
"""

import asyncio
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.guided as jg
import dynamo_tpu_torch.guided as tg
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import mla as jmla
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.graphs import DecodeGraphs
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
from dynamo_tpu_torch.models import llama, loader, mla
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.family import MlaFamily, get_family
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.runtime.context import Context
from test_torch_quant import _assert_bits, _pool_both

pytestmark = pytest.mark.unit

LOGIT_TOL = 1e-4
PACKED_TOL = 2e-4
POOL_TOL = 1e-5
KV = ("bf16", "fp8")
PAGE, P, NUM_PAGES = 4, 8, 40
YARN = dict(rope_scaling_factor=40.0, rope_orig_max_pos=4096, rope_mscale=1.0,
            rope_mscale_all_dim=1.0)
# the input embedding scaled: no greedy token sits on a near-tie
EMBED_SCALE = 4.0
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [1, 2, 3], [40, 41], [60, 61, 62, 63, 64, 65, 66, 67, 68]]
SAMPLING = dict(
    active=np.asarray([True, True, False, True]),
    temperature=np.asarray([0.0, 0.8, 0.0, 1.2], np.float32),
    top_k=np.asarray([0, 5, 0, 0], np.int32),
    top_p=np.asarray([1.0, 1.0, 1.0, 0.9], np.float32),
    seeds=np.asarray([3, 4_000_000_000, 0, 77], np.uint32),
    steps=np.asarray([1, 1, 0, 6], np.int32),
)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_WEIGHTS: dict = {}


def _weights(seed=0, yarn=False):
    """(JAX spec, port spec, JAX params, port params) of tiny_deepseek on
    the reference's init, the input embedding x EMBED_SCALE and the
    routers' correction bias drawn non-zero."""
    key = (seed, yarn)
    if key not in _WEIGHTS:
        extra = YARN if yarn else {}
        jspec = dataclasses.replace(JaxSpec.tiny_deepseek(), **extra)
        tspec = dataclasses.replace(ModelSpec.tiny_deepseek(), **extra)
        jp = jax.tree.map(np.asarray, jmla.init_params(jspec, jax.random.PRNGKey(seed)))
        jp["embed"] = jp["embed"] * EMBED_SCALE
        rng = np.random.default_rng(seed)
        for lp in jp["layers"]:
            if "moe" in lp:
                sb = lp["moe"]["score_bias"]
                lp["moe"]["score_bias"] = (rng.standard_normal(sb.shape) * 0.2).astype(
                    np.float32)
        _WEIGHTS[key] = (jspec, tspec, jp, params_from_numpy(tspec, jp, device="cpu"))
    return _WEIGHTS[key]


def _jax_reference(jspec, jp, tokens):
    """The reference's reference_forward, jitted (op by op it takes
    seconds)."""
    return jax.jit(jmla.reference_forward, static_argnums=0)(jspec, jp, jnp.asarray(tokens))


def _caches(jspec, tspec, kv):
    return (jmla.init_cache(jspec, NUM_PAGES, PAGE, kv_dtype=kv),
            mla.init_cache(tspec, NUM_PAGES, PAGE, device="cpu", kv_dtype=kv))


def _assert_pools_close(got, want, pages=None):
    """The same rows written (the scale-or-value nonzero pattern), the
    values within POOL_TOL, or within one e4m3 step of their row's scale
    on an fp8 pool; only ``pages`` when given (trash page 0 is garbage by
    contract)."""
    sl = slice(1, None) if pages is None else pages
    if quant.is_quant(got):
        gs = got.scale.float().numpy()[:, sl]
        ws = np.asarray(want.scale.astype(jnp.float32))[:, sl]
        np.testing.assert_array_equal(gs != 0, ws != 0)
        np.testing.assert_allclose(gs, ws, rtol=2 ** -7)
        gv = got.vals.float().numpy()[:, sl] * gs[..., None]
        wv = np.asarray(want.vals.astype(jnp.float32))[:, sl] * ws[..., None]
        # one e4m3 step at the top binade: 32 of 448 units of the scale
        assert (np.abs(gv - wv) <= 32.0 * ws[..., None]).all()
        return
    g, w = got.numpy()[:, sl], np.asarray(want)[:, sl]
    np.testing.assert_array_equal(g != 0, w != 0)
    np.testing.assert_allclose(g, w, atol=POOL_TOL, rtol=POOL_TOL)


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("case", ["random", "large", "zero_row"])
def test_quant_append_rows_2d_matches_jax(case):
    """The MLA latent append: each row's own scale and values, stored at
    (page, offset), siblings on one page included; the reference's bytes,
    every other row untouched."""
    rng = np.random.default_rng(len(case))
    L, NP, page, D, N = 2, 6, 4, 24, 7
    vals = rng.standard_normal((L, NP, page, D)).astype(np.float32) * 100
    scale = rng.uniform(0.5, 1.5, (L, NP, page)).astype(np.float32) / 448
    rows = rng.standard_normal((N, D)).astype(np.float32) * (1e3 if case == "large" else 1)
    if case == "zero_row":
        rows[2] = 0.0
    dst_page = np.asarray([1, 1, 1, 3, 5, 5, 0], np.int32)  # siblings share pages
    dst_off = np.asarray([0, 1, 3, 2, 0, 3, 1], np.int32)
    jpool, tpool = _pool_both(vals, scale)
    want = jquant.quant_append_rows(jpool, jnp.asarray(rows), jnp.asarray(dst_page),
                                    jnp.asarray(dst_off), 1)
    quant.quant_append_rows(tpool, torch.from_numpy(rows), torch.from_numpy(dst_page),
                            torch.from_numpy(dst_off), 1)
    _assert_bits(tpool.vals, want.vals)
    _assert_bits(tpool.scale, want.scale)
    if case == "zero_row":
        assert float(tpool.scale[1, 1, 3]) == 0.0


def test_gather_dequant_rows_and_page_tiles_match_jax():
    rng = np.random.default_rng(3)
    shape = (2, 5, 4, 24)
    jpool, tpool = _pool_both(rng.standard_normal(shape).astype(np.float32) * 50,
                              rng.uniform(0.001, 0.1, shape[:3]).astype(np.float32))
    bt = np.asarray([[3, 1, 4], [2, 2, 0]], np.int32)
    got = quant.gather_dequant_rows(tpool.layer(1), torch.from_numpy(bt))
    assert got.shape == (2, 12, 24) and got.dtype == torch.float32
    for i in range(2):
        _assert_bits(got[i], jquant.gather_dequant_rows(jpool.layer(1), jnp.asarray(bt[i])))
    # prefill tiles [n, page, D], one scale per row, padded rows zeroed first
    tiles = (rng.standard_normal((3, 4, 24)) * 30).astype(np.float32)
    valid = rng.random((3, 4)) < 0.7
    wv, ws = jquant.quant_page_tiles(jnp.asarray(tiles), jnp.asarray(valid)[:, :, None], (2,))
    gv, gs = quant.quant_page_tiles(torch.from_numpy(tiles),
                                    torch.from_numpy(valid)[:, :, None], (2,))
    _assert_bits(gv, wv)
    _assert_bits(gs, ws)
    assert gs.shape == (3, 4)


def test_latent_cache_forms_and_family():
    """The cache forms and the family adapter: one latent array (page 0
    the trash page) or a per-row QuantPool, and an empty v_pages
    placeholder, so the engine's pool bytes are the latent cache's."""
    spec = ModelSpec.tiny_deepseek()
    c = mla.init_cache(spec, 9, 4, device="cpu")
    assert c.shape == (3, 9, 4, mla.latent_dim(spec)) and c.dtype == torch.float32
    q = mla.init_cache(spec, 9, 4, device="cpu", kv_dtype="fp8")
    assert q.scale.shape == (3, 9, 4) and q.vals.dtype == torch.float8_e4m3fn
    assert mla.latent_dim(ModelSpec.deepseek_r1()) == 576
    fam = get_family(ModelSpec.deepseek_r1())
    assert isinstance(fam, MlaFamily) and fam.supports_logprobs and fam.supports_spec_decode
    rows = 3 * 17 * 4  # layers x (16 pages + trash) x page
    for kv, row_bytes in (("bf16", 24 * 4), ("fp8", 24 + 2)):  # f32 rows; e4m3 + a scale
        eng = InferenceEngine(spec, EngineConfig(page_size=4, num_pages=16, kv_dtype=kv),
                              device="cpu")
        assert eng.v_pages.numel() == 0
        assert eng.pool_bytes == eng.k_pages.nbytes == rows * row_bytes
    assert mla.softmax_scale(dataclasses.replace(spec, **YARN)) == pytest.approx(
        jmla.softmax_scale(dataclasses.replace(JaxSpec.tiny_deepseek(), **YARN)), rel=1e-12)


def test_yarn_table_keyed_on_rope_dim():
    """MLA rotates only qk_rope_head_dim columns: the cached YaRN table is
    made per rotary dim, and rope at that dim equals the reference's."""
    jspec = dataclasses.replace(JaxSpec.tiny_deepseek(), **YARN)
    tspec = dataclasses.replace(ModelSpec.tiny_deepseek(), **YARN)
    rng = np.random.default_rng(0)
    pos = np.arange(0, 3000, 97).astype(np.int32)
    for dim in (tspec.qk_rope_head_dim, tspec.head_dim):
        x = rng.standard_normal((len(pos), 4, dim)).astype(np.float32)
        want = np.asarray(jllama.rope_spec(jspec, jnp.asarray(x), jnp.asarray(pos)))
        got = llama.rope_spec(tspec, torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        inv, _att = llama._yarn_table(tspec, dim, torch.device("cpu"))
        assert inv.shape == (dim // 2,)


# ----------------------------------------------------------------- forwards


@pytest.mark.parametrize("yarn", [False, True])
def test_reference_forward_matches_jax(yarn):
    jspec, tspec, jp, tp = _weights(yarn=yarn)
    tokens = np.random.default_rng(0).integers(0, tspec.vocab_size, 21).astype(np.int32)
    want = _jax_reference(jspec, jp, tokens)
    got = mla.reference_forward(tspec, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("kv", KV)
def test_prefill_matches_jax(kv):
    """One prompt, then a second chunk behind its cached first page: the
    last logits within 1e-4 of the reference's and the rows it wrote."""
    jspec, tspec, jp, tp = _weights()
    jc, tc = _caches(jspec, tspec, kv)
    toks = np.random.default_rng(1).integers(3, tspec.vocab_size, 11).astype(np.int32)
    bt = np.asarray([1, 2, 3, 4, 0, 0, 0, 0], np.int32)
    for start, n in ((0, 4), (4, 7)):
        padded = np.zeros(8, np.int32)
        padded[:n] = toks[start:start + n]
        want, jc = jmla.prefill_forward(jspec, jp, jnp.asarray(padded), jnp.asarray(bt),
                                        jnp.asarray(start, jnp.int32), jc,
                                        jnp.asarray(n, jnp.int32))
        got, dropped = mla.prefill_forward(tspec, tp, torch.from_numpy(padded),
                                           torch.from_numpy(bt), start, tc, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        assert int(dropped) == 0
    _assert_pools_close(tc, jc)
    ref = _jax_reference(jspec, jp, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[-1],
                               atol=0.05 if kv == "fp8" else 2e-4)


def _packed(tspec):
    """Three prompts and a padded row, each on its own pages."""
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(3, tspec.vocab_size, n)) for n in (7, 11, 5)]
    T, N = 12, 4
    tokens = np.zeros((N, T), np.int32)
    bts = np.zeros((N, P), np.int32)
    nts = np.zeros((N,), np.int32)
    nxt = 1
    for i, pr in enumerate(prompts):
        tokens[i, : len(pr)] = pr
        npg = (len(pr) + PAGE - 1) // PAGE
        bts[i, :npg] = np.arange(nxt, nxt + npg)
        nxt += npg
        nts[i] = len(pr)
    return tokens, bts, nts, nxt


@pytest.mark.parametrize("kv", KV)
def test_packed_prefill_matches_jax_and_singles(kv):
    """prefill_forward_batch of 3 prompts and a padded row: logits within
    1e-4 of the reference's packed prefill and within the reference
    test's 2e-4 of the port's own single prefills, and the same rows."""
    jspec, tspec, jp, tp = _weights(seed=7)
    tokens, bts, nts, used = _packed(tspec)
    N = len(nts)
    jc, tc = _caches(jspec, tspec, kv)
    want, jc = jmla.prefill_forward_batch(jspec, jp, jnp.asarray(tokens), jnp.asarray(bts),
                                          jnp.zeros((N,), jnp.int32), jc, jnp.asarray(nts))
    got, dropped = mla.prefill_forward_batch(tspec, tp, torch.from_numpy(tokens),
                                             torch.from_numpy(bts),
                                             torch.zeros(N, dtype=torch.int64), tc,
                                             torch.from_numpy(nts))
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert int(dropped) == 0
    _assert_pools_close(tc, jc, slice(1, used))
    pg, off = _real_rows(bts, nts)
    _jc, singles = _caches(jspec, tspec, kv)
    for i in range(3):
        one, _ = mla.prefill_forward(tspec, tp, torch.from_numpy(tokens[i]),
                                     torch.from_numpy(bts[i]), 0, singles, int(nts[i]))
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), atol=PACKED_TOL,
                                   rtol=PACKED_TOL)
    if kv == "bf16":  # the real tokens' rows (the experts route padding otherwise)
        np.testing.assert_allclose(tc[:, pg, off].numpy(), singles[:, pg, off].numpy(),
                                   atol=POOL_TOL)


def _real_rows(bts, nts):
    """(pages, offsets) of the real tokens' rows."""
    pos = [(i, t) for i, n in enumerate(nts) for t in range(n)]
    return (torch.tensor([int(bts[i, t // PAGE]) for i, t in pos]),
            torch.tensor([t % PAGE for _i, t in pos]))


def _decode_setup(kv):
    """Both models with PROMPTS prefilled (slot i owns pages 1 + 4i ..
    4 + 4i); returns the JAX side, the port side, block tables, the first
    tokens and seq_lens."""
    jspec, tspec, jp, tp = _weights(seed=5)
    jc, tc = _caches(jspec, tspec, kv)
    B = len(PROMPTS)
    bts = np.zeros((B, P), np.int32)
    tokens = np.zeros((B, 12), np.int32)
    for i, pr in enumerate(PROMPTS):
        bts[i, :4] = np.arange(1 + 4 * i, 5 + 4 * i)
        tokens[i, : len(pr)] = pr
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    logits, jc = jmla.prefill_forward_batch(jspec, jp, jnp.asarray(tokens), jnp.asarray(bts),
                                            jnp.zeros((B,), jnp.int32), jc, jnp.asarray(lens))
    mla.prefill_forward_batch(tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts),
                              torch.zeros(B, dtype=torch.int64), tc, torch.from_numpy(lens))
    first = np.asarray(logits).argmax(-1).astype(np.int32)
    return (jspec, jp, jc), (tspec, tp, tc), bts, first, lens + 1


def _sampling(s, greedy):
    s = dict(s, temperature=s["temperature"] * (not greedy))
    return s, (torch.from_numpy(s["active"]), torch.from_numpy(s["temperature"]),
               torch.from_numpy(s["top_k"]), torch.from_numpy(s["top_p"]),
               torch.from_numpy(s["seeds"].astype(np.int64)), torch.from_numpy(s["steps"]))


@pytest.mark.parametrize("mode", ["greedy", "sampled_logprobs"])
@pytest.mark.parametrize("kv", KV)
def test_decode_steps_match_jax(kv, mode):
    """Three decode steps (an inactive row; seeded sampled rows with top-k
    and top-p): tokens identical to the reference's mla.decode_steps,
    logprobs within 1e-4, top ids identical, the same rows written."""
    (jspec, jp, jc), (tspec, tp, tc), bts, first, seq_lens = _decode_setup(kv)
    greedy = mode == "greedy"
    n_lp = 0 if greedy else 4
    s, port_s = _sampling(SAMPLING, greedy)
    want = jmla.decode_steps(jspec, jp, jnp.asarray(first), jnp.asarray(bts),
                             jnp.asarray(seq_lens), jc,
                             *(jnp.asarray(s[k]) for k in ("active", "temperature", "top_k",
                                                           "top_p", "seeds", "steps")),
                             n_steps=3, n_logprobs=n_lp)
    got = mla.decode_steps(tspec, tp, torch.from_numpy(first), torch.from_numpy(bts),
                           torch.from_numpy(seq_lens), tc, *port_s, n_steps=3,
                           n_logprobs=n_lp)
    jc = want[-1]
    if greedy:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))
    else:
        act = s["active"]
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy()[act], np.asarray(want[1])[act],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_array_equal(got[2].numpy()[act], np.asarray(want[2])[act])
        np.testing.assert_allclose(got[3].numpy()[act], np.asarray(want[3])[act],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    _assert_pools_close(tc, jc)


@pytest.mark.parametrize("kv", KV)
def test_graph_step_equals_decode_steps(kv):
    """The decode graph runner's MLA step (static tensors: the function a
    CUDA graph captures, run eagerly on the CPU) gives decode_steps'
    tokens, logprobs and pool bytes exactly."""
    _, (tspec, tp, tc), bts, first, seq_lens = _decode_setup(kv)
    eager = quant.QuantPool(tc.vals.clone(), tc.scale.clone()) if kv == "fp8" else tc.clone()
    s, port_s = _sampling(SAMPLING, greedy=False)
    want = mla.decode_steps(tspec, tp, torch.from_numpy(first), torch.from_numpy(bts),
                            torch.from_numpy(seq_lens), eager, *port_s, n_steps=3,
                            n_logprobs=4)
    fam = get_family(tspec)
    placeholder = torch.zeros(0, dtype=torch.int8)

    def step(t, sampled, n_lp):
        fam.decode_step(tspec, tp, tc, placeholder, t, sampled=sampled, n_logprobs=n_lp)

    g = DecodeGraphs(step, batch=4, pages_per_seq=P, max_steps=4, n_logprobs=4,
                     device=torch.device("cpu"))
    burst = g.dispatch({"tokens": first, "block_tables": bts, "seq_lens": seq_lens, **s},
                       3, sampled=True, n_logprobs=4)
    fed, toks, lp, ti, tv = burst.result()
    np.testing.assert_array_equal(fed, first)
    np.testing.assert_array_equal(toks, want[0].numpy())
    for a, b in zip((lp, ti, tv), want[1:]):
        np.testing.assert_array_equal(a, b.numpy())
    if kv == "fp8":
        assert torch.equal(tc.vals.view(torch.uint8), eager.vals.view(torch.uint8))
        assert torch.equal(tc.scale, eager.scale)
    else:
        assert torch.equal(tc, eager)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kv", KV)
def test_verify_matches_jax(kv, masked):
    """A verify of 4 rows x 3 (rows starting mid-page, siblings sharing
    pages, one row of 2, one padded row) after the prefill: targets equal
    to the reference's, under random guided masks too, and the rows
    written."""
    (jspec, jp, jc), (tspec, tp, tc), bts, first, seq_lens = _decode_setup(kv)
    N, W = 4, 3
    rng = np.random.default_rng(4)
    tokens = np.concatenate([first[:, None], rng.integers(3, tspec.vocab_size, (N, W - 1))],
                            axis=1).astype(np.int32)
    starts = (seq_lens - 1).astype(np.int32)
    nts = np.asarray([3, 2, 0, 3], np.int32)
    allowed = None
    if masked:
        allowed = rng.random((N, W, tspec.vocab_size)) < 0.3
        allowed[..., 7] = True  # never an empty row
    want, jc = jmla.verify_forward(jspec, jp, jnp.asarray(tokens), jnp.asarray(bts),
                                   jnp.asarray(starts), jc, jnp.asarray(nts),
                                   allowed=None if allowed is None else jnp.asarray(allowed))
    got, dropped = mla.verify_forward(
        tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts), torch.from_numpy(starts),
        tc, torch.from_numpy(nts), None if allowed is None else torch.from_numpy(allowed))
    assert int(dropped) == 0 and got.dtype == torch.int32
    for r, n in enumerate(nts):
        assert got[r, :n].tolist() == np.asarray(want)[r, :n].tolist()
        if masked:
            assert all(allowed[r, j, int(got[r, j])] for j in range(n))
    _assert_pools_close(tc, jc)


# ------------------------------------------------------------------ engines


def _req(prompt, n, **extra):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}, **extra}


async def _collect(eng, req, ctx):
    return [x async for x in eng.generate(dict(req), ctx)]


async def _serve(eng, ctx_cls, first, rest):
    """``first`` alone (its prompt's pages sealed), then ``rest``
    concurrently; returns the items per request and the prompt tokens
    ``rest[0]`` can take from the prefix cache then."""
    a = await _collect(eng, first, ctx_cls())
    hit = (eng.prefix_hit_tokens(rest[0]["token_ids"]) if hasattr(eng, "prefix_hit_tokens")
           else -eng.cached_prompt_tokens)
    outs = await asyncio.gather(*(_collect(eng, r, ctx_cls()) for r in rest))
    if hit <= 0:  # the port counts the tokens its admissions took
        hit += eng.cached_prompt_tokens
    return [a, *outs], hit


async def test_engine_streams_match_jax():
    """tiny-deepseek through both engines on the same weights, with ngram
    speculation, the ascii-json vocabulary and the packed prefill padded
    to its pack size: a prompt, then a second one on its cached prefix
    (a prefix-cache hit), a repeating prompt (drafts verified), a seeded
    temperature-0.8 request with logprobs and a guided json_object
    request. Streams equal, logprobs within 1e-4, the guided stream walks
    its grammar, no page left."""
    jspec, tspec, jp, tp = _weights(seed=3)
    kw = dict(page_size=4, num_pages=160, max_pages_per_seq=16, max_decode_slots=4,
              prefill_buckets=(8, 16, 32), prefill_pack_size=4, spec_mode="ngram",
              spec_k_max=4)
    grammar = tg.grammar_from_request({"response_format": {"type": "json_object"}})
    assert grammar == jg.grammar_from_request({"response_format": {"type": "json_object"}})
    rng = np.random.default_rng(9)
    shared = rng.integers(3, tspec.vocab_size, 12).tolist()
    first = _req(shared + [7, 8], 8)
    rest = [
        _req(shared + [9, 10, 11], 8),
        _req([20, 21, 22, 23] * 4, 16),
        _req(rng.integers(3, tspec.vocab_size, 9).tolist(), 8,
             sampling={"temperature": 0.8, "seed": 11}, output_options={"logprobs": 3}),
        _req([30, 31, 32], 12, guided={**grammar, "prompt_len": 3}),
    ]
    jeng = JaxEngine(jspec, JaxEngineConfig(**kw), params=jax.tree.map(jnp.asarray, jp),
                     guided_vocab=jg.TokenVocab.ascii_json(tspec.vocab_size))
    teng = InferenceEngine(tspec, EngineConfig(**kw), params=tp, device="cpu",
                           guided_vocab=tg.TokenVocab.ascii_json(tspec.vocab_size))
    want, j_hit = await _serve(jeng, JaxContext, first, rest)
    got, t_hit = await _serve(teng, Context, first, rest)
    t_verifies = teng.spec_verifies
    await jeng.close()
    await teng.close()
    for w, o in zip(want, got):
        assert [t for x in o for t in x["token_ids"]] == [t for x in w for t in x["token_ids"]]
        assert o[-1]["finish_reason"] == w[-1]["finish_reason"]
    we = [e for x in want[3] for e in x.get("logprobs", ())]
    ge = [e for x in got[3] for e in x.get("logprobs", ())]
    assert len(ge) == len(we) == 8
    for a, b in zip(ge, we):
        assert a["id"] == b["id"] and abs(a["logprob"] - b["logprob"]) <= LOGIT_TOL
        assert [t["id"] for t in a["top"]] == [t["id"] for t in b["top"]]
        for x, y in zip(a["top"], b["top"]):
            assert abs(x["logprob"] - y["logprob"]) <= LOGIT_TOL
    assert t_hit == j_hit >= 12
    assert t_verifies > 0
    st = tg.GrammarCompiler(tg.TokenVocab.ascii_json(tspec.vocab_size),
                            vocab_size=tspec.vocab_size).state_for(grammar, eos_ids=(2,))
    assert all(st.advance(t) for x in got[4] for t in x["token_ids"])
    assert teng.allocator.active_pages == 0


def test_cli_serves_deepseek_checkpoint(tmp_path):
    """``cli run --in http --model-path DIR`` on a tiny DeepSeek checkpoint
    (bf16, interleaved rope columns) streams the greedy token-id
    completion an in-process engine on the loaded weights gives."""
    spec = dataclasses.replace(ModelSpec.tiny_deepseek(), dtype="bfloat16",
                               rope_interleave=True)
    loader.save_params(spec, mla.init_params(spec, 8, device="cpu"), str(tmp_path))
    prompt, n = [17, 40, 41, 42, 90, 33, 18], 6
    spec2, params = loader.load_model_dir(str(tmp_path), device="cpu")

    async def local():
        eng = InferenceEngine(spec2, EngineConfig(), params=params, device="cpu")
        items = await _collect(eng, _req(prompt, n), Context())
        await eng.close()
        return [t for x in items for t in x["token_ids"]]

    want = asyncio.run(local())
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http", "--out",
         "engine", "--model-path", str(tmp_path), "--device", "cpu", "--port", "0"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        addr, t0 = None, time.monotonic()
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
            data=json.dumps({"model": tmp_path.name, "prompt": prompt, "max_tokens": n,
                             "temperature": 0.0, "ignore_eos": True}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(10)
    assert out["usage"]["completion_tokens"] == n == len(want)
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["choices"][0]["text"] == MockTokenizer().decode(want)
