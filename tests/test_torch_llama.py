"""The port's llama model (dynamo_tpu_torch/models/llama.py) against the JAX
package's, on the same weights.

Weights come from ``dynamo_tpu.models.llama.init_params`` and reach the port
through ``params_from_numpy``. The JAX side runs on the CPU's XLA decode
path (scatter + gather attention); the port's CPU path takes the kernels'
plain versions. Logits at f32 agree within 1e-4 (sums in another order,
1-ulp differences in exp/sin/cos); greedy tokens agree exactly on a peaked
spec (input embeddings scaled, as in tests/test_quant_goldens.py, so no
argmax rides on a near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.unit

ATOL = 1e-4
SPEC_KW = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
               dtype="float32")
PAGE, P, NUM_PAGES = 4, 8, 33
EMBED_SCALE = 32.0  # peaked logits (tests/test_quant_goldens.py)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models(seed=0, peaked=False, **kw):
    """(torch spec, jax spec, jax params, port params) on the same weights."""
    spec_kw = {**SPEC_KW, **kw}
    jspec, tspec = JaxSpec(**spec_kw), ModelSpec(**spec_kw)
    jp = jllama.init_params(jspec, jax.random.PRNGKey(seed))
    if peaked:
        jp = dict(jp)
        jp["embed"] = jp["embed"] * EMBED_SCALE
    tree = jax.tree.map(np.asarray, jp)
    return tspec, jspec, jp, params_from_numpy(tspec, tree, device="cpu")


def _caches(tspec, jspec):
    jk, jv = jllama.init_cache(jspec, NUM_PAGES, PAGE)
    tk, tv = llama.init_cache(tspec, NUM_PAGES, PAGE, device="cpu")
    return (jk, jv), (tk, tv)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=atol, atol=atol,
    )


def test_params_from_numpy_bridges_bf16_bitwise():
    jspec = JaxSpec(**{**SPEC_KW, "dtype": "bfloat16"})
    tspec = ModelSpec(**{**SPEC_KW, "dtype": "bfloat16"})
    jp = jllama.init_params(jspec, jax.random.PRNGKey(4))
    tp = params_from_numpy(tspec, jax.tree.map(np.asarray, jp), device="cpu")
    for name in ("wq", "wk", "w_down", "attn_norm"):
        want = np.asarray(jp["layers"][1][name]).view(np.uint16)
        got = getattr(tp.layers[1], name).view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, want)
    assert tp.embed.dtype == torch.bfloat16


def test_init_params_seeded_and_raises_without_gpu():
    spec = ModelSpec(**SPEC_KW)
    a = llama.init_params(spec, 3, device="cpu")
    b = llama.init_params(spec, 3, device="cpu")
    assert torch.equal(a.layers[0].wq, b.layers[0].wq)
    assert a.layers[0].wq.shape == (32, 32) and a.lm_head is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            llama.init_params(spec, 3)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            llama.init_cache(spec, 4, PAGE)


def test_reference_forward_matches():
    tspec, jspec, jp, tp = _models(seed=1)
    toks = np.asarray([5, 17, 3, 42, 8, 9, 23, 1, 60], np.int32)
    want = jllama.reference_forward(jspec, jp, jnp.asarray(toks))
    got = llama.reference_forward(tspec, tp, torch.from_numpy(toks))
    _close(got, want)


@pytest.mark.parametrize("start", [0, 4])
def test_prefill_matches(start):
    """One prompt, cold (start 0) and behind a cached page (start 4): last
    logits and the written pool pages agree."""
    tspec, jspec, jp, tp = _models(seed=2)
    (jk, jv), (tk, tv) = _caches(tspec, jspec)
    prompt = np.asarray([5, 17, 3, 42, 8, 9, 23, 11, 2, 7, 30], np.int32)
    bt = np.zeros((P,), np.int32)
    bt[:3] = [4, 9, 2]
    if start:
        # the cached page comes from a cold prefill of the same prompt
        padded = np.zeros((8,), np.int32)
        padded[:start] = prompt[:start]
        _, jk, jv, _ = jllama.prefill_forward(
            jspec, jp, jnp.asarray(padded), jnp.asarray(bt),
            jnp.asarray(0, jnp.int32), jk, jv, jnp.asarray(start, jnp.int32))
        llama.prefill_forward(tspec, tp, torch.from_numpy(padded),
                              torch.from_numpy(bt), 0, tk, tv, start)
    tail = prompt[start:]
    padded = np.zeros((8 if len(tail) <= 8 else 16,), np.int32)
    padded[: len(tail)] = tail
    want, jk, jv, _ = jllama.prefill_forward(
        jspec, jp, jnp.asarray(padded), jnp.asarray(bt),
        jnp.asarray(start, jnp.int32), jk, jv,
        jnp.asarray(len(tail), jnp.int32))
    got = llama.prefill_forward(tspec, tp, torch.from_numpy(padded),
                                torch.from_numpy(bt), start, tk, tv, len(tail))
    _close(got, want)
    live = [4, 9, 2]
    _close(tk[:, live], np.asarray(jk)[:, live])
    _close(tv[:, live], np.asarray(jv)[:, live])


def test_prefill_batch_matches():
    """Packed prefill of three prompts (one behind a cached page, one padded
    row): last logits per row agree."""
    tspec, jspec, jp, tp = _models(seed=3)
    (jk, jv), (tk, tv) = _caches(tspec, jspec)
    N, T = 4, 8
    tokens = np.zeros((N, T), np.int32)
    rng = np.random.default_rng(0)
    lens = [7, 8, 3, 0]
    starts = [0, 0, 4, 0]
    bts = np.zeros((N, P), np.int32)
    bts[0, :2] = [1, 2]
    bts[1, :2] = [3, 4]
    bts[2, :2] = [5, 6]
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 97, n)
    want, jk, jv, _ = jllama.prefill_forward_batch(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts),
        jnp.asarray(starts, jnp.int32), jk, jv, jnp.asarray(lens, jnp.int32))
    got = llama.prefill_forward_batch(
        tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts),
        torch.tensor(starts), tk, tv, torch.tensor(lens))
    _close(got[:3], np.asarray(want)[:3])
    _close(tk[:, 1:7], np.asarray(jk)[:, 1:7])


def _prefilled(tspec, jspec, jp, tp, prompts):
    """Both models' caches after prefilling ``prompts`` (slot i owns pages
    1 + 4i .. 4 + 4i)."""
    (jk, jv), (tk, tv) = _caches(tspec, jspec)
    B = len(prompts)
    bts = np.zeros((B, P), np.int32)
    for i, prompt in enumerate(prompts):
        bts[i, :4] = np.arange(1 + 4 * i, 5 + 4 * i)
        padded = np.zeros((8,), np.int32)
        padded[: len(prompt)] = prompt
        _, jk, jv, _ = jllama.prefill_forward(
            jspec, jp, jnp.asarray(padded), jnp.asarray(bts[i]),
            jnp.asarray(0, jnp.int32), jk, jv,
            jnp.asarray(len(prompt), jnp.int32))
        llama.prefill_forward(tspec, tp, torch.from_numpy(padded),
                              torch.from_numpy(bts[i]), 0, tk, tv, len(prompt))
    return (jk, jv), (tk, tv), bts


@pytest.mark.parametrize("fused", ["1", "0"])
def test_decode_matches(fused, monkeypatch):
    """One decode step over three slots (slot 1 inactive): active rows'
    logits agree, through the fused path and through the unfused pair."""
    monkeypatch.setenv("DYNAMO_FUSED_DECODE", fused)
    tspec, jspec, jp, tp = _models(seed=4)
    prompts = [[5, 6, 7, 8, 9], [1, 2], [40, 41, 42, 43, 44, 45, 46]]
    (jk, jv), (tk, tv), bts = _prefilled(tspec, jspec, jp, tp, prompts)
    tokens = np.asarray([11, 0, 12], np.int32)
    lens = np.asarray([6, 1, 8], np.int32)
    active = np.asarray([True, False, True])
    want, jk, jv = jllama.decode_forward(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts), jnp.asarray(lens),
        jk, jv, jnp.asarray(active))
    got = llama.decode_forward(
        tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts),
        torch.from_numpy(lens), tk, tv, torch.from_numpy(active))
    _close(got[active], np.asarray(want)[active])
    # the appended rows landed where the reference put them
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])


def test_decode_steps_greedy_tokens_identical():
    """Greedy multi-step decode on a peaked spec: identical token ids."""
    tspec, jspec, jp, tp = _models(seed=5, peaked=True, vocab_size=128,
                                   hidden_size=64, intermediate_size=128,
                                   head_dim=16)
    prompts = [[5, 6, 7, 8, 9], [1, 2, 3], [40, 41, 42, 43, 44, 45, 46, 47]]
    (jk, jv), (tk, tv), bts = _prefilled(tspec, jspec, jp, tp, prompts)
    B, n = 3, 7
    tokens = np.asarray([11, 3, 12], np.int32)
    lens = np.asarray([len(p) + 1 for p in prompts], np.int32)
    want, _, _ = jllama.decode_steps(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts), jnp.asarray(lens),
        jk, jv, jnp.ones((B,), bool), jnp.zeros((B,), jnp.float32),
        jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.float32),
        jnp.zeros((B,), jnp.uint32), jnp.zeros((B,), jnp.int32), n_steps=n)
    got = llama.decode_steps(
        tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts),
        torch.from_numpy(lens), tk, tv, torch.ones(B, dtype=torch.bool),
        torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B),
        torch.zeros(B, dtype=torch.int64), torch.zeros(B, dtype=torch.int64),
        n_steps=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rope_spec_yarn_matches():
    """YaRN-scaled rope (gpt-oss settings) and the plain theta schedule."""
    yarn = dict(rope_theta=150000.0, rope_scaling_factor=32.0,
                rope_orig_max_pos=4096, rope_truncate=False)
    for kw in ({}, yarn):
        jspec = JaxSpec(**{**SPEC_KW, **kw})
        tspec = ModelSpec(**{**SPEC_KW, **kw})
        rng = np.random.default_rng(1)
        x = rng.standard_normal((6, 4, 8)).astype(np.float32)
        pos = np.asarray([0, 1, 5, 77, 1000, 4095], np.int32)
        want = jllama.rope_spec(jspec, jnp.asarray(x), jnp.asarray(pos))
        got = llama.rope_spec(tspec, torch.from_numpy(x), torch.from_numpy(pos))
        _close(got, want, atol=1e-5)


# ------------------------------------------------------------------
# fp8 KV pools (kv_dtype="fp8"): QuantPools on both sides. Logits at f32
# within ATOL. The pools pass through matmuls and rope, whose sin / cos may
# differ by an ulp, so they are held dequantized: every element within one
# e4m3 step (at the larger of the two values and scales), and at least
# 99.9% of the value bytes identical. One such flipped byte moves a later
# step's logits by more than ATOL, so each decode step starts from the
# reference's pool bytes.


def _fp8_caches(tspec, jspec):
    jk, jv = jllama.init_cache(jspec, NUM_PAGES, PAGE, kv_dtype="fp8")
    tk, tv = llama.init_cache(tspec, NUM_PAGES, PAGE, device="cpu", kv_dtype="fp8")
    return (jk, jv), (tk, tv)


def _e4m3_step(mag: np.ndarray) -> np.ndarray:
    """Gap between neighbouring e4m3 values at |x| (3 mantissa bits;
    subnormal spacing 2^-9 below 2^-6)."""
    e = np.floor(np.log2(np.maximum(mag, 2.0 ** -6)))
    return 2.0 ** (e - 3)


def _assert_fp8_pools_close(t_pools, j_pools, pages):
    """Both pools (K and V) on ``pages``: each dequantized element within
    one e4m3 step, and >= 99.9% of the value bytes identical."""
    same = total = 0
    for t_pool, j_pool in zip(t_pools, j_pools):
        tv = t_pool.vals[:, pages].view(torch.uint8).numpy()
        jv = np.asarray(j_pool.vals)[:, pages].view(np.uint8)
        same, total = same + (tv == jv).sum(), total + tv.size
        tq = t_pool.vals[:, pages].float().numpy()
        jq = np.asarray(j_pool.vals[:, pages].astype(jnp.float32))
        ts = t_pool.scale[:, pages].float().numpy()[..., None, None]
        js = np.asarray(j_pool.scale[:, pages].astype(jnp.float32))[..., None, None]
        step = _e4m3_step(np.maximum(np.abs(tq), np.abs(jq))) * np.maximum(ts, js)
        diff = np.abs(tq * ts - jq * js)
        assert (diff <= step + 1e-12).all(), float((diff / step).max())
    assert same / total >= 0.999, (same, total)


def _copy_fp8_pools(t_pools, j_pools):
    """Overwrite the port's pools with the reference's bytes."""
    for t_pool, j_pool in zip(t_pools, j_pools):
        t_pool.vals.view(torch.uint8).copy_(
            torch.from_numpy(np.asarray(j_pool.vals).view(np.uint8).copy()))
        t_pool.scale.view(torch.int16).copy_(
            torch.from_numpy(np.asarray(j_pool.scale).view(np.int16).copy()))


def _fresh_jit(fn, spec):
    """A jit of ``fn`` (with ``spec`` bound) that no earlier trace can
    serve: the reference reads DYNAMO_PALLAS / DYNAMO_FUSED_DECODE while
    tracing, and JAX caches traces per function object."""
    return jax.jit(lambda *args: fn(spec, *args))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_fp8_prefill_and_decode_match(fused, monkeypatch):
    """Packed prefill (one prompt behind a cached page, one padded row)
    then two decode steps over fp8 pools, through the fused path and
    through the unfused pair. The port follows the reference's Pallas
    routes, so the reference runs with DYNAMO_PALLAS=1 (interpret mode):
    the fused kernel reads the destination page before its requantizing
    append, and the unfused pair appends, then v3 reads the new row back at
    fp8. (Its XLA route appends first and overlays the exact row: when a
    scale grows, the older rows of that page read requantized.)"""
    tspec, jspec, jp, tp = _models(seed=6)
    (jk, jv), (tk, tv) = _fp8_caches(tspec, jspec)
    N, T = 4, 8
    lens, starts = [5, 8, 3, 0], [0, 0, 4, 0]
    bts = np.zeros((N, P), np.int32)
    bts[0, :2] = [1, 2]
    bts[1, :3] = [3, 4, 5]
    bts[2, :2] = [6, 7]
    rng = np.random.default_rng(2)
    tokens = np.zeros((N, T), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 97, n)
    # the cached page of prompt 2 comes from an earlier prefill
    cached = np.zeros((1, T), np.int32)
    cached[0, :4] = rng.integers(0, 97, 4)
    args = (np.asarray([0], np.int32), [4])
    _, jk, jv, _ = jllama.prefill_forward_batch(
        jspec, jp, jnp.asarray(cached), jnp.asarray(bts[2:3]),
        jnp.asarray(args[0]), jk, jv, jnp.asarray(args[1], jnp.int32))
    llama.prefill_forward_batch(tspec, tp, torch.from_numpy(cached),
                                torch.from_numpy(bts[2:3]), torch.tensor([0]),
                                tk, tv, torch.tensor([4]))
    want, jk, jv, _ = jllama.prefill_forward_batch(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts),
        jnp.asarray(starts, jnp.int32), jk, jv, jnp.asarray(lens, jnp.int32))
    got = llama.prefill_forward_batch(
        tspec, tp, torch.from_numpy(tokens), torch.from_numpy(bts),
        torch.tensor(starts), tk, tv, torch.tensor(lens))
    _close(got[:3], np.asarray(want)[:3])
    live = list(range(1, 8))
    _assert_fp8_pools_close((tk, tv), (jk, jv), live)

    monkeypatch.setenv("DYNAMO_FUSED_DECODE", fused)
    monkeypatch.setenv("DYNAMO_PALLAS", "1")
    decode = _fresh_jit(jllama.decode_forward_impl, jspec)
    active = np.asarray([True, True, True, False])
    seq = np.asarray([6, 9, 8, 1], np.int32)
    toks = np.asarray([11, 12, 13, 0], np.int32)
    for _ in range(2):
        _copy_fp8_pools((tk, tv), (jk, jv))
        want, jk, jv = decode(jp, jnp.asarray(toks), jnp.asarray(bts),
                              jnp.asarray(seq), jk, jv, jnp.asarray(active))
        got = llama.decode_forward(tspec, tp, torch.from_numpy(toks),
                                   torch.from_numpy(bts), torch.from_numpy(seq),
                                   tk, tv, torch.from_numpy(active))
        _close(got[active], np.asarray(want)[active])
        _assert_fp8_pools_close((tk, tv), (jk, jv), live)
        toks = np.asarray(want).argmax(-1).astype(np.int32)
        seq = seq + active
