"""Decode bursts: the port's ``decode_steps`` (models/llama.py) against the
JAX package's, and the graph runner (engine/graphs.py) against
``decode_steps``.

``decode_steps`` runs the one-step function ``decode_step_`` that the CUDA
graphs capture; on the CPU the runner calls that function eagerly over its
static tensors, with the same staging, feeds and record layout it uses on
the card. So the runner must give exactly ``decode_steps``' tokens,
logprobs and pool bytes (bitwise: one function on one backend), and
``decode_steps`` must match JAX's: tokens identical on a peaked spec
(greedy and seeded sampled rows), logprobs within 1e-4 (f32 logits that
differ by sums in another order), top ids identical. fp8 pools run the
reference's Pallas route (``DYNAMO_PALLAS=1``), which the port's kernels
follow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.engine.graphs import DecodeGraphs
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.ops.quant import QuantPool, is_quant

pytestmark = pytest.mark.unit

ATOL = 1e-4
SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
PAGE, P, NUM_PAGES = 4, 8, 33
# input embeddings scaled (tests/test_quant_goldens.py): no greedy token on
# a near-tie, while the sampled rows still draw off the argmax
EMBED_SCALE = 8.0
PROMPTS = [[5, 6, 7, 8, 9], [1, 2, 3], [40, 41], [60, 61, 62, 63, 64, 65, 66]]
# row 2 inactive; row 1 sampled with a seed and top-k, row 3 sampled plain
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


def _setup(kv_dtype="bf16", seed=5):
    """Both models on the same peaked weights, with the prompts prefilled
    into their pools (slot i owns pages 1 + 4i .. 4 + 4i)."""
    jspec, tspec = JaxSpec(**SPEC_KW), ModelSpec(**SPEC_KW)
    jp = dict(jllama.init_params(jspec, jax.random.PRNGKey(seed)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    tp = params_from_numpy(tspec, jax.tree.map(np.asarray, jp), device="cpu")
    jk, jv = jllama.init_cache(jspec, NUM_PAGES, PAGE, kv_dtype=kv_dtype)
    tk, tv = llama.init_cache(tspec, NUM_PAGES, PAGE, device="cpu", kv_dtype=kv_dtype)
    B = len(PROMPTS)
    bts = np.zeros((B, P), np.int32)
    tokens = np.zeros((B, 8), np.int32)
    for i, prompt in enumerate(PROMPTS):
        bts[i, :4] = np.arange(1 + 4 * i, 5 + 4 * i)
        tokens[i, : len(prompt)] = prompt
    lens = [len(p) for p in PROMPTS]
    logits, jk, jv, _ = jllama.prefill_forward_batch(
        jspec, jp, jnp.asarray(tokens), jnp.asarray(bts),
        jnp.zeros((B,), jnp.int32), jk, jv, jnp.asarray(lens, jnp.int32))
    llama.prefill_forward_batch(tspec, tp, torch.from_numpy(tokens),
                                torch.from_numpy(bts), torch.zeros(B, dtype=torch.int64),
                                tk, tv, torch.tensor(lens))
    if is_quant(tk):
        # start from the reference's bytes (a rope ulp can flip an e4m3
        # byte; tests/test_torch_llama.py)
        for t_pool, j_pool in ((tk, jk), (tv, jv)):
            t_pool.vals.view(torch.uint8).copy_(
                torch.from_numpy(np.asarray(j_pool.vals).view(np.uint8).copy()))
            t_pool.scale.view(torch.int16).copy_(
                torch.from_numpy(np.asarray(j_pool.scale).view(np.int16).copy()))
    first = np.asarray(logits).argmax(-1).astype(np.int32)
    seq_lens = np.asarray(lens, np.int32) + 1
    return (jspec, jp, jk, jv), (tspec, tp, tk, tv), bts, first, seq_lens


def _clone(pool):
    return QuantPool(pool.vals.clone(), pool.scale.clone()) if is_quant(pool) else pool.clone()


def _pool_bytes(pool):
    if is_quant(pool):
        return torch.cat([pool.vals.view(torch.uint8).reshape(-1),
                          pool.scale.view(torch.uint8).reshape(-1)])
    return pool.view(torch.uint8).reshape(-1)


def _port_args(bts, first, seq_lens):
    return (torch.from_numpy(first), torch.from_numpy(bts), torch.from_numpy(seq_lens))


def _port_sampling():
    s = SAMPLING
    return (torch.from_numpy(s["active"]), torch.from_numpy(s["temperature"]),
            torch.from_numpy(s["top_k"]), torch.from_numpy(s["top_p"]),
            torch.from_numpy(s["seeds"].astype(np.int64)), torch.from_numpy(s["steps"]))


@pytest.mark.parametrize("n_logprobs", [0, 5])
@pytest.mark.parametrize("n_steps", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
def test_decode_steps_match_jax(kv_dtype, n_steps, n_logprobs, monkeypatch):
    """Tokens identical to JAX's decode_steps (greedy and seeded sampled
    rows, an inactive row), logprobs within 1e-4, top ids identical."""
    if kv_dtype == "fp8":
        monkeypatch.setenv("DYNAMO_PALLAS", "1")
    (jspec, jp, jk, jv), (tspec, tp, tk, tv), bts, first, seq_lens = _setup(kv_dtype)
    s = SAMPLING
    # a fresh jit: the reference reads DYNAMO_PALLAS while tracing
    jfn = jax.jit(lambda *a: jllama.decode_steps_impl(
        jspec, *a, n_steps=n_steps, n_logprobs=n_logprobs))
    want = jfn(jp, jnp.asarray(first), jnp.asarray(bts), jnp.asarray(seq_lens),
               jk, jv, jnp.asarray(s["active"]), jnp.asarray(s["temperature"]),
               jnp.asarray(s["top_k"]), jnp.asarray(s["top_p"]),
               jnp.asarray(s["seeds"]), jnp.asarray(s["steps"]))
    got = llama.decode_steps(tspec, tp, *_port_args(bts, first, seq_lens), tk, tv,
                             *_port_sampling(), n_steps=n_steps, n_logprobs=n_logprobs)
    if not n_logprobs:
        got = (got,)
    assert got[0].shape == (4, n_steps) and got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if n_logprobs:
        act = s["active"]
        np.testing.assert_allclose(got[1].numpy()[act], np.asarray(want[1])[act],
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_array_equal(got[2].numpy()[act], np.asarray(want[2])[act])
        np.testing.assert_allclose(got[3].numpy()[act], np.asarray(want[3])[act],
                                   atol=ATOL, rtol=ATOL)
        assert got[2].shape == (4, n_steps, n_logprobs)


def _runner(tspec, tp, tk, tv, max_steps, n_logprobs=5):
    def step(t, sampled, n_lp):
        llama.decode_step_(tspec, tp, tk, tv, t, sampled=sampled, n_logprobs=n_lp)
    return DecodeGraphs(step, batch=len(PROMPTS), pages_per_seq=P, max_steps=max_steps,
                        n_logprobs=n_logprobs, device=torch.device("cpu"))


def _inputs(first, bts, seq_lens, **over):
    s = SAMPLING
    return {"tokens": first, "block_tables": bts, "seq_lens": seq_lens,
            "active": s["active"], "temperature": s["temperature"],
            "top_k": s["top_k"], "top_p": s["top_p"], "seeds": s["seeds"],
            "steps": s["steps"], **over}


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("n_logprobs", [0, 5])
def test_runner_step_equals_decode_steps(kv_dtype, n_logprobs):
    """The runner's step function, run eagerly through its staging and
    records, gives decode_steps' tokens, logprobs and pool bytes
    exactly; its fed column is the staged tokens."""
    _, (tspec, tp, tk, tv), bts, first, seq_lens = _setup(kv_dtype)
    k2, v2 = _clone(tk), _clone(tv)
    want = llama.decode_steps(tspec, tp, *_port_args(bts, first, seq_lens), k2, v2,
                              *_port_sampling(), n_steps=3, n_logprobs=n_logprobs)
    want = want if n_logprobs else (want,)
    g = _runner(tspec, tp, tk, tv, max_steps=4)
    burst = g.dispatch(_inputs(first, bts, seq_lens), 3, sampled=True,
                       n_logprobs=n_logprobs)
    fed, toks, lp, ti, tv_ = burst.result()
    np.testing.assert_array_equal(fed, first)
    np.testing.assert_array_equal(toks, want[0].numpy())
    if n_logprobs:
        for a, b in zip((lp, ti, tv_), want[1:]):
            np.testing.assert_array_equal(a, b.numpy())
    else:
        assert lp is None
    assert torch.equal(_pool_bytes(tk), _pool_bytes(k2))
    assert torch.equal(_pool_bytes(tv), _pool_bytes(v2))
    np.testing.assert_array_equal(burst.last_tokens().numpy(), toks[:, -1])
    g.precompile()  # a no-op on the CPU
    assert g.replays == 0


def test_runner_chains_feeds_on_device():
    """Two bursts of 2 steps, the second fed on the device from the
    first's last tokens (host tokens left stale), equal one burst of 4;
    a wave feed replaces a row's token by an entry of a device tensor."""
    _, (tspec, tp, tk, tv), bts, first, seq_lens = _setup()
    k2, v2 = _clone(tk), _clone(tv)
    want = llama.decode_steps(tspec, tp, *_port_args(bts, first, seq_lens), k2, v2,
                              *_port_sampling(), n_steps=4)
    g = _runner(tspec, tp, tk, tv, max_steps=2)
    a = g.dispatch(_inputs(first, bts, seq_lens), 2, sampled=True, n_logprobs=0)
    act = SAMPLING["active"].astype(np.int32)
    src = np.where(SAMPLING["active"], 0, -1).astype(np.int32)
    b = g.dispatch(_inputs(np.zeros(4, np.int32), bts, seq_lens + 2 * act,
                           steps=SAMPLING["steps"] + 2),
                   2, sampled=True, n_logprobs=0, feeds=[a.last_tokens()],
                   feed_src=src, feed_idx=np.arange(4, dtype=np.int32))
    got = np.concatenate([a.result()[1], b.result()[1]], axis=1)
    np.testing.assert_array_equal(got[SAMPLING["active"]],
                                  want.numpy()[SAMPLING["active"]])
    # outside trash page 0, which the inactive row writes with its token
    assert torch.equal(tk[:, 1:], k2[:, 1:]) and torch.equal(tv[:, 1:], v2[:, 1:])
    # wave feed: rows 0 and 3 take entries 2 and 0 of a device sample
    wave = torch.tensor([7, 8, 9], dtype=torch.int32)
    c = g.dispatch(_inputs(first, bts, seq_lens), 1, sampled=False, n_logprobs=0,
                   feeds=[wave], feed_src=np.asarray([0, -1, -1, 0], np.int32),
                   feed_idx=np.asarray([2, 0, 0, 0], np.int32))
    np.testing.assert_array_equal(c.result()[0], [9, first[1], first[2], 7])
    with pytest.raises(ValueError, match="steps"):
        g.dispatch(_inputs(first, bts, seq_lens), 3, sampled=False, n_logprobs=0)
    with pytest.raises(ValueError, match="n_logprobs"):
        g.dispatch(_inputs(first, bts, seq_lens), 1, sampled=False, n_logprobs=3)
