"""The port's sampler (dynamo_tpu_torch/engine/sampling.py) against the JAX
package's (dynamo_tpu/engine/sampling.py) on the same numpy logits.

The random stream is JAX's bit for bit: threefry words equal
``jax.random.bits`` under ``fold_in(PRNGKey(seed), step)`` exactly; the
Gumbel noise may differ by an ulp (``log`` on two backends), so sampled
tokens are held equal on random logits, where no draw rides on a tie that
close. Log-probabilities agree within 1e-5 with identical top ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jsampling
from dynamo_tpu_torch.engine import sampling

pytestmark = pytest.mark.unit

SEEDS = np.asarray([0, 1, 7, 12345, 2**31 - 1, 2**31, 3_000_000_000, 2**32 - 1],
                   np.uint32)
STEPS = np.asarray([0, 1, 5, 99, 1000, 2**20 + 3, 2**31 - 1, 17], np.int64)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_key(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(int(seed)), int(step) & 0xFFFFFFFF)


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a).astype(dtype) if dtype else np.asarray(a))


@pytest.mark.parametrize("n", [1, 7, 128, 1001])
def test_threefry_bits_equal_jax(n):
    """fold_in keys and the [n] uniform words equal jax.random's, bit for
    bit, over a grid of seeds (both halves of the uint32 range) and steps."""
    keys = sampling.fold_in_keys(_t(SEEDS, np.int64), _t(STEPS))
    want_keys = np.stack([np.asarray(jax.random.key_data(_jax_key(s, t)))
                          if hasattr(jax.random, "key_data") else
                          np.asarray(_jax_key(s, t))
                          for s, t in zip(SEEDS, STEPS)])
    np.testing.assert_array_equal(np.stack([k.numpy() for k in keys], 1),
                                  want_keys.astype(np.int64))
    got = sampling.random_bits(keys, n).numpy().astype(np.uint32)
    want = np.stack([np.asarray(jax.random.bits(_jax_key(s, t), (n,), jnp.uint32))
                     for s, t in zip(SEEDS, STEPS)])
    np.testing.assert_array_equal(got, want)


def test_gumbel_noise_within_an_ulp_of_jax():
    """Uniform draws bit for bit; Gumbel noise -log(-log(u)) within 4 f32
    ulps of max(|g|, 1): each log may differ by an ulp, and the inner
    one's error stays absolute where g is near 0."""
    n = 257
    seeds, steps = _t(SEEDS, np.int64), _t(STEPS)
    bits = sampling.random_bits(sampling.fold_in_keys(seeds, steps), n)
    got_u = sampling.uniform_from_bits(bits).numpy()
    want_u = np.stack([np.asarray(jax.random.uniform(
        _jax_key(s, t), (n,), minval=np.finfo(np.float32).tiny, maxval=1.0))
        for s, t in zip(SEEDS, STEPS)])
    np.testing.assert_array_equal(got_u, want_u)
    got = sampling.gumbel_noise(seeds, steps, n).numpy()
    want = np.stack([np.asarray(jax.random.gumbel(_jax_key(s, t), (n,)))
                     for s, t in zip(SEEDS, STEPS)])
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert (np.abs(got - want) <= 4 * ulp).all()


@pytest.mark.parametrize("masks", ["none", "top_k", "top_p", "both"])
def test_seeded_tokens_equal_jax(masks):
    """Seeded sampled tokens equal dynamo_tpu.engine.sampling.sample_tokens
    on the same logits over 16 steps, greedy rows (temperature 0) among
    them, with and without top-k / top-p."""
    rng = np.random.default_rng(11)
    B, V = 8, 300
    logits = (rng.standard_normal((B, V)) * 2.5).astype(np.float32)
    temps = np.asarray([0.8, 1.0, 0.0, 0.5, 1.3, 0.8, 2.0, 0.0], np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    if masks in ("top_k", "both"):
        top_k[:] = [0, 5, 3, 40, 0, 1, 10, 2]
    if masks in ("top_p", "both"):
        top_p[:] = [0.9, 1.0, 0.5, 0.7, 0.95, 1.0, 0.3, 1.0]
    differ = 0
    for step in range(16):
        steps = np.full(B, step, np.int32)
        want = np.asarray(jsampling.sample_tokens(
            logits, temps, top_k, top_p, SEEDS, steps))
        got = sampling.sample_tokens(
            _t(logits), _t(temps), _t(top_k), _t(top_p), _t(SEEDS, np.int64),
            _t(steps)).numpy()
        np.testing.assert_array_equal(got, want)
        differ += int((want != logits.argmax(-1)).sum())
    assert differ > 0  # the draws are not all the argmax


def test_greedy_tokens_first_maximum():
    logits = np.zeros((2, 9), np.float32)
    logits[0, [2, 5]] = 1.0
    logits[1, 8] = 3.0
    assert sampling.greedy_tokens(_t(logits)).tolist() == [2, 8]


@pytest.mark.parametrize("n_top", [0, 1, 5, 20])
def test_token_logprobs_match_jax(n_top):
    """Sampled logprobs and top-n values within 1e-5, top ids identical."""
    rng = np.random.default_rng(n_top)
    logits = (rng.standard_normal((6, 128)) * 4).astype(np.float32)
    sampled = rng.integers(0, 128, 6).astype(np.int32)
    want = jsampling.token_logprobs(logits, sampled, n_top)
    got = sampling.token_logprobs(_t(logits), _t(sampled), n_top)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5, rtol=0)
    assert got[1].shape == (6, max(n_top, 1)) and got[1].dtype == torch.int32
