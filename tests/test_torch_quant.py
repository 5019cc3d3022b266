"""The port's fp8 KV codec (dynamo_tpu_torch/ops/quant.py) against the JAX
package's (dynamo_tpu/ops/quant.py), bit for bit.

Both sides get the same numpy-seeded values; fp8 values and bf16 scales are
compared as their bytes (uint8 / uint16 views), f32 results as their bits.
The cases cover a scale that grows 3x, a recycled page with a stale scale of
64 appended at row 0, values at and past +-448 after the division, values in
the e4m3 subnormal range, and all-zero rows (scale 0). Also the kv_dtype
setting: EngineConfig and DYN_KV_DTYPE with the reference's precedence.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.ops import quant

pytestmark = pytest.mark.unit

F8 = ml_dtypes.float8_e4m3fn
BF16 = ml_dtypes.bfloat16


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or JAX array (fp8 -> uint8, bf16 ->
    uint16, f32 -> uint32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _pool_both(vals_f32: np.ndarray, scale_f32: np.ndarray):
    """One QuantPool's bits as a JAX pool and a torch pool."""
    u8 = np.clip(vals_f32, -448, 448).astype(F8).view(np.uint8)
    s16 = scale_f32.astype(BF16).view(np.uint16)
    jpool = jquant.QuantPool(jnp.asarray(u8.view(F8)), jnp.asarray(s16.view(BF16)))
    tpool = quant.QuantPool(
        torch.from_numpy(u8.copy()).view(torch.float8_e4m3fn),
        torch.from_numpy(s16.view(np.int16).copy()).view(torch.bfloat16))
    return jpool, tpool


# rows [N, KH, D] and old scales [N, KH]: (row scale, old scale)
CODEC_CASES = {
    "random": (1.0, 0.01),
    # the rows' amax is ~3x what the old scale encodes: the scale grows
    "growth3x": (3.0, 3.5 / 448),
    # amax / 448 rounds DOWN in bf16 for some heads, so x / scale lands
    # just past 448 and the clip decides
    "beyond448": (100.0, 0.0),
    # rows far below the old scale: quotients in the e4m3 subnormal range
    "subnormal": (1e-3, 0.05),
    "zeros": (0.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_math_bitwise(case):
    """append_scale, rescale_factor and quant_values (then the e4m3 cast)
    give the reference's bits."""
    row_scale, old_scale = CODEC_CASES[case]
    rng = np.random.default_rng(len(case))
    rows = (row_scale * rng.standard_normal((6, 4, 32))).astype(np.float32)
    old = (old_scale * rng.uniform(0.5, 1.5, (6, 4))).astype(BF16).astype(np.float32)
    ns_j = jquant.append_scale(jnp.asarray(old), jnp.asarray(rows))
    ns_t = quant.append_scale(torch.from_numpy(old), torch.from_numpy(rows))
    _assert_bits(ns_t, ns_j)
    _assert_bits(quant.rescale_factor(torch.from_numpy(old), ns_t),
                 jquant.rescale_factor(jnp.asarray(old), ns_j))
    qv_j = jquant.quant_values(jnp.asarray(rows), ns_j[..., None])
    qv_t = quant.quant_values(torch.from_numpy(rows), ns_t[..., None])
    _assert_bits(qv_t, qv_j)
    _assert_bits(qv_t.to(torch.float8_e4m3fn), qv_j.astype(jquant.FP8_DTYPE))
    if case == "beyond448":
        q = np.abs(rows / ns_t.numpy()[..., None])
        assert (q > 448).any() and (np.abs(qv_t.numpy()) == 448).any()
    if case == "subnormal":
        mags = qv_t.to(torch.float8_e4m3fn).float().abs()
        assert ((mags > 0) & (mags < 2.0 ** -6)).any()  # e4m3 subnormals
    if case == "zeros":
        assert (ns_t == 0).all() and (qv_t == 0).all()


def test_quant_page_tiles_bitwise_with_partial_tail_page():
    """Prefill tiles: padded rows of a partial tail page are zeroed before
    the amax, so they cannot inflate the page's scale."""
    rng = np.random.default_rng(3)
    tiles = rng.standard_normal((5, 2, 4, 16)).astype(np.float32)
    tiles[4, :, 2:] *= 1000.0  # garbage past the real tokens
    valid = np.ones((5, 4), bool)
    valid[4, 2:] = False
    valid[3, :] = False  # a fully padded tile
    vj, sj = jquant.quant_page_tiles(jnp.asarray(tiles),
                                     jnp.asarray(valid)[:, None, :, None], (2, 3))
    vt, st = quant.quant_page_tiles(torch.from_numpy(tiles),
                                    torch.from_numpy(valid)[:, None, :, None], (2, 3))
    _assert_bits(vt, vj)
    _assert_bits(st, sj)
    assert (st[3] == 0).all() and (st[4].float() < 10 / 448).all()


APPEND_CASES = {
    # name: (row scale, dst_off per row, stale scale or None)
    "growth3x": (3.0, (1, 2, 3, 1), None),
    "fresh_over_polluted": (0.5, (0, 0, 0, 0), 64.0),
    "subnormal": (1e-3, (1, 3, 2, 1), None),
    "zero_rows": (0.0, (0, 1, 2, 3), None),
    "beyond448": (300.0, (2, 2, 0, 1), None),
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_quant_append_rows_bitwise(case):
    """The GQA append: the destination pages' values and scales after the
    append are the reference's bytes; other pages are untouched."""
    row_scale, offs, stale = APPEND_CASES[case]
    rng = np.random.default_rng(11 + len(case))
    L, NP, KH, page, D, N = 2, 7, 2, 4, 16, 4
    vals = rng.standard_normal((L, NP, KH, page, D)).astype(np.float32) * 100
    if stale is None:
        scale = rng.uniform(0.5, 1.5, (L, NP, KH)).astype(np.float32) / 448
    else:
        scale = np.full((L, NP, KH), stale, np.float32)
    rows = (row_scale * rng.standard_normal((N, KH, D))).astype(np.float32)
    if case == "growth3x":
        # each head's amax is 3x what its old scale encodes
        rows *= (3.0 * 448 * scale[1, [1, 3, 5, 6]][:, :, None]
                 / np.abs(rows).max(axis=-1, keepdims=True))
    dst_page = np.asarray([1, 3, 5, 6], np.int32)
    dst_off = np.asarray(offs, np.int32)
    jpool, tpool = _pool_both(vals, scale)
    want = jquant.quant_append_rows(jpool, jnp.asarray(rows), jnp.asarray(dst_page),
                                    jnp.asarray(dst_off), 1)
    quant.quant_append_rows(tpool, torch.from_numpy(rows), torch.from_numpy(dst_page),
                            torch.from_numpy(dst_off), 1)
    _assert_bits(tpool.vals, want.vals)
    _assert_bits(tpool.scale, want.scale)
    new_s = tpool.scale[1, dst_page].float().numpy()
    old_s = scale.astype(BF16).astype(np.float32)[1, dst_page]
    if case == "growth3x":
        assert (new_s > old_s).all()
    if case == "fresh_over_polluted":
        # the scale comes from the new rows alone, not max(64, amax / 448)
        assert (new_s < 1.0).all()
    if case == "zero_rows":
        assert (new_s[dst_off == 0] == 0).all()


def test_quant_append_rows_trash_page_duplicates():
    """Inactive slots all append to trash page 0: garbage there, every other
    page bitwise the reference's."""
    rng = np.random.default_rng(5)
    shape = (1, 4, 2, 4, 8)
    jpool, tpool = _pool_both(rng.standard_normal(shape).astype(np.float32),
                              np.full(shape[:3], 0.01, np.float32))
    rows = rng.standard_normal((4, 2, 8)).astype(np.float32)
    dst_page = np.asarray([0, 2, 0, 3], np.int32)
    dst_off = np.asarray([1, 1, 2, 0], np.int32)
    want = jquant.quant_append_rows(jpool, jnp.asarray(rows), jnp.asarray(dst_page),
                                    jnp.asarray(dst_off), 0)
    quant.quant_append_rows(tpool, torch.from_numpy(rows), torch.from_numpy(dst_page),
                            torch.from_numpy(dst_off), 0)
    _assert_bits(tpool.vals[:, 1:], np.asarray(want.vals)[:, 1:])
    _assert_bits(tpool.scale[:, 1:], np.asarray(want.scale)[:, 1:])


def test_gather_dequant_pages_and_pool_shape():
    rng = np.random.default_rng(9)
    shape = (2, 5, 2, 4, 8)
    jpool, tpool = _pool_both(rng.standard_normal(shape).astype(np.float32) * 50,
                              rng.uniform(0.001, 0.1, shape[:3]).astype(np.float32))
    bt = np.asarray([[3, 1, 4], [2, 2, 0]], np.int32)
    got = quant.gather_dequant_pages(tpool.layer(1), torch.from_numpy(bt))
    for i in range(2):
        want = jquant.gather_dequant_pages(jpool.layer(1), jnp.asarray(bt[i]))
        _assert_bits(got[i], want)
    assert tpool.shape == shape and tpool.dtype == torch.float8_e4m3fn
    assert tpool.nbytes == np.prod(shape) + 2 * np.prod(shape[:3])
    empty = quant.init_quant_pool(shape, 3)
    assert empty.scale.shape == shape[:3] and not empty.vals.float().any()


@pytest.mark.parametrize("value,env,want", [
    ("", None, "bf16"),
    ("fp8", None, "fp8"),
    ("", "fp8", "fp8"),
    ("", "e4m3", "fp8"),
    ("bf16", "fp8", "bf16"),  # an explicit value wins over the environment
    ("float8", "bf16", "fp8"),
    ("native", None, "bf16"),
])
def test_kv_dtype_setting_matches_reference(value, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("DYN_KV_DTYPE", raising=False)
    else:
        monkeypatch.setenv("DYN_KV_DTYPE", env)
    assert EngineConfig(kv_dtype=value).kv_dtype == want
    assert JaxEngineConfig(kv_dtype=value).kv_dtype == want


def test_kv_dtype_unknown_raises(monkeypatch):
    monkeypatch.delenv("DYN_KV_DTYPE", raising=False)
    with pytest.raises(ValueError, match="kv_dtype"):
        EngineConfig(kv_dtype="int4")
    monkeypatch.setenv("DYN_KV_DTYPE", "int4")
    with pytest.raises(ValueError, match="kv_dtype"):
        EngineConfig()
