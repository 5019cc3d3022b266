"""The port's decode kernels (dynamo_tpu_torch/ops/cuda/) against the JAX
package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain PyTorch version; the JAX
side runs the Pallas kernels in interpret mode. Both get the same
numpy-seeded inputs. Tolerances: f32 at 1e-5 (the two differ only in the
order of f32 sums), bf16 at 2e-2 (bf16 outputs round at slightly different
points), kv_write bitwise outside trash page 0.

On the card, chip_smoke.py holds each CUDA kernel against its plain version.
The CUDA attention kernels' own arithmetic (context splits, per-warp tiles,
the in-launch merge) is emulated at the end of this file and held against
both.
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import quant as jquant
from dynamo_tpu.ops.pallas.fused_decode import fused_decode_attention as jax_fused
from dynamo_tpu.ops.pallas.kv_write import kv_write_pallas
from dynamo_tpu.ops.pallas.paged_attention_v3 import paged_decode_attention_v3 as jax_v3
from dynamo_tpu_torch.ops import quant as tquant
from dynamo_tpu_torch.ops.cuda import fused_decode, kv_write, paged_attention_v3

pytestmark = pytest.mark.unit

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor."""
    if dtype == "bfloat16":
        return (jnp.asarray(arr, jnp.bfloat16),
                torch.from_numpy(arr.copy()).to(torch.bfloat16))
    if arr.dtype.kind == "i":
        return jnp.asarray(arr), torch.from_numpy(arr.copy())
    return jnp.asarray(arr, jnp.float32), torch.from_numpy(arr.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _decode_inputs(L=2, KH=2, G=2, page=4, D=8, B=4, P=3, seed=0,
                   seq_lens=(6, 1, 12, 9)):
    """Pools with distinct pages per sequence (page 0 = trash), per-slot
    seq_lens INCLUDING the new token, and the new token's page/offset."""
    rng = np.random.default_rng(seed)
    NP = 1 + B * P
    sl = np.asarray(seq_lens[:B], np.int32)
    bt = np.zeros((B, P), np.int32)
    for i in range(B):
        bt[i] = rng.permutation(np.arange(1 + i * P, 1 + (i + 1) * P))
    pos = sl - 1
    return {
        "q": rng.standard_normal((B, KH * G, D)).astype(np.float32),
        "k_pages": rng.standard_normal((L, NP, KH, page, D)).astype(np.float32),
        "v_pages": rng.standard_normal((L, NP, KH, page, D)).astype(np.float32),
        "k_new": rng.standard_normal((B, KH, D)).astype(np.float32),
        "v_new": rng.standard_normal((B, KH, D)).astype(np.float32),
        "bt": bt,
        "sl": sl,
        "dst_page": np.asarray([bt[i, pos[i] // page] for i in range(B)], np.int32),
        "dst_off": (pos % page).astype(np.int32),
        "sinks": rng.standard_normal((KH * G,)).astype(np.float32),
    }


FUSED_CASES = {
    # name: (input overrides, kernel options)
    "gqa": ({}, {}),
    "group4": ({"KH": 2, "G": 4}, {}),
    "window": ({}, {"window": 5}),
    "sinks": ({}, {"sinks": True}),
    "window_sinks_multichunk": ({"P": 4, "seq_lens": (15, 2, 16, 7)},
                                {"window": 6, "sinks": True, "chunk1": True}),
    "multichunk": ({"P": 4, "seq_lens": (13, 1, 16, 5)}, {"chunk1": True}),
    "all_len_one": ({"seq_lens": (1, 1, 1, 1)}, {}),
}


# every case at f32; bf16 on the cases that cover each code path once
BF16_FUSED = ("gqa", "window_sinks_multichunk")
BF16_V3 = ("gqa", "window_sinks")


@pytest.mark.parametrize("case,dtype", [
    (c, dt) for c in sorted(FUSED_CASES) for dt in ("float32", "bfloat16")
    if dt == "float32" or c in BF16_FUSED
])
def test_fused_decode_plain_matches_pallas(case, dtype):
    over, opts = FUSED_CASES[case]
    x = _decode_inputs(seed=len(case), **over)
    layer = 1
    j = {k: _both(v, dtype if v.dtype.kind == "f" else "") for k, v in x.items()}
    sinks = "sinks" if opts.get("sinks") else None
    window = opts.get("window", 0)
    got = fused_decode.fused_decode_attention(
        *(j[k][1] for k in ("q", "k_pages", "v_pages", "k_new", "v_new",
                            "bt", "sl", "dst_page", "dst_off")),
        layer=layer, window=window,
        sinks=torch.from_numpy(x["sinks"]) if sinks else None,
    )
    k_t, v_t = j["k_pages"][1], j["v_pages"][1]
    want, want_k, want_v = jax_fused(
        *(j[k][0] for k in ("q", "k_pages", "v_pages", "k_new", "v_new",
                            "bt", "sl", "dst_page", "dst_off")),
        layer=layer, window=window,
        sinks=jnp.asarray(x["sinks"]) if sinks else None,
        interpret=True, window_pages_override=1 if opts.get("chunk1") else None,
    )
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # the append is a copy: pools bitwise equal (no inactive rows here)
    np.testing.assert_array_equal(_np(k_t), _np(want_k))
    np.testing.assert_array_equal(_np(v_t), _np(want_v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_decode_inactive_slot_on_trash_page(dtype):
    """An inactive slot (seq_len 1, dst page 0) writes only the trash page;
    its output is the single-key merge, finite, on both sides."""
    x = _decode_inputs(seed=21)
    x["sl"][1] = 1
    x["dst_page"][1] = 0
    x["dst_off"][1] = 0
    j = {k: _both(v, dtype if v.dtype.kind == "f" else "") for k, v in x.items()}
    args = ("q", "k_pages", "v_pages", "k_new", "v_new", "bt", "sl",
            "dst_page", "dst_off")
    got = fused_decode.fused_decode_attention(*(j[k][1] for k in args), layer=0)
    want, want_k, _ = jax_fused(*(j[k][0] for k in args), layer=0,
                                interpret=True)
    tol = TOL[dtype]
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_np(j["k_pages"][1])[:, 1:],
                                  _np(want_k)[:, 1:])
    # the inactive row attends to nothing but itself: output == v_new
    G = x["q"].shape[1] // x["k_new"].shape[1]
    np.testing.assert_allclose(
        _np(got)[1], np.repeat(_np(j["v_new"][1])[1], G, axis=0),
        rtol=tol, atol=tol,
    )


V3_CASES = {
    "gqa": ({}, {}),
    "group4": ({"KH": 2, "G": 4}, {}),
    "window": ({}, {"window": 5}),
    "sinks": ({}, {"sinks": True}),
    "window_sinks": ({"seq_lens": (11, 3, 12, 8)}, {"window": 4, "sinks": True}),
    "short_and_full": ({"seq_lens": (1, 12, 2, 11)}, {}),
}


@pytest.mark.parametrize("case,dtype", [
    (c, dt) for c in sorted(V3_CASES) for dt in ("float32", "bfloat16")
    if dt == "float32" or c in BF16_V3
])
def test_paged_attention_v3_plain_matches_pallas(case, dtype):
    over, opts = V3_CASES[case]
    x = _decode_inputs(seed=100 + len(case), **over)
    layer = 1
    q = _both(x["q"], dtype)
    kp = _both(x["k_pages"][layer], dtype)
    vp = _both(x["v_pages"][layer], dtype)
    bt, sl = _both(x["bt"], ""), _both(x["sl"], "")
    window = opts.get("window", 0)
    sinks = x["sinks"] if opts.get("sinks") else None
    got = paged_attention_v3.paged_decode_attention_v3(
        q[1], kp[1], vp[1], bt[1], sl[1], window=window,
        sinks=torch.from_numpy(sinks) if sinks is not None else None,
    )
    want = jax_v3(
        q[0], kp[0], vp[0], bt[0], sl[0], window=window,
        sinks=jnp.asarray(sinks) if sinks is not None else None,
        interpret=True,
    )
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_kv_write_plain_matches_pallas(layer, dtype):
    """Bitwise outside page 0; rows aimed at page 0 collide there."""
    rng = np.random.default_rng(7 + layer)
    L, NP, KH, page, D, N = 2, 6, 2, 4, 8, 5
    pools = [rng.standard_normal((L, NP, KH, page, D)).astype(np.float32)
             for _ in range(2)]
    rows = [rng.standard_normal((N, KH, D)).astype(np.float32)
            for _ in range(2)]
    dst_page = np.asarray([1, 0, 3, 5, 0], np.int32)
    dst_off = np.asarray([0, 1, 2, 3, 1], np.int32)
    kp, vp = (_both(p, dtype) for p in pools)
    kn, vn = (_both(r, dtype) for r in rows)
    dp, do = _both(dst_page, ""), _both(dst_off, "")
    kv_write.kv_write(kp[1], vp[1], kn[1], vn[1], dp[1], do[1], layer=layer)
    want_k, want_v = kv_write_pallas(kp[0], vp[0], kn[0], vn[0], dp[0], do[0],
                                     layer=layer, interpret=True)
    np.testing.assert_array_equal(_np(kp[1])[:, 1:], _np(want_k)[:, 1:])
    np.testing.assert_array_equal(_np(vp[1])[:, 1:], _np(want_v)[:, 1:])
    # the other layer's page 0 is untouched on both sides
    other = 1 - layer
    np.testing.assert_array_equal(_np(kp[1])[other], _np(want_k)[other])


def test_wrappers_reject_unsupported_devices():
    """A wrapper takes the plain version only for CPU tensors; any other
    device without a kernel raises instead of falling back."""
    x = _decode_inputs()
    meta = {k: torch.from_numpy(v).to("meta") for k, v in x.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_decode.fused_decode_attention(
            *(meta[k] for k in ("q", "k_pages", "v_pages", "k_new", "v_new",
                                "bt", "sl", "dst_page", "dst_off")), layer=0)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention_v3.paged_decode_attention_v3(
            meta["q"], meta["k_pages"][0], meta["v_pages"][0], meta["bt"],
            meta["sl"])
    with pytest.raises(ValueError, match="unsupported device"):
        kv_write.kv_write(meta["k_pages"], meta["v_pages"], meta["k_new"],
                          meta["v_new"], meta["dst_page"], meta["dst_off"],
                          layer=0)


# ------------------------------------------------------------------
# The CUDA kernels' split-context arithmetic (csrc/common.cuh), emulated
# in f32: each (sequence, KV head) cuts its live pages into
# min(S, max(live pages // 8, 1)) near-equal runs (one empty run when no
# page is live; the grid's other splits leave at once); within a run, consumer warp w takes tiles w, w + 4, ... with an
# online softmax per tile; the block merges its warps, the last split
# merges the splits, then the new token as one more key, then the sinks.

NEG_INF = -1e30
KERNEL_WARPS = 4  # csrc/common.cuh kWarps
KERNEL_MIN_SPLIT_PAGES = 8  # csrc/common.cuh kMinSplitPages


@pytest.mark.parametrize("B,KH,P,sms", [
    (8, 8, 64, 132), (1, 8, 512, 132), (32, 8, 32, 132), (1, 1, 512, 132),
    (8, 8, 2, 132), (256, 8, 64, 132), (1, 2, 3, 132), (4, 2, 8, 1),
])
def test_num_splits_plan(B, KH, P, sms):
    """Every (sequence, KV head) gets at least one split, never more than
    the P page slots of its row or MAX_SPLITS; where those caps allow, the
    grid covers the SMs about twice."""
    S = paged_attention_v3.num_splits(B, KH, P, sms)
    assert 1 <= S <= min(P, paged_attention_v3.MAX_SPLITS)
    if S < min(P, paged_attention_v3.MAX_SPLITS) and B * KH < 2 * sms:
        assert 1.5 * sms <= B * KH * S <= 2.5 * sms


def _merge(parts):
    """(m, l, acc) partials -> one, scaled to the largest max."""
    m = torch.stack([p[0] for p in parts]).max(dim=0).values
    l = sum(p[1] * torch.exp(p[0] - m) for p in parts)
    acc = sum(p[2] * torch.exp(p[0] - m)[:, None] for p in parts)
    return m, l, acc


def _emulate_split_kernel(q, k_layer, v_layer, bt, sl, *, S, window=0,
                          sinks=None, new_kv=None):
    """The kernels' split-and-merge arithmetic over one layer's pool
    [NP, KH, page, D]; ``new_kv`` = (k_new, v_new) gives the fused form."""
    B, H, D = q.shape
    _, KH, page, _ = k_layer.shape
    G = H // KH
    qs = paged_attention_v3.prescale(q, None).float()
    kf, vf = k_layer.float(), v_layer.float()
    out = torch.empty(B, H, D)
    for b in range(B):
        seq_len = int(sl[b])
        ctx = seq_len - 1 if new_kv is not None else seq_len
        lo = max(seq_len - window, 0) if window else 0
        lo_p = lo // page
        n_live = max(-(-ctx // page) - lo_p, 0)
        S_b = min(S, max(n_live // KERNEL_MIN_SPLIT_PAGES, 1))  # splits used
        for kh in range(KH):
            qg = qs[b, kh * G:(kh + 1) * G]  # [G, D]
            splits = []
            for s in range(S_b):
                p_begin = lo_p + s * n_live // S_b
                n = lo_p + (s + 1) * n_live // S_b - p_begin
                warps = []
                for w in range(KERNEL_WARPS):
                    m = torch.full((G,), NEG_INF)
                    l = torch.zeros(G)
                    acc = torch.zeros(G, D)
                    for i in range(w, n, KERNEL_WARPS):
                        page_id = int(bt[b, p_begin + i])
                        pos = (p_begin + i) * page + torch.arange(page)
                        valid = (pos >= lo) & (pos < ctx)
                        sc = torch.where(valid, qg @ kf[page_id, kh].T, NEG_INF)
                        m_new = torch.maximum(m, sc.max(dim=1).values)
                        alpha = torch.exp(m - m_new)
                        p = torch.where(valid, torch.exp(sc - m_new[:, None]), 0.0)
                        vt = torch.where(valid[:, None], vf[page_id, kh], 0.0)
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ vt
                        m = m_new
                    warps.append((m, l, acc))
                splits.append(_merge(warps))
            m, l, acc = _merge(splits) if S_b > 1 else splits[0]
            if new_kv is not None:
                s_new = qg @ new_kv[0][b, kh].float()
                m_f = torch.maximum(m, s_new)
                alpha, p_new = torch.exp(m - m_f), torch.exp(s_new - m_f)
                l = l * alpha + p_new
                acc = acc * alpha[:, None] + p_new[:, None] * new_kv[1][b, kh].float()
                m = m_f
            if sinks is not None:
                sk = sinks[kh * G:(kh + 1) * G].float()
                m_s = torch.maximum(m, sk)
                c = torch.exp(m - m_s)
                l = l * c + torch.exp(sk - m_s)
                acc = acc * c[:, None]
            out[b, kh * G:(kh + 1) * G] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


SPLIT_P = 32  # page slots per row: up to 4 splits of 8 pages
SPLIT_SCENARIOS = {
    # name: (seq_lens, kernel options); pages of 4 tokens
    "base": ((1, 45, 128, 97), {}),
    # 107 - 70 = 37 starts mid-page, 18 live pages in 2 splits
    "window_across_splits": ((107, 2, 128, 90), {"window": 70}),
    "sinks": ((5, 128, 1, 67), {"sinks": True}),
}


@functools.lru_cache(maxsize=None)
def _split_reference(fused: bool, scenario: str):
    """Inputs, plain version and Pallas (interpret) outputs, f32."""
    seq_lens, opts = SPLIT_SCENARIOS[scenario]
    x = _decode_inputs(seed=50 + len(scenario), P=SPLIT_P, seq_lens=seq_lens)
    j = {k: _both(v, "float32" if v.dtype.kind == "f" else "") for k, v in x.items()}
    window = opts.get("window", 0)
    sinks = x["sinks"] if opts.get("sinks") else None
    layer = 1
    if fused:
        args = ("q", "k_pages", "v_pages", "k_new", "v_new", "bt", "sl",
                "dst_page", "dst_off")
        plain = fused_decode.fused_decode_plain(
            *(j[k][1].clone() for k in args), layer=layer, window=window,
            sinks=torch.from_numpy(sinks) if sinks is not None else None)
        pallas, _, _ = jax_fused(
            *(j[k][0] for k in args), layer=layer, window=window,
            sinks=jnp.asarray(sinks) if sinks is not None else None,
            interpret=True)
    else:
        plain = paged_attention_v3.paged_attention_v3_plain(
            j["q"][1], j["k_pages"][1][layer], j["v_pages"][1][layer],
            j["bt"][1], j["sl"][1], window=window,
            sinks=torch.from_numpy(sinks) if sinks is not None else None)
        pallas = jax_v3(
            j["q"][0], j["k_pages"][0][layer], j["v_pages"][0][layer],
            j["bt"][0], j["sl"][0], window=window,
            sinks=jnp.asarray(sinks) if sinks is not None else None,
            interpret=True)
    return x, window, sinks, _np(plain), _np(pallas)


@pytest.mark.parametrize("S", [1, 2, 3, 7, SPLIT_P])
@pytest.mark.parametrize("scenario", sorted(SPLIT_SCENARIOS))
@pytest.mark.parametrize("fused", [True, False], ids=["fused_decode", "paged_attention_v3"])
def test_split_merge_arithmetic_matches_plain_and_pallas(fused, scenario, S):
    """The kernels' split-and-merge arithmetic on a grid of S splits equals
    the plain version and the Pallas kernel (f32 at 1e-5): a sequence takes
    at most one split per 8 live pages, an empty split (m = NEG_INF, l = 0:
    seq_len 1, fused) keeps the single-key merge, and a window starting
    mid-page may cross split boundaries."""
    x, window, sinks, plain, pallas = _split_reference(fused, scenario)
    layer = 1
    got = _emulate_split_kernel(
        torch.from_numpy(x["q"]), torch.from_numpy(x["k_pages"][layer]),
        torch.from_numpy(x["v_pages"][layer]), torch.from_numpy(x["bt"]),
        torch.from_numpy(x["sl"]), S=S, window=window,
        sinks=torch.from_numpy(sinks) if sinks is not None else None,
        new_kv=(torch.from_numpy(x["k_new"]), torch.from_numpy(x["v_new"]))
        if fused else None)
    tol = TOL["float32"]
    np.testing.assert_allclose(_np(got), plain, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), pallas, rtol=tol, atol=tol)


# ------------------------------------------------------------------
# fp8 pools (QuantPool): e4m3 values with one bf16 scale per (layer, page,
# KV head). The kernels' fp8 branches against the Pallas kernels'
# quantized branches in interpret mode: outputs at the tolerances above,
# the fused append's values and scales bitwise outside trash page 0.

F8 = ml_dtypes.float8_e4m3fn


def _fp8_pools_both(x, seed):
    """x's K and V pools as fp8 QuantPools, the same bytes on both sides:
    values ~N(0, 1) after dequant, scales per (layer, page, head)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("k_pages", "v_pages"):
        u8 = np.clip(40 * x[name], -448, 448).astype(F8).view(np.uint8)
        scale = (rng.uniform(0.5, 1.5, x[name].shape[:3]) / 40).astype(np.float32)
        s16 = scale.astype(ml_dtypes.bfloat16).view(np.uint16)
        out[name] = _quant_pool_both(u8, s16)
    return out


def _quant_pool_both(u8: np.ndarray, s16: np.ndarray):
    return (
        jquant.QuantPool(jnp.asarray(u8.view(F8)),
                         jnp.asarray(s16.view(ml_dtypes.bfloat16))),
        tquant.QuantPool(torch.from_numpy(u8.copy()).view(torch.float8_e4m3fn),
                         torch.from_numpy(s16.view(np.int16).copy()).view(torch.bfloat16)),
    )


def _pool_bytes(pool) -> tuple[np.ndarray, np.ndarray]:
    """(value bytes, scale bits) of a QuantPool from either package."""
    if isinstance(pool.vals, torch.Tensor):
        return (pool.vals.view(torch.uint8).numpy(),
                pool.scale.view(torch.int16).numpy().view(np.uint16))
    return (np.asarray(pool.vals).view(np.uint8),
            np.asarray(pool.scale).view(np.uint16))


FP8_FUSED_CASES = {
    # name: (input overrides, kernel options)
    "multichunk": ({"P": 4, "seq_lens": (13, 1, 16, 5)}, {"chunk1": True}),
    "window_sinks": ({"P": 4, "seq_lens": (15, 2, 16, 7)},
                     {"window": 6, "sinks": True, "chunk1": True}),
    "inactive_trash": ({}, {"inactive": 1}),
    # every append at row 0 of a page whose last occupant left garbage and
    # a stale scale of 64
    "fresh_over_polluted": ({"seq_lens": (5, 9, 1, 9)}, {"polluted": True}),
    # new rows far above what the pages' scales encode: the scales grow
    "growth": ({}, {"growth": 60.0}),
}


@pytest.mark.parametrize("case,dtype", [
    (c, dt) for c in sorted(FP8_FUSED_CASES) for dt in ("float32", "bfloat16")
])
def test_fused_decode_fp8_plain_matches_pallas(case, dtype):
    over, opts = FP8_FUSED_CASES[case]
    x = _decode_inputs(seed=200 + len(case), **over)
    if opts.get("inactive") is not None:
        i = opts["inactive"]
        x["sl"][i], x["dst_page"][i], x["dst_off"][i] = 1, 0, 0
    x["k_new"] *= opts.get("growth", 1.0)
    x["v_new"] *= opts.get("growth", 1.0)
    layer = 1
    pools = _fp8_pools_both(x, seed=len(case))
    if opts.get("polluted"):
        for name in ("k_pages", "v_pages"):
            u8, s16 = (a.copy() for a in _pool_bytes(pools[name][1]))
            s16[layer, x["dst_page"]] = np.asarray(64.0, ml_dtypes.bfloat16).view(np.uint16)
            pools[name] = _quant_pool_both(u8, s16)
        assert (x["dst_off"] == 0).all()
    j = {k: _both(v, dtype if v.dtype.kind == "f" else "")
         for k, v in x.items() if k not in ("k_pages", "v_pages")}
    sinks = x["sinks"] if opts.get("sinks") else None
    window = opts.get("window", 0)
    kp_t, vp_t = pools["k_pages"][1], pools["v_pages"][1]
    got = fused_decode.fused_decode_attention(
        j["q"][1], kp_t, vp_t, *(j[k][1] for k in ("k_new", "v_new", "bt", "sl",
                                                   "dst_page", "dst_off")),
        layer=layer, window=window,
        sinks=torch.from_numpy(sinks) if sinks is not None else None,
    )
    want, want_k, want_v = jax_fused(
        j["q"][0], pools["k_pages"][0], pools["v_pages"][0],
        *(j[k][0] for k in ("k_new", "v_new", "bt", "sl", "dst_page", "dst_off")),
        layer=layer, window=window,
        sinks=jnp.asarray(sinks) if sinks is not None else None,
        interpret=True, window_pages_override=1 if opts.get("chunk1") else None,
    )
    tol = TOL[dtype]
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    for t_pool, j_pool in ((kp_t, want_k), (vp_t, want_v)):
        (tv, ts), (jv, js) = _pool_bytes(t_pool), _pool_bytes(j_pool)
        np.testing.assert_array_equal(tv[:, 1:], jv[:, 1:])
        np.testing.assert_array_equal(ts[:, 1:], js[:, 1:])
    live = x["dst_page"][x["dst_page"] > 0]
    new_s = kp_t.scale[layer, live].float()
    if opts.get("growth"):
        old = _pool_bytes(_fp8_pools_both(x, seed=len(case))["k_pages"][1])[1]
        old_s = torch.from_numpy(old.view(np.int16)).view(torch.bfloat16)[layer, live]
        assert (new_s > old_s.float()).all()
    if opts.get("polluted"):
        assert (new_s < 1.0).all()


FP8_V3_CASES = {
    "gqa": ({}, {}),
    "window_sinks": ({"seq_lens": (11, 3, 12, 8)}, {"window": 4, "sinks": True}),
    "short_and_full": ({"seq_lens": (1, 12, 2, 11)}, {}),
}


@pytest.mark.parametrize("case,dtype", [
    (c, dt) for c in sorted(FP8_V3_CASES) for dt in ("float32", "bfloat16")
])
def test_paged_attention_v3_fp8_plain_matches_pallas(case, dtype):
    over, opts = FP8_V3_CASES[case]
    x = _decode_inputs(seed=300 + len(case), **over)
    layer = 1
    pools = _fp8_pools_both(x, seed=len(case))
    q = _both(x["q"], dtype)
    bt, sl = _both(x["bt"], ""), _both(x["sl"], "")
    window = opts.get("window", 0)
    sinks = x["sinks"] if opts.get("sinks") else None
    kp, vp = pools["k_pages"], pools["v_pages"]
    got = paged_attention_v3.paged_decode_attention_v3(
        q[1], kp[1].layer(layer), vp[1].layer(layer), bt[1], sl[1],
        window=window, sinks=torch.from_numpy(sinks) if sinks is not None else None,
    )
    want = jax_v3(
        q[0], kp[0].vals[layer], vp[0].vals[layer], bt[0], sl[0], window=window,
        sinks=jnp.asarray(sinks) if sinks is not None else None, interpret=True,
        k_scale=kp[0].scale[layer], v_scale=vp[0].scale[layer],
    )
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


STALE = np.asarray(64.0, ml_dtypes.bfloat16).view(np.uint16)  # a recycled page's scale


def _fp8_append_case(case: str, dtype: str, layer: int = 1):
    """An fp8 append at a small size: pools of both packages with the same
    bytes, rows, their destinations, and the reference's calls (index
    groups on distinct pages, applied in order with write_new_kv).

    decode: 4 rows on distinct pages, mid-page, with 3x the amax their
    page's scale encodes. fresh_over_stale: 4 row-0 appends on pages a last
    occupant left with garbage and a scale of 64. verify: 4 slots x W 9
    rows (n = slot * W + w), starts 3, 7, 15 and 19 tokens into the table;
    siblings share pages, the start-15 run crosses at w 1 into a page at
    offset 0 that holds a stale scale, the last slot has 5 tokens and 4
    padded rows on page 0; row amaxes vary 10x, so scales grow between
    siblings. The reference lands them one position per call, as its
    verify forward does. interleaved: verify's rows in position-major
    order (n = w * 4 + slot), so a page's rows are never adjacent."""
    rng = np.random.default_rng(31 + len(case))
    L, NP, KH, page, D = 2, 16, 2, 16, 16
    u8 = [np.clip(40 * rng.standard_normal((L, NP, KH, page, D)), -448, 448)
          .astype(F8).view(np.uint8) for _ in range(2)]
    s16 = [(rng.uniform(0.5, 1.5, (L, NP, KH)) / 40).astype(ml_dtypes.bfloat16)
           .view(np.uint16) for _ in range(2)]
    if case in ("decode", "fresh_over_stale"):
        dst_page = np.asarray([3, 1, 6, 4], np.int32)
        dst_off = np.asarray([5, 9, 1, 14] if case == "decode" else [0] * 4, np.int32)
        rows = [rng.standard_normal((4, KH, D)).astype(np.float32) for _ in range(2)]
        if case == "decode":
            for r, s in zip(rows, s16):
                enc = 448 * s.view(ml_dtypes.bfloat16).astype(np.float32)[layer, dst_page]
                r *= (3 * enc / np.abs(r).max(-1))[..., None]
        else:
            for s in s16:
                s[layer, dst_page] = STALE
        calls = [np.arange(4)]
    else:
        W, slots = 9, 4
        bts = np.asarray([[2, 5, 9], [7, 1, 12], [4, 11, 14], [13, 8, 3]], np.int32)
        starts, nts = (3, 7, 15, 19), (9, 9, 9, 5)
        pos = np.asarray(starts)[:, None] + np.arange(W)[None]
        valid = np.arange(W)[None] < np.asarray(nts)[:, None]
        pg = np.where(valid, np.take_along_axis(bts, pos // page, axis=1), 0)
        off = pos % page
        for s in s16:
            s[layer, bts[2, 1]] = STALE  # the page the start-15 run enters
        amp = rng.uniform(0.3, 3.0, (slots, W, 1, 1))
        rows = [(amp * rng.standard_normal((slots, W, KH, D))).astype(np.float32)
                for _ in range(2)]
        order = (1, 0) if case == "interleaved" else (0, 1)
        rows = [r.transpose(*order, 2, 3).reshape(slots * W, KH, D) for r in rows]
        dst_page = pg.transpose(*order).reshape(-1).astype(np.int32)
        dst_off = off.transpose(*order).reshape(-1).astype(np.int32)
        idx = np.arange(slots * W).reshape((slots, W) if order == (0, 1) else (W, slots))
        calls = [idx[:, w] if order == (0, 1) else idx[w] for w in range(W)]
    pools = [_quant_pool_both(u, s) for u, s in zip(u8, s16)]
    return pools, [_both(r, dtype) for r in rows], dst_page, dst_off, calls


def _hold_fp8_append(case: str, dtype: str, layer: int = 1):
    """kv_write on CPU QuantPools (the plain version, in rounds) against
    the reference's write_new_kv applied call by call: values and scales
    bitwise outside page 0; no kernel launch."""
    from dynamo_tpu.ops.pallas.kv_write import write_new_kv

    pools, rows, dst_page, dst_off, calls = _fp8_append_case(case, dtype, layer)
    (jk, tk), (jv, tv) = pools
    (jkn, tkn), (jvn, tvn) = rows
    before = kv_write.kv_write.launches
    kv_write.kv_write(tk, tv, tkn, tvn, torch.from_numpy(dst_page),
                      torch.from_numpy(dst_off), layer=layer)
    assert kv_write.kv_write.launches == before
    for c in calls:
        jk, jv = write_new_kv(jk, jv, jkn[c], jvn[c], jnp.asarray(dst_page[c]),
                              jnp.asarray(dst_off[c]), layer=layer)
    for t_pool, j_pool in ((tk, jk), (tv, jv)):
        for u, w in zip(_pool_bytes(t_pool), _pool_bytes(j_pool)):
            np.testing.assert_array_equal(u[:, 1:], w[:, 1:])
    return dst_page, dst_off


def test_kv_write_routes_fp8_pools_to_quant_append():
    """An fp8 pool on the CPU takes the plain version, which for rows on
    distinct pages is one quant_append_rows per pool (the reference's
    route): the decode shape, bitwise; the kernel's count does not move."""
    _hold_fp8_append("decode", "float32")


@pytest.mark.parametrize("case", ["decode", "fresh_over_stale", "verify", "interleaved"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_write_fp8_plain_matches_position_order(case, dtype):
    """kv_write's fp8 form applies a page's rows in index order, one full
    requantizing append each: the reference's one-position-per-call loop,
    bit for bit, whether or not a page's rows are adjacent."""
    dst_page, dst_off = _hold_fp8_append(case, dtype)
    rounds = kv_write.append_rounds(torch.from_numpy(dst_page)).numpy()
    assert (rounds[dst_page == 0] == 0).all()
    if case in ("verify", "interleaved"):
        assert rounds.max() == 8  # a page holds all 9 rows of the start-3 slot
        assert (dst_page == 0).sum() == 4 and ((dst_off == 0) & (dst_page != 0)).sum() == 1


# ------------------------------------------------------------------
# kv_write's fp8 schedule (csrc/kv_write.cu), emulated with the port's
# codec ops: the first row of each page owns its runs; the scale chain
# (new scale and old / new after each of the page's rows, in index order)
# runs first; then each token of a run takes the last row written at it,
# quantized under that row's scale, and one e4m3 re-encode per later row
# of the page. Held bitwise against the plain version, which applies the
# rows in rounds.


def _emulate_fp8_append(pool, rows, dst_page, dst_off, layer):
    vals = pool.vals.view(torch.uint8)[layer]
    scale = pool.scale[layer]
    KH, page = vals.shape[1], vals.shape[2]
    pg, off = dst_page.tolist(), dst_off.tolist()
    for n, p in enumerate(pg):
        if p == 0 or p in pg[:n]:
            continue
        js = [j for j in range(n, len(pg)) if pg[j] == p]
        for kh in range(KH):
            cur = scale[p, kh].float()
            ns, fac = [], []
            for j in js:
                old = torch.zeros_like(cur) if off[j] == 0 else cur
                cur = tquant.append_scale(old, rows[j, kh].float()[None])[0]
                ns.append(cur)
                fac.append(tquant.rescale_factor(old, cur))
            run = vals[p, kh].view(torch.float8_e4m3fn)
            out = torch.empty_like(run)
            for t in range(page):
                at = [i for i, j in enumerate(js) if off[j] == t]
                last = at[-1] if at else -1
                v = (tquant.quant_values(rows[js[last], kh].float(), ns[last])
                     .to(torch.float8_e4m3fn) if at else run[t])
                for i in range(last + 1, len(js)):
                    v = (v.float() * fac[i]).clamp(-tquant.FP8_MAX, tquant.FP8_MAX).to(
                        torch.float8_e4m3fn)
                out[t] = v
            vals[p, kh] = out.view(torch.uint8)
            scale[p, kh] = cur.to(torch.bfloat16)


@pytest.mark.parametrize("case", ["decode", "fresh_over_stale", "verify", "interleaved"])
def test_kv_write_fp8_kernel_schedule_matches_plain(case):
    pools, rows, dst_page, dst_off, _ = _fp8_append_case(case, "bfloat16")
    (_, tk), (_, tv) = pools
    (_, tkn), (_, tvn) = rows
    dp, do = torch.from_numpy(dst_page), torch.from_numpy(dst_off)
    want = [tquant.QuantPool(p.vals.clone(), p.scale.clone()) for p in (tk, tv)]
    kv_write.kv_write_plain(*want, tkn, tvn, dp, do, layer=1)
    for pool, r in ((tk, tkn), (tv, tvn)):
        _emulate_fp8_append(pool, r, dp, do, layer=1)
    for got, w in zip((tk, tv), want):
        for u, x in zip(_pool_bytes(got), _pool_bytes(w)):
            np.testing.assert_array_equal(u[:, 1:], x[:, 1:])
