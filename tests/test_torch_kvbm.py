"""The port's KVBM (dynamo_tpu_torch/kvbm/, the checksum, the packed fp8
block, the families' page movement and the engine's offload and onboard)
held against the JAX package's, bit for bit wherever bytes move.

Engines of both packages get the same weights (the JAX init through
params_from_numpy, the embedding scaled for peaked logits) on f32 specs:
the reference's ``kv_checksum`` cannot hash an ``ml_dtypes.bfloat16``
array (no buffer export), so its engine cannot offload bf16 blocks; the
port's bf16 path (blocks as ``uint16`` bits) is held to the port's own
device pools instead. fp8 engines run the JAX side on its Pallas route
(``DYNAMO_PALLAS=1``), the route the port follows.
"""

import asyncio
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dynamo_tpu.kvbm as jkvbm
import dynamo_tpu.ops.quant as jquant
import dynamo_tpu.runtime.context as jctx
import dynamo_tpu.runtime.integrity as jint
import dynamo_tpu_torch.kvbm as tkvbm
import dynamo_tpu_torch.ops.quant as tquant
import dynamo_tpu_torch.runtime.context as tctx
import dynamo_tpu_torch.runtime.integrity as tint
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.models import family as jfamily
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import mla as jmla
from dynamo_tpu.tokens import TokenBlockSequence as JaxSeq
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.models import family as tfamily
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.tokens import TokenBlockSequence

pytestmark = pytest.mark.unit

SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=64, max_pages_per_seq=16,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
EMBED_SCALE = 8.0  # peaked logits: greedy streams agree across packages
PROMPT = list(range(30, 43))  # 3 full pages of 4 and one token


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_WEIGHTS: dict = {}


def _weights(mla=False):
    if mla not in _WEIGHTS:
        if mla:
            jspec, tspec = JaxSpec.tiny_deepseek(), ModelSpec.tiny_deepseek()
            jp = jax.tree.map(np.asarray, jmla.init_params(jspec, jax.random.PRNGKey(3)))
        else:
            jspec, tspec = JaxSpec(**SPEC_KW), ModelSpec(**SPEC_KW)
            jp = jax.tree.map(np.asarray, jllama.init_params(jspec, jax.random.PRNGKey(3)))
        jp["embed"] = jp["embed"] * EMBED_SCALE
        _WEIGHTS[mla] = (jspec, tspec, jp, params_from_numpy(tspec, jp, device="cpu"))
    return _WEIGHTS[mla]


SIDES = {
    "jax": SimpleNamespace(Engine=JaxEngine, Config=JaxEngineConfig, kvbm=jkvbm,
                           ctx=jctx, integ=jint, spec=lambda w: w[0], params=lambda w: w[2],
                           kw={}),
    "port": SimpleNamespace(Engine=InferenceEngine, Config=EngineConfig, kvbm=tkvbm,
                            ctx=tctx, integ=tint, spec=lambda w: w[1], params=lambda w: w[3],
                            kw={"device": "cpu"}),
}


def _engine(m, kvbm=None, mla=False, **cfg):
    w = _weights(mla)
    return m.Engine(m.spec(w), m.Config(**{**CFG_KW, **cfg}), params=m.params(w),
                    kvbm=kvbm, **m.kw)


async def _run(eng, m, tokens, n=6):
    out = []
    req = {"token_ids": list(tokens), "sampling": {"temperature": 0.0},
           "stop_conditions": {"max_tokens": n, "ignore_eos": True}}
    async for item in eng.generate(req, m.ctx.Context()):
        assert item.get("finish_reason") != "error", item
        out.extend(item.get("token_ids") or [])
    return out


def _bytes(a) -> np.ndarray:
    """Any block or array (numpy, ml_dtypes, jax, torch) as its raw bytes."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy().reshape(-1) if a.element_size() == 1 else \
            a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy() \
             .view(np.uint8).reshape(-1)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).reshape(-1)


# ------------------------------------------------------------- checksums


def _checksum_case(case):
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    return {
        "bytes": (b"kv block bytes",),
        "f32": (f32, f32 + 1.0),
        "u8": (rng.integers(0, 256, (2, 68), dtype=np.uint8),),
        "bf16_bits": (f32.astype(ml_dtypes.bfloat16).view(np.uint16),),
        "strided": (f32[:, 1], None, f32[..., ::2]),
    }[case]


@pytest.mark.parametrize("case", ["bytes", "f32", "u8", "bf16_bits", "strided"])
def test_kv_checksum_matches_reference(case):
    parts = _checksum_case(case)
    assert tint.kv_checksum(*parts) == jint.kv_checksum(*parts)
    # a bf16 block's value: its uint16 bits hash as the bf16 array's bytes
    # (the reference's kv_checksum raises on the ml_dtypes array itself)
    if case == "bf16_bits":
        bf = parts[0].view(ml_dtypes.bfloat16)
        assert tint.kv_checksum(parts[0]) == jint.kv_checksum(bf.tobytes())


def test_verify_checksum_raises_integrity_error_and_counts():
    k = np.arange(64, dtype=np.uint8)
    tint.verify_checksum(tint.kv_checksum(k), k, path="kvbm.test")
    tint.verify_checksum(None, k, path="kvbm.test")  # unstamped: trivially ok
    before = tint.integrity_snapshot().get("kvbm.test", 0)
    with pytest.raises(tint.IntegrityError, match="kvbm.test") as e:
        tint.verify_checksum(tint.kv_checksum(k) ^ 1, k, path="kvbm.test")
    assert isinstance(e.value, tctx.StreamError)
    assert tint.integrity_snapshot()["kvbm.test"] == before + 1


# --------------------------------------------------------- packed fp8 block


def _quant_pools(layout, seed=0):
    """The same random QuantPool in both packages: GQA ``[L, NP, KH, page,
    D]`` with scales ``[L, NP, KH]``, or the MLA latent ``[L, NP, page, D]``
    with per-row scales ``[L, NP, page]``."""
    rng = np.random.default_rng(seed)
    shape = (2, 9, 2, 4, 8) if layout == "gqa" else (2, 9, 4, 24)
    vals = rng.integers(0, 0x7F, shape, dtype=np.uint8)
    scale = rng.uniform(0.01, 2.0, shape[:3]).astype(ml_dtypes.bfloat16)
    jp = jquant.QuantPool(jnp.asarray(vals).view(jnp.float8_e4m3fn), jnp.asarray(scale))
    tp = tquant.QuantPool(torch.from_numpy(vals.copy()).view(torch.float8_e4m3fn),
                          torch.from_numpy(scale.view(np.uint16).view(np.int16).copy())
                          .view(torch.bfloat16))
    return jp, tp


@pytest.mark.parametrize("layout", ["gqa", "mla"])
def test_packed_codec_bytes_match_reference(layout):
    jp, tp = _quant_pools(layout)
    ids = [5, 1, 8]
    assert tquant.packed_bytes_per_page(tp) == jquant.packed_bytes_per_page(jp)
    assert tquant.packed_scale_bytes(tp) == jquant.packed_scale_bytes(jp)
    want = np.asarray(jquant.pack_pages(jp, jnp.asarray(ids)))
    got = tquant.pack_pages(tp, torch.tensor(ids))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    jv, js = jquant.unpack_pages(jnp.asarray(want), jp.vals.shape[2:], jp.scale.shape[2:])
    tv, ts = tquant.unpack_pages(torch.from_numpy(want.copy()), tuple(tp.vals.shape[2:]),
                                 tuple(tp.scale.shape[2:]))
    assert np.array_equal(_bytes(tv), _bytes(jv)) and np.array_equal(_bytes(ts), _bytes(js))


def _block_case(case):
    _jp, tp = _quant_pools("gqa", seed=1)
    n, tail = tquant.packed_bytes_per_page(tp), tquant.packed_scale_bytes(tp)
    k = tquant.pack_pages(tp, torch.tensor([3]))[:, 0].numpy().copy()
    v = k[::-1].copy()
    nan = np.array([np.nan], dtype=ml_dtypes.bfloat16).view(np.uint8)
    inf = np.array([np.inf], dtype=ml_dtypes.bfloat16).view(np.uint8)
    if case == "truncated":
        k = k[:, :-1]
    elif case == "nan_scale":
        k[1, -2:] = nan
    elif case == "inf_scale":
        v[0, n - tail: n - tail + 2] = inf
    elif case == "wrong_dtype":
        k = k.astype(np.int16)
    elif case == "wrong_ndim":
        k = k.reshape(-1)
    return (k, v), n, tail


@pytest.mark.parametrize("case", ["good", "truncated", "nan_scale", "inf_scale",
                                  "wrong_dtype", "wrong_ndim"])
def test_packed_block_ok_matches_reference(case):
    block, n, tail = _block_case(case)
    want = jquant.packed_block_ok(block, n, tail)
    assert tquant.packed_block_ok(block, n, tail) is want
    assert want is (case == "good")


# -------------------------------------------------- page extract / insert


def _pools_for(fam_name, kv):
    """(JAX family, its pools, port family, its pools), pools filled with the
    same random bytes."""
    rng = np.random.default_rng(11)
    if fam_name == "gqa":
        jspec = JaxSpec(**{**SPEC_KW, "dtype": "bfloat16" if kv == "bf16" else "float32"})
        tspec = ModelSpec(**{**SPEC_KW, "dtype": jspec.dtype})
    else:
        jspec, tspec = JaxSpec.tiny_deepseek(), ModelSpec.tiny_deepseek()
    jf, tf = jfamily.get_family(jspec), tfamily.get_family(tspec)
    kv_dtype = "fp8" if kv == "fp8" else "bf16"
    jpools = jf.init_cache(jspec, 9, 4, kv_dtype=kv_dtype)
    tpools = tf.init_cache(tspec, 9, 4, device="cpu", kv_dtype=kv_dtype)

    def fill(jpool, tpool):
        if tquant.is_quant(tpool):
            vals = rng.integers(0, 0x7F, tuple(tpool.vals.shape), dtype=np.uint8)
            scale = rng.uniform(0.01, 2.0, tuple(tpool.scale.shape)).astype(
                ml_dtypes.bfloat16)
            tpool.vals.view(torch.uint8).copy_(torch.from_numpy(vals))
            tpool.scale.view(torch.int16).copy_(torch.from_numpy(scale.view(np.int16)))
            return jquant.QuantPool(jnp.asarray(vals).view(jnp.float8_e4m3fn),
                                    jnp.asarray(scale))
        if tpool.numel() == 0:  # MLA's empty v placeholder
            return jpool
        x = rng.standard_normal(tuple(tpool.shape)).astype(np.float32)
        tpool.copy_(torch.from_numpy(x).to(tpool.dtype))
        return jnp.asarray(x).astype(jpool.dtype)

    jpools = tuple(fill(j, t) for j, t in zip(jpools, tpools))
    return jf, jpools, tf, tpools


def _ptr(pool):
    return (pool.vals if tquant.is_quant(pool) else pool).data_ptr()


@pytest.mark.parametrize("fam_name,kv", [("gqa", "f32"), ("gqa", "bf16"), ("gqa", "fp8"),
                                         ("mla", "f32"), ("mla", "fp8")])
def test_page_extract_insert_match_reference(fam_name, kv):
    jf, (jk, jv), tf, (tk, tv) = _pools_for(fam_name, kv)
    ids = [6, 2, 7]
    jkb, jvb = jf.extract_pages(jk, jv, jnp.asarray(ids))
    tkb, tvb = tf.extract_pages(tk, tv, torch.tensor(ids))
    assert tuple(tkb.shape) == jkb.shape and tuple(tvb.shape) == jvb.shape
    assert np.array_equal(_bytes(tkb), _bytes(jkb))
    assert np.array_equal(_bytes(tvb), _bytes(jvb))
    if fam_name == "mla":  # the reference's inert v slot, exactly
        assert tvb.dtype == torch.int8 and tuple(tvb.shape) == (1, len(ids))
    # insert into other pages: in place, the pools' storage unchanged
    dst = [1, 5, 8]
    ptrs = (_ptr(tk), _ptr(tv))
    jk2, jv2 = jf.insert_pages(jk, jv, jnp.asarray(dst), jkb, jvb)
    assert tf.insert_pages(tk, tv, torch.tensor(dst), tkb, tvb) is None
    assert (_ptr(tk), _ptr(tv)) == ptrs
    for jpool, tpool in ((jk2, tk), (jv2, tv)):
        if tquant.is_quant(tpool):
            assert np.array_equal(_bytes(tpool.vals), _bytes(jpool.vals))
            assert np.array_equal(_bytes(tpool.scale), _bytes(jpool.scale))
        elif tpool.numel():  # not MLA's placeholder (the packages' differ)
            assert np.array_equal(_bytes(tpool), _bytes(jpool))
    again_t = tf.extract_pages(tk, tv, torch.tensor(dst))[0]
    assert np.array_equal(_bytes(again_t), _bytes(tkb))


# ---------------------------------------------------------------- pools


def _block(fill, nbytes=256):
    n = max(nbytes // 8, 2)
    k = np.full((n,), fill, np.float32)
    return k, k + 0.5


def _pool_state(pool):
    return [(sh, _bytes(k).tobytes(), _bytes(v).tobytes())
            for sh, (k, v) in pool._blocks.items()], pool.used_bytes


def test_host_pool_lru_sequence_matches_reference():
    """tests/test_kvbm.py's host-pool sequence on both packages: the same
    evictions in the same order, contents, order and bytes."""
    res = {}
    for name, m in SIDES.items():
        evicted = []
        pool = m.kvbm.HostBlockPool(1000, on_evict=lambda sh, k, v: evicted.append(sh))
        k, v = _block(1.0, 400)
        cap = 1000 // (k.nbytes + v.nbytes)
        puts = [pool.put(i, *_block(float(i), 400)) for i in range(cap)]
        pool.get(0)
        puts.append(pool.put(99, *_block(9.9, 400)))
        puts.append(pool.put(500, np.zeros(2000, np.float32), np.zeros(2000, np.float32)))
        state = _pool_state(pool)
        pool.clear()
        res[name] = (puts, evicted, state, len(pool), pool.used_bytes)
    assert res["port"] == res["jax"]
    assert res["port"][1] == [1] and res["port"][0][-1] is False


def test_disk_pool_and_manager_sequences_match_reference(tmp_path):
    """test_kvbm.py's disk persistence, G3 -> G2 promotion and G2 -> G3
    cascade sequences: equal blocks, order, bytes and stats."""
    res = {}
    for name, m in SIDES.items():
        d = tmp_path / name
        pool = m.kvbm.DiskBlockPool(str(d / "kv"), 1 << 20)
        k, v = _block(3.25)
        assert pool.put(42, k, v)
        got = pool.get(42)
        reopened = m.kvbm.DiskBlockPool(str(d / "kv"), 1 << 20)
        got2 = reopened.get(42)
        mgr = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(
            host_bytes=1 << 20, disk_bytes=1 << 20, disk_dir=str(d / "m1")))
        mgr.disk.put(5, *_block(7.0))
        promoted = (5 in mgr.host, _bytes(mgr.get(5)[0]).tobytes(), 5 in mgr.host)
        casc = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(
            host_bytes=800, disk_bytes=1 << 20, disk_dir=str(d / "m2")))
        for i in range(6):
            casc.offer(i, *_block(float(i), 400))
        res[name] = (
            [_bytes(x).tobytes() for x in (*got, *got2)], reopened.used_bytes,
            list(reopened._order), promoted, mgr.stats.to_dict(),
            list(casc.host._blocks), list(casc.disk._order), casc.disk.used_bytes,
            casc.tier_bytes(), casc.stats.to_dict())
    assert res["port"] == res["jax"]
    assert res["port"][3][:1] == (False,) and res["port"][3][2] is True


def _fp8_block(fill=3, layers=2, nbytes=130):
    k = np.arange(layers * nbytes, dtype=np.uint8).reshape(layers, nbytes)
    return (k + fill) % 251, (k + fill + 100) % 251


def test_quantized_blocks_roundtrip_host_and_disk(tmp_path):
    for name, m in SIDES.items():
        mgr = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(
            host_bytes=1 << 20, disk_bytes=1 << 20, disk_dir=str(tmp_path / name)))
        k, v = _fp8_block()
        mgr.offer(11, k, v)
        mgr.disk.put(12, k, v)
        for sh in (11, 12):
            got = mgr.get(sh)
            assert got[0].dtype == np.uint8 and got[1].dtype == np.uint8
            assert np.array_equal(got[0], k) and np.array_equal(got[1], v)
        assert mgr.stats.onboard_hits_disk == 1 and mgr.stats.onboard_hits_host == 1


@pytest.mark.parametrize("kind", ["f32", "u8", "bf16"])
async def test_remote_objects_equal_and_decode_across_packages(kind):
    """G4: the same block written by each package is the same object, byte
    for byte (a port bf16 block, carried as uint16 bits, names bfloat16 in
    its header); each package decodes the other's object to the block."""
    from dynamo_tpu.runtime.hub import InMemoryHub

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
    blocks = {"f32": (x, x + 7.0), "u8": _fp8_block(5),
              "bf16": (x.astype(ml_dtypes.bfloat16), (x + 1).astype(ml_dtypes.bfloat16))}
    k, v = blocks[kind]
    port_kv = (k.view(np.uint16), v.view(np.uint16)) if kind == "bf16" else (k, v)
    hub, loop = InMemoryHub(), asyncio.get_running_loop()
    cfg = dict(host_bytes=1 << 20, remote_max_blocks=8)
    jm = jkvbm.KvBlockManager(jkvbm.KvbmConfig(**cfg), hub=hub, loop=loop, namespace="j")
    tm = tkvbm.KvBlockManager(tkvbm.KvbmConfig(**cfg), hub=hub, loop=loop, namespace="t")
    assert await asyncio.to_thread(jm.remote.put, 0xB1, k, v)
    assert await asyncio.to_thread(tm.remote.put, 0xB1, *port_kv)
    j_obj = await hub.get_object(jm.remote.bucket, "00000000000000b1")
    t_obj = await hub.get_object(tm.remote.bucket, "00000000000000b1")
    assert t_obj == j_obj and tm.remote.stored_bytes == jm.remote.stored_bytes
    # each side reads the other's bucket
    jm.remote.bucket, tm.remote.bucket = tm.remote.bucket, jm.remote.bucket
    jgot = await asyncio.to_thread(jm.remote.get, 0xB1)
    tgot = await asyncio.to_thread(tm.remote.get, 0xB1)
    assert [_bytes(a).tobytes() for a in jgot] == [_bytes(a).tobytes() for a in (k, v)]
    assert [_bytes(a).tobytes() for a in tgot] == [_bytes(a).tobytes() for a in (k, v)]
    assert tgot[0].dtype == port_kv[0].dtype


# ------------------------------------------------------ engine offload/onboard


def _g2(kvbm):
    """G2's blocks as {hash: (k, v)} numpy copies."""
    return {sh: (np.array(k), np.array(v)) for sh, (k, v) in kvbm.host._blocks.items()}


def _g2_is_device(eng, kvbm, hashes) -> bool:
    """Every G2 block of ``hashes`` still in G1 is its device page, bit for
    bit (either package's engine)."""
    pages = eng.allocator.match_prefix(hashes)
    if isinstance(eng, InferenceEngine):
        ids = torch.tensor(pages)
    else:
        ids = jnp.asarray(pages)
    dk, dv = eng.fam.extract_pages(eng.k_pages, eng.v_pages, ids)
    return all(
        np.array_equal(_bytes(kvbm.host.get(sh)[0]), _bytes(dk[:, i]))
        and np.array_equal(_bytes(kvbm.host.get(sh)[1]), _bytes(dv[:, i]))
        for i, sh in enumerate(hashes[:len(pages)]))


def _same_g2(a: dict, b: dict, exact: bool) -> bool:
    """The packages' G2: the same hashes; the same bytes (``exact``: fp8,
    packed) or f32 values equal up to the two frameworks' rounding."""
    if sorted(a) != sorted(b):
        return False
    for sh in a:
        for x, y in zip(a[sh], b[sh]):
            if x.dtype != y.dtype or x.shape != y.shape:
                return False
            if exact or x.dtype != np.float32:
                if not np.array_equal(_bytes(x), _bytes(y)):
                    return False
            elif not np.allclose(x, y, rtol=1e-4, atol=1e-5):
                return False
    return True


async def _offload_onboard(m, kv="bf16", mla=False, corrupt=False):
    """Serve PROMPT, flush the offload, clear G1, serve it again (onboarded
    from G2); with ``corrupt`` re-offer one block with a NaN scale and serve
    a third time (a miss at that block, re-prefilled)."""
    kvbm = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(host_bytes=1 << 20))
    eng = _engine(m, kvbm, mla=mla, kv_dtype=kv)
    hashes = TokenBlockSequence.from_tokens(PROMPT, 4).sequence_hashes()
    out = {"want": await _run(eng, m, PROMPT)}
    eng.offload.flush()
    out["after_offload"] = kvbm.stats.to_dict()
    g2 = _g2(kvbm)
    out["g2_is_device"] = _g2_is_device(eng, kvbm, hashes)
    eng.allocator.clear_cache()
    assert eng.allocator.match_prefix(hashes) == []
    out["probe"] = eng.prefix_hit_tokens(PROMPT)
    out["got"] = await _run(eng, m, PROMPT)
    out["probe_after"] = eng.prefix_hit_tokens(PROMPT)
    out["onboarded_is_tier"] = _g2_is_device(eng, kvbm, hashes[:3])
    eng.offload.flush()
    out["after_onboard"] = kvbm.stats.to_dict()
    if corrupt:
        k, v = kvbm.host.get(hashes[1])
        bad = np.array(k, copy=True)
        bad[0, -2:] = np.array([np.nan], dtype=ml_dtypes.bfloat16).view(np.uint8)
        kvbm.host.remove(hashes[1])
        kvbm.offer(hashes[1], bad, v)  # stamped: only the scale check catches it
        eng.allocator.clear_cache()
        out["corrupt_got"] = await _run(eng, m, PROMPT)
        eng.offload.flush()
        out["after_corrupt"] = kvbm.stats.to_dict()
        # evicted, then re-sealed by the re-prefill: a finite block again
        again = kvbm.host.get(hashes[1])
        out["bad_evicted_then_resealed"] = again is not None and bool(
            np.isfinite(again[0][:, -2:].copy().view(ml_dtypes.bfloat16)
                        .astype(np.float32)).all())
    await eng.close()
    return out, g2


@pytest.mark.parametrize("kv", ["f32", "fp8"])
async def test_engine_offload_onboard_matches_jax(kv, monkeypatch):
    """An engine with KVBM offloads a prompt's sealed blocks, onboards them
    after G1 eviction, and serves the same stream; G2's blocks, the
    streams and the stats equal the JAX engine's, and the stream equals
    the port engine's without KVBM (fp8: its G1 prefix hit's, the same
    cached pages). fp8 also re-offers one block with a NaN scale: a miss,
    evicted, re-prefilled and re-offloaded, the stream unchanged."""
    kvd = "fp8" if kv == "fp8" else "bf16"
    fp8 = kv == "fp8"
    if fp8:
        monkeypatch.setenv("DYNAMO_PALLAS", "1")
    res = {name: await _offload_onboard(m, kvd, corrupt=fp8) for name, m in SIDES.items()}
    (port, port_g2), (jax_, jax_g2) = res["port"], res["jax"]
    assert port == jax_
    assert _same_g2(port_g2, jax_g2, exact=fp8) and len(port_g2) == 4
    assert port["g2_is_device"] and port["onboarded_is_tier"]
    assert port["got"] == port["want"]
    assert port["probe"] == 12 and port["probe_after"] >= 8
    assert port["after_onboard"]["onboard_hits_host"] == 3
    plain = _engine(SIDES["port"], kv_dtype=kvd)
    first = await _run(plain, SIDES["port"], PROMPT)
    hit = await _run(plain, SIDES["port"], PROMPT)
    await plain.close()
    assert first == port["want"] and hit == port["got"]
    if fp8:
        assert port["corrupt_got"] == port["want"]
        assert port["after_corrupt"]["onboard_misses"] == port["after_onboard"][
            "onboard_misses"] + 1
        # blocks 0-2 all hit G2 (their checksums hold); the scale check cuts
        # at block 1
        assert port["after_corrupt"]["onboard_hits_host"] == 6
        assert port["bad_evicted_then_resealed"]


async def test_mla_fp8_latent_onboard_matches_jax(monkeypatch):
    """tiny-deepseek on an fp8 latent pool: the latent blocks (packed, with
    the inert v slot) offload and onboard with no spurious corrupt-block
    miss, as the JAX engine's."""
    monkeypatch.setenv("DYNAMO_PALLAS", "1")
    res = {name: await _offload_onboard(m, "fp8", mla=True) for name, m in SIDES.items()}
    (port, port_g2), (jax_, jax_g2) = res["port"], res["jax"]
    assert port == jax_ and _same_g2(port_g2, jax_g2, exact=True)
    assert port["g2_is_device"] and port["onboarded_is_tier"]
    assert port["got"] == port["want"]
    assert port["after_onboard"]["onboard_hits_host"] == 3
    assert port["after_onboard"]["onboard_misses"] == port["after_offload"]["onboard_misses"]


async def test_bf16_blocks_are_the_device_pages_and_onboard_in_place():
    """A bf16 engine: each G2 block is the device pool's page bit for bit
    (uint16), the onboarded pages are the tier blocks bit for bit, the
    pools keep their storage, and the stream equals a G1 prefix hit's."""
    m = SIDES["port"]
    spec = ModelSpec(**{**SPEC_KW, "dtype": "bfloat16"})
    params = params_from_numpy(spec, _weights()[2], device="cpu")
    kvbm = tkvbm.KvBlockManager(tkvbm.KvbmConfig(host_bytes=1 << 20))
    eng = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu",
                          kvbm=kvbm)
    ptrs = (eng.k_pages.data_ptr(), eng.v_pages.data_ptr())
    hashes = TokenBlockSequence.from_tokens(PROMPT, 4).sequence_hashes()
    want = await _run(eng, m, PROMPT)
    hit = await _run(eng, m, PROMPT)
    eng.offload.flush()
    pages = eng.allocator.match_prefix(hashes)
    dev_k, dev_v = eng.fam.extract_pages(eng.k_pages, eng.v_pages, torch.tensor(pages))
    for i, sh in enumerate(hashes[:3]):
        k, v = kvbm.host.get(sh)
        assert k.dtype == np.uint16 and tuple(k.shape) == tuple(dev_k[:, i].shape)
        assert np.array_equal(_bytes(k), _bytes(dev_k[:, i]))
        assert np.array_equal(_bytes(v), _bytes(dev_v[:, i]))
    eng.allocator.clear_cache()
    got = await _run(eng, m, PROMPT)
    pages = eng.allocator.match_prefix(hashes)
    on_k, _ = eng.fam.extract_pages(eng.k_pages, eng.v_pages, torch.tensor(pages[:3]))
    for i, sh in enumerate(hashes[:3]):
        assert np.array_equal(_bytes(kvbm.host.get(sh)[0]), _bytes(on_k[:, i]))
    assert (eng.k_pages.data_ptr(), eng.v_pages.data_ptr()) == ptrs
    assert got == hit and kvbm.stats.onboard_hits_host == 3
    assert list(eng.onboards)[-1][1:] == (0, 3)
    await eng.close()


async def test_disk_tier_roundtrip_through_the_engine(tmp_path):
    """test_kvbm.py's disk sequence on both engines: a tiny G2 spills the
    prompt's blocks to G3, other prompts churn, and after G1 eviction the
    prompt onboards from disk with an unchanged stream; equal stats."""
    res = {}
    for name, m in SIDES.items():
        kvbm = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(
            host_bytes=4096, disk_bytes=1 << 20, disk_dir=str(tmp_path / name)))
        eng = _engine(m, kvbm)
        want = await _run(eng, m, PROMPT)
        eng.offload.flush()
        for base in range(3):
            await _run(eng, m, list(range(60 + base * 13, 73 + base * 13)), 2)
        eng.offload.flush()
        eng.allocator.clear_cache()
        got = await _run(eng, m, PROMPT)
        eng.offload.flush()
        res[name] = (want, got, kvbm.stats.to_dict(), kvbm.tier_bytes())
        await eng.close()
    assert res["port"] == res["jax"]
    want, got, stats, _tb = res["port"]
    assert got == want and stats["onboard_hits_disk"] >= 1


async def test_depth_filter_and_prefix_probe_match_jax():
    """max_offload_depth_blocks=1 offloads only each sequence's first
    block; the prefix probe counts G1 then the local tiers."""
    res = {}
    for name, m in SIDES.items():
        kvbm = m.kvbm.KvBlockManager(m.kvbm.KvbmConfig(host_bytes=1 << 20,
                                                       max_offload_depth_blocks=1))
        eng = _engine(m, kvbm)
        await _run(eng, m, PROMPT, 8)
        eng.offload.flush()
        probe = eng.prefix_hit_tokens(PROMPT)
        eng.allocator.clear_cache()
        res[name] = (kvbm.stats.to_dict(), probe, eng.prefix_hit_tokens(PROMPT),
                     sorted(kvbm.host._blocks))
        await eng.close()
    assert res["port"] == res["jax"]
    assert res["port"][0]["offloaded"] == 1 and res["port"][2] == 4
    hashes = JaxSeq.from_tokens(PROMPT, 4).sequence_hashes()
    assert res["port"][3] == [hashes[0]]
