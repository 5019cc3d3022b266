"""Tensor parallelism of the port (dynamo_tpu_torch/parallel/,
models/convert.shard_params, the tp forwards, the engine under SPMD
replay) held against the JAX package on ``make_mesh(tp=2|4)``.

The JAX side runs its tp mesh in this process over the 8 forced CPU
devices (tests/conftest.py). The port runs one process per rank: gloo
ranks spawned with ``torch.multiprocessing`` (a ``tcp://`` rendezvous on a
free local port), each driving the CPU with 1 thread. The rank functions
live at module level and import no JAX, so a spawned rank imports only
torch and the port. Spawns are few: one group of 2 ranks runs every engine
case, one group of 4 the prefill forwards.

Tolerances. The all-reduced partial sums are reduced in f32 (parallel/
mesh.py), so a tp forward differs from a one-rank forward by the order of
its f32 sums and the one extra rounding of each partial to the model
dtype: bf16 prefill logits agree to 3% of the logits' range (PREFILL_TOL),
f32 ones to 1e-4. Greedy streams of the peaked f32 spec are equal, token for
token. Shards are equal bit for bit.
"""

from __future__ import annotations

import asyncio
import traceback

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.models.convert import SHARD_DIMS, shard_params
from dynamo_tpu_torch.parallel.mesh import AXES, Mesh

pytestmark = pytest.mark.unit

RANK_TIMEOUT_S = 240.0
PREFILL_TOL = 0.03  # of max |logit|, bf16 weights (see module docstring)
# the peaked f32 golden spec of tests/test_torch_engine.py, KV heads over 2
ENGINE_SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      dtype="float32")
ENGINE_CFG_KW = dict(page_size=4, num_pages=96, max_pages_per_seq=16,
                     max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
EMBED_SCALE = 32.0
ENGINE_CASES = {
    "bf16": {},
    "fp8": {"kv_dtype": "fp8"},
    "spec": {"spec_mode": "ngram", "spec_k_max": 4},
    "pipelined": {"pipeline_decode": True, "decode_steps_per_dispatch": 3},
}


def _dryrun(**kw) -> ModelSpec:
    return ModelSpec(**{**ModelSpec.dryrun().__dict__, **kw})


def local_mesh(tp: int, rank: int) -> Mesh:
    """A rank's mesh coordinates without a process group: shard cutting
    needs no collective."""
    return Mesh(dict.fromkeys(AXES, 1) | {"tp": tp},
                dict.fromkeys(AXES, 0) | {"tp": rank}, torch.device("cpu"))


# ------------------------------------------------------------ rank harness


def group_store():
    """A master TCPStore on a port of its own choosing, held by this process
    for a group's life: the ranks join it as clients (``join_group``). A
    port found free, closed and bound later by rank 0 can be taken in
    between by another process (ephemeral ports are shared by every
    test worker's connections)."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)


def join_group(port: int, n: int, rank: int, timeout_s: float) -> None:
    """Join rank ``rank`` of ``n`` through the store listening on ``port``."""
    import datetime

    import torch.distributed as dist

    from dynamo_tpu_torch.parallel.multihost import initialize_multihost

    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    initialize_multihost(f"127.0.0.1:{port}", n, rank, device="cpu", timeout_s=timeout_s,
                         store=store)


def _rank_main(rank, n, port, task, args, q):
    try:
        torch.set_num_threads(1)  # up to 4 ranks beside other test workers
        from dynamo_tpu_torch.parallel.multihost import shutdown

        join_group(port, n, rank, 60)
        try:
            q.put((rank, "ok", task(rank, n, *args)))
        finally:
            shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(n: int, task, *args) -> list:
    """``task(rank, n, *args)`` on ``n`` spawned gloo ranks; their results
    in rank order (a rank's exception fails the call with its traceback)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = group_store()
    port = store.port
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, task, args, q))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        got = [q.get(timeout=RANK_TIMEOUT_S) for _ in procs]
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
        del store
    errors = [msg for _r, status, msg in got if status != "ok"]
    assert not errors, "\n".join(errors)
    return [out for _r, _s, out in sorted(got, key=lambda g: g[0])]


def _prefill_task(rank, n, spec_kw, tree, tokens, bucket):
    """Rank's prefill logits: its shard of the JAX weights, one prompt."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.mesh import make_mesh

    spec = ModelSpec(**spec_kw)
    mesh = make_mesh(tp=n)
    params = shard_params(spec, tree, mesh, device="cpu")
    k, v = llama.init_cache(spec, 9, 16, device="cpu", tp=n)
    padded = torch.zeros(bucket, dtype=torch.int32)
    padded[: len(tokens)] = torch.tensor(tokens)
    bt = torch.arange(1, 9, dtype=torch.int32)
    with torch.inference_mode():
        logits, _ = llama.prefill_forward(spec, params, padded, bt, 0, k, v, len(tokens))
        full = llama.reference_forward(spec, params, torch.tensor(tokens))
    return logits.numpy(), full.numpy()


async def _serve(eng, prompts, n_tokens):
    from dynamo_tpu_torch.runtime.context import Context

    async def one(p):
        req = {"token_ids": p, "stop_conditions": {"max_tokens": n_tokens,
                                                   "ignore_eos": True}}
        return [t for x in [x async for x in eng.generate(req, Context())]
                for t in x["token_ids"]]

    got = list(await asyncio.gather(*(one(p) for p in prompts[:-1])))
    got.append(await one(prompts[-1]))  # the sharer, once the prefix is sealed
    return got


def _pool_numpy(pool):
    from dynamo_tpu_torch.ops.quant import is_quant

    if is_quant(pool):
        return (pool.vals.view(torch.uint8).numpy().copy(),
                pool.scale.float().numpy().copy())
    return (pool.numpy().copy(),)


def _engine_task(rank, n, cases, tree, prompts, n_tokens):
    """Every engine case in turn on this group: rank 0 serves ``prompts``
    through an SPMD leader engine, the others replay as followers. Returns
    per case (streams or the replayed op counts, this rank's pools)."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub

    spec = ModelSpec(**ENGINE_SPEC_KW)
    mesh = make_mesh(tp=n)
    params = shard_params(spec, tree, mesh, device="cpu")
    out = {}

    async def one(name, extra):
        cfg = EngineConfig(**ENGINE_CFG_KW, tp=n, **extra)
        group = f"test/{name}"
        if rank == 0:
            leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                      strict=True).start()
            eng = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh,
                                  spmd=leader)
            await eng.start()
            res = await _serve(eng, prompts, n_tokens)
            await eng.close()
            res = {"streams": res, "descriptors": leader.publish_count,
                   "verifies": eng.spec_verifies,
                   "cached": dict(eng.allocator._hash_page)}
        else:
            eng = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh)
            f = SpmdFollower(StoreHub(), group, eng)
            await f.run()
            await eng.close()
            res = {"ops": f.ops}
        return res, [_pool_numpy(p) for p in (eng.k_pages, eng.v_pages)]

    for name, extra in cases.items():
        out[name] = asyncio.run(one(name, extra))
    return out


# ---------------------------------------------------------------- fixtures


def _jax_tree(spec_kw, seed=0, embed_scale=None):
    import jax

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama

    jp = dict(jllama.init_params(JaxSpec(**spec_kw), jax.random.PRNGKey(seed)))
    if embed_scale:
        jp["embed"] = jp["embed"] * embed_scale
    return jp, jax.tree.map(np.asarray, jp)


def _prompts():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, k).tolist() for k in (5, 13, 9, 22)]
    prompts.append(prompts[3][:16] + [7, 8])  # shares 4 pages with prompt 3
    return prompts


@pytest.fixture(scope="module")
def engine_runs():
    """tp=2 ranks through every engine case; the JAX engine on
    make_mesh(tp=2) and the port's one-rank engine on the same weights."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models.convert import params_from_numpy

    jp, tree = _jax_tree(ENGINE_SPEC_KW, seed=1, embed_scale=EMBED_SCALE)
    prompts = _prompts()
    ranks = run_ranks(2, _engine_task, ENGINE_CASES, tree, prompts, 8)
    spec = ModelSpec(**ENGINE_SPEC_KW)
    full = params_from_numpy(spec, tree, device="cpu")
    one = {}
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for name, extra in ENGINE_CASES.items():
            async def run(extra=extra):
                eng = InferenceEngine(spec, EngineConfig(**ENGINE_CFG_KW, **extra),
                                      params=full, device="cpu")
                await eng.start()
                got = await _serve(eng, prompts, 8)
                await eng.close()
                return (got, [_pool_numpy(p) for p in (eng.k_pages, eng.v_pages)],
                        dict(eng.allocator._hash_page))
            one[name] = asyncio.run(run())
    finally:
        torch.set_num_threads(prev)
    return {"ranks": ranks, "one": one, "jp": jp, "prompts": prompts}


async def _jax_streams(jp, prompts, extra, monkeypatch):
    from dynamo_tpu.runtime.context import Context as JaxContext
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh

    if extra.get("kv_dtype") == "fp8":
        monkeypatch.setenv("DYNAMO_PALLAS", "1")
    jeng = JaxEngine(JaxSpec(**ENGINE_SPEC_KW), JaxEngineConfig(**ENGINE_CFG_KW, **extra),
                     params=jp, mesh=jax_make_mesh(tp=2))

    async def one(p):
        req = {"token_ids": p, "stop_conditions": {"max_tokens": 8, "ignore_eos": True}}
        return [t for x in [x async for x in jeng.generate(req, JaxContext())]
                for t in x["token_ids"]]

    got = list(await asyncio.gather(*(one(p) for p in prompts[:-1])))
    got.append(await one(prompts[-1]))
    await jeng.close()
    return got


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("tp", [2, 4])
def test_param_shards_equal_jax_addressable_shards(tp):
    """shard_params of the JAX numpy tree, and of the port's full params,
    equal bit for bit each JAX array's addressable_shards[r] under
    llama.param_shardings(spec, make_mesh(tp))."""
    import jax

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu_torch.models.convert import params_from_numpy

    for tied in (True, False):
        kw = {**ModelSpec.dryrun().__dict__, "tie_embeddings": tied}
        jp, tree = _jax_tree(kw, seed=3)
        spec = ModelSpec(**kw)
        jmesh = jax_make_mesh(tp=tp)
        sharded = jax.tree.map(jax.device_put, jp,
                               jllama.param_shardings(JaxSpec(**kw), jmesh))
        full = params_from_numpy(spec, tree, device="cpu")
        for r in range(tp):
            mine = shard_params(spec, tree, local_mesh(tp, r), device="cpu")
            mine2 = shard_params(spec, full, local_mesh(tp, r))

            def check(name, got, got2, arr):
                want = np.asarray(arr.addressable_shards[r].data)
                bits = (lambda a: a.view(np.uint16)) if want.dtype.name == "bfloat16" \
                    else (lambda a: a)
                g = got.view(torch.int16).numpy().view(np.uint16) \
                    if got.dtype == torch.bfloat16 else got.numpy()
                assert g.shape == want.shape, (name, g.shape, want.shape)
                np.testing.assert_array_equal(g, bits(want), err_msg=name)
                assert torch.equal(got, got2), name

            check("embed", mine.embed, mine2.embed, sharded["embed"])
            if not tied:
                check("lm_head", mine.lm_head, mine2.lm_head, sharded["lm_head"])
            for li, lp in enumerate(sharded["layers"]):
                for name, arr in lp.items():
                    check(f"layers.{li}.{name}", getattr(mine.layers[li], name),
                          getattr(mine2.layers[li], name), arr)
            assert mine.mesh.tp_rank == r


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_kv_pool_shards_equal_jax_cache_shards(tp, kv_dtype):
    """A rank's pool after kv_write of its KV heads' rows equals, bit for
    bit outside trash page 0, the JAX pool's shard under cache_shardings
    after the JAX package's write_new_kv on the tp mesh (values, and an
    fp8 pool's scales)."""
    import jax
    import jax.numpy as jnp

    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.ops import quant as jquant
    from dynamo_tpu.ops.pallas.kv_write import write_new_kv
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops.cuda.kv_write import kv_write
    from dynamo_tpu_torch.ops.quant import is_quant

    spec = ModelSpec.dryrun()
    L, NP, KH, page, D, N = spec.num_layers, 12, spec.num_kv_heads, 16, spec.head_dim, 6
    rng = np.random.default_rng(5 + tp)
    rows = [rng.standard_normal((N, KH, D)).astype(np.float32) for _ in range(2)]
    dst_page = np.asarray([3, 5, 7, 9, 0, 11], np.int32)
    dst_off = np.asarray([0, 4, 15, 7, 2, 9], np.int32)
    jmesh = jax_make_mesh(tp=tp)
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec

    jk, jv = jllama.init_cache(JaxSpec(**ModelSpec.dryrun().__dict__), NP, page,
                               kv_dtype=kv_dtype)
    ks, vs = jllama.cache_shardings(jmesh, kv_dtype)
    jk, jv = jax.device_put(jk, ks), jax.device_put(jv, vs)
    dt = jnp.bfloat16
    jk, jv = write_new_kv(jk, jv, jnp.asarray(rows[0], dt), jnp.asarray(rows[1], dt),
                          jnp.asarray(dst_page), jnp.asarray(dst_off), layer=1,
                          mesh=jmesh)
    for r in range(tp):
        heads = slice(r * KH // tp, (r + 1) * KH // tp)
        k, v = llama.init_cache(spec, NP, page, device="cpu", kv_dtype=kv_dtype, tp=tp)
        kv_write(k, v, torch.from_numpy(rows[0][:, heads]).to(torch.bfloat16),
                 torch.from_numpy(rows[1][:, heads]).to(torch.bfloat16),
                 torch.from_numpy(dst_page), torch.from_numpy(dst_off), layer=1)
        for mine, theirs in ((k, jk), (v, jv)):
            if is_quant(mine):
                assert isinstance(theirs, jquant.QuantPool)
                want_v = np.asarray(theirs.vals.addressable_shards[r].data).view(np.uint8)
                want_s = np.asarray(theirs.scale.addressable_shards[r].data).view(np.uint16)
                np.testing.assert_array_equal(
                    mine.vals.view(torch.uint8).numpy()[:, 1:], want_v[:, 1:])
                np.testing.assert_array_equal(
                    mine.scale.view(torch.int16).numpy().view(np.uint16)[:, 1:],
                    want_s[:, 1:])
            else:
                want = np.asarray(theirs.addressable_shards[r].data).view(np.uint16)
                np.testing.assert_array_equal(
                    mine.view(torch.int16).numpy().view(np.uint16)[:, 1:], want[:, 1:])


@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_logits_match_jax_tp_mesh_and_reference(tp):
    """Each gloo rank's prefill logits (its shard of the same bf16 weights)
    are the same on every rank, and within PREFILL_TOL of the JAX
    prefill_forward on make_mesh(tp) and of the reference forward; the
    ranks' reference_forward over the shards agrees with JAX's too."""
    import jax
    import jax.numpy as jnp

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh

    kw = ModelSpec.dryrun().__dict__
    jp, tree = _jax_tree(kw, seed=3)
    tokens = [5, 17, 3, 42, 8, 9, 23, 1, 77, 300, 12]
    bucket = 16
    ranks = run_ranks(tp, _prefill_task, kw, tree, tokens, bucket)
    jspec = JaxSpec(**kw)
    jmesh = jax_make_mesh(tp=tp)
    sharded = jax.tree.map(jax.device_put, jp, jllama.param_shardings(jspec, jmesh))
    k, v = jllama.init_cache(jspec, 9, 16)
    ks, vs = jllama.cache_shardings(jmesh)
    padded = np.zeros(bucket, np.int32)
    padded[: len(tokens)] = tokens
    want, _k, _v, _d = jllama.prefill_forward(
        jspec, sharded, jnp.asarray(padded), jnp.arange(1, 9, dtype=jnp.int32),
        jnp.asarray(0, jnp.int32), jax.device_put(k, ks), jax.device_put(v, vs),
        jnp.asarray(len(tokens), jnp.int32))
    ref = np.asarray(jllama.reference_forward(jspec, jp, jnp.asarray(tokens)))
    want = np.asarray(want)
    scale = np.abs(ref).max()
    for logits, full in ranks:
        np.testing.assert_array_equal(logits, ranks[0][0])  # every rank samples alike
        assert np.abs(logits - want).max() <= PREFILL_TOL * scale
        assert np.abs(logits - ref[-1]).max() <= PREFILL_TOL * scale
        assert np.abs(full - ref).max() <= PREFILL_TOL * scale


@pytest.mark.parametrize("case", list(ENGINE_CASES))
async def test_tp2_engine_streams_match_jax_engine_on_tp_mesh(engine_runs, case,
                                                              monkeypatch):
    """The tp=2 leader's greedy streams (bf16 and fp8 pools, the spec
    verify, pipelined 3-step bursts) equal the JAX engine's on
    make_mesh(tp=2) and the port's one-rank engine's, token for token; the
    follower replayed every op the leader published."""
    leader, _pools = engine_runs["ranks"][0][case]
    follower, _fpools = engine_runs["ranks"][1][case]
    want = await _jax_streams(engine_runs["jp"], engine_runs["prompts"],
                              ENGINE_CASES[case], monkeypatch)
    assert leader["streams"] == want
    assert leader["streams"] == engine_runs["one"][case][0]
    assert all(len(s) == 8 for s in want)
    assert sum(follower["ops"].values()) == leader["descriptors"] - 1  # all but stop
    if case == "spec":
        assert leader["verifies"] > 0 and follower["ops"]["verify"] == leader["verifies"]
    if case == "pipelined":
        assert follower["ops"]["decode"] > 0


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_tp2_rank_pools_equal_one_rank_pool_head_slices(engine_runs, case):
    """Each rank's pools hold its KV heads of the one-rank engine's pools:
    every block both prefix caches sealed (matched by its hash: the spec
    path may place it on another page) within 1e-4 in f32; an fp8 pool's
    e4m3 bytes equal on 99% of the elements and its scales within 1%."""
    _streams, one_pools, one_cached = engine_runs["one"][case]
    lead_cached = engine_runs["ranks"][0][case][0]["cached"]
    common = sorted(set(one_cached) & set(lead_cached))
    assert len(common) >= 8
    mine_pg = [lead_cached[h] for h in common]
    full_pg = [one_cached[h] for h in common]
    for r, rank in enumerate(engine_runs["ranks"]):
        for mine, full in zip(rank[case][1], one_pools):
            kh = mine[0].shape[2]
            heads = slice(r * kh, (r + 1) * kh)
            got = [a[:, mine_pg] for a in mine]
            want = [a[:, full_pg][:, :, heads] for a in full]
            if len(mine) == 2:  # fp8: e4m3 bytes and scales
                assert np.mean(got[0] == want[0]) > 0.99
                np.testing.assert_allclose(got[1], want[1], rtol=1e-2)
            else:
                np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_load_reads_a_slice_of_the_checkpoint(tmp_path, tp):
    """load_model_dir(mesh=) gives rank r exactly shard_params of the full
    load, reading about 1/tp of the checkpoint's tensor bytes (plus the
    replicated norms)."""
    from dynamo_tpu_torch.models import llama, loader

    spec = _dryrun(tie_embeddings=False)
    loader.save_params(spec, llama.init_params(spec, 0, device="cpu"), str(tmp_path))
    _s, full = loader.load_model_dir(str(tmp_path), device="cpu")
    norms = sum(p.nbytes for n, p in full.named_parameters() if n.endswith("norm"))
    for r in range(tp):
        mesh = local_mesh(tp, r)
        _s, mine = loader.load_model_dir(str(tmp_path), mesh=mesh, device="cpu")
        want = shard_params(spec, full, mesh)
        for (n, a), (n2, b) in zip(mine.named_parameters(), want.named_parameters()):
            assert n == n2 and torch.equal(a, b), n
        assert mine.mesh is mesh
        assert mine.bytes_read == (full.bytes_read - norms) // tp + norms


@pytest.mark.parametrize("axis,item", [("dp", "11d"), ("sp", "11d"), ("ep", "11b"),
                                       ("pp", "11c")])
def test_other_axes_refuse_naming_their_item(axis, item):
    """Every axis is ported now. dp, sp and ep (items 11d, 11b) build their
    config, and make_mesh asks only for the group it needs. pp (item 11c)
    is a library path: make_mesh builds it, and EngineConfig refuses it,
    naming parallel/pipeline.py (the engine stages no layers)."""
    from dynamo_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(**{axis: 2})
    if axis == "pp":
        with pytest.raises(ValueError, match=r"parallel/pipeline\.py"):
            EngineConfig(pp=2)
        return
    assert getattr(EngineConfig(**{axis: 2}), axis) == 2


def test_tp_refusals_name_their_items():
    """MLA and MoE specs under tp > 1 shard (item 11b ported them: the
    engine and the MLA family's init keep this rank's heads and expert
    columns), a disagg export under tp builds (item 11e: a GQA rank
    exports its KV-head shard, MLA's latent pool is whole), a tp config
    without its mesh and a spec that does not divide are refused, a tp
    mesh needs an initialised group."""
    from dynamo_tpu_torch.disagg.transfer import KvTransferSource
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models.convert import check_shardable
    from dynamo_tpu_torch.models.family import get_family
    from dynamo_tpu_torch.parallel import make_mesh

    mesh = local_mesh(2, 0)
    for spec in (ModelSpec.tiny_deepseek(), ModelSpec.tiny_moe()):
        check_shardable(spec, 2)
        eng = InferenceEngine(spec, EngineConfig(tp=2), device="cpu", mesh=mesh)
        assert eng.params.mesh is mesh
        assert (eng.params.layers[-1].moe.w_gate.shape[-1]
                == spec.moe_intermediate_size // 2)
    ds = ModelSpec.tiny_deepseek()
    params = get_family(ds).init_params(ds, 0, device="cpu", mesh=mesh)
    assert params.layers[0].w_uk.shape[0] == ds.num_heads // 2
    src = KvTransferSource()
    eng = InferenceEngine(ModelSpec.dryrun(), EngineConfig(tp=2), device="cpu", mesh=mesh,
                          transfer_source=src)
    assert eng.transfer_source is src and eng.kv_shards == 2
    assert InferenceEngine(ds, EngineConfig(tp=2), device="cpu", mesh=mesh,
                           transfer_source=KvTransferSource()).kv_shards == 1
    with pytest.raises(ValueError, match="mesh"):
        InferenceEngine(ModelSpec.dryrun(), EngineConfig(tp=2), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        check_shardable(ModelSpec.dryrun(), 3)
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(tp=2)
    assert make_mesh(tp=1).group is None  # one process, no group: no collective


async def test_worker_refuses_disagg_under_tp(monkeypatch):
    """Item 11e: a prefill and a decode worker build on rank 0 of a tp=2
    mesh. The prefill worker's source learns the other rank's transfer
    source from the group's store (``shard_sources``), the decode worker
    serves its front door over the tp engine."""
    from dynamo_tpu_torch.disagg.handlers import DecodeWorkerHandler, PrefillWorkerHandler
    from dynamo_tpu_torch.engine import worker
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    peers = [{"addr": "127.0.0.1:1", "uid": "rank1"}]
    asked = []

    async def shard_sources(tp, group, timeout=120.0):
        asked.append((tp, group))
        return peers

    monkeypatch.setattr(worker, "shard_sources", shard_sources)
    drt = DistributedRuntime(InMemoryHub())
    try:
        for mode, handler in (("prefill", PrefillWorkerHandler),
                              ("decode", DecodeWorkerHandler)):
            eng, _ = await worker.launch_engine_worker(
                drt, engine_config=EngineConfig(tp=2), mode=mode, device="cpu",
                mesh=local_mesh(2, 0), spec=ModelSpec.dryrun())
            assert isinstance(eng.frontdoor, handler) and eng.kv_shards == 2
            if mode == "prefill":
                assert eng.transfer_source.peers == peers
            await eng.close()
        assert asked == [(2, "dynamo/backend/generate")]
    finally:
        await drt.close()


@pytest.mark.parametrize("argv", [["--mode", "prefill", "--tp", "2"],
                                  ["--mode", "decode", "--mirror", "leader"],
                                  ["--mirror", "follower", "--tp", "2"]])
def test_worker_flags_refuse_disagg_and_mirror_under_tp(argv):
    """Item 11e: the worker's flags build the config of disagg under tp or
    a mirror, and of a mirror of a tp group."""
    from dynamo_tpu_torch.engine.worker import _engine_config, parse_args

    args = parse_args(["--device", "cpu", *argv])
    cfg = _engine_config(args)
    assert cfg.tp == args.tp and (args.mode, args.mirror) != ("aggregated", None)


@pytest.mark.parametrize("kh", [4, 2, 1])
def test_split_count_fills_the_card_at_sharded_kv_heads(kh):
    """num_splits at a tp rank's KV heads (llama-3-8b tp=2: 4; llama-3-70b
    tp=4: 2; tp=8: 1) gives B * KH * S blocks of at least the H100's 132
    SMs at 8 decode slots over a long table."""
    from dynamo_tpu_torch.ops.cuda.paged_attention_v3 import num_splits

    s = num_splits(8, kh, 256, 132)
    assert 8 * kh * s >= 132
    assert num_splits(8, kh, 2, 132) <= 2  # never more splits than pages


def test_parallel_package_imports_no_jax():
    """parallel/ imports neither jax nor the JAX package."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "dynamo_tpu_torch" / "parallel"
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names
                        if n.split(".")[0] in ("jax", "jaxlib", "dynamo_tpu")], path


def test_shard_dims_follow_the_reference_shardings():
    """SHARD_DIMS names the sharded axis of each leaf param_shardings
    shards on tp (and nothing it replicates)."""
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh

    kw = {**ModelSpec.dryrun().__dict__, "tie_embeddings": False,
          "attn_bias": True, "attn_sinks": True}
    sh = jllama.param_shardings(JaxSpec(**kw), jax_make_mesh(tp=2))
    leaves = {**{k: v for k, v in sh.items() if k != "layers"}, **sh["layers"][0]}
    for name, s in leaves.items():
        spec = tuple(s.spec)
        dim = spec.index("tp") if "tp" in spec else None
        assert SHARD_DIMS.get(name) == dim, name
