"""Expert parallelism of the port (parallel/mesh.py's ep axis and expert
group, models/convert's MoE and MLA shards, moe.moe_mlp over ep x tp, the
MLA forwards under tp, the sharded load) held against the JAX package on
``make_mesh(ep=2, tp=2)`` and ``make_mesh(ep=4)``.

The JAX side runs its mesh in this process over the 8 forced CPU devices
(tests/conftest.py). The port runs one process per rank: 4 gloo ranks
spawned with ``torch.multiprocessing`` (tests/test_torch_parallel.py's
harness), each driving the CPU with 1 thread. The rank functions live at
module level and import no JAX. Two spawns: one group of ep=2 x tp=2
runs the moe_mlp, prefill and engine cases, one group of ep=4 the
moe_mlp and prefill cases.

Tolerances. The experts' combine is all-reduced in f32 over the expert
group, the attention and dense partials over tp, so a rank's forward
differs from a one-rank forward by the order of its f32 sums: moe_mlp
outputs within 1e-5 and f32 prefill logits within 1e-4 of the logits'
range. Shards and the ep replicas' pools are equal bit for bit, and so
are the dropped-slot counts. Greedy streams of the peaked specs are equal
token for token.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.models.convert import shard_params, shard_tensor
from dynamo_tpu_torch.parallel.mesh import AXES, Mesh
from test_torch_parallel import run_ranks

pytestmark = pytest.mark.unit

MOE_TOL = 1e-5  # moe_mlp outputs, f32: sums in another order
LOGIT_TOL = 1e-4  # of max |logit|, f32 prefill logits
NAMES = ("tiny_gpt_oss", "tiny_moe", "tiny_deepseek")
MESHES = {"ep2tp2": (2, 2), "ep4": (4, 1)}
CFG_KW = dict(page_size=4, num_pages=96, max_pages_per_seq=16, max_decode_slots=4,
              prefill_buckets=(8, 16, 32), prefill_pack_size=1)
ENGINE_CASES = {  # (spec, kv_dtype), on the ep=2 x tp=2 group
    "gpt-oss-bf16": ("tiny_gpt_oss", "bf16"),
    "gpt-oss-fp8": ("tiny_gpt_oss", "fp8"),
    "deepseek-bf16": ("tiny_deepseek", "bf16"),
    "deepseek-fp8": ("tiny_deepseek", "fp8"),
}
N_TOKENS = 8


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def local_mesh(ep: int, tp: int, rank: int) -> Mesh:
    """A rank's mesh coordinates without a process group (tp innermost):
    shard cutting needs no collective."""
    return Mesh(dict.fromkeys(AXES, 1) | {"ep": ep, "tp": tp},
                dict.fromkeys(AXES, 0) | {"ep": rank // tp, "tp": rank % tp},
                torch.device("cpu"))


def _spec(name: str) -> ModelSpec:
    return getattr(ModelSpec, name)()


def _prompts(vocab: int):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, k).tolist() for k in (5, 13, 9, 22)]
    prompts.append(prompts[3][:16] + [7, 8])  # shares 4 pages with prompt 3
    return prompts


def _moe_layer(name: str, seed: int) -> dict:
    """One MoE layer's leaves drawn from numpy: every leaf nonzero (the
    init's expert biases are zeros, and a doubled b_down would not show)."""
    spec = _spec(name)
    d, E, f = spec.hidden_size, spec.num_experts, spec.moe_intermediate_size
    rng = np.random.default_rng(seed)
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    if spec.moe_bias:
        shapes.update(router_bias=(E,), b_gate=(E, f), b_up=(E, f), b_down=(E, d))
    if spec.moe_scoring == "sigmoid":
        shapes["score_bias"] = (E,)
    return {k: (rng.standard_normal(s) * (0.3 if k.startswith("router") else 0.2))
            .astype(np.float32) for k, s in shapes.items()}


def _moe_x(name: str) -> np.ndarray:
    d = _spec(name).hidden_size
    return (np.random.default_rng(1).standard_normal((40, d)) + 0.3).astype(np.float32)


# ------------------------------------------------------------ rank tasks


def _prefill_logits(spec, params, tokens, bucket=16):
    from dynamo_tpu_torch.models.family import get_family

    fam = get_family(spec)
    mesh = params.mesh
    k, v = fam.init_cache(spec, 9, 4, device="cpu", tp=mesh.tp if mesh else 1)
    padded = torch.zeros(bucket, dtype=torch.int32)
    padded[: len(tokens)] = torch.tensor(tokens)
    bt = torch.arange(1, 9, dtype=torch.int32)
    with torch.inference_mode():
        logits, _ = fam.prefill(spec, params, padded, bt, 0, k, v, len(tokens))
    return logits.numpy()


def _pool_numpy(pool):
    from dynamo_tpu_torch.ops.quant import is_quant

    if is_quant(pool):
        return (pool.vals.view(torch.uint8).numpy().copy(),
                pool.scale.float().numpy().copy())
    return (pool.numpy().copy(),)


async def _serve(eng, prompts):
    from dynamo_tpu_torch.runtime.context import Context

    async def one(p):
        req = {"token_ids": p, "stop_conditions": {"max_tokens": N_TOKENS,
                                                   "ignore_eos": True}}
        return [t for x in [x async for x in eng.generate(req, Context())]
                for t in x["token_ids"]]

    got = list(await asyncio.gather(*(one(p) for p in prompts[:-1])))
    got.append(await one(prompts[-1]))  # the sharer, once the prefix is sealed
    return got


def _engine_case(rank, mesh, name, spec, cfg, params, prompts):
    """One engine case on this group: rank 0 serves through an SPMD leader
    engine, the others replay; (streams or replayed ops, this rank's
    pools)."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub

    async def run():
        group = f"ep-test/{name}"
        if rank == 0:
            leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                      strict=True).start()
            eng = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh,
                                  spmd=leader)
            await eng.start()
            res = {"streams": await _serve(eng, prompts),
                   "descriptors": leader.publish_count,
                   "dropped": int(eng._moe_dropped_dev or 0)}
            await eng.close()
        else:
            eng = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh)
            f = SpmdFollower(StoreHub(), group, eng)
            await f.run()
            await eng.close()
            res = {"ops": f.ops}
        return res, [_pool_numpy(p) for p in (eng.k_pages, eng.v_pages)]

    return asyncio.run(run())


def _group_task(rank, n, ep, moe_cases, trees, engine_cases):
    """Everything one group runs: moe_mlp on each case's layer, prefill
    logits of each tree, then each engine case. Returns a dict of those."""
    from dynamo_tpu_torch.models.llama import LlamaLayer
    from dynamo_tpu_torch.models.moe import moe_mlp
    from dynamo_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(ep=ep, tp=n // ep)
    out = {"coords": dict(mesh.coords), "moe": {}, "prefill": {}, "engine": {}}
    for name, (lp, x) in moe_cases.items():
        layer = LlamaLayer({k: torch.from_numpy(v)
                            for k, v in shard_tensor("moe", lp, mesh).items()})
        with torch.inference_mode():
            y, d = moe_mlp(_spec(name), layer, torch.from_numpy(x), return_dropped=True,
                           mesh=mesh)
        out["moe"][name] = (y.numpy(), int(d))
    sharded = {name: shard_params(_spec(name), tree, mesh, device="cpu")
               for name, tree in trees.items()}
    for name, params in sharded.items():
        out["prefill"][name] = _prefill_logits(_spec(name), params, _prompts(96)[3][:13])
    for case, (name, kv) in engine_cases.items():
        cfg = EngineConfig(**CFG_KW, tp=n // ep, ep=ep, kv_dtype=kv)
        out["engine"][case] = _engine_case(rank, mesh, case, _spec(name), cfg,
                                           sharded[name], _prompts(96))
    out["stats"] = {k: dict(v) for k, v in mesh.group_stats.items()}
    return out


# ---------------------------------------------------------------- fixtures


def _jax_tree(name: str, seed: int = 0):
    """The reference's init of ``name`` (JAX arrays and numpy): the input
    embedding x 4 and the routers x 20 (peaked logits and routing: greedy
    streams do not sit on near-ties), biases, sinks and score biases drawn
    nonzero."""
    import jax

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.models import mla as jmla

    jspec = getattr(JaxSpec, name)()
    mod = jmla if jspec.kv_lora_rank else jllama
    tree = jax.tree.map(np.asarray, mod.init_params(jspec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree["embed"] = tree["embed"] * 4.0
    for lp in tree["layers"]:
        for k in ("bq", "bk", "bv", "bo", "sinks"):
            if k in lp:
                lp[k] = (rng.standard_normal(lp[k].shape) * 0.2).astype(np.float32)
        m = lp.get("moe")
        if m is None:
            continue
        for k in ("router_bias", "b_gate", "b_up", "b_down", "score_bias"):
            if k in m:
                m[k] = (rng.standard_normal(m[k].shape) * 0.2).astype(np.float32)
        m["router"] = m["router"] * 20.0
    return jspec, jax.tree.map(jax.numpy.asarray, tree), tree


@pytest.fixture(scope="module")
def trees():
    return {name: _jax_tree(name, seed=7) for name in ("tiny_gpt_oss", "tiny_deepseek")}


@pytest.fixture(scope="module")
def moe_cases():
    return {name: (_moe_layer(name, seed=11 + i), _moe_x(name))
            for i, name in enumerate(NAMES)}


@pytest.fixture(scope="module")
def groups(trees, moe_cases):
    """Both 4-rank groups' results: ep=2 x tp=2 with the engine cases,
    ep=4 without."""
    numpy_trees = {name: t[2] for name, t in trees.items()}
    out = {}
    for mesh, (ep, _tp) in MESHES.items():
        cases = ENGINE_CASES if mesh == "ep2tp2" else {}
        out[mesh] = run_ranks(4, _group_task, ep, moe_cases, numpy_trees, cases)
    return out


async def _one_rank_engine(name, tree, kv):
    """The port's one-rank engine on the same weights: streams and its
    dropped-slot total."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models.convert import params_from_numpy

    spec = _spec(name)
    eng = InferenceEngine(spec, EngineConfig(**CFG_KW, kv_dtype=kv),
                          params=params_from_numpy(spec, tree, device="cpu"), device="cpu")
    await eng.start()
    got = await _serve(eng, _prompts(96))
    dropped = int(eng._moe_dropped_dev or 0)
    await eng.close()
    return got, dropped


async def _jax_streams(name, jtree, kv, monkeypatch):
    """The JAX engine's greedy streams on make_mesh(ep=2, tp=2)."""
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu.runtime.context import Context as JaxContext

    if kv == "fp8":
        monkeypatch.setenv("DYNAMO_PALLAS", "1")
    jeng = JaxEngine(getattr(JaxSpec, name)(), JaxEngineConfig(**CFG_KW, kv_dtype=kv),
                     params=jtree, mesh=jax_make_mesh(ep=2, tp=2))
    prompts = _prompts(96)

    async def one(p):
        req = {"token_ids": p, "stop_conditions": {"max_tokens": N_TOKENS,
                                                   "ignore_eos": True}}
        return [t for x in [x async for x in jeng.generate(req, JaxContext())]
                for t in x["token_ids"]]

    got = list(await asyncio.gather(*(one(p) for p in prompts[:-1])))
    got.append(await one(prompts[-1]))
    await jeng.close()
    return got


def _jax_mesh_and_shardings(name, ep, tp):
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.models import mla as jmla
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh

    jspec = getattr(JaxSpec, name)()
    jmesh = jax_make_mesh(ep=ep, tp=tp)
    mod = jmla if jspec.kv_lora_rank else jllama
    return jspec, jmesh, mod, mod.param_shardings(jspec, jmesh)


def _shard_of(arr, jmesh, rank: int) -> np.ndarray:
    """The JAX array's shard on the mesh's device ``rank`` (tp innermost)."""
    dev = jmesh.devices.reshape(-1)[rank]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_shards_equal_jax_addressable_shards(mesh, name):
    """shard_params of the JAX numpy tree, and of the port's full params,
    equal bit for bit each JAX array's addressable shard on every device of
    make_mesh(ep, tp) under the family's param_shardings: experts over ep,
    their columns over tp, the MLA heads over tp, the latent path, routers
    and norms whole."""
    import jax

    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.models import mla as jmla
    from dynamo_tpu_torch.models.convert import params_from_numpy

    ep, tp = MESHES[mesh]
    jspec, jmesh, mod, shardings = _jax_mesh_and_shardings(name, ep, tp)
    jp = (jmla if jspec.kv_lora_rank else jllama).init_params(jspec, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    sharded = jax.tree.map(jax.device_put, jp, shardings)
    spec = _spec(name)
    full = params_from_numpy(spec, tree, device="cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(sharded)[0])
    for r in range(ep * tp):
        lm = local_mesh(ep, tp, r)
        mine = dict(shard_params(spec, tree, lm, device="cpu").named_parameters())
        mine2 = dict(shard_params(spec, full, lm).named_parameters())
        assert mine.keys() == mine2.keys()
        names = set()
        for path, arr in flat_j.items():
            key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            names.add(key)
            want = _shard_of(arr, jmesh, r)
            got = mine[key]
            assert tuple(got.shape) == want.shape, (key, got.shape, want.shape)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.float32), err_msg=key)
            assert torch.equal(got, mine2[key]), key
        assert names == set(mine)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_mlp_on_four_ranks_matches_one_rank_and_jax(groups, moe_cases, mesh, name):
    """moe_mlp on each rank of the group (its experts and columns of a layer
    with every bias nonzero, the expert-group all-reduce) equals the same
    output on every rank, within 1e-5 of the one-rank moe_mlp and of the
    reference's on make_mesh(ep, tp); the dropped-slot count equals both
    exactly."""
    import jax
    import jax.numpy as jnp

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import moe as jmoe
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu_torch.models.llama import LlamaLayer
    from dynamo_tpu_torch.models.moe import moe_mlp

    ep, tp = MESHES[mesh]
    lp, x = moe_cases[name]
    jspec = getattr(JaxSpec, name)()
    jmesh = jax_make_mesh(ep=ep, tp=tp)
    jlp = jax.tree.map(jax.device_put, {k: jnp.asarray(v) for k, v in lp.items()},
                       jmoe.moe_layer_shardings(jmesh, jspec))
    want, want_drop = jmoe.moe_mlp(jspec, jlp, jnp.asarray(x), return_dropped=True)
    one, one_drop = moe_mlp(_spec(name), LlamaLayer({k: torch.from_numpy(v)
                                                     for k, v in lp.items()}),
                            torch.from_numpy(x), return_dropped=True)
    ranks = groups[mesh]
    assert [r["coords"]["ep"] * tp + r["coords"]["tp"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        got, drop = r["moe"][name]
        np.testing.assert_array_equal(got, ranks[0]["moe"][name][0])
        np.testing.assert_allclose(got, one.numpy(), atol=MOE_TOL, rtol=MOE_TOL)
        np.testing.assert_allclose(got, np.asarray(want), atol=MOE_TOL, rtol=MOE_TOL)
        assert drop == int(one_drop) == int(want_drop)
    assert int(one_drop) > 0 or name != "tiny_moe"  # the case does drop


def test_moe_partials_sum_to_one_rank_and_bias_once(moe_cases):
    """Without a group each rank's moe_mlp is its partial: the four
    partials of ep=2 x tp=2 sum to the one-rank output (b_down added once,
    on tp rank 0), and a partial alone does not."""
    from dynamo_tpu_torch.models.llama import LlamaLayer
    from dynamo_tpu_torch.models.moe import moe_mlp

    lp, x = moe_cases["tiny_gpt_oss"]
    spec = _spec("tiny_gpt_oss")
    one = moe_mlp(spec, LlamaLayer({k: torch.from_numpy(v) for k, v in lp.items()}),
                  torch.from_numpy(x))
    parts = [moe_mlp(spec, LlamaLayer({k: torch.from_numpy(v) for k, v in
                                       shard_tensor("moe", lp, local_mesh(2, 2, r)).items()}),
                     torch.from_numpy(x), mesh=local_mesh(2, 2, r)) for r in range(4)]
    np.testing.assert_allclose(sum(parts).numpy(), one.numpy(), atol=MOE_TOL, rtol=MOE_TOL)
    assert (parts[0] - one).abs().max() > 1e-2


@pytest.mark.parametrize("name", ["tiny_gpt_oss", "tiny_deepseek"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_logits_match_jax_mesh_forward(groups, trees, mesh, name):
    """Each rank's prefill logits (its shard of the same weights, one
    13-token prompt) are the same on every rank and within LOGIT_TOL of the
    reference's prefill_forward on its make_mesh(ep, tp) (params under
    param_shardings, pools under cache_shardings)."""
    import jax
    import jax.numpy as jnp

    ep, tp = MESHES[mesh]
    jspec, jmesh, mod, shardings = _jax_mesh_and_shardings(name, ep, tp)
    _js, jtree, _tree = trees[name]
    sharded = jax.tree.map(jax.device_put, jtree, shardings)
    tokens = _prompts(96)[3][:13]
    padded = np.zeros(16, np.int32)
    padded[:13] = tokens
    bt = jnp.arange(1, 9, dtype=jnp.int32)
    if jspec.kv_lora_rank:
        cache = jax.device_put(mod.init_cache(jspec, 9, 4), mod.cache_shardings(jmesh))
        want, _c = mod.prefill_forward(jspec, sharded, jnp.asarray(padded), bt,
                                       jnp.asarray(0, jnp.int32), cache,
                                       jnp.asarray(13, jnp.int32), mesh=jmesh)
    else:
        k, v = mod.init_cache(jspec, 9, 4)
        ks, vs = mod.cache_shardings(jmesh)
        want, _k, _v, _d = mod.prefill_forward(
            jspec, sharded, jnp.asarray(padded), bt, jnp.asarray(0, jnp.int32),
            jax.device_put(k, ks), jax.device_put(v, vs), jnp.asarray(13, jnp.int32))
    want = np.asarray(want)
    scale = np.abs(want).max()
    for r in groups[mesh]:
        got = r["prefill"][name]
        np.testing.assert_array_equal(got, groups[mesh][0]["prefill"][name])
        assert np.abs(got - want).max() <= LOGIT_TOL * scale


@pytest.mark.parametrize("case", list(ENGINE_CASES))
async def test_ep2tp2_engine_streams_match_jax_engine_on_ep_mesh(groups, trees, case,
                                                                 monkeypatch):
    """The ep=2 x tp=2 leader's greedy streams (tiny-gpt-oss and
    tiny-deepseek, bf16 and fp8 pools) equal the JAX engine's on
    make_mesh(ep=2, tp=2) and the port's one-rank engine's, token for
    token, with the same dropped-slot total; the three followers (the ep
    replica of rank 0 among them) replayed every op the leader
    published."""
    name, kv = ENGINE_CASES[case]
    ranks = groups["ep2tp2"]
    leader, _pools = ranks[0]["engine"][case]
    want = await _jax_streams(name, trees[name][1], kv, monkeypatch)
    one, one_drop = await _one_rank_engine(name, trees[name][2], kv)
    assert leader["streams"] == want
    assert leader["streams"] == one
    assert all(len(s) == N_TOKENS for s in want)
    assert leader["dropped"] == one_drop
    for r in ranks[1:]:
        follower, _p = r["engine"][case]
        # every descriptor published before the leader's close (its stop)
        assert sum(follower["ops"].values()) == leader["descriptors"]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_ep_replicas_hold_bitwise_equal_pools(groups, case):
    """The two ep replicas of each tp coordinate (ranks 0 and 2, 1 and 3)
    hold bit-for-bit equal KV pools after the serve; MLA's latent pool is
    whole and equal on all four ranks; a GQA rank holds its tp coordinate's
    KV heads."""
    ranks = groups["ep2tp2"]
    pools = [r["engine"][case][1] for r in ranks]
    for a, b in ((0, 2), (1, 3)):
        for pa, pb in zip(pools[a], pools[b]):
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)
    mla = ENGINE_CASES[case][0] == "tiny_deepseek"
    if mla:
        for p in pools[1:]:
            for x, y in zip(p[0], pools[0][0]):
                np.testing.assert_array_equal(x, y)
    else:
        kv_heads = _spec(ENGINE_CASES[case][0]).num_kv_heads
        assert pools[0][0][0].shape[2] == kv_heads // 2
        assert not np.array_equal(pools[0][0][0], pools[1][0][0])


def test_expert_group_collectives_counted_per_group(groups):
    """Every rank counts its collectives per group: the expert group's
    all-reduces (one per MoE layer per forward) and the tp group's; at
    ep=4 the tp group is one rank and runs none."""
    for r in groups["ep2tp2"]:
        assert r["stats"]["expert"]["calls"] > 0 and r["stats"]["tp"]["calls"] > 0
    for r in groups["ep4"]:
        assert r["stats"]["expert"]["calls"] > 0 and r["stats"]["tp"]["calls"] == 0


@pytest.mark.parametrize("name", ["tiny_gpt_oss", "tiny_deepseek", "tiny_moe",
                                  "tiny_deepseek-rope_interleave"])
def test_sharded_load_reads_its_experts_and_columns(tmp_path, name):
    """load_model_dir(mesh=) gives each rank of ep=2 x tp=2 exactly
    shard_params of the full load, reading only the bytes of its shard:
    about 1/(ep * tp) of the expert bytes (gpt-oss's fused, interleaved
    gate_up_proj included; a rope_interleave checkpoint's query columns
    permuted within the rank's heads)."""
    import dataclasses

    from dynamo_tpu_torch.models import loader
    from dynamo_tpu_torch.models.family import get_family

    name, _, flag = name.partition("-")
    spec = _spec(name)
    if flag:
        spec = dataclasses.replace(spec, **{flag: True})
    loader.save_params(spec, get_family(spec).init_params(spec, 0, device="cpu"),
                       str(tmp_path))
    _s, full = loader.load_model_dir(str(tmp_path), device="cpu")

    def expert_bytes(params):
        return sum(p.nbytes for n, p in params.named_parameters()
                   if ".moe." in n and not n.split(".")[-1].startswith(("router", "score")))

    for r in range(4):
        mesh = local_mesh(2, 2, r)
        _s, mine = loader.load_model_dir(str(tmp_path), mesh=mesh, device="cpu")
        want = shard_params(spec, full, mesh)
        for (n, a), (n2, b) in zip(mine.named_parameters(), want.named_parameters()):
            assert n == n2 and torch.equal(a, b), n
        assert mine.mesh is mesh
        assert mine.bytes_read == sum(p.nbytes for p in mine.parameters())
        # b_down is cut over ep only: a little over a quarter
        assert expert_bytes(full) / 4 <= expert_bytes(mine) <= expert_bytes(full) / 3.5


def test_ep_config_mesh_and_refusals():
    """EngineConfig(ep=2) builds; make_mesh(ep=2) needs an initialised
    group; a spec whose experts do not divide over ep is refused naming
    the axis; a config's ep must be its mesh's."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models.convert import check_shardable
    from dynamo_tpu_torch.parallel import make_mesh

    assert EngineConfig(ep=2, tp=2).ep == 2
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(ep=2)
    with pytest.raises(ValueError, match="ep=3"):
        check_shardable(ModelSpec.tiny_moe(), {"ep": 3, "tp": 1})
    check_shardable(ModelSpec.dryrun(), {"ep": 3, "tp": 1})  # dense: replicated on ep
    with pytest.raises(ValueError, match="ep=2 but the mesh has ep=1"):
        InferenceEngine(ModelSpec.tiny_moe(), EngineConfig(ep=2), device="cpu")


@pytest.mark.parametrize("argv,want", [(["--ep", "2", "--tp", "2"], (2, 2)),
                                       (["--ep", "4"], (4, 1))])
def test_worker_flags_build_the_ep_config(argv, want):
    """``cli worker --ep E --tp T`` builds EngineConfig(ep=E, tp=T)."""
    from dynamo_tpu_torch.engine.worker import _engine_config, parse_args

    cfg = _engine_config(parse_args(["--device", "cpu", *argv]))
    assert (cfg.ep, cfg.tp) == want


def test_new_modules_import_no_jax():
    """The modules this slice touches import neither jax nor the JAX
    package."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "dynamo_tpu_torch"
    paths = [*root.glob("parallel/*.py"), root / "engine" / "worker.py", root / "cli.py",
             *(root / "models" / f for f in ("moe.py", "mla.py", "llama.py", "convert.py",
                                              "loader.py", "family.py"))]
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names
                        if n.split(".")[0] in ("jax", "jaxlib", "dynamo_tpu")], path


async def test_worker_starts_ep_times_tp_local_ranks(monkeypatch):
    """A worker with ``--ep 2 --tp 2`` and no coordinator starts ranks 1..3
    here (its EngineConfig, ep and tp, handed to them), joins a world of 4
    as rank 0 and builds make_mesh(ep=2, tp=2)."""
    import json
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine import worker
    from dynamo_tpu_torch.parallel import mesh as mesh_mod
    from dynamo_tpu_torch.parallel import multihost
    from dynamo_tpu_torch.parallel import spmd as spmd_mod

    seen = {}

    class Leader:
        def __init__(self, *a, **k):
            pass

        async def start(self):
            return self

    def join(coordinator, n, pid, device=None):
        seen.update(world=n, pid=pid)
        return True

    monkeypatch.setattr(multihost, "spawn_local_followers",
                        lambda n, argv, coordinator: seen.update(n=n, argv=argv) or [])
    monkeypatch.setattr(multihost, "initialize_multihost", join)
    monkeypatch.setattr(mesh_mod, "make_mesh",
                        lambda **k: seen.update(mesh=k) or SimpleNamespace(rank=0))
    monkeypatch.setattr(spmd_mod, "SpmdLeader", Leader)
    monkeypatch.setattr(spmd_mod, "StoreHub", lambda: None)
    group = await worker.start_tp_group(EngineConfig(ep=2, tp=2), model="tiny-moe",
                                        device="cpu")
    assert group.leader
    assert (seen["n"], seen["world"], seen["pid"], seen["mesh"]) == (
        4, 4, 0, {"tp": 2, "ep": 2, "sp": 1, "dp": 1})
    cfg = json.loads(seen["argv"][seen["argv"].index("--engine-config-json") + 1])
    assert (cfg["ep"], cfg["tp"]) == (2, 2)
