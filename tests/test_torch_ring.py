"""Sequence parallelism of the port (parallel/ring.py's ``ring_attention``,
models/llama.prefill_forward_ring, the engine's ring admission and the
SPMD ``ring_prefill`` op, the five-axis mesh's groups) held against the
JAX package on ``make_mesh(sp=2|4)`` and ``make_mesh(sp=2, tp=2)``.

The JAX side runs its mesh in this process over the 8 forced CPU devices
(tests/conftest.py). The port runs one process per rank: gloo ranks
spawned with ``torch.multiprocessing`` (tests/test_torch_parallel.py's
harness). The rank functions live at module level and import no JAX.
Three spawns: sp=4 (the ring alone), sp=2 x tp=2 (the ring, f32, fp8 and
MoE prefills) and sp=2 (the ring, the leader and follower engines).

Tolerances, as the reference's own tests (tests/test_ring_moe.py): ring
attention within 1e-5 (f32 online softmax, sums in another order), prefill
logits within 2e-4, pages within 1e-5 on the real rows. fp8 pages are held
dequantized, each element within one e4m3 step (a value the sum order
moved may round the other way), as tests/test_torch_llama.py holds them.
MoE drops are equal, and greedy streams of the peaked f32 spec are equal
token for token.
"""

from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.models.convert import shard_params
from dynamo_tpu_torch.parallel.mesh import AXES, GROUPS, Mesh, group_members, rank_grid
from test_torch_parallel import run_ranks

pytestmark = pytest.mark.unit

ATTN_TOL = 1e-5
LOGIT_TOL = 2e-4
POOL_TOL = 1e-5
SPEC_KW = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=8, dtype="float32")
PAGE, PAGES = 4, 16
CFG_KW = dict(page_size=4, num_pages=96, max_pages_per_seq=16, max_decode_slots=4,
              prefill_buckets=(8, 16, 32, 64), prefill_pack_size=1)
EMBED_SCALE = 32.0  # peaked logits: greedy streams do not sit on near-ties
N_TOKENS = 8


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(T=32, H=4, KH=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((T, h, D)).astype(np.float32) for h in (H, KH, KH))


def _prompt():
    return (np.arange(13) % 97).tolist()  # 13 real tokens, padded to 16


def _engine_prompts():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 97, k).tolist() for k in (13, 7, 30)]
    prompts.append(prompts[0][:8] + [5, 6, 7])  # shares 2 pages with prompt 0
    return prompts


# ------------------------------------------------------------ rank tasks


def _ring_chunk(mesh, qkv):
    """This rank's ring attention over its sequence chunk and tp heads."""
    from dynamo_tpu_torch.parallel.ring import ring_attention

    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    s, t = mesh.coords["sp"], mesh.coords["tp"]
    Tl = qkv[0].shape[0] // sp
    q, k, v = (torch.from_numpy(a[s * Tl:(s + 1) * Tl]) for a in qkv)
    q = q[:, t * q.shape[1] // tp:(t + 1) * q.shape[1] // tp]
    k = k[:, t * k.shape[1] // tp:(t + 1) * k.shape[1] // tp]
    v = v[:, t * v.shape[1] // tp:(t + 1) * v.shape[1] // tp]
    seen = []
    out = ring_attention(q.contiguous(), k.contiguous(), v.contiguous(), mesh,
                         on_chunk=lambda src, kc, vc: seen.append(src))
    return out.numpy(), seen


def _pools_numpy(k, v):
    from dynamo_tpu_torch.ops.quant import is_quant

    if is_quant(k):
        return [(p.vals.view(torch.uint8).numpy().copy(), p.scale.float().numpy().copy())
                for p in (k, v)]
    return [p.numpy().copy() for p in (k, v)]


def _ring_prefill(spec, params, mesh, kv_dtype="bf16"):
    from dynamo_tpu_torch.models import llama

    k, v = llama.init_cache(spec, PAGES + 1, PAGE, device="cpu", kv_dtype=kv_dtype,
                            dtype=torch.float32, tp=mesh.tp)
    padded = torch.zeros(16, dtype=torch.int32)
    padded[:13] = torch.tensor(_prompt())
    bt = torch.zeros(8, dtype=torch.int32)
    bt[:4] = torch.tensor([1, 2, 3, 4])
    with torch.inference_mode():
        logits, dropped = llama.prefill_forward_ring(spec, params, padded, bt, k, v, 13)
    return logits.numpy(), int(dropped), _pools_numpy(k, v)


def _sp4_task(rank, n, qkv):
    from dynamo_tpu_torch.parallel.mesh import make_mesh

    return _ring_chunk(make_mesh(sp=4), qkv)


def _sp2tp2_task(rank, n, qkv, tree, moe_tree):
    from dynamo_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(sp=2, tp=2)
    out = {"coords": dict(mesh.coords), "ring": _ring_chunk(mesh, qkv)}
    spec = ModelSpec(**SPEC_KW)
    params = shard_params(spec, tree, mesh, device="cpu")
    for kv in ("bf16", "fp8"):
        out[kv] = _ring_prefill(spec, params, mesh, kv)
    moe = ModelSpec.tiny_moe()
    out["moe"] = _ring_prefill(moe, shard_params(moe, moe_tree, mesh, device="cpu"), mesh)
    out["stats"] = {g: dict(st) for g, st in mesh.group_stats.items()}
    return out


def _sp2_task(rank, n, qkv, tree, prompts):
    """The ring at sp=2, then the sp=2 engine: rank 0 serves through an
    SPMD leader, rank 1 replays."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub

    mesh = make_mesh(sp=2)
    out = {"ring": _ring_chunk(mesh, qkv)}
    spec = ModelSpec(**SPEC_KW)
    params = shard_params(spec, tree, mesh, device="cpu")
    cfg = EngineConfig(**CFG_KW, sp=2)

    async def run():
        from dynamo_tpu_torch.runtime.context import Context

        if rank == 0:
            leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), "ring-test",
                                      strict=True).start()
            eng = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh,
                                  spmd=leader)
            await eng.start()

            async def one(p):
                req = {"token_ids": p, "stop_conditions": {"max_tokens": N_TOKENS,
                                                           "ignore_eos": True}}
                return [t for x in [x async for x in eng.generate(req, Context())]
                        for t in x["token_ids"]]

            streams = list(await asyncio.gather(*(one(p) for p in prompts[:-1])))
            streams.append(await one(prompts[-1]))  # the sharer: a warm prefix
            digest = await eng.kv_digest()
            res = {"streams": streams, "ring_prefills": eng.ring_prefills,
                   "prefills": eng.prefill_forwards, "digest": digest}
            await eng.close()
        else:
            eng = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh)
            f = SpmdFollower(StoreHub(), "ring-test", eng)
            await f.run()
            res = {"ops": dict(f.ops), "digest": eng.pool_digest(f.digest_pages)}
            await eng.close()
        return res

    out["engine"] = asyncio.run(run())
    return out


# ---------------------------------------------------------------- fixtures


def _jax_tree(spec_kw=None, jspec=None, seed=0, embed_scale=None):
    import jax

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama

    jspec = jspec or JaxSpec(**spec_kw)
    jp = dict(jllama.init_params(jspec, jax.random.PRNGKey(seed)))
    if embed_scale:
        jp["embed"] = jp["embed"] * embed_scale
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def trees():
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec

    return {"dense": _jax_tree(SPEC_KW), "moe": _jax_tree(jspec=JaxSpec.tiny_moe(), seed=3),
            "engine": _jax_tree(SPEC_KW, seed=1, embed_scale=EMBED_SCALE)}


@pytest.fixture(scope="module")
def groups(trees):
    qkv = _qkv()
    return {
        "sp4": run_ranks(4, _sp4_task, qkv),
        "sp2tp2": run_ranks(4, _sp2tp2_task, _qkv(T=16, D=8, seed=1), trees["dense"][1],
                            trees["moe"][1]),
        "sp2": run_ranks(2, _sp2_task, qkv, trees["engine"][1], _engine_prompts()),
    }


def _jax_ring(qkv, **axes):
    import jax.numpy as jnp

    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu.parallel.ring import ring_attention as jax_ring

    return np.asarray(jax_ring(*(jnp.asarray(a) for a in qkv), mesh=jax_make_mesh(**axes)))


def _jax_prefill_ring(jspec, jp, kv_dtype="bf16"):
    import jax.numpy as jnp

    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh

    k, v = jllama.init_cache(jspec, PAGES + 1, PAGE, kv_dtype=kv_dtype)
    padded = np.zeros((16,), np.int32)
    padded[:13] = _prompt()
    bt = np.zeros((8,), np.int32)
    bt[:4] = [1, 2, 3, 4]
    logits, k, v, dropped = jllama.prefill_forward_ring(
        jspec, jp, jnp.asarray(padded), jnp.asarray(bt), k, v,
        jnp.asarray(13, jnp.int32), mesh=jax_make_mesh(sp=2, tp=2))
    return np.asarray(logits), int(dropped), (k, v)


def _real_rows(pool, pages=slice(1, 4)):
    """The pages of the 13 real rows: 1..3 whole, page 4's first row."""
    return np.concatenate([pool[:, pages].reshape(pool.shape[0], -1),
                           pool[:, 4, :, :1].reshape(pool.shape[0], -1)], axis=1)


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("shape", [
    dict(dp=1, pp=1, sp=2, ep=1, tp=2), dict(dp=2, pp=2, sp=1, ep=1, tp=2),
    dict(dp=2, pp=1, sp=2, ep=2, tp=1), dict(dp=1, pp=4, sp=1, ep=1, tp=1),
    dict(dp=2, pp=2, sp=2, ep=2, tp=2)])
def test_group_members_follow_the_reference_reshape(shape):
    """Every group of every kind, against np.arange(n).reshape(dp, pp, sp,
    ep, tp): tp and expert groups never span a dp, pp or sp replica, each
    rank is in exactly one group of each kind, and Mesh.peer walks an
    axis."""
    grid = np.arange(int(np.prod(list(shape.values())))).reshape(
        [shape[a] for a in AXES])
    assert (rank_grid(shape) == grid).all()
    for over in GROUPS:
        got = group_members(shape, over)
        if over == "expert":
            want = [grid[d, p, s].reshape(-1).tolist() for d in range(shape["dp"])
                    for p in range(shape["pp"]) for s in range(shape["sp"])]
        else:
            ax = AXES.index(over)
            want = np.moveaxis(grid, ax, -1).reshape(-1, shape[over]).tolist()
        assert got == want, over
        assert sorted(r for g in got for r in g) == list(range(grid.size))
    for r in range(grid.size):
        coords = dict(zip(AXES, (int(c) for c in np.argwhere(grid == r)[0])))
        mesh = Mesh(shape, coords, torch.device("cpu"))
        for ax in AXES:
            for c in range(shape[ax]):
                want = grid[tuple(c if a == ax else coords[a] for a in AXES)]
                assert mesh.peer(ax, c) == want


@pytest.mark.parametrize("mesh", ["sp2", "sp4", "sp2tp2"])
def test_ring_attention_matches_jax_ring(groups, mesh):
    """Each rank's chunk (its tp heads) against the JAX ring on the same
    mesh, within ATTN_TOL; every rank sees every chunk once, its own
    first."""
    sp, tp = {"sp2": (2, 1), "sp4": (4, 1), "sp2tp2": (2, 2)}[mesh]
    qkv = _qkv(T=16, D=8, seed=1) if mesh == "sp2tp2" else _qkv()
    want = _jax_ring(qkv, sp=sp, tp=tp)
    ranks = groups[mesh]
    Tl, H = want.shape[0] // sp, want.shape[1]
    for r, res in enumerate(ranks):
        got, seen = res["ring"] if isinstance(res, dict) else res
        s, t = divmod(r, tp)
        np.testing.assert_allclose(
            got, want[s * Tl:(s + 1) * Tl, t * H // tp:(t + 1) * H // tp], atol=ATTN_TOL)
        assert seen == [(s - i) % sp for i in range(sp)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
def test_prefill_ring_matches_jax_on_sp2_tp2(groups, trees, kv_dtype):
    """prefill_forward_ring on make_mesh(sp=2, tp=2): every rank's logits
    within LOGIT_TOL of the JAX prefill_forward_ring's, each rank's pools
    (its KV head) on the real rows within POOL_TOL (fp8: one e4m3 step),
    the sp replicas' pools bit for bit equal."""
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec

    want, _d, (jk, jv) = _jax_prefill_ring(JaxSpec(**SPEC_KW), trees["dense"][0], kv_dtype)
    ranks = groups["sp2tp2"]
    for r, res in enumerate(ranks):
        logits, dropped, pools = res[kv_dtype]
        np.testing.assert_allclose(logits, want, atol=LOGIT_TOL)
        assert dropped == 0
        t = res["coords"]["tp"]
        for got, jpool in zip(pools, (jk, jv)):
            if kv_dtype == "fp8":
                from test_torch_llama import _e4m3_step

                tq = torch.from_numpy(got[0]).view(torch.float8_e4m3fn).float().numpy()
                ts = got[1][..., None, None]
                jq = np.asarray(jpool.vals.astype(np.float32))[:, :, t:t + 1]
                js = np.asarray(jpool.scale.astype(np.float32))[:, :, t:t + 1, None, None]
                a, b = _real_rows(tq * ts), _real_rows(jq * js)
                step = _real_rows(_e4m3_step(np.maximum(np.abs(tq), np.abs(jq)))
                                  * np.maximum(ts, js))
                assert (np.abs(a - b) <= step + 1e-12).all()
            else:
                np.testing.assert_allclose(_real_rows(got),
                                           _real_rows(np.asarray(jpool)[:, :, t:t + 1]),
                                           atol=POOL_TOL)
    for r in (0, 1):  # sp replicas of one tp coordinate: ranks r and r + 2
        for a, b in zip(ranks[r][kv_dtype][2], ranks[r + 2][kv_dtype][2]):
            for x, y in zip(a if kv_dtype == "fp8" else (a,), b if kv_dtype == "fp8" else (b,)):
                assert np.array_equal(x, y)


def test_moe_ring_prefill_routes_the_whole_prompt(groups, trees):
    """A tiny MoE GQA spec under sp=2 x tp=2: the experts route all T rows
    (gathered over sp), so the logits match the JAX ring prefill's within
    LOGIT_TOL and the dropped slots are equal, on every rank."""
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec

    want, want_dropped, _pools = _jax_prefill_ring(JaxSpec.tiny_moe(), trees["moe"][0])
    for res in groups["sp2tp2"]:
        logits, dropped, _p = res["moe"]
        np.testing.assert_allclose(logits, want, atol=LOGIT_TOL)
        assert dropped == want_dropped
    stats = groups["sp2tp2"][0]["stats"]
    assert stats["sp"]["calls"] > 0 and stats["tp"]["calls"] > 0
    assert stats["pp"]["calls"] == stats["dp"]["calls"] == 0


async def test_sp2_engine_streams_match_jax_sp2_engine(groups, trees):
    """The sp=2 engine (leader plus follower) serves three cold prompts by
    ring prefill and a warm-prefix sharer on the packed path; its greedy
    streams equal the JAX engine's on make_mesh(sp=2), the follower
    replayed every ring prefill, and the replicas' pools are bit for bit
    equal."""
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu.runtime.context import Context as JaxContext

    prompts = _engine_prompts()
    jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW, sp=2),
                     params=trees["engine"][0], mesh=jax_make_mesh(sp=2))

    async def one(p):
        req = {"token_ids": p, "stop_conditions": {"max_tokens": N_TOKENS,
                                                   "ignore_eos": True}}
        return [t for x in [x async for x in jeng.generate(req, JaxContext())]
                for t in x["token_ids"]]

    want = list(await asyncio.gather(*(one(p) for p in prompts[:-1])))
    want.append(await one(prompts[-1]))
    await jeng.close()
    lead, follow = (r["engine"] for r in groups["sp2"])
    assert lead["streams"] == want
    assert lead["ring_prefills"] == 3 and lead["prefills"] == 4
    assert follow["ops"]["ring_prefill"] == 3 and follow["ops"]["prefill"] == 1
    assert lead["digest"]["pages"] > 0 and follow["digest"] == lead["digest"]


@pytest.mark.parametrize("case", ["cold", "warm", "odd-bucket", "multimodal", "gpt-oss",
                                  "too-long", "no-sp"])
def test_ring_admission_takes_the_reference_conditions(case):
    """The engine's ring decision (``_prefill``'s conditions, the
    reference's): only a cold text prompt that fits the largest bucket,
    whose bucket divides by sp, of a spec without attention extras, under
    sp > 1. Checked on a one-process engine holding a coordinates-only sp=3
    mesh (no collective runs: no forward is dispatched)."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.parallel.mesh import AXES as axes

    spec = ModelSpec(**SPEC_KW)
    if case == "gpt-oss":
        spec = dataclasses.replace(spec, attn_sinks=True)
    sp = 1 if case == "no-sp" else 3
    mesh = Mesh(dict.fromkeys(axes, 1) | {"sp": sp}, dict.fromkeys(axes, 0),
                torch.device("cpu"))
    eng = InferenceEngine(spec, EngineConfig(**{**CFG_KW, "prefill_buckets": (8, 24, 48)},
                                             sp=sp), device="cpu", mesh=mesh)
    tail, start, mm = {"odd-bucket": 5, "too-long": 50}.get(case, 20), 0, None
    if case == "warm":
        start = 8
    if case == "multimodal":
        mm = {"embeds": None}
    assert eng._takes_ring(start, tail, mm) is (case in ("cold",))
    assert eng._ring_sp() == (1 if case in ("gpt-oss", "no-sp") else 3)


def test_ring_forward_refuses_a_bucket_that_does_not_divide():
    """prefill_forward_ring raises on a bucket that does not divide over sp
    or into pages (the engine never sends one)."""
    from dynamo_tpu_torch.models import llama

    spec = ModelSpec(**SPEC_KW)
    params = llama.init_params(spec, 0, device="cpu")
    params.mesh = Mesh(dict.fromkeys(AXES, 1) | {"sp": 2}, dict.fromkeys(AXES, 0),
                       torch.device("cpu"), groups={"sp": object()})
    k, v = llama.init_cache(spec, 5, PAGE, device="cpu")
    with pytest.raises(ValueError, match="must divide over sp=2"):
        llama.prefill_forward_ring(spec, params, torch.zeros(6, dtype=torch.int32),
                                   torch.zeros(4, dtype=torch.int32), k, v, 3)


def test_ring_modules_import_no_jax():
    """parallel/ring.py and parallel/pipeline.py import torch and the port
    only."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "dynamo_tpu_torch" / "parallel"
    for name in ("ring.py", "pipeline.py", "mesh.py"):
        tree = ast.parse((root / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert not any(m.split(".")[0] in ("jax", "dynamo_tpu") for m in mods), name
