"""Pipeline parallelism of the port (parallel/pipeline.py: ``stack_params``,
the stage pools, ``pp_prefill`` and ``pp_decode_step`` with the kv_write
and paged_attention_v3 wrappers; the pp stage slice of models/convert and
models/loader) held against the JAX package's pipeline on the same mesh.

The JAX side runs ``dynamo_tpu.parallel.pipeline`` on ``make_mesh(pp=2)``,
``make_mesh(pp=2, tp=2)`` and ``make_mesh(pp=2, dp=2)`` in this process
(the 8 forced CPU devices of tests/conftest.py), with
tests/test_pipeline_pp.py's spec. The port runs one process per rank: gloo
ranks spawned with ``torch.multiprocessing`` (tests/test_torch_parallel.py's
harness), one spawn per mesh; the rank functions live at module level and
import no JAX. On the CPU the kernel wrappers take their plain versions.

Tolerances, as the reference's own tests (tests/test_pipeline_pp.py):
prefill logits within 2e-4 (rtol 1e-4), decode logits within 3e-4 (rtol
1e-3), pages within 1e-5; the dp replicas' pools are equal bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.models.convert import shard_params
from dynamo_tpu_torch.parallel.mesh import AXES, Mesh
from test_torch_parallel import run_ranks

pytestmark = pytest.mark.unit

PREFILL_ATOL, PREFILL_RTOL = 2e-4, 1e-4
DECODE_ATOL, DECODE_RTOL = 3e-4, 1e-3
POOL_TOL = 1e-5
SPEC_KW = dict(name="pp-test", vocab_size=96, hidden_size=32, intermediate_size=64,
               num_layers=4, num_heads=4, num_kv_heads=2, head_dim=8, dtype="float32",
               tie_embeddings=False)
PAGE = 4
T = 16
B, PPS = 8, 2  # decode slots, pages per slot
MESHES = {"pp2": dict(pp=2), "pp2tp2": dict(pp=2, tp=2), "pp2dp2": dict(pp=2, dp=2)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _decode_inputs():
    """The reference test's decode step: 8 slots of 2 pages, random tokens
    and lengths, every page filled with random K/V context."""
    rng = np.random.default_rng(0)
    bt = np.stack([np.arange(1 + i * PPS, 1 + (i + 1) * PPS) for i in range(B)]).astype(np.int32)
    tokens = rng.integers(3, SPEC_KW["vocab_size"], B).astype(np.int32)
    seq_lens = rng.integers(2, PAGE * PPS, B).astype(np.int32)
    shape = (SPEC_KW["num_layers"], 1 + B * PPS, SPEC_KW["num_kv_heads"], PAGE,
             SPEC_KW["head_dim"])
    k_init = rng.standard_normal(shape).astype(np.float32)
    v_init = rng.standard_normal(shape).astype(np.float32)
    return bt, tokens, seq_lens, k_init, v_init


def _local(spec, mesh, full: np.ndarray) -> torch.Tensor:
    """This rank's stage pools out of the whole ``[L, pages, KH, page, D]``:
    its stage's layers, its KV heads."""
    ls = mesh.shard(spec.num_layers, "layers", "pp")
    hs = mesh.shard(spec.num_kv_heads, "KV heads")
    return torch.from_numpy(full[ls, :, hs].copy())


def _pp_task(rank, n, axes, tree, decode):
    """One mesh's ranks: pp_prefill of a 16-token prompt into fresh stage
    pools, then (``decode``) one pp_decode_step over seeded pools. Returns
    the logits, the pools, the coordinates and the per-group collectives
    of the decode step."""
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.pipeline import (
        init_stage_cache,
        pp_decode_step,
        pp_prefill,
        stack_params,
    )

    spec = ModelSpec(**SPEC_KW)
    mesh = make_mesh(**axes)
    stage = stack_params(spec, shard_params(spec, tree, mesh, device="cpu"))
    out = {"coords": dict(mesh.coords), "n_local": stage.n_local}
    k, v = init_stage_cache(spec, 16, PAGE, mesh, device="cpu", dtype=torch.float32)
    tokens = torch.arange(T, dtype=torch.int32) % spec.vocab_size
    bt = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32)
    with torch.inference_mode():
        out["prefill"] = (pp_prefill(spec, stage, tokens, bt, k, v, T).numpy(),
                          k.numpy().copy(), v.numpy().copy())
        if decode:
            bt, tokens, seq_lens, k_init, v_init = decode
            k, v = _local(spec, mesh, k_init), _local(spec, mesh, v_init)
            before = {g: dict(st) for g, st in mesh.group_stats.items()}
            logits = pp_decode_step(spec, stage, torch.from_numpy(tokens),
                                    torch.from_numpy(bt), torch.from_numpy(seq_lens), k, v,
                                    torch.ones(B, dtype=torch.bool))
            out["coll"] = {g: {key: st[key] - before[g][key] for key in ("calls", "bytes")}
                           for g, st in mesh.group_stats.items()}
            out["decode"] = (logits.numpy(), k.numpy().copy(), v.numpy().copy())
    return out


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def tree():
    import jax

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama

    jp = jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def ranks(tree):
    decode = _decode_inputs()
    return {name: run_ranks(int(np.prod(list(axes.values()))), _pp_task, axes, tree[1],
                            None if name == "pp2" else decode)
            for name, axes in MESHES.items()}


def _jax_pp(jp, axes, decode=None):
    """The JAX pipeline on the same mesh: pp_prefill of the same prompt,
    or one pp_decode_step over the same pools. (logits, k, v) as numpy."""
    import jax
    import jax.numpy as jnp

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu.parallel.pipeline import (
        pp_cache_shardings,
        pp_decode_step,
        pp_param_shardings,
        pp_prefill,
        stack_params,
    )

    jspec = JaxSpec(**SPEC_KW)
    mesh = jax_make_mesh(**axes)
    pp_params = jax.tree.map(lambda p, s: jax.device_put(p, s), stack_params(jspec, jp),
                             pp_param_shardings(jspec, mesh))
    ks, vs = pp_cache_shardings(mesh)
    if decode is None:
        k, v = jllama.init_cache(jspec, 16, PAGE)
        out = pp_prefill(jspec, pp_params, jnp.arange(T, dtype=jnp.int32) % jspec.vocab_size,
                         jnp.asarray([1, 2, 3, 4, 0, 0, 0, 0], jnp.int32),
                         jax.device_put(k, ks), jax.device_put(v, vs),
                         jnp.asarray(T, jnp.int32), mesh=mesh)
    else:
        bt, tokens, seq_lens, k_init, v_init = decode
        out = pp_decode_step(jspec, pp_params, jnp.asarray(tokens), jnp.asarray(bt),
                             jnp.asarray(seq_lens), jax.device_put(jnp.asarray(k_init), ks),
                             jax.device_put(jnp.asarray(v_init), vs),
                             jnp.ones((B,), bool), mesh=mesh)
    return tuple(np.asarray(a) for a in out)


def _stage_slice(full: np.ndarray, coords: dict, axes: dict) -> np.ndarray:
    pp, tp = axes.get("pp", 1), axes.get("tp", 1)
    nl, kh = full.shape[0] // pp, full.shape[2] // tp
    return full[coords["pp"] * nl:(coords["pp"] + 1) * nl, :,
                coords["tp"] * kh:(coords["tp"] + 1) * kh]


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("mesh", ["pp2", "pp2tp2"])
def test_pp_prefill_matches_jax_pipeline(ranks, tree, mesh):
    """pp_prefill: every rank's last-token logits against the JAX
    pp_prefill's on the same mesh, each rank's stage pools against the
    matching slice of the JAX pools (pages 1-4, the prompt's)."""
    axes = MESHES[mesh]
    want_logits, wk, wv = _jax_pp(tree[0], axes)
    for res in ranks[mesh]:
        logits, k, v = res["prefill"]
        assert res["n_local"] == SPEC_KW["num_layers"] // axes["pp"]
        np.testing.assert_allclose(logits, want_logits, atol=PREFILL_ATOL, rtol=PREFILL_RTOL)
        for got, want in ((k, wk), (v, wv)):
            np.testing.assert_allclose(got[:, 1:5], _stage_slice(want, res["coords"], axes)[:, 1:5],
                                       atol=POOL_TOL)


@pytest.mark.parametrize("mesh", ["pp2tp2", "pp2dp2"])
def test_pp_decode_step_matches_jax_pipeline(ranks, tree, mesh):
    """One pp_decode_step of 8 slots: every rank's logits [B, V] against
    the JAX pp_decode_step's on the same mesh, each rank's stage pools
    (every written row, bubble ticks' trash page excluded) against the
    matching slice of the JAX pools. Under dp the replicas' pools are
    equal bit for bit."""
    axes = MESHES[mesh]
    want_logits, wk, wv = _jax_pp(tree[0], axes, _decode_inputs())
    for res in ranks[mesh]:
        logits, k, v = res["decode"]
        np.testing.assert_allclose(logits, want_logits, atol=DECODE_ATOL, rtol=DECODE_RTOL)
        for got, want in ((k, wk), (v, wv)):
            np.testing.assert_allclose(got[:, 1:], _stage_slice(want, res["coords"], axes)[:, 1:],
                                       atol=POOL_TOL)
    if mesh == "pp2dp2":
        by_stage = {}
        for res in ranks[mesh]:
            by_stage.setdefault(res["coords"]["pp"], []).append(res["decode"][1:])
        for pools in by_stage.values():
            (ka, va), (kb, vb) = pools
            assert np.array_equal(ka[:, 1:], kb[:, 1:]) and np.array_equal(va[:, 1:], vb[:, 1:])


def test_pp_decode_step_collectives_per_group(ranks):
    """The fixed schedule's traffic at pp=2 x tp=2: 2 * pp - 2 = 2
    activation hops and one broadcast over pp, the stage's 2 x 3 ticks x 2
    all-reduces plus the head's all-gather over tp, nothing over sp or
    dp; at pp=2 x dp=2 the new rows, pages, offsets and logits go over
    dp."""
    res = ranks["pp2tp2"][0]["coll"]
    assert res["pp"]["calls"] == 3
    assert res["tp"]["calls"] == 2 * 3 * 2 + 1
    assert res["sp"]["calls"] == res["dp"]["calls"] == res["expert"]["calls"] == 0
    dp = ranks["pp2dp2"][0]["coll"]
    assert dp["dp"]["calls"] == 3 * (2 + 2 * 2) + 1
    assert dp["tp"]["calls"] == 0


def _fake_mesh(**axes) -> Mesh:
    """A rank's coordinates (all 0) without process groups: the refusals
    raise before any collective."""
    return Mesh(dict.fromkeys(AXES, 1) | axes, dict.fromkeys(AXES, 0), torch.device("cpu"))


def _stage(spec, mesh):
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.pipeline import stack_params

    return stack_params(spec, llama.init_params(spec, 0, device="cpu", mesh=mesh))


@pytest.mark.parametrize("case", ["batch", "layers", "quant", "moe"])
def test_pipeline_refusals(case):
    """The reference's refusals: a batch that does not divide dp x pp,
    layers that do not divide pp, fp8 pools (stages write unquantized
    pages), and MoE specs (stack_params, in the reference's words)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.pipeline import (
        init_stage_cache,
        pp_decode_step,
        pp_prefill,
        stack_params,
    )

    spec = ModelSpec(**SPEC_KW)
    mesh = _fake_mesh(pp=2, dp=2)
    if case == "moe":
        moe = ModelSpec.tiny_moe()
        with pytest.raises(NotImplementedError, match="dense layers only"):
            stack_params(moe, llama.init_params(moe, 0, device="cpu", mesh=_fake_mesh(pp=2)))
        return
    stage = _stage(spec, mesh)
    k, v = init_stage_cache(spec, 17, PAGE, mesh, device="cpu", dtype=torch.float32)
    if case == "batch":
        with pytest.raises(ValueError, match="must divide pp"):
            pp_decode_step(spec, stage, torch.zeros(6, dtype=torch.int32),
                           torch.zeros((6, 2), dtype=torch.int32), torch.ones(6, dtype=torch.int32),
                           k, v, torch.ones(6, dtype=torch.bool))
    elif case == "layers":
        with pytest.raises(ValueError, match="does not divide over pp=2"):
            llama.init_params(dataclasses.replace(spec, num_layers=3), 0, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="layers 5 must divide pp=2"):
            pp_prefill(dataclasses.replace(spec, num_layers=5), stage,
                       torch.zeros(8, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                       k, v, 8)
    else:
        kq, vq = llama.init_cache(dataclasses.replace(spec, num_layers=2), 17, PAGE,
                                  device="cpu", kv_dtype="fp8")
        with pytest.raises(ValueError, match="unquantized"):
            pp_prefill(spec, stage, torch.zeros(8, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32), kq, vq, 8)


@pytest.mark.parametrize("coord", [(0, 0), (1, 1)])
def test_stage_weights_and_sharded_load(tmp_path, tree, coord):
    """A rank's stage: init_params(mesh=) keeps the seeded init's stage
    layers (drawn in the same order), shard_params of the JAX tree takes
    them whole-embedding and tp-cut, and load_params(mesh=) reads that
    stage only from a checkpoint, its bytes under the whole file's."""
    from dynamo_tpu_torch.models import llama, loader

    spec = ModelSpec(**SPEC_KW)
    mesh = Mesh(dict.fromkeys(AXES, 1) | {"pp": 2, "tp": 2},
                dict.fromkeys(AXES, 0) | {"pp": coord[0], "tp": coord[1]}, torch.device("cpu"))
    full = llama.init_params(spec, 0, device="cpu")
    mine = llama.init_params(spec, 0, device="cpu", mesh=mesh)
    want = shard_params(spec, full, mesh)
    assert len(mine.layers) == len(want.layers) == 2
    for (n, a), (n2, b) in zip(mine.named_parameters(), want.named_parameters()):
        assert n == n2 and torch.equal(a, b), n
    assert torch.equal(mine.embed, full.embed)
    assert torch.equal(mine.layers[0].wq, full.layers[2 * coord[0]].wq[:, 16 * coord[1]:16 * (coord[1] + 1)])
    loader.save_params(spec, full, str(tmp_path))
    _s, whole = loader.load_model_dir(str(tmp_path), device="cpu")
    _s, got = loader.load_model_dir(str(tmp_path), mesh=mesh, device="cpu")
    got_d, want_d = dict(got.named_parameters()), dict(want.named_parameters())
    assert got_d.keys() == want_d.keys()
    for n, a in got_d.items():
        assert torch.equal(a, want_d[n]), n
    layer_bytes = sum(p.nbytes for p in whole.layers.parameters())
    assert got.bytes_read < whole.bytes_read - layer_bytes // 2
