"""Disaggregated serving under tensor parallelism (the port's per-shard KV
exports, the ``kv_export`` / ``kv_resume`` / ``embed`` ops of the SPMD
plane), held against the JAX package.

One spawn of four gloo ranks: a prefill group (tp=2) and a decode group
(tp=2), each a ``launch_engine_worker`` leader with its follower, on a TCP
hub this process serves. This process drives them, and is itself the
other side of the width-mismatched cases, a JAX tp=2 prefill engine on
``make_mesh(tp=2)`` (CPU devices) and the one-rank reference engines:

- tp=2 to tp=2 through the decode worker's front door: each decode rank
  pulls its own shard at the leader's intake (op ``kv_prefetch``) and
  installs exactly its prefill twin's export (mode ``shard``); streams
  equal the one-rank engine's; no shard is left at the prefill group;
- tp=2 to tp=1: a one-rank decode engine here pulls the export whole over
  TCP (the prefill leader joins the shards): its install equals the two
  shards joined on the heads axis, bit for bit;
- the export's ``shard_axis`` and ``shards[*].{start, k_shape, v_shape}``
  equal the reference's ``shard_layout`` of the JAX engine's sharded
  pages, the JAX package's TCP ``pull_kv_blocks`` gets the full shape, and
  the pages agree with the JAX engine's within f32 tolerance;
- tp=1 to tp=2 and a JAX tp=2 prefill engine to the port's tp=2 group: the
  decode leader pulls whole and sends each rank its heads over the group
  (mode ``scatter``): each rank installs its heads of the source's blocks,
  bit for bit;
- ``/v1/embeddings``' engine path on the tp=2 group (op ``embed``) equals
  the one-rank engine's vector within 1e-4.

Spawned ranks import this module: it imports no JAX at module level.
Without a process group (``local_mesh``), the packed fp8 join and split,
an fp8 sharded export pulled whole, MLA's whole latent rows, the release
of every shard of a dropped staging and a mirrored resume in chunks are
held in this process.
"""

from __future__ import annotations

import asyncio
import json
import traceback

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from test_torch_parallel import group_store, join_group

pytestmark = pytest.mark.integration

RANK_TIMEOUT_S = 240.0
SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=16, dtype="float32")
CFG_KW = dict(page_size=4, num_pages=96, max_pages_per_seq=16, max_decode_slots=4,
              prefill_buckets=(8, 16, 32, 64))
EMBED_SCALE = 32.0  # peaked logits: tp and one-rank greedy streams agree
TOKENS = 6
NS = "t"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _req(prompt, n=TOKENS, **kw):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True},
            "eos_token_ids": [2], **kw}


def _prompts():
    rng = np.random.default_rng(4)
    p = [rng.integers(0, 128, k).tolist() for k in (13, 22, 9, 18)]
    p.append(p[1][:16] + [5, 6, 7])  # shares 4 pages with prompt 1
    return p


def _np(t) -> np.ndarray:
    from dynamo_tpu_torch.kvbm.offload import block_numpy

    return block_numpy(t.detach().cpu()).copy() if isinstance(t, torch.Tensor) \
        else np.array(t)


# ------------------------------------------------------------- rank side


def _record_exports(src, into: dict) -> None:
    """Keep a copy of every block this source exports, by transfer id."""
    real = src.export

    def export(k, v, **kw):
        params = real(k, v, **kw)
        into[params["transfer_id"]] = (_np(k), _np(v))
        return params

    src.export = export


def _record_installs(engine, into: list) -> None:
    """Keep every install (page ids, k and v tails) in order."""
    real = engine._insert_blocks

    def insert(k, v, ready, page_ids, first):
        into.append((list(page_ids), _np(k[:, first:]), _np(v[:, first:])))
        return real(k, v, ready, page_ids, first)

    engine._insert_blocks = insert


def _fail_last_shard_pull(engine, n_ok: int) -> None:
    """The decode follower's pull of its shard (its prefetch at the
    leader's intake) fails after ``n_ok`` clean ones (the ``disagg.pull``
    fault site): the group must install nothing and the leader prefill
    locally."""
    from dynamo_tpu_torch.runtime.faults import FAULTS

    real, seen = engine.prefetch_shard, []

    def prefetch(kvp):
        seen.append(kvp.get("transfer_id"))
        if len(seen) == n_ok + 1:
            FAULTS.configure("disagg.pull:error@1x1")
        return real(kvp)

    engine.prefetch_shard = prefetch


async def _rank_serve(role, rank, n, job, done):
    from dynamo_tpu_torch.disagg.transfer import KvTransferSource
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.engine.worker import XFER_KEY_FMT, launch_engine_worker
    from dynamo_tpu_torch.models.convert import shard_params
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub

    spec = ModelSpec(**SPEC_KW)
    mesh = make_mesh(tp=n)
    params = shard_params(spec, job["tree"], mesh, device="cpu")
    cfg = EngineConfig(**CFG_KW, tp=n)
    comp = f"{role}_backend"
    group = f"{NS}/{comp}/generate"
    out: dict = {"exports": {}, "installs": []}
    if rank == 0:
        addr = job["hub"]
        drt = DistributedRuntime(await RemoteHub.connect(addr),
                                 RuntimeConfig(hub_address=addr))
        leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                  strict=True).start()
        kw = dict(namespace=NS, component=comp, spec=spec, params=params,
                  engine_config=cfg, device="cpu", mesh=mesh, spmd=leader,
                  router_mode="round_robin", prefill_router_mode="round_robin",
                  prefill_component="prefill_tp")
        if role == "prefill":
            engine, _ = await launch_engine_worker(drt, mode="prefill", **kw)
            _record_exports(engine.transfer_source, out["exports"])
        else:
            engine, _ = await launch_engine_worker(drt, mode="decode",
                                                   always_remote_prefill=True, **kw)
            await engine.frontdoor.wait_for_prefill_pool(timeout=RANK_TIMEOUT_S)
            # this process's raw engine: the test's process sends resumes of other
            # sources' exports and embedding requests here
            await drt.namespace(NS).component("raw").endpoint("generate").serve(
                engine.generate)
            modes = out["modes"] = []
            real = engine.install_remote

            def install(mode, kvp, *a, **k):
                modes.append((mode, kvp.get("transfer_id")))
                return real(mode, kvp, *a, **k)

            engine.install_remote = install
            _record_installs(engine, out["installs"])
        await asyncio.to_thread(done.wait, RANK_TIMEOUT_S)
        out["fallbacks"] = engine.disagg_fallbacks
        if engine.transfer_source is not None:
            out["pending"] = engine.transfer_source.pending
        await engine.close()
        await drt.close()
    else:
        src = None
        if role == "prefill":
            src = await KvTransferSource().start()
            await StoreHub().put(XFER_KEY_FMT.format(group=group, rank=rank),
                                 json.dumps({"addr": f"{src.host}:{src.port}",
                                             "uid": src.uid}))
            _record_exports(src, out["exports"])
        engine = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh,
                                 transfer_source=src)
        _record_installs(engine, out["installs"])
        if role == "decode":
            _fail_last_shard_pull(engine, job["shard_resumes"])
        f = SpmdFollower(StoreHub(), group, engine, rejoin=False)
        await f.run()
        out["ops"] = dict(f.ops)
        if src is not None:
            out["pending"] = src.pending  # the engine's close drops the rest
        await engine.close()
        if src is not None:
            await src.close()
    return out


def _rank_main(role, rank, n, port, job, q, done):
    try:
        torch.set_num_threads(1)
        from dynamo_tpu_torch.parallel.multihost import shutdown

        join_group(port, n, rank, 60)
        try:
            q.put(((role, rank), "ok", asyncio.run(_rank_serve(role, rank, n, job, done))))
        finally:
            shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put(((role, rank), "error", traceback.format_exc()))


# ------------------------------------------------------ the test's side


def _jax_tree():
    import jax

    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.models import llama as jllama

    jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(1)))
    jp["embed"] = jp["embed"] * EMBED_SCALE
    return jp, jax.tree.map(np.asarray, jp)


async def _tokens(agen):
    out = []
    async for item in agen:
        assert item.get("finish_reason") != "error", item
        out.extend(item.get("token_ids") or [])
    return out


async def _drive(job, jp) -> dict:
    """Everything this process asks of the two groups; the record."""
    import dynamo_tpu.disagg.transfer as jtr
    import dynamo_tpu.runtime.context as jctx
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.config import ModelSpec as JaxSpec
    from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
    from dynamo_tpu.parallel import make_mesh as jax_make_mesh
    from dynamo_tpu_torch.disagg import transfer as tr
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models.convert import params_from_numpy
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

    spec = ModelSpec(**SPEC_KW)
    full = params_from_numpy(spec, job["tree"], device="cpu")
    prompts = _prompts()
    rec: dict = {"prompts": prompts}
    addr = job["hub"]
    drt = DistributedRuntime(await RemoteHub.connect(addr), RuntimeConfig(hub_address=addr))

    async def router(comp):
        r = await PushRouter.from_endpoint(
            drt.namespace(NS).component(comp).endpoint("generate"), RouterMode.ROUND_ROBIN)
        await r.client.wait_for_instances(1, timeout=RANK_TIMEOUT_S)
        return r

    front, prefill, raw = (await router("decode_backend"), await router("prefill_tp"),
                           await router("raw"))

    async def prefill_export(p):
        r = _req(p, n=1, disagg={"mode": "prefill", "kv_transfer": {"do_remote_decode": True}})
        (item,) = [i async for i in prefill.generate(r, Context())]
        return item["token_ids"][0], item["kv_transfer_params"]

    # the one-rank references
    one = InferenceEngine(spec, EngineConfig(**CFG_KW), params=full, device="cpu")
    rec["one"] = [await _tokens(one.generate(_req(p), Context())) for p in prompts]
    rec["one_embed"] = one._embed(prompts[0])
    await one.close()

    # (a) tp=2 -> tp=2 through the decode worker's front door
    got = list(await asyncio.gather(*(_tokens(front.generate(_req(p), Context()))
                                      for p in prompts[:-1])))
    got.append(await _tokens(front.generate(_req(prompts[-1]), Context())))
    rec["front"] = got

    # (b) tp=2 -> tp=1: a one-rank decode engine here pulls the export whole
    dec1 = InferenceEngine(spec, EngineConfig(**CFG_KW), params=full, device="cpu")
    rec["dec1_installs"] = []
    _record_installs(dec1, rec["dec1_installs"])
    first, kvp = await prefill_export(prompts[0])
    rec["b_params"] = kvp
    resume = _req(prompts[0], disagg={"mode": "decode",
                                      "kv_transfer": {**kvp, "first_token": first}})
    rec["b"] = [first] + await _tokens(dec1.generate(resume, Context()))
    rec["b_pulls"] = tr.PULLS.snapshot()["pulls"]
    await dec1.close()

    # the JAX package's TCP pull of a sharded export: the whole blocks
    first, kvp = await prefill_export(prompts[2])
    rec["jax_pull_params"] = kvp
    k, v, _meta = await asyncio.to_thread(jtr.pull_kv_blocks, kvp)
    rec["jax_pull"] = (np.asarray(k), np.asarray(v))

    # the JAX engine's export on make_mesh(tp=2): its sharded pages
    jsrc = await jtr.KvTransferSource(device_transfer=False).start()
    jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW), params=jp,
                     transfer_source=jsrc, mesh=jax_make_mesh(tp=2))
    layouts = []
    real_export = jsrc.export

    def jexport(kb, vb, **kw):
        layouts.append((jtr.shard_layout(kb), jtr.shard_layout(vb), np.asarray(kb),
                        np.asarray(vb)))
        return real_export(kb, vb, **kw)

    jsrc.export = jexport
    try:
        for p in (prompts[2], prompts[3]):
            r = _req(p, n=1, disagg={"mode": "prefill",
                                     "kv_transfer": {"do_remote_decode": True}})
            (item,) = [i async for i in jeng.generate(r, jctx.Context())]
            if p is prompts[3]:
                # (d) the JAX tp=2 prefill engine's export resumed by the
                # port's tp=2 group over TCP
                jkvp, jfirst = item["kv_transfer_params"], item["token_ids"][0]
                resume = _req(p, disagg={"mode": "decode",
                                         "kv_transfer": {**jkvp, "first_token": jfirst}})
                rec["d_tid"] = jkvp["transfer_id"]
                rec["d"] = [jfirst] + await _tokens(raw.generate(resume, Context()))
        rec["jax_layouts"] = [(lk[0], [(s, list(a.shape)) for s, a in lk[1]],
                               lv[0], [(s, list(a.shape)) for s, a in lv[1]], k, v)
                              for lk, lv, k, v in layouts]
    finally:
        await jeng.close()
        await jsrc.close()

    # (c) tp=1 -> tp=2: a one-rank prefill engine here, resumed by the group
    src = await tr.KvTransferSource().start()
    pre1 = InferenceEngine(spec, EngineConfig(**CFG_KW), params=full, device="cpu",
                           transfer_source=src)
    rec["c_exports"] = {}
    _record_exports(src, rec["c_exports"])
    try:
        r = _req(prompts[3], n=1, disagg={"mode": "prefill",
                                          "kv_transfer": {"do_remote_decode": True}})
        (item,) = [i async for i in pre1.generate(r, Context())]
        kvp, first = item["kv_transfer_params"], item["token_ids"][0]
        rec["c_tid"] = kvp["transfer_id"]
        resume = _req(prompts[3], disagg={"mode": "decode",
                                          "kv_transfer": {**kvp, "first_token": first}})
        rec["c"] = [first] + await _tokens(raw.generate(resume, Context()))
    finally:
        await pre1.close()
        await src.close()

    # (f) the decode follower's shard pull fails (its fault is armed for
    # the resume after the front door's): no rank installs, the leader
    # prefills locally and the stream equals the one-rank engine's
    fresh = np.random.default_rng(9).integers(0, 128, 15).tolist()
    one = InferenceEngine(spec, EngineConfig(**CFG_KW), params=full, device="cpu")
    rec["f_want"] = await _tokens(one.generate(_req(fresh), Context()))
    await one.close()
    rec["f"] = await _tokens(front.generate(_req(fresh), Context()))

    # (e) an embedding request on the tp=2 group (op embed)
    items = [i async for i in raw.generate(
        {"token_ids": prompts[0], "embedding_request": True}, Context())]
    rec["embed"] = items[-1]["embedding"]
    for r in (front, prefill, raw):
        await r.client.close()
    await drt.close()
    return rec


def _spawn(job, q, done, stores):
    """The four ranks; ``stores`` gets each group's rendezvous store, which
    the caller holds until the ranks are done."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = []
    for role in ("prefill", "decode"):
        stores.append(group_store())
        for r in range(2):
            procs.append(ctx.Process(target=_rank_main,
                                     args=(role, r, 2, stores[-1].port, job, q, done)))
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def groups():
    """The four ranks, driven once; (this process's record, rank results)."""
    import torch.multiprocessing as mp

    from dynamo_tpu_torch.runtime.hub_server import HubServer

    jp, tree = _jax_tree()
    ctx = mp.get_context("spawn")
    q, done = ctx.Queue(), ctx.Event()
    prev = torch.get_num_threads()
    torch.set_num_threads(2)

    async def main():
        hub = HubServer()
        host, port = await hub.start()
        job = {"hub": f"{host}:{port}", "tree": tree, "shard_resumes": len(_prompts())}
        stores: list = []
        procs = _spawn(job, q, done, stores)
        try:
            rec = await asyncio.wait_for(_drive(job, jp), RANK_TIMEOUT_S)
        finally:
            done.set()
        ranks = {}
        try:
            for _ in procs:
                key, status, res = await asyncio.to_thread(q.get, True, RANK_TIMEOUT_S)
                assert status == "ok", res
                ranks[key] = res
        finally:
            for p in procs:
                await asyncio.to_thread(p.join, 30)
                if p.is_alive():
                    p.kill()
            await hub.stop()
        return rec, ranks

    try:
        return asyncio.run(main())
    finally:
        torch.set_num_threads(prev)


# ------------------------------------------------------------------ tests


def _join(exports, tid, packed=False):
    from dynamo_tpu_torch.disagg.transfer import join_heads

    parts = [exports[r][tid] for r in range(2)]
    h = SPEC_KW["num_kv_heads"] // 2
    return (join_heads([p[0] for p in parts], [h, h], packed),
            join_heads([p[1] for p in parts], [h, h], packed))


def test_tp2_to_tp2_streams_equal_one_rank_and_each_rank_installs_its_twins_shard(groups):
    """Through the decode worker's front door every prompt prefills on the
    tp=2 prefill group and resumes on the tp=2 decode group: the streams
    equal the one-rank engine's, every install is mode ``shard`` with no
    fallback, and each decode rank's installed pages are bitwise its
    prefill twin's export (the tail past a cached prefix)."""
    rec, ranks = groups
    n = len(rec["prompts"])
    assert rec["front"] == rec["one"]
    lead = ranks[("decode", 0)]
    shard_modes = [(m, t) for m, t in lead["modes"] if m == "shard"][:n]
    assert len(shard_modes) == n
    exports = {r: ranks[("prefill", r)]["exports"] for r in range(2)}
    for r in range(2):
        installs = ranks[("decode", r)]["installs"][:n]
        for (_m, tid), (pages, k, v) in zip(shard_modes, installs):
            ek, ev = exports[r][tid]
            assert k.shape[1] == len(pages) and k.shape[2] == SPEC_KW["num_kv_heads"] // 2
            np.testing.assert_array_equal(k, ek[:, ek.shape[1] - k.shape[1]:])
            np.testing.assert_array_equal(v, ev[:, ev.shape[1] - v.shape[1]:])
    assert ranks[("decode", 1)]["ops"]["kv_resume"] >= n
    assert ranks[("prefill", 1)]["ops"]["kv_export"] >= n


def test_a_failed_shard_pull_installs_nothing_and_prefills_locally(groups):
    """One rank's shard pull fails at the resume: the group agrees on it
    before anyone installs, so neither decode rank installs a page of that
    export, the leader counts one fallback and prefills the prompt plus the
    relayed first token itself, and the stream equals the one-rank
    engine's."""
    rec, ranks = groups
    lead = ranks[("decode", 0)]
    shard = [m for m in lead["modes"] if m[0] == "shard"]
    assert len(shard) == len(rec["prompts"]) + 1
    assert lead["fallbacks"] == 1
    assert rec["f"] == rec["f_want"]
    assert lead["modes"][-1] == shard[-1]
    for r in range(2):
        # one install per resume that landed: none for the failed one
        assert len(ranks[("decode", r)]["installs"]) == len(lead["modes"]) - 1


def test_tp2_to_tp1_whole_pull_joins_the_shards_bitwise(groups):
    """A one-rank decode engine pulls a tp=2 export whole over TCP: the
    prefill leader joins both shards on the heads axis, the install is
    exactly that join, and the stream equals the one-rank engine's."""
    rec, ranks = groups
    kvp = rec["b_params"]
    assert rec["b"] == rec["one"][0]
    assert rec["b_pulls"]["tcp"] >= 1 and rec["b_pulls"]["device"] == 0
    exports = {r: ranks[("prefill", r)]["exports"] for r in range(2)}
    wk, wv = _join(exports, kvp["transfer_id"])
    (pages, k, v), = rec["dec1_installs"]
    assert k.shape == wk.shape and len(pages) == wk.shape[1]
    np.testing.assert_array_equal(k, wk)
    np.testing.assert_array_equal(v, wv)


def test_shard_params_equal_the_reference_shard_layout(groups):
    """``shard_axis`` and ``shards[*].{start, k_shape, v_shape}`` of the
    port's tp=2 export equal the reference's ``shard_layout`` of the JAX
    engine's pages on make_mesh(tp=2) for the same prompt; the JAX
    package's TCP ``pull_kv_blocks`` gets the full ``[L, n, KH, page, D]``
    blocks, equal to the joined shards, and within 1e-4 of the JAX
    engine's own pages (two backends' f32 forwards)."""
    rec, ranks = groups
    kvp = rec["jax_pull_params"]
    axis_k, lay_k, axis_v, lay_v, jk, jv = rec["jax_layouts"][0]
    assert kvp["shard_axis"] == axis_k == axis_v == 2
    assert [(s["start"], s["k_shape"]) for s in kvp["shards"]] == lay_k
    assert [(s["start"], s["v_shape"]) for s in kvp["shards"]] == lay_v
    assert all(s["transfer_id"] == kvp["transfer_id"] for s in kvp["shards"])
    assert len({s["addr"] for s in kvp["shards"]}) == 2
    k, v = rec["jax_pull"]
    assert list(k.shape) == list(jk.shape) and k.shape[2] == SPEC_KW["num_kv_heads"]
    exports = {r: ranks[("prefill", r)]["exports"] for r in range(2)}
    wk, wv = _join(exports, kvp["transfer_id"])
    np.testing.assert_array_equal(k, wk)
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_allclose(k, jk, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(v, jv, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", ["tp1_to_tp2", "jax_tp2_to_tp2"])
def test_whole_export_installs_each_ranks_heads_inline(groups, case):
    """A one-rank port export, and a JAX tp=2 engine's (host-staged, no
    shards), resumed by the tp=2 group: the leader pulls the whole blocks
    over TCP and sends each rank its heads over the group (mode
    ``scatter``: nothing of the blocks rides the descriptor); each rank
    installs its heads of them bit for bit, and the stream equals the
    one-rank engine's."""
    rec, ranks = groups
    key, i = {"tp1_to_tp2": ("c", 3), "jax_tp2_to_tp2": ("d", 3)}[case]
    assert rec[key] == rec["one"][i]
    tid = rec[f"{key}_tid"]
    modes = ranks[("decode", 0)]["modes"]
    idx = [m for m in modes].index(("scatter", tid))
    if case == "tp1_to_tp2":
        wk, wv = rec["c_exports"][tid]
    else:
        wk, wv = rec["jax_layouts"][1][4:]
    h = SPEC_KW["num_kv_heads"] // 2
    for r in range(2):
        pages, k, v = ranks[("decode", r)]["installs"][idx]
        tail = slice(wk.shape[1] - k.shape[1], None)
        np.testing.assert_array_equal(k, np.asarray(wk)[:, tail, r * h:(r + 1) * h])
        np.testing.assert_array_equal(v, np.asarray(wv)[:, tail, r * h:(r + 1) * h])


def test_no_shard_is_left_on_the_prefill_group(groups):
    """Every export of the tp=2 prefill group was installed or released at
    each of its sources: the decode follower prefetched its shards, and the
    resume whose follower pull failed released the shard still there (the
    leader's own entry was gone after its pull, so no cascade from it)."""
    _rec, ranks = groups
    assert [ranks[("prefill", r)]["pending"] for r in range(2)] == [0, 0]
    assert ranks[("decode", 1)]["ops"]["kv_prefetch"] == len(_prompts()) + 1


def test_embedding_on_a_tp2_group_equals_one_rank(groups):
    """An embedding request on the tp=2 group runs on the leader's step
    thread (op ``embed``: the follower replays its collectives) and the
    vector equals the one-rank engine's within 1e-4."""
    rec, ranks = groups
    got, want = np.asarray(rec["embed"]), np.asarray(rec["one_embed"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert ranks[("decode", 1)]["ops"]["embed"] == 1


# ------------------------------------------------- in this process, no group


def _quant_pool(kh, n_pages=6, seed=0):
    from dynamo_tpu_torch.ops.quant import QuantPool

    g = torch.Generator().manual_seed(seed)
    vals = torch.randint(0, 256, (2, n_pages, kh, 4, 8), generator=g,
                         dtype=torch.uint8).view(torch.float8_e4m3fn)
    scale = torch.rand((2, n_pages, kh), generator=g).to(torch.bfloat16)
    return QuantPool(vals, scale)


def test_packed_fp8_shards_join_and_split_bitwise():
    """A packed fp8 block does not concatenate on its last axis: the join
    unpacks each shard, joins the heads and repacks. The joined shards'
    bytes equal the one-rank pool's ``pack_pages`` of the same pages, and
    the split gives each rank's own pack back."""
    from dynamo_tpu_torch.disagg.transfer import join_heads, split_heads
    from dynamo_tpu_torch.ops.quant import QuantPool, pack_pages

    whole = _quant_pool(4)
    ids = torch.tensor([1, 3, 4])
    want = pack_pages(whole, ids)
    shards = [pack_pages(QuantPool(whole.vals[:, :, r * 2:(r + 1) * 2],
                                   whole.scale[:, :, r * 2:(r + 1) * 2]), ids)
              for r in range(2)]
    assert torch.equal(join_heads(shards, [2, 2], True), want)
    assert np.array_equal(join_heads([s.numpy() for s in shards], [2, 2], True),
                          want.numpy())
    for r in range(2):
        assert torch.equal(split_heads(want, 4, 2, r, True), shards[r])
    f = torch.randn(2, 3, 4, 4, 8)
    assert torch.equal(join_heads(list(f.split(2, dim=2)), [2, 2], False), f)
    assert torch.equal(split_heads(f, 4, 2, 1, False), f[:, :, 2:])


async def test_fp8_sharded_export_pulled_whole_is_the_one_rank_pack():
    """Two sources as a tp=2 export's shards (fp8 pools, packed blocks):
    a whole pull from the leader over TCP joins them into the one-rank
    pool's packed bytes under one checksum; a shard pull gets that
    source's own pack; a plain release of the leader's export releases the
    other shard too."""
    from dynamo_tpu_torch.disagg import transfer as tr
    from dynamo_tpu_torch.ops.quant import QuantPool, pack_pages

    whole = _quant_pool(4, seed=3)
    ids = torch.tensor([2, 5])
    packs = [[pack_pages(QuantPool(p.vals[:, :, r * 2:(r + 1) * 2],
                                   p.scale[:, :, r * 2:(r + 1) * 2]), ids)
              for r in range(2)] for p in (whole, _quant_pool(4, seed=4))]
    srcs = [await tr.KvTransferSource().start() for _ in range(2)]
    try:
        local = dict(tr._LOCAL_SOURCES)
        tr._LOCAL_SOURCES.clear()  # TCP, as between processes
        for n_pull in range(3):
            p0 = srcs[0].export(packs[0][0], packs[1][0], num_tokens=7, page_size=4)
            tid = p0["transfer_id"]
            srcs[1].export(packs[0][1], packs[1][1], num_tokens=7, page_size=4,
                           transfer_id=tid)
            shards = [{"start": 2 * r, "k_shape": list(packs[0][r].shape),
                       "v_shape": list(packs[1][r].shape),
                       "addr": f"{s.host}:{s.port}", "transfer_id": tid,
                       "source_uid": s.uid} for r, s in enumerate(srcs)]
            srcs[0].shard(tid, shards, packed=True)
            params = {**p0, "shard_axis": 2, "shards": shards, "kv_dtype": "fp8"}
            if n_pull == 0:
                k, v, meta = await asyncio.to_thread(tr.pull_kv_blocks, params)
                assert np.array_equal(k, pack_pages(whole, ids).numpy())
                assert meta == {"num_tokens": 7, "page_size": 4}
            elif n_pull == 1:
                k, _v, _m = await asyncio.to_thread(tr.pull_kv_blocks, params, 30.0, 1)
                assert np.array_equal(k, packs[0][1].numpy())
                assert srcs[0].pending == 1  # the leader's shard is still there
                await asyncio.to_thread(tr.release_kv_blocks, tr.shard_params(params, 0))
            else:
                await asyncio.to_thread(tr.release_kv_blocks, params)
                for _ in range(100):
                    if srcs[1].pending == 0:
                        break
                    await asyncio.sleep(0.02)
            assert srcs[0].pending == 0 and srcs[1].pending == 0
        tr._LOCAL_SOURCES.update(local)
    finally:
        for s in srcs:
            await s.close()


async def test_a_shard_pull_waits_for_a_lagging_ranks_export(monkeypatch):
    """Rank 1 exports its shard when it replays the leader's kv_export; a
    whole pull at the leader (and a decode rank's own shard pull) can ask
    for it first. The shard pull waits for the export, up to SHARD_WAIT_S,
    so the whole pull joins both shards instead of failing over to a
    local prefill; a shard that never comes still fails the pull."""
    from dynamo_tpu_torch.disagg import transfer as tr

    monkeypatch.setattr(tr, "SHARD_WAIT_S", 1.0)
    k = [torch.randn(2, 3, 1, 4, 16) for _ in range(2)]
    v = [torch.randn(2, 3, 1, 4, 16) for _ in range(2)]
    srcs = [await tr.KvTransferSource().start() for _ in range(2)]
    local = dict(tr._LOCAL_SOURCES)
    tr._LOCAL_SOURCES.clear()  # TCP, as between processes
    try:
        for late in (True, False):
            p0 = srcs[0].export(k[0], v[0], num_tokens=7, page_size=4)
            tid = p0["transfer_id"]
            shards = [{"start": r, "k_shape": list(k[r].shape), "v_shape": list(v[r].shape),
                       "addr": f"{s.host}:{s.port}", "transfer_id": tid,
                       "source_uid": s.uid} for r, s in enumerate(srcs)]
            srcs[0].shard(tid, shards, packed=False)
            params = {**p0, "shard_axis": 2, "shards": shards}
            pull = asyncio.create_task(asyncio.to_thread(tr.pull_kv_blocks, params))
            await asyncio.sleep(0.3)
            if late:  # rank 1's export arrives while the leader waits for it
                srcs[1].export(k[1], v[1], num_tokens=7, page_size=4, transfer_id=tid)
                wk, wv, _meta = await pull
                assert np.array_equal(wk, torch.cat(k, dim=2).numpy())
                assert np.array_equal(wv, torch.cat(v, dim=2).numpy())
            else:  # it never comes: the whole pull fails, the puller falls back
                with pytest.raises(KeyError, match="shard pull failed"):
                    await pull
        assert srcs[0].pending == srcs[1].pending == 0
    finally:
        tr._LOCAL_SOURCES.update(local)
        for s in srcs:
            await s.close()


class _Published:
    """An SPMD leader's stand-in: the descriptors the engine publishes."""

    def __init__(self):
        self.sent = []
        self.lockstep_count = 0

    def publish(self, op, scalars=None, arrays=None, side=False):
        self.sent.append((op, scalars, side))


async def test_dropping_a_shard_staging_unstages_and_releases_every_shard():
    """A tp=2 export whose leader shard the decode leader pulled at intake
    (its entry at the prefill leader is gone) and whose request then never
    resumes (cancel, bounce, step failure): dropping the staging tells the
    followers to drop their prefetched shards (a side ``kv_unstage``) and
    releases every shard at its own source, so none waits for the TTL."""
    from dynamo_tpu_torch.disagg import transfer as tr
    from dynamo_tpu_torch.engine.core import InferenceEngine

    blocks = [torch.randn(2, 3, 1, 4, 16) for _ in range(4)]
    srcs = [await tr.KvTransferSource().start() for _ in range(2)]
    eng = InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW), device="cpu")
    try:
        local = dict(tr._LOCAL_SOURCES)
        tr._LOCAL_SOURCES.clear()  # TCP, as between processes
        p0 = srcs[0].export(blocks[0], blocks[1], num_tokens=10, page_size=4)
        tid = p0["transfer_id"]
        srcs[1].export(blocks[2], blocks[3], num_tokens=10, page_size=4, transfer_id=tid)
        shards = [{"start": r, "k_shape": [2, 3, 1, 4, 16], "v_shape": [2, 3, 1, 4, 16],
                   "addr": f"{s.host}:{s.port}", "transfer_id": tid, "source_uid": s.uid}
                  for r, s in enumerate(srcs)]
        srcs[0].shard(tid, shards, packed=False)
        kvp = {**p0, "shard_axis": 2, "shards": shards}
        k, v, _meta = await asyncio.to_thread(tr.pull_kv_blocks, kvp, 30.0, 0)
        assert srcs[0].pending == 0 and srcs[1].pending == 1
        eng.spmd = plane = _Published()
        req = {"disagg": {"mode": "decode", "kv_transfer": {**kvp, "first_token": 5},
                          "_staged_kv": (k, v, None, {}, "shard")}}
        assert eng._drop_staged_kv(req)
        assert "_staged_kv" not in req["disagg"]
        assert plane.sent == [("kv_unstage", {"transfer_id": tid}, True)]
        for _ in range(250):
            if srcs[1].pending == 0:
                break
            await asyncio.sleep(0.02)
        assert srcs[1].pending == 0
        # a staging of whole blocks (its pull took every shard) drops quietly
        req["disagg"]["_staged_kv"] = (k, v, None, {}, "scatter")
        assert not eng._drop_staged_kv(req) and len(plane.sent) == 1
        tr._LOCAL_SOURCES.update(local)
    finally:
        eng.spmd = None
        await eng.close()
        for s in srcs:
            await s.close()


async def test_a_mirrored_resume_rides_the_descriptors_in_chunks(monkeypatch):
    """With mirror links a resume's tail rides the descriptors (mode
    ``inline``), cut to RESUME_CHUNK_BYTES each: a tail of several chunks
    (the cap lowered to two pages), larger than the frame cap (lowered to
    8 KiB, under the 12 KiB tail), arrives in as many ``kv_resume``
    descriptors, none over the cap, and the follower's pools equal the
    leader's bit for bit."""
    from dynamo_tpu_torch.disagg import transfer as tr
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel import spmd
    from dynamo_tpu_torch.runtime import framing
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    spec = ModelSpec(**SPEC_KW)
    page = 2 * spec.num_layers * spec.num_kv_heads * CFG_KW["page_size"] * spec.head_dim * 4
    monkeypatch.setattr(spmd, "RESUME_CHUNK_BYTES", 2 * page)
    monkeypatch.setattr(framing, "MAX_FRAME", 8192)
    assert 6 * page > framing.MAX_FRAME
    params = llama.init_params(spec, 0, device="cpu")
    params.embed.data.mul_(EMBED_SCALE)
    hub = InMemoryHub()
    leader = await spmd.SpmdLeader(hub, asyncio.get_running_loop(), "c/backend/generate",
                                   strict=False).start()
    sizes, real = [], leader.publish

    def publish(op, scalars=None, arrays=None, side=False):
        if op == "kv_resume":
            sizes.append(sum(np.asarray(a).nbytes for n, a in arrays.items() if n != "page_ids"))
        return real(op, scalars, arrays, side=side)

    leader.publish = publish
    dec = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu",
                          spmd=leader)
    feng = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu")
    follower = spmd.SpmdFollower(hub, "c/backend/generate", feng, rejoin=True)
    task = asyncio.create_task(follower.run())
    src = await tr.KvTransferSource().start()
    pre = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu",
                          transfer_source=src)
    try:
        p = _prompts()[1]  # 22 tokens: 6 pages, 3 chunks
        r = _req(p, n=1, disagg={"mode": "prefill", "kv_transfer": {"do_remote_decode": True}})
        (item,) = [i async for i in pre.generate(r, Context())]
        resume = _req(p, disagg={"mode": "decode", "kv_transfer": {
            **item["kv_transfer_params"], "first_token": item["token_ids"][0]}})
        assert len(await _tokens(dec.generate(resume, Context()))) == TOKENS - 1
    finally:
        await dec.close()
        await asyncio.wait_for(task, 30)
        await pre.close()
        await src.close()
    assert sizes == [2 * page] * 3
    assert follower.ops["kv_resume"] == 3
    for a, b in ((dec.k_pages, feng.k_pages), (dec.v_pages, feng.v_pages)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_inline_install_takes_a_ranks_heads_or_the_whole_latent_rows(family):
    """A decode rank's ``inline`` install of whole blocks: a GQA rank of
    tp=2 installs its KV heads, an MLA rank installs the whole latent rows
    (the latent pool is whole on every rank)."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.parallel.mesh import AXES, Mesh

    spec = (ModelSpec.tiny_deepseek() if family == "mla"
            else ModelSpec(**{**SPEC_KW, "num_kv_heads": 4}))
    mesh = Mesh(dict.fromkeys(AXES, 1) | {"tp": 2}, dict.fromkeys(AXES, 0) | {"tp": 1},
                torch.device("cpu"))
    eng = InferenceEngine(spec, EngineConfig(**CFG_KW, tp=2), device="cpu", mesh=mesh)
    one = InferenceEngine(spec, EngineConfig(**CFG_KW), device="cpu")
    ids = [3, 7, 8]
    g = torch.Generator().manual_seed(0)
    for p in (one.k_pages, one.v_pages):
        if p.numel():
            p.copy_(torch.randn(p.shape, generator=g).to(p.dtype))
    kb, vb = one.fam.extract_pages(one.k_pages, one.v_pages, torch.tensor(ids))
    assert eng.install_remote("inline", {}, [1, 2], 0, inline=(_np(kb[:, 1:]),
                                                                _np(vb[:, 1:])))
    got, _ = eng.fam.extract_pages(eng.k_pages, eng.v_pages, torch.tensor([1, 2]))
    want = kb[:, 1:] if family == "mla" else kb[:, 1:, 2:4]
    assert torch.equal(got, want)


# ----------------------------------------------------- a mirror of a tp group


def _record_digests(engine, into: list) -> None:
    """Keep the pages every kv_digest covers, as this rank's host blocks."""
    real = engine.pool_digest

    def digest(ids):
        kb, vb = engine.fam.extract_pages(engine.k_pages, engine.v_pages,
                                          torch.tensor(ids, dtype=torch.int64))
        into.append((list(ids), _np(kb), _np(vb)))
        return real(ids)

    engine.pool_digest = digest


async def _mirror_rank_serve(role, rank, n, job, done):
    """A tp=2 group serving (``lead``: its leader advertised on the hub) or
    its mirror group (``mirror``: rank 0 follows the leader and relays to
    rank 1). The mirror's rank 0 drops its stream after the first digest
    and rejoins through the sync."""
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models.convert import shard_params
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub

    spec = ModelSpec(**SPEC_KW)
    mesh = make_mesh(tp=n)
    params = shard_params(spec, job["tree"], mesh, device="cpu")
    cfg = EngineConfig(**CFG_KW, tp=n, pipeline_decode=True)
    group = f"{NS}/backend/generate"
    out: dict = {"digests": []}
    engine = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh,
                             spmd=None)
    if role == "lead" and rank == 0:
        hub = await RemoteHub.connect(job["hub"])
        leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                  strict=True).start()
        await leader.advertise(hub)
        engine = InferenceEngine(spec, cfg, params=params, device="cpu", mesh=mesh,
                                 spmd=leader)
        _record_digests(engine, out["digests"])
        await engine.start()

        async def until(cond, what):
            for _ in range(int(RANK_TIMEOUT_S / 0.05)):
                if cond():
                    return
                await asyncio.sleep(0.05)
            raise TimeoutError(what)

        # its rank 1 and the mirror's rank 0
        await until(lambda: leader.followers == 2, "followers")
        prompts = _prompts()
        out["wave1"] = [await _tokens(engine.generate(_req(p), Context()))
                        for p in prompts[:3]]
        await engine.kv_digest()
        # the mirror dropped its stream and rejoined through the sync
        await until(lambda: leader.syncs_served == 1, "rejoin sync")
        out["wave2"] = [await _tokens(engine.generate(_req(p), Context()))
                        for p in prompts[3:]]
        await engine.kv_digest()
        out["healthy"] = leader.healthy
        await engine.close()
        await hub.close()
        return out
    _record_digests(engine, out["digests"])
    if role == "mirror" and rank == 0:
        hub = await RemoteHub.connect(job["hub"])
        relay = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                 strict=True).start()
        f = SpmdFollower(hub, group, engine, rejoin=True, relay=relay)
        real, seen = f.apply, []

        def apply(op, sc, ar):
            real(op, sc, ar)
            if op == "kv_digest" and not seen:
                seen.append(op)
                raise ConnectionError("stream dropped")  # lost: rejoin

        f.apply = apply
        await f.run()
        relay.stop()
        await relay.close()
        await hub.close()
    else:
        f = SpmdFollower(StoreHub(), group, engine, rejoin=False)
        await f.run()
    out["ops"], out["rejoins"] = dict(f.ops), f.rejoins
    await engine.close()
    return out


def _mirror_rank_main(role, rank, n, port, job, q):
    try:
        torch.set_num_threads(1)
        from dynamo_tpu_torch.parallel.multihost import shutdown

        join_group(port, n, rank, 60)
        try:
            q.put(((role, rank), "ok",
                   asyncio.run(_mirror_rank_serve(role, rank, n, job, None))))
        finally:
            shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put(((role, rank), "error", traceback.format_exc()))


@pytest.fixture(scope="module")
def mirror_groups():
    import torch.multiprocessing as mp

    from dynamo_tpu_torch.runtime.hub_server import HubServer

    _jp, tree = _jax_tree()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()

    async def main():
        hub = HubServer()
        host, port = await hub.start()
        job = {"hub": f"{host}:{port}", "tree": tree}
        procs = []
        stores = []
        for role in ("lead", "mirror"):
            stores.append(group_store())
            procs += [ctx.Process(target=_mirror_rank_main,
                                  args=(role, r, 2, stores[-1].port, job, q))
                      for r in range(2)]
        for p in procs:
            p.start()
        ranks = {}
        try:
            for _ in procs:
                key, status, res = await asyncio.to_thread(q.get, True, RANK_TIMEOUT_S)
                assert status == "ok", res
                ranks[key] = res
        finally:
            for p in procs:
                await asyncio.to_thread(p.join, 30)
                if p.is_alive():
                    p.kill()
            await hub.stop()
        return ranks

    return asyncio.run(main())


@pytest.mark.parametrize("point", ["after_serve", "after_rejoin"])
def test_tp2_mirror_group_pools_equal_the_leader_groups_bitwise(mirror_groups, point):
    """A mirror of a tp=2 group is a second group of 2 ranks: its rank 0
    follows the leader's stream and relays it to its rank 1, each replaying
    with its own collectives. After a serve, and after rank 0 lost its
    stream and rejoined through the sync (the snapshot gathers both of
    the leader group's KV heads: op ``kv_gather``; the mirror's rank 1
    installs its heads from ``sync_install``) and the next serve, each
    mirror rank's pages equal its twin's in the leader group bit for bit,
    and the leader's plane stayed healthy."""
    ranks = mirror_groups
    i = 0 if point == "after_serve" else 1
    lead = ranks[("lead", 0)]
    assert lead["healthy"]
    assert lead["wave1"] and all(len(t) == TOKENS for t in lead["wave1"] + lead["wave2"])
    for r in range(2):
        want = ranks[("lead", r)]["digests"][i]
        got = ranks[("mirror", r)]["digests"][i]
        assert got[0] == want[0] and len(want[0]) > 4
        assert got[1].shape[2] == SPEC_KW["num_kv_heads"] // 2
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    assert ranks[("mirror", 0)]["rejoins"] == 1
    assert ranks[("mirror", 1)]["ops"]["sync_install"] >= 1
    assert ranks[("lead", 1)]["ops"]["kv_gather"] >= 1


async def test_mirror_decode_engine_resume_and_embedding_replay_bitwise():
    """Disaggregation and embeddings under SPMD replay without a mesh (a
    mirror leader and its follower in this process): a resume of a remote
    export rides the descriptor whole (mode ``inline``), so the follower's
    pools equal the leader's bit for bit; an embedding request runs on the
    leader's step thread and the follower replays it (op ``embed``)."""
    from dynamo_tpu_torch.disagg import transfer as tr
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    spec = ModelSpec(**SPEC_KW)
    params = llama.init_params(spec, 0, device="cpu")
    params.embed.data.mul_(EMBED_SCALE)
    hub = InMemoryHub()
    leader = await SpmdLeader(hub, asyncio.get_running_loop(), "m/backend/generate",
                              strict=False).start()
    dec = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu",
                          spmd=leader)
    feng = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu")
    follower = SpmdFollower(hub, "m/backend/generate", feng, rejoin=True)
    task = asyncio.create_task(follower.run())
    src = await tr.KvTransferSource().start()
    pre = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu",
                          transfer_source=src)
    one = InferenceEngine(spec, EngineConfig(**CFG_KW), params=params, device="cpu")
    try:
        prompts = _prompts()[:3]
        for p in prompts:
            r = _req(p, n=1, disagg={"mode": "prefill", "kv_transfer": {"do_remote_decode": True}})
            (item,) = [i async for i in pre.generate(r, Context())]
            kvp, first = item["kv_transfer_params"], item["token_ids"][0]
            resume = _req(p, disagg={"mode": "decode",
                                     "kv_transfer": {**kvp, "first_token": first}})
            got = [first] + await _tokens(dec.generate(resume, Context()))
            assert got == await _tokens(one.generate(_req(p), Context()))
        emb = [i async for i in dec.generate({"token_ids": prompts[0],
                                              "embedding_request": True}, Context())]
        assert emb[-1]["embedding"] == one._embed(prompts[0])
        assert dec.disagg_fallbacks == 0
    finally:
        await dec.close()
        await asyncio.wait_for(task, 30)
        await pre.close()
        await src.close()
        await one.close()
    assert follower.ops["kv_resume"] == 3 and follower.ops["embed"] == 1
    for a, b in ((dec.k_pages, feng.k_pages), (dec.v_pages, feng.v_pages)):
        assert torch.equal(a, b)
