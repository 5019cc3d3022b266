"""dynamo_tpu_torch.kv_router against dynamo_tpu.kv_router, module by module,
on the same numpy-seeded inputs.

- protocols: to_dict forms through the port's codec give the reference's
  bytes through msgpack, and round-trip;
- indexer: random store/remove/clear event streams over a few workers give
  equal find_matches scores and equal snapshots; restore round-trips;
  ApproxKvIndexer under one patched clock expires the same entries;
- sequence: the same add/prefill-done/decode-block/free stream gives equal
  per-worker loads;
- scheduler: the same random.Random(seed) gives identical incremental and
  oracle picks and softmax_sample draws, exclusions (fail-open) included;
- steering, hashing, sharding: equal exclusions, chains and shards;
- publisher and router: events flow through an in-memory hub into the
  port's KvRouter as into the reference's (equal radix snapshots and
  picks), snapshot save/load through the object store, the retention-gap
  check, and KvPushRouter freeing its request on every exit.
"""

from __future__ import annotations

import asyncio
import random
import threading

import msgpack
import numpy as np
import pytest

from dynamo_tpu.kv_router import hashing as jhashing
from dynamo_tpu.kv_router import indexer as jindexer
from dynamo_tpu.kv_router import protocols as jproto
from dynamo_tpu.kv_router import router as jrouter_mod
from dynamo_tpu.kv_router import scheduler as jsched
from dynamo_tpu.kv_router import sequence as jseq
from dynamo_tpu.kv_router import sharding as jshard
from dynamo_tpu.kv_router import steering as jsteer
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu.tokens import compute_sequence_hashes as jax_hashes
from dynamo_tpu_torch import kv_router as tkv
from dynamo_tpu_torch.kv_router import hashing as thashing
from dynamo_tpu_torch.kv_router import indexer as tindexer
from dynamo_tpu_torch.kv_router import protocols as tproto
from dynamo_tpu_torch.kv_router import scheduler as tsched
from dynamo_tpu_torch.kv_router import sequence as tseq
from dynamo_tpu_torch.kv_router import sharding as tshard
from dynamo_tpu_torch.kv_router import steering as tsteer
from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.kv_router.router import KV_EVENT_SUBJECT, KvPushRouter, KvRouter
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.context import Context, ServiceUnavailable
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode
from dynamo_tpu_torch.tokens import compute_sequence_hashes

pytestmark = pytest.mark.unit


def test_package_exports_match_reference():
    import dynamo_tpu.kv_router as jkv

    assert tkv.__all__ == jkv.__all__
    assert all(hasattr(tkv, n) for n in tkv.__all__)


# ------------------------------------------------------------- protocols


def _events(mod, rng):
    stored = tuple(mod.BlockStored(int(rng.integers(0, 2**64, dtype=np.uint64)),
                                   int(rng.integers(0, 2**63)), int(rng.integers(0, 9)))
                   for _ in range(3))
    return [
        mod.RouterEvent(0x1F2E3D4C5B6A0001, mod.KvCacheEvent("stored", stored=stored), 7),
        mod.RouterEvent(5, mod.KvCacheEvent("removed", removed=(2**64 - 1, 0, 3)), 8),
        mod.RouterEvent(5, mod.KvCacheEvent("cleared"), 2**40),
    ]


def test_protocol_dicts_encode_like_msgpack():
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    for te, je in zip(_events(tproto, rng_a), _events(jproto, rng_b)):
        d = te.to_dict()
        assert d == je.to_dict()
        assert codec.packb(d) == msgpack.packb(je.to_dict(), use_bin_type=True)
        assert tproto.RouterEvent.from_dict(codec.unpackb(codec.packb(d))) == te
    m = dict(worker_id=0xABCDEF012345, active_kv_blocks=17, total_kv_blocks=2048,
             waiting_requests=2, running_requests=6, step_time_ms=13.25)
    tm, jm = tproto.ForwardPassMetrics(**m), jproto.ForwardPassMetrics(**m)
    assert tm.to_dict() == jm.to_dict()
    assert codec.packb(tm.to_dict()) == msgpack.packb(jm.to_dict(), use_bin_type=True)
    assert tproto.ForwardPassMetrics.from_dict(codec.unpackb(codec.packb(tm.to_dict()))) == tm
    assert tm.kv_usage == jm.kv_usage
    assert vars(tproto.RouterConfig()) == vars(jproto.RouterConfig())
    assert (tproto.KV_EVENT_SUBJECT, tproto.KV_METRICS_SUBJECT) == (
        jproto.KV_EVENT_SUBJECT, jproto.KV_METRICS_SUBJECT)


# --------------------------------------------------------------- indexer


def _event_stream(mod, seed: int, n_workers: int = 4, n: int = 300):
    """(worker, KvCacheEvent) pairs of random prefix chains: stores along
    chains that share prefixes, removals of stored blocks, a few clears."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(0, 500, 64).tolist() for _ in range(3)]
    held: dict[int, list[tuple[int, int]]] = {w: [] for w in range(n_workers)}
    out = []
    for _ in range(n):
        w = int(rng.integers(0, n_workers))
        r = float(rng.random())
        if r < 0.6:
            toks = roots[int(rng.integers(0, 3))][: 4 * int(rng.integers(1, 17))]
            toks = toks + rng.integers(0, 500, int(rng.integers(0, 9))).tolist()
            hs = compute_sequence_hashes(toks, 4)
            parents = [0] + hs[:-1]
            k = int(rng.integers(1, len(hs) + 1))
            pairs = list(zip(hs, parents))[:k]
            held[w] += pairs
            out.append((w, mod.KvCacheEvent("stored", stored=tuple(
                mod.BlockStored(sh, p) for sh, p in pairs))))
        elif r < 0.95 and held[w]:
            idx = rng.choice(len(held[w]), size=min(3, len(held[w])), replace=False)
            gone = [held[w][int(i)][0] for i in idx]
            out.append((w, mod.KvCacheEvent("removed", removed=tuple(gone))))
        else:
            held[w] = []
            out.append((w, mod.KvCacheEvent("cleared")))
    return out, roots


def _snap(tree):
    s = tree.snapshot()
    return sorted((n["sh"], n["parent"], tuple(n["workers"])) for n in s["nodes"]), \
        s["applied_events"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_event_streams_equal_reference(seed):
    tev, roots = _event_stream(tproto, seed)
    jev, _ = _event_stream(jproto, seed)
    tt, jt = tindexer.RadixTree(), jindexer.RadixTree()
    rng = np.random.default_rng(seed + 100)
    for i, ((tw, te), (jw, je)) in enumerate(zip(tev, jev)):
        tt.apply_event(tw, te)
        jt.apply_event(jw, je)
        if i % 25 == 0:
            probe = roots[int(rng.integers(0, 3))][: 4 * int(rng.integers(1, 17))]
            hs = compute_sequence_hashes(probe, 4)
            a, b = tt.find_matches(hs), jt.find_matches(hs)
            assert (a.scores, a.total_blocks, a.best()) == (b.scores, b.total_blocks,
                                                            b.best())
    assert _snap(tt) == _snap(jt)
    assert tt.workers() == jt.workers()
    assert [tt.num_blocks(w) for w in range(5)] == [jt.num_blocks(w) for w in range(5)]
    tt.remove_worker(1)
    jt.remove_worker(1)
    assert _snap(tt) == _snap(jt)
    # snapshot/restore across the packages: the port restores the
    # reference's snapshot into the same tree, and back
    assert _snap(tindexer.RadixTree.restore(jt.snapshot())) == _snap(jt)
    assert _snap(jindexer.RadixTree.restore(tt.snapshot())) == _snap(tt)
    with pytest.raises(ValueError):
        tt.apply_event(0, tproto.KvCacheEvent("bogus"))


def test_approx_indexer_under_patched_clock(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(tindexer.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(jindexer.time, "monotonic", lambda: now[0])
    ta, ja = tindexer.ApproxKvIndexer(ttl_s=10.0), jindexer.ApproxKvIndexer(ttl_s=10.0)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 1000, 64).tolist()
    for step in range(120):
        now[0] += float(rng.random() * 1.5)
        w = int(rng.integers(0, 3))
        toks = base[: 4 * int(rng.integers(1, 17))]
        hs = compute_sequence_hashes(toks, 4)
        parents = [0] + hs[:-1]
        if rng.random() < 0.7:
            ta.process_routing_decision(w, hs, parents)
            ja.process_routing_decision(w, hs, parents)
        elif rng.random() < 0.2:
            ta.remove_worker(w)
            ja.remove_worker(w)
        a, b = ta.find_matches(hs), ja.find_matches(hs)
        assert a.scores == b.scores, step
    assert _snap(ta._tree) == _snap(ja._tree)
    assert ta._deadlines == ja._deadlines


# -------------------------------------------------------------- sequence


def test_active_sequences_equal_reference(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(tseq.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(jseq.time, "monotonic", lambda: now[0])
    tm = tseq.ActiveSequencesMultiWorker(force_expiry_s=30.0)
    jm = jseq.ActiveSequencesMultiWorker(force_expiry_s=30.0)
    rng = np.random.default_rng(9)
    live: list[str] = []
    for i in range(400):
        now[0] += float(rng.random())
        r = rng.random()
        if r < 0.4 or not live:
            rid, w = f"r{i}", int(rng.integers(0, 4))
            b, p = int(rng.integers(0, 40)), int(rng.integers(0, 600))
            tm.add_request(rid, w, b, p)
            jm.add_request(rid, w, b, p)
            live.append(rid)
        elif r < 0.6:
            rid = live[int(rng.integers(0, len(live)))]
            tm.mark_prefill_done(rid)
            jm.mark_prefill_done(rid)
        elif r < 0.8:
            rid = live.pop(int(rng.integers(0, len(live))))
            tm.free(rid)
            jm.free(rid)
        elif r < 0.9:
            ws = [int(x) for x in rng.choice(5, size=3, replace=False)]
            tm.update_workers(ws)
            jm.update_workers(ws)
        else:
            rid = live[int(rng.integers(0, len(live)))]
            for m in (tm, jm):
                seqs = m._workers.get(m.worker_of(rid))
                if seqs is not None:
                    seqs.add_decode_block(rid)
        assert tm.loads() == jm.loads(), i
        assert [tm.load_of(w) for w in range(5)] == [jm.load_of(w) for w in range(5)]


# ------------------------------------------------------------- scheduler


@pytest.mark.parametrize("temperature", [0.0, 0.7, 3.0])
def test_softmax_sample_draws_equal_reference(temperature):
    rng = np.random.default_rng(11)
    tr, jr = random.Random(3), random.Random(3)
    for _ in range(300):
        n = int(rng.integers(1, 9))
        logits = {int(w): float(c) for w, c in zip(rng.choice(1000, n, replace=False),
                                                   rng.integers(0, 6, n))}
        assert (tsched.softmax_sample(logits, temperature, tr)
                == jsched.softmax_sample(logits, temperature, jr))
    with pytest.raises(ValueError):
        tsched.softmax_sample({}, 0.0)


def _fleet_updates(mod, seed: int, n_workers: int = 12, n: int = 200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = int(rng.integers(0, n_workers)) * 0x10001
        if rng.random() < 0.5:
            out.append(("m", mod.ForwardPassMetrics(
                worker_id=w, active_kv_blocks=int(rng.integers(0, 60)),
                total_kv_blocks=64, waiting_requests=int(rng.integers(0, 4)))))
        else:
            out.append(("p", (w, int(rng.integers(0, 80)), int(rng.integers(0, 900)))))
    return out


@pytest.mark.parametrize("temperature,candidate_k", [(0.0, 1), (0.0, 8), (0.9, 4)])
def test_scheduler_picks_equal_reference(temperature, candidate_k):
    """Incremental and oracle schedulers of both packages on one update
    stream and one seeded RNG each: identical picks, exclusions included."""
    tcfg = tproto.RouterConfig(block_size=16, temperature=temperature,
                               candidate_k=candidate_k)
    jcfg = jproto.RouterConfig(block_size=16, temperature=temperature,
                               candidate_k=candidate_k)
    pairs = [
        (tsched.KvScheduler(tcfg), jsched.KvScheduler(jcfg)),
        (tsched.KvScheduler(tcfg, selector=tsched.DefaultWorkerSelector(random.Random(5))),
         jsched.KvScheduler(jcfg, selector=jsched.DefaultWorkerSelector(random.Random(5)))),
    ]
    for ts, js in pairs:
        ts.rng, js.rng = random.Random(21), random.Random(21)
        ids = [w * 0x10001 for w in range(12)]
        ts.update_workers(ids)
        js.update_workers(ids)
        rng = np.random.default_rng(4)
        for (kind, tu), (_k, ju) in zip(_fleet_updates(tproto, 8), _fleet_updates(jproto, 8)):
            if kind == "m":
                ts.update_metrics(tu)
                js.update_metrics(ju)
            else:
                ts.set_predicted_load(*tu)
                js.set_predicted_load(*ju)
            holders = [int(w) * 0x10001 for w in rng.choice(12, 3, replace=False)]
            scores = {w: int(rng.integers(0, 20)) for w in holders}
            blocks = int(rng.integers(1, 24))
            excl = ({int(w) * 0x10001 for w in rng.choice(12, int(rng.integers(0, 13)),
                                                          replace=False)}
                    if rng.random() < 0.4 else None)
            got = ts.schedule(blocks, tindexer.OverlapScores(dict(scores), blocks),
                              exclude=excl)
            want = js.schedule(blocks, jindexer.OverlapScores(dict(scores), blocks),
                               exclude=excl)
            assert got == want
        assert ts.states_version == js.states_version
        assert ts.full_pick_scans == js.full_pick_scans
        ts.update_workers(ids[:3])
        js.update_workers(ids[:3])
        assert sorted(s.worker_id for s in ts.workers()) == sorted(
            s.worker_id for s in js.workers())
    with pytest.raises(LookupError):
        tsched.KvScheduler(tcfg).schedule(1, tindexer.OverlapScores())


# ----------------------------------------------- steering, hashing, sharding


def test_tenant_steering_equal_reference():
    now = [0.0]
    ts = tsteer.TenantSteering(tsteer.SteeringConfig(half_life_s=2.0, hot_rate_per_s=1.0),
                               clock=lambda: now[0])
    js = jsteer.TenantSteering(jsteer.SteeringConfig(half_life_s=2.0, hot_rate_per_s=1.0),
                               clock=lambda: now[0])
    rng = np.random.default_rng(2)
    for i in range(300):
        now[0] += float(rng.random() * 0.3)
        tenant, w = f"t{int(rng.integers(0, 3))}", int(rng.integers(0, 4))
        if rng.random() < 0.05:
            ts.forget_worker(w)
            js.forget_worker(w)
        else:
            ts.record(tenant, w)
            js.record(tenant, w)
        assert ts.exclusions(tenant) == js.exclusions(tenant), i
        assert ts.rate(tenant) == js.rate(tenant)
    assert ts.snapshot() == js.snapshot()


@pytest.mark.parametrize("chunk_blocks", [1, 4])
def test_prefix_hash_cache_equals_direct_chain(chunk_blocks, monkeypatch):
    """PrefixHashCache returns compute_sequence_hashes bit for bit (salts,
    partial tails, shared preambles, evictions), hits and evicts where the
    reference's cache does, and DYN_ROUTER_HASH_CACHE reads as the
    reference reads it."""
    tc = thashing.PrefixHashCache(max_entries=6, chunk_blocks=chunk_blocks)
    jc = jhashing.PrefixHashCache(max_entries=6, chunk_blocks=chunk_blocks)
    rng = np.random.default_rng(chunk_blocks)
    pre = rng.integers(0, 128_000, 300).tolist()
    for i in range(60):
        toks = pre[: int(rng.integers(0, 300))] + rng.integers(0, 128_000, int(
            rng.integers(0, 40))).tolist()
        salt = [None, "m", b"lora"][i % 3]
        bs = [16, 4][i % 2]
        want = jax_hashes(toks, bs, salt)
        assert tc.sequence_hashes(toks, bs, salt) == want
        assert jc.sequence_hashes(toks, bs, salt) == want
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    # the same entries in the same LRU order (the port keys a chunk on its
    # bytes, the reference on their xxh3 digest)
    assert list(tc._lru.values()) == list(jc._lru.values())
    assert [k[0] for k in tc._lru] == [k[0] for k in jc._lru]
    # one 16-token block at block size 16 has the bytes of a 4-block chunk
    # at block size 4: the block size in the key keeps them apart
    x = pre[:16]
    assert tc.sequence_hashes(x, 16) == jax_hashes(x, 16)
    assert tc.sequence_hashes(x, 4) == jax_hashes(x, 4)
    for env, entries in (("0", 0), ("17", 17), ("junk", 4096), ("-3", 0)):
        monkeypatch.setenv("DYN_ROUTER_HASH_CACHE", env)
        assert thashing.PrefixHashCache.from_env().max_entries == entries
        assert jhashing.PrefixHashCache.from_env().max_entries == entries
    off = thashing.PrefixHashCache(max_entries=0)
    assert off.sequence_hashes(pre, 16) == jax_hashes(pre, 16) and not off._lru


def test_sharding_equal_reference(monkeypatch):
    rng = np.random.default_rng(0)
    for _ in range(500):
        key = int(rng.integers(0, 2**64, dtype=np.uint64))
        n = int(rng.integers(0, 40))
        assert tshard.jump_hash(key, n) == jshard.jump_hash(key, n)
    tm, jm = tshard.ShardMap(7, 16), jshard.ShardMap(7, 16)
    for _ in range(100):
        toks = rng.integers(0, 128_000, int(rng.integers(0, 40))).tolist()
        assert tm.shard_for(toks, "s") == jm.shard_for(toks, "s")
    for env in ("3", "0", "x"):
        monkeypatch.setenv("DYN_ROUTER_SHARDS", env)
        assert tshard.shards_from_env(2) == jshard.shards_from_env(2)


# -------------------------------------------------- publisher and router


async def _until(cond, timeout=5.0):
    t = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < t, "condition not reached"
        await asyncio.sleep(0.01)


async def test_publisher_from_a_thread_keeps_order_and_router_matches_reference():
    """A step thread's stores and removals (interleaved, some past a full
    batch) reach the port's KvRouter in order; the same RouterEvents fed
    to the reference's KvRouter give equal radix snapshots and picks."""
    hub, jhub = InMemoryHub(), JaxHub()
    cfg = tproto.RouterConfig(block_size=4)
    router = await KvRouter(hub, "ns/w", cfg).start()
    jrouter = await jrouter_mod.KvRouter(jhub, "ns/w", jproto.RouterConfig(block_size=4)).start()
    router.update_workers([11, 22])
    jrouter.update_workers([11, 22])
    pubs = {w: KvEventPublisher(hub, "ns/w", w, flush_interval_s=0.01, max_batch=8).start()
            for w in (11, 22)}
    rng = np.random.default_rng(1)
    ops = []
    for i in range(120):
        toks = rng.integers(0, 50, 4 * int(rng.integers(1, 8))).tolist()
        hs = compute_sequence_hashes(toks, 4)
        w = (11, 22)[i % 2]
        ops.append((w, "stored", list(zip(hs, [0] + hs[:-1]))))
        if rng.random() < 0.4:
            ops.append((w, "removed", hs[-int(rng.integers(1, len(hs) + 1)):]))

    def step_thread():
        for w, kind, arg in ops:
            if kind == "stored":
                for sh, p in arg:
                    pubs[w].block_stored(sh, p)
            else:
                pubs[w].blocks_removed(arg)

    t = threading.Thread(target=step_thread)
    t.start()
    await asyncio.to_thread(t.join)
    for p in pubs.values():
        await p.close()
    subject = KV_EVENT_SUBJECT.format(component="ns/w")
    n_pub = len(hub._retained[subject])
    await _until(lambda: router.tree.applied_events == n_pub)
    # the reference router folds the same published events
    for _seq, payload in list(hub._retained[subject]):
        await jhub.publish(subject, payload)
    await _until(lambda: jrouter.tree.applied_events == n_pub)
    assert _snap(router.tree) == _snap(jrouter.tree)
    # per worker, the radix equals a direct replay of the thread's op order
    direct = tindexer.RadixTree()
    for w, kind, arg in ops:
        ev = (tproto.KvCacheEvent("stored", stored=tuple(
            tproto.BlockStored(sh, p) for sh, p in arg)) if kind == "stored"
            else tproto.KvCacheEvent("removed", removed=tuple(arg)))
        direct.apply_event(w, ev)
    assert _snap(router.tree)[0] == _snap(direct)[0]
    for i in range(20):
        probe = rng.integers(0, 50, 4 * int(rng.integers(1, 8))).tolist()
        assert (router.find_best_match(f"p{i}", probe)
                == jrouter.find_best_match(f"p{i}", probe))
    await router.close()
    await jrouter.close()


async def test_publisher_wakes_the_loop_once_per_batch_of_thread_ops():
    """A step thread's 40 stores made while the loop is busy schedule one
    wake-up, not 40; that wake-up still sees the full batch (max_batch 8)
    and flushes at once, and every store is published in order."""
    hub = InMemoryHub()
    pub = KvEventPublisher(hub, "ns/w", 5, flush_interval_s=60.0, max_batch=8).start()
    loop = asyncio.get_running_loop()
    wakes = []
    real = loop.call_soon_threadsafe

    def counting(cb, *a, **kw):
        wakes.append(cb)
        return real(cb, *a, **kw)

    loop.call_soon_threadsafe = counting
    try:
        t = threading.Thread(target=lambda: [pub.block_stored(h, h - 1)
                                             for h in range(1, 41)])
        t.start()
        t.join()  # on the loop's thread: the loop is busy for the whole batch
        assert len(wakes) == 1
        subject = KV_EVENT_SUBJECT.format(component="ns/w")
        # the full batch flushes without waiting out the 60 s interval
        await _until(lambda: len(hub._retained.get(subject, ())) == 1)
        (_seq, payload), = hub._retained[subject]
        ev = tproto.RouterEvent.from_dict(payload)
        assert [b.sequence_hash for b in ev.event.stored] == list(range(1, 41))
        # the next op from a thread wakes the loop again
        t = threading.Thread(target=lambda: pub.block_stored(41, 40))
        t.start()
        t.join()
        assert len(wakes) == 2
    finally:
        loop.call_soon_threadsafe = real
        await pub.close()


async def test_metrics_publisher_feeds_scheduler():
    hub = InMemoryHub()
    router = await KvRouter(hub, "ns/w", tproto.RouterConfig(block_size=4)).start()
    pub = WorkerMetricsPublisher(hub, "ns/w", 9, interval_s=0.01).start()
    pub.publish(tproto.ForwardPassMetrics(active_kv_blocks=5, total_kv_blocks=10))
    await _until(lambda: any(s.worker_id == 9 and s.metrics.active_kv_blocks == 5
                             for s in router.scheduler.workers()))
    await pub.close()
    await router.close()


async def test_snapshot_roundtrip_and_retention_gap():
    hub = InMemoryHub()
    hub.RETAIN_PER_SUBJECT = 64
    comp, cfg = "dyn/backend", tproto.RouterConfig(block_size=4, snapshot_threshold=40)
    subject = KV_EVENT_SUBJECT.format(component=comp)

    async def publish_chain(h, start, n):
        parent = 1000 + start - 1 if start else 0
        for i in range(start, start + n):
            await h.publish(subject, tproto.RouterEvent(7, tproto.KvCacheEvent(
                "stored", stored=(tproto.BlockStored(1000 + i, parent),))).to_dict())
            parent = 1000 + i

    r1 = await KvRouter(hub, comp, cfg).start()
    await _until(lambda: hub._subs)
    await publish_chain(hub, 0, 200)
    await _until(lambda: len(r1.tree._nodes) >= 200)
    await r1.save_snapshot()
    nodes = set(r1.tree._nodes)
    await r1.close()
    r2 = await KvRouter(hub, comp, cfg).start()
    await asyncio.sleep(0.05)
    assert set(r2.tree._nodes) == nodes and r2.replay_gap == 0
    await r2.close()
    # no snapshot covers the dropped prefix: the gap is counted, loudly
    hub2 = InMemoryHub()
    hub2.RETAIN_PER_SUBJECT = 64
    await publish_chain(hub2, 0, 200)
    r3 = await KvRouter(hub2, comp, cfg).start()
    await asyncio.sleep(0.05)
    assert r3.replay_gap == 200 - 64 and len(r3.tree._nodes) < 200
    await r3.close()


async def test_kv_push_router_frees_on_every_exit():
    """KvPushRouter routes to the prefix holder, marks prefill done on the
    first item and frees its request on completion, on a consumer that
    stops early, on a worker error and on a drain refusal."""
    drt = DistributedRuntime(InMemoryHub())
    ep = drt.namespace("ns").component("w").endpoint("generate")
    mode = {"v": "ok"}

    async def handler(request, context):
        if mode["v"] == "refuse":
            raise ServiceUnavailable("worker draining")
        for i in range(3):
            yield {"i": i, "overlap": request.get("estimated_prefix_hit_num_blocks")}
            if mode["v"] == "error":
                raise RuntimeError("boom")

    served = [await ep.serve(handler) for _ in range(2)]
    ids = [s.instance.instance_id for s in served]
    push = await PushRouter.from_endpoint(ep, RouterMode.DIRECT)
    await push.client.wait_for_instances(2, timeout=5)
    kv = await KvRouter(drt.hub, "ns/w", tproto.RouterConfig(block_size=4)).start()
    pub = KvEventPublisher(drt.hub, "ns/w", ids[1], flush_interval_s=0.01).start()
    toks = list(range(16))
    hs = compute_sequence_hashes(toks, 4)
    for sh, p in zip(hs, [0] + hs[:-1]):
        pub.block_stored(sh, p)
    await _until(lambda: kv.tree.num_blocks(ids[1]) == 4)
    kvp = KvPushRouter(push, kv)
    out = [x async for x in kvp.generate({"token_ids": toks}, Context())]
    assert [x["overlap"] for x in out] == [4, 4, 4]
    assert kv.sequences.loads()[ids[1]] == (0, 0)
    # early stop: the consumer closes the stream after one item
    gen = kvp.generate({"token_ids": toks}, Context())
    assert (await gen.__anext__())["i"] == 0
    assert list(kv.sequences._request_worker.values()) == [ids[1]]
    await gen.aclose()
    for m in ("error", "refuse"):
        mode["v"] = m
        with pytest.raises(Exception):
            async for _ in kvp.generate({"token_ids": toks}, Context()):
                pass
    assert all(v == (0, 0) for v in kv.sequences.loads().values())
    assert not kv.sequences._request_worker
    # the standalone-service decision frees its probe
    assert kvp.best_worker_id(toks) == (ids[1], 4)
    assert not kv.sequences._request_worker
    await pub.close()
    await kv.close()
    await drt.close()
