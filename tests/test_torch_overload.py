"""The port's overload plane (dynamo_tpu_torch/engine/tenancy.py and the
engine's intake, scheduler and preemption) against the JAX package's.

Every case drives both packages with the same inputs and requires the same
outcome: the scheduler on the same enqueue/dequeue sequences; the engines
on shared seeded weights (the JAX init bridged through params_from_numpy,
the input embedding scaled by 4 so greedy streams are diverse and equal
across packages) with the same arrivals; both HTTP stacks with the same
requests. Quota Retry-After values come from bucket state at ``now``, so
both tenancy modules read one injected clock; saturation Retry-After comes
from step-time samples, so both engines get the same frozen samples.

Also here: the resume-prompt checksum at intake (``verify_resume_tokens``),
through both engines and through both migration operators with the
``migration.resume`` corrupt site armed.
"""

import asyncio
import collections
import os
import threading
from types import SimpleNamespace

import aiohttp
import jax
import numpy as np
import pytest
import torch

import dynamo_tpu.engine.tenancy as jten
import dynamo_tpu.runtime.context as jctx
import dynamo_tpu.runtime.integrity as jint
import dynamo_tpu_torch.engine.tenancy as tten
import dynamo_tpu_torch.runtime.context as tctx
import dynamo_tpu_torch.runtime.integrity as tint
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.engine.core import _Waiting as JaxWaiting
from dynamo_tpu.frontend.http import HttpFrontend as JaxHttpFrontend
from dynamo_tpu.frontend.migration import Migration as JaxMigration
from dynamo_tpu.frontend.model_card import register_llm as jax_register_llm
from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.faults import FAULTS as JAX_FAULTS
from dynamo_tpu.runtime.hub import InMemoryHub as JaxHub
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.core import _Waiting as PortWaiting
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.frontend.model_card import register_llm
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.faults import FAULTS as PORT_FAULTS
from dynamo_tpu_torch.runtime.hub import InMemoryHub

pytestmark = pytest.mark.unit

SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=256, max_pages_per_seq=32,
              max_decode_slots=2, prefill_buckets=(8, 16, 32, 64, 128))
EMBED_SCALE = 4.0  # diverse greedy streams, equal across the packages


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_WEIGHTS: dict[int, tuple] = {}


def _weights(seed=5):
    if seed not in _WEIGHTS:
        jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(seed)))
        jp["embed"] = jp["embed"] * EMBED_SCALE
        _WEIGHTS[seed] = (jp, params_from_numpy(
            ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp), device="cpu"))
    return _WEIGHTS[seed]


SIDES = {
    "jax": SimpleNamespace(
        Engine=JaxEngine, Config=JaxEngineConfig, Spec=JaxSpec, Waiting=JaxWaiting,
        ten=jten, ctx=jctx, integ=jint, faults=JAX_FAULTS, Migration=JaxMigration,
        pick=lambda w: w[0], kw={}),
    "port": SimpleNamespace(
        Engine=InferenceEngine, Config=EngineConfig, Spec=ModelSpec, Waiting=PortWaiting,
        ten=tten, ctx=tctx, integ=tint, faults=PORT_FAULTS, Migration=Migration,
        pick=lambda w: w[1], kw={"device": "cpu"}),
}


def _engine(m, seed=5, **cfg):
    return m.Engine(m.Spec(**SPEC_KW), m.Config(**{**CFG_KW, **cfg}),
                    params=m.pick(_weights(seed)), **m.kw)


class _Clock:
    """An injected monotonic clock for both tenancy modules."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for m in SIDES.values():
        monkeypatch.setattr(m.ten, "time", c)
    return c


class _FrozenSamples(collections.deque):
    """Step-time samples the step thread cannot move: the saturation
    Retry-After reads the same numbers in both engines."""

    def append(self, x):
        pass


def _freeze_step_times(eng, value):
    eng.step_times = _FrozenSamples([value] * 16)


def _ctx(m, tenant=None, priority=None):
    headers = {}
    if tenant:
        headers[m.ctx.TENANT_HEADER] = tenant
    if priority:
        headers[m.ctx.PRIORITY_HEADER] = priority
    return m.ctx.Context(headers=headers)


def _req(tokens, n, **extra):
    return {"token_ids": list(tokens),
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}, **extra}


async def _collect(eng, req, ctx, sink=None):
    out = [] if sink is None else sink
    async for item in eng.generate(req, ctx):
        out.append(item)
    return out


def _tokens(items):
    return [t for x in items for t in (x.get("token_ids") or [])]


async def _until(cond, n=3000):
    for _ in range(n):
        if cond():
            return True
        await asyncio.sleep(0.01)
    return False


class _Gate:
    """Parks an engine's step thread at its next admission pass, so the
    arrivals enqueued meanwhile meet one admission decision, the same in
    both packages whatever the host's speed."""

    def __init__(self, eng):
        self.open, self.parked = threading.Event(), threading.Event()
        self.open.set()
        admit = eng._admit_phase

        def gated():
            if not self.open.is_set():
                self.parked.set()
                self.open.wait(60.0)  # bounded: a failed test must not park it for good
            return admit()

        eng._admit_phase = gated

    async def close(self):
        self.parked.clear()
        self.open.clear()
        assert await _until(self.parked.is_set)

    def release(self):
        self.open.set()


async def _both(scenario, **kw):
    """Run ``scenario(m)`` on the JAX engine's side, then the port's."""
    return {name: await scenario(m, **kw) for name, m in SIDES.items()}


# ------------------------------------------------------------ the scheduler


def _w(tenant, priority="interactive", cost=10.0, tag=None):
    return SimpleNamespace(tenant=tenant, priority=priority, cost=cost,
                           tag=tag or tenant)


def _case_grammar(ten):
    q = ten.parse_tenant_quotas(
        "alpha:weight=4,rate=1000,burst=2000;beta:rate=50;*:rate=200")
    errors = []
    for bad in ("a:frobnicate=1", "a:rate=abc", ":rate=1", "a:weight=0", "a:rate=-1"):
        try:
            ten.parse_tenant_quotas(bad)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    got = ({t: vars(v) for t, v in q.items()}, ten.parse_tenant_quotas(" ; "), errors)
    assert got[0]["beta"]["burst"] == 200 and got[0]["alpha"]["weight"] == 4
    assert None not in errors
    return got


def _case_bucket(ten):
    b = ten.TokenBucket(ten.TenantQuota(rate=10, burst=20), now=0.0)
    out = [b.try_take(20, now=0.0), b.try_take(5, now=0.0),
           b.retry_after_s(5, now=0.0), b.over_quota(now=0.0),
           b.try_take(5, now=1.0), b.level, b.retry_after_s(30, now=1.0)]
    b2 = ten.TokenBucket(ten.TenantQuota(rate=10, burst=20), now=0.0)
    out += [b2.try_take(500, now=0.0), b2.try_take(1, now=0.0)]
    b3 = ten.TokenBucket(ten.TenantQuota(), now=0.0)
    out += [b3.try_take(10**9, now=0.0), b3.over_quota(now=0.0), b3.retry_after_s(5)]
    assert out == [True, False, 0.5, True, True, 5.0, 1.5, True, False, True, False, 0.0]
    return out


def _case_interactive_first(ten):
    s = ten.TenantScheduler()
    s.put_nowait(_w("bt", "batch", tag="b1"))
    s.put_nowait(_w("bt", "batch", tag="b2"))
    s.put_nowait(_w("it", tag="i1"))
    out = [s.qsize(), s.peek().tag, s.waiting_by_tenant()]
    out += [s.get_nowait().tag for _ in range(3)] + [s.empty()]
    assert out[3:] == ["i1", "b1", "b2", True]
    return out


def _case_weighted_fair(ten):
    s = ten.TenantScheduler({"heavy": ten.TenantQuota(weight=4.0),
                             "light": ten.TenantQuota(weight=1.0)})
    for i in range(20):
        s.put_nowait(_w("heavy", cost=10.0 + i % 3))
        s.put_nowait(_w("light", cost=10.0 + i % 2))
    order = [s.get_nowait().tag for _ in range(16)]
    assert order.count("heavy") >= 11 and order.count("light") >= 2, order
    return order


def _case_idle_credit(ten):
    s = ten.TenantScheduler()
    for _ in range(8):
        s.put_nowait(_w("a", cost=100.0))
        s.get_nowait()
    for _ in range(4):
        s.put_nowait(_w("b", cost=10.0))
        s.put_nowait(_w("a", cost=10.0))
    order = [s.get_nowait().tag for _ in range(8)]
    assert "a" in order[:4], order
    return order


def _case_shed_victim(ten):
    s = ten.TenantScheduler({"greedy": ten.TenantQuota(rate=10, burst=10),
                             "modest": ten.TenantQuota(rate=10, burst=1000)})
    out = [s.charge("greedy", 500), s.charge("modest", 5)]
    for w in (_w("greedy", "batch", tag="greedy-old"), _w("greedy", "batch", tag="greedy-new"),
              _w("modest", "batch", tag="modest-1"), _w("it", tag="it-1")):
        s.put_nowait(w)
    out += [s.sheddable_below("batch"), s.shed_victim("batch"),
            s.sheddable_below("interactive")]
    out += [s.shed_victim("interactive").tag,
            s.shed_victim("interactive", keep=lambda w: w.tag == "modest-1").tag,
            s.shed_victim("interactive", keep=lambda w: True), s.qsize(),
            sorted(s.token_counts.items()), [w.tag for w in s.drain()], s.qsize()]
    assert out[5:7] == ["greedy-new", "greedy-old"], out
    return out


def _case_requeue(ten):
    s = ten.TenantScheduler()
    s.put_nowait(_w("t", cost=100.0, tag="first"))
    s.put_nowait(_w("t", cost=100.0, tag="second"))
    before = s._lanes["interactive"]["t"].vtime
    got = s.get_nowait()
    s.requeue(got)
    out = [got.tag, s._lanes["interactive"]["t"].vtime == before, s.get_nowait().tag]
    assert out == ["first", True, "first"]
    return out


def _case_dynamic_overflow(ten):
    s = ten.TenantScheduler({"vip": ten.TenantQuota(weight=4)})
    s.MAX_DYNAMIC_TENANTS = 4
    seen = []
    for i in range(10):
        t = s.resolve(f"key-{i:04x}")
        seen.append(t)
        s.charge(t, 1)
    out = [seen, s.resolve("vip"), len(s._buckets), s.resolve("key-ffff"),
           s.resolve("key-0001")]
    assert out[3] == ten.TenantScheduler.OVERFLOW_TENANT and out[1] == "vip"
    return out


def _case_emptied_lanes(ten):
    s = ten.TenantScheduler()
    for i in range(50):
        s.put_nowait(_w(f"t{i}", cost=10.0))
    while not s.empty():
        s.get_nowait()
    out = [any(s._lanes[p] for p in s._lanes)]
    w = _w("t0", cost=10.0)
    s.put_nowait(w)
    got = s.get_nowait()
    s.requeue(got)
    out += [s.get_nowait() is got, s.empty()]
    assert out == [False, True, True]
    return out


def _case_charge_refund(ten):
    s = ten.TenantScheduler({"t": ten.TenantQuota(rate=10, burst=30)})
    out = [s.charge("t", 20), s.charge("t", 20), s.bucket_level("t"),
           s.tenant_over_quota("t")]
    s.refund("t", 500)  # capped at the burst
    out += [s.bucket_level("t"), sorted(s.token_counts.items()),
            s.bucket_level("unmetered")]
    assert out[0] is None and out[1] == pytest.approx(1.0) and out[4] == 30
    return out


_SCHEDULER_CASES = {
    "grammar": _case_grammar, "bucket_refill_retry_after": _case_bucket,
    "interactive_first": _case_interactive_first, "weighted_fair": _case_weighted_fair,
    "no_idle_credit": _case_idle_credit, "shed_victim": _case_shed_victim,
    "requeue_restores_head_and_vtime": _case_requeue,
    "dynamic_tenant_overflow": _case_dynamic_overflow,
    "emptied_lanes_dropped": _case_emptied_lanes, "charge_and_refund": _case_charge_refund,
}


@pytest.mark.parametrize("case", list(_SCHEDULER_CASES))
def test_scheduler_matches_jax(case, clock):
    """The same sequence through both packages' tenancy modules, on one
    injected clock, gives the same results."""
    fn = _SCHEDULER_CASES[case]
    assert fn(tten) == fn(jten)


# ------------------------------------------------------- engine admission


async def test_default_config_admission_order_matches_jax():
    """Queue C 2: with the default config (preemption on, unmetered
    tenants) one slot held by a batch stream, then batch and interactive
    arrivals from two tenants: the interactive class is admitted first (the
    holder paused for it), each class shared between tenants by vtime. The
    admission order, as admitted_seq, and every stream equal the JAX
    engine's."""
    arrivals = [("b1", "t1", "batch", 5), ("b2", "t2", "batch", 9),
                ("i1", "t1", "interactive", 7), ("b3", "t1", "batch", 3),
                ("i2", "t2", "interactive", 4), ("i3", "t1", "interactive", 11),
                ("i4", "t2", "interactive", 6), ("b4", "t2", "batch", 8)]

    async def scenario(m):
        eng = _engine(m, max_decode_slots=1)
        order: list[tuple[str, int]] = []
        make_slot = eng._make_slot

        def spy(waiting, *a, **kw):
            slot = make_slot(waiting, *a, **kw)
            order.append((waiting.request["tag"], slot.admitted_seq))
            return slot

        eng._make_slot = spy
        gate = _Gate(eng)
        prompts = np.random.default_rng(11).integers(3, 128, (9, 12)).tolist()
        hold_items: list = []
        hold = asyncio.create_task(_collect(
            eng, _req(prompts[0][:6], 48, tag="hold"), _ctx(m, "t1", "batch"), hold_items))
        assert await _until(lambda: len(hold_items) >= 2)
        await gate.close()
        tasks = [asyncio.create_task(_collect(
            eng, _req(prompts[k + 1][:n], 3 + k, tag=tag), _ctx(m, tenant, prio)))
            for k, (tag, tenant, prio, n) in enumerate(arrivals)]
        assert await _until(lambda: eng._waiting.qsize() == len(arrivals))
        gate.release()
        outs = await asyncio.gather(hold, *tasks)
        res = (order, [_tokens(o) for o in outs], [o[-1]["finish_reason"] for o in outs],
               dict(eng.preemptions), eng.allocator.active_pages)
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    order = [tag for tag, _ in got["port"][0]]
    assert order[0] == "hold" and set(order[1:5]) == {"i1", "i2", "i3", "i4"}, order
    assert order.count("hold") == 2 and got["port"][3] == {"interactive_admission": 1}
    assert [seq for _, seq in got["port"][0]] == list(range(1, len(order) + 1))
    assert got["port"][4] == 0


async def test_over_quota_and_saturation_retry_after_match_jax(clock):
    """A drained bucket answers OverQuota with the same message and the
    Retry-After its deficit gives on the injected clock; another tenant is
    unaffected; the saturation Retry-After follows queue depth x the
    injected step-time samples."""

    async def scenario(m):
        eng = _engine(m, tenants="bt:rate=1,burst=60")
        req = _req(range(3, 33), 8)
        first = _tokens(await _collect(eng, dict(req), _ctx(m, "bt", "batch")))
        with pytest.raises(m.ctx.OverQuota) as e:
            await _collect(eng, dict(req), _ctx(m, "bt", "batch"))
        other = _tokens(await _collect(eng, dict(req), _ctx(m, "other", "batch")))
        await eng.close()
        sat = _engine(m)
        _freeze_step_times(sat, 0.1)
        shallow = sat._saturation_retry_after()
        for _ in range(40):
            sat._waiting.put_nowait(m.Waiting({"token_ids": [1]}, m.ctx.Context(),
                                              asyncio.Queue(), tenant="t",
                                              priority="batch", cost=5.0))
        deep = sat._saturation_retry_after()
        await sat.close()
        return (first, other, str(e.value), e.value.retry_after_s,
                dict(eng.admission_rejects), shallow, deep)

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    first, other, msg, retry, rejects, shallow, deep = got["port"]
    assert first == other and len(first) == 8
    assert msg == "tenant 'bt' over token quota (cost 38 tokens)" and retry == 16.0
    assert rejects["over_quota"] == 1 and shallow == 0.25 and deep == pytest.approx(2.0)


async def test_shed_in_interactive_favour_and_refund_match_jax(clock):
    """max_waiting overflow: a batch arrival with nothing below it bounces
    (saturated); an interactive arrival sheds the waiting batch entry,
    whose charge comes back exactly; counted in admission_rejects."""

    async def scenario(m):
        eng = _engine(m, max_decode_slots=1, max_waiting=1, preemption=False,
                      tenants="bt:rate=1,burst=1000")
        _freeze_step_times(eng, 0.5)
        gate = _Gate(eng)
        hold = _req([1, 2, 3], 100)
        t_hold = asyncio.create_task(_collect(eng, dict(hold), _ctx(m, "bt", "batch")))
        assert await _until(lambda: any(s is not None for s in eng._slots))
        await gate.close()
        t_wait = asyncio.create_task(_collect(eng, dict(hold), _ctx(m, "bt", "batch")))
        assert await _until(lambda: eng._waiting.qsize() >= 1)
        level_before = eng._waiting.bucket_level("bt")
        with pytest.raises(m.ctx.ServiceUnavailable) as bounced:
            await _collect(eng, dict(hold), _ctx(m, "bt2", "batch"))
        it = asyncio.create_task(_collect(eng, _req([7, 8], 2), _ctx(m, "it")))
        with pytest.raises(m.ctx.ServiceUnavailable) as shed:
            await t_wait
        level_after = eng._waiting.bucket_level("bt")
        gate.release()
        out = await it
        held = await t_hold
        res = (str(bounced.value), bounced.value.retry_after_s, str(shed.value),
               shed.value.retry_after_s, level_before, level_after, _tokens(out),
               len(_tokens(held)), dict(eng.admission_rejects), eng.allocator.active_pages)
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    res = got["port"]
    assert res[0] == "engine saturated (1 waiting)" and res[1] == 0.5
    assert res[2] == "shed under overload (outranked while waiting)" and res[3] == 0.25
    assert res[5] == res[4] + 103 and len(res[6]) == 2 and res[7] == 100
    assert res[8]["shed"] == 1 and res[8]["saturated"] == 1 and res[9] == 0


async def test_never_fitting_prompt_refunds_quota_like_jax(clock):
    """A charged prompt that no pool could ever hold errors at admission and
    its charge comes back in full."""

    async def scenario(m):
        eng = _engine(m, num_pages=8, max_pages_per_seq=16, tenants="t:rate=1,burst=500")
        out = await _collect(eng, _req(range(1, 41), 2), _ctx(m, "t", "batch"))
        res = ([x.get("error") for x in out], eng._waiting.bucket_level("t"),
               eng.allocator.active_pages)
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    assert "pool can never hold it" in got["port"][0][-1] and got["port"][1] == 500


# ------------------------------------------------------------- preemption


async def _unpreempted(m, req, seed=5, **cfg):
    eng = _engine(m, seed=seed, **cfg)
    out = await _collect(eng, dict(req), m.ctx.Context())
    await eng.close()
    return _tokens(out)


async def _arrive(eng, gate, req, ctx):
    """One arrival while the step thread is parked: its first admission
    pass sees it, wherever the running streams are."""
    await gate.close()
    task = asyncio.create_task(_collect(eng, req, ctx))
    assert await _until(lambda: eng._waiting.qsize() == 1)
    gate.release()
    return await task


async def test_slot_pressure_preemption_resumes_to_unpreempted_tokens():
    """One slot held by a greedy batch stream; an interactive arrival
    pauses it (interactive_admission); the resumed stream equals its
    unpreempted run and the JAX engine's, token for token; no page leaks."""
    batch = _req([1, 2, 3, 4, 5], 80)

    async def scenario(m):
        eng = _engine(m, max_decode_slots=1)
        gate = _Gate(eng)
        items: list = []
        t_batch = asyncio.create_task(_collect(eng, dict(batch), _ctx(m, "bt", "batch"), items))
        assert await _until(lambda: len(items) >= 3)
        inter = await _arrive(eng, gate, _req([7, 8, 9], 4), _ctx(m, "it"))
        bout = await t_batch
        res = (_tokens(bout), bout[-1]["finish_reason"], _tokens(inter),
               dict(eng.preemptions), eng.allocator.active_pages)
        await eng.close()
        return res, await _unpreempted(m, batch, max_decode_slots=1)

    got = await _both(scenario)
    (port, port_ref), (jax_, jax_ref) = got["port"], got["jax"]
    assert port_ref == jax_ref and len(port_ref) == 80
    assert port[0] == port_ref == jax_[0], "preempted stream parted from its run"
    assert port[1:] == jax_[1:]
    assert port[3] == {"interactive_admission": 1} and port[4] == 0


async def test_spec_managed_victim_resumes_unchanged():
    """The victim is a speculating slot (spec_mode ngram): it loses its
    SlotSpec, the resume gets a fresh one at admission, and the greedy
    stream equals its unpreempted run and the JAX engine's."""
    seg = [11, 29, 40, 7, 63, 2]
    batch = _req(seg * 4, 60)

    async def scenario(m):
        eng = _engine(m, max_decode_slots=1, spec_mode="ngram", spec_k_max=4)
        spec_victims = []
        victim_slot = eng._victim_slot

        def spy():
            v = victim_slot()
            if v is not None:
                spec_victims.append(v[1].spec is not None)
            return v

        eng._victim_slot = spy
        gate = _Gate(eng)
        items: list = []
        t_batch = asyncio.create_task(_collect(eng, dict(batch), _ctx(m, "bt", "batch"), items))
        assert await _until(lambda: len(items) >= 3)
        inter = await _arrive(eng, gate, _req([7, 8, 9], 4), _ctx(m, "it"))
        bout = await t_batch
        res = (_tokens(bout), _tokens(inter), dict(eng.preemptions), spec_victims,
               eng.spec_verifies > 0, eng.allocator.active_pages)
        await eng.close()
        return res, await _unpreempted(m, batch, max_decode_slots=1)

    got = await _both(scenario)
    (port, port_ref), (jax_, jax_ref) = got["port"], got["jax"]
    assert port[0] == port_ref == jax_[0] == jax_ref and len(port_ref) == 60
    assert port[1:] == jax_[1:]
    assert port[2] == {"interactive_admission": 1} and port[3] == [True]
    assert port[4] and port[5] == 0


async def test_page_pressure_preemption_frees_pages_for_interactive():
    """An interactive prompt that finds a free slot but no free page pauses
    the batch stream holding the pool (interactive_pages; the admitting
    request's own empty slot must not count as room) instead of bouncing;
    no page leaks. The batch stream is then stopped by its client: its
    resume prompt can never fit this pool."""

    async def scenario(m):
        eng = _engine(m, num_pages=15, max_pages_per_seq=16, max_decode_slots=2)
        bctx = _ctx(m, "bt", "batch")
        t_batch = asyncio.create_task(_collect(eng, _req([1, 2, 3, 4, 5], 200), bctx))
        assert await _until(lambda: eng.allocator.free_pages == 0)
        t_inter = asyncio.create_task(_collect(
            eng, _req(range(30, 38), 2), _ctx(m, "it", "interactive")))
        assert await _until(lambda: eng.preemptions.get("interactive_pages", 0) >= 1
                            or t_inter.done())
        bctx.stop_generating()
        out = await t_inter
        bout = await t_batch
        await _until(lambda: eng.allocator.active_pages == 0)
        errors = [x["error"] for x in bout if x.get("error")]
        res = (_tokens(out), [x.get("error") for x in out], dict(eng.preemptions),
               all("pool can never hold it" in e for e in errors),
               eng.allocator.active_pages)
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 2 and got["port"][1] == [None, None]
    assert got["port"][2] == {"interactive_pages": 1} and got["port"][3:] == (True, 0)


async def test_preempt_fault_site_skips_preemption_cleanly(monkeypatch):
    """engine.preempt armed through DYN_FAULTS (each package's registry
    configured from it, as at import): an injected error skips the
    preemption. The interactive request waits out the batch stream, nobody
    errors, nothing was preempted, no page leaks."""
    monkeypatch.setenv("DYN_FAULTS", "engine.preempt:error")

    async def scenario(m):
        eng = _engine(m, max_decode_slots=1)
        m.faults.configure(os.environ["DYN_FAULTS"], seed=1)
        try:
            gate = _Gate(eng)
            items: list = []
            t_batch = asyncio.create_task(_collect(eng, _req([1, 2, 3], 40),
                                                   _ctx(m, "bt", "batch"), items))
            assert await _until(lambda: len(items) >= 2)
            out = await _arrive(eng, gate, _req([7], 2), _ctx(m, "it"))
            bout = await t_batch
            res = (_tokens(out), _tokens(bout), [x for x in bout if x.get("error")],
                   dict(eng.preemptions), eng.allocator.active_pages,
                   m.faults.snapshot()["trips"].get("engine.preempt:error", 0) >= 1)
        finally:
            m.faults.clear()
            await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 2 and len(got["port"][1]) == 40
    assert got["port"][2:] == ([], {}, 0, True)


# ------------------------------------------------- resume checksum (Queue C 1)


async def test_resume_checksum_verified_at_intake_like_jax():
    """A missing, a right and a wrong token_checksum: the first two serve,
    the third raises IntegrityError with the reference's message before
    any admission and counts on migration.resume."""
    prompt = list(range(3, 12))

    async def scenario(m):
        eng = _engine(m)
        right = m.integ.token_checksum(prompt)
        outs = []
        before = m.integ.integrity_snapshot().get("migration.resume", 0)
        for stamp in (None, right, right ^ 1):
            req = _req(prompt, 5)
            if stamp is not None:
                req["token_checksum"] = stamp
            try:
                outs.append(_tokens(await _collect(eng, req, m.ctx.Context())))
            except m.integ.IntegrityError as e:
                assert isinstance(e, m.ctx.StreamError)
                outs.append(str(e))
        after = m.integ.integrity_snapshot().get("migration.resume", 0)
        res = (outs, after - before, eng.allocator.active_pages, eng.inflight())
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    outs, counted, pages, inflight = got["port"]
    assert outs[0] == outs[1] and len(outs[0]) == 5
    assert outs[2].startswith("resume prompt checksum mismatch: expected 0x")
    assert (counted, pages, inflight) == (1, 0, 0)


async def test_corrupt_resume_redrives_migration_like_jax():
    """migration.resume armed as corrupt (once): a stream that dies after
    two items is re-driven with a checksummed resume prompt, the engine
    sees it corrupted and raises IntegrityError, and the migration operator
    re-drives again from its pristine copy. The client's stream equals the
    unbroken one in both packages."""
    prompt = list(range(20, 31))

    class _DiesOnce:
        def __init__(self, eng, error):
            self.eng, self.error, self.calls = eng, error, 0

        async def generate(self, req, ctx):
            self.calls += 1
            n = 0
            async for item in self.eng.generate(req, ctx):
                yield item
                n += 1
                if self.calls == 1 and n == 2:
                    raise self.error("worker lost")

    async def scenario(m):
        eng = _engine(m)
        clean = _tokens(await _collect(eng, _req(prompt, 12), m.ctx.Context()))
        m.faults.configure("migration.resume:corrupt=1x1", seed=3)
        before = m.integ.integrity_snapshot().get("migration.resume", 0)
        try:
            down = _DiesOnce(eng, m.ctx.StreamError)
            mig = m.Migration(down, retry_delay_s=0.01, backoff_max_s=0.02)
            out = [x async for x in mig.generate(_req(prompt, 12), m.ctx.Context())]
            trips = m.faults.snapshot()["trips"].get("migration.resume:corrupt", 0)
        finally:
            m.faults.clear()
        counted = m.integ.integrity_snapshot().get("migration.resume", 0) - before
        await _until(lambda: eng.allocator.active_pages == 0)
        res = (clean, _tokens(out), out[-1]["finish_reason"], down.calls, counted, trips,
               eng.allocator.active_pages)
        await eng.close()
        return res

    got = await _both(scenario)
    assert got["port"] == got["jax"]
    clean, out, finish, calls, counted, trips, pages = got["port"]
    assert out == clean and len(clean) == 12 and finish == "length"
    assert (calls, counted, trips, pages) == (3, 1, 1, 0)


# ------------------------------------------------------ both HTTP stacks


async def _stack(m, side):
    """One serving stack (engine, round-robin card with no migration,
    watcher, HTTP frontend) on the running loop."""
    cfg = m.Config(**{**CFG_KW, "max_decode_slots": 1, "max_waiting": 1,
                      "tenants": "q:rate=1,burst=60"})
    spec = dict(SPEC_KW, vocab_size=288)
    jp = dict(jllama.init_params(JaxSpec(**spec), jax.random.PRNGKey(3)))
    jp["embed"] = jp["embed"] * 8.0
    params = jp if side == "jax" else params_from_numpy(
        ModelSpec(**spec), jax.tree.map(np.asarray, jp), device="cpu")
    eng = m.Engine(m.Spec(**spec), cfg, params=params, **m.kw)
    _freeze_step_times(eng, 0.5)
    if side == "jax":
        drt, register, manager, watcher, frontend = (
            JaxRuntime(JaxHub()), jax_register_llm, JaxModelManager, JaxModelWatcher,
            JaxHttpFrontend)
    else:
        drt, register, manager, watcher, frontend = (
            DistributedRuntime(InMemoryHub()), register_llm, ModelManager, ModelWatcher,
            HttpFrontend)
    ep = drt.namespace("dynamo").component("backend").endpoint("generate")
    await register(drt, ep, eng.generate, model_name="tiny", router_mode="round_robin",
                   context_length=eng.config.max_context, kv_block_size=4,
                   migration_limit=0)
    await eng.start()
    watch = await watcher(drt, manager()).start()
    await watch.wait_for_model("tiny", timeout=10)
    http = frontend(watch.manager, host="127.0.0.1", port=0, drt=drt)
    await http.start()
    return SimpleNamespace(eng=eng, gate=_Gate(eng), drt=drt, watch=watch, http=http,
                           base=f"http://127.0.0.1:{http.port}")


async def test_http_429_and_503_match_jax(clock):
    """Both HTTP stacks, the same requests: an over-quota tenant's 429 and a
    saturated engine's 503 carry the same JSON bodies and Retry-After."""
    chat = {"model": "tiny", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 8, "ignore_eos": True}

    async def scenario(m, sess):
        side = "jax" if m is SIDES["jax"] else "port"
        st = await _stack(m, side)
        res = {}
        try:
            statuses = []
            for _ in range(4):
                async with sess.post(st.base + "/v1/chat/completions", json=chat,
                                     headers={"x-dyn-tenant": "q"}) as r:
                    statuses.append(r.status)
                    if r.status == 429:
                        res["429"] = (await r.json(), r.headers["Retry-After"])
                        break
            res["statuses"] = statuses

            async def stream(tenant, n):
                body = dict(chat, max_tokens=n, stream=True)
                async with sess.post(st.base + "/v1/chat/completions", json=body,
                                     headers={"x-dyn-tenant": tenant}) as r:
                    return r.status, await r.text()

            hold = asyncio.create_task(stream("h", 100))
            assert await _until(lambda: any(s is not None for s in st.eng._slots))
            await st.gate.close()
            wait = asyncio.create_task(stream("w", 4))
            assert await _until(lambda: st.eng._waiting.qsize() == 1)
            async with sess.post(st.base + "/v1/chat/completions", json=chat,
                                 headers={"x-dyn-tenant": "x"}) as r:
                res["503"] = (r.status, await r.json(), r.headers["Retry-After"])
            st.gate.release()
            res["streams"] = [s for s, _ in await asyncio.gather(hold, wait)]
            res["rejects"] = dict(st.eng.admission_rejects)
        finally:
            await st.http.stop()
            await st.watch.close()
            await st.eng.close()
            await st.drt.close()
        return res

    async with aiohttp.ClientSession() as sess:
        got = await _both(scenario, sess=sess)
    assert got["port"] == got["jax"]
    res = got["port"]
    assert res["429"][0]["error"]["code"] == "over_quota" and res["statuses"][-1] == 429
    status, body, retry = res["503"]
    assert status == 503 and body["error"]["code"] == "service_unavailable"
    assert "engine saturated (1 waiting)" in body["error"]["message"] and retry == "1"
    assert res["streams"] == [200, 200] and res["rejects"]["saturated"] == 1
