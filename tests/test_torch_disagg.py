"""The port's disaggregated serving (dynamo_tpu_torch/disagg/ and the
engine's export and resume), case by case after tests/test_disagg.py and
the disagg cases of tests/test_integrity.py (the PJRT and shard-layout
cases wait for ROADMAP Queue A items 10c and 11):

- the transfer plane in process and over TCP (f32, bf16 as its bits, the
  packed fp8 block, MLA's latent blocks with their int8 v slot), one-shot
  pulls, release, the TTL, the ``disagg.pull`` corrupt site;
- the policy's live hub key;
- a prefill worker + decode worker stream exactly the aggregated worker's
  greedy tokens (f32 and fp8 pools, in process and over TCP), the decode
  engine running no prefill forward and the prefill engine no decode step;
  a second request on its prefix hit stays local;
- the kv_dtype mismatch fails loudly; a failed pull (``disagg.pull`` error
  or corrupt) falls back to a local prefill with the same stream; no
  prefill pool, a short prompt and ``max_tokens`` 1;
- a resume bounced at a full queue, or shed from it, drops its staged
  blocks and releases its export; a resumed slot preempted mid-decode
  comes back as a plain request on its prefix hit, with no second pull;
- tiny-deepseek served disaggregated equals its aggregated stream.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.disagg import transfer as tr
from dynamo_tpu_torch.disagg.policy import DisaggPolicy
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.models.family import get_family
from dynamo_tpu_torch.ops.quant import QuantPool, is_quant
from dynamo_tpu_torch.runtime.context import Context, ServiceUnavailable
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.hub import InMemoryHub
from dynamo_tpu_torch.runtime.integrity import IntegrityError, integrity_snapshot
from dynamo_tpu_torch.tokens import TokenBlockSequence

pytestmark = pytest.mark.integration

SPEC = ModelSpec(name="tiny-test", vocab_size=272, hidden_size=32,
                 intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                 head_dim=8, dtype="float32")
PROMPT = list(range(40, 40 + 23))  # 23 tokens: 5 full pages of 4 and 3


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def faults():
    yield FAULTS
    FAULTS.clear()


def engine_config(**kw):
    return EngineConfig(**{**dict(page_size=4, num_pages=128, max_pages_per_seq=32,
                                  max_decode_slots=4, prefill_buckets=(32, 64, 128)),
                           **kw})


def req(token_ids, max_tokens=8, **kw):
    return {"token_ids": list(token_ids), "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
            "eos_token_ids": [2], **kw}


async def collect(agen):
    toks, items = [], []
    async for item in agen:
        items.append(item)
        toks.extend(item.get("token_ids") or [])
    return toks, items


async def aggregated(prompt, spec=SPEC, max_tokens=8, **cfg):
    drt = DistributedRuntime(InMemoryHub())
    eng, _ = await launch_engine_worker(drt, spec=spec, engine_config=engine_config(**cfg),
                                        model_name="agg", device="cpu")
    try:
        return (await collect(eng.generate(req(prompt, max_tokens), Context())))[0]
    finally:
        await eng.close()
        await drt.close()


class _Pair:
    """A prefill worker and a decode worker on one in-memory hub."""

    async def start(self, spec=SPEC, dec_cfg=None, pre=True, pre_cfg=None, **dec_kw):
        self.drt = DistributedRuntime(InMemoryHub())
        self.pre = None
        if pre:
            self.pre, _ = await launch_engine_worker(
                self.drt, spec=spec, engine_config=pre_cfg or engine_config(),
                mode="prefill", device="cpu")
        self.dec, _ = await launch_engine_worker(
            self.drt, spec=spec, engine_config=dec_cfg or engine_config(),
            mode="decode", device="cpu", **{"always_remote_prefill": True, **dec_kw})
        self.handler = self.dec.frontdoor
        if pre:
            await self.handler.wait_for_prefill_pool()
        return self

    async def close(self):
        if self.pre is not None:
            await self.pre.close()
        await self.dec.close()
        await self.drt.close()


class _Blind(dict):
    def __setitem__(self, key, value):
        pass


@pytest.fixture
def tcp_only(monkeypatch):
    """An in-process registry that keeps nothing: every pull takes the
    socket."""
    monkeypatch.setattr(tr, "_LOCAL_SOURCES", _Blind())


# ------------------------------------------------------------ transfer plane


def _blocks(case):
    """(k, v) blocks as ``extract_pages`` gives them, with their wire names."""
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((2, 3, 2, 4, 8)).astype(np.float32)
    if case == "f32":
        return torch.from_numpy(f32), torch.from_numpy(f32 + 1000.0)
    if case == "bf16":
        return (torch.from_numpy(f32).to(torch.bfloat16),
                torch.from_numpy(-f32).to(torch.bfloat16))
    if case == "packed":
        u8 = rng.integers(0, 256, (2, 3, 136), dtype=np.uint8)
        return torch.from_numpy(u8), torch.from_numpy(u8[:, ::-1].copy())
    lat = rng.standard_normal((2, 3, 4, 24)).astype(np.float32)  # MLA latent
    return torch.from_numpy(lat), torch.zeros((1, 3), dtype=torch.int8)


def _bits(x) -> np.ndarray:
    """A block's elements as comparable bits (bf16 tensors as uint16)."""
    if isinstance(x, torch.Tensor):
        x = tr._host_array(x)
    return np.asarray(x)


@pytest.mark.parametrize("case", ["f32", "bf16", "packed", "latent"])
async def test_transfer_roundtrip_local_tcp_release_and_ttl(case):
    """In process the puller gets the exported blocks; over TCP the same
    bits with their types (bf16 as ``uint16`` bits named bfloat16, the MLA
    v slot int8 under ``v_dtype``); pulls are one-shot; release and the TTL
    drop an export and run its on_done."""
    k, v = _blocks(case)
    src = await tr.KvTransferSource(ttl_s=0.2).start()
    try:
        params = src.export(k, v, num_tokens=11, page_size=4)
        assert "cuda_ipc" not in params  # host blocks: no device route
        k1, v1, meta = tr.pull_kv_blocks(params)
        assert meta == {"num_tokens": 11, "page_size": 4, "checksum": meta["checksum"]}
        assert np.array_equal(k1, _bits(k)) and np.array_equal(v1, _bits(v))
        with pytest.raises(KeyError):
            tr.pull_kv_blocks(params)
        tr._LOCAL_SOURCES.pop(src.uid)  # from here on, the socket

        params = src.export(k, v, num_tokens=11, page_size=4)
        before = tr.PULLS.snapshot()["pulls"]["tcp"]
        k2, v2, meta = await asyncio.to_thread(tr.pull_kv_blocks, params)
        assert tr.PULLS.snapshot()["pulls"]["tcp"] == before + 1
        assert meta == {"num_tokens": 11, "page_size": 4}
        assert k2.dtype == _bits(k).dtype and v2.dtype == _bits(v).dtype
        assert np.array_equal(k2, _bits(k)) and np.array_equal(v2, _bits(v))
        with pytest.raises(KeyError):
            await asyncio.to_thread(tr.pull_kv_blocks, params)

        done = []
        params = src.export(k, v, num_tokens=11, page_size=4, on_done=lambda: done.append(1))
        await asyncio.to_thread(tr.release_kv_blocks, params)
        assert done == [1] and src.pending == 0
        src.export(k, v, num_tokens=11, page_size=4, on_done=lambda: done.append(2))
        for _ in range(100):
            if src.pending == 0:
                break
            await asyncio.sleep(0.02)
        assert done == [1, 2]  # expired unclaimed
    finally:
        await src.close()


async def test_pull_corrupt_detected_never_decoded(faults, tcp_only):
    """A bit flipped on the wire is caught by the receiver's checksum
    before the bytes become KV (IntegrityError, counted on disagg.pull);
    once the fault is spent the same wire round-trips exactly
    (tests/test_integrity.py's case)."""
    k, v = _blocks("f32")
    src = await tr.KvTransferSource().start()
    before = integrity_snapshot().get("disagg.pull", 0)
    try:
        params = src.export(k, v, num_tokens=11, page_size=4)
        trips0 = faults.trip_counts.get(("disagg.pull", "corrupt"), 0)
        faults.configure("disagg.pull:corrupt=1x1")
        with pytest.raises(IntegrityError):
            await asyncio.to_thread(tr.pull_kv_blocks, params)
        assert faults.trip_counts[("disagg.pull", "corrupt")] == trips0 + 1
        assert integrity_snapshot()["disagg.pull"] == before + 1
        params = src.export(k, v, num_tokens=11, page_size=4)
        k2, v2, _ = await asyncio.to_thread(tr.pull_kv_blocks, params)
        assert np.array_equal(k2, k.numpy()) and np.array_equal(v2, v.numpy())
    finally:
        await src.close()


def test_ipc_handles_encode_to_json_and_back():
    """The device route's handle codec: bytes, dtypes, classes and sizes
    survive JSON; a class outside torch's tensor and storage types is
    refused."""
    import json

    args = (torch.Tensor, torch.Size([2, 3]), (3, 1), 0, torch.storage.TypedStorage,
            torch.bfloat16, 0, b"\x00\xffhandle", 4096, 512, False, "/shm", 8,
            b"\x01ev", True)
    back = tr._ipc_decode(json.loads(json.dumps(tr._ipc_encode(args))))
    assert back == tuple(tuple(a) if isinstance(a, torch.Size) else a for a in args)
    with pytest.raises(ValueError):
        tr._ipc_decode({"cls": "os.system"})


async def test_policy_live_update():
    hub = InMemoryHub()
    policy = DisaggPolicy(max_local_prefill_length=10)
    assert not policy.prefill_remote(10)
    assert policy.prefill_remote(11)
    assert not policy.prefill_remote(14, prefix_hit_len=4)
    await policy.watch(hub, "dynamo")
    await hub.put("v1/config/disagg/dynamo", {"max_local_prefill_length": 2})
    await asyncio.sleep(0.05)
    assert policy.prefill_remote(3)
    await hub.put("v1/config/disagg/dynamo", {"always_remote": True,
                                              "max_local_prefill_length": 100})
    await asyncio.sleep(0.05)
    assert policy.prefill_remote(1)
    policy.close()
    await hub.close()


# ------------------------------------------------------------------ e2e


def _sealed(eng, prompt) -> list[int]:
    return eng.allocator.match_prefix(
        TokenBlockSequence.from_tokens(prompt, 4).sequence_hashes())


@pytest.mark.parametrize("kv,route", [("bf16", "local"), ("bf16", "tcp"),
                                      ("fp8", "local"), ("fp8", "tcp")])
async def test_disagg_matches_aggregated_greedy(kv, route, request):
    """prefill worker + decode worker == aggregated worker, token for token:
    the prompt's pages were computed on the prefill engine (it sealed them
    and ran no decode step) and installed bitwise into the decode engine
    (which ran no prefill forward), over the route asked. The second
    request, on its prefix hit, stays local (max_local_prefill_length 8)."""
    if route == "tcp":
        request.getfixturevalue("tcp_only")
    want = await aggregated(PROMPT, kv_dtype=kv)
    assert len(want) == 8
    pair = await _Pair().start(pre_cfg=engine_config(kv_dtype=kv),
                               dec_cfg=engine_config(kv_dtype=kv),
                               always_remote_prefill=False, max_local_prefill_length=8)
    pre, dec = pair.pre, pair.dec
    pulls = tr.PULLS.snapshot()["pulls"]
    try:
        got, items = await collect(pair.handler.generate(req(PROMPT), Context()))
        assert got == want and items[-1]["finish_reason"] == "length"
        assert pre.steps == 0 and pre.transfer_source.exported == 1
        assert dec.prefill_forwards == 0 and dec.steps >= len(want) - 1
        assert dec.resume_times[-1][1] == 6  # pages installed
        after = tr.PULLS.snapshot()["pulls"]
        assert {r: after[r] - pulls[r] for r in after} == {
            "local": int(route == "local"), "device": 0, "tcp": int(route == "tcp")}
        # the decode engine's sealed prompt pages hold the prefill engine's bytes
        mine, theirs = _sealed(dec, PROMPT), _sealed(pre, PROMPT)
        assert len(mine) == len(theirs) == 5
        kd, vd = dec.fam.extract_pages(dec.k_pages, dec.v_pages, torch.tensor(mine))
        kp, vp = pre.fam.extract_pages(pre.k_pages, pre.v_pages, torch.tensor(theirs))
        assert torch.equal(kd, kp) and torch.equal(vd, vp)
        # the second request's uncached tail (3 tokens) is under the limit
        assert dec.prefix_hit_tokens(PROMPT) == 20
        got2, _ = await collect(pair.handler.generate(req(PROMPT), Context()))
        assert got2 == want and pre.transfer_source.exported == 1
        assert dec.prefill_forwards == 1
    finally:
        await pair.close()
    assert pre.allocator.active_pages == 0 and dec.allocator.active_pages == 0


async def test_kv_dtype_mismatch_rejected_loudly():
    """A bf16 prefill worker and an fp8 decode worker: the request fails
    with an error naming the knob, no page held."""
    pair = await _Pair().start(dec_cfg=engine_config(kv_dtype="fp8"))
    try:
        _, items = await collect(pair.handler.generate(req(PROMPT), Context()))
        errs = [i for i in items if i.get("finish_reason") == "error"]
        assert errs and "kv_dtype mismatch" in errs[-1]["error"]
    finally:
        await pair.close()
    assert pair.dec.allocator.active_pages == 0


@pytest.mark.parametrize("fault", ["error", "corrupt"])
async def test_failed_pull_falls_back_with_continuity(fault, faults, tcp_only):
    """The KV pull fails once (the prefill worker died between export and
    pull, or a bit flipped on the wire, caught by the checksum): the decode
    worker prefills prompt + the remote first token itself and streams the
    aggregated tokens; then, with the prefill worker gone, a new prompt is
    served locally."""
    want = await aggregated(PROMPT)
    pair = await _Pair().start()
    try:
        spec = "disagg.pull:error@1x1" if fault == "error" else "disagg.pull:corrupt=1x1"
        before = integrity_snapshot().get("disagg.pull", 0)
        faults.configure(spec)
        got, _ = await collect(pair.handler.generate(req(PROMPT), Context()))
        assert got == want
        assert pair.dec.disagg_fallbacks == 1 and pair.dec.prefill_forwards == 1
        assert integrity_snapshot().get("disagg.pull", 0) == before + (fault == "corrupt")
        faults.clear()
        await pair.pre.close()
        prompt2 = list(range(70, 93))
        want2 = await aggregated(prompt2)
        got2, _ = await collect(pair.handler.generate(req(prompt2), Context()))
        assert got2 == want2
    finally:
        await pair.close()
    assert pair.dec.allocator.active_pages == 0


async def test_no_prefill_pool_short_prompt_and_one_token():
    """No live prefill worker: local. A prompt under the limit: local, the
    prefill pool untouched. max_tokens 1: the remote token alone, its export
    released."""
    pair = await _Pair().start(pre=False)
    try:
        assert not pair.handler.can_prefill()
        got, _ = await collect(pair.handler.generate(req(range(50, 70)), Context()))
        assert len(got) == 8
    finally:
        await pair.close()
    pair = await _Pair().start(always_remote_prefill=False, max_local_prefill_length=64)
    try:
        got, _ = await collect(pair.handler.generate(req(range(40, 52)), Context()))
        assert len(got) == 8
        assert pair.pre.steps == 0 and pair.pre.allocator.used_pages == 0
    finally:
        await pair.close()
    pair = await _Pair().start()
    try:
        got, items = await collect(pair.handler.generate(
            req(range(40, 60), max_tokens=1), Context()))
        assert len(got) == 1 and items[-1]["finish_reason"] == "length"
        await asyncio.sleep(0.05)
        assert pair.pre.transfer_source.pending == 0
        assert pair.dec.steps == 0 and pair.dec.prefill_forwards == 0
    finally:
        await pair.close()


async def _remote_first(pre, prompt, **kw):
    """The prefill worker's answer to a remote prefill: (first token,
    kv_transfer_params)."""
    r = req(prompt, max_tokens=1, **kw)
    r["disagg"] = {"mode": "prefill", "kv_transfer": {"do_remote_decode": True}}
    _, items = await collect(pre.frontdoor.generate(r, Context()))
    return items[-1]["token_ids"][0], items[-1]["kv_transfer_params"]


def _resume(prompt, first, kvp, **kw):
    return req(prompt, disagg={"mode": "decode",
                                   "kv_transfer": {**kvp, "first_token": first}}, **kw)


async def _until(cond, n=500):
    for _ in range(n):
        if cond():
            return True
        await asyncio.sleep(0.01)
    return False


async def test_bounced_and_shed_resumes_release_their_exports(monkeypatch):
    """A full waiting queue (max_waiting 1, the step thread parked): of two
    batch resumes arriving together one is queued and the other bounced at
    the enqueue; an interactive resume then sheds the queued one. Both
    losers drop their staged blocks and release their exports; the
    interactive stream equals the aggregated one."""
    want = await aggregated(PROMPT)
    pair = await _Pair().start(dec_cfg=engine_config(max_waiting=1))
    dec = pair.dec
    released = []
    real = tr.release_kv_blocks
    monkeypatch.setattr(tr, "release_kv_blocks",
                        lambda p, *a: (released.append(p["transfer_id"]), real(p, *a)))
    gate_open, parked = threading.Event(), threading.Event()
    admit = dec._admit_phase

    def gated():
        if not gate_open.is_set():
            parked.set()
            gate_open.wait(30.0)  # bounded: a failed test must not park it for good
        return admit()

    dec._admit_phase = gated
    try:
        await dec.start()

        def wake_parked():
            dec._wake.set()
            return parked.is_set()

        assert await _until(wake_parked)
        reqs = []
        for prompt in (PROMPT, list(range(90, 113))):
            first, kvp = await _remote_first(pair.pre, prompt)
            reqs.append((_resume(prompt, first, kvp, priority="batch"), kvp))
        tasks = [asyncio.create_task(collect(dec.generate(r, Context()))) for r, _ in reqs]
        assert await _until(lambda: dec.admission_rejects["saturated"] == 1)
        await asyncio.sleep(0.05)
        bounced = [i for i, t in enumerate(tasks) if t.done()]
        assert len(bounced) == 1
        assert isinstance(tasks[bounced[0]].exception(), ServiceUnavailable)
        queued = 1 - bounced[0]
        assert dec._waiting.qsize() == 1
        first, kvp = await _remote_first(pair.pre, PROMPT)
        inter = asyncio.create_task(collect(dec.generate(
            _resume(PROMPT, first, kvp, priority="interactive"), Context())))
        assert await _until(lambda: dec.admission_rejects["shed"] == 1)
        with pytest.raises(ServiceUnavailable):
            await tasks[queued]
        gate_open.set()
        got, _ = await inter
        assert [first] + got == want
        for r, _kvp in reqs:
            assert "_staged_kv" not in r["disagg"]
        assert await _until(lambda: all(kvp["transfer_id"] in released
                                        for _r, kvp in reqs))
    finally:
        gate_open.set()
        await pair.close()
    assert dec.allocator.active_pages == 0


async def test_preempted_resume_rehits_its_prefix_without_a_pull():
    """One decode slot holds a resumed batch stream; an interactive arrival
    preempts it (interactive_admission). The stream comes back as a plain
    request on its sealed prompt pages, with no second pull of the spent
    export, and equals the aggregated stream token for token; no page
    leaks."""
    want = await aggregated(PROMPT, max_tokens=24)
    pair = await _Pair().start(dec_cfg=engine_config(max_decode_slots=1))
    dec = pair.dec
    gate_open, parked = threading.Event(), threading.Event()
    gate_open.set()
    admit = dec._admit_phase

    def gated():
        if not gate_open.is_set():
            parked.set()
            gate_open.wait(30.0)  # bounded: a failed test must not park it for good
        return admit()

    dec._admit_phase = gated
    try:
        first, kvp = await _remote_first(pair.pre, PROMPT)
        pulls = tr.PULLS.snapshot()["pulls"]
        items: list = []

        async def stream():
            async for item in dec.generate(
                    _resume(PROMPT, first, kvp, max_tokens=24, priority="batch"),
                    Context()):
                items.append(item)

        batch = asyncio.create_task(stream())
        assert await _until(lambda: len(items) >= 3)
        gate_open.clear()
        assert await _until(parked.is_set)
        inter = asyncio.create_task(collect(dec.generate(
            req(range(90, 97), max_tokens=4, priority="interactive"), Context())))
        assert await _until(lambda: dec._waiting.qsize() == 1)
        gate_open.set()
        await batch
        got_inter, _ = await inter
        got = [t for x in items for t in (x.get("token_ids") or [])]
        assert items[-1]["finish_reason"] == "length"
        assert [first] + got == want and len(got_inter) == 4
        assert dec.preemptions == {"interactive_admission": 1}
        assert dec.prefill_forwards == 2  # the interactive prompt and the resume's tail
        after = tr.PULLS.snapshot()["pulls"]
        assert sum(after.values()) - sum(pulls.values()) == 1
    finally:
        gate_open.set()
        await pair.close()
    assert dec.allocator.active_pages == 0


# ----------------------------------------------------------------- MLA


@pytest.mark.parametrize("kv", ["f32", "fp8"])
async def test_latent_blocks_cross_tcp_bitwise(kv, tcp_only):
    """tiny-deepseek's latent blocks (f32, or packed per-row fp8) go
    extract -> export -> TCP pull -> insert -> extract bitwise, the inert
    int8 v slot crossing under ``v_dtype`` (the JAX wire carries one dtype,
    so its reader fails on f32 latent exports)."""
    spec = ModelSpec.tiny_deepseek()
    fam = get_family(spec)
    kv_dtype = "fp8" if kv == "fp8" else "bf16"
    src_k, src_v = fam.init_cache(spec, 9, 4, device="cpu", kv_dtype=kv_dtype)
    dst_k, dst_v = fam.init_cache(spec, 9, 4, device="cpu", kv_dtype=kv_dtype)
    g = torch.Generator().manual_seed(7)
    if is_quant(src_k):
        src_k.vals.view(torch.uint8).copy_(
            torch.randint(0, 0x7F, src_k.vals.shape, generator=g, dtype=torch.uint8))
        src_k.scale.copy_(torch.rand(src_k.scale.shape, generator=g).to(torch.bfloat16))
    else:
        src_k.copy_(torch.randn(src_k.shape, generator=g))
    ids = torch.tensor([3, 1, 6])
    kb, vb = fam.extract_pages(src_k, src_v, ids)
    src = await tr.KvTransferSource().start()
    try:
        params = src.export(kb, vb, num_tokens=10, page_size=4)
        k2, v2, _ = await asyncio.to_thread(tr.pull_kv_blocks, params)
    finally:
        await src.close()
    assert v2.dtype == np.int8 and v2.shape == (1, 3)
    dst_ids = torch.tensor([2, 5, 7])
    fam.insert_pages(dst_k, dst_v, dst_ids, torch.from_numpy(k2), torch.from_numpy(v2))
    kb2, _ = fam.extract_pages(dst_k, dst_v, dst_ids)
    assert isinstance(dst_k, QuantPool) == (kv == "fp8")
    assert torch.equal(kb2, kb)


async def test_deepseek_disagg_matches_aggregated():
    """tiny-deepseek (MLA) served by a prefill + decode pair equals its
    aggregated stream."""
    spec = ModelSpec.tiny_deepseek()
    prompt = list(range(20, 43))
    want = await aggregated(prompt, spec=spec)
    pair = await _Pair().start(spec=spec)
    try:
        got, _ = await collect(pair.handler.generate(req(prompt), Context()))
        assert got == want and pair.dec.prefill_forwards == 0
    finally:
        await pair.close()
