"""Named chaos scenarios: traffic + faults + continuously-asserted
invariants over real control-plane components (the counterpart of
dynamo_tpu/sim/scenarios.py; HTTP goes through runtime/http_client.py).

Every scenario returns a dict with an ``invariants`` map ({name: {pass,
...detail}}); the harness derives the verdict. AssertionError anywhere
(including inside ``check_cluster_invariants``) is a failed invariant.

Scenario ingredients are ALL production code paths: the quorum hub
(runtime/hub_replica.py) with its fencing/commit machinery, the
multi-address failover client (runtime/hub_client.py), the KV-aware
router + EPP breakers (kv_router/, gateway/), the migration operator
(frontend/migration.py), the planner's replica math (planner/core.py),
and the ``DYN_FAULTS`` / ``transport.partition`` grammar
(runtime/faults.py). Only the workers are mocks — time-dilated
``MockEngine``s that honor the same fault sites and deadline contract
as the real engine (mocker/engine.py chaos parity).
"""

from __future__ import annotations

import asyncio
import logging
import random
import tempfile
import time
from pathlib import Path

from dynamo_tpu_torch.gateway.breaker import BreakerConfig
from dynamo_tpu_torch.gateway.epp import EndpointPicker
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.http_client import HttpSession
from dynamo_tpu_torch.runtime.hub_client import RemoteHub, failover_stats
from dynamo_tpu_torch.sim import cluster as hubctl
from dynamo_tpu_torch.sim.harness import (
    COMP,
    EP,
    NS,
    MockFleet,
    ProcReplicaCluster,
    ReplicaCluster,
    SimConfig,
    migrations_snapshot,
    telemetry_overhead,
)
from dynamo_tpu_torch.sim.replay import (
    load_trace,
    pct_ms,
    replay_trace,
    synthesize_trace,
    synthesize_wave_trace,
)

log = logging.getLogger("dynamo_tpu.sim")


def _inv(ok: bool, **detail) -> dict:
    return {"pass": bool(ok), **detail}


def _tmpdir(cfg: SimConfig, tag: str) -> Path:
    """Scenario scratch under ONE run-scoped base dir. run_scenarios
    pins cfg.data_dir for the whole run (and cleans it up on a passing
    run); the mkdtemp branch only fires for direct scenario calls."""
    if not cfg.data_dir:
        cfg.data_dir = tempfile.mkdtemp(prefix="dynamo-sim-")
    d = Path(cfg.data_dir) / tag
    d.mkdir(parents=True, exist_ok=True)
    return d


def _mk_trace(cfg: SimConfig, tag: str, *, requests: int, rate: float,
              osl: int | None = None, groups: int | None = None,
              seed: int | None = None) -> list[dict]:
    path = _tmpdir(cfg, "traces") / f"{tag}.jsonl"
    synthesize_trace(
        str(path), requests=requests, block_size=cfg.block_size,
        groups=groups or max(12, cfg.workers // 8), rate_per_s=rate,
        osl=osl or cfg.osl, seed=cfg.seed if seed is None else seed,
    )
    return load_trace(str(path), cfg.block_size)


# -- pick_scaling ------------------------------------------------------------


async def pick_scaling(cfg: SimConfig) -> dict:
    """EPP pick latency vs instance count: the flatness bar. For each
    fleet size, a fresh mock fleet registers against an in-memory hub,
    the real EndpointPicker serves /pick over HTTP, and we measure the
    full pick path (tokenless token_ids pick: KV score + instance
    resolve + breaker walk) client-side. Steady-state picks must do ZERO
    hub round-trips (hub_scans flat while picks grow) and the latency
    curve must stay flat-ish as the fleet grows to 100s of instances."""
    from dynamo_tpu_torch.gateway.pickline import PickLineClient

    curve = []
    rng = random.Random(cfg.seed)
    for size in cfg.sizes():
        fleet = await MockFleet(cfg, size).start()
        epp = None
        try:
            epp = await EndpointPicker(
                fleet.drt, namespace=NS, target_component=COMP,
                target_endpoint=EP,
                config=RouterConfig(block_size=cfg.block_size),
                host="127.0.0.1", port=0, pick_port=0,
            ).start()
            deadline = time.monotonic() + 20
            while len(epp.kv.scheduler.workers()) < size:
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"EPP saw {len(epp.kv.scheduler.workers())}/{size} "
                        "workers"
                    )
                await asyncio.sleep(0.05)

            prompts = [
                [rng.randrange(10, 30000) for _ in range(cfg.block_size * 4)]
                for _ in range(32)
            ]
            lats: list[float] = []
            sem = asyncio.Semaphore(cfg.pick_concurrency)

            async def one(i: int, sess):
                async with sem:
                    t0 = time.perf_counter()
                    status, body = await sess.request("POST", "/pick", {
                        "token_ids": prompts[i % len(prompts)],
                        "request_id": f"pk-{i}",
                    })
                    assert status == 200, body
                    lats.append(time.perf_counter() - t0)

            async with HttpSession("127.0.0.1", epp.port) as sess:
                # warmup fills the pick-path caches (cards + instances)
                for i in range(8):
                    await one(i, sess)
                lats.clear()
                scans0 = epp._cards.scans + epp._instances.scans
                picks0 = epp.kv.picks
                phases0 = dict(epp.kv.pick_phase_totals)
                full_scans0 = epp.kv.scheduler.full_pick_scans
                await asyncio.gather(
                    *(one(i, sess) for i in range(cfg.picks))
                )
                scans1 = epp._cards.scans + epp._instances.scans
            # per-phase decision attribution (hash/overlap/select) over
            # the measured window — the rest of the client-observed pick
            # latency is transport + HTTP plumbing
            dp = max(epp.kv.picks - picks0, 1)
            phase_us = {
                k: round(
                    1e6 * (epp.kv.pick_phase_totals[k] - phases0[k]) / dp,
                    2,
                )
                for k in phases0
            }
            # the pickline fast path over the same prompts: persistent
            # connection, pipelined by the same concurrency semaphore
            line = await PickLineClient(
                "127.0.0.1", epp.pick_port
            ).connect()
            line_lats: list[float] = []

            async def one_line(i: int):
                async with sem:
                    t0 = time.perf_counter()
                    r = await line.pick({
                        "token_ids": prompts[i % len(prompts)],
                        "request_id": f"pl-{i}",
                    })
                    assert r["status"] == 200, r
                    line_lats.append(time.perf_counter() - t0)

            await asyncio.gather(*(one_line(i) for i in range(cfg.picks)))
            await line.close()
            curve.append({
                "instances": size,
                "picks": cfg.picks,
                "pick_ms_p50": pct_ms(lats, 0.5),
                "pick_ms_p90": pct_ms(lats, 0.9),
                "pick_ms_p99": pct_ms(lats, 0.99),
                "pickline_ms_p50": pct_ms(line_lats, 0.5),
                "pickline_ms_p99": pct_ms(line_lats, 0.99),
                "decision_phase_us": phase_us,
                "steady_state_hub_scans": scans1 - scans0,
                "full_fleet_scans": (
                    epp.kv.scheduler.full_pick_scans - full_scans0
                ),
            })
        finally:
            if epp is not None:
                await epp.close()
            await fleet.close()
    lo, hi = curve[0], curve[-1]
    flat_ratio = hi["pick_ms_p50"] / max(lo["pick_ms_p50"], 1.0)
    return {
        "curve": curve,
        "invariants": {
            # the flatness bar: growing the fleet 4x must not grow the
            # median pick more than ~3x (sub-linear; floor 1 ms so tiny
            # absolute numbers don't flap the ratio)
            "pick_latency_flat": _inv(
                flat_ratio <= 3.0, ratio=round(flat_ratio, 2),
                p50_small_ms=lo["pick_ms_p50"], p50_large_ms=hi["pick_ms_p50"],
            ),
            "zero_hub_roundtrips_steady_state": _inv(
                all(c["steady_state_hub_scans"] == 0 for c in curve),
                scans=[c["steady_state_hub_scans"] for c in curve],
            ),
            # the incremental selector's contract at fleet scale: no
            # pick ever falls back to an O(instances) full-fleet scan
            "zero_full_fleet_scans": _inv(
                all(c["full_fleet_scans"] == 0 for c in curve),
                scans=[c["full_fleet_scans"] for c in curve],
            ),
            # the pickline transport must beat the HTTP route it
            # displaces at the largest fleet
            "pickline_beats_http": _inv(
                hi["pickline_ms_p50"] <= hi["pick_ms_p50"],
                pickline_ms=hi["pickline_ms_p50"],
                http_ms=hi["pick_ms_p50"],
            ),
        },
    }


# -- leader_kill -------------------------------------------------------------


async def leader_kill(cfg: SimConfig) -> dict:
    """SIGKILL the quorum leader mid-commit-storm (real subprocesses,
    real kill -9). Writers hammer majority-committed puts through the
    multi-address failover client; the kill lands a third of the way in.
    Asserts: every ACKED write survives into the recovered cluster, the
    unavailability window is bounded by election + reconnect scale, the
    post-kill commit rate recovers, and the WAL invariant checker holds
    across all three data dirs (including the corpse's)."""
    base = _tmpdir(cfg, "leader_kill")
    cl = await ProcReplicaCluster(cfg, base).start()
    client = None
    acked: list[tuple[float, str, float]] = []  # (t_done, key, latency)
    failed: list[str] = []
    stop = asyncio.Event()
    writers: list[asyncio.Future] = []
    redirects0 = failover_stats()
    try:
        leader = await cl.find_leader()
        client = await RemoteHub.connect(
            ",".join(cl.addrs), reconnect_window_s=20.0
        )
        t_start = time.monotonic()

        async def writer(w: int):
            i = 0
            while not stop.is_set():
                key = f"storm/{w}/{i}"
                t0 = time.monotonic()
                try:
                    await client.put(key, i)
                    acked.append((time.monotonic(), key, time.monotonic() - t0))
                except (ConnectionError, RuntimeError) as e:
                    failed.append(f"{key}: {e}")
                    # a closed/unreachable client raises without ever
                    # suspending — without this pause a failure path
                    # that forgot us would busy-starve the event loop
                    await asyncio.sleep(0.01)
                i += 1

        writers = [
            asyncio.ensure_future(writer(w))
            for w in range(cfg.storm_writers)
        ]
        kill_at = cfg.storm_duration_s * 0.35
        await asyncio.sleep(kill_at)
        t_kill = time.monotonic()
        cl.sigkill(leader)
        log.warning("sim: SIGKILLed hub leader %s mid-storm", leader)
        await asyncio.sleep(cfg.storm_duration_s - kill_at)
        stop.set()
        await asyncio.gather(*writers, return_exceptions=True)

        new_leader = await cl.find_leader()
        assert new_leader != leader, "dead leader still answers as leader"
        await client.put("post/recovery", 1)

        # durability of the acked prefix: every write the client saw
        # acked (majority-committed by contract) must be readable now
        sample = acked if len(acked) <= 400 else random.Random(
            cfg.seed
        ).sample(acked, 400)
        lost = []
        for _t, key, _l in sample:
            i = int(key.rsplit("/", 1)[1])
            if await client.get(key) != i:
                lost.append(key)

        # throughput timeline around the kill
        pre = [t for t, _k, _l in acked if t < t_kill]
        post = [t for t, _k, _l in acked if t >= t_kill]
        pre_rate = len(pre) / max(t_kill - t_start, 1e-9)
        post_win = max(acked[-1][0] - t_kill, 1e-9) if acked else 1.0
        post_rate = len(post) / post_win
        # unavailability: the longest gap between consecutive acks that
        # spans the kill moment
        times = sorted([t for t, _k, _l in acked] + [t_kill])
        outage = max(
            (b - a for a, b in zip(times, times[1:])), default=0.0
        )
        outage_bound = cfg.lease_s * 12 + cfg.commit_timeout_s + 2.0
        redirects = {
            k: v - redirects0.get(k, 0.0)
            for k, v in failover_stats().items()
        }
    finally:
        # stop the storm FIRST: failure paths must not leave writer
        # tasks looping against a closed client for the rest of the run
        stop.set()
        await asyncio.gather(*writers, return_exceptions=True)
        if client is not None:
            await client.close()
        cl.terminate_all()
    inv_detail = hubctl.check_cluster_invariants(cl.data_dirs())
    return {
        "commits_acked": len(acked),
        "commit_rate_pre_kill": round(pre_rate, 1),
        "commit_rate_post_kill": round(post_rate, 1),
        "commit_ms_p50": pct_ms([x for _t, _k, x in acked], 0.5),
        "commit_ms_p99": pct_ms([x for _t, _k, x in acked], 0.99),
        "outage_s": round(outage, 3),
        "committed_records": len(inv_detail["committed"]),
        "client_failover": redirects,
        "invariants": {
            "cluster_invariants": _inv(True),  # checker above raised if not
            "no_acked_write_lost": _inv(
                not lost, lost=lost[:5], sampled=len(sample)
            ),
            "outage_bounded": _inv(
                outage <= outage_bound,
                outage_s=round(outage, 3), bound_s=outage_bound,
            ),
            "throughput_recovered": _inv(
                post_rate >= 0.4 * pre_rate,
                pre=round(pre_rate, 1), post=round(post_rate, 1),
            ),
            "write_failures_zero": _inv(
                not failed, failures=failed[:5]
            ),
        },
    }


# -- partition ---------------------------------------------------------------


async def partition(cfg: SimConfig) -> dict:
    """Partition matrix during live traffic: a symmetric partition
    isolates the leader mid-write-storm (the majority side must elect
    and keep committing; no_quorum stalls bounded to the window), then a
    one-way cut that must NOT depose the leader. Invariants via the
    jepsen-style WAL checker: no dual-lead per term, no committed fork,
    no seq gap — and every acked write survives the heals."""
    base = _tmpdir(cfg, "partition")
    cl = await ReplicaCluster(cfg, base).start()
    client = None
    acked: list[tuple[float, str, float]] = []
    failed: list[str] = []
    stop = asyncio.Event()
    wt: asyncio.Future | None = None
    windows: list[tuple[float, float]] = []  # (start, end) of chaos
    redirects0 = failover_stats()
    try:
        leader = await cl.wait_leader()
        client = await RemoteHub.connect(
            ",".join(cl.addrs), reconnect_window_s=20.0
        )

        async def writer():
            i = 0
            while not stop.is_set():
                key = f"part/{i}"
                t0 = time.monotonic()
                try:
                    await client.put(key, i)
                    acked.append(
                        (time.monotonic(), key, time.monotonic() - t0)
                    )
                except (ConnectionError, RuntimeError) as e:
                    failed.append(f"{key}: {e}")
                i += 1
                await asyncio.sleep(0.01)

        wt = asyncio.ensure_future(writer())
        await asyncio.sleep(0.5)

        # round 1: symmetric partition cutting the leader off
        t0 = time.monotonic()
        FAULTS.configure(
            hubctl.isolate_spec(leader.advertise, cl.addrs), seed=cfg.seed
        )
        try:
            survivors = [r for r in cl.reps if r is not leader]
            deadline = time.monotonic() + 15
            while not any(r.hub.role == "leader" for r in survivors):
                assert time.monotonic() < deadline, (
                    "majority side failed to elect within 15s"
                )
                await asyncio.sleep(0.05)
            await asyncio.sleep(cfg.partition_window_s)
        finally:
            FAULTS.clear()
            windows.append((t0, time.monotonic()))
        await cl.wait_leader()

        # round 2: one-way cut (leader -> follower) must not depose
        await asyncio.sleep(0.5)
        new_leader = await cl.wait_leader()
        follower = next(r for r in cl.reps if r is not new_leader)
        t0 = time.monotonic()
        FAULTS.configure(hubctl.partition_spec(
            (new_leader.advertise, follower.advertise), one_way=True,
        ), seed=cfg.seed + 1)
        try:
            await asyncio.sleep(cfg.partition_window_s)
            leaders = [r for r in cl.reps if r.hub.role == "leader"]
            one_way_stable = leaders == [new_leader]
        finally:
            FAULTS.clear()
            windows.append((t0, time.monotonic()))

        await cl.wait_leader()
        await asyncio.sleep(0.5)
        stop.set()
        await asyncio.gather(wt, return_exceptions=True)

        # acked durability after both heals
        sample = acked if len(acked) <= 300 else random.Random(
            cfg.seed
        ).sample(acked, 300)
        lost = [
            key for _t, key, _l in sample
            if await client.get(key) != int(key.rsplit("/", 1)[1])
        ]
        # no_quorum stalls bounded to the chaos windows: outside them
        # (with slack for the failover tail) every commit is fast
        slack = cfg.lease_s * 8 + cfg.commit_timeout_s
        stalled_outside = [
            key for t, key, lat in acked
            if lat > 1.0 and not any(
                s <= t <= e + slack for s, e in windows
            )
        ]
    finally:
        FAULTS.clear()
        # failure paths included: the writer must not outlive the
        # scenario and spin against a closed client
        stop.set()
        if wt is not None:
            await asyncio.gather(wt, return_exceptions=True)
        if client is not None:
            await client.close()
        dirs = cl.data_dirs()
        await cl.stop_all()
    inv_detail = hubctl.check_cluster_invariants(dirs)
    return {
        "commits_acked": len(acked),
        "committed_records": len(inv_detail["committed"]),
        "terms_seen": sorted(inv_detail["promotes"]),
        "chaos_windows": [
            [round(e - s, 2) for s, e in [w]][0] for w in windows
        ],
        # delta over the scenario, not process-lifetime absolutes — the
        # redirect counters are process-global and earlier scenarios
        # (leader_kill in an --scenario all run) already moved them
        "client_failover": {
            k: v - redirects0.get(k, 0.0)
            for k, v in failover_stats().items()
        },
        "invariants": {
            "cluster_invariants": _inv(True),
            "no_acked_write_lost": _inv(
                not lost, lost=lost[:5], sampled=len(sample)
            ),
            "one_way_keeps_leader": _inv(one_way_stable),
            "stalls_bounded_to_partition": _inv(
                not stalled_outside, stalled=stalled_outside[:5]
            ),
            "write_failures_zero": _inv(not failed, failures=failed[:5]),
        },
    }


# -- churn -------------------------------------------------------------------


async def churn(cfg: SimConfig) -> dict:
    """Worker kill + rejoin waves under open-loop trace replay, through
    the REAL client path (KV-aware routing + migration operator). The
    acceptance bar from the soak tier, at fleet scale: ZERO
    client-visible errors with migrations > 0 — every stream cut by a
    kill wave must be transparently re-driven. The rejoin waves are
    deliberate thundering herds (all replacements register at once).
    Feeds the observed interval into the real SLA planner's replica math
    and records its recommendation."""
    fleet = await MockFleet(cfg, cfg.workers).start()
    mig0 = migrations_snapshot()
    killed = rejoined = 0
    try:
        engine = await fleet.client_path(migration=True)
        trace = _mk_trace(
            cfg, "churn", requests=cfg.trace_n(), rate=cfg.trace_rate()
        )
        replay_window = trace[-1]["t_ms"] / 1000.0 if trace else 1.0

        async def chaos():
            nonlocal killed, rejoined
            waves = max(cfg.churn_waves, 1)
            t_begin = time.monotonic()
            for i in range(waves):
                # absolute schedule: wave i lands at (i+0.5)/waves of
                # the replay window regardless of how long earlier
                # kills/rejoins took (cumulative sleeps would push late
                # waves past the end of the replay onto an idle fleet)
                target = t_begin + replay_window * (i + 0.5) / waves
                await asyncio.sleep(max(target - time.monotonic(), 0.0))
                k = max(1, int(len(fleet.alive_workers())
                               * cfg.churn_kill_frac))
                victims = await fleet.kill_wave(k)
                killed += len(victims)
                log.warning(
                    "sim churn wave %d: killed %d workers (%d alive)",
                    i, len(victims), len(fleet.alive_workers()),
                )
                await asyncio.sleep(0.2)
                await fleet.rejoin_wave(len(victims))
                rejoined += len(victims)

        chaos_task = asyncio.ensure_future(chaos())
        res = await replay_trace(
            engine.generate, trace, id_prefix="churn"
        )
        await chaos_task
        migrations = migrations_snapshot() - mig0
        summary = res.summary()
        itls = res.itls()
        incomplete = [
            r for r in res.results
            if r["ttft"] is None and r["error"] is None
        ]
    finally:
        await fleet.close()

    # the real planner's replica math over the observed interval: would
    # the SLA planner have scaled this fleet, given what the storm did?
    from dynamo_tpu_torch.planner.core import Metrics, PlannerConfig, SlaPlanner
    from dynamo_tpu_torch.planner.interpolation import (
        DecodeInterpolator,
        PrefillInterpolator,
        synthetic_profile,
    )

    prof = synthetic_profile()
    planner = SlaPlanner(
        PlannerConfig(
            ttft_sla_s=0.5, itl_sla_s=0.05,
            adjustment_interval_s=max(res.elapsed_s, 1e-3),
            predictor="constant", no_correction=True,
            max_chip_budget=cfg.workers * 2,
        ),
        PrefillInterpolator(prof), DecodeInterpolator(prof),
    )
    isl_avg = (
        sum(len(r["token_ids"]) for r in trace) / max(len(trace), 1)
    )
    planner.ingest(Metrics(
        ttft=(summary["ttft_ms_p50"] or 0.0) / 1e3,
        itl=(pct_ms(itls, 0.5) or 0.0) / 1e3,
        num_req=float(len(trace)), isl=isl_avg, osl=float(cfg.osl),
        request_duration=sum(
            r["duration"] for r in res.results
        ) / max(len(res.results), 1),
    ))
    n_p, n_d = planner.compute_replicas(
        float(len(trace)), isl_avg, float(cfg.osl)
    )

    return {
        **summary,
        # offered = the trace's open-loop schedule; achieved = what the
        # single replay process actually sustained (the gap is the
        # one-router throughput cap)
        "offered_req_per_s": round(cfg.trace_rate(), 1),
        "dilated_offered_req_per_s": round(
            cfg.trace_rate() * cfg.speedup, 1
        ),
        "dilated_req_per_s": round(summary["req_per_s"] * cfg.speedup, 1),
        "workers": cfg.workers,
        "killed": killed,
        "rejoined": rejoined,
        "migrations": migrations,
        "itl_ms_p50": pct_ms(itls, 0.5),
        "planner_recommendation": {"prefill": n_p, "decode": n_d},
        "invariants": {
            "zero_client_errors": _inv(
                not res.errors, errors=res.errors[:5]
            ),
            "migrations_gt_zero": _inv(
                migrations > 0, migrations=migrations
            ),
            "all_requests_completed": _inv(
                not incomplete, incomplete=len(incomplete)
            ),
            "workers_actually_churned": _inv(killed > 0, killed=killed),
        },
    }


# -- breaker_storm -----------------------------------------------------------


async def breaker_storm(cfg: SimConfig) -> dict:
    """Injected ``epp.breaker`` failures brown out picked instances:
    breakers must OPEN (instances ejected from picks) while /pick stays
    100% available (fail-open contract), then — after the fault clears
    and /report feeds recoveries — every breaker must CLOSE again."""
    size = min(cfg.workers, 16)
    fleet = await MockFleet(cfg, size).start()
    epp = None
    storm_statuses: list[int] = []
    try:
        epp = await EndpointPicker(
            fleet.drt, namespace=NS, target_component=COMP,
            target_endpoint=EP,
            config=RouterConfig(block_size=cfg.block_size),
            host="127.0.0.1", port=0,
            breaker_config=BreakerConfig(
                window=16, min_samples=4, failure_threshold=0.5,
                open_cooldown_s=0.2, half_open_probes=2, close_after=2,
                probe_timeout_s=5.0,
            ),
        ).start()
        deadline = time.monotonic() + 20
        while len(epp.kv.scheduler.workers()) < size:
            assert time.monotonic() < deadline, "EPP never saw the fleet"
            await asyncio.sleep(0.05)
        rng = random.Random(cfg.seed)

        async def one_pick(sess, i: int) -> int:
            status, _ = await sess.request("POST", "/pick", {
                "token_ids": [
                    rng.randrange(10, 30000)
                    for _ in range(cfg.block_size * 2)
                ],
                "request_id": f"bs-{i}",
            })
            return status

        async with HttpSession("127.0.0.1", epp.port) as sess:
            # storm: every pick records an injected failure outcome
            # against the chosen instance (the epp.breaker fault site)
            FAULTS.configure("epp.breaker:error@1x200", seed=cfg.seed)
            try:
                for i in range(150):
                    storm_statuses.append(await one_pick(sess, i))
                    if len(epp.breakers.ejected()) >= max(size // 3, 1):
                        break
            finally:
                FAULTS.clear()
            ejected_peak = len(epp.breakers.ejected())

            # recovery: keep picking (half-open probes re-admit) and
            # report success for everything still tracked as ejected
            deadline = time.monotonic() + 15
            while epp.breakers.ejected() and time.monotonic() < deadline:
                storm_statuses.append(await one_pick(sess, 10_000))
                for iid in list(epp.breakers.ejected()):
                    await sess.request("POST", "/report", {
                        "worker_id": f"{iid:x}", "ok": True,
                        "latency_ms": 1.0,
                    })
                await asyncio.sleep(0.05)
            ejected_final = len(epp.breakers.ejected())
    finally:
        FAULTS.clear()
        if epp is not None:
            await epp.close()
        await fleet.close()
    return {
        "fleet": size,
        "picks": len(storm_statuses),
        "ejected_peak": ejected_peak,
        "ejected_after_recovery": ejected_final,
        "invariants": {
            "breakers_opened": _inv(
                ejected_peak >= 1, ejected_peak=ejected_peak
            ),
            "breakers_recovered": _inv(
                ejected_final == 0, still_open=ejected_final
            ),
            "pick_availability_100": _inv(
                all(s == 200 for s in storm_statuses),
                non_200=[s for s in storm_statuses if s != 200][:5],
            ),
        },
    }


# -- tenant_storm ------------------------------------------------------------


async def tenant_storm(cfg: SimConfig) -> dict:
    """A batch tenant floods the fleet while an interactive tenant keeps
    its dribble of traffic: the mock engines' class-priority admission
    (the parity mirror of engine/tenancy.py's lanes) must hold the
    interactive TTFT SLO through the storm. Baseline first (interactive
    alone), then the same interactive trace under the batch flood.

    Runs on a slot-constrained sub-fleet at modest dilation so the storm
    saturates WORKER SLOTS (the thing priority admission arbitrates)
    rather than the harness event loop — at full fleet scale a single
    replay process saturates on routing CPU first, which is a real
    finding but a different one."""
    from dataclasses import replace

    size = min(cfg.workers, 16)
    storm_cfg = replace(
        cfg, workers=size, speedup=4.0, max_batch_size=2,
        trace_rate_per_s=size * 16.0,
    )
    fleet = await MockFleet(storm_cfg, size).start()
    try:
        engine = await fleet.client_path(migration=True)
        n_int = max(cfg.trace_n() // 4, 24)
        int_rate = storm_cfg.trace_rate() / 16.0
        int_trace = _mk_trace(
            storm_cfg, "tenant_int", requests=n_int, rate=int_rate,
            seed=cfg.seed,
        )
        # storm length scales with the SUB-fleet (≈1.5s of flood at the
        # storm rate), not the global worker count — a small --workers
        # run must still saturate the slots it has, or the falsifiable
        # batch_actually_stormed invariant correctly calls it out
        n_batch = max(cfg.trace_n(), size * 25)
        batch_trace = _mk_trace(
            storm_cfg, "tenant_batch", requests=n_batch,
            rate=storm_cfg.trace_rate(), osl=cfg.osl * 4,
            seed=cfg.seed + 7,
        )
        # the contended phase replays a DIFFERENT interactive trace
        # (fresh seed, same shape): re-running the baseline's exact
        # tokens would ride the prefix caches the baseline just warmed
        # and mask real contention in the SLO comparison
        int_trace_cold = _mk_trace(
            storm_cfg, "tenant_int_cold", requests=n_int, rate=int_rate,
            seed=cfg.seed + 13,
        )
        hdr_int = {"x-dyn-tenant": "live", "x-dyn-priority": "interactive"}
        hdr_batch = {"x-dyn-tenant": "bulk", "x-dyn-priority": "batch"}

        base = await replay_trace(
            engine.generate, int_trace, headers=hdr_int, id_prefix="tb",
        )
        base_sum = base.summary()

        contended, flood = await asyncio.gather(
            replay_trace(
                engine.generate, int_trace_cold, headers=hdr_int,
                id_prefix="ti",
            ),
            replay_trace(
                engine.generate, batch_trace, headers=hdr_batch,
                id_prefix="tf",
            ),
        )
        cont_sum = contended.summary()
        flood_sum = flood.summary()

        # cluster-level tenant steering: replay decision-only picks for
        # a prompt with TOTAL prefix affinity (one warm radix group, so
        # overlap-argmax wants exactly one worker). Untagged picks must
        # pin that worker (the falsifiable control — steering never
        # touches the untenanted path); the same picks tagged as a hot
        # tenant must spread across several workers.
        kv = fleet.kv_router
        hot_toks = int_trace[0]["token_ids"]
        pinned: set[int] = set()
        steered: set[int] = set()
        for i in range(64):
            wid, _ = kv.find_best_match(f"pin-{i}", hot_toks)
            kv.free(f"pin-{i}")
            pinned.add(wid)
        for i in range(64):
            wid, _ = kv.find_best_match(
                f"hot-{i}", hot_toks, tenant="hot-tenant"
            )
            kv.free(f"hot-{i}")
            steered.add(wid)
    finally:
        await fleet.close()
    slo_s = max(
        cfg.slo_ttft_factor * (base_sum["ttft_ms_p50"] or 0.0) / 1e3,
        cfg.slo_ttft_floor_s,
    )
    p99_s = (cont_sum["ttft_ms_p99"] or float("inf")) / 1e3
    return {
        "fleet": size,
        "slots_per_worker": storm_cfg.max_batch_size,
        "interactive_baseline": base_sum,
        "interactive_contended": cont_sum,
        "batch_flood": flood_sum,
        "slo_ttft_ms": round(slo_s * 1e3, 1),
        "invariants": {
            "interactive_ttft_slo_held": _inv(
                p99_s <= slo_s,
                p99_ms=cont_sum["ttft_ms_p99"],
                slo_ms=round(slo_s * 1e3, 1),
            ),
            "interactive_zero_errors": _inv(
                not contended.errors, errors=contended.errors[:5]
            ),
            # falsifiable saturation check: if the flood never actually
            # contended for slots (e.g. every request bounced), batch
            # TTFT would sit at the uncontended baseline and the SLO
            # invariant above would be passing against an idle fleet
            "batch_actually_stormed": _inv(
                not flood.errors
                and (flood_sum["ttft_ms_p50"] or 0.0)
                >= 2.0 * (base_sum["ttft_ms_p50"] or float("inf")),
                batch_ttft_ms_p50=flood_sum["ttft_ms_p50"],
                baseline_ttft_ms_p50=base_sum["ttft_ms_p50"],
                flood_errors=len(flood.errors),
            ),
            # cluster-level steering: the hot tenant spreads across
            # workers while untagged picks (the control) stay pinned to
            # the affinity winner
            "hot_tenant_spreads": _inv(
                len(pinned) == 1 and len(steered) >= 2,
                pinned_workers=len(pinned),
                steered_workers=len(steered),
            ),
        },
    }


# -- telemetry overhead ------------------------------------------------------


async def telemetry(cfg: SimConfig) -> dict:
    """Span/metric emission overhead as a fraction of step time: does
    observability load the fleet down at scale?"""
    out = telemetry_overhead(cfg)
    return {
        **out,
        "invariants": {
            # a real (undilated) engine step must spend <5% of its time
            # on span+metric emission
            "emission_under_5pct_of_real_step": _inv(
                out["emission_frac_of_real_step"] < 0.05,
                frac=out["emission_frac_of_real_step"],
            ),
        },
    }


# -- autoscale ---------------------------------------------------------------


def _autoscale_config(cfg: SimConfig, *, lead_ticks: int) -> "AutoscalerConfig":
    from dynamo_tpu_torch.autoscaler import AutoscalerConfig

    tick = cfg.autoscale_tick_s
    return AutoscalerConfig(
        slots_per_worker=cfg.autoscale_slots,
        target_occupancy=0.75,
        min_workers=cfg.autoscale_start_workers,
        max_workers=cfg.autoscale_max_workers,
        scale_up_at=0.85,
        scale_down_at=0.5,
        up_cooldown_s=1.5 * tick,
        down_cooldown_s=8.0 * tick,
        max_step_up=4,
        max_step_down=2,
        predict_ahead_ticks=lead_ticks,
        predictor="holt",
        tick_interval_s=tick,
    )


async def _autoscale_pass(
    cfg: SimConfig, trace: list[dict], *, lead_ticks: int, tag: str
) -> dict:
    """One full closed loop over the wave trace: small slow fleet, live
    hub-fed telemetry, the real control law, SimBackend actuation.
    Returns the replay summary + per-tick capacity accounting."""
    import dataclasses

    from dynamo_tpu_torch.autoscaler import (
        AutoscaleController,
        FleetTelemetry,
        SimBackend,
    )

    fcfg = dataclasses.replace(
        cfg,
        workers=cfg.autoscale_start_workers,
        speedup=cfg.autoscale_speedup,
        max_batch_size=cfg.autoscale_slots,
    )
    tick = cfg.autoscale_tick_s
    fleet = await MockFleet(fcfg, fcfg.workers).start()
    backend = SimBackend(fleet)
    tel = FleetTelemetry(
        fleet.hub, f"{NS}/{COMP}", stale_after_s=max(1.0, 4 * tick)
    ).start()
    ctrl = AutoscaleController(
        _autoscale_config(cfg, lead_ticks=lead_ticks), tel, backend,
        initial_workers=cfg.autoscale_start_workers,
    )
    samples: list[tuple[float, int]] = []  # (demand, alive workers)
    stop = asyncio.Event()

    async def drive():
        while not stop.is_set():
            await ctrl.tick()
            samples.append(
                (tel.signal().demand, len(fleet.alive_workers()))
            )
            await asyncio.sleep(tick)

    try:
        engine = await fleet.client_path(migration=True)
        mig0 = migrations_snapshot()
        driver = asyncio.ensure_future(drive())
        res = await replay_trace(engine.generate, trace, id_prefix=tag)
        # tail: keep the loop ticking past the trough so the down-
        # cooldown expires and scale-down actually happens in-scenario
        await asyncio.sleep(12 * tick)
        stop.set()
        await driver
        migrations = migrations_snapshot() - mig0
    finally:
        await ctrl.close()
        await tel.close()
        await fleet.close()

    slots = cfg.autoscale_slots
    deficit = sum(
        max(0.0, d - w * slots) * tick for d, w in samples
    )
    peak_demand = max((d for d, _ in samples), default=0.0)
    report = ctrl.report()
    return {
        **res.summary(),
        "migrations": migrations,
        "peak_demand": round(peak_demand, 1),
        "deficit_area": round(deficit, 2),
        "max_workers_seen": max((w for _, w in samples), default=0),
        "final_workers": report["final"]["workers"],
        "spawned": backend.spawned,
        "drained": backend.drained,
        "errors_detail": res.errors[:5],
        "autoscaler": report,
    }


async def autoscale(cfg: SimConfig) -> dict:
    """The closed-loop SLA autoscaler under a diurnal wave + 10x flash
    spike, actuated in the live sim fleet (SimBackend spawn/drain over
    the real runtime). Acceptance: interactive TTFT p99
    within SLO on the predictive pass, ZERO client-visible errors while
    replicas scale down through the drain contract, plans converge
    within bounded ticks, over-provisioning bounded, and the predictive
    pre-scaler measurably beats the reactive baseline on capacity
    deficit (the queue the fleet was short, integrated over time)."""
    import math as _math

    wave_path = _tmpdir(cfg, "autoscale") / "wave.jsonl"
    synthesize_wave_trace(
        str(wave_path),
        duration_s=cfg.autoscale_duration_s,
        base_rate=cfg.autoscale_base_rate,
        peak_rate=cfg.autoscale_peak_rate,
        spike_rate=cfg.autoscale_spike_factor * cfg.autoscale_base_rate,
        block_size=cfg.block_size,
        osl=cfg.autoscale_osl,
        seed=cfg.seed,
    )
    trace = load_trace(str(wave_path), cfg.block_size)

    predictive = await _autoscale_pass(
        cfg, trace, lead_ticks=cfg.autoscale_lead_ticks, tag="as-pred"
    )
    reactive = None
    if cfg.autoscale_compare:
        reactive = await _autoscale_pass(
            cfg, trace, lead_ticks=0, tag="as-react"
        )

    acfg = _autoscale_config(cfg, lead_ticks=cfg.autoscale_lead_ticks)
    needed_peak = _math.ceil(
        predictive["peak_demand"]
        / (cfg.autoscale_slots * acfg.target_occupancy)
    )
    slo_ms = cfg.autoscale_slo_ttft_s * 1e3
    invariants = {
        "ttft_slo_held": _inv(
            (predictive["ttft_ms_p99"] or 0.0) <= slo_ms,
            ttft_ms_p99=predictive["ttft_ms_p99"], slo_ms=slo_ms,
        ),
        "zero_client_errors_during_scaling": _inv(
            predictive["errors"] == 0 and predictive["drained"] > 0,
            errors=predictive["errors_detail"],
            drained=predictive["drained"],
        ),
        "fleet_actually_scaled": _inv(
            predictive["spawned"] > 0 and predictive["drained"] > 0,
            spawned=predictive["spawned"], drained=predictive["drained"],
        ),
        "overprovisioning_bounded": _inv(
            predictive["max_workers_seen"]
            <= min(needed_peak + acfg.max_step_up, acfg.max_workers),
            max_workers_seen=predictive["max_workers_seen"],
            needed_at_peak=needed_peak,
        ),
        "convergence_bounded": _inv(
            predictive["autoscaler"]["converge_ticks_max"] <= 3
            and not predictive["autoscaler"]["unconverged"],
            converge_ticks_max=(
                predictive["autoscaler"]["converge_ticks_max"]
            ),
        ),
    }
    if reactive is not None:
        # the margin: predictive's capacity deficit must be at most 70%
        # of reactive's — unless predictive's own deficit is already
        # below the control loop's resolution (one bounded step of
        # capacity held for the pre-scale horizon). On a calm host the
        # reactive pass can actuate fast enough to incur ~zero deficit;
        # demanding a 30% win over noise turns the gate into a coin
        # flip, while a predictive deficit under the noise floor means
        # pre-scaling delivered everything the spike could ask of it.
        noise_floor = (
            acfg.max_step_up * cfg.autoscale_tick_s
            * max(cfg.autoscale_lead_ticks, 1)
        )
        invariants["predictive_beats_reactive"] = _inv(
            predictive["deficit_area"]
            <= max(0.7 * reactive["deficit_area"], noise_floor),
            predictive_deficit=predictive["deficit_area"],
            reactive_deficit=reactive["deficit_area"],
            noise_floor=round(noise_floor, 2),
        )
    return {
        "trace_requests": len(trace),
        "predictive": predictive,
        "reactive": reactive,
        "invariants": invariants,
    }


# -- gray_failure ------------------------------------------------------------


async def gray_failure(cfg: SimConfig) -> dict:
    """One worker degrades GRAY — 10x step time via a sticky per-instance
    ``engine.step:delay`` fault, still answering everything — and the
    self-healing plane must catch it without any absolute threshold:
    peer-relative degradation scoring over the step-time fingerprints in
    ForwardPassMetrics flags it, quarantine soft-withdraws it (card stays
    in the hub, flagged), routers exclude it fail-open, in-flight streams
    migrate off through the existing re-drive path, the autoscaler counts
    it as zero capacity and spawns a replacement, and healing (the fault
    cleared + clean fingerprints) re-admits it and unwinds the
    replacement. Acceptance: quarantined within the dilated
    detection budget, ZERO client-visible errors end to end, TTFT p99
    back under the healthy baseline x1.5 after quarantine, desired
    workers +1 while quarantined."""
    import dataclasses

    from dynamo_tpu_torch.autoscaler import (
        AutoscaleController,
        AutoscalerConfig,
        FleetTelemetry,
        SimBackend,
    )
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.health import DegradationDetector, is_quarantined

    n = cfg.gray_workers
    fcfg = dataclasses.replace(
        cfg,
        workers=n,
        speedup=cfg.gray_speedup,
        max_batch_size=4,
        metrics_interval_s=0.05,
    )
    fleet = await MockFleet(fcfg, n).start()
    tel = FleetTelemetry(
        fleet.hub, f"{NS}/{COMP}", stale_after_s=2.0
    ).start()
    backend = SimBackend(fleet)
    ctrl = AutoscaleController(
        AutoscalerConfig(
            # demand never drives scaling here: capacity per worker is
            # set far above the offered load, so the ONLY mover is the
            # quarantine replacement overlay
            slots_per_worker=64,
            min_workers=n, max_workers=n + 2,
            up_cooldown_s=0.05, down_cooldown_s=60.0,
            tick_interval_s=0.05, predict_ahead_ticks=0,
        ),
        tel, backend, initial_workers=n,
    )
    detector = DegradationDetector(tolerance=3.0, min_peers=3)
    mig0 = migrations_snapshot()
    victim = fleet.workers[1]
    quarantined_at: list[float] = []
    readmitted: list[float] = []
    desired_peak = n
    stop = asyncio.Event()

    def _by_wid(wid: int) -> "object | None":
        for w in fleet.workers:
            if w.wid == wid:
                return w
        return None

    async def watchdog():
        """The fleet-side gray-failure plane: score fingerprints, flip
        cards. Same observe path the EPP uses (scheduler worker states
        fed by the kv_metrics subscription)."""
        nonlocal desired_peak
        while not stop.is_set():
            if fleet.kv_router is not None:
                for ws in fleet.kv_router.scheduler.workers():
                    detector.observe(ws.worker_id, ws.metrics.step_time_ms)
            scores = detector.scores()
            for wid, s in scores.items():
                w = _by_wid(wid)
                if w is None or not w.alive:
                    continue
                if s >= detector.tolerance and not w.quarantined:
                    await fleet.quarantine_worker(w, "degraded")
                    quarantined_at.append(time.monotonic())
                    tel.set_quarantined({wid})
                    log.warning(
                        "sim gray: worker %x quarantined (score %.1f)",
                        wid, s,
                    )
                elif w.quarantined and s < detector.tolerance:
                    await fleet.readmit_worker(w)
                    readmitted.append(time.monotonic())
                    tel.set_quarantined(set())
                    log.warning(
                        "sim gray: worker %x re-admitted (score %.1f)",
                        wid, s,
                    )
            await ctrl.tick()
            desired_peak = max(desired_peak, ctrl.engine.current()[0])
            await asyncio.sleep(0.02)

    async def probe_victim():
        """Keep the victim decoding so its fingerprint reflects reality
        (a gray worker is degraded, not idle)."""
        k = 0
        while not stop.is_set():
            k += 1
            ctx = Context(request_id=f"gray-probe-{k}")
            try:
                async for _ in victim.engine.generate(
                    {"token_ids": [7, 8, 9],
                     "stop_conditions": {"max_tokens": 4,
                                         "ignore_eos": True}},
                    ctx,
                ):
                    pass
            except Exception as exc:  # noqa: BLE001 — probe loss not the SUT
                log.debug("sim gray: probe request failed "
                          "(expected while degraded): %s", exc)
            await asyncio.sleep(0.02)

    try:
        engine = await fleet.client_path(migration=True)
        rate, reqs, osl = cfg.gray_rate_per_s, cfg.gray_requests, cfg.gray_osl

        # phase A: healthy baseline
        base = (await replay_trace(
            engine.generate,
            _mk_trace(cfg, "gray-base", requests=reqs, rate=rate, osl=osl,
                      groups=n, seed=cfg.seed),
            id_prefix="gray-base",
        )).summary()

        driver = asyncio.ensure_future(watchdog())
        prober = asyncio.ensure_future(probe_victim())

        # degrade ONE worker: sticky per-instance delay, sized to take
        # its dilated step time to gray_slowdown x the fleet's
        step_s = victim.engine.config.decode_step_s / cfg.gray_speedup
        delay_ms = (cfg.gray_slowdown - 1.0) * step_s * 1000.0
        FAULTS.configure(
            f"engine.step:delay={delay_ms:g}ms~{victim.fault_instance}"
        )
        t_degrade = time.monotonic()

        # phase B: traffic THROUGH the degradation + detection window
        degraded = (await replay_trace(
            engine.generate,
            _mk_trace(cfg, "gray-deg", requests=reqs, rate=rate, osl=osl,
                      groups=n, seed=cfg.seed + 1),
            id_prefix="gray-deg",
        )).summary()
        budget_wall = cfg.gray_detect_budget_s / cfg.gray_speedup
        deadline = t_degrade + 3 * budget_wall
        while not quarantined_at and time.monotonic() < deadline:
            await asyncio.sleep(0.01)

        # phase C: post-quarantine — victim excluded, replacement live
        served_before = victim.served_requests
        after = (await replay_trace(
            engine.generate,
            _mk_trace(cfg, "gray-after", requests=reqs, rate=rate, osl=osl,
                      groups=n, seed=cfg.seed + 2),
            id_prefix="gray-after",
        )).summary()
        victim_served_after_q = victim.served_requests - served_before
        desired_while_q = ctrl.engine.current()[0]

        # heal: clear the fault; the probe loop refreshes the fingerprint
        # and the watchdog re-admits on score decay
        FAULTS.clear()
        heal_deadline = time.monotonic() + 20 * budget_wall
        while not readmitted and time.monotonic() < heal_deadline:
            await asyncio.sleep(0.01)
        await ctrl.tick()  # unwind the replacement overlay
        desired_final = ctrl.engine.current()[0]
        victim_card = await fleet.hub.get(victim.served.instance.path)

        stop.set()
        await prober
        await driver
        migrations = migrations_snapshot() - mig0
    finally:
        FAULTS.clear()
        stop.set()
        await ctrl.close()
        await tel.close()
        await fleet.close()

    detect_dilated_s = (
        (quarantined_at[0] - t_degrade) * cfg.gray_speedup
        if quarantined_at else None
    )
    errors = base["errors"] + degraded["errors"] + after["errors"]
    base_p99 = base["ttft_ms_p99"] or 0.0
    after_p99 = after["ttft_ms_p99"] or 0.0
    return {
        "workers": n,
        "slowdown": cfg.gray_slowdown,
        "detect_dilated_s": (
            round(detect_dilated_s, 3) if detect_dilated_s else None
        ),
        "baseline_ttft_ms_p99": base_p99,
        "degraded_ttft_ms_p99": degraded["ttft_ms_p99"],
        "after_ttft_ms_p99": after_p99,
        "migrations": migrations,
        "victim_served_after_quarantine": victim_served_after_q,
        "desired_while_quarantined": desired_while_q,
        "desired_final": desired_final,
        "spawned": backend.spawned,
        "invariants": {
            "quarantined_within_budget": _inv(
                detect_dilated_s is not None
                and detect_dilated_s <= cfg.gray_detect_budget_s,
                detect_dilated_s=detect_dilated_s,
                budget_dilated_s=cfg.gray_detect_budget_s,
            ),
            "zero_client_errors": _inv(errors == 0, errors=errors),
            "ttft_recovered_after_quarantine": _inv(
                after_p99 <= 1.5 * base_p99,
                after_ms=after_p99, baseline_ms=base_p99,
            ),
            "victim_excluded_while_quarantined": _inv(
                victim_served_after_q == 0,
                served=victim_served_after_q,
            ),
            "autoscaler_replaced_quarantined": _inv(
                desired_while_q == n + 1 and backend.spawned >= 1,
                desired_while_quarantined=desired_while_q,
                spawned=backend.spawned,
            ),
            "readmitted_and_unwound": _inv(
                bool(readmitted)
                and not is_quarantined(victim_card or {})
                and desired_final == n,
                readmitted=bool(readmitted),
                desired_final=desired_final,
            ),
        },
    }


SCENARIOS = {
    "pick_scaling": pick_scaling,
    "leader_kill": leader_kill,
    "partition": partition,
    "churn": churn,
    "breaker_storm": breaker_storm,
    "tenant_storm": tenant_storm,
    "telemetry_overhead": telemetry,
    "autoscale": autoscale,
    "gray_failure": gray_failure,
}
