"""The port's cluster sim (dynamo_tpu_torch/sim/) against the reference's
(dynamo_tpu/sim/).

- the smokes of tests/test_cluster_sim.py on the port: partition and
  churn (zero client-visible errors with migrations > 0, the WAL checker
  over the partitioned quorum hub) and gray_failure, each at <= 16 mock
  workers;
- sim/replay.py against benchmarks/replay.py: the same trace files, the
  same loaded requests, the same percentiles and summaries for a seed;
- the artifact: both packages' ``run_scenarios`` at one small config write
  artifacts with the same keys, every scenario passing in both;
- ``python -m dynamo_tpu_torch.sim`` writes its artifact where ``--out``
  says, and by default under build/sim/.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmarks import loadgen as jax_loadgen
from benchmarks import replay as jax_replay
from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineConfig
from dynamo_tpu_torch.runtime import framing
from dynamo_tpu_torch.runtime.hub_client import RemoteHub, failover_stats
from dynamo_tpu_torch.sim import replay
from dynamo_tpu_torch.sim.harness import SimConfig, run_scenarios

pytestmark = pytest.mark.integration

ROOT = Path(__file__).resolve().parents[1]


def _smoke_kw(**over) -> dict:
    base = dict(
        workers=10, speedup=400.0, block_size=8, worker_blocks=1024,
        trace_requests=160, churn_waves=2, churn_kill_frac=0.2,
        lease_s=0.3, commit_timeout_s=1.0, partition_window_s=1.2,
        storm_duration_s=3.0, picks=60, seed=3, fleet_sizes=(4, 8),
    )
    base.update(over)
    return base


# -- the smokes --------------------------------------------------------------


async def test_sim_smoke_partition_and_churn(tmp_path):
    """Churn must show zero client-visible errors with migrations > 0; the
    partition scenario must pass the WAL checker (no dual-lead, no committed
    fork) with every acked write durable across the heals."""
    cfg = SimConfig(**_smoke_kw(data_dir=str(tmp_path)))
    artifact = await run_scenarios(cfg, ["partition", "churn"])
    scen = artifact["scenarios"]

    part = scen["partition"]
    assert part["verdict"] == "pass", part
    assert part["invariants"]["cluster_invariants"]["pass"]
    assert part["invariants"]["no_acked_write_lost"]["pass"]
    assert part["commits_acked"] > 0

    ch = scen["churn"]
    assert ch["verdict"] == "pass", ch
    assert ch["errors"] == 0
    assert ch["migrations"] > 0
    assert ch["killed"] > 0 and ch["rejoined"] == ch["killed"]
    assert ch["requests"] == cfg.trace_n()
    assert ch["dilated_req_per_s"] > ch["req_per_s"]
    assert artifact["verdict"] == "pass"


async def test_sim_smoke_gray_failure(tmp_path):
    """A worker degraded to 10x step time is quarantined within the dilated
    detection budget with zero client-visible errors, excluded while
    quarantined, replaced by the autoscaler (+1 desired) and re-admitted
    once it heals."""
    cfg = SimConfig(**_smoke_kw(data_dir=str(tmp_path), gray_requests=24,
                                gray_rate_per_s=60.0))
    artifact = await run_scenarios(cfg, ["gray_failure"])
    out = artifact["scenarios"]["gray_failure"]
    assert out["verdict"] == "pass", out
    inv = out["invariants"]
    assert inv["quarantined_within_budget"]["pass"], inv
    assert out["detect_dilated_s"] <= cfg.gray_detect_budget_s
    assert inv["zero_client_errors"]["pass"], inv
    assert inv["ttft_recovered_after_quarantine"]["pass"], inv
    assert out["victim_served_after_quarantine"] == 0
    assert out["desired_while_quarantined"] == out["workers"] + 1
    assert out["spawned"] >= 1
    assert out["desired_final"] == out["workers"]


async def test_hub_client_redirect_and_backoff_metrics():
    """A not_leader bounce increments dynamo_hub_redirects_total{reason}
    and the chase's sleep lands in dynamo_hub_backoff_seconds."""
    bounces = {"n": 0}

    async def handle(reader, writer):
        while True:
            msg = await framing.read_frame(reader)
            if msg is None:
                break
            if msg.get("op") == "put" and bounces["n"] < 2:
                bounces["n"] += 1
                await framing.write_frame(writer, {
                    "id": msg["id"], "ok": False, "error": "not_leader",
                    "leader": None,
                })
            else:
                await framing.write_frame(writer, {
                    "id": msg["id"], "ok": True, "result": None,
                })
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    before = failover_stats()
    client = await RemoteHub.connect(f"127.0.0.1:{port}", reconnect_window_s=10.0)
    try:
        await client.put("k", 1)
    finally:
        await client.close()
        server.close()
        await server.wait_closed()
    after = failover_stats()
    assert after.get("not_leader", 0) - before.get("not_leader", 0) >= 2
    assert after.get("backoff_count", 0) - before.get("backoff_count", 0) >= 2
    assert after.get("backoff_sum_s", 0) > before.get("backoff_sum_s", 0)
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    text = MetricsRegistry().exposition().decode()
    assert "dynamo_hub_redirects_total" in text
    assert "dynamo_hub_backoff_seconds" in text


async def test_http_session_reuses_and_redials_connections():
    """The sim's HTTP client (runtime/http_client.HttpSession): requests
    reuse an idle keep-alive connection, a server that closed an idle one is
    redialled once, ``Connection: close`` retires it, and bodies of every
    framing (length, chunked) come back whole."""
    from dynamo_tpu_torch.runtime.http_client import HttpSession

    conns = []

    async def handle(reader, writer):
        conns.append(writer)
        served = 0
        while True:
            line = await reader.readline()
            if not line:
                break
            headers = {}
            while (h := (await reader.readline()).strip()):
                k, _, v = h.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            body = await reader.readexactly(int(headers.get("content-length", 0)))
            served += 1
            path = line.split()[1].decode()
            if path == "/chunked":
                writer.write(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                             b"3\r\nabc\r\n2\r\nde\r\n0\r\n\r\n")
            else:
                close = path == "/close"
                writer.write(b"HTTP/1.1 201 Created\r\nContent-Length: %d\r\n%s\r\n%s" % (
                    len(body), b"Connection: close\r\n" if close else b"", body))
                if close:
                    await writer.drain()
                    break
            await writer.drain()
            if path == "/drop-after":  # answered, then the idle connection dies
                break
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        async with HttpSession("127.0.0.1", port) as sess:
            assert await sess.request("POST", "/a", {"x": 1}) == (201, b'{"x": 1}')
            assert await sess.request("GET", "/chunked") == (200, b"abcde")
            assert len(conns) == 1  # both on one connection
            assert (await sess.request("POST", "/drop-after", [1]))[0] == 201
            await asyncio.sleep(0.05)
            assert await sess.request("POST", "/b", "y") == (201, b'"y"')  # redialled
            assert len(conns) == 2
            assert (await sess.request("POST", "/close", {}))[0] == 201
            assert await sess.request("POST", "/c", 2) == (201, b"2")
            assert len(conns) == 3
    finally:
        server.close()
        await server.wait_closed()


# -- sim/replay.py against benchmarks/replay.py ------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_replay_traces_equal_the_reference(tmp_path, seed):
    """The same seed writes byte-equal trace files (Poisson and wave),
    loads them to equal requests, and pct_ms / summarize agree."""
    rng = np.random.default_rng(seed)
    kw = dict(requests=int(rng.integers(20, 200)), block_size=int(rng.choice([4, 8, 16])),
              groups=int(rng.integers(2, 20)), rate_per_s=float(rng.uniform(5, 500)),
              osl=int(rng.integers(1, 40)), seed=seed)
    wave = dict(duration_s=float(rng.uniform(1, 6)), base_rate=float(rng.uniform(2, 20)),
                peak_rate=float(rng.uniform(20, 60)), spike_rate=float(rng.uniform(0, 80)),
                block_size=kw["block_size"], osl=kw["osl"], seed=seed)
    for name, fn, args in (("t", "synthesize_trace", kw),
                           ("w", "synthesize_wave_trace", wave)):
        mine, ref = tmp_path / f"{name}.port.jsonl", tmp_path / f"{name}.ref.jsonl"
        getattr(replay, fn)(str(mine), **args)
        getattr(jax_replay, fn)(str(ref), **args)
        assert mine.read_bytes() == ref.read_bytes()
        assert replay.load_trace(str(mine), kw["block_size"]) == jax_replay.load_trace(
            str(ref), kw["block_size"])
    samples = [list(rng.exponential(0.05, int(rng.integers(0, 50)))) for _ in range(8)] + [[]]
    for xs in samples:
        for p in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert replay.pct_ms(xs, p) == jax_loadgen.pct_ms(xs, p)
    results = [{"ttft": None if i % 7 == 0 else float(rng.uniform(0, 0.2)),
                "itl": [float(x) for x in rng.uniform(0, 0.01, 3)],
                "cached": int(rng.integers(0, 4)), "blocks": int(rng.integers(1, 6)),
                "duration": float(rng.uniform(0, 1)), "error": None} for i in range(30)]
    mine = replay.ReplayResult(results=results, errors=["x"], elapsed_s=1.25)
    ref = jax_replay.ReplayResult(results=results, errors=["x"], elapsed_s=1.25)
    assert mine.summary() == ref.summary()
    assert mine.itls() == ref.itls() and mine.ttfts() == ref.ttfts()


async def test_replay_over_a_mock_engine(tmp_path):
    """An open-loop replay over a bare port mock engine: the full summary
    schema, and a dead-on-arrival deadline recorded as an error, not
    raised out of the replay loop."""
    path = tmp_path / "t.jsonl"
    replay.synthesize_trace(str(path), requests=24, block_size=4, osl=2, rate_per_s=500.0)
    trace = replay.load_trace(str(path), 4)
    assert len(trace) == 24
    eng = MockEngine(MockEngineConfig(block_size=4, total_kv_blocks=256,
                                      speedup_ratio=2000.0, seed=1))
    res = await replay.replay_trace(eng.generate, trace, id_prefix="rp")
    assert res.errors == []
    s = res.summary()
    assert s["requests"] == 24 and s["errors"] == 0
    for key in ("req_per_s", "ttft_ms_p50", "ttft_ms_p99", "ttft_ms_mean",
                "prefix_hit_rate"):
        assert s[key] is not None
    res2 = await replay.replay_trace(eng.generate, trace[:4],
                                     headers={"x-dyn-deadline-ms": "0"}, id_prefix="rpx")
    assert len(res2.errors) == 4


# -- the artifact --------------------------------------------------------------


def _keys(obj):
    """The key tree of an artifact: dicts by key, lists by their first item."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], (dict, list)):
        return [_keys(obj[0])]
    return None


async def test_sim_artifact_has_the_reference_keys(tmp_path):
    """Both packages' sims at one small config: the artifacts have the same
    keys (config, per-scenario figures, invariants and their details), and
    every invariant that does not compare two latencies holds in both
    (pick_scaling's flatness and pickline-vs-HTTP bars are timings of a
    loaded test host)."""
    from dynamo_tpu.sim.harness import SimConfig as JaxSimConfig
    from dynamo_tpu.sim.harness import run_scenarios as jax_run_scenarios

    names = ["pick_scaling", "churn", "breaker_storm", "telemetry_overhead"]
    mine = await run_scenarios(SimConfig(**_smoke_kw(data_dir=str(tmp_path / "p"))), names)
    ref = await jax_run_scenarios(JaxSimConfig(**_smoke_kw(data_dir=str(tmp_path / "r"))),
                                  names)
    timed = {("pick_scaling", "pick_latency_flat"), ("pick_scaling", "pickline_beats_http")}
    for art in (mine, ref):
        failed = {(n, k): v for n, sc in art["scenarios"].items()
                  for k, v in sc.get("invariants", {"error": {"pass": False, **sc}}).items()
                  if not v["pass"] and (n, k) not in timed}
        assert not failed, failed
    assert mine["schema"] == ref["schema"] == "dynamo-sim/v1"
    assert {**mine["config"], "data_dir": None} == {**ref["config"], "data_dir": None}
    assert _keys(mine) == _keys(ref)


def test_sim_cli_writes_its_artifact(tmp_path):
    """``python -m dynamo_tpu_torch.sim`` exits 0 on a passing run and
    writes the artifact ``--out`` names; the default is under build/sim/."""
    from dynamo_tpu_torch.sim import __main__ as sim_main

    assert Path(sim_main.DEFAULT_OUT).parts[:2] == ("build", "sim")
    out = tmp_path / "deep" / "SIM.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.sim", "--scenario", "telemetry_overhead",
         "--workers", "4", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "verdict": "pass", "artifact": str(out)}
    art = json.loads(out.read_text())
    assert list(art["scenarios"]) == ["telemetry_overhead"]
    assert art["config"]["workers"] == 4


# -- the full matrix -----------------------------------------------------------


@pytest.mark.slow
@pytest.mark.e2e
async def test_sim_full_matrix(tmp_path):
    """All scenarios at 100s-of-workers scale (``python -m
    dynamo_tpu_torch.sim --scenario all --workers 200`` writes the same
    artifact)."""
    cfg = SimConfig(
        workers=200, speedup=50.0, data_dir=str(tmp_path),
        storm_duration_s=6.0, partition_window_s=2.5,
    )
    from dynamo_tpu_torch.sim.scenarios import SCENARIOS

    artifact = await run_scenarios(cfg, list(SCENARIOS))
    failed = {
        n: s for n, s in artifact["scenarios"].items()
        if s["verdict"] != "pass"
    }
    assert not failed, failed
    curve = artifact["scenarios"]["pick_scaling"]["curve"]
    assert len(curve) >= 3 and curve[-1]["instances"] >= 200
