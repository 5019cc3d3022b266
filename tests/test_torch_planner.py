"""The port's SLA planner (dynamo_tpu_torch/planner/) against the reference's
(dynamo_tpu/planner/): the predictors and interpolators give the same float64
values bit for bit on the same series and profiles, ``compute_replicas`` and
``dryrun`` the same decisions on the same traces, the stdlib exposition
parser the dict prometheus_client's parser gives (the port frontend's own
/metrics and edge cases), ``FrontendMetricsSource.observe`` the same
``Metrics`` on the same scrapes, and the CLI's dryrun the same decisions.
Inputs come from numpy seeds."""

import asyncio
import json
import math
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.planner import connector as jax_connector
from dynamo_tpu.planner import core as jax_core
from dynamo_tpu.planner import interpolation as jax_interp
from dynamo_tpu.planner import predictor as jax_pred
from dynamo_tpu_torch.planner import connector, core, interpolation, predictor

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
KINDS = sorted(predictor.PREDICTORS)


def _series(seed: int, n: int = 90) -> list[float]:
    """A load series with leading idle, NaNs, a ramp, a burst and a cycle."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    x = 20 + 0.5 * t + 8 * np.sin(2 * np.pi * t / 12) + rng.normal(0, 3, n)
    x[40:48] += 60
    x = np.maximum(x, 0.0).tolist()
    x[:5] = [0.0] * 5
    for i in rng.choice(np.arange(6, n), 4, replace=False):
        x[int(i)] = float("nan")
    return x


@pytest.mark.parametrize("kind", KINDS)
def test_predictors_match_the_reference_bitwise(kind):
    kw = {"period": 12} if kind == "seasonal" else {}
    for seed in (0, 1):
        mine = predictor.make_predictor(kind, window_size=48, **kw)
        ref = jax_pred.make_predictor(kind, window_size=48, **kw)
        for v in _series(seed):
            mine.observe(v)
            ref.observe(v)
            assert mine.buf == ref.buf
            got = [mine.predict()] + [mine.predict_ahead(k) for k in (1, 2, 5)]
            want = [ref.predict()] + [ref.predict_ahead(k) for k in (1, 2, 5)]
            assert got == want, (kind, seed, got, want)
    with pytest.raises(ValueError, match="unknown predictor"):
        predictor.make_predictor("nope")


def _profile(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return interpolation.synthetic_profile(
        base_ttft_s=float(rng.uniform(0.02, 0.3)),
        ttft_per_token_s=float(rng.uniform(1e-5, 3e-4)),
        prefill_thpt_per_chip=float(rng.uniform(2e3, 2e4)),
        base_itl_s=float(rng.uniform(0.005, 0.03)),
        itl_per_kv_usage_s=float(rng.uniform(0.01, 0.08)),
        itl_per_context_s=float(rng.uniform(1e-7, 5e-6)),
        decode_thpt_at_full_kv=float(rng.uniform(1e3, 8e3)),
        max_kv_tokens=int(rng.integers(8192, 262144)),
        max_context=int(rng.integers(2048, 16384)),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolators_match_the_reference_bitwise(seed, tmp_path):
    prof = _profile(seed)
    # the profile through npz files in a directory, as --profile-dir reads it
    np.savez(tmp_path / "prefill.npz", **prof)
    np.savez(tmp_path / "decode.npz", **prof)
    rng = np.random.default_rng(100 + seed)
    for src in (prof, str(tmp_path)):
        pre, jpre = interpolation.PrefillInterpolator(src), jax_interp.PrefillInterpolator(src)
        dec, jdec = interpolation.DecodeInterpolator(src), jax_interp.DecodeInterpolator(src)
        for _ in range(40):
            isl = float(rng.uniform(0, 20000))
            assert pre.interpolate_ttft(isl) == jpre.interpolate_ttft(isl)
            assert pre.interpolate_thpt_per_chip(isl) == jpre.interpolate_thpt_per_chip(isl)
            conc, ctx = float(rng.uniform(0, 64)), float(rng.uniform(0, 20000))
            assert dec.interpolate_itl(conc, ctx) == jdec.interpolate_itl(conc, ctx)
            assert (dec.interpolate_thpt_per_chip(conc, ctx)
                    == jdec.interpolate_thpt_per_chip(conc, ctx))
            itl = float(rng.uniform(0.001, 0.12))
            assert (dec.find_best_throughput_per_chip(itl, ctx)
                    == jdec.find_best_throughput_per_chip(itl, ctx))


def test_synthetic_profile_matches_the_reference():
    for kw in ({}, {"max_kv_tokens": 4096, "max_context": 1024, "base_itl_s": 0.02}):
        got, want = interpolation.synthetic_profile(**kw), jax_interp.synthetic_profile(**kw)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


CONFIGS = [
    dict(),
    dict(max_chip_budget=3, min_endpoint=1, adjustment_interval_s=2.0),
    dict(max_chip_budget=9, prefill_engine_num_chips=2, decode_engine_num_chips=4,
         itl_sla_s=0.02, ttft_sla_s=0.2, min_endpoint=2),
    dict(max_chip_budget=64, adjustment_interval_s=10.0, predictor="holt",
         itl_sla_s=0.03),
]


def _planners(cfg_kw: dict, seed: int = 0, **cfg_extra):
    prof = _profile(seed)
    mine = core.SlaPlanner(core.PlannerConfig(**cfg_kw, **cfg_extra),
                           interpolation.PrefillInterpolator(prof),
                           interpolation.DecodeInterpolator(prof))
    ref = jax_core.SlaPlanner(jax_core.PlannerConfig(**cfg_kw, **cfg_extra),
                              jax_interp.PrefillInterpolator(prof),
                              jax_interp.DecodeInterpolator(prof))
    return mine, ref


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_compute_replicas_matches_the_reference(cfg):
    mine, ref = _planners(CONFIGS[cfg], seed=cfg)
    rng = np.random.default_rng(cfg)
    for _ in range(200):
        num_req = float(rng.choice([rng.uniform(0, 5), rng.uniform(0, 500),
                                    rng.uniform(0, 20000)]))
        isl, osl = float(rng.uniform(1, 8000)), float(rng.uniform(1, 2000))
        for corr in ((1.0, 1.0), (float(rng.uniform(0.3, 3)), float(rng.uniform(0.3, 3)))):
            mine.p_correction, mine.d_correction = corr
            ref.p_correction, ref.d_correction = corr
            assert (mine.compute_replicas(num_req, isl, osl)
                    == ref.compute_replicas(num_req, isl, osl))


def _trace(seed: int, n: int = 40) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {"num_req": float(max(0.0, 50 + 40 * math.sin(i / 4) + rng.normal(0, 10))),
               "isl": float(rng.uniform(100, 3000)), "osl": float(rng.uniform(20, 600))}
        if i % 3:
            rec |= {"ttft": float(rng.uniform(0.05, 0.9)), "itl": float(rng.uniform(0.005, 0.09)),
                    "request_duration": float(rng.uniform(1, 30))}
        if i == 7:
            rec["isl"] = 0.0  # an idle interval: no decision
        out.append(rec)
    return out


@pytest.mark.parametrize("case", [(c, corr) for c in range(len(CONFIGS))
                                  for corr in (False, True)])
async def test_dryrun_matches_the_reference(case):
    cfg, correction = case
    counts = {"n": 0}

    async def worker_counts():
        counts["n"] += 1
        return 1, 1 + counts["n"] % 3

    mine, ref = _planners(CONFIGS[cfg], seed=cfg, no_correction=not correction)
    mine.worker_counts = ref.worker_counts = worker_counts if correction else None
    trace = _trace(10 + cfg)
    got = await mine.dryrun(trace)
    counts["n"] = 0
    want = await ref.dryrun(trace)
    assert got == want
    assert (mine.p_correction, mine.d_correction) == (ref.p_correction, ref.d_correction)
    assert [asdict(d) for d in mine.decisions] == [asdict(d) for d in ref.decisions]
    assert [asdict(d) for d in mine.connector.history] == [
        asdict(d) for d in ref.connector.history]


# ------------------------------------------------------- exposition parser


def _library_dict(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _same(got: dict, want: dict) -> bool:
    """Equal dicts, NaN equal to NaN, ints to ints and floats to floats."""
    if got.keys() != want.keys():
        return False
    for k, v in got.items():
        w = want[k]
        if type(v) is not type(w):
            return False
        if not (v == w or (isinstance(v, float) and math.isnan(v) and math.isnan(w))):
            return False
    return True


EDGE_CASES = {
    "escapes": '# HELP a_total doc with \\\\ and \\n\n# TYPE a_total counter\n'
               'a_total{model="q\\"x\\\\y\\nz",route="chat"} 3\n',
    "counter_without_total": "# TYPE c counter\nc 4\nc_created 1.7e9\n",
    "histogram": '# TYPE h histogram\nh_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 2\n'
                 'h_sum 0.30000000000000004\nh_count 2\n',
    "summary": '# TYPE s summary\ns{quantile="0.5"} 1\ns_sum 2\ns_count 3\n',
    "special_values": "x NaN\ny +Inf\nz -Inf\nw 1e+06\nv -0.0\nu 12345678901234567890\n",
    "comments_timestamps": "# a comment\n\n#another\ng 7 1700000000000\n"
                           "g2{a=\"1\",} 2.5e-3 -12\n# HELP\ng3\t8\n",
    "untyped_interleaved": "# TYPE m gauge\nm 1\nm_other 2\nm 3\n",
    "label_spacing": 'k{ a = "1" , b="}" ,c="{,}"} 9\n',
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_parser_matches_prometheus_client_on_edge_cases(case):
    text = EDGE_CASES[case]
    assert _same(core.parse_prometheus_text(text), _library_dict(text))
    assert _same(core.parse_prometheus_text(text), jax_core.parse_prometheus_text(text))


def test_parser_matches_prometheus_client_on_the_port_registry():
    """The port's own exposition (runtime/metrics.py) with every metric kind,
    escaped label values and float edge values, parsed both ways."""
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    rng = np.random.default_rng(7)
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "requests", ["model", "route"])
    g = reg.gauge("inflight", 'in "flight"\\ now', ["model"])
    h = reg.histogram("ttft_seconds", "TTFT", ["model"])
    for model in ("m", 'q"uote', "back\\slash", "new\nline", "ünï"):
        c.labels(model, "chat").inc(float(rng.integers(0, 100)))
        g.labels(model).set(float(rng.normal()))
        for v in rng.exponential(0.3, 20):
            h.labels(model).observe(float(v))
    g.labels("inf").set(math.inf)
    g.labels("nan").set(math.nan)
    text = reg.render()
    assert _same(core.parse_prometheus_text(text), _library_dict(text))


def test_parser_rejects_malformed_lines():
    for bad in ('x{a="1"', 'x{a=1} 2', "x 1_000", "x", '# TYPE t\n', 'x{a="1",a="2"} 1'):
        with pytest.raises(ValueError):
            core.parse_prometheus_text(bad)


def _scrapes(seed: int, n: int = 5) -> list[str]:
    """Cumulative frontend expositions of two models over n scrapes."""
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    rng = np.random.default_rng(seed)
    reg = MetricsRegistry()
    ttft = reg.histogram("time_to_first_token_seconds", "TTFT", ["model"])
    itl = reg.histogram("inter_token_latency_seconds", "ITL", ["model"])
    dur = reg.histogram("request_duration_seconds", "request duration", ["model"])
    out_tok = reg.counter("output_tokens_total", "generated tokens", ["model"])
    in_tok = reg.counter("input_tokens_total", "prompt tokens", ["model"])
    done = reg.counter("requests_completed_total", "requests", ["model"])
    texts = []
    for i in range(n):
        for model in ("a", "b"):
            k = 0 if i == 2 else int(rng.integers(1, 20))  # scrape 2: idle
            for _ in range(k):
                done.labels(model).inc()
                in_tok.labels(model).inc(float(rng.integers(10, 900)))
                osl = int(rng.integers(1, 60))
                out_tok.labels(model).inc(osl)
                ttft.labels(model).observe(float(rng.uniform(0.01, 0.5)))
                for _ in range(osl - 1):
                    itl.labels(model).observe(float(rng.uniform(0.001, 0.05)))
                dur.labels(model).observe(float(rng.uniform(0.1, 3)))
        texts.append(reg.render())
    return texts


def _metrics_equal(a, b) -> bool:
    return all(x == y or (x is not None and y is not None and math.isnan(x) and math.isnan(y))
               for x, y in zip(asdict(a).values(), asdict(b).values()))


@pytest.mark.parametrize("model", [None, "a"])
async def test_metrics_source_observe_matches_the_reference(model):
    texts = _scrapes(3)

    class Mine(core.FrontendMetricsSource):
        async def fetch_text(self):
            return texts[self.i]

    class Ref(jax_core.FrontendMetricsSource):
        async def fetch_text(self):
            return texts[self.i]

    mine, ref = Mine("http://x/metrics", model), Ref("http://x/metrics", model)
    for i in range(len(texts)):
        mine.i = ref.i = i
        a, b = await mine.observe(), await ref.observe()
        assert _metrics_equal(a, b), (i, a, b)
        assert a.is_valid() == b.is_valid()


# ------------------------------------------------------------ http_get


async def test_http_get_reads_length_chunked_and_close_bodies():
    bodies = {"/len": b"content-length body \xc3\xbc",
              "/chunked": b"chunk one|chunk two|" * 50, "/close": b"to the end" * 100}

    async def handle(reader, writer):
        line = (await reader.readline()).decode()
        while (await reader.readline()).strip():
            pass
        path = line.split()[1]
        body = bodies.get(path.split("?")[0])
        if body is None:
            writer.write(b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n")
        elif path == "/len":
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
        elif path.startswith("/chunked"):
            writer.write(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n")
            for i in range(0, len(body), 77):
                part = body[i:i + 77]
                writer.write(b"%x;ext=1\r\n" % len(part) + part + b"\r\n")
            writer.write(b"0\r\n\r\n")
        else:
            writer.write(b"HTTP/1.0 200 OK\r\n\r\n" + body)
        await writer.drain()
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        for path, body in bodies.items():
            url = f"http://127.0.0.1:{port}{path}"
            assert await core.http_get(url + ("?q=1" if path == "/chunked" else "")) == (
                body.decode())
        with pytest.raises(ConnectionError, match="404"):
            await core.http_get(f"http://127.0.0.1:{port}/missing")
        with pytest.raises(ValueError):
            await core.http_get(f"https://127.0.0.1:{port}/len")
    finally:
        server.close()
        await server.wait_closed()


async def _post_stream(port: int, body: dict) -> int:
    """POST a streamed completion to the port frontend; the SSE data events."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 b"application/json\r\nConnection: close\r\nContent-Length: %d\r\n\r\n"
                 % len(data) + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    assert raw.startswith(b"HTTP/1.1 200"), raw[:200]
    assert b"data: [DONE]" in raw
    return raw.count(b"data: ")


async def test_live_scrape_of_the_port_frontend_matches_the_reference():
    """The port frontend over port mock workers: its /metrics fetched with
    http_get equals the aiohttp fetch, parses to prometheus_client's dict,
    and two scrapes around 4 streamed completions give the reference
    source's Metrics; a planner plans from them."""
    from dynamo_tpu_torch.frontend.http import HttpFrontend
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
    from dynamo_tpu_torch.mocker.engine import MockEngineConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    drt = DistributedRuntime(InMemoryHub())
    cfg = MockEngineConfig(block_size=4, total_kv_blocks=512, speedup_ratio=500.0)
    engine, _ = await launch_mock_worker(drt, "dyn", "backend", "generate", cfg,
                                         model_name="mock-model", register_card=True)
    manager = ModelManager()
    watcher = await ModelWatcher(drt, manager).start()
    await watcher.wait_for_model("mock-model", timeout=5)
    frontend = HttpFrontend(manager, host="127.0.0.1", port=0)
    await frontend.start()
    url = f"http://127.0.0.1:{frontend.port}/metrics"
    try:
        texts = []

        class Capture(core.FrontendMetricsSource):
            async def fetch_text(self):
                texts.append(await super().fetch_text())
                return texts[-1]

        src = Capture(url, "mock-model")
        await src.observe()
        for i in range(4):
            n = await _post_stream(frontend.port, {
                "model": "mock-model", "prompt": f"q{i} " * (i + 1), "max_tokens": 8,
                "stream": True, "ignore_eos": True})
            assert n >= 2
        m = await src.observe()
        assert m.num_req == 4 and m.osl == 8 and m.is_valid(), m
        import aiohttp

        async with aiohttp.ClientSession() as sess:
            async with sess.get(url) as resp:
                lib_text = await resp.text()
        assert _same(core.parse_prometheus_text(lib_text), _library_dict(lib_text))
        mine_text = await core.http_get(url)
        # the same exposition but for what the two fetches themselves moved
        assert core.parse_prometheus_text(mine_text).keys() == _library_dict(lib_text).keys()

        class Replay(jax_core.FrontendMetricsSource):
            async def fetch_text(self):
                return texts.pop(0)

        ref = Replay(url, "mock-model")
        await ref.observe()
        assert _metrics_equal(m, await ref.observe())
        prof = interpolation.synthetic_profile()
        pl = core.SlaPlanner(core.PlannerConfig(predictor="constant", no_correction=True),
                             interpolation.PrefillInterpolator(prof),
                             interpolation.DecodeInterpolator(prof))
        pl.ingest(m)
        desired = await pl.make_adjustments()
        assert desired is not None and desired.decode >= 1
    finally:
        await frontend.stop()
        await watcher.close()
        for pub in (engine.events, engine.metrics):
            await pub.close()
        await drt.close()


# ------------------------------------------------------------- connectors


async def test_virtual_connector_key_is_shared_with_the_reference():
    """The port writes the reference's document under the reference's key,
    revisioned; each package reads what the other wrote."""
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    hub = InMemoryHub()
    vc = connector.VirtualConnector(hub, "ns", model="m")
    await vc.set_replicas(connector.DesiredReplicas(prefill=1, decode=3))
    await vc.set_replicas(connector.DesiredReplicas(prefill=2, decode=1))
    raw = await hub.get(jax_connector.DESIRED_KEY.format(namespace="ns"))
    assert set(raw) == set(asdict(jax_connector.DesiredReplicas(0, 0)))
    got = await jax_connector.read_desired_replicas(hub, "ns")
    assert (got.prefill, got.decode, got.revision, got.model) == (2, 1, 2, "m")
    jvc = jax_connector.VirtualConnector(hub, "ns2")
    await jvc.set_replicas(jax_connector.DesiredReplicas(prefill=0, decode=4))
    mine = await connector.read_desired_replicas(hub, "ns2")
    assert asdict(mine) == asdict(await jax_connector.read_desired_replicas(hub, "ns2"))
    assert await connector.read_desired_replicas(hub, "absent") is None


async def test_process_connector_withdraws_before_draining():
    """ProcessConnector on the port's mock workers: 0 -> 2 -> 1 decode, the
    retiring worker's instance key leaves the hub before its engine is
    closed, and a stream in flight on it finishes."""
    from dynamo_tpu_torch.mocker.engine import MockEngineConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    drt = DistributedRuntime(InMemoryHub())
    conn = connector.ProcessConnector(
        drt, "dynamo", model_name="scale-model",
        mock_config=MockEngineConfig(block_size=4, total_kv_blocks=256, speedup_ratio=20.0))
    keys = lambda: drt.hub.get_prefix("v1/instances/dynamo/backend/")  # noqa: E731
    try:
        await conn.set_replicas(connector.DesiredReplicas(prefill=0, decode=2))
        assert conn.replica_counts() == {"prefill": 0, "decode": 2}
        assert len(await keys()) == 2
        engine, served = conn._workers["decode"][1]
        req = {"token_ids": list(range(40)),
               "stop_conditions": {"max_tokens": 24, "ignore_eos": True}}
        seen = []

        async def stream():
            async for item in engine.generate(req, Context()):
                seen.extend(item.get("token_ids", []))

        task = asyncio.create_task(stream())
        await asyncio.sleep(0.05)
        withdrawn_while_running = {}
        orig_close = engine.close if hasattr(engine, "close") else None

        async def spy_close():
            withdrawn_while_running["keys"] = len(await keys())
            if orig_close is not None:
                res = orig_close()
                if hasattr(res, "__await__"):
                    await res

        engine.close = spy_close
        await conn.set_replicas(connector.DesiredReplicas(prefill=0, decode=1))
        await asyncio.wait_for(task, 10)
        assert len(seen) == 24
        assert conn.replica_counts()["decode"] == 1
        assert withdrawn_while_running["keys"] == 1
        assert [d.decode for d in conn.history] == [2, 1]
    finally:
        await conn.close()
        await drt.close()


# ------------------------------------------------------------------- CLI


def _cli_args(**over):
    import argparse

    d = dict(hub=None, namespace="dynamo", model=None, metrics_url=None, ttft=0.4,
             itl=0.03, adjustment_interval=5.0, load_predictor="ar", min_endpoint=1,
             max_chip_budget=12, prefill_engine_num_chips=1, decode_engine_num_chips=2,
             no_correction=False, no_operation=False, connector="virtual",
             prefill_component="prefill", decode_component="backend",
             profile_dir=None, dryrun_trace=None)
    d.update(over)
    return argparse.Namespace(**d)


def test_build_planner_matches_the_reference(tmp_path):
    from dynamo_tpu.planner import __main__ as jax_main
    from dynamo_tpu_torch.planner import __main__ as main

    prof = _profile(5)
    np.savez(tmp_path / "prefill.npz", **prof)
    np.savez(tmp_path / "decode.npz", **prof)
    for over in ({}, {"profile_dir": str(tmp_path), "no_correction": True,
                      "load_predictor": "holt", "metrics_url": "http://h:1/metrics"}):
        mine, ref = main.build_planner(_cli_args(**over)), jax_main.build_planner(
            _cli_args(**over))
        assert asdict(mine.cfg) == asdict(ref.cfg)
        assert type(mine.connector).__name__ == type(ref.connector).__name__
        assert type(mine.pred_num_req).__name__ == type(ref.pred_num_req).__name__
        assert (mine.metrics_source is None) == (ref.metrics_source is None)
        np.testing.assert_array_equal(mine.decode.thpt, ref.decode.thpt)


async def test_worker_counts_read_the_instance_keys():
    """``worker_counts`` counts each component's serving instances, leaving
    out the admin endpoint, as the reference's."""
    from dynamo_tpu.planner import __main__ as jax_main
    from dynamo_tpu_torch.planner import __main__ as main
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    hub = InMemoryHub()
    for comp, ep, n in (("backend", "generate", 3), ("backend", "admin", 3),
                        ("prefill", "generate", 2), ("other", "generate", 5)):
        for i in range(n):
            await hub.put(f"v1/instances/dynamo/{comp}/{ep}/{i:x}", {"i": i})
    got = await main.build_planner(_cli_args(), hub=hub).worker_counts()
    want = await jax_main.build_planner(_cli_args(), hub=hub).worker_counts()
    assert got == want == (2, 3)


def test_cli_planner_dryrun_matches_the_reference(tmp_path):
    """``python -m dynamo_tpu_torch.cli planner --dryrun-trace`` prints the
    reference planner's decisions for the same trace and profile."""
    from dynamo_tpu.planner import __main__ as jax_main

    trace = _trace(21, 25)
    path = tmp_path / "trace.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in trace) + "\n")
    flags = ["--dryrun-trace", str(path), "--load-predictor", "constant",
             "--adjustment-interval", "10", "--max-chip-budget", "16",
             "--itl", "0.03"]
    proc = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.cli", "planner", *flags],
                          cwd=ROOT, capture_output=True, text=True, timeout=60,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    got = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    ref = jax_main.build_planner(_cli_args(load_predictor="constant", adjustment_interval=10.0,
                                           max_chip_budget=16, itl=0.03, ttft=0.5,
                                           decode_engine_num_chips=1))
    want = asyncio.run(ref.dryrun(trace))
    assert [(d["prefill"], d["decode"]) for d in got] == want
    assert [d["interval"] for d in got] == list(range(len(trace)))
