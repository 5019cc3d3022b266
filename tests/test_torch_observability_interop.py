"""Tracing and the flight recorder across packages over one TCP hub.

One JAX hub server; a JAX worker (``dynamo_tpu.engine.worker``) and a port
worker (``launch_engine_worker``), each under its own model name and
component; a JAX frontend and a port frontend, every piece on its own
RemoteHub. A request from the JAX frontend to the port worker, and one from
the port frontend to the JAX worker, each carry the client's
``traceparent``: both packages' span files then hold one trace per request,
in which the worker's ``worker.request`` is the child of the caller's
``transport.call``. Each frontend's ``GET /debug/timeline`` reads the other
package's worker through the admin ``timeline`` op.
"""

from __future__ import annotations

import asyncio
import json
import urllib.request

import pytest
import torch

import dynamo_tpu.runtime.flight as jflight
import dynamo_tpu.runtime.tracing as jtracing
import dynamo_tpu_torch.runtime.flight as tflight
import dynamo_tpu_torch.runtime.tracing as ttracing
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.worker import launch_engine_worker as jax_launch_engine_worker
from dynamo_tpu.frontend.http import HttpFrontend as JaxHttpFrontend
from dynamo_tpu.frontend.watcher import ModelManager as JaxModelManager
from dynamo_tpu.frontend.watcher import ModelWatcher as JaxModelWatcher
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu.runtime.hub_server import HubServer as JaxHubServer
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.worker import launch_engine_worker
from dynamo_tpu_torch.frontend.http import HttpFrontend
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub_client import RemoteHub

pytestmark = pytest.mark.integration

SPEC_KW = dict(vocab_size=272, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=8, dtype="float32")
CFG_KW = dict(page_size=4, num_pages=128, max_pages_per_seq=32, max_decode_slots=4,
              prefill_buckets=(32, 64, 128))
TRACES = {"jax->port": "0af7651916cd43dd8448eb211c80319c",
          "port->jax": "4bf92f3577b34da6a3ce929d0e0e4736"}
CLIENT_SPAN = "b7ad6b7169203331"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _post(port: int, model: str, trace_id: str):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"model": model, "max_tokens": 4, "temperature": 0,
                         "messages": [{"role": "user", "content": "trace me"}]}).encode(),
        headers={"Content-Type": "application/json",
                 "traceparent": f"00-{trace_id}-{CLIENT_SPAN}-01"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port: int, route: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=60) as r:
        return r.status, json.loads(r.read())


def _spans(path, trace_id):
    return [r for r in (json.loads(x) for x in path.read_text().splitlines())
            if r["trace_id"] == trace_id]


async def test_cross_package_traces_and_timelines(tmp_path):
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jtracing.set_trace_file(str(jpath))
    ttracing.set_trace_file(str(tpath))
    hub = JaxHubServer(port=0)
    await hub.start()
    addr = f"127.0.0.1:{hub.port}"
    jcfg, tcfg = JaxRuntimeConfig(hub_address=addr), RuntimeConfig(hub_address=addr)
    closers = []
    try:
        jworker = JaxRuntime(await JaxRemoteHub.connect(addr), jcfg)
        closers.append(jworker.close)
        jeng, _ = await jax_launch_engine_worker(
            jworker, component="jax-backend", model_name="jax-model",
            spec=JaxSpec(**SPEC_KW), engine_config=JaxEngineConfig(**CFG_KW),
            router_mode="round_robin")
        closers.insert(0, jeng.close)
        tworker = DistributedRuntime(await RemoteHub.connect(addr), tcfg)
        closers.append(tworker.close)
        teng, served = await launch_engine_worker(
            tworker, component="port-backend", model_name="port-model",
            spec=ModelSpec(**SPEC_KW), engine_config=EngineConfig(**CFG_KW),
            device="cpu", router_mode="round_robin")
        closers.insert(0, teng.close)
        assert served.instance.transport == "tcp"
        jfront = JaxRuntime(await JaxRemoteHub.connect(addr), jcfg)
        closers.append(jfront.close)
        jwatch = await JaxModelWatcher(jfront, JaxModelManager()).start()
        closers.insert(0, jwatch.close)
        tfront = DistributedRuntime(await RemoteHub.connect(addr), tcfg)
        closers.append(tfront.close)
        twatch = await ModelWatcher(tfront, ModelManager()).start()
        closers.insert(0, twatch.close)
        for watch in (jwatch, twatch):
            for model in ("jax-model", "port-model"):
                await watch.wait_for_model(model, timeout=10)
        jhttp = JaxHttpFrontend(jwatch.manager, host="127.0.0.1", port=0, drt=jfront)
        await jhttp.start()
        closers.insert(0, jhttp.stop)
        thttp = HttpFrontend(twatch.manager, host="127.0.0.1", port=0, drt=tfront)
        await thttp.start()
        closers.insert(0, thttp.stop)

        runs = {"jax->port": (jhttp.port, "port-model", jpath, tpath, jflight),
                "port->jax": (thttp.port, "jax-model", tpath, jpath, tflight)}
        for case, (port, model, front_path, worker_path, _f) in runs.items():
            status, body = await asyncio.to_thread(_post, port, model, TRACES[case])
            assert status == 200 and body["usage"]["completion_tokens"] == 4, case
        for case, (port, model, front_path, worker_path, _f) in runs.items():
            tid = TRACES[case]
            front = _spans(front_path, tid)
            worker = _spans(worker_path, tid)
            fnames = {r["span"]: r for r in front}
            wnames = {r["span"]: r for r in worker}
            assert {"http.request", "http.preprocess", "transport.call"} <= set(fnames), case
            assert {"worker.request", "engine.queue_wait", "engine.prefill",
                    "engine.decode"} <= set(wnames), case
            # one trace: the caller's transport.call parents worker.request
            assert fnames["http.request"]["parent_span_id"] == CLIENT_SPAN
            call = fnames["transport.call"]
            assert call["parent_span_id"] == fnames["http.request"]["span_id"]
            wr = wnames["worker.request"]
            assert wr["parent_span_id"] == call["span_id"], case
            for name, rec in wnames.items():
                if name.startswith("engine."):
                    assert rec["parent_span_id"] == wr["span_id"], (case, name)
            # the calling frontend's /debug/timeline reads the other
            # package's worker through the admin timeline op
            status, tl = await asyncio.to_thread(
                _get, port, f"/debug/timeline?request_id={wr['request_id']}")
            assert status == 200
            found = [w["timeline"] for comp in tl["results"].values()
                     for w in comp.values() if isinstance(w, dict) and w.get("found")]
            assert len(found) == 1, (case, tl)
            assert found[0]["trace_id"] == tid
            assert found[0]["finish_reason"] == "length"
            assert [e["name"] for e in found[0]["events"]] == ["admit", "first_token"]
            status, summary = await asyncio.to_thread(_get, port, "/debug/timeline?n=4")
            assert status == 200
            comps = summary["results"]
            assert {"dynamo/jax-backend", "dynamo/port-backend"} <= set(comps)
            for comp in comps.values():
                for w in comp.values():
                    assert w["ok"] and "recent" in w and "slowest" in w
    finally:
        for close in closers:
            await close()
        await hub.stop()
        jtracing.set_trace_file(None)
        ttracing.set_trace_file(None)
        jflight.FLIGHT.clear()
        tflight.FLIGHT.clear()
