"""The port's operator (dynamo_tpu_torch/operator/) against the reference's
(dynamo_tpu/operator/): the graph resource's documents, the Reconciler's
scale, delete and prune calls and status write-backs against a recording
backend, the rendered manifests, the argv and stdin that KubectlBackend and
CrdSync send to a fake ``kubectl``, ProcessBackend's replicas, the
planner-to-operator loop across the packages over one TCP hub, and the
scaling plane as a whole: a port hub, frontend, operator and planner, each
a process, scaling ``--device cpu`` tiny-test workers 1 -> 2 -> 1 under a
burst with every request completed."""

import asyncio
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from dynamo_tpu.operator import backends as jax_backends
from dynamo_tpu.operator import controller as jax_controller
from dynamo_tpu.operator import crd_sync as jax_crd_sync
from dynamo_tpu.operator import graph as jax_graph
from dynamo_tpu.operator import manifests as jax_manifests
from dynamo_tpu.planner import connector as jax_connector
from dynamo_tpu_torch.operator import backends, controller, crd_sync, graph, manifests
from dynamo_tpu_torch.planner import connector
from dynamo_tpu_torch.runtime.hub import InMemoryHub

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"port": (graph, controller, backends, manifests, crd_sync, connector),
        "ref": (jax_graph, jax_controller, jax_backends, jax_manifests, jax_crd_sync,
                jax_connector)}


def _random_services(g, rng, n: int) -> list:
    roles = ["", "prefill", "decode", "router"]
    out = []
    for i in range(n):
        out.append(g.ServiceSpec(
            name=f"svc{i}", replicas=int(rng.integers(0, 5)),
            command=["-m", f"mod{i}", "--flag", str(int(rng.integers(0, 99)))],
            component=str(rng.choice(["backend", "prefill", "frontend"])),
            role=roles[int(rng.integers(0, 4))],
            port=int(rng.choice([0, 0, 8000 + i])),
            env={f"K{j}": f"v{int(rng.integers(0, 9))}" for j in range(int(rng.integers(0, 3)))},
            hosts=int(rng.choice([1, 1, 2, 4]))))
    return out


def test_graph_documents_match_the_reference():
    rng = np.random.default_rng(0)
    hub = InMemoryHub()
    for seed in range(4):
        mine = graph.DynamoGraphDeployment(
            name=f"g{seed}", namespace="ns", services=_random_services(graph, rng, 3),
            revision=seed)
        d = mine.to_dict()
        ref = jax_graph.DynamoGraphDeployment.from_dict(d)
        assert ref.to_dict() == d
        assert graph.DynamoGraphDeployment.from_dict(ref.to_dict()).to_dict() == d
        assert mine.key == ref.key
    assert (graph.DGD_KEY, graph.DGD_STATUS_KEY) == (jax_graph.DGD_KEY, jax_graph.DGD_STATUS_KEY)

    async def roundtrip():
        dgd = graph.DynamoGraphDeployment(name="x", services=_random_services(graph, rng, 2))
        await dgd.apply(hub)
        got = await jax_graph.DynamoGraphDeployment.get(hub, "x")
        assert got.to_dict() == dgd.to_dict() and got.revision == 1
        await got.apply(hub)
        assert (await graph.DynamoGraphDeployment.get(hub, "x")).revision == 2

    asyncio.run(roundtrip())


# ---------------------------------------------------------------- reconciler


class _Recording:
    """A backend that records every call and reports what it was told."""

    def __init__(self, calls: list, delete: bool = True):
        self.calls = calls
        self.live: dict[str, int] = {}
        if delete:
            self.delete = self._delete
            self.prune = self._prune

    def running(self, service: str) -> int:
        return self.live.get(service, 0)

    async def scale(self, spec, replicas: int) -> None:
        self.calls.append(("scale", spec.name, replicas, spec.role, dict(spec.env)))
        self.live[spec.name] = replicas

    async def _delete(self, spec) -> None:
        self.calls.append(("delete", spec.name))
        self.live.pop(spec.name, None)

    async def _prune(self, current: set) -> None:
        self.calls.append(("prune", sorted(current)))

    async def close(self) -> None:
        self.calls.append(("close",))


async def _reconcile_story(pkg: str, delete: bool, planner: bool) -> list:
    """One sequence of resource edits, planner writes and backend drift,
    reconciled pass by pass; the backend's calls and every status."""
    g, ctl, _b, _m, _c, conn = PKGS[pkg]
    hub = InMemoryHub()
    calls: list = []
    be = _Recording(calls, delete=delete)
    rec = ctl.Reconciler(hub, "g", be, apply_planner_desired=planner)
    statuses: list = []

    async def step(note: str):
        out = await rec.reconcile_once()
        calls.append(("pass", note, None if out is None else out.revision))
        statuses.append(await hub.get(g.DGD_STATUS_KEY.format(name="g")))

    dgd = g.DynamoGraphDeployment(name="g", namespace="ns", services=[
        g.ServiceSpec(name="prefill", replicas=2, command=["-m", "p"], role="prefill"),
        g.ServiceSpec(name="decode", replicas=1, command=["-m", "d"], role="decode"),
        g.ServiceSpec(name="frontend", replicas=1, command=["-m", "f"], port=8000),
    ])
    await step("no resource")
    await dgd.apply(hub)
    await step("created")
    await step("converged")
    vc = conn.VirtualConnector(hub, "ns")
    await vc.set_replicas(conn.DesiredReplicas(prefill=1, decode=3))
    await step("planner 1/3")
    be.live["decode"] = 2  # a replica crashed
    await step("drift")
    dgd.services[1].env = {"NEW": "1"}
    await dgd.apply(hub)
    await step("env edit")
    dgd.services = dgd.services[:2]
    await dgd.apply(hub)
    await step("frontend removed")
    await vc.set_replicas(conn.DesiredReplicas(prefill=0, decode=1))
    await step("planner 0/1")
    await hub.delete(g.DGD_KEY.format(name="g"))
    await step("deleted")
    await step("deleted again")
    await rec.close()
    return [calls, statuses, rec.reconciles]


@pytest.mark.parametrize("delete", [True, False])
@pytest.mark.parametrize("planner", [True, False])
async def test_reconciler_calls_match_the_reference(delete, planner):
    assert (await _reconcile_story("port", delete, planner)
            == await _reconcile_story("ref", delete, planner))


async def test_reconciler_wakes_on_a_resource_edit():
    """start(): the hub watch wakes the loop on an edit, long before its
    interval; close() closes the backend."""
    hub = InMemoryHub()
    calls: list = []
    rec = await controller.Reconciler(hub, "g", _Recording(calls), interval_s=30.0).start()
    try:
        dgd = graph.DynamoGraphDeployment(name="g", services=[
            graph.ServiceSpec(name="decode", replicas=2, command=["-m", "d"], role="decode")])
        await asyncio.sleep(0.05)
        await dgd.apply(hub)  # the watch wakes the loop: no 30 s wait
        await _wait_until(lambda: ("scale", "decode", 2, "decode", {}) in calls, 5)
        rec._wake.set()
        status = {}

        async def ready():
            status.update(await hub.get(graph.DGD_STATUS_KEY.format(name="g")) or {})
            return status.get("ready")

        t0 = time.monotonic()
        while not await ready():
            assert time.monotonic() - t0 < 5
            await asyncio.sleep(0.02)
        assert status["services"]["decode"] == {"desired": 2, "ready": 2}
    finally:
        await rec.close()
    assert calls[-1] == ("close",)


# ----------------------------------------------------------------- manifests


@pytest.mark.parametrize("seed", range(4))
def test_manifests_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for svc in _random_services(graph, rng, 4):
        ref_svc = jax_graph.ServiceSpec(**asdict(svc))
        kw = dict(graph="g1", namespace="prod", image="img:v1", hub="hub:9000",
                  name_format=str(rng.choice(["dynamo-{service}", "x-{service}-y"])),
                  python=str(rng.choice(["python", "python3"])))
        n = int(rng.integers(0, 4))
        assert manifests.render_bundle(svc, n, **kw) == jax_manifests.render_bundle(
            ref_svc, n, **kw)
        assert manifests.render_multihost_bundle(svc, n, **kw) == (
            jax_manifests.render_multihost_bundle(ref_svc, n, **kw))
        assert manifests.deployment_manifest(svc, n, **kw) == (
            jax_manifests.deployment_manifest(ref_svc, n, **kw))
        kw2 = {k: kw[k] for k in ("graph", "namespace", "name_format")}
        assert manifests.service_manifest(svc, **kw2) == jax_manifests.service_manifest(
            ref_svc, **kw2)
        assert manifests.multihost_manifests(svc, 1, **kw) == (
            jax_manifests.multihost_manifests(ref_svc, 1, **kw))
    assert manifests.probe_manifests(8000) == jax_manifests.probe_manifests(8000)
    for name in ("GRAPH_LABEL", "SERVICE_LABEL", "HOST_INDEX_LABEL", "COORDINATOR_PORT"):
        assert getattr(manifests, name) == getattr(jax_manifests, name)


def test_multihost_command_is_the_port_workers_flags():
    """The Indexed Job's command ends with the coordinator flags that the
    port's worker parses (parallel/multihost.py's, through the worker)."""
    from dynamo_tpu_torch.engine.worker import parse_args

    svc = graph.ServiceSpec(name="mh", replicas=1, hosts=2,
                            command=["-m", "dynamo_tpu_torch.engine.worker", "--tp", "2"])
    job = next(i for i in manifests.render_bundle(
        svc, 1, graph="g", namespace="n", image="i", hub="h")["items"] if i["kind"] == "Job")
    argv = job["spec"]["template"]["spec"]["containers"][0]["command"][3:]
    args = parse_args([a.replace("$(JOB_COMPLETION_INDEX)", "1") for a in argv])
    assert (args.coordinator_address, args.num_processes, args.process_id) == (
        "dynamo-mh-0-0.dynamo-mh-0:9876", 2, 1)


# ------------------------------------------------------- kubectl and the CRD


FAKE_KUBECTL = """#!{python}
import json, os, sys, time
d = os.path.dirname(os.path.abspath(__file__))
argv = sys.argv[1:]
stdin = sys.stdin.read() if "apply" in argv else None
with open(os.path.join(d, "calls.jsonl"), "a") as f:
    f.write(json.dumps({{"argv": argv, "stdin": stdin}}) + "\\n")
mode = open(os.path.join(d, "mode")).read().strip()
line = " ".join(argv)
if "apply" in argv and mode == "immutable":
    print("Job.batch invalid: field is immutable", file=sys.stderr)
    sys.exit(1)
if "dynamographdeployments" in argv and "-w" in argv:
    sys.stdout.write(open(os.path.join(d, "crd.json")).read())
    sys.stdout.flush()
    time.sleep(60)
elif "-w" in argv:
    pos = 0
    while True:
        data = open(os.path.join(d, "events.txt")).read()
        sys.stdout.write(data[pos:])
        sys.stdout.flush()
        pos = len(data)
        time.sleep(0.02)
elif "get" in argv and "jobs" in argv and "host-index" in line:
    print("0\\n1\\n2")
elif "get" in argv and "jobs" in argv and "status.ready" in line:
    print("2\\n1")
elif "get" in argv and ("deployments" in argv or "jobs" in argv) and "-l" in argv:
    print("decode\\nold-prefill")
elif "get" in argv and "deployment" in argv:
    print(3, end="")
"""


@pytest.fixture
def kubectl(tmp_path, monkeypatch):
    path = tmp_path / "kubectl"
    path.write_text(FAKE_KUBECTL.format(python=sys.executable))
    path.chmod(0o755)
    (tmp_path / "mode").write_text("ok")
    (tmp_path / "events.txt").write_text("ADDED frontend 2\n")
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ.get('PATH', '')}")

    def take() -> list[dict]:
        f = tmp_path / "calls.jsonl"
        calls = [json.loads(ln) for ln in f.read_text().splitlines()] if f.exists() else []
        f.write_text("")
        return calls

    take.dir = tmp_path
    return take


async def _kubectl_story(pkg: str, kubectl) -> list:
    g, _c, b, _m, _s, _n = PKGS[pkg]
    out: list = []
    (kubectl.dir / "mode").write_text("ok")
    scale_only = b.KubectlBackend(namespace="prod")
    out.append(("running", scale_only.running("decode")))
    await scale_only.scale(g.ServiceSpec(name="decode", replicas=1, command=["-m", "w"]), 5)
    await scale_only.prune({"decode"})  # scale-only mode prunes nothing
    out.append(kubectl())
    be = b.KubectlBackend(namespace="prod", image="img:v1", hub="hub:9000", graph="g1",
                          python="python3")
    front = g.ServiceSpec(name="frontend", replicas=1, command=["-m", "f"], port=8000,
                          env={"DYN_LOG": "info"})
    await be.scale(front, 4)
    await be.scale(g.ServiceSpec(name="decode", replicas=1, command=["-m", "d"]), 2)
    await be.delete(front)
    await be.prune({"decode"})
    out.append(kubectl())
    mh = g.ServiceSpec(name="mh", replicas=2, hosts=2, role="decode", command=["-m", "w"])
    await be.scale(mh, 2)
    out.append(("running mh", be.running("mh")))
    (kubectl.dir / "mode").write_text("immutable")
    await be.scale(mh, 2)
    (kubectl.dir / "mode").write_text("ok")
    await be.delete(mh)
    await b.KubectlBackend(namespace="prod").scale(mh, 1)  # multihost needs an image
    out.append(kubectl())
    await be.close()
    return out


async def test_kubectl_backend_sends_the_reference_argv_and_stdin(kubectl):
    mine = await _kubectl_story("port", kubectl)
    ref = await _kubectl_story("ref", kubectl)
    assert mine == ref
    flat = [c for part in mine if isinstance(part, list) for c in part]
    assert any(c["argv"][-2:] == ["-f", "-"] and json.loads(c["stdin"])["kind"] == "List"
               for c in flat)
    assert mine[0] == ("running", 3) and ("running mh", 1) in mine


async def _watch_story(pkg: str, kubectl) -> list:
    b = PKGS[pkg][2]
    (kubectl.dir / "events.txt").write_text("ADDED frontend 2\n")
    kubectl()
    be = b.KubectlBackend(namespace="prod", image="img", graph="g1")
    wakes: list = []
    seen = []
    await be.start_watch(lambda: wakes.append(1))
    for event, want in ((None, {"frontend": 2}), ("MODIFIED frontend 5\n", {"frontend": 5}),
                        ("ADDED decode\n", {"frontend": 5, "decode": 0}),
                        ("DELETED frontend 5\n", {"decode": 0})):
        if event is not None:
            with open(kubectl.dir / "events.txt", "a") as f:
                f.write(event)
        t0 = time.monotonic()
        while be._observed != want:
            assert time.monotonic() - t0 < 10, (pkg, event, be._observed)
            await asyncio.sleep(0.02)
        seen.append((be.running("frontend"), be.running("decode"), len(wakes)))
    calls = kubectl()
    await be.close()
    return [seen, calls[0]["argv"], len(calls)]


async def test_kubectl_watch_matches_the_reference(kubectl):
    mine = await _watch_story("port", kubectl)
    assert mine == await _watch_story("ref", kubectl)
    assert mine[2] == 1  # one watch stream; running() read the cache


async def _crd_story(pkg: str, kubectl) -> list:
    g, _c, _b, _m, cs, _n = PKGS[pkg]
    crd = {"apiVersion": "dynamo.tpu/v1alpha1", "kind": "DynamoGraphDeployment",
           "metadata": {"name": "g1", "namespace": "prod"},
           "spec": {"envs": {"DYN_LOG": "info"}, "services": {
               "decode": {"replicas": 3, "role": "decode", "command": ["-m", "w"]},
               "frontend": {"replicas": 1, "command": ["-m", "f"], "port": 8000,
                            "env": {"A": "1"}}}}}
    # two documents back to back, the second a no-op status update
    (kubectl.dir / "crd.json").write_text(json.dumps(crd) + "\n" + json.dumps(
        {**crd, "status": {"state": "pending"}}))
    kubectl()
    hub = InMemoryHub()
    sync = await cs.CrdSync(hub, "g1", namespace="prod").start()
    t0 = time.monotonic()
    while sync.synced_revisions < 1:
        assert time.monotonic() - t0 < 10
        await asyncio.sleep(0.02)
    await asyncio.sleep(0.2)
    dgd = await g.DynamoGraphDeployment.get(hub, "g1")
    for ready in (False, True):
        await hub.put(g.DGD_STATUS_KEY.format(name="g1"), {
            "revision": dgd.revision, "ready": ready,
            "services": {"decode": {"desired": 3, "ready": 3 if ready else 1}}})
        t0 = time.monotonic()
        while sum("patch" in c for c in (kubectl.dir / "calls.jsonl").read_text().splitlines()
                  ) < 1 + ready:
            assert time.monotonic() - t0 < 10
            await asyncio.sleep(0.02)
    calls = kubectl()
    await sync.close()
    translated = [asdict(s) for s in cs.services_from_crd(crd["spec"])]
    return [dgd.to_dict(), sync.synced_revisions, [c["argv"] for c in calls], translated]


async def test_crd_sync_matches_the_reference(kubectl):
    mine = await _crd_story("port", kubectl)
    assert mine == await _crd_story("ref", kubectl)
    assert mine[1] == 1 and mine[0]["revision"] == 1
    patches = [a for a in mine[2] if "patch" in a]
    assert json.loads(patches[1][-1])["status"]["state"] == "successful"


# ----------------------------------------------------------- process backend


FAKE_WORKER = (
    "import os, signal, sys, time\n"
    "print('up', os.environ.get('MARK'), flush=True)\n"
    "def stop(*_):\n"
    "    time.sleep(0.3)\n"
    "    print('drained', flush=True)\n"
    "    sys.exit(0)\n"
    "signal.signal(signal.SIGTERM, stop)\n"
    "while True:\n"
    "    time.sleep(0.05)\n"
)


async def _wait_until(cond, timeout: float = 10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout
        await asyncio.sleep(0.02)


async def test_process_backend_spawns_respawns_and_drains(tmp_path, caplog):
    """One process per replica with the service's env; a crashed replica is
    forgotten and respawned by the next scale (as the reference's); a
    scale-down SIGTERMs the highest index, whose exit is logged with its
    drain time; output lands in the log dir; close() waits for all."""
    import logging

    caplog.set_level(logging.INFO, logger="dynamo.operator")
    svc = graph.ServiceSpec(name="w", replicas=2, role="decode", env={"MARK": "x"},
                            command=["-c", FAKE_WORKER])
    mine = backends.ProcessBackend(log_dir=str(tmp_path))
    ref = jax_backends.ProcessBackend()
    counts = {"port": [], "ref": []}

    def ups(index: int) -> int:
        path = tmp_path / f"w-{index}.log"
        return path.read_text().count("up x") if path.exists() else 0

    for name, be in (("port", mine), ("ref", ref)):
        # each step waits for the replicas to be up (their handlers set)
        up = (lambda want: _wait_until(lambda: (ups(0), ups(1)) == want)) if (
            name == "port") else (lambda want: asyncio.sleep(1.0))
        await be.scale(svc, 2)
        await up((1, 1))
        counts[name].append(be.running("w"))
        victim = be._procs[("w", 0)]
        victim.kill()
        victim.wait()
        counts[name].append(be.running("w"))
        await be.scale(svc, 2)
        await up((2, 1))
        counts[name].append(be.running("w"))
        await be.scale(svc, 1)
        counts[name].append(be.running("w"))
    assert counts["port"] == counts["ref"] == [2, 1, 2, 1]
    await _wait_until(lambda: (mine.running("w"), not mine._stopping) == (1, True))
    assert any("w[1]" in r.getMessage() and "after SIGTERM" in r.getMessage()
               for r in caplog.records)
    assert any("respawning" in r.getMessage() for r in caplog.records)
    await mine.close()
    await ref.close()
    logs = {p.name: p.read_text() for p in tmp_path.iterdir()}
    assert sorted(logs) == ["w-0.log", "w-1.log"]
    assert logs["w-0.log"].count("up x") == 2  # the respawn appended
    assert "drained" in logs["w-1.log"] and "drained" in logs["w-0.log"]
    assert backends.make_backend("process").log_dir is None
    with pytest.raises(ValueError):
        backends.make_backend("nope")


# --------------------------------------------- planner -> operator interop


async def _interop(planner_pkg: str, operator_pkg: str) -> list:
    """A planner of one package writes desired counts through its
    VirtualConnector; the other package's started Reconciler converges a
    recording backend, over one TCP hub."""
    from dynamo_tpu.planner import core as jax_core
    from dynamo_tpu.planner import interpolation as jax_interp
    from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
    from dynamo_tpu_torch.planner import core, interpolation
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.hub_server import HubServer

    server = HubServer(port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"
    hubs = {"port": await RemoteHub.connect(addr), "ref": await JaxRemoteHub.connect(addr)}
    pcore, pint = (core, interpolation) if planner_pkg == "port" else (jax_core, jax_interp)
    pconn = PKGS[planner_pkg][5]
    og, octl = PKGS[operator_pkg][0], PKGS[operator_pkg][1]
    prof = pint.synthetic_profile(decode_thpt_at_full_kv=100.0)
    planner = pcore.SlaPlanner(
        pcore.PlannerConfig(namespace="ns", predictor="constant", no_correction=True,
                            adjustment_interval_s=10.0, max_chip_budget=8),
        pint.PrefillInterpolator(prof), pint.DecodeInterpolator(prof),
        connector=pconn.VirtualConnector(hubs[planner_pkg], "ns"))
    calls: list = []
    be = _Recording(calls)
    dgd = og.DynamoGraphDeployment(name="g", namespace="ns", services=[
        og.ServiceSpec(name="decode", replicas=1, command=["-m", "d"], role="decode")])
    await dgd.apply(hubs[operator_pkg])
    rec = await octl.Reconciler(hubs[operator_pkg], "g", be, interval_s=0.05).start()
    seen = []
    try:
        for num_req in (10.0, 60.0, 140.0, 5.0):
            out = await planner.dryrun([{"num_req": num_req, "isl": 200.0, "osl": 100.0}])
            want = out[0][1]
            t0 = time.monotonic()
            while be.live.get("decode") != want:
                assert time.monotonic() - t0 < 10, (want, calls)
                await asyncio.sleep(0.02)
            seen.append(want)
    finally:
        await rec.close()
        for h in hubs.values():
            await h.close()
        await server.stop()
    return seen


@pytest.mark.parametrize("pair", [("ref", "port"), ("port", "ref")])
async def test_planner_and_operator_interoperate_over_a_tcp_hub(pair):
    # 100 tok/s per chip at the ITL target: 2, then 7 (the budget of 8 less
    # the one prefill replica) twice, then 1
    assert await _interop(*pair) == [2, 7, 7, 1]


# ------------------------------------------------------- the slice, whole


class _Proc:
    """A ``python -m dynamo_tpu_torch.cli`` child; its lines in a queue."""

    def __init__(self, *args, env=None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", *args], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})})
        self.lines: queue.Queue = queue.Queue()
        self.seen: list[str] = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))

    def drain(self) -> list[str]:
        while not self.lines.empty():
            self.seen.append(self.lines.get_nowait())
        return self.seen

    def wait_line(self, prefix: str, timeout: float = 60.0) -> str:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            try:
                line = self.lines.get(timeout=0.1)
            except queue.Empty:
                assert self.proc.poll() is None, self.seen[-20:]
                continue
            self.seen.append(line)
            if line.startswith(prefix):
                return line
        raise AssertionError(f"no {prefix!r} line: {self.seen[-20:]}")

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(10)


def _models(port: int) -> list[str]:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=10) as r:
        return [m["id"] for m in json.loads(r.read())["data"]]


async def _complete(port: int, prompt: str, n: int) -> dict:
    """One streamed completion through the frontend: tokens, TTFT, end."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"model": "tiny-test", "prompt": prompt, "max_tokens": n,
                       "stream": True, "ignore_eos": True,
                       "stream_options": {"include_usage": True}}).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 b"application/json\r\nConnection: close\r\nContent-Length: %d\r\n\r\n"
                 % len(body) + body)
    await writer.drain()
    status = await reader.readline()
    ttft = None
    raw = b""
    while True:
        chunk = await reader.read(65536)
        if not chunk:
            break
        if ttft is None and b"data: " in chunk:
            ttft = time.perf_counter() - t0
        raw += chunk
    writer.close()
    events = [json.loads(ln[6:]) for ln in raw.decode().splitlines()
              if ln.startswith("data: {")]
    tokens = next((e["usage"]["completion_tokens"] for e in events if e.get("usage")), 0)
    finish = [c["finish_reason"] for e in events for c in e.get("choices", [])
              if c.get("finish_reason")]
    return {"ok": status.startswith(b"HTTP/1.1 200") and b"data: [DONE]" in raw
            and finish == ["length"], "tokens": tokens, "ttft": ttft,
            "events": None if finish == ["length"] else events}


@pytest.mark.e2e
async def test_scaling_plane_scales_cpu_workers_one_two_one(tmp_path):
    """hub, frontend, operator (--backend process) and planner of the port,
    each a process; the DGD's decode service runs ``dynamo_tpu_torch.engine
    .worker --device cpu --model tiny-test``. A paced burst at 2.5x one
    replica's profiled tok/s (the budget of 3 chips, one of them the
    planner's prefill replica, caps decode at 2) holds until the planner
    writes decode 2 and the operator's second worker registers; a second
    burst reaches both workers (their own ForwardPassMetrics show running
    requests and step times); then a trickle of one request per interval
    (an interval with no completion is skipped, as the reference's) brings
    decode 1, and the operator SIGTERMs the second worker, which drains.
    Every request completes with its full token count; the desired key and
    the operator's status go 1 -> 2 -> 1."""
    from dynamo_tpu_torch.planner import interpolation
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub

    interval, osl, thpt = 1.5, 8, 20.0
    # requests/s: 2.5x one replica's profiled tok/s, so an interval whose
    # completions bunch on a loaded CPU still reads above one replica; a
    # reading of 3 is capped at 2 by the 3-chip budget (one prefill replica)
    rate = 2.5 * thpt / osl
    prof = interpolation.synthetic_profile(
        decode_thpt_at_full_kv=thpt, base_itl_s=0.01, itl_per_kv_usage_s=0.0,
        itl_per_context_s=0.0, prefill_thpt_per_chip=1e6, max_context=1024)
    (tmp_path / "profile").mkdir()
    for name in ("prefill.npz", "decode.npz"):
        np.savez(tmp_path / "profile" / name, **prof)
    env = {"OMP_NUM_THREADS": "1", "DYN_LEASE_TTL_S": "3", "DYN_KEEPALIVE_INTERVAL_S": "1"}
    procs: list[_Proc] = []
    try:
        hub_p = _Proc("hub", "--port", "0", env=env)
        procs.append(hub_p)
        hub_addr = hub_p.wait_line("DYNAMO_HUB=").split("=", 1)[1]
        front = _Proc("frontend", "--hub", hub_addr, "--port", "0", "--host", "127.0.0.1",
                      env=env)
        procs.append(front)
        http_port = int(front.wait_line("DYNAMO_HTTP=").rsplit(":", 1)[1])
        hub = await RemoteHub.connect(hub_addr)
        dgd = graph.DynamoGraphDeployment(name="g", services=[graph.ServiceSpec(
            name="decode", replicas=1, role="decode", env=env,
            command=["-m", "dynamo_tpu_torch.engine.worker", "--hub", hub_addr,
                     "--device", "cpu", "--model", "tiny-test"])])
        await dgd.apply(hub)
        desired: list = []
        statuses: list = []
        instances: dict[str, float] = {}
        metrics: dict[int, dict] = {}

        async def watch(prefix, fn):
            async for ev in hub.watch_prefix(prefix):
                fn(ev)

        def on_desired(ev):
            if ev.kind == "put":
                desired.append((time.monotonic(), ev.value["decode"], ev.value["revision"]))

        def on_status(ev):
            if ev.kind == "put":
                s = ev.value["services"]["decode"]
                if not statuses or statuses[-1][1:] != (s["desired"], s["ready"]):
                    statuses.append((time.monotonic(), s["desired"], s["ready"]))

        def on_instance(ev):
            if ev.kind == "put":
                instances.setdefault(ev.key, time.monotonic())
            elif ev.kind == "delete":
                instances[ev.key] = -time.monotonic()

        async def on_metrics():
            async for _s, payload in hub.subscribe("kv_metrics.dynamo/backend"):
                m = metrics.setdefault(payload["worker_id"], {"running": 0, "step_ms": 0.0})
                m["running"] = max(m["running"], payload["running_requests"])
                m["step_ms"] = max(m["step_ms"], payload["step_time_ms"])

        tasks = [asyncio.create_task(watch("v1/planner/dynamo/desired", on_desired)),
                 asyncio.create_task(watch("v1/dgd-status/g", on_status)),
                 asyncio.create_task(watch("v1/instances/dynamo/backend/generate/",
                                           on_instance)),
                 asyncio.create_task(on_metrics())]
        op = _Proc("operator", "--hub", hub_addr, "--name", "g", "--interval", "0.3",
                   "--log-dir", str(tmp_path / "workers"), env=env)
        procs.append(op)
        op.wait_line("OPERATOR_READY")
        plan = _Proc("planner", "--hub", hub_addr, "--metrics-url",
                     f"http://127.0.0.1:{http_port}/metrics", "--load-predictor", "constant",
                     "--no-correction", "--adjustment-interval", str(interval),
                     "--min-endpoint", "1", "--max-chip-budget", "3",
                     "--profile-dir", str(tmp_path / "profile"), env=env)
        procs.append(plan)
        plan.wait_line("PLANNER_READY")
        await _wait_until(lambda: len([k for k, v in instances.items() if v > 0]) == 1, 60)
        t0 = time.monotonic()
        while "tiny-test" not in await asyncio.to_thread(_models, http_port):
            assert time.monotonic() - t0 < 30, "the frontend never listed the model"
            await asyncio.sleep(0.05)

        results: dict[str, list] = {"burst1": [], "burst2": [], "trickle": []}
        pending: list[asyncio.Task] = []

        async def paced(label: str, per_s: float, until, group: int = 1):
            """``group`` concurrent requests at a time, ``per_s`` in all: two
            in flight at once make the router's load tell the workers
            apart (an idle tie goes to the lower worker id)."""
            i = 0
            t0 = time.monotonic()
            while not until():
                for _ in range(group):
                    pending.append(asyncio.create_task(
                        _complete(http_port, f"{label} {i} " * (3 + i % 5), osl)))
                    pending[-1].add_done_callback(
                        lambda t, lab=label: results[lab].append(t.result()))
                    i += 1
                await asyncio.sleep(max(0.0, t0 + i / per_s - time.monotonic()))

        live = lambda: sum(1 for v in instances.values() if v > 0)  # noqa: E731
        await asyncio.wait_for(paced("burst1", rate, lambda: live() == 2, group=2), 90)
        t2 = time.monotonic()
        await paced("burst2", rate, lambda: time.monotonic() - t2 > 3 * interval, group=2)
        await asyncio.wait_for(paced(
            "trickle", 1.0 / interval,
            lambda: live() == 1 and desired and desired[-1][1] == 1), 60)
        await asyncio.wait_for(asyncio.gather(*pending), 60)
        op_lines = op.drain()
        await _wait_until(lambda: any("exited rc=0" in ln for ln in op.drain()), 30)
        for t in tasks:
            t.cancel()
        await hub.close()
    finally:
        for p in reversed(procs):
            p.stop()
    for label, res in results.items():
        assert res and all(r["ok"] and r["tokens"] == osl for r in res), (label, res)
    seq = [1]
    for _t, d, _r in desired:
        if d != seq[-1]:
            seq.append(d)
    assert seq == [1, 2, 1], desired
    assert [d for _t, d, _r in desired] and [r for _t, _d, r in desired] == list(
        range(1, len(desired) + 1))
    ready = [1]
    for _t, _d, r in statuses:
        if r != ready[-1] and r > 0:
            ready.append(r)
    assert ready == [1, 2, 1], statuses
    assert len(metrics) == 2, metrics
    assert all(m["running"] >= 1 and m["step_ms"] > 0 for m in metrics.values()), metrics
    logs = sorted((tmp_path / "workers").iterdir())
    assert [p.name for p in logs] == ["decode-0.log", "decode-1.log"]
    assert "ENGINE_DRAINED leftover=0" in logs[1].read_text()
    assert any("stopping decode[1]" in ln for ln in op_lines + op.seen)
