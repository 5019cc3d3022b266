"""Reconciler backends: how desired replicas become running workers (the
port's copy of dynamo_tpu/operator/backends.py).

ProcessBackend supervises OS processes on this host (the test/CI and
single-host production path; the reference's operator manages pods the
same level-triggered way). KubectlBackend drives a cluster through
``kubectl``: in managed mode it renders and ``apply``s the full
Deployment/Service objects from the graph resource (the reference
controller's behavior); without an image it degrades to replica
patching of externally-created Deployments.
"""

from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
import time
from typing import Any

from dynamo_tpu_torch.operator.graph import ServiceSpec

log = logging.getLogger("dynamo.operator")


class ProcessBackend:
    """One subprocess per (service, index) replica.

    Beyond the reference's: a replica gets the service's ``env`` (the
    reference applies it only in the Kubernetes manifests); ``log_dir``
    keeps each replica's output (the reference discards it) in
    ``{log_dir}/{service}-{index}.log``, appended across respawns; a replica
    stopped on scale-down is waited for in a thread and its exit logged
    with the seconds since its SIGTERM (its drain time), and ``close()``
    waits for those too, so no draining worker outlives the operator."""

    def __init__(self, extra_env: dict[str, str] | None = None,
                 log_dir: str | None = None):
        self.env = {**os.environ, **(extra_env or {})}
        self.log_dir = log_dir
        self._procs: dict[tuple[str, int], subprocess.Popen] = {}
        # replicas SIGTERMed on scale-down, each with the task waiting for it
        self._stopping: dict[asyncio.Task, subprocess.Popen] = {}

    @staticmethod
    async def _drained(svc: str, i: int, p: subprocess.Popen, t0: float) -> None:
        rc = await asyncio.to_thread(p.wait)
        log.info("operator: %s[%d] pid=%d exited rc=%d %.2f s after SIGTERM",
                 svc, i, p.pid, rc, time.monotonic() - t0)

    def running(self, service: str) -> int:
        n = 0
        for (svc, _i), p in list(self._procs.items()):
            if svc != service:
                continue
            if p.poll() is None:
                n += 1
            else:  # crashed replica: forget it so reconcile respawns
                log.warning("operator: %s[%d] pid=%d exited rc=%d; respawning",
                            svc, _i, p.pid, p.returncode)
                self._procs.pop((svc, _i))
        return n

    def _spawn(self, spec: ServiceSpec, index: int) -> subprocess.Popen:
        argv = [sys.executable, *spec.command]
        env = {**self.env, **spec.env}
        if self.log_dir is None:
            return subprocess.Popen(argv, env=env, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, f"{spec.name}-{index}.log"), "ab") as out:
            return subprocess.Popen(argv, env=env, stdout=out, stderr=subprocess.STDOUT)

    async def scale(self, spec: ServiceSpec, replicas: int) -> None:
        # spawn missing indices
        live = {
            i for (svc, i), p in self._procs.items()
            if svc == spec.name and p.poll() is None
        }
        for i in range(replicas):
            if i in live:
                continue
            p = self._spawn(spec, i)
            self._procs[(spec.name, i)] = p
            log.info("operator: spawned %s[%d] pid=%d", spec.name, i, p.pid)
        # stop extras: SIGTERM for graceful deregistration (lease revoke);
        # the hub reaper sweeps instance keys of anything that dies hard
        for (svc, i) in sorted(self._procs):
            if svc == spec.name and i >= replicas:
                p = self._procs.pop((svc, i))
                if p.poll() is None:
                    p.terminate()
                    task = asyncio.get_running_loop().create_task(
                        self._drained(svc, i, p, time.monotonic()))
                    self._stopping[task] = p
                    task.add_done_callback(lambda t: self._stopping.pop(t, None))
                    log.info(
                        "operator: stopping %s[%d] pid=%d", svc, i, p.pid
                    )

    async def close(self) -> None:
        procs = [*self._procs.values(), *self._stopping.values()]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = asyncio.get_running_loop().time() + 10
        for p in procs:
            while p.poll() is None:
                if asyncio.get_running_loop().time() > deadline:
                    p.kill()
                    p.wait()
                    break
                await asyncio.sleep(0.1)
        await asyncio.gather(*self._stopping)
        self._procs.clear()


class KubectlBackend:
    """Converge Kubernetes Deployments named ``dynamo-{service}``.

    The cluster-side half of the reference's operator reconciliation
    (controllers owning component Deployments/Services, ref
    deploy/cloud/operator/internal/controller/). Two modes:

    - **managed** (``image`` set): render the full Deployment (+Service
      when the spec has a port) from the ServiceSpec
      (operator/manifests.py) and ``kubectl apply`` it — one idempotent
      verb for create, command/env/image rolling updates, AND scaling,
      exactly how the reference controller drives the apiserver. A
      service removed from the graph is ``kubectl delete``d (delete()).
    - **scale-only** (no ``image``): only patch replicas of Deployments
      someone else created (manifests under deploy/k8s/).
    """

    def __init__(self, namespace: str = "default",
                 name_format: str = "dynamo-{service}",
                 image: str = "", hub: str = "", graph: str = "dynamo",
                 python: str = "python"):
        self.namespace = namespace
        self.name_format = name_format
        self.image = image
        self.hub = hub
        self.graph = graph
        self.python = python
        # watch mode (start_watch): observed readyReplicas per service,
        # maintained by a single long-lived `kubectl get -w` stream
        self._observed: dict[str, int] | None = None
        self._watch_task: asyncio.Task | None = None
        self._watch_proc: asyncio.subprocess.Process | None = None
        self._on_change = None
        # multihost services seen by scale(): service -> hosts per group.
        # The deployment watch stream can't observe Indexed Jobs, so
        # running() takes the job-query path for these.
        self._multihost: dict[str, int] = {}

    async def start_watch(self, on_change) -> None:
        """Informer-style observation: ONE long-lived
        ``kubectl get -w --output-watch-events`` stream replaces the
        per-service ``kubectl get`` fork+exec storm (the upstream
        controller-runtime informers in
        deploy/cloud/operator/internal/controller/). Each watch event
        updates the observed-replica cache and fires ``on_change`` so
        the reconciler reacts to CLUSTER-side edits (pod readiness,
        external scale/delete) event-driven instead of on its poll
        interval. The stream auto-restarts with backoff; the initial
        list arrives as ADDED events and re-seeds the cache.

        The cache is seeded only by the FIRST successful event: until
        then running() keeps the per-service ``kubectl get`` fallback,
        so a watch that can never be established (RBAC grants get but
        not watch, old kubectl without --output-watch-events) degrades
        to polling instead of reporting 0 forever."""
        self._on_change = on_change
        self._watch_task = asyncio.get_running_loop().create_task(
            self._watch_loop()
        )

    async def _watch_loop(self) -> None:
        from dynamo_tpu_torch.operator.manifests import GRAPH_LABEL, SERVICE_LABEL

        argv = [
            "kubectl", "-n", self.namespace, "get", "deployments",
            "-l", f"{GRAPH_LABEL}={self.graph}",
            "-w", "--output-watch-events",
            "-o",
            "jsonpath={.type}{\" \"}"
            f"{{.object.metadata.labels['{SERVICE_LABEL}']}}{{\" \"}}"
            "{.object.status.readyReplicas}{\"\\n\"}",
        ]
        delay = 1.0
        while True:
            try:
                proc = await asyncio.create_subprocess_exec(
                    *argv,
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.DEVNULL,
                )
                self._watch_proc = proc
                assert proc.stdout is not None
                while True:
                    line = await proc.stdout.readline()
                    if not line:
                        break
                    parts = line.decode().split()
                    if len(parts) < 2:
                        continue
                    etype, svc = parts[0], parts[1]
                    ready = (
                        int(parts[2])
                        if len(parts) > 2 and parts[2].isdigit() else 0
                    )
                    if self._observed is None:
                        self._observed = {}  # first event: cache is live
                    if etype == "DELETED":
                        self._observed.pop(svc, None)
                    else:
                        self._observed[svc] = ready
                    delay = 1.0
                    if self._on_change is not None:
                        self._on_change()
                await proc.wait()
            except asyncio.CancelledError:
                if self._watch_proc and self._watch_proc.returncode is None:
                    self._watch_proc.kill()
                    # reap on the loop: GC-time transport finalization
                    # after loop close raises and leaves a zombie
                    try:
                        await self._watch_proc.wait()
                    # best-effort zombie reap on a process we just
                    # killed; shutdown must not fail here
                    except Exception:  # noqa: BLE001
                        pass
                raise
            except Exception:  # noqa: BLE001 — kubectl missing/apiserver gone
                log.warning("kubectl watch stream failed; retrying",
                            exc_info=True)
            await asyncio.sleep(delay)
            delay = min(delay * 2, 30.0)

    def running(self, service: str) -> int:
        hosts = self._multihost.get(service, 0)
        if hosts > 1:
            # one "replica" = one fully-ready group: count Jobs whose
            # ready pods reach the group size
            from dynamo_tpu_torch.operator.manifests import (
                GRAPH_LABEL, SERVICE_LABEL,
            )

            out = subprocess.run(
                ["kubectl", "-n", self.namespace, "get", "jobs",
                 "-l", f"{SERVICE_LABEL}={service},{GRAPH_LABEL}={self.graph}",
                 "-o", "jsonpath={range .items[*]}{.status.ready}"
                 "{\"\\n\"}{end}"],
                capture_output=True, text=True,
            )
            return sum(
                1 for tok in out.stdout.split()
                if tok.isdigit() and int(tok) >= hosts
            )
        if self._observed is not None:
            # watch mode: cache read, no subprocess. A deployment deleted
            # during a watch-stream gap may linger until the stream's
            # next event re-syncs it — scale() stays idempotent either way
            # (informers accept the same staleness window).
            return self._observed.get(service, 0)
        out = subprocess.run(
            ["kubectl", "-n", self.namespace, "get", "deployment",
             self.name_format.format(service=service),
             "-o", "jsonpath={.status.readyReplicas}"],
            capture_output=True, text=True,
        )
        try:
            return int(out.stdout.strip() or 0)
        except ValueError:
            return 0

    @staticmethod
    async def _kubectl(argv: list[str], **kw) -> subprocess.CompletedProcess:
        """kubectl off the event loop: apiserver round-trips run 100ms+
        (or hang on a dead cluster), and the reconciler shares its loop
        with watch streams and the hub client."""
        return await asyncio.to_thread(subprocess.run, argv, **kw)

    async def scale(self, spec: ServiceSpec, replicas: int) -> None:
        if spec.hosts > 1:
            if not self.image:
                # scale-only mode can't patch Indexed Jobs (completions
                # are immutable); multihost requires managed mode
                log.warning(
                    "operator: cannot scale multihost service %r without "
                    "an image (managed mode required)", spec.name,
                )
                return
            self._multihost[spec.name] = spec.hosts
            await self._scale_multihost(spec, replicas)
            return
        self._multihost.pop(spec.name, None)
        if self.image:
            import json

            from dynamo_tpu_torch.operator.manifests import render_bundle

            bundle = render_bundle(
                spec, replicas, graph=self.graph, namespace=self.namespace,
                image=self.image, hub=self.hub,
                name_format=self.name_format, python=self.python,
            )
            await self._kubectl(
                ["kubectl", "-n", self.namespace, "apply", "-f", "-"],
                input=json.dumps(bundle), text=True, check=False,
            )
            if not spec.port:
                # apply doesn't prune: a Service left over from when the
                # spec HAD a port must go explicitly
                await self._kubectl(
                    ["kubectl", "-n", self.namespace, "delete", "service",
                     self.name_format.format(service=spec.name),
                     "--ignore-not-found"],
                    check=False,
                )
            return
        await self._kubectl(
            ["kubectl", "-n", self.namespace, "scale", "deployment",
             self.name_format.format(service=spec.name),
             f"--replicas={replicas}"],
            check=False,
        )

    async def _scale_multihost(self, spec: ServiceSpec, replicas: int) -> None:
        """Converge the Indexed Job groups of a ``hosts > 1`` service.

        ``apply`` covers create and replica growth, but Job pod templates
        are immutable — a command/env/image change makes apply fail, and
        the roll is an explicit delete + re-apply of the service's
        groups (pods restart; the SPMD group must re-form anyway).
        Scale-down GC deletes groups with index >= replicas by their
        HOST_INDEX_LABEL, most-recent group names first being irrelevant
        here: group identity is the index, so the highest indices go.
        """
        import json

        from dynamo_tpu_torch.operator.manifests import (
            GRAPH_LABEL, HOST_INDEX_LABEL, SERVICE_LABEL,
            multihost_group_name, render_multihost_bundle,
        )

        bundle = render_multihost_bundle(
            spec, replicas, graph=self.graph, namespace=self.namespace,
            image=self.image, hub=self.hub,
            name_format=self.name_format, python=self.python,
        )
        sel = f"{SERVICE_LABEL}={spec.name},{GRAPH_LABEL}={self.graph}"
        out = await self._kubectl(
            ["kubectl", "-n", self.namespace, "apply", "-f", "-"],
            input=json.dumps(bundle), text=True, check=False,
            capture_output=True,
        )
        if out.returncode != 0 and "immutable" in (out.stderr or ""):
            log.info("operator: rolling multihost service %r "
                     "(job template changed)", spec.name)
            await self._kubectl(
                ["kubectl", "-n", self.namespace, "delete", "jobs",
                 "-l", sel, "--ignore-not-found"],
                check=False,
            )
            await self._kubectl(
                ["kubectl", "-n", self.namespace, "apply", "-f", "-"],
                input=json.dumps(bundle), text=True, check=False,
            )
        # GC groups beyond the desired replica count (apply never prunes)
        out = await self._kubectl(
            ["kubectl", "-n", self.namespace, "get", "jobs", "-l", sel,
             "-o", "jsonpath={range .items[*]}"
             f"{{.metadata.labels['{HOST_INDEX_LABEL}']}}{{\"\\n\"}}{{end}}"],
            capture_output=True, text=True, check=False,
        )
        for tok in out.stdout.split():
            if tok.isdigit() and int(tok) >= replicas:
                name = multihost_group_name(
                    spec.name, int(tok), self.name_format
                )
                log.info("operator: GC multihost group %r", name)
                for kind in ("job", "service"):
                    await self._kubectl(
                        ["kubectl", "-n", self.namespace, "delete", kind,
                         name, "--ignore-not-found"],
                        check=False,
                    )

    async def delete(self, spec: ServiceSpec) -> None:
        """Remove a service's objects (it left the graph resource).
        The Service is deleted unconditionally (--ignore-not-found):
        the current spec's port says nothing about whether an EARLIER
        revision created one."""
        name = self.name_format.format(service=spec.name)
        for kind in ("deployment", "service"):
            await self._kubectl(
                ["kubectl", "-n", self.namespace, "delete", kind, name,
                 "--ignore-not-found"],
                check=False,
            )
        # multihost groups (Indexed Jobs + headless Services) carry the
        # service label — sweep them by selector; matches nothing for
        # single-host services
        self._multihost.pop(spec.name, None)
        if self.image:
            from dynamo_tpu_torch.operator.manifests import (
                GRAPH_LABEL, SERVICE_LABEL,
            )

            sel = f"{SERVICE_LABEL}={spec.name},{GRAPH_LABEL}={self.graph}"
            for kind in ("jobs", "services"):
                await self._kubectl(
                    ["kubectl", "-n", self.namespace, "delete", kind,
                     "-l", sel, "--ignore-not-found"],
                    check=False,
                )

    async def prune(self, current_services: set[str]) -> None:
        """Delete graph-labeled objects whose service left the resource
        while the operator was down — the in-memory last-seen diff in
        the reconciler can't see those; the GRAPH_LABEL stamped on every
        managed object makes them findable. Managed mode only."""
        if not self.image:
            return
        from dynamo_tpu_torch.operator.manifests import GRAPH_LABEL, SERVICE_LABEL

        found: set[str] = set()
        # multihost groups live as Jobs, not Deployments — sweep both
        for kind in ("deployments", "jobs"):
            out = await self._kubectl(
                ["kubectl", "-n", self.namespace, "get", kind,
                 "-l", f"{GRAPH_LABEL}={self.graph}",
                 "-o", f"jsonpath={{range .items[*]}}"
                 f"{{.metadata.labels.{SERVICE_LABEL}}}{{\"\\n\"}}{{end}}"],
                capture_output=True, text=True,
            )
            found.update(out.stdout.split())
        for svc_name in sorted(found):
            if svc_name and svc_name not in current_services:
                log.info("operator: pruning orphaned service %r", svc_name)
                await self.delete(ServiceSpec(
                    name=svc_name, replicas=0, command=[]
                ))

    async def close(self) -> None:  # deployments outlive the operator
        if self._watch_task is not None:
            self._watch_task.cancel()
            try:
                await self._watch_task
            except asyncio.CancelledError:
                pass
        if self._watch_proc is not None and self._watch_proc.returncode is None:
            self._watch_proc.kill()
            try:
                await asyncio.wait_for(self._watch_proc.wait(), timeout=5)
            except (asyncio.TimeoutError, ProcessLookupError):
                pass


def make_backend(kind: str, **kwargs: Any):
    if kind == "process":
        return ProcessBackend(**kwargs)
    if kind == "kubectl":
        return KubectlBackend(**kwargs)
    raise ValueError(f"unknown operator backend {kind!r}")
