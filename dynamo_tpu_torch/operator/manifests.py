"""Kubernetes manifest rendering for managed graph deployments (the port's
copy of dynamo_tpu/operator/manifests.py: the same dicts, rendered as JSON).

The upstream operator's controllers OWN the component Deployments and
Services — they render them from the DynamoGraphDeployment resource and
let the apiserver perform rolling updates when the pod template changes
(ref deploy/cloud/operator/internal/controller/
dynamocomponentdeployment_controller.go: generateDeployment/
generateService). This module is that rendering step as pure functions:
ServiceSpec -> Deployment (+ Service) dicts, consumed by KubectlBackend
via ``kubectl apply -f -``. The objects are emitted as JSON — valid
YAML, so no extra dependency — and ``apply`` makes create, update, and
scale the same idempotent verb.
"""

from __future__ import annotations

from typing import Any

from dynamo_tpu_torch.operator.graph import ServiceSpec

GRAPH_LABEL = "dynamo-graph"
SERVICE_LABEL = "dynamo-service"
# multihost: per-replica group index, stamped on the Job + headless
# Service so scale-down / prune can GC groups by label
HOST_INDEX_LABEL = "dynamo-host-index"
# the distributed runtime's coordinator port on pod 0 of every multihost group
# (deploy/k8s/worker-multihost.yaml)
COORDINATOR_PORT = 9876


def deployment_name(svc_name: str, name_format: str = "dynamo-{service}") -> str:
    return name_format.format(service=svc_name)


def probe_manifests(port: int) -> dict[str, Any]:
    """Kubelet probes against the worker's SystemStatusServer routes
    (runtime/health.py ``/live`` + ``/ready``), in the exact shape the
    hand-written deploy/k8s worker/prefill manifests carry: readiness
    gates traffic on the canary loop reporting every endpoint ready,
    liveness restarts a pod whose process (or engine watchdog) wedged.
    Gray failures are deliberately NOT a liveness matter — a degraded
    or quarantined worker still answers ``/live``; eviction is the
    control plane's quarantine path, not a kubelet restart loop."""
    return {
        "readinessProbe": {
            "httpGet": {"path": "/ready", "port": port},
            "initialDelaySeconds": 30,
            "periodSeconds": 10,
        },
        "livenessProbe": {
            "httpGet": {"path": "/live", "port": port},
            "periodSeconds": 15,
        },
    }


def multihost_group_name(
    svc_name: str, index: int, name_format: str = "dynamo-{service}"
) -> str:
    """Name of one multihost replica group (Indexed Job + headless
    Service). Each replica of a ``hosts > 1`` service is its own group:
    the coordinator DNS name is derived from the group name, so groups
    cannot share a Job."""
    return f"{deployment_name(svc_name, name_format)}-{index}"


def deployment_manifest(
    svc: ServiceSpec,
    replicas: int,
    *,
    graph: str,
    namespace: str,
    image: str,
    hub: str,
    name_format: str = "dynamo-{service}",
    python: str = "python",
) -> dict[str, Any]:
    """Render the Deployment that runs ``replicas`` copies of a service.

    The container command mirrors ProcessBackend's spawn line
    (``python *spec.command``); DYNAMO_HUB carries the coordination
    address the way the reference injects etcd/NATS endpoints into its
    component pods.
    """
    name = deployment_name(svc.name, name_format)
    labels = {
        "app": name,
        GRAPH_LABEL: graph,
        SERVICE_LABEL: svc.name,
    }
    if svc.role:
        labels["dynamo-role"] = svc.role
    env = [{"name": "DYNAMO_HUB", "value": hub}]
    env += [{"name": k, "value": v} for k, v in sorted(svc.env.items())]
    container: dict[str, Any] = {
        "name": "worker",
        "image": image,
        "command": [python, *svc.command],
        "env": env,
    }
    if svc.port:
        container["ports"] = [{"containerPort": svc.port}]
        container.update(probe_manifests(svc.port))
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace, "labels": labels},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {"containers": [container]},
            },
        },
    }


def service_manifest(
    svc: ServiceSpec,
    *,
    graph: str,
    namespace: str,
    name_format: str = "dynamo-{service}",
) -> dict[str, Any]:
    """ClusterIP Service in front of a port-bearing component (the
    frontend, typically). Only rendered when ``svc.port`` is set."""
    name = deployment_name(svc.name, name_format)
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {GRAPH_LABEL: graph, SERVICE_LABEL: svc.name},
        },
        "spec": {
            "selector": {"app": name},
            "ports": [{"port": svc.port, "targetPort": svc.port}],
        },
    }


def multihost_manifests(
    svc: ServiceSpec,
    index: int,
    *,
    graph: str,
    namespace: str,
    image: str,
    hub: str,
    name_format: str = "dynamo-{service}",
    python: str = "python",
) -> list[dict[str, Any]]:
    """One multihost replica group: headless coordinator Service +
    Indexed Job spanning ``svc.hosts`` pods.

    Mirrors deploy/k8s/worker-multihost.yaml (the golden shape, asserted
    in the operator tests): pod 0 is the SPMD leader, the headless
    Service gives it the stable DNS name ``{group}-0.{group}`` the
    group's coordinator needs (the port's worker takes the same
    ``--coordinator-address/--num-processes/--process-id`` flags,
    parallel/multihost.py), and JOB_COMPLETION_INDEX (via the
    downward-API annotation) becomes ``--process-id``. Multihost flags
    are appended to the spec's own command so graph authors write the
    same argv they would for a single-host worker.
    """
    base = deployment_name(svc.name, name_format)
    name = multihost_group_name(svc.name, index, name_format)
    labels = {
        "app": base,  # shared across groups: a port Service (or operator
        # queries) can still select every pod of the service
        GRAPH_LABEL: graph,
        SERVICE_LABEL: svc.name,
        HOST_INDEX_LABEL: str(index),
    }
    if svc.role:
        labels["dynamo-role"] = svc.role
    coordinator = f"{name}-0.{name}:{COORDINATOR_PORT}"
    env = [{"name": "DYNAMO_HUB", "value": hub}]
    env += [{"name": k, "value": v} for k, v in sorted(svc.env.items())]
    env.append({
        "name": "JOB_COMPLETION_INDEX",
        "valueFrom": {"fieldRef": {
            "fieldPath":
                "metadata.annotations"
                "['batch.kubernetes.io/job-completion-index']",
        }},
    })
    container: dict[str, Any] = {
        "name": "worker",
        "image": image,
        "command": [
            python, *svc.command,
            "--coordinator-address", coordinator,
            "--num-processes", str(svc.hosts),
            # $(VAR) is expanded by the kubelet from the container env
            "--process-id", "$(JOB_COMPLETION_INDEX)",
        ],
        "env": env,
    }
    if svc.port:
        container["ports"] = [{"containerPort": svc.port}]
        container.update(probe_manifests(svc.port))
    headless: dict[str, Any] = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": dict(labels)},
        "spec": {
            "clusterIP": "None",  # headless: per-pod DNS for the coordinator
            "selector": {"job-name": name},
            "ports": [{"name": "coordinator", "port": COORDINATOR_PORT}],
        },
    }
    job: dict[str, Any] = {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": dict(labels)},
        "spec": {
            "completions": svc.hosts,
            "parallelism": svc.hosts,
            "completionMode": "Indexed",
            "template": {
                "metadata": {"labels": {**labels, "job-name": name}},
                "spec": {
                    "subdomain": name,  # pods resolvable via the headless svc
                    "restartPolicy": "Never",
                    "containers": [container],
                },
            },
        },
    }
    return [headless, job]


def render_multihost_bundle(
    svc: ServiceSpec,
    replicas: int,
    *,
    graph: str,
    namespace: str,
    image: str,
    hub: str,
    name_format: str = "dynamo-{service}",
    python: str = "python",
) -> dict[str, Any]:
    """All replica groups of a multihost service as one ``v1 List``.
    Scale-down GC (groups with index >= replicas) is the backend's job —
    apply does not prune."""
    items: list[dict[str, Any]] = []
    for i in range(replicas):
        items.extend(multihost_manifests(
            svc, i, graph=graph, namespace=namespace, image=image,
            hub=hub, name_format=name_format, python=python,
        ))
    if svc.port:
        items.append(
            service_manifest(
                svc, graph=graph, namespace=namespace,
                name_format=name_format,
            )
        )
    return {"apiVersion": "v1", "kind": "List", "items": items}


def render_bundle(
    svc: ServiceSpec,
    replicas: int,
    *,
    graph: str,
    namespace: str,
    image: str,
    hub: str,
    name_format: str = "dynamo-{service}",
    python: str = "python",
) -> dict[str, Any]:
    """Everything one service needs, as a single ``v1 List`` document
    (what ``kubectl apply -f -`` consumes in one pass). Multihost
    services (``hosts > 1``) render as Indexed Job groups instead of a
    Deployment."""
    if svc.hosts > 1:
        return render_multihost_bundle(
            svc, replicas, graph=graph, namespace=namespace, image=image,
            hub=hub, name_format=name_format, python=python,
        )
    items: list[dict[str, Any]] = [
        deployment_manifest(
            svc, replicas, graph=graph, namespace=namespace, image=image,
            hub=hub, name_format=name_format, python=python,
        )
    ]
    if svc.port:
        items.append(
            service_manifest(
                svc, graph=graph, namespace=namespace,
                name_format=name_format,
            )
        )
    return {"apiVersion": "v1", "kind": "List", "items": items}
