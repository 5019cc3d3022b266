"""DynamoGraphDeployment: the serving-graph custom resource (the port's
copy of dynamo_tpu/operator/graph.py: the same hub keys and JSON document).

Mirror of the upstream CRD
(deploy/cloud/operator/api/v1alpha1/dynamographdeployment_types.go:31-78
``DynamoGraphDeploymentSpec.services``) as plain data: each service has
a launch command (argv template), a replica count, and the component it
registers under (for observed-state matching). The resource lives in
the hub KV under ``v1/dgd/{name}``; edits there are the declarative
API the reconciler converges on.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

DGD_KEY = "v1/dgd/{name}"
# status write-back (the CRD status subresource equivalent): the
# reconciler publishes per-service desired/ready counts here each pass
DGD_STATUS_KEY = "v1/dgd-status/{name}"


@dataclass
class ServiceSpec:
    name: str
    replicas: int
    command: list[str]  # argv; must be self-disambiguating across
    # replicas (no fixed ports etc. — replicas launch identically)
    component: str = "backend"  # runtime component it registers under
    # planner wiring: "prefill"/"decode" services accept replica
    # overrides from the planner's desired-replicas key
    role: str = ""  # "", "prefill", "decode"
    # k8s rendering (operator/manifests.py): a port gets a containerPort
    # + ClusterIP Service; env vars are injected into the container
    port: int = 0
    env: dict[str, str] = field(default_factory=dict)
    # multihost (hosts > 1): ONE logical worker spanning N host pods —
    # rendered as an Indexed Job + headless coordinator Service instead
    # of a Deployment (deploy/k8s/worker-multihost.yaml is the golden
    # shape); each replica is its own Job. ProcessBackend treats the
    # service as single-host (the worker's --num-processes flag governs
    # local multi-process runs).
    hosts: int = 1


@dataclass
class DynamoGraphDeployment:
    name: str
    namespace: str = "dynamo"
    services: list[ServiceSpec] = field(default_factory=list)
    revision: int = 0

    @property
    def key(self) -> str:
        return DGD_KEY.format(name=self.name)

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DynamoGraphDeployment":
        services = [ServiceSpec(**s) for s in d.get("services", [])]
        return cls(
            name=d["name"],
            namespace=d.get("namespace", "dynamo"),
            services=services,
            revision=int(d.get("revision", 0)),
        )

    async def apply(self, hub) -> None:
        """Publish (create or update) this resource."""
        self.revision += 1
        await hub.put(self.key, self.to_dict())

    @classmethod
    async def get(cls, hub, name: str) -> "DynamoGraphDeployment | None":
        raw = await hub.get(DGD_KEY.format(name=name))
        return cls.from_dict(raw) if raw else None
