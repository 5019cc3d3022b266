"""Deployment operator: reconcile a declared serving graph into reality.

The port's copy of dynamo_tpu/operator/ (host code: the stdlib, no torch;
the workers it starts run on the card). Role of the upstream Go operator (deploy/cloud/operator/: CRDs
DynamoGraphDeployment/DynamoComponentDeployment, controllers, etcd
cleanup on scale-down) rebuilt for this stack: the GRAPH — services,
their launch commands, replica counts — is data in the hub KV; a
reconciler process watches desired vs. observed state and converges by
spawning/stopping worker processes (ProcessBackend) or scaling
Kubernetes deployments (KubectlBackend). The SLA planner closes its
loop through the same path the reference uses (KubernetesConnector
patches DGD replicas): its VirtualConnector writes desired counts to
the hub, and the operator applies them to the graph's prefill/decode
services.
"""

from dynamo_tpu_torch.operator.graph import DynamoGraphDeployment, ServiceSpec
from dynamo_tpu_torch.operator.controller import Reconciler

__all__ = ["DynamoGraphDeployment", "ServiceSpec", "Reconciler"]
