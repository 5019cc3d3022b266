"""SLA planner: load prediction -> perf interpolation -> replica targets.

The port's copy of dynamo_tpu/planner/ (host code: numpy and the stdlib,
no torch). Counterpart of the upstream planner component
(components/src/dynamo/planner/, 3k LoC): observe serving metrics, predict
the next interval's load, invert pre-deployment profiling curves to find
how many prefill/decode engine replicas meet the TTFT/ITL SLAs, and push
desired replica counts through a connector (virtual hub-backed here;
Kubernetes in the reference's kubernetes_connector.py).
"""

from dynamo_tpu_torch.planner.connector import (
    DesiredReplicas,
    LoggingConnector,
    VirtualConnector,
    read_desired_replicas,
)
from dynamo_tpu_torch.planner.core import Metrics, PlannerConfig, SlaPlanner
from dynamo_tpu_torch.planner.interpolation import (
    DecodeInterpolator,
    PrefillInterpolator,
    synthetic_profile,
)
from dynamo_tpu_torch.planner.predictor import make_predictor

__all__ = [
    "DecodeInterpolator",
    "DesiredReplicas",
    "LoggingConnector",
    "Metrics",
    "PlannerConfig",
    "PrefillInterpolator",
    "SlaPlanner",
    "VirtualConnector",
    "make_predictor",
    "read_desired_replicas",
    "synthetic_profile",
]
