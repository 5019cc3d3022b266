"""Closed-loop SLA autoscaler (the port's copy of dynamo_tpu/autoscaler/:
host code, no torch; the same plans, hub keys and metrics).

Consumes live fleet telemetry (the same ForwardPassMetrics stream the KV
router schedules from, plus optional frontend scrape aggregates), turns it
into versioned :class:`~dynamo_tpu_torch.autoscaler.plan.ScalePlan` documents
through a hysteresis/cooldown/bounded-step control law with optional
predictive pre-scaling, and actuates plans through a pluggable backend —
the chaos sim's :class:`~dynamo_tpu_torch.autoscaler.backends.SimBackend` or the
operator-riding :class:`~dynamo_tpu_torch.autoscaler.backends.K8sBackend`.

Scale-down always rides the drain contract: the instance key is withdrawn
(and the watch-propagation grace served) before any worker dies, so a
converging fleet never produces a client-visible error.
"""

from dynamo_tpu_torch.autoscaler.backends import (
    K8sBackend,
    ScaleBackend,
    SimBackend,
)
from dynamo_tpu_torch.autoscaler.controller import AutoscaleController
from dynamo_tpu_torch.autoscaler.plan import (
    AutoscalerConfig,
    DemandSignal,
    PlanEngine,
    ScalePlan,
)
from dynamo_tpu_torch.autoscaler.telemetry import FleetTelemetry

__all__ = [
    "AutoscaleController",
    "AutoscalerConfig",
    "DemandSignal",
    "FleetTelemetry",
    "K8sBackend",
    "PlanEngine",
    "ScaleBackend",
    "ScalePlan",
    "SimBackend",
]
