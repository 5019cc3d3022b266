"""Autoscaler observability (module registry, every /metrics surface): the
reference's series on the port's runtime/metrics.py."""

from __future__ import annotations

from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

_REG = MetricsRegistry()

PLAN_REVISIONS = _REG.counter(
    "autoscaler_plan_revisions_total",
    "scale plans emitted by the control law",
)
ACTUATION_SECONDS = _REG.histogram(
    "autoscaler_actuation_seconds",
    "wall time for the backend to apply one scale plan",
)
REPLICAS_DESIRED = _REG.gauge(
    "autoscaler_replicas_desired",
    "latest plan's target replicas by dimension",
    ["dimension"],
)
REPLICAS_ACTUAL = _REG.gauge(
    "autoscaler_replicas_actual",
    "backend-observed replicas by dimension",
    ["dimension"],
)
PREDICTOR_ERROR = _REG.gauge(
    "autoscaler_predictor_error",
    "forecast minus realized demand for the last matured forecast",
)
CONVERGENCE_TICKS = _REG.gauge(
    "autoscaler_convergence_ticks",
    "controller ticks the last plan took to converge observed to desired",
)

register_registry("autoscaler", _REG)
