"""Inference-gateway integration (the port's copy of dynamo_tpu/gateway/):
the endpoint-picker (EPP) role of the Kubernetes Gateway API inference
extension. The picker IS the KV router, exposed over the HTTP contract
gateways consume (``POST /pick``), with per-instance circuit breakers
(``breaker.py``) and the line-delimited JSON fast path (``pickline.py``)."""

from dynamo_tpu_torch.gateway.epp import EndpointPicker

__all__ = ["EndpointPicker"]
