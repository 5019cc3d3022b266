"""Disaggregated prefill/decode serving (the port's copy of
dynamo_tpu/disagg/).

A decode worker conditionally delegates prompt processing to a prefill
worker pool; the KV blocks move prefill -> decode over the transfer plane
(in process, CUDA IPC on one card, or TCP host staging).

Modules:
  transfer.py - KvTransferSource and the pull client
  policy.py   - the conditional disagg policy and its live hub key
  handlers.py - the decode and prefill worker handlers
"""

from dynamo_tpu_torch.disagg.handlers import DecodeWorkerHandler, PrefillWorkerHandler
from dynamo_tpu_torch.disagg.policy import DisaggPolicy
from dynamo_tpu_torch.disagg.transfer import KvTransferSource, pull_kv_blocks

__all__ = [
    "DecodeWorkerHandler",
    "PrefillWorkerHandler",
    "DisaggPolicy",
    "KvTransferSource",
    "pull_kv_blocks",
]
