"""KV-cache-aware request routing.

The router maintains a global view of which KV blocks live on which worker
(event-sourced from worker cache events into a radix/prefix index) plus each
worker's load (published ForwardPassMetrics), and routes each request to the
worker minimizing ``overlap_weight * potential_prefill_blocks +
decode_blocks`` - i.e. the worker that can reuse the most prefix KV while not
being overloaded. Ref: lib/llm/src/kv_router/ (KvRouter kv_router.rs:202,
RadixTree indexer.rs:225, KvScheduler scheduler.rs, ActiveSequences
sequence.rs, publisher.rs).
"""

from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    RouterConfig,
    RouterEvent,
)
from dynamo_tpu_torch.kv_router.indexer import ApproxKvIndexer, OverlapScores, RadixTree
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler, WorkerSelector, softmax_sample
from dynamo_tpu_torch.kv_router.sequence import ActiveSequences, ActiveSequencesMultiWorker
from dynamo_tpu_torch.kv_router.router import KvRouter, KvPushRouter
from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher

__all__ = [
    "ForwardPassMetrics",
    "KvCacheEvent",
    "RouterConfig",
    "RouterEvent",
    "ApproxKvIndexer",
    "OverlapScores",
    "RadixTree",
    "KvScheduler",
    "WorkerSelector",
    "softmax_sample",
    "ActiveSequences",
    "ActiveSequencesMultiWorker",
    "KvRouter",
    "KvPushRouter",
    "KvEventPublisher",
    "WorkerMetricsPublisher",
]
