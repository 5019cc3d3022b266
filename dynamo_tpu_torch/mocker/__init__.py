"""Mock engine: a simulated worker for accelerator-free infra testing.

Mirrors the role of the reference's mocker (lib/llm/src/mocker/: engine.rs:48
MockVllmEngine, kv_manager.rs, scheduler.rs): a worker process that behaves
like a real engine from the outside - continuous-batching admission, bounded
KV block pool with prefix caching and LRU eviction, realistic prefill/decode
timing (dilatable by ``speedup_ratio``), real KV cache events and
ForwardPassMetrics - but computes nothing. The entire router / frontend /
planner / fault-tolerance stack is testable against fleets of these on one
CPU.

A copy of ``dynamo_tpu/mocker/__init__.py``.
"""

from dynamo_tpu_torch.mocker.kv_manager import MockKvManager
from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineConfig

__all__ = ["MockKvManager", "MockEngine", "MockEngineConfig"]
