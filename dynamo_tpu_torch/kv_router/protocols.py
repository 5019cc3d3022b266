"""Wire types for KV routing (ref lib/llm/src/kv_router/protocols.rs; a copy
of dynamo_tpu/kv_router/protocols.py).

Everything here crosses process boundaries (hub pub/sub), so types are plain
dicts-on-the-wire with dataclass views.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# hub pub/sub subjects
KV_EVENT_SUBJECT = "kv_events.{component}"  # worker cache events -> routers
KV_METRICS_SUBJECT = "kv_metrics.{component}"  # worker load metrics -> routers


@dataclass(frozen=True)
class BlockStored:
    """One KV block became resident on a worker.

    ``sequence_hash`` is the chained prefix identity (tokens.py), which is
    what the radix index is keyed on; ``parent_sequence_hash`` links it into
    the prefix tree; ``block_hash`` is the content hash (kept for debugging /
    cross-checking).
    """

    sequence_hash: int
    parent_sequence_hash: int
    block_hash: int = 0


@dataclass(frozen=True)
class KvCacheEvent:
    """A batch of cache mutations from one worker's engine.

    kind: "stored" | "removed" | "cleared"
    """

    kind: str
    stored: tuple[BlockStored, ...] = ()
    removed: tuple[int, ...] = ()  # sequence hashes

    def to_dict(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "stored": [
                {
                    "sequence_hash": b.sequence_hash,
                    "parent_sequence_hash": b.parent_sequence_hash,
                    "block_hash": b.block_hash,
                }
                for b in self.stored
            ],
            "removed": list(self.removed),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KvCacheEvent":
        return cls(
            kind=d["kind"],
            stored=tuple(
                BlockStored(
                    sequence_hash=b["sequence_hash"],
                    parent_sequence_hash=b["parent_sequence_hash"],
                    block_hash=b.get("block_hash", 0),
                )
                for b in d.get("stored", ())
            ),
            removed=tuple(d.get("removed", ())),
        )


@dataclass(frozen=True)
class RouterEvent:
    """KvCacheEvent tagged with its source worker (ref indexer.rs:175)."""

    worker_id: int
    event: KvCacheEvent
    event_id: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "event_id": self.event_id,
            "event": self.event.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RouterEvent":
        return cls(
            worker_id=d["worker_id"],
            event=KvCacheEvent.from_dict(d["event"]),
            event_id=d.get("event_id", 0),
        )


@dataclass
class ForwardPassMetrics:
    """Per-worker load snapshot (ref kv_router/protocols.rs:48).

    Published by workers on every scheduler iteration (or change); consumed
    by the router's scheduler as the ``decode_blocks`` / queueing signals.
    """

    worker_id: int = 0
    active_kv_blocks: int = 0
    total_kv_blocks: int = 1
    waiting_requests: int = 0
    running_requests: int = 0
    prefill_tokens_queued: int = 0
    # cumulative MoE capacity-dropped expert slots (quality signal; 0 for
    # dense models — see models/moe.py capacity semantics)
    moe_dropped_slots: int = 0
    data_parallel_rank: int = 0
    # rolling (EWMA) wall-clock decode-step latency in ms: the worker's
    # degradation fingerprint. Peer-RELATIVE — the DegradationDetector
    # scores it against the fleet median, so absolute speed (hardware
    # generation, sim time dilation) cancels out; 0 = not yet measured
    step_time_ms: float = 0.0

    @property
    def kv_usage(self) -> float:
        return self.active_kv_blocks / max(self.total_kv_blocks, 1)

    def to_dict(self) -> dict[str, Any]:
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ForwardPassMetrics":
        return cls(**{k: d[k] for k in cls().__dict__ if k in d})


@dataclass
class RouterConfig:
    """Scheduler knobs (ref kv_router.rs:116-126, scheduler.rs:519)."""

    overlap_weight: float = 1.0
    temperature: float = 0.0  # 0 => deterministic argmin
    block_size: int = 64
    # incremental selection: lowest-load workers drawn from the
    # scheduler's load index per pick (on top of the overlap-scored
    # set). 2 = classic power-of-two-choices; higher widens the
    # temperature>0 sampling pool. The temperature-0 argmin is
    # bit-identical to the full-fleet oracle scan for ANY k >= 1.
    candidate_k: int = 8
    # replica sync / snapshots
    snapshot_threshold: int = 1_000_000  # events between radix snapshots
    # approx indexer
    approx_ttl_s: float = 120.0
    use_approx: bool = False
    # cluster-level tenant steering (kv_router/steering.py): a hot
    # tenant (> steer_hot_rate_per_s sustained picks/s) with more than
    # steer_max_share of its recent picks on one worker gets that worker
    # excluded (fail-open), spreading affinity instead of pinning.
    # Only engages for requests that carry a tenant tag.
    steer_enabled: bool = True
    steer_half_life_s: float = 10.0
    steer_hot_rate_per_s: float = 2.0
    steer_max_share: float = 0.5
