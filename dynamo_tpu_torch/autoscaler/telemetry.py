"""Live fleet telemetry for the autoscaler (a copy of
dynamo_tpu/autoscaler/telemetry.py on the port's kv_router protocols).

:class:`FleetTelemetry` rides the SAME hub pub/sub stream the KV router
schedules from (``kv_metrics.{component}`` carrying per-worker
ForwardPassMetrics) — the autoscaler sees exactly the load signal the data
plane acts on, with no second scrape path to drift. Snapshots age out
workers whose metrics went quiet (crashed or drained), so demand never
counts a corpse's last report.
"""

from __future__ import annotations

import asyncio
import logging
import time

from dynamo_tpu_torch.autoscaler.plan import DemandSignal
from dynamo_tpu_torch.kv_router.protocols import (
    KV_METRICS_SUBJECT,
    ForwardPassMetrics,
)

log = logging.getLogger("dynamo.autoscaler.telemetry")

__all__ = ["FleetTelemetry"]


class FleetTelemetry:
    """Latest-per-worker ForwardPassMetrics view with staleness expiry."""

    def __init__(
        self,
        hub,
        component_path: str,
        *,
        stale_after_s: float = 2.0,
        clock=time.monotonic,
    ):
        self.hub = hub
        self.subject = KV_METRICS_SUBJECT.format(component=component_path)
        self.stale_after_s = stale_after_s
        self.clock = clock
        self._latest: dict[int, tuple[float, ForwardPassMetrics]] = {}
        self._task: asyncio.Task | None = None
        # soft-withdrawn workers (gray-failure quarantine): alive and
        # possibly still reporting metrics, but zero routable capacity.
        # Fed from instance-card state (runtime/health.py quarantine
        # metadata) by whoever watches the cards — the controller plans
        # a replacement per entry.
        self._quarantined: set[int] = set()

    def start(self) -> "FleetTelemetry":
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._consume()
            )
        return self

    async def _consume(self) -> None:
        try:
            async for _subj, payload in self.hub.subscribe(self.subject):
                try:
                    m = ForwardPassMetrics.from_dict(payload)
                except (KeyError, ValueError, TypeError):
                    log.warning("dropping malformed metrics: %r", payload)
                    continue
                self._latest[m.worker_id] = (self.clock(), m)
        except asyncio.CancelledError:
            pass
        except ConnectionError:
            log.warning("autoscaler metrics subscription lost")

    def ingest(self, m: ForwardPassMetrics) -> None:
        """Direct feed for tests/dryruns (no hub round-trip)."""
        self._latest[m.worker_id] = (self.clock(), m)

    def set_quarantined(self, worker_ids) -> None:
        """Replace the quarantined-worker set (from instance cards)."""
        self._quarantined = set(worker_ids)

    def quarantined(self) -> set[int]:
        return set(self._quarantined)

    def _fresh(self) -> list[ForwardPassMetrics]:
        cutoff = self.clock() - self.stale_after_s
        dead = [w for w, (ts, _) in self._latest.items() if ts < cutoff]
        for w in dead:
            del self._latest[w]
        return [m for _, m in self._latest.values()]

    def signal(self) -> DemandSignal:
        """Aggregate the fresh per-worker reports into one DemandSignal."""
        fresh = self._fresh()
        return DemandSignal(
            demand=float(
                sum(m.running_requests + m.waiting_requests for m in fresh)
            ),
            prefill_queue_tokens=float(
                sum(m.prefill_tokens_queued for m in fresh)
            ),
            workers_observed=len(fresh),
            live_workers_reporting=len(fresh),
            quarantined_workers=len(self._quarantined),
        )

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
