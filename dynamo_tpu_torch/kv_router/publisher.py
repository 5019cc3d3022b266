"""Worker-side publishers: KV cache events + load metrics to the hub (a copy
of dynamo_tpu/kv_router/publisher.py).

Ref: lib/llm/src/kv_router/publisher.rs (KvEventPublisher :92,
WorkerMetricsPublisher :684). The engine (real or mocker) calls
``block_stored``/``blocks_removed`` from its scheduler loop; events batch and
flush to the hub pub/sub subject tagged with this worker's instance id.

Threads: the engine's step thread records ops under a lock and signals the
loop with ``call_soon_threadsafe``, once until the loop has taken the
signal; only the loop publishes. Flushes run one
at a time (an asyncio lock), so a full batch's immediate flush cannot
interleave its runs with the interval flush's and reorder stored/removed.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Any, Iterable

from dynamo_tpu_torch.kv_router.protocols import (
    KV_EVENT_SUBJECT,
    KV_METRICS_SUBJECT,
    BlockStored,
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
)
from dynamo_tpu_torch.runtime.context import spawn
from dynamo_tpu_torch.runtime.hub import Hub

log = logging.getLogger("dynamo.kv.publisher")


class KvEventPublisher:
    def __init__(
        self,
        hub: Hub,
        component_path: str,
        worker_id: int,
        *,
        flush_interval_s: float = 0.05,
        max_batch: int = 256,
    ):
        self.hub = hub
        self.subject = KV_EVENT_SUBJECT.format(component=component_path)
        self.worker_id = worker_id
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        # single ordered op log: ("stored", BlockStored) | ("removed", int).
        # Order matters: remove-then-restore of the same block within one
        # flush window must not be reordered into restore-then-remove.
        self._ops: list[tuple[str, Any]] = []
        self._ops_lock = threading.Lock()  # the step thread appends, the loop swaps
        self._signal_pending = False  # a compute thread's wake-up is queued
        self._flush_lock = asyncio.Lock()
        self._event_id = 0
        self._task: asyncio.Task | None = None
        self._dirty = asyncio.Event()
        self._closed = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: int | None = None

    def start(self) -> "KvEventPublisher":
        if self._task is None:
            self._loop = asyncio.get_running_loop()
            self._loop_thread = threading.get_ident()
            self._task = self._loop.create_task(self._flush_loop())
        return self

    # engine-facing (sync, callable from the scheduler loop) ---------------

    def block_stored(
        self, sequence_hash: int, parent_sequence_hash: int, block_hash: int = 0
    ) -> None:
        op = ("stored", BlockStored(sequence_hash, parent_sequence_hash, block_hash))
        with self._ops_lock:
            self._ops.append(op)
        self._mark_dirty()

    def blocks_removed(self, sequence_hashes: Iterable[int]) -> None:
        ops = [("removed", sh) for sh in sequence_hashes]
        with self._ops_lock:
            self._ops.extend(ops)
        self._mark_dirty()

    def _mark_dirty(self) -> None:
        """Thread-safe: engines call block_stored from compute threads. A
        compute thread wakes the loop once per batch of ops, not once per
        op: each ``call_soon_threadsafe`` writes the loop's self-pipe and
        hands the GIL to the loop thread, and a prompt's seal of 32 blocks
        paid that 32 times on the step thread."""
        if self._loop is None:
            return  # not started yet; ops accumulate until start()
        if threading.get_ident() == self._loop_thread:
            self._signal()
            return
        with self._ops_lock:
            if self._signal_pending:
                return  # the pending signal runs after this op was queued
            self._signal_pending = True
        self._loop.call_soon_threadsafe(self._signal)

    def _signal(self) -> None:
        with self._ops_lock:
            self._signal_pending = False
            n = len(self._ops)
        self._dirty.set()
        if n >= self.max_batch:
            # batch full: flush immediately rather than waiting the interval
            spawn(self.flush(), name="kv-publisher-flush")

    def cache_cleared(self) -> None:
        with self._ops_lock:
            self._ops.clear()
        if self._loop is None:
            return

        def send() -> None:
            self._event_id += 1  # on the loop, as flush's
            ev = RouterEvent(self.worker_id, KvCacheEvent("cleared"), self._event_id)
            spawn(self._publish(ev), name="kv-publisher-cleared")

        if threading.get_ident() == self._loop_thread:
            send()
        else:
            self._loop.call_soon_threadsafe(send)

    # internals ------------------------------------------------------------

    async def _flush_loop(self) -> None:
        try:
            while not self._closed:
                await self._dirty.wait()
                await asyncio.sleep(self.flush_interval_s)
                self._dirty.clear()
                await self.flush()
        except asyncio.CancelledError:
            pass

    async def flush(self) -> None:
        """Publish queued ops as batches, preserving stored/removed order."""
        async with self._flush_lock:
            with self._ops_lock:
                ops, self._ops = self._ops, []
            await self._publish_ops(ops)

    async def _publish_ops(self, ops: list[tuple[str, Any]]) -> None:
        i = 0
        while i < len(ops):
            kind = ops[i][0]
            j = i
            while j < len(ops) and ops[j][0] == kind:
                j += 1
            run = [op[1] for op in ops[i:j]]
            self._event_id += 1
            if kind == "stored":
                ev = KvCacheEvent("stored", stored=tuple(run))
            else:
                ev = KvCacheEvent("removed", removed=tuple(run))
            await self._publish(RouterEvent(self.worker_id, ev, self._event_id))
            i = j

    async def _publish(self, ev: RouterEvent) -> None:
        try:
            await self.hub.publish(self.subject, ev.to_dict())
        except ConnectionError:
            log.warning("hub publish failed (kv event dropped)")

    async def close(self) -> None:
        self._closed = True
        await self.flush()
        if self._task is not None:
            self._task.cancel()


class WorkerMetricsPublisher:
    """Publishes ForwardPassMetrics on change/interval (ref publisher.rs:684)."""

    def __init__(
        self,
        hub: Hub,
        component_path: str,
        worker_id: int,
        *,
        interval_s: float = 0.25,
    ):
        self.hub = hub
        self.subject = KV_METRICS_SUBJECT.format(component=component_path)
        self.worker_id = worker_id
        self.interval_s = interval_s
        self._latest: ForwardPassMetrics | None = None
        self._task: asyncio.Task | None = None
        self._closed = False

    def start(self) -> "WorkerMetricsPublisher":
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    def publish(self, metrics: ForwardPassMetrics) -> None:
        metrics.worker_id = self.worker_id
        self._latest = metrics

    async def _loop(self) -> None:
        try:
            while not self._closed:
                if self._latest is not None:
                    try:
                        await self.hub.publish(self.subject, self._latest.to_dict())
                    except ConnectionError:
                        pass
                await asyncio.sleep(self.interval_s)
        except asyncio.CancelledError:
            pass

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
