"""KvRouter + KvPushRouter: the KV-aware routing engines (a copy of
dynamo_tpu/kv_router/router.py).

``KvRouter`` (ref lib/llm/src/kv_router/kv_router.rs:202) owns the radix
index (fed by worker events off the hub), the scheduler (fed by worker
metrics), and active-sequence tracking; ``find_best_match`` is the routing
decision. ``KvPushRouter`` (:476) wraps it as an AsyncEngine operator that
routes preprocessed requests to a specific instance through a PushRouter and
maintains sequence lifecycle around the stream.

Radix state snapshots persist to the hub object store so a restarting router
warm-starts instead of replaying history (ref RADIX_STATE_BUCKET
kv_router.rs:66-71).
"""

from __future__ import annotations

from contextlib import aclosing

import asyncio
import json
import logging
import time
from typing import Any, AsyncIterator

from dynamo_tpu_torch.kv_router.hashing import PrefixHashCache
from dynamo_tpu_torch.kv_router.indexer import ApproxKvIndexer, OverlapScores, RadixTree
from dynamo_tpu_torch.kv_router.protocols import (
    KV_EVENT_SUBJECT,
    KV_METRICS_SUBJECT,
    ForwardPassMetrics,
    RouterConfig,
    RouterEvent,
)
from dynamo_tpu_torch.kv_router.scheduler import KvScheduler
from dynamo_tpu_torch.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.kv_router.steering import SteeringConfig, TenantSteering
from dynamo_tpu_torch.runtime.context import TENANT_HEADER, Context
from dynamo_tpu_torch.runtime.health import is_quarantined
from dynamo_tpu_torch.runtime.hub import Hub
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

log = logging.getLogger("dynamo.kv.router")

RADIX_STATE_BUCKET = "kv-router-state"
# seconds between full prediction refolds in find_best_match — the
# healing backstop for leaked active-sequence state (force-expiry is
# 600 s; a few seconds of stale deprioritization is noise against it)
PREDICTION_SWEEP_S = 5.0

# pick-phase telemetry on every /metrics surface (a module registry):
# where the routing decision spends its time. Buckets sized for a decision
# measured in microseconds, not request latencies.
_REG = MetricsRegistry()
_PICK_SECONDS = _REG.histogram(
    "router_pick_seconds",
    "KV routing decision latency by phase (hash | overlap | select)",
    ["phase"],
    buckets=(0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
             0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05),
)
_PH_HASH = _PICK_SECONDS.labels("hash")
_PH_OVERLAP = _PICK_SECONDS.labels("overlap")
_PH_SELECT = _PICK_SECONDS.labels("select")
ROUTER_SHARD_GAUGE = _REG.gauge(
    "router_shard_id",
    "prefix-hash shard this router process serves (0-based; 0 when "
    "unsharded)",
)
register_registry("kv_router", _REG)


class KvRouter:
    """KV-cache-aware worker selection for one component."""

    def __init__(
        self,
        hub: Hub,
        component_path: str,
        config: RouterConfig | None = None,
    ):
        self.hub = hub
        self.component_path = component_path
        self.config = config or RouterConfig()
        self.tree = RadixTree()
        self.approx = ApproxKvIndexer(self.config.approx_ttl_s)
        self.scheduler = KvScheduler(self.config)
        self.sequences = ActiveSequencesMultiWorker()
        # amortized prefix hashing: repeated preambles skip the
        # O(tokens) chained rehash (DYN_ROUTER_HASH_CACHE bounds it)
        self.hasher = PrefixHashCache.from_env()
        # cluster-level tenant steering (only consulted for tenant-
        # tagged picks; untagged traffic keeps the oracle-identical path)
        self.steering = (
            TenantSteering(SteeringConfig(
                half_life_s=self.config.steer_half_life_s,
                hot_rate_per_s=self.config.steer_hot_rate_per_s,
                max_share=self.config.steer_max_share,
            ))
            if self.config.steer_enabled else None
        )
        # per-phase attribution (seconds + picks), the in-process
        # counterpart of the dynamo_router_pick_seconds histogram —
        # benches read deltas of this without scraping /metrics
        self.pick_phase_totals = {"hash": 0.0, "overlap": 0.0,
                                  "select": 0.0}
        self.picks = 0
        # periodic full prediction refold (see find_best_match): heals
        # scheduler state for workers whose tracked sequences
        # force-expired without a lifecycle event (a caller that died
        # before free()) — without it a leaked stale-high prediction
        # deprioritizes its worker indefinitely, since the per-worker
        # incremental updates only fire when that worker is touched
        self._pred_sweep_at = 0.0
        self._tasks: list[asyncio.Task] = []
        self._started = False
        # retention-boundary accounting: the snapshot records the last
        # event seq it covers; replay verifies the retained tail reaches
        # back to it. A nonzero replay_gap means events were dropped past
        # the hub's retention cap while this router was down — the radix
        # state is INCOMPLETE until workers republish/expire (surfaced
        # loudly, never silently).
        self._snapshot_seq = 0
        self._last_seq = 0
        # False only for legacy snapshots without a recorded seq: the
        # baseline is unknown, so the gap check cannot distinguish
        # "events purged under an old snapshot" from real loss
        self._baseline_known = True
        self.replay_gap = 0

    async def start(self) -> "KvRouter":
        if self._started:
            return self
        self._started = True
        # late-start catch-up = snapshot (compacted base) + event replay
        # (recent tail) — ref kv_router.rs RADIX_STATE_BUCKET restore
        try:
            await self.load_snapshot()
        except Exception:  # noqa: BLE001
            log.warning("radix snapshot restore failed; replay-only start",
                        exc_info=True)
        loop = asyncio.get_running_loop()
        self._tasks.append(loop.create_task(self._consume_events()))
        self._tasks.append(loop.create_task(self._consume_metrics()))
        return self

    # -- event/metrics consumption ----------------------------------------

    async def _consume_events(self) -> None:
        subject = KV_EVENT_SUBJECT.format(component=self.component_path)
        events_since_snapshot = 0
        first = True
        try:
            # replay: catch up on events published before this router started
            async for _subj, payload, seq in self.hub.subscribe(
                subject, replay=True, with_seq=True
            ):
                if first:
                    first = False
                    # retention-boundary check: the tail must reach back
                    # to the snapshot (or to seq 1 when starting fresh) —
                    # anything older fell off the hub's retention cap
                    expected = self._snapshot_seq + 1
                    if self._baseline_known and seq > expected:
                        self.replay_gap = seq - expected
                        log.error(
                            "kv event replay gap: %d events between "
                            "snapshot seq %d and the oldest retained seq "
                            "%d were dropped past the hub retention cap — "
                            "radix state is incomplete until workers "
                            "republish or entries expire",
                            self.replay_gap, self._snapshot_seq, seq,
                        )
                if seq <= self._snapshot_seq:
                    continue  # already folded into the restored snapshot
                self._last_seq = seq
                try:
                    ev = RouterEvent.from_dict(payload)
                    self.tree.apply_event(ev.worker_id, ev.event)
                except (KeyError, ValueError, TypeError):
                    # one malformed event must not kill the consumer
                    log.warning("dropping malformed kv event: %r", payload)
                    continue
                events_since_snapshot += 1
                if events_since_snapshot >= self.config.snapshot_threshold:
                    # compaction (ref router_snapshot_threshold,
                    # kv_router.rs:66-71): persist the radix state, then
                    # trim ONLY the retained events this snapshot covers
                    # (<= seq) — later events a late router hasn't seen
                    # must survive for its replay.
                    events_since_snapshot = 0
                    try:
                        await self.save_snapshot()
                        dropped = await self.hub.purge_subject(
                            subject, up_to_seq=seq
                        )
                        log.info(
                            "radix snapshot saved; purged %d covered events",
                            dropped,
                        )
                    except Exception:  # noqa: BLE001
                        log.warning("snapshot compaction failed",
                                    exc_info=True)
        except asyncio.CancelledError:
            pass
        except ConnectionError:
            log.warning("kv event subscription lost")

    async def _consume_metrics(self) -> None:
        subject = KV_METRICS_SUBJECT.format(component=self.component_path)
        try:
            async for _subj, payload in self.hub.subscribe(subject):
                try:
                    self.scheduler.update_metrics(ForwardPassMetrics.from_dict(payload))
                except (KeyError, ValueError, TypeError):
                    log.warning("dropping malformed metrics: %r", payload)
        except asyncio.CancelledError:
            pass
        except ConnectionError:
            log.warning("kv metrics subscription lost")

    # -- membership --------------------------------------------------------

    def update_workers(self, worker_ids) -> None:
        live = set(worker_ids)
        for gone in self.tree.workers() - live:
            self.tree.remove_worker(gone)
            self.approx.remove_worker(gone)
            if self.steering is not None:
                self.steering.forget_worker(gone)
        self.scheduler.update_workers(worker_ids)
        self.sequences.update_workers(worker_ids)

    # -- the routing decision ---------------------------------------------

    def find_best_match(
        self, request_id: str, token_ids: list[int], *,
        salt: str | None = None, exclude: "set[int] | None" = None,
        tenant: str | None = None,
    ) -> tuple[int, int]:
        """Pick a worker for ``token_ids``; returns (worker_id, overlap_blocks).

        Registers the request in active-sequence tracking; callers MUST pair
        with ``free(request_id)`` when the stream ends.

        ``exclude``: instance ids the caller's circuit breakers have
        ejected — dropped from the candidate set
        unless that would leave NO candidates, in which case the
        exclusion is ignored (fail open: a fully-browned-out pool still
        routes rather than blackholing).

        ``tenant``: tenancy tag for cluster-level steering — a hot
        tenant concentrated on one worker gets that worker added to the
        exclusions (same fail-open semantics) so affinity spreads
        instead of pinning. None (untagged) never consults steering.
        """
        bs = self.config.block_size
        # rare O(instances) prediction sweep (time-bounded, NOT
        # per-pick): refold every worker's tracked load so force-expired
        # leaked sequences heal even for workers no lifecycle event
        # touches. The steady-state pick still never walks the fleet.
        now = time.monotonic()
        if now >= self._pred_sweep_at:
            self._pred_sweep_at = now + PREDICTION_SWEEP_S
            for wid, (blocks, ptok) in self.sequences.loads().items():
                self.scheduler.set_predicted_load(wid, blocks, ptok)
        t0 = time.perf_counter()
        seq_hashes = self.hasher.sequence_hashes(token_ids, bs, salt)
        request_blocks = max(len(token_ids) // bs, 1)

        t1 = time.perf_counter()
        overlaps = self.tree.find_matches(seq_hashes)
        if self.config.use_approx:
            approx_overlaps = self.approx.find_matches(seq_hashes)
            for wid, score in approx_overlaps.scores.items():
                overlaps.scores[wid] = max(overlaps.scores.get(wid, 0), score)

        # NOTE: predictions are NOT folded here — the scheduler's view
        # is updated incrementally at sequence lifecycle points
        # (_push_predicted below), so the pick never pays an
        # O(instances) prediction sweep.
        if tenant is not None and self.steering is not None:
            steered = self.steering.exclusions(tenant)
            if steered:
                exclude = (set(exclude) | steered) if exclude else steered
        t2 = time.perf_counter()
        worker_id, overlap = self.scheduler.schedule(
            request_blocks, overlaps, exclude=exclude
        )
        t3 = time.perf_counter()
        if tenant is not None and self.steering is not None:
            self.steering.record(tenant, worker_id)
        self.sequences.add_request(
            request_id,
            worker_id,
            blocks=request_blocks - overlap,
            prefill_tokens=max(len(token_ids) - overlap * bs, 0),
        )
        self._push_predicted(worker_id)
        if self.config.use_approx:
            parents = [0] + seq_hashes[:-1]
            self.approx.process_routing_decision(worker_id, seq_hashes, parents)
        totals = self.pick_phase_totals
        totals["hash"] += t1 - t0
        totals["overlap"] += t2 - t1
        totals["select"] += t3 - t2
        self.picks += 1
        _PH_HASH.observe(t1 - t0)
        _PH_OVERLAP.observe(t2 - t1)
        _PH_SELECT.observe(t3 - t2)
        return worker_id, overlap

    def _push_predicted(self, worker_id: int | None) -> None:
        """Refresh the scheduler's predicted load for ONE worker — the
        only one a lifecycle event (route / prefill-done / free) can
        have changed."""
        if worker_id is not None:
            blocks, ptok = self.sequences.load_of(worker_id)
            self.scheduler.set_predicted_load(worker_id, blocks, ptok)

    def mark_prefill_done(self, request_id: str) -> None:
        self.sequences.mark_prefill_done(request_id)
        self._push_predicted(self.sequences.worker_of(request_id))

    def free(self, request_id: str) -> None:
        wid = self.sequences.worker_of(request_id)
        self.sequences.free(request_id)
        self._push_predicted(wid)

    # -- snapshots ---------------------------------------------------------

    async def save_snapshot(self) -> None:
        data = json.dumps({
            "seq": self._last_seq,
            "boot": await self.hub.get_boot_id(),
            "tree": self.tree.snapshot(),
        }).encode()
        await self.hub.put_object(
            RADIX_STATE_BUCKET, self.component_path.replace("/", "_"), data
        )

    async def load_snapshot(self) -> bool:
        data = await self.hub.get_object(
            RADIX_STATE_BUCKET, self.component_path.replace("/", "_")
        )
        if not data:
            return False
        obj = json.loads(data)
        if isinstance(obj, dict) and "tree" in obj:
            self._snapshot_seq = int(obj.get("seq") or 0)
            boot_then = obj.get("boot")
            boot_now = await self.hub.get_boot_id()
            if boot_then and boot_now and boot_then != boot_now:
                # hub restarted since the snapshot: per-subject seq
                # counters reset, so the recorded baseline is from an
                # incomparable seq space. Replay everything retained over
                # the restored tree (stored events re-add; loud, not
                # silent staleness).
                log.warning(
                    "hub rebooted since radix snapshot (boot %s -> %s): "
                    "seq baseline reset, replaying all retained events",
                    boot_then, boot_now,
                )
                self._snapshot_seq = 0
            self._last_seq = self._snapshot_seq
            obj = obj["tree"]
        else:
            # legacy snapshot without a seq baseline: gap check impossible
            self._baseline_known = False
        self.tree = RadixTree.restore(obj)
        return True

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()


class KvPushRouter:
    """AsyncEngine operator: KV-route then stream from the chosen instance.

    Wraps a PushRouter (direct mode) around KvRouter decisions; keeps the
    router's active-sequence state in sync with stream lifecycle. Ref:
    kv_router.rs:476-491 KvPushRouter.
    """

    def __init__(self, push_router, kv_router: KvRouter, *, salt: str | None = None):
        self.push_router = push_router
        self.kv_router = kv_router
        self.salt = salt
        # membership memo: update_workers walks scheduler/sequence/radix
        # state for EVERY worker, and running it per request made fleet
        # churn reconciliation an O(instances) tax on every pick at
        # fleet scale — skip it when nothing
        # changed since the last request. The memo key covers BOTH the
        # client's membership generation (bumped on every watch-driven
        # instance add/remove) AND the scheduler's states_version: a
        # dead worker's replayed metrics tail can re-create its
        # scheduler state after the prune, and without the version in
        # the key that zombie would stay routable until the next real
        # membership change (exactly the 503 storm the churn soak
        # caught when the memo was set-only).
        self._members_gen_seen = -1
        self._states_seen = -1
        # soft-withdrawn (quarantined) instance ids, recomputed on the
        # same memo: a quarantine republish is a card put, which bumps
        # membership_gen, so this set is never stale
        self._quarantined: set[int] = set()

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[Any]:
        token_ids = request.get("token_ids") or []
        # live membership reconciliation before deciding (memoized: a
        # no-change reconcile is two int compares)
        client = self.push_router.client
        sched = self.kv_router.scheduler
        if (
            client.membership_gen != self._members_gen_seen
            or sched.states_version != self._states_seen
        ):
            self.kv_router.update_workers(client.instance_ids())
            self._quarantined = {
                inst.instance_id
                for inst in client.instances()
                if is_quarantined(inst)
            }
            self._members_gen_seen = client.membership_gen
            self._states_seen = sched.states_version

        pinned = request.get("backend_instance_id")
        # per-request cache-partition salt (multimodal: image digest) —
        # must match the engine's salted block hashes or overlap
        # estimates are systematically wrong for image traffic
        req_salt = (request.get("multimodal") or {}).get("salt") or self.salt
        if pinned is not None:
            # the pick already happened upstream (an external picker): route
            # straight to it, and keep the picker's overlap estimate if
            # it sent one instead of stomping it to 0
            worker_id = pinned
            overlap = int(request.get("estimated_prefix_hit_num_blocks") or 0)
        else:
            # tenant-tagged traffic engages cluster-level steering; the
            # header is only present when a frontend/client set it, so
            # untagged callers keep the oracle-identical pick path
            tenant = (context.headers or {}).get(TENANT_HEADER) or None
            # quarantined instances are soft-withdrawn: excluded from the
            # pick with the scheduler's fail-open semantics (a fully
            # quarantined pool still routes rather than blackholing)
            worker_id, overlap = self.kv_router.find_best_match(
                context.id, token_ids, salt=req_salt, tenant=tenant,
                exclude=self._quarantined or None,
            )
        request = dict(request)
        request["estimated_prefix_hit_num_blocks"] = overlap
        first = True
        try:
            stream = self.push_router.generate(
                request, context, instance_id=worker_id
            )
            async with aclosing(stream):
                async for item in stream:
                    if first:
                        first = False
                        self.kv_router.mark_prefill_done(context.id)
                    yield item
        finally:
            self.kv_router.free(context.id)

    def best_worker_id(
        self, token_ids: list[int], request_id: str = "probe",
        *, salt: str | None = None, tenant: str | None = None,
    ) -> tuple[int, int]:
        """Routing decision without dispatch (standalone router service
        API). ``salt``: per-request cache-partition salt (multimodal
        image digest) — must match the engine's block hashing or the
        overlap estimate is systematically wrong for image traffic."""
        wid, overlap = self.kv_router.find_best_match(
            request_id, token_ids, salt=salt or self.salt, tenant=tenant
        )
        self.kv_router.free(request_id)
        return wid, overlap
