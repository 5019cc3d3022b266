"""Per-tenant fair admission: weighted-fair queues + token-bucket quotas.

The counterpart of dynamo_tpu/engine/tenancy.py, copied whole; its lock is
a ``threading.Lock`` (the reference's ``race.Lock`` annotates it for its
race checker, which this package does not carry).

The overload half of the robustness story: one batch tenant
must not be able to saturate an engine and have every interactive user
eat the same newest-first 503. This module replaces the engine's single
FIFO ``_waiting`` queue with:

- **Priority classes**: ``interactive`` strictly ahead of ``batch`` at
  every dequeue — a full batch backlog never delays an interactive
  admission by more than the in-flight work.
- **Weighted-fair queuing within a class**: per-tenant FIFO deques
  scheduled by virtual-time stride scheduling (vtime advances by
  ``cost / weight`` per dequeue), so a 4-weight tenant drains 4x the
  token volume of a 1-weight tenant under contention — but an idle
  tenant banks no credit (vtime re-joins at the class clock).
- **Token-bucket quotas**: per-tenant refill ``rate`` (tokens/s) and
  ``burst`` capacity, charged at admission with the request's token
  cost (prompt + decode budget). Over-quota requests bounce with a
  typed :class:`~dynamo_tpu_torch.runtime.context.OverQuota` whose
  ``retry_after_s`` is computed FROM BUCKET STATE (deficit / refill
  rate) — the HTTP frontend maps it to 429 + Retry-After.
- **Policy-ordered shedding**: when ``max_waiting`` overflows, the
  victim is the lowest-priority, most-over-quota, newest entry — never
  blindly the arriving request.

Quota spec grammar (``DYN_TENANT_QUOTAS`` / ``EngineConfig.tenants`` /
``--tenant-quotas``)::

    tenantA:weight=4,rate=1000,burst=2000;tenantB:rate=50;*:rate=200

``*`` is the default applied to tenants with no explicit entry;
omitted fields fall back to weight=1, rate=0 (0 = unmetered), burst =
4x rate (or unlimited when rate is 0).

Thread-safety: the scheduler is mutated from the event loop (enqueue,
shed) and the step thread (dequeue, peek, preemption bookkeeping); one
internal lock covers all state, and every operation is non-blocking.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

PRIORITIES = ("interactive", "batch")
DEFAULT_TENANT = "default"


@dataclass
class TenantQuota:
    """Static per-tenant policy: fair-share weight + token bucket."""

    weight: float = 1.0
    rate: float = 0.0  # tokens/second refill; 0 = unmetered
    burst: float = 0.0  # bucket capacity; 0 = 4x rate (unlimited if rate 0)

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.rate < 0 or self.burst < 0:
            raise ValueError("tenant rate/burst must be >= 0")
        if self.burst == 0 and self.rate > 0:
            self.burst = 4 * self.rate


def parse_tenant_quotas(spec: str) -> dict[str, TenantQuota]:
    """Parse the quota spec grammar (see module doc). Raises ValueError
    naming the offending entry so a bad ``DYN_TENANT_QUOTAS`` fails the
    worker loudly at startup instead of silently unmetering a tenant."""
    out: dict[str, TenantQuota] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        tenant, _, rest = entry.partition(":")
        tenant = tenant.strip()
        if not tenant:
            raise ValueError(f"tenant quota entry {entry!r}: empty tenant id")
        kwargs: dict[str, float] = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in ("weight", "rate", "burst"):
                raise ValueError(
                    f"tenant quota entry {entry!r}: unknown field {k!r} "
                    "(want weight/rate/burst)"
                )
            try:
                kwargs[k] = float(v)
            except ValueError:
                raise ValueError(
                    f"tenant quota entry {entry!r}: {k}={v!r} is not a number"
                ) from None
        out[tenant] = TenantQuota(**kwargs)
    return out


class TokenBucket:
    """Classic token bucket, refilled lazily on access. NOT thread-safe
    on its own — the owning scheduler's lock covers it."""

    def __init__(self, quota: TenantQuota, now: float | None = None):
        self.rate = quota.rate
        self.burst = quota.burst
        self.level = quota.burst  # start full: a fresh tenant may burst
        self._last = time.monotonic() if now is None else now

    def _refill(self, now: float) -> None:
        if self.rate > 0:
            self.level = min(
                self.burst, self.level + (now - self._last) * self.rate
            )
        self._last = now

    def try_take(self, n: float, now: float | None = None) -> bool:
        """Charge ``n`` tokens; False (nothing taken) when over quota.
        A request costing more than the whole burst charges the full
        burst instead — it needs a FULL bucket, not an unreachable one
        (otherwise any prompt bigger than the burst would be permanently
        unadmittable rather than rate-limited)."""
        if self.rate <= 0:
            return True  # unmetered
        n = min(n, self.burst)
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.level >= n:
            self.level -= n
            return True
        return False

    def retry_after_s(self, n: float, now: float | None = None) -> float:
        """Seconds until ``n`` tokens will be available — the Retry-After
        a 429 carries, derived from live bucket state."""
        if self.rate <= 0:
            return 0.0
        now = time.monotonic() if now is None else now
        self._refill(now)
        deficit = max(min(n, self.burst) - self.level, 0.0)
        return deficit / self.rate

    def over_quota(self, now: float | None = None) -> bool:
        """Drained below one token: the preemption/shedding eligibility
        predicate (a tenant submitting unbounded work pins its bucket
        here)."""
        if self.rate <= 0:
            return False
        now = time.monotonic() if now is None else now
        self._refill(now)
        return self.level < 1.0


class _TenantLane:
    """One tenant's FIFO within a priority class, with its WFQ vtime."""

    __slots__ = ("entries", "vtime")

    def __init__(self) -> None:
        self.entries: collections.deque = collections.deque()
        self.vtime = 0.0


class TenantScheduler:
    """Weighted-fair, quota-metered replacement for the engine's waiting
    queue. API-compatible with the subset of ``queue.Queue`` the engine
    used (``put_nowait`` / ``get_nowait`` / ``empty`` / ``qsize``), so
    the step loop's drain sweeps work unchanged.

    Entries are the engine's ``_Waiting`` records; the scheduler reads
    their ``tenant`` / ``priority`` / ``cost`` attributes (defaulted for
    direct callers that never touched tenancy)."""

    # dynamically-discovered tenants tracked individually before new
    # ones collapse into the shared OVERFLOW_TENANT (bounds memory and
    # metric-label cardinality against an attacker minting a fresh
    # tenant id — or rotating Authorization credential — per request;
    # configured tenants are always tracked individually)
    MAX_DYNAMIC_TENANTS = 1024
    OVERFLOW_TENANT = "overflow"

    def __init__(self, quotas: dict[str, TenantQuota] | None = None):
        self._lock = threading.Lock()
        self.quotas = dict(quotas or {})
        self._default_quota = self.quotas.pop("*", TenantQuota())
        self._buckets: dict[str, TokenBucket] = {}
        # lanes[priority][tenant] -> _TenantLane; class-level virtual
        # clock advances to the dequeued lane's vtime so idle tenants
        # re-join at "now" instead of replaying banked history
        self._lanes: dict[str, dict[str, _TenantLane]] = {
            p: {} for p in PRIORITIES
        }
        self._vclock: dict[str, float] = {p: 0.0 for p in PRIORITIES}
        self._size = 0
        # observability feed (engine telemetry drains the deltas):
        # (tenant, outcome) -> token count; outcomes: admitted |
        # rejected | shed
        self.token_counts: dict[tuple[str, str], int] = {}

    # -- quota -------------------------------------------------------------

    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self._default_quota)

    def resolve(self, tenant: str) -> str:
        """Bound per-tenant state: configured and already-tracked
        tenants keep their identity; past MAX_DYNAMIC_TENANTS distinct
        dynamic ids, new ones share the overflow tenant (fairness
        degrades gracefully instead of memory/cardinality growing with
        every rotated credential)."""
        with self._lock:
            if tenant in self.quotas or tenant in self._buckets:
                return tenant
            if len(self._buckets) >= self.MAX_DYNAMIC_TENANTS:
                return self.OVERFLOW_TENANT
            return tenant

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(self.quota_for(tenant))
        return b

    def _count(self, tenant: str, outcome: str, tokens: float) -> None:
        key = (tenant, outcome)
        self.token_counts[key] = self.token_counts.get(key, 0) + int(tokens)

    def charge(self, tenant: str, cost: float) -> float | None:
        """Charge ``cost`` tokens against the tenant's bucket. Returns
        None when admitted, else the Retry-After seconds for the typed
        429 (nothing charged)."""
        with self._lock:
            bucket = self._bucket(tenant)
            if bucket.try_take(cost):
                self._count(tenant, "admitted", cost)
                return None
            self._count(tenant, "rejected", cost)
            return max(bucket.retry_after_s(cost), 0.05)

    def refund(self, tenant: str, cost: float) -> None:
        """Credit back a charge whose request was bounced AFTER charging
        (saturation re-check, shed while waiting, post-charge staging
        failures): the tenant received no service, so its bucket must
        not pay — otherwise every bounce-and-retry cycle double-charges
        and retryable 503s decay into 429s. Capped at burst."""
        with self._lock:
            b = self._bucket(tenant)
            if b.rate > 0:
                b.level = min(b.level + min(cost, b.burst), b.burst)
            # token_counts stays as-charged: the Prometheus counter must
            # not move backwards, and the bounce itself is already
            # visible under the shed/saturated reject counters

    def tenant_over_quota(self, tenant: str) -> bool:
        with self._lock:
            return self._bucket(tenant).over_quota()

    def bucket_level(self, tenant: str) -> float:
        """Current bucket level (refreshed); inf for unmetered tenants."""
        with self._lock:
            b = self._bucket(tenant)
            if b.rate <= 0:
                return float("inf")
            b._refill(time.monotonic())
            return b.level

    # -- queue -------------------------------------------------------------

    def put_nowait(self, waiting: Any) -> None:
        """Enqueue one waiting record under its (priority, tenant) lane."""
        priority = getattr(waiting, "priority", "interactive")
        if priority not in PRIORITIES:
            priority = "interactive"
        tenant = getattr(waiting, "tenant", DEFAULT_TENANT)
        with self._lock:
            lanes = self._lanes[priority]
            lane = lanes.get(tenant)
            if lane is None:
                lane = lanes[tenant] = _TenantLane()
            # re-joining lane starts at the class clock: fairness is
            # about contended throughput, not banked idle time
            if not lane.entries:
                lane.vtime = max(lane.vtime, self._vclock[priority])
            lane.entries.append(waiting)
            self._size += 1

    def _next_lane(self, priority: str) -> tuple[str, _TenantLane] | None:
        lanes = self._lanes[priority]
        best: tuple[str, _TenantLane] | None = None
        for tenant, lane in lanes.items():
            if not lane.entries:
                continue
            if best is None or lane.vtime < best[1].vtime:
                best = (tenant, lane)
        return best

    def _peek_locked(self) -> Any | None:
        for priority in PRIORITIES:
            best = self._next_lane(priority)
            if best is not None:
                return best[1].entries[0]
        return None

    def get_nowait(self) -> Any:
        """Dequeue by policy: interactive class first, then min-vtime
        lane within the class. Raises ``queue.Empty`` when empty."""
        with self._lock:
            for priority in PRIORITIES:
                best = self._next_lane(priority)
                if best is None:
                    continue
                tenant, lane = best
                w = lane.entries.popleft()
                cost = float(getattr(w, "cost", 1.0) or 1.0)
                weight = self.quota_for(tenant).weight
                lane.vtime += cost / weight
                self._vclock[priority] = max(
                    self._vclock[priority], lane.vtime
                )
                if not lane.entries:
                    # drop emptied lanes so peek/dequeue scans stay
                    # proportional to ACTIVE tenants, not every tenant
                    # ever seen. No vtime history is lost: the vclock
                    # was just advanced to this lane's vtime, and a
                    # re-joining lane starts at the vclock anyway.
                    del self._lanes[priority][tenant]
                self._size -= 1
                return w
            raise _queue.Empty

    def requeue(self, waiting: Any) -> None:
        """Put a just-dequeued entry BACK AT ITS LANE HEAD with the
        dequeue's vtime advance undone: a page-stall retry is zero
        service, so it must neither burn the tenant's fair share nor
        drop the entry behind later same-tenant arrivals."""
        priority = getattr(waiting, "priority", "interactive")
        if priority not in PRIORITIES:
            priority = "interactive"
        tenant = getattr(waiting, "tenant", DEFAULT_TENANT)
        with self._lock:
            lanes = self._lanes[priority]
            lane = lanes.get(tenant)
            if lane is None:
                # the dequeue may have dropped the emptied lane; the
                # vclock recorded its post-dequeue vtime, so starting
                # there and undoing the advance restores it exactly
                lane = lanes[tenant] = _TenantLane()
                lane.vtime = self._vclock[priority]
            cost = float(getattr(waiting, "cost", 1.0) or 1.0)
            lane.vtime -= cost / self.quota_for(tenant).weight
            lane.entries.appendleft(waiting)
            self._size += 1

    def peek(self) -> Any | None:
        """The record ``get_nowait`` would return (step thread only —
        the single consumer keeps the head stable)."""
        with self._lock:
            return self._peek_locked()

    def empty(self) -> bool:
        return self._size == 0

    def qsize(self) -> int:
        return self._size

    def sheddable_below(self, incoming_priority: str) -> bool:
        """True when a STRICTLY lower-priority entry is waiting (a shed
        candidate for an ``incoming_priority`` arrival)."""
        order = list(reversed(PRIORITIES))
        try:
            cut = order.index(incoming_priority)
        except ValueError:
            cut = 0
        with self._lock:
            return any(
                lane.entries
                for priority in order[:cut]
                for lane in self._lanes[priority].values()
            )

    def shed_victim(
        self, incoming_priority: str,
        keep: Callable[[Any], bool] | None = None,
    ) -> Any | None:
        """Remove + return the entry shedding policy says to bounce so an
        ``incoming_priority`` request can enqueue: STRICTLY lower
        priority classes only (shedding a same-class peer for the
        newcomer would just move the bounce), most-over-quota tenant
        (lowest bucket level) first, then the NEWEST entry of that lane
        — the oldest keeps its place in line. None when nothing ranks
        below the incoming request (the caller bounces the incoming
        request instead, exactly the old behavior for a batch arrival)."""
        order = list(reversed(PRIORITIES))  # lowest class first
        try:
            cut = order.index(incoming_priority)
        except ValueError:
            cut = 0
        with self._lock:
            now = time.monotonic()
            for priority in order[:cut]:
                lanes = self._lanes[priority]
                candidates = [
                    (t, lane) for t, lane in lanes.items() if lane.entries
                ]
                if not candidates:
                    continue

                def level(t: str) -> float:
                    b = self._bucket(t)
                    if b.rate <= 0:
                        return float("inf")
                    b._refill(now)
                    return b.level

                candidates.sort(key=lambda tl: level(tl[0]))
                for tenant, lane in candidates:
                    for i in range(len(lane.entries) - 1, -1, -1):
                        w = lane.entries[i]
                        if keep is not None and keep(w):
                            continue
                        del lane.entries[i]
                        if not lane.entries:
                            del self._lanes[priority][tenant]
                        self._size -= 1
                        self._count(
                            tenant, "shed",
                            float(getattr(w, "cost", 1.0) or 1.0),
                        )
                        return w
            return None

    def drain(self) -> Iterable[Any]:
        """Pop everything (error/close sweeps), FIFO-ish per lane."""
        with self._lock:
            out: list[Any] = []
            for lanes in self._lanes.values():
                for lane in lanes.values():
                    out.extend(lane.entries)
                lanes.clear()
            self._size = 0
            return out

    def waiting_by_tenant(self) -> dict[str, int]:
        """Queue depth per tenant (observability / tests)."""
        with self._lock:
            out: dict[str, int] = {}
            for lanes in self._lanes.values():
                for tenant, lane in lanes.items():
                    if lane.entries:
                        out[tenant] = out.get(tenant, 0) + len(lane.entries)
            return out
