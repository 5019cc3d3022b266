"""Cluster-level tenant steering: spread hot tenants across workers (a copy
of dynamo_tpu/kv_router/steering.py).

KV-aware routing loves prefix affinity — a tenant whose requests share a
long preamble scores maximal overlap on ONE worker, so a hot tenant pins
that worker while the rest of the fleet idles (and every other tenant
sharing the pinned worker eats the hot tenant's queueing). Engine-level
fair admission (the reference engine's tenancy.py) arbitrates slots WITHIN a worker; this
module is the cluster-level complement: when a tenant's recent pick rate
marks it hot AND one worker holds more than ``max_share`` of that
tenant's recent picks, that worker is handed to the scheduler as an
exclusion — the next pick lands on the next-best worker, seeding its
cache so affinity genuinely forks instead of bouncing.

Exclusions ride the scheduler's existing fail-open ``exclude`` path
(kv_router/scheduler.py): they are dropped if honoring them would empty
the candidate set, so steering can never blackhole traffic. Untagged
traffic (``tenant=None``) bypasses steering entirely — the temperature-0
pick path stays bit-identical to the oracle for everything untenanted.

Accounting is O(1) per pick: per-(tenant, worker) exponentially-decayed
pick credits with lazy decay, pruned when they decay to noise.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

__all__ = ["SteeringConfig", "TenantSteering"]

_LN2 = math.log(2.0)
_EPS = 1e-3  # credits below this are pruned


@dataclass
class SteeringConfig:
    half_life_s: float = 10.0  # decay of per-(tenant, worker) pick credit
    hot_rate_per_s: float = 2.0  # sustained picks/s marking a tenant hot
    max_share: float = 0.5  # one worker may hold at most this fraction
    # of a hot tenant's recent picks before it is steered around


class _TenantState:
    __slots__ = ("counts", "total", "t")

    def __init__(self, now: float):
        self.counts: dict[int, float] = {}
        self.total = 0.0
        self.t = now


class TenantSteering:
    def __init__(self, cfg: SteeringConfig | None = None,
                 clock=time.monotonic):
        self.cfg = cfg or SteeringConfig()
        self.clock = clock
        self._tenants: dict[str, _TenantState] = {}

    def _decay(self, st: _TenantState, now: float) -> None:
        dt = now - st.t
        if dt <= 0:
            return
        f = 0.5 ** (dt / self.cfg.half_life_s)
        st.t = now
        st.total *= f
        if st.total < _EPS:
            st.counts.clear()
            st.total = 0.0
            return
        dead = []
        for wid in st.counts:
            st.counts[wid] *= f
            if st.counts[wid] < _EPS:
                dead.append(wid)
        for wid in dead:
            del st.counts[wid]

    def record(self, tenant: str, worker_id: int) -> None:
        now = self.clock()
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(now)
        self._decay(st, now)
        st.counts[worker_id] = st.counts.get(worker_id, 0.0) + 1.0
        st.total += 1.0

    def rate(self, tenant: str) -> float:
        """Estimated sustained pick rate: at steady rate r the decayed
        total converges to r * half_life / ln2."""
        st = self._tenants.get(tenant)
        if st is None:
            return 0.0
        self._decay(st, self.clock())
        return st.total * _LN2 / self.cfg.half_life_s

    def exclusions(self, tenant: str) -> set[int]:
        """Workers holding more than max_share of a HOT tenant's recent
        picks; empty for cold/unknown tenants."""
        st = self._tenants.get(tenant)
        if st is None:
            return set()
        self._decay(st, self.clock())
        if st.total * _LN2 / self.cfg.half_life_s < self.cfg.hot_rate_per_s:
            return set()
        bar = self.cfg.max_share * st.total
        return {wid for wid, c in st.counts.items() if c > bar}

    def forget_worker(self, worker_id: int) -> None:
        """Drop a departed worker's credits (fleet churn)."""
        for st in self._tenants.values():
            c = st.counts.pop(worker_id, 0.0)
            st.total -= c

    def snapshot(self) -> dict:
        """Debug/scenario view: {tenant: {worker: credit}}."""
        now = self.clock()
        out = {}
        for tenant, st in self._tenants.items():
            self._decay(st, now)
            if st.counts:
                out[tenant] = dict(st.counts)
        return out
