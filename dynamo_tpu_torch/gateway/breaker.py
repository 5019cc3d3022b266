"""Per-instance circuit breakers for the pick path (the port's copy of
dynamo_tpu/gateway/breaker.py: EPP / routers).

A sick worker — crashing handlers, pathological latency, a wedged step
thread — keeps its instance key alive as long as its lease holds, so
pure liveness-based routing feeds it every Nth request until the lease
reaper or a human notices. The breaker closes that gap with the classic
three-state machine driven by OBSERVED OUTCOMES (error/latency scoring
over a rolling window), so a sick worker browns out within a window's
worth of traffic and is re-admitted by probes once it recovers:

  CLOSED     normal routing; outcomes recorded into the rolling window.
             Trips OPEN when the window holds >= ``min_samples`` and the
             failure score (errors + over-SLO latencies, each weighted
             1.0) exceeds ``failure_threshold``.
  OPEN       excluded from picks for ``open_cooldown_s``; after the
             cooldown the breaker moves to HALF-OPEN.
  HALF-OPEN  up to ``half_open_probes`` picks are allowed through as
             probes. A failure re-opens (fresh cooldown); enough
             successes (``close_after`` consecutive) close the breaker
             and clear the window.

State is exported as ``dynamo_epp_breaker_state{instance}`` (0 closed,
1 half-open, 2 open) so dashboards can see a brownout AS a brownout.
The ``epp.breaker`` fault site (fired per recorded outcome at the
owning picker) lets chaos schedules force outcomes without a genuinely
sick worker.
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass

log = logging.getLogger("dynamo_tpu_torch.gateway.breaker")

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}


@dataclass
class BreakerConfig:
    window: int = 32  # rolling outcome window per instance (count)
    window_s: float = 60.0  # outcomes older than this age out
    min_samples: int = 8  # no verdicts off tiny samples
    failure_threshold: float = 0.5  # failure score fraction that trips
    latency_slo_s: float = 0.0  # >SLO latency counts as a failure; 0 = off
    open_cooldown_s: float = 10.0  # OPEN hold before half-open probing
    half_open_probes: int = 2  # concurrent-ish probes allowed half-open
    close_after: int = 2  # consecutive probe successes that close
    # a half-open probe whose outcome is never reported (the /report
    # feedback is best-effort: the caller may crash or just not report)
    # expires after this long, releasing its slot — without it a couple
    # of unreported probes would wedge the breaker HALF-OPEN forever
    probe_timeout_s: float = 30.0


class CircuitBreaker:
    """One instance's breaker. Single-threaded (event-loop) use."""

    def __init__(self, config: BreakerConfig | None = None):
        self.config = config or BreakerConfig()
        self._window: collections.deque = collections.deque(
            maxlen=self.config.window
        )  # (ts, failed)
        self._state = CLOSED
        self._opened_at = 0.0
        self._probes_inflight: list[float] = []  # admission timestamps
        self._probe_successes = 0

    # -- scoring -----------------------------------------------------------

    def _prune(self, now: float) -> None:
        horizon = now - self.config.window_s
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()

    def _failure_frac(self, now: float) -> float:
        self._prune(now)
        if not self._window:
            return 0.0
        return sum(f for _t, f in self._window) / len(self._window)

    # -- transitions -------------------------------------------------------

    def record(
        self, ok: bool, latency_s: float = 0.0, now: float | None = None
    ) -> None:
        """Feed one observed outcome (a completed request, a failed
        dispatch, an injected chaos outcome)."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        failed = (not ok) or (
            cfg.latency_slo_s > 0 and latency_s > cfg.latency_slo_s
        )
        if self._state == HALF_OPEN:
            if self._probes_inflight:
                self._probes_inflight.pop(0)
            if failed:
                # a failing probe re-opens with a fresh cooldown
                self._state = OPEN
                self._opened_at = now
                self._probe_successes = 0
                return
            self._probe_successes += 1
            if self._probe_successes >= cfg.close_after:
                self._state = CLOSED
                self._window.clear()
                self._probe_successes = 0
            return
        self._window.append((now, 1 if failed else 0))
        if self._state == CLOSED:
            if (
                len(self._window) >= cfg.min_samples
                and self._failure_frac(now) >= cfg.failure_threshold
            ):
                self._state = OPEN
                self._opened_at = now
                self._probe_successes = 0

    def allow(self, now: float | None = None) -> bool:
        """May this instance be picked right now? OPEN past its cooldown
        transitions to HALF-OPEN here (probe admission)."""
        now = time.monotonic() if now is None else now
        if self._state == CLOSED:
            return True
        if self._state == OPEN:
            if now - self._opened_at < self.config.open_cooldown_s:
                return False
            self._state = HALF_OPEN
            self._probes_inflight = []
            self._probe_successes = 0
        # HALF_OPEN: bounded probe admission; unreported probes expire
        # (feedback is best-effort) so the breaker can never wedge here
        horizon = now - self.config.probe_timeout_s
        self._probes_inflight = [
            t for t in self._probes_inflight if t >= horizon
        ]
        if len(self._probes_inflight) < self.config.half_open_probes:
            self._probes_inflight.append(now)
            return True
        return False

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self._state]


class BreakerBoard:
    """All instances' breakers for one picker, plus the gauge bridge."""

    def __init__(
        self,
        config: BreakerConfig | None = None,
        *,
        on_state: "callable | None" = None,
        on_forget: "callable | None" = None,
    ):
        self.config = config or BreakerConfig()
        self._breakers: dict[int, CircuitBreaker] = {}
        # gauge hooks: on_state(instance_id, state_int) on every record/
        # allow touch, on_forget(instance_id) when a breaker is GC'd —
        # the EPP bridges them into dynamo_epp_breaker_state{instance}
        # (set / remove), so a departed worker's series disappears
        # instead of reporting a phantom state forever
        self.on_state = on_state
        self.on_forget = on_forget

    def _get(self, instance_id: int) -> CircuitBreaker:
        b = self._breakers.get(instance_id)
        if b is None:
            b = self._breakers[instance_id] = CircuitBreaker(self.config)
        return b

    def _publish(self, instance_id: int, b: CircuitBreaker) -> None:
        if self.on_state is not None:
            self.on_state(instance_id, b.state)

    def record(self, instance_id: int, ok: bool, latency_s: float = 0.0) -> None:
        b = self._get(instance_id)
        prev = b.state
        b.record(ok, latency_s)
        if b.state != prev:
            log.warning(
                "breaker %x: %s -> %s",
                instance_id, _STATE_NAMES[prev], b.state_name,
            )
        self._publish(instance_id, b)

    def allow(self, instance_id: int) -> bool:
        b = self._get(instance_id)
        out = b.allow()
        self._publish(instance_id, b)
        return out

    def state(self, instance_id: int) -> int:
        return self._get(instance_id).state

    def state_name(self, instance_id: int) -> str:
        return self._get(instance_id).state_name

    def knows(self, instance_id: int) -> bool:
        """True when this board already tracks the instance (without
        minting state for it — the /report membership guard)."""
        return instance_id in self._breakers

    def ejected(self) -> set[int]:
        """Instances currently excluded outright (OPEN inside cooldown).
        Half-open instances are NOT here — probes must reach them."""
        now = time.monotonic()
        return {
            iid for iid, b in self._breakers.items()
            if b.state == OPEN
            and now - b._opened_at < b.config.open_cooldown_s
        }

    def forget(self, live_ids: "set[int] | None" = None) -> None:
        """Drop breakers (and their gauge series, via on_forget) for
        instances that no longer exist (lease expiry/deregistration) so
        neither the board nor /metrics grows unbounded."""
        gone = [
            iid for iid in self._breakers
            if live_ids is None or iid not in live_ids
        ]
        for iid in gone:
            del self._breakers[iid]
            if self.on_forget is not None:
                self.on_forget(iid)
