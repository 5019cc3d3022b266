"""Deterministic fault-injection layer: named fault points, seeded schedules.

The recovery machinery in this framework (frontend/migration.py re-drives,
runtime/health.py withdrawal, transport drain, hub client failover) only gets
exercised when something actually fails. This module makes failure a
first-class, *reproducible* input: code under test declares named fault
points (``fire("transport.send")``), and a process-wide registry decides —
from a seeded per-site RNG — whether that call drops, delays, or errors.
Ref: the reference's fault-tolerance test tier provokes failures with real
SIGKILLs (tests/fault_tolerance/); this layer covers the partial-failure
space kill -9 can't reach (slow fsync, lossy links, flaky admission).

Spec grammar (``DYN_FAULTS`` env var, or the worker admin ``faults`` RPC)::

    site:action[=param][@prob][xN][~instance][,site:action...]

    transport.send:drop@0.02          2% of sends die like a cut connection
    hub.fsync:delay=50ms              every WAL fsync takes +50ms
    engine.step:error@0.001           1-in-1000 steps raises (recovery path)
    disagg.pull:error@1x1             the first KV pull fails, then clean
    disagg.pull:corrupt=3x1           flip 3 bits in the first pulled KV
                                      payload (checksum detection path)
    engine.step:delay=80ms~10.0.0.3:*   sticky per-instance degradation:
                                      only the worker whose fault identity
                                      matches the fnmatch pattern slows
                                      down (the gray-failure straggler)
    transport.partition:drop=A|B      bidirectional partition between the
                                      address pair A and B
    transport.partition:drop=A>B      one-way partition: traffic A -> B is
                                      cut (B never hears A; A still hears B)

Actions:
    drop     raise ``FaultDrop`` (a ConnectionResetError): the site behaves
             exactly as if the peer vanished — existing except-clauses and
             migration/retry paths handle it with zero special-casing.
    delay    sleep ``param`` (``50ms``/``0.2s``/bare seconds) at the site.
    error    raise ``FaultInjected`` (a RuntimeError): an internal failure.
    corrupt  flip ``param`` bits (default 1, positive integer) at seeded
             positions in the payload a ``corrupt_bytes()`` call site
             hands over — silent data corruption on the wire/tier, which
             ONLY the receiver's content checksum can catch
             (runtime/integrity.py). Never raises at the site.

Instance scoping (``~pattern``): a rule suffixed with ``~pattern`` only
fires for call sites whose fault identity matches the fnmatch pattern.
Workers set their identity once via ``FAULTS.set_instance(addr)`` (or the
``DYN_FAULT_INSTANCE`` env var); multi-worker processes (the cluster sim)
pass ``instance=`` per call instead. A scoped rule is STICKY: the same
worker degrades on every matching fire, which is the gray-failure
straggler shape — one slow replica in an otherwise healthy fleet.
Unscoped rules fire for everyone, scoped rules never fire for callers
with no identity.

Partitions are address-pair scoped: the ``transport.partition`` site takes
a ``drop`` action whose param names the pair (``A|B`` symmetric, ``A>B``
one-way src->dst; either side may be a ``*`` fnmatch pattern). Code that
speaks peer-to-peer (the hub replication plane, hub_replica.py) consults
``link_blocked(site, src, dst)`` / ``fire_link(site, src, dst)`` with its
own advertise address and the peer's — a cut link refuses dials, kills
established streams at the next frame, and drops follower acks, which is
exactly the partial-failure surface a Raft-style election has to survive.
Live-flippable like every other rule: ``configure()`` (the worker admin
``faults`` RPC) swaps the partition set atomically.

Determinism: every site draws its own decision stream from
``random.Random(f"{seed}:{site}")`` — the schedule at one site is a pure
function of (spec, seed, call index at that site), independent of thread
interleavings or what other sites are doing. The same spec + seed replays
the same fault schedule; tests assert this (tests/test_faults.py).

Registered fault points (see tools/dynalint/catalog.py for the full,
drift-checked catalog):
    transport.connect / transport.send / transport.recv   (transport.py)
    hub.dial / hub.call                                   (hub_client.py)
    hub.wal_append / hub.fsync                            (hub_store.py)
    engine.step / engine.admit / engine.spec_verify       (engine/core.py)
    engine.guided_compile                                 (guided/runtime.py)
    disagg.pull                                           (disagg/transfer.py)
    kvbm.onboard                                          (kvbm/manager.py)
    migration.resume                                      (frontend/migration.py)
    health.canary                                         (runtime/health.py)

Trip counters are exported on every ``/metrics`` surface as
``dynamo_fault_trips_total{site,action}`` (runtime/metrics.py global
exposition providers), so a chaos run can assert its faults actually fired.
"""

from __future__ import annotations

import asyncio
import fnmatch
import logging
import os
import random
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any

log = logging.getLogger("dynamo.faults")


# Machine-readable site catalog (mirrored by tools/dynalint/catalog.py,
# cross-checked by tests/test_static_analysis.py): every fire()/fire_sync()
# call site in the tree must use one of these strings, and configure()
# warns when a DYN_FAULTS spec names a site no code declares — both
# directions of the drift that silently kills chaos-schedule replay.
KNOWN_SITES: frozenset[str] = frozenset({
    "transport.connect",
    "transport.send",
    "transport.recv",
    "transport.partition",
    "hub.dial",
    "hub.call",
    "hub.wal_append",
    "hub.fsync",
    "hub.snap_fsync",
    "engine.step",
    "engine.admit",
    "engine.compile",
    "engine.spec_verify",
    "engine.guided_compile",
    "engine.quant",
    "engine.preempt",
    "epp.breaker",
    "disagg.pull",
    "kvbm.onboard",
    "migration.resume",
    "health.canary",
})


class FaultInjected(RuntimeError):
    """An injected ``error`` action fired at a fault point."""


class FaultDrop(ConnectionResetError):
    """An injected ``drop`` action fired: behave like the peer vanished."""


_DURATION = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m)?$")


def _parse_duration(text: str) -> float:
    m = _DURATION.match(text.strip())
    if m is None:
        raise ValueError(f"bad duration {text!r} (want e.g. 50ms, 0.2s)")
    val = float(m.group(1))
    unit = m.group(2) or "s"
    return val * {"ms": 1e-3, "s": 1.0, "m": 60.0}[unit]


@dataclass
class FaultRule:
    site: str
    action: str  # drop | delay | error | corrupt
    prob: float = 1.0
    delay_s: float = 0.0
    limit: int = 0  # max trips; 0 = unbounded
    trips: int = 0
    # corrupt rules: bits to flip per trip (seeded positions)
    flips: int = 1
    # instance scoping: fnmatch pattern over the caller's fault identity;
    # "" = unscoped (fires for everyone)
    instance: str = ""
    # partition rules only (site transport.partition): the address pair.
    # ``one_way`` cuts src->dst traffic only; symmetric cuts both ways.
    src: str | None = None
    dst: str | None = None
    one_way: bool = False

    def is_partition(self) -> bool:
        return self.dst is not None

    def instance_matches(self, instance: str) -> bool:
        if not self.instance:
            return True
        return bool(instance) and fnmatch.fnmatchcase(instance, self.instance)

    def link_matches(self, src: str, dst: str) -> bool:
        if self.one_way:
            return (
                fnmatch.fnmatchcase(src, self.src)
                and fnmatch.fnmatchcase(dst, self.dst)
            )
        return (
            fnmatch.fnmatchcase(src, self.src)
            and fnmatch.fnmatchcase(dst, self.dst)
        ) or (
            fnmatch.fnmatchcase(src, self.dst)
            and fnmatch.fnmatchcase(dst, self.src)
        )

    def spec(self) -> str:
        out = f"{self.site}:{self.action}"
        if self.is_partition():
            out += f"={self.src}{'>' if self.one_way else '|'}{self.dst}"
        elif self.action == "delay":
            out += f"={self.delay_s * 1000:g}ms"
        elif self.action == "corrupt" and self.flips != 1:
            out += f"={self.flips}"
        if self.prob != 1.0:
            out += f"@{self.prob:g}"
        if self.limit:
            out += f"x{self.limit}"
        if self.instance:
            out += f"~{self.instance}"
        return out


def parse_spec(spec: str) -> list[FaultRule]:
    """Parse a ``DYN_FAULTS`` spec string into rules (see module doc)."""
    rules: list[FaultRule] = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, _, rest = entry.partition(":")
        if not rest:
            raise ValueError(f"fault entry {entry!r}: want site:action")
        instance = ""
        if "~" in rest:
            rest, _, instance = rest.rpartition("~")
            instance = instance.strip()
            if not instance:
                raise ValueError(
                    f"fault entry {entry!r}: ~ needs an instance pattern"
                )
        limit = 0
        m = re.search(r"x(\d+)$", rest)
        if m:
            limit = int(m.group(1))
            rest = rest[: m.start()]
        prob = 1.0
        if "@" in rest:
            rest, _, p = rest.rpartition("@")
            prob = float(p)
        action, _, param = rest.partition("=")
        action = action.strip()
        if action not in ("drop", "delay", "error", "corrupt"):
            raise ValueError(f"fault entry {entry!r}: unknown action {action!r}")
        site = site.strip()
        if site == "transport.partition":
            if action != "drop" or not param:
                raise ValueError(
                    f"fault entry {entry!r}: partition wants "
                    "transport.partition:drop=A|B (or A>B one-way)"
                )
            if instance:
                # partitions are already address-pair scoped; a ~instance
                # suffix on top is contradictory, not composable
                raise ValueError(
                    f"fault entry {entry!r}: partitions are address-pair "
                    "scoped; ~instance is not valid on them"
                )
            if limit:
                # a partition is link STATE probed by traffic, not a
                # countable event: xN would silently heal after N probes
                # (including idle polls), which is never what a chaos
                # schedule means — flip the spec off to heal instead
                raise ValueError(
                    f"fault entry {entry!r}: xN limits are not valid on "
                    "partitions (clear/replace the spec to heal)"
                )
            one_way = ">" in param
            src, _, dst = param.partition(">" if one_way else "|")
            if not src.strip() or not dst.strip():
                raise ValueError(
                    f"fault entry {entry!r}: partition needs both addresses"
                )
            rules.append(FaultRule(
                site=site, action=action, prob=prob,
                src=src.strip(), dst=dst.strip(), one_way=one_way,
            ))
            continue
        flips = 1
        delay_s = 0.0
        if action == "corrupt":
            # typed param validation: the only meaningful corrupt param is
            # a positive bit-flip count — "50ms", "0", "-2" or random text
            # would silently mean "1 flip" and make the schedule lie
            if param:
                try:
                    flips = int(param)
                except ValueError:
                    raise ValueError(
                        f"fault entry {entry!r}: corrupt wants a positive "
                        f"integer bit-flip count, not {param!r}"
                    ) from None
                if flips <= 0:
                    raise ValueError(
                        f"fault entry {entry!r}: corrupt bit-flip count "
                        "must be >= 1"
                    )
        else:
            delay_s = _parse_duration(param) if param else 0.0
            if action == "delay" and not delay_s:
                raise ValueError(
                    f"fault entry {entry!r}: delay needs =duration"
                )
        rules.append(FaultRule(
            site=site, action=action, prob=prob,
            delay_s=delay_s, limit=limit, flips=flips, instance=instance,
        ))
    return rules


class FaultRegistry:
    """Process-wide fault-point registry.

    ``enabled`` is the hot-path gate: with no rules configured every
    ``fire``/``fire_sync`` call is one attribute read and a return —
    production overhead is negligible.
    """

    def __init__(self, spec: str = "", seed: int = 0, instance: str = ""):
        self._lock = threading.Lock()
        self.enabled = False
        self.seed = seed
        # process-default fault identity for ~instance-scoped rules;
        # per-call instance= overrides it (multi-worker sim processes)
        self.instance = instance
        self._rules: dict[str, list[FaultRule]] = {}
        self._rngs: dict[str, random.Random] = {}
        self.trip_counts: dict[tuple[str, str], int] = {}
        if spec:
            self.configure(spec, seed)

    def set_instance(self, instance: str) -> None:
        """Declare this process's fault identity (worker advertise
        address) so ``~instance``-scoped rules can target it."""
        self.instance = instance or ""

    # -- configuration -----------------------------------------------------

    def configure(self, spec: str, seed: int | None = None) -> None:
        """Replace the active rule set (live reconfig: the admin ``faults``
        RPC lands here). Resets per-site RNGs so the new schedule is
        deterministic from the configure point."""
        rules = parse_spec(spec)
        with self._lock:
            if seed is not None:
                self.seed = seed
            self._rules = {}
            for r in rules:
                self._rules.setdefault(r.site, []).append(r)
            self._rngs = {}
            self.enabled = bool(self._rules)
        if rules:
            unknown = {r.site for r in rules} - KNOWN_SITES
            if unknown:
                # warn, don't raise: an old schedule replayed against a
                # newer build should degrade loudly, not crash the worker
                log.warning(
                    "fault spec names unknown site(s) %s — these will "
                    "NEVER trip (known: %s)",
                    ",".join(sorted(unknown)), ",".join(sorted(KNOWN_SITES)),
                )
            log.warning(
                "fault injection ACTIVE (seed=%d): %s",
                self.seed, ",".join(r.spec() for r in rules),
            )
        else:
            log.info("fault injection cleared")

    def clear(self) -> None:
        self.configure("")

    # -- decision ----------------------------------------------------------

    def _site_rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def decide(
        self,
        site: str,
        instance: str | None = None,
        kinds: tuple[str, ...] | None = None,
    ) -> FaultRule | None:
        """One decision draw at ``site``; returns the rule to apply (and
        counts the trip) or None. Deterministic per (spec, seed, site,
        call index). ``instance`` is the caller's fault identity for
        ``~``-scoped rules (defaults to the process identity); ``kinds``
        restricts which actions this call site can apply (payload sites
        draw corrupt rules via ``corrupt_bytes``, never ``fire``)."""
        if not self.enabled:
            return None
        who = self.instance if instance is None else instance
        with self._lock:
            rules = self._rules.get(site)
            if not rules:
                return None
            # one draw per configured rule, in spec order, so multi-rule
            # sites (delay + rare drop) keep independent schedules
            for rule in rules:
                if rule.is_partition():
                    continue  # pair-scoped: only link_blocked matches these
                if kinds is not None and rule.action not in kinds:
                    continue
                if not rule.instance_matches(who):
                    continue
                if rule.limit and rule.trips >= rule.limit:
                    continue
                if self._site_rng(site).random() < rule.prob:
                    rule.trips += 1
                    key = (site, rule.action)
                    self.trip_counts[key] = self.trip_counts.get(key, 0) + 1
                    return rule
            return None

    def link_blocked(self, site: str, src: str, dst: str) -> bool:
        """True when a partition rule at ``site`` cuts the directed link
        ``src -> dst``. Symmetric rules match either direction; one-way
        rules match src->dst only. Probabilistic partitions (flaky links)
        draw from the same seeded per-site stream as every other rule, so
        a chaos schedule replays. Trip semantics differ from event sites:
        a partition is link STATE, so ``trips`` counts blocked link
        CHECKS (dials refused, stream frames cut, idle polls while cut) —
        nonzero trips still means the partition was live and consulted."""
        if not self.enabled:
            return False
        with self._lock:
            rules = self._rules.get(site)
            if not rules:
                return False
            for rule in rules:
                if not rule.is_partition():
                    continue
                if not rule.link_matches(src, dst):
                    continue
                if (
                    rule.prob < 1.0
                    and self._site_rng(site).random() >= rule.prob
                ):
                    continue
                rule.trips += 1
                key = (site, rule.action)
                self.trip_counts[key] = self.trip_counts.get(key, 0) + 1
                return True
            return False

    async def fire_link(self, site: str, src: str, dst: str) -> None:
        """Async fault point for directed peer traffic: raises FaultDrop
        (the peer-vanished contract) when the link is partitioned."""
        if self.link_blocked(site, src, dst):
            raise FaultDrop(f"injected partition at {site}: {src} -/-> {dst}")

    def _raise(self, rule: FaultRule) -> None:
        log.warning("fault injected: %s (trip %d)", rule.spec(), rule.trips)
        if rule.action == "drop":
            raise FaultDrop(f"injected drop at {rule.site}")
        raise FaultInjected(f"injected error at {rule.site}")

    _FIRE_KINDS = ("drop", "delay", "error")

    def fire_sync(self, site: str, instance: str | None = None) -> None:
        """Blocking fault point (step thread, WAL append, transfer pull).
        Event-loop call sites must use the async ``fire`` instead."""
        rule = self.decide(site, instance=instance, kinds=self._FIRE_KINDS)
        if rule is None:
            return
        if rule.action == "delay":
            # dynalint: disable=DL001 -- blocking delay IS the contract
            # here: fire_sync is documented thread-side only (step thread,
            # WAL fsync, transfer pull); loop sites use async fire()
            time.sleep(rule.delay_s)
            return
        self._raise(rule)

    async def fire(self, site: str, instance: str | None = None) -> None:
        """Async fault point (event-loop call sites)."""
        rule = self.decide(site, instance=instance, kinds=self._FIRE_KINDS)
        if rule is None:
            return
        if rule.action == "delay":
            await asyncio.sleep(rule.delay_s)
            return
        self._raise(rule)

    def corrupt_bytes(
        self, site: str, data, instance: str | None = None
    ) -> bytes:
        """Payload fault point: when a ``corrupt`` rule trips at ``site``,
        return a copy of ``data`` with ``flips`` bits flipped at seeded
        positions; otherwise return ``data`` unchanged. The flip positions
        are a pure function of (seed, site, trip index), so a red chaos
        run replays bit-for-bit. Call sites place this where the payload
        crosses a process boundary — the receiver's content checksum
        (runtime/integrity.py) is the detection under test."""
        rule = self.decide(site, instance=instance, kinds=("corrupt",))
        if rule is None:
            return data
        buf = bytearray(data)
        if not buf:
            return data
        rng = random.Random(f"{self.seed}:{site}:corrupt:{rule.trips}")
        for _ in range(rule.flips):
            i = rng.randrange(len(buf))
            buf[i] ^= 1 << rng.randrange(8)
        log.warning(
            "fault injected: %s flipped %d bit(s) across %d bytes (trip %d)",
            rule.spec(), rule.flips, len(buf), rule.trips,
        )
        return bytes(buf)

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "seed": self.seed,
                "rules": [
                    r.spec() for rs in self._rules.values() for r in rs
                ],
                "trips": {
                    f"{site}:{action}": n
                    for (site, action), n in sorted(self.trip_counts.items())
                },
            }

    def exposition(self) -> str:
        """Prometheus text lines for every /metrics surface (registered as
        a global provider with runtime/metrics.py)."""
        if not self.trip_counts:
            return ""
        lines = [
            "# HELP dynamo_fault_trips_total Injected fault trips by site/action.",
            "# TYPE dynamo_fault_trips_total counter",
        ]
        with self._lock:
            for (site, action), n in sorted(self.trip_counts.items()):
                lines.append(
                    f'dynamo_fault_trips_total{{site="{site}",'
                    f'action="{action}"}} {n}'
                )
        return "\n".join(lines) + "\n"


# The process-wide registry: env-configured at import, reconfigurable live
# via the worker admin ``faults`` RPC.
FAULTS = FaultRegistry(
    os.environ.get("DYN_FAULTS", ""),
    seed=int(os.environ.get("DYN_FAULTS_SEED", "0") or 0),
    instance=os.environ.get("DYN_FAULT_INSTANCE", ""),
)


def _register_metrics() -> None:
    from dynamo_tpu_torch.runtime import metrics

    metrics.register_global_provider("faults", FAULTS.exposition)


_register_metrics()
