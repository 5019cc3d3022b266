"""Cluster-scale chaos simulation: trace-replay fleet harness (the
counterpart of dynamo_tpu/sim).

We cannot rent a million users, but the mocker + time-dilation backbone
(SURVEY §"mocker, time dilation") can fake one: this package composes
REAL control-plane components — the replicated quorum hub
(runtime/hub_replica.py), the KV-aware router (kv_router/), the EPP with
circuit breakers (gateway/epp.py), the migration operator
(frontend/migration.py) and the SLA planner's replica math (planner/) —
with 100s of ``MockEngine``-backed workers (time-dilated via
``speedup_ratio``) driving mooncake-style trace replay
(sim/replay.py), and runs named chaos SCENARIOS through the
existing ``DYN_FAULTS`` / ``transport.partition`` grammar:

    pick_scaling    EPP pick latency vs instance count (the flatness bar)
    leader_kill     SIGKILL the quorum leader mid-commit-storm
    partition       symmetric + one-way partitions during election
    churn           worker kill + rejoin waves under open-loop replay
    breaker_storm   injected epp.breaker failures -> eject -> recovery
    tenant_storm    batch-tenant flood vs the interactive TTFT SLO
    telemetry_overhead   span/metric emission cost vs dilated step time

Each scenario asserts its invariants continuously (no dual-lead per term
via the jepsen-style WAL checker, zero client-visible errors with
migrations > 0 under churn, commit unavailability bounded to the
partition window, interactive TTFT SLO held during storms) and the run
writes a saturation-curve artifact (under ``build/sim/`` by default) —
the control-plane analogue of the serving ladder. The hub, router, EPP,
migration and planner are the port's; nothing here holds a tensor.

Run: ``python -m dynamo_tpu_torch.sim --scenario all --workers 200``.
"""

from dynamo_tpu_torch.sim.harness import SimConfig, run_scenarios, write_artifact
from dynamo_tpu_torch.sim.scenarios import SCENARIOS

__all__ = ["SimConfig", "SCENARIOS", "run_scenarios", "write_artifact"]
