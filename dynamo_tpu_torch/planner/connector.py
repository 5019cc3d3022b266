"""Planner connectors: where replica decisions go (the counterpart of
dynamo_tpu/planner/connector.py: the same hub key and JSON document, so a
JAX planner and a port operator, or the reverse, share one loop).

Upstream analogues: ``VirtualConnector`` (lib/bindings planner.rs — writes
desired counts to etcd for tests/external orchestrators) and
``KubernetesConnector`` (kubernetes_connector.py — patches
DynamoGraphDeployment replicas). Here the virtual connector writes a JSON
document to the hub KV at ``v1/planner/{namespace}/desired``; whatever
supervises workers (tests, a process manager, a future K8s operator)
watches that key and converges actual to desired.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import asdict, dataclass

log = logging.getLogger("dynamo.planner.connector")

DESIRED_KEY = "v1/planner/{namespace}/desired"


@dataclass
class DesiredReplicas:
    prefill: int
    decode: int
    revision: int = 0
    updated_at: float = 0.0
    model: str | None = None


class LoggingConnector:
    """No-op connector (reference --no-operation): decisions only logged;
    also keeps the last decision for inspection."""

    def __init__(self) -> None:
        self.history: list[DesiredReplicas] = []

    async def set_replicas(self, desired: DesiredReplicas) -> None:
        self.history.append(desired)
        log.info(
            "planner decision (no-op): prefill=%d decode=%d",
            desired.prefill, desired.decode,
        )


class VirtualConnector:
    """Write desired replica counts to the hub KV, revisioned."""

    def __init__(self, hub, namespace: str, model: str | None = None):
        self.hub = hub
        self.namespace = namespace
        self.model = model
        self.revision = 0

    @property
    def key(self) -> str:
        return DESIRED_KEY.format(namespace=self.namespace)

    async def set_replicas(self, desired: DesiredReplicas) -> None:
        self.revision += 1
        desired.revision = self.revision
        desired.updated_at = time.time()
        desired.model = desired.model or self.model
        await self.hub.put(self.key, asdict(desired))
        log.info(
            "planner desired replicas -> %s: prefill=%d decode=%d (rev %d)",
            self.key, desired.prefill, desired.decode, self.revision,
        )


async def read_desired_replicas(hub, namespace: str) -> DesiredReplicas | None:
    """Supervisor-side helper: current desired counts, or None."""
    raw = await hub.get(DESIRED_KEY.format(namespace=namespace))
    if raw is None:
        return None
    return DesiredReplicas(**raw)


class ProcessConnector:
    """Close the scaling loop WITHOUT Kubernetes: converge actual worker
    processes to the planner's desired counts by spawning/retiring local
    mocker workers (ref: KubernetesConnector patches DynamoGraphDeployment
    replicas and the operator reconciles pods — here the connector IS the
    reconciler). Retiring drains: the endpoint deregisters first, so the
    router stops picking the worker before it disappears.

    ``spawn(role, index)`` must return a ``ServedEndpoint``-bearing worker
    handle ``(engine, served)``; the default spawner launches mocker
    workers on this runtime — the same fleet the reference scales in
    tests/planner/.
    """

    def __init__(
        self,
        drt,
        namespace: str,
        *,
        component: str = "backend",
        prefill_component: str = "prefill",
        endpoint: str = "generate",
        model_name: str = "mock-model",
        spawn=None,
        mock_config=None,
    ):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.prefill_component = prefill_component
        self.endpoint = endpoint
        self.model_name = model_name
        self._spawn = spawn or self._spawn_mocker
        self._mock_config = mock_config
        self._workers: dict[str, list] = {"prefill": [], "decode": []}
        self.history: list[DesiredReplicas] = []

    def replica_counts(self) -> dict[str, int]:
        return {k: len(v) for k, v in self._workers.items()}

    async def _spawn_mocker(self, role: str, index: int):
        from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
        from dynamo_tpu_torch.mocker.engine import MockEngineConfig

        cfg = self._mock_config or MockEngineConfig(
            block_size=16, total_kv_blocks=1024, speedup_ratio=100.0
        )
        component = (
            self.prefill_component if role == "prefill" else self.component
        )
        # the FIRST decode worker registers the model card so the frontend
        # discovers the model; replicas only add serving capacity
        return await launch_mock_worker(
            self.drt, self.namespace, component, self.endpoint, cfg,
            model_name=self.model_name,
            register_card=(role == "decode" and index == 0),
        )

    async def set_replicas(self, desired: DesiredReplicas) -> None:
        self.history.append(desired)
        retiring: list = []
        for role, want in (("prefill", desired.prefill),
                           ("decode", desired.decode)):
            pool = self._workers[role]
            while len(pool) < want:
                pool.append(await self._spawn(role, len(pool)))
            while len(pool) > max(want, 0):
                retiring.append(pool.pop())
        if retiring:
            # scale-down ordering (pick-during-scale-down race): withdraw
            # EVERY retiring instance key before any worker dies, so a
            # router that picked off its not-yet-updated watch copy still
            # lands on a live handler. served.shutdown's withdraw grace
            # covers the propagation window; the idle-wait below covers
            # streams admitted inside it. Only then is the engine closed.
            await asyncio.gather(
                *(self.drt.hub.delete(served.instance.path)
                  for _e, served in retiring)
            )
            for engine, served in retiring:
                deadline = asyncio.get_running_loop().time() + 30.0
                while (getattr(engine, "_running", 0) > 0
                       and asyncio.get_running_loop().time() < deadline):
                    await asyncio.sleep(0.005)
                await served.shutdown(drain=True)
                close = getattr(engine, "close", None)
                if close is not None:
                    res = close()
                    if hasattr(res, "__await__"):
                        await res
        log.info(
            "process connector converged: prefill=%d decode=%d",
            len(self._workers["prefill"]), len(self._workers["decode"]),
        )

    async def close(self) -> None:
        await self.set_replicas(DesiredReplicas(prefill=0, decode=0))
