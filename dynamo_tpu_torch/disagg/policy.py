"""Conditional disaggregation policy (the port's copy of
dynamo_tpu/disagg/policy.py).

Prefill goes remote iff the *non-cached* part of the prompt is long enough
to be worth the transfer: ``prefill_len - prefix_hit_len >
max_local_prefill_length`` (ref: lib/llm/src/disagg_router.rs:230
``prefill_remote``). The threshold is live-tunable through a hub config key
(ref: etcd watch, disagg_router.rs:26-110).
"""

from __future__ import annotations

import asyncio
import logging

log = logging.getLogger("dynamo_tpu_torch.disagg.policy")

CONFIG_KEY = "v1/config/disagg/{namespace}"


class DisaggPolicy:
    def __init__(
        self,
        *,
        max_local_prefill_length: int = 128,
        always_remote: bool = False,
    ):
        self.max_local_prefill_length = max_local_prefill_length
        self.always_remote = always_remote
        self._watch_task: asyncio.Task | None = None

    def prefill_remote(self, prefill_len: int, prefix_hit_len: int = 0) -> bool:
        if self.always_remote:
            return True
        return (prefill_len - prefix_hit_len) > self.max_local_prefill_length

    # -- live config -------------------------------------------------------

    async def watch(self, hub, namespace: str) -> "DisaggPolicy":
        """Follow hub config updates; returns immediately after initial read."""
        key = CONFIG_KEY.format(namespace=namespace)
        current = await hub.get(key)
        if isinstance(current, dict):
            self._apply(current)

        async def _loop():
            try:
                async for ev in hub.watch_prefix(key):
                    if ev.value is not None and isinstance(ev.value, dict):
                        self._apply(ev.value)
            except asyncio.CancelledError:
                pass
            except ConnectionError:
                log.warning("disagg policy watch lost")

        self._watch_task = asyncio.get_running_loop().create_task(_loop())
        return self

    def _apply(self, cfg: dict) -> None:
        if "max_local_prefill_length" in cfg:
            self.max_local_prefill_length = int(cfg["max_local_prefill_length"])
        if "always_remote" in cfg:
            self.always_remote = bool(cfg["always_remote"])
        log.info(
            "disagg policy updated: max_local_prefill_length=%d always_remote=%s",
            self.max_local_prefill_length, self.always_remote,
        )

    def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
