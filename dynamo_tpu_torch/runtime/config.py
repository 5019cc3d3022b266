"""Layered runtime configuration (the counterpart of
dynamo_tpu/runtime/config.py).

Precedence (low to high): dataclass defaults < the file at ``DYN_CONFIG`` <
``DYN_*`` environment variables. The reference reads that file as YAML; the
port reads it as JSON, which YAML contains, so a JSON file means the same to
both. A file that is not JSON raises: PyYAML is not a dependency here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

_PREFIX = "DYN_"


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class RuntimeConfig:
    """Process-level runtime knobs (env prefix ``DYN_``)."""

    # identity / cluster
    namespace: str = "dynamo"
    hub_address: str = ""  # "host:port" of the hub service; empty = in-memory
    # replicated hub: comma-separated replica addresses (DYN_HUB_ADDRESSES);
    # takes precedence over hub_address
    hub_addresses: str = ""
    static: bool = False  # static mode: no discovery, fixed peers

    # data plane
    host: str = "127.0.0.1"  # address workers advertise for their TCP listener
    request_timeout_s: float = 600.0
    connect_timeout_s: float = 5.0
    prewarm_dials: bool = True
    uds_dir: str = ""

    # leases / health
    lease_ttl_s: float = 10.0
    keepalive_interval_s: float = 3.0
    health_check_interval_s: float = 30.0
    health_check_timeout_s: float = 10.0
    # graceful drain: max seconds to let in-flight requests finish
    drain_timeout_s: float = 30.0
    # per-endpoint withdrawal grace (DYN_WITHDRAW_GRACE_S): after the
    # instance key is deleted, the handler keeps serving this long so a
    # router that picked inside the watch-propagation window still lands on
    # a live handler (scale-down drain contract)
    withdraw_grace_s: float = 0.01

    # http frontend
    http_port: int = 8000
    system_port: int = 9090

    # logging
    log_level: str = "INFO"
    log_jsonl: bool = False

    # engine-side compute
    block_size: int = 64
    spec_mode: str = ""
    spec_k_max: int = 0
    guided_mode: str = ""
    compile_cache_dir: str = ""
    tenant_quotas: str = ""

    extra: dict[str, Any] = field(default_factory=dict)

    def hub_target(self) -> str:
        """The hub address to connect to: the replica list when configured,
        else the single hub address (empty = in-memory)."""
        return self.hub_addresses or self.hub_address

    def override_hub(self, address: str) -> "RuntimeConfig":
        """CLI ``--hub`` beats env: route hub_target() at ``address``."""
        self.hub_address = self.hub_addresses = address
        return self

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "RuntimeConfig":
        env = dict(os.environ if env is None else env)
        layers: dict[str, Any] = {}

        cfg_path = env.get(_PREFIX + "CONFIG")
        if cfg_path and Path(cfg_path).exists():
            text = Path(cfg_path).read_text()
            try:
                loaded = json.loads(text) if text.strip() else {}
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"config file {cfg_path} is not JSON ({e}); the port reads "
                    "DYN_CONFIG as JSON because PyYAML is not installed"
                ) from e
            loaded = loaded or {}
            if not isinstance(loaded, dict):
                raise ValueError(f"config file {cfg_path} must be a mapping")
            layers.update(loaded)

        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, raw in env.items():
            if not key.startswith(_PREFIX):
                continue
            name = key[len(_PREFIX):].lower()
            if name != "extra" and name != "config":
                layers[name] = raw  # known keys coerced below via default's type

        known = {k: v for k, v in layers.items() if k in fields and k != "extra"}
        extra = {k: v for k, v in layers.items() if k not in fields}
        defaults = cls()
        for k, v in list(known.items()):
            if isinstance(v, str):
                known[k] = _coerce(v, type(getattr(defaults, k)))
        return cls(**known, extra=extra)


def config_from_env() -> RuntimeConfig:
    return RuntimeConfig.from_env()
