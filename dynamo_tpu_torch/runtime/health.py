"""Worker health states read by routers (the counterpart of
dynamo_tpu/runtime/health.py, reduced to what the KV router reads).

A quarantined instance stays registered (its streams finish) but is
soft-withdrawn: ``KvPushRouter`` excludes it from picks, fail-open. Nothing
in this package quarantines a worker yet (health publishing and the engine
monitor are ROADMAP Queue A item 4c); a card written by the reference's
health monitor is honoured.
"""

from __future__ import annotations

__all__ = ["is_quarantined"]


def is_quarantined(instance) -> bool:
    """True for an Instance (or raw card dict) in the quarantined state."""
    meta = (
        instance.get("metadata") if isinstance(instance, dict)
        else getattr(instance, "metadata", None)
    )
    return bool(meta) and meta.get("state") == "quarantined"
