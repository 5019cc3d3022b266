"""The hub: cluster coordination service (a copy of dynamo_tpu/runtime/hub.py).

One small service with the capabilities the serving stack uses:

  - lease-scoped KV store with atomic create and prefix watches
  - pub/sub subjects with wildcard suffix match and retained history
  - object store buckets

Requests do NOT flow through the hub. ``InMemoryHub`` backs the one-process
stack; the TCP hub server and client wait for ROADMAP Queue A item 4b.
"""

from __future__ import annotations

import asyncio
import fnmatch
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

__all__ = ["WatchEvent", "Hub", "InMemoryHub", "KeyExists"]


class KeyExists(Exception):
    """Atomic create failed: key already present."""


@dataclass(frozen=True)
class WatchEvent:
    """One KV mutation delivered to a prefix watcher."""

    kind: str  # "put" | "delete" | "sync"
    key: str
    value: Any = None


@dataclass
class _Lease:
    lease_id: int
    ttl: float
    deadline: float
    keys: set[str] = field(default_factory=set)


class Hub:
    """Abstract hub interface (see module docstring)."""

    async def get_boot_id(self) -> str | None:
        """Identity of this hub instance (per-subject seq counters live in
        hub memory, so two boots have incomparable seq spaces)."""
        return getattr(self, "boot_id", None)

    # -- kv ---------------------------------------------------------------
    async def put(self, key: str, value: Any, lease_id: int | None = None) -> None:
        raise NotImplementedError

    async def create(self, key: str, value: Any, lease_id: int | None = None) -> None:
        """Atomic create: raise KeyExists if the key is already present."""
        raise NotImplementedError

    async def get(self, key: str) -> Any:
        raise NotImplementedError

    async def delete(self, key: str) -> bool:
        raise NotImplementedError

    async def get_prefix(self, prefix: str) -> dict[str, Any]:
        raise NotImplementedError

    def watch_prefix(
        self, prefix: str, *, initial: bool = True, sync_marker: bool = False
    ) -> AsyncIterator[WatchEvent]:
        """Stream of WatchEvents for keys under ``prefix``. With
        ``initial=True`` the current contents are replayed as "put" events
        first; ``sync_marker=True`` ends that replay with a ``kind="sync"``
        event."""
        raise NotImplementedError

    # -- leases ------------------------------------------------------------
    async def grant_lease(self, ttl_s: float) -> int:
        raise NotImplementedError

    async def keepalive(self, lease_id: int) -> bool:
        raise NotImplementedError

    async def revoke_lease(self, lease_id: int) -> None:
        raise NotImplementedError

    # -- pub/sub -----------------------------------------------------------
    async def publish(
        self, subject: str, payload: Any, pub_id: str | None = None
    ) -> bool:
        """Publish one event. A retried publish carrying an already-seen
        ``pub_id`` is dropped. Returns True when applied."""
        raise NotImplementedError

    async def purge_subject(
        self, subject: str, keep_last: int = 0,
        up_to_seq: int | None = None,
    ) -> int:
        """Drop retained history for ``subject``: events with seq <=
        ``up_to_seq`` when given, else all but the newest ``keep_last``.
        Returns the number dropped."""
        raise NotImplementedError

    def subscribe(
        self, subject: str, *, replay: bool = False
    ) -> AsyncIterator[tuple[str, Any]]:
        """Subscribe to a subject (``*`` wildcards); ``replay=True``
        delivers retained history first."""
        raise NotImplementedError

    # -- object store ------------------------------------------------------
    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        raise NotImplementedError

    async def get_object(self, bucket: str, name: str) -> bytes | None:
        raise NotImplementedError

    async def delete_object(self, bucket: str, name: str) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class InMemoryHub(Hub):
    """Single-process hub."""

    RETAIN_PER_SUBJECT = 65536
    # publish-dedup window: ids older than this many publishes age out
    PUB_ID_WINDOW = 8192

    def __init__(self) -> None:
        self.boot_id = uuid.uuid4().hex
        self._retained: dict[str, deque] = {}  # subject -> (seq, payload)
        self._subject_seq: dict[str, int] = {}  # publish counter per subject
        self._seen_pub_ids: "OrderedDict[str, None]" = OrderedDict()
        self._kv: dict[str, Any] = {}
        self._key_lease: dict[str, int] = {}
        self._leases: dict[int, _Lease] = {}
        self._next_lease = 1
        self._watchers: list[tuple[str, asyncio.Queue]] = []
        self._subs: list[tuple[str, asyncio.Queue]] = []
        self._objects: dict[tuple[str, str], bytes] = {}
        self._reaper: asyncio.Task | None = None
        self._closed = False

    # -- internals ---------------------------------------------------------

    def _notify(self, ev: WatchEvent) -> None:
        for prefix, q in self._watchers:
            if ev.key.startswith(prefix):
                q.put_nowait(ev)

    def _ensure_reaper(self) -> None:
        if self._reaper is None or self._reaper.done():
            self._reaper = asyncio.get_running_loop().create_task(self._reap_loop())

    async def _reap_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(0.5)
            self.reap_expired()

    def reap_expired(self, now: float | None = None) -> list[int]:
        """Expire leases whose deadline passed; drop their keys. Returns ids."""
        now = time.monotonic() if now is None else now
        expired = [lease for lease in self._leases.values() if lease.deadline <= now]
        for lease in expired:
            self._drop_lease(lease)
        return [lease.lease_id for lease in expired]

    def _drop_lease(self, lease: _Lease) -> None:
        self._leases.pop(lease.lease_id, None)
        for key in sorted(lease.keys):
            if self._kv.pop(key, None) is not None:
                self._key_lease.pop(key, None)
                self._notify(WatchEvent("delete", key))

    # -- kv ---------------------------------------------------------------

    async def put(self, key: str, value: Any, lease_id: int | None = None) -> None:
        if lease_id is not None:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise ValueError(f"unknown lease {lease_id}")
            lease.keys.add(key)
            self._key_lease[key] = lease_id
        self._kv[key] = value
        self._notify(WatchEvent("put", key, value))

    async def create(self, key: str, value: Any, lease_id: int | None = None) -> None:
        if key in self._kv:
            raise KeyExists(key)
        await self.put(key, value, lease_id)

    async def get(self, key: str) -> Any:
        return self._kv.get(key)

    async def delete(self, key: str) -> bool:
        if key in self._kv:
            del self._kv[key]
            lease_id = self._key_lease.pop(key, None)
            if lease_id is not None and lease_id in self._leases:
                self._leases[lease_id].keys.discard(key)
            self._notify(WatchEvent("delete", key))
            return True
        return False

    async def get_prefix(self, prefix: str) -> dict[str, Any]:
        return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    async def watch_prefix(
        self, prefix: str, *, initial: bool = True, sync_marker: bool = False
    ) -> AsyncIterator[WatchEvent]:
        q: asyncio.Queue = asyncio.Queue()
        snapshot = (
            [WatchEvent("put", k, v) for k, v in sorted(self._kv.items()) if k.startswith(prefix)]
            if initial
            else []
        )
        self._watchers.append((prefix, q))
        try:
            for ev in snapshot:
                yield ev
            if sync_marker:
                yield WatchEvent("sync", "")
            while True:
                yield await q.get()
        finally:
            self._watchers.remove((prefix, q))

    # -- leases ------------------------------------------------------------

    async def grant_lease(self, ttl_s: float) -> int:
        self._ensure_reaper()
        lease_id = self._next_lease
        self._next_lease += 1
        self._leases[lease_id] = _Lease(lease_id, ttl_s, time.monotonic() + ttl_s)
        return lease_id

    async def keepalive(self, lease_id: int) -> bool:
        lease = self._leases.get(lease_id)
        if lease is None:
            return False
        lease.deadline = time.monotonic() + lease.ttl
        return True

    async def revoke_lease(self, lease_id: int) -> None:
        lease = self._leases.get(lease_id)
        if lease is not None:
            self._drop_lease(lease)

    # -- pub/sub -----------------------------------------------------------

    def _pub_id_fresh(self, pub_id: str | None) -> bool:
        """Record ``pub_id`` in the bounded dedup window; False when the
        id was already seen (a retried publish)."""
        if pub_id is None:
            return True
        if pub_id in self._seen_pub_ids:
            return False
        self._seen_pub_ids[pub_id] = None
        while len(self._seen_pub_ids) > self.PUB_ID_WINDOW:
            self._seen_pub_ids.popitem(last=False)
        return True

    async def publish(
        self, subject: str, payload: Any, pub_id: str | None = None
    ) -> bool:
        if not self._pub_id_fresh(pub_id):
            return False
        if subject not in self._retained:
            self._retained[subject] = deque(maxlen=self.RETAIN_PER_SUBJECT)
        seq = self._subject_seq.get(subject, 0) + 1
        self._subject_seq[subject] = seq
        self._retained[subject].append((seq, payload))
        for pattern, q in self._subs:
            if fnmatch.fnmatchcase(subject, pattern):
                q.put_nowait((subject, payload, seq))
        return True

    async def purge_subject(
        self, subject: str, keep_last: int = 0,
        up_to_seq: int | None = None,
    ) -> int:
        dropped = 0
        for subj in list(self._retained):
            if not fnmatch.fnmatchcase(subj, subject):
                continue
            dq = self._retained[subj]
            if up_to_seq is not None:
                while dq and dq[0][0] <= up_to_seq:
                    dq.popleft()
                    dropped += 1
            else:
                while len(dq) > keep_last:
                    dq.popleft()
                    dropped += 1
        return dropped

    async def subscribe(
        self, subject: str, *, replay: bool = False, with_seq: bool = False
    ) -> AsyncIterator[tuple]:
        # snapshot history, then register live: both synchronous, so no gap
        # and no duplicates
        backlog: list[tuple[str, Any, int]] = []
        if replay:
            for subj in sorted(self._retained):
                if fnmatch.fnmatchcase(subj, subject):
                    backlog.extend((subj, p, s) for s, p in self._retained[subj])
        q: asyncio.Queue = asyncio.Queue()
        self._subs.append((subject, q))
        try:
            for item in backlog:
                yield item if with_seq else item[:2]
            while True:
                item = await q.get()
                yield item if with_seq else item[:2]
        finally:
            self._subs.remove((subject, q))

    # -- object store ------------------------------------------------------

    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        self._objects[(bucket, name)] = bytes(data)

    async def get_object(self, bucket: str, name: str) -> bytes | None:
        return self._objects.get((bucket, name))

    async def delete_object(self, bucket: str, name: str) -> None:
        self._objects.pop((bucket, name), None)

    async def close(self) -> None:
        self._closed = True
        if self._reaper is not None:
            self._reaper.cancel()
