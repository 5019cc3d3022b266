"""TCP client for the hub service - same interface as InMemoryHub (the
counterpart of dynamo_tpu/runtime/hub_client.py).

One connection per client, request/response multiplexed by message id;
watch/subscribe streams fan out to per-stream queues.

Reconnection is built in (``reconnect=True``): when the hub connection
drops — a hub crash/restart, not a clean close — calls retry after
re-dialing with backoff for up to ``reconnect_window_s``, and streams
re-establish transparently:

- ``watch_prefix`` re-opens with a fresh initial snapshot delimited by a
  server-side sync marker, diffs it against the keys it has already
  yielded, and emits synthetic ``delete`` events for keys that vanished
  while disconnected before replaying the snapshot — consumer state
  converges exactly (ref: etcd watch re-establishment semantics).
- ``subscribe`` with ``replay=True`` re-subscribes with replay and drops
  events whose per-subject seq it already delivered (the durable hub
  preserves seq counters across restarts, hub_store.py); with
  ``replay=False`` it re-subscribes live-only — events published while
  disconnected are lost, NATS-core semantics.

Retried mutations are at-least-once: a ``create`` whose ack was lost in
the crash may raise KeyExists on retry (same exposure etcd clients have
without txn ids). Workers still treat a hub that stays unreachable past
the reconnect window as fatal (etcd loss => shutdown).

Replicated-hub failover, client side: construct with a comma-
separated address list (or set ``DYN_HUB_ADDRESSES``) and the client
dials round-robin across replicas, follows ``not_leader`` redirects so
writes always land on the leader while reads are served by whichever
replica answered, and — because failover rides the same reconnect path —
re-syncs watches (snapshot diff) and re-subscribes with seq dedup
against the promoted follower exactly as it does across a restart (the
cluster shares one boot_id, so seq baselines stay valid). The replicated
hub server is ``hub_replica.py``.

Fault sites (runtime/faults.py): ``hub.dial`` before each dial (a drop or
an error fails it), ``hub.call`` before each request (a drop is a
ConnectionError, which the reconnect-and-retry loop absorbs; a delay is a
slow hub; an error reaches the caller).

The wire is the JAX package's (framing.py over the port's stdlib msgpack
codec): this client talks to a JAX hub server as well as to the port's.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import random
import time
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime import framing
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.hub import Hub, KeyExists, WatchEvent
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

log = logging.getLogger("dynamo_tpu_torch.hub.client")

# Failover observability, on every /metrics surface: a redirect-chase
# storm during a hub failover (every client bouncing not_leader /
# no_quorum around the replica ring) was previously only INFERRABLE from
# latency — these counters make it a first-class signal the cluster sim
# asserts on (dynamo_tpu/sim leader-kill / partition scenarios).
_METRICS = MetricsRegistry()
REDIRECTS = _METRICS.counter(
    "hub_redirects_total",
    "Hub client write bounces by reason "
    "(not_leader | no_quorum | unavailable).",
    ["reason"],
)
BACKOFF = _METRICS.histogram(
    "hub_backoff_seconds",
    "Seconds the hub client slept between redirect hops "
    "(server-hinted and exponential backoff alike).",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)
register_registry("hub_client", _METRICS)


def failover_stats() -> dict[str, float]:
    """Live sample of the redirect counters by reason, plus the backoff
    histogram's count and sum."""
    out: dict[str, float] = {}
    for labels, child in REDIRECTS._series():
        out[labels["reason"]] = child.value
    (_, backoff), = BACKOFF._series()
    out["backoff_count"] = sum(backoff.counts)
    out["backoff_sum_s"] = round(backoff.sum, 4)
    return out


class _ConnLost(Exception):
    """Internal: the stream's connection died mid-iteration."""


class NotLeader(Exception):
    """A write landed on a replicated-hub follower (or bounced
    ``no_quorum``/``unavailable``). ``leader`` is the current leader's
    address when known, None mid-election. ``retry_after_s`` is the
    server-supplied backoff hint when the bounce carried one — honored
    by _call ahead of its own jittered exponential backoff. _call
    follows the redirect transparently; this only escapes to callers
    when the cluster stays leaderless past the reconnect window."""

    def __init__(
        self, leader: str | None, retry_after_s: float | None = None
    ):
        super().__init__(leader or "<no leader>")
        self.leader = leader
        self.retry_after_s = retry_after_s


class RemoteHub(Hub):
    """Hub client. ``address`` may be ONE ``host:port`` or a comma-
    separated list (a replicated hub, hub_replica.py): dials round-robin
    across the list, follows ``not_leader`` redirects for writes, and
    fails over streams to whichever replica answers."""

    # redirect-chase bound: a mid-election cluster (every replica bouncing
    # with a different — or no — leader hint, or two stale replicas naming
    # each other) must not spin a client through an unbounded hot loop;
    # after this many hops the call fails even inside the reconnect
    # window. Sized so the backoff sum (~15 s expected at the 0.5 s cap)
    # comfortably exceeds the default reconnect window AND a default
    # 3 s-lease election — the window is the failover SLA, the hop cap
    # only kills true redirect loops.
    MAX_REDIRECT_HOPS = 32

    def __init__(
        self,
        address: str,
        *,
        reconnect: bool = True,
        reconnect_window_s: float = 10.0,
    ):
        import uuid

        self._addrs = [a.strip() for a in address.split(",") if a.strip()]
        if not self._addrs:
            raise ValueError("empty hub address")
        self._addr_idx = 0
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._ids = itertools.count(1)
        # pending/stream entries are tagged with the connection EPOCH they
        # were sent on: a stale rx task (old connection, still blocked on
        # its reader while a reconnect already dialed a new one) must only
        # fail entries from its own generation — nuking newer-epoch
        # futures would spuriously retry calls on the healthy connection
        # (duplicating non-idempotent ops) and force needless stream
        # re-syncs (ADVICE r5 medium).
        self._epoch = 0
        self._pending: dict[int, tuple[int, asyncio.Future]] = {}
        self._streams: dict[int, tuple[int, asyncio.Queue]] = {}
        self._rx_task: asyncio.Task | None = None
        # client-unique publish ids let the hub drop the duplicate when
        # _call's at-least-once retry re-sends a publish whose ack was
        # lost in a crash (ADVICE r5 low: a dup under a fresh seq defeats
        # the subscribe-side seq dedup and double-counts router blocks)
        self._pub_ids = itertools.count(1)
        self._client_id = uuid.uuid4().hex[:12]
        self._write_lock = asyncio.Lock()
        self._conn_lock = asyncio.Lock()
        self._reconnect = reconnect
        self._reconnect_window_s = reconnect_window_s
        self._closed = False

    @classmethod
    async def connect(
        cls,
        address: str,
        timeout: float = 5.0,
        *,
        reconnect: bool = True,
        reconnect_window_s: float = 10.0,
    ) -> "RemoteHub":
        hub = cls(
            address,
            reconnect=reconnect,
            reconnect_window_s=reconnect_window_s,
        )
        await hub._connect(timeout)
        return hub

    @staticmethod
    def _split(addr: str) -> tuple[str, int]:
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)

    async def _connect(self, timeout: float = 5.0) -> None:
        """Dial the preferred address, falling back round-robin through
        the rest; raises the last dial error when every replica fails."""
        last_err: Exception | None = None
        for i in range(len(self._addrs)):
            idx = (self._addr_idx + i) % len(self._addrs)
            host, port = self._split(self._addrs[idx])
            try:
                if FAULTS.enabled:
                    await FAULTS.fire("hub.dial")  # drop/error: the dial fails
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), timeout
                )
            except (OSError, asyncio.TimeoutError) as e:
                last_err = e
                continue
            self._addr_idx = idx
            self._epoch += 1
            self._rx_task = asyncio.get_running_loop().create_task(
                self._rx_loop(self._reader, self._epoch)
            )
            return
        raise last_err if last_err is not None else OSError(
            "no hub addresses"
        )

    def _connected(self) -> bool:
        return (
            self._writer is not None
            and not self._writer.is_closing()
            and self._rx_task is not None
            and not self._rx_task.done()
        )

    async def _ensure_connected(self) -> None:
        """Re-dial with backoff for up to the reconnect window. Raises
        ConnectionError when closed, reconnect is disabled, or the window
        is exhausted."""
        if self._closed:
            raise ConnectionError("hub client closed")
        if self._connected():
            return
        if not self._reconnect:
            raise ConnectionError("hub not connected")
        # dynalint: disable=DL009 -- deliberate: _conn_lock's whole job is
        # to serialize re-dials — contenders MUST wait for the one
        # reconnect in flight (a parallel dial would mint a duplicate rx
        # loop), and the span is bounded by reconnect_window_s
        async with self._conn_lock:
            if self._closed:
                raise ConnectionError("hub client closed")
            if self._connected():
                return  # a neighbor reconnected while we waited
            if self._writer is not None:
                self._writer.close()
            deadline = time.monotonic() + self._reconnect_window_s
            delay = 0.05
            while True:
                try:
                    await self._connect(timeout=2.0)
                    return
                except (OSError, asyncio.TimeoutError):
                    if self._closed or time.monotonic() + delay >= deadline:
                        raise ConnectionError(
                            f"hub unreachable for {self._reconnect_window_s}s"
                        )
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 1.0)

    async def _rx_loop(self, reader: asyncio.StreamReader, epoch: int) -> None:
        try:
            while True:
                msg = await framing.read_frame(reader)
                if msg is None:
                    break
                mid = msg.get("id")
                if "stream" in msg:
                    entry = self._streams.get(mid)
                    if entry is not None:
                        entry[1].put_nowait(msg["stream"])
                else:
                    _ep, fut = self._pending.pop(mid, (0, None))
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
        except Exception as e:  # noqa: BLE001 — any rx failure = conn lost
            # the finally block below converts this into the reconnect
            # path; keep the *cause* visible for post-mortems (an
            # oversized-frame bug looks identical to a cut cable without
            # this line — dynalint DL003)
            log.debug("hub rx loop (epoch %d) died: %s: %s",
                      epoch, type(e).__name__, e)
        finally:
            # connection lost: fail in-flight calls (their callers retry
            # via _call's reconnect loop) and wake stream consumers (they
            # re-open). MUST run even on unexpected read errors (OSError
            # variants, oversized/corrupt frames) or callers await their
            # futures forever. EPOCH-SCOPED: a reconnect can replace this
            # task while it is still blocked on the dead reader (a send-
            # side broken pipe surfaces before the read side EOFs), so
            # only entries from THIS connection generation — which no rx
            # loop will ever answer — may be failed; newer-epoch entries
            # belong to the live connection and its own rx loop.
            err = ConnectionError("hub connection lost")
            for mid, (ep, fut) in list(self._pending.items()):
                if ep <= epoch:
                    del self._pending[mid]
                    if not fut.done():
                        fut.set_exception(err)
            for _mid, (ep, q) in list(self._streams.items()):
                if ep <= epoch:
                    q.put_nowait(None)  # sentinel: stream closed

    async def _send_request(self, op: str, kwargs: dict[str, Any]) -> Any:
        if FAULTS.enabled:
            # drop: a ConnectionError, into _call's reconnect-and-retry loop
            await FAULTS.fire("hub.call")
        mid = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        try:
            # dynalint: disable=DL009 -- deliberate: per-connection frame
            # writes MUST serialize (interleaved write_frame calls corrupt
            # the framing); the await is bounded by socket backpressure,
            # and a dead peer surfaces as ConnectionError to every waiter
            async with self._write_lock:
                # snapshot writer+epoch together INSIDE the lock: a
                # reconnect can land while we awaited the lock, and the
                # entry must be tagged with the epoch of the connection
                # the frame actually goes out on — a stale tag would let
                # the dying rx loop fail a request in flight on the
                # healthy connection (spurious retry of a non-idempotent
                # op, the exact bug the epochs exist to prevent)
                writer, epoch = self._writer, self._epoch
                self._pending[mid] = (epoch, fut)
                await framing.write_frame(
                    writer, {"id": mid, "op": op, **kwargs}
                )
        except (OSError, ConnectionError):
            self._pending.pop(mid, None)
            raise ConnectionError("hub connection lost on send")
        msg = await fut
        if not msg.get("ok"):
            if msg.get("error") == "key_exists":
                raise KeyExists(msg.get("key"))
            if msg.get("error") == "not_leader":
                REDIRECTS.labels("not_leader").inc()
                raise NotLeader(msg.get("leader"))
            if msg.get("error") in ("no_quorum", "unavailable"):
                REDIRECTS.labels(msg["error"]).inc()
                # the leader logged the write but could not commit it to a
                # majority (mid-partition): retryable exactly like a
                # mid-election bounce — chase until the cluster converges.
                # AMBIGUOUS like any timeout: the record may still commit
                # once stragglers ack, so a retried non-idempotent create
                # can see KeyExists for its own write — the same
                # at-least-once exposure the reconnect path documents
                # (publish stays exactly-once via pub_id dedup). A
                # server-supplied retry_after hint (election/lease scale)
                # rides along and takes precedence over our own backoff.
                hint = msg.get("retry_after")
                raise NotLeader(
                    None,
                    retry_after_s=float(hint) if hint is not None else None,
                )
            raise RuntimeError(f"hub error for {op}: {msg.get('error')}")
        return msg.get("result")

    async def _redirect(self, leader: str | None) -> None:
        """Point the next dial at the leader (when hinted; otherwise the
        next replica in the ring — an election may still be running) and
        drop the current connection so _ensure_connected re-dials."""
        if leader:
            if leader not in self._addrs:
                self._addrs.append(leader)
            self._addr_idx = self._addrs.index(leader)
        else:
            self._addr_idx = (self._addr_idx + 1) % len(self._addrs)
        async with self._conn_lock:
            if self._writer is not None:
                self._writer.close()

    async def _call(self, op: str, **kwargs: Any) -> Any:
        deadline: float | None = None
        hops = 0
        while True:
            try:
                await self._ensure_connected()
                return await self._send_request(op, kwargs)
            except NotLeader as e:
                # a follower bounced a write: chase the leader, but
                # BOUNDED — max hops with jittered exponential backoff, so
                # a mid-election cluster (or two stale replicas naming
                # each other as leader) cannot spin us in a redirect loop
                if not self._reconnect or self._closed:
                    raise ConnectionError(
                        f"hub follower refused {op!r}: leader is "
                        f"{e.leader or 'unknown'}"
                    )
                hops += 1
                deadline = deadline or (
                    time.monotonic() + self._reconnect_window_s
                )
                if hops > self.MAX_REDIRECT_HOPS:
                    raise ConnectionError(
                        f"hub redirect loop: {op!r} bounced "
                        f"{hops} times without reaching a leader"
                    )
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"hub leaderless for {self._reconnect_window_s}s "
                        f"(op {op!r})"
                    )
                await self._redirect(e.leader)
                hint = e.retry_after_s
                if hint:
                    # server-supplied hint (no_quorum/unavailable
                    # bounces): the server KNOWS its election/lease
                    # timescale — honor it (lightly jittered so a
                    # thundering herd of bounced writers still spreads),
                    # bounded by the remaining failover window
                    backoff = min(
                        float(hint) * (0.9 + 0.2 * random.random()),
                        max(deadline - time.monotonic(), 0.0),
                    )
                else:
                    backoff = (
                        min(0.05 * (2 ** (hops - 1)), 0.5)
                        * (0.5 + random.random())
                    )
                BACKOFF.observe(backoff)
                await asyncio.sleep(backoff)
            except ConnectionError:
                if not self._reconnect or self._closed:
                    raise
                deadline = deadline or (
                    time.monotonic() + self._reconnect_window_s
                )
                if time.monotonic() >= deadline:
                    raise
                await asyncio.sleep(0.05)

    async def _open_stream(
        self, op: str, **kwargs: Any
    ) -> tuple[int, asyncio.Queue]:
        await self._ensure_connected()
        mid = next(self._ids)
        q: asyncio.Queue = asyncio.Queue()
        try:
            # dynalint: disable=DL009 -- deliberate: same frame-write
            # serialization contract as _send_request (interleaved frames
            # corrupt the protocol; bounded by socket backpressure)
            async with self._write_lock:
                # same epoch-at-send discipline as _send_request
                writer, epoch = self._writer, self._epoch
                self._streams[mid] = (epoch, q)
                await framing.write_frame(
                    writer, {"id": mid, "op": op, **kwargs}
                )
        except (OSError, ConnectionError):
            self._streams.pop(mid, None)
            raise ConnectionError("hub connection lost on stream open")
        return mid, q

    async def _close_stream(self, mid: int) -> None:
        self._streams.pop(mid, None)
        if self._connected() and not self._closed:
            try:
                # dynalint: disable=DL009 -- deliberate: frame-write
                # serialization (see _send_request); cancel frames ride
                # the same connection as the calls they cancel
                async with self._write_lock:
                    await framing.write_frame(
                        self._writer, {"id": next(self._ids), "op": "cancel", "target": mid}
                    )
            except (ConnectionError, OSError, RuntimeError):
                pass

    # -- kv ---------------------------------------------------------------

    async def put(self, key: str, value: Any, lease_id: int | None = None) -> None:
        await self._call("put", key=key, value=value, lease=lease_id)

    async def create(self, key: str, value: Any, lease_id: int | None = None) -> None:
        await self._call("create", key=key, value=value, lease=lease_id)

    async def get(self, key: str) -> Any:
        return await self._call("get", key=key)

    async def delete(self, key: str) -> bool:
        return await self._call("delete", key=key)

    async def get_prefix(self, prefix: str) -> dict[str, Any]:
        return await self._call("get_prefix", prefix=prefix)

    def _stream_retry_gate(self, deadline: float | None) -> float:
        """Shared stream-reconnect policy: raise when reconnect is off,
        the client is closed, or the failure deadline passed; otherwise
        return the deadline (setting it on first failure). Streams must
        NOT retry unboundedly — a permanently dead hub has to surface as
        ConnectionError so consumers hit their etcd-loss => shutdown
        path."""
        if not self._reconnect or self._closed:
            raise ConnectionError("hub connection lost")
        deadline = deadline or time.monotonic() + self._reconnect_window_s
        if time.monotonic() >= deadline:
            raise ConnectionError(
                f"hub unreachable for {self._reconnect_window_s}s"
            )
        return deadline

    async def watch_prefix(
        self, prefix: str, *, initial: bool = True, sync_marker: bool = False
    ) -> AsyncIterator[WatchEvent]:
        known: set[str] = set()
        first = True
        fail_deadline: float | None = None
        while True:
            # first open: plain watch, events stream through untouched (no
            # marker — also keeps legacy servers working). Re-opens after a
            # connection loss request the sync marker so the fresh snapshot
            # can be diffed against ``known`` for missed deletes.
            resync = not first
            try:
                mid, q = await self._open_stream(
                    "watch", prefix=prefix,
                    initial=initial if first else True, sync=resync,
                )
            except ConnectionError:
                fail_deadline = self._stream_retry_gate(fail_deadline)
                await asyncio.sleep(0.05)
                continue
            fail_deadline = None
            try:
                if resync:
                    # collect the snapshot up to the server's sync marker,
                    # then reconcile: keys we know that are GONE from the
                    # fresh snapshot were deleted while we were away
                    snap: list[WatchEvent] = []
                    while True:
                        item = await q.get()
                        if item is None:
                            raise _ConnLost
                        if item["kind"] == "sync":
                            break
                        snap.append(
                            WatchEvent(
                                item["kind"], item["key"], item.get("value")
                            )
                        )
                    snap_keys = {ev.key for ev in snap if ev.kind == "put"}
                    for key in sorted(known - snap_keys):
                        known.discard(key)
                        yield WatchEvent("delete", key)
                    # snapshot puts re-yield even already-known keys:
                    # puts are idempotent upserts for every consumer, and
                    # the value may have changed while disconnected
                    for ev in snap:
                        if ev.kind == "put":
                            known.add(ev.key)
                        yield ev
                first = False
                while True:
                    item = await q.get()
                    if item is None:
                        raise _ConnLost
                    if item["kind"] == "sync":
                        continue
                    ev = WatchEvent(item["kind"], item["key"], item.get("value"))
                    if ev.kind == "put":
                        known.add(ev.key)
                    elif ev.kind == "delete":
                        known.discard(ev.key)
                    yield ev
            except _ConnLost:
                self._streams.pop(mid, None)
                fail_deadline = self._stream_retry_gate(fail_deadline)
                first = False
                continue
            finally:
                await self._close_stream(mid)

    # -- leases ------------------------------------------------------------

    async def grant_lease(self, ttl_s: float) -> int:
        return await self._call("grant_lease", ttl=ttl_s)

    async def get_boot_id(self) -> str | None:
        try:
            return await self._call("boot_id")
        except RuntimeError as e:
            # ONLY the legacy-server case maps to "unknown": transient
            # RPC failures must propagate, or a blip would silently store
            # boot=None and disable hub-reboot detection downstream
            if "unknown op" in str(e):
                return None
            raise

    async def keepalive(self, lease_id: int) -> bool:
        return await self._call("keepalive", lease=lease_id)

    async def revoke_lease(self, lease_id: int) -> None:
        await self._call("revoke_lease", lease=lease_id)

    # -- pub/sub -----------------------------------------------------------

    async def publish(
        self, subject: str, payload: Any, pub_id: str | None = None
    ) -> bool:
        # idempotency id: _call's reconnect loop may re-send after a lost
        # ack; the hub dedups on pub_id so the retry cannot mint a second
        # event under a fresh seq (hub.py publish; legacy servers ignore
        # the extra field and keep plain at-least-once semantics)
        res = await self._call(
            "publish", subject=subject, payload=payload,
            pub_id=pub_id or f"{self._client_id}:{next(self._pub_ids)}",
        )
        # legacy servers ack with a bare True; new ones relay the hub's
        # applied/deduplicated bool so the contract matches local hubs
        return True if res is None else bool(res)

    async def purge_subject(
        self, subject: str, keep_last: int = 0,
        up_to_seq: int | None = None,
    ) -> int:
        return await self._call(
            "purge_subject", subject=subject, keep_last=keep_last,
            up_to_seq=up_to_seq,
        )

    async def subscribe(
        self, subject: str, *, replay: bool = False, with_seq: bool = False
    ) -> AsyncIterator[tuple]:
        last_seq: dict[str, int] = {}
        boot: str | None = None
        first = True
        fail_deadline: float | None = None
        while True:
            # re-subscribe with replay only if the caller wanted replay:
            # a live-only subscription stays live-only across reconnects
            # (missed events are lost — NATS-core semantics); a replay
            # subscription dedups by per-subject seq, which the durable
            # hub preserves across restarts. Seq baselines are only valid
            # within one hub boot: a NON-durable hub restart resets seq
            # counters, so a changed boot_id clears the dedup map instead
            # of silently discarding fresh low-seq events.
            try:
                if replay:
                    new_boot = await self.get_boot_id()
                    if not first and new_boot != boot:
                        last_seq.clear()
                    boot = new_boot
                mid, q = await self._open_stream(
                    "subscribe", subject=subject, replay=replay
                )
            except ConnectionError:
                fail_deadline = self._stream_retry_gate(fail_deadline)
                await asyncio.sleep(0.05)
                continue
            fail_deadline = None
            try:
                while True:
                    item = await q.get()
                    if item is None:
                        raise _ConnLost
                    subj, seq = item["subject"], item.get("seq", 0)
                    if replay and not first and seq and seq <= last_seq.get(subj, 0):
                        continue  # already delivered before the reconnect
                    if seq:
                        last_seq[subj] = max(last_seq.get(subj, 0), seq)
                    if with_seq:
                        yield subj, item["payload"], seq
                    else:
                        yield subj, item["payload"]
            except _ConnLost:
                self._streams.pop(mid, None)
                fail_deadline = self._stream_retry_gate(fail_deadline)
                first = False
                continue
            finally:
                await self._close_stream(mid)

    # -- object store ------------------------------------------------------

    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        await self._call("put_object", bucket=bucket, name=name, data=bytes(data))

    async def get_object(self, bucket: str, name: str) -> bytes | None:
        return await self._call("get_object", bucket=bucket, name=name)

    async def delete_object(self, bucket: str, name: str) -> None:
        await self._call("delete_object", bucket=bucket, name=name)

    async def close(self) -> None:
        self._closed = True
        if self._rx_task is not None:
            self._rx_task.cancel()
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass


async def connect_hub(address: str | None) -> Hub:
    """Connect to a remote hub, or fall back to a process-local one.

    ``address`` may be a comma-separated multi-address list (a replicated
    hub deployment, hub_replica.py) — every connect site gets round-robin
    failover across the whole list, not just the first entry. Env
    layering (``DYN_HUB_ADDRESSES`` / ``DYN_HUB_ADDRESS``) lives in
    RuntimeConfig.hub_target(), the single source of truth — callers pass
    its result; an empty address always means in-memory."""
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    address = (address or "").strip()
    if address:
        return await RemoteHub.connect(address)
    return InMemoryHub()
