"""Leader-driven SPMD replay: one logical worker over several processes
(the counterpart of dynamo_tpu/parallel/spmd.py).

Every rank of a group (the dp x sp x ep x tp ranks of an engine's mesh:
the tp groups, the expert groups, the ring's sp groups) must run the same
collectives in the same order, or the first one it waits in never
completes. So every rank but the leader follows, the ep, sp and dp
replicas of the leader's tp coordinate included: each replays the whole forward, and its
tp and expert collectives line up with the leader's. The LEADER (rank 0) runs the
whole engine: scheduler, page bookkeeping, sampling, streaming. Before
each device dispatch on the serving path it publishes a step descriptor:
an op tag, scalars, and the host arrays the dispatch consumes. Each
FOLLOWER holds an engine shell built as the leader's (spec, config, its
own shard of the weights and the KV pools, the same decode and verify
graphs) and replays every descriptor through the same entry points, so
its collectives line up with the leader's. It keeps only device state;
its results are discarded, except the tokens of its own in-flight decode
bursts, which it chains into the next burst as the leader does (the
descriptor says which burst feeds which slot).

Ops: ``prefill`` (one prompt, with multimodal rows when it carries them),
``ring_prefill`` (a cold prompt over the sp ranks: every rank of the ring
joins it), ``prefill_batch``, ``verify`` (the speculative verify; the port's own),
``decode`` (a burst and its chain feeds), ``kv_offload`` / ``kv_onboard``
(each rank moves its own shard of a block between its pools and its own
KVBM tiers; a block a strict follower's tiers lack breaks the plane, a
mirror re-syncs), ``precompile`` (one graph capture: its warm-up steps run the
collectives), ``kv_digest`` (each rank prints a digest of its pages in
use: a mirror's equals the leader's), ``kv_export`` (a prefill group's
ranks each gather and export their KV heads of a finished prompt under
the leader's transfer id, before its pages are released),
``kv_prefetch`` / ``kv_unstage`` (a decode rank starts pulling its own
shard of a sharded export in the background at the leader's intake, or
drops it: no collectives, so the leader may publish them from any thread),
``kv_resume`` (a decode group's ranks each install their heads of a remote
prefill: rank r its prefetched shard r; or the leader sends each rank its
heads of the whole blocks over the group; or, with mirror links, the
descriptors carry the tail in chunks of ``RESUME_CHUNK_BYTES``),
``embed`` (an embedding forward and its tp collectives), ``kv_gather``
(a rejoin snapshot of a tp group gathers every rank's heads) and
``sync_install`` (a relayed snapshot chunk: a mirror group's rank 0 hands
its followers the leader's snapshot), ``stop``; and the plane's own
``__sync__`` (a rejoin's state snapshot) and ``__reject__`` (a join past
the catch-up window). The ops after ``kv_digest`` are the port's.

TRANSPORT: one TCP stream per follower, framed by runtime/framing.py
(arrays as raw bytes). The leader's address sits under
``spmd/<group>/addr`` on a hub: the worker's hub, or the group's own
``torch.distributed`` store (``StoreHub``) when there is none. A bounded
ring (``RING_FRAMES`` descriptors, ``RING_BYTES`` of payload) replays the
backlog to a follower that connects late.

Two policies, as the reference's. STRICT (a mesh's group: the ranks share
collectives): a follower lost, or one that stops draining, latches the
plane broken and the engine reports itself dead; nothing rejoins.
MIRROR (``--mirror``: each process runs its own whole model and no
collective spans them): the leader keeps serving, and a follower that
comes back rejoins through a quiesced ``__sync__`` snapshot of the
leader's pages in chunks of ``SYNC_CHUNK_BYTES``. A strict group's leader
can serve mirror links too (``advertise``: its address on a second hub;
a link whose hello says ``mirror`` never breaks the plane). A mirror of a
tp group of N is a second group of N ranks: its rank 0 follows the
leader's stream as a mirror and RELAYS every descriptor to its own ranks
(``SpmdFollower(relay=)``, its group's strict leader) before it applies
it, so every rank of the mirror replays the leader's stream with its own
collectives; its followers get the rejoin snapshot as ``sync_install``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.runtime.framing import read_frame, write_frame

log = logging.getLogger("dynamo_tpu_torch.spmd")

ADDR_KEY_FMT = "spmd/{group}/addr"
RING_FRAMES = 1024  # catch-up window cap (descriptors)
RING_BYTES = 64 * 1024 * 1024  # catch-up window cap (payload bytes)
SYNC_CHUNK_BYTES = 64 * 1024 * 1024  # rejoin snapshot chunk (< MAX_FRAME)
# a mirrored resume's tail per descriptor: well under RING_BYTES, so one
# resume does not flush the catch-up ring
RESUME_CHUNK_BYTES = 16 * 1024 * 1024
# how long a rejoiner may overflow its (bounded) sync queue without
# latching the strict-mode plane broken
SYNC_DRAIN_GRACE_S = 300.0

# queue sentinel: the leader dropped this follower (stopped draining)
_DROPPED = object()


def _enc(arr: np.ndarray) -> dict[str, Any]:
    arr = np.ascontiguousarray(arr)
    return {"dtype": arr.dtype.name, "shape": list(arr.shape), "data": arr.tobytes()}


def _dec(d: dict[str, Any]) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def _default_strict() -> bool:
    """Strict when this process is a rank of a multi-rank group."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


class StoreHub:
    """The three hub calls the plane makes (``put``, ``get``, ``delete``)
    over a ``torch.distributed`` store: a group's ranks find the
    leader's address through the rendezvous they already share."""

    def __init__(self, store=None):
        if store is None:
            import torch.distributed.distributed_c10d as c10d

            store = c10d._get_default_store()
        self.store = store

    async def put(self, key: str, value: str) -> None:
        self.store.set(key, value)

    async def get(self, key: str) -> str | None:
        if not self.store.check([key]):
            return None
        value = self.store.get(key).decode()
        return value or None

    async def delete(self, key: str) -> bool:
        # an empty value reads as absent (not every store deletes)
        self.store.set(key, "")
        return True


class SpmdLeader:
    """Streams step descriptors to followers over direct TCP.

    ``publish`` is called from the engine's step thread and never blocks:
    it appends to the ring and hands the frame to each connection's writer
    queue on the event loop. A ``side`` descriptor (one whose replay runs
    no collective) may come from any thread. It counts the descriptors,
    their payload bytes and the host seconds spent encoding them
    (``publish_count``, ``publish_bytes``, ``publish_secs``), and the step
    thread's own (``lockstep_count``)."""

    def __init__(self, hub, loop: asyncio.AbstractEventLoop, group: str,
                 host: str = "127.0.0.1", strict: bool | None = None):
        self.hub = hub
        self.loop = loop
        self.group = group
        self.host = host
        self.publish_failures = 0
        self.publish_count = 0
        self.lockstep_count = 0
        self._lock = threading.Lock()  # sequence numbers across threads
        self.publish_bytes = 0
        self.publish_secs = 0.0
        self._broken = False
        self.broken_reason: str | None = None
        self.strict = _default_strict() if strict is None else strict
        self._sync_waiting: list[tuple[asyncio.Future, Any]] = []
        self._sync_pending = 0
        self.syncs_served = 0  # rejoin snapshots served
        self.on_sync_request = None  # engine wake hook (set by the engine)
        self._ring: deque[tuple[int, dict, int]] = deque()
        self._ring_bytes = 0
        # highest seq visible on the event loop (the join handshake must
        # not race the step thread's publish_count)
        self._loop_seq = 0
        self._conns: list[asyncio.Queue] = []
        self._streams: set[asyncio.Task] = set()  # live connection handlers
        self._server: asyncio.AbstractServer | None = None
        self._addr = ""
        self._advertised: list = []  # second hubs holding the address

    async def start(self) -> "SpmdLeader":
        self._server = await asyncio.start_server(self._serve_conn, self.host, 0)
        port = self._server.sockets[0].getsockname()[1]
        self._addr = f"{self.host}:{port}"
        await self.hub.put(ADDR_KEY_FMT.format(group=self.group), self._addr)
        log.info("spmd leader descriptor plane on %s:%d", self.host, port)
        return self

    async def advertise(self, hub) -> None:
        """Also publish the address on ``hub`` (a tp group's leader under
        ``--mirror leader``: mirror followers look for it on the worker's
        hub)."""
        await hub.put(ADDR_KEY_FMT.format(group=self.group), self._addr)
        self._advertised.append(hub)

    @property
    def mirrored(self) -> bool:
        """True when followers outside this group's collectives may
        replay the stream (a mirror leader, or an advertised one): what
        they install must ride the descriptors."""
        return not self.strict or bool(self._advertised)

    @property
    def followers(self) -> int:
        """Followers connected now."""
        return len(self._conns)

    @property
    def healthy(self) -> bool:
        return not self._broken

    def mark_broken(self, reason: str) -> None:
        """Latch the plane broken: followers out of lockstep cannot be
        repaired in strict mode, so it must be visible, not a deadlock."""
        if not self._broken:
            log.error("spmd plane broken: %s", reason)
            self.broken_reason = reason
        self._broken = True

    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._streams.add(task)
        try:
            await self._serve_conn_inner(reader, writer)
        finally:
            self._streams.discard(task)

    async def _serve_conn_inner(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        hello = await read_frame(reader)
        if hello is None:
            writer.close()
            return
        # a mirror link (a follower outside this group's collectives)
        # never breaks a strict plane
        mirror = bool(hello.get("mirror"))
        if hello.get("sync"):
            # REJOIN: park until the engine reaches a step boundary and
            # calls serve_sync, then stream the snapshot and live frames
            fut: asyncio.Future = self.loop.create_future()
            self._sync_waiting.append((fut, writer))
            self._sync_pending += 1
            if self.on_sync_request is not None:
                self.on_sync_request()
            log.info("spmd follower %s requested rejoin sync", peer)
            try:
                sync_frames, q = await fut
            except asyncio.CancelledError:
                writer.close()
                raise
            q.mirror = mirror
            await self._stream_to(peer, writer, q, sync_frames)
            return
        from_seq = int(hello.get("from_seq", 0))
        oldest = self._ring[0][0] if self._ring else self._loop_seq + 1
        if from_seq + 1 < oldest:
            await write_frame(writer, {
                "op": "__reject__",
                "scalars": {"reason": f"catch-up window exceeded "
                            f"(need {from_seq + 1}, oldest {oldest})"},
                "arrays": {},
            })
            writer.close()
            if self.strict and not mirror:
                self.mark_broken(f"follower {peer} beyond catch-up window")
            return
        q: asyncio.Queue = asyncio.Queue(maxsize=RING_FRAMES)
        q.mirror = mirror
        # backlog + live, no gap: one loop turn between the ring snapshot
        # and the queue registration
        backlog = [f for s, f, _n in self._ring if s > from_seq]
        self._conns.append(q)
        log.info("spmd follower %s joined (%d backlog frames)", peer, len(backlog))
        await self._stream_to(peer, writer, q, backlog)

    async def _stream_to(self, peer, writer, q: asyncio.Queue, first_frames) -> None:
        try:
            for f in first_frames:
                await write_frame(writer, f)
            while True:
                frame = await q.get()
                if frame is _DROPPED:
                    break
                await write_frame(writer, frame)
                if frame["op"] == "stop":
                    break
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError) as e:
            self._follower_lost(peer, e, getattr(q, "mirror", False))
        finally:
            if q in self._conns:
                self._conns.remove(q)
            writer.close()

    def _follower_lost(self, peer, err, mirror: bool = False) -> None:
        if self.strict and not mirror:
            self.mark_broken(f"follower {peer} connection lost: {err}")
        else:
            log.warning("spmd follower %s lost (%s); serving continues, "
                        "awaiting rejoin", peer, err)

    @property
    def sync_pending(self) -> int:
        """Rejoin syncs waiting for the engine's next step boundary."""
        return self._sync_pending

    def serve_sync(self, chunks: list[tuple]) -> None:
        """Resolve every parked rejoin with a quiesced state snapshot:
        ``chunks`` of (page_ids, k, v) numpy arrays, each under
        SYNC_CHUNK_BYTES. Called from the step thread at a step boundary
        (pipeline flushed); the queue registers on the loop before any
        later publish lands, so the follower sees the snapshot, then every
        later descriptor."""
        seq = self.publish_count
        frames: list[dict] = []
        if not chunks:
            frames.append({"op": "__sync__", "scalars": {"seq": seq, "last": True},
                           "arrays": {"page_ids": _enc(np.zeros((0,), np.int32))}})
        for i, (ids, k, v) in enumerate(chunks):
            frames.append({"op": "__sync__",
                           "scalars": {"seq": seq, "last": i == len(chunks) - 1},
                           "arrays": {"page_ids": _enc(ids), "k": _enc(k),
                                      "v": _enc(v)}})
        self._sync_pending = 0
        self.syncs_served += 1

        def _resolve() -> None:
            waiting, self._sync_waiting = self._sync_waiting, []
            for fut, writer in waiting:
                if fut.done():
                    continue
                if writer.is_closing():
                    fut.cancel()  # the requester died while parked
                    continue
                q = asyncio.Queue(maxsize=4 * RING_FRAMES)
                q.sync_grace_until = time.monotonic() + SYNC_DRAIN_GRACE_S
                self._conns.append(q)
                fut.set_result((frames, q))

        try:
            self.loop.call_soon_threadsafe(_resolve)
        except RuntimeError:
            pass  # loop closed during shutdown

    def publish(self, op: str, scalars: dict[str, Any] | None = None,
                arrays: dict[str, np.ndarray] | None = None, side: bool = False) -> int:
        """Send one descriptor; returns its sequence number (1, 2, ...).
        ``side``: its replay runs no collective (any thread may send it)."""
        t0 = time.perf_counter()
        msg = {"op": op, "scalars": scalars or {},
               "arrays": {k: _enc(np.asarray(v)) for k, v in (arrays or {}).items()}}
        nbytes = sum(len(v["data"]) for v in msg["arrays"].values()) + 256
        with self._lock:
            self.publish_count += 1
            seq = self.publish_count
            if not side:
                self.lockstep_count += 1
            self.publish_bytes += nbytes
            self._send(msg, seq, nbytes)
        self.publish_secs += time.perf_counter() - t0
        return seq

    def _send(self, msg: dict, seq: int, nbytes: int) -> None:
        """Hand ``msg`` to the ring and the connections on the event loop
        (under the publish lock: the loop sees the sequence in order)."""

        def _enqueue() -> None:
            self._loop_seq = seq
            self._ring.append((seq, msg, nbytes))
            self._ring_bytes += nbytes
            while self._ring and (len(self._ring) > RING_FRAMES
                                  or self._ring_bytes > RING_BYTES):
                _s, _m, n = self._ring.popleft()
                self._ring_bytes -= n
            for q in list(self._conns):
                try:
                    q.put_nowait(msg)
                except asyncio.QueueFull:
                    self._conns.remove(q)
                    backlog = q.qsize()
                    # flush the backlog and leave the sentinel: the stream
                    # closes at a frame boundary, so the drop is visible
                    try:
                        while True:
                            q.get_nowait()
                    except asyncio.QueueEmpty:
                        pass
                    q.put_nowait(_DROPPED)
                    in_grace = getattr(q, "sync_grace_until", 0.0) > time.monotonic()
                    if self.strict and not in_grace and not getattr(q, "mirror", False):
                        self.mark_broken("follower stopped draining descriptors "
                                         f"({backlog} backlogged)")
                    else:
                        log.warning("spmd follower stopped draining; dropped "
                                    "(it will rejoin with a state sync)")

        try:
            self.loop.call_soon_threadsafe(_enqueue)
        except RuntimeError as e:  # loop closed
            self.publish_failures += 1
            self.mark_broken(f"descriptor publish failed: {e}")

    def stop(self) -> None:
        self.publish("stop")

    async def close(self, timeout: float = 10.0) -> None:
        """Let every connection write out what was published (a ``stop``
        ends each stream), then stop listening and withdraw the address."""
        await asyncio.sleep(0)  # the step thread's last publishes land
        if self._streams:
            await asyncio.wait(list(self._streams), timeout=timeout)
        if self._server is not None:
            self._server.close()
        for hub in [self.hub, *self._advertised]:
            try:
                # a follower of a later run must not find this dead leader
                await hub.delete(ADDR_KEY_FMT.format(group=self.group))
            except Exception:  # noqa: BLE001 - the hub may already be gone
                log.debug("spmd leader: address withdrawal failed", exc_info=True)


class SpmdFollower:
    """Replays the leader's descriptors against a local engine shell,
    built exactly as the leader's engine (spec, EngineConfig, mesh, its
    shard of the weights): any other shape would issue other collectives.
    ``rejoin`` (mirror topologies) reconnects with a state sync when the
    stream is lost; strict followers raise. ``relay``: this follower is
    rank 0 of a mirror group, and ``relay`` (its group's strict leader)
    gets every descriptor before this rank applies it."""

    def __init__(self, hub, group: str, engine, rejoin: bool | None = None,
                 relay: SpmdLeader | None = None):
        self.hub = hub
        self.group = group
        self.engine = engine
        self.relay = relay
        self._apply_pool = None  # the apply thread
        self.op_secs: dict[str, float] = {}  # host seconds per op
        depth = int(getattr(engine.config, "pipeline_depth", 2) or 2)
        # this process's in-flight decode bursts by the leader's descriptor
        # sequence number: the chain feeds of later bursts
        self._bursts: OrderedDict[int, Any] = OrderedDict()
        self._max_bursts = max(8, depth + 2)
        self.rejoin = (not _default_strict()) if rejoin is None else rejoin
        self.rejoins = 0  # completed state-sync rejoins
        self.replayed = 0  # descriptors applied
        self.ops: dict[str, int] = {}
        self._sync_pages = 0
        self._tier_missed: set[int] = set()  # onboard misses already re-synced
        self.digest_pages: list[int] = []  # the pages the last kv_digest covered

    async def _leader_addr(self, timeout: float = 60.0) -> str:
        key = ADDR_KEY_FMT.format(group=self.group)
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            addr = await self.hub.get(key)
            if addr:
                return addr
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"no spmd leader address at {key}")
            await asyncio.sleep(0.1)

    async def run(self) -> None:
        """Replay until the leader's ``stop``. With ``rejoin`` a lost stream
        reconnects with a state-sync join (``DYNAMO_SPMD_SYNC_JOIN=1``
        makes the first join a sync join too)."""
        sync_join = os.environ.get("DYNAMO_SPMD_SYNC_JOIN") == "1"
        try:
            await self._run_rejoining(sync_join)
        finally:
            if self._apply_pool is not None:
                self._apply_pool.shutdown(wait=False)

    async def _run_rejoining(self, sync_join: bool) -> None:
        while True:
            try:
                await self._run_once(sync_join)
                return
            except ConnectionError as e:
                if not self.rejoin:
                    raise
                log.warning("spmd stream lost (%s); rejoining with state sync", e)
                self._bursts.clear()
                sync_join = True
                await asyncio.sleep(0.2)

    async def _run_once(self, sync_join: bool) -> None:
        deadline = asyncio.get_running_loop().time() + 60.0
        while True:
            addr = await self._leader_addr()
            host, port = addr.rsplit(":", 1)
            try:
                reader, writer = await asyncio.open_connection(host, int(port))
                break
            except OSError as e:
                if asyncio.get_running_loop().time() > deadline:
                    raise ConnectionError(f"spmd leader at {addr} unreachable: {e}") from e
                await asyncio.sleep(0.3)
        await write_frame(writer, {"from_seq": 0, "sync": sync_join,
                                   "mirror": self.rejoin})
        log.info("spmd follower replaying from %s%s", addr,
                 " (sync join)" if sync_join else "")
        try:
            await self._replay(reader, writer)
        finally:
            writer.close()

    async def _replay(self, reader, writer) -> None:
        while True:
            msg = await read_frame(reader)
            if msg is None:
                raise ConnectionError("spmd descriptor stream closed by leader")
            op = msg["op"]
            sc = msg["scalars"]
            ar = {k: _dec(v) for k, v in msg["arrays"].items()}
            if op == "stop":
                log.info("spmd follower: leader stopped")
                return
            if op == "__reject__":
                if self.rejoin:
                    raise ConnectionError(f"join rejected ({sc.get('reason')})")
                raise RuntimeError(f"spmd leader rejected join: {sc.get('reason')}")
            if op == "__sync__":
                if self.relay is not None:
                    self.relay.publish("sync_install", sc, ar)
                self._install_sync(sc, ar)
                continue
            # on a thread of its own, one descriptor at a time, while the
            # loop stays free: a mirror group's ranks get the descriptor
            # first (this rank's collectives wait for theirs, and the loop
            # writes the frame out), and a prefill rank's transfer source
            # answers its pullers during a replayed forward
            import concurrent.futures

            if self.relay is not None:
                self.relay.publish(op, sc, ar)
            if self._apply_pool is None:
                self._apply_pool = concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="spmd-apply")
            await asyncio.get_running_loop().run_in_executor(
                self._apply_pool, self.apply, op, sc, ar)

    def _install_sync(self, sc: dict, ar: dict) -> None:
        """One chunk of a rejoin snapshot: the leader's quiesced pages."""
        from dynamo_tpu_torch.kvbm.offload import block_tensor

        from dynamo_tpu_torch.disagg.transfer import split_heads

        eng = self.engine
        ids = ar["page_ids"].astype(np.int64)
        if ids.size:
            dev, n = eng.device, eng.kv_shards
            blocks = []
            for name in ("k", "v"):
                b = ar[name]
                if n > 1:  # the snapshot holds every head: install this rank's
                    b = split_heads(b, eng.spec.num_kv_heads, n, eng.mesh.tp_rank,
                                    eng._packed_blocks())
                blocks.append(block_tensor(np.array(b)).to(dev))
            eng.fam.insert_pages(eng.k_pages, eng.v_pages, torch.from_numpy(ids).to(dev),
                                 *blocks)
        self._sync_pages += int(ids.size)
        if sc.get("last", True):
            self._bursts.clear()
            self.rejoins += 1
            log.info("spmd rejoin complete: %d pages synced at seq %s",
                     self._sync_pages, sc.get("seq"))
            self._sync_pages = 0

    def _onboard(self, pages: list[int], hashes: list[int]) -> None:
        """Replay the leader's onboard from this rank's own tiers. A miss on
        a strict follower raises: its shard cannot be made up, and zeros
        would change the group's tokens. A mirror follower re-syncs once
        per missing block (the snapshot holds the leader's onboarded
        pages); a block it misses again zero-fills, loudly."""
        from dynamo_tpu_torch.engine.core import TierMiss

        try:
            self.engine.onboard_from_tiers(pages, None, hashes=hashes)
            return
        except TierMiss as e:
            if not self.rejoin:
                raise RuntimeError(f"kvbm onboard replay: {e}; a strict follower "
                                   "cannot make up its shard") from e
            fresh = [h for h in e.hashes if h not in self._tier_missed]
            if fresh:
                self._tier_missed.update(fresh)
                raise ConnectionError(f"kvbm tier miss ({len(fresh)} blocks); "
                                      "re-syncing") from e
        self.engine.onboard_from_tiers(pages, None, hashes=hashes, zero_fill=True)

    def apply(self, op: str, sc: dict, ar: dict) -> None:
        """Apply one descriptor. Every branch matches one leader dispatch
        site in engine/core.py; keep them in lockstep."""
        eng = self.engine
        fam, spec, dev = eng.fam, eng.spec, eng.device

        def t(name, dtype=torch.int32):
            return torch.from_numpy(np.array(ar[name])).to(dev, dtype)

        t0 = time.perf_counter()
        if op == "prefill":
            mm = {}
            if "mm_embeds" in ar:
                mm = {"mm_embeds": t("mm_embeds", torch.float32), "mm_pos": t("mm_pos")}
            fam.prefill(spec, eng.params, t("tokens"), t("block_table"),
                        int(sc["start"]), eng.k_pages, eng.v_pages,
                        int(sc["num_tokens"]), **mm)
        elif op == "ring_prefill":
            fam.prefill_ring(spec, eng.params, t("tokens"), t("block_table"),
                             eng.k_pages, eng.v_pages, int(sc["num_tokens"]))
        elif op == "prefill_batch":
            fam.prefill_batch(spec, eng.params, t("tokens"), t("block_tables"),
                              torch.from_numpy(np.array(ar["start"])), eng.k_pages,
                              eng.v_pages, torch.from_numpy(np.array(ar["num_tokens"])))
        elif op == "verify":
            eng._verify.dispatch(ar["tokens"], ar["block_tables"], ar["start_pos"],
                                 ar["num_tokens"])
        elif op == "decode":
            chain = [int(s) for s in sc.get("chain", [])]
            missing = [s for s in chain if s not in self._bursts]
            if missing:
                raise RuntimeError(f"chain replay misaligned: bursts {missing} "
                                   "are not in flight here")
            inputs = {name[3:]: ar[name] for name in ar if name.startswith("in_")}
            burst = eng._graphs.dispatch(
                inputs, int(sc["n_steps"]), sampled=bool(sc["sampled"]),
                n_logprobs=int(sc["n_lp"]),
                feeds=[self._bursts[s].last_tokens() for s in chain],
                feed_src=ar["feed_src"], feed_idx=ar["feed_idx"])
            self._bursts[int(sc["id"])] = burst
            while len(self._bursts) > self._max_bursts:
                self._bursts.popitem(last=False)
        elif op == "kv_offload":
            eng.offload_pages([int(h) for h in sc["hashes"]],
                              [int(p) for p in ar["page_ids"]], wait=True)
        elif op == "kv_onboard":
            self._onboard([int(p) for p in ar["page_ids"]], [int(h) for h in sc["hashes"]])
        elif op == "kv_digest":
            self.digest_pages = [int(p) for p in ar["page_ids"]]
            got = eng.pool_digest(self.digest_pages)
            print("SPMD_KV_DIGEST " + json.dumps(got), flush=True)
        elif op == "precompile":
            graphs = eng._graphs if sc["graphs"] == "decode" else eng._verify
            graphs.precompile([tuple(sc["key"])])
        elif op == "kv_export":
            # only the ranks of the leader's tp group hold a transfer source
            # (the shards the params name); replicas and mirrors have none
            if eng.transfer_source is not None:
                eng.export_pages([int(p) for p in ar["page_ids"]], int(sc["num_tokens"]),
                                 transfer_id=sc["transfer_id"])
        elif op == "kv_prefetch":
            eng.prefetch_shard(sc["kvp"])
        elif op == "kv_unstage":
            eng.unstage_shard(sc["transfer_id"])
        elif op == "kv_resume":
            pages = [int(p) for p in ar["page_ids"]]
            if sc["mode"] == "inline":
                eng.install_remote("inline", sc, pages, 0, inline=(ar["k"], ar["v"]))
            else:  # shard, scatter
                eng.install_remote(sc["mode"], sc, pages, int(sc["first"]))
        elif op == "embed":
            eng.embed_padded(np.array(ar["tokens"]), int(sc["num_tokens"]))
        elif op == "kv_gather":
            eng.gather_pages([int(p) for p in ar["page_ids"]])
        elif op == "sync_install":
            self._install_sync(sc, ar)
        else:
            raise RuntimeError(f"unknown spmd op {op!r}")
        self.replayed += 1
        self.ops[op] = self.ops.get(op, 0) + 1
        self.op_secs[op] = self.op_secs.get(op, 0.0) + time.perf_counter() - t0

