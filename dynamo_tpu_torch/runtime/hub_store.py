"""Hub durability: snapshot + write-ahead log (the counterpart of
dynamo_tpu/runtime/hub_store.py, whose files it reads and writes byte for
byte: records and snapshots are msgpack, written by ``runtime/codec``).

The reference rides etcd's disk persistence and NATS JetStream file
storage (ref: lib/runtime/src/transports/etcd.rs leases/KV,
nats.rs:132-243 JetStream stream config): a frontend or router restart
recovers model cards, instance keys, and event-stream positions from
the transports, and a restarted etcd/NATS node recovers its own state
from disk. This module gives the self-hosted hub the same property:

- every mutation appends ONE msgpack record to a write-ahead log
  (length-prefixed, same framing as the wire protocol) and the file is
  flushed before the mutation is acknowledged — a SIGKILL'd hub process
  loses nothing that was acked (OS page cache survives process death;
  set DYNAMO_HUB_FSYNC=1 to also survive kernel/power loss);
- a threshold-triggered snapshot (every ``compact_every`` records,
  written by a background task off the mutation path) bounds replay
  time and WAL growth;
- recovery rebuilds the FULL hub state — KV + lease bindings, leases,
  retained subjects with their per-subject seq counters, object
  buckets — and preserves ``boot_id``, so consumers' persisted seq
  baselines (e.g. the KV router's radix snapshot, kv_router/router.py)
  remain valid across a hub restart.

Leases are restored with deadlines reset to now+ttl: a live owner keeps
them alive via keepalive (lease ids are stable across the restart); a
dead owner's lease re-expires one TTL later — etcd's lease-recovery
semantics. Keepalives are NOT logged (they would dominate the WAL);
re-expiry replaces them.

File layout under ``data_dir``:
  hub.snap      msgpack snapshot, atomically replaced; carries ``gen``
  hub.wal.<g>   records appended since snapshot generation ``g``
On load, only the WAL whose generation matches the snapshot's is
replayed (an older WAL's records are already inside the snapshot — the
crash window between snapshot replace and WAL rotation is covered by
the generation check, never by double-apply). A torn final record
(crash mid-append) is detected and the tail discarded.
"""

from __future__ import annotations

import asyncio
import fnmatch
import itertools
import logging
import os
import struct
import time
from collections import OrderedDict, deque
from pathlib import Path
from typing import Any

from dynamo_tpu_torch.runtime.codec import packb, unpackb
from dynamo_tpu_torch.runtime.context import spawn
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.hub import InMemoryHub, _Lease
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

log = logging.getLogger("dynamo_tpu.hub")

_LEN = struct.Struct(">I")
_MAX_REC = 512 * 1024 * 1024

# Process-wide hub-store metrics, appended to every /metrics surface.
# Background snapshot-compaction failures were previously only visible in
# logs; the counter makes "the WAL is growing because compaction keeps
# failing" alertable before the disk fills.
_METRICS = MetricsRegistry()
COMPACTION_FAILURES = _METRICS.counter(
    "hub_compaction_failures_total",
    "Hub snapshot-compaction failures (serving continues on the "
    "uncompacted WAL).",
)
register_registry("hub_store", _METRICS)


class HubFenced(RuntimeError):
    """A WAL commit was refused by the fencing check: the hub minting the
    record is no longer the leader of the epoch it is writing under
    (hub_replica.py sets the policy via ``_commit_allowed``). The
    in-flight write of a deposed leader dies here instead of being
    replayed into a history the cluster has moved past."""


class HubStore:
    """Disk half of the durable hub: WAL append + snapshot rotation.

    ``fsync`` forces an fsync per WAL append (survives kernel/power loss,
    not just process death); default follows ``DYNAMO_HUB_FSYNC=1``.
    """

    def __init__(self, data_dir: str | Path, *, fsync: bool | None = None):
        self.dir = Path(data_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.gen = 0
        self._wal = None
        self._tmp_ids = itertools.count(1)
        # stale temp snapshots/term files (crash mid-write, or a discarded
        # stale background capture) are dead weight — clear them
        for pattern in ("hub.snap.tmp*", "hub.term.tmp*"):
            for p in self.dir.glob(pattern):
                try:
                    p.unlink()
                except OSError:
                    pass
        self._fsync = (
            os.environ.get("DYNAMO_HUB_FSYNC") == "1" if fsync is None
            else fsync
        )
        self.records_since_snapshot = 0

    @property
    def snap_path(self) -> Path:
        return self.dir / "hub.snap"

    @property
    def term_path(self) -> Path:
        return self.dir / "hub.term"

    def wal_path(self, gen: int) -> Path:
        return self.dir / f"hub.wal.{gen}"

    # -- election term (raft-style durable vote state) ----------------------

    def load_term(self) -> tuple[int, str | None]:
        """(term, voted_for) from the term file; (0, None) when absent or
        torn. Kept OUT of the WAL deliberately: a vote grant must not look
        like replicated-state divergence to the resync path."""
        try:
            data = unpackb(self.term_path.read_bytes())
            return int(data.get("term", 0)), data.get("voted_for")
        except (OSError, ValueError):  # codec: torn, truncated or trailing bytes
            return 0, None

    def save_term(self, term: int, voted_for: str | None) -> None:
        """Atomically persist (term, voted_for). Always fsynced regardless
        of the WAL fsync knob: voting twice in one term after a crash
        breaks election safety outright, while a lost WAL tail only costs
        acked-but-unreplicated data the contract already concedes.
        Deliberately synchronous on the caller's thread (it runs on the
        event loop from vote handling): the grant must be durable BEFORE
        the response frame leaves the process, and term changes happen
        once per election — not per write — so the stall is rare and
        bounded, unlike the per-append path that earned a background
        thread."""
        tmp = Path(f"{self.term_path}.tmp{next(self._tmp_ids)}")
        with open(tmp, "wb") as f:
            f.write(packb({"term": int(term), "voted_for": voted_for}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.term_path)
        # the rename itself must be durable before the grant leaves this
        # process: without the directory fsync a power loss can resurrect
        # the OLD term file and let the restarted replica vote a second
        # time in the same term
        dirfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    # -- load --------------------------------------------------------------

    def load(self) -> tuple[dict[str, Any] | None, list[dict[str, Any]]]:
        """(snapshot state or None, WAL records after it)."""
        state = None
        if self.snap_path.exists():
            try:
                state = unpackb(self.snap_path.read_bytes())
                self.gen = int(state.get("gen", 0))
            except ValueError as e:
                # torn snapshot can only mean a failed atomic replace
                # that never committed — fall back to empty + WAL
                log.error("hub snapshot unreadable (%s); ignoring", e)
                state = None
        records = self._read_wal(self.wal_path(self.gen))
        return state, records

    def _read_wal(self, path: Path) -> list[dict[str, Any]]:
        if not path.exists():
            return []
        data = path.read_bytes()
        records: list[dict[str, Any]] = []
        off = 0
        while off + _LEN.size <= len(data):
            (n,) = _LEN.unpack_from(data, off)
            if n > _MAX_REC or off + _LEN.size + n > len(data):
                break  # torn tail record: crash mid-append
            try:
                records.append(unpackb(data[off + _LEN.size: off + _LEN.size + n]))
            except ValueError:
                break
            off += _LEN.size + n
        if off != len(data):
            log.warning(
                "hub WAL %s: discarding torn tail (%d bytes)",
                path.name, len(data) - off,
            )
            # truncate so the torn bytes don't prefix future appends
            with open(path, "r+b") as f:
                f.truncate(off)
        return records

    # -- append ------------------------------------------------------------

    def open_wal(self, append: bool = True) -> None:
        mode = "ab" if append else "wb"
        if self._wal is not None:
            self._wal.close()
        self._wal = open(self.wal_path(self.gen), mode)

    def append(self, rec: dict[str, Any]) -> None:
        if FAULTS.enabled:
            # hub.wal_append error = failed disk write (acked mutations
            # must not be lost — the caller surfaces the failure);
            # hub.fsync delay = slow disk at the durability point
            FAULTS.fire_sync("hub.wal_append")
        if self._wal is None:
            self.open_wal()
        body = packb(rec)
        self._wal.write(_LEN.pack(len(body)) + body)
        self._wal.flush()
        if FAULTS.enabled:
            FAULTS.fire_sync("hub.fsync")
        if self._fsync:
            os.fsync(self._wal.fileno())
        self.records_since_snapshot += 1

    # -- snapshot ----------------------------------------------------------

    def snapshot(self, state: dict[str, Any]) -> None:
        """Atomically replace the snapshot and rotate the WAL (inline)."""
        tmp, new_gen = self.write_snapshot_tmp(state)
        self.commit_snapshot(tmp, new_gen, [])

    def write_snapshot_tmp(
        self, state: dict[str, Any]
    ) -> tuple[Path, int]:
        """Serialize + fsync the snapshot to a temp file. Does NOT touch
        the live snapshot or the WAL, so it is safe to run in a worker
        thread while the event loop keeps appending to the current WAL
        (DurableHub background compaction). The temp name is UNIQUE per
        call: an inline hard-bound snapshot may race an in-flight
        background write, and a shared name would let the background
        thread keep writing through its fd into an inode the inline
        path already renamed onto hub.snap — corrupting the live
        snapshot."""
        new_gen = self.gen + 1
        state = dict(state, gen=new_gen)
        # NOT with_suffix: that would REPLACE ".snap" ("hub.tmp7") and
        # the crash-cleanup glob for "hub.snap.tmp*" would never match
        tmp = Path(f"{self.snap_path}.tmp{next(self._tmp_ids)}")
        with open(tmp, "wb") as f:
            f.write(packb(state))
            f.flush()
            if FAULTS.enabled:
                # the snapshot's own durability point: a failing disk here
                # is a compaction failure, not a serving failure — the
                # caller counts it and keeps serving on the old WAL. A
                # DISTINCT site from the per-append hub.fsync: this runs
                # in a compaction worker thread, and sharing one seeded
                # decision stream across threads would make the schedule
                # interleaving-dependent (the determinism faults.py
                # promises).
                FAULTS.fire_sync("hub.snap_fsync")
            os.fsync(f.fileno())
        return tmp, new_gen

    def commit_snapshot(
        self, tmp: Path, new_gen: int,
        pending: list[dict[str, Any]],
    ) -> None:
        """Publish a prepared snapshot: start the new-generation WAL,
        re-append ``pending`` records (mutations logged AFTER the state
        was captured — they are in the old-gen WAL, which the new
        snapshot's generation check will ignore), then atomically replace
        the snapshot. Crash-safe in both orders: before the replace the
        old snapshot + old WAL are authoritative; after it the new
        snapshot + new WAL already hold the pending tail."""
        old_gen = self.gen
        self.gen = new_gen
        self.open_wal(append=False)
        self.records_since_snapshot = 0
        for rec in pending:
            self.append(rec)
        os.replace(tmp, self.snap_path)
        for p in self.dir.glob("hub.wal.*"):
            try:
                if int(p.name.rsplit(".", 1)[1]) < new_gen:
                    p.unlink()
            except (ValueError, OSError):
                pass
        log.info(
            "hub snapshot gen %d written (%d bytes, %d pending re-appended),"
            " wal rotated from gen %d",
            new_gen, self.snap_path.stat().st_size, len(pending), old_gen,
        )

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None


class DurableHub(InMemoryHub):
    """InMemoryHub + HubStore persistence: every mutation WAL-logged,
    full state (incl. boot_id and per-subject seqs) recovered on
    construction. The etcd-disk + JetStream-file-store durability role.

    Snapshot compaction is a threshold-triggered BACKGROUND task: once
    ``compact_every`` records accumulate, the state is captured
    synchronously but serialized + fsynced in a worker thread, and
    mutations keep flowing to the old-generation WAL meanwhile (they are
    re-appended to the new generation at commit). The mutating call never
    pays the snapshot latency — replication bootstrap (hub_replica.py)
    can request snapshots without blocking the serving path. A hard
    bound (4x the threshold) falls back to an inline snapshot so a loop
    that never yields still cannot grow the WAL unboundedly.

    Replication taps: every logged record gets a global ``wal_seq``; the
    last ``REPL_BACKLOG`` records are kept in memory so a follower can
    catch up mid-WAL, and listener queues registered in
    ``_repl_listeners`` receive every ``(seq, record)`` as it commits.
    """

    # in-memory (seq, record) window a reconnecting follower can resume
    # from without a snapshot bootstrap
    REPL_BACKLOG = 8192

    def __init__(
        self, data_dir: str | Path, *, compact_every: int = 8192,
        fsync: bool | None = None,
    ) -> None:
        super().__init__()
        self.compact_every = compact_every
        self.store = HubStore(data_dir, fsync=fsync)
        # replication stream position: total records ever logged by the
        # leader lineage this hub's state descends from
        self.wal_seq = 0
        # leadership term; bumped by hub_replica promotion
        self.repl_epoch = 0
        # fencing epoch of the LAST record in the log: the raft election
        # restriction compares (last record term, position), so a deposed
        # leader's uncommitted tail — long, but stamped with a dead term —
        # can never outrank a shorter log holding newer-term records
        self.last_rec_epoch = 0
        # follower-side: last leader wal_seq applied (0 = never synced)
        self.repl_cursor = 0
        self._recent: deque = deque(maxlen=self.REPL_BACKLOG)
        self._repl_listeners: list[asyncio.Queue] = []
        self._compacting = False
        # when set, _log also mirrors records here (compaction capture)
        self._capture_log: list[dict[str, Any]] | None = None
        state, records = self.store.load()
        if state is not None:
            self._restore(state)
        for rec in records:
            self._apply(rec)
            # records minted after the replication PR carry their global
            # stream seq ("sq") — prefer it so recovery lands on exactly
            # the position the record was logged at; the increment covers
            # pre-stamp WALs
            self.wal_seq = max(int(rec.get("sq", 0)), self.wal_seq + 1)
            self._recent.append((self.wal_seq, rec))
        self.store.records_since_snapshot = len(records)
        self._import_legacy_objects()
        if state is None and not records:
            # first boot: persist boot_id immediately — a crash before the
            # first compaction must not mint a new identity (consumers'
            # seq baselines key off it)
            self.store.snapshot(self._state())
        self.store.open_wal()

    def _import_legacy_objects(self) -> None:
        """In-place upgrade path: earlier hub versions persisted ONLY the
        object store, as ``data_dir/<bucket>/<file>`` blobs. Import any
        such blob absent from the recovered state so router snapshots /
        model cards written by the old layout survive the upgrade. (The
        old layout flattened '/' in names to '_'; blobs are imported
        under the flattened name, matching how the old server read them
        back from disk.)"""
        imported = 0
        for bucket_dir in sorted(self.store.dir.iterdir()):
            if not bucket_dir.is_dir():
                continue
            for f in sorted(bucket_dir.iterdir()):
                key = (bucket_dir.name, f.name)
                if f.is_file() and key not in self._objects:
                    data = f.read_bytes()
                    self._objects[key] = data
                    self._log(
                        {"op": "obj", "b": key[0], "n": key[1], "d": data}
                    )
                    imported += 1
        if imported:
            log.info("hub: imported %d legacy object blobs", imported)

    # -- state <-> snapshot ------------------------------------------------

    def _state(self) -> dict[str, Any]:
        now = time.monotonic()
        return {
            "boot_id": self.boot_id,
            # replication identity: stream position + leadership term. A
            # follower bootstrapping from this snapshot adopts all three
            # (boot_id included), making identity CLUSTER-wide so client
            # seq baselines stay valid across a failover.
            "wal_seq": self.wal_seq,
            "repl_epoch": self.repl_epoch,
            "repl_cursor": self.repl_cursor,
            "last_e": self.last_rec_epoch,
            "kv": dict(self._kv),
            "key_lease": dict(self._key_lease),
            "leases": [
                # remaining ttl not persisted: restore resets to full ttl
                {"id": l.lease_id, "ttl": l.ttl}
                for l in self._leases.values()
                if self._lease_snapshot_live(l, now)
            ],
            "next_lease": self._next_lease,
            "subject_seq": dict(self._subject_seq),
            # publish-dedup window: persists so a client retry landing
            # after restart+compaction still dedups
            "pub_ids": list(self._seen_pub_ids),
            "retained": {
                subj: list(dq) for subj, dq in self._retained.items()
            },
            "objects": [
                [b, n, d] for (b, n), d in self._objects.items()
            ],
        }

    def _lease_snapshot_live(self, lease: Any, now: float) -> bool:
        """Should this lease survive into a snapshot? The local deadline
        is authoritative on a single (or leader) hub; replication
        followers override — their deadlines are stale by design, since
        keepalives are never replicated and expiry arrives as the
        leader's revoke record."""
        return lease.deadline > now

    def _restore(self, state: dict[str, Any]) -> None:
        self.boot_id = state["boot_id"]
        # .get: pre-replication snapshots carry none of these
        self.wal_seq = int(state.get("wal_seq", 0))
        self.repl_epoch = int(state.get("repl_epoch", 0))
        self.repl_cursor = int(state.get("repl_cursor", 0))
        # pre-election snapshots: the minting leader's epoch is the best
        # available bound for its last record's term
        self.last_rec_epoch = int(state.get("last_e", self.repl_epoch))
        self._kv = dict(state["kv"])
        self._key_lease = dict(state["key_lease"])
        now = time.monotonic()
        for rec in state["leases"]:
            self._leases[rec["id"]] = _Lease(
                rec["id"], rec["ttl"], now + rec["ttl"]
            )
        # leases own their keys again (snapshot stores the binding map)
        for key, lid in self._key_lease.items():
            if lid in self._leases:
                self._leases[lid].keys.add(key)
        self._next_lease = state["next_lease"]
        self._subject_seq = dict(state["subject_seq"])
        # .get: pre-dedup snapshots have no pub_ids entry
        self._seen_pub_ids = OrderedDict(
            (pid, None) for pid in state.get("pub_ids", ())
        )
        self._retained = {
            subj: deque(
                (tuple(item) for item in items),
                maxlen=self.RETAIN_PER_SUBJECT,
            )
            for subj, items in state["retained"].items()
        }
        self._objects = {(b, n): d for b, n, d in state["objects"]}

    # -- WAL replay --------------------------------------------------------

    def _apply(self, rec: dict[str, Any]) -> None:
        """Re-apply one WAL record. Mirrors the mutation bodies exactly,
        minus logging/notification (no watchers or subscribers exist at
        recovery time) and minus anything needing a running loop."""
        op = rec["op"]
        # follower-logged records carry the leader wal_seq they replicate
        # ("rsq", hub_replica.py) so the replication cursor survives a
        # follower restart even for records not yet inside a snapshot
        rsq = rec.get("rsq")
        if rsq is not None:
            self.repl_cursor = max(self.repl_cursor, int(rsq))
        e = rec.get("e")
        if e is not None:
            self.last_rec_epoch = max(self.last_rec_epoch, int(e))
        if op == "put":
            key, lid = rec["k"], rec.get("l")
            if lid is not None and lid in self._leases:
                self._leases[lid].keys.add(key)
                self._key_lease[key] = lid
            self._kv[key] = rec["v"]
        elif op == "del":
            key = rec["k"]
            self._kv.pop(key, None)
            lid = self._key_lease.pop(key, None)
            if lid is not None and lid in self._leases:
                self._leases[lid].keys.discard(key)
        elif op == "lease":
            lid, ttl = rec["id"], rec["ttl"]
            self._leases[lid] = _Lease(lid, ttl, time.monotonic() + ttl)
            self._next_lease = max(self._next_lease, lid + 1)
        elif op == "revoke":
            lease = self._leases.get(rec["id"])
            if lease is not None:
                self._drop_lease(lease)
        elif op == "pub":
            subj = rec["s"]
            if not self._pub_id_fresh(rec.get("pid")):
                return  # replayed duplicate (same pid logged twice)
            if subj not in self._retained:
                self._retained[subj] = deque(maxlen=self.RETAIN_PER_SUBJECT)
            seq = self._subject_seq.get(subj, self._subject_seq_base()) + 1
            self._subject_seq[subj] = seq
            self._retained[subj].append((seq, rec["p"]))
        elif op == "purge":
            for subj in list(self._retained):
                if not fnmatch.fnmatchcase(subj, rec["s"]):
                    continue
                dq = self._retained[subj]
                upto = rec.get("upto")
                if upto is not None:
                    while dq and dq[0][0] <= upto:
                        dq.popleft()
                else:
                    while len(dq) > rec.get("keep", 0):
                        dq.popleft()
        elif op == "obj":
            self._objects[(rec["b"], rec["n"])] = rec["d"]
        elif op == "objdel":
            self._objects.pop((rec["b"], rec["n"]), None)
        elif op == "promote":
            # leadership transition (hub_replica.py): adopt the term and
            # re-apply the promotion seq gap so per-subject seqs stay
            # ahead of anything the dead leader might have minted
            self.repl_epoch = int(rec["epoch"])
            gap = int(rec.get("gap", 0))
            if gap:
                for subj in list(self._subject_seq):
                    self._subject_seq[subj] += gap
        else:  # forward-compat: ignore unknown records
            log.warning("hub WAL: unknown record op %r ignored", op)

    # -- logged mutations --------------------------------------------------

    def _commit_allowed(self, rec: dict[str, Any]) -> None:
        """Commit-time fencing hook: raise HubFenced to refuse logging
        ``rec``. The plain durable hub commits everything; the replicated
        hub (hub_replica.py) refuses records minted by a deposed leader."""

    def _log(self, rec: dict[str, Any]) -> int:
        self._commit_allowed(rec)
        if "sq" not in rec:
            # stamp the record's global stream position so a WAL is
            # self-describing for recovery and the replication invariant
            # checker (followers keep the leader's stamp: rsq == sq)
            rec = dict(rec, sq=self.wal_seq + 1)
        self.store.append(rec)
        self.wal_seq += 1
        self._recent.append((self.wal_seq, rec))
        if self._capture_log is not None:
            self._capture_log.append(rec)
        for q in self._repl_listeners:
            try:
                q.put_nowait((self.wal_seq, rec))
            except asyncio.QueueFull:
                # a stalled follower stream must not grow leader memory
                # without bound: mark it overflowed — the stream ends and
                # the follower re-syncs from its cursor (or a snapshot)
                q.repl_overflowed = True
        self._maybe_compact()
        return self.wal_seq

    # -- snapshot compaction ------------------------------------------------

    def _maybe_compact(self) -> None:
        since = self.store.records_since_snapshot
        if since < self.compact_every or self._closed:
            return
        if since >= self.compact_every * 4:
            # hard bound: a caller that never yields to the loop (or no
            # loop at all) must still get its WAL rotated eventually
            self._snapshot_inline()
            return
        if self._compacting:
            return
        try:
            asyncio.get_running_loop()  # probe: background mode needs a loop
        except RuntimeError:
            self._snapshot_inline()
            return
        self._compacting = True
        # spawn: the loop's weak task ref is not enough — a GC'd compaction
        # task would leave _compacting latched True and the WAL unbounded
        spawn(self._compact_bg(), name="hub-compact")

    def _snapshot_inline(self) -> None:
        """Inline snapshot on the mutation path (no-loop / hard-bound
        fallback): a compaction failure must not fail the mutation that
        tripped it — count it and keep serving on the uncompacted WAL."""
        try:
            self.store.snapshot(self._state())
        except Exception as e:  # noqa: BLE001 - counted and logged, survivable
            COMPACTION_FAILURES.inc()
            log.error("hub snapshot compaction failed (inline): %s", e)

    async def _compact_bg(self) -> None:
        """Background compaction: capture state synchronously, serialize +
        fsync it in a worker thread while mutations keep landing in the
        old-generation WAL, then commit (rotate + re-append the records
        captured during the write). The mutation path never blocks on
        snapshot I/O. A failure (disk error at the snapshot fsync, fault
        injection at ``hub.fsync``) is counted in
        ``dynamo_hub_compaction_failures_total`` and serving continues on
        the uncompacted WAL; the next threshold crossing retries."""
        try:
            while (
                not self._closed
                and self.store.records_since_snapshot >= self.compact_every
            ):
                state = self._state()
                pending: list[dict[str, Any]] = []
                self._capture_log = pending
                try:
                    tmp, new_gen = await asyncio.to_thread(
                        self.store.write_snapshot_tmp, state
                    )
                    if self._closed or new_gen != self.store.gen + 1:
                        # closed, or the inline hard-bound snapshot
                        # rotated the gen while we serialized: our
                        # capture is stale (its pending records are
                        # already inside the newer snapshot) — discard
                        tmp.unlink(missing_ok=True)
                        if self._closed:
                            return
                        continue
                    self.store.commit_snapshot(tmp, new_gen, pending)
                except Exception as e:  # noqa: BLE001 - counted + logged:
                    # the WAL still holds every acked record, keep serving
                    COMPACTION_FAILURES.inc()
                    log.error(
                        "hub snapshot compaction failed (background): %s "
                        "— serving continues on the uncompacted WAL", e,
                    )
                    return
                finally:
                    self._capture_log = None
        finally:
            self._compacting = False

    def reap_expired(self, now: float | None = None) -> list[int]:
        # expiry IS logged (as a revoke): replication followers never run
        # the reaper — keepalives are not replicated, so only the leader
        # may decide a lease is dead — and they learn expiry from this
        # record. Recovery semantics are unchanged: a lease that expired
        # pre-crash is revoked by replay instead of re-expiring one TTL
        # after restart.
        expired = super().reap_expired(now)
        for lid in expired:
            self._log({"op": "revoke", "id": lid})
        return expired

    # Every mutator fences BEFORE touching state (the _log recheck is the
    # belt): raising after super() mutated would bounce the client while
    # local readers and watchers keep seeing a value that is in no WAL —
    # a crash-restart and a non-restart would then disagree.

    async def put(self, key: str, value: Any, lease_id: int | None = None) -> None:
        self._commit_allowed({"op": "put"})
        await super().put(key, value, lease_id)
        self._log({"op": "put", "k": key, "v": value, "l": lease_id})

    async def delete(self, key: str) -> bool:
        self._commit_allowed({"op": "del"})
        existed = await super().delete(key)
        if existed:
            self._log({"op": "del", "k": key})
        return existed

    async def grant_lease(self, ttl_s: float) -> int:
        self._commit_allowed({"op": "lease"})
        lid = await super().grant_lease(ttl_s)
        self._log({"op": "lease", "id": lid, "ttl": ttl_s})
        return lid

    async def revoke_lease(self, lease_id: int) -> None:
        self._commit_allowed({"op": "revoke"})
        existed = lease_id in self._leases
        await super().revoke_lease(lease_id)
        if existed:
            self._log({"op": "revoke", "id": lease_id})
        # lease EXPIRY is also logged as a revoke (see reap_expired): the
        # replication stream must carry it, since followers never reap

    async def publish(
        self, subject: str, payload: Any, pub_id: str | None = None
    ) -> bool:
        self._commit_allowed({"op": "pub"})
        applied = await super().publish(subject, payload, pub_id)
        if applied:
            # pid rides in the WAL so a retry that lands AFTER a hub
            # restart (which replayed the original record) still dedups
            rec = {"op": "pub", "s": subject, "p": payload}
            if pub_id is not None:
                rec["pid"] = pub_id
            self._log(rec)
        return applied

    async def purge_subject(
        self, subject: str, keep_last: int = 0,
        up_to_seq: int | None = None,
    ) -> int:
        self._commit_allowed({"op": "purge"})
        dropped = await super().purge_subject(
            subject, keep_last, up_to_seq=up_to_seq
        )
        if dropped:
            self._log({
                "op": "purge", "s": subject, "keep": keep_last,
                "upto": up_to_seq,
            })
        return dropped

    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        self._commit_allowed({"op": "obj"})
        await super().put_object(bucket, name, data)
        self._log({"op": "obj", "b": bucket, "n": name, "d": bytes(data)})

    async def delete_object(self, bucket: str, name: str) -> None:
        self._commit_allowed({"op": "objdel"})
        existed = (bucket, name) in self._objects
        await super().delete_object(bucket, name)
        if existed:
            self._log({"op": "objdel", "b": bucket, "n": name})

    async def close(self) -> None:
        await super().close()
        self.store.close()
