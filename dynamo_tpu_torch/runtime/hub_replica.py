"""Replicated hub: WAL-shipping followers + Raft-lite quorum election (the
counterpart of dynamo_tpu/runtime/hub_replica.py: the same ops, frame fields,
files and flags, so a JAX replica and a port replica join one cluster).

The hub is the control plane's last single point of failure: EPP picks,
KV-router publishes, worker leases, and planner watches all die with one
process, even though hub_store.py already makes that process durable.
The reference design leans on etcd's Raft consensus here; this module
gives the self-hosted hub the Raft-shaped slice of it (Ongaro &
Ousterhout: elected leader, term numbers, majority commit) over the
existing framed transport:

- ONE leader per term serves writes and streams its WAL records (plus a
  snapshot bootstrap at the current state) to followers over the
  existing framed transport (``repl.sync`` -> snapshot/append/hb frames,
  every frame stamped with the leader's term);
- followers replay records into their own ``DurableHub`` — persisting
  locally, firing watch/subscribe notifications for their own clients —
  answer reads while bouncing writes with ``not_leader``, and ACK their
  replication cursor back on the sync connection (``repl.ack``);
- a write is acked to the client only once a STRICT MAJORITY of the
  configured replica set holds it (leader self + floor(n/2) follower
  acks): the committed prefix is on a majority, so any electable leader
  has it — committed writes are linearizable and survive any minority
  failure;
- when a follower hears nothing for the leader lease it campaigns:
  first a PRE-VOTE round (Raft §9.6 — would a majority elect me? no
  term change, so a flapping node cannot inflate terms or depose a
  healthy leader), then a real ``repl.request_vote`` round carrying
  ``(term, wal_seq, boot_id)``. A replica votes AT MOST ONCE per term
  (durably, ``hub.term`` file — a crash cannot double-vote), only for a
  candidate whose WAL is at least as caught up, and refuses candidates
  outright while it hears a live leader (leader stickiness). A strict
  majority of granted votes promotes the candidate; its term becomes
  the FENCING EPOCH stamped on every replicated record and checked by
  followers and by the store's commit hook — a deposed leader's
  in-flight writes are rejected (``HubFenced`` / stale-epoch bounce),
  never replayed.

Ranking by data happens in the vote rule: a crashed leader restarting
with a wiped data dir solicits votes at WAL position 0 and is refused by
every caught-up replica, so it can never re-elect itself empty and
stream that emptiness over everyone else's copy.

Consistency contract: acked writes are on a majority and survive any
minority of failures, including a full partition — the minority side
cannot elect (no quorum of votes) and cannot commit (no quorum of acks;
clients get a retryable ``no_quorum``), so there is never dual-lead
within a term and never a fork in the committed prefix. A deposed
leader's unacked tail (logged locally, never committed) is discarded on
heal via snapshot bootstrap from the winner. Publishers keep their
at-least-once retries + ``pub_id`` dedup, so a write that died with a
``no_quorum`` can be retried against the new leader without
double-counting. With n=2 the majority is 2: either replica failing
halts writes (reads keep serving) — run 3+ replicas for availability.

Identity is cluster-wide: a follower's bootstrap snapshot carries the
leader's ``boot_id``, ``wal_seq``, and per-subject seq counters, so
client seq baselines stay valid across a failover. Promotion advances
every subject seq by ``PROMOTION_SEQ_GAP`` so events minted by the new
leader always outrank anything the dead leader's subscribers saw.

Partition testing rides runtime/faults.py: the ``transport.partition``
site (``transport.partition:drop=A|B`` symmetric, ``A>B`` one-way) cuts
replica links at dial time, kills established sync streams at the next
frame, and drops follower acks — seeded, live-flippable, address-pair
scoped (tests/test_torch_hub_replication.py drives the jepsen-style matrix).

Run: ``python -m dynamo_tpu_torch.runtime.hub_replica --port P --peers
h1:p1,h2:p2,h3:p3 --data-dir DIR`` on each replica; the ``--peers`` list
IS the membership — quorum is computed from it, not from who is alive —
and must spell this replica's ``--advertise`` address identically. Point
clients at the full list (``DYN_HUB_ADDRESSES``).
"""

from __future__ import annotations

import argparse
import asyncio
import fnmatch
import logging
import os
import random
import time
import uuid
from collections import OrderedDict, deque
from pathlib import Path
from typing import Any

from dynamo_tpu_torch.runtime import framing
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.hub import NoQuorum, WatchEvent, _Lease
from dynamo_tpu_torch.runtime.hub_server import HubServer
from dynamo_tpu_torch.runtime.hub_store import DurableHub, HubFenced
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

log = logging.getLogger("dynamo_tpu.hub")

__all__ = ["ReplicatedHub", "ReplicatedHubServer", "HubReplica", "addr_key", "main"]

# Election observability, appended to every /metrics surface: an alert on
# hub_elections_total churn catches a flapping control plane, and
# hub_term jumping without operator action means leadership is unstable.
_METRICS = MetricsRegistry()
ELECTIONS = _METRICS.counter(
    "hub_elections_total",
    "Hub replica election rounds by outcome.",
    ["outcome"],  # won | lost | pre_lost
)
TERM_GAUGE = _METRICS.gauge(
    "hub_term",
    "Current fencing epoch (election term) per hub replica.",
    ["replica"],
)
register_registry("hub_replica", _METRICS)


def addr_key(addr: str) -> tuple[str, int]:
    """Numeric-port sort key: '10.0.0.1:9000' < '10.0.0.1:10000' must
    hold numerically (lexical comparison would invert it)."""
    host, _, port = addr.rpartition(":")
    try:
        return (host, int(port))
    except ValueError:
        return (addr, 0)


class ReplicatedHub(DurableHub):
    """DurableHub with a replication role and durable election-term
    state: a follower replays the leader's records (never reaping leases
    or accepting direct writes); the commit hook fences writes minted by
    anything that is not the current leader."""

    # added to every per-subject seq on promotion: new-leader events must
    # outrank anything the dead leader minted past our replication cursor
    PROMOTION_SEQ_GAP = 1 << 20

    def __init__(
        self, data_dir: str | Path, *, compact_every: int = 8192,
        fsync: bool | None = None, role: str = "follower",
    ) -> None:
        # set BEFORE super().__init__: recovery replay (incl. the legacy
        # object import) logs records, and the fencing hook must see a
        # replay-permitted follower, not raise on our own recovery
        self.role = role
        self.voted_for: str | None = None
        self._replay_ok = True
        super().__init__(data_dir, compact_every=compact_every, fsync=fsync)
        self._replay_ok = False
        # the term file outranks the snapshot/WAL view of the epoch: a
        # vote granted after the last WAL record must survive restart
        term, voted = self.store.load_term()
        if term > self.repl_epoch:
            self.repl_epoch = term
            self.voted_for = voted
        elif term == self.repl_epoch:
            self.voted_for = voted

    # -- role gating ---------------------------------------------------------

    def _ensure_reaper(self) -> None:
        # keepalives are not replicated: only the leader may decide a
        # lease is dead (followers learn expiry from its revoke records)
        if self.role == "leader":
            super()._ensure_reaper()

    def reap_expired(self, now: float | None = None) -> list[int]:
        if self.role != "leader":
            return []
        return super().reap_expired(now)

    def _subject_seq_base(self) -> int:
        # a subject first seen in term E must mint seqs above every seq
        # any earlier term could have minted for it (same <2^20-events-
        # per-subject-per-term assumption the promotion gap makes):
        # subscribers that followed the dead leader keep valid baselines
        # even for subjects the promoted leader never learned
        return self.repl_epoch * self.PROMOTION_SEQ_GAP

    def _lease_snapshot_live(self, lease: Any, now: float) -> bool:
        # a follower's lease deadlines go stale by design (keepalives
        # are not replicated; expiry arrives as the leader's revoke
        # record), so its snapshots must keep every lease — dropping one
        # here would kill a live owner's keepalive after this follower
        # restarts and later promotes
        if self.role != "leader":
            return True
        return super()._lease_snapshot_live(lease, now)

    # -- fencing at commit time ----------------------------------------------

    def _commit_allowed(self, rec: dict[str, Any]) -> None:
        # hub_store commit hook: a record minted by this hub (not a
        # replicated replay) only commits while we hold the leadership —
        # a deposed leader's in-flight write dies HERE, not in the WAL
        if self.role != "leader" and not self._replay_ok:
            raise HubFenced(
                f"write {rec.get('op')!r} refused: replica role is "
                f"{self.role!r} at term {self.repl_epoch}"
            )

    def _log(self, rec: dict[str, Any]) -> int:
        # stamp the fencing epoch onto every leader-minted record; a
        # replicated replay keeps the minting leader's stamp
        if self.role == "leader" and "e" not in rec:
            rec = dict(rec, e=self.repl_epoch)
        seq = super()._log(rec)
        e = rec.get("e")
        if e is not None:
            self.last_rec_epoch = max(self.last_rec_epoch, int(e))
        return seq

    # -- term state (durable: hub.term) --------------------------------------

    def observe_term(self, term: int) -> bool:
        """Adopt a higher term seen on the wire (vote request, competing
        leader, replication stream): clears the vote, persists, demotes a
        leader — the cluster has moved past its regime. False if ``term``
        is not actually newer."""
        term = int(term)
        if term <= self.repl_epoch:
            return False
        self.repl_epoch = term
        self.voted_for = None
        if self.role == "leader":
            self.role = "follower"
        self.store.save_term(term, None)
        return True

    def record_vote(self, term: int, candidate: str) -> None:
        """Durably vote for ``candidate`` in ``term`` — persisted BEFORE
        the grant leaves this process, so a crash cannot double-vote."""
        term = int(term)
        if term < self.repl_epoch:
            raise ValueError(f"vote for past term {term} < {self.repl_epoch}")
        self.repl_epoch = term
        self.voted_for = candidate
        self.store.save_term(term, candidate)

    # -- promotion -----------------------------------------------------------

    def promote(self, epoch: int | None = None, addr: str | None = None) -> int:
        """Become the leader: adopt the winning term (or bump past the
        current one for the manual lever), reset lease deadlines to a
        full-TTL grace (recovery semantics — live owners keepalive, dead
        owners re-expire), gap the subject seqs, start reaping."""
        if self.role == "leader":
            return self.repl_epoch
        self.role = "leader"
        if epoch is not None and int(epoch) == self.repl_epoch and (
            addr is not None and self.voted_for == addr
        ):
            # the elected path: our durable self-vote already holds this
            # term — leading at it cannot collide with another leader
            pass
        else:
            # manual lever (repl.promote) or unowned term: ALWAYS move
            # strictly past the current term — seizing a term some
            # candidate may already hold a vote quorum for would mint two
            # leaders inside one fencing epoch
            self.repl_epoch = (
                self.repl_epoch + 1 if epoch is None
                else max(int(epoch), self.repl_epoch + 1)
            )
        # the leader's own durable vote for its term: without this, a
        # manually promoted leader (repl.promote bumps the term with
        # voted_for unset) could GRANT a real vote at its own term and
        # elect a second leader beside itself — dual-lead within a term
        if addr is not None:
            self.voted_for = addr
        self.store.save_term(self.repl_epoch, self.voted_for)
        self.wal_seq = max(self.wal_seq, self.repl_cursor)
        now = time.monotonic()
        for lease in self._leases.values():
            lease.deadline = now + lease.ttl
        gap = self.PROMOTION_SEQ_GAP
        for subj in list(self._subject_seq):
            self._subject_seq[subj] += gap
        self._log({
            "op": "promote", "epoch": self.repl_epoch, "gap": gap,
            "addr": addr,
        })
        self._ensure_reaper()
        return self.repl_epoch

    def demote(self) -> None:
        """Step down (a competing leader outranks us); the replica's role
        loop re-syncs to the winner."""
        self.role = "follower"

    # -- follower replay -----------------------------------------------------

    def reset_from_snapshot(
        self, state: dict[str, Any], seq: int, epoch: int
    ) -> None:
        """Adopt a full leader snapshot: replace ALL local state (incl.
        boot_id — identity is cluster-wide), persist it as our own
        snapshot, and surface the change to locally connected watchers as
        synthetic events (puts are idempotent upserts for every consumer;
        keys gone from the new state get deletes)."""
        old_keys = set(self._kv)
        self._kv = {}
        self._key_lease = {}
        self._leases = {}
        self._retained = {}
        self._subject_seq = {}
        self._seen_pub_ids = OrderedDict()
        self._objects = {}
        # the catch-up backlog indexes the OLD seq space; a stale window
        # here could satisfy a peer's repl.sync with wrong records
        self._recent.clear()
        # capture BEFORE _restore: it overwrites repl_epoch with the
        # snapshot's value, so comparing afterwards is always a no-op —
        # and a stale vote silently reinterpreted under the new term
        # would refuse legitimate candidates for a term we never voted in
        old_term = self.repl_epoch
        self._restore(state)
        self.repl_cursor = int(seq)
        self.repl_epoch = max(self.repl_epoch, int(epoch))
        if self.repl_epoch > old_term:
            # adopting a newer regime invalidates whatever vote we held
            self.voted_for = None
            self.store.save_term(self.repl_epoch, None)
        elif self.repl_epoch < old_term:
            # the durable term (possibly carrying our vote) never
            # regresses, even if a stale snapshot slips past the
            # stream-side epoch fence
            self.repl_epoch = old_term
        self.store.snapshot(self._state())
        for key in sorted(old_keys - set(self._kv)):
            self._notify(WatchEvent("delete", key))
        for key, value in sorted(self._kv.items()):
            self._notify(WatchEvent("put", key, value))

    async def apply_replicated(
        self, rec: dict[str, Any], seq: int, epoch: int | None = None
    ) -> None:
        """Replay ONE leader WAL record: mutate state exactly as the
        leader did, fire local watch/subscribe notifications, and log the
        record (tagged with the leader seq, ``rsq``) to our own WAL so
        the replication cursor survives a follower restart. ``epoch`` is
        the fencing check: a record from a deposed regime is refused."""
        seq = int(seq)
        if epoch is not None and int(epoch) < self.repl_epoch:
            raise HubFenced(
                f"replicated record seq {seq} carries stale epoch "
                f"{epoch} < {self.repl_epoch}"
            )
        if seq <= self.repl_cursor:
            return  # duplicate delivery (resync overlap)
        op = rec["op"]
        if op == "put":
            key, lid = rec["k"], rec.get("l")
            if lid is not None and lid in self._leases:
                self._leases[lid].keys.add(key)
                self._key_lease[key] = lid
            self._kv[key] = rec["v"]
            self._notify(WatchEvent("put", key, rec["v"]))
        elif op == "del":
            key = rec["k"]
            if self._kv.pop(key, None) is not None:
                lid = self._key_lease.pop(key, None)
                if lid is not None and lid in self._leases:
                    self._leases[lid].keys.discard(key)
                self._notify(WatchEvent("delete", key))
        elif op == "lease":
            lid, ttl = rec["id"], rec["ttl"]
            self._leases[lid] = _Lease(lid, ttl, time.monotonic() + ttl)
            self._next_lease = max(self._next_lease, lid + 1)
        elif op == "revoke":
            lease = self._leases.get(rec["id"])
            if lease is not None:
                self._drop_lease(lease)  # notifies the key deletes
        elif op == "pub":
            subj = rec["s"]
            if self._pub_id_fresh(rec.get("pid")):
                if subj not in self._retained:
                    self._retained[subj] = deque(
                        maxlen=self.RETAIN_PER_SUBJECT
                    )
                sseq = self._subject_seq.get(
                    subj, self._subject_seq_base()
                ) + 1
                self._subject_seq[subj] = sseq
                self._retained[subj].append((sseq, rec["p"]))
                for pattern, q in self._subs:
                    if fnmatch.fnmatchcase(subj, pattern):
                        q.put_nowait((subj, rec["p"], sseq))
        else:
            # purge / obj / objdel / promote: the recovery-replay body is
            # already notification-free and correct here
            self._apply(rec)
        self.repl_cursor = seq
        self._replay_ok = True
        try:
            self._log(dict(rec, rsq=seq))
        finally:
            self._replay_ok = False


class ReplicatedHubServer(HubServer):
    """HubServer + replication RPCs; bounces writes while follower and
    gates write acks on the majority-commit barrier while leader."""

    def __init__(
        self, replica: "HubReplica", host: str = "127.0.0.1", port: int = 0
    ):
        super().__init__(host, port, hub=replica.hub)
        self.replica = replica

    def _route(self, op: str) -> dict[str, Any] | None:
        if self.hub.role != "leader" and op in self.WRITE_OPS:
            return {"error": "not_leader", "leader": self.replica.leader_addr}
        return None

    def _leader_hint(self) -> str | None:
        return self.replica.leader_addr

    def _retry_after_hint(self) -> float | None:
        # quorum loss heals on the election/lease timescale: a partition
        # must first expire the old lease, then a pre-vote + vote round
        # completes within ~a heartbeat of it — so lease_s is the
        # earliest a retry can plausibly commit
        return max(self.replica.lease_s, 0.25)

    async def _commit_barrier(self, seq: int) -> None:
        # ack only once THIS op's records (up to its own post-log
        # position) are on a majority — never the live wal_seq, which
        # would couple the ack to neighbors' later writes
        await self.replica.wait_committed(seq)

    async def _dispatch_repl(
        self, op: str, mid: int, msg: dict[str, Any], send, streams
    ) -> bool:
        hub: ReplicatedHub = self.hub
        if op == "repl.status":
            await send({"id": mid, "ok": True, "result": {
                "role": hub.role, "leader": self.replica.leader_addr,
                "epoch": hub.repl_epoch, "wal_seq": hub.wal_seq,
                "cursor": hub.repl_cursor, "boot_id": hub.boot_id,
                "addr": self.replica.advertise,
                "nonce": self.replica.nonce,
                "commit": self.replica.commit_seq,
            }})
            return True
        if op == "repl.request_vote":
            result = self.replica.on_vote_request(
                term=int(msg["term"]),
                pos=int(msg.get("wal_seq", 0)),
                last_e=int(msg.get("last_e", 0)),
                boot=msg.get("boot"),
                candidate=msg.get("candidate", ""),
                pre=bool(msg.get("pre", False)),
            )
            await send({"id": mid, "ok": True, "result": result})
            return True
        if op == "repl.ack":
            # fire-and-forget: a follower's replication-cursor ack feeding
            # the leader's majority-commit barrier (no response frame —
            # it rides the repl.sync connection between stream frames)
            self.replica.note_ack(
                msg.get("follower", ""), int(msg.get("seq", 0)),
                int(msg.get("term", -1)),
            )
            return True
        if op == "repl.sync":
            if hub.role != "leader":
                await send({"id": mid, "ok": False, "error": "not_leader",
                            "leader": self.replica.leader_addr})
                return True
            # the follower self-identifies: the leader logs who is
            # tailing AND scopes partition checks + acks to that address
            follower = msg.get("follower", "<unknown>")
            log.info(
                "hub replica %s: follower %s syncing from cursor %s",
                self.replica.advertise, follower, msg.get("cursor", 0),
            )
            streams[mid] = asyncio.ensure_future(self._stream_repl(
                mid, int(msg.get("cursor", 0)), int(msg.get("epoch", -1)),
                int(msg.get("last_e", -1)), msg.get("boot"), follower, send,
            ))
            return True
        if op == "repl.append":
            # push-apply one record (admin/tooling path; the normal tail
            # rides the repl.sync stream)
            if hub.role == "leader":
                await send({"id": mid, "ok": False, "error": "is_leader"})
            elif int(msg.get("epoch", -1)) != hub.repl_epoch:
                await send({"id": mid, "ok": False,
                            "error": "epoch_mismatch",
                            "epoch": hub.repl_epoch})
            elif int(msg["seq"]) > hub.repl_cursor + 1:
                await send({"id": mid, "ok": False, "error": "gap",
                            "cursor": hub.repl_cursor})
            else:
                await hub.apply_replicated(msg["rec"], int(msg["seq"]))
                await send({"id": mid, "ok": True,
                            "result": hub.repl_cursor})
            return True
        if op == "repl.promote":
            # manual failover lever — runs a REAL vote round (skipping
            # only the pre-vote) rather than promoting unilaterally: a
            # unilateral term bump could seize the exact term an
            # in-flight candidate already holds a vote quorum for,
            # minting two leaders inside one fencing epoch. The optional
            # ``epoch`` is a floor for the campaign term.
            won = await self.replica.campaign(
                min_term=int(msg.get("epoch") or 0)
            )
            if won:
                await send({"id": mid, "ok": True, "result": hub.repl_epoch})
            else:
                await send({"id": mid, "ok": False, "error": "no_quorum",
                            "epoch": hub.repl_epoch})
            return True
        return False

    async def _stream_repl(
        self, mid: int, cursor: int, epoch: int, last_e: int,
        boot: str | None, follower: str, send,
    ) -> None:
        hub: ReplicatedHub = self.hub
        # bounded: a follower that stops draining (stalled TCP, wedged
        # process) marks the queue overflowed instead of growing leader
        # memory one record per mutation; the stream then ends and the
        # follower re-syncs from its durable cursor
        q: asyncio.Queue = asyncio.Queue(maxsize=hub.REPL_BACKLOG)
        q.repl_overflowed = False
        hub._repl_listeners.append(q)
        try:
            # listener registration, backlog slice, and snapshot capture
            # form one synchronous block — nothing can be logged between
            # them, so queue + what we send below cover the stream
            # exactly once with no gap and no duplicate
            recent = list(hub._recent)
            oldest = recent[0][0] if recent else hub.wal_seq + 1
            # LOG-MATCHING, not just current-term matching: the follower
            # may have adopted our term after replaying a dead leader's
            # uncommitted record at a seq we assigned to a DIFFERENT
            # record — its current epoch looks right while its log is
            # forked. Require the term stamp of OUR record at its cursor
            # to equal the term stamp of ITS last record (raft's
            # prevLogTerm check); any mismatch or out-of-window cursor
            # falls back to a snapshot bootstrap, which truncates the
            # follower's conflicting tail.
            rec_at_cursor = next(
                (r for s, r in recent if s == cursor), None
            )
            lineage_ok = (cursor == 0 and oldest == 1) or (
                rec_at_cursor is not None
                and int(rec_at_cursor.get("e", -1)) == last_e
            )
            caught_up = (
                boot == hub.boot_id
                and epoch == hub.repl_epoch
                and cursor <= hub.wal_seq
                and lineage_ok
            )
            if caught_up:
                for s, r in recent:
                    if s > cursor:
                        await send({"id": mid, "stream": {
                            "kind": "append", "rec": r, "seq": s,
                            "epoch": hub.repl_epoch}})
            else:
                await send({"id": mid, "stream": {
                    "kind": "snapshot", "state": hub._state(),
                    "seq": hub.wal_seq, "epoch": hub.repl_epoch}})
            while not q.repl_overflowed:
                if FAULTS.enabled and FAULTS.link_blocked(
                    "transport.partition", self.replica.advertise, follower
                ):
                    break  # live partition flip: the link to this follower died
                try:
                    s, r = await asyncio.wait_for(
                        q.get(), self.replica.hb_interval_s
                    )
                except asyncio.TimeoutError:
                    if hub.role != "leader":
                        break  # demoted: end stream, follower rediscovers
                    await send({"id": mid, "stream": {
                        "kind": "hb", "seq": hub.wal_seq,
                        "epoch": hub.repl_epoch}})
                    continue
                if hub.role != "leader":
                    break  # deposed with records queued: never stream a dead regime's tail
                await send({"id": mid, "stream": {
                    "kind": "append", "rec": r, "seq": s,
                    "epoch": hub.repl_epoch}})
        except asyncio.CancelledError:
            pass
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        finally:
            hub._repl_listeners.remove(q)


class HubReplica:
    """One replica: a ReplicatedHub + its server + the role loop
    (discover -> follow -> campaign -> lead) + the commit quorum."""

    def __init__(
        self, host: str, port: int, peers: list[str] | str,
        data_dir: str | Path, *, advertise: str | None = None,
        lease_s: float = 3.0, hb_interval_s: float | None = None,
        fsync: bool | None = None, compact_every: int = 8192,
        commit_timeout_s: float | None = None,
    ):
        if isinstance(peers, str):
            peers = peers.split(",")
        self.peers = [p.strip() for p in peers if p.strip()]
        self.host, self.port = host, port
        self.advertise = advertise or f"{host}:{port}"
        self.lease_s = lease_s
        self.hb_interval_s = hb_interval_s or max(lease_s / 6.0, 0.05)
        self.commit_timeout_s = commit_timeout_s or max(2.0, lease_s * 4)
        self.hub = ReplicatedHub(
            data_dir, compact_every=compact_every, fsync=fsync
        )
        self.server = ReplicatedHubServer(self, host, port)
        # per-PROCESS identity for probe self-recognition: boot_id is
        # cluster-wide (followers adopt the leader's) and the advertise
        # string can be spelled differently from the peers list
        # (localhost vs 127.0.0.1), so neither can tell "that status is
        # me" reliably — a replica probing itself as a phantom peer
        # would defer elections to it forever
        self.nonce = uuid.uuid4().hex
        self.leader_addr: str | None = None
        self.stats = {
            "snapshots": 0, "appends": 0, "promotions": 0, "elections": 0,
        }
        # commit quorum (leader side): highest acked cursor per follower,
        # and the resulting committed seq (on leader self + floor(n/2)
        # followers). The event is REPLACED on every ack, never cleared —
        # waiters grab it before re-checking, so no wakeup is ever lost.
        self.commit_seq = 0
        self._ack_seq: dict[str, int] = {}
        self._ack_event: asyncio.Event = asyncio.Event()
        self._warned_non_members: set[str] = set()
        self._member_cache: frozenset[str] = frozenset()
        self._members_for: str | None = None
        # election timer: last time we heard a CURRENT-term leader (frame
        # on the sync stream, discovery hit, or a vote we granted)
        self._last_leader_seen = 0.0
        self._task: asyncio.Task | None = None
        self._stopping = False

    # -- membership ----------------------------------------------------------

    @property
    def member_set(self) -> frozenset[str]:
        """The CONFIGURED membership (peers + self): quorum is computed
        from this set, never from who happens to be alive — that is the
        difference between surviving a partition and splitting on one.
        Cached per advertise spelling (finalized in start() for :0
        ports): the commit path consults it once per follower ack."""
        if self._members_for != self.advertise:
            self._member_cache = frozenset(self.peers) | {self.advertise}
            self._members_for = self.advertise
        return self._member_cache

    @property
    def replica_set(self) -> list[str]:
        return sorted(self.member_set, key=addr_key)

    @property
    def majority(self) -> int:
        return len(self.member_set) // 2 + 1

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        host, port = await self.server.start()
        self.host, self.port = host, port
        if self.advertise.endswith(":0"):
            self.advertise = f"{host}:{port}"
        self._note_term()
        self._task = asyncio.get_running_loop().create_task(
            self._role_loop()
        )
        return host, port

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            # cancel-with-retry: on 3.10 asyncio.wait_for can swallow a
            # lone cancellation when its inner future completes in the
            # same tick (probes to dead peers complete constantly during
            # teardown, so the race is live here). The stopping flag
            # bounds every loop await to ~lease_s regardless.
            while not self._task.done():
                self._task.cancel()
                try:
                    await asyncio.wait_for(
                        asyncio.shield(self._task), 1.0
                    )
                except asyncio.TimeoutError:
                    continue
                except asyncio.CancelledError:
                    pass
            self._task = None
        await self.server.stop()

    def on_promoted(self) -> None:
        """External promotion (repl.promote RPC) landed on our hub."""
        if self.hub.role == "leader":
            self.leader_addr = self.advertise
            self._ack_seq = {}
            self.stats["promotions"] += 1
            self._note_term()

    def _note_term(self) -> None:
        TERM_GAUGE.labels(self.advertise).set(self.hub.repl_epoch)

    # -- commit quorum (leader side) -----------------------------------------

    def note_ack(self, follower: str, seq: int, term: int) -> None:
        """A follower acked its replication cursor (``repl.ack``). Only
        current-term acks from MEMBERS of the configured replica set
        count: a partitioned-away follower still acking a dead regime, or
        a non-member (wrong --peers, advertise spelled differently from
        the membership list), must not advance the commit point — the
        majority contract is over the configured set, and a quorum padded
        with non-members could lose acked writes to a real election."""
        if not follower or self.hub.role != "leader":
            return
        if term != self.hub.repl_epoch:
            return
        if follower not in self.member_set or follower == self.advertise:
            if follower not in self._warned_non_members:
                # once per address: acks arrive at full replication rate
                self._warned_non_members.add(follower)
                log.warning(
                    "hub replica %s: ignoring repl.ack from non-member %s "
                    "(check --peers/--advertise spelling)",
                    self.advertise, follower,
                )
            return
        if seq <= self._ack_seq.get(follower, 0):
            return
        self._ack_seq[follower] = seq
        need = self.majority - 1
        if need > 0:
            acked = sorted(self._ack_seq.values(), reverse=True)
            if len(acked) >= need:
                # the need-th highest follower ack is on (need) followers
                # + the leader itself = a strict majority
                self.commit_seq = max(
                    self.commit_seq, min(self.hub.wal_seq, acked[need - 1])
                )
        ev, self._ack_event = self._ack_event, asyncio.Event()
        ev.set()

    async def wait_committed(self, seq: int) -> None:
        """Block until WAL position ``seq`` is on a strict majority of
        the replica set (leader + floor(n/2) follower acks). Raises
        NoQuorum on leadership loss, term change, or timeout — the write
        is then NOT committed and may be discarded on heal."""
        hub = self.hub
        term = hub.repl_epoch
        if self.majority <= 1:
            self.commit_seq = max(self.commit_seq, hub.wal_seq)
            return
        deadline = time.monotonic() + self.commit_timeout_s
        while True:
            if hub.role != "leader" or hub.repl_epoch != term:
                raise NoQuorum(
                    "leadership lost before the write reached a majority"
                )
            if self.commit_seq >= seq:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise NoQuorum(
                    f"no majority ack for wal seq {seq} within "
                    f"{self.commit_timeout_s:.1f}s"
                )
            ev = self._ack_event
            try:
                await asyncio.wait_for(
                    ev.wait(), min(remaining, self.hb_interval_s)
                )
            except asyncio.TimeoutError:
                pass  # re-check role/term at heartbeat granularity

    # -- role loop -----------------------------------------------------------

    async def _role_loop(self) -> None:
        try:
            while not self._stopping:
                if self.hub.role == "leader":
                    self.leader_addr = self.advertise
                    await self._lead()
                    continue
                leader = await self._discover()
                if leader is None:
                    await self._elect()
                else:
                    await self._follow(leader)
        except asyncio.CancelledError:
            pass

    def _cut(self, peer: str) -> bool:
        """Request/response to ``peer`` impossible under the active
        partition set (either direction blocked — a framed RPC needs
        both)."""
        if not FAULTS.enabled:
            return False
        return (
            FAULTS.link_blocked("transport.partition", self.advertise, peer)
            or FAULTS.link_blocked("transport.partition", peer, self.advertise)
        )

    def leader_recent(self) -> bool:
        """Heard a current-term leader within the lease (election-timer
        state, also refreshed by granting a vote — raft stickiness)."""
        return (time.monotonic() - self._last_leader_seen) < self.lease_s

    async def _peer_call(
        self, addr: str, op: str, timeout: float = 0.75,
        **fields: Any,
    ) -> dict[str, Any] | None:
        """One framed request/response RPC to a peer replica; None when
        the peer is unreachable, cut by a partition, or errors (a
        pre-replication hub answering unknown-op maps to None too)."""
        if self._cut(addr):
            return None
        try:
            host, _, port = addr.rpartition(":")
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host or "127.0.0.1", int(port)),
                timeout,
            )
        except (OSError, asyncio.TimeoutError, ValueError):
            return None
        try:
            await framing.write_frame(writer, {"id": 1, "op": op, **fields})
            msg = await asyncio.wait_for(framing.read_frame(reader), timeout)
            if msg and msg.get("ok"):
                return msg["result"]
        except (OSError, asyncio.TimeoutError, ValueError):
            pass
        finally:
            writer.close()
        return None

    async def _probe(
        self, addr: str, timeout: float = 0.75
    ) -> dict[str, Any] | None:
        """repl.status of one peer; None when unreachable."""
        result = await self._peer_call(addr, "repl.status", timeout)
        if result is None:
            return None
        # rank by the address WE dialed (advertise mismatches must not
        # fork the ordering)
        return dict(result, addr=addr)

    @staticmethod
    def _rank(status: dict[str, Any]) -> tuple:
        """Competing-leader sort key (ascending = better): highest term,
        then highest WAL position, then lowest address. Used only to heal
        a forced/manual split-brain — elections themselves are decided by
        votes, not ranking."""
        pos = max(int(status.get("wal_seq", 0)), int(status.get("cursor", 0)))
        return (-int(status.get("epoch", 0)), -pos, addr_key(status["addr"]))

    def _self_status(self) -> dict[str, Any]:
        return {
            "addr": self.advertise, "epoch": self.hub.repl_epoch,
            "wal_seq": self.hub.wal_seq, "cursor": self.hub.repl_cursor,
        }

    async def _discover(self) -> str | None:
        """Find the current leader among peers; None = nobody (reachable)
        claims a leadership we could follow."""
        others = [p for p in self.peers if p != self.advertise]
        statuses = [
            s for s in await asyncio.gather(
                *(self._probe(p) for p in others)
            )
            # nonce, not addr: a peers-list spelling of our own address
            # (localhost vs 127.0.0.1) must not register us as a
            # phantom peer we then defer elections to
            if s and s.get("nonce") != self.nonce
        ]
        leaders = [
            s for s in statuses
            if s.get("role") == "leader"
            # never follow a leader of a term we have moved past: its
            # stream is fenced anyway, and treating it as live would
            # suppress the election that heals the cluster
            and int(s.get("epoch", 0)) >= self.hub.repl_epoch
        ]
        if not leaders:
            return None
        best = min(leaders, key=self._rank)
        self._last_leader_seen = time.monotonic()
        return best["addr"]

    # -- election (pre-vote + quorum vote) -----------------------------------

    async def _request_vote(
        self, addr: str, term: int, pos: int, pre: bool,
        timeout: float = 0.75,
    ) -> dict[str, Any] | None:
        """One ``repl.request_vote`` RPC; None when unreachable or cut."""
        return await self._peer_call(
            addr, "repl.request_vote", timeout,
            term=term, wal_seq=pos, last_e=self.hub.last_rec_epoch,
            boot=self.hub.boot_id, candidate=self.advertise, pre=pre,
        )

    def on_vote_request(
        self, *, term: int, pos: int, last_e: int = 0,
        boot: str | None, candidate: str, pre: bool,
    ) -> dict[str, Any]:
        """Voter side. Pre-vote: would we grant, with NO state change —
        a flapping candidate cannot inflate terms through us. Real vote:
        at most one durable grant per term, only for a candidate whose
        log is at least as up to date as ours, refused while we hear a
        live leader. 'Up to date' is the raft election restriction —
        (last record term, position), in that order: a deposed minority
        leader can pad its WAL arbitrarily long with no-quorum writes,
        but they are stamped with its dead term, so a shorter log holding
        a newer term's committed records still outranks it."""
        hub = self.hub
        mypos = max(hub.wal_seq, hub.repl_cursor)
        caught_up = (last_e, pos) >= (hub.last_rec_epoch, mypos)
        if pre:
            granted = (
                term > hub.repl_epoch
                and caught_up
                and hub.role != "leader"
                and not self.leader_recent()
            )
            return {"granted": granted, "term": hub.repl_epoch, "pre": True}
        if term < hub.repl_epoch:
            return {"granted": False, "term": hub.repl_epoch}
        if term > hub.repl_epoch:
            was_leader = hub.role == "leader"
            hub.observe_term(term)
            if was_leader:
                # a real vote round only starts after a pre-vote majority
                # saw us dead: we lost quorum, step aside
                self.leader_addr = None
            self._note_term()
        if hub.role == "leader":
            # we ARE the leader of this term (term == repl_epoch here):
            # never endorse a second leader beside ourselves
            return {"granted": False, "term": hub.repl_epoch}
        granted = hub.voted_for in (None, candidate) and caught_up
        if granted:
            hub.record_vote(term, candidate)
            # granting resets our election timer: don't immediately
            # campaign against the candidate we just endorsed
            self._last_leader_seen = time.monotonic()
        log.info(
            "hub replica %s: vote request from %s (term %d, pos %d, "
            "boot %s) -> %s", self.advertise, candidate, term, pos,
            boot, "granted" if granted else "refused",
        )
        return {"granted": granted, "term": hub.repl_epoch}

    async def _elect(self) -> None:
        """Leader lease expired and nobody reachable claims a current
        leadership: campaign. Pre-vote round first (no term change), then
        a durable self-vote + real round; a strict majority of the
        CONFIGURED replica set promotes us at the new term."""
        hub = self.hub
        self.stats["elections"] += 1
        others = [p for p in self.replica_set if p != self.advertise]
        pos = max(hub.wal_seq, hub.repl_cursor)
        term = hub.repl_epoch + 1
        if others:
            pre = [r for r in await asyncio.gather(
                *(self._request_vote(p, term, pos, True) for p in others)
            ) if r]
            for r in pre:
                if int(r.get("term", 0)) > hub.repl_epoch:
                    hub.observe_term(int(r["term"]))
                    self._note_term()
            if 1 + sum(1 for r in pre if r.get("granted")) < self.majority:
                ELECTIONS.labels("pre_lost").inc()
                await self._election_backoff()
                return
        if self.leader_recent():
            # a leader emerged — or we endorsed another candidate, which
            # refreshes the election timer — while our pre-vote round was
            # in flight: standing down here keeps a slow campaigner from
            # deposing the freshly elected leader one term later
            ELECTIONS.labels("pre_lost").inc()
            await self._election_backoff()
            return
        if await self.campaign():
            ELECTIONS.labels("won").inc()
        else:
            ELECTIONS.labels("lost").inc()
            await self._election_backoff()

    async def campaign(self, min_term: int = 0) -> bool:
        """One real vote round: durable self-vote at the next term (at
        least ``min_term``), then ``repl.request_vote`` to every member;
        a strict majority promotes us. Shared by elections (after a
        pre-vote majority) and by the manual ``repl.promote`` lever —
        because every path acquires the term through at-most-once-per-
        term votes, even a manual promotion racing an in-flight candidate
        cannot mint two leaders inside one fencing epoch."""
        hub = self.hub
        if hub.role == "leader":
            # already leading — bumping our own term here would strand us
            # leading at a term we hold only a self-vote for, colliding
            # with whoever wins the real election at that term
            return True
        others = [p for p in self.replica_set if p != self.advertise]
        pos = max(hub.wal_seq, hub.repl_cursor)
        term = max(hub.repl_epoch + 1, int(min_term))
        hub.record_vote(term, self.advertise)
        self._note_term()
        votes = [r for r in await asyncio.gather(
            *(self._request_vote(p, term, pos, False) for p in others)
        ) if r]
        maxterm = max([term] + [int(r.get("term", 0)) for r in votes])
        if maxterm > term:
            hub.observe_term(maxterm)
            self._note_term()
            return False
        if hub.repl_epoch != term or hub.voted_for != self.advertise:
            # a concurrent higher-term campaign moved us while the round
            # was in flight: our majority (if any) is for a dead term
            return False
        granted = 1 + sum(1 for r in votes if r.get("granted"))
        if granted < self.majority:
            return False
        epoch = hub.promote(term, addr=self.advertise)
        self.on_promoted()  # one home for the promotion bookkeeping
        log.warning(
            "hub replica %s elected leader for term %d (%d/%d votes)",
            self.advertise, epoch, granted, len(self.member_set),
        )
        return True

    async def _election_backoff(self) -> None:
        """Randomized backoff between failed rounds: breaks the symmetric
        split-vote livelock (everyone self-voting forever)."""
        self.leader_addr = None
        await asyncio.sleep(self.hb_interval_s * (0.5 + random.random() * 1.5))

    # -- leading / following -------------------------------------------------

    async def _lead(self) -> None:
        """Leader steady state: repl.sync streams are served by the
        server; here we only heal forced/manual split-brain (a competing
        leader that outranks us per _rank — higher term, more data,
        lower address — wins; step down and re-sync to it). An elected
        competitor always carries a higher term, so this also retires a
        deposed leader that missed its own deposition."""
        while self.hub.role == "leader" and not self._stopping:
            others = [p for p in self.peers if p != self.advertise]
            statuses = await asyncio.gather(
                *(self._probe(p) for p in others)
            )
            me = self._rank(self._self_status())
            for st in statuses:
                if st and st.get("nonce") == self.nonce:
                    continue  # our own status dialed via an alias
                if st and st.get("role") == "leader":
                    them = self._rank(st)
                    if them < me:
                        log.warning(
                            "hub replica %s stepping down: %s leads at "
                            "epoch %d", self.advertise, st["addr"],
                            st.get("epoch", 0),
                        )
                        self.hub.observe_term(int(st.get("epoch", 0)))
                        self.hub.demote()
                        self._note_term()
                        self.leader_addr = st["addr"]
                        return
            await asyncio.sleep(self.lease_s)

    async def _send_ack(self, writer, leader: str) -> None:
        """Report our replication cursor to the leader (feeds its commit
        quorum). Rides the sync connection; a one-way partition that cuts
        our uplink silently eats the ack — exactly a real cut link."""
        if FAULTS.enabled and FAULTS.link_blocked(
            "transport.partition", self.advertise, leader
        ):
            return
        await framing.write_frame(writer, {
            "id": 0, "op": "repl.ack", "seq": self.hub.repl_cursor,
            "follower": self.advertise, "term": self.hub.repl_epoch,
        })

    async def _follow(self, leader: str) -> None:
        """Tail the leader's WAL until it dies (lease expiry), demotes,
        is fenced by a newer term, or we get promoted. Returning hands
        control back to the role loop (re-discover / campaign)."""
        hub = self.hub
        self.leader_addr = leader
        if self._cut(leader):
            self.leader_addr = None
            await asyncio.sleep(self.hb_interval_s)
            return
        try:
            host, _, port = leader.rpartition(":")
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host or "127.0.0.1", int(port)),
                2.0,
            )
        except (OSError, asyncio.TimeoutError, ValueError):
            self.leader_addr = None
            await asyncio.sleep(self.hb_interval_s)
            return
        # a deposed split-brain loser holds records past its replication
        # cursor (it led and logged its own writes); an append tail would
        # silently merge that divergence into the winner's history, so
        # request a full snapshot bootstrap instead
        diverged = hub.wal_seq > hub.repl_cursor
        try:
            await framing.write_frame(writer, {
                "id": 1, "op": "repl.sync",
                "cursor": 0 if diverged else hub.repl_cursor,
                "epoch": -1 if diverged else hub.repl_epoch,
                "last_e": -1 if diverged else hub.last_rec_epoch,
                "boot": hub.boot_id, "follower": self.advertise,
            })
            while hub.role != "leader" and not self._stopping:
                try:
                    msg = await asyncio.wait_for(
                        framing.read_frame(reader), self.lease_s
                    )
                except asyncio.TimeoutError:
                    log.warning(
                        "hub replica %s: leader %s silent for %.1fs "
                        "(lease expired)", self.advertise, leader,
                        self.lease_s,
                    )
                    return
                if hub.role == "leader":
                    # promoted while the read was pending: the frame is
                    # from the OLD leader's stream — applying it now
                    # would merge its post-promotion writes into ours
                    return
                if msg is None:
                    return  # connection closed
                if not msg.get("ok", True):
                    if msg.get("error") == "not_leader":
                        self.leader_addr = msg.get("leader")
                    return
                item = msg.get("stream")
                if not item:
                    continue
                if FAULTS.enabled and FAULTS.link_blocked(
                    "transport.partition", leader, self.advertise
                ):
                    return  # live partition flip: the downlink died under us
                kind = item.get("kind")
                ep = int(item.get("epoch", -1))
                if ep >= 0:
                    if ep < hub.repl_epoch:
                        # fencing: a deposed leader's stream — its frames
                        # must never land after we adopted a newer term
                        log.warning(
                            "hub replica %s: dropping stale-epoch stream "
                            "from %s (epoch %d < term %d)",
                            self.advertise, leader, ep, hub.repl_epoch,
                        )
                        return
                    if ep > hub.repl_epoch:
                        hub.observe_term(ep)
                        self._note_term()
                # only a current-term leader refreshes the election timer
                self._last_leader_seen = time.monotonic()
                if kind == "snapshot":
                    hub.reset_from_snapshot(
                        item["state"], item["seq"], item["epoch"]
                    )
                    self.stats["snapshots"] += 1
                    # adopting a snapshot means locally connected
                    # subscribers missed whatever the snapshot delta
                    # contained; kick them so they re-converge through
                    # the client reconnect path (watch diff re-sync,
                    # replay-subscribe with per-subject seq dedup)
                    self.server.kick_clients()
                    await self._send_ack(writer, leader)
                elif kind == "append":
                    seq = int(item["seq"])
                    if seq > hub.repl_cursor + 1:
                        log.warning(
                            "hub replica %s: replication gap (cursor %d,"
                            " got %d); resyncing", self.advertise,
                            hub.repl_cursor, seq,
                        )
                        return
                    await hub.apply_replicated(
                        item["rec"], seq, epoch=ep if ep >= 0 else None
                    )
                    self.stats["appends"] += 1
                    await self._send_ack(writer, leader)
                # hb: the read itself refreshed the leader lease
        except HubFenced:
            return  # stale-epoch record refused: rediscover the real leader
        except (ConnectionError, OSError):
            return
        finally:
            writer.close()


async def _amain(args: argparse.Namespace) -> None:
    replica = HubReplica(
        args.host, args.port, args.peers, args.data_dir,
        advertise=args.advertise, lease_s=args.lease_s,
        fsync=True if args.fsync else None,
        commit_timeout_s=args.commit_timeout_s,
    )
    host, port = await replica.start()
    print(f"DYNAMO_HUB={host}:{port}", flush=True)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    try:
        import signal

        loop.add_signal_handler(signal.SIGTERM, stop.set)
    except (NotImplementedError, RuntimeError):  # pragma: no cover
        pass  # non-unix event loop
    serving = asyncio.ensure_future(replica.server.serve_forever())
    try:
        await stop.wait()
    finally:
        serving.cancel()
        await replica.stop()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="dynamo-tpu replicated hub (one replica process)"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6650)
    parser.add_argument("--peers",
                        default=os.environ.get("DYN_HUB_PEERS", ""),
                        help="comma-separated replica addresses: the "
                             "MEMBERSHIP. Quorum size is len(peers), and "
                             "this replica's advertise address must "
                             "appear in it spelled identically (env "
                             "DYN_HUB_PEERS)")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--advertise", default=None,
                        help="address peers/clients reach us at "
                             "(default host:port)")
    parser.add_argument("--lease-s", type=float, default=3.0,
                        help="leader lease: silence past this starts an "
                             "election")
    parser.add_argument("--commit-timeout-s", type=float, default=None,
                        help="max wait for a write to reach a majority "
                             "before bouncing it as no_quorum (default "
                             "max(2s, 4x lease))")
    parser.add_argument("--fsync", action="store_true",
                        help="fsync every WAL append")
    args = parser.parse_args(argv)
    if not args.peers:
        parser.error("--peers (or DYN_HUB_PEERS) is required")
    from dynamo_tpu_torch.runtime.logging_util import setup_logging

    setup_logging()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
