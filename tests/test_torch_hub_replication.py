"""The port's replicated hub (dynamo_tpu_torch/runtime/hub_replica.py): the
tests of tests/test_hub_replication.py run on the port, then clusters that
mix port and JAX replicas, and port replica processes.

- a leader streams term-stamped WAL records to followers that replay
  them into identical DurableHub state (snapshot bootstrap and mid-WAL
  catch-up) and ack their cursor back into the commit quorum;
- followers answer reads and bounce writes with ``not_leader``; clients
  given the full replica list fail over, with bounded redirect chasing;
- elections are quorum-backed (pre-vote, durable once-per-term votes, the
  log-position vote rule): under symmetric, one-way and
  partition-during-election faults the WAL invariant checker
  (sim/cluster.py ``check_cluster_invariants``) finds no dual-lead in a
  term, no committed-seq gap and no committed fork;
- mixed clusters (two port replicas and one JAX replica, and the
  reverse) elect one leader per term, replicate, fail over when the leader
  stops, and both packages' invariant checkers agree on their data dirs;
- a port replica process SIGKILLed and restarted on its data dir rejoins,
  and the clients reconverge.

The real-process chaos test and the full partition matrix are marked
``slow`` as the reference's are.
"""

import asyncio
import itertools
import shutil
import signal
import time

import pytest

from dynamo_tpu_torch.sim.cluster import (
    check_cluster_invariants,
    find_leader,
    free_port,
    isolate_spec,
    partition_spec,
    repl_status,
    spawn_replica,
)

from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_replica import HubReplica, addr_key

pytestmark = [pytest.mark.integration]

# fast cluster timing: leader lease 0.5 s => failover ~1-2 s (one lease
# of silence + a pre-vote/vote round), smoke stays comfortably under the
# tier-1 per-test budget
LEASE_S = 0.5


async def _start_cluster(
    tmp_path, n: int = 3, lease_s: float = LEASE_S,
    commit_timeout_s: float = 2.0,
) -> tuple[list[HubReplica], list[str]]:
    ports = sorted(free_port() for _ in range(n))
    addrs = [f"127.0.0.1:{p}" for p in ports]
    peers = ",".join(addrs)
    reps = [
        HubReplica(
            "127.0.0.1", p, peers, tmp_path / f"replica{i}",
            lease_s=lease_s, commit_timeout_s=commit_timeout_s,
        )
        for i, p in enumerate(ports)
    ]
    for r in reps:
        await r.start()
    return reps, addrs


async def _stop_all(reps) -> None:
    for r in reps:
        await r.stop()


async def _wait_single_leader(reps, timeout: float = 10.0) -> HubReplica:
    """Wait until exactly one live replica leads and the rest follow it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [r for r in reps if r.hub.role == "leader"]
        if len(leaders) == 1 and all(
            r.leader_addr == leaders[0].advertise for r in reps
        ):
            return leaders[0]
        await asyncio.sleep(0.02)
    raise AssertionError(
        f"no single leader: {[(r.advertise, r.hub.role) for r in reps]}"
    )


async def _wait_caught_up(leader, followers, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(f.hub.repl_cursor >= leader.hub.wal_seq for f in followers):
            return
        await asyncio.sleep(0.02)
    raise AssertionError(
        f"followers lag: leader@{leader.hub.wal_seq}, "
        f"{[(f.advertise, f.hub.repl_cursor) for f in followers]}"
    )


async def _wait(pred, timeout: float = 10.0, msg: str = "") -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(msg or "condition not reached")


# -- in-process cluster (tier-1) --------------------------------------------


async def test_election_smoke(tmp_path):
    """The fast tier-1 election smoke: a cold 3-replica cluster elects
    exactly one quorum-backed leader, a majority-committed write
    round-trips, and every replica agrees on the term."""
    reps, addrs = await _start_cluster(tmp_path, lease_s=0.3)
    client = None
    try:
        leader = await _wait_single_leader(reps)
        assert leader.hub.repl_epoch >= 1
        client = await RemoteHub.connect(
            ",".join(addrs), reconnect_window_s=15.0
        )
        await client.put("smoke", 1)
        assert await client.get("smoke") == 1
        followers = [r for r in reps if r is not leader]
        await _wait_caught_up(leader, followers)
        assert {r.hub.repl_epoch for r in reps} == {leader.hub.repl_epoch}
    finally:
        if client is not None:
            await client.close()
        await _stop_all(reps)


async def test_replication_smoke(tmp_path):
    """Elect, replicate, bounce follower writes, fail over after a clean
    leader stop, round-trip on the new leader."""
    reps, addrs = await _start_cluster(tmp_path)
    client = None
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]

        client = await RemoteHub.connect(
            ",".join(addrs), reconnect_window_s=15.0
        )
        await client.put("mdc/llama", {"card": 1})
        lease = await client.grant_lease(30.0)
        await client.put("inst/w0", {"port": 9}, lease_id=lease)
        assert await client.publish("kv.ev", {"n": 1}) is True
        await client.put_object("snap", "radix", b"tree")
        await _wait_caught_up(leader, followers)

        # identity is cluster-wide: every replica reports the SAME boot
        # id, so client seq baselines stay valid across failover
        boots = {r.hub.boot_id for r in reps}
        assert boots == {leader.hub.boot_id}

        # followers answer reads; writes bounce with not_leader naming
        # the leader
        faddr = followers[0].advertise
        fclient = await RemoteHub.connect(faddr, reconnect=False)
        assert await fclient.get("mdc/llama") == {"card": 1}
        assert await fclient.get_object("snap", "radix") == b"tree"
        with pytest.raises(ConnectionError, match=leader.advertise):
            await fclient.put("nope", 1)
        await fclient.close()

        # replicated state is identical on every follower
        for f in followers:
            assert f.hub._kv["mdc/llama"] == {"card": 1}
            assert f.hub._subject_seq["kv.ev"] == leader.hub._subject_seq[
                "kv.ev"
            ]
            assert lease in f.hub._leases

        # clean leader stop: the survivors elect a quorum-backed leader
        # at a HIGHER term and the SAME client reconverges via
        # multi-address failover
        old_term = leader.hub.repl_epoch
        await leader.stop()
        survivors = followers
        new_leader = await _wait_single_leader(survivors)
        assert new_leader.hub.repl_epoch > old_term
        await client.put("mdc/qwen", {"card": 2})
        assert await client.get("mdc/qwen") == {"card": 2}
        assert await client.get("mdc/llama") == {"card": 1}
        assert await client.keepalive(lease) is True
        assert await client.get_boot_id() == new_leader.hub.boot_id
    finally:
        if client is not None:
            await client.close()
        await _stop_all(reps)


async def test_follower_catchup_from_mid_wal(tmp_path):
    """A follower that restarts mid-stream resumes from its persisted
    replication cursor over the in-memory backlog — append replay, NOT a
    fresh snapshot bootstrap."""
    reps, addrs = await _start_cluster(tmp_path, n=2)
    try:
        leader = await _wait_single_leader(reps)
        follower = next(r for r in reps if r is not leader)
        for i in range(20):
            await leader.hub.put(f"k/{i}", i)
        await _wait_caught_up(leader, [follower])
        cursor = follower.hub.repl_cursor
        assert cursor >= 20

        # follower goes away; the leader keeps committing (well within
        # the REPL_BACKLOG window)
        fdir = follower.hub.store.dir
        await follower.stop()
        for i in range(20, 35):
            await leader.hub.put(f"k/{i}", i)

        # restart on the SAME data dir: the persisted rsq tags must have
        # restored the cursor, so resync takes the mid-WAL append path
        follower2 = HubReplica(
            "127.0.0.1", int(follower.advertise.rsplit(":", 1)[1]),
            ",".join(addrs), fdir, lease_s=LEASE_S,
        )
        assert follower2.hub.repl_cursor >= cursor  # survived restart
        await follower2.start()
        try:
            await _wait_caught_up(leader, [follower2])
            assert follower2.stats["snapshots"] == 0  # no bootstrap
            assert follower2.stats["appends"] >= 15
            for i in range(35):
                assert follower2.hub._kv[f"k/{i}"] == i
        finally:
            await follower2.stop()
    finally:
        await _stop_all([r for r in reps if r.hub.role == "leader"])


async def test_torn_tail_at_replication_boundary(tmp_path):
    """A follower SIGKILL'd mid-append leaves a torn record at its WAL
    tail. On restart the tail is discarded, the cursor falls back to the
    last intact record, and resync replays exactly the missing suffix —
    no gap, no double-apply."""
    reps, addrs = await _start_cluster(tmp_path, n=2)
    try:
        leader = await _wait_single_leader(reps)
        follower = next(r for r in reps if r is not leader)
        for i in range(10):
            await leader.hub.publish("ev", {"i": i})
        await _wait_caught_up(leader, [follower])
        fdir = follower.hub.store.dir
        fgen = follower.hub.store.gen
        await follower.stop()

        # crash mid-append of a replicated record: garbage half-frame
        with open(fdir / f"hub.wal.{fgen}", "ab") as f:
            f.write(b"\x00\x00\x20\x00torn-replicated-record")
        # leader moves on meanwhile
        for i in range(10, 16):
            await leader.hub.publish("ev", {"i": i})

        follower2 = HubReplica(
            "127.0.0.1", int(follower.advertise.rsplit(":", 1)[1]),
            ",".join(addrs), fdir, lease_s=LEASE_S,
        )
        await follower2.start()
        try:
            await _wait_caught_up(leader, [follower2])
            # state equality: every event applied exactly once, seq
            # space continuous across the torn boundary
            assert follower2.hub._subject_seq["ev"] == leader.hub._subject_seq[
                "ev"
            ]
            assert list(follower2.hub._retained["ev"]) == list(
                leader.hub._retained["ev"]
            )
        finally:
            await follower2.stop()
    finally:
        await _stop_all([r for r in reps if r.hub.role == "leader"])


async def test_election_race_two_followers(tmp_path):
    """Both followers time out on the dead leader simultaneously: the
    quorum vote (at most one durable vote per term) yields exactly ONE
    leader; a forced manual promotion (admin repl.promote) heals the same
    way — the lower term steps down within a lease period."""
    reps, addrs = await _start_cluster(tmp_path)
    try:
        leader = await _wait_single_leader(reps)
        followers = sorted(
            (r for r in reps if r is not leader),
            key=lambda r: addr_key(r.advertise),
        )
        await leader.hub.put("k", 1)
        await _wait_caught_up(leader, followers)

        # kill the leader abruptly: both followers' leases expire in the
        # same window and both enter the election path
        old_term = leader.hub.repl_epoch
        await leader.stop()
        new_leader = await _wait_single_leader(followers)
        assert new_leader.hub.repl_epoch > old_term

        # forced split-brain: promote the OTHER follower too (admin
        # repl.promote landing mid-race bumps past the current term) —
        # two leaders exist briefly, in DIFFERENT terms, and the lower
        # term must step down and resync to the higher one
        other = next(f for f in followers if f is not new_leader)
        other.hub.promote(addr=other.advertise)
        other.on_promoted()
        assert other.hub.role == "leader"  # momentarily two
        settled = await _wait_single_leader(followers)
        assert settled is other  # higher term wins
        # post-heal: a write through the survivors round-trips
        client = await RemoteHub.connect(
            ",".join(f.advertise for f in followers),
            reconnect_window_s=15.0,
        )
        await client.put("after-race", 42)
        assert await client.get("after-race") == 42
        await client.close()
    finally:
        await _stop_all(reps)


async def test_manual_promote_rpc_campaigns_for_quorum(tmp_path):
    """The operator failover lever (repl.promote) runs a real vote round
    instead of unilaterally seizing a term: with a quorum reachable the
    target wins at a strictly higher term and the old leader retires;
    with the target partitioned off it fails with no_quorum and the
    cluster keeps its leader."""
    from dynamo_tpu_torch.runtime import framing

    async def rpc_promote(addr):
        host, port = addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            await framing.write_frame(
                writer, {"id": 1, "op": "repl.promote"}
            )
            return await asyncio.wait_for(framing.read_frame(reader), 5)
        finally:
            writer.close()

    reps, addrs = await _start_cluster(tmp_path)
    try:
        leader = await _wait_single_leader(reps)
        target = next(r for r in reps if r is not leader)
        old_term = leader.hub.repl_epoch

        # partitioned target: the campaign can't reach a quorum
        FAULTS.configure(isolate_spec(target.advertise, addrs), seed=5)
        try:
            msg = await rpc_promote(target.advertise)
            assert msg["ok"] is False and msg["error"] == "no_quorum"
            assert target.hub.role != "leader"
        finally:
            FAULTS.clear()

        # healed: the lever wins a real vote round at a higher term
        msg = await rpc_promote(target.advertise)
        assert msg["ok"] is True and msg["result"] > old_term
        settled = await _wait_single_leader(reps)
        assert settled is target
    finally:
        FAULTS.clear()
        await _stop_all(reps)


async def test_watch_resubscription_after_failover(tmp_path):
    """A prefix watch opened through the multi-address client survives a
    leader failover: the re-sync snapshot diff surfaces keys deleted
    while disconnected, and new puts on the elected leader stream
    through."""
    reps, addrs = await _start_cluster(tmp_path)
    client = None
    wt = None
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        client = await RemoteHub.connect(
            ",".join(addrs), reconnect_window_s=15.0
        )
        await client.put("reg/a", 1)
        await client.put("reg/b", 2)
        await _wait_caught_up(leader, followers)

        events: list = []

        async def watcher():
            async for ev in client.watch_prefix("reg/"):
                events.append((ev.kind, ev.key))

        wt = asyncio.create_task(watcher())
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(events) < 2:
            await asyncio.sleep(0.02)
        assert ("put", "reg/a") in events and ("put", "reg/b") in events

        await leader.stop()
        new_leader = await _wait_single_leader(followers)
        # mutations land on the NEW leader while our client may still be
        # re-dialing: a delete it must learn via the re-sync diff and a
        # put it must receive live after resubscription
        await new_leader.hub.delete("reg/b")
        await client.put("reg/c", 3)  # also proves write failover

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if ("delete", "reg/b") in events and ("put", "reg/c") in events:
                break
            await asyncio.sleep(0.05)
        assert ("delete", "reg/b") in events
        assert ("put", "reg/c") in events
    finally:
        if wt is not None:
            wt.cancel()
        if client is not None:
            await client.close()
        await _stop_all(reps)


async def test_subscribe_seq_dedup_across_failover(tmp_path):
    """A replay subscription crossing a failover delivers every event
    exactly once: the elected follower preserved the per-subject seq
    space (cluster-wide boot_id), so the client's seq baseline dedups
    the replayed prefix; the promotion seq gap keeps new-leader events
    strictly ahead."""
    reps, addrs = await _start_cluster(tmp_path)
    client = None
    st = None
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        client = await RemoteHub.connect(
            ",".join(addrs), reconnect_window_s=15.0
        )
        for i in range(3):
            await client.publish("kv.ev", {"n": i})
        await _wait_caught_up(leader, followers)

        seen: list = []

        async def subscriber():
            async for _s, payload, seq in client.subscribe(
                "kv.ev", replay=True, with_seq=True
            ):
                seen.append((seq, payload["n"]))

        st = asyncio.create_task(subscriber())
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(seen) < 3:
            await asyncio.sleep(0.02)
        assert [n for _s, n in seen] == [0, 1, 2]

        await leader.stop()
        await _wait_single_leader(followers)
        assert await client.publish("kv.ev", {"n": 3}) is True

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(n == 3 for _s, n in seen):
                break
            await asyncio.sleep(0.05)
        payloads = [n for _s, n in seen]
        assert payloads.count(0) == 1 and payloads.count(1) == 1
        assert payloads.count(2) == 1 and payloads.count(3) == 1
        # promotion gap: the new event's seq outranks the old prefix —
        # client-visible seq stays monotonic across the failover
        assert seen[-1][0] > seen[2][0]
        assert [s for s, _n in seen] == sorted(s for s, _n in seen)
    finally:
        if st is not None:
            st.cancel()
        if client is not None:
            await client.close()
        await _stop_all(reps)


async def test_stale_epoch_repl_append_fenced_after_promotion(tmp_path):
    """Fencing regression: after a promotion bumps the term, a deposed
    leader's stale-epoch ``repl.append`` push must be REJECTED by
    followers of the new leader — a late append from the old regime
    applied after promotion would silently diverge the follower from the
    new leader's history."""
    from dynamo_tpu_torch.runtime import framing

    reps, addrs = await _start_cluster(tmp_path, n=3)
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        await leader.hub.put("k", 1)
        await _wait_caught_up(leader, followers)
        stale_epoch = leader.hub.repl_epoch

        # forced promotion: one follower takes over with a bumped term
        promoted, bystander = followers
        promoted.hub.promote(addr=promoted.advertise)
        promoted.on_promoted()
        settled = await _wait_single_leader(reps)
        assert settled is promoted
        # the bystander has adopted the new regime's term
        deadline = time.monotonic() + 10
        while (
            bystander.hub.repl_epoch != promoted.hub.repl_epoch
            and time.monotonic() < deadline
        ):
            await asyncio.sleep(0.05)
        assert bystander.hub.repl_epoch == promoted.hub.repl_epoch
        assert bystander.hub.repl_epoch > stale_epoch

        # the deposed leader's late push-apply under the OLD epoch: fenced
        host, port = bystander.advertise.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            await framing.write_frame(writer, {
                "id": 1, "op": "repl.append", "epoch": stale_epoch,
                "seq": bystander.hub.repl_cursor + 1,
                "rec": {"op": "put", "k": "div/late", "v": 666, "l": None},
            })
            msg = await asyncio.wait_for(framing.read_frame(reader), 5)
            assert msg["ok"] is False
            assert msg["error"] == "epoch_mismatch"
            assert msg["epoch"] == bystander.hub.repl_epoch

            # and the record was NOT applied
            assert "div/late" not in bystander.hub._kv
        finally:
            writer.close()

        # the promoted leader itself refuses push-appends outright
        host, port = promoted.advertise.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            await framing.write_frame(writer, {
                "id": 1, "op": "repl.append", "epoch": stale_epoch,
                "seq": 999,
                "rec": {"op": "put", "k": "div/l", "v": 1, "l": None},
            })
            msg = await asyncio.wait_for(framing.read_frame(reader), 5)
            assert msg["ok"] is False and msg["error"] == "is_leader"
        finally:
            writer.close()
    finally:
        await _stop_all(reps)


async def test_split_brain_loser_discards_divergent_writes(tmp_path):
    """When a split-brain heals, the losing leader must adopt the
    winner's history via a full snapshot bootstrap — NOT an append tail
    that would silently merge the writes it accepted while it led."""
    reps, addrs = await _start_cluster(tmp_path, n=2)
    try:
        leader = await _wait_single_leader(reps)
        follower = next(r for r in reps if r is not leader)
        await leader.hub.put("k", 1)
        await _wait_caught_up(leader, [follower])

        # forced split-brain: the follower promotes (higher term, so it
        # outranks); the old leader keeps serving and accepts one more
        # write before its next probe round notices
        follower.hub.promote(addr=follower.advertise)
        follower.on_promoted()
        assert leader.hub.role == "leader"  # both lead, briefly
        await leader.hub.put("div/stale", 9)

        settled = await _wait_single_leader(reps)
        assert settled is follower
        # the loser re-synced from the winner's snapshot: its divergent
        # write is gone everywhere, the shared prefix survived
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if (
                "div/stale" not in leader.hub._kv
                and leader.hub._kv.get("k") == 1
            ):
                break
            await asyncio.sleep(0.05)
        assert "div/stale" not in leader.hub._kv
        assert "div/stale" not in follower.hub._kv
        assert leader.hub._kv["k"] == 1
    finally:
        await _stop_all(reps)


async def test_wiped_leader_restart_defers_to_caught_up_followers(tmp_path):
    """A kill -9'd leader that restarts with a WIPED data dir — empty
    state, fresh boot_id — must NOT win the election it cold-boots into:
    the vote rule refuses any candidate whose WAL position is behind the
    voter's, so a caught-up follower wins and the wiped replica re-syncs
    the full state back instead of streaming its emptiness over everyone
    else's copy."""
    reps, addrs = await _start_cluster(tmp_path)
    try:
        leader = await _wait_single_leader(reps)
        idx = reps.index(leader)
        await leader.hub.put("mdc/llama", {"card": 1})
        await _wait_caught_up(leader, [r for r in reps if r is not leader])

        # kill the leader, burn its data dir, restart it IMMEDIATELY on
        # the same address — inside the followers' lease window
        laddr = leader.advertise
        await leader.stop()
        shutil.rmtree(leader.hub.store.dir)
        reborn = HubReplica(
            "127.0.0.1", int(laddr.rsplit(":", 1)[1]),
            ",".join(addrs), leader.hub.store.dir, lease_s=LEASE_S,
        )
        await reborn.start()
        reps[idx] = reborn

        new_leader = await _wait_single_leader(reps)
        assert new_leader is not reborn  # empty replica must not lead
        assert new_leader.hub._kv["mdc/llama"] == {"card": 1}
        # and the wiped replica gets the state BACK via bootstrap
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if reborn.hub._kv.get("mdc/llama") == {"card": 1}:
                break
            await asyncio.sleep(0.05)
        assert reborn.hub._kv["mdc/llama"] == {"card": 1}
        assert reborn.hub.boot_id == new_leader.hub.boot_id
    finally:
        await _stop_all(reps)


async def test_follower_snapshot_keeps_stale_deadline_leases(tmp_path):
    """A follower's lease deadlines go stale by design (keepalives are
    never replicated; expiry arrives as the leader's revoke record), so
    its snapshots must keep every lease: dropping one would kill a live
    owner's keepalive after the follower restarts and later promotes."""
    from dynamo_tpu_torch.runtime.hub_replica import ReplicatedHub

    hub = ReplicatedHub(tmp_path / "f")
    await hub.apply_replicated({"op": "lease", "id": 7, "ttl": 0.05}, 1)
    await hub.apply_replicated(
        {"op": "put", "k": "v1/instances/w", "v": b"x", "l": 7}, 2
    )
    await asyncio.sleep(0.12)  # lease deadline is now past LOCALLY
    state = hub._state()
    assert [rec["id"] for rec in state["leases"]] == [7]
    hub.store.snapshot(state)
    await hub.close()
    # restart from that snapshot, promote: the live owner's keepalive
    # must still succeed (and its instance key must still be reapable)
    hub2 = ReplicatedHub(tmp_path / "f")
    hub2.promote()
    try:
        assert await hub2.keepalive(7) is True
        assert await hub2.get("v1/instances/w") == b"x"
    finally:
        await hub2.close()


async def test_votes_are_durable_and_once_per_term(tmp_path):
    """Election safety backbone: a replica votes at most once per term,
    the vote survives a restart (hub.term file), and a candidate behind
    the voter's WAL is refused."""
    from dynamo_tpu_torch.runtime.hub_replica import ReplicatedHub

    hub = ReplicatedHub(tmp_path / "v")
    await hub.apply_replicated({"op": "put", "k": "k", "v": 1, "l": None}, 1)
    hub.record_vote(3, "10.0.0.1:7701")
    assert (hub.repl_epoch, hub.voted_for) == (3, "10.0.0.1:7701")
    await hub.close()
    # the vote survives a crash/restart: no second grant in term 3
    hub2 = ReplicatedHub(tmp_path / "v")
    try:
        assert (hub2.repl_epoch, hub2.voted_for) == (3, "10.0.0.1:7701")
        # observing a higher term clears the vote for the new term
        assert hub2.observe_term(5) is True
        assert (hub2.repl_epoch, hub2.voted_for) == (5, None)
        assert hub2.observe_term(4) is False  # terms never regress
    finally:
        await hub2.close()


async def test_leader_never_endorses_a_rival_at_its_own_term(tmp_path):
    """Dual-lead regression: a leader — including a manually promoted one
    whose term was bumped by repl.promote with no election vote — must
    never grant a vote at its own term, and the commit quorum must ignore
    acks from addresses outside the configured replica set."""
    port = free_port()
    addr = f"127.0.0.1:{port}"
    member = "127.0.0.1:1"
    rep = HubReplica(
        "127.0.0.1", port, f"{addr},{member}", tmp_path / "r", lease_s=5.0,
    )
    try:
        rep.hub.promote(addr=rep.advertise)  # the manual lever
        rep.on_promoted()
        term = rep.hub.repl_epoch
        # promotion recorded a durable self-vote for the term
        assert rep.hub.voted_for == rep.advertise
        # a rival's real vote request at the SAME term is refused
        res = rep.on_vote_request(
            term=term, pos=10**9, boot=None, candidate=member, pre=False,
        )
        assert res == {"granted": False, "term": term}
        # and pre-votes at a live leader are refused outright
        res = rep.on_vote_request(
            term=term + 1, pos=10**9, boot=None, candidate=member, pre=True,
        )
        assert res["granted"] is False
        # commit quorum: a non-member ack (wrong --peers / advertise
        # spelling drift) never advances the commit point...
        rep.hub.wal_seq = 5
        rep.note_ack("10.9.9.9:1", 5, term)
        assert rep.commit_seq == 0 and not rep._ack_seq
        # ...while a configured member's ack does
        rep.note_ack(member, 5, term)
        assert rep.commit_seq == 5
    finally:
        await rep.hub.close()


async def test_vote_rule_prefers_newer_term_over_longer_log(tmp_path):
    """Raft election restriction (§5.4.1): a deposed minority leader can
    pad its WAL arbitrarily long with no-quorum writes, but they carry
    its dead term — a voter holding a SHORTER log with newer-term records
    must refuse it, or majority-acked writes could be overwritten."""
    port = free_port()
    addr = f"127.0.0.1:{port}"
    rep = HubReplica(
        "127.0.0.1", port, f"{addr},127.0.0.1:1,127.0.0.1:2",
        tmp_path / "r", lease_s=5.0,
    )
    try:
        # the voter replayed committed records minted by a term-2 leader
        await rep.hub.apply_replicated(
            {"op": "put", "k": "a", "v": 1, "l": None, "e": 2}, 1, epoch=2,
        )
        rep.hub.observe_term(2)
        assert rep.hub.last_rec_epoch == 2
        mypos = max(rep.hub.wal_seq, rep.hub.repl_cursor)
        # stale-term candidate with a much LONGER log: refused
        res = rep.on_vote_request(
            term=3, pos=mypos + 100, last_e=1, boot=None,
            candidate="127.0.0.1:1", pre=False,
        )
        assert res["granted"] is False
        # same-term-or-newer last record at equal position: granted
        res = rep.on_vote_request(
            term=3, pos=mypos, last_e=2, boot=None,
            candidate="127.0.0.1:2", pre=False,
        )
        assert res["granted"] is True
        assert rep.hub.voted_for == "127.0.0.1:2"
        # and last_rec_epoch survives a restart (snapshot carries it)
        rep.hub.store.snapshot(rep.hub._state())
        await rep.hub.close()
        from dynamo_tpu_torch.runtime.hub_replica import ReplicatedHub

        hub2 = ReplicatedHub(tmp_path / "r")
        try:
            assert hub2.last_rec_epoch == 2
        finally:
            await hub2.close()
    except BaseException:
        await rep.hub.close()
        raise


async def test_kick_clients_resubscribes_without_duplicates(tmp_path):
    """kick_clients (fired on follower snapshot adoption) must be
    transparent to a replay subscriber: the client reconnects, re-opens
    with replay, and per-subject seq dedup drops the already-delivered
    prefix — no loss, no duplicates."""
    reps, addrs = await _start_cluster(tmp_path, n=1)
    client = None
    st = None
    try:
        leader = await _wait_single_leader(reps)
        client = await RemoteHub.connect(addrs[0], reconnect_window_s=15.0)
        await client.publish("kv.ev", {"n": 0})

        seen: list = []

        async def subscriber():
            async for _s, payload in client.subscribe("kv.ev", replay=True):
                seen.append(payload["n"])

        st = asyncio.create_task(subscriber())
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not seen:
            await asyncio.sleep(0.02)
        assert seen == [0]

        leader.server.kick_clients()
        await asyncio.sleep(0.1)  # let the client notice + reconnect
        await client.publish("kv.ev", {"n": 1})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and 1 not in seen:
            await asyncio.sleep(0.02)
        assert seen == [0, 1]  # prefix deduped, new event delivered once
    finally:
        if st is not None:
            st.cancel()
        if client is not None:
            await client.close()
        await _stop_all(reps)


async def test_redirect_loop_is_bounded(tmp_path):
    """Two stale replicas naming each other as leader (the pathological
    mid-election pair) must not spin a client: the redirect chase is
    bounded by max hops + jittered backoff and fails well inside the
    reconnect window."""
    ports = sorted(free_port() for _ in range(2))
    addrs = [f"127.0.0.1:{p}" for p in ports]
    reps = [
        HubReplica(
            "127.0.0.1", p, ",".join(addrs), tmp_path / f"r{i}",
            lease_s=30.0,
        )
        for i, p in enumerate(ports)
    ]
    client = None
    try:
        # servers only — no role loop, so both stay followers forever,
        # each statically naming the OTHER as leader
        for r, other in zip(reps, reversed(reps)):
            await r.server.start()
            r.leader_addr = other.advertise
        client = await RemoteHub.connect(
            ",".join(addrs), reconnect_window_s=60.0
        )
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="redirect loop"):
            await client.put("spin", 1)
        elapsed = time.monotonic() - t0
        # bounded by hops + backoff, NOT by the 60 s reconnect window
        assert elapsed < 30.0
    finally:
        if client is not None:
            await client.close()
        for r in reps:
            await r.server.stop()


# -- jepsen-style partitions (transport.partition faults) --------------------


async def test_symmetric_partition_never_dual_leads(tmp_path):
    """The acceptance scenario: a seeded symmetric partition cuts the
    leader from both followers. The majority side elects a new leader at
    a higher term and keeps committing; the minority leader can neither
    commit (no_quorum) nor, after heal, keep its divergent tail. The WAL
    invariant checker proves no dual-lead within a term, no committed-seq
    gap, no fork; client seq baselines stay intact."""
    reps, addrs = await _start_cluster(tmp_path, commit_timeout_s=1.0)
    client = None
    st = None
    seen: list = []
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        old_term = leader.hub.repl_epoch
        client = await RemoteHub.connect(
            ",".join(addrs), reconnect_window_s=20.0
        )
        await client.put("pre/partition", 1)
        assert await client.publish("ev", {"n": 0}, pub_id="part:0") is True
        await _wait_caught_up(leader, followers)

        async def subscriber():
            async for _s, payload, seq in client.subscribe(
                "ev", replay=True, with_seq=True
            ):
                seen.append((seq, payload["n"]))

        st = asyncio.create_task(subscriber())

        # seeded, live-flipped symmetric partition: leader vs the rest
        FAULTS.configure(isolate_spec(leader.advertise, addrs), seed=7)
        try:
            new_leader = await _wait_single_leader(followers, timeout=15.0)
            assert new_leader is not leader
            assert new_leader.hub.repl_epoch > old_term

            # the minority leader cannot commit: a pinned client write
            # dies with a bounded error instead of hanging or landing
            pinned = await RemoteHub.connect(
                leader.advertise, reconnect=False
            )
            with pytest.raises(ConnectionError):
                await pinned.put("minority/client-write", 9)
            await pinned.close()
            # ...and a direct write on it diverges only ITS local WAL
            await leader.hub.put("minority/direct", 9)

            # the majority keeps committing through the same client
            await client.put("during/partition", 2)
            assert await client.publish(
                "ev", {"n": 1}, pub_id="part:1"
            ) is True
            assert await client.get("during/partition") == 2
        finally:
            FAULTS.clear()

        # heal: the deposed leader rejoins as a follower and discards its
        # divergent tail via snapshot bootstrap from the winner
        new_leader = await _wait_single_leader(reps, timeout=15.0)
        await _wait(
            lambda: "minority/direct" not in leader.hub._kv
            and leader.hub._kv.get("during/partition") == 2,
            msg="deposed leader kept divergent state after heal",
        )
        # the cluster accepts writes after heal, baselines intact
        await client.put("after/heal", 3)
        assert await client.get("pre/partition") == 1
        # a retried pre-heal publish dedups; a new one applies
        assert await client.publish("ev", {"n": 1}, pub_id="part:1") is False
        assert await client.publish("ev", {"n": 2}, pub_id="part:2") is True
        await _wait(
            lambda: len(seen) >= 3, msg=f"subscriber saw only {seen}"
        )
        # client-visible seq is strictly monotonic across the failover
        seqs = [s for s, _n in seen]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        assert [n for _s, n in seen] == [0, 1, 2]
        await _wait_caught_up(
            await _wait_single_leader(reps),
            [r for r in reps if r.hub.role != "leader"],
        )
    finally:
        FAULTS.clear()
        if st is not None:
            st.cancel()
        if client is not None:
            await client.close()
        dirs = [r.hub.store.dir for r in reps]
        await _stop_all(reps)
    check_cluster_invariants(dirs)


async def test_partition_during_election_blocks_both_sides(tmp_path):
    """Partition-during-election: the leader dies while the two survivors
    are cut from each other — neither can assemble a majority, so the
    cluster stays leaderless (no minority promotion, no term inflation)
    until the partition heals, then elects exactly one leader with the
    full committed state."""
    reps, addrs = await _start_cluster(tmp_path, commit_timeout_s=1.0)
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        await leader.hub.put("k", 1)
        await _wait_caught_up(leader, followers)
        terms_before = {r.advertise: r.hub.repl_epoch for r in followers}

        FAULTS.configure(partition_spec(
            (followers[0].advertise, followers[1].advertise)
        ), seed=3)
        try:
            await leader.stop()
            await asyncio.sleep(LEASE_S * 6)
            assert all(f.hub.role != "leader" for f in followers)
            # pre-vote keeps failed campaigns from inflating terms
            for f in followers:
                assert f.hub.repl_epoch == terms_before[f.advertise]
        finally:
            FAULTS.clear()

        new_leader = await _wait_single_leader(followers)
        assert new_leader.hub._kv.get("k") == 1
        client = await RemoteHub.connect(
            ",".join(f.advertise for f in followers),
            reconnect_window_s=15.0,
        )
        await client.put("after/heal", 2)
        assert await client.get("after/heal") == 2
        await client.close()
    finally:
        FAULTS.clear()
        await _stop_all(reps)


async def test_one_way_partition_converges_single_leader(tmp_path):
    """Election liveness under an asymmetric fault: one follower hears
    the cluster but the leader's traffic to it is cut (one-way
    ``transport.partition``). The isolated follower keeps campaigning but
    can never assemble a pre-vote majority (leader stickiness at the
    healthy follower), so the cluster converges to — and stays at —
    exactly one leader, and writes keep committing through the healthy
    follower's acks."""
    reps, addrs = await _start_cluster(tmp_path)
    client = None
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        f1 = followers[0]
        await _wait_caught_up(leader, followers)

        FAULTS.configure(partition_spec(
            (leader.advertise, f1.advertise), one_way=True
        ), seed=11)
        try:
            # several election timeouts pass; the cut follower's
            # campaigns must not depose the leader or elect a second one
            await asyncio.sleep(LEASE_S * 6)
            leaders = [r for r in reps if r.hub.role == "leader"]
            assert leaders == [leader]
            client = await RemoteHub.connect(
                ",".join(addrs), reconnect_window_s=20.0
            )
            await client.put("one-way/write", 1)
            assert await client.get("one-way/write") == 1
        finally:
            FAULTS.clear()
        # heal: the cut follower re-syncs and the cluster is whole again
        await _wait_caught_up(
            leader, followers, timeout=15.0
        )
        assert f1.hub._kv.get("one-way/write") == 1
    finally:
        FAULTS.clear()
        if client is not None:
            await client.close()
        await _stop_all(reps)


@pytest.mark.slow
@pytest.mark.e2e
async def test_partition_matrix_invariants(tmp_path):
    """The full seeded partition matrix (nightly chaos tier): every
    replica takes a turn being symmetrically isolated and one-way cut,
    with live flips and heals between rounds; every round's majority
    write must commit and survive, and the WAL invariant checker must
    pass over the final cluster state."""
    reps, addrs = await _start_cluster(tmp_path, commit_timeout_s=1.0)
    client = await RemoteHub.connect(",".join(addrs), reconnect_window_s=30.0)
    rounds = 0
    try:
        for seed, (kind, pick) in enumerate(
            itertools.product(("sym", "oneway"), range(3))
        ):
            await _wait_single_leader(reps, timeout=20.0)
            target = reps[pick]
            others = [a for a in addrs if a != target.advertise]
            spec = (
                isolate_spec(target.advertise, others) if kind == "sym"
                else partition_spec(
                    (target.advertise, others[0]), one_way=True
                )
            )
            FAULTS.configure(spec, seed=seed)
            try:
                await asyncio.sleep(LEASE_S * 5)
                rounds += 1
                await client.put(f"round/{rounds}", rounds)
            finally:
                FAULTS.clear()
            await client.put(f"healed/{rounds}", rounds)
        leader = await _wait_single_leader(reps, timeout=20.0)
        for i in range(1, rounds + 1):
            assert await client.get(f"round/{i}") == i
            assert await client.get(f"healed/{i}") == i
        await _wait_caught_up(
            leader, [r for r in reps if r is not leader], timeout=20.0
        )
    finally:
        FAULTS.clear()
        await client.close()
        dirs = [r.hub.store.dir for r in reps]
        await _stop_all(reps)
    check_cluster_invariants(dirs)


# -- kill -9 chaos through real processes (slow tier) -----------------------


@pytest.mark.slow
@pytest.mark.e2e
async def test_kill9_leader_delete_data_dir_chaos(tmp_path):
    """The acceptance scenario: 3-process hub cluster; kill -9 the
    leader AND delete its data dir. Within the election timeout a
    follower wins a quorum vote, the client reconverges via
    multi-address failover, a get_prefix/publish round-trip succeeds,
    and replayed publishes are deduplicated (zero duplicate pub_ids in
    the elected hub)."""
    ports = sorted(free_port() for _ in range(3))
    addrs = [f"127.0.0.1:{p}" for p in ports]
    peers = ",".join(addrs)
    dirs = {a: tmp_path / f"rep{i}" for i, a in enumerate(addrs)}
    procs = {a: spawn_replica(a, peers, str(dirs[a])) for a in addrs}
    client = None
    try:
        leader = await find_leader(addrs)
        client = await RemoteHub.connect(peers, reconnect_window_s=30.0)
        await client.put("mdc/llama", {"card": 1})
        lease = await client.grant_lease(60.0)
        await client.put("v1/instances/w0", {"port": 9}, lease_id=lease)
        assert await client.publish(
            "kv.ev", {"n": 1}, pub_id="chaos:1"
        ) is True

        # writes are majority-committed by construction now, but wait for
        # FULL catch-up so the invariant state is deterministic before
        # pulling the trigger
        lstat = await repl_status(leader)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            fstats = [
                await repl_status(a) for a in addrs if a != leader
            ]
            if all(
                s and s["cursor"] >= lstat["wal_seq"] for s in fstats
            ):
                break
            await asyncio.sleep(0.1)

        # kill -9 AND burn the data dir: promotion must come from the
        # followers' replicated state, not any recovery of the leader's
        procs[leader].send_signal(signal.SIGKILL)
        procs[leader].wait()
        shutil.rmtree(dirs[leader])

        survivors = [a for a in addrs if a != leader]
        new_leader = await find_leader(survivors, timeout=20.0)

        # client reconverges: reads see the pre-kill state
        prefix = await client.get_prefix("mdc/")
        assert prefix == {"mdc/llama": {"card": 1}}
        assert await client.get("v1/instances/w0") == {"port": 9}
        assert await client.keepalive(lease) is True

        # the at-least-once retry of a pre-kill publish is DEDUPED by
        # the elected hub (pub_id replicated inside the WAL record)...
        assert await client.publish(
            "kv.ev", {"n": 1}, pub_id="chaos:1"
        ) is False
        # ...while genuinely new publishes apply
        assert await client.publish(
            "kv.ev", {"n": 2}, pub_id="chaos:2"
        ) is True
        await client.put("mdc/qwen", {"card": 2})
        assert (await client.get_prefix("mdc/"))["mdc/qwen"] == {"card": 2}

        # the elected leader carries a fencing epoch above the dead one's
        status = await repl_status(new_leader)
        assert status["role"] == "leader"
        assert status["epoch"] > lstat["epoch"]
    finally:
        if client is not None:
            await client.close()
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait()
    # jepsen-style postcondition over the survivors' WALs (the dead
    # leader's dir is gone; quorum=2 of the remaining copies)
    check_cluster_invariants(
        [dirs[a] for a in addrs if dirs[a].exists()], quorum=2,
    )


# -- mixed clusters: port and JAX replicas in one quorum ---------------------


async def _rpc(addr: str, msg: dict, timeout: float = 5.0) -> dict:
    from dynamo_tpu_torch.runtime import framing

    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        await framing.write_frame(writer, {"id": 1, **msg})
        return await asyncio.wait_for(framing.read_frame(reader), timeout)
    finally:
        writer.close()


def _replica(kind: str, port: int, peers: str, data_dir):
    from dynamo_tpu.runtime.hub_replica import HubReplica as JaxHubReplica

    cls = HubReplica if kind == "port" else JaxHubReplica
    return cls("127.0.0.1", port, peers, data_dir, lease_s=LEASE_S,
               commit_timeout_s=2.0)


async def _fail_over_from(reps, kind: str, peers: str, tmp_path) -> tuple:
    """Hand the leadership to a replica of package ``kind`` (the manual
    lever: a real vote round), stop it, wait for the survivors' leader,
    then restart the stopped one on its address and data dir. Returns
    (the old leader's term, the new leader)."""
    leader = await _wait_single_leader(reps)
    if not isinstance(leader, HubReplica) == (kind == "port"):
        target = next(r for r in reps if isinstance(r, HubReplica) == (kind == "port"))
        msg = await _rpc(target.advertise, {"op": "repl.promote"})
        assert msg["ok"], msg
        leader = await _wait_single_leader(reps)
        assert leader is target
    old_term = leader.hub.repl_epoch
    idx = reps.index(leader)
    await leader.stop()
    survivors = [r for r in reps if r is not leader]
    new_leader = await _wait_single_leader(survivors)
    port = int(leader.advertise.rsplit(":", 1)[1])
    reps[idx] = _replica(kind, port, peers, leader.hub.store.dir)
    await reps[idx].start()
    return old_term, new_leader


@pytest.mark.parametrize("kinds", [("port", "port", "ref"), ("port", "ref", "ref")],
                         ids=["2port+1ref", "1port+2ref"])
async def test_mixed_cluster_fails_over_both_ways(tmp_path, kinds):
    """Port and JAX replicas form one cluster: one leader per term, writes
    through both packages' RemoteHub majority-committed, a port leader and
    then a JAX leader stopped in turn with every acked write on the elected
    leader, and both packages' WAL checkers agreeing on the three dirs."""
    from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
    from dynamo_tpu.sim.cluster import check_cluster_invariants as jax_check

    ports = sorted(free_port() for _ in kinds)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    peers = ",".join(addrs)
    reps = [_replica(k, p, peers, tmp_path / f"{k}{i}")
            for i, (k, p) in enumerate(zip(kinds, ports))]
    clients = []
    acked: dict[str, int] = {}
    try:
        for r in reps:
            await r.start()
        for cls in (RemoteHub, JaxRemoteHub):
            clients.append(await cls.connect(peers, reconnect_window_s=20.0))

        async def write(tag: str, n: int) -> None:
            for i in range(n):
                c = clients[i % 2]
                key = f"{tag}/{type(c).__module__.split('.')[0]}/{i}"
                await c.put(key, i)
                acked[key] = i

        lease = await clients[0].grant_lease(60.0)
        await clients[1].put("v1/instances/w0", {"port": 9}, lease_id=lease)
        assert await clients[0].publish("ev", {"n": 0}, pub_id="mix:0") is True
        await write("pre", 10)
        terms = []
        for kind in ("port", "ref"):
            old_term, new_leader = await _fail_over_from(reps, kind, peers, tmp_path)
            assert new_leader.hub.repl_epoch > old_term
            terms.append(new_leader.hub.repl_epoch)
            await write(f"after-{kind}", 6)
            for key, v in acked.items():
                assert new_leader.hub._kv.get(key) == v, key
            for c in clients:
                assert await c.get("v1/instances/w0") == {"port": 9}
                assert await c.keepalive(lease) is True
                # the retried publish dedups on the elected leader
                assert await c.publish("ev", {"n": 0}, pub_id="mix:0") is False
        leader = await _wait_single_leader(reps)
        await _wait_caught_up(leader, [r for r in reps if r is not leader])
        assert len({r.hub.boot_id for r in reps}) == 1
        assert terms[0] < terms[1]
    finally:
        for c in clients:
            await c.close()
        dirs = [r.hub.store.dir for r in reps]
        await _stop_all(reps)
    mine = check_cluster_invariants(dirs)
    assert mine == jax_check(dirs)
    assert mine["committed"] and all(
        len(a - {None}) == 1 for a in mine["promotes"].values())


# -- port replica processes --------------------------------------------------


async def test_replica_process_kill9_restart_clients_reconverge(tmp_path):
    """Three ``cli hub-replica``-equivalent processes of the port: SIGKILL
    the leader, the survivors elect and the client (with a live watch)
    reconverges; the killed replica restarts on its address and data dir,
    catches up, and the WAL checker holds over all three dirs."""
    ports = sorted(free_port() for _ in range(3))
    addrs = [f"127.0.0.1:{p}" for p in ports]
    peers = ",".join(addrs)
    dirs = {a: tmp_path / f"rep{i}" for i, a in enumerate(addrs)}
    procs = {a: await asyncio.to_thread(spawn_replica, a, peers, str(dirs[a]), LEASE_S)
             for a in addrs}
    client = wt = None
    events: list = []
    try:
        leader = await find_leader(addrs)
        client = await RemoteHub.connect(peers, reconnect_window_s=20.0)
        await client.put("mdc/llama", {"card": 1})

        async def watcher():
            async for ev in client.watch_prefix("mdc/"):
                events.append((ev.kind, ev.key))

        wt = asyncio.create_task(watcher())
        procs[leader].send_signal(signal.SIGKILL)
        procs[leader].wait()
        new_leader = await find_leader([a for a in addrs if a != leader])
        await client.put("mdc/qwen", {"card": 2})
        assert await client.get("mdc/llama") == {"card": 1}
        procs[leader] = await asyncio.to_thread(
            spawn_replica, leader, peers, str(dirs[leader]), LEASE_S)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            lead = await repl_status(new_leader)
            back = await repl_status(leader)
            if back and lead and back["role"] == "follower" and (
                    back["cursor"] >= lead["wal_seq"]):
                break
            await asyncio.sleep(0.05)
        assert back["cursor"] >= lead["wal_seq"], (back, lead)
        assert back["boot_id"] == lead["boot_id"]
        while ("put", "mdc/qwen") not in events and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert ("put", "mdc/llama") in events and ("put", "mdc/qwen") in events
    finally:
        if wt is not None:
            wt.cancel()
        if client is not None:
            await client.close()
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
                p.wait(10)
    check_cluster_invariants([dirs[a] for a in addrs])
